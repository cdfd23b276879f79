"""The overlap of a gradient exchange with backward: one mechanism for
every armed step.

Counterpart of what the JAX package leaves to XLA's latency-hiding
scheduler, which interleaves a compiled step's collectives with the
compute they do not depend on (``horovod_tpu/parallel/optimizer.py``:
the replicated path's bucket all-reduces, ZeRO-2/3's per-leaf
reduce-scatters). Here a wrapper arms a step on the calling thread (its
plan built, registered in the program and negotiated there) and
post-accumulate-grad hooks issue the exchange's units from backward:
:class:`Overlap` issues unit k once the gradients it reads are
accumulated and every unit before it in a fixed order has gone.
``parallel/optimizer.py`` arms the replicated path (a unit a fusion
bucket, in the plan's order) and ``parallel/sharded.py`` ZeRO-2/3 (a unit
a tensor's reduce-scatter, in reverse gather order).
"""

from __future__ import annotations

import functools
import weakref

import torch

from horovod_tpu_torch.core import context as _ctx
from horovod_tpu_torch.core.state import HorovodError


class Overlap:
    """One armed step: a gradient exchange cut into units, issued from
    backward. ``units`` lists, in the fixed issue order, the positions in
    ``params`` whose gradients each unit reads (the replicated path: a
    fusion bucket's members, in the plan's order; the sharded modes: one
    tensor each, in reverse gather order), and ``issue(k)`` issues unit
    ``k``, moving data only: what it registers and negotiates was done
    when the step was armed. A parameter's post-accumulate-grad hook calls
    :meth:`accumulated`; a unit is issued once all its gradients are
    accumulated and every unit before it in the order has been issued, so
    the wire order is the same on every rank whatever order the hooks
    fire in. The first hook of a backward pass queues :meth:`finish` on
    autograd's engine, which runs it when that pass ends: it issues what
    is left and joins, so the exchange is done when ``backward()``
    returns (as DDP's is), for whatever reads the gradients before
    ``step()`` (gradient clipping, a scaler's unscale, logging). Where no
    hook fired (gradients written by ``torch.autograd.grad``), ``step()``
    finishes instead.

    On the card a unit issued while backward still owes gradients of the
    exchange runs on ``stream`` (the wrapper's exchange stream), after the
    work the calling stream has queued: a collective on the backward
    stream would stall backward. Once every gradient is in (the last hook,
    :meth:`finish`) nothing is left to overlap, and the units left run on
    the calling stream, as an unarmed step's do: a unit on the exchange
    stream costs the step time (PERF.md §6). :meth:`finish` runs on the
    stream that called ``backward()`` and makes it wait for the exchange
    stream; inside a capture the exchange stream forks from the capture
    stream and joins it there. ``ctx`` is the program context the step
    was armed in, made current again for each unit (autograd runs a CUDA
    backward on a thread of its own)."""

    def __init__(self, params: list, units: list, issue, stream, ctx,
                 plan=None) -> None:
        self.plan = plan        # the step's exchange plan
        self.issue_unit = issue
        self.stream = stream
        self.ctx = ctx
        self.slot = {id(p): i for i, p in enumerate(params)}
        self.unit_of = [0] * len(params)
        for k, idx in enumerate(units):
            for i in idx:
                self.unit_of[i] = k
        self.waiting = [len(idx) for idx in units]
        self.done = [False] * len(params)
        self.pending = len(params)      # gradients backward still owes
        self.issued = 0
        self.forked = False
        self.queued = False
        self.finished = False

    def accumulated(self, p) -> int:
        """``p``'s gradient is accumulated: issue every unit now ready
        (the first call of a backward pass queues :meth:`finish` for its
        end). Returns the units issued."""
        i = self.slot[id(p)]
        if self.done[i] or self.finished:
            when = ("twice since zero_grad()" if self.done[i] else
                    "after the backward pass that finished the exchange")
            raise HorovodError(
                f"DistributedOptimizer: the gradient of parameter {i} of "
                f"the exchange was accumulated {when}. An armed step "
                f"issues each bucket's allreduce from backward as soon as "
                f"its gradients are accumulated, and finishes the exchange "
                f"when backward ends, so a second backward pass would "
                f"change gradients already on the wire. Call step() (or "
                f"synchronize()) between backward passes, or "
                f"zero_grad(set_to_none=True) for a step that exchanges "
                f"after backward.")
        if not self.queued:
            torch.autograd.Variable._execution_engine.queue_callback(
                self.finish)
            self.queued = True
        self.done[i] = True
        self.pending -= 1
        self.waiting[self.unit_of[i]] -= 1
        return self._issue_ready(everything=False)

    def finish(self) -> None:
        """Issue the units not yet issued, in order, and :meth:`close`; a
        second call only joins."""
        self.pending = 0        # backward is over (or never ran)
        self._issue_ready(everything=True)
        self.close()

    def close(self) -> None:
        """Issue nothing more (a step dropped before it finished leaves
        its other units unissued; a later hook raises) and :meth:`join`.
        The issuing function goes: it may hold the step's tensors, which
        the hooks would otherwise keep in a reference cycle."""
        self.finished = True
        self.issue_unit = None
        self.join()

    def join(self) -> None:
        """Make the calling stream wait for the units issued so far."""
        if self.forked:
            torch.cuda.current_stream(self.stream.device).wait_stream(
                self.stream)

    def _issue_ready(self, everything: bool) -> int:
        start = self.issued
        n = len(self.waiting)
        with _ctx.resume(self.ctx):
            while self.issued < n and (everything
                                       or self.waiting[self.issued] == 0):
                self._issue(self.issued)
                self.issued += 1
        return self.issued - start

    def _issue(self, k: int) -> None:
        with torch.no_grad():
            if self.stream is None or self.pending == 0:
                self.issue_unit(k)
                return
            self.stream.wait_stream(torch.cuda.current_stream(
                self.stream.device))
            self.forked = True
            with torch.cuda.stream(self.stream):
                self.issue_unit(k)


def exchange_stream(owner, device):
    """``owner``'s exchange stream on ``device`` (made at its first armed
    step on the card; None on the CPU)."""
    if device.type != "cuda":
        return None
    if owner._stream is None:
        owner._stream = torch.cuda.Stream(device)
    return owner._stream


def _remove_hooks(hooks: list) -> None:
    for h in hooks:
        h.remove()


def accumulated(ref, p, armed=None) -> None:
    """A parameter's post-accumulate-grad hook: ``ref`` is a weak
    reference to its wrapper, whose armed step (``armed``, else the
    wrapper's current one, if any) takes it."""
    opt = ref()
    if opt is None:
        return
    armed = opt._armed if armed is None else armed
    if armed is not None:
        opt.buckets_in_backward += armed.accumulated(p)
        opt.hooks_fired += 1


def hook_params(owner, params) -> None:
    """Register :func:`accumulated` on each of ``params`` that is a leaf
    requiring a gradient; the hooks go with ``owner`` (wrapping the
    parameters again, an elastic rebuild, does not stack them)."""
    ref = weakref.ref(owner)
    hooks = [p.register_post_accumulate_grad_hook(
                 functools.partial(accumulated, ref))
             for p in params if p.requires_grad and p.is_leaf]
    weakref.finalize(owner, _remove_hooks, hooks)

"""``hvd.spmd`` — run a step function as one recorded program.

Counterpart of ``horovod_tpu/parallel/spmd.py``. There ``jax.jit(shard_map(
fn))`` traces the step once, validates its collective schedule across the
processes and compiles it into one XLA program that every later call runs.
Here each rank is a process running ``fn`` on its own values, and on the
card the program is a CUDA graph: ``spmd(fn)`` captures one step's kernels
and collectives once and replays them.

One program per key ``(generation, group, signature of the arguments)``;
the generation (``core/state.py::generation``) moves at every
``shutdown``/``init`` cycle and at ``bump_generation`` (which
``Trainer.restore`` calls), and programs of an older generation are dropped.

On the card (``hvd.init()``'s device is CUDA), per key:

1. the first call runs ``fn`` eagerly, on a side stream of the program's
   own: it negotiates every collective, as eager collectives do, and does
   every lazy initialisation a capture cannot (cuBLAS handles, the NCCL
   communicator, the optimizer's state, kernel A1's launch table, kernel
   B1's barrier words, which are owned by the stream);
2. the second call copies the tensor arguments into static buffers and
   captures ``fn`` on that side stream into one ``torch.cuda.CUDAGraph``
   (``utils/graphs.py``, the capture core the serving engine shares),
   under a program context (``core/context.py``) in which the collectives
   only register; ``core/multihost.py::validate_schedule`` then compares
   the schedule across the group's ranks, and the graph is replayed. The
   graphs of one :class:`Spmd` share one memory pool: they run one after
   another on one stream, and each replay's outputs are copied out at once;
3. every later call copies its tensor arguments into the static buffers and
   replays the graph.

Every call thus runs exactly one step. Outputs come back as fresh tensors,
never the graph's static ones, which the next replay overwrites. A capture
that fails raises; nothing falls back to eager. The kernel wrappers'
launches that a capture records are counted at each replay
(``ops/launches.py``), where the card runs them.

On the CPU there is no graph: the first call of a key runs ``fn`` under the
program context with the per-call negotiation on, and its schedule is
validated; later calls run it under the context without a store round.

With the timeline's device mode (``HOROVOD_TIMELINE_DEVICE=1``, the
reference's device-fidelity mode) a key's first call, and every N-th with
``HOROVOD_TIMELINE_DEVICE_INTERVAL=N``, is sampled: it runs under
``torch.profiler`` (the first call eagerly, a later one as a graph
replay), its device events are mapped onto the schedule
(``core/xprof.py``) and written with device timestamps anchored at the
host clock of the session's start (each launch of the port's own kernels
on the ``_kernels`` row too), and its collective spans feed the α–β
recalibrator (``ops/exchange.py::observe_xla_spans``). A session with no
device event (the CPU) leaves an instant ``NO_DEVICE_PLANE`` note.
Unsampled calls write no span and wait for nothing; ``sampled`` counts the
sampled calls.

What ``fn`` may do is what a capture allows: no host synchronisation
(``.item()``, ``float(tensor)``, a copy to the host), no copy from pageable
host memory, the same kernels and addresses every call. Its tensor
arguments must live on the rank's device, and it must not keep references
to them past the call (they are the static buffers).

Divergences from the reference (ROADMAP §C): a process is a rank, so
arguments carry no rank axis and ``donate_argnums``/``replicated_argnums``
are not taken; results are fresh tensors; the timeline names a replay's
spans GRAPH_<OP> where the reference writes XLA_<OP>; a program's first
call is eager.
"""

from __future__ import annotations

import functools
from typing import Callable

import numpy as np
import torch
import torch.utils._pytree as pytree

from horovod_tpu_torch.core import context as _ctx
from horovod_tpu_torch.core import multihost as _mh
from horovod_tpu_torch.core import state as _state
from horovod_tpu_torch.core import timeline as _tl
from horovod_tpu_torch.core.state import HorovodError
from horovod_tpu_torch.utils import env as _env
from horovod_tpu_torch.utils import graphs as _graphs


def _signature(leaves) -> tuple:
    """What a program is specialised on: each tensor's shape, dtype and
    device, and the value of every other leaf (a capture bakes it in)."""
    def one(t):
        if isinstance(t, torch.Tensor):
            return tuple(t.shape), t.dtype, t.device
        try:
            hash(t)
        except TypeError:
            return type(t), repr(t)
        return type(t), t

    return tuple(one(t) for t in leaves)


class _Program(_graphs.Graph):
    """One key's program: its calls so far, its schedule and, on the card,
    its stream, graph and static buffers (``utils/graphs.py``)."""

    def __init__(self) -> None:
        super().__init__()
        self.calls = 0
        self.executions = 0  # calls counted by the device timeline mode
        self.schedule: list | None = None
        self.static_in: list = []


class Spmd:
    """The callable :func:`spmd` returns. ``trace_count`` counts the
    programs recorded so far (one a key: a capture on the card, the
    validated first call on the CPU); ``runs`` the calls that ran ``fn``'s
    Python (on the card the first call and the capture of each key);
    ``replays`` the graph replays; ``sampled`` the calls the device
    timeline mode ran under the profiler; ``programs`` holds the programs
    by key."""

    def __init__(self, fn: Callable, group: int = 0) -> None:
        functools.update_wrapper(self, fn)
        self.fn = fn
        self.group = group
        self.tag = getattr(fn, "__qualname__", "fn")
        self.programs: dict = {}
        self.trace_count = 0
        self.runs = 0
        self.replays = 0
        self.sampled = 0

    @property
    def recorded(self) -> bool:
        """Whether a program has been recorded (and so holds what ``fn``
        read as constants, such as a float learning rate)."""
        return any(p.schedule is not None for p in self.programs.values())

    def reset(self) -> None:
        """Drop every program (and its graph): the next call records
        anew."""
        self.programs.clear()

    def __call__(self, *args):
        leaves, spec = pytree.tree_flatten(args)
        key = (_state.generation(self.group), self.group,
               _signature(leaves), spec)
        prog = self.programs.get(key)
        if prog is None:
            # Programs of an earlier generation can never run again.
            for stale in [k for k in self.programs if k[0] != key[0]]:
                del self.programs[stale]
            prog = self.programs[key] = _Program()
        tag = f"{self.tag}/{len(args)}"
        try:
            if _state.device().type == "cuda":
                return self._on_card(prog, tag, args, leaves, spec)
            return self._on_cpu(prog, tag, args)
        except BaseException:
            if prog.schedule is None or prog.calls < 2:
                # Half-built: the next call starts this key over.
                self.programs.pop(key, None)
            raise

    # -- recording ---------------------------------------------------------

    def _recorded(self, tag: str, ctx: _ctx.ProgramContext) -> list:
        """The schedule of a program just recorded under ``ctx``, validated
        across the group's ranks."""
        self.trace_count += 1
        schedule = ctx.schedule()
        tl = _tl.session()
        for nm, op, *_ in schedule:
            tl.start_activity(nm, f"NEGOTIATE_{op}")
            tl.end_activity(nm, f"NEGOTIATE_{op}")
        _mh.validate_schedule(tag, schedule, self.group)
        return schedule

    def _spans(self, prog: _Program, phase: str) -> None:
        tl = _tl.session()
        if not tl.active or tl.device_mode or not prog.schedule:
            return
        rows = prog.schedule if phase == "B" else reversed(prog.schedule)
        for nm, op, *_ in rows:
            tl.event(nm, f"GRAPH_{op}", phase)

    # -- the device timeline mode -----------------------------------------

    def _sampling(self, prog: _Program) -> bool:
        """Whether this call of ``prog`` is sampled: in the device mode,
        its first call and every N-th (``HOROVOD_TIMELINE_DEVICE_INTERVAL``);
        a program whose schedule is recorded empty never is."""
        tl = _tl.session()
        if not (tl.active and tl.device_mode) or prog.schedule == []:
            return False
        n = prog.executions
        prog.executions += 1
        interval = _env.timeline_device_interval()
        return n == 0 or (interval > 0 and n % interval == 0)

    def _sampled(self, run_once, schedule: Callable[[], list]):
        """``run_once()`` under ``torch.profiler``, its device events
        mapped onto ``schedule()`` and written to the timeline."""
        from horovod_tpu_torch.core import xprof as _xprof
        from horovod_tpu_torch.ops import exchange as _exchange

        out, events, anchor_us = _xprof.profiled_events(run_once)
        self.sampled += 1
        sched = schedule()
        spans = _xprof.map_device_spans(sched, events)
        tl = _tl.session()
        if spans:
            for row, activity, start_us, dur_us in (
                    spans + _xprof.kernel_spans(events)):
                tl.event_at(row, activity, anchor_us + start_us, dur_us)
            _exchange.observe_xla_spans(spans, sched)
        else:
            tl.event("_device", "NO_DEVICE_PLANE", "X")
        return out

    def _first(self, prog: _Program, run_once):
        """A key's first call, ``run_once()`` under a negotiating program
        context (sampled in the device mode); returns its output and the
        context, which holds the schedule it registered."""
        holder = []

        def once():
            with _ctx.enter(self.group, negotiate=True) as ctx:
                holder.append(ctx)
                return run_once()

        if self._sampling(prog):
            out = self._sampled(once, lambda: holder[0].schedule())
        else:
            out = once()
        return out, holder[0]

    # -- the CPU -----------------------------------------------------------

    def _on_cpu(self, prog: _Program, tag: str, args):
        self.runs += 1
        if prog.schedule is None:
            tl = _tl.session()
            row = f"_program/{tag}"
            tl.start_activity(row, "TRACE_AND_COMPILE")
            out, ctx = self._first(prog, lambda: self.fn(*args))
            tl.end_activity(row, "TRACE_AND_COMPILE")
            prog.schedule = self._recorded(tag, ctx)
            prog.calls = 2
            return out

        def run():
            with _ctx.enter(self.group):
                return self.fn(*args)

        if self._sampling(prog):
            return self._sampled(run, lambda: prog.schedule)
        self._spans(prog, "B")
        out = run()
        self._spans(prog, "E")
        return out

    # -- the card ----------------------------------------------------------

    def _on_card(self, prog: _Program, tag: str, args, leaves, spec):
        dev = _state.device()
        for t in leaves:
            if isinstance(t, torch.Tensor) and t.device != dev:
                raise HorovodError(
                    f"spmd: program {tag} runs on {dev}, but an argument of "
                    f"shape {tuple(t.shape)} lies on {t.device}; move the "
                    f"arguments to the rank's device first.")
        if prog.calls == 0:
            self.runs += 1
            out, _ = self._first(prog,
                                 lambda: prog.eager(dev, self.fn, *args))
            prog.calls = 1
            return out
        if prog.calls == 1:
            self._capture(prog, tag, leaves, spec)
        for static, t in zip(prog.static_in, leaves):
            if isinstance(t, torch.Tensor) and t is not static:
                static.copy_(t)
        if self._sampling(prog):
            out = self._sampled(prog.replay, lambda: prog.schedule)
        else:
            self._spans(prog, "B")
            out = prog.replay()
            tl = _tl.session()
            if tl.active and not tl.device_mode:
                torch.cuda.current_stream(dev).synchronize()
            self._spans(prog, "E")
        self.replays += 1
        return out

    def _capture(self, prog: _Program, tag: str, leaves, spec) -> None:
        prog.static_in = [t.clone() if isinstance(t, torch.Tensor) else t
                          for t in leaves]
        args = pytree.tree_unflatten(prog.static_in, spec)
        # One pool for all this Spmd's graphs: a second signature (a ragged
        # last batch) reuses the first one's activations instead of holding
        # its own. Safe as the graphs never run at once, and a replay's
        # outputs are cloned before another graph runs.
        pool = next((p.graph.pool() for p in self.programs.values()
                     if p.graph is not None), None)
        self.runs += 1
        tl = _tl.session()
        row = f"_program/{tag}"
        tl.start_activity(row, "TRACE_AND_COMPILE")
        ctx = prog.capture(
            self.fn, *args, pool=pool, within=_ctx.enter(self.group),
            what=f"spmd: program {tag}",
            rules="A captured step must not synchronise with the host "
                  "(.item(), float(tensor), a copy to the host) or copy "
                  "from pageable host memory, and its optimizer must be "
                  "capturable (torch.optim's with capturable=True, which "
                  "the Trainer sets).")
        tl.end_activity(row, "TRACE_AND_COMPILE")
        prog.schedule = self._recorded(tag, ctx)
        prog.calls = 2


def spmd(fn: Callable, group: int = 0) -> Spmd:
    """Wrap ``fn(*args) -> outputs`` (one rank's step) into a program over
    group ``group``: captured once as a CUDA graph and replayed on the card,
    run eagerly under a validated schedule on the CPU (see the module
    docstring)."""
    return Spmd(fn, group)


# -- rank-stacked helpers: a process is a rank ---------------------------------

def _members_here(group: int) -> int:
    return 1 if _state.rank(group) >= 0 else 0


def rank_stack(values, group: int = 0):
    """The reference stacks one value per rank into a leading rank axis; a
    process drives one rank, so ``values`` holds one value (none on a
    process outside ``group``) and that value is returned."""
    n = _members_here(group)
    if len(values) != n:
        raise HorovodError(
            f"rank_stack: expected one value per local member rank ({n}), "
            f"got {len(values)}.")
    return values[0] if n else None


def replicate(value, group: int = 0):
    """One replica a rank: this rank's replica is ``value`` itself."""
    _state.get_group(group)
    return value


def device_put_ranked(value, group: int = 0):
    """``value``'s tensors on the rank's device."""
    _state.get_group(group)
    dev = _state.device()
    return pytree.tree_map(
        lambda t: t.to(dev) if isinstance(t, torch.Tensor) else t, value)


def local_values(stacked, group: int = 0) -> list:
    """This process's ranks' values as numpy pytrees: one entry (none on a
    process outside ``group``)."""
    if not _members_here(group):
        return []
    return [pytree.tree_map(
        lambda t: t.detach().cpu().numpy() if isinstance(t, torch.Tensor)
        else np.asarray(t), stacked)]

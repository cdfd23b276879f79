"""Pipeline parallelism (GPipe and 1F1B schedules) on the group machinery.

Counterpart of ``horovod_tpu/parallel/pipeline.py``. A *pipeline group*
is an ``hvd`` group whose rank r hosts stage r of a layer-partitioned
model; activations hop stage to stage around the group's ring and
microbatches fill the pipeline GPipe-style (Huang et al. 2019).

The reference runs the schedule as one ``lax.scan`` over the ticks with a
``ppermute`` a tick. A rank here is a process: the scan is a Python loop
over the same ticks, and the hop is the ring hop of sequence parallelism
(``parallel/sequence.py::_shift``: a point-to-point exchange on the
group's process group, not registered in the program's schedule). The
host knows each rank's stage and tick, so a bubble runs no stage
arithmetic: its output is the zero the reference masks in. Every member
still makes every hop, the wrap-around one included, forward and (for
:func:`gpipe`, one autograd function over the whole schedule) backward; a
rank outside a subset group makes none and gets zeros.

``remat=True`` keeps each tick's stage input and runs the stage again in
the backward, apart from its hop, where the reference's
``jax.checkpoint`` also replays the ``ppermute``: the recompute moves no
extra bytes.

Constraint: every stage maps activations of one fixed shape and dtype to
the same shape and dtype; the first stage reads the microbatches, the last
stage's outputs are the pipeline's result. ``stage_fn(params, x)`` takes
this rank's stage parameters (a dict of tensors, or any pytree); an
``nn.Module`` as ``stage_fn`` is applied with
``torch.func.functional_call(module, params, (x,))``.

Every function but :func:`stage_split` runs inside ``hvd.spmd``, as in the
reference.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch
import torch.utils._pytree as pytree

from horovod_tpu_torch.core import context as _ctx
from horovod_tpu_torch.core import state as _state
from horovod_tpu_torch.core.state import HorovodError
from horovod_tpu_torch.ops import collectives as _coll
from horovod_tpu_torch.parallel.sequence import _shift


def _stage_caller(stage_fn) -> Callable:
    if isinstance(stage_fn, torch.nn.Module):
        return lambda params, x: torch.func.functional_call(
            stage_fn, params, (x,))
    return stage_fn


def _pipeline_group(fn_name: str, group: int):
    """(group, its size, this rank's stage; −1 outside it), after the
    reference's checks."""
    tctx = _ctx.current()
    if tctx is None:
        raise HorovodError(
            f"{fn_name} must be called inside an hvd.spmd-wrapped step "
            f"function (its stage hops lower to mesh collectives).")
    _coll._family_positions(tctx, group)
    g = _state.get_group(group)
    return g, g.size, g.group_rank_of(_state.global_rank())


class _GPipe(torch.autograd.Function):
    """The GPipe schedule of one member as one autograd function, so that
    its backward, like the reference's transpose of the scan, makes every
    hop back on every tick: autograd alone would run only the hops whose
    output reached the loss, and a ring's members would then disagree on
    the number of exchanges. The backward walks the ticks in reverse:
    hop the cotangent one stage back, add the last stage's output
    cotangent, and run the stage's vjp (recomputed from its saved input
    under ``remat``)."""

    @staticmethod
    def forward(ctx, microbatches, run, *leaves):
        call, spec, ring, n, grank, remat = run
        ctx.run, ctx.leaves, ctx.mb_like = run, leaves, microbatches
        if grank < 0:
            return torch.zeros_like(microbatches)
        m = microbatches.shape[0]
        zero = torch.zeros_like(microbatches[0])
        params = pytree.tree_unflatten(list(leaves), spec)
        outs = [zero] * m
        saved = {}
        buf = zero
        for t in range(m + n - 1):
            j = t - grank               # stage s works on microbatch t - s
            x = microbatches[min(t, m - 1)] if grank == 0 else buf
            y = zero
            if 0 <= j < m:
                if remat:
                    y = call(params, x)
                    saved[t] = x
                else:
                    with torch.enable_grad():
                        p = [q.detach().requires_grad_() for q in leaves]
                        xs = x.detach().requires_grad_()
                        yg = call(pytree.tree_unflatten(p, spec), xs)
                    saved[t] = (p, xs, yg)
                    y = yg.detach()
                if grank == n - 1:
                    outs[j] = y
            # Hand the activation on (the wrap-around hop into stage 0 is
            # overwritten by the next microbatch read).
            buf = _shift(y, ring, 1) if n > 1 else y
        ctx.saved, ctx.m = saved, m
        return torch.stack(outs)

    @staticmethod
    def backward(ctx, d_outs):
        call, spec, ring, n, grank, remat = ctx.run
        leaves = ctx.leaves
        if grank < 0:
            return (torch.zeros_like(ctx.mb_like), None,
                    *(torch.zeros_like(q) for q in leaves))
        m = ctx.m
        zero = torch.zeros_like(ctx.mb_like[0])
        d_mb = torch.zeros_like(ctx.mb_like) if grank == 0 else None
        grads = [None] * len(leaves)
        d_buf = zero
        for t in reversed(range(m + n - 1)):
            dy = _shift(d_buf, ring, -1) if n > 1 else d_buf
            j = t - grank
            d_buf = zero
            if not 0 <= j < m:
                continue
            if grank == n - 1:
                dy = dy + d_outs[j]
            with torch.enable_grad():
                if remat:
                    p = [q.detach().requires_grad_() for q in leaves]
                    xs = ctx.saved.pop(t).detach().requires_grad_()
                    y = call(pytree.tree_unflatten(p, spec), xs)
                else:
                    p, xs, y = ctx.saved.pop(t)
                *dparams, dx = torch.autograd.grad(
                    y, p + [xs], grad_outputs=dy, allow_unused=True)
            grads = [a if d is None else d if a is None else a + d
                     for a, d in zip(grads, dparams)]
            if dx is not None:
                if grank == 0:
                    d_mb[min(t, m - 1)] += dx
                else:
                    d_buf = dx
        return (d_mb, None, *grads)


def gpipe(stage_fn: Callable, stage_params, microbatches, group: int = 0,
          remat: bool = True):
    """Run ``microbatches`` (M, mb, ...) through the group's pipeline.

    ``stage_fn(params, x) -> y``: one stage's computation, applied by each
    rank to its own ``stage_params`` (:func:`stage_split`).
    ``microbatches`` is read by the first stage (other ranks' are
    ignored). Returns (M, mb, ...) outputs valid on the last stage's rank
    and zero elsewhere: mask the loss to the last stage
    (``loss if hvd.rank(group) == n - 1 else 0``) so it counts once;
    gradients then flow backward through the pipeline, one hop back a
    tick on every member, to every stage's parameters.

    Non-members of a subset ``group`` get all-zero outputs (and zero
    gradients).
    """
    ring, n, grank = _pipeline_group("gpipe", group)
    leaves, spec = pytree.tree_flatten(stage_params)
    run = (_stage_caller(stage_fn), spec, ring, n, grank, remat)
    return _GPipe.apply(microbatches, run, *leaves)


def pipeline_1f1b(stage_fn: Callable, stage_params, microbatches,
                  loss_fn: Callable, targets=None, group: int = 0):
    """One-forward-one-backward (PipeDream-flush) pipeline schedule.

    Each stage holds at most ``2(n-1)+1`` in-flight microbatch inputs —
    O(n), independent of M — where :func:`gpipe` keeps all M microbatches'
    residuals alive. Every tick has one forward and one backward slot for
    every stage (warmup ticks idle the backward half, drain ticks the
    forward half), over ``M + 2(n-1)`` ticks.

    Schedule (stage s, microbatch j, tick t): forward at ``t = s + j``;
    the last stage computes the loss and its cotangent the same tick;
    backward at ``t = 2(n-1) - s + j``, cotangents hopping one stage up
    the ring per tick. Residuals are a FIFO of stage inputs; the backward
    runs the stage again under ``torch.enable_grad()`` and takes
    ``torch.autograd.grad`` of it (the reference's ``jax.vjp``).

    ``stage_fn(params, x) -> y`` as in :func:`gpipe`;
    ``loss_fn(y[, target]) -> scalar`` is the per-microbatch loss applied
    on the last stage (mean over microbatches); ``targets``: optional
    (M, ...) indexed alongside the microbatches.

    Returns ``(loss, grads)``: ``loss`` — the mean microbatch loss,
    broadcast to every member (zero on non-members); ``grads`` — d(loss)/
    d(stage_params) of this rank's stage, shaped like ``stage_params``
    (zeros on non-members). The function computes its own backward:
    differentiating through it is not supported; take the returned grads.
    """
    ring, n, grank = _pipeline_group("pipeline_1f1b", group)
    m = microbatches.shape[0]
    depth = 2 * (n - 1) + 1             # residual FIFO: the O(n) bound
    leaves, spec = pytree.tree_flatten(stage_params)
    leaves = [p.detach() for p in leaves]
    grads = [torch.zeros_like(p) for p in leaves]
    loss_acc = torch.zeros((), dtype=torch.float32,
                           device=microbatches.device)
    if grank >= 0:
        call = _stage_caller(stage_fn)
        zero = torch.zeros_like(microbatches[0])
        resid = [zero] * depth
        buf_fwd = buf_bwd = zero
        last = grank == n - 1
        for t in range(m + 2 * (n - 1)):
            # ---- forward slot: stage s runs microbatch fj = t - s --------
            fj = t - grank
            x_in = microbatches[min(max(fj, 0), m - 1)] if grank == 0 \
                else buf_fwd
            resid[t % depth] = x_in
            y = zero
            if 0 <= fj < m:
                with torch.no_grad():
                    y = call(pytree.tree_unflatten(leaves, spec), x_in)

            # ---- backward slot: stage s runs microbatch bj ----------------
            # bj = t - (2(n-1) - s): cotangents left the last stage n-1-s
            # ticks ago and hopped one stage per tick.
            bj = t - (2 * (n - 1) - grank)
            dx = zero
            if 0 <= bj < m:
                # Its residual was written at tick s + bj.
                x_saved = resid[(t - 2 * (n - 1) + 2 * grank) % depth]
                with torch.enable_grad():
                    p = [leaf.requires_grad_() for leaf in
                         (q.detach() for q in leaves)]
                    xs = x_saved.detach().requires_grad_()
                    y_b = call(pytree.tree_unflatten(p, spec), xs)
                    if last:
                        yl = y_b.detach().requires_grad_()
                        tgt = () if targets is None else (targets[bj],)
                        loss_b = loss_fn(yl, *tgt)
                        (dldy,) = torch.autograd.grad(loss_b, yl)
                        # Mean over microbatches: each cotangent is / M.
                        dy = dldy / m
                        loss_acc = loss_acc + loss_b.detach().float() / m
                    else:
                        dy = buf_bwd
                    *dparams, dx = torch.autograd.grad(
                        y_b, p + [xs], grad_outputs=dy, allow_unused=True)
                grads = [acc if d is None else acc + d
                         for acc, d in zip(grads, dparams)]
                dx = torch.zeros_like(xs) if dx is None else dx

            # ---- ring hops -------------------------------------------------
            buf_fwd = _shift(y, ring, 1) if n > 1 else y
            buf_bwd = _shift(dx, ring, -1) if n > 1 else dx

    # Broadcast the loss from the last stage to every member.
    loss = _coll.broadcast(loss_acc, root_rank=n - 1, group=group)
    if loss is None:
        loss = torch.zeros_like(loss_acc)
    return loss, pytree.tree_unflatten(grads, spec)


def stage_split(layers: Sequence, group: int = 0):
    """This rank's stage of per-layer parameters: ``layers[r]`` for group
    rank r (the reference stacks every rank's). ``layers`` must have
    exactly the group's size entries; a rank outside a subset group gets
    ``layers[0]`` as a placeholder, as the reference fills non-members'
    rows."""
    g = _state.get_group(group)
    if len(layers) != g.size:
        raise HorovodError(
            f"stage_split got {len(layers)} stages for a {g.size}-rank "
            f"pipeline group.")
    sr = g.group_rank_of(_state.global_rank())
    return layers[sr if sr >= 0 else 0]

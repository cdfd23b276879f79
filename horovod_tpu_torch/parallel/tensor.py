"""Tensor parallelism (Megatron-style sharded matmuls) on the group machinery.

Counterpart of ``horovod_tpu/parallel/tensor.py``. A *tensor-parallel
family* is a tuple of group indices partitioning the world into TP units
(8 ranks as 4 TP pairs: ``hvd.init([[0,1],[2,3],[4,5],[6,7]])``, family
``(1, 2, 3, 4)``); the orthogonal partition is the *data-parallel family*
over which the sharded parameters' gradients are averaged
(``hvd.allreduce_gradients(g, group=(5, 6))``).

* :func:`column_parallel` — weight sharded on the output dim; a local
  matmul, activations come out sharded. No forward communication.
* :func:`row_parallel` — weight sharded on the input dim; a local matmul,
  then one family allreduce assembles the full output on every rank.

Megatron's ``f`` and ``g`` operators (:class:`_CopyToTp`,
:class:`_ReduceFromTp`) and the sequence-parallel boundaries
(:class:`_GatherSeq`, :class:`_ScatterSeq`) are autograd functions over the
family collectives (``ops/collectives.py``); each backward collective is
named ``name + "_bwd"`` and registered in the program's schedule, as the
reference's ``custom_vjp`` rules register theirs. Autograd may run a
backward on a thread of its own, so each function keeps the program
context of its forward and resumes it there.

One rank's arithmetic between its collectives is a function of its own,
:func:`attention_shard` and :func:`mlp_shard` (the partial product before
the family sum), so one card can replay a tp-rank block rank by rank.

Where the reference holds parameters rank-stacked, a process here is a
rank: :func:`shard_columns`/:func:`shard_rows` return this rank's shard.
Every function but those two runs inside ``hvd.spmd``, as in the
reference.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch
import torch.nn.functional as F

from horovod_tpu_torch.core import context as _ctx
from horovod_tpu_torch.core import state as _state
from horovod_tpu_torch.core.state import HorovodError
from horovod_tpu_torch.ops import collectives as _coll


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in the promoted dtype of the two (``jnp``'s rule: a bf16
    activation against fp32 weights computes in fp32)."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return torch.matmul(x.to(dt), w.to(dt))


def _bwd_name(name: str | None) -> str | None:
    return None if name is None else name + "_bwd"


def _family_layout(family: Sequence[int]):
    """(tp_index_of_world_rank, tp_size) for a family covering the world.

    Validates that the family's groups are pairwise disjoint, equally
    sized, and cover every rank of the world group — the preconditions for
    shard shapes to be the same on every rank.
    """
    world = _state.get_group(0)
    tp_of: dict[int, int] = {}
    sizes = set()
    for gi in family:
        g = _state.get_group(gi)
        sizes.add(g.size)
        for tp_idx, r in enumerate(g.ranks):
            if r in tp_of:
                raise HorovodError(
                    f"Tensor-parallel family {list(family)} is not pairwise "
                    f"disjoint: rank {r} appears twice.")
            tp_of[r] = tp_idx
    if len(sizes) != 1:
        raise HorovodError(
            f"Tensor-parallel family {list(family)} has unequal group sizes "
            f"{sorted(sizes)}; shards would not be SPMD-uniform.")
    missing = [r for r in world.ranks if r not in tp_of]
    if missing:
        raise HorovodError(
            f"Tensor-parallel family {list(family)} must cover the whole "
            f"mesh; ranks {missing} belong to no family group.")
    return tp_of, sizes.pop()


def shard_columns(w, family: Sequence[int]) -> torch.Tensor:
    """This rank's column shard ``(…, out/tp)`` of ``w`` ``(…, out)``, by
    its position in its family group (the reference returns every rank's,
    stacked)."""
    tp_of, tp = _family_layout(family)
    w = torch.as_tensor(w)
    out = w.shape[-1]
    if out % tp != 0:
        raise HorovodError(
            f"Output dim {out} is not divisible by the family's group "
            f"size {tp}.")
    cols = out // tp
    i = tp_of[_state.global_rank()]
    return w[..., i * cols:(i + 1) * cols].contiguous()


def shard_rows(w, family: Sequence[int]) -> torch.Tensor:
    """This rank's row shard ``(in/tp, …)`` of ``w`` ``(in, …)``."""
    tp_of, tp = _family_layout(family)
    w = torch.as_tensor(w)
    din = w.shape[0]
    if din % tp != 0:
        raise HorovodError(
            f"Input dim {din} is not divisible by the family's group "
            f"size {tp}.")
    rows = din // tp
    i = tp_of[_state.global_rank()]
    return w[i * rows:(i + 1) * rows].contiguous()


# -- the collectives' autograd functions -----------------------------------


class _CopyToTp(torch.autograd.Function):
    """Megatron's ``f``: forward identity (x is replicated within the TP
    group), backward family allreduce — the column shards' partial
    cotangents sum into the true dx. Each rank's gradient is then the
    gradient of its own loss, so replicated losses give replicated
    gradients without tp-degree factors."""

    @staticmethod
    def forward(ctx, x, family, name):
        ctx.family, ctx.name, ctx.prog = family, name, _ctx.current()
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        with _ctx.resume(ctx.prog):
            out = _coll.allreduce(g.contiguous(), group=ctx.family,
                                  average=False, name=_bwd_name(ctx.name))
        return out, None, None


class _ReduceFromTp(torch.autograd.Function):
    """Megatron's ``g``: forward family allreduce (the row shards' partial
    products sum into the full output), backward identity (the output is
    replicated within the TP group, so each rank's cotangent is already
    the full dy)."""

    @staticmethod
    def forward(ctx, y, family, name):
        return _coll.allreduce(y.contiguous(), group=family, average=False,
                               name=name)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def _copy_to_tp(x, family, name):
    return _CopyToTp.apply(x, tuple(family), name)


def _reduce_from_tp(y, family, name):
    return _ReduceFromTp.apply(y, tuple(family), name)


def _seq_first(x: torch.Tensor) -> torch.Tensor:
    """(B, T, E) ↔ (T, B, E): the family allgather and reducescatter work
    on dim 0."""
    return x.transpose(0, 1).contiguous()


class _GatherSeq(torch.autograd.Function):
    """Sequence-parallel gather (Megatron-SP's ``g`` boundary): forward
    all-gathers the sequence shards within each TP group, (B, T/tp, E) →
    (B, T, E); backward reduce-scatters the cotangent (each rank's partial
    dx of every position sums, and each rank keeps its shard)."""

    @staticmethod
    def forward(ctx, x_shard, family, name):
        ctx.family, ctx.name, ctx.prog = family, name, _ctx.current()
        full = _coll.allgather(_seq_first(x_shard), group=family, name=name)
        return full.transpose(0, 1)

    @staticmethod
    def backward(ctx, g):
        with _ctx.resume(ctx.prog):
            out = _coll.reducescatter(_seq_first(g), group=ctx.family,
                                      name=_bwd_name(ctx.name))
        return out.transpose(0, 1), None, None


class _ScatterSeq(torch.autograd.Function):
    """Sequence-parallel reduce-scatter: forward sums the TP ranks' partial
    outputs and shards the sequence, (B, T, E) → (B, T/tp, E); backward
    all-gathers the cotangent (every rank's partial contributed to every
    position, so each needs the full dy)."""

    @staticmethod
    def forward(ctx, y_partial, family, name):
        ctx.family, ctx.name, ctx.prog = family, name, _ctx.current()
        out = _coll.reducescatter(_seq_first(y_partial), group=family,
                                  name=name)
        return out.transpose(0, 1)

    @staticmethod
    def backward(ctx, g):
        with _ctx.resume(ctx.prog):
            out = _coll.allgather(_seq_first(g), group=ctx.family,
                                  name=_bwd_name(ctx.name))
        return out.transpose(0, 1), None, None


# -- one rank's arithmetic ---------------------------------------------------


def attention_shard(x, wq_shard, wk_shard, wv_shard, wo_shard, h_local: int,
                    causal: bool = True, sm_scale: float | None = None,
                    attn_impl: str = "auto") -> torch.Tensor:
    """One rank's arithmetic of :func:`tp_attention` between its two
    collectives: project ``x`` (B, T, E) onto this rank's ``h_local``
    heads, attend (:func:`~horovod_tpu_torch.parallel.sequence.
    local_attention`: B3/B4 on a CUDA tensor above 2048 tokens) and
    multiply by the row shard of the output projection. Returns the
    rank's partial output (B, T, E), before the family sum."""
    from horovod_tpu_torch.parallel.sequence import local_attention

    b, t, _ = x.shape

    def proj(w_shard):
        return matmul(x, w_shard).reshape(b, t, h_local, -1)

    attn = local_attention(proj(wq_shard), proj(wk_shard), proj(wv_shard),
                           causal=causal, sm_scale=sm_scale, impl=attn_impl)
    return matmul(attn.reshape(b, t, -1), wo_shard)


def mlp_shard(x, w1_shard, b1_shard, w2_shard,
              act: Callable = gelu) -> torch.Tensor:
    """One rank's arithmetic of the Megatron MLP between its collectives:
    ``act(x @ w1_shard + b1_shard) @ w2_shard``, the partial output before
    the family sum."""
    h = matmul(x, w1_shard)
    if b1_shard is not None:
        h = h + b1_shard
    return matmul(act(h), w2_shard)


# -- the public functions ----------------------------------------------------


def _require_traced(fn_name: str, why: str) -> None:
    if _ctx.current() is None:
        raise HorovodError(
            f"{fn_name} must be called inside an hvd.spmd-wrapped step "
            f"function ({why}).")


def column_parallel(x, w_shard, family: Sequence[int], b_shard=None,
                    name: str | None = None):
    """``x @ w_shard`` — weight sharded on the output dim, no forward
    communication.

    ``x``: (..., in) replicated within the TP group; ``w_shard``:
    (in, out/tp) this rank's columns. Returns (..., out/tp), the sharded
    activation a following :func:`row_parallel` consumes directly. The
    backward runs one family allreduce so dx sums every column block's
    contribution (the Megatron ``f`` operator)."""
    _require_traced("column_parallel",
                    "its backward psum lowers to a mesh collective")
    y = matmul(_copy_to_tp(x, family, name), w_shard)
    if b_shard is not None:
        y = y + b_shard
    return y


def row_parallel(x, w_shard, family: Sequence[int], b=None,
                 name: str | None = None):
    """``allreduce_family(x @ w_shard)`` — weight sharded on the input dim.

    ``x``: (..., in/tp) the sharded activation; ``w_shard``: (in/tp, out).
    The family allreduce assembles the full (..., out) on every rank;
    ``b`` is added after the sum so it is applied once, not tp times.
    Backward is identity (the Megatron ``g`` operator)."""
    _require_traced("row_parallel", "its psum lowers to a mesh collective")
    y = _reduce_from_tp(matmul(x, w_shard), family, name)
    if b is not None:
        y = y + b
    return y


def tp_attention(x, wq_shard, wk_shard, wv_shard, wo_shard,
                 family: Sequence[int], num_heads: int,
                 causal: bool = True, sm_scale: float | None = None,
                 attn_impl: str = "auto", name: str | None = None):
    """Megatron-style tensor-parallel self-attention: the heads are the
    sharded dimension.

    ``x``: (B, T, E) replicated within the TP group. ``wq/wk/wv_shard``:
    (E, (H/tp)·D) column shards; ``wo_shard``: ((H/tp)·D, E) row shard.
    Each rank attends over its own heads (:func:`attention_shard`;
    ``attn_impl`` as in ``local_attention``), and the output projection's
    family allreduce assembles the full (B, T, E). One collective forward
    (``name``), one backward (``name + "_qkv_bwd"``: one ``f`` operator for
    the three projections)."""
    _require_traced("tp_attention",
                    "its copy/psum operators lower to mesh collectives")
    _tp_of, tp = _family_layout(family)
    if num_heads % tp != 0:
        raise HorovodError(
            f"tp_attention needs num_heads ({num_heads}) divisible by the "
            f"family's group size ({tp}).")
    xr = _copy_to_tp(x, family, None if name is None else name + "_qkv")
    partial = attention_shard(xr, wq_shard, wk_shard, wv_shard, wo_shard,
                              num_heads // tp, causal, sm_scale, attn_impl)
    return _reduce_from_tp(partial, family, name)


def tp_mlp_sp(x_shard, w1_shard, b1_shard, w2_shard, b2,
              family: Sequence[int], act: Callable = gelu,
              name: str | None = None):
    """The Megatron sequence-parallel MLP block (Korthikanti et al. 2022):
    activations between TP blocks are sharded along the sequence within
    each TP group — (B, T/tp, E) in and out. One all-gather in
    (``name + "_ag"``), one reduce-scatter out (``name``); the gather's
    backward is a reduce-scatter and vice versa, so no ``f`` operator is
    needed. The family must cover the program's group (the family
    allgather/reducescatter requirement)."""
    gname = None if name is None else name + "_ag"
    x_full = _GatherSeq.apply(x_shard, tuple(family), gname)   # (B, T, E)
    y_partial = mlp_shard(x_full, w1_shard, b1_shard, w2_shard, act)
    y_shard = _ScatterSeq.apply(y_partial, tuple(family), name)
    if b2 is not None:
        y_shard = y_shard + b2
    return y_shard


def tp_mlp(x, w1_shard, b1_shard, w2_shard, b2, family: Sequence[int],
           act: Callable = gelu, name: str | None = None):
    """The Megatron MLP block: column-parallel expand (its ``f`` operator
    named ``name + "_col"``), activation, row-parallel contract (``name``)
    — one collective in each direction."""
    _require_traced("column_parallel",
                    "its backward psum lowers to a mesh collective")
    xr = _copy_to_tp(x, family, None if name is None else name + "_col")
    y = _reduce_from_tp(mlp_shard(xr, w1_shard, b1_shard, w2_shard, act),
                        family, name)
    if b2 is not None:
        y = y + b2
    return y

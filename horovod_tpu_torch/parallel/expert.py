"""Expert parallelism (Mixture-of-Experts) on the group machinery.

Counterpart of ``horovod_tpu/parallel/expert.py``. An *expert-parallel
group* is an ``hvd`` group whose ranks each host one expert, and the token
exchange rides :func:`~horovod_tpu_torch.ops.collectives.alltoall`, the
transport Ulysses attention uses, through its autograd function
(``collectives.AllToAll``: the backward is the same exchange).

The layer is Switch-Transformer-style routing (Fedus et al. 2021; GShard's
top-2 with ``k=2``):

1. A router picks each token's expert and gate probability.
2. Tokens are packed into per-expert capacity buffers (capacity
   ``C = ceil(tokens/n · capacity_factor)`` per source rank); overflow
   tokens are dropped — their output is 0, the residual carries them.
3. One all-to-all sends each buffer to the expert's owner; the expert MLP
   runs on everything it received; a second all-to-all returns the
   results.
4. Each token's output is its gate probability times its expert's output.

Dense products with static shapes, no sorting. The routing arithmetic
(softmax, cumsum positions, the dispatch products, the aux loss) is fp32;
the send buffer is cast to ``x``'s dtype before the exchange.

Two choices of the port's own (ROADMAP §C): ``jax.lax.top_k`` breaks a tie
toward the lower expert index and ``torch.topk`` promises no order, so the
router takes its first choice by ``argmax`` (the first maximum) and its
second by ``argmax`` with the first masked out; and ``jax.nn.one_hot`` of
an index past the capacity is the zero row (how overflow tokens drop out)
where ``F.one_hot`` raises, so the dispatch compares the positions with
``arange(cap)``.

Every function runs inside ``hvd.spmd``, as in the reference.
"""

from __future__ import annotations

import math

import torch

from horovod_tpu_torch.core import context as _ctx
from horovod_tpu_torch.core import state as _state
from horovod_tpu_torch.core.state import HorovodError
from horovod_tpu_torch.ops import collectives as _coll
from horovod_tpu_torch.parallel.tensor import gelu, matmul


def moe_capacity(tokens_per_rank: int, num_experts: int,
                 capacity_factor: float = 1.25) -> int:
    """Per-(source rank, expert) capacity: each rank sends at most this many
    tokens to each expert."""
    return max(1, math.ceil(tokens_per_rank * capacity_factor / num_experts))


def top_k(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k(probs, k)`` for k ≤ 2 along the last dim, ties to the
    lower index: ``argmax`` (the first maximum), then ``argmax`` again with
    that position masked out. Returns (values, indices), each (..., k)."""
    first = probs.argmax(dim=-1, keepdim=True)
    idx = [first]
    if k == 2:
        masked = probs.scatter(-1, first, float("-inf"))
        idx.append(masked.argmax(dim=-1, keepdim=True))
    top_e = torch.cat(idx, dim=-1)
    return probs.gather(-1, top_e), top_e


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """fp32 one-hot rows of ``idx``; an index outside [0, n) gives the zero
    row, as ``jax.nn.one_hot`` does."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def route(xf, gate_w, cap: int, k: int = 1):
    """The router and the capacity packing of one source rank's tokens
    ``xf`` (T, E) over ``n = gate_w.shape[-1]`` experts: ``(probs, gates,
    dispatches, first)`` — the fp32 softmax (T, n), one gate (T,) and one fp32
    dispatch mask (T, n, cap) a choice. A token's position in its
    expert's buffer follows source order (for k=2 every first choice
    precedes the second choices); a position ≥ cap matches no column, so
    the token drops out. Also returns ``first``, the fp32 one-hot (T, n)
    of each token's first choice, kept or dropped."""
    n = gate_w.shape[-1]
    probs = torch.softmax(matmul(xf, gate_w).float(), dim=-1)
    top_p, top_e = top_k(probs, k)                         # (T, k)
    onehot_1 = _one_hot(top_e[:, 0], n)                    # (T, n)
    pos1 = torch.cumsum(onehot_1, dim=0) * onehot_1 - 1.0
    pos_in_1 = (pos1 * onehot_1).sum(-1)
    d1 = onehot_1[:, :, None] * _one_hot(pos_in_1.long(), cap)[:, None, :]
    if k == 1:
        return probs, [top_p[:, 0]], [d1], onehot_1
    onehot_2 = _one_hot(top_e[:, 1], n)
    count1 = onehot_1.sum(0)                               # (n,) firsts
    pos2 = torch.cumsum(onehot_2, dim=0) * onehot_2 - 1.0
    pos_in_2 = ((pos2 * onehot_2).sum(-1)
                + (onehot_2 * count1[None, :]).sum(-1))
    d2 = onehot_2[:, :, None] * _one_hot(pos_in_2.long(), cap)[:, None, :]
    denom = torch.clamp_min(top_p[:, 0] + top_p[:, 1], 1e-9)
    return (probs, [top_p[:, 0] / denom, top_p[:, 1] / denom], [d1, d2],
            onehot_1)


def dispatch(xf, dispatches) -> torch.Tensor:
    """The send buffer (n, cap, E), fp32: each expert's capacity slots
    filled with the tokens routed there."""
    return torch.einsum("tec,td->ecd", sum(dispatches), xf.float())


def expert_mlp(recv, w1, b1, w2, b2, act=gelu) -> torch.Tensor:
    """One expert over every token it received, (n, cap, E) → (n, cap, E)
    (one slab a source rank)."""
    n, cap, e = recv.shape
    hidden = act(matmul(recv.reshape(n * cap, e), w1) + b1)
    return (matmul(hidden, w2) + b2).reshape(n, cap, e)


def combine(back, gates, dispatches) -> torch.Tensor:
    """The gate-weighted unpack of the returned buffers (n, cap, E) into
    the source rank's tokens (T, E), fp32; dropped tokens get 0."""
    backf = back.float()
    return sum(g[:, None] * torch.einsum("tec,ecd->td", d, backf)
               for g, d in zip(gates, dispatches))


def aux_loss(probs, first) -> torch.Tensor:
    """``n · Σ_e f_e · P_e``: f_e the share of tokens whose first choice is
    e (``first`` from :func:`route`), P_e the mean router probability of
    e."""
    n = probs.shape[-1]
    return n * (first.mean(0) * probs.mean(0)).sum()


def moe_mlp(x, gate_w, w1, b1, w2, b2, group=0,
            capacity_factor: float = 1.25, act=gelu,
            k: int = 1, name: str | None = None):
    """Top-k mixture-of-experts MLP; this rank hosts expert ``hvd.rank(group)``.

    ``x``: (B, T, E) this rank's tokens. ``gate_w``: (E, n) router weights
    (replicated across the group — average its gradient like any
    replicated parameter). ``w1``: (E, F), ``b1``: (F,), ``w2``: (F, E),
    ``b2``: (E,) — this rank's expert (keep it out of the gradient
    allreduce: its gradient belongs to its owner).

    ``k``: 1 = Switch-style top-1 routing (gate = the winning softmax
    probability); 2 = GShard-style top-2 (gates renormalized over the two
    choices; within each expert's capacity buffer, first-choice tokens
    take priority over second-choice ones, each in source order).

    Returns ``(out, aux_loss)``: ``out`` (B, T, E) with dropped tokens 0
    (add the residual around this layer), and the load-balancing
    auxiliary loss ``n · Σ_e f_e · P_e`` over first choices (multiply by
    your aux weight and add to the task loss).

    ``group`` may be a single group covering the program's group (pure
    EP), or a family — a tuple of equal-size disjoint groups partitioning
    it (DP × EP: each group is an independent set of n experts, tokens
    exchange within their own group; this rank hosts expert
    ``hvd.rank(g)`` of the family group it belongs to). A strict-subset
    single EP group is not supported.
    """
    tctx = _ctx.current()
    if tctx is None:
        raise HorovodError(
            "moe_mlp must be called inside an hvd.spmd-wrapped step "
            "function (its all-to-alls lower to mesh collectives).")
    prog = _state.get_group(tctx.group_index)
    me = _state.global_rank()
    if isinstance(group, (list, tuple)):
        sizes = {_state.get_group(gi).size for gi in group}
        if len(sizes) != 1:
            raise HorovodError(
                f"moe_mlp group family {list(group)} has unequal group "
                f"sizes {sorted(sizes)}.")
        n = sizes.pop()  # coverage/disjointness validated by the alltoall
        group = tuple(group)
        ring = next((g for g in map(_state.get_group, group)
                     if me in g.ranks), None)
    else:
        g = _state.get_group(group)
        if tuple(sorted(g.ranks)) != tuple(sorted(prog.ranks)):
            raise HorovodError(
                f"moe_mlp group {group} must cover the program's whole mesh "
                f"(group has {g.size} ranks, mesh has {prog.size}).")
        n, ring = g.size, g
    b, t, e = x.shape
    cap = moe_capacity(b * t, n, capacity_factor)
    if gate_w.shape[-1] != n:
        raise HorovodError(
            f"Router width {gate_w.shape[-1]} != number of experts {n} "
            f"(the group size).")
    if k not in (1, 2):
        raise HorovodError(f"moe_mlp supports k=1 or k=2, got {k}.")
    xf = x.reshape(b * t, e)
    probs, gates, dispatches, first = route(xf, gate_w, cap, k)
    # Pack, exchange, run the expert, exchange back.
    send = dispatch(xf, dispatches)
    recv = _coll.AllToAll.apply(send.to(x.dtype), group, ring,
                                None if name is None else name + "_fwd")
    out_buf = expert_mlp(recv, w1, b1, w2, b2, act)
    back = _coll.AllToAll.apply(out_buf, group, ring,
                                None if name is None else name + "_bwd")
    combined = combine(back, gates, dispatches)
    aux = aux_loss(probs, first)
    return combined.reshape(b, t, e).to(x.dtype), aux

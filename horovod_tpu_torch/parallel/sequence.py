"""Sequence (context) parallelism — ring and Ulysses attention — and the
single-device ``local_attention``.

Counterpart of ``horovod_tpu/parallel/sequence.py``. A context-parallel
group is an ``hvd`` group whose ranks hold consecutive shards of the
sequence axis (or, with ``layout='zigzag'``, one early and one late chunk
each). Tensors are the local shard, ``(batch, seq_local, heads,
head_dim)``.

* :func:`ring_attention` — the K/V shards travel around the group's ring
  while each rank folds them into an online softmax over its own queries:
  exact attention over the whole sequence. One ring step's arithmetic is
  :func:`ring_step` (the flash body: one :func:`~horovod_tpu_torch.ops.
  flash_attention.flash_attention_lse` per chunk pair, kernels B3/B4 on a
  CUDA tensor, merged by the partials' log-sum-exp; the blockwise body:
  the plain online-softmax update, optionally in ``block_k`` sub-blocks).
* :func:`ulysses_attention` — two all-to-alls swap the sequence axis
  against the head axis (``hvd.alltoall``), so each rank attends over the
  whole sequence for H/g of the heads.

Where the reference's ring moves K/V by ``lax.ppermute`` inside one
compiled program, a rank here is a process: a hop is a point-to-point
exchange on the ring's process group (each member sends to the next member
and receives from the previous one, both posted together), wrapped in a
``torch.autograd.Function`` whose backward hops the gradient the other way
(the transpose of a permutation). A group family runs its rings side by
side, each rank on its own group's process group; a rank outside the group
keeps its own shard and computes local attention over it. Hops are not
registered in the program's schedule, as the reference registers no
``ppermute``: every member of a ring makes the same number of hops (g − 1),
so no rank waits on a hop another skips. Each ring step runs under
``torch.utils.checkpoint`` (the reference's ``jax.checkpoint``): the
backward recomputes the step's scores (on the card: B3 again) from the
step's inputs instead of keeping them.

Both functions run inside an ``hvd.spmd`` program, as in the reference.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from horovod_tpu_torch.core import context as _ctx
from horovod_tpu_torch.core import state as _state
from horovod_tpu_torch.core.state import HorovodError
from horovod_tpu_torch.ops import collectives as _coll
from horovod_tpu_torch.ops import flash_attention as _fa

_NEG_INF = -1e30  # large-negative mask (not -inf: keeps exp/max NaN-free)


def _require_traced(fn_name: str) -> _ctx.ProgramContext:
    tctx = _ctx.current()
    if tctx is None:
        raise HorovodError(
            f"{fn_name} must be called inside an hvd.spmd-wrapped step "
            f"function (it lowers to mesh collectives).")
    return tctx


def _group_ring(tctx: _ctx.ProgramContext, group):
    """(ring, group size, group rank) for a group or a group family.

    ``ring``: the group this rank is a member of (for a family, the one
    family group it is in), whose process group carries its hops; None on
    a rank outside every group, whose group rank is −1. A family's groups
    must be equal in size and pairwise disjoint, and every member must lie
    in the program's group (the reference's texts)."""
    me = _state.global_rank()
    if isinstance(group, (tuple, list)):
        fam = tuple(group)
        if not fam:
            raise HorovodError("ring_attention family must be non-empty.")
        sizes = {_state.get_group(g).size for g in fam}
        if len(sizes) != 1:
            raise HorovodError(
                f"ring_attention family groups must have equal sizes; got "
                f"{sorted(_state.get_group(g).size for g in fam)}.")
        flat = [p for g in fam for p in _coll._family_positions(tctx, g)]
        if len(set(flat)) != len(flat):
            raise HorovodError(
                "ring_attention family groups must be pairwise disjoint.")
        ring = next((g for g in map(_state.get_group, fam)
                     if me in g.ranks), None)
        return (ring, sizes.pop(),
                -1 if ring is None else ring.group_rank_of(me))
    g = _state.get_group(group)
    _coll._family_positions(tctx, group)
    grank = g.group_rank_of(me)
    return (g if grank >= 0 else None), g.size, grank


# -- the hop ------------------------------------------------------------------


def _shift(x: torch.Tensor, ring: _state.Group, shift: int) -> torch.Tensor:
    """Send ``x`` to the member ``shift`` places on and receive from the
    member ``shift`` places back, on the ring's process group (peers by
    global rank). Both are posted together, so a two-member ring, whose
    two peers are one rank, does not deadlock."""
    n = ring.size
    me = ring.group_rank_of(_state.global_rank())
    x = x.contiguous()
    out = torch.empty_like(x)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, x, ring.ranks[(me + shift) % n],
                   group=ring.pg),
        dist.P2POp(dist.irecv, out, ring.ranks[(me - shift) % n],
                   group=ring.pg)])
    for r in reqs:
        r.wait()
    return out


class _RingHop(torch.autograd.Function):
    """One hop forward around the ring; the backward hops the gradient
    back (a permutation's transpose is its inverse)."""

    @staticmethod
    def forward(ctx, x, ring):
        ctx.ring = ring
        return _shift(x, ring, 1)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.ring, -1), None


def _hop(x: torch.Tensor, ring: _state.Group) -> torch.Tensor:
    if x.dtype.is_floating_point:
        return _RingHop.apply(x, ring)
    return _shift(x, ring, 1)


# -- one ring step's arithmetic ---------------------------------------------------


def _lse_merge(m, l, acc, o_s, lse_s):
    """Merge a partial attention result into the running (m, l, acc) by its
    log-sum-exp — the exact softmax-weighted average both ring layouts use.
    A partial whose rows see no key arrives with lse ≈ −6.9e29 (B3 and its
    plain version alike) and o = 0: above the running max's −1e30 start,
    so it takes weight 1 with a zero output, and the first live partial
    then scales it by exp(−6.9e29 − lse) = 0. Nothing is NaN."""
    m_new = torch.maximum(m, lse_s)
    alpha = torch.exp(m - m_new)
    w = torch.exp(lse_s - m_new)
    return (m_new, l * alpha + w,
            acc * alpha[..., None] + w[..., None] * o_s.float())


def _block_attend(q, k, v, m, l, acc, q_off, kv_off, causal, sm_scale,
                  qseg=None, kvseg=None, window=None):
    """One blockwise-softmax accumulation step (the flash-attention update).

    q: (B, H, Tq, D); k/v: (B, Hkv, Tk, D) with H % Hkv == 0 (GQA heads are
    expanded locally, so the ring only ever carries Hkv heads); m/l:
    (B, H, Tq) running max / normalizer; acc: (B, H, Tq, D) running
    numerator. Offsets are global sequence positions of the blocks (for
    causal masking across shards). ``qseg``/``kvseg``: optional (B, Tq)/
    (B, Tk) packed-sequence segment ids.
    """
    if k.shape[1] != q.shape[1]:
        reps = q.shape[1] // k.shape[1]
        k = k.repeat_interleave(reps, dim=1)
        v = v.repeat_interleave(reps, dim=1)
    # bf16 operands, fp32 products: the einsum's preferred_element_type.
    s = (q.float() @ k.float().transpose(-1, -2)) * sm_scale
    tq, tk = q.shape[2], k.shape[2]
    if causal:
        qpos = q_off + torch.arange(tq, device=q.device)[:, None]
        kpos = kv_off + torch.arange(tk, device=q.device)[None, :]
        s = torch.where(qpos >= kpos, s, _NEG_INF)
        if window is not None:
            s = torch.where(kpos > qpos - window, s, _NEG_INF)
    if qseg is not None:
        seg_ok = qseg[:, None, :, None] == kvseg[:, None, None, :]
        s = torch.where(seg_ok, s, _NEG_INF)
    m_new = torch.maximum(m, s.amax(-1))
    # Rows with every position masked so far keep m at its start and
    # alpha = 1; their p would be exp(0) on masked positions: zero it, so
    # no result depends on which shard the ring delivers first.
    alpha = torch.exp(m - m_new)
    p = torch.exp(s - m_new[..., None])
    p = torch.where((m_new <= _NEG_INF * 0.5)[..., None], 0.0, p)
    return (m_new, l * alpha + p.sum(-1),
            acc * alpha[..., None] + p @ v.float())


def ring_state(q: torch.Tensor, chunks: int = 1, impl: str = "flash"):
    """A fresh running state for :func:`ring_step`: one ``(m, l, acc)`` a
    query chunk, fp32, ``m`` at −1e30. ``q`` is the shard in the impl's
    layout (:func:`ring_step`)."""
    if impl == "flash":
        b, t, h, d = q.shape
        rows = (b, t // chunks, h)
    else:
        b, h, t, d = q.shape
        rows = (b, h, t // chunks)
    return tuple((torch.full(rows, _NEG_INF, device=q.device),
                  torch.zeros(rows, device=q.device),
                  torch.zeros(rows + (d,), device=q.device))
                 for _ in range(chunks))


def ring_step(q, k, v, state, q_offs, kv_offs, causal: bool = True,
              sm_scale=None, impl: str = "flash", block_k=None,
              q_segment_ids=None, kv_segment_ids=None, window=None):
    """One ring step's arithmetic, without the hop: fold the K/V shard this
    rank holds at the step into the running ``state`` (:func:`ring_state`)
    and return the new state.

    The shards split into ``len(q_offs)`` equal chunks (one under the
    contiguous layout, two under zigzag), chunk ``i`` of the queries at
    global position ``q_offs[i]`` and chunk ``j`` of the keys at
    ``kv_offs[j]``; every (query chunk, key chunk) pair is attended, query
    chunk first, and merged into its query chunk's state.

    ``impl='flash'``: q (B, T, H, D), k/v (B, T, Hkv, D), each pair through
    :func:`~horovod_tpu_torch.ops.flash_attention.flash_attention_lse` at
    the pair's offsets (B3/B4 on a CUDA tensor, their plain versions on a
    CPU one), merged by :func:`_lse_merge`. ``impl='blockwise'``: q
    (B, H, T, D), k/v (B, Hkv, T, D), each pair by :func:`_block_attend`,
    in ``block_k`` sub-blocks of the key chunk (None: the whole chunk).
    Segment ids are (B, T) for the whole shard."""
    n = len(q_offs)
    flash = impl == "flash"
    tdim = 1 if flash else 2
    qc = q.chunk(n, dim=tdim)
    kc, vc = k.chunk(n, dim=tdim), v.chunk(n, dim=tdim)
    qsc = (q_segment_ids.chunk(n, dim=1) if q_segment_ids is not None
           else (None,) * n)
    ksc = (kv_segment_ids.chunk(n, dim=1) if kv_segment_ids is not None
           else (None,) * n)
    out = []
    for qi in range(n):
        m, l, acc = state[qi]
        for ki in range(n):
            if flash:
                seg = ({} if qsc[qi] is None else
                       dict(q_segment_ids=qsc[qi], kv_segment_ids=ksc[ki]))
                o_s, lse_s = _fa.flash_attention_lse(
                    qc[qi], kc[ki], vc[ki], causal, sm_scale, q_offs[qi],
                    kv_offs[ki], window=window, **seg)
                m, l, acc = _lse_merge(m, l, acc, o_s, lse_s)
                continue
            tk = kc[ki].shape[2]
            bk = tk if block_k is None else block_k
            for j in range(0, tk, bk):
                m, l, acc = _block_attend(
                    qc[qi], kc[ki][:, :, j:j + bk], vc[ki][:, :, j:j + bk],
                    m, l, acc, q_offs[qi], kv_offs[ki] + j, causal,
                    sm_scale, qsc[qi],
                    None if ksc[ki] is None else ksc[ki][:, j:j + bk],
                    window)
        out.append((m, l, acc))
    return tuple(out)


def ring_output(state, impl: str, dtype) -> torch.Tensor:
    """The attention output ``(B, T, H, D)`` in ``dtype`` of a finished
    ring's state: each chunk's ``acc / l``, the chunks concatenated."""
    outs = []
    for _m, l, acc in state:
        o = acc / l.clamp_min(1e-20)[..., None]
        outs.append(o if impl == "flash" else o.transpose(1, 2))
    return torch.cat(outs, dim=1).to(dtype)


def _flat(state) -> tuple:
    return tuple(t for chunk in state for t in chunk)


def _unflat(flat) -> tuple:
    return tuple(tuple(flat[i:i + 3]) for i in range(0, len(flat), 3))


def _checkpointed_step(q, kv, qseg, kvseg, *flat, q_offs, kv_offs, **kw):
    """:func:`ring_step` over flat tensor arguments, as
    ``torch.utils.checkpoint`` takes them."""
    return _flat(ring_step(q, kv[0], kv[1], _unflat(flat), q_offs, kv_offs,
                           q_segment_ids=qseg, kv_segment_ids=kvseg, **kw))


def chunk_offsets(grank: int, gsize: int, t_local: int, n: int) -> tuple:
    """Global start positions of the ``n`` chunks of group rank ``grank``'s
    shard of ``t_local`` (the offsets :func:`ring_step` takes): ``[r·T]``
    contiguous (n = 1), ``[r·c, (2g − 1 − r)·c]`` zigzag (n = 2, c =
    T/2)."""
    if n == 1:
        return (grank * t_local,)
    c = t_local // 2
    return (grank * c, (2 * gsize - 1 - grank) * c)


def _ring(q, k, v, ring, gsize, grank, chunks, impl, block_k, causal,
          sm_scale, q_segment_ids, kv_segment_ids, window):
    """The ring: ``gsize`` steps on a member (a hop before each but the
    first), one on a non-member, which attends over its own shard at the
    positions of group rank 0."""
    t_local = q.shape[1]
    flash = impl == "flash"
    qb = q.to(torch.bfloat16)
    kv = torch.stack([k.to(torch.bfloat16), v.to(torch.bfloat16)])
    if not flash:
        qb = qb.transpose(1, 2)
        kv = kv.transpose(2, 3)
    member = grank >= 0
    grank_c = max(grank, 0)
    q_offs = chunk_offsets(grank_c, gsize, t_local, chunks)
    kvseg = kv_segment_ids
    flat = _flat(ring_state(qb, chunks, impl))
    step = functools.partial(_checkpointed_step, causal=causal,
                             sm_scale=sm_scale, impl=impl, block_k=block_k,
                             window=window)
    for s in range(gsize if member else 1):
        if s > 0:
            kv = _hop(kv, ring)
            if kvseg is not None:
                kvseg = _hop(kvseg, ring)
        src = (grank_c - s) % gsize
        flat = checkpoint(
            step, qb, kv, q_segment_ids, kvseg, *flat, q_offs=q_offs,
            kv_offs=chunk_offsets(src, gsize, t_local, chunks),
            use_reentrant=False, preserve_rng_state=False)
    return ring_output(_unflat(flat), impl, q.dtype)


def ring_attention(q, k, v, group=0, causal: bool = True,
                   sm_scale: float | None = None,
                   block_k: int | None = None, impl: str = "auto",
                   q_segment_ids=None, kv_segment_ids=None,
                   layout: str = "contiguous", window: int | None = None):
    """Exact attention over a sequence sharded across the group's ranks.

    ``group`` may also be a *family* (tuple of pairwise-disjoint,
    equal-size group indices): every group runs its own ring side by side
    — the DP×SP composition. Ranks outside every family group compute
    plain local attention on their shard.

    ``q``: local shard, ``(B, T_local, H, D)``; ``k``/``v``:
    ``(B, T_local, Hkv, D)`` with H a multiple of Hkv (the ring carries
    only the Hkv K/V heads). Returns the local shard of the attention
    output, same shape and dtype as ``q``.

    ``q_segment_ids``/``kv_segment_ids``: optional (B, T_local) integer
    packed-sequence ids of the local shard; the kv ids travel around the
    ring with their K/V shard.

    ``layout``: ``'contiguous'`` — rank i holds global positions
    ``[i*T_local, (i+1)*T_local)``; ``'zigzag'`` — rank i holds chunks
    ``i`` and ``2g-1-i`` of a 2g-way split (:func:`zigzag_shard` /
    :func:`zigzag_unshard`), which balances the causal mask's work across
    the ranks; each step then attends four (q-chunk, kv-chunk) pairs and
    ``block_k`` does not apply.

    ``impl``: ``'flash'`` runs every pair through
    :func:`~horovod_tpu_torch.ops.flash_attention.flash_attention_lse` and
    merges the partials by their log-sum-exp (B3/B4 on a CUDA tensor,
    their plain versions on a CPU one); ``'blockwise'`` is the plain
    online softmax, to which ``block_k`` sub-blocking applies (it must
    divide T_local; default T_local up to 2048, else the largest divisor
    up to 1024); ``'auto'`` is ``'flash'`` on a CUDA tensor and
    ``'blockwise'`` on a CPU tensor, and ``'blockwise'`` whenever
    ``block_k`` is given. Both compute the QK and PV products from bf16
    operands with fp32 accumulation.

    ``window``: sliding-window attention (causal only).
    """
    tctx = _require_traced("ring_attention")
    ring, gsize, grank = _group_ring(tctx, group)
    if q.ndim != 4:
        raise HorovodError(
            f"ring_attention expects (batch, seq, heads, head_dim); got "
            f"shape {list(q.shape)}.")
    b, t_local, h, d = q.shape
    hkv = k.shape[2]
    if h % hkv != 0:
        raise HorovodError(
            f"ring_attention needs q heads ({h}) divisible by kv heads "
            f"({hkv}).")
    if (q_segment_ids is None) != (kv_segment_ids is None):
        raise HorovodError(
            "ring_attention needs q_segment_ids and kv_segment_ids "
            "together.")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    if layout not in ("contiguous", "zigzag"):
        raise HorovodError(f"Unknown ring_attention layout {layout!r}.")
    on_card = q.device.type == "cuda"
    if layout == "zigzag":
        if impl == "auto":
            impl = "flash" if on_card else "blockwise"
        if impl not in ("flash", "blockwise"):
            raise HorovodError(f"Unknown ring_attention impl {impl!r}.")
        if block_k is not None:
            raise HorovodError(
                "ring_attention layout='zigzag' consumes whole chunks per "
                "step; block_k sub-blocking does not apply.")
        if t_local % 2 != 0:
            raise HorovodError(
                f"zigzag layout needs an even local sequence length "
                f"(got {t_local}: two chunks per rank).")
        return _ring(q, k, v, ring, gsize, grank, 2, impl, None, causal,
                     sm_scale, q_segment_ids, kv_segment_ids, window)
    if impl == "auto":
        # An explicit block_k is a blockwise-tuning request.
        impl = "blockwise" if block_k is not None or not on_card else "flash"
    if impl == "flash":
        if block_k is not None:
            raise HorovodError(
                "ring_attention block_k only applies to impl='blockwise'; "
                "the flash kernel blocks internally in VMEM. Pass "
                "impl='blockwise' to use block_k, or drop it.")
        return _ring(q, k, v, ring, gsize, grank, 1, impl, None, causal,
                     sm_scale, q_segment_ids, kv_segment_ids, window)
    if impl != "blockwise":
        raise HorovodError(f"Unknown ring_attention impl {impl!r}.")
    if block_k is None:
        if t_local <= 2048:
            block_k = t_local
        else:
            block_k = max(n for n in range(1, min(1024, t_local) + 1)
                          if t_local % n == 0)
    block_k = min(block_k, t_local)
    if t_local % block_k != 0:
        raise HorovodError(
            f"ring_attention block_k ({block_k}) must divide the local "
            f"sequence length ({t_local}).")
    return _ring(q, k, v, ring, gsize, grank, 1, impl, block_k, causal,
                 sm_scale, q_segment_ids, kv_segment_ids, window)


# -- the zigzag layout ------------------------------------------------------------


def zigzag_shard(x, group_size: int, axis: int = 1) -> torch.Tensor:
    """Shard a sequence axis in the zigzag (load-balanced causal) layout.

    The sequence splits into ``2g`` chunks; rank i holds chunks ``i`` and
    ``2g-1-i`` concatenated — one early chunk and one late chunk, so the
    causal triangle's work is the same on every rank. Returns the
    rank-stacked layout (leading axis = group size); rank i takes row i.
    See ``ring_attention(layout='zigzag')``."""
    g = group_size
    chunks = torch.as_tensor(x).chunk(2 * g, dim=axis)
    return torch.stack([torch.cat([chunks[i], chunks[2 * g - 1 - i]],
                                  dim=axis) for i in range(g)])


def zigzag_unshard(stacked, axis: int = 1) -> torch.Tensor:
    """Inverse of :func:`zigzag_shard` (input: rank-stacked)."""
    g = stacked.shape[0]
    out = [None] * (2 * g)
    for i in range(g):
        out[i], out[2 * g - 1 - i] = stacked[i].chunk(2, dim=axis)
    return torch.cat(out, dim=axis)


def zigzag_positions(group_rank, t_local: int, group_size: int, *,
                     device=None) -> torch.Tensor:
    """Global token positions of a rank's zigzag shard, ``(t_local,)``
    int64: chunk ``rank`` then chunk ``2g-1-rank`` (each ``t_local//2``
    long) — what rotary embeddings and loss masking need in place of the
    contiguous layout's ``shard_offset + arange``. Non-members (rank −1)
    get the rank-0 positions. ``device``: where to build them (a captured
    step must not copy them from the host)."""
    c = t_local // 2
    r = max(int(group_rank), 0)
    ar = torch.arange(c, device=device)
    return torch.cat([r * c + ar, (2 * group_size - 1 - r) * c + ar])


# -- Ulysses ------------------------------------------------------------------------


def ulysses_attention(q, k, v, group: int = 0, causal: bool = True,
                      sm_scale: float | None = None,
                      attn_fn=None, q_segment_ids=None,
                      kv_segment_ids=None):
    """All-to-all sequence parallelism (the DeepSpeed-Ulysses layout swap).

    Input: local sequence shard ``(B, T_local, H, D)`` with H divisible by
    the group size and equal q/kv head counts. ``hvd.alltoall`` swaps the
    sharding from the sequence to the heads, so each rank holds the whole
    sequence for ``H/g`` heads, runs :func:`local_attention` (or
    ``attn_fn(q, k, v)``) and swaps back.

    ``q_segment_ids``/``kv_segment_ids``: optional (B, T_local) integer
    ids of the local shard, allgathered to the whole sequence for the
    attention (ignored with ``attn_fn``).

    ``group`` may be a family (equal groups covering the program's group):
    every group swaps within itself. A rank outside a subset group takes
    part in no exchange and gets local attention over its own shard.
    """
    tctx = _require_traced("ulysses_attention")
    ring, gsize, grank = _group_ring(tctx, group)
    b, t_local, h, d = q.shape
    if (q_segment_ids is None) != (kv_segment_ids is None):
        raise HorovodError(
            "ulysses_attention needs q_segment_ids and kv_segment_ids "
            "together.")
    if k.shape[2] != h:
        raise HorovodError(
            f"ulysses_attention needs equal q/kv head counts (got {h} vs "
            f"{k.shape[2]}): the all-to-all swaps the head axis against "
            f"the sequence axis. Expand GQA KV heads first (jnp.repeat), "
            f"or use ring_attention, which carries Hkv heads natively.")
    if h % gsize != 0:
        raise HorovodError(
            f"ulysses_attention needs heads ({h}) divisible by the group "
            f"size ({gsize}).")
    hs = h // gsize

    def seq_to_heads(x):
        # (B, T, H, D) -> (H, T, B, D): the exchanged axis leads.
        xs = _coll.AllToAll.apply(x.permute(2, 1, 0, 3), group, ring)
        xs = xs.reshape(gsize, hs, t_local, b, d).permute(3, 0, 2, 1, 4)
        return xs.reshape(b, gsize * t_local, hs, d)

    def heads_to_seq(x):
        xs = x.reshape(b, gsize, t_local, hs, d).permute(1, 3, 2, 0, 4)
        xs = _coll.AllToAll.apply(xs.reshape(h, t_local, b, d), group, ring)
        return xs.permute(2, 1, 0, 3)

    def full_segs(segs):
        # (B, T_local) -> (B, T): allgather concatenates dim 0.
        s = _coll.allgather(segs.transpose(0, 1).contiguous(), group=group)
        return None if s is None else s.transpose(0, 1)

    # Every rank of the program issues the same exchanges (the schedule
    # is compared across them); a non-member's come back unchanged.
    qf, kf, vf = seq_to_heads(q), seq_to_heads(k), seq_to_heads(v)
    seg_kw = {}
    if attn_fn is None and q_segment_ids is not None:
        qs_full = full_segs(q_segment_ids)
        # Self-attention passes one id array for both sides: gather once.
        kvs_full = (qs_full if kv_segment_ids is q_segment_ids
                    else full_segs(kv_segment_ids))
        seg_kw = dict(q_segment_ids=qs_full, kv_segment_ids=kvs_full)
    if grank < 0:
        heads_to_seq(qf)
        nm_kw = {}
        if q_segment_ids is not None:
            nm_kw = dict(q_segment_ids=q_segment_ids,
                         kv_segment_ids=kv_segment_ids)
        return local_attention(q, k, v, causal=causal, sm_scale=sm_scale,
                               **nm_kw)
    if attn_fn is None:
        attn_out = local_attention(qf, kf, vf, causal=causal,
                                   sm_scale=sm_scale, **seg_kw)
    else:
        attn_out = attn_fn(qf, kf, vf)
    return heads_to_seq(attn_out)


# -- one device -----------------------------------------------------------------


def local_attention(q, k, v, causal: bool = True, sm_scale=None,
                    impl: str = "auto", q_segment_ids=None,
                    kv_segment_ids=None, window=None):
    """Single-device attention, (B, T, H, D) layout; GQA (``k``/``v`` with
    fewer heads) and packed-sequence segment masking on every impl.

    ``impl``:
    * ``'xla'`` — materialize the (T, T) scores in plain torch; fastest for
      short T (the name is the JAX package's, where XLA runs it);
    * ``'flash'`` — :func:`~horovod_tpu_torch.ops.flash_attention.flash_attention`:
      kernels B3/B4 on a CUDA tensor, their plain versions on a CPU tensor;
    * ``'blockwise'`` — the online softmax over K/V blocks, any device;
    * ``'auto'`` — ``'xla'`` for T ≤ 2048, else ``'flash'`` on a CUDA tensor
      and ``'blockwise'`` on a CPU tensor (the JAX package's choice off the
      TPU).
    """
    b, t, h, d = q.shape
    if (q_segment_ids is None) != (kv_segment_ids is None):
        raise HorovodError(
            "local_attention needs q_segment_ids and kv_segment_ids "
            "together.")
    # One behavior for `window` on every impl: causal-only, >= 1.
    _fa._check_window(window, causal)
    if sm_scale is None:
        sm_scale = 1.0 / d ** 0.5
    if impl == "auto":
        if t <= 2048:
            impl = "xla"
        else:
            impl = "flash" if q.device.type == "cuda" else "blockwise"

    if impl == "flash":
        return _fa.flash_attention(q, k, v, causal, sm_scale,
                                   q_segment_ids=q_segment_ids,
                                   kv_segment_ids=kv_segment_ids,
                                   window=window)
    if impl == "blockwise":
        return _fa.blockwise_attention(q, k, v, causal=causal,
                                       sm_scale=sm_scale,
                                       q_segment_ids=q_segment_ids,
                                       kv_segment_ids=kv_segment_ids,
                                       window=window)
    if impl != "xla":
        raise HorovodError(f"Unknown attention impl {impl!r}.")
    if k.shape[2] != h:
        reps = h // k.shape[2]
        k = k.repeat_interleave(reps, dim=2)
        v = v.repeat_interleave(reps, dim=2)
    # bf16 operands, fp32 products: the JAX einsum's
    # preferred_element_type=float32.
    qb = q.to(torch.bfloat16).float().transpose(1, 2)
    kb = k.to(torch.bfloat16).float().transpose(1, 2)
    s = (qb @ kb.transpose(-1, -2)) * sm_scale                 # (B, H, T, T)
    pos = torch.arange(t, device=q.device)
    if causal:
        s = torch.where(pos[None, :] <= pos[:, None], s, _NEG_INF)
    if q_segment_ids is not None:
        seg_ok = q_segment_ids[:, None, :, None] == kv_segment_ids[:, None,
                                                                   None, :]
        s = torch.where(seg_ok, s, _NEG_INF)
    if window is not None:
        s = torch.where(pos[None, :] > pos[:, None] - window, s, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = p @ v.float().transpose(1, 2)
    return out.transpose(1, 2).to(q.dtype)

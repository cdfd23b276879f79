"""Transformer (GPT-style causal LM) — the long-context model family.

Counterpart of the training side of ``horovod_tpu/models/transformer.py``:
the same network, parameter for parameter, so weights carry across
(:func:`from_flax_params`) and both frameworks compute the same function.
Pre-norm blocks (RMSNorm → attention → RMSNorm → GELU MLP), rotary position
embeddings, grouped-query attention (``num_kv_heads``), an optional sliding
``window`` and packed-sequence ``segment_ids``. The attention strategy is
the reference's: ``'local'`` (every rank sees its whole sequence, through
:func:`~horovod_tpu_torch.parallel.sequence.local_attention`, which sends
sequences longer than 2048 tokens on the GPU to the flash kernels B3/B4),
``'ring'`` (the sequence sharded over the ``sp_group``'s ranks, exact
attention by :func:`~horovod_tpu_torch.parallel.sequence.ring_attention`,
``sp_layout`` contiguous or zigzag) or ``'ulysses'`` (sharded, head-parallel
attention by :func:`~horovod_tpu_torch.parallel.sequence.ulysses_attention`).
Under ``'ring'``/``'ulysses'`` the model takes the local shard and its rotary
phases come from global positions (``shard_offset``, or ``positions`` for a
zigzag shard); both run inside an ``hvd.spmd`` program. Parameters are the
same under every strategy.

Parameters keep flax's shapes and are fp32; each op casts them and its
input to the compute ``dtype`` (bf16 by default), as flax's ``dtype`` does:
``embed`` (V, E), per block ``norm1``/``norm2`` scales (E,), ``attn.query``
(E, H, D), ``attn.key``/``attn.value`` (E, Hkv, D), ``attn.out`` (H, D, E),
``mlp_in`` (E, M), ``mlp_out`` (M, E), then ``norm`` (E,) and ``lm_head``
(E, V). Numerics follow flax: RMSNorm takes its statistics in fp32
(ε = 1e-6) and returns ``dtype``; GELU is the tanh approximation; rotary
runs in fp32; the logits come out fp32. Rotary tables are computed per call,
not kept as buffers, so ``Trainer`` has no buffers to average.

The decode side (``horovod_tpu/models/transformer.py:112-257``,
``:444-590``): one-token steps against a KV cache, through one attend for
both cache carriers, so :func:`generate` and the serving engine
(``horovod_tpu_torch.serving``) compute the same bits:

* a dense :class:`DecodeCache` ``(layers, B, max_seq_len, Hkv, d)`` in the
  compute dtype with one shared write index — :func:`init_cache`,
  :func:`decode_step`, :func:`prefill` and :func:`generate`;
* a paged ``kv_view`` per layer, gathered by the engine from its block pool:
  ``(k, v)`` raw pages or ``(k, v, k_scale, v_scale)`` quantized ones, with
  per-row ``(B, W)`` positions. The fresh K/V of the step (quantized once,
  on write) go into the view before the attend and come back from
  :meth:`Transformer.decode` for the engine's pool scatter — where flax
  ``sow``s them into a ``paged_kv`` collection.

The attend runs in fp32: GQA grouped as ``bqhgd,bkhd`` without expanding
the cache, positions past each query's frontier (and outside ``window``)
written as -1e30 before the softmax.
The decode side computes a row the same whether it rides a one-token step
of B rows or the serving engine's (B, k + 1) speculative verify: its
RMSNorm sums the statistics in an order independent of the number of rows,
its products run on at most 8 rows at a time, and the attend takes one
query position at a time (the card's reductions and products otherwise
round by their shapes).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from horovod_tpu_torch.core import state as _state
from horovod_tpu_torch.models.resnet import lecun_normal_
from horovod_tpu_torch.ops.losses import default_chunk, fused_cross_entropy
from horovod_tpu_torch.parallel.sequence import (local_attention,
                                                 ring_attention,
                                                 ulysses_attention,
                                                 zigzag_positions)
from horovod_tpu_torch.serving.kv_cache import (dequantize_kv, kv_quantized,
                                                quantize_kv,
                                                resolve_kv_dtype)
from horovod_tpu_torch.utils import rng as _rng


class TransformerConfig(NamedTuple):
    vocab_size: int = 32_000
    num_layers: int = 4
    num_heads: int = 8
    embed_dim: int = 512
    mlp_dim: int = 2048
    max_seq_len: int = 2048
    dtype: torch.dtype = torch.bfloat16
    attention: str = "local"      # 'local' | 'ring' | 'ulysses'
    sp_group: int = 0             # context-parallel group for ring/ulysses
    num_kv_heads: int | None = None  # GQA/MQA: fewer K/V heads (None = MHA)
    sp_layout: str = "contiguous"    # ring only: 'contiguous' | 'zigzag'
    decode: bool = False          # one-token KV-cache decoding
    window: int | None = None     # sliding-window attention (causal SWA)
    kv_dtype: str = "model"       # paged-KV pool format ('model' = dtype;
                                  # fp32|bf16|int8_block|int4 — serving)


def _rotary_tables(positions: torch.Tensor, d: int):
    """fp32 ``(cos, sin)`` for head dim ``d``, shaped to broadcast over
    (B, T, H, d/2). ``positions``: (T,) shared across the batch or (B, T)
    per row."""
    half = d // 2
    freqs = 1.0 / (10000.0 ** (torch.arange(half, dtype=torch.float32,
                                            device=positions.device) / half))
    angles = positions[..., None].float() * freqs
    cos, sin = angles.cos(), angles.sin()
    if angles.ndim == 2:
        return cos[None, :, None, :], sin[None, :, None, :]
    return cos[:, :, None, :], sin[:, :, None, :]


def _apply_rotary(x: torch.Tensor, cos, sin) -> torch.Tensor:
    """Rotary position embedding on (B, T, H, D), in fp32, cast back."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


# The decode side's products run on at most this many rows at a time: the
# card's library picks its kernel (a split of the contraction among them)
# by the number of rows, and at the LM's widths every product of up to 8
# rows rounds a row as a one-row product does (measured on an H100,
# chip_smoke.py phase 13).
_INVARIANT_ROWS = 8


def _dense(x: torch.Tensor, w: torch.Tensor, dtype,
           row_invariant: bool = False) -> torch.Tensor:
    """flax Dense/DenseGeneral without bias: x and the fp32 kernel, both cast
    to ``dtype``, contracted over x's last dim and w's leading dims.
    ``row_invariant`` (the decode side) multiplies at most
    ``_INVARIANT_ROWS`` rows at a time, so that a row's bits do not depend
    on how many rows ride with it."""
    x, w = x.to(dtype), w.to(dtype).reshape(x.shape[-1], -1)
    rows = x.reshape(-1, x.shape[-1])
    if not row_invariant or rows.shape[0] <= _INVARIANT_ROWS:
        return x @ w
    return torch.cat([r @ w for r in rows.split(_INVARIANT_ROWS)]).reshape(
        *x.shape[:-1], w.shape[1])


class _Step(NamedTuple):
    """What every layer of one decode step shares: whether the carrier is
    a paged view, the view's write coordinates ``rows`` (B, 1) and ``pos``
    (B, W), and ``visible`` (B, 1, 1, W, K), the keys each query may see."""
    paged: bool
    rows: torch.Tensor | None
    pos: torch.Tensor | None
    visible: torch.Tensor


def _visibility(frontier: torch.Tensor, k_len: int,
                window: int | None) -> torch.Tensor:
    """(B, 1, 1, W, K): key position ≤ each query's frontier (B, W), and
    within ``window`` of it when one is set."""
    kpos = torch.arange(k_len, device=frontier.device)
    vis = kpos[None, None, :] <= frontier[:, :, None]
    if window is not None:
        vis = vis & (kpos[None, None, :] > frontier[:, :, None] - window)
    return vis[:, None, None]


def _attend(q, kc, vc, visible) -> torch.Tensor:
    """The decode attend, in fp32: q (B, W, H, d) against the cache or
    view (B, K, Hkv, d), GQA grouped as ``bqhgd,bkhd`` (the cache is never
    expanded), invisible scores written as -1e30 before the softmax.
    Returns (B, W, H, d) in q's dtype. One query position at a time: the
    card's fp32 products round by their shapes, so a position of the
    serving engine's (B, k + 1) verify is scored with the one-token step's
    shapes, and so with its bits."""
    b, w, h, d = q.shape
    hkv = kc.shape[2]
    kf, vf = kc.float(), vc.float()
    outs = []
    for i in range(w):
        qg = q[:, i:i + 1].reshape(b, 1, hkv, h // hkv, d).float()
        s = torch.einsum("bqhgd,bkhd->bhgqk", qg, kf) * (1.0 / d ** 0.5)
        p = torch.softmax(torch.where(visible[:, :, :, i:i + 1], s, -1e30),
                          dim=-1)
        outs.append(torch.einsum("bhgqk,bkhd->bqhgd", p, vf))
    out = outs[0] if w == 1 else torch.cat(outs, dim=1)
    return out.reshape(b, w, h, d).to(q.dtype)


def _row_invariant_mean_sq(xf: torch.Tensor) -> torch.Tensor:
    """The mean of squares over the last dim, summed in an order that does
    not depend on how many rows there are: lanes of 32, then the lanes'
    sums. A single CUDA reduction spreads a row over more lanes when there
    are fewer rows, so a one-token decode step (B rows) and the serving
    engine's (B, k + 1) verify would round each row's statistics
    differently."""
    e = xf.shape[-1]
    if e % 32:
        return (xf * xf).mean(-1, keepdim=True)
    sq = (xf * xf).reshape(*xf.shape[:-1], e // 32, 32)
    return sq.sum(-1).sum(-1, keepdim=True) / e


class RMSNorm(nn.Module):
    """flax ``nn.RMSNorm``: statistics in fp32, ε = 1e-6, output ``dtype``.
    ``row_invariant`` (the decode side) sums the statistics in an order
    independent of the number of rows (:func:`_row_invariant_mean_sq`)."""

    def __init__(self, dim: int, dtype: torch.dtype) -> None:
        super().__init__()
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor,
                row_invariant: bool = False) -> torch.Tensor:
        xf = x.float()
        ms = (_row_invariant_mean_sq(xf) if row_invariant
              else (xf * xf).mean(-1, keepdim=True))
        mul = torch.rsqrt(ms + 1e-6) * self.scale
        return (xf * mul).to(self.dtype)


class Attention(nn.Module):

    def __init__(self, config: TransformerConfig,
                 generator: torch.Generator | None = None) -> None:
        super().__init__()
        cfg = config
        if cfg.embed_dim % cfg.num_heads != 0:
            raise ValueError(
                f"embed_dim ({cfg.embed_dim}) must be divisible by num_heads "
                f"({cfg.num_heads}).")
        h, d = cfg.num_heads, cfg.embed_dim // cfg.num_heads
        hkv = cfg.num_kv_heads or h
        if h % hkv != 0:
            raise ValueError(
                f"num_heads ({h}) must be a multiple of num_kv_heads "
                f"({hkv}) for grouped-query attention.")
        if d % 2 != 0:
            raise ValueError(
                f"head_dim ({d} = {cfg.embed_dim}/{cfg.num_heads}) must be "
                f"even for rotary embeddings.")
        self.config, self.h, self.hkv, self.d = cfg, h, hkv, d
        e = cfg.embed_dim

        def kernel(shape, fan_in):
            return nn.Parameter(lecun_normal_(torch.empty(shape), fan_in,
                                              generator))

        self.query = kernel((e, h, d), e)
        self.key = kernel((e, hkv, d), e)
        self.value = kernel((e, hkv, d), e)
        self.out = kernel((h, d, e), h * d)

    def _qkv(self, x, rot, row_invariant: bool = False):
        cfg = self.config
        b, t, _ = x.shape
        q = _apply_rotary(_dense(x, self.query, cfg.dtype,
                                 row_invariant).reshape(
            b, t, self.h, self.d), *rot)
        k = _apply_rotary(_dense(x, self.key, cfg.dtype,
                                 row_invariant).reshape(
            b, t, self.hkv, self.d), *rot)
        v = _dense(x, self.value, cfg.dtype, row_invariant).reshape(
            b, t, self.hkv, self.d)
        return q, k, v

    def forward(self, x, positions, segment_ids=None):
        cfg = self.config
        b, t, _ = x.shape
        q, k, v = self._qkv(x, _rotary_tables(positions, self.d))
        segs = {}
        if segment_ids is not None:
            segs = dict(q_segment_ids=segment_ids,
                        kv_segment_ids=segment_ids)
        if cfg.attention == "ring":
            out = ring_attention(q, k, v, group=cfg.sp_group, causal=True,
                                 layout=cfg.sp_layout, window=cfg.window,
                                 **segs)
        elif cfg.attention == "ulysses":
            if self.hkv != self.h:
                # The all-to-all swaps the head axis against the sequence
                # axis, which needs equal head counts: expand the grouped
                # K/V heads locally (the ring carries Hkv heads instead).
                k = k.repeat_interleave(self.h // self.hkv, dim=2)
                v = v.repeat_interleave(self.h // self.hkv, dim=2)
            if cfg.window is not None:
                raise ValueError(
                    "window is not supported with attention='ulysses'; "
                    "use 'local' or 'ring'.")
            out = ulysses_attention(q, k, v, group=cfg.sp_group,
                                    causal=True, **segs)
        elif cfg.attention == "local":
            out = local_attention(q, k, v, causal=True, window=cfg.window,
                                  **segs)
        else:
            raise ValueError(
                f"Unknown attention strategy {cfg.attention!r}.")
        return _dense(out.reshape(b, t, self.h * self.d), self.out,
                      cfg.dtype)

    def decode(self, x, rot, step, carrier, kv_dtype: str):
        """One decode step of attention. ``rot``: rotary tables of the
        step's positions; ``step``: :class:`_Step` (frontiers and
        visibility, shared by every layer); ``carrier``: this layer's
        ``(k_cache, v_cache, index)`` dense cache (written in place at
        ``index``) or its paged view, 2 or 4 planes (written in place at
        the step's positions — the view is the caller's gathered scratch).
        Returns the attention output and, for a paged view, the fresh
        K/V as written (and their scales), squeezed to (B, Hkv, ...) when
        W == 1; None for the dense cache."""
        cfg = self.config
        b, w, _ = x.shape
        q, k, v = self._qkv(x, rot, row_invariant=True)
        fresh = None
        if step.paged:
            if kv_quantized(kv_dtype):
                kview, vview, kscale, vscale = carrier
                kw, ku = quantize_kv(k, kv_dtype)
                vw, vu = quantize_kv(v, kv_dtype)
                kview[step.rows, step.pos] = kw
                vview[step.rows, step.pos] = vw
                kscale[step.rows, step.pos] = ku
                vscale[step.rows, step.pos] = vu
                fresh = (kw, vw, ku, vu)
                kc = dequantize_kv(kview, kscale, kv_dtype)
                vc = dequantize_kv(vview, vscale, kv_dtype)
            else:
                kc, vc = carrier
                kw, vw = k.to(kc.dtype), v.to(vc.dtype)
                kc[step.rows, step.pos] = kw
                vc[step.rows, step.pos] = vw
                fresh = (kw, vw)
            if w == 1:
                fresh = tuple(f[:, 0] for f in fresh)
        else:
            kc, vc, i = carrier
            kc[:, i] = k[:, 0].to(kc.dtype)
            vc[:, i] = v[:, 0].to(vc.dtype)
        out = _attend(q, kc, vc, step.visible)
        return _dense(out.reshape(b, w, self.h * self.d), self.out,
                      cfg.dtype, row_invariant=True), fresh


class Block(nn.Module):

    def __init__(self, config: TransformerConfig,
                 generator: torch.Generator | None = None) -> None:
        super().__init__()
        e, m = config.embed_dim, config.mlp_dim
        self.dtype = config.dtype
        self.norm1 = RMSNorm(e, config.dtype)
        self.attn = Attention(config, generator)
        self.norm2 = RMSNorm(e, config.dtype)
        self.mlp_in = nn.Parameter(lecun_normal_(torch.empty(e, m), e,
                                                 generator))
        self.mlp_out = nn.Parameter(lecun_normal_(torch.empty(m, e), m,
                                                  generator))

    def _mlp(self, x, row_invariant: bool = False):
        y = _dense(self.norm2(x, row_invariant), self.mlp_in, self.dtype,
                   row_invariant)
        y = F.gelu(y, approximate="tanh")
        return x + _dense(y, self.mlp_out, self.dtype, row_invariant)

    def forward(self, x, positions, segment_ids=None):
        return self._mlp(x + self.attn(self.norm1(x), positions,
                                       segment_ids))

    def decode(self, x, rot, step, carrier, kv_dtype: str):
        a, fresh = self.attn.decode(self.norm1(x, True), rot, step, carrier,
                                    kv_dtype)
        return self._mlp(x + a, True), fresh


class Transformer(nn.Module):
    """Decoder-only LM over a whole sequence: ``tokens`` (B, T) int →
    fp32 logits (B, T, V), or the final-norm hidden states (B, T, E) in
    ``dtype`` with ``return_hidden=True`` (what the fused loss takes).
    ``shard_offset``: global position of the first token (``sp_rank ·
    T_local`` under sequence parallelism); ``positions``: explicit (T,)
    positions overriding it, required for ``sp_layout='zigzag'`` shards
    (:func:`~horovod_tpu_torch.parallel.sequence.zigzag_positions`). Weights are initialised as flax
    initialises the reference (LeCun-normal kernels, N(0, 0.02) embedding,
    unit norm scales), drawing from ``generator``. :meth:`decode` is one
    decode step against a KV cache (the reference's ``decode=True``
    apply)."""

    def __init__(self, config: TransformerConfig,
                 generator: torch.Generator | None = None) -> None:
        super().__init__()
        self.config = config
        e, v = config.embed_dim, config.vocab_size
        self.embed = nn.Parameter(
            torch.randn((v, e), generator=generator) * 0.02)
        self.blocks = nn.ModuleList(Block(config, generator)
                                    for _ in range(config.num_layers))
        self.norm = RMSNorm(e, config.dtype)
        self.lm_head = nn.Parameter(lecun_normal_(torch.empty(e, v), e,
                                                  generator))

    def forward(self, tokens, shard_offset: int = 0, segment_ids=None,
                positions=None, return_hidden: bool = False):
        if self.config.decode:
            raise ValueError(
                "decode=True runs one-token steps against a KV cache: call "
                "decode(tokens, cache=init_cache(...)) or decode(tokens, "
                "kv_views=...) (the serving engine's paged views).")
        cfg = self.config
        if cfg.sp_layout == "zigzag" and cfg.attention != "ring":
            raise ValueError(
                "sp_layout='zigzag' only applies to attention='ring' "
                f"(got {cfg.attention!r}); zigzag-sharded data under any "
                "other strategy would silently misplace positions.")
        if positions is None:
            if cfg.sp_layout == "zigzag":
                raise ValueError(
                    "sp_layout='zigzag' shards are not contiguous: pass "
                    "positions=hvd.zigzag_positions(hvd.rank(sp_group), "
                    "t_local, group_size) from inside the step function.")
            positions = shard_offset + torch.arange(tokens.shape[1],
                                                    device=tokens.device)
        x = F.embedding(tokens, self.embed.to(self.config.dtype))
        for block in self.blocks:
            x = block(x, positions, segment_ids)
        x = self.norm(x)
        if return_hidden:
            return x
        return _dense(x, self.lm_head, self.config.dtype).float()

    def decode(self, tokens, shard_offset: int = 0, positions=None,
               kv_views=None, cache: "DecodeCache | None" = None,
               kv_dtype: str | None = None):
        """One decode step against one of two cache carriers:

        * ``cache``: the dense :class:`DecodeCache`; ``tokens`` (B, 1) at
          position ``shard_offset`` (or ``positions`` (1,)) are written at
          ``cache.index``, which then advances. Returns (B, 1, V) fp32
          logits.
        * ``kv_views``: one paged view per layer — ``(k, v)`` raw pages or
          ``(k, v, k_scale, v_scale)`` when ``kv_dtype`` (default
          ``config.kv_dtype``) is quantized — each (B, K, Hkv, ...) and
          written in place; ``positions`` (B, W) per row. Returns the
          logits (B, W, V) and the fresh K/V as written, one tensor per
          plane stacked over layers: (layers, B, Hkv, ...) when W == 1,
          else (layers, B, W, Hkv, ...) — what flax ``sow``s into the
          reference's ``paged_kv`` collection.
        """
        cfg = self.config
        if cfg.attention != "local":
            raise ValueError(
                "decode=True supports attention='local' (generation "
                "runs on the full cached sequence per chip).")
        if (kv_views is None) == (cache is None):
            raise ValueError("a decode step takes one carrier: cache= or "
                             "kv_views=")
        b, w = tokens.shape
        d = cfg.embed_dim // cfg.num_heads
        kvd = None
        if kv_views is not None:
            if len(kv_views) != cfg.num_layers:
                raise ValueError(
                    f"kv_views must carry one (k_view, v_view) pair per "
                    f"layer: got {len(kv_views)} for num_layers="
                    f"{cfg.num_layers}.")
            kvd = resolve_kv_dtype(kv_dtype or cfg.kv_dtype, cfg.dtype)
            planes = len(kv_views[0])
            if kv_quantized(kvd) and planes != 4:
                raise ValueError(
                    f"kv_dtype={kvd!r} pages carry scale "
                    f"planes: kv_view must be (k, v, k_scale, "
                    f"v_scale), got a {planes}-tuple.")
            if not kv_quantized(kvd) and planes != 2:
                raise ValueError(
                    f"kv_dtype={kvd!r} pages are raw (k, v) "
                    f"— a {planes}-tuple kv_view looks like "
                    f"quantized pools passed to an unquantized "
                    f"config (fresh K/V would be written into the "
                    f"int8 payload view as garbage).")
            if (positions is None or positions.ndim != 2
                    or tuple(positions.shape) != (b, w)):
                got = None if positions is None else tuple(positions.shape)
                raise ValueError(
                    "paged decode (kv_view=) needs per-row positions "
                    f"shaped (B, W) matching the tokens, got "
                    f"{got} for (B, W)=({b}, {w}).")
            pos = positions.long()
            step = _Step(True, torch.arange(b, device=tokens.device)[:, None],
                         pos, _visibility(pos, kv_views[0][0].shape[1],
                                          cfg.window))
            carriers = kv_views
        else:
            if w != 1:
                raise ValueError(
                    f"decode=True processes ONE token per call (got "
                    f"{w}); feed the prompt token-by-token as "
                    f"generate() does.")
            i = cache.index
            if not 0 <= i < cache.k.shape[2]:
                raise ValueError(
                    f"the dense cache is full: write index {i} of "
                    f"{cache.k.shape[2]} positions (max_seq_len).")
            if positions is None:
                positions = shard_offset + torch.arange(1,
                                                        device=tokens.device)
            step = _Step(False, None, None, _visibility(
                torch.full((b, 1), i, device=tokens.device),
                cache.k.shape[2], cfg.window))
            carriers = [(cache.k[layer], cache.v[layer], i)
                        for layer in range(cfg.num_layers)]
        rot = _rotary_tables(positions, d)
        x = F.embedding(tokens, self.embed.to(cfg.dtype))
        fresh = []
        for block, carrier in zip(self.blocks, carriers):
            x, f = block.decode(x, rot, step, carrier, kvd)
            fresh.append(f)
        logits = _dense(self.norm(x, True), self.lm_head, cfg.dtype,
                        row_invariant=True).float()
        if cache is not None:
            cache.index = i + 1
            return logits
        return logits, tuple(torch.stack(p) for p in zip(*fresh))


def _require_device(device, who: str, what: str) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device on a host without
    CUDA raises instead of falling back to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{who}: CUDA is not available on this host. The port "
            f"runs on the GPU by default; pass device='cpu' to {what} "
            f"on the CPU.")
    return device


def init_params(config: TransformerConfig, seed: int = 0,
                device: str | torch.device = "cuda"):
    """A :class:`Transformer` with weights drawn from a ``torch.Generator``
    seeded with ``seed``, on ``device`` — the GPU unless the caller passes
    ``device='cpu'``; without CUDA the default raises instead of building
    on the CPU. The weights are drawn on the CPU, so they are the same on
    every device. (The JAX package's ``init_params`` returns a parameter
    tree; here the module holds its parameters.)"""
    device = _require_device(device, "init_params", "build the model")
    g = torch.Generator().manual_seed(seed)
    return Transformer(config, generator=g).to(device)


def make_loss_fn(config: TransformerConfig, sp_rank=None,
                 fused_head: bool = False):
    """``loss_fn(model, tokens) -> loss``: next-token cross-entropy over the
    local shard, for :class:`~horovod_tpu_torch.Trainer` (tokens: (B,
    T_local)).

    ``fused_head=True`` runs the lm_head product inside
    :func:`~horovod_tpu_torch.ops.losses.fused_cross_entropy` (chunked
    vocabulary): the (N, V) logits never materialize, at the cost of one
    extra head-product recompute in the backward. Contiguous layouts only.

    ``sp_rank``: under sequence parallelism, a callable that returns this
    rank's rank in the SP group (``lambda: hvd.rank(config.sp_group)``);
    None for plain data parallelism. The shard starts at global position
    ``sp_rank() · T_local``, and each shard trains on its own T_local − 1
    transitions (the one across a shard boundary has its logit on the
    previous rank); the loss is their mean.

    With ``sp_layout='zigzag'`` the shard is two non-adjacent chunks: the
    positions come from :func:`~horovod_tpu_torch.parallel.sequence.
    zigzag_positions`, and the pair straddling the chunk boundary in the
    middle of the shard is no transition, so it is masked out. As in the
    reference, the masked sum over all B rows is divided by one row's
    count of transitions: the zigzag loss is B times the mean."""
    zigzag = (config.sp_layout == "zigzag"
              and config.attention == "ring")

    def loss_fn(model: Transformer, tokens: torch.Tensor) -> torch.Tensor:
        t_local = tokens.shape[1]
        targets = tokens[:, 1:].reshape(-1).long()
        if zigzag:
            if fused_head:
                raise ValueError(
                    "fused_head=True is not supported with "
                    "sp_layout='zigzag' (the cross-chunk loss masking is "
                    "not plumbed through the fused path).")
            if sp_rank is None:
                raise ValueError(
                    "sp_layout='zigzag' needs sp_rank (the SP group rank "
                    "determines the shard's chunk positions).")
            pos = zigzag_positions(sp_rank(), t_local,
                                   _state.size(config.sp_group),
                                   device=tokens.device)
            logits = model(tokens, positions=pos)
            per_tok = F.cross_entropy(
                logits[:, :-1].reshape(-1, logits.shape[-1]), targets,
                reduction="none").view(tokens.shape[0], t_local - 1)
            # Transition c-1 -> c crosses the non-adjacent chunk boundary.
            valid = (torch.arange(t_local - 1, device=tokens.device)
                     != t_local // 2 - 1)
            return (per_tok * valid[None]).sum() / valid.sum()
        offset = 0 if sp_rank is None else sp_rank() * t_local
        if fused_head:
            hidden = model(tokens, shard_offset=offset, return_hidden=True)
            w = model.lm_head.to(config.dtype)
            x2 = hidden[:, :-1].reshape(-1, hidden.shape[-1])
            return fused_cross_entropy(x2, w, targets,
                                       chunk=default_chunk(w.shape[1]))
        logits = model(tokens, shard_offset=offset)
        pred = logits[:, :-1].reshape(-1, logits.shape[-1])
        return F.cross_entropy(pred, targets)

    return loss_fn


def synthetic_tokens(batch_size: int, seq_len: int, vocab_size: int = 32_000,
                     seed: int = 0, device: str | torch.device = "cuda"):
    """(batch_size, seq_len) int64 token ids, uniform over the vocabulary,
    from a ``torch.Generator`` seeded with ``seed`` on ``device``."""
    device = torch.device(device)
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(0, vocab_size, (batch_size, seq_len), generator=g,
                         device=device)


# -- the decode side -------------------------------------------------------------

def decode_config(config: TransformerConfig) -> TransformerConfig:
    """The cached-decode variant of a training config: one-token steps,
    local attention, contiguous layout — what :func:`generate`, the
    :func:`prefill`/:func:`decode_step` pair and the serving engine run."""
    return config._replace(decode=True, attention="local",
                           sp_layout="contiguous")


def draft_config(config: TransformerConfig, num_layers: int = 1,
                 mlp_dim: int | None = None) -> TransformerConfig:
    """A small draft-model config for speculative decoding (the serving
    engine's ``speculate=k``): the same vocabulary (proposals are target
    token ids), heads, width and ``max_seq_len`` (its paged cache rides
    the target's block tables and positions), fewer layers. Train it
    separately or distill it from the target, and pass its model as
    ``draft_params``."""
    if num_layers < 1:
        raise ValueError(f"draft num_layers must be >= 1, got {num_layers}")
    return config._replace(
        num_layers=num_layers,
        mlp_dim=config.mlp_dim if mlp_dim is None else mlp_dim)


_ARCH_FIELDS = ("vocab_size", "num_layers", "num_heads", "embed_dim",
                "mlp_dim", "dtype", "window")


def check_model(config: TransformerConfig, model: Transformer) -> None:
    """Raise unless ``model`` was built for ``config``'s network (the decode
    entry points take both, as the reference takes a config and a
    parameter tree)."""
    have = model.config
    for field in _ARCH_FIELDS:
        if getattr(have, field) != getattr(config, field):
            raise ValueError(
                f"the model was built with {field}={getattr(have, field)!r}"
                f" but the config has {getattr(config, field)!r}")
    if (have.num_kv_heads or have.num_heads) != (config.num_kv_heads
                                                 or config.num_heads):
        raise ValueError(
            f"the model has {have.num_kv_heads or have.num_heads} K/V "
            f"heads but the config {config.num_kv_heads or config.num_heads}")


@dataclasses.dataclass
class DecodeCache:
    """The dense KV cache :func:`generate` runs on: ``k`` and ``v``
    (layers, B, max_seq_len, Hkv, d) in the compute dtype, and ``index``,
    the next write position, shared by every layer (the reference keeps
    one per layer, always equal). A decode step writes it in place."""
    k: torch.Tensor
    v: torch.Tensor
    index: int = 0


def init_cache(config: TransformerConfig, batch_size: int,
               device: str | torch.device = "cuda") -> DecodeCache:
    """A zeroed :class:`DecodeCache` for ``batch_size`` rows on ``device``
    — the GPU unless the caller passes ``device='cpu'``."""
    device = _require_device(device, "init_cache", "build the cache")
    hkv = config.num_kv_heads or config.num_heads
    shape = (config.num_layers, batch_size, config.max_seq_len, hkv,
             config.embed_dim // config.num_heads)
    return DecodeCache(torch.zeros(shape, dtype=config.dtype, device=device),
                       torch.zeros(shape, dtype=config.dtype, device=device))


def decode_step(config: TransformerConfig, params: Transformer,
                cache: DecodeCache, token, t: int | None = None):
    """One cached decode step: ``token`` (B,) or (B, 1) at position ``t``
    (default: the cache's own write index) → ((B, V) fp32 logits, the
    cache, advanced in place). The same path :func:`generate` and
    :func:`prefill` run, step by step; the model and the cache must be on
    one device."""
    check_model(config, params)
    token = torch.as_tensor(token, device=cache.k.device).long()
    if token.ndim == 1:
        token = token[:, None]
    if t is None:
        t = cache.index
    with torch.no_grad():
        logits = params.decode(token, shard_offset=t, cache=cache)
    return logits[:, 0], cache


def prefill(config: TransformerConfig, params: Transformer, tokens,
            device: str | torch.device = "cuda"):
    """Ingest a whole prompt through the cached decode path: ``tokens``
    (B, P) → (cache, (B, V) logits at the last prompt position). One
    one-token step a position, as the reference's ``lax.scan`` does, so
    prefill-then-decode equals feeding the prompt token by token."""
    device = _require_device(device, "prefill", "decode")
    check_model(config, params)
    tokens = torch.as_tensor(tokens, device=device).long()
    b, plen = tokens.shape
    if plen > config.max_seq_len:
        raise ValueError(
            f"prompt ({plen}) exceeds max_seq_len ({config.max_seq_len}) "
            f"— the KV cache's capacity.")
    cache = init_cache(config, b, device)
    with torch.no_grad():
        for t in range(plen):
            logits = params.decode(tokens[:, t:t + 1], shard_offset=t,
                                   cache=cache)
    return cache, logits[:, 0]


def generate(config: TransformerConfig, params: Transformer, prompt,
             max_new_tokens: int, temperature: float = 0.0, seed: int = 0,
             device: str | torch.device = "cuda") -> torch.Tensor:
    """Autoregressive generation with a dense KV cache: ``prompt`` (B, P)
    → (B, P + max_new_tokens) int64, the prompt then the generated tokens.
    One token a step against the cache (teacher-forced inside the prompt);
    ``temperature=0`` is greedy, otherwise :func:`sample_tokens` keyed by
    (``seed``, batch row, position). The serving engine
    (``horovod_tpu_torch.serving.Engine``) runs the same attend over a
    paged cache, so its greedy tokens are bit-identical at equal shapes."""
    device = _require_device(device, "generate", "decode")
    check_model(config, params)
    prompt = torch.as_tensor(prompt, device=device).long()
    b, plen = prompt.shape
    total = plen + max_new_tokens
    if total > config.max_seq_len:
        raise ValueError(
            f"prompt ({plen}) + max_new_tokens ({max_new_tokens}) exceeds "
            f"max_seq_len ({config.max_seq_len}) — the KV cache's capacity.")
    cache = init_cache(config, b, device)
    out = torch.empty((b, total), dtype=torch.long, device=device)
    out[:, :plen] = prompt
    rows = torch.arange(b, device=device)
    with torch.no_grad():
        for t in range(total - 1):
            logits = params.decode(out[:, t:t + 1], shard_offset=t,
                                   cache=cache)
            if t + 1 >= plen:
                out[:, t + 1] = sample_tokens(logits[:, 0], temperature,
                                              seed, rows, t)
    return out


# Counter-based sampling: splitmix64 over int64 tensors (utils/rng.py).
_i64 = _rng.i64
_GOLDEN, _MIX1, _MIX2 = _rng.GOLDEN, _rng.MIX1, _rng.MIX2
_srl = _rng.srl
_splitmix64 = _rng.splitmix64


def sample_tokens(logits: torch.Tensor, temperature: float, seed: int,
                  streams, positions) -> torch.Tensor:
    """Next tokens (B,) int64 from (B, V) logits. ``temperature == 0`` is
    greedy (``argmax``, as the reference). Otherwise Gumbel-max: the
    token maximising ``logits / temperature + g`` with ``g = -log(-log u)``
    and ``u`` uniform in (0, 1) from splitmix64 over (``seed``, stream,
    position, vocabulary id) — deterministic, independent of the batch a
    row rides in and of the device, and stable under recompute. ``streams``
    and ``positions``: ints or (B,) integer tensors (the serving engine
    passes each request's seed and position). The reference draws from
    ``jax.random``, which torch cannot reproduce: sampled tokens differ
    from it, greedy ones do not (ROADMAP §C)."""
    if temperature == 0.0:
        return logits.argmax(dim=-1)
    b, v = logits.shape
    dev = logits.device

    def col(x):
        return torch.as_tensor(x, dtype=torch.long, device=dev).expand(b)

    h = _splitmix64(torch.full((b,), int(seed), dtype=torch.long,
                               device=dev))
    h = _splitmix64(h ^ col(streams))
    h = _splitmix64(h ^ col(positions))
    h = _splitmix64(h[:, None] ^ torch.arange(v, device=dev))
    u = (_srl(h, 11).double() + 0.5) * 2.0 ** -53
    g = -torch.log(-torch.log(u))
    return (logits.double() / temperature + g).argmax(dim=-1)


# -- weights carried across from flax ------------------------------------------

def from_flax_params(params) -> dict[str, torch.Tensor]:
    """The port's ``state_dict`` for the flax parameter tree of
    ``horovod_tpu.models.transformer.Transformer`` (numpy leaves): every
    kernel keeps its flax shape, so the map is by name only."""
    def t(a):
        return torch.from_numpy(np.array(a, dtype=np.float32))

    out = {"embed": t(params["Embed_0"]["embedding"]),
           "norm.scale": t(params["RMSNorm_0"]["scale"]),
           "lm_head": t(params["lm_head"]["kernel"])}
    i = 0
    while f"block_{i}" in params:
        p = params[f"block_{i}"]
        pre = f"blocks.{i}."
        out[pre + "norm1.scale"] = t(p["RMSNorm_0"]["scale"])
        out[pre + "norm2.scale"] = t(p["RMSNorm_1"]["scale"])
        for name in ("query", "key", "value", "out"):
            out[f"{pre}attn.{name}"] = t(p["attn"][name]["kernel"])
        out[pre + "mlp_in"] = t(p["Dense_0"]["kernel"])
        out[pre + "mlp_out"] = t(p["Dense_1"]["kernel"])
        i += 1
    return out

"""Transformer (GPT-style causal LM) — the long-context model family.

Counterpart of the training side of ``horovod_tpu/models/transformer.py``:
the same network, parameter for parameter, so weights carry across
(:func:`from_flax_params`) and both frameworks compute the same function.
Pre-norm blocks (RMSNorm → attention → RMSNorm → GELU MLP), rotary position
embeddings, grouped-query attention (``num_kv_heads``), an optional sliding
``window`` and packed-sequence ``segment_ids``. Attention goes through
:func:`~horovod_tpu_torch.parallel.sequence.local_attention`, which sends
sequences longer than 2048 tokens on the GPU to the flash kernels B3/B4.

Parameters keep flax's shapes and are fp32; each op casts them and its
input to the compute ``dtype`` (bf16 by default), as flax's ``dtype`` does:
``embed`` (V, E), per block ``norm1``/``norm2`` scales (E,), ``attn.query``
(E, H, D), ``attn.key``/``attn.value`` (E, Hkv, D), ``attn.out`` (H, D, E),
``mlp_in`` (E, M), ``mlp_out`` (M, E), then ``norm`` (E,) and ``lm_head``
(E, V). Numerics follow flax: RMSNorm takes its statistics in fp32
(ε = 1e-6) and returns ``dtype``; GELU is the tanh approximation; rotary
runs in fp32; the logits come out fp32. Rotary tables are computed per call,
not kept as buffers, so ``Trainer`` has no buffers to average.

Not ported yet: sequence-parallel attention (``attention='ring'`` /
``'ulysses'``, the ``'zigzag'`` layout — ROADMAP §A item 13) and the
decode side (``decode=True``, the KV cache, ``generate``/``prefill``/
``decode_step``, paged ``kv_view`` — ROADMAP §A items 10 and 14); those
raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from horovod_tpu_torch.models.resnet import lecun_normal_
from horovod_tpu_torch.ops.losses import default_chunk, fused_cross_entropy
from horovod_tpu_torch.parallel.sequence import local_attention


class TransformerConfig(NamedTuple):
    vocab_size: int = 32_000
    num_layers: int = 4
    num_heads: int = 8
    embed_dim: int = 512
    mlp_dim: int = 2048
    max_seq_len: int = 2048
    dtype: torch.dtype = torch.bfloat16
    attention: str = "local"      # only 'local' is ported
    sp_group: int = 0
    num_kv_heads: int | None = None  # GQA/MQA: fewer K/V heads (None = MHA)
    sp_layout: str = "contiguous"
    decode: bool = False
    window: int | None = None     # sliding-window attention (causal SWA)


def _not_ported(config: TransformerConfig) -> None:
    if config.attention in ("ring", "ulysses"):
        raise NotImplementedError(
            f"attention={config.attention!r} (sequence parallelism) is not "
            f"ported to horovod_tpu_torch yet: ROADMAP §A item 13. Use "
            f"attention='local'.")
    if config.attention != "local":
        raise ValueError(f"Unknown attention strategy {config.attention!r}.")
    if config.sp_layout != "contiguous":
        raise NotImplementedError(
            f"sp_layout={config.sp_layout!r} belongs to ring attention, "
            f"which is not ported yet: ROADMAP §A item 13.")
    if config.decode:
        raise NotImplementedError(
            "decode=True (KV-cache generation, prefill/decode_step, paged "
            "kv_view) is not ported to horovod_tpu_torch yet: ROADMAP §A "
            "items 10 and 14. The port trains only.")


def _rotary(x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """Rotary position embedding on (B, T, H, D), in fp32, cast back.
    ``positions``: (T,) shared across the batch or (B, T) per row."""
    half = x.shape[-1] // 2
    freqs = 1.0 / (10000.0 ** (torch.arange(half, dtype=torch.float32,
                                            device=x.device) / half))
    angles = positions[..., None].float() * freqs
    cos, sin = angles.cos(), angles.sin()
    if angles.ndim == 2:
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    else:
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


def _dense(x: torch.Tensor, w: torch.Tensor, dtype) -> torch.Tensor:
    """flax Dense/DenseGeneral without bias: x and the fp32 kernel, both cast
    to ``dtype``, contracted over x's last dim and w's leading dims."""
    return x.to(dtype) @ w.to(dtype).reshape(x.shape[-1], -1)


class RMSNorm(nn.Module):
    """flax ``nn.RMSNorm``: statistics in fp32, ε = 1e-6, output ``dtype``."""

    def __init__(self, dim: int, dtype: torch.dtype) -> None:
        super().__init__()
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mul = torch.rsqrt((xf * xf).mean(-1, keepdim=True) + 1e-6) * self.scale
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

    def forward(self, x, positions, segment_ids=None):
        cfg = self.config
        b, t, _ = x.shape
        q = _rotary(_dense(x, self.query, cfg.dtype).reshape(
            b, t, self.h, self.d), positions)
        k = _rotary(_dense(x, self.key, cfg.dtype).reshape(
            b, t, self.hkv, self.d), positions)
        v = _dense(x, self.value, cfg.dtype).reshape(b, t, self.hkv, self.d)
        out = local_attention(q, k, v, causal=True, window=cfg.window,
                              q_segment_ids=segment_ids,
                              kv_segment_ids=segment_ids)
        return _dense(out.reshape(b, t, self.h * self.d), self.out,
                      cfg.dtype)


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

    def forward(self, x, positions, segment_ids=None):
        x = x + self.attn(self.norm1(x), positions, segment_ids)
        y = _dense(self.norm2(x), self.mlp_in, self.dtype)
        y = F.gelu(y, approximate="tanh")
        return x + _dense(y, self.mlp_out, self.dtype)


class Transformer(nn.Module):
    """Decoder-only LM over a whole sequence: ``tokens`` (B, T) int →
    fp32 logits (B, T, V), or the final-norm hidden states (B, T, E) in
    ``dtype`` with ``return_hidden=True`` (what the fused loss takes).
    ``shard_offset``: global position of the first token; ``positions``:
    explicit (T,) positions overriding it. Weights are initialised as flax
    initialises the reference (LeCun-normal kernels, N(0, 0.02) embedding,
    unit norm scales), drawing from ``generator``."""

    def __init__(self, config: TransformerConfig,
                 generator: torch.Generator | None = None) -> None:
        super().__init__()
        _not_ported(config)
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
        if positions is None:
            positions = shard_offset + torch.arange(tokens.shape[1],
                                                    device=tokens.device)
        x = F.embedding(tokens, self.embed.to(self.config.dtype))
        for block in self.blocks:
            x = block(x, positions, segment_ids)
        x = self.norm(x)
        if return_hidden:
            return x
        return _dense(x, self.lm_head, self.config.dtype).float()


def init_params(config: TransformerConfig, seed: int = 0,
                device: str | torch.device = "cuda"):
    """A :class:`Transformer` with weights drawn from a ``torch.Generator``
    seeded with ``seed``, on ``device`` — the GPU unless the caller passes
    ``device='cpu'``; without CUDA the default raises instead of building
    on the CPU. The weights are drawn on the CPU, so they are the same on
    every device. (The JAX package's ``init_params`` returns a parameter
    tree; here the module holds its parameters.)"""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "init_params: CUDA is not available on this host. The port "
            "runs on the GPU by default; pass device='cpu' to build the "
            "model on the CPU.")
    g = torch.Generator().manual_seed(seed)
    return Transformer(config, generator=g).to(device)


def make_loss_fn(config: TransformerConfig, fused_head: bool = False):
    """``loss_fn(model, tokens) -> loss``: next-token cross-entropy, mean
    over the B·(T − 1) transitions, for :class:`~horovod_tpu_torch.Trainer`.

    ``fused_head=True`` runs the lm_head product inside
    :func:`~horovod_tpu_torch.ops.losses.fused_cross_entropy` (chunked
    vocabulary): the (N, V) logits never materialize, at the cost of one
    extra head-product recompute in the backward. Plain data parallelism
    only (the reference's ``sp_rank`` is for sequence parallelism, not
    ported yet)."""
    _not_ported(config)

    def loss_fn(model: Transformer, tokens: torch.Tensor) -> torch.Tensor:
        targets = tokens[:, 1:].reshape(-1).long()
        if fused_head:
            hidden = model(tokens, return_hidden=True)
            w = model.lm_head.to(config.dtype)
            x2 = hidden[:, :-1].reshape(-1, hidden.shape[-1])
            return fused_cross_entropy(x2, w, targets,
                                       chunk=default_chunk(w.shape[1]))
        logits = model(tokens)
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

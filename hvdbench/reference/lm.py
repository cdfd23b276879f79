"""The long-context LM in plain PyTorch, float32: the benchmark's reference
for the ``lm`` family, written without any kernel of the program.

A decoder-only causal LM of pre-norm blocks:

* RMSNorm (epsilon 1e-6, a learned scale, no bias);
* attention: rotary position embeddings (base 10000, the head dim split
  into halves) on queries and keys, grouped-query attention (``num_kv_heads``
  key/value heads, each shared by ``num_heads / num_kv_heads`` query
  heads), causal softmax at scale ``1/sqrt(head_dim)``, no biases;
* a non-gated MLP with the tanh form of GELU, no biases;
* a token embedding and an untied output head.

The loss is next-token cross-entropy, the mean over every row's ``T - 1``
transitions. Parameter names and shapes are the program's, so one set of
weights loads into both.

To fit a full-width step on one card in float32, :func:`loss_and_grads`
takes one row of the batch at a time and recomputes each block in the
backward pass (``torch.utils.checkpoint``); the gradient is the same sum.
``cast`` is applied to both operands of every product: the identity, or
the lower precision of the control (``reference/lowp.py``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint


def _ident(x):
    return x


class RMSNorm(nn.Module):
    def __init__(self, e: int) -> None:
        super().__init__()
        self.scale = nn.Parameter(torch.empty(e))

    def forward(self, x):
        return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + 1e-6) \
            * self.scale


def rotary(x, positions):
    """Rotary embedding on (B, T, H, D): the two halves of each head
    rotated by position x 10000^(-i / (D/2))."""
    half = x.shape[-1] // 2
    freqs = 1.0 / (10000.0 ** (torch.arange(half, dtype=torch.float32,
                                            device=x.device) / half))
    ang = positions[:, None].float() * freqs
    cos, sin = ang.cos()[None, :, None], ang.sin()[None, :, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


class Attention(nn.Module):
    def __init__(self, cfg: dict) -> None:
        super().__init__()
        e, h, hkv = cfg["embed_dim"], cfg["num_heads"], cfg["num_kv_heads"]
        d = e // h
        self.h, self.hkv, self.d = h, hkv, d
        self.query = nn.Parameter(torch.empty(e, h, d))
        self.key = nn.Parameter(torch.empty(e, hkv, d))
        self.value = nn.Parameter(torch.empty(e, hkv, d))
        self.out = nn.Parameter(torch.empty(h, d, e))

    def forward(self, x, cast=_ident):
        b, t, e = x.shape
        pos = torch.arange(t, device=x.device)
        cx = cast(x)
        q = rotary(torch.einsum("bte,ehd->bthd", cx, cast(self.query)), pos)
        k = rotary(torch.einsum("bte,ehd->bthd", cx, cast(self.key)), pos)
        v = torch.einsum("bte,ehd->bthd", cx, cast(self.value))
        rep = self.h // self.hkv
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
        s = torch.einsum("bqhd,bkhd->bhqk", cast(q), cast(k)) \
            / math.sqrt(self.d)
        mask = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
        p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
        o = torch.einsum("bhqk,bkhd->bqhd", cast(p), cast(v))
        return torch.einsum("bthd,hde->bte", cast(o), cast(self.out))


class Block(nn.Module):
    def __init__(self, cfg: dict) -> None:
        super().__init__()
        e, m = cfg["embed_dim"], cfg["mlp_dim"]
        self.norm1 = RMSNorm(e)
        self.attn = Attention(cfg)
        self.norm2 = RMSNorm(e)
        self.mlp_in = nn.Parameter(torch.empty(e, m))
        self.mlp_out = nn.Parameter(torch.empty(m, e))

    def forward(self, x, cast=_ident):
        x = x + self.attn(self.norm1(x), cast)
        y = F.gelu(cast(self.norm2(x)) @ cast(self.mlp_in),
                   approximate="tanh")
        return x + cast(y) @ cast(self.mlp_out)


class LM(nn.Module):
    def __init__(self, cfg: dict) -> None:
        super().__init__()
        e, v = cfg["embed_dim"], cfg["vocab_size"]
        self.embed = nn.Parameter(torch.empty(v, e))
        self.blocks = nn.ModuleList(Block(cfg) for _ in range(
            cfg["num_layers"]))
        self.norm = RMSNorm(e)
        self.lm_head = nn.Parameter(torch.empty(e, v))

    def row_loss(self, tokens, cast=_ident):
        """The mean next-token cross-entropy of (1, T) tokens."""
        x = F.embedding(tokens, self.embed)
        for block in self.blocks:
            x = checkpoint(block, x, cast, use_reentrant=False)
        x = self.norm(x)[:, :-1]
        logits = cast(x) @ cast(self.lm_head)
        return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                               tokens[:, 1:].reshape(-1))


def loss_and_grads(model: LM, cfg: dict, tokens, cast=_ident) -> float:
    """The batch's mean loss, with its gradient accumulated into the
    parameters' ``.grad``, one row at a time."""
    rows = tokens.shape[0]
    total = 0.0
    for r in range(rows):
        row = model.row_loss(tokens[r:r + 1], cast) / rows
        row.backward()
        total += float(row.detach())
    return total


def init_spec(cfg: dict) -> list[tuple]:
    """How the benchmark draws each parameter: ``(name, shape, kind,
    arg)``: the embedding ``normal`` with std 0.02, every projection
    ``lecun`` (a normal truncated at 2 sigma, variance 1/fan_in, fan_in
    the contracted size), the norm scales ``const`` 1."""
    with torch.device("meta"):
        model = LM(cfg)
    e, h = cfg["embed_dim"], cfg["num_heads"]
    spec = []
    for name, t in model.state_dict().items():
        shape = tuple(t.shape)
        if name == "embed":
            spec.append((name, shape, "normal", 0.02))
        elif name.endswith("scale"):
            spec.append((name, shape, "const", 1.0))
        elif name.endswith("attn.out"):
            spec.append((name, shape, "lecun", h * (e // h)))
        else:  # query, key, value, mlp_in, mlp_out, lm_head
            spec.append((name, shape, "lecun", shape[0]))
    return spec


def build(cfg: dict) -> LM:
    return LM(cfg)

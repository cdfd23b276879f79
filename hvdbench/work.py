"""The work a cell's step requires, counted from its shapes, and the table of
the card's peaks: the numbers the per-layer metrics divide by. Nothing here
reads the program; the counts are the benchmark's own.

Peaks are NVIDIA's data sheet for the H100 SXM (dense, no sparsity, at the
full 700-W limit).
"""

from __future__ import annotations

BF16_FLOPS = 989e12     # dense bf16 tensor cores
HBM_BYTES = 3.35e12     # device memory bandwidth


# -- the LM -------------------------------------------------------------------

def lm_param_sizes(cfg: dict) -> list[int]:
    """The element count of every parameter tensor, in the model's
    order."""
    e, m, v = cfg["embed_dim"], cfg["mlp_dim"], cfg["vocab_size"]
    h, hkv = cfg["num_heads"], cfg["num_kv_heads"]
    d = e // h
    block = [e, e * h * d, e * hkv * d, e * hkv * d, h * d * e, e, e * m,
             m * e]
    return [v * e, *block * cfg["num_layers"], e, e * v]


def lm_matmul_params(cfg: dict) -> int:
    """The parameters that enter a matrix product: every block's
    projections and the head (the embedding is a lookup, the norms are
    scales)."""
    e, m, v = cfg["embed_dim"], cfg["mlp_dim"], cfg["vocab_size"]
    h, hkv = cfg["num_heads"], cfg["num_kv_heads"]
    d = e // h
    block = 2 * e * h * d + 2 * e * hkv * d + 2 * e * m
    return block * cfg["num_layers"] + e * v


def causal_pairs(batch: int, seq: int, heads: int) -> int:
    """The (query, key) pairs a causal attention call sees."""
    return batch * heads * seq * (seq + 1) // 2


def flash_fwd_flops(batch: int, seq: int, heads: int, head_dim: int) -> float:
    """Causal attention forward: two products over the visible pairs."""
    return 4.0 * head_dim * causal_pairs(batch, seq, heads)


def flash_bwd_flops(batch: int, seq: int, heads: int, head_dim: int) -> float:
    """Causal attention backward: 2.5x the forward (five products)."""
    return 2.5 * flash_fwd_flops(batch, seq, heads, head_dim)


def lm_flops_per_step(cfg: dict, batch: int, seq: int) -> float:
    """6 x the matmul parameters x the tokens, plus causal attention at
    3.5x its forward FLOPs in every layer; nothing recomputed is
    counted."""
    d = cfg["embed_dim"] // cfg["num_heads"]
    attn = flash_fwd_flops(batch, seq, cfg["num_heads"], d)
    return (6.0 * lm_matmul_params(cfg) * batch * seq
            + 3.5 * attn * cfg["num_layers"])


def adamw_bytes(sizes, param_bytes: int = 4, moment_bytes: int = 2) -> int:
    """AdamW's required bytes: parameter and gradient read, parameter
    written, both moments read and written, and each tensor's int32 step
    count read and written."""
    return sum(n * (3 * param_bytes + 4 * moment_bytes) + 8 for n in sizes)

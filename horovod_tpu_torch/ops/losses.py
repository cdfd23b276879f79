"""Fused (chunked-vocab) softmax cross-entropy — the LM-head loss.

Counterpart of ``horovod_tpu/ops/losses.py``. A causal LM's loss would
materialize logits of shape (N, V) — 1 GB in fp32 at N = 16k tokens and
V = 32k — write them, read them for the log-sum-exp, keep them for the
backward and produce an equally large dlogits. :func:`fused_cross_entropy`
computes ``CE(x @ W, targets)`` without them: the forward keeps a running
log-sum-exp over vocabulary chunks (the flash-attention trick on the vocab
axis), and the backward recomputes each chunk's logits and feeds its
``softmax − onehot`` straight into the dx/dW products. Peak memory is
O(N · chunk). A vocabulary that the chunk does not divide gets one
remainder chunk, no padding.

The reference is plain JAX (XLA matmuls), so the products here are plain
torch matmuls: bf16 (or fp32) operands with fp32 results, as the reference's
``preferred_element_type=float32``.
"""

from __future__ import annotations

import torch

# Default vocabulary chunk width (the reference's measured best on its TPU;
# the chunk changes the memory footprint, not the function).
DEFAULT_CHUNK = 8192


def default_chunk(vocab_size: int) -> int:
    """The chunk :func:`fused_cross_entropy` callers use by default."""
    return min(DEFAULT_CHUNK, vocab_size)


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with an fp32 result from operands of one dtype. On the GPU
    the product accumulates in fp32 and is written in fp32 (``out_dtype``);
    on the CPU the operands are widened first, which is exact."""
    if a.device.type == "cuda" and a.dtype != torch.float32:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.float(), b.float())


def _chunks(v: int, chunk: int):
    """(start, end) of each vocab chunk: full chunks, then a remainder."""
    return [(s, min(s + chunk, v)) for s in range(0, v, chunk)]


class _FusedCrossEntropy(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, w, targets, chunk):
        n = x.shape[0]
        m = torch.full((n,), float("-inf"), device=x.device)
        s = torch.zeros((n,), device=x.device)
        tl = torch.zeros((n,), device=x.device)
        for start, end in _chunks(w.shape[1], chunk):
            logits = _mm_f32(x, w[:, start:end])
            m_new = torch.maximum(m, logits.amax(-1))
            s = s * torch.exp(m - m_new) + torch.exp(
                logits - m_new[:, None]).sum(-1)
            local = targets - start
            in_chunk = (local >= 0) & (local < end - start)
            picked = logits.gather(
                1, local.clamp(0, end - start - 1)[:, None])[:, 0]
            tl = torch.where(in_chunk, picked, tl)
            m = m_new
        lse = m + torch.log(s)
        ctx.save_for_backward(x, w, targets, lse)
        ctx.chunk = chunk
        return (lse - tl).mean()

    @staticmethod
    def backward(ctx, g):
        x, w, targets, lse = ctx.saved_tensors
        n = x.shape[0]
        scale = g / n                               # d(mean)/d(per-token)
        dx = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        dws = []
        for start, end in _chunks(w.shape[1], ctx.chunk):
            wc = w[:, start:end]
            p = torch.exp(_mm_f32(x, wc) - lse[:, None])
            local = targets - start
            onehot = (local[:, None] == torch.arange(
                end - start, device=x.device)[None, :]).float()
            dlogits = ((p - onehot) * scale).to(x.dtype)
            dx += _mm_f32(dlogits, wc.t())
            dws.append(_mm_f32(x.t(), dlogits))
        dw = dws[0] if len(dws) == 1 else torch.cat(dws, dim=1)
        return dx.to(x.dtype), dw.to(w.dtype), None, None


def fused_cross_entropy(x: torch.Tensor, w: torch.Tensor,
                        targets: torch.Tensor,
                        chunk: int = DEFAULT_CHUNK) -> torch.Tensor:
    """Mean cross-entropy of ``x @ w`` against integer ``targets``.

    ``x``: (N, E) activations (matmuls run in its dtype with fp32 results);
    ``w``: (E, V) vocabulary projection in x's dtype; ``targets``: (N,)
    integer class ids. Equals ``F.cross_entropy((x @ w).float(), targets)``
    without materializing the (N, V) logits in either direction; any
    vocabulary size works (a trailing remainder chunk handles V % chunk).
    """
    return _FusedCrossEntropy.apply(x, w, targets, chunk)

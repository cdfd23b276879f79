"""Fused (chunked-vocab) softmax cross-entropy — the LM-head loss — and
kernel A2.

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
``preferred_element_type=float32``. What the reference leaves XLA to fuse
around them — each chunk's max, sum of exp and target pick in the forward,
its ``(softmax − onehot) · scale`` cast to x's dtype in the backward — is on
the card one launch a chunk in each direction of kernel A2
(``horovod_tpu_torch/csrc/ce_head.cu``): one read of the fp32 tile each,
where eager PyTorch makes about 6 and 12 passes over it. CPU tensors take
the plain versions (:func:`fold_plain`, :func:`dlogits_plain`), the same
function in PyTorch; any other tensor launches A2 or raises, outside
:func:`plain_chunks`, which holds A2 to the plain versions on the card.
Launches are counted in :data:`LAUNCHES`. The forward and the backward
are the step spans ``head`` and ``head_bwd`` (``core/timeline.py``).
"""

from __future__ import annotations

import contextlib
import ctypes

import torch

from horovod_tpu_torch.core import timeline as _tl
from horovod_tpu_torch.ops import _build
from horovod_tpu_torch.ops import launches as _launches

# Default vocabulary chunk width (the reference's measured best on its TPU;
# the chunk changes the memory footprint, not the function).
DEFAULT_CHUNK = 8192

# Kernel launches since the last reset_launch_counts(); only the CUDA branch
# counts, one a chunk in each direction (a captured launch at each replay of
# its graph: ops/launches.py).
LAUNCHES = {"ce_chunk_fwd": 0, "ce_chunk_bwd": 0}

# dlogits' dtypes A2 writes (csrc/ce_head.cu's out_type codes).
_OUT_TYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
VECTOR_WIDTHS = (8, 4, 2, 1)  # elements a thread takes at a time

_lib = None


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _kernels():
    """``hvd_ce_chunk_fwd`` and ``hvd_ce_chunk_bwd`` (``csrc/ce_head.cu``),
    built at first use."""
    global _lib
    if _lib is None:
        lib = _build.load("ce_head")
        vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.hvd_ce_chunk_fwd.argtypes = [vp, ll, ll, vp, ll, vp, vp, vp, i,
                                         vp]
        lib.hvd_ce_chunk_fwd.restype = i
        lib.hvd_ce_chunk_bwd.argtypes = [vp, ll, ll, vp, ll, vp, vp, vp, i,
                                         i, vp]
        lib.hvd_ce_chunk_bwd.restype = i
        _lib = lib
    return _lib


def default_chunk(vocab_size: int) -> int:
    """The chunk :func:`fused_cross_entropy` callers use by default."""
    return min(DEFAULT_CHUNK, vocab_size)


def vector_width(width: int, operands) -> int:
    """The elements an A2 thread takes at a time for rows of ``width``
    elements: the largest of :data:`VECTOR_WIDTHS` that divides ``width``
    and keeps every access aligned — each operand, ``(base address, element
    size)``, needs its base on ``min(vec · size, 16)`` bytes. A contiguous
    row then starts aligned too, so one width serves the whole tile."""
    for vec in VECTOR_WIDTHS:
        if width % vec == 0 and all(addr % min(vec * size, 16) == 0
                                    for addr, size in operands):
            return vec
    return 1


def _mm_f32(a: torch.Tensor, b: torch.Tensor, out=None) -> torch.Tensor:
    """``a @ b`` with an fp32 result from operands of one dtype, into
    ``out`` when given. On the GPU the product accumulates in fp32 and is
    written in fp32 (``out_dtype``); on the CPU the operands are widened
    first, which is exact."""
    if a.device.type == "cuda" and a.dtype != torch.float32:
        return torch.mm(a, b, out_dtype=torch.float32, out=out)
    return torch.mm(a.float(), b.float(), out=out)


def _chunks(v: int, chunk: int):
    """(start, end) of each vocab chunk: full chunks, then a remainder."""
    return [(s, min(s + chunk, v)) for s in range(0, v, chunk)]


# -- the plain versions (CPU tensors) ------------------------------------------

def fold_plain(m, s, tl, logits, targets, start: int):
    """One chunk of the forward: the running max ``m`` and sum of exp ``s``
    (relative to ``m``) moved over the chunk's ``logits`` (N, W) fp32, and
    ``tl`` the target's logit where ``targets`` falls in the chunk. Returns
    the new ``(m, s, tl)``."""
    width = logits.shape[1]
    m_new = torch.maximum(m, logits.amax(-1))
    s = s * torch.exp(m - m_new) + torch.exp(
        logits - m_new[:, None]).sum(-1)
    local = targets - start
    in_chunk = (local >= 0) & (local < width)
    picked = logits.gather(1, local.clamp(0, width - 1)[:, None])[:, 0]
    return m_new, s, torch.where(in_chunk, picked, tl)


def dlogits_plain(logits, targets, start: int, lse, scale, dtype):
    """One chunk of the backward: ``(softmax − onehot) · scale`` of the
    chunk's fp32 ``logits`` against the full row's ``lse``, in ``dtype``."""
    p = torch.exp(logits - lse[:, None])
    local = targets - start
    onehot = (local[:, None] == torch.arange(
        logits.shape[1], device=logits.device)[None, :]).float()
    return ((p - onehot) * scale).to(dtype)


# -- kernel A2 ------------------------------------------------------------------

def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_kernel_call(name: str, logits, targets, rows) -> None:
    """What A2 refuses, before any launch."""
    if logits.device.type != "cuda":
        raise RuntimeError(
            f"{name}: no kernel for device {logits.device}; tensors on the "
            f"CPU take the plain version, others must be CUDA tensors.")
    if logits.dtype != torch.float32 or logits.dim() != 2 \
            or not logits.is_contiguous():
        raise ValueError(
            f"{name}: the kernel reads a contiguous (N, W) float32 logit "
            f"tile, got {logits.dtype} of shape {tuple(logits.shape)} with "
            f"strides {logits.stride()}.")
    n = logits.shape[0]
    for what, t in (("targets", targets), *rows):
        if t.device != logits.device:
            raise RuntimeError(f"{name}: {what} must be on {logits.device}, "
                               f"got {t.device}.")
        want = torch.int64 if what == "targets" else torch.float32
        if t.dtype != want or t.shape != (n,) or not t.is_contiguous():
            raise ValueError(
                f"{name}: {what} must be a contiguous ({n},) {want} vector, "
                f"got {t.dtype} of shape {tuple(t.shape)}.")


def fold_kernel(m, s, tl, logits, targets, start: int):
    """:func:`fold_plain` as one launch of A2's forward on CUDA tensors:
    ``m``, ``s`` and ``tl`` are updated in place and returned."""
    _check_kernel_call("ce_chunk_fwd", logits, targets,
                       (("m", m), ("s", s), ("tl", tl)))
    n, width = logits.shape
    if n == 0:
        return m, s, tl
    vec = vector_width(width, [(logits.data_ptr(), 4)])
    with torch.cuda.device(logits.device):
        err = _kernels().hvd_ce_chunk_fwd(
            logits.data_ptr(), n, width, targets.data_ptr(), start,
            m.data_ptr(), s.data_ptr(), tl.data_ptr(), vec, _stream(logits))
    if err != 0:
        raise RuntimeError(f"ce_chunk_fwd: CUDA error {err} at kernel launch.")
    _launches.count(LAUNCHES, "ce_chunk_fwd")
    return m, s, tl


def dlogits_kernel(logits, targets, start: int, lse, scale, dtype):
    """:func:`dlogits_plain` as one launch of A2's backward on CUDA tensors;
    ``scale`` is a 0-d float32 tensor on the card, read by the kernel."""
    _check_kernel_call("ce_chunk_bwd", logits, targets, (("lse", lse),))
    if dtype not in _OUT_TYPES:
        raise TypeError(f"ce_chunk_bwd: the kernel writes float32, bfloat16 "
                        f"or float16 dlogits, got {dtype}.")
    if scale.dtype != torch.float32 or scale.dim() != 0 \
            or scale.device != logits.device:
        raise ValueError(
            f"ce_chunk_bwd: the scale must be a 0-d float32 tensor on "
            f"{logits.device}, got {scale.dtype} of shape "
            f"{tuple(scale.shape)} on {scale.device}.")
    n, width = logits.shape
    out = torch.empty((n, width), dtype=dtype, device=logits.device)
    if n == 0:
        return out
    vec = vector_width(width, [(logits.data_ptr(), 4),
                               (out.data_ptr(), out.element_size())])
    with torch.cuda.device(logits.device):
        err = _kernels().hvd_ce_chunk_bwd(
            logits.data_ptr(), n, width, targets.data_ptr(), start,
            lse.data_ptr(), scale.data_ptr(), out.data_ptr(),
            _OUT_TYPES[dtype], vec, _stream(logits))
    if err != 0:
        raise RuntimeError(f"ce_chunk_bwd: CUDA error {err} at kernel launch.")
    _launches.count(LAUNCHES, "ce_chunk_bwd")
    return out


def _fold(m, s, tl, logits, targets, start):
    if logits.device.type == "cpu":
        return fold_plain(m, s, tl, logits, targets, start)
    return fold_kernel(m, s, tl, logits, targets, start)


def _dlogits(logits, targets, start, lse, scale, dtype):
    if logits.device.type == "cpu":
        return dlogits_plain(logits, targets, start, lse, scale, dtype)
    return dlogits_kernel(logits, targets, start, lse, scale, dtype)


@contextlib.contextmanager
def plain_chunks():
    """Inside the block, every chunk's work — on any device — is taken by
    the plain versions (:func:`fold_plain`, :func:`dlogits_plain`) around
    the same matmuls: A2's yardstick on the card."""
    global _fold, _dlogits
    kept = _fold, _dlogits
    _fold, _dlogits = fold_plain, dlogits_plain
    try:
        yield
    finally:
        _fold, _dlogits = kept


class _FusedCrossEntropy(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, w, targets, chunk):
        _tl.begin("head")
        n = x.shape[0]
        targets = targets.to(torch.int64).contiguous()
        m = torch.full((n,), float("-inf"), device=x.device)
        s = torch.zeros((n,), device=x.device)
        tl = torch.zeros((n,), device=x.device)
        for start, end in _chunks(w.shape[1], chunk):
            m, s, tl = _fold(m, s, tl, _mm_f32(x, w[:, start:end]), targets,
                             start)
        lse = m + torch.log(s)
        ctx.save_for_backward(x, w, targets, lse)
        ctx.chunk = chunk
        loss = (lse - tl).mean()
        _tl.end("head")
        return loss

    @staticmethod
    def backward(ctx, g):
        _tl.begin("head_bwd")
        x, w, targets, lse = ctx.saved_tensors
        n = x.shape[0]
        scale = g / n                               # d(mean)/d(per-token)
        dx = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        # Each chunk's dW is written into its columns of one buffer.
        dw = torch.empty(w.shape, dtype=torch.float32, device=x.device)
        for start, end in _chunks(w.shape[1], ctx.chunk):
            wc = w[:, start:end]
            dlogits = _dlogits(_mm_f32(x, wc), targets, start, lse, scale,
                               x.dtype)
            dx += _mm_f32(dlogits, wc.t())
            _mm_f32(x.t(), dlogits, out=dw[:, start:end])
        dx, dw = dx.to(x.dtype), dw.to(w.dtype)
        _tl.end("head_bwd")
        return dx, dw, None, None


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

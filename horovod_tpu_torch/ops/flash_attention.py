"""Flash attention — CUDA kernels B3/B4 and the plain attention paths.

Counterpart of ``horovod_tpu/ops/flash_attention.py``. The TPU package runs
attention above 2048 tokens through a Pallas forward kernel and one fused
Pallas backward kernel; here the same two functions are CUDA C++ kernels
written for Hopper (``horovod_tpu_torch/csrc/flash_fwd.cu`` and
``flash_bwd.cu``, on the TMA/mbarrier/wgmma machinery of
``flash_common.cuh``): a producer warp streams tiles into a shared-memory
ring by TMA while two consumer warpgroups multiply them with ``wgmma``.

* **B3** (forward) — online-softmax attention: O and the per-row natural-log
  LSE, never materializing the (Tq, Tk) scores;
* **B4** (backward) — FlashAttention-2 gradients from the saved LSE: dq, dk,
  dv with di = rowsum(dO·O) − g_lse. B4 is two kernels, a dk/dv kernel
  (one block per kv tile, looping over the q-heads of its GQA group and the
  q tiles) and a dq kernel (one block per q tile, looping over the kv
  tiles): Hopper's blocks run in no order, and this split sums every
  gradient inside one block in a fixed order, with no float atomics and no
  fp32 dq partials to reduce afterwards, so B4 is deterministic: the same
  inputs give the same bits.

:func:`flash_attention` and :func:`flash_attention_lse` are
``torch.autograd.Function``\\ s: B3 in the forward, which saves O and the LSE,
B4 in the backward. ``flash_attention_lse`` also returns the LSE, which is
differentiable (its cotangent enters B4 as di − g_lse; ring attention merges
partial results through it).

Dispatch is by the tensor's device alone: a CPU tensor takes the plain
PyTorch versions (:func:`flash_fwd_plain`, :func:`flash_bwd_plain` — block
loops with the same online softmax, FA2 math and bf16 rounding points, in
fp32), which is what the CPU tests run; any other tensor launches the kernels
or raises. There is no fallback. Launches are counted in :data:`LAUNCHES`,
one per B3 or B4 call.

Numerics, as in the JAX package: q/k/v (and dO) are rounded to bf16, products
accumulate in fp32, P and dS are rounded to bf16 before their products, and
O/dq/dk/dv come out in the inputs' dtypes. The softmax scale multiplies the
fp32 scores; the TPU kernels fold √(scale·log2e) into the bf16 operands
instead — a difference in rounding only (ROADMAP §C). A row that sees no key
gets O = 0, a very negative finite LSE and zero gradients.

:func:`blockwise_attention` is the JAX package's plain ``lax.scan`` path
(``local_attention``'s choice off the TPU above 2048 tokens): an online
softmax over K/V blocks, each block under ``torch.utils.checkpoint`` so the
backward recomputes its scores instead of keeping (Tq, Tk) of them.
"""

from __future__ import annotations

import ctypes
import math
from types import SimpleNamespace

import torch
from torch.utils.checkpoint import checkpoint

from horovod_tpu_torch.ops import _build

# Kernel launches per wrapper since the last reset_launch_counts(); only the
# CUDA branch counts, where the kernels are actually launched (B4's two
# kernels count as one launch of B4).
LAUNCHES = {"flash_fwd": 0, "flash_bwd": 0}

# Head dims the kernels are instantiated for: every one the repo's models use.
HEAD_DIMS = (16, 32, 64, 128)

_NEG_INF = -1e30
_POS_BIG = 1e30
_DEAD_LSE = _NEG_INF * 0.5  # an LSE at or below this belongs to a dead row
_LOG2E = math.log2(math.e)
_LN2 = math.log(2.0)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# The plain versions' kv block. Any size computes the same function; 64 is
# the kernels' forward tile.
_PLAIN_BLOCK_K = 64

_lib = None


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _kernels():
    """The entry points ``hvd_flash_fwd`` (``csrc/flash_fwd.cu``) and
    ``hvd_flash_bwd`` (``csrc/flash_bwd.cu``), built at first use."""
    global _lib
    if _lib is None:
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fwd = _build.load("flash_fwd").hvd_flash_fwd
        fwd.argtypes = [vp] * 7 + [i] * 10 + [f, i, vp]
        fwd.restype = i
        bwd = _build.load("flash_bwd").hvd_flash_bwd
        bwd.argtypes = [vp] * 11 + [i] * 10 + [f, i, vp]
        bwd.restype = i
        _lib = SimpleNamespace(hvd_flash_fwd=fwd, hvd_flash_bwd=bwd)
    return _lib


# -- argument checks (error texts identical to the JAX package's) ---------------

def _check_gqa(h: int, hkv: int) -> int:
    if h % hkv != 0:
        raise ValueError(
            f"GQA needs q heads ({h}) divisible by kv heads ({hkv}).")
    return h // hkv


def _check_window(window, causal):
    if window is not None:
        if not causal:
            raise ValueError(
                "window (sliding-window attention) requires causal=True.")
        if window < 1:
            raise ValueError(f"window must be >= 1 (got {window}).")


def _check_seg_pair(qseg, kvseg):
    if (qseg is None) != (kvseg is None):
        raise ValueError(
            "q_segment_ids and kv_segment_ids must be given together.")


def _visible(tq: int, k0: int, k1: int, tk: int, causal: bool, q_offset: int,
             kv_offset: int, window, qseg, kvseg, device) -> torch.Tensor:
    """Visibility of keys [k0, k1) from every query: (Tq, k1-k0) bool, or
    (B, 1, Tq, k1-k0) with segment ids (broadcasts over heads)."""
    qpos = q_offset + torch.arange(tq, device=device)[:, None]
    kloc = torch.arange(k0, k1, device=device)[None, :]
    kpos = kv_offset + kloc
    valid = kloc < tk
    if causal:
        valid = valid & (qpos >= kpos)
        if window is not None:
            valid = valid & (kpos > qpos - window)
    if qseg is not None:
        seg_ok = qseg[:, :, None] == kvseg[:, None, k0:k1]
        valid = valid[None] & seg_ok
        return valid[:, None]
    return valid


def _bf16_bhtd(x: torch.Tensor, g: int = 1) -> torch.Tensor:
    """(B, T, Hx, D) → fp32 (B, Hx·g, T, D) holding bf16-rounded values, each
    kv head repeated for the ``g`` q heads it serves."""
    x = x.to(torch.bfloat16).float()
    if g > 1:
        x = x.repeat_interleave(g, dim=2)
    return x.transpose(1, 2)


def _round_bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def _resolve_scale(sm_scale, d: int) -> float:
    return 1.0 / math.sqrt(d) if sm_scale is None else float(sm_scale)


# -- plain versions ---------------------------------------------------------------

def flash_fwd_plain(q, k, v, causal: bool = True, sm_scale=None,
                    q_offset: int = 0, kv_offset: int = 0,
                    q_segment_ids=None, kv_segment_ids=None, window=None):
    """Plain PyTorch B3: ``(out, lse)`` with out (B, Tq, H, D) in q's dtype
    and lse (B, H, Tq) fp32, by a loop over kv blocks with the kernel's
    base-2 online softmax in fp32."""
    b, tq, h, d = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    g = _check_gqa(h, hkv)
    c2 = _resolve_scale(sm_scale, d) * _LOG2E
    qb, kb, vb = _bf16_bhtd(q), _bf16_bhtd(k, g), _bf16_bhtd(v, g)
    m = torch.full((b, h, tq), _NEG_INF, device=q.device)
    l = torch.zeros((b, h, tq), device=q.device)
    acc = torch.zeros((b, h, tq, d), device=q.device)
    for k0 in range(0, tk, _PLAIN_BLOCK_K):
        k1 = min(k0 + _PLAIN_BLOCK_K, tk)
        valid = _visible(tq, k0, k1, tk, causal, q_offset, kv_offset, window,
                         q_segment_ids, kv_segment_ids, q.device)
        s = torch.where(valid, (qb @ kb[:, :, k0:k1].transpose(-1, -2)) * c2,
                        _NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp2(m - m_new)
        p = torch.where(valid, torch.exp2(s - m_new[..., None]), 0.0)
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + _round_bf16(p) @ vb[:, :, k0:k1]
        m = m_new
    l = l.clamp_min(1e-20)
    lse = (m + torch.log2(l)) * _LN2
    out = (acc / l[..., None]).transpose(1, 2).to(q.dtype)
    return out, lse


def flash_bwd_plain(q, k, v, out, lse, g_out, g_lse=None, causal: bool = True,
                    sm_scale=None, q_offset: int = 0, kv_offset: int = 0,
                    q_segment_ids=None, kv_segment_ids=None, window=None):
    """Plain PyTorch B4: ``(dq, dk, dv)`` in q's, k's and v's dtypes from the
    forward's ``out`` and ``lse`` (B, H, Tq) and the cotangents ``g_out``
    (B, Tq, H, D) and ``g_lse`` (B, Tq, H) or None."""
    b, tq, h, d = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    g = _check_gqa(h, hkv)
    scale = _resolve_scale(sm_scale, d)
    c2 = scale * _LOG2E
    di = _di(out, g_out, g_lse)
    lse2 = torch.where(lse <= _DEAD_LSE, _POS_BIG, lse * _LOG2E)[..., None]
    qb, kb, vb = _bf16_bhtd(q), _bf16_bhtd(k, g), _bf16_bhtd(v, g)
    dob = _bf16_bhtd(g_out)
    dq = torch.zeros((b, h, tq, d), device=q.device)
    dk = torch.zeros((b, h, tk, d), device=q.device)
    dv = torch.zeros((b, h, tk, d), device=q.device)
    for k0 in range(0, tk, _PLAIN_BLOCK_K):
        k1 = min(k0 + _PLAIN_BLOCK_K, tk)
        kk, vv = kb[:, :, k0:k1], vb[:, :, k0:k1]
        valid = _visible(tq, k0, k1, tk, causal, q_offset, kv_offset, window,
                         q_segment_ids, kv_segment_ids, q.device)
        p = torch.where(valid,
                        torch.exp2((qb @ kk.transpose(-1, -2)) * c2 - lse2),
                        0.0)
        dv[:, :, k0:k1] = _round_bf16(p).transpose(-1, -2) @ dob
        ds = _round_bf16(p * (dob @ vv.transpose(-1, -2) - di[..., None]))
        dk[:, :, k0:k1] = ds.transpose(-1, -2) @ qb
        dq += ds @ kk
    dk = dk.reshape(b, hkv, g, tk, d).sum(2) * scale
    dv = dv.reshape(b, hkv, g, tk, d).sum(2)
    return ((dq * scale).transpose(1, 2).to(q.dtype),
            dk.transpose(1, 2).to(k.dtype), dv.transpose(1, 2).to(v.dtype))


def _di(out, g_out, g_lse):
    """di = rowsum(dO·O) − g_lse, fp32 (B, H, Tq): the softmax-jacobian
    correction, elementwise work outside the kernels as in the reference."""
    di = (g_out.float() * out.float()).sum(-1)
    if g_lse is not None:
        di = di - g_lse.float()
    return di.transpose(1, 2).contiguous()


# -- kernel wrappers ----------------------------------------------------------------

def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at kernel launch.")


def _kernel_operand(name: str, t: torch.Tensor, device) -> torch.Tensor:
    """A contiguous, 16-byte-aligned bf16 copy (or the tensor itself) for the
    kernels, whose TMA tensor maps need a 16-byte-aligned base (every row
    stride, heads · D · 2 bytes, is a multiple of 16)."""
    if t.device != device:
        raise ValueError(f"{name}: every operand must be on {device}, got "
                         f"{t.device}.")
    t = t.to(torch.bfloat16).contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _check_kernel_call(name: str, q, k, v, qseg, kvseg):
    """What the kernels refuse, checked before the device: every refusal
    raises, so the order only decides which message a caller sees first."""
    for t in (q, k, v):
        if t.dtype not in _DTYPE_CODES:
            raise TypeError(f"{name}: the kernels take bfloat16 or float32, "
                            f"got {t.dtype}.")
    if not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"{name}: q, k and v must share one dtype, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}.")
    b, tq, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"{name}: k and v must be (B, Tk, Hkv, {d}) with "
                         f"B={b}, got {tuple(k.shape)} and {tuple(v.shape)}.")
    if d not in HEAD_DIMS:
        raise ValueError(
            f"{name}: the CUDA kernels are built for head dims {HEAD_DIMS}, "
            f"got {d} (ROADMAP §C).")
    if qseg is not None:
        if qseg.shape != (b, tq) or kvseg.shape != (b, k.shape[1]):
            raise ValueError(
                f"{name}: segment ids must be (B, Tq)=({b}, {tq}) and "
                f"(B, Tk)=({b}, {k.shape[1]}), got {tuple(qseg.shape)} and "
                f"{tuple(kvseg.shape)}.")
    if q.device.type != "cuda":
        raise RuntimeError(
            f"{name}: no kernel for device {q.device}; tensors on the CPU take "
            f"the plain version, others must be CUDA tensors.")


def _segs(qseg, kvseg, device):
    if qseg is None:
        return None, None, None, None
    qs = qseg.to(device=device, dtype=torch.int32).contiguous()
    ks = kvseg.to(device=device, dtype=torch.int32).contiguous()
    return qs, ks, qs.data_ptr(), ks.data_ptr()


def flash_fwd_kernel(q, k, v, causal: bool = True, sm_scale=None,
                     q_offset: int = 0, kv_offset: int = 0,
                     q_segment_ids=None, kv_segment_ids=None, window=None):
    """Launch B3 on CUDA tensors; same contract as :func:`flash_fwd_plain`."""
    _check_kernel_call("flash_fwd", q, k, v, q_segment_ids, kv_segment_ids)
    b, tq, h, d = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    _check_gqa(h, hkv)
    qc, kc, vc = (_kernel_operand(n, t, q.device)
                  for n, t in (("q", q), ("k", k), ("v", v)))
    qs, ks, qs_p, ks_p = _segs(q_segment_ids, kv_segment_ids, q.device)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    lib = _kernels()
    with torch.cuda.device(q.device):
        err = lib.hvd_flash_fwd(
            qc.data_ptr(), kc.data_ptr(), vc.data_ptr(), qs_p, ks_p,
            out.data_ptr(), lse.data_ptr(), b, tq, tk, h, hkv, d, int(causal),
            window or 0, int(q_offset), int(kv_offset),
            _resolve_scale(sm_scale, d), _DTYPE_CODES[q.dtype], _stream(q))
    _raise_on(err, "flash_fwd")
    LAUNCHES["flash_fwd"] += 1
    return out, lse


def flash_bwd_kernel(q, k, v, out, lse, g_out, g_lse=None, causal: bool = True,
                     sm_scale=None, q_offset: int = 0, kv_offset: int = 0,
                     q_segment_ids=None, kv_segment_ids=None, window=None):
    """Launch B4 on CUDA tensors; same contract as :func:`flash_bwd_plain`."""
    _check_kernel_call("flash_bwd", q, k, v, q_segment_ids, kv_segment_ids)
    b, tq, h, d = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    _check_gqa(h, hkv)
    if lse.shape != (b, h, tq) or lse.dtype != torch.float32:
        raise ValueError(f"flash_bwd: lse must be float32 ({b}, {h}, {tq}), "
                         f"got {lse.dtype} {tuple(lse.shape)}.")
    qc, kc, vc, doc = (_kernel_operand(n, t, q.device) for n, t in
                       (("q", q), ("k", k), ("v", v), ("g_out", g_out)))
    di = _di(out, g_out, g_lse)
    lse = lse.contiguous()
    qs, ks, qs_p, ks_p = _segs(q_segment_ids, kv_segment_ids, q.device)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dk = torch.empty(k.shape, dtype=k.dtype, device=q.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=q.device)
    lib = _kernels()
    with torch.cuda.device(q.device):
        err = lib.hvd_flash_bwd(
            qc.data_ptr(), kc.data_ptr(), vc.data_ptr(), doc.data_ptr(),
            lse.data_ptr(), di.data_ptr(), qs_p, ks_p, dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), b, tq, tk, h, hkv, d, int(causal),
            window or 0, int(q_offset), int(kv_offset),
            _resolve_scale(sm_scale, d), _DTYPE_CODES[q.dtype], _stream(q))
    _raise_on(err, "flash_bwd")
    LAUNCHES["flash_bwd"] += 1
    return dq, dk, dv


def flash_fwd(q, k, v, **kw):
    """B3: CPU tensors take :func:`flash_fwd_plain`; others launch the kernel."""
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, **kw)
    return flash_fwd_kernel(q, k, v, **kw)


def flash_bwd(q, k, v, out, lse, g_out, g_lse=None, **kw):
    """B4: CPU tensors take :func:`flash_bwd_plain`; others launch the
    kernels."""
    if q.device.type == "cpu":
        return flash_bwd_plain(q, k, v, out, lse, g_out, g_lse, **kw)
    return flash_bwd_kernel(q, k, v, out, lse, g_out, g_lse, **kw)


# -- autograd ------------------------------------------------------------------------

class _Flash(torch.autograd.Function):
    """B3 forward, B4 backward; outputs ``(out, lse)`` with lse (B, Tq, H)."""

    @staticmethod
    def forward(ctx, q, k, v, qseg, kvseg, causal, sm_scale, q_offset,
                kv_offset, window):
        ctx.kw = dict(causal=causal, sm_scale=sm_scale, q_offset=q_offset,
                      kv_offset=kv_offset, window=window)
        out, lse = flash_fwd(q, k, v, q_segment_ids=qseg,
                             kv_segment_ids=kvseg, **ctx.kw)
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(q, k, v, out, lse, qseg, kvseg)
        return out, lse.transpose(1, 2).contiguous()

    @staticmethod
    def backward(ctx, g_out, g_lse):
        q, k, v, out, lse, qseg, kvseg = ctx.saved_tensors
        if g_out is None:
            g_out = torch.zeros_like(out)
        dq, dk, dv = flash_bwd(q, k, v, out, lse, g_out, g_lse,
                               q_segment_ids=qseg, kv_segment_ids=kvseg,
                               **ctx.kw)
        return dq, dk, dv, None, None, None, None, None, None, None


def _flash(q, k, v, causal, sm_scale, q_offset, kv_offset, q_segment_ids,
           kv_segment_ids, window):
    _check_seg_pair(q_segment_ids, kv_segment_ids)
    _check_window(window, causal)
    _check_gqa(q.shape[2], k.shape[2])
    return _Flash.apply(q, k, v, q_segment_ids, kv_segment_ids, causal,
                        sm_scale, q_offset, kv_offset, window)


def flash_attention(q, k, v, causal: bool = True, sm_scale=None,
                    q_offset: int = 0, kv_offset: int = 0, *,
                    q_segment_ids=None, kv_segment_ids=None, window=None):
    """Flash attention, (B, T, H, D) layout; returns (B, Tq, H, D) in q's
    dtype.

    ``q``: (B, Tq, H, D); ``k``/``v``: (B, Tk, Hkv, D) with H a multiple of
    Hkv (each kv head serves H/Hkv consecutive q heads).
    ``q_offset``/``kv_offset``: global positions of q[:, 0] and k[:, 0] for
    causal masking. ``q_segment_ids``/``kv_segment_ids``: optional (B, Tq)/
    (B, Tk) integer packed-sequence ids; attention is masked to equal ids.
    ``window``: sliding-window attention (causal only), query p sees keys
    [p − window + 1, p]. Forward B3, backward B4; no (Tq, Tk) matrix is
    kept in either direction.
    """
    out, _ = _flash(q, k, v, causal, sm_scale, q_offset, kv_offset,
                    q_segment_ids, kv_segment_ids, window)
    return out


def flash_attention_lse(q, k, v, causal: bool = True, sm_scale=None,
                        q_offset: int = 0, kv_offset: int = 0, *,
                        q_segment_ids=None, kv_segment_ids=None, window=None):
    """Like :func:`flash_attention` but returns ``(out, lse)``; ``lse``:
    (B, Tq, H) fp32 log-sum-exp of the scaled scores per query row (very
    negative and finite for a row that sees nothing). Both outputs are
    differentiable: the lse cotangent enters B4 as di' = di − g_lse."""
    return _flash(q, k, v, causal, sm_scale, q_offset, kv_offset,
                  q_segment_ids, kv_segment_ids, window)


# -- blockwise attention (plain, any device) ------------------------------------------

def _blockwise_step(m, l, acc, qT, kb, vb, valid, sm_scale):
    """Fold one K/V block into the running (max, normalizer, accumulator)."""
    s = torch.where(valid, (qT.float() @ kb.float().transpose(-1, -2))
                    * sm_scale, _NEG_INF)
    m_new = torch.maximum(m, s.amax(-1))
    alpha = torch.exp(m - m_new)
    # Fully-masked-so-far guard: exp(s − m_new) would be exp(0) there.
    p = torch.where(valid, torch.exp(s - m_new[..., None]), 0.0)
    l_new = l * alpha + p.sum(-1)
    acc_new = acc * alpha[..., None] + (p.to(torch.bfloat16).float()
                                        @ vb.float())
    return m_new, l_new, acc_new


def blockwise_attention(q, k, v, causal: bool = True, sm_scale=None,
                        q_offset: int = 0, kv_offset: int = 0,
                        block_k: int = 512, q_segment_ids=None,
                        kv_segment_ids=None, window=None):
    """Online-softmax attention over K/V blocks of ``block_k``, any device.

    Same arguments and result as :func:`flash_attention` (plus the block
    size). Each block runs under ``torch.utils.checkpoint``, so the
    backward recomputes the block's scores from (q, k-block) instead of
    keeping every (Tq, block_k) probability matrix — the full T² — alive.
    """
    _check_seg_pair(q_segment_ids, kv_segment_ids)
    _check_window(window, causal)
    b, tq, h, d = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    g = _check_gqa(h, hkv)
    if g > 1:
        k = k.repeat_interleave(g, dim=2)
        v = v.repeat_interleave(g, dim=2)
    sm_scale = _resolve_scale(sm_scale, d)
    block_k = min(block_k, tk)
    qT = q.transpose(1, 2).to(torch.bfloat16)
    kT = k.transpose(1, 2).to(torch.bfloat16)
    vT = v.transpose(1, 2).to(torch.bfloat16)
    m = torch.full((b, h, tq), _NEG_INF, device=q.device)
    l = torch.zeros((b, h, tq), device=q.device)
    acc = torch.zeros((b, h, tq, d), device=q.device)
    for k0 in range(0, tk, block_k):
        k1 = min(k0 + block_k, tk)
        valid = _visible(tq, k0, k1, tk, causal, q_offset, kv_offset, window,
                         q_segment_ids, kv_segment_ids, q.device)
        m, l, acc = checkpoint(_blockwise_step, m, l, acc, qT,
                               kT[:, :, k0:k1], vT[:, :, k0:k1], valid,
                               sm_scale, use_reentrant=False)
    out = acc / l.clamp_min(1e-20)[..., None]
    return out.transpose(1, 2).to(q.dtype)

"""Single-device attention dispatch — ``local_attention``.

Counterpart of ``horovod_tpu/parallel/sequence.py::local_attention``, the
attention every rank runs on its full sequence under plain data
parallelism. Ring and Ulysses attention (sequence parallelism) are not
ported yet (ROADMAP §A item 13).
"""

from __future__ import annotations

import torch

from horovod_tpu_torch.core.state import HorovodError
from horovod_tpu_torch.ops import flash_attention as _fa

_NEG_INF = -1e30


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

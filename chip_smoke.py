#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of horovod_tpu on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line of output each:

1. the card's name and power limit (``nvidia-smi``);
2. build every CUDA source of the main paths (``horovod_tpu_torch/csrc``:
   ``batchnorm.cu``, ``flash_fwd.cu``, ``flash_bwd.cu``) with ``nvcc`` for
   ``sm_90a``, all builds started together;
3. each kernel against its plain PyTorch version on the card, in bf16 and
   fp32, at every distinct (N, C) the main path gives it (ResNet-50, batch
   128, 224 px — read off the model's BatchNorm inputs) plus one ragged N;
   kernel, plain, bound and library-call times (``torch.batch_norm_stats``
   for B1, ``torch.batch_norm_backward_reduce`` for B2, which is checked
   against B2's plain version);
4. one full-width ResNet-50 ``Trainer`` step (224 px, 1000 classes, batch 2)
   on the card with the kernels (bf16) against the same step on the CPU
   with the plain path (fp32): loss and every gradient;
5. the main path: ``hvd.init()`` (world of 1, NCCL), ResNet-50 at full
   width with ``norm_impl="fused"``, batch 128, bf16,
   ``DistributedOptimizer(SGD(0.1, momentum=0.9))``, ``Trainer.fit`` for 10
   steps on a repeated seeded batch; the loss must be finite and fall, and
   each kernel's launch count must grow by exactly 53 per step (53
   BatchNorm layers);
6. the flash kernels B3/B4 against their plain versions on the card, row
   by row, at small shapes for every masking mode (GQA, ragged lengths
   crossing the kernels' tiles, offsets, dead rows, window, segment ids, an
   LSE cotangent, fp32 operands) and at the LM's shape (B=2, T=8192, H=8,
   Hkv=4, D=128, causal, bf16); every case run twice, and the two runs must
   agree bit for bit (B4 uses no float atomics); five planted faults,
   confined to late tiles or to di, must fail that check; kernel, plain,
   bound and library times at the LM's shape
   (``scaled_dot_product_attention``: its forward for B3, forward +
   backward for B4, and its backward alone, ``library_bwd_ms``), with each
   kernel's achieved TFLOP/s and share of its bound;
7. one step of the full-width LM (E=1024, H=8, Hkv=4, mlp 4096, V=32768),
   depth cut to 2 layers, B=1, T=2304, fused head, through
   ``Trainer.train_step`` on the card (B3/B4, fp32 and bf16) against the
   same loss and gradients on the CPU (``blockwise``, fp32), every
   gradient tensor held on its own; B4 with di dropped must fail it;
8. the LM's main path: bench.py's config (8 layers, T=8192, B=2, bf16,
   fused head), ``DistributedOptimizer(AdamW(3e-4, weight_decay=0.1))``,
   ``Trainer.fit`` for 10 steps on a repeated seeded batch; the loss must be
   finite and fall, and B3 and B4 must launch exactly 8 times a step.

Each main path (5 and 8) runs with its kernels' launch counts set to 0
just before it and read just after. Then a JSON line with each kernel's
record, and last the result line
``{"ok": true, "device": {...}}``. Any failed phase raises: the script then
exits non-zero and prints no result. It also fails without CUDA, and when
the ``horovod_tpu_torch`` package is not beside it.

Precision: TF32 is switched off for fp32 matmuls and convolutions
(``torch.backends.cuda.matmul.allow_tf32 = False``,
``torch.backends.cudnn.allow_tf32 = False``), so fp32 work on the card is
full fp32; the main path computes in bf16, which TF32 does not touch.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

import horovod_tpu_torch as hvd
from horovod_tpu_torch.models import resnet, transformer
from horovod_tpu_torch.models.layers import FusedBatchNorm
from horovod_tpu_torch.ops import _build
from horovod_tpu_torch.ops import batchnorm as bn
from horovod_tpu_torch.ops import flash_attention as fa
from horovod_tpu_torch.ops.optim import AdamW
from horovod_tpu_torch.training.callbacks import Callback

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 0
BATCH = 128
IMAGE = 224
CLASSES = 1000
STEPS = 10
BN_LAYERS = 53            # BatchNorm layers of ResNet-50
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_FLOPS_PER_S = 67e12   # H100 SXM, fp32 outside the tensor cores
KERNEL_TOL = 1e-5          # |kernel − plain| ≤ KERNEL_TOL · Σ|term|, per channel
LIBRARY_TOL = 1e-4         # the same, for the library call timed beside B2
# Phase 4 limits (relative loss error, relative L2 error of all gradients)
# against the CPU fp32 step. fp32 on the card differs from the CPU only in
# summation order. bf16 keeps 8 significant bits, and the error of each
# rounding is carried through 53 BatchNorm layers, whose statistics at batch
# 2 amplify it: the bf16 limits are a sanity bound, the fp32 ones (with
# phase 3) the kernels' check.
STEP_FP32_TOL = (1e-4, 1e-2)
STEP_BF16_TOL = (2e-2, 0.3)
REPS = 20

BF16_FLOPS_PER_S = 989e12  # H100 SXM data sheet, dense bf16 tensor cores
# Attention of the LM at full width: (B, T, H, Hkv, D), causal.
LM_ATTN_SHAPE = (2, 8192, 8, 4, 128)
FLASH_OUTPUTS = ("O", "dq", "dk", "dv")
# B3/B4 against their plain versions, row by row: for every row of O, dq,
# dk and dv (the D values of one batch, position and head),
# ‖kernel − plain‖₂ / ‖plain‖₂, the worst row counting. Rows differ in
# scale by orders of magnitude (a causal O row averages i + 1 values, an
# early key's dk sums every later query), so a limit on the whole tensor
# would let the small rows go unchecked. The denominator is floored at
# FLASH_ROW_FLOOR of the tensor's rms row norm: a row that is ~0 by
# cancellation (dq of a query that sees one key) is judged at the
# tensor's scale, and a row that is exactly 0 on both sides (dead rows,
# keys no query sees) reads 0. Both sides round the same quantities to bf16
# (q, k, v, dO, P, dS) and accumulate in fp32; a row moves where a
# summation-order difference flips one bf16 rounding of P, dS or the output
# (2^-8 of that value). Read on an H100: at most 5.1e-3 at the small cases
# and 6.8e-3 at the LM's shape (dq); the planted faults read 0.2 and up.
# The limit, 2e-2, is 3x the worst sound reading and 10x below the
# weakest fault: an error of 10% in any row fails.
FLASH_ROW_TOL = 2e-2
FLASH_ROW_FLOOR = 1e-3
# The LSE is fp32 on both sides, from fp32 scores: 1e-3 absolute (natural
# log units) on rows that see a key; rows that see none must agree on it.
LSE_TOL = 1e-3
# SDPA (timed beside B3/B4) against B3's plain version, the same row
# error: SDPA rounds at its own points (read: 4.0e-3).
LIBRARY_FLASH_TOL = 2e-2
# The planted faults' first q or kv tile (64 rows or keys a tile) at the
# first small case (T=192) and at the LM's shape (T=8192).
FAULT_TILE = {"small": 2, "LM": 64}
# Launches timed at the LM's shape, a mean as everywhere: now and then one
# SDPA launch stalls (SDPA's forward read 0.48 ms in most calls and 1.05 ms
# in one as a mean of 5), so its mean takes 10.
FLASH_REPS = 10
# The LM: bench.py's full-width config (_lm_extra) and its main-path batch.
LM_LAYERS = 8
LM_BATCH = 2
LM_T = 8192
# The card-vs-CPU LM step: depth cut to 2 layers, one row of 2304 tokens
# (above local_attention's 2048 switch).
LM_STEP_LAYERS = 2
LM_STEP_T = 2304
# Its limits (relative loss error, relative L2 error of all gradients
# together, the worst single tensor's relative L2 error) against the CPU
# fp32 step. The embedding and lm_head gradients dominate the total, so the
# attention weights' gradients are held by the per-tensor limit. Card fp32:
# the matmuls are full fp32 on both sides, but attention rounds to bf16 at
# different points on the two (B3/B4 round P and dS; the CPU's blockwise
# path rounds P and the cotangents of its bf16 casts), each rounding 2^-8
# relative: a gradient error of a few 2^-8, limit 3e-2 in total and 2e-2
# per tensor (read: 2.67e-3 and 7.04e-3); the loss moves far less, limit
# 1e-3. Card bf16 rounds every activation and product (2^-8 each, through
# 2 layers and a 32768-way softmax): a sanity bound, as for the ResNet
# step, 6e-2 per tensor (read: 1.88e-2).
LM_STEP_FP32_TOL = (1e-3, 3e-2, 2e-2)
LM_STEP_BF16_TOL = (2e-2, 0.3, 6e-2)
# Small B3/B4 checks: (name, (B, Tq, Tk, H, Hkv, D), dtype, kwargs,
# segment ids). "g_lse" in kwargs also feeds an LSE cotangent to B4.
FLASH_CASES = (
    ("causal", (2, 192, 192, 4, 4, 64), torch.bfloat16,
     dict(causal=True), False),
    ("non-causal GQA ragged", (1, 130, 200, 4, 2, 128), torch.bfloat16,
     dict(causal=False), False),
    ("offsets g_lse", (1, 80, 200, 4, 1, 32), torch.bfloat16,
     dict(causal=True, q_offset=120, kv_offset=0, g_lse=True), False),
    ("dead rows", (1, 96, 160, 2, 2, 16), torch.bfloat16,
     dict(causal=True, q_offset=0, kv_offset=40, g_lse=True), False),
    ("window", (2, 300, 300, 4, 2, 128), torch.bfloat16,
     dict(causal=True, window=100), False),
    ("segments", (2, 257, 257, 4, 2, 64), torch.bfloat16,
     dict(causal=True, g_lse=True), True),
    ("fp32 operands", (1, 200, 200, 8, 4, 128), torch.float32,
     dict(causal=True), False),
    # Crosses the kernels' 128-row q and kv tiles (and B4's 64-row ones) in
    # both lengths, with four q heads to a kv head.
    ("GQA tile edges", (1, 257, 257, 8, 2, 128), torch.bfloat16,
     dict(causal=False), False),
)


def say(msg: str) -> None:
    print(msg, flush=True)


def card_identity() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
        check=True)
    return out.stdout.strip().splitlines()[0]


def seeded_resnet50(dtype, device):
    """ResNet-50 (fused BN) with weights made from SEED on the CPU. Where the
    reference zero-initialises each block's last BN scale, these draw it
    from U(0, 0.2): each block still starts close to the identity, and every
    layer gets a non-zero gradient."""
    g = torch.Generator().manual_seed(SEED)
    model = resnet.ResNet50(num_classes=CLASSES, dtype=dtype,
                            norm_impl="fused", generator=g)
    with torch.no_grad():
        for block in model.blocks:
            block.norm3.scale.copy_(
                torch.rand(block.norm3.scale.shape, generator=g) * 0.2)
    return model.to(device)


def cuda_time_ms(fn, flush, reps: int = REPS) -> float:
    """Mean device time of ``fn()`` over ``reps`` launches, each after a
    write of a buffer larger than L2, so every launch finds its input cold."""
    for _ in range(3):
        fn()
    total = 0.0
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def bn_shapes(model, images):
    """(N, C) of every BatchNorm input of one forward pass, in order."""
    shapes = []
    hooks = [m.register_forward_pre_hook(
        lambda mod, args: shapes.append(
            (args[0].numel() // args[0].shape[-1], args[0].shape[-1])))
        for m in model.modules() if isinstance(m, FusedBatchNorm)]
    try:
        with torch.no_grad():
            model.train()(images)
    finally:
        for h in hooks:
            h.remove()
    return shapes


def phase_kernels(model, device):
    """Phase 3: B1/B2 against their plain versions, and their times."""
    g = torch.Generator(device=device).manual_seed(SEED)
    images = torch.randn((BATCH, IMAGE, IMAGE, 3), generator=g, device=device)
    layer_shapes = bn_shapes(model, images)
    if len(layer_shapes) != BN_LAYERS:
        raise RuntimeError(f"expected {BN_LAYERS} BatchNorm inputs, saw "
                           f"{len(layer_shapes)}")
    distinct = sorted(set(layer_shapes))
    ragged = (25087, 1024)
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=device)
    rec = {k: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
               "bound_ms": 0.0, "library_ms": 0.0,
               "bound_terms": {"bytes": 0.0, "operations": 0.0}}
           for k in ("channel_sums", "channel_grad_sums")}
    worst_rel = 0.0
    worst_library_rel = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        for (n, c) in distinct + [ragged]:
            x = (torch.randn((n, c), generator=g, device=device) * 3 + 2) \
                .to(dtype)
            dy = torch.randn((n, c), generator=g, device=device).to(dtype)
            xf, dyf = x.float(), dy.float()
            mean = xf.mean(0)
            rstd = torch.rsqrt(xf.var(0, unbiased=False) + 1e-5)
            s1, s2 = bn.channel_sums(x)
            p1, p2 = bn.channel_sums_plain(x)
            sdy, sdx = bn.channel_grad_sums(dy, x, mean, rstd)
            q1, q2 = bn.channel_grad_sums_plain(dy, x, mean, rstd)
            torch.cuda.synchronize()
            term = dyf * (xf - mean) * rstd
            for key, pairs in (
                    ("channel_sums", ((s1, p1, xf.abs()), (s2, p2, xf * xf))),
                    ("channel_grad_sums", ((sdy, q1, dyf.abs()),
                                           (sdx, q2, term.abs())))):
                for got, want, mag in pairs:
                    diff = (got - want).abs()
                    rel = float((diff / mag.sum(0).clamp_min(1e-30)).max())
                    worst_rel = max(worst_rel, rel)
                    rec[key]["max_abs_err"] = max(rec[key]["max_abs_err"],
                                                  float(diff.max()))
                    if not rel <= KERNEL_TOL:
                        raise RuntimeError(
                            f"{key} disagrees with its plain version at "
                            f"({n}, {c}) {dtype}: {rel:.3e} > {KERNEL_TOL} "
                            f"of the summed magnitude")
            if dtype != torch.bfloat16 or (n, c) == ragged:
                del xf, dyf, term
                continue
            # The library calls timed beside B1/B2: batch_norm_stats gives
            # mean and invstd (B1's sums, finished), batch_norm_backward_
            # reduce with weight 1 gives Σdy and Σdy·x̂ (B2's function).
            ones = torch.ones(c, dtype=torch.float32, device=device)
            lib_sdy, _, lib_sdx, _ = torch.batch_norm_backward_reduce(
                dy, x, mean, rstd, ones, False, True, True)
            for got, want, mag in ((lib_sdy, q1, dyf.abs()),
                                   (lib_sdx, q2, term.abs())):
                worst_library_rel = max(worst_library_rel, float(
                    ((got.float() - want).abs()
                     / mag.sum(0).clamp_min(1e-30)).max()))
            del xf, dyf, term
            # Per-step times: each distinct shape weighted by how many of
            # the 53 layers have it (bf16, the main path's dtype).
            count = layer_shapes.count((n, c))
            elem = n * c
            times = {
                ("channel_sums", "ms"): lambda: bn.channel_sums(x),
                ("channel_sums", "plain_ms"): lambda: bn.channel_sums_plain(x),
                ("channel_sums", "library_ms"):
                    lambda: torch.batch_norm_stats(x, 1e-5),
                ("channel_grad_sums", "ms"):
                    lambda: bn.channel_grad_sums(dy, x, mean, rstd),
                ("channel_grad_sums", "plain_ms"):
                    lambda: bn.channel_grad_sums_plain(dy, x, mean, rstd),
                ("channel_grad_sums", "library_ms"):
                    lambda: torch.batch_norm_backward_reduce(
                        dy, x, mean, rstd, ones, False, True, True),
            }
            for (key, field), fn in times.items():
                rec[key][field] += count * cuda_time_ms(fn, flush)
            # Bounds: bytes read once and written once over the memory
            # rate, or fp32 operations over the fp32 rate, the larger; the
            # term that wins at each shape is credited with its time.
            for key, nbytes, ops in (
                    ("channel_sums", elem * 2 + 2 * c * 4, 3 * elem),
                    ("channel_grad_sums",
                     2 * elem * 2 + 2 * c * 4 + 2 * c * 4, 5 * elem)):
                terms = {"bytes": nbytes / HBM_BYTES_PER_S,
                         "operations": ops / FP32_FLOPS_PER_S}
                by = max(terms, key=terms.get)
                rec[key]["bound_ms"] += count * terms[by] * 1e3
                rec[key]["bound_terms"][by] += count * terms[by] * 1e3
    del flush
    torch.cuda.empty_cache()
    if not worst_library_rel <= LIBRARY_TOL:
        raise RuntimeError(
            f"batch_norm_backward_reduce disagrees with channel_grad_sums_"
            f"plain: {worst_library_rel:.3e} > {LIBRARY_TOL} of the summed "
            f"magnitude, so it is not B2's function")
    for r in rec.values():
        terms = r.pop("bound_terms")
        r["bound_by"] = max(terms, key=terms.get)
    return rec, distinct, worst_rel, worst_library_rel


# -- flash attention (B3/B4) ------------------------------------------------------

def _flash_inputs(b, tq, tk, h, hkv, d, dtype, device, seed, segs=False):
    g = torch.Generator(device=device).manual_seed(seed)
    q = torch.randn((b, tq, h, d), generator=g, device=device).to(dtype)
    k = torch.randn((b, tk, hkv, d), generator=g, device=device).to(dtype)
    v = torch.randn((b, tk, hkv, d), generator=g, device=device).to(dtype)
    g_out = torch.randn((b, tq, h, d), generator=g, device=device).to(dtype)
    g_lse = torch.randn((b, tq, h), generator=g, device=device)
    kw = {}
    if segs:
        # Three packed documents per row; the q side's third id differs
        # from the kv side's, so its rows see nothing (dead rows).
        qs = torch.zeros((b, tq), dtype=torch.int32, device=device)
        ks = torch.zeros((b, tk), dtype=torch.int32, device=device)
        qs[:, tq // 3:] = 1
        ks[:, tk // 3:] = 1
        qs[:, 2 * tq // 3:] = 2
        ks[:, 2 * tk // 3:] = 3
        kw = dict(q_segment_ids=qs, kv_segment_ids=ks)
    return q, k, v, g_out, g_lse, kw


def _row_err(got, want) -> float:
    """The worst row's ‖got − want‖₂ / ‖want‖₂ over the last dim, the
    denominator floored at FLASH_ROW_FLOOR of the rms row norm."""
    d = want.shape[-1]
    w = want.float().reshape(-1, d)
    num = (got.float().reshape(-1, d) - w).norm(dim=1)
    den = w.norm(dim=1)
    floor = FLASH_ROW_FLOOR * float(den.pow(2).mean().sqrt())
    return float((num / den.clamp_min(max(floor, 1e-30))).max())


def _max_rel_err(outs, wants) -> float:
    """max|got − want| / max|want|, the worst of O/dq/dk/dv: printed
    beside the row error for the planted faults, it shows how much of a
    late-tile fault a whole-tensor scale hides."""
    return max(float((a.float() - b.float()).abs().max()
                     / b.float().abs().max().clamp_min(1e-30))
               for a, b in zip(outs, wants))


def _flash_kernels(q, k, v, g_out, g_lse, kw):
    """(out, lse, dq, dk, dv) of B3 then B4."""
    out, lse = fa.flash_fwd_kernel(q, k, v, **kw)
    return (out, lse, *fa.flash_bwd_kernel(q, k, v, out, lse, g_out, g_lse,
                                           **kw))


def _flash_run(q, k, v, g_out, g_lse, kw):
    """(out, lse, dq, dk, dv) of B3/B4 and of their plain versions on the
    same card inputs. B3/B4 run twice and must give the same bits: every
    sum stays in one block, in a fixed order."""
    got = _flash_kernels(q, k, v, g_out, g_lse, kw)
    again = _flash_kernels(q, k, v, g_out, g_lse, kw)
    p_out, p_lse = fa.flash_fwd_plain(q, k, v, **kw)
    p_grads = fa.flash_bwd_plain(q, k, v, p_out, p_lse, g_out, g_lse, **kw)
    torch.cuda.synchronize()
    differ = [n for n, a, b in zip(("O", "lse") + FLASH_OUTPUTS[1:], got,
                                   again) if not torch.equal(a, b)]
    if differ:
        raise RuntimeError(f"B3/B4 are not deterministic: a second run on "
                           f"the same inputs changed {differ}")
    return got, (p_out, p_lse, *p_grads)


def _flash_errors(got, want) -> dict:
    """Row errors of O/dq/dk/dv, the LSE's absolute error on rows that see
    a key, whether both sides agree on which rows see none, and the largest
    absolute errors of B3 (O, LSE) and of B4 (dq, dk, dv)."""
    (out, lse, *grads), (p_out, p_lse, *p_grads) = got, want
    errs = {n: _row_err(a, b) for n, a, b in
            zip(FLASH_OUTPUTS, (out, *grads), (p_out, *p_grads))}
    live = p_lse > fa._DEAD_LSE
    errs["lse"] = float((lse - p_lse)[live].abs().max()) if live.any() \
        else 0.0
    errs["dead_rows_agree"] = torch.equal(live, lse > fa._DEAD_LSE)
    errs["fwd_abs"] = max(float((out.float() - p_out.float()).abs().max()),
                          errs["lse"])
    errs["bwd_abs"] = max(float((a.float() - b.float()).abs().max())
                          for a, b in zip(grads, p_grads))
    return errs


def _flash_faults(errs) -> str:
    """What breaks the limits, or '' when nothing does."""
    bad = [f"{n} row err {errs[n]:.3e}" for n in FLASH_OUTPUTS
           if not errs[n] <= FLASH_ROW_TOL]
    if not errs["lse"] <= LSE_TOL:
        bad.append(f"lse err {errs['lse']:.3e}")
    if not errs["dead_rows_agree"]:
        bad.append("they disagree on which rows see no key")
    return "; ".join(bad)


def _check_flash(name, got, want) -> dict:
    errs = _flash_errors(got, want)
    fault = _flash_faults(errs)
    if fault:
        raise RuntimeError(
            f"flash {name}: kernel vs plain beyond the limits (row "
            f"{FLASH_ROW_TOL}, lse {LSE_TOL}): {fault}")
    return errs


def _planted_faults(q, k, v, g_out, kw, got, want, tile: int) -> dict:
    """Wrong results the check must reject, each confined to q or kv tiles
    at and past ``tile`` (64 rows or keys a tile), or to di: B3 dropping
    those kv tiles (the kernel run on the keys before them), B3 shifting O
    by one row there, B4 dropping those kv tiles (dq without them, their
    dk/dv zero), B4 dropping di (the kernel given g_lse = rowsum(dO·O)),
    B4's dq 20% low there. Raises if one passes; returns each fault's
    (row error, max-normalized error)."""
    cut = 64 * tile
    out, lse, dq, dk, dv = got
    shifted = out.clone()
    shifted[:, cut:] = out[:, cut - 1:-1]
    low_dq = dq.clone()
    low_dq[:, cut:] *= 0.8
    kc, vc = k[:, :cut], v[:, :cut]
    tail = torch.zeros_like(k[:, cut:])
    cut_dq, cut_dk, cut_dv = fa.flash_bwd_kernel(q, kc, vc, out, lse, g_out,
                                                 None, **kw)
    faults = {
        f"B3 drops kv tiles >= {tile}":
            (fa.flash_fwd_kernel(q, kc, vc, **kw)[0], lse, dq, dk, dv),
        f"B3 shifts O by one row from q tile {tile}":
            (shifted, lse, dq, dk, dv),
        f"B4 drops kv tiles >= {tile}":
            (out, lse, cut_dq, torch.cat([cut_dk, tail], 1),
             torch.cat([cut_dv, tail], 1)),
        "B4 drops di":
            (out, lse, *fa.flash_bwd_kernel(
                q, k, v, out, lse, g_out,
                (g_out.float() * out.float()).sum(-1), **kw)),
        f"B4's dq 20% low from q tile {tile}": (out, lse, low_dq, dk, dv),
    }
    readings = {}
    for name, bad in faults.items():
        errs = _flash_errors(bad, want)
        if not _flash_faults(errs):
            raise RuntimeError(f"planted fault passed the flash check: "
                               f"{name}: {errs}")
        readings[name] = (max(errs[n] for n in FLASH_OUTPUTS),
                          _max_rel_err(bad[:1] + bad[2:],
                                       want[:1] + want[2:]))
    return readings


def _flash_bounds(b, t, h, hkv, d):
    """(B3, B4) bounds in ms, what bounds each, and the operations counted,
    at a causal same-offset (T, T) call: the visible pairs are T(T+1)/2 per
    (b, h); B3 does 2 products on them, B4 at least 5, at the dense bf16
    rate; the bytes are each input read once and each output written
    once."""
    pairs = b * h * t * (t + 1) // 2
    q_bytes = 2 * b * t * h * d
    kv_bytes = 2 * b * t * hkv * d
    lse_bytes = 4 * b * h * t
    out = {}
    for name, flops, nbytes in (
            ("flash_fwd", 4 * d * pairs, 2 * q_bytes + 2 * kv_bytes
             + lse_bytes),
            ("flash_bwd", 10 * d * pairs, 4 * q_bytes + 4 * kv_bytes
             + lse_bytes)):
        terms = {"bytes": nbytes / HBM_BYTES_PER_S,
                 "operations": flops / BF16_FLOPS_PER_S}
        by = max(terms, key=terms.get)
        out[name] = (terms[by] * 1e3, by, flops)
    return out


def phase_flash_kernels(device):
    """B3/B4 against their plain versions on the card at small shapes for
    every masking mode (GQA, ragged lengths, offsets, dead rows, window,
    segment ids, g_lse, fp32 operands) and at the LM's shape, each run
    twice and bit-identical, then kernel, plain, bound and library (SDPA)
    times at the LM's shape, with SDPA's backward alone for B4
    (``library_bwd_ms``). Planted faults (``_planted_faults``) must fail
    the check at the first small case and at the LM's shape."""
    worst = dict.fromkeys(FLASH_OUTPUTS + ("lse",), 0.0)
    abs_err = {"flash_fwd": 0.0, "flash_bwd": 0.0}
    faults = {}

    def account(errs):
        for n in worst:
            worst[n] = max(worst[n], errs[n])
        abs_err["flash_fwd"] = max(abs_err["flash_fwd"], errs["fwd_abs"])
        abs_err["flash_bwd"] = max(abs_err["flash_bwd"], errs["bwd_abs"])
        return errs

    for i, (name, shape, dtype, kw, segs) in enumerate(FLASH_CASES):
        q, k, v, g_out, g_lse, seg_kw = _flash_inputs(
            *shape, dtype, device, SEED + 10 + i, segs)
        kw = dict(kw)
        if not kw.pop("g_lse", False):
            g_lse = None
        got, want = _flash_run(q, k, v, g_out, g_lse, {**kw, **seg_kw})
        account(_check_flash(name, got, want))
        if i == 0:
            faults["small"] = _planted_faults(q, k, v, g_out, kw, got, want,
                                              FAULT_TILE["small"])
    b, t, h, hkv, d = LM_ATTN_SHAPE
    q, k, v, g_out, _, _ = _flash_inputs(b, t, t, h, hkv, d, torch.bfloat16,
                                         device, SEED + 3)
    kw = dict(causal=True)
    got, want = _flash_run(q, k, v, g_out, None, kw)
    full = account(_check_flash("LM shape", got, want))
    faults["LM"] = _planted_faults(q, k, v, g_out, kw, got, want,
                                   FAULT_TILE["LM"])
    (out, lse), (p_out, p_lse) = got[:2], want[:2]
    del got, want
    # The library call timed beside each kernel: SDPA (cuDNN / flash
    # backends) on the same inputs — forward for B3, forward + backward for
    # B4, and its backward alone from one saved forward (no single PyTorch
    # call computes B4's function with GQA) — checked against the plain
    # version first.
    qT, kT, vT = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    gT = g_out.transpose(1, 2)

    def sdpa():
        return F.scaled_dot_product_attention(qT, kT, vT, is_causal=True,
                                              enable_gqa=True)

    def sdpa_fwd_bwd():
        return torch.autograd.grad(sdpa(), (qT, kT, vT), gT)

    sdpa_out = sdpa()

    def sdpa_bwd():
        return torch.autograd.grad(sdpa_out, (qT, kT, vT), gT,
                                   retain_graph=True)

    lib_err = _row_err(sdpa().detach().transpose(1, 2), p_out)
    if not lib_err <= LIBRARY_FLASH_TOL:
        raise RuntimeError(f"SDPA disagrees with flash_fwd_plain: row err "
                           f"{lib_err:.3e} > {LIBRARY_FLASH_TOL}")
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=device)
    bounds = _flash_bounds(b, t, h, hkv, d)
    # The plain versions (≈ 0.1-0.2 s a call) are timed last: timed after
    # their seconds of load, SDPA's backward alone read slower than SDPA's
    # forward and backward together.
    times = {
        ("flash_fwd", "ms"): lambda: fa.flash_fwd_kernel(q, k, v, **kw),
        ("flash_fwd", "library_ms"): sdpa,
        ("flash_bwd", "ms"): lambda: fa.flash_bwd_kernel(
            q, k, v, out, lse, g_out, None, **kw),
        ("flash_bwd", "library_ms"): sdpa_fwd_bwd,
        ("flash_bwd", "library_bwd_ms"): sdpa_bwd,
        ("flash_fwd", "plain_ms"): lambda: fa.flash_fwd_plain(q, k, v, **kw),
        ("flash_bwd", "plain_ms"): lambda: fa.flash_bwd_plain(
            q, k, v, p_out, p_lse, g_out, None, **kw),
    }
    rec = {name: {"max_abs_err": abs_err[name], "bound_ms": bounds[name][0],
                  "bound_by": bounds[name][1]} for name in bounds}
    for (name, field), fn in times.items():
        rec[name][field] = cuda_time_ms(fn, flush, reps=FLASH_REPS)
    for name, r in rec.items():
        # The bound's operations (B3: 2 products, B4: the 5-product
        # minimum) over the kernel's time, and the bound over that time.
        r["tflops"] = bounds[name][2] / (r["ms"] * 1e-3) / 1e12
        r["bound_share"] = r["bound_ms"] / r["ms"]
    del flush, sdpa_out
    torch.cuda.empty_cache()
    return rec, worst, full, lib_err, faults


def _step_errors(gpu, cpu):
    """Relative loss error, relative L2 error of all gradients together, and
    the worst single tensor's relative L2 error with its name."""
    (gl, gg), (cl, cg) = gpu, cpu
    if not (math.isfinite(gl)
            and all(bool(torch.isfinite(t).all()) for t in gg.values())):
        raise RuntimeError("non-finite loss or gradient on the card")
    num = sum(float((gg[n] - cg[n]).pow(2).sum()) for n in cg)
    den = sum(float(cg[n].pow(2).sum()) for n in cg)
    worst = max((float((gg[n] - cg[n]).norm()
                       / cg[n].norm().clamp_min(1e-30)), n) for n in cg)
    return abs(gl - cl) / abs(cl), math.sqrt(num / den), worst


def phase_step_vs_cpu(device):
    """Phase 4: one full-width Trainer step on the card (kernels) against
    the same step on the CPU (plain path, fp32), same weights and batch:
    the card in fp32 (tight limits) and in bf16, the main path's dtype."""
    g = torch.Generator().manual_seed(SEED + 2)
    images = torch.randn((2, IMAGE, IMAGE, 3), generator=g)
    labels = torch.randint(0, CLASSES, (2,), generator=g)

    def one_step(dtype, dev):
        model = seeded_resnet50(dtype, dev)
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9))
        trainer = hvd.Trainer(model, resnet.make_loss_fn(model), opt,
                              has_aux=True)
        before = dict(bn.LAUNCHES)
        loss, _ = trainer.train_step((images.to(dev), labels.to(dev)))
        grads = {n: p.grad.detach().float().cpu()
                 for n, p in model.named_parameters()}
        if dev != "cpu":
            for k in before:
                if bn.LAUNCHES[k] - before[k] != BN_LAYERS:
                    raise RuntimeError(
                        f"{k}: {bn.LAUNCHES[k] - before[k]} launches in one "
                        f"step, expected {BN_LAYERS}")
        return float(loss), grads

    hvd.init(device="cpu")
    try:
        cpu = one_step(torch.float32, "cpu")
    finally:
        hvd.shutdown()
    hvd.init()  # the card, NCCL: the rest of the run uses this world
    out = {}
    for name, dtype, (loss_tol, grad_tol) in (
            ("fp32", torch.float32, STEP_FP32_TOL),
            ("bf16", torch.bfloat16, STEP_BF16_TOL)):
        errs = _step_errors(one_step(dtype, device), cpu)
        if errs[0] > loss_tol or errs[1] > grad_tol:
            raise RuntimeError(
                f"card {name} step disagrees with the CPU fp32 step: loss "
                f"rel err {errs[0]:.3e} (limit {loss_tol}), gradient rel L2 "
                f"err {errs[1]:.3e} (limit {grad_tol}); worst {errs[2]}")
        out[name] = errs
    return cpu[0], out


class StepTimer(Callback):
    """Host time of each fit step, each ended by a device sync."""

    def __init__(self):
        self.times = []
        self._t0 = 0.0

    def on_batch_begin(self, batch, logs=None):
        torch.cuda.synchronize()
        self._t0 = time.perf_counter()

    def on_batch_end(self, batch, logs=None):
        torch.cuda.synchronize()
        self.times.append(time.perf_counter() - self._t0)


def phase_main_path(device):
    """Phase 5: the port's main path at full width."""
    model = seeded_resnet50(torch.bfloat16, device)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9))
    trainer = hvd.Trainer(model, resnet.make_loss_fn(model), opt,
                          has_aux=True)
    batch = resnet.synthetic_imagenet(BATCH, IMAGE, seed=SEED,
                                      num_classes=CLASSES, device=device)
    timer = StepTimer()
    bn.reset_launch_counts()
    history = trainer.fit(
        [batch], epochs=STEPS, steps_per_epoch=1, verbose=False,
        callbacks=[hvd.BroadcastGlobalVariablesCallback(0),
                   hvd.MetricAverageCallback(), timer])
    torch.cuda.synchronize()
    launches = dict(bn.LAUNCHES)
    losses = history["loss"]
    if not all(math.isfinite(v) for v in losses):
        raise RuntimeError(f"non-finite loss: {losses}")
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"loss did not fall: {losses}")
    for k, v in launches.items():
        if v != BN_LAYERS * STEPS:
            raise RuntimeError(f"{k} launched {v} times in {STEPS} steps, "
                               f"expected {BN_LAYERS} per step")
    steady = timer.times[2:]
    images_per_s = BATCH * len(steady) / sum(steady)
    return losses, launches, images_per_s, steady


# -- the LM (B3/B4's path) -----------------------------------------------------------

def lm_config(dtype, num_layers: int = LM_LAYERS):
    """bench.py's full-width LM (``_lm_extra``): vocab 32768, E=1024, H=8,
    Hkv=4, mlp 4096, T up to 8192."""
    return transformer.TransformerConfig(
        vocab_size=32_768, num_layers=num_layers, num_heads=8,
        num_kv_heads=4, embed_dim=1024, mlp_dim=4096, max_seq_len=8192,
        dtype=dtype)


def phase_lm_step_vs_cpu(device):
    """One full-width LM step, depth cut to 2 layers, B=1, T=2304 (above
    the 2048 switch, so the card runs B3/B4 and the CPU ``blockwise``), on
    the card through ``Trainer.train_step`` against the same loss and
    gradients on the CPU in fp32 (plain path): the card in fp32 (tight
    limits) and in bf16, the main path's dtype. A planted B4 fault (di
    dropped) must fail the fp32 check."""
    g = torch.Generator().manual_seed(SEED + 4)
    tokens = torch.randint(0, lm_config(torch.float32).vocab_size,
                           (1, LM_STEP_T), generator=g)

    def init(dtype, dev):
        return transformer.init_params(lm_config(dtype, LM_STEP_LAYERS),
                                       seed=SEED, device=dev)

    def card_step(dtype):
        model = init(dtype, device)
        cfg = lm_config(dtype, LM_STEP_LAYERS)
        trainer = hvd.Trainer(
            model, transformer.make_loss_fn(cfg, fused_head=True),
            hvd.DistributedOptimizer(AdamW(model.parameters(), 3e-4,
                                           weight_decay=0.1)))
        before = dict(fa.LAUNCHES)
        gl, _ = trainer.train_step(tokens.to(device))
        grads = {n: p.grad.detach().float().cpu()
                 for n, p in model.named_parameters()}
        for k in before:
            if fa.LAUNCHES[k] - before[k] != LM_STEP_LAYERS:
                raise RuntimeError(
                    f"{k}: {fa.LAUNCHES[k] - before[k]} launches in one "
                    f"2-layer step, expected {LM_STEP_LAYERS}")
        del model, trainer
        torch.cuda.empty_cache()
        return _step_errors((float(gl), grads), cpu)

    def beyond(errs, tol):
        return any(e > lim for e, lim in zip(
            (errs[0], errs[1], errs[2][0]), tol))

    model = init(torch.float32, "cpu")
    loss = transformer.make_loss_fn(lm_config(torch.float32, LM_STEP_LAYERS),
                                    fused_head=True)(model, tokens)
    loss.backward()
    cpu = (loss.item(), {n: p.grad.detach().float()
                         for n, p in model.named_parameters()})
    del model
    out = {}
    for name, dtype, tol in (("fp32", torch.float32, LM_STEP_FP32_TOL),
                             ("bf16", torch.bfloat16, LM_STEP_BF16_TOL)):
        errs = card_step(dtype)
        if beyond(errs, tol):
            raise RuntimeError(
                f"card {name} LM step disagrees with the CPU fp32 step: loss "
                f"rel err {errs[0]:.3e}, gradient rel L2 err {errs[1]:.3e}, "
                f"worst tensor {errs[2]} (limits {tol})")
        out[name] = errs
    # The planted fault: B4 given g_lse = rowsum(dO·O), so di = 0.
    kernel = fa.flash_bwd_kernel

    def drop_di(q, k, v, o, lse, g_out, g_lse=None, **kw):
        return kernel(q, k, v, o, lse, g_out,
                      (g_out.float() * o.float()).sum(-1), **kw)

    fa.flash_bwd_kernel = drop_di
    try:
        errs = card_step(torch.float32)
    finally:
        fa.flash_bwd_kernel = kernel
    if not beyond(errs, LM_STEP_FP32_TOL):
        raise RuntimeError(f"planted fault (B4 drops di) passed the fp32 LM "
                           f"step check: {errs}")
    out["fault"] = errs
    return cpu[0], out


def phase_lm_main_path(device):
    """The LM's main path at full width: bench.py's config (8 layers,
    T=8192, B=2, bf16, fused head), ``DistributedOptimizer(AdamW(3e-4,
    weight_decay=0.1))``, ``Trainer.fit`` for STEPS steps on a repeated
    seeded batch."""
    cfg = lm_config(torch.bfloat16)
    model = transformer.init_params(cfg, seed=SEED, device=device)
    n_params = sum(p.numel() for p in model.parameters())
    opt = hvd.DistributedOptimizer(AdamW(model.parameters(), 3e-4,
                                         weight_decay=0.1))
    trainer = hvd.Trainer(model, transformer.make_loss_fn(cfg,
                                                          fused_head=True),
                          opt)
    tokens = transformer.synthetic_tokens(LM_BATCH, LM_T, cfg.vocab_size,
                                          seed=SEED, device=device)
    timer = StepTimer()
    torch.cuda.reset_peak_memory_stats(device)
    fa.reset_launch_counts()
    history = trainer.fit(
        [tokens], epochs=STEPS, steps_per_epoch=1, verbose=False,
        callbacks=[hvd.BroadcastGlobalVariablesCallback(0),
                   hvd.MetricAverageCallback(), timer])
    torch.cuda.synchronize()
    launches = dict(fa.LAUNCHES)
    losses = history["loss"]
    if not all(math.isfinite(v) for v in losses):
        raise RuntimeError(f"non-finite LM loss: {losses}")
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"LM loss did not fall: {losses}")
    for k, v in launches.items():
        if v != LM_LAYERS * STEPS:
            raise RuntimeError(f"{k} launched {v} times in {STEPS} LM steps, "
                               f"expected {LM_LAYERS} per step")
    steady = timer.times[2:]
    tokens_per_s = LM_BATCH * LM_T * len(steady) / sum(steady)
    peak_gib = torch.cuda.max_memory_allocated(device) / 2 ** 30
    del model, trainer, opt
    torch.cuda.empty_cache()
    return losses, launches, tokens_per_s, steady, n_params, peak_gib


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs the port "
              "on a GPU.", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    t_start = time.perf_counter()

    ident = card_identity()
    say(ident)
    say(f"phase 1 card: {ident}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    libs = _build.build(["batchnorm", "flash_fwd", "flash_bwd"])
    say(f"phase 2 build: ok in {time.perf_counter() - t0:.1f} s: "
        f"{sorted(os.path.relpath(p, HERE) for p in libs.values())}")

    model = seeded_resnet50(torch.bfloat16, device)
    rec, distinct, worst_rel, worst_library_rel = phase_kernels(model, device)
    del model
    torch.cuda.empty_cache()
    say(f"phase 3 kernels: ok at {len(distinct)} ResNet-50 shapes + 1 ragged, "
        f"bf16 and fp32; worst |kernel-plain|/sum|term| {worst_rel:.2e} "
        f"(limit {KERNEL_TOL}); batch_norm_backward_reduce vs plain "
        f"{worst_library_rel:.2e} (limit {LIBRARY_TOL}); per step (53 "
        f"layers, bf16): " + "; ".join(
            f"{k} {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library "
            f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms (by "
            f"{r['bound_by']})" for k, r in rec.items()))

    cpu_loss, errs = phase_step_vs_cpu(device)
    say(f"phase 4 step vs cpu: ok; ResNet-50 224 px batch 2, CPU fp32 loss "
        f"{cpu_loss:.6f}; " + "; ".join(
            f"card {k}: loss rel err {e[0]:.2e}, gradient rel L2 err "
            f"{e[1]:.2e} (limits {lim}), worst tensor {e[2][1]} "
            f"{e[2][0]:.2e}" for (k, e), lim in zip(
                errs.items(), (STEP_FP32_TOL, STEP_BF16_TOL))))

    losses, launches, ips, steady = phase_main_path(device)
    say(f"phase 5 main path: ok; ResNet-50 bf16 fused BN batch {BATCH}, "
        f"{STEPS} steps; loss {losses[0]:.4f} -> {losses[-1]:.4f}; launches "
        f"{launches} ({BN_LAYERS}/step each); smoke throughput "
        f"{ips:.1f} images/s (steps 3-{STEPS}, mean step "
        f"{1e3 * sum(steady) / len(steady):.2f} ms) on {ident}; total "
        f"{time.perf_counter() - t_start:.0f} s")

    frec, f_worst, f_full, f_lib, f_faults = phase_flash_kernels(device)

    def row_errs(errs):
        return ", ".join(f"{n} {errs[n]:.2e}" for n in FLASH_OUTPUTS)

    say(f"phase 6 flash kernels: ok at {len(FLASH_CASES)} small shapes (every "
        f"masking mode, g_lse, fp32 operands, tile edges) and the LM's "
        f"{LM_ATTN_SHAPE} causal bf16, each run twice with bit-identical O, "
        f"LSE, dq, dk, dv; worst row err |kernel-plain|/|plain| (limit "
        f"{FLASH_ROW_TOL}): all cases {row_errs(f_worst)}; at the LM shape "
        f"{row_errs(f_full)}; worst lse err {f_worst['lse']:.2e} (limit "
        f"{LSE_TOL}); SDPA vs plain row err {f_lib:.2e} (limit "
        f"{LIBRARY_FLASH_TOL}); planted faults caught (row err, "
        f"max-normalized err): " + "; ".join(
            f"{where} {name} {r[0]:.2e}, {r[1]:.2e}"
            for where, fs in f_faults.items() for name, r in fs.items())
        + "; per call at the LM shape: " + "; ".join(
            f"{k} {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library "
            f"{r['library_ms']:.4f} ms"
            + (f" (backward alone {r['library_bwd_ms']:.4f} ms)"
               if "library_bwd_ms" in r else "")
            + f", bound {r['bound_ms']:.4f} ms (by {r['bound_by']}), "
            f"{r['tflops']:.1f} TFLOP/s at the bound's operation count, "
            f"{100 * r['bound_share']:.1f}% of the bound"
            for k, r in frec.items()) + f", on {ident}")

    lm_cpu_loss, lm_errs = phase_lm_step_vs_cpu(device)
    say(f"phase 7 LM step vs cpu: ok; E=1024 H=8 Hkv=4 mlp 4096 V=32768, "
        f"{LM_STEP_LAYERS} layers, B=1 T={LM_STEP_T}, fused head; CPU fp32 "
        f"loss {lm_cpu_loss:.6f}; limits (loss, gradients, worst tensor) "
        f"fp32 {LM_STEP_FP32_TOL}, bf16 {LM_STEP_BF16_TOL}; " + "; ".join(
            f"card {k}: loss rel err {e[0]:.2e}, gradient rel L2 err "
            f"{e[1]:.2e}, worst tensor {e[2][1]} {e[2][0]:.2e}"
            for k, e in lm_errs.items()))

    (lm_losses, lm_launches, tps, lm_steady, n_params,
     peak_gib) = phase_lm_main_path(device)
    say(f"phase 8 LM main path: ok; {n_params / 1e6:.1f}M params, "
        f"{LM_LAYERS} layers, B={LM_BATCH} T={LM_T} bf16 fused head, "
        f"AdamW(3e-4, wd 0.1, bf16 moments), {STEPS} steps; loss "
        f"{lm_losses[0]:.4f} -> {lm_losses[-1]:.4f}; launches {lm_launches} "
        f"({LM_LAYERS}/step each); smoke throughput {tps:.1f} tokens/s "
        f"(steps 3-{STEPS}, mean step "
        f"{1e3 * sum(lm_steady) / len(lm_steady):.2f} ms), peak memory "
        f"{peak_gib:.1f} GiB, on {ident}; total "
        f"{time.perf_counter() - t_start:.0f} s")

    kernels = []
    for name, source, replaces, r, n in (
            ("channel_sums", "batchnorm.cu", "batchnorm.py:53", rec,
             launches),
            ("channel_grad_sums", "batchnorm.cu", "batchnorm.py:115", rec,
             launches),
            ("flash_fwd", "flash_fwd.cu", "flash_attention.py:234",
             frec, lm_launches),
            ("flash_bwd", "flash_bwd.cu", "flash_attention.py:447",
             frec, lm_launches)):
        r = r[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"horovod_tpu_torch/csrc/{source}",
            "replaces": f"horovod_tpu/ops/{replaces}",
            "launches": n[name], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"]})
        if "library_bwd_ms" in r:
            kernels[-1]["library_bwd_ms"] = r["library_bwd_ms"]
    say(json.dumps({"kernels": kernels}))
    hvd.shutdown()
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of horovod_tpu on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line of output each:

1. the card's name and power limit (``nvidia-smi``);
2. build every CUDA source of the main path (``horovod_tpu_torch/csrc``)
   with ``nvcc`` for ``sm_90a``, all builds started together;
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
   BatchNorm layers).

Then a JSON line with each kernel's record, and last the result line
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

import horovod_tpu_torch as hvd
from horovod_tpu_torch.models import resnet
from horovod_tpu_torch.models.layers import FusedBatchNorm
from horovod_tpu_torch.ops import _build
from horovod_tpu_torch.ops import batchnorm as bn
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


def cuda_time_ms(fn, flush) -> float:
    """Mean device time of ``fn()`` over REPS launches, each after a write
    of a buffer larger than L2, so every launch finds its input cold."""
    for _ in range(3):
        fn()
    total = 0.0
    for _ in range(REPS):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / REPS


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
    libs = _build.build(["batchnorm"])
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

    kernels = []
    for name, line in (("channel_sums", 53), ("channel_grad_sums", 115)):
        r = rec[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "horovod_tpu_torch/csrc/batchnorm.cu",
            "replaces": f"horovod_tpu/ops/batchnorm.py:{line}",
            "launches": launches[name], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"]})
    say(json.dumps({"kernels": kernels}))
    hvd.shutdown()
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

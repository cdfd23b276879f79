"""Where the device time of one data-parallel ResNet-50 step of the
PyTorch/CUDA port (``horovod_tpu_torch``) goes.

    python tools/profile_torch_step.py [--batch 128] [--steps 5]
        [--norm-impl fused] [--out profile_step.json]

Runs the port's main path on one GPU (``hvd.init()``, world of 1, NCCL;
ResNet-50 at 224 px, 1000 classes, bf16, ``DistributedOptimizer(SGD(0.1,
momentum=0.9))``, ``Trainer``), warms up, then traces ``--steps`` steps
with ``torch.profiler``. It prints, per step: the host wall time, the summed
device kernel time and their ratio (the device's busy share; one stream, so
kernels do not overlap), the time by category (the BatchNorm channel-sum
kernels, convolutions and matrix products, other kernels) and the top
kernels, and writes the same as JSON to ``--out`` when it is given.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch
from torch.profiler import ProfilerActivity, profile

import horovod_tpu_torch as hvd
from horovod_tpu_torch.models import resnet

_BN = ("channel_sums_kernel", "channel_grad_sums_kernel", "finalize_kernel")
_CATEGORIES = (  # first match wins
    ("nccl", ("nccl",)),
    ("conv_and_matmul", ("conv", "gemm", "xmma", "cutlass", "cudnn",
                         "implicit", "wgrad", "dgrad", "fprop", "sm90")),
    ("reduction", ("reduce_kernel",)),
    ("copy_and_cast", ("copy", "memcpy", "memset")),
    ("elementwise", ("elementwise",)),
)


def _category(name: str) -> str:
    if any(k in name for k in _BN):
        return "bn_channel_sums"
    low = name.lower()
    for cat, keys in _CATEGORIES:
        if any(k in low for k in keys):
            return cat
    return "other"


def _device_us(event) -> float:
    return float(getattr(event, "self_device_time_total",
                         getattr(event, "self_cuda_time_total", 0.0)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--norm-impl", default="fused", choices=["fused", "flax"])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    hvd.init()
    device = hvd.device()
    g = torch.Generator().manual_seed(0)
    model = resnet.ResNet50(num_classes=1000, norm_impl=args.norm_impl,
                            generator=g).to(device)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9))
    trainer = hvd.Trainer(model, resnet.make_loss_fn(model), opt,
                          has_aux=True)
    batch = resnet.synthetic_imagenet(args.batch, 224, device=device)
    for _ in range(3):
        trainer.train_step(batch)
    torch.cuda.synchronize()
    # Wall time without the profiler (which slows the host), then the trace.
    t0 = time.perf_counter()
    for _ in range(args.steps):
        trainer.train_step(batch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(args.steps):
            trainer.train_step(batch)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if _device_us(e) > 0
               and e.device_type == torch.autograd.DeviceType.CUDA]
    per_step_ms = {}
    for e in kernels:
        cat = _category(e.key)
        per_step_ms[cat] = per_step_ms.get(cat, 0.0) + \
            _device_us(e) / 1e3 / args.steps
    device_ms = sum(per_step_ms.values())
    wall_ms = wall * 1e3 / args.steps
    top = sorted(kernels, key=_device_us, reverse=True)[:25]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    result = {
        "card": card, "norm_impl": args.norm_impl, "batch": args.batch,
        "steps": args.steps, "wall_ms_per_step": wall_ms,
        "device_ms_per_step": device_ms,
        "device_busy_share": device_ms / wall_ms,
        "images_per_s": args.batch / (wall_ms / 1e3),
        "device_ms_per_step_by_category": per_step_ms,
        "top_kernels": [{"name": e.key[:160], "category": _category(e.key),
                         "calls_per_step": e.count / args.steps,
                         "ms_per_step": _device_us(e) / 1e3 / args.steps}
                        for e in top],
    }
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))
    hvd.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Where the device time of one data-parallel training step of the
PyTorch/CUDA port (``horovod_tpu_torch``) goes.

    python tools/profile_torch_step.py [--model resnet50] [--batch 128]
        [--steps 5] [--norm-impl fused] [--out profile_step.json]
    python tools/profile_torch_step.py --model lm [--batch 2] [--seq 8192]

Runs a main path on one GPU (``hvd.init()``, world of 1, NCCL), warms up,
then traces ``--steps`` steps with ``torch.profiler``:

* ``resnet50``: 224 px, 1000 classes, bf16, ``DistributedOptimizer(SGD(0.1,
  momentum=0.9))``, ``Trainer``;
* ``lm``: bench.py's full-width LM (8 layers, E=1024, H=8, Hkv=4, mlp 4096,
  V=32768, bf16, fused head), ``DistributedOptimizer(AdamW(3e-4,
  weight_decay=0.1))``, ``Trainer``, a batch of ``--batch`` rows of
  ``--seq`` tokens.

It prints, per step: the host wall time, the summed device kernel time and
their ratio (the device's busy share; one stream, so kernels do not
overlap), the time by category (the port's own kernels — BatchNorm channel
sums, flash attention — then convolutions and matrix products, other
kernels) and the top kernels, and writes the same as JSON to ``--out`` when
it is given.
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
from horovod_tpu_torch.models import resnet, transformer
from horovod_tpu_torch.ops.optim import AdamW

_OWN = (  # the port's kernels, by category
    ("bn_channel_sums", ("channel_sums_ring_kernel", "channel_sums_kernel",
                         "channel_grad_sums_kernel", "finalize_kernel")),
    ("flash_attention", ("flash_fwd_kernel", "flash_bwd_dkdv_kernel",
                         "flash_bwd_dq_kernel")),
)
_CATEGORIES = (  # first match wins
    ("nccl", ("nccl",)),
    ("conv_and_matmul", ("conv", "gemm", "xmma", "cutlass", "cudnn",
                         "implicit", "wgrad", "dgrad", "fprop", "sm90",
                         "nvjet")),
    ("reduction", ("reduce_kernel",)),
    ("copy_and_cast", ("copy", "memcpy", "memset")),
    ("elementwise", ("elementwise",)),
)


def _category(name: str) -> str:
    for cat, keys in _OWN:
        if any(k in name for k in keys):
            return cat
    low = name.lower()
    for cat, keys in _CATEGORIES:
        if any(k in low for k in keys):
            return cat
    return "other"


def _device_us(event) -> float:
    return float(getattr(event, "self_device_time_total",
                         getattr(event, "self_cuda_time_total", 0.0)))


def kernel_times(events) -> dict[str, list]:
    """``{kernel name: [device µs, launches]}`` over a trace's events. GPU
    user annotations (the optimizer's ``Optimizer.step#...`` range) span
    kernels that are counted already, so they are left out."""
    kernels: dict[str, list] = {}
    for e in events:
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or getattr(e, "is_user_annotation", False)):
            continue
        us = _device_us(e)
        if us > 0:
            k = kernels.setdefault(e.name, [0.0, 0])
            k[0] += us
            k[1] += 1
    return kernels


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="resnet50", choices=["resnet50", "lm"])
    ap.add_argument("--batch", type=int, default=None,
                    help="rows per step (default 128 for resnet50, 2 for lm)")
    ap.add_argument("--seq", type=int, default=8192, help="lm tokens per row")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--norm-impl", default="fused", choices=["fused", "flax"])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if args.batch is None:
        args.batch = 128 if args.model == "resnet50" else 2

    hvd.init()
    device = hvd.device()
    if args.model == "resnet50":
        g = torch.Generator().manual_seed(0)
        model = resnet.ResNet50(num_classes=1000, norm_impl=args.norm_impl,
                                generator=g).to(device)
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9))
        trainer = hvd.Trainer(model, resnet.make_loss_fn(model), opt,
                              has_aux=True)
        batch = resnet.synthetic_imagenet(args.batch, 224, device=device)
        items_per_step, unit = args.batch, "images"
    else:
        cfg = transformer.TransformerConfig(
            vocab_size=32_768, num_layers=8, num_heads=8, num_kv_heads=4,
            embed_dim=1024, mlp_dim=4096, max_seq_len=args.seq,
            dtype=torch.bfloat16)
        model = transformer.init_params(cfg, seed=0, device=device)
        opt = hvd.DistributedOptimizer(AdamW(model.parameters(), 3e-4,
                                             weight_decay=0.1))
        trainer = hvd.Trainer(
            model, transformer.make_loss_fn(cfg, fused_head=True), opt)
        batch = transformer.synthetic_tokens(args.batch, args.seq,
                                             cfg.vocab_size, device=device)
        items_per_step, unit = args.batch * args.seq, "tokens"
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
    kernels = kernel_times(prof.events())
    per_step_ms = {}
    for name, (us, _) in kernels.items():
        cat = _category(name)
        per_step_ms[cat] = per_step_ms.get(cat, 0.0) + us / 1e3 / args.steps
    device_ms = sum(per_step_ms.values())
    wall_ms = wall * 1e3 / args.steps
    top = sorted(kernels.items(), key=lambda kv: kv[1][0], reverse=True)[:25]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    result = {
        "card": card, "model": args.model, "batch": args.batch,
        "steps": args.steps, "wall_ms_per_step": wall_ms,
        "device_ms_per_step": device_ms,
        "device_busy_share": device_ms / wall_ms,
        f"{unit}_per_s": items_per_step / (wall_ms / 1e3),
        "device_ms_per_step_by_category": per_step_ms,
        "top_kernels": [{"name": name[:160], "category": _category(name),
                         "calls_per_step": n / args.steps,
                         "ms_per_step": us / 1e3 / args.steps}
                        for name, (us, n) in top],
    }
    if args.model == "resnet50":
        result["norm_impl"] = args.norm_impl
    else:
        result["seq"] = args.seq
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))
    hvd.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Per-shape times of the PyTorch/CUDA port's BatchNorm channel-sum kernels
(B1 ``channel_sums``, B2 ``channel_grad_sums``) at ResNet-50's BatchNorm
inputs, and the device kernels one B1 call runs.

    python tools/bench_bn_sums.py [--root DIR] [--reps 20] [--main-path]
        [--cuts] [--out FILE]

For every distinct (N, C) of ResNet-50's 53 BatchNorm inputs (batch 128,
224 px, bf16), each single launch timed with CUDA events after
``chip_smoke.py``'s flush:

* B1 and ``torch.batch_norm_stats``: mean and median under the dirty flush
  (a write of 256 MB before each launch, the timer of ``chip_smoke.py``'s
  ``ms``) and under the clean flush (that write, then a read of a second
  256 MB buffer, so L2 holds no dirty lines);
* B2: the dirty-flush mean;
* B1's device kernels by ``torch.profiler``, ``--reps`` calls each after a
  dirty flush: each kernel's mean duration and the mean gap from the end of
  one to the start of the next inside a call.

Also B1's host cost: the wall time per call of 500 calls in a row at a
(256, 64) input, where the host, not the card, is the bottleneck.

``--cuts`` splits B1's one kernel (``csrc/bn_sums.cu``) by where it ends:
the source is built three more times with ``-DHVD_B1_CUT=1`` (every block
returns after its main pass), ``2`` (after writing its partial row, no
barrier) and ``3`` (after the grid barrier, no combine), and each build is
timed per shape on B1's own plan, beside the whole kernel.

Per-step sums weight each shape by its layer count, beside B1's bound
(bytes read once and written once at 3.35 TB/s). ``--main-path`` then runs
``chip_smoke.py``'s phase 5 (ResNet-50, batch 128, 10 ``Trainer.fit``
steps) and reports its images/s.

``--root`` names the checkout whose ``horovod_tpu_torch`` is measured
(default: this one); the timers are this checkout's ``chip_smoke.py``, so
two commits are measured by the same code. Needs one GPU.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_timers():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_timers", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _short(name: str) -> str:
    """A kernel's name without its namespace, template arguments and
    parameters."""
    return name.split("(anonymous namespace)::")[-1].split("<")[0] \
        .split("(")[0]


def b1_kernel_split(bn, x, flush, reps: int) -> dict:
    """{kernel name: mean µs} of the kernels B1 runs per call, and the mean
    gap (µs) between consecutive ones inside a call, from a profiler trace
    of ``reps`` calls each after a dirty flush."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush.zero_()
            bn.channel_sums(x)
        torch.cuda.synchronize()
    kernels = sorted(
        (e for e in prof.events()
         if e.device_type == torch.autograd.DeviceType.CUDA
         and not getattr(e, "is_user_annotation", False)),
        key=lambda e: e.time_range.start)
    calls, call = [], None
    for e in kernels:
        if "channel_sums" in e.name or "finalize_kernel" in e.name:
            if call is None:
                call = []
                calls.append(call)
            call.append(e)
        else:  # the flush ends a call
            call = None
    durations: dict[str, list] = {}
    gaps = []
    for call in calls:
        for i, e in enumerate(call):
            durations.setdefault(_short(e.name), []).append(
                e.time_range.end - e.time_range.start)
            if i:
                gaps.append(e.time_range.start - call[i - 1].time_range.end)
    return {"calls": len(calls),
            "kernels_per_call": [len(c) for c in calls][:3],
            "kernel_us": {k: sum(v) / len(v) for k, v in durations.items()},
            "gap_us": sum(gaps) / len(gaps) if gaps else 0.0}


CUTS = {1: "main pass", 2: "+ partial rows", 3: "+ grid barrier"}


def b1_cut_libs(bn) -> dict:
    """{cut: ctypes library} of B1's source built with ``-DHVD_B1_CUT``,
    all ``nvcc`` processes started together."""
    import ctypes
    import subprocess

    b = bn._build
    procs = {}
    for cut in CUTS:
        out = b.library_path("bn_sums").replace(".so", f"-cut{cut}.so")
        procs[cut] = (out, subprocess.Popen(
            b._compile_cmd("bn_sums", out) + [f"-DHVD_B1_CUT={cut}"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for cut, (out, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc bn_sums.cu -DHVD_B1_CUT={cut}:\n{log}")
        lib = ctypes.CDLL(out)
        lib.hvd_channel_sums.argtypes = bn._sums_lib().hvd_channel_sums.argtypes
        libs[cut] = lib
    return libs


def b1_cut_times(cs, libs, x, flush, clean) -> dict:
    """{cut name: (dirty-flush mean, clean-flush median) ms} of B1's cut
    builds on ``x``, launched with the plan B1 itself launches, timed by
    ``cs`` (``chip_smoke.py``)."""
    import torch

    bn = cs.bn
    n, c = x.shape
    plan = bn.launch_plan(x)
    buf = torch.empty(plan.scratch, dtype=torch.float32, device=x.device)
    bar = torch.zeros(max(32, plan.gy), dtype=torch.int64, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    out = {}
    for cut, lib in libs.items():
        def fn(lib=lib):
            err = lib.hvd_channel_sums(
                x.data_ptr(), buf.data_ptr(), bar.data_ptr(), n, c,
                bn._DTYPE_CODES[x.dtype], bn._vec(x, c), plan.gx, plan.gy,
                plan.ct, plan.rows_per_stage, x.device.index, stream)
            if err:
                raise RuntimeError(f"cut {cut}: CUDA error {err}")
        dirty = cs.cuda_times(fn, flush)
        tidy = cs.cuda_times(fn, flush, clean=clean)
        out[CUTS[cut]] = (sum(dirty) / len(dirty), statistics.median(tidy))
    return out


def b1_host_us(bn, device, calls: int = 500) -> float:
    """Wall µs per B1 call over ``calls`` calls in a row on a (256, 64)
    bf16 input (a few µs of device work each): the host's cost of a
    call."""
    import time

    import torch

    x = torch.randn((256, 64), device=device).to(torch.bfloat16)
    for _ in range(20):
        bn.channel_sums(x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        bn.channel_sums(x)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE,
                    help="checkout whose horovod_tpu_torch is measured")
    ap.add_argument("--reps", type=int, default=20,
                    help="B1 calls traced per shape for the kernel split")
    ap.add_argument("--main-path", action="store_true")
    ap.add_argument("--cuts", action="store_true",
                    help="also time B1 built to end after each of its parts")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))

    import torch

    if not torch.cuda.is_available():
        print("bench_bn_sums: CUDA is not available.", file=sys.stderr)
        return 2
    cs = _load_timers()
    bn = cs.bn
    if args.cuts and not hasattr(bn, "sums_plan"):
        print("bench_bn_sums: --cuts needs a checkout with csrc/bn_sums.cu.",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    ident = cs.card_identity()
    g = torch.Generator(device=device).manual_seed(cs.SEED)
    model = cs.seeded_resnet50(torch.bfloat16, device)
    images = torch.randn((cs.BATCH, cs.IMAGE, cs.IMAGE, 3), generator=g,
                         device=device)
    layers = cs.bn_shapes(model, images)
    del model, images
    torch.cuda.empty_cache()
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=device)
    clean = torch.empty_like(flush).fill_(1.0)
    cut_libs = b1_cut_libs(bn) if args.cuts else {}
    rows, step = [], {}
    for n, c in sorted(set(layers)):
        count = layers.count((n, c))
        x = (torch.randn((n, c), generator=g, device=device) * 3 + 2).to(
            torch.bfloat16)
        dy = torch.randn((n, c), generator=g, device=device).to(torch.bfloat16)
        xf = x.float()
        mean = xf.mean(0)
        rstd = torch.rsqrt(xf.var(0, unbiased=False) + 1e-5)
        del xf
        row = {"n": n, "c": c, "layers": count,
               "bound_ms": (2 * n * c + 8 * c) / cs.HBM_BYTES_PER_S * 1e3}
        row.update(cs.time_fields(lambda: bn.channel_sums(x), flush, clean,
                                  "ms"))
        row.update(cs.time_fields(lambda: torch.batch_norm_stats(x, 1e-5),
                                  flush, clean, "library_ms"))
        row["b2_ms"] = cs.cuda_time_ms(
            lambda: bn.channel_grad_sums(dy, x, mean, rstd), flush)
        row["split"] = b1_kernel_split(bn, x, flush, args.reps)
        if cut_libs:
            row["cuts"] = b1_cut_times(cs, cut_libs, x, flush, clean)
            for name, (dm, cm) in row["cuts"].items():
                for k, v in ((f"cut {name} ms", dm),
                             (f"cut {name} ms_clean_median", cm)):
                    step[k] = step.get(k, 0.0) + count * v
        rows.append(row)
        for k, v in row.items():
            if isinstance(v, float):
                step[k] = step.get(k, 0.0) + count * v
        for k, us in [*row["split"]["kernel_us"].items(),
                      ("gap between kernels", row["split"]["gap_us"])]:
            key = f"profiled {k} ms"
            step[key] = step.get(key, 0.0) + count * us / 1e3
        print(json.dumps(row), flush=True)
    host_us = b1_host_us(bn, device)
    print(f"host us per B1 call: {host_us:.2f}", flush=True)
    result = {"card": ident, "root": os.path.abspath(args.root),
              "reps": args.reps, "per_step": step, "shapes": rows,
              "host_us_per_call": host_us}
    print("per step: " + json.dumps(step), flush=True)
    del flush, clean
    torch.cuda.empty_cache()
    if args.main_path:
        cs.hvd.init()
        losses, launches, ips, steady = cs.phase_main_path(device)
        result["main_path"] = {
            "images_per_s": ips, "mean_step_ms": 1e3 * statistics.mean(steady),
            "losses": losses, "launches": launches}
        print("main path: " + json.dumps(result["main_path"]), flush=True)
        cs.hvd.shutdown()
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps({"card": ident, "root": result["root"],
                      "per_step": step, "host_us_per_call": host_us,
                      "main_path": result.get("main_path")}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

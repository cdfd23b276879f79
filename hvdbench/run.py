"""The benchmark of horovod_tpu_torch: one run of one cell.

    python hvdbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout. The cell is an entry of ``BENCHMARK.json``'s
``workloads``: its configuration (``hvdbench/configs/<config>.json``), its
traffic mix (``hvdbench/traffic/<traffic>.json``) and its limits
(``hvdbench/limits/<cell>.json``) are found by name. The port's CUDA
sources are built once into ``horovod_tpu_torch/_build/`` inside the
checkout, and Python's bytecode and the compile caches are kept in
``.hvdbench_cache/`` there; each rank then trains as ``hvdbench/cell.py``
sets out.

The last line of standard output is one JSON object: ``correct``,
``attempted`` and ``failed`` (the window's steps, and those whose loss is
not finite), ``metrics`` (the cell's end-to-end metrics with ``--trace
0``, its per-layer metrics with ``--trace 1``), ``device``, with ``--trace
1`` a ``breakdown``, and last ``checks``: each number compared, with its
limit, as the last lines of standard error also give them. Earlier lines
of standard error give the set-up's phases and the window's step count.

Without a CUDA card, or with fewer cards than the cell asks for, it prints
no result and exits with 3.
"""

import time

T0 = time.monotonic()  # the process's start, as near as Python reaches

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
NO_CARD = 3


def use_checkout_caches() -> None:
    """Every build and compile cache the run touches, at fixed paths inside
    the checkout, for this process and the ranks it starts; call before
    ``torch`` is imported. Python's bytecode goes there too: where the
    environment forbids writing it beside the sources
    (``PYTHONDONTWRITEBYTECODE``, or a read-only installation), every
    process would otherwise compile torch's and the port's modules anew,
    seconds of set-up that vary from run to run."""
    cache = os.path.join(ROOT, ".hvdbench_cache")
    pyc = os.path.join(cache, "pyc")
    sys.pycache_prefix = pyc
    sys.dont_write_bytecode = False
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
    os.environ.update(PYTHONPYCACHEPREFIX=pyc,
                      TRITON_CACHE_DIR=os.path.join(cache, "triton"),
                      TORCH_EXTENSIONS_DIR=os.path.join(cache, "extensions"),
                      USE_FLAX="0")


def load_cell(name: str, root: str = ROOT) -> dict:
    """The cell's entry, configuration, mix, limits and metric names, from
    ``BENCHMARK.json`` and the files it names."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        spec = json.load(f)
    cell = next((w for w in spec["workloads"] if w["name"] == name), None)
    if cell is None:
        raise SystemExit(f"hvdbench: no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in spec["configs"] if c["name"] == cell["config"])

    def data(*parts):
        with open(os.path.join(root, *parts)) as f:
            return json.load(f)

    config = data(conf["file"])
    mix = data("hvdbench", "traffic", f"{cell['traffic']}.json")
    if mix["ranks"] != cell["chips"]:
        raise SystemExit(f"hvdbench: traffic {cell['traffic']!r} runs "
                         f"{mix['ranks']} ranks, the cell {cell['chips']} "
                         f"chips")

    def ours(metric):
        return name in metric.get("workloads", [name])

    return {"cell": cell, "config": config, "mix": mix,
            "limits": data("hvdbench", "limits", f"{name}.json"),
            "end_to_end": [m for m in spec["end_to_end"] if ours(m)],
            "per_layer": [m for m in spec["per_layer"] if ours(m)]}


def card_name() -> str:
    import torch

    return torch.cuda.get_device_name(0)


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def merge(c: dict, ranks: list, trace: bool, device: dict) -> dict:
    """The result line from the ranks' results (rank 0's window and
    steps; memory and numbers at their worst over the ranks)."""
    from hvdbench import cell, check

    r0 = ranks[0]
    world = r0["world"]
    numbers = {k: max(r["numbers"][k] for r in ranks)
               for k in ranks[0]["numbers"]}
    limits = c["limits"]
    correct = (check.judge(numbers, limits)
               and all(r["nonfinite"] == 0 for r in ranks))
    rate = r0["steps"] * r0["items"] / r0["window_s"]
    values = {"setup_s": r0["setup_s"], "step_ms_p95": cell.p95(r0["step_ms"]),
              "peak_mem_gib": max(r["peak_bytes"] for r in ranks) / 2 ** 30,
              "tokens_per_s_per_gpu": rate}
    device = dict(device, count=world,
                  memory_peak_bytes=max(r["peak_bytes"] for r in ranks))
    out = {"correct": bool(correct), "attempted": r0["attempted"],
           "failed": max(r["nonfinite"] for r in ranks)}
    if trace:
        metrics = {}
        for m in c["per_layer"]:
            got = [r["per_layer"][m["name"]] for r in ranks
                   if r["per_layer"][m["name"]] is not None]
            if got:
                metrics[m["name"]] = {"value": sum(got) / len(got),
                                      "unit": m["unit"]}
        device["busy_s"] = sum(r["busy_s"] for r in ranks) / len(ranks)
        device["window_s"] = sum(r["slice_s"] for r in ranks) / len(ranks)
        out.update(metrics=metrics, device=device,
                   breakdown=r0["breakdown"])
    else:
        out.update(metrics={m["name"]: {"value": values[m["name"]],
                                        "unit": m["unit"]}
                            for m in c["end_to_end"]}, device=device)
    # A number with no reading (no optimizer state) is infinite: null in
    # the line, which stays JSON.
    out["checks"] = {k: {"value": numbers[k] if math.isfinite(numbers[k])
                         else None, "limit": limits[k]} for k in limits}
    return out


def job_for(c: dict, seed: int, seconds: float, trace: bool,
            device: str) -> dict:
    return {"config": c["config"], "mix": c["mix"], "seed": seed,
            "seconds": seconds, "trace": trace, "device": device,
            "t0": T0, "per_layer": [m["name"] for m in c["per_layer"]]}


def run_ranks(fn, job: dict, ranks: int, device: str) -> list:
    """``fn(job)`` on every rank: in this process for one rank, else in
    ``ranks`` processes of ``horovod_tpu_torch.run.run``."""
    job = dict(job, t_ranks=time.monotonic())
    if ranks == 1:
        import horovod_tpu_torch as hvd

        try:
            return [fn(job)]
        finally:
            hvd.shutdown()
    from horovod_tpu_torch.run import run

    return run(fn, ranks, device=device, args=(job,), timeout=1500)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    c = load_cell(a.workload)
    use_checkout_caches()
    marks = [("start", T0)]
    import torch

    marks.append(("import_torch", time.monotonic()))
    chips = c["cell"]["chips"]
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < chips:
        print(f"hvdbench: the cell needs {chips} CUDA card(s); {cards} "
              f"found. No result.", file=sys.stderr)
        return NO_CARD
    marks.append(("cards", time.monotonic()))
    from hvdbench import cell, check

    marks.append(("import_harness", time.monotonic()))
    from horovod_tpu_torch.ops import _build

    _build.build()  # once, before any rank starts
    marks.append(("build", time.monotonic()))
    print("hvdbench: setup " + ", ".join(
        f"{k} {t - s:.3f}" for (_, s), (k, t) in zip(marks, marks[1:]))
        + " s", file=sys.stderr)
    job = job_for(c, a.seed, a.seconds, bool(a.trace), "cuda")
    ranks = run_ranks(cell.run_rank, job, chips, "cuda")
    device = {"platform": "gpu", "kind": card_name()}
    found = sorted(set(cell.forbidden_modules()).union(
        *(r["forbidden"] for r in ranks)))
    if found:
        print(f"hvdbench: modules of JAX or of the JAX package were loaded: "
              f"{found}. No result.", file=sys.stderr)
        return 1
    out = merge(c, ranks, bool(a.trace), device)
    r0 = ranks[0]
    print(f"hvdbench: {power_limit()}; setup {r0['setup_s']:.3f} s (rank 0: "
          + ", ".join(f"{k} {v:.3f}" for k, v in r0["phases"].items())
          + f" s); window {r0['steps']} steps in {r0['window_s']:.3f} s",
          file=sys.stderr)
    for line in check.lines({k: max(r["numbers"][k] for r in ranks)
                             for k in c["limits"]}, c["limits"]):
        print(line, file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())

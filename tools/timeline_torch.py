"""The device timeline and the recalibrator of the port on N ranks.

    python tools/timeline_torch.py --ranks 4 [--tune]       # 4 GPUs, NCCL
    python tools/timeline_torch.py --ranks 2 --device cpu  # gloo drill

Each rank trains a small MLP (``--width``, ``--layers``; fp32, SGD)
through ``DistributedOptimizer`` and ``Trainer`` for ``--calls`` calls
with ``HOROVOD_TIMELINE_DEVICE=1`` at ``--interval``, the fusion threshold
set so that the gradients travel in several buckets. Rank 0 writes the
timeline (``<out>/timeline.json``) and the tuning cache the recalibrator
persists (``<out>/cache.json``). With ``--tune`` every rank first runs
``hvd.tune()`` with the live timer and commits ``<out>/tuned.tuned.json``.

The last line of output is one JSON object from rank 0: the sampled
calls, the timeline's spans by activity, the collective spans matched to
the schedule, the NCCL kernels one profiled step ran (by name, with what
``core/xprof.py`` classifies them as), the recalibrator's constants and
what ``hvd.tune()`` committed.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))


def _rank_main(args: dict) -> dict:
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.core import xprof
    from horovod_tpu_torch.ops import exchange

    rank = int(os.environ["RANK"])
    out = args["out"]
    os.environ["HOROVOD_TUNING_CACHE"] = os.path.join(out, f"cache.{rank}"
                                                      ".json")
    os.environ["HOROVOD_FUSION_THRESHOLD"] = str(args["threshold"])
    hvd.init(device=args["device"])
    tuned = None
    if args["tune"]:
        config = hvd.tune(path=os.path.join(out, f"r{rank}",
                                            "tuned.tuned.json"))
        tuned = {"knobs": config.knobs, "constants": config.constants,
                 "compute_window_ms": config.compute_window_ms,
                 "predicted_exposed_ms": config.predicted_exposed_ms,
                 "measured_lm_step_ms": config.measured_lm_step_ms}
        hvd.shutdown()
    # The timeline is opened at init, by rank 0.
    os.environ["HOROVOD_TIMELINE"] = os.path.join(out, "timeline.json")
    os.environ["HOROVOD_TIMELINE_DEVICE"] = "1"
    os.environ["HOROVOD_TIMELINE_DEVICE_INTERVAL"] = str(args["interval"])
    hvd.init(device=args["device"])
    dev = hvd.device()
    g = torch.Generator().manual_seed(0)
    layers = []
    for _ in range(args["layers"]):
        layers += [torch.nn.Linear(args["width"], args["width"]),
                   torch.nn.Tanh()]
    model = torch.nn.Sequential(*layers)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.02)
    model = model.to(dev)
    trainer = hvd.Trainer(
        model, lambda m, x: m(x).pow(2).mean(),
        hvd.DistributedOptimizer(torch.optim.SGD(model.parameters(),
                                                 lr=0.01)))
    x = (torch.randn(64, args["width"], generator=g) + rank).to(dev)
    losses = [float(trainer.train_step(x)[0]) for _ in range(args["calls"])]
    sampled = trainer._step.sampled
    _, events, _ = xprof.profiled_events(lambda: trainer.train_step(x))
    nccl = collections.Counter(n for n, _, _ in events
                               if "nccl" in n.lower())
    constants = exchange.recalibrator().constants()
    hvd.shutdown()
    return {"losses": losses, "sampled": sampled, "tuned": tuned,
            "constants": constants,
            "nccl": {n: [c, xprof.kernel_base(n)] for n, c in nccl.items()},
            "buckets": len(exchange.last_plan().buckets)}


def _summary(out: str) -> dict:
    with open(os.path.join(out, "timeline.json")) as f:
        rows = [json.loads(ln.strip().rstrip(",")) for ln in f
                if ln.strip() not in ("[", "]", "")]
    names = {e["pid"]: e["args"]["name"] for e in rows
             if e["name"] == "process_name"}
    spans = [e for e in rows if e["ph"] == "X" and "dur" in e]
    by_activity = collections.Counter(e["name"] for e in spans
                                      if e["name"].startswith(
                                          ("XLA_", "DEVICE_STEP",
                                           "MEMCPY_", "NO_DEVICE")))
    return {"spans": len(spans), "by_activity": dict(by_activity),
            "collective_rows": sorted({names[e["pid"]] for e in spans
                                       if e["name"].startswith("XLA_")
                                       and "[" not in e["name"]})}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--ranks", type=int, default=4)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--calls", type=int, default=5)
    p.add_argument("--interval", type=int, default=2)
    p.add_argument("--width", type=int, default=1024)
    p.add_argument("--layers", type=int, default=4)
    p.add_argument("--threshold", type=int, default=4 << 20,
                   help="HOROVOD_FUSION_THRESHOLD (bytes)")
    p.add_argument("--tune", action="store_true")
    p.add_argument("--out", default=os.path.join(
        os.path.dirname(HERE), "chiprun_out", "timeline_torch"))
    a = p.parse_args(argv)
    os.makedirs(a.out, exist_ok=True)
    from horovod_tpu_torch.run import run

    results = run(_rank_main, a.ranks, device=a.device, timeout=600,
                  args=(dict(vars(a)),))
    print(json.dumps(dict(results[0], ranks=a.ranks, **_summary(a.out))))
    return 0


if __name__ == "__main__":
    sys.exit(main())

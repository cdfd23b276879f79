"""Cost-model CLI of the PyTorch port — a thin front end over the port's
α–β model (``horovod_tpu_torch/utils/costs.py``), the counterpart of
``tools/cost_model.py``, plus the ResNet-50 step's FLOP count.

No constant lives here: every prediction calls the same
:class:`~horovod_tpu_torch.utils.costs.CostModel` the exchange planner,
the ``auto`` algorithm selector and ``hvd.tune()`` price with, seeded from
:mod:`~horovod_tpu_torch.ops.topology`'s link constants (``nvlink`` within
a host, ``ib`` across hosts) or from a ``--cache`` v3 tuning cache via
:func:`~horovod_tpu_torch.utils.costs.model_for`.

Usage:
    python tools/cost_model_torch.py predict 16777216 --world 8 [--slices 2]
        # per-algorithm predicted µs for one collective of that size
    python tools/cost_model_torch.py choose 16777216 --world 8 [--slices 2]
        # the algorithm + channel count the model would pick
    python tools/cost_model_torch.py threshold --world 8 [--slices 2]
        # the derived fusion-threshold bytes (90%-busbw point)
    python tools/cost_model_torch.py flops [BATCH]
        # FLOPs of one ResNet-50 train step (224 px, SGD with momentum),
        # counted by torch.utils.flop_counter.FlopCounterMode on meta
        # tensors (shapes only, no arithmetic); the reference's mode counts
        # XLA's FLOPs, so the two counts are not the same measurement
    python tools/cost_model_torch.py 128
        # bare integer == `flops 128`

``--device-kind`` picks the seeds: ``cpu`` (the default, the CPU
constants) or a GPU's name (the H100 seeds). Imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def _topo(world: int, slices: int, device_kind: str):
    """A synthetic Topology over the device kind's seed links — the seeds
    ``ops/topology.discover`` gives a live group."""
    from horovod_tpu_torch.ops import topology as _topology

    if world < 1 or slices < 1 or world % slices != 0:
        raise SystemExit(f"cost_model: {world} rank(s) cannot form "
                         f"{slices} equal slice(s)")
    nvlink, ib = _topology.seed_links(device_kind)
    return _topology.Topology(
        group_size=world,
        slice_of=tuple(r * slices // world for r in range(world)),
        num_slices=slices, local_size=world // slices,
        device_kind=device_kind, nvlink=nvlink, ib=ib)


def _model(topo, cache: str | None):
    from horovod_tpu_torch.utils import costs as _costs

    if cache:
        return _costs.model_for(topo, cache)
    return _costs.CostModel(nvlink=topo.nvlink, ib=topo.ib)


def _cmd_predict(args) -> dict:
    from horovod_tpu_torch.utils import costs as _costs

    topo = _topo(args.world, args.slices, args.device_kind)
    model = _model(topo, args.cache)
    out = {"nbytes": args.nbytes, "world": args.world,
           "slices": args.slices, "source": model.source}
    for algo in _costs.ALGORITHMS:
        us = model.predict_us(algo, args.nbytes, topo,
                              channels=args.channels)
        out[f"predicted_us_{algo}"] = (None if us == float("inf")
                                       else round(us, 2))
    return out


def _cmd_choose(args) -> dict:
    topo = _topo(args.world, args.slices, args.device_kind)
    model = _model(topo, args.cache)
    algo = model.choose(args.nbytes, topo)
    channels = model.choose_channels(algo, args.nbytes, topo,
                                     args.max_channels)
    return {"nbytes": args.nbytes, "world": args.world,
            "slices": args.slices, "source": model.source,
            "chosen_algo": algo, "chosen_channels": channels}


def _cmd_threshold(args) -> dict:
    topo = _topo(args.world, args.slices, args.device_kind)
    model = _model(topo, args.cache)
    return {"world": args.world, "slices": args.slices,
            "source": model.source,
            "fusion_threshold_bytes": model.fusion_threshold_bytes(topo)}


def _cmd_flops(batch: int) -> dict:
    """FLOPs of one ResNet-50 train step (forward, backward, SGD with
    momentum; the allreduce is an identity at world 1), counted on meta
    tensors: the shapes alone, nothing computed."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from horovod_tpu_torch.models import resnet

    with torch.device("meta"):
        model = resnet.ResNet50(num_classes=1000, dtype=torch.bfloat16)
        images = torch.empty(batch, 224, 224, 3, dtype=torch.bfloat16)
        labels = torch.zeros(batch, dtype=torch.int64)
    loss_fn = resnet.make_loss_fn(model)
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    counter = FlopCounterMode(display=False)
    with counter:
        loss, _ = loss_fn(model, (images, labels))
        loss.backward()
        opt.step()
    flops = counter.get_total_flops()
    return {"batch": batch, "flops_per_step": flops,
            "gflops_per_image": round(flops / batch / 1e9, 2),
            "counter": "torch.utils.flop_counter.FlopCounterMode"}


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0].isdigit():
        argv = ["flops", argv[0]]
    ap = argparse.ArgumentParser(
        prog="cost_model_torch",
        description="Thin CLI over the port's α–β cost model "
                    "(horovod_tpu_torch/utils/costs.py) + the ResNet-50 "
                    "step's FLOP count.")
    sub = ap.add_subparsers(dest="cmd", required=True)

    def add_common(p, nbytes=True):
        if nbytes:
            p.add_argument("nbytes", type=int,
                           help="collective payload bytes")
        p.add_argument("--world", type=int, default=8)
        p.add_argument("--slices", type=int, default=1)
        p.add_argument("--device-kind", default="cpu")
        p.add_argument("--cache", default=None,
                       help="v3 tuning-cache path (utils/costs.py "
                            "load_tuning_cache); default analytic seeds")

    p = sub.add_parser("predict", help="per-algorithm predicted µs")
    add_common(p)
    p.add_argument("--channels", type=int, default=1)
    p = sub.add_parser("choose", help="model's algo + channel choice")
    add_common(p)
    p.add_argument("--max-channels", type=int, default=8)
    p = sub.add_parser("threshold", help="derived fusion threshold")
    add_common(p, nbytes=False)
    p = sub.add_parser("flops", help="FLOPs of the ResNet-50 train step")
    p.add_argument("batch", type=int, nargs="?", default=128)

    args = ap.parse_args(argv)
    if args.cmd == "flops":
        out = _cmd_flops(args.batch)
    elif args.cmd == "predict":
        out = _cmd_predict(args)
    elif args.cmd == "choose":
        out = _cmd_choose(args)
    else:
        out = _cmd_threshold(args)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The gradient exchange overlapped with backward, measured on N ranks.

    python tools/overlap_torch.py --ranks 4                       # 4 GPUs
    python tools/overlap_torch.py --device cpu --ranks 2 --smoke  # gloo
    python tools/overlap_torch.py --ranks 4 --models lm --sharding zero2,zero3

Each rank trains each model of ``--models`` under each plan (``enum`` and
``priority``) in three arms, built from the same seed:

* ``overlapped``: ``Trainer.train_step`` with ``DistributedOptimizer``.
  From its second call the step is armed (``parallel/optimizer.py``): the
  parameters' post-accumulate-grad hooks issue each fusion bucket from
  backward, in the plan's order, and the pass's end joins the exchange;
* ``unoverlapped``: the same armed step with the gradients computed by
  ``torch.autograd.grad`` and added into the zeroed ``.grad``. No hook
  fires, so ``step()`` issues every bucket after backward, on the
  exchange stream;
* ``unarmed``: the same step zeroed by the inner optimizer's
  ``zero_grad``, which arms nothing, so ``step()`` exchanges after
  backward on the calling stream (``synchronize()``'s unarmed path): the
  exchange as it ran before the overlap existed.

The models are the full-width LM of ``chip_smoke.py`` phase 8 (8 layers,
B=2, T=8192, bf16, fused head, ``AdamW(3e-4, weight_decay=0.1)``: kernels
B3, B4, A1) and ResNet-50 (batch 128 a rank, 224 px, bf16, fused BN,
``SGD(0.1, momentum=0.9)``: kernels B1, B2), each rank on its own batch;
``--smoke`` cuts both to a few narrow layers in fp32 on small inputs. The
fusion threshold is the environment's ``HOROVOD_FUSION_THRESHOLD``
(``SMOKE_THRESHOLD`` with ``--smoke``, so the narrow models travel in
several buckets). The arms of one plan are built together and timed in
turns.

Per arm (rank 0's row; the CRCs are every rank's):

* ``crc``: crc32 of the parameters after 3 calls (the eager call, the
  capture, one replay on the card), equal among the arms of one plan;
* ``hooks``, ``buckets_in_backward``: the hooks the armed step took and
  the buckets they issued, in the pass that defined the program (on the
  card the capture: a replay runs no Python); ``peak_added_gib``: the
  peak device memory of those 3 calls above what was allocated before
  them (null on the CPU);
* ``step_ms``: the median, min and max of ``--windows`` windows of
  ``--steps`` steps (host clock around a synchronized window; null on the
  CPU);
* from 5 steps under one profiler session, after the ranks meet at a
  host barrier, a step each (``torch.profiler``; null on the CPU, which
  has no device events): ``measured_exposed_comm_ms`` (NCCL time not
  covered by compute, ``ops/exchange.py::exposed_comm_from_spans``, as
  ``measured_exposed_comm_ms`` there computes it),
  ``compute_ms`` (the union of the compute kernels), ``nccl_ms``,
  ``planned_exposed_comm_ms`` (the α–β model's, ``ops/exchange.py::
  planned_exposed_comm_ms``, on the plan with that ``compute_ms`` and the
  topology's seed links), ``first_nccl_before_last_bwd``: whether the
  first NCCL kernel starts before the first step's last launch of the
  model's backward kernel (B4 for the LM, B2 for ResNet-50) ends, the
  device counterpart of
  ``tests/test_overlap.py``'s gate, ``bwd_kernel_ms``: that kernel's
  time a step, and ``top_kernels_ms``: the ``TOP_KERNELS`` kernels with
  the most device time a step (by ``core/xprof.py::kernel_base``; NCCL's
  by collective).

``--sharding off,zero2,zero3`` (default ``off``: the rows above) adds,
for each sharded mode, the LM (ZeRO's model in ``chip_smoke.py`` phase
18) under ``Trainer(sharding=mode)`` in two arms, timed in turns:
``overlapped`` (the Trainer's step, armed from its second call: backward's
hooks issue each tensor's reduce-scatter in reverse gather order, and
zero3's gathers run on a gather stream beside the forward, each waited
for at its first read) and ``unarmed`` (the same step with the module's
gradients zeroed in place, as before the overlap, and nothing armed:
every gather before the forward reads anything, every reduce-scatter
after backward). Their rows
(``lm/<mode>``) carry the fields above, the CRC over the module's
parameters and this rank's shards, ``gather_waits`` (zero3's waits in the
defining pass, one a parameter), and from the profiled steps
``first_gather_wait_before_last_gather_end`` (zero3: the first B3 starts
before the step's last all-gather ends), ``first_rs_before_last_bwd`` (the
first reduce-scatter starts before the step's last B4 ends), ``b3_ms``,
``gather_ms`` and ``reduce_scatter_ms`` a step; ``planned_exposed_comm_ms``
prices the plan's rows in the armed issue order at half their ``rs_ag``
all-reduce (the reduce-scatter prefix) and leaves the gathers out.

The last line of output is one JSON object: the card, the ranks, every
arm's row, and ``crc_equal`` per model and plan (``lm/<mode>`` for a
sharded mode).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time
import zlib

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

SEED = 0
PLANS = ("enum", "priority")
ARMS = ("overlapped", "unoverlapped", "unarmed")
SHARDED_ARMS = ("overlapped", "unarmed")
SHARDINGS = ("off", "zero2", "zero3")
SMOKE_THRESHOLD = 4096   # bytes
CRC_CALLS = 3
PROFILED_STEPS = 5
TOP_KERNELS = 16          # the kernels of a profiled step a row lists
# The backward kernel whose last launch ends backward's kernels of the
# port (ops/launches.py's names).
BWD_KERNEL = {"lm": "flash_bwd", "resnet50": "channel_grad_sums"}


def _program(trainer, zero_grad, backward):
    """``trainer``'s step as an ``hvd.spmd`` program, its gradients zeroed
    by ``zero_grad(set_to_none=False)`` and made by ``backward(loss)``.
    Returns the loss."""
    import horovod_tpu_torch as hvd

    opt, model = trainer.optimizer, trainer.model

    def forward_backward(batch):
        out = trainer.loss_fn(model, batch)
        loss = out[0] if trainer.has_aux else out
        backward(loss)
        return loss

    def step(batch):
        model.train()
        zero_grad(set_to_none=False)
        if trainer.sharding == "zero3":
            full = opt.gather_params()
            with opt.swapped(model, full):
                loss = forward_backward(batch)
            opt.apply_gradients([t.grad for t in full])
        else:
            loss = forward_backward(batch)
            opt.step()
        trainer._sync_buffers([b for b in model.buffers()
                               if b.dtype.is_floating_point])
        return loss.detach()

    return hvd.spmd(step, group=trainer.group)


def unoverlapped(trainer):
    """``trainer``'s step whose gradients come from ``torch.autograd.grad``,
    added into the ``.grad`` that ``zero_grad(set_to_none=False)`` zeroed,
    as backward accumulates them: no post-accumulate-grad hook fires, so
    an armed step issues every bucket in ``step()``, after backward."""
    import torch

    params = [p for p in trainer.model.parameters() if p.requires_grad]

    def backward(loss):
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        with torch.no_grad():
            for p, g in zip(params, grads):
                if g is None:
                    continue
                if p.grad is None:
                    p.grad = g
                else:
                    p.grad.add_(g)

    return _program(trainer, trainer.optimizer.zero_grad, backward)


def unarmed(trainer):
    """``trainer``'s step zeroed by the inner optimizer's ``zero_grad``,
    which arms nothing: the hooks find no armed step and ``step()``
    exchanges after backward on the calling stream. A sharded trainer's
    inner optimizer holds the shards, so its step zeroes the module's
    gradients in place instead, as the Trainer's step did before the
    overlap (zero3's gathered leaves start with none), and arms nothing:
    its gathers go before the forward, its reduce-scatters after
    backward."""
    if trainer.sharding == "off":
        zero_grad = trainer.optimizer.optimizer.zero_grad
    else:
        def zero_grad(set_to_none):
            for p in trainer.model.parameters():
                if p.grad is not None:
                    p.grad.detach_()
                    p.grad.zero_()
    return _program(trainer, zero_grad, lambda loss: loss.backward())


def param_crc(model, extra=()) -> int:
    """crc32 of ``model``'s parameters' bytes, in order, then of
    ``extra``'s tensors (a sharded optimizer's shards)."""
    import torch

    crc = 0
    for p in [*model.parameters(), *extra]:
        t = p.detach().reshape(-1).cpu()
        crc = zlib.crc32(t.view(torch.uint8).numpy().tobytes(), crc)
    return crc


def _workload(name: str, plan: str, smoke: bool, dev, rank: int):
    """``(trainer, batch)`` for one arm: the model, its optimizer wrapped
    in ``DistributedOptimizer(schedule=plan)`` (a sharded mode for
    ``plan``: the LM's AdamW under ``Trainer(sharding=plan)``), and this
    rank's batch."""
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import resnet, transformer
    from horovod_tpu_torch.ops.optim import AdamW

    if name == "lm":
        if smoke:
            cfg = transformer.TransformerConfig(
                vocab_size=97, num_layers=2, num_heads=2, num_kv_heads=1,
                embed_dim=32, mlp_dim=64, max_seq_len=32,
                dtype=torch.float32)
            b, t = 2, 32
        else:
            cfg = transformer.TransformerConfig(
                vocab_size=32_768, num_layers=8, num_heads=8,
                num_kv_heads=4, embed_dim=1024, mlp_dim=4096,
                max_seq_len=8192, dtype=torch.bfloat16)
            b, t = 2, 8192
        model = transformer.init_params(cfg, seed=SEED, device=dev)
        opt = AdamW(model.parameters(), 3e-4, weight_decay=0.1)
        sharding = plan if plan in SHARDINGS else "off"
        if sharding == "off":
            opt = hvd.DistributedOptimizer(opt, schedule=plan)
        trainer = hvd.Trainer(
            model, transformer.make_loss_fn(cfg, fused_head=not smoke), opt,
            sharding=sharding)
        batch = transformer.synthetic_tokens(b, t, cfg.vocab_size,
                                             seed=SEED + 1 + rank, device=dev)
        return trainer, batch
    g = torch.Generator().manual_seed(SEED)
    if smoke:
        model = resnet.ResNet(stage_sizes=[1, 1, 1, 1], num_classes=10,
                              num_filters=8, dtype=torch.float32,
                              norm_impl="fused", generator=g)
        n, size, classes = 4, 32, 10
    else:
        model = resnet.ResNet50(num_classes=1000, dtype=torch.bfloat16,
                                norm_impl="fused", generator=g)
        n, size, classes = 128, 224, 1000
    with torch.no_grad():
        # Each block's last BN scale from U(0, 0.2), as chip_smoke.py's
        # seeded ResNet-50: every layer gets a non-zero gradient.
        for block in model.blocks:
            block.norm3.scale.copy_(
                torch.rand(block.norm3.scale.shape, generator=g) * 0.2)
    model = model.to(dev)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9),
        schedule=plan)
    trainer = hvd.Trainer(model, resnet.make_loss_fn(model), opt,
                          has_aux=True)
    batch = resnet.synthetic_imagenet(n, size, seed=SEED + 1 + rank,
                                      num_classes=classes, device=dev)
    return trainer, batch


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _first_step(spans: list, k: int) -> list:
    """The first of ``k`` steps' spans: the first 1/k of them by start."""
    return sorted(spans)[:len(spans) // k]


def _profiled(run, model_name: str, sched, group, host,
              sharding: str = "off") -> dict:
    """The overlap figures of ``PROFILED_STEPS`` steps under one profiler
    session on the card, a step each (module docstring). The ranks meet
    at a host barrier (``host``, a gloo group: no device kernel) inside
    the session, so no NCCL kernel waits out another rank's profiler
    start."""
    import torch.distributed as dist

    from horovod_tpu_torch.core import state as hstate
    from horovod_tpu_torch.core import xprof
    from horovod_tpu_torch.ops import exchange, launches, topology
    from horovod_tpu_torch.utils import costs

    def window():
        if host is not None:
            dist.barrier(group=host)
        for _ in range(PROFILED_STEPS):
            run()

    events = xprof.profiled_events(window)[1]
    bwd = set(launches.KERNELS[BWD_KERNEL[model_name]])
    fwd = set(launches.KERNELS["flash_fwd"])
    comm, compute, bwd_spans, fwd_spans = [], [], [], []
    by_kind: dict = {"all-gather": [], "reduce-scatter": []}
    by_base: dict = {}
    for name, start, dur in events:
        base = xprof.kernel_base(name)
        base = base.removesuffix("-start").removesuffix("-done")
        by_base[base] = by_base.get(base, 0.0) + dur
        if base in xprof._COLL_KIND:
            comm.append((start, dur))
            by_kind.setdefault(base, []).append((start, dur))
        else:
            compute.append((start, dur))
            if base in bwd:
                bwd_spans.append((start, dur))
            if base in fwd:
                fwd_spans.append((start, dur))
    k = PROFILED_STEPS
    compute_ms = exchange.exposed_comm_from_spans(compute, []) / 1e3 / k
    topo = topology.discover(hstate.get_group(group))
    model = costs.CostModel(nvlink=topo.nvlink, ib=topo.ib,
                            source="analytic")
    last_bwd_end = max((s + d for s, d in _first_step(bwd_spans, k)),
                       default=None)
    first_nccl = min((s for s, _ in comm), default=None)

    def before(start, end):
        return None if start is None or end is None else start < end

    row = {
        "measured_exposed_comm_ms":
            exchange.exposed_comm_from_spans(comm, compute) / 1e3 / k,
        "compute_ms": compute_ms,
        "nccl_ms": sum(d for _, d in comm) / 1e3 / k,
        "first_nccl_before_last_bwd": before(first_nccl, last_bwd_end),
        "bwd_kernel_ms": sum(d for _, d in bwd_spans) / 1e3 / k,
        "top_kernels_ms": {b: us / 1e3 / k for b, us in sorted(
            by_base.items(), key=lambda kv: -kv[1])[:TOP_KERNELS]}}
    if sharding == "off":
        row["planned_exposed_comm_ms"] = exchange.planned_exposed_comm_ms(
            sched, topo, model, compute_ms)
        return row
    # The armed issue order: the plan's rows reversed, each the
    # reduce-scatter prefix of its rs_ag all-reduce (half its time).
    armed = dataclasses.replace(sched, buckets=tuple(reversed(
        sched.buckets)))
    gathers = _first_step(by_kind["all-gather"], k)
    rs = _first_step(by_kind["reduce-scatter"], k)
    row.update({
        "planned_exposed_comm_ms": exchange.planned_exposed_comm_ms(
            armed, topo, model, compute_ms, comm_scale=0.5),
        "first_gather_wait_before_last_gather_end": (
            before(min((s for s, _ in _first_step(fwd_spans, k)),
                       default=None),
                   max((s + d for s, d in gathers), default=None))
            if sharding == "zero3" else None),
        "first_rs_before_last_bwd": before(
            min((s for s, _ in rs), default=None), last_bwd_end),
        "b3_ms": sum(d for _, d in fwd_spans) / 1e3 / k,
        "gather_ms": sum(d for _, d in by_kind["all-gather"]) / 1e3 / k,
        "reduce_scatter_ms":
            sum(d for _, d in by_kind["reduce-scatter"]) / 1e3 / k})
    return row


def _pair(name: str, plan: str, a: dict, dev, rank: int, host) -> dict:
    """The arms of one model and plan (or sharded mode): their rows by
    arm."""
    import torch

    from horovod_tpu_torch.ops import exchange

    sharding = plan if plan in SHARDINGS else "off"
    names = ARMS if sharding == "off" else SHARDED_ARMS
    arms = {}
    for arm in names:
        trainer, batch = _workload(name, plan, a["smoke"], dev, rank)
        run = {"overlapped": trainer._step, "unoverlapped": unoverlapped,
               "unarmed": unarmed}[arm]
        if arm != "overlapped":
            run = run(trainer)
        arms[arm] = {"trainer": trainer, "batch": batch, "run": run}
    rows = {}
    for arm, st in arms.items():
        opt, run, batch = st["trainer"].optimizer, st["run"], st["batch"]
        hooks = []
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            resident = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        for _ in range(CRC_CALLS):
            before = (opt.hooks_fired, opt.buckets_in_backward,
                      getattr(opt, "gather_waits", 0))
            run(batch)
            hooks.append((opt.hooks_fired - before[0],
                          opt.buckets_in_backward - before[1],
                          getattr(opt, "gather_waits", 0) - before[2]))
        _sync(dev)
        sched = (opt._allreduce.plan if sharding == "off"
                 else exchange.last_plan())
        rows[arm] = {
            "crc": param_crc(st["trainer"].model,
                             opt.shards if sharding != "off" else ()),
            # The defining pass: on the card the capture (call 2), on the
            # CPU the calls after the first, unarmed one.
            "hooks": hooks[1][0], "buckets_in_backward": hooks[1][1],
            "buckets": len(sched.buckets), "sched": sched,
            **({} if sharding == "off"
               else {"gather_waits": hooks[1][2]}),
            "peak_added_gib": (
                (torch.cuda.max_memory_allocated(dev) - resident) / 2 ** 30
                if dev.type == "cuda" else None),
            "times": []}
    if dev.type == "cuda":
        for w in range(a["windows"]):
            # In turns: each arm first in as many windows as the others.
            n = w % len(names)
            for arm in names[n:] + names[:n]:
                st = arms[arm]
                _sync(dev)
                t0 = time.perf_counter()
                for _ in range(a["steps"]):
                    st["run"](st["batch"])
                _sync(dev)
                rows[arm]["times"].append(
                    (time.perf_counter() - t0) * 1e3 / a["steps"])
    for arm, st in arms.items():
        row = rows[arm]
        sched = row.pop("sched")
        row.update(dict.fromkeys(
            ("measured_exposed_comm_ms", "planned_exposed_comm_ms",
             "compute_ms", "nccl_ms", "first_nccl_before_last_bwd",
             "bwd_kernel_ms", "top_kernels_ms") if sharding == "off" else
            ("measured_exposed_comm_ms", "planned_exposed_comm_ms",
             "compute_ms", "nccl_ms", "first_nccl_before_last_bwd",
             "bwd_kernel_ms", "top_kernels_ms",
             "first_gather_wait_before_last_gather_end",
             "first_rs_before_last_bwd", "b3_ms", "gather_ms",
             "reduce_scatter_ms")) if dev.type != "cuda" else _profiled(
            lambda: st["run"](st["batch"]), name, sched,
            st["trainer"].group, host, sharding))
        t = row.pop("times")
        row["step_ms"] = ({"median": statistics.median(t), "min": min(t),
                           "max": max(t), "windows": len(t),
                           "steps_a_window": a["steps"]} if t else None)
    del arms
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return rows


def _rank_main(a: dict) -> dict:
    import torch

    import horovod_tpu_torch as hvd

    rank = int(os.environ.get("RANK", "0"))
    if a["device"] == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    if a["smoke"]:
        os.environ["HOROVOD_FUSION_THRESHOLD"] = str(SMOKE_THRESHOLD)
    hvd.init(device=a["device"])
    dev = hvd.device()
    host = (torch.distributed.new_group(backend="gloo")
            if hvd.size() > 1 else None)
    out = {}
    cases = [(name, plan) for name in a["models"] for plan in PLANS
             if "off" in a["sharding"]]
    if "lm" in a["models"]:
        cases += [("lm", mode) for mode in a["sharding"] if mode != "off"]
    for name, plan in cases:
        t0 = time.perf_counter()
        out[f"{name}/{plan}"] = _pair(name, plan, a, dev, rank, host)
        if rank == 0:
            print(f"overlap_torch: {name}/{plan} in "
                  f"{time.perf_counter() - t0:.1f} s", file=sys.stderr,
                  flush=True)
    hvd.shutdown()
    return out


def card_identity() -> str | None:
    """``nvidia-smi``'s name and power limit of the first card, or None."""
    try:
        got = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = got.stdout.strip().splitlines()
    return lines[0].strip() if got.returncode == 0 and lines else None


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--ranks", type=int, default=4)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--models", default="lm,resnet50")
    p.add_argument("--windows", type=int, default=7)
    p.add_argument("--steps", type=int, default=5,
                   help="steps a timed window")
    p.add_argument("--smoke", action="store_true",
                   help="narrow models, small inputs")
    p.add_argument("--sharding", default="off",
                   help="off,zero2,zero3: the sharded modes' LM rows "
                        "beside (off) the replicated ones")
    a = p.parse_args(argv)
    a.models = [m for m in a.models.split(",") if m]
    for m in a.models:
        if m not in BWD_KERNEL:
            p.error(f"unknown model {m!r}: pick from {sorted(BWD_KERNEL)}")
    a.sharding = [m for m in a.sharding.split(",") if m]
    for m in a.sharding:
        if m not in SHARDINGS:
            p.error(f"unknown sharding {m!r}: pick from {list(SHARDINGS)}")
    if set(a.sharding) - {"off"} and "lm" not in a.models:
        p.error("--sharding zero2/zero3 runs the LM: add lm to --models")
    if a.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            print("overlap_torch: CUDA is not available; pass --device cpu "
                  "for the gloo drill.", file=sys.stderr)
            return 2
        from horovod_tpu_torch.ops import _build

        _build.build()  # once, before the ranks start
    from horovod_tpu_torch.run import run

    t0 = time.perf_counter()
    results = run(_rank_main, a.ranks, device=a.device, timeout=1800,
                  args=(dict(vars(a)),))
    rows, crc_equal = {}, {}
    for key, pair in results[0].items():
        for arm in pair:
            print(json.dumps({"case": key, "arm": arm, **pair[arm],
                              "crcs": [r[key][arm]["crc"]
                                       for r in results]}))
        crc_equal[key] = all(len({r[key][arm]["crc"] for arm in pair}) == 1
                             for r in results)
        rows[key] = pair
    print(json.dumps({"card": card_identity() if a.device == "cuda"
                      else None, "device": a.device, "ranks": a.ranks,
                      "smoke": a.smoke, "seconds": time.perf_counter() - t0,
                      "crc_equal": crc_equal, "rows": rows}))
    return 0 if all(crc_equal.values()) else 1


if __name__ == "__main__":
    sys.exit(main())

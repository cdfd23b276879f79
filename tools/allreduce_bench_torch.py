"""Allreduce bus-bandwidth benchmark of the PyTorch port — the counterpart of
``tools/allreduce_bench.py``.

For an allreduce of S bytes over n ranks the bus bandwidth is the
nccl-tests convention

    busbw = (2 * (n - 1) / n) * S / t

which makes numbers comparable across world sizes. At one rank the
factor is 0: no byte crosses a link, so a world-1 row's ``value`` is 0.0
by the formula and its ``note`` says so; ``algbw_gbps`` (S / t) is then
the program's own rate, not a link figure.

Each row is timed as ``tune/calibrate.py::allreduce_seconds`` times one:
an ``hvd.spmd`` program of ``STEPS`` allreduces in a row (inputs perturbed
each step, magnitudes held by dividing by n), its first call and its
capture run before timing (on the card later calls are graph replays),
each timed call waited for, best of ``trials``, the slowest rank's
reading. Modes, each printing one JSON line per row in the reference's
field names:

* the size sweep (``--sizes-mb``), flat, with the α–β cost model's
  ``predicted_busbw_gbps`` / ``cost_model``;
* ``--algo flat rs_ag hierarchical auto``: each decomposition
  (``ops/strategy.py``); ``auto`` adds ``chosen_algo``; hierarchical
  needs a multi-host topology (``HOROVOD_TOPOLOGY_SLICES=N`` simulates
  one), else the row says it was skipped;
* ``--compression bf16 int8 int8_block int4``: wire bytes, wire busbw and
  the measured max abs error against the fp32 exchange;
* ``--channels 1 2 4``: the bucket split into that many channel
  instances;
* ``--schedule enum priority``: a fused multi-leaf gradient exchange per
  whole-step schedule (``ops/exchange.py``) against a no-comm baseline of
  the same compute: ``exposed_comm_ms`` and the plan's hash;
* ``--sparse [DENSITY ...]``: the padded-gather sparse exchange against
  densify + allreduce (``ops/sparse.py``), with the cost model's view;
* ``--calibrate``: fits ``t(S) = α + ring·S/β`` over a flat size sweep
  and writes the port's v3 tuning cache (``HOROVOD_TUNING_CACHE``,
  ``utils/costs.py``);
* ``--smoke``: a short size sweep, one ``rs_ag`` row, one channelized
  row, one sparse row and the schedule A/B at reduced steps;
* ``--eager CALLS``: ``CALLS`` named eager allreduces of 4 MiB of bf16
  with the eager verdict replay on and with ``HOROVOD_EAGER_CACHE=0``:
  each arm's ms a call and store calls after the first call, and whether
  the results are bit-identical.

``collective_ops`` counts, per opcode, the wire collectives (``dist.
all_reduce``, ``reduce_scatter``, ``all_gather``, ``all_to_all``) one
allreduce issues under the row's knobs, in the first call of a one-
allreduce program (where the reference counts them in the program's
HLO); ``schedule_ops`` counts the rows of the schedule
``core/context.py`` records for that program (one ``ALLREDUCE``: the
decomposition is below the schedule). Flat uncompressed rows also feed
the α–β recalibrator (``HOROVOD_RECALIBRATION``).

    python tools/allreduce_bench_torch.py --device cuda --smoke
    python tools/allreduce_bench_torch.py --device cpu --ranks 2 --smoke
    torchrun --nproc-per-node 4 tools/allreduce_bench_torch.py --algo rs_ag

``--ranks N`` spawns an N-rank world (``horovod_tpu_torch.run.run``; on
the card one GPU a rank); without it the process joins the world its
launcher set up (``RANK``/``WORLD_SIZE``), or runs a world of one. Rank 0
prints. Imports no JAX.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import importlib
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

STEPS = 10
CALIBRATE_SIZES_MB = [0.0625, 0.25, 1, 4, 16, 64]
SMOKE_SIZES_MB = [0.0625, 0.25]
SPARSE_DENSITIES = [0.01, 0.05, 0.25]
# torch.distributed's wire calls, by the reference's HLO opcode names.
WIRE_OPCODES = {"all_reduce": "all-reduce",
                "reduce_scatter": "reduce-scatter",
                "reduce_scatter_tensor": "reduce-scatter",
                "all_gather": "all-gather",
                "all_gather_into_tensor": "all-gather",
                "all_to_all": "all-to-all",
                "all_to_all_single": "all-to-all"}


def _comp_arg(name: str):
    """None for the uncompressed baseline, else the format's name."""
    return None if name == "none" else name


def _backend() -> str:
    import torch.distributed as dist

    return dist.get_backend()


def _sync(t) -> float:
    return float(t)


@contextlib.contextmanager
def count_wire_calls():
    """Count the ``torch.distributed`` wire collectives issued inside the
    block, by opcode (every thread's: keep the block to one program
    call)."""
    import torch.distributed as dist

    counts = collections.Counter()
    saved = {}
    for fn, opcode in WIRE_OPCODES.items():
        real = getattr(dist, fn, None)
        if real is None:
            continue
        saved[fn] = real

        def counted(*a, _real=real, _op=opcode, **k):
            counts[_op] += 1
            return _real(*a, **k)

        setattr(dist, fn, counted)
    try:
        yield counts
    finally:
        for fn, real in saved.items():
            setattr(dist, fn, real)


def count_collective_ops(nbytes: int, compression: str, algo: str = "flat",
                         channels: int = 1) -> dict:
    """The wire collectives of ONE allreduce under (``compression``,
    ``algo``, ``channels``), counted in the first call of a one-allreduce
    program, and the rows of the schedule that program records."""
    import torch

    import horovod_tpu_torch as hvd

    comp = _comp_arg(compression)
    n = max(1, nbytes // 4)
    x = torch.arange(n, dtype=torch.float32, device=hvd.device()) / n
    prog = hvd.spmd(lambda v: hvd.allreduce(
        v, average=False, compression=comp, algo=algo, channels=channels,
        name="bench_payload"))
    with count_wire_calls() as counts:
        _sync(prog(x).sum())  # the first call (eager on the card)
    if not prog.recorded:
        _sync(prog(x).sum())  # the card records the schedule at the capture
    sched = next(p.schedule for p in prog.programs.values()
                 if p.schedule is not None)
    ops = {op: counts.get(op, 0) for op in ("all-reduce", "reduce-scatter",
                                            "all-gather", "all-to-all")}
    return {"collective_ops": ops,
            "schedule_ops": dict(collections.Counter(r[1] for r in sched))}


def measure_compression_error(nbytes: int, compression: str,
                              algo: str = "flat") -> float:
    """Max abs error of one compressed allreduce-average against the fp32
    exchange of the same data."""
    import torch

    import horovod_tpu_torch as hvd

    n = max(1, nbytes // 4)
    x = (torch.arange(n, dtype=torch.float32, device=hvd.device()) / n
         ) * 2.0 - 1.0
    exact = hvd.spmd(lambda v: hvd.allreduce(v, average=True))
    comp = hvd.spmd(lambda v: hvd.allreduce(v, average=True,
                                            compression=compression,
                                            algo=algo))
    a = exact(x)
    b = comp(x)
    return float((a - b).abs().max())


def _timed(prog, args_, trials: int, steps: int) -> float:
    """Best seconds a step of ``prog(*args_)`` over ``trials`` timed calls,
    after its first call and its capture; the group's slowest reading."""
    # The package re-exports a function named calibrate: reach the module.
    calibrate = importlib.import_module("horovod_tpu_torch.tune.calibrate")

    _sync(prog(*args_))  # the first call (eager on the card)
    _sync(prog(*args_))  # the capture
    best = float("inf")
    for _ in range(trials):
        t0 = time.perf_counter()
        _sync(prog(*args_))
        best = min(best, (time.perf_counter() - t0) / steps)
    return calibrate.agreed_seconds(best)


def bench_size(nbytes: int, world: int, compression: str = "none",
               algo: str = "flat", trials: int = 3, channels: int = 1,
               steps: int = STEPS) -> dict:
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import compression as _compression
    from horovod_tpu_torch.ops import exchange as _exchange
    from horovod_tpu_torch.ops import topology as _topology
    from horovod_tpu_torch.utils import costs as _costs
    from horovod_tpu_torch.utils import env as _envmod

    n = max(1, nbytes // 4)
    x = torch.arange(n, dtype=torch.float32, device=hvd.device()) / n
    comp = _comp_arg(compression)

    def step_fn(x, seed):
        y = x * seed
        for i in range(steps):
            y = hvd.allreduce(y * (1.0 + 1e-6 * i), average=False,
                              compression=comp, algo=algo,
                              channels=channels)
            y = y / world  # magnitudes stay put, call after call
        return y.sum()

    seed = torch.ones((), dtype=torch.float32, device=x.device)
    best = _timed(hvd.spmd(step_fn), (x, seed), trials, steps)
    busbw = 2 * (world - 1) / world * nbytes / best
    topo = _topology.discover(hvd.get_group(0))
    if compression == "none" and algo == "flat" \
            and _envmod.recalibration_enabled():
        level = "ib" if topo.multi_slice else "nvlink"
        if channels > 1:
            _exchange.recalibrator().observe_channels(
                level, channels, nbytes, best, world)
        else:
            _exchange.recalibrator().observe(level, nbytes, best, world)
        _exchange.recalibrator().maybe_persist(topo)
    result = {
        "metric": "allreduce_busbw",
        "bytes": nbytes,
        # Four significant digits: a slow link (gloo under load) reads a
        # rate below 0.005 GB/s, which two decimals would print as 0.
        "value": float(f"{busbw / 1e9:.4g}"),
        "unit": "GB/s",
        "algbw_gbps": float(f"{nbytes / best / 1e9:.4g}"),
        "time_us": round(best * 1e6, 1),
        "world": world,
        "backend": _backend(),
    }
    if world == 1:
        result["note"] = ("world size 1: no byte crosses a link, so the "
                          "bus bandwidth is 0 by its formula; algbw_gbps "
                          "is the program's own rate")
    if channels != 1:
        result["channels"] = channels
    if algo != "flat":
        result["algo"] = algo
        if algo == "auto":
            model = _costs.model_for(topo)
            result["chosen_algo"] = model.choose(nbytes, topo)
    if compression != "none":
        compressor = _compression.resolve(compression)
        wire = _compression.wire_bytes(n, torch.float32, compressor,
                                       sum_width=world)
        result.update({
            "compression": compression,
            "wire_bytes": wire,
            "wire_fraction": round(wire / nbytes, 4),
            "wire_busbw_gbps": round(
                2 * (world - 1) / world * wire / best / 1e9, 2),
            "max_abs_err_vs_fp32": round(
                measure_compression_error(nbytes, compression, algo), 6),
        })
    counted = count_collective_ops(nbytes, compression, algo,
                                   channels=channels)
    if algo == "flat" and channels == 1:
        result["allreduce_ops"] = counted["collective_ops"]["all-reduce"]
    result.update(counted)
    return result


def sparse_workload(world: int, rows: int, dim: int, rows_per_rank: int,
                    seed: int = 17):
    """The reference's sparse workload: Zipf-hot per-rank indices and fp32
    value blocks, stacked over the ranks (made from ``seed`` with numpy;
    each rank takes its own row)."""
    import numpy as np

    rng = np.random.RandomState(seed)
    idx = np.stack([(rng.zipf(1.3, rows_per_rank) - 1) % rows
                    for _ in range(world)]).astype(np.int64)
    vals = rng.randn(world, rows_per_rank, dim).astype(np.float32)
    return vals, idx


def make_sparse_step(algo: str, rows: int, dim: int, steps: int,
                     name_prefix: str = "sparse_ab"):
    """``steps`` chained sparse exchanges with perturbed inputs whose
    merged values feed a scalar accumulator."""
    import horovod_tpu_torch as hvd

    def step_fn(v, i, acc):
        a = acc
        for k in range(steps):
            s = hvd.IndexedSlices(v * (1.0 + 1e-6 * k), i, (rows, dim))
            o = hvd.allreduce_indexed_slices(
                s, average=True, algo=algo, name=f"{name_prefix}_{algo}")
            a = a + o.values.sum()
        return a

    return hvd.spmd(step_fn)


def sparse_wire_accounting(world: int, rows: int, dim: int,
                           rows_per_rank: int) -> dict:
    """Byte accounting of the sparse-vs-dense A/B (the reference's)."""
    row_bytes = dim * 4 + 4                       # fp32 row + int32 index
    recv = max(1, world - 1) * rows_per_rank * row_bytes
    dense_bytes = rows * dim * 4
    ring = (2 * (world - 1) / world * dense_bytes if world > 1
            else dense_bytes)
    return {
        "row_bytes": row_bytes,
        "recv_bytes": recv,
        "dense_bytes": dense_bytes,
        "ring_bytes": ring,
        "bytes_ratio": round(recv / ring, 4),
        "density": round(world * rows_per_rank / rows, 4),
    }


def bench_sparse(density: float, world: int, rows: int = 1 << 14,
                 dim: int = 64, trials: int = 3,
                 steps: int = STEPS) -> dict:
    """One row of the ``--sparse`` sweep: the padded gather and the dense
    fallback timed on the same Zipf-hot table, with the cost model's
    predictions, its choice and its crossover density."""
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import topology as _topology
    from horovod_tpu_torch.utils import costs as _costs
    from horovod_tpu_torch.utils import env as _envmod

    C = max(1, int(density * rows) // max(1, world))
    vals, idx = sparse_workload(world, rows, dim, C)
    me = hvd.rank()
    dev = hvd.device()
    v = torch.from_numpy(vals[me]).to(dev)
    i = torch.from_numpy(idx[me]).to(dev)
    acc = torch.zeros((), dtype=torch.float32, device=dev)
    times = {}
    for algo in ("gather", "dense"):
        step = make_sparse_step(algo, rows, dim, steps,
                                name_prefix="sparse_sweep")
        times[algo] = _timed(step, (v, i, acc), trials, steps)
    acct = sparse_wire_accounting(world, rows, dim, C)
    topo = _topology.discover(hvd.get_group(0))
    model = _costs.model_for(topo)
    pred_sparse = model.predict_sparse_gather_us(C * acct["row_bytes"],
                                                 topo)
    pred_dense = model.predict_us("flat", acct["dense_bytes"], topo)
    return {
        "metric": "sparse_exchange",
        "density": acct["density"],
        "rows_per_rank": C,
        "dense_rows": rows,
        "dim": dim,
        "value": round(acct["recv_bytes"] / times["gather"] / 1e9, 3),
        "unit": "GB/s",
        "sparse_time_us": round(times["gather"] * 1e6, 1),
        "dense_time_us": round(times["dense"] * 1e6, 1),
        "bytes_ratio": acct["bytes_ratio"],
        "predicted_sparse_us": round(pred_sparse, 1),
        "predicted_dense_us": round(pred_dense, 1),
        "predicted_algo": model.choose_sparse(
            rows_per_rank=C, row_bytes=acct["row_bytes"],
            dense_nbytes=acct["dense_bytes"], dense_rows=rows, topo=topo,
            density_threshold=_envmod.sparse_density_threshold()),
        "crossover_density": round(
            model.sparse_crossover_density(acct["row_bytes"], rows,
                                           dim * 4, topo), 4),
        "cost_model": model.source,
        "world": world,
        "backend": _backend(),
    }


def sweep_sparse(densities, world, trials: int = 3, steps: int = STEPS,
                 rows: int = 1 << 14, dim: int = 64) -> list:
    out = []
    for d in densities:
        if not 0 < d <= 1:
            raise SystemExit(
                f"--sparse densities must be in (0, 1], got {d}")
        out.append(bench_sparse(d, world, rows=rows, dim=dim,
                                trials=trials, steps=steps))
    return out


def bench_exchange(mode: str | None, world: int, nleaves: int = 12,
                   base_elems: int = 4096, threshold: int = 1 << 16,
                   trials: int = 3, steps: int = STEPS) -> dict:
    """One fused multi-leaf gradient exchange a step under a whole-step
    schedule; ``mode=None`` is the no-comm baseline of the same compute."""
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import exchange as _exchange

    dev = hvd.device()
    sizes = [base_elems * (1 + (i % 3)) for i in range(nleaves)]
    grads = [torch.arange(n, dtype=torch.float32, device=dev) / n
             for n in sizes]

    def step_fn(gs, seed):
        gs = [g * seed for g in gs]
        for i in range(steps):
            gs = [g * (1.0 + 1e-6 * i) for g in gs]
            if mode is not None:
                gs = hvd.allreduce_gradients(
                    gs, fusion_threshold=threshold, schedule=mode)
        return sum(g.sum() for g in gs)

    seed = torch.ones((), dtype=torch.float32, device=dev)
    best = _timed(hvd.spmd(step_fn), (grads, seed), trials, steps)
    result = {
        "metric": "exchange_step",
        "schedule": mode or "none",
        "time_us": round(best * 1e6, 1),
        "leaves": nleaves,
        "grad_bytes": sum(sizes) * 4,
        "world": world,
        "backend": _backend(),
    }
    if mode is not None:
        plan = _exchange.last_plan()
        if plan is not None:
            result["exchange_schedule_hash"] = plan.plan_hash()
            result["buckets"] = len(plan.buckets)
    return result


def sweep_exchange(modes, world, trials: int = 3, steps: int = STEPS,
                   nleaves: int = 12) -> list:
    """The ``--schedule`` A/B: the no-comm baseline first, then each mode
    with its measured exposed communication a step."""
    base = bench_exchange(None, world, trials=trials, steps=steps,
                          nleaves=nleaves)
    rows = [base]
    for mode in modes:
        row = bench_exchange(mode, world, trials=trials, steps=steps,
                             nleaves=nleaves)
        row["exposed_comm_ms"] = round(
            max(0.0, (row["time_us"] - base["time_us"]) / 1e3), 3)
        rows.append(row)
    return rows


def bench_eager(calls: int, nbytes: int = 4 << 20) -> dict:
    """Named eager allreduces (``core/negotiate.py``'s per-call round)
    replayed against renegotiated: each arm's mean ms a call, every call
    waited for, and its store calls after the first call."""
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.core import negotiate

    g = torch.Generator().manual_seed(hvd.rank())
    x = torch.randn(nbytes // 2, generator=g).to(hvd.device(),
                                                  torch.bfloat16)
    neg = negotiate.negotiator()
    row = {"metric": "eager_allreduce", "bytes": nbytes, "calls": calls,
           "world": hvd.size(), "backend": _backend()}
    outs = {}
    for arm, cache in (("cached", "1"), ("renegotiated", "0")):
        os.environ["HOROVOD_EAGER_CACHE"] = cache
        try:
            outs[arm] = hvd.allreduce(x, name="bench_eager", average=False)
            _sync(outs[arm].float().sum())
            calls0 = neg.store_calls
            t0 = time.perf_counter()
            for _ in range(calls - 1):
                outs[arm] = hvd.allreduce(x, name="bench_eager",
                                          average=False)
                _sync(outs[arm].float().sum())
            row[f"{arm}_ms"] = round(
                1e3 * (time.perf_counter() - t0) / max(1, calls - 1), 4)
            row[f"{arm}_store_calls"] = neg.store_calls - calls0
        finally:
            del os.environ["HOROVOD_EAGER_CACHE"]
    row["bit_identical"] = bool(torch.equal(outs["cached"],
                                            outs["renegotiated"]))
    return row


def _predicted(result: dict, topo, model) -> dict:
    """Attach the cost model's view to a measured row."""
    algo = result.get("chosen_algo", result.get("algo", "flat"))
    t_us = model.predict_us(algo, result["bytes"], topo,
                            channels=result.get("channels", 1))
    if t_us and t_us != float("inf"):
        n = topo.group_size
        pred = 2 * (n - 1) / n * result["bytes"] / (t_us * 1e-6)
        result["predicted_busbw_gbps"] = round(pred / 1e9, 2)
        result["cost_model"] = model.source
    return result


def calibrate(sizes_mb, trials: int = 3) -> list:
    """Fit α–β from a flat size sweep (least squares on ``t(S) = α +
    ring·S/β``) and write the tuning cache. The level is the flat ring's
    bottleneck: ``nvlink`` within a host, ``ib`` across hosts."""
    import numpy as np

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import topology as _topology
    from horovod_tpu_torch.utils import costs as _costs

    world = hvd.size()
    topo = _topology.discover(hvd.get_group(0))
    rows, ts, ss = [], [], []
    for mb in sizes_mb:
        nbytes = int(mb * 2 ** 20)
        row = bench_size(nbytes, world, trials=trials)
        rows.append(row)
        ss.append(nbytes)
        ts.append(row["time_us"] * 1e-6)
    ring = 2 * (world - 1) / world
    slope, intercept = np.polyfit(np.asarray(ss, np.float64),
                                  np.asarray(ts, np.float64), 1)
    # A tiny sweep's fit can go degenerate (a negative intercept on a
    # noisy host): clamp to physical values rather than poison the cache.
    alpha_us = max(float(intercept) * 1e6, 0.1)
    gbps = max(ring / max(float(slope), 1e-15) / 1e9, 0.01)
    level = "ib" if topo.multi_slice else "nvlink"
    constants = {level: {"alpha_us": round(alpha_us, 2),
                         "gbps": round(gbps, 3)}}
    model = _costs.model_from_constants(constants, topo)
    path = None
    if hvd.rank() == 0:
        path = _costs.save_tuning_cache(
            constants, device_kind=topo.device_kind, world=world,
            fusion_threshold=model.fusion_threshold_bytes(topo),
            measured=[{"bytes": r["bytes"], "time_us": r["time_us"],
                       "busbw_gbps": r["value"]} for r in rows])
    return rows + [{
        "metric": "allreduce_calibration",
        "path": path,
        "schema": _costs.SCHEMA,
        "level": level,
        "alpha_us": round(alpha_us, 2),
        "busbw_gbps": round(gbps, 3),
        "fusion_threshold": model.fusion_threshold_bytes(topo),
        "world": world,
        "backend": _backend(),
    }]


def _flush_recalibration() -> list:
    """The end-of-run recalibration flush: a short sweep's α–β samples
    still reach the tuning cache. Nothing when the fit is degenerate or
    ``HOROVOD_RECALIBRATION=0``."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import exchange as _exchange
    from horovod_tpu_torch.ops import topology as _topology
    from horovod_tpu_torch.utils import costs as _costs
    from horovod_tpu_torch.utils import env as _envmod

    if not _envmod.recalibration_enabled():
        return []
    topo = _topology.discover(hvd.get_group(0))
    if _exchange.recalibrator().maybe_persist(topo, force=True):
        return [{"metric": "allreduce_recalibration",
                 "path": _envmod.tuning_cache_path(),
                 "schema": _costs.SCHEMA,
                 "constants": _exchange.recalibrator().constants()}]
    return []


def bench(args: dict) -> list:
    """Every row this rank measures under ``args`` (the parsed flags)."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import topology as _topology
    from horovod_tpu_torch.utils import costs as _costs

    hvd.init(device=args["device"])
    try:
        world = hvd.size()
        topo = _topology.discover(hvd.get_group(0))
        model = _costs.model_for(topo)
        if args["smoke"]:
            rows = [_predicted(bench_size(int(mb * 2 ** 20), world,
                                          trials=1, steps=5), topo, model)
                    for mb in SMOKE_SIZES_MB]
            rows.append(_predicted(bench_size(
                int(SMOKE_SIZES_MB[-1] * 2 ** 20), world, algo="rs_ag",
                trials=1, steps=5), topo, model))
            rows.append(_predicted(bench_size(
                int(SMOKE_SIZES_MB[-1] * 2 ** 20), world, trials=1,
                channels=2, steps=5), topo, model))
            rows.append(bench_sparse(0.05, world, rows=4096, dim=16,
                                     trials=1, steps=5))
            rows += sweep_exchange(["enum", "priority"], world, trials=1,
                                   steps=5, nleaves=8)
            return rows + _flush_recalibration()
        if args["calibrate"]:
            return calibrate(CALIBRATE_SIZES_MB)
        if args["eager"]:
            return [bench_eager(args["eager"])]
        if args["schedule"]:
            return sweep_exchange(args["schedule"], world) + \
                _flush_recalibration()
        if args["sparse"] is not None:
            return sweep_sparse(args["sparse"] or SPARSE_DENSITIES, world) \
                + _flush_recalibration()
        comp_sweep = [c for c in args["compression"] if c != "none"]
        algo_sweep = [a for a in args["algo"] if a != "flat"]
        chan_sweep = [c for c in args["channels"] if c != 1]
        for c in chan_sweep:
            if c < 1:
                raise SystemExit(f"--channels values must be >= 1, got {c}")
        rows = []
        for mb in args["sizes_mb"]:
            nbytes = int(mb * 2 ** 20)
            base = _predicted(bench_size(nbytes, world), topo, model)
            rows.append(base)
            for comp in comp_sweep:
                row = bench_size(nbytes, world, compression=comp)
                row["speedup_vs_none"] = round(
                    base["time_us"] / row["time_us"], 3)
                rows.append(row)
            for algo in algo_sweep:
                try:
                    row = bench_size(nbytes, world, algo=algo)
                except hvd.HorovodError as e:
                    rows.append({"metric": "allreduce_busbw",
                                 "bytes": nbytes, "algo": algo,
                                 "value": None, "note": f"skipped: {e}"})
                    continue
                row["speedup_vs_flat"] = round(
                    base["time_us"] / row["time_us"], 3)
                rows.append(_predicted(row, topo, model))
            for ch in chan_sweep:
                row = bench_size(nbytes, world, channels=ch)
                row["speedup_vs_1ch"] = round(
                    base["time_us"] / row["time_us"], 3)
                rows.append(_predicted(row, topo, model))
        return rows + _flush_recalibration()
    finally:
        hvd.shutdown()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--ranks", type=int, default=None,
                   help="spawn a world of this many ranks (one GPU each "
                        "on the card); default: the launcher's world, or "
                        "one rank")
    p.add_argument("--sizes-mb", type=float, nargs="*",
                   default=[1, 4, 16, 64])
    p.add_argument("--compression", nargs="*", default=[],
                   choices=["none", "bf16", "int8", "int8_block", "int4"])
    p.add_argument("--algo", nargs="*", default=[],
                   choices=["flat", "rs_ag", "hierarchical", "auto"])
    p.add_argument("--channels", nargs="*", type=int, default=[])
    p.add_argument("--calibrate", action="store_true")
    p.add_argument("--schedule", nargs="*", default=[],
                   choices=["enum", "priority"])
    p.add_argument("--sparse", nargs="*", type=float, default=None,
                   metavar="DENSITY")
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--eager", type=int, default=0, metavar="CALLS")
    a = p.parse_args(argv)
    args = dict(vars(a))
    if a.ranks is not None:
        from horovod_tpu_torch.run import run

        rows = run(bench, a.ranks, device=a.device, timeout=1200,
                   args=(args,))[0]
    else:
        rows = bench(args)
        if int(os.environ.get("RANK", "0")) != 0:
            return 0
    for row in rows:
        print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())

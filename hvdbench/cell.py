"""One rank of one run of a cell: the program trained as a user trains it,
its window timed, its profiled slice read, its first steps held against
the reference.

Every rank runs :func:`run_rank` (in the harness's own process for a
one-chip cell, in a process of ``horovod_tpu_torch.run.run`` for more):

1. ``hvd.init()``; the weights from the seed, on the device
   (``weights.py``), loaded into the port's model; the inner optimizer
   wrapped in ``hvd.DistributedOptimizer``; ``hvd.Trainer`` with a user's
   defaults (the step captured as a CUDA graph from its second call);
   this rank's ring of batches from the seed, on the device;
2. the first three steps through ``trainer.train_step``, each on its own
   batch: the readings the reference is held to (the losses; the first
   step's gradient, eager, and the third's, a replay of the captured step
   with the exchange armed, both from the optimizer's state; the
   parameters' change);
3. a warm-up, then a step count that fills ``seconds`` at the warm-up's
   rate, the same on every rank;
4. the window: that many steps, a CUDA event recorded after each on the
   calling stream, the host held at most ``LOOKAHEAD`` steps ahead of the
   device (it waits on an older step's event, never on the queue's end);
5. with ``trace``, a profiled slice of ``trace_steps`` further steps
   (``torch.profiler``, host and device), read by the per-layer readers;
6. the program freed, then the reference's three steps from the same
   weights and batches, in float32, compared by ``check.py``.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import math
import os
import statistics
import sys
import time

import torch
import torch.distributed as dist

from hvdbench import check, trace, weights
from hvdbench.reference import train as reference

HERE = os.path.dirname(os.path.abspath(__file__))
SETUP_STEPS = 3          # the steps the reference follows
LOOKAHEAD = 2            # steps the host may run ahead of the device
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "horovod_tpu")


def family(cfg: dict):
    return importlib.import_module(f"hvdbench.families.{cfg['family']}")


def ref_family(cfg: dict):
    return importlib.import_module(f"hvdbench.reference.{cfg['family']}")


def weight_seed(seed: int) -> int:
    return seed * 64


def data_generator(seed: int, rank: int, device) -> torch.Generator:
    """This rank's generator of batches: a stream of its own for every
    (seed, rank)."""
    return torch.Generator(device=device).manual_seed(seed * 64 + 1 + rank)


def forbidden_modules() -> list[str]:
    """Modules of JAX or of the JAX package loaded in this process, by whole
    top-level names."""
    return sorted({m.split(".", 1)[0] for m in sys.modules}
                  & set(FORBIDDEN))


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Marks:
    """Points between steps: CUDA events on the calling stream on the card
    (read after the window), host clock readings on the CPU."""

    def __init__(self, dev) -> None:
        self.cuda = dev.type == "cuda"
        self.marks: list = []

    def mark(self) -> None:
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            self.marks.append(e)
        else:
            self.marks.append(time.perf_counter())

    def wait(self, i: int) -> None:
        if self.cuda and i >= 0:
            self.marks[i].synchronize()

    def intervals_ms(self) -> list[float]:
        m = self.marks
        if self.cuda:
            return [a.elapsed_time(b) for a, b in zip(m, m[1:])]
        return [(b - a) * 1e3 for a, b in zip(m, m[1:])]


def p95(values) -> float:
    return statistics.quantiles(values, n=20, method="inclusive")[18]


def _average_fn(world: int):
    """The reference's gradient mean over the ranks: plain
    ``torch.distributed`` on the default group, a flat buffer at a
    time."""
    if world == 1:
        return None

    def average(grads):
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat)
        flat /= world
        at = 0
        for g in grads:
            g.copy_(flat[at:at + g.numel()].view_as(g))
            at += g.numel()
    return average


# -- the program --------------------------------------------------------------

def _norms(tensors):
    return None if tensors is None else torch.stack(
        [t.norm() for t in tensors])


class Program:
    """The trainer a user builds for the cell, its ring of batches, and the
    readings of its first three steps. ``phase(name)`` closes a set-up
    phase."""

    def __init__(self, job: dict, hvd, phase=lambda name: None) -> None:
        cfg, mix = job["config"], job["mix"]
        self.dev = hvd.device()
        self.fam = family(cfg)
        self.spec = ref_family(cfg).init_spec(cfg)
        self.seed = weight_seed(job["seed"])
        w = weights.make(self.spec, self.seed, self.dev)
        phase("weights")
        self.model, self.opt, loss_fn = self.fam.build(cfg, w, self.dev)
        del w
        phase("model")
        self.trainer = hvd.Trainer(self.model, loss_fn,
                                   hvd.DistributedOptimizer(self.opt))
        phase("trainer")
        gen = data_generator(job["seed"], hvd.rank(), self.dev)
        self.ring = self.fam.batches(cfg, mix, gen, mix["ring"], self.dev)
        self.next = 0
        self.losses: list = []
        phase("batches")

    def step(self):
        loss, _ = self.trainer.train_step(self.ring[self.next
                                                    % len(self.ring)])
        self.next += 1
        self.losses.append(loss)
        return loss

    def first_steps(self, phase=lambda name: None) -> dict:
        """The first three steps, each on its own batch, and their
        readings: the losses; the per-leaf norms of the first step's
        gradient and of the last one's (an armed, replayed step), as the
        optimizer holds them; the per-leaf norms of the parameters' change
        from the seed's weights, made again on the device. Every reading
        stays on the device."""
        named = list(self.model.named_parameters())
        params = [p for _, p in named]
        first = before = None
        for k in range(SETUP_STEPS):
            if k == SETUP_STEPS - 1:
                before = self.fam.moments(self.opt, params)
            self.step()
            if k == 0:
                first = _norms(self.fam.grads(self.opt, params))
            phase(f"step{k + 1}")
        late = _norms(self.fam.grads(self.opt, params, before))
        del before
        start = weights.make(self.spec, self.seed, self.dev)
        change = torch.stack([(p.detach().float()
                               - start[n].to(p.dtype).float()).norm()
                              for n, p in named])
        del start
        return {"losses": torch.stack(self.losses[:SETUP_STEPS]),
                "first": first, "late": late, "change": change}


def host_readings(r: dict) -> dict:
    return {k: None if v is None else v.tolist() for k, v in r.items()}


def reference_readings(job: dict, world: int, rank: int, dev,
                       cast=None, fault: str | None = None) -> dict:
    """The reference's three steps from the seed's weights and this rank's
    first three batches. ``fault``: ``half`` (half of each batch, the mean
    over the rest) or ``exchange`` (this rank's gradient alone)."""
    cfg, mix = job["config"], job["mix"]
    fam = family(cfg)
    w = weights.make(ref_family(cfg).init_spec(cfg),
                     weight_seed(job["seed"]), dev)
    batches = fam.batches(cfg, mix, data_generator(job["seed"], rank, dev),
                          SETUP_STEPS, dev)
    if fault == "half":
        batches = [fam.half(b) for b in batches]
    average = None if fault == "exchange" else _average_fn(world)
    return reference.run(cfg, w, batches, SETUP_STEPS, cast, average)


def free(dev) -> None:
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


# -- the per-layer readers ----------------------------------------------------

def reader(name: str):
    """``hvdbench/metrics/<name>.py``'s ``read``."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"hvdbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _depth(e) -> int:
    d = 0
    while e.cpu_parent is not None:
        d += 1
        e = e.cpu_parent
    return d


def profiled_slice(prog: Program, steps: int, host_group) -> tuple:
    """``steps`` steps under ``torch.profiler`` (host and device), the
    ranks met at a host barrier first. Returns the device events, the
    host events, the slice's device seconds and its first event's
    start."""
    from torch.profiler import ProfilerActivity, profile

    dev = prog.dev
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    _sync(dev)
    prof = profile(activities=acts)
    prof.start()
    try:
        if host_group is not None:
            dist.barrier(group=host_group)
        marks = Marks(dev)
        marks.mark()
        for _ in range(steps):
            prog.step()
        marks.mark()
        _sync(dev)
    finally:
        prof.stop()
    dev_events, host = [], []
    for e in prof.events():
        if getattr(e, "is_user_annotation", False):
            continue
        start = e.time_range.start
        dur = e.time_range.end - start
        if e.device_type == torch.autograd.DeviceType.CUDA:
            dev_events.append((e.name, start, dur))
        else:
            host.append((e.name, start, dur, _depth(e)))
    dev_events.sort(key=lambda t: t[1])
    slice_s = marks.intervals_ms()[0] / 1e3
    start = dev_events[0][1] if dev_events else 0.0
    return dev_events, host, slice_s, start


# -- one run ------------------------------------------------------------------

def process_age() -> float:
    """Seconds since this process started (``/proc/self/stat``); 0 where
    that cannot be read."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        return (time.clock_gettime(time.CLOCK_BOOTTIME)
                - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError, AttributeError):
        return 0.0


class Phases:
    """The set-up's phases: the seconds from one call to the next, the
    device drained first once ``dev`` is set, so a phase holds its own
    device work."""

    def __init__(self, since: float) -> None:
        self.times: dict[str, float] = {}
        self.last = since
        self.dev = None

    def __call__(self, name: str) -> None:
        if self.dev is not None:
            _sync(self.dev)
        now = time.monotonic()
        self.times[name] = now - self.last
        self.last = now


def write_bytecode() -> None:
    """Let this rank write Python's bytecode (to the checkout's cache,
    ``run.use_checkout_caches``). A rank of its own process starts with
    ``-B`` where its parent's environment forbade writing bytecode
    (``multiprocessing`` passes the flag on), and would compile the port's
    modules anew in every run."""
    sys.dont_write_bytecode = False


def run_rank(job: dict) -> dict:
    """One rank's run of the cell (module docstring); returns what the
    harness merges into the result line."""
    now = time.monotonic()
    write_bytecode()
    # A rank of its own process: its start, and the imports that brought
    # it to this call.
    born = max(now - process_age(), job["t_ranks"])
    phase = Phases(now)
    phase.times.update(spawn=born - job["t_ranks"], rank_import=now - born)

    import horovod_tpu_torch as hvd

    hvd.init(device=job["device"])
    dev = phase.dev = hvd.device()
    rank, world = hvd.rank(), hvd.size()
    cfg, mix = job["config"], job["mix"]
    host_group = None
    if world > 1:
        host_group = dist.new_group(backend="gloo")
    phase("init")
    prog = Program(job, hvd, phase)
    readings = prog.first_steps(phase)
    phase("readings")
    for _ in range(mix["warmup_steps"]):
        prog.step()
    _sync(dev)
    t = time.perf_counter()
    for _ in range(mix["warmup_steps"]):
        prog.step()
    _sync(dev)
    step_s = (time.perf_counter() - t) / mix["warmup_steps"]
    phase("warmup")
    n = torch.tensor([max(mix["min_steps"],
                          math.ceil(job["seconds"] / step_s))], device=dev)
    if world > 1:
        dist.broadcast(n, 0)
    n = int(n.item())
    first_timed = len(prog.losses)

    # The window.
    _sync(dev)
    marks = Marks(dev)
    t0 = time.monotonic()
    setup_s = t0 - job["t0"]
    marks.mark()
    for k in range(n):
        prog.step()
        marks.mark()
        marks.wait(k + 1 - LOOKAHEAD)
    _sync(dev)
    window_s = time.monotonic() - t0
    step_ms = marks.intervals_ms()

    out = {"rank": rank, "world": world, "setup_s": setup_s,
           "phases": phase.times, "steps": n,
           "window_s": window_s, "step_ms": step_ms,
           "items": prog.fam.counts(cfg, mix)["items"]}
    if job["trace"]:
        events, host, slice_s, start = profiled_slice(
            prog, mix["trace_steps"], host_group)
        rt = trace.RankTrace(events, host, slice_s, start,
                             mix["trace_steps"], prog.fam.UNIT,
                             prog.fam.counts(cfg, mix))
        out["per_layer"] = {name: reader(name)(rt)
                            for name in job["per_layer"]}
        out["busy_s"] = rt.busy_us() / 1e6
        out["slice_s"] = slice_s
        out["breakdown"] = {"device_ops": trace.top_ops(rt),
                            "idle_gaps": trace.idle_gaps(rt)}
    losses = torch.stack(prog.losses[first_timed:]).float().cpu()
    out["nonfinite"] = int((~torch.isfinite(losses)).sum())
    out["attempted"] = len(prog.losses) - first_timed
    out["peak_bytes"] = (torch.cuda.max_memory_allocated(dev)
                         if dev.type == "cuda" else 0)
    prog_readings = host_readings(readings)
    del prog, readings, losses
    free(dev)
    ref = reference_readings(job, world, rank, dev)
    out["numbers"] = check.numbers(prog_readings, ref)
    out["forbidden"] = forbidden_modules()
    return out


# -- the readings that set the limits -----------------------------------------

def calibrate_rank(job: dict) -> list[dict]:
    """For each seed of ``job["seeds"]``: the program's numbers against the
    reference (sound runs), and on the first ``job["control_seeds"]``
    seeds those of the control (the reference computed in fp8, put in the
    program's place) and of the faults planted in the reference put in
    the program's place (``half``; ``exchange`` across ranks). A state
    left unchanged reads 1 on ``change_gap`` by the measure and needs no
    run. No window."""
    import horovod_tpu_torch as hvd

    from hvdbench.reference import lowp

    write_bytecode()
    hvd.init(device=job["device"])
    dev = hvd.device()
    rank, world = hvd.rank(), hvd.size()
    rows = []
    for i, seed in enumerate(job["seeds"]):
        sj = dict(job, seed=seed)
        t = time.perf_counter()
        prog = Program(sj, hvd)
        r = host_readings(prog.first_steps())
        del prog
        free(dev)
        ref = reference_readings(sj, world, rank, dev)
        row = {"seed": seed, "program": check.numbers(r, ref)}
        if i < job["control_seeds"]:
            arms = {"control": dict(cast=lowp.cast),
                    "half": dict(fault="half")}
            if world > 1:
                arms["exchange"] = dict(fault="exchange")
            for arm, kw in arms.items():
                other = reference_readings(sj, world, rank, dev, **kw)
                row[arm] = check.numbers(other, ref)
                free(dev)
        row["seconds"] = time.perf_counter() - t
        rows.append(row)
        free(dev)
    return rows

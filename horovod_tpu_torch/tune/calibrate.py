"""The bounded calibration pass behind ``hvd.tune()``.

Counterpart of ``horovod_tpu/tune/calibrate.py``. One pass, one budget
(``HOROVOD_TUNE_BUDGET_S``): timed micro-collectives
(:func:`allreduce_seconds`) feed a fresh
:class:`~horovod_tpu_torch.ops.exchange.Recalibrator` (the same
ring-normalized α–β least squares and rounding, so equal measurements give
byte-identical constants on every rank), a ``channels=2`` probe at the
largest size gives the level's ``ch_eff`` sample, and one timed
no-exchange step of a tiny LM measures the compute window the search
overlaps communication against. The recalibrator is local and unseeded: a
calibration speaks of this machine now, not of a cache's history.

The budget bounds the pass rather than failing it: the two-size sweep
(the α–β fit is degenerate below it) always completes, and further
measurements stop once the budget is spent. Each rank times on its own
clock, so every reading and every budget check takes the group's slowest
rank's (:func:`agreed_seconds`): all ranks fit the same constants and
commit the same plan. At one rank every
observation is ignored (a one-rank collective moves nothing), so the
constants stay empty and the search prices with the seeds.

The tiny LM is the reference's template (vocab 97, 2 layers, 2 heads,
width 32, MLP 64, T 16, fp32, SGD 0.1, 4 steps a call) on the port's
``Transformer`` and ``hvd.spmd``; its tokens are ``(arange(32) + rank) %
97`` (the reference adds the rank after the modulo, which reaches past
the vocabulary on rank > 0: JAX's gather clamps, ``nn.Embedding``
raises).
"""

from __future__ import annotations

import dataclasses
import time

# Default micro-collective sweep: spread over two decades so the α–β fit
# has leverage, small enough for a tight budget.
DEFAULT_SIZES = (64 << 10, 1 << 20, 8 << 20)

# Allreduces a timed call of the micro-collective runs (the reference's
# tools/allreduce_bench.py STEPS).
ALLREDUCE_STEPS = 10

# The tiny LM's steps a call (the reference's K).
LM_STEPS = 4


@dataclasses.dataclass(frozen=True)
class Calibration:
    """What one calibration pass measured."""

    constants: dict          # cache-layout α–β[/ch_eff] per level
    topo: object             # ops.topology.Topology of the tuned group
    leaves: tuple            # the gradients' meta tensors (may be empty)
    labels: tuple            # their labels, matching ``leaves``
    compute_window_s: float | None  # the tiny LM's step (no exchange)
    seconds_spent: float
    samples: int


def calibrate(group: int = 0, *, budget_s: float | None = None,
              measure=None, lm: bool | None = None,
              sizes=DEFAULT_SIZES, trials: int = 2) -> Calibration:
    """Run the bounded pass (module docstring).

    ``measure(nbytes, channels) -> seconds`` replaces the live
    micro-collective (tests inject a deterministic timer) and, unless
    ``lm=True`` is forced, skips the LM profile."""
    global _last
    from horovod_tpu_torch.core import state as _state
    from horovod_tpu_torch.ops import exchange as _exchange
    from horovod_tpu_torch.ops import topology as _topology
    from horovod_tpu_torch.utils import env as _env

    if budget_s is None:
        budget_s = _env.tune_budget_seconds()
    if lm is None:
        lm = measure is None
    t0 = time.monotonic()

    topo = _topology.discover(_state.get_group(group))
    world = topo.group_size
    # The whole-group collective runs on the group's top level; the other
    # level keeps its seed (model_from_constants falls back per level).
    level = "ib" if topo.multi_slice else "nvlink"
    if measure is None:
        def measure(nbytes, channels):
            return allreduce_seconds(nbytes, channels, group=group,
                                     trials=trials)

    def spent() -> bool:
        # Every rank takes the same branch: the slowest rank's clock.
        return agreed_seconds(time.monotonic() - t0, group) >= budget_s

    recal = _exchange.Recalibrator()  # fresh and unseeded: see docstring
    samples = 0
    largest = None
    for i, nbytes in enumerate(sorted(set(int(s) for s in sizes))):
        # The first two sizes always run; beyond them the budget governs.
        if i >= 2 and spent():
            break
        recal.observe(level, nbytes, float(measure(nbytes, 1)), world)
        samples += 1
        largest = nbytes
    if largest is not None and world >= 2 and not spent():
        # ch_eff needs the α–β fit above as its single-channel reference,
        # so the channel probe comes last.
        recal.observe_channels(level, 2, largest,
                               float(measure(largest, 2)), world)
        samples += 1

    compute_window_s = None
    leaves: tuple = ()
    labels: tuple = ()
    if lm:
        compute_window_s, leaves, labels = _profile_lm_step()
    return Calibration(
        constants=recal.constants(), topo=topo, leaves=leaves,
        labels=labels, compute_window_s=compute_window_s,
        seconds_spent=time.monotonic() - t0, samples=samples)


def _sync(t) -> float:
    """Wait for ``t`` (a host read, as the reference's ``float(...)``)."""
    return float(t)


def agreed_seconds(seconds: float, group: int = 0) -> float:
    """The largest of the group's ranks' ``seconds``. Each rank times on
    its own clock; fitting, searching and choosing on the slowest rank's
    reading gives every rank the same constants, knobs and plan (the
    reference's one controller measures once)."""
    import torch
    import torch.distributed as dist

    from horovod_tpu_torch.core import state as _state

    g = _state.get_group(group)
    if g.size <= 1 or g.pg is None:
        return seconds
    t = torch.tensor([seconds], dtype=torch.float64, device=_state.device())
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=g.pg)
    return float(t.item())


def allreduce_seconds(nbytes: int, channels: int = 1, *, group: int = 0,
                      trials: int = 2) -> float:
    """Seconds of one ``hvd.allreduce(average=False, channels=)`` of
    ``nbytes`` fp32 bytes over ``group``, best of ``trials`` calls of an
    ``hvd.spmd`` program that runs ``ALLREDUCE_STEPS`` of them in a row
    (on the card a replayed graph), each call waited for. The reference's
    ``tools/allreduce_bench.py::bench_size`` row, as a function of the
    port. Every rank returns the slowest rank's reading
    (:func:`agreed_seconds`)."""
    import torch

    from horovod_tpu_torch.core import state as _state
    from horovod_tpu_torch.ops import collectives as _coll
    from horovod_tpu_torch.parallel import spmd as _spmd

    world = _state.size(group)
    n = max(1, nbytes // 4)
    x = torch.arange(n, dtype=torch.float32,
                     device=_state.device()) / n

    def step(x, seed):
        y = x * seed
        for i in range(ALLREDUCE_STEPS):
            y = _coll.allreduce(y * (1.0 + 1e-6 * i), average=False,
                                group=group, channels=channels)
            y = y / world  # magnitudes stay put, call after call
        return y.sum()

    prog = _spmd.spmd(step, group=group)
    seed = torch.ones((), dtype=torch.float32, device=x.device)
    _sync(prog(x, seed))  # the first call (eager on the card)
    _sync(prog(x, seed))  # the capture
    best = float("inf")
    for _ in range(trials):
        t0 = time.perf_counter()
        _sync(prog(x, seed))
        best = min(best, (time.perf_counter() - t0) / ALLREDUCE_STEPS)
    return agreed_seconds(best, group)


class _TinyLM:
    """The reference's calibration template on the port: the model, its
    loss, SGD(0.1) and this rank's tokens, on ``hvd.device()``."""

    def __init__(self) -> None:
        import numpy as np
        import torch

        from horovod_tpu_torch.core import state as _state
        from horovod_tpu_torch.models import transformer

        cfg = transformer.TransformerConfig(
            vocab_size=97, num_layers=2, num_heads=2, embed_dim=32,
            mlp_dim=64, max_seq_len=16, dtype=torch.float32)
        dev = _state.device()
        self.model = transformer.init_params(cfg, seed=0, device=dev)
        self.loss_fn = transformer.make_loss_fn(cfg)
        self.opt = torch.optim.SGD(self.model.parameters(), lr=0.1)
        self.params = list(self.model.parameters())
        r = _state.rank()
        self.tokens = torch.as_tensor(
            (np.arange(2 * 16).reshape(2, 16) + r) % 97, dtype=torch.int64,
            device=dev)

    def step(self, exchange: bool):
        """``LM_STEPS`` SGD steps, the gradients averaged over the world
        by ``hvd.allreduce_gradients`` when ``exchange``; the last loss."""
        from horovod_tpu_torch.parallel import optimizer as _opt

        def run(tokens):
            for _ in range(LM_STEPS):
                self.opt.zero_grad(set_to_none=False)
                loss = self.loss_fn(self.model, tokens)
                loss.backward()
                if exchange:
                    _opt.allreduce_gradients([p.grad for p in self.params])
                self.opt.step()
            return loss.detach()

        return run

    def seconds_a_step(self, exchange: bool) -> float:
        """Best of two timed calls of a fresh program (the tuned knobs
        resolve when it records), each waited for, after its first call
        and its capture; the group's slowest rank's reading."""
        from horovod_tpu_torch.parallel import spmd as _spmd

        prog = _spmd.spmd(self.step(exchange))
        _sync(prog(self.tokens))
        _sync(prog(self.tokens))
        best = float("inf")
        for _ in range(2):
            t0 = time.perf_counter()
            _sync(prog(self.tokens))
            best = min(best, (time.perf_counter() - t0) / LM_STEPS)
        return agreed_seconds(best)


def measure_lm_ab(candidate, *, path: str | None = None):
    """The measured guardrail behind ``hvd.tune()``'s commit: the tiny
    LM's step, exchange included, under the defaults and under
    ``candidate`` (a not-yet-committed TunedConfig); returns
    ``(default_s, tuned_s)`` a step. The cost model prices wire time only,
    so its argmin is a hypothesis and this its experiment. Each arm records
    a fresh program, so the knobs resolve under that arm's config; a
    config active on entry is deactivated (``tune()`` replaces it)."""
    from horovod_tpu_torch.tune import apply as _apply

    _apply.deactivate()
    default_s = _TinyLM().seconds_a_step(exchange=True)
    _apply.activate(candidate, path=path)
    try:
        tuned_s = _TinyLM().seconds_a_step(exchange=True)
    finally:
        _apply.deactivate()
    return default_s, tuned_s


def _profile_lm_step():
    """One timed no-exchange step of the tiny LM (gradients computed,
    never reduced): the compute window the search overlaps wire time
    against, with the gradients' meta tensors and labels (the gradient
    path's ``allreduce_gradients.<i>``) that the planner buckets."""
    import torch

    lm = _TinyLM()
    window = lm.seconds_a_step(exchange=False)
    leaves = tuple(torch.empty(p.shape, dtype=p.dtype, device="meta")
                   for p in lm.params)
    labels = tuple(f"allreduce_gradients.{i}" for i in range(len(leaves)))
    return window, leaves, labels

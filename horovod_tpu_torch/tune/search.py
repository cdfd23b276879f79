"""Knob-space search over the port's one cost model (``utils/costs.py``).

Counterpart of ``horovod_tpu/tune/search.py``, copied onto the port's
planner. The searched space is what the planner already prices:
exchange schedule × algorithm × compression × fusion threshold × channel
cap, each candidate evaluated by planning the actual gradient exchange
(:func:`~horovod_tpu_torch.ops.exchange.plan_exchange` with the
calibrated model) and scoring it with the overlap model
(:func:`~horovod_tpu_torch.ops.exchange.planned_exposed_comm_ms`) against
the profiled compute window.

Defaults are privileged twice: the default configuration is in the grid
and evaluated first, and a candidate replaces the incumbent only when
strictly better (beyond a 1 ns tolerance). Ties keep defaults, so
``hvd.tune()`` never commits a configuration the model does not expect to
win. The pricing helpers of speculation and sharding read the port's
link levels (``model.nvlink`` where the reference reads ``model.ici``).
"""

from __future__ import annotations

import dataclasses

# Conservative-first candidate orderings: earlier entries win ties.
SEARCH_COMPRESSIONS = ("none", "bf16", "int8")
SEARCH_CHANNEL_CAPS = (1, 2, 4, 8)


@dataclasses.dataclass(frozen=True)
class SearchResult:
    """The argmin + its evidence."""

    knobs: dict              # env-var name -> tuned value
    plan: object             # the winning ExchangeSchedule
    predicted_default_ms: float
    predicted_tuned_ms: float
    candidates: int          # grid points actually evaluated
    default_knobs: dict      # the default candidate, same key set
    default_plan: object     # its plan (the measured-fallback target)


def search(leaves, topo, model, *, labels=None,
           compute_window_s: float | None = None,
           compressions=SEARCH_COMPRESSIONS,
           channel_caps=SEARCH_CHANNEL_CAPS,
           sparse_density_threshold: float | None = None) -> SearchResult:
    """Find the cheapest knob assignment for exchanging ``leaves``.

    ``model`` is the calibrated CostModel the candidates are priced
    with; ``compute_window_s`` the profiled no-exchange step time (None
    = no overlap credit: every wire microsecond counts as exposed, so
    the search degenerates to minimum-wire-time — still well-ordered).
    ``sparse_density_threshold`` rides through to the committed knobs
    when the caller derived one (tune() computes it from the model's
    sparse crossover only when the workload has sparse leaves)."""
    from horovod_tpu_torch.ops import compression as _compression
    from horovod_tpu_torch.ops import exchange as _exchange
    from horovod_tpu_torch.ops import strategy as _strategy
    from horovod_tpu_torch.utils import env as _env
    from horovod_tpu_torch.core.state import HorovodError

    leaves = list(leaves)
    compute_ms = (compute_window_s or 0.0) * 1e3

    # The default candidate = what a fresh process with no knobs set
    # would run. resolve() of the env defaults, not hard-coded strings,
    # so "tuned never loses to defaults" tracks the real defaults.
    default_mode = _exchange.resolve_mode(None)
    default_algo = _strategy.gradient_algo_default()
    if default_algo not in _exchange._costs.ALGORITHMS:
        default_algo = "flat"  # "auto" defers per call; price the base
    default_threshold = _env.fusion_threshold_bytes()
    default_cap = _env.max_channels()
    default = (default_mode, default_algo, "none", default_threshold,
               default_cap)

    modes = _ordered(_exchange.MODES, default_mode)
    algos = [a for a in _ordered(_exchange._costs.ALGORITHMS, default_algo)
             if a != "hierarchical" or topo.multi_slice]
    comps = _ordered(compressions, "none")
    thresholds = [default_threshold]
    derived = _pow2_at_most(model.fusion_threshold_bytes(topo))
    if derived not in thresholds:
        thresholds.append(derived)
    caps = [c for c in channel_caps if c >= 1]
    if default_cap not in caps:
        caps.insert(0, default_cap)

    def evaluate(mode, algo, comp_name, threshold, cap):
        comp = _compression.resolve(comp_name)
        if getattr(comp, "name", "none") == "none":
            comp = None  # NoneCompressor == uncompressed (optimizer idiom)
        plan = _exchange.plan_exchange(
            leaves, threshold, mode=mode, compression=comp, algo=algo,
            labels=labels, topo=topo, model=model,
            compute_window_s=compute_window_s, max_channels=cap)
        return plan, _exchange.planned_exposed_comm_ms(
            plan, topo, model, compute_ms)

    best_plan, best_ms = evaluate(*default)
    default_ms = best_ms
    default_plan = best_plan
    best = default
    evaluated = 1
    for mode in modes:
        for algo in algos:
            for comp_name in comps:
                for threshold in thresholds:
                    for cap in caps:
                        cand = (mode, algo, comp_name, threshold, cap)
                        if cand == default:
                            continue
                        try:
                            plan, ms = evaluate(*cand)
                        except HorovodError:
                            continue  # infeasible knob combination
                        evaluated += 1
                        # Strictly better only: ties keep the earlier
                        # (more conservative) candidate — ultimately
                        # the defaults.
                        if ms < best_ms - 1e-9:
                            best, best_plan, best_ms = cand, plan, ms

    def as_knobs(cand):
        out = {
            "HOROVOD_EXCHANGE_SCHEDULE": cand[0],
            "HOROVOD_ALLREDUCE_ALGO": cand[1],
            "HOROVOD_COMPRESSION": cand[2],
            "HOROVOD_FUSION_THRESHOLD": int(cand[3]),
            "HOROVOD_MAX_CHANNELS": int(cand[4]),
        }
        if sparse_density_threshold is not None:
            out["HOROVOD_SPARSE_DENSITY_THRESHOLD"] = float(
                sparse_density_threshold)
        return out

    return SearchResult(
        knobs=as_knobs(best), plan=best_plan,
        predicted_default_ms=round(default_ms, 6),
        predicted_tuned_ms=round(best_ms, 6),
        candidates=evaluated,
        default_knobs=as_knobs(default), default_plan=default_plan)


def price_speculation(accept_rate: float, k: int,
                      draft_cost_ratio: float = 0.25) -> float:
    """Expected decode speedup of draft-and-verify at draft length ``k``.

    Models per-position acceptance as independent with probability
    ``accept_rate`` (the engine's measured ``spec_accept_rate``): a step
    emits ``a + 1`` tokens where ``a`` is the longest accepted prefix,
    so the expected emission is the geometric partial sum
    ``(1 - p^(k+1)) / (1 - p)`` (``k + 1`` at p=1). One speculative
    step costs one verify pass (priced as one plain decode step — same
    weights-bound regime, batched positions ride along) plus ``k``
    draft forwards at ``draft_cost_ratio`` of a target forward each.
    Self-speculation prices the draft at 1.0 but still wins on dispatch
    amortization, which this model deliberately does NOT credit — the
    measured decode rate holds that on the machine's terms."""
    if not 0.0 <= accept_rate <= 1.0:
        raise ValueError(f"accept_rate must be in [0, 1], "
                         f"got {accept_rate!r}")
    if k < 0:
        raise ValueError(f"speculate k must be >= 0, got {k!r}")
    if draft_cost_ratio <= 0.0:
        raise ValueError(f"draft_cost_ratio must be > 0, "
                         f"got {draft_cost_ratio!r}")
    if k == 0:
        return 1.0  # speculation off == the plain decode baseline
    p = float(accept_rate)
    if p >= 1.0:
        emitted = k + 1.0
    else:
        emitted = (1.0 - p ** (k + 1)) / (1.0 - p)
    return emitted / (1.0 + k * draft_cost_ratio)


def shrink_speculate_k(accept_rate: float, k: int,
                       draft_cost_ratio: float = 0.25) -> int:
    """The accept-rate-aware speculation knob: the draft length the
    measured accept rate actually pays for.

    Returns the ``k' <= k`` that maximizes the priced speedup
    (:func:`price_speculation`), or 0 when every draft length prices
    speculation as a loss — a low accept rate makes the draft pure
    overhead and the right setting is OFF. Ties keep the SMALLER k'
    (fewer wasted draft forwards per rollback, smaller headroom
    reservation) — the same conservative tie-break the knob search
    applies. Operates between runs: k is a trace-shape constant, so the
    engine cannot shrink it live without retracing; the shrunk value is
    committed as ``HOROVOD_SERVE_SPECULATE`` for the next run."""
    if k < 0:
        raise ValueError(f"speculate k must be >= 0, got {k!r}")
    best_k, best = 0, 1.0  # k'=0 == baseline speedup 1.0
    for cand in range(1, k + 1):
        s = price_speculation(accept_rate, cand, draft_cost_ratio)
        if s > best + 1e-9:
            best_k, best = cand, s
    return best_k


def speculation_knob(accept_rate: float, k: int,
                     draft_cost_ratio: float = 0.25) -> dict:
    """``{"HOROVOD_SERVE_SPECULATE": k'}`` — the committed form of
    :func:`shrink_speculate_k`, mergeable into a TunedConfig's knobs
    (the name is registered in tune/artifact.py TUNABLE_KNOBS and
    HVD105-checked like every other committed knob)."""
    return {"HOROVOD_SERVE_SPECULATE":
            shrink_speculate_k(accept_rate, k, draft_cost_ratio)}


def price_sharding(param_bytes: int, fsdp_size: int, topo, model, *,
                   n_leaves: int = 1,
                   compute_window_s: float | None = None) -> dict:
    """Per-step EXTRA exposed wire time (ms) of each sharding mode
    relative to the replicated path — the α–β pricing behind
    :func:`sharding_knob`.

    The gradient exchange itself is wire-neutral across modes (zero2/3
    keep the replicated lowering's reduce-scatter prefix and drop its
    trailing all-gather; ops/strategy.py), so the difference prices
    down to the all-gathers each mode ADDS: ``zero2`` all-gathers the update shards
    after the backward (one AG of ~param_bytes at the parameter dtype,
    nothing to overlap against — the step is ending), ``zero3``
    all-gathers parameter shards ahead of the forward (gather-on-use),
    priced as overlapping all but the issue alphas with forward compute
    (the reference's model). ``compute_window_s`` is the profiled
    no-exchange step window; its forward half is the overlap budget
    (None = no credit, every gather microsecond counts as exposed).
    Gathers run over the fsdp partition — NVLink by construction
    (ops/mesh.py: fsdp never straddles a host boundary)."""
    from horovod_tpu_torch.core.state import HorovodError

    if param_bytes < 0 or n_leaves < 1 or fsdp_size < 1:
        raise HorovodError(
            f"price_sharding: param_bytes={param_bytes!r}, "
            f"fsdp_size={fsdp_size!r}, n_leaves={n_leaves!r} — all must "
            f"be positive (param_bytes >= 0).")
    if fsdp_size == 1:
        return {"off": 0.0, "zero2": 0.0, "zero3": 0.0}
    s_us_per_byte = 1e-3 / model.nvlink.gbps
    # All-gather over the F-way fsdp partition: each rank receives the
    # other (F-1)/F of every leaf; each leaf is its own collective, so
    # every leaf pays the NVLink issue alpha.
    wire_us = (n_leaves * model.nvlink.alpha_us
               + (fsdp_size - 1) / fsdp_size * param_bytes * s_us_per_byte)
    alpha_us = n_leaves * model.nvlink.alpha_us
    forward_ms = (compute_window_s or 0.0) * 1e3 / 2.0
    zero3_ms = max(wire_us * 1e-3 - forward_ms, alpha_us * 1e-3)
    return {"off": 0.0,
            "zero2": round(wire_us * 1e-3, 6),
            "zero3": round(zero3_ms, 6)}


def sharding_knob(param_bytes: int, opt_state_bytes: int, topo, model, *,
                  fsdp_size: int | None = None, n_leaves: int = 1,
                  hbm_bytes: int | None = None,
                  compute_window_s: float | None = None) -> dict:
    """``{"HOROVOD_SHARDING": mode}`` — the committed sharding decision,
    mergeable into a TunedConfig's knobs (both names are registered in
    tune/artifact.py TUNABLE_KNOBS; explicit env still beats the tuned
    value — tune/apply.py).

    Feasibility first, then price: per-chip resident bytes per mode are
    ``off = P + O``, ``zero2 = P + O/F``, ``zero3 = (P + O)/F + peak
    transient gather`` (the largest gathered leaf, approximated as
    ``P/n_leaves``). With an ``hbm_bytes`` budget, infeasible modes are
    struck and the cheapest feasible mode by :func:`price_sharding`
    wins, ties breaking toward the LEFT of off → zero2 → zero3 (the
    search's conservative tie-break: replicated is the bit-exact
    baseline and every added all-gather is an extra compiled
    collective). Without a budget the pricing alone decides — and since
    sharding only ever ADDS wire time, that keeps ``off``: sharding is
    a memory-capacity trade, and committing it needs the capacity fact.
    When NO mode fits, zero3 (the smallest footprint) is committed
    anyway — the run may still fit with the slack the estimate can't
    see, and every other choice is strictly worse. A non-default
    ``fsdp_size`` is committed alongside as ``HOROVOD_FSDP_AXIS_SIZE``."""
    from horovod_tpu_torch.ops import mesh as _mesh_mod

    fmesh = _mesh_mod.layout(topo, fsdp_size=fsdp_size)
    F = fmesh.fsdp_size
    priced = price_sharding(param_bytes, F, topo, model,
                            n_leaves=n_leaves,
                            compute_window_s=compute_window_s)
    resident = {
        "off": param_bytes + opt_state_bytes,
        "zero2": param_bytes + opt_state_bytes // F,
        "zero3": ((param_bytes + opt_state_bytes) // F
                  + param_bytes // max(1, n_leaves)),
    }
    modes = ("off", "zero2", "zero3")
    if hbm_bytes is not None:
        feasible = [m for m in modes if resident[m] <= hbm_bytes]
        if not feasible:
            feasible = ["zero3"]
    else:
        feasible = list(modes)
    best = feasible[0]
    for m in feasible[1:]:
        if priced[m] < priced[best] - 1e-9:
            best = m
    out = {"HOROVOD_SHARDING": best}
    per_slice = (topo.local_size if topo.multi_slice
                 else topo.group_size)
    if best != "off" and F != per_slice:
        out["HOROVOD_FSDP_AXIS_SIZE"] = F
    return out


def _ordered(values, first):
    """``values`` with ``first`` moved to the front (tie-break order)."""
    rest = [v for v in values if v != first]
    return ([first] + rest) if first in values else list(values)


def _pow2_at_most(n: int) -> int:
    """Largest power of two <= n (the planner's threshold quantization,
    so a derived threshold lands on the same grid explicit ones use)."""
    n = max(1, int(n))
    p = 1
    while p * 2 <= n:
        p *= 2
    return p

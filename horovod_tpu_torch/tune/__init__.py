"""``hvd.tune()``: profile-guided configuration of the port.

Counterpart of ``horovod_tpu/tune/__init__.py``. Every lever of the
gradient exchange (the decompositions, the wire formats, the priority
schedule, channels, the sparse gather) defaults off. This layer turns them
on where the cost model says they pay: one bounded calibration pass
(``tune/calibrate.py``) fits α–β and ``ch_eff`` with the recalibrator, a
grid search over the knobs the cost model prices (``tune/search.py``)
picks the cheapest configuration, and the result is committed as a
versioned ``.tuned.json`` (``tune/artifact.py``) beside the fully resolved
``.exchange.json``: a pair the port's verifier
(``analysis/schedule.py::verify_tuned_config``) checks end to end before
anything applies it.

Precedence, everywhere: **explicit env > tuned > default**
(``tune/apply.py``); ``hvd.tune_report()`` says for every knob which won.

Trigger forms:

* ``hvd.tune()``, after ``hvd.init()``;
* ``HOROVOD_PROFILE=auto``: the same pass at the end of ``hvd.init``;
* ``HOROVOD_TUNED_CONFIG=path.tuned.json``: no calibration; verify and
  apply a committed pair at ``hvd.init``.

At one rank a collective moves nothing: the calibration fits no constant,
every candidate prices the same, and ties keep the defaults, so
``hvd.tune()`` commits the defaults, as the reference does.
"""

from __future__ import annotations

import os

from horovod_tpu_torch.tune.artifact import (  # noqa: F401  (public re-exports)
    TUNABLE_KNOBS, TUNED_ARTIFACT_SCHEMA, TunedConfig, TunedConfigError,
    default_tuned_path, exchange_path_for, load_tuned_config)
from horovod_tpu_torch.tune import apply as _apply
from horovod_tpu_torch.tune import calibrate as _calibrate
from horovod_tpu_torch.tune.calibrate import Calibration, calibrate  # noqa: F401
from horovod_tpu_torch.tune.search import (  # noqa: F401
    SearchResult, price_sharding, price_speculation, search,
    sharding_knob, shrink_speculate_k, speculation_knob)


def tune(group: int = 0, *, path: str | None = None,
         budget_s: float | None = None, apply: bool = True,
         measure=None, lm: bool | None = None,
         verify: bool = True) -> TunedConfig:
    """Calibrate, search, commit, verify, (optionally) apply.

    Returns the committed :class:`TunedConfig`; the artifact pair lands
    at ``path`` (default :func:`default_tuned_path`) with the resolved
    ``.exchange.json`` next to it. Refuses to commit — raises
    ``HorovodError`` — if the freshly built pair fails its own
    verification; a config that can't pass it must never reach
    a run. ``measure``/``lm`` are test injection points
    (tune/calibrate.py)."""
    from horovod_tpu_torch.core import state as hvd
    from horovod_tpu_torch.core.state import HorovodError
    from horovod_tpu_torch.utils import costs as _costs

    if not hvd.is_initialized():
        raise HorovodError("hvd.tune() requires hvd.init() first — "
                           "calibration times live collectives.")
    cal = calibrate(group, budget_s=budget_s, measure=measure, lm=lm)
    model = _costs.model_from_constants(cal.constants, cal.topo)
    leaves, labels = cal.leaves, cal.labels
    if not leaves:
        leaves, labels = _probe_leaves()
    result = search(leaves, cal.topo, model, labels=list(labels),
                    compute_window_s=cal.compute_window_s)

    tuned_path = path or default_tuned_path()
    exchange_path = exchange_path_for(tuned_path)

    def build_config(knobs, plan, measured_ms):
        return TunedConfig(
            device_kind=cal.topo.device_kind,
            world_size=cal.topo.group_size,
            num_slices=cal.topo.num_slices,
            constants=cal.constants,
            knobs=knobs,
            exchange_artifact=os.path.basename(exchange_path),
            exchange_plan_hash=plan.plan_hash(),
            compute_window_ms=(
                None if cal.compute_window_s is None
                else round(cal.compute_window_s * 1e3, 6)),
            predicted_exposed_ms={
                "default": result.predicted_default_ms,
                "tuned": result.predicted_tuned_ms,
            },
            measured_lm_step_ms=measured_ms)

    knobs, plan = dict(result.knobs), result.plan
    measured_ms = None
    if cal.compute_window_s is not None and knobs != result.default_knobs:
        # Measured guardrail: the model's argmin is a hypothesis — the
        # cost model prices wire time, not the compute that compression
        # and channelization add to the step. Run the real LM step both
        # ways (tune/calibrate.py measure_lm_ab); when the tuned arm does
        # not measure strictly faster, commit the DEFAULTS (keeping any
        # workload-derived sparse threshold) with the measurement as
        # evidence — the same "ties keep defaults" rule the search
        # applies on the model's terms, now on the machine's.
        default_s, tuned_s = _calibrate.measure_lm_ab(
            build_config(knobs, plan, None), path=tuned_path)
        measured_ms = {"default": round(default_s * 1e3, 6),
                       "tuned": round(tuned_s * 1e3, 6)}
        if tuned_s >= default_s:
            knobs, plan = dict(result.default_knobs), result.default_plan

    config = build_config(knobs, plan, measured_ms)
    exchange_text = plan.to_json()
    if verify:
        # The pair must verify clean before it exists on disk: the same
        # verifier apply_committed runs on committed artifacts.
        from horovod_tpu_torch.analysis import schedule as _sched

        findings = _sched.verify_tuned_config(
            config.to_json(), path=tuned_path,
            exchange_text=exchange_text)
        if findings:
            raise HorovodError(
                "hvd.tune(): refusing to commit a tuned config that "
                "fails its own verification:\n" +
                "\n".join(str(f) for f in findings))

    parent = os.path.dirname(os.path.abspath(tuned_path))
    os.makedirs(parent, exist_ok=True)
    plan.save(exchange_path)
    config.save(tuned_path)
    if apply:
        _apply.activate(config, path=tuned_path)
    return config


def apply_committed(path: str) -> TunedConfig:
    """Verify + apply a previously committed artifact pair (the
    ``HOROVOD_TUNED_CONFIG`` path at ``hvd.init``). Refuses — raises
    ``HorovodError`` — when the pair fails verification or was tuned
    for a different world shape than the live one."""
    from horovod_tpu_torch.core import state as hvd
    from horovod_tpu_torch.analysis import schedule as _sched
    from horovod_tpu_torch.core.state import HorovodError

    try:
        with open(path) as f:
            text = f.read()
    except OSError as e:
        raise HorovodError(f"HOROVOD_TUNED_CONFIG: cannot read "
                           f"{path!r}: {e}")
    findings = _sched.verify_tuned_config(text, path=path)
    if findings:
        raise HorovodError(
            f"HOROVOD_TUNED_CONFIG: {path!r} failed verification — "
            "refusing to apply:\n" + "\n".join(str(f) for f in findings))
    config = TunedConfig.from_json(text)
    if config.world_size != hvd.size():
        raise HorovodError(
            f"HOROVOD_TUNED_CONFIG: {path!r} was tuned for world "
            f"{config.world_size}, live world is {hvd.size()} — a "
            f"schedule for the wrong world would diverge (HVD103); "
            f"re-run hvd.tune().")
    _apply.activate(config, path=path)
    return config


def tune_report() -> dict:
    """Provenance of every tunable knob: which of env/tuned/default won
    (tune/apply.py :func:`~horovod_tpu_torch.tune.apply.report`)."""
    return _apply.report()


def _probe_leaves():
    """Synthetic gradient set for calibrations that skipped the LM
    profile (injected ``measure``): a transformer-shaped byte mix so
    the search still exercises bucketing, ordering and channels."""
    import torch

    shapes = [(97, 32), (32, 64), (64, 32), (32, 32), (32,), (64,),
              (32, 32), (32,)]
    leaves = tuple(torch.empty(s, dtype=torch.float32, device="meta")
                   for s in shapes)
    labels = tuple(f"probe{i}" for i in range(len(shapes)))
    return leaves, labels

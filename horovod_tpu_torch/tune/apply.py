"""Application and provenance of an active :class:`TunedConfig`.

Counterpart of ``horovod_tpu/tune/apply.py``. Precedence is the whole
contract: **explicit env beats tuned beats default**. A knob resolves to
its tuned value only when the operator did not set its environment
variable: an explicit ``HOROVOD_COMPRESSION=none`` always wins over what
``hvd.tune()`` decided. The port's resolution sites consult
:func:`override` where ``None`` used to mean "the env default": the
gradient path's algorithm, compression, cross-host wire, schedule, fusion
threshold and channel cap (``parallel/optimizer.py::FusedAllreduce`` for
``allreduce_gradients`` and ``DistributedOptimizer``, never for a
restricted group or the Trainer's buffer sync), the sharding mode and
fsdp axis (``parallel/optimizer.py``, ``training/loop.py``), the ZeRO
wire (``parallel/sharded.py``), the sparse density switch
(``ops/sparse.py``) and the serving engine's speculate knob
(``serving/engine.py``).

Provenance is recorded at activation (which env vars were set when the
config went live), so :func:`report` says for every knob whether its
value came from ``env``, ``tuned`` or ``default``; the timeline gets an
instant tick on its ``tune`` row stamped with the config hash.
"""

from __future__ import annotations

import os
import threading

from horovod_tpu_torch.tune.artifact import TUNABLE_KNOBS, TunedConfig

_lock = threading.Lock()
_active: TunedConfig | None = None
_active_path: str | None = None
_env_wins: frozenset[str] = frozenset()


def activate(config: TunedConfig, *, path: str | None = None) -> None:
    """Make ``config`` the live tuned configuration.

    Snapshot which tunable knobs the environment already sets — those
    keep winning for the lifetime of this activation (precedence is
    decided once, at activation, so a mid-run ``os.environ`` mutation
    can't flip a knob between traced steps)."""
    global _active, _active_path, _env_wins
    with _lock:
        _active = config
        _active_path = path
        _env_wins = frozenset(
            name for name in TUNABLE_KNOBS if os.environ.get(name))
    _tune_tick(f"apply:{config.config_hash()}")


def deactivate() -> None:
    """Drop the active tuned configuration (``hvd.shutdown``)."""
    global _active, _active_path, _env_wins
    with _lock:
        _active = None
        _active_path = None
        _env_wins = frozenset()


def active() -> TunedConfig | None:
    """The live TunedConfig, or None when nothing is applied."""
    return _active


def override(name: str):
    """The tuned value for env knob ``name``, or None when the tuned
    config doesn't cover it / the environment explicitly sets it / no
    config is active. Callers treat None exactly like "knob absent":
    fall through to the env default they already read."""
    config = _active
    if config is None or name in _env_wins:
        return None
    return config.knobs.get(name)


def report() -> dict:
    """Provenance of every tunable knob: ``{"active": bool, "hash":
    ..., "path": ..., "knobs": {name: {"value": ..., "source":
    env|tuned|default}}}`` — the ``hvd.tune_report()`` payload."""
    config = _active
    knobs = {}
    for name in TUNABLE_KNOBS:
        if os.environ.get(name):
            knobs[name] = {"value": os.environ[name], "source": "env"}
        elif config is not None and name in config.knobs:
            knobs[name] = {"value": config.knobs[name], "source": "tuned"}
        else:
            knobs[name] = {"value": None, "source": "default"}
    out = {"active": config is not None, "knobs": knobs}
    if config is not None:
        out["hash"] = config.config_hash()
        out["path"] = _active_path
        out["device_kind"] = config.device_kind
        out["world_size"] = config.world_size
        if config.predicted_exposed_ms is not None:
            out["predicted_exposed_ms"] = dict(config.predicted_exposed_ms)
    return out


def _tune_tick(activity: str) -> None:
    """Timeline instant tick on the ``tune`` row; a no-op when the
    timeline is inactive (artifact round-trips work without a world)."""
    from horovod_tpu_torch.core import timeline as _tl

    tl = _tl.session()
    if tl.active:
        tl.event("tune", activity, "X")

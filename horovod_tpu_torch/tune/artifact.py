"""The versioned ``TunedConfig`` artifact (``.tuned.json``).

Counterpart of ``horovod_tpu/tune/artifact.py``, copied. One committed
file records everything ``hvd.tune()`` decided: the fitted α–β/``ch_eff``
constants the search priced with, the resolved knob values (exactly the
environment variables they stand in for), the predicted exposed-
communication costs of the default and the tuned configuration, and the
identity (filename + plan hash) of the fully resolved ``.exchange.json``
committed next to it. Canonical sorted-keys/compact JSON is the hashed
identity (crc32, stable across processes), ``save`` pretty-prints the
same data, and ``from_json`` refuses any schema it does not match.

Divergence (ROADMAP §C): the schema is the port's own,
``horovod_tpu_torch/tuned-config/v1``, because ``constants`` carry the
port's link levels ``nvlink``/``ib``. Stdlib only; the verifier is
``analysis/schedule.py::verify_tuned_config``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import zlib

# The port's own schema: its ``constants`` name the port's cost-model
# levels (``nvlink``/``ib``, where the reference's name ``ici``/``dcn``), so
# an artifact tuned on a TPU is refused, never misread. Bump whenever the
# layout changes; old files are then refused outright.
TUNED_ARTIFACT_SCHEMA = "horovod_tpu_torch/tuned-config/v1"

# The environment knobs a TunedConfig may resolve. Application
# (tune/apply.py) consults exactly this tuple, and the verifier refuses
# artifacts carrying knobs outside it — a tuned config must never smuggle
# in a setting the precedence rules don't cover.
TUNABLE_KNOBS = (
    "HOROVOD_ALLREDUCE_ALGO",
    "HOROVOD_COMPRESSION",
    "HOROVOD_COMPRESSION_CROSS_SLICE",
    "HOROVOD_EXCHANGE_SCHEDULE",
    "HOROVOD_FSDP_AXIS_SIZE",
    "HOROVOD_FUSION_THRESHOLD",
    "HOROVOD_MAX_CHANNELS",
    "HOROVOD_SERVE_SPECULATE",
    "HOROVOD_SHARDING",
    "HOROVOD_SPARSE_DENSITY_THRESHOLD",
)


class TunedConfigError(ValueError):
    """Unreadable/stale/inconsistent tuned-config artifact (refused)."""


@dataclasses.dataclass(frozen=True)
class TunedConfig:
    """One committed profile-guided configuration.

    ``knobs`` maps knob names (:data:`TUNABLE_KNOBS` members) to their
    tuned values — absent keys mean "leave the default alone", and a
    ``None`` value is serialized (and applied) as "explicitly no
    override" for knobs whose unset state is meaningful
    (``HOROVOD_SPARSE_DENSITY_THRESHOLD``). ``constants`` is the fitted
    cache-layout α–β dict the search priced with
    (``{"nvlink": {"alpha_us", "gbps"[, "ch_eff"]}, ...}``).
    ``exchange_artifact``/``exchange_plan_hash`` name the fully resolved
    ``.exchange.json`` committed next to this file and pin its identity
    — the verifier refuses the pair when they disagree.
    """

    device_kind: str
    world_size: int
    num_slices: int
    constants: dict
    knobs: dict
    exchange_artifact: str
    exchange_plan_hash: str
    compute_window_ms: float | None = None
    predicted_exposed_ms: dict | None = None
    # The commit-time measured LM-step A/B (tune/calibrate.py
    # measure_lm_ab), present only when a live profile ran AND the search
    # left the defaults: {"default": ms, "tuned": ms}. When the tuned arm
    # measured slower, the committed knobs ARE the defaults and this
    # field is the evidence for why.
    measured_lm_step_ms: dict | None = None

    def to_json(self) -> str:
        """Canonical (sorted-keys, compact) JSON — the hashed identity,
        byte-identical across processes for identical inputs (the
        ExchangeSchedule convention)."""
        data = {
            "schema": TUNED_ARTIFACT_SCHEMA,
            "device_kind": self.device_kind,
            "world_size": self.world_size,
            "num_slices": self.num_slices,
            "constants": self.constants,
            "knobs": self.knobs,
            "exchange_artifact": self.exchange_artifact,
            "exchange_plan_hash": self.exchange_plan_hash,
        }
        # Only-when-present serialization (the exchange artifact's rule):
        # configs tuned without an LM profile keep byte-identical JSON.
        if self.compute_window_ms is not None:
            data["compute_window_ms"] = self.compute_window_ms
        if self.predicted_exposed_ms is not None:
            data["predicted_exposed_ms"] = self.predicted_exposed_ms
        if self.measured_lm_step_ms is not None:
            data["measured_lm_step_ms"] = self.measured_lm_step_ms
        return json.dumps(data, sort_keys=True, separators=(",", ":"))

    def config_hash(self) -> str:
        """Stable 8-hex-digit identity (crc32 of the canonical JSON —
        crc32, not hash(), so it matches across processes), reported by
        ``hvd.tune_report()`` and stamped on the timeline TUNE tick."""
        return f"{zlib.crc32(self.to_json().encode('utf-8')) & 0xFFFFFFFF:08x}"

    def save(self, path: str) -> str:
        """Write the artifact (pretty-printed; the hash is computed over
        the canonical form, so formatting doesn't change identity)."""
        with open(path, "w") as f:
            json.dump(json.loads(self.to_json()), f, indent=1,
                      sort_keys=True)
            f.write("\n")
        return path

    @staticmethod
    def from_json(text: str) -> "TunedConfig":
        """Parse a serialized artifact; unknown schema raises (never
        field-guessed — the tuning-cache convention)."""
        try:
            data = json.loads(text)
        except ValueError as e:
            raise TunedConfigError(f"unreadable TunedConfig JSON: {e}")
        if not isinstance(data, dict) \
                or data.get("schema") != TUNED_ARTIFACT_SCHEMA:
            raise TunedConfigError(
                f"TunedConfig schema mismatch: expected "
                f"{TUNED_ARTIFACT_SCHEMA!r}, got {data.get('schema')!r} — "
                f"refusing to guess a stale layout.")
        knobs = data.get("knobs")
        if not isinstance(knobs, dict):
            raise TunedConfigError(
                "TunedConfig carries no knobs object — refused, never "
                "field-guessed.")
        unknown = sorted(set(knobs) - set(TUNABLE_KNOBS))
        if unknown:
            raise TunedConfigError(
                f"TunedConfig resolves unknown knob(s) {unknown} — only "
                f"{list(TUNABLE_KNOBS)} are tunable; a typo'd knob name "
                f"must not be silently ignored.")
        try:
            return TunedConfig(
                device_kind=str(data["device_kind"]),
                world_size=int(data["world_size"]),
                num_slices=int(data["num_slices"]),
                constants=dict(data.get("constants") or {}),
                knobs=dict(knobs),
                exchange_artifact=str(data["exchange_artifact"]),
                exchange_plan_hash=str(data["exchange_plan_hash"]),
                compute_window_ms=(
                    None if data.get("compute_window_ms") is None
                    else float(data["compute_window_ms"])),
                predicted_exposed_ms=(
                    None if data.get("predicted_exposed_ms") is None
                    else dict(data["predicted_exposed_ms"])),
                measured_lm_step_ms=(
                    None if data.get("measured_lm_step_ms") is None
                    else dict(data["measured_lm_step_ms"])))
        except (KeyError, TypeError, ValueError) as e:
            raise TunedConfigError(
                f"corrupt TunedConfig artifact field "
                f"({e.__class__.__name__}: {e}) — refused, never "
                f"field-guessed.")


def load_tuned_config(path: str) -> TunedConfig:
    """Read + parse one ``.tuned.json`` artifact (schema-refusing)."""
    with open(path) as f:
        return TunedConfig.from_json(f.read())


def exchange_path_for(tuned_path: str) -> str:
    """The sibling ``.exchange.json`` path of a ``.tuned.json`` path —
    same stem, next to it (the committed-pair layout the verifier checks)."""
    if not tuned_path.endswith(".tuned.json"):
        raise TunedConfigError(
            f"tuned-config paths must end in .tuned.json (the hvd-lint "
            f"dispatch suffix), got {tuned_path!r}")
    return tuned_path[:-len(".tuned.json")] + ".exchange.json"


def default_tuned_path() -> str:
    """Where ``hvd.tune()`` commits when no path is given:
    ``HOROVOD_TUNED_CONFIG`` when set, else next to the tuning cache."""
    from horovod_tpu_torch.utils import env as _env

    configured = _env.tuned_config_path()
    if configured:
        return configured
    return os.path.join(
        os.path.dirname(os.path.abspath(_env.tuning_cache_path())),
        "default.tuned.json")

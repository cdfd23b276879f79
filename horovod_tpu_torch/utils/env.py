"""Environment-variable configuration — the knobs the port reads.

Same variable names as the reference, so job scripts carry over:
``HOROVOD_FUSION_THRESHOLD`` sizes the gradient fusion buffer (default
64 MB), ``HOROVOD_TIMELINE`` names a Chrome-tracing output file,
``HOROVOD_STALL_CHECK_TIME`` and ``HOROVOD_NEGOTIATION_TIMEOUT`` time the
negotiation's stall report and its wait for the coordinator
(``core/negotiate.py``), ``HOROVOD_SCHEDULE_TIMEOUT`` caps the coordinator's
wait for a program's schedules (``core/multihost.py``), the ``HOROVOD_SERVE_*`` knobs configure the
serving engine (``horovod_tpu_torch.serving``), ``HOROVOD_FAULT_INJECT``
arms the serving faults and ``torn_write`` (``core/resilience.py``), and
``HOROVOD_DATA_DIR`` and ``HOROVOD_PREFETCH_DEPTH`` place the datasets and
set how far the input pipeline prefetches (``training/data.py``), and
``HOROVOD_SPARSE_PAD_CAPACITY`` pads the sparse gather wire
(``ops/sparse.py``).

Every other knob of the reference is registered too, with the ROADMAP §A
item that ports it (:data:`UNPORTED_RESULT_KNOBS`,
:data:`UNPORTED_TUNING_KNOBS`). At ``hvd.init`` (:func:`check_unported`) a
knob that would change what a run computes raises
``NotImplementedError`` naming its item, so a job script never runs
without a setting it asked for; a knob that only tunes timing or reporting
draws a warning. Any ``HOROVOD_*`` variable that is not registered at all
is most likely a typo'd knob name and draws a warning too. A typo'd
*value* raises, with the reference's message.
"""

from __future__ import annotations

import os
import warnings

DEFAULT_FUSION_THRESHOLD = 64 * 1024 * 1024  # bytes
DEFAULT_STALL_WARNING_TIME = 60.0  # seconds

# The knobs the port reads.
PORTED_KNOBS = frozenset({
    "HOROVOD_DATA_DIR",
    "HOROVOD_FAULT_INJECT",
    "HOROVOD_FUSION_THRESHOLD",
    "HOROVOD_NEGOTIATION_TIMEOUT",
    "HOROVOD_PREFETCH_DEPTH",
    "HOROVOD_SCHEDULE_TIMEOUT",
    "HOROVOD_SERVE_BLOCK_SIZE",
    "HOROVOD_SERVE_DEADLINE_MS",
    "HOROVOD_SERVE_DRAFT_KV_DTYPE",
    "HOROVOD_SERVE_JOURNAL",
    "HOROVOD_SERVE_KV_DTYPE",
    "HOROVOD_SERVE_MAX_BATCH",
    "HOROVOD_SERVE_MIN_ACCEPT",
    "HOROVOD_SERVE_PREFIX_CACHE",
    "HOROVOD_SERVE_SPECULATE",
    "HOROVOD_SERVE_WATCHDOG_TIMEOUT",
    "HOROVOD_SPARSE_PAD_CAPACITY",
    "HOROVOD_STALL_CHECK_TIME",
    "HOROVOD_TIMELINE",
})

# Knobs of the reference that change what a run computes, not ported yet:
# name -> (ROADMAP §A item, what it does, the values that leave it off).
# Set to anything else, each raises at hvd.init.
UNPORTED_RESULT_KNOBS: dict[str, tuple[int, str, frozenset]] = {
    "HOROVOD_ALLREDUCE_ALGO": (12, "the allreduce decomposition",
                               frozenset({"", "flat"})),
    "HOROVOD_COMPRESSION": (12, "gradient wire compression",
                            frozenset({"", "none"})),
    "HOROVOD_ERROR_FEEDBACK": (12, "compression error feedback",
                               frozenset({"", "0"})),
    "HOROVOD_SHARDING": (12, "ZeRO sharding of optimizer state and "
                             "parameters", frozenset({"", "off"})),
    "HOROVOD_FSDP_AXIS_SIZE": (12, "the FSDP mesh axis of the ZeRO modes",
                               frozenset({""})),
    "HOROVOD_ELASTIC": (15, "elastic shrink and regrow",
                        frozenset({"", "0"})),
}

# Knobs of the reference that only tune timing or reporting, not ported
# yet: name -> ROADMAP §A item. Each draws a warning at hvd.init.
UNPORTED_TUNING_KNOBS: dict[str, int] = {
    "HOROVOD_AUTOTUNE": 16,
    "HOROVOD_COMPRESSION_BLOCK": 12,
    "HOROVOD_COMPRESSION_CROSS_SLICE": 12,
    "HOROVOD_EAGER_CACHE": 1,
    "HOROVOD_ELASTIC_JOIN_TIMEOUT": 15,
    "HOROVOD_ELASTIC_MIN_WORLD": 15,
    "HOROVOD_EXCHANGE_CHANNELS": 12,
    "HOROVOD_EXCHANGE_SCHEDULE": 12,
    "HOROVOD_KV_BACKOFF_MS": 15,
    "HOROVOD_KV_RETRIES": 15,
    "HOROVOD_LIVENESS_INTERVAL": 15,
    "HOROVOD_LIVENESS_TIMEOUT": 15,
    "HOROVOD_MAX_CHANNELS": 12,
    "HOROVOD_MODEL_FAULTS": 17,
    "HOROVOD_MODEL_MAX_STATES": 17,
    "HOROVOD_PROFILE": 16,
    "HOROVOD_RECALIBRATION": 12,
    "HOROVOD_SPARSE_DENSITY_THRESHOLD": 12,
    "HOROVOD_TIMELINE_DEVICE": 16,
    "HOROVOD_TIMELINE_DEVICE_INTERVAL": 16,
    "HOROVOD_TOPOLOGY_SLICES": 12,
    "HOROVOD_TUNED_CONFIG": 16,
    "HOROVOD_TUNE_BUDGET_S": 16,
    "HOROVOD_TUNING_CACHE": 16,
}

# Knobs that only mean something under JAX: accepted, and nothing is said.
JAX_ONLY_KNOBS = frozenset({"HOROVOD_CPU_DEVICES", "HOROVOD_XLA_OPTIONS"})

# Training faults of HOROVOD_FAULT_INJECT that the port does not inject
# yet (ROADMAP §A item 15; it injects torn_write and the serving faults).
UNPORTED_FAULTS = frozenset({"crash", "kv_timeout", "regrow"})

KNOWN_ENV_VARS = (PORTED_KNOBS | frozenset(UNPORTED_RESULT_KNOBS)
                  | frozenset(UNPORTED_TUNING_KNOBS) | JAX_ONLY_KNOBS)


def unknown_horovod_vars(environ=None) -> list[str]:
    """``HOROVOD_*`` names present in ``environ`` (default ``os.environ``)
    but absent from :data:`KNOWN_ENV_VARS`."""
    env = os.environ if environ is None else environ
    return sorted(k for k in env
                  if k.startswith("HOROVOD_") and k not in KNOWN_ENV_VARS)


def warn_unknown_env(environ=None) -> list[str]:
    """Warn about unknown ``HOROVOD_*`` variables; returns their names."""
    unknown = unknown_horovod_vars(environ)
    for name in unknown:
        warnings.warn(
            f"Unknown environment variable {name!r}: not a horovod_tpu_torch "
            f"knob (see horovod_tpu_torch.utils.env.KNOWN_ENV_VARS). A "
            f"typo'd knob name is silently ignored — did you mean one of the "
            f"registered HOROVOD_* variables?", stacklevel=2)
    return unknown


def fusion_threshold_bytes() -> int:
    """Fusion buffer size in bytes; 0 disables fusion. Unparsable or
    negative values raise."""
    raw = os.environ.get("HOROVOD_FUSION_THRESHOLD")
    if raw is None:
        return DEFAULT_FUSION_THRESHOLD
    try:
        value = int(raw)
    except ValueError:
        raise ValueError(
            f"HOROVOD_FUSION_THRESHOLD must be a byte count (0 disables "
            f"fusion), got {raw!r}") from None
    if value < 0:
        raise ValueError(
            f"HOROVOD_FUSION_THRESHOLD must be >= 0 (0 disables fusion), "
            f"got {raw!r}")
    return value


def timeline_path() -> str | None:
    """Path for the Chrome-tracing timeline, or None when disabled."""
    path = os.environ.get("HOROVOD_TIMELINE")
    return path if path else None


def stall_warning_seconds() -> float:
    """``HOROVOD_STALL_CHECK_TIME`` (seconds, default 60; 0 disables): how
    long the coordinator waits on missing ranks between stall warnings.
    Parsed as the reference parses it: an unparsable value is the
    default."""
    raw = os.environ.get("HOROVOD_STALL_CHECK_TIME")
    if raw is None:
        return DEFAULT_STALL_WARNING_TIME
    try:
        return max(0.0, float(raw))
    except ValueError:
        return DEFAULT_STALL_WARNING_TIME


def negotiation_timeout_ms() -> int:
    """``HOROVOD_NEGOTIATION_TIMEOUT`` (seconds; default 600): how long a
    member that is not the coordinator waits for the coordinator's verdict
    before raising. The coordinator itself waits indefinitely, printing
    stall warnings. 0 or inf waits effectively forever; an unparsable
    value is the default (the reference's parsing)."""
    raw = os.environ.get("HOROVOD_NEGOTIATION_TIMEOUT")
    if raw is None:
        return 600_000
    try:
        seconds = float(raw)
    except ValueError:
        return 600_000
    if seconds <= 0 or seconds == float("inf"):
        return 2 ** 31 - 1  # ~24.8 days in ms
    return max(1, int(seconds * 1000))


def schedule_timeout_ms() -> int:
    """``HOROVOD_SCHEDULE_TIMEOUT`` (seconds; default 0 = wait forever):
    opt-in hard cap on the *coordinator's* wait for peer schedules in
    ``validate_schedule`` (core/multihost.py). By default the coordinator
    sweeps stall warnings indefinitely — a slow peer may legitimately be
    recording a big program — but a crashed peer then hangs the whole job;
    setting this bound turns that into a fatal, diagnosable error naming
    the missing process. An unparsable value raises, as in the
    reference."""
    raw = os.environ.get("HOROVOD_SCHEDULE_TIMEOUT")
    if raw is None:
        return 0
    try:
        seconds = float(raw)
    except ValueError:
        seconds = float("nan")
    if seconds != seconds:  # unparsable or NaN: refuse, don't silently
        raise ValueError(   # fall back to the unbounded sweep
            f"HOROVOD_SCHEDULE_TIMEOUT must be a number of seconds, "
            f"got {raw!r}")
    if seconds <= 0 or seconds == float("inf"):
        return 0  # 0/inf: the default unbounded sweep
    return max(1, int(seconds * 1000))


def check_unported(environ=None) -> None:
    """Refuse what the port cannot honour (called by ``hvd.init``).

    A knob of :data:`UNPORTED_RESULT_KNOBS` set to anything but an off
    value, or a ``HOROVOD_FAULT_INJECT`` spec with a training fault the
    port does not inject, raises ``NotImplementedError`` naming the
    ROADMAP §A item that ports it. A knob of :data:`UNPORTED_TUNING_KNOBS`
    draws a warning naming its item and the run goes on without it."""
    env = os.environ if environ is None else environ
    for name, (item, what, off) in sorted(UNPORTED_RESULT_KNOBS.items()):
        raw = env.get(name)
        if raw is not None and raw.strip().lower() not in off:
            raise NotImplementedError(
                f"{name}={raw!r} changes what the run computes ({what}) "
                f"and is not ported: ROADMAP §A item {item}. Unset it to "
                f"run without it.")
    from horovod_tpu_torch.analysis import protocol as _proto

    for fault in _proto.parse_fault_spec(env.get("HOROVOD_FAULT_INJECT")):
        if fault.kind in UNPORTED_FAULTS:
            raise NotImplementedError(
                f"HOROVOD_FAULT_INJECT: the {fault.kind!r} fault "
                f"({fault.describe()}) is not injected by the port: "
                f"ROADMAP §A item 15. A drill that "
                f"injects nothing would pass fault-free; drop the entry.")
    for name, item in sorted(UNPORTED_TUNING_KNOBS.items()):
        if name in env:
            warnings.warn(
                f"{name} is set but not ported: ROADMAP §A item {item}. It "
                f"only tunes timing or reporting; the run goes on without "
                f"it.", stacklevel=2)


def prefetch_depth() -> int:
    """``HOROVOD_PREFETCH_DEPTH`` (default 1): how many batches
    :func:`horovod_tpu_torch.training.data.prefetch_to_device` keeps in
    flight on the device ahead of the consumer. Depth 1 is the classic
    double-buffer; slow/jittery loaders can raise it to keep the device fed
    through hiccups (each unit of depth holds one more batch in device
    memory). Must be a positive integer; typos raise (the resilience-knob
    convention)."""
    raw = os.environ.get("HOROVOD_PREFETCH_DEPTH")
    if raw is None:
        return 1
    try:
        depth = int(raw)
    except ValueError:
        raise ValueError(
            f"HOROVOD_PREFETCH_DEPTH must be a positive integer, "
            f"got {raw!r}") from None
    if depth < 1:
        raise ValueError(
            f"HOROVOD_PREFETCH_DEPTH must be >= 1, got {raw!r}")
    return depth


# -- serving knobs (horovod_tpu_torch.serving) ---------------------------------


def sparse_pad_capacity() -> int:
    """``HOROVOD_SPARSE_PAD_CAPACITY`` (default 0 = no padding): the fixed
    per-rank row capacity of the sparse gather wire (``ops/sparse.py``).
    Must be a non-negative integer; a typo raises at ``hvd.init``."""
    raw = os.environ.get("HOROVOD_SPARSE_PAD_CAPACITY")
    if raw is None or not raw.strip():
        return 0
    try:
        n = int(raw)
    except ValueError:
        raise ValueError(
            f"HOROVOD_SPARSE_PAD_CAPACITY must be a non-negative integer "
            f"row capacity (0 disables padding), got {raw!r}") from None
    if n < 0:
        raise ValueError(
            f"HOROVOD_SPARSE_PAD_CAPACITY must be >= 0 (0 disables "
            f"padding), got {raw!r}")
    return n


def _kv_format(var: str) -> str | None:
    """A ``HOROVOD_SERVE_*KV_DTYPE`` value: None when unset, else one of
    ``model`` or ``serving.kv_cache.KV_DTYPES`` (other values raise)."""
    raw = os.environ.get(var)
    if raw is None or not raw.strip():
        return None
    value = raw.strip().lower()
    from horovod_tpu_torch.serving.kv_cache import KV_DTYPES

    valid = ("model", *KV_DTYPES)
    if value not in valid:
        raise ValueError(
            f"{var} must be one of {'|'.join(valid)}, got {raw!r}")
    return value


def serve_block_size() -> int:
    """``HOROVOD_SERVE_BLOCK_SIZE`` (default 16): tokens per paged KV-cache
    block. A positive integer; anything else raises."""
    raw = os.environ.get("HOROVOD_SERVE_BLOCK_SIZE")
    if raw is None or not raw.strip():
        return 16
    try:
        n = int(raw)
    except ValueError:
        raise ValueError(
            f"HOROVOD_SERVE_BLOCK_SIZE must be a positive integer token "
            f"count, got {raw!r}") from None
    if n < 1:
        raise ValueError(
            f"HOROVOD_SERVE_BLOCK_SIZE must be >= 1, got {raw!r}")
    return n


def serve_max_batch() -> int:
    """``HOROVOD_SERVE_MAX_BATCH`` (default 8): the engine's padded batch
    slots, which fix the decode shape. A positive integer."""
    raw = os.environ.get("HOROVOD_SERVE_MAX_BATCH")
    if raw is None or not raw.strip():
        return 8
    try:
        n = int(raw)
    except ValueError:
        raise ValueError(
            f"HOROVOD_SERVE_MAX_BATCH must be a positive integer slot "
            f"count, got {raw!r}") from None
    if n < 1:
        raise ValueError(
            f"HOROVOD_SERVE_MAX_BATCH must be >= 1, got {raw!r}")
    return n


def serve_kv_dtype() -> str | None:
    """``HOROVOD_SERVE_KV_DTYPE`` (default unset = ``model``): the paged
    pool's storage format — ``model`` (bf16 models cache bf16, others
    fp32), ``fp32``, ``bf16``, ``int8_block`` or ``int4``."""
    return _kv_format("HOROVOD_SERVE_KV_DTYPE")


def serve_prefix_cache() -> bool:
    """``HOROVOD_SERVE_PREFIX_CACHE`` (default 0): copy-on-write prefix
    sharing of full prompt blocks. 0 or 1; anything else raises."""
    raw = os.environ.get("HOROVOD_SERVE_PREFIX_CACHE")
    if raw is None or raw.strip() in ("", "0"):
        return False
    if raw.strip() == "1":
        return True
    raise ValueError(
        f"HOROVOD_SERVE_PREFIX_CACHE must be 0 or 1, got {raw!r}")


def serve_speculate() -> int:
    """``HOROVOD_SERVE_SPECULATE`` (default 0 = off): the speculative draft
    length k, parsed as the reference parses it (the engine's
    ``speculate=``)."""
    raw = os.environ.get("HOROVOD_SERVE_SPECULATE")
    if raw is None or not raw.strip():
        return 0
    try:
        n = int(raw)
    except ValueError:
        raise ValueError(
            f"HOROVOD_SERVE_SPECULATE must be an integer draft length "
            f"(0 disables speculation), got {raw!r}") from None
    if n < 0:
        raise ValueError(
            f"HOROVOD_SERVE_SPECULATE must be >= 0, got {raw!r}")
    return n


def serve_draft_kv_dtype() -> str | None:
    """``HOROVOD_SERVE_DRAFT_KV_DTYPE`` (default unset): the draft model's
    pool format under speculation; the same values as
    ``HOROVOD_SERVE_KV_DTYPE``."""
    return _kv_format("HOROVOD_SERVE_DRAFT_KV_DTYPE")


def serve_deadline_ms() -> float | None:
    """``HOROVOD_SERVE_DEADLINE_MS`` (default unset = no deadline): the
    default per-request latency budget in milliseconds. Positive and
    finite; typos, NaN and non-positive values raise."""
    raw = os.environ.get("HOROVOD_SERVE_DEADLINE_MS")
    if raw is None or not raw.strip():
        return None
    try:
        ms = float(raw)
    except ValueError:
        raise ValueError(
            f"HOROVOD_SERVE_DEADLINE_MS must be a positive number of "
            f"milliseconds, got {raw!r}") from None
    if ms != ms:  # NaN: every deadline comparison would be False
        raise ValueError(
            f"HOROVOD_SERVE_DEADLINE_MS must be a positive number of "
            f"milliseconds, got {raw!r}")
    if ms <= 0 or ms == float("inf"):
        raise ValueError(
            f"HOROVOD_SERVE_DEADLINE_MS must be > 0 and finite, "
            f"got {raw!r}")
    return ms


def serve_journal_path() -> str | None:
    """``HOROVOD_SERVE_JOURNAL`` (default unset = no journal): the
    crash-safe request journal's path, which must end in
    ``.journal.json``."""
    raw = os.environ.get("HOROVOD_SERVE_JOURNAL")
    if raw is None or not raw.strip():
        return None
    path = raw.strip()
    if not path.endswith(".journal.json"):
        raise ValueError(
            f"HOROVOD_SERVE_JOURNAL must name a .journal.json artifact "
            f"(the hvd-lint dispatch suffix), got {raw!r}")
    return path


def serve_watchdog_timeout() -> float:
    """``HOROVOD_SERVE_WATCHDOG_TIMEOUT`` (default 0 = off): seconds a
    prefill or decode dispatch may stay open before the watchdog raises
    ``EngineStalled``. Non-negative and finite."""
    raw = os.environ.get("HOROVOD_SERVE_WATCHDOG_TIMEOUT")
    if raw is None or not raw.strip():
        return 0.0
    try:
        seconds = float(raw)
    except ValueError:
        raise ValueError(
            f"HOROVOD_SERVE_WATCHDOG_TIMEOUT must be a non-negative "
            f"number of seconds (0 disables), got {raw!r}") from None
    if seconds != seconds:  # NaN: the age comparison would never fire
        raise ValueError(
            f"HOROVOD_SERVE_WATCHDOG_TIMEOUT must be a non-negative "
            f"number of seconds (0 disables), got {raw!r}")
    if seconds < 0 or seconds == float("inf"):
        raise ValueError(
            f"HOROVOD_SERVE_WATCHDOG_TIMEOUT must be >= 0 and finite, "
            f"got {raw!r}")
    return seconds


def serve_min_accept() -> float:
    """``HOROVOD_SERVE_MIN_ACCEPT`` (default 0 = off): the speculative
    accept-rate floor in [0, 1]."""
    raw = os.environ.get("HOROVOD_SERVE_MIN_ACCEPT")
    if raw is None or not raw.strip():
        return 0.0
    try:
        frac = float(raw)
    except ValueError:
        raise ValueError(
            f"HOROVOD_SERVE_MIN_ACCEPT must be an acceptance fraction "
            f"in [0, 1] (0 disables), got {raw!r}") from None
    if frac != frac:  # NaN: the window comparison would never trigger
        raise ValueError(
            f"HOROVOD_SERVE_MIN_ACCEPT must be an acceptance fraction "
            f"in [0, 1] (0 disables), got {raw!r}")
    if frac < 0 or frac > 1:
        raise ValueError(
            f"HOROVOD_SERVE_MIN_ACCEPT must be in [0, 1], got {raw!r}")
    return frac


def validate_serving_knobs() -> None:
    """Read every ``HOROVOD_SERVE_*`` knob once, so a typo'd value raises
    at ``hvd.init`` instead of at the first request."""
    for read in (serve_block_size, serve_max_batch, serve_kv_dtype,
                 serve_prefix_cache, serve_speculate, serve_draft_kv_dtype,
                 serve_deadline_ms, serve_journal_path,
                 serve_watchdog_timeout, serve_min_accept):
        read()

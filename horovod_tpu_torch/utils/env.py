"""Environment-variable configuration — the knobs the port reads.

Same variable names as the reference, so job scripts carry over:
``HOROVOD_FUSION_THRESHOLD`` sizes the gradient fusion buffer (default
64 MB), ``HOROVOD_TIMELINE`` names a Chrome-tracing output file,
``HOROVOD_STALL_CHECK_TIME`` and ``HOROVOD_NEGOTIATION_TIMEOUT`` time the
negotiation's stall report and its wait for the coordinator
(``core/negotiate.py``), ``HOROVOD_SCHEDULE_TIMEOUT`` caps the coordinator's
wait for a program's schedules (``core/multihost.py``), the ``HOROVOD_SERVE_*`` knobs configure the
serving engine (``horovod_tpu_torch.serving``), ``HOROVOD_FAULT_INJECT``
arms the training, checkpoint and serving faults, ``HOROVOD_KV_RETRIES``
and ``HOROVOD_KV_BACKOFF_MS`` bound the store's retries and
``HOROVOD_LIVENESS_INTERVAL`` and ``HOROVOD_LIVENESS_TIMEOUT`` its
heartbeat and liveness judgement (``core/resilience.py``),
``HOROVOD_ELASTIC``, ``HOROVOD_ELASTIC_MIN_WORLD`` and
``HOROVOD_ELASTIC_JOIN_TIMEOUT`` turn on and bound the elastic shrink and
regrow (``core/elastic.py``), and
``HOROVOD_DATA_DIR`` and ``HOROVOD_PREFETCH_DEPTH`` place the datasets and
set how far the input pipeline prefetches (``training/data.py``),
``HOROVOD_SPARSE_PAD_CAPACITY`` pads the sparse gather wire and
``HOROVOD_SPARSE_DENSITY_THRESHOLD`` moves its density switch
(``ops/sparse.py``), and the gradient exchange's knobs pick its wire format
and decomposition: ``HOROVOD_COMPRESSION``, ``HOROVOD_COMPRESSION_BLOCK``,
``HOROVOD_COMPRESSION_CROSS_SLICE`` and ``HOROVOD_ERROR_FEEDBACK``
(``ops/compression.py``), ``HOROVOD_ALLREDUCE_ALGO`` and
``HOROVOD_EXCHANGE_CHANNELS`` (``ops/strategy.py``),
``HOROVOD_EXCHANGE_SCHEDULE`` and ``HOROVOD_MAX_CHANNELS``
(``ops/exchange.py``),
``HOROVOD_TOPOLOGY_SLICES`` (``ops/topology.py``) and
``HOROVOD_TUNING_CACHE`` (``utils/costs.py``), ``HOROVOD_SHARDING`` and
``HOROVOD_FSDP_AXIS_SIZE`` pick the ZeRO mode and its mesh
(``ops/mesh.py``), and profile-guided tuning and the device timeline read
``HOROVOD_PROFILE``, ``HOROVOD_TUNED_CONFIG``, ``HOROVOD_TUNE_BUDGET_S``
(``horovod_tpu_torch/tune``), ``HOROVOD_AUTOTUNE`` (the gradient path's
fusion threshold from the tuning cache), ``HOROVOD_RECALIBRATION``
(``ops/exchange.py``), ``HOROVOD_TIMELINE_DEVICE`` and
``HOROVOD_TIMELINE_DEVICE_INTERVAL`` (``core/timeline.py``,
``parallel/spmd.py``), and the protocol checker reads
``HOROVOD_MODEL_MAX_STATES`` and ``HOROVOD_MODEL_FAULTS``
(``analysis/model.py``, ``tools/hvd_model_torch.py``).

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
    "HOROVOD_ALLREDUCE_ALGO",
    "HOROVOD_AUTOTUNE",
    "HOROVOD_COMPRESSION",
    "HOROVOD_COMPRESSION_BLOCK",
    "HOROVOD_COMPRESSION_CROSS_SLICE",
    "HOROVOD_DATA_DIR",
    "HOROVOD_EAGER_CACHE",
    "HOROVOD_ELASTIC",
    "HOROVOD_ELASTIC_JOIN_TIMEOUT",
    "HOROVOD_ELASTIC_MIN_WORLD",
    "HOROVOD_ERROR_FEEDBACK",
    "HOROVOD_EXCHANGE_CHANNELS",
    "HOROVOD_EXCHANGE_SCHEDULE",
    "HOROVOD_FAULT_INJECT",
    "HOROVOD_FSDP_AXIS_SIZE",
    "HOROVOD_FUSION_THRESHOLD",
    "HOROVOD_KV_BACKOFF_MS",
    "HOROVOD_KV_RETRIES",
    "HOROVOD_LIVENESS_INTERVAL",
    "HOROVOD_LIVENESS_TIMEOUT",
    "HOROVOD_MAX_CHANNELS",
    "HOROVOD_MODEL_FAULTS",
    "HOROVOD_MODEL_MAX_STATES",
    "HOROVOD_NEGOTIATION_TIMEOUT",
    "HOROVOD_PREFETCH_DEPTH",
    "HOROVOD_PROFILE",
    "HOROVOD_RECALIBRATION",
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
    "HOROVOD_SHARDING",
    "HOROVOD_SPARSE_DENSITY_THRESHOLD",
    "HOROVOD_SPARSE_PAD_CAPACITY",
    "HOROVOD_STALL_CHECK_TIME",
    "HOROVOD_TIMELINE",
    "HOROVOD_TIMELINE_DEVICE",
    "HOROVOD_TIMELINE_DEVICE_INTERVAL",
    "HOROVOD_TOPOLOGY_SLICES",
    "HOROVOD_TUNED_CONFIG",
    "HOROVOD_TUNE_BUDGET_S",
    "HOROVOD_TUNING_CACHE",
})

# Knobs of the reference that change what a run computes, not ported yet:
# name -> (ROADMAP §A item, what it does, the values that leave it off).
# Set to anything else, each raises at hvd.init. Every one is ported.
UNPORTED_RESULT_KNOBS: dict[str, tuple[int, str, frozenset]] = {}

# Knobs of the reference that only tune timing or reporting, not ported
# yet: name -> ROADMAP §A item. Each would draw a warning at hvd.init.
# Every one is ported.
UNPORTED_TUNING_KNOBS: dict[str, int] = {}

# Knobs that only mean something under JAX: accepted, and nothing is said.
JAX_ONLY_KNOBS = frozenset({"HOROVOD_CPU_DEVICES", "HOROVOD_XLA_OPTIONS"})

# Faults of HOROVOD_FAULT_INJECT that the port does not inject yet: none
# (core/resilience.py injects every kind the grammar parses).
UNPORTED_FAULTS: frozenset = frozenset()

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


def timeline_device_mode() -> bool:
    """``HOROVOD_TIMELINE_DEVICE=1``: an ``spmd`` program's spans come from
    sampled executions under ``torch.profiler``, with device timestamps
    (``core/xprof.py``), instead of host stamps around a synchronised
    replay."""
    return os.environ.get("HOROVOD_TIMELINE_DEVICE", "") not in ("", "0")


def timeline_device_interval() -> int:
    """``HOROVOD_TIMELINE_DEVICE_INTERVAL=N``: in the device timeline mode,
    sample every N-th call of each program as well as the first. 0/unset =
    the first call only; an unparsable value is 0, as in the reference."""
    raw = os.environ.get("HOROVOD_TIMELINE_DEVICE_INTERVAL")
    if raw is None:
        return 0
    try:
        return max(0, int(raw))
    except ValueError:
        return 0


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


def eager_cache_enabled() -> bool:
    """``HOROVOD_EAGER_CACHE=0`` turns off the eager verdict replay
    (``core/negotiate.py``): every call then pays the full store round,
    which restores per-call desync detection. Default: on."""
    return os.environ.get("HOROVOD_EAGER_CACHE", "1") not in ("0",)


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
    value, or a ``HOROVOD_FAULT_INJECT`` spec with a fault of
    :data:`UNPORTED_FAULTS` (both empty now), raises
    ``NotImplementedError`` naming the ROADMAP §A item that ports it; a
    typo'd spec raises ``ValueError`` with the reference's text. A knob of
    :data:`UNPORTED_TUNING_KNOBS` draws a warning naming its item and the
    run goes on without it. The elastic and resilience knobs are parsed
    here, so a typo'd value raises at ``hvd.init`` as in the
    reference."""
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
                f"({fault.describe()}) is not injected by the port. A "
                f"drill that injects nothing would pass fault-free; drop "
                f"the entry.")
    for name, item in sorted(UNPORTED_TUNING_KNOBS.items()):
        if name in env:
            warnings.warn(
                f"{name} is set but not ported: ROADMAP §A item {item}. It "
                f"only tunes timing or reporting; the run goes on without "
                f"it.", stacklevel=2)


def sharding_mode() -> str:
    """``HOROVOD_SHARDING`` (default ``off``): the sharding mode that
    ``DistributedOptimizer`` and ``Trainer`` take for ``sharding=None`` —
    ``off`` (replicated), ``zero2`` (reduce-scattered gradients and
    optimizer state sharded 1/fsdp_size, replicated parameters) or
    ``zero3`` (the parameters sharded too, gathered on use;
    ``ops/mesh.py``, ``parallel/sharded.py``). A typo raises at
    ``hvd.init``."""
    raw = os.environ.get("HOROVOD_SHARDING")
    if raw is None:
        return "off"
    value = raw.strip().lower() or "off"
    if value not in ("off", "zero2", "zero3"):
        raise ValueError(
            f"HOROVOD_SHARDING must be off|zero2|zero3, got {raw!r}")
    return value


def fsdp_axis_size() -> int | None:
    """``HOROVOD_FSDP_AXIS_SIZE`` (default unset = auto): the size of the
    ``fsdp`` mesh axis of the zero2/zero3 modes (``ops/mesh.py``). Auto is
    one host on a multi-host topology (shards gather over NVLink while the
    ``data`` axis spans the hosts) and the whole group on one host; an
    override must divide the ranks of a host, which is checked where the
    mesh is built. A typo raises at ``hvd.init``."""
    raw = os.environ.get("HOROVOD_FSDP_AXIS_SIZE")
    if raw is None or not raw.strip():
        return None
    try:
        n = int(raw)
    except ValueError:
        raise ValueError(
            f"HOROVOD_FSDP_AXIS_SIZE must be a positive integer axis "
            f"size, got {raw!r}") from None
    if n < 1:
        raise ValueError(
            f"HOROVOD_FSDP_AXIS_SIZE must be >= 1, got {raw!r}")
    return n


def elastic_enabled() -> bool:
    """``HOROVOD_ELASTIC`` (default 0): turn a liveness-fatal during
    negotiation or a collective wait into an elastic shrink — survivors
    execute the ``plan_shrink`` contract (drop the dead ranks, re-elect the
    lowest survivor as coordinator, bump the KV generation, re-plan the
    exchange schedule) and ``Trainer.fit`` continues at the smaller world
    size instead of dying (``core/elastic.py``). Off by default: without
    this knob a dead peer stays a loud, diagnosable fatal. Values other
    than 0/1 raise at ``hvd.init``."""
    raw = os.environ.get("HOROVOD_ELASTIC")
    if raw is None or raw.strip() in ("", "0"):
        return False
    if raw.strip() == "1":
        return True
    raise ValueError(
        f"HOROVOD_ELASTIC must be 0 or 1, got {raw!r}")


def elastic_min_world() -> int:
    """``HOROVOD_ELASTIC_MIN_WORLD`` (default 1): the smallest world size
    an elastic shrink may continue at. A shrink that would leave fewer
    surviving ranks than this refuses to continue and re-raises the
    liveness fatal. Must be a positive integer; typos raise at
    ``hvd.init``."""
    raw = os.environ.get("HOROVOD_ELASTIC_MIN_WORLD")
    if raw is None or not raw.strip():
        return 1
    try:
        n = int(raw)
    except ValueError:
        raise ValueError(
            f"HOROVOD_ELASTIC_MIN_WORLD must be a positive integer world "
            f"size, got {raw!r}") from None
    if n < 1:
        raise ValueError(
            f"HOROVOD_ELASTIC_MIN_WORLD must be >= 1, got {raw!r}")
    return n


def elastic_join_timeout_seconds() -> float:
    """``HOROVOD_ELASTIC_JOIN_TIMEOUT`` (seconds; default 0 = no window):
    how long the coordinator holds a regrow step boundary open for
    announced joiners before admitting whoever has arrived
    (``core/elastic.py``). The default of 0 admits only joiners already
    announced at the boundary. Unparsable, negative or infinite values
    raise at ``hvd.init``."""
    raw = os.environ.get("HOROVOD_ELASTIC_JOIN_TIMEOUT")
    if raw is None or not raw.strip():
        return 0.0
    try:
        seconds = float(raw)
    except ValueError:
        seconds = float("nan")
    if seconds != seconds:
        raise ValueError(
            f"HOROVOD_ELASTIC_JOIN_TIMEOUT must be a number of seconds, "
            f"got {raw!r}")
    if seconds < 0:
        raise ValueError(
            f"HOROVOD_ELASTIC_JOIN_TIMEOUT must be >= 0 (0 admits only "
            f"already-announced joiners), got {raw!r}")
    if seconds == float("inf"):
        raise ValueError(
            f"HOROVOD_ELASTIC_JOIN_TIMEOUT must be finite (an unbounded "
            f"join window would hold every step boundary forever), "
            f"got {raw!r}")
    return seconds


def kv_retries() -> int:
    """``HOROVOD_KV_RETRIES`` (default 3): the bounded retry budget for a
    TRANSIENT store fault on any store call (``core/resilience.py``).
    Pending poll timeouts are not retried here (the caller's poll loop
    owns them) and fatal errors never are. Unparsable values raise."""
    raw = os.environ.get("HOROVOD_KV_RETRIES")
    if raw is None:
        return 3
    try:
        return max(0, int(raw))
    except ValueError:
        raise ValueError(
            f"HOROVOD_KV_RETRIES must be an integer retry count, "
            f"got {raw!r}") from None


def kv_backoff_ms() -> float:
    """``HOROVOD_KV_BACKOFF_MS`` (default 50): the base backoff between
    store retries. The schedule is decorrelated jitter — ``sleep =
    uniform(base, prev*3)`` capped at ``base*64``. Unparsable values
    raise."""
    raw = os.environ.get("HOROVOD_KV_BACKOFF_MS")
    if raw is None:
        return 50.0
    try:
        ms = float(raw)
    except ValueError:
        ms = float("nan")
    if ms != ms:
        raise ValueError(
            f"HOROVOD_KV_BACKOFF_MS must be a number of milliseconds, "
            f"got {raw!r}")
    return max(1.0, ms)


def liveness_interval_seconds() -> float:
    """``HOROVOD_LIVENESS_INTERVAL`` (seconds, default 10; 0 disables): how
    often each process of a multi-process world publishes its heartbeat
    key ``hvd/hb/g<generation>/p<rank>`` (``core/resilience.py``).
    Unparsable values raise."""
    raw = os.environ.get("HOROVOD_LIVENESS_INTERVAL")
    if raw is None:
        return 10.0
    try:
        seconds = float(raw)
    except ValueError:
        seconds = float("nan")
    if seconds != seconds:
        raise ValueError(
            f"HOROVOD_LIVENESS_INTERVAL must be a number of seconds, "
            f"got {raw!r}")
    return max(0.0, seconds)


def liveness_timeout_seconds() -> float:
    """``HOROVOD_LIVENESS_TIMEOUT`` (seconds; default 0 = disabled): a peer
    whose last heartbeat is older than this is declared dead, turning
    every blocking negotiation / schedule-validation wait, and a
    collective that lost its peer, into a fatal error naming the dead
    rank(s) instead of an indefinite hang. It also bounds the process
    groups' own waits (``core/state.py``). Unparsable values raise."""
    raw = os.environ.get("HOROVOD_LIVENESS_TIMEOUT")
    if raw is None:
        return 0.0
    try:
        seconds = float(raw)
    except ValueError:
        seconds = float("nan")
    if seconds != seconds:
        raise ValueError(
            f"HOROVOD_LIVENESS_TIMEOUT must be a number of seconds, "
            f"got {raw!r}")
    if seconds <= 0 or seconds == float("inf"):
        return 0.0
    return seconds


def validate_resilience_knobs() -> None:
    """Parse the elastic and resilience knobs once at ``hvd.init``, so a
    typo'd value raises there, as the reference's ``init`` does."""
    elastic_enabled()
    elastic_min_world()
    elastic_join_timeout_seconds()
    kv_retries()
    kv_backoff_ms()
    liveness_interval_seconds()
    liveness_timeout_seconds()


def validate_sharding_knobs() -> None:
    """The reference's ``hvd.init`` checks of the sharding knobs: both
    parsed (a typo raises), then sharding with ``HOROVOD_ELASTIC=1``
    refused with its text: the elastic shrink and regrow re-replicate the
    training state."""
    from horovod_tpu_torch.core.state import HorovodError

    mode = sharding_mode()
    fsdp_axis_size()
    if elastic_enabled() and mode != "off":
        raise HorovodError(
            f"HOROVOD_ELASTIC=1 is incompatible with "
            f"HOROVOD_SHARDING={mode}: the elastic "
            f"shrink/regrow path re-replicates training state and "
            f"would desync sharded (ZeRO-2/3) layouts on reshard. "
            f"Use the replicated path (HOROVOD_SHARDING=off) with "
            f"elastic training, or drop HOROVOD_ELASTIC for "
            f"sharded runs.")


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


# -- the gradient exchange's knobs (ops/compression.py, ops/strategy.py) ------


def compression_default() -> str:
    """``HOROVOD_COMPRESSION``: the default wire compression of the
    *gradient* path (``allreduce_gradients`` / ``DistributedOptimizer``
    with ``compression=None``) — ``none`` (default), ``bf16``, ``int8``,
    ``int8_block`` or ``int4`` (``ops/compression.py``). Raw
    ``hvd.allreduce`` calls never read it. An unknown value raises at the
    first compressed exchange (``compression.resolve``)."""
    raw = os.environ.get("HOROVOD_COMPRESSION")
    if raw is None:
        return "none"
    return raw.strip().lower() or "none"


def compression_block() -> int:
    """``HOROVOD_COMPRESSION_BLOCK`` (default 256): elements per scale
    block of ``int8_block``/``int4``. A positive even integer >= 8 (int4
    packs two elements per wire byte); a typo raises at ``hvd.init``."""
    raw = os.environ.get("HOROVOD_COMPRESSION_BLOCK")
    if raw is None or not raw.strip():
        return 256
    try:
        n = int(raw)
    except ValueError:
        raise ValueError(
            f"HOROVOD_COMPRESSION_BLOCK must be an even element count "
            f">= 8, got {raw!r}") from None
    if n < 8 or n % 2:
        raise ValueError(
            f"HOROVOD_COMPRESSION_BLOCK must be an even element count "
            f">= 8 (int4 packs two elements per wire byte), got {raw!r}")
    return n


def error_feedback_default() -> bool:
    """``HOROVOD_ERROR_FEEDBACK`` (default 0): ``DistributedOptimizer``
    keeps each rank's quantization residual and adds it back before the
    next step's compression. 0 or 1; anything else raises at
    ``hvd.init``."""
    raw = os.environ.get("HOROVOD_ERROR_FEEDBACK")
    if raw is None or raw.strip() in ("", "0"):
        return False
    if raw.strip() == "1":
        return True
    raise ValueError(
        f"HOROVOD_ERROR_FEEDBACK must be 0 or 1, got {raw!r}")


def compression_cross_slice_default() -> str | None:
    """``HOROVOD_COMPRESSION_CROSS_SLICE``: the wire format of the
    hierarchical decomposition's cross-host hop on the gradient path
    (``compression.resolve_phase_formats``); unset = the bucket
    compressor's own policy, and an explicit ``none`` pins the hop to the
    uncompressed dtype. Unknown names raise at ``hvd.init``."""
    raw = os.environ.get("HOROVOD_COMPRESSION_CROSS_SLICE")
    if raw is None or not raw.strip():
        return None
    value = raw.strip().lower()
    from horovod_tpu_torch.ops import compression as _compression

    if value not in _compression.registered_names():
        raise ValueError(
            f"HOROVOD_COMPRESSION_CROSS_SLICE must be one of "
            f"{sorted(_compression.registered_names())}, got {raw!r}")
    return value


def allreduce_algo_default() -> str:
    """``HOROVOD_ALLREDUCE_ALGO``: the default decomposition of the
    gradient path's buckets — ``flat`` (default), ``rs_ag``,
    ``hierarchical`` or ``auto`` (``ops/strategy.py``). Raw
    ``hvd.allreduce`` calls never read it. Typos raise."""
    raw = os.environ.get("HOROVOD_ALLREDUCE_ALGO")
    if raw is None:
        return "flat"
    value = raw.strip().lower() or "flat"
    if value not in ("flat", "rs_ag", "hierarchical", "auto"):
        raise ValueError(
            f"HOROVOD_ALLREDUCE_ALGO must be one of flat|rs_ag|"
            f"hierarchical|auto, got {raw!r}")
    return value


def exchange_channels_default() -> int | None:
    """``HOROVOD_EXCHANGE_CHANNELS``: the channel count of every eligible
    gradient bucket (``ops/strategy.py``); unset = 1. A positive integer;
    a typo raises at ``hvd.init``."""
    raw = os.environ.get("HOROVOD_EXCHANGE_CHANNELS")
    if raw is None or not raw.strip():
        return None
    try:
        n = int(raw)
    except ValueError:
        raise ValueError(
            f"HOROVOD_EXCHANGE_CHANNELS must be a positive integer "
            f"channel count, got {raw!r}") from None
    if n < 1:
        raise ValueError(
            f"HOROVOD_EXCHANGE_CHANNELS must be >= 1, got {raw!r}")
    return n


def exchange_schedule_default() -> str:
    """``HOROVOD_EXCHANGE_SCHEDULE``: the gradient path's exchange schedule
    when ``schedule=None`` (``ops/exchange.py``): ``enum`` (default: the
    enumeration plan) or ``priority`` (reverse-layer issue order with
    per-region bucket sizing). Typos raise."""
    raw = os.environ.get("HOROVOD_EXCHANGE_SCHEDULE")
    if raw is None:
        return "enum"
    value = raw.strip().lower() or "enum"
    if value not in ("enum", "priority"):
        raise ValueError(
            f"HOROVOD_EXCHANGE_SCHEDULE must be enum|priority, got {raw!r}")
    return value


def max_channels() -> int:
    """``HOROVOD_MAX_CHANNELS`` (default 1 = channelization off): the cap
    of the exchange planner's per-bucket channel choice, the cheapest
    power-of-two count up to it by the per-channel α–β model
    (``ops/exchange.py``). A positive integer; a typo raises at
    ``hvd.init``."""
    raw = os.environ.get("HOROVOD_MAX_CHANNELS")
    if raw is None or not raw.strip():
        return 1
    try:
        n = int(raw)
    except ValueError:
        raise ValueError(
            f"HOROVOD_MAX_CHANNELS must be a positive integer channel "
            f"cap, got {raw!r}") from None
    if n < 1:
        raise ValueError(
            f"HOROVOD_MAX_CHANNELS must be >= 1, got {raw!r}")
    return n


def topology_slices() -> int:
    """``HOROVOD_TOPOLOGY_SLICES=N``: treat a group as N equal contiguous
    slices (hosts) instead of reading them off ``LOCAL_WORLD_SIZE``
    (``ops/topology.py``). 0/unset = discovered. Typos raise."""
    raw = os.environ.get("HOROVOD_TOPOLOGY_SLICES")
    if raw is None or not raw.strip():
        return 0
    try:
        n = int(raw)
    except ValueError:
        raise ValueError(
            f"HOROVOD_TOPOLOGY_SLICES must be an integer slice count, "
            f"got {raw!r}") from None
    if n < 0:
        raise ValueError(
            f"HOROVOD_TOPOLOGY_SLICES must be >= 0, got {raw!r}")
    return n


def sparse_density_threshold() -> float | None:
    """``HOROVOD_SPARSE_DENSITY_THRESHOLD``: the sparse exchange's
    ``algo='auto'`` densifies once gathered rows / table rows reach it
    (``ops/sparse.py``); unset = the cost model's crossover
    (``utils/costs.py``). A positive number (``inf`` pins the gather);
    typos and non-positive values raise at ``hvd.init``."""
    raw = os.environ.get("HOROVOD_SPARSE_DENSITY_THRESHOLD")
    if raw is None or not raw.strip():
        return None
    try:
        value = float(raw)
    except ValueError:
        value = float("nan")
    if value != value:  # unparsable or NaN: refuse, never silently auto
        raise ValueError(
            f"HOROVOD_SPARSE_DENSITY_THRESHOLD must be a positive density "
            f"fraction (gathered rows / table rows), got {raw!r}")
    if value <= 0:
        raise ValueError(
            f"HOROVOD_SPARSE_DENSITY_THRESHOLD must be > 0 (a zero "
            f"threshold would silently densify every sparse exchange), "
            f"got {raw!r}")
    return value


def tuning_cache_path() -> str:
    """``HOROVOD_TUNING_CACHE``: the allreduce tuning cache the cost model
    reads (``utils/costs.py``). Default
    ``~/.horovod_tpu_torch/allreduce_tuning.json``."""
    return os.environ.get(
        "HOROVOD_TUNING_CACHE",
        os.path.join(os.path.expanduser("~"), ".horovod_tpu_torch",
                     "allreduce_tuning.json"))


def recalibration_enabled() -> bool:
    """``HOROVOD_RECALIBRATION`` (default 1): feed measured collective
    spans of the device timeline back into the α–β constants through the
    tuning cache (``ops/exchange.py::Recalibrator``). ``0`` disables.
    Values other than 0/1 raise."""
    raw = os.environ.get("HOROVOD_RECALIBRATION")
    if raw is None or raw.strip() in ("", "1"):
        return True
    if raw.strip() == "0":
        return False
    raise ValueError(
        f"HOROVOD_RECALIBRATION must be 0 or 1, got {raw!r}")


def autotune_enabled() -> bool:
    """``HOROVOD_AUTOTUNE=1``: the gradient path's fusion threshold comes
    from the tuning cache (``utils/costs.py::tuned_fusion_threshold``)
    when neither ``fusion_threshold=`` nor ``HOROVOD_FUSION_THRESHOLD``
    pins it. Off by default: rebucketing changes which tensors share a
    compression scale. Values other than 0/1 raise."""
    raw = os.environ.get("HOROVOD_AUTOTUNE")
    if raw is None or raw.strip() in ("", "0"):
        return False
    if raw.strip() == "1":
        return True
    raise ValueError(
        f"HOROVOD_AUTOTUNE must be 0 or 1, got {raw!r}")


def profile_mode() -> str | None:
    """``HOROVOD_PROFILE``: ``auto`` runs one bounded ``hvd.tune()`` pass
    at the end of ``hvd.init`` (``horovod_tpu_torch/tune``) and applies
    what it commits; ``off``/unset does nothing. Typos raise at
    ``hvd.init``."""
    raw = os.environ.get("HOROVOD_PROFILE")
    if raw is None or not raw.strip():
        return None
    value = raw.strip().lower()
    if value == "off":
        return None
    if value != "auto":
        raise ValueError(
            f"HOROVOD_PROFILE must be auto or off, got {raw!r}")
    return value


def tune_budget_seconds() -> float:
    """``HOROVOD_TUNE_BUDGET_S`` (default 30): the wall-clock budget of
    one calibration pass, seconds. The pass always completes its two-size
    sweep and stops adding measurements once the budget is spent. Positive
    and finite; typos, NaN and non-positive values raise at
    ``hvd.init``."""
    raw = os.environ.get("HOROVOD_TUNE_BUDGET_S")
    if raw is None or not raw.strip():
        return 30.0
    try:
        seconds = float(raw)
    except ValueError:
        raise ValueError(
            f"HOROVOD_TUNE_BUDGET_S must be a positive number of "
            f"seconds, got {raw!r}") from None
    if seconds != seconds:  # NaN: every comparison below would be False
        raise ValueError(
            f"HOROVOD_TUNE_BUDGET_S must be a positive number of "
            f"seconds, got {raw!r}")
    if seconds <= 0 or seconds == float("inf"):
        raise ValueError(
            f"HOROVOD_TUNE_BUDGET_S must be > 0 and finite, got {raw!r}")
    return seconds


def tuned_config_path() -> str | None:
    """``HOROVOD_TUNED_CONFIG``: a committed ``.tuned.json`` (its sibling
    ``.exchange.json`` beside it) that ``hvd.init`` verifies and applies;
    ``hvd.tune()`` also commits there when it is set. The path must end in
    ``.tuned.json``; other suffixes raise at ``hvd.init``."""
    raw = os.environ.get("HOROVOD_TUNED_CONFIG")
    if raw is None or not raw.strip():
        return None
    path = raw.strip()
    if not path.endswith(".tuned.json"):
        raise ValueError(
            f"HOROVOD_TUNED_CONFIG must name a .tuned.json artifact "
            f"(the hvd-lint dispatch suffix), got {raw!r}")
    return path


def validate_tuning_knobs() -> None:
    """Read the tuning and analysis knobs whose typos the reference
    refuses at ``hvd.init``."""
    for read in (profile_mode, tune_budget_seconds, tuned_config_path,
                 model_max_states, model_faults):
        read()


def model_max_states() -> int:
    """``HOROVOD_MODEL_MAX_STATES`` (default 200000): cap on the state
    count the ``hvd-model`` protocol checker explores per world
    (analysis/model.py; tools/hvd_model_torch.py). Exceeding the cap is an
    ERROR (exit 2), never a silent truncation — a sweep that did not
    finish must not pass as "protocol clean". Must be a positive integer;
    typos raise at ``hvd.init`` (the newer-knob convention)."""
    raw = os.environ.get("HOROVOD_MODEL_MAX_STATES")
    if raw is None or not raw.strip():
        from horovod_tpu_torch.analysis import model as _model

        return _model.DEFAULT_MAX_STATES
    try:
        n = int(raw)
    except ValueError:
        raise ValueError(
            f"HOROVOD_MODEL_MAX_STATES must be a positive integer state "
            f"cap, got {raw!r}") from None
    if n < 1:
        raise ValueError(
            f"HOROVOD_MODEL_MAX_STATES must be >= 1, got {raw!r}")
    return n


def model_faults() -> str | None:
    """``HOROVOD_MODEL_FAULTS``: extra fault spec added to the
    ``hvd-model`` sweep matrix (tools/hvd_model_torch.py; the fault-drill
    preflight passes the drill's own injection spec the same way). Uses
    the ``HOROVOD_FAULT_INJECT`` grammar — parsed through the same
    ``analysis.protocol.parse_fault_spec`` the live injector uses, so a
    typo'd spec raises at ``hvd.init`` instead of silently sweeping a
    fault-free matrix that then "passes"."""
    raw = os.environ.get("HOROVOD_MODEL_FAULTS")
    if raw is None or not raw.strip():
        return None
    from horovod_tpu_torch.analysis import protocol as _proto

    _proto.parse_fault_spec(raw)  # typos raise here, at init
    return raw


def validate_exchange_knobs() -> None:
    """Read the exchange knobs whose typos the reference refuses at
    ``hvd.init`` (the others raise at their first use, as there)."""
    for read in (compression_block, error_feedback_default,
                 compression_cross_slice_default, exchange_channels_default,
                 max_channels, sparse_density_threshold):
        read()


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

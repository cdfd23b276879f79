"""Environment-variable configuration — the main-path knobs.

Same variable names as the reference (``HOROVOD_FUSION_THRESHOLD`` sizes the
gradient fusion buffer, default 64 MB; ``HOROVOD_TIMELINE`` names a
Chrome-tracing output file), so job scripts carry over. The port reads only
these two; any other ``HOROVOD_*`` variable in the environment is most likely
a typo'd knob name and draws a warning at ``hvd.init``.
"""

from __future__ import annotations

import os
import warnings

DEFAULT_FUSION_THRESHOLD = 64 * 1024 * 1024  # bytes

KNOWN_ENV_VARS = frozenset({
    "HOROVOD_FUSION_THRESHOLD",
    "HOROVOD_TIMELINE",
})


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

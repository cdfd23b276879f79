"""Launch counts of the port's kernels, CUDA graph replays included.

Each kernel module counts its wrapper's launches in its own ``LAUNCHES``
dict through :func:`count`. A wrapper called while a CUDA graph is being
captured launches nothing: the capture records the kernel, and the graph
launches it at every replay. So :func:`recording` collects what a capture
records, and :func:`replayed` counts it once a replay
(``parallel/spmd.py`` does both). :data:`KERNELS` names the device
functions behind each wrapper.
"""

from __future__ import annotations

import contextlib

import torch

# The device functions each wrapper launches, the one a launch counts
# first: what a profiler session (``core/xprof.py::kernel_spans``) names.
KERNELS = {
    "channel_sums": ("channel_sums_ring_kernel",),
    "channel_grad_sums": ("channel_grad_sums_kernel", "finalize_kernel"),
    "flash_fwd": ("flash_fwd_kernel",),
    "flash_bwd": ("flash_bwd_dkdv_kernel", "flash_bwd_dq_kernel"),
    "adamw": ("adamw_kernel",),
    "ce_chunk_fwd": ("ce_chunk_fwd_kernel",),
    "ce_chunk_bwd": ("ce_chunk_bwd_kernel",),
}

_recorded: list | None = None


def count(launches: dict, name: str) -> None:
    """One call of kernel ``name``'s wrapper on the card: a launch, counted
    in ``launches`` now; under a capture a graph node, counted at each
    replay of the graph (when :func:`recording` collects it)."""
    if torch.cuda.is_current_stream_capturing():
        if _recorded is not None:
            _recorded.append((launches, name))
    else:
        launches[name] += 1


@contextlib.contextmanager
def recording():
    """Collect the kernels the wrappers record inside the block: yields the
    list :func:`replayed` takes."""
    global _recorded
    outer, _recorded = _recorded, []
    try:
        yield _recorded
    finally:
        _recorded = outer


def replayed(recorded: list) -> None:
    """Count one replay of a graph whose capture recorded ``recorded``."""
    for launches, name in recorded:
        launches[name] += 1

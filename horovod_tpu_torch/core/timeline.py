"""Horovod Timeline — a Chrome-tracing record of collective activity.

Counterpart of ``horovod_tpu/core/timeline.py``'s Python writer, enabled by
``HOROVOD_TIMELINE=<file>`` and written by rank 0 only. Every tensor is a
trace "process" row; phases are B/E events with µs timestamps on the host
clock, and the file flushes at most once a second. Activity names:

    NEGOTIATE_<OP>           requests exchanged → all ranks matched
    <rank>                   per-rank ready tick inside NEGOTIATE_<OP>
    MEMCPY_IN_FUSION_BUFFER  pack a fusion bucket into its flat buffer
    ALLREDUCE / ALLGATHER / BROADCAST / GATHER
                             the collective itself
    MEMCPY_OUT_FUSION_BUFFER unpack

On the GPU these are enqueue times: the host stamps them around calls that
return before the device finishes.
"""

from __future__ import annotations

import atexit
import json
import threading
import time

from horovod_tpu_torch.utils import env as _env


class _PyTimeline:
    """The JSON writer."""

    def __init__(self, path: str):
        self._f = open(path, "w")
        self._f.write("[\n")
        self._pids: dict[str, int] = {}
        self._t0 = time.monotonic_ns() // 1000
        self._last_flush = time.monotonic()
        self._lock = threading.Lock()
        self._closed = False
        atexit.register(self.close)

    def _pid(self, tensor: str) -> int:
        pid = self._pids.get(tensor)
        if pid is None:
            pid = len(self._pids) + 1
            self._pids[tensor] = pid
            self._f.write(json.dumps({
                "name": "process_name", "ph": "M", "pid": pid,
                "args": {"name": tensor}}) + ",\n")
            self._f.write(json.dumps({
                "name": "process_sort_index", "ph": "M", "pid": pid,
                "args": {"sort_index": pid}}) + ",\n")
        return pid

    def event(self, tensor: str, activity: str, phase: str) -> None:
        with self._lock:
            if self._closed:
                return
            ts = time.monotonic_ns() // 1000 - self._t0
            ev = {"name": activity, "ph": phase, "ts": ts,
                  "pid": self._pid(tensor)}
            if phase == "X":
                ev["dur"] = 0
            self._f.write(json.dumps(ev) + ",\n")
            now = time.monotonic()
            if now - self._last_flush > 1.0:
                self._f.flush()
                self._last_flush = now

    def close(self) -> None:
        """Flush and close; idempotent."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._f.flush()
            self._f.close()
        atexit.unregister(self.close)


class Timeline:
    """The session timeline; inactive until :meth:`start`."""

    def __init__(self) -> None:
        self._py: _PyTimeline | None = None

    def start(self, path: str) -> None:
        if self._py is None:
            self._py = _PyTimeline(path)

    def event(self, tensor: str, activity: str, phase: str) -> None:
        if self._py is not None:
            self._py.event(tensor, activity, phase)

    def rank_ready(self, tensor: str, rank: int) -> None:
        """Per-rank negotiation-ready tick on the tensor's row."""
        self.event(tensor, str(rank), "X")

    def start_activity(self, tensor: str, activity: str) -> None:
        self.event(tensor, activity, "B")

    def end_activity(self, tensor: str, activity: str) -> None:
        self.event(tensor, activity, "E")

    def stop(self) -> None:
        if self._py is not None:
            self._py.close()
            self._py = None


_session = Timeline()


def session() -> Timeline:
    return _session


def maybe_start() -> None:
    """Start the timeline if ``HOROVOD_TIMELINE`` is set."""
    path = _env.timeline_path()
    if path:
        _session.start(path)


def stop() -> None:
    _session.stop()


class activity:
    """Context manager: one B/E activity span on a tensor's row."""

    def __init__(self, tensor: str, name: str) -> None:
        self._tensor = tensor
        self._name = name

    def __enter__(self):
        _session.start_activity(self._tensor, self._name)
        return self

    def __exit__(self, *exc):
        _session.end_activity(self._tensor, self._name)

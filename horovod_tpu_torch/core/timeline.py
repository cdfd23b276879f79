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

An ``spmd`` program (``parallel/spmd.py``) adds, when it is recorded, a
TRACE_AND_COMPILE span on its ``_program/<tag>`` row and a NEGOTIATE_<OP>
span on each row of its schedule; and on every later run, GRAPH_<OP> spans
on those rows, opened before the run and closed once the device is done
with it (the reference names them XLA_<OP>).

The serving engine writes one ``serving`` row: PREFILL and DECODE spans
around its two forwards, and instant ticks ADMIT (a request took a slot),
EVICT (finished or preempted), DEADLINE (evicted or refused past its
deadline), SHED (the load-shedding latch closed), STALL (the watchdog
convicted a dispatch) and RECOVER (a journaled request resumed).

On the GPU these are enqueue times: the host stamps them around calls that
return before the device finishes.

With ``HOROVOD_TIMELINE_DEVICE=1`` (latched when the timeline starts) a
program's runs are sampled instead (``parallel/spmd.py``): its first call,
and every N-th with ``HOROVOD_TIMELINE_DEVICE_INTERVAL=N``, runs under
``torch.profiler``, and the device's kernels, mapped onto the schedule by
``core/xprof.py``, enter the file through :meth:`Timeline.event_at` with
device timestamps: DEVICE_STEP on the ``_device`` row, XLA_<OP> on each
collective's row and its members' rows, and MEMCPY_IN/OUT_FUSION_BUFFER
on ``_fusion_buffer``. A sampled call whose session holds no device event
(the CPU) leaves an instant NO_DEVICE_PLANE on ``_device``. Unsampled calls
write nothing and wait for nothing. ``hvd.tune``'s activation writes an
instant tick on the ``tune`` row.
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

    def event_at(self, tensor: str, activity: str, ts_us: float,
                 dur_us: float) -> None:
        """A complete ('X') event at an explicit host-monotonic timestamp
        (µs): how device spans enter the file."""
        with self._lock:
            if self._closed:
                return
            self._f.write(json.dumps({
                "name": activity, "ph": "X",
                "ts": round(ts_us - self._t0, 3),
                "dur": round(dur_us, 3),
                "pid": self._pid(tensor)}) + ",\n")

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
        self._device_mode = False

    @property
    def active(self) -> bool:
        return self._py is not None

    def start(self, path: str) -> None:
        if self._py is None:
            # Latched here: flipping HOROVOD_TIMELINE_DEVICE later cannot
            # switch a running timeline's mode.
            self._device_mode = _env.timeline_device_mode()
            self._py = _PyTimeline(path)

    @property
    def device_mode(self) -> bool:
        """Whether ``HOROVOD_TIMELINE_DEVICE=1`` was set when the timeline
        started (before it starts: the live variable): programs' spans then
        come from sampled profiler sessions with device timestamps."""
        if self._py is not None:
            return self._device_mode
        return _env.timeline_device_mode()

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

    def event_at(self, tensor: str, activity: str, ts_us: float,
                 dur_us: float) -> None:
        """A complete event at an explicit host-monotonic timestamp (a
        device span). Only the device mode writes them: in host mode the
        span is dropped with a warning."""
        if self._py is None:
            return
        if not self._device_mode:
            import warnings

            warnings.warn(
                "Timeline.event_at called while the timeline is in host "
                "mode (HOROVOD_TIMELINE_DEVICE was not set when the "
                "timeline started) — device-true span dropped. Set the "
                "variable before horovod_tpu_torch.init().", stacklevel=2)
            return
        self._py.event_at(tensor, activity, ts_us, dur_us)

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

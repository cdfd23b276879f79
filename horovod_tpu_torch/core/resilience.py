"""Fault injection — the part of ``horovod_tpu/core/resilience.py`` that
the serving engine and the checkpoint writer read.

``HOROVOD_FAULT_INJECT="engine_crash@step=5;stuck_decode@step=3,ms=9000"``
threads synthetic faults through ``Engine.step`` (``serving/engine.py``):

* ``engine_crash@step=S`` — hard ``os._exit(CRASH_EXIT_CODE)`` at engine
  step S, the stand-in for a killed serving process (the journal's last
  per-step flush is what ``Engine.recover`` replays);
* ``stuck_decode@step=S[,ms=M]`` — the watchdog's open stamp is aged by M
  ms and judged, so the conviction is immediate and never a real hang;
* ``deadline_storm@step=S`` — every in-flight deadline expires at step S.

``torn_write@epoch=N`` leaves the checkpoint of epoch N truncated under
its final name (``training/checkpoint.py::_atomic_write``), the artifact a
writer killed mid-write leaves, so the resume scan's fall-back is
drillable.

The grammar is the reference's (``analysis/protocol.py::parse_fault_spec``):
a typo'd spec raises instead of running a fault-free drill. The other
training faults (``kv_timeout``, ``crash``, ``regrow``) parse, and
``hvd.init`` refuses them: nothing in the port injects them yet (ROADMAP
§A item 15).
"""

from __future__ import annotations

import os
import threading

from horovod_tpu_torch.analysis import protocol as _proto

# The exit code an injected crash dies with — distinct from Python's 1 so a
# drill can tell an injected crash from an ordinary error.
CRASH_EXIT_CODE = 43

Fault = _proto.Fault
parse_fault_spec = _proto.parse_fault_spec


class FaultInjector:
    """The parsed ``HOROVOD_FAULT_INJECT`` spec, with consume-once matching
    of the serving faults and of ``torn_write``."""

    def __init__(self, faults: tuple[Fault, ...] = ()):
        self._faults = tuple(faults)
        self._serve_consumed: set[int] = set()
        self._consumed: set[int] = set()
        self._lock = threading.Lock()

    @property
    def active(self) -> bool:
        return bool(self._faults)

    def serve_fault_due(self, kind: str, step: int,
                        span: int = 1) -> Fault | None:
        """The matching serving-engine fault (``engine_crash``,
        ``stuck_decode``, ``deadline_storm``) for engine steps ``step <= s
        < step + span``, consumed once — a deadline storm hits exactly one
        step boundary, and a stuck decode must not re-freeze the restarted
        engine."""
        with self._lock:
            f = _proto.serve_fault_matching(self._faults, kind, step, span)
            if f is None:
                return None
            i = self._faults.index(f)
            if i in self._serve_consumed:
                return None
            self._serve_consumed.add(i)
            return f

    def torn_write_due(self, epoch: int | None) -> bool:
        """True exactly once for a ``torn_write`` fault matching ``epoch``
        (consume-once: a retried save of the same epoch succeeds; the
        matcher is protocol.torn_write_index, this injector owns only the
        consumed set)."""
        with self._lock:
            i = _proto.torn_write_index(self._faults, epoch, self._consumed)
            if i is not None:
                self._consumed.add(i)
                return True
        return False


_injector: FaultInjector | None = None
_injector_lock = threading.Lock()


def injector() -> FaultInjector:
    """The process's injector, parsed from ``HOROVOD_FAULT_INJECT`` on first
    use (the env is read once; :func:`reset_injector` re-reads it)."""
    global _injector
    with _injector_lock:
        if _injector is None:
            _injector = FaultInjector(
                parse_fault_spec(os.environ.get("HOROVOD_FAULT_INJECT")))
        return _injector


def reset_injector() -> None:
    """Drop the cached injector so the next :func:`injector` re-reads the
    environment."""
    global _injector
    with _injector_lock:
        _injector = None

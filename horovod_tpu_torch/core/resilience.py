"""Fault tolerance: store retry, heartbeat and liveness, fault injection.

Counterpart of ``horovod_tpu/core/resilience.py``. A synchronous job
wedges on one stalled or dead rank; this module turns those hangs into
bounded, diagnosable failures, over the world's key-value store
(``core/negotiate.py``'s, a ``torch.distributed`` store) where the
reference uses the JAX coordination service:

* **Error classification** (:func:`classify_kv_error`): a *pending* poll
  timeout (the key is not set yet: the caller's poll loop handles it), a
  *transient* store fault (retry with backoff) and a *fatal* one (fail
  now) — ``protocol.classify_kv_message``, the reference's table plus
  torch's store messages.
* **Bounded retry with decorrelated-jitter backoff** (:func:`kv_get`,
  :func:`kv_set`, :func:`kv_call`): every store call of the negotiation
  goes through it, so a transient fault costs ``HOROVOD_KV_RETRIES``
  backed-off attempts instead of the job; each retry is a ``RETRY``
  activity on the timeline's ``coordination`` row.
* **Heartbeat and liveness** (:class:`Heartbeat`, :class:`Liveness`): each
  process of a multi-process world publishes ``hvd/hb/g<generation>/
  p<rank>`` on a daemon ticker; the blocking waits consult the registry
  (opt-in via ``HOROVOD_LIVENESS_TIMEOUT``), so a wait on a dead peer
  becomes :class:`WorkerLost` naming it, its ranks and its last-seen
  age. A collective whose peer went away (a gloo "Connection closed by
  peer", a timed-out process group) is judged the same way
  (:func:`judge_peer_loss`).
* **Deterministic fault injection** (:func:`injector`):
  ``HOROVOD_FAULT_INJECT="kv_timeout@seq=3;crash@rank=1,step=5;
  regrow@step=9;torn_write@epoch=2"`` threads synthetic faults through the
  store calls (``kv_timeout``), the training loop (``crash``, ``regrow``),
  the checkpoint writer (``torn_write``) and the serving engine
  (``engine_crash``, ``stuck_decode``, ``deadline_storm``).

A process is one rank here, so a rank-targeted ``crash`` always ends its
process (exit 43); under ``HOROVOD_ELASTIC=1`` the other members read the
same spec and raise :class:`WorkerLost` for it at the same call boundary
(:func:`maybe_crash`), which is when the reference's in-process survivors
observe the loss.
"""

from __future__ import annotations

import json
import os
import random
import threading
import time

from horovod_tpu_torch.analysis import protocol as _proto
from horovod_tpu_torch.core.state import HorovodError
from horovod_tpu_torch.utils import env as _env

# The exit code an injected crash dies with — distinct from Python's 1 so a
# drill can tell an injected crash from an ordinary error.
CRASH_EXIT_CODE = 43

# At most this many heartbeat keys are freshly read per Liveness.check:
# the check runs inside the coordinator's poll loop, so a read per peer
# would stall it at scale. Probing rotates through the stalest sightings.
_HB_PROBE_CAP = 32
_BACKOFF_CAP_FACTOR = 64  # backoff never exceeds base * this
_POLL_MIN_S = 1e-4  # kv_get's first pause between polls; doubles up to
_POLL_MAX_S = 0.02  # this

# Messages of a collective that lost a peer: gloo's when the peer's
# socket closed or its wait timed out, NCCL's when the communicator was
# aborted or its watchdog fired.
PEER_LOSS_MARKERS: tuple[str, ...] = (
    "CONNECTION CLOSED BY PEER", "CONNECTION RESET BY PEER", "BROKEN PIPE",
    "TIMED OUT", "TIMEOUT", "ABORTED", "WATCHDOG",
)

# Decorrelated jitter needs randomness; a module Random instance keeps the
# retry schedule independent of user code's global seed (and reseedable by
# tests for determinism).
_rng = random.Random(0x5EED)


# ---------------------------------------------------------------------------
# Error classification
# ---------------------------------------------------------------------------

def classify_kv_error(e: Exception) -> str:
    """``"pending"`` (key not set yet — the caller's poll loop handles it),
    ``"transient"`` (store fault worth a bounded retry), or ``"fatal"``
    (store dead, or unrecognized — never retried):
    ``protocol.classify_kv_message`` of the error's text."""
    return _proto.classify_kv_message(str(e))


def is_kv_timeout(e: Exception) -> bool:
    """True when a store read failed because the key is not set yet (a
    poll timeout), NOT because the store died or refused."""
    return classify_kv_error(e) == "pending"


class KVTimeout(Exception):
    """A store wait exceeded its deadline without the key appearing.
    Carries the key so callers can craft context-specific messages."""

    def __init__(self, key: str):
        self.key = key
        super().__init__(f"timed out waiting for KV key {key}")


class WorkerLost(HorovodError):
    """A worker was judged dead: a liveness fatal (a peer process stopped
    heartbeating) or an injected rank-targeted crash under
    ``HOROVOD_ELASTIC=1``. Without elastic mode it propagates as the
    liveness fatal; with it the training loop catches it and shrinks
    (``core/elastic.py``). Carries the lost group-local ``ranks`` of group
    0 and/or the lost processes' global ranks (``pids``)."""

    def __init__(self, message: str, *, ranks=(), pids=()):
        super().__init__(message)
        self.ranks = tuple(ranks)
        self.pids = tuple(pids)


# ---------------------------------------------------------------------------
# Fault injection
# ---------------------------------------------------------------------------

Fault = _proto.Fault
parse_fault_spec = _proto.parse_fault_spec


class _InjectedFault(Exception):
    """Synthetic transient store fault (classify: transient — the message
    carries the INJECTED COORDINATION-SERVICE FAULT marker)."""


class FaultInjector:
    """Deterministic injection points threaded through the store calls,
    the training loop, the checkpoint writer and the serving engine.
    ``seq`` counts every store call of the retry layer (retries
    included)."""

    def __init__(self, faults: tuple[Fault, ...] = ()):
        self._faults = tuple(faults)
        self._kv_seq = -1
        self._consumed: set[int] = set()
        self._crash_consumed: set[int] = set()
        self._regrow_consumed: set[int] = set()
        self._serve_consumed: set[int] = set()
        self._lock = threading.Lock()

    @property
    def active(self) -> bool:
        return bool(self._faults)

    @property
    def kv_calls(self) -> int:
        """Store calls numbered so far (the next one is ``seq`` this)."""
        return self._kv_seq + 1

    def next_kv_seq(self) -> int:
        with self._lock:
            self._kv_seq += 1
            return self._kv_seq

    def kv_fault_due(self, seq: int) -> str | None:
        """The matching ``kv_timeout`` fault's description, or None. The
        fault covers store calls ``seq <= s < seq + times`` (times default
        1), so ``times`` > ``HOROVOD_KV_RETRIES`` exhausts the retry
        budget and surfaces the failure."""
        return _proto.kv_fault_covering(self._faults, seq)

    def crash_due(self, step: int, ranks, span: int = 1) -> Fault | None:
        """The matching ``crash`` fault for the steps ``step <= s < step +
        span``, or None. ``span`` covers multi-step calls
        (``Trainer(steps_per_call=N)`` checks once a call). ``rank``
        (group-local) is matched against ``ranks``; omitted = any
        process."""
        return _proto.crash_fault_matching(self._faults, step, ranks, span)

    def consume_crash(self, f: Fault) -> bool:
        """Mark a ``crash`` fault as consumed by the survivors' observation
        of it: the shrunk loop retries the same call boundary, where the
        matcher would otherwise fire again. True the first time only."""
        with self._lock:
            i = self._faults.index(f)
            if i in self._crash_consumed:
                return False
            self._crash_consumed.add(i)
            return True

    def crash_consumed(self, f: Fault) -> bool:
        """Whether the survivors have already observed ``f``: after the
        shrink, its group-local rank names another process, which must not
        exit for it."""
        with self._lock:
            return self._faults.index(f) in self._crash_consumed

    def regrow_due(self, step: int, span: int = 1) -> Fault | None:
        """The matching ``regrow`` join event for the steps ``step <= s <
        step + span``, consumed once (a join happens at exactly one step
        boundary), or None."""
        with self._lock:
            f = _proto.regrow_fault_matching(self._faults, step, span)
            if f is None:
                return None
            i = self._faults.index(f)
            if i in self._regrow_consumed:
                return None
            self._regrow_consumed.add(i)
            return f

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


def _lost(f: Fault, step: int) -> WorkerLost:
    """The survivors' observation of the rank-targeted crash ``f``."""
    target = f.attrs["rank"]
    print(f"HOROVOD_FAULT_INJECT: simulating worker loss of rank "
          f"{target} at step {step} ({f.describe()}); "
          f"HOROVOD_ELASTIC=1 — survivors continue.", flush=True)
    return WorkerLost(
        f"Worker hosting group rank {target} lost at step {step} "
        f"({f.describe()}).", ranks=(target,))


def maybe_crash(step: int, ranks, span: int = 1, peers=()) -> None:
    """Hard-kill this process (``os._exit``, the preemption analog — no
    atexit, no finally) when a ``crash`` fault matches one of the steps
    ``step <= s < step + span`` and one of this process's group-local
    ``ranks``. Called by ``Trainer.fit`` once a call with
    ``span=steps_per_call``.

    ``peers`` are the group's other group-local ranks. Under
    ``HOROVOD_ELASTIC=1`` a rank-targeted crash of a peer raises
    :class:`WorkerLost` naming it here, once: the survivors observe the
    loss at the boundary where the target dies. (The reference raises it
    instead of exiting in a process that hosts other ranks too; a process
    here hosts one, so the target always exits.)"""
    inj = injector()
    if not inj.active:
        return
    f = inj.crash_due(step, ranks, span)
    if f is not None and not inj.crash_consumed(f):
        print(f"HOROVOD_FAULT_INJECT: simulating hard crash at step {step} "
              f"({f.describe()}); exiting {CRASH_EXIT_CODE}.", flush=True)
        os._exit(CRASH_EXIT_CODE)
    if not peers or not _env.elastic_enabled():
        return
    f = inj.crash_due(step, peers, span)
    if (f is None or f.attrs.get("rank") is None
            or not inj.consume_crash(f)):
        return
    target = f.attrs["rank"]
    print(f"HOROVOD_FAULT_INJECT: simulating worker loss of rank "
          f"{target} at step {step} ({f.describe()}); "
          f"HOROVOD_ELASTIC=1 — survivors continue.", flush=True)
    raise WorkerLost(
        f"Worker hosting group rank {target} lost at step {step} "
        f"({f.describe()}).", ranks=(target,))


# ---------------------------------------------------------------------------
# Store retry with decorrelated-jitter backoff
# ---------------------------------------------------------------------------

_retry_total = 0


def retry_count() -> int:
    """Total store retries this process has performed (the per-retry
    trace goes to the timeline as RETRY activities)."""
    return _retry_total


def _note_retry(key: str, opname: str, attempt: int, err: Exception) -> None:
    global _retry_total
    _retry_total += 1
    from horovod_tpu_torch.core import timeline as _tl

    tl = _tl.session()
    if tl.active:
        # One 'coordination' row collects every retry tick; per-key rows
        # would explode the trace with one-event processes.
        tl.event("coordination", "RETRY", "X")


def kv_call(opname: str, key: str, thunk):
    """Run one store operation with fault injection and bounded
    retry-with-backoff around transient store faults.

    Pending poll timeouts pass straight through (the caller's poll loop
    owns them); fatal errors raise immediately; transient faults are
    retried up to ``HOROVOD_KV_RETRIES`` times with decorrelated-jitter
    backoff (``sleep = uniform(base, prev*3)`` capped at ``base*64``,
    base = ``HOROVOD_KV_BACKOFF_MS``), then surfaced as a
    :class:`HorovodError` naming the failing key."""
    retries = _env.kv_retries()
    base = max(1.0, _env.kv_backoff_ms())
    delay = base
    attempt = 0
    inj = injector()
    while True:
        seq = inj.next_kv_seq()
        try:
            fault = inj.kv_fault_due(seq)
            if fault:
                raise _InjectedFault(
                    f"UNAVAILABLE: injected coordination-service fault "
                    f"({fault} at kv seq {seq})")
            return thunk()
        except Exception as e:
            action = _proto.retry_decision(
                classify_kv_error(e), opname, attempt, retries, str(e))
            if action == "duplicate_ok":
                return None
            if action == "raise":
                raise
            attempt += 1
            if action == "exhausted":
                raise HorovodError(
                    f"Coordination-service {opname} on key {key!r} still "
                    f"failing after {retries} bounded "
                    f"retr{'y' if retries == 1 else 'ies'} with backoff "
                    f"(HOROVOD_KV_RETRIES={retries}, "
                    f"HOROVOD_KV_BACKOFF_MS={base:g}): {e}") from e
            _note_retry(key, opname, attempt, e)
            delay = min(base * _BACKOFF_CAP_FACTOR,
                        _rng.uniform(base, max(base, delay * 3.0)))
            time.sleep(delay / 1000.0)


def _poll_get(store, key: str, timeout_ms: float) -> str:
    deadline = time.monotonic() + timeout_ms / 1000.0
    pause = _POLL_MIN_S
    while not store.check([key]):
        if time.monotonic() >= deadline:
            raise KVTimeout(key)
        time.sleep(pause)
        pause = min(2 * pause, _POLL_MAX_S)
    value = store.get(key)
    return value.decode() if isinstance(value, bytes) else value


def kv_get(store, key: str, timeout_ms: float) -> str:
    """The value of ``key``, waited for at most ``timeout_ms`` (a
    :class:`KVTimeout`, a pending error, past it), with retry/backoff and
    fault injection."""
    return kv_call("get", key, lambda: _poll_get(store, key, timeout_ms))


def kv_set(store, key: str, value: str) -> None:
    """``store.set`` with retry/backoff and fault injection."""
    kv_call("set", key, lambda: store.set(key, value))


def wait_kv(store, key: str, timeout_ms: float, *, pids=(),
            context: str = "", poll_ms: int = 1000) -> str:
    """Wait for ``key`` in bounded poll chunks, consulting the liveness
    registry between chunks: a dead peer among ``pids`` raises
    :class:`WorkerLost` naming it (instead of burning the whole timeout),
    and deadline expiry raises :class:`KVTimeout` so the caller can craft
    its context-specific message. With liveness disabled the whole wait
    is one chunk."""
    if not pids or _env.liveness_timeout_seconds() <= 0:
        poll_ms = timeout_ms
    deadline = time.monotonic() + timeout_ms / 1000.0
    while True:
        remaining_ms = (deadline - time.monotonic()) * 1000.0
        if remaining_ms <= 0:
            raise KVTimeout(key)
        try:
            return kv_get(store, key, max(1, min(poll_ms, int(remaining_ms))))
        except Exception as e:
            if not is_kv_timeout(e):
                raise
            liveness().maybe_check(store, pids, context)


# ---------------------------------------------------------------------------
# Heartbeat / liveness registry
# ---------------------------------------------------------------------------


def _hb_key(generation: int, pid: int) -> str:
    return _proto.hb_key(generation, pid)


def _generation() -> int:
    from horovod_tpu_torch.core import state as _state

    return _state.kv_generation()


class Heartbeat:
    """Daemon ticker publishing this process's liveness to the store every
    ``HOROVOD_LIVENESS_INTERVAL`` seconds. The value is a wall-clock
    timestamp; ages are compared against it, so multi-host deployments
    need clocks NTP-aligned to well within the liveness timeout."""

    def __init__(self, store, pid: int, interval: float):
        self._store = store
        self._pid = pid
        self._interval = interval
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name="hvd-heartbeat", daemon=True)
        self._started = False
        self.published = 0  # heartbeats written so far

    def beat(self) -> None:
        """Publish now (the generation changed)."""
        self._publish()

    def _publish(self) -> None:
        try:
            # The generation is read per tick: a resume or an elastic
            # transition bumps it, and the peers read the new keys.
            self._store.set(_hb_key(_generation(), self._pid),
                            json.dumps({"t": time.time()}))
            self.published += 1
        except Exception:
            pass  # best-effort: a dead store surfaces in the blocking waits

    def _run(self) -> None:
        while not self._stop.wait(self._interval):
            self._publish()

    def start(self) -> None:
        self._publish()  # visible immediately, not one interval later
        self._thread.start()
        self._started = True

    def stop(self) -> None:
        self._stop.set()
        if self._started:
            self._thread.join(timeout=2.0)


_hb: Heartbeat | None = None
_hb_lock = threading.Lock()


def heartbeat() -> Heartbeat | None:
    """The running heartbeat publisher, or None."""
    return _hb


def start_heartbeat(force: bool = False) -> None:
    """Start the liveness publisher. No-op unless the world has more than
    one process (``force`` starts it at one too) and
    ``HOROVOD_LIVENESS_INTERVAL`` > 0 (default 10 s; 0 disables). Called
    by ``hvd.init``; idempotent."""
    global _hb
    interval = _env.liveness_interval_seconds()
    if interval <= 0:
        return
    from horovod_tpu_torch.core import negotiate as _neg
    from horovod_tpu_torch.core import state as _state

    if _state.global_size() <= 1 and not force:
        return
    with _hb_lock:
        if _hb is not None:
            return
        hb = Heartbeat(_neg.negotiator().store, _state.global_rank(),
                       interval)
        hb.start()
        _hb = hb


def stop_heartbeat() -> None:
    global _hb
    with _hb_lock:
        hb = _hb
        _hb = None
    if hb is not None:
        hb.stop()


def _ranks_of_process(pid: int) -> list[int]:
    """Global ranks hosted by process ``pid``: a process is its rank."""
    return [pid]


class Liveness:
    """Reader side of the heartbeat registry: the blocking waits ask it
    whether the peers they are waiting on are still alive. Opt-in via
    ``HOROVOD_LIVENESS_TIMEOUT`` (seconds; 0 = disabled) — a peer whose
    last heartbeat is older than the timeout is declared dead and the wait
    raises :class:`WorkerLost` naming it, its ranks and its last-seen
    age."""

    def __init__(self):
        self._lock = threading.Lock()
        # (generation, pid) -> published wall time. Keyed per generation so
        # a resume's generation bump restores the startup grace.
        self._last_seen: dict[tuple[int, int], float] = {}
        self._last_check = 0.0

    def maybe_check(self, store, pids, context: str = "") -> None:
        """Rate-limited :meth:`check` — safe to call every poll iteration."""
        timeout = _env.liveness_timeout_seconds()
        if timeout <= 0 or not pids:
            return
        now = time.monotonic()
        with self._lock:
            if now - self._last_check < min(1.0, timeout / 4):
                return
            self._last_check = now
        self.check(store, pids, context)

    def check(self, store, pids, context: str = "") -> None:
        """Read the heartbeat keys of ``pids``; raise naming every peer whose
        last heartbeat is older than ``HOROVOD_LIVENESS_TIMEOUT``. A peer
        that has NEVER heartbeat is given startup grace (the caller's own
        timeout bounds that wait). At most ``_HB_PROBE_CAP`` keys are read
        a call, stalest sightings first (``protocol.liveness_probe_order``);
        the verdict is over the cached sightings of every pid."""
        timeout = _env.liveness_timeout_seconds()
        if timeout <= 0:
            return
        gen = _generation()
        now = time.time()
        with self._lock:
            cached = {p: self._last_seen.get((gen, p))
                      for p in sorted(set(pids))}
        for p in _proto.liveness_probe_order(cached, now, timeout,
                                             _HB_PROBE_CAP):
            key = _hb_key(gen, p)
            try:
                if not store.check([key]):
                    continue
                t_pub = float(json.loads(store.get(key))["t"])
            except Exception:
                continue  # no fresh read: judge from the cached sighting
            with self._lock:
                self._last_seen[(gen, p)] = t_pub
            cached[p] = t_pub
        dead = _proto.judge_dead(cached, time.time(), timeout)
        if dead:
            parts = []
            for p, age in dead:
                parts.append(
                    f"process {p} (global ranks {_ranks_of_process(p)}, "
                    f"last heartbeat {age:.1f}s ago)")
            raise WorkerLost(
                f"Liveness check failed while "
                f"{context or 'waiting on a peer'}: "
                + "; ".join(parts)
                + f". The heartbeat registry (HOROVOD_LIVENESS_TIMEOUT="
                f"{timeout:g}s) says these peer(s) are dead; a synchronous "
                f"job cannot make progress without them. Restart the failed "
                f"host(s) and resume from the last complete checkpoint "
                f"(Trainer.fit(resume=...)).",
                ranks=_group0_ranks([p for p, _age in dead]),
                pids=[p for p, _age in dead])


def _group0_ranks(pids) -> list[int]:
    """Group 0's group-local ranks of the global ranks ``pids``."""
    from horovod_tpu_torch.core import state as _state

    g = _state.get_group(0)
    return [g.group_rank_of(p) for p in pids if g.group_rank_of(p) >= 0]


_liveness = Liveness()


def liveness() -> Liveness:
    return _liveness


def is_peer_loss(e: BaseException) -> bool:
    """Whether a collective's error reads as a lost peer
    (:data:`PEER_LOSS_MARKERS`)."""
    if isinstance(e, HorovodError) or not isinstance(e, RuntimeError):
        return False
    msg = str(e).upper()
    return any(m in msg for m in PEER_LOSS_MARKERS)


def judge_peer_loss(err: BaseException, pids, context: str,
                    pg=None) -> None:
    """A collective over ``pids`` (global ranks of the other members)
    raised ``err``. When it reads as a lost peer and liveness is on, wait
    until the registry can judge — at most the liveness timeout plus two
    heartbeat intervals — abort the collective's process group ``pg``
    (a member still blocked in it is released, and judges in turn) and
    raise :class:`WorkerLost` naming the dead from ``err``. Returns when
    it cannot judge (liveness off, not a peer loss, or every peer still
    heartbeating): the caller re-raises ``err``."""
    timeout = _env.liveness_timeout_seconds()
    if timeout <= 0 or not pids or not is_peer_loss(err):
        return
    from horovod_tpu_torch.core import negotiate as _neg

    store = _neg.negotiator().store
    deadline = (time.monotonic() + timeout
                + 2 * _env.liveness_interval_seconds() + 1.0)
    while time.monotonic() < deadline:
        try:
            liveness().check(store, pids, context)
        except WorkerLost as lost:
            if pg is not None:
                from horovod_tpu_torch.core import state as _state

                _state.abort_pg(pg)
            raise lost from err
        time.sleep(min(0.25, timeout / 4))


def _reset_for_tests() -> None:
    """Fresh injector/liveness/retry state + reseeded backoff RNG, so tests
    and the fault drill are order-independent."""
    global _liveness, _retry_total
    reset_injector()
    _liveness = Liveness()
    _retry_total = 0
    _rng.seed(0x5EED)

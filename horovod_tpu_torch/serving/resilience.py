"""Serving resilience: request deadlines, the engine watchdog, the
crash-safe request journal, and the load-shedding judgement.

Counterpart of ``horovod_tpu/serving/resilience.py``, a near copy (stdlib
only; the journal's schema and bytes are the reference's):

* **Deadlines** — a request carries an absolute monotonic deadline
  (``Engine.submit(deadline_ms=)``, default ``HOROVOD_SERVE_DEADLINE_MS``).
  The engine evicts expired requests at step boundaries and the scheduler
  refuses admissions that cannot finish prefill inside their remaining
  budget at the measured prefill rate; the decisions are the pure
  ``protocol.deadline_expired`` / ``protocol.admission_feasible``.
* **Watchdog** — :class:`Watchdog` stamps a monotonic heartbeat around
  every prefill and decode dispatch (each ends with a host sync) and
  converts a dispatch older than ``HOROVOD_SERVE_WATCHDOG_TIMEOUT`` into a
  loud :class:`EngineStalled` naming the phase, step and age
  (``protocol.judge_dead`` over a one-member world).
* **Journal** — :class:`RequestJournal` is an append-only
  ``.journal.json`` record of admissions (prompt + CRC, sampling seed,
  tenant, deadline budget) and emitted-token runs, each line carrying the
  CRC32 of its record; appends are fsynced once per engine step. On
  restart :func:`load_journal` drops the torn tail a mid-append crash
  leaves and folds the rest through ``protocol.journal_committed``, so
  ``Engine.recover`` resumes every in-flight request through the
  preemption-recompute path with bit-identical continuations.
* **Degradation** — :func:`pool_pressure_high` (sustained preemption) is
  the judgement behind load shedding (``SHED`` tick).

The fault specs ``engine_crash@step=S``, ``stuck_decode@step=S[,ms=M]``
and ``deadline_storm@step=S`` thread through ``Engine.step``
(``core/resilience.py``).
"""

from __future__ import annotations

import json
import os
import time
import zlib
from collections import deque
from typing import Any, Sequence

from horovod_tpu_torch.analysis import protocol as _proto
from horovod_tpu_torch.core import timeline as _timeline
from horovod_tpu_torch.core.state import HorovodError

JOURNAL_SCHEMA = "horovod_tpu/serve-journal/v1"

# Config fields a journal pins: a replay against a differently-shaped
# engine cannot be bit-identical, so recover refuses the mismatch.
FINGERPRINT_FIELDS = ("block_size", "kv_dtype", "temperature", "seed",
                     "speculate_k")


def now_ms() -> float:
    """The serving clock: monotonic milliseconds. Deadlines are absolute
    points on this clock (meaningless across a restart — the journal
    records the original BUDGET so recovery can re-arm them)."""
    return time.monotonic() * 1000.0


class EngineStalled(HorovodError):
    """A dispatched executable exceeded the watchdog timeout — raised
    loudly (phase, step, age) instead of hanging the load driver."""

    def __init__(self, phase: str, step: int, age: float, timeout: float):
        self.phase = phase
        self.step = step
        self.age = age
        super().__init__(
            f"serving engine stalled: the {phase} dispatch at step {step} "
            f"has not completed for {age:.2f}s (watchdog timeout "
            f"{timeout:g}s, HOROVOD_SERVE_WATCHDOG_TIMEOUT) — the "
            f"executable is stuck or the device is wedged; the engine "
            f"must be restarted (Engine.recover replays the journal).")


class Watchdog:
    """Heartbeat-and-judge for one engine's dispatches. ``stamp`` before
    a dispatch, ``clear`` after its host sync returns; ``check`` (from
    the step loop, or any other thread) raises :class:`EngineStalled`
    when the open stamp's age exceeds the timeout. The judgement routes
    through ``protocol.judge_dead``, the liveness verdict over a
    one-member world. ``timeout`` <= 0 disables
    judging (stamps stay cheap no-ops-with-state for the fault hooks)."""

    def __init__(self, timeout: float = 0.0):
        self.timeout = float(timeout)
        self._phase: str | None = None
        self._step = -1
        self._beat: float | None = None

    def stamp(self, phase: str, step: int) -> None:
        self._phase = phase
        self._step = int(step)
        self._beat = time.monotonic()

    def clear(self) -> None:
        self._phase = None
        self._beat = None

    def backdate(self, seconds: float) -> None:
        """Age the open stamp (the ``stuck_decode`` injection: the
        drill's stand-in for a dispatch that never returns)."""
        if self._beat is not None:
            self._beat -= float(seconds)

    def check(self, timeout: float | None = None) -> None:
        """Judge the open stamp; raise :class:`EngineStalled` when its
        age exceeds the (possibly overridden) timeout."""
        timeout = self.timeout if timeout is None else float(timeout)
        if timeout <= 0 or self._beat is None:
            return
        now = time.monotonic()
        judged = _proto.judge_dead({0: self._beat}, now=now,
                                   timeout=timeout)
        if judged:
            _pid, age = judged[0]
            tl = _timeline.session()
            tl.event("serving", "STALL", "X")
            raise EngineStalled(self._phase or "?", self._step, age,
                                timeout)


def pool_pressure_high(window: Sequence[int], min_steps: int = 8) -> bool:
    """Sustained pool pressure: at least ``min_steps`` recent steps
    observed, and preemptions fired in at least half of them — the
    thrashing regime where admitting more work only recomputes more.
    Pure, so the engine's shed decision and its tests agree."""
    if len(window) < min_steps:
        return False
    return 2 * sum(1 for n in window if n > 0) >= len(window)


# ---------------------------------------------------------------------------
# The journal
# ---------------------------------------------------------------------------


def _canonical(rec: dict[str, Any]) -> bytes:
    return json.dumps(rec, sort_keys=True,
                      separators=(",", ":")).encode()


def _line(rec: dict[str, Any]) -> bytes:
    body = _canonical(rec)
    crc = zlib.crc32(body) & 0xFFFFFFFF
    return json.dumps({"crc": crc, "rec": rec}, sort_keys=True,
                      separators=(",", ":")).encode() + b"\n"


def prompt_crc(prompt: Sequence[int]) -> int:
    """CRC32 of the prompt token stream (the admission's integrity
    fingerprint — also what the drill compares outputs with)."""
    body = ",".join(str(int(t)) for t in prompt).encode()
    return zlib.crc32(body) & 0xFFFFFFFF


class RequestJournal:
    """Append-only crash-safe record of one engine's request lifecycle.

    One JSON line per record: ``{"crc": C, "rec": {...}}`` where ``C``
    is the CRC32 of the record's canonical bytes. The first record is a
    schema header carrying the engine's config fingerprint. Appends are
    buffered per engine step and flushed with one ``write``+``fsync``
    (``flush``), so a crash loses at most the CURRENT step's records —
    which the restarted engine regenerates bit-identically through the
    recompute path. Token emissions within a step coalesce into one
    ``emit`` run per request (monotone ``start`` indices)."""

    def __init__(self, path: str, fingerprint: dict[str, Any]):
        if not path.endswith(".journal.json"):
            raise ValueError(
                f"journal path must end in .journal.json (the hvd-lint "
                f"dispatch suffix), got {path!r}")
        self.path = path
        self.time_s = 0.0  # cumulative record+flush wall time
        self._buf: list[bytes] = []
        self._pending: dict[int, tuple[int, list[int]]] = {}
        existing = os.path.exists(path) and os.path.getsize(path) > 0
        if existing:
            header = _read_records(path)[0]
            if not header or header[0].get("kind") != "header":
                raise HorovodError(
                    f"{path}: existing journal has no readable header — "
                    f"refusing to append to an unrecognizable artifact")
            if header[0].get("schema") != JOURNAL_SCHEMA:
                raise HorovodError(
                    f"{path}: journal schema "
                    f"{header[0].get('schema')!r} != {JOURNAL_SCHEMA!r} "
                    f"— a stale layout is refused, never field-guessed")
        self._fh = open(path, "ab")
        if not existing:
            # Header goes through the same append path (fsynced), then
            # the directory entry is made durable (fsync of the dir).
            self._buf.append(_line({"kind": "header",
                                    "schema": JOURNAL_SCHEMA,
                                    "engine": dict(fingerprint)}))
            self.flush()
            dirfd = os.open(os.path.dirname(path) or ".", os.O_RDONLY)
            try:
                os.fsync(dirfd)
            finally:
                os.close(dirfd)

    # -- record builders (buffered until flush) ---------------------------

    def record_admit(self, rid: int, prompt: Sequence[int], *,
                     tenant: str, seed: int, max_new: int,
                     deadline_ms: float | None, budget_ms: float | None,
                     t: float) -> None:
        toks = [int(x) for x in prompt]
        self._buf.append(_line({
            "kind": "admit", "rid": int(rid), "tenant": tenant,
            "seed": int(seed), "max_new": int(max_new),
            "prompt": toks, "prompt_crc": prompt_crc(toks),
            "deadline_ms": deadline_ms, "budget_ms": budget_ms,
            "t": t}))

    def record_emit(self, rid: int, index: int, token: int) -> None:
        """Buffer one emitted token; consecutive emissions for one
        request inside a step coalesce into a single monotone run."""
        rid = int(rid)
        if rid in self._pending:
            self._pending[rid][1].append(int(token))
        else:
            self._pending[rid] = (int(index), [int(token)])

    def record_finish(self, rid: int, n: int, t: float) -> None:
        self._flush_pending(rid, t)
        self._buf.append(_line({"kind": "finish", "rid": int(rid),
                                "n": int(n), "t": t}))

    def record_evict(self, rid: int, reason: str, t: float) -> None:
        self._flush_pending(rid, t)
        self._buf.append(_line({"kind": "evict", "rid": int(rid),
                                "reason": reason, "t": t}))

    def record_recover(self, rid: int, committed: int, t: float) -> None:
        self._buf.append(_line({"kind": "recover", "rid": int(rid),
                                "committed": int(committed), "t": t}))

    def _flush_pending(self, rid: int, t: float) -> None:
        run = self._pending.pop(int(rid), None)
        if run is not None:
            start, toks = run
            self._buf.append(_line({"kind": "emit", "rid": int(rid),
                                    "start": start, "tokens": toks,
                                    "t": t}))

    def flush(self, t: float | None = None) -> None:
        """Drain the step's buffered records with ONE write + fsync —
        the per-step durability point."""
        t0 = time.monotonic()
        if t is None:
            t = now_ms()
        for rid in sorted(self._pending):
            self._flush_pending(rid, t)
        if self._buf:
            self._fh.write(b"".join(self._buf))
            self._fh.flush()
            os.fsync(self._fh.fileno())
            self._buf.clear()
        self.time_s += time.monotonic() - t0

    def close(self) -> None:
        self.flush()
        self._fh.close()


def _read_records(path: str) -> tuple[list[dict[str, Any]], int]:
    """All CRC-verified records in order, plus the count of torn-tail
    lines DROPPED (partial last line, bad JSON, or CRC mismatch at the
    tail — the artifact a crash mid-append leaves). Corruption that is
    NOT a pure tail (verified records follow it) is refused loudly: the
    file did not tear, it rotted."""
    records: list[dict[str, Any]] = []
    torn_at: int | None = None
    with open(path, "rb") as f:
        raw = f.read()
    for i, line in enumerate(raw.split(b"\n")):
        if not line.strip():
            continue
        rec = None
        try:
            entry = json.loads(line)
            body = entry.get("rec")
            crc = entry.get("crc")
            if (isinstance(body, dict) and isinstance(crc, int)
                    and zlib.crc32(_canonical(body)) & 0xFFFFFFFF == crc):
                rec = body
        except (ValueError, AttributeError):
            rec = None
        if rec is None:
            if torn_at is None:
                torn_at = i
            continue
        if torn_at is not None:
            raise HorovodError(
                f"{path}: corrupt journal record at line {torn_at + 1} "
                f"FOLLOWED by verified records — not a torn tail but "
                f"mid-file corruption; refusing to replay any of it")
        records.append(rec)
    return records, (0 if torn_at is None else 1)


def load_journal(path: str) -> tuple[dict[str, Any], list[dict[str, Any]],
                                     dict[int, tuple[int, ...]], int]:
    """Load a journal for replay: ``(header, records, committed,
    torn_dropped)``. The torn tail (if any) is dropped — and the
    committed token runs come from ``protocol.journal_committed``, so a
    torn tail is never replayed as committed tokens."""
    records, torn = _read_records(path)
    if not records or records[0].get("kind") != "header":
        raise HorovodError(
            f"{path}: journal carries no verified header record — "
            f"nothing trustworthy to replay")
    header = records[0]
    if header.get("schema") != JOURNAL_SCHEMA:
        raise HorovodError(
            f"{path}: journal schema {header.get('schema')!r} != "
            f"{JOURNAL_SCHEMA!r} — a stale layout is refused, never "
            f"field-guessed")
    try:
        committed, _ = _proto.journal_committed(records)
    except ValueError as e:
        raise HorovodError(f"{path}: inconsistent journal — {e}") from None
    return header, records, committed, torn


def replay_plan(records: Sequence[dict[str, Any]],
                committed: dict[int, tuple[int, ...]]
                ) -> list[dict[str, Any]]:
    """The per-request resume plan: every admitted request that neither
    finished nor was evicted, with its committed prefix. Ordered by
    request id so replay admission order is deterministic."""
    admits: dict[int, dict[str, Any]] = {}
    closed: set[int] = set()
    for rec in records:
        if rec.get("kind") == "admit":
            admits[int(rec["rid"])] = rec
        elif rec.get("kind") in ("finish", "evict"):
            closed.add(int(rec["rid"]))
    plan = []
    for rid in sorted(admits):
        if rid in closed:
            continue
        rec = admits[rid]
        toks = committed.get(rid, ())
        if len(toks) >= int(rec["max_new"]):
            continue  # all tokens committed; only the finish record tore
        if prompt_crc(rec["prompt"]) != rec.get("prompt_crc"):
            raise HorovodError(
                f"journal admission {rid}: prompt fails its CRC32 — "
                f"refusing to replay a corrupt prompt")
        plan.append({"rid": rid, "prompt": rec["prompt"],
                     "tenant": rec.get("tenant", "default"),
                     "seed": int(rec.get("seed", rid)),
                     "max_new": int(rec["max_new"]),
                     "budget_ms": rec.get("budget_ms"),
                     "committed": list(toks)})
    return plan

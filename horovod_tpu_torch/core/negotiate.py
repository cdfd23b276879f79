"""Name-keyed negotiation: every rank's requests are exchanged and checked.

Counterpart of ``horovod_tpu/core/negotiate.py`` and of the per-process
negotiator of ``horovod_tpu/core/multihost.py``. In the JAX package one
controller sees every rank's request; here each rank is a process, so each
member of the group submits its own :class:`Request` s through the world's
key-value store (``torch.distributed``'s default store: a ``FileStore``
under a ``file://`` rendezvous, a ``TCPStore`` under ``env://``, a
``HashStore`` for a world of one), as the reference's processes do through
the coordination service:

* each member writes its batch under ``protocol.neg_key(generation, group,
  seq, rank)``, where ``seq`` counts the group's negotiations;
* the group-local rank 0 is the coordinator: it polls for the other
  members' batches and, while some are missing, prints the reference's
  stall warning every ``HOROVOD_STALL_CHECK_TIME`` seconds (default 60)
  naming the ready and the missing ranks; then it cross-checks the batches,
  validates each name with ``protocol.validate_requests`` and publishes the
  verdict under ``protocol.verdict_key``, deleting the spent keys;
* when the native control plane is loaded (``core/native``), the
  coordinator submits each member's requests to its request table as the
  member's batch arrives, so the table's stall report names the missing
  ranks, and the table validates; otherwise ``validate_requests`` does,
  with byte-identical texts;
* every other member waits for the verdict at most
  ``HOROVOD_NEGOTIATION_TIMEOUT`` seconds (default 600), then raises;
* every store call goes through ``core/resilience.py``'s bounded retry
  (and takes a ``kv_timeout@seq=N`` sequence number), and both waits
  consult the liveness registry (``HOROVOD_LIVENESS_TIMEOUT``): the
  coordinator judges the members it waits on, a member the coordinator.
  A coordinator that judges a member dead publishes that verdict before
  it raises :class:`~horovod_tpu_torch.core.resilience.WorkerLost`, so
  every member raises the same loss instead of waiting out its timeout.

A mismatch in dtype, op, shape or root raises :class:`HorovodError` with the
reference's message on every member, before any data moves; members that
submit different names at one index raise ``protocol.coordinate``'s desync
text with that index. A batch of requests (one per fusion bucket, one per
broadcast variable) is one round, which is what lets the optimizer
negotiate its whole gradient plan once per gradient signature: a step
whose plan is cached makes no store call.

**The eager verdict replay** (the reference's ``core/multihost.py``,
``HOROVOD_EAGER_CACHE``, default on). A batch whose every request has a
``protocol.replay_fingerprint`` — an explicitly named allreduce,
broadcast, alltoall or reducescatter — and whose fingerprints validated
before in the group's current generation replays the cached verdict with
no store call, and the group's negotiation index does not advance. The
fingerprint is ``(name, op, group size)``, so every member decides alike.
The trade is the reference's: a member that issues a new collective while
its peers replay cached ones waits at an index the peers never reach, and
times out with a text naming ``HOROVOD_EAGER_CACHE=0``, which restores
per-call validation; a named collective reissued with other metadata
replays its old verdict. Auto-named collectives and the allgather family
always negotiate. A generation move (``bump_generation``, an elastic
reconfigure or join) drops the group's cache.
"""

from __future__ import annotations

import dataclasses
import enum
import json
import threading
import time
from typing import Sequence

from horovod_tpu_torch.analysis import protocol as _proto
from horovod_tpu_torch.core import resilience as _res
from horovod_tpu_torch.core import state as _state
from horovod_tpu_torch.core import timeline as _tl
from horovod_tpu_torch.core.state import HorovodError
from horovod_tpu_torch.utils import env as _env

_POLL_MIN_S = 5e-5  # first pause between store polls; doubles up to
_POLL_MAX_S = 2e-3  # this, so a late rank costs ≤ 2 ms of extra latency


class CollectiveOp(enum.Enum):
    ALLREDUCE = _proto.OP_ALLREDUCE
    ALLGATHER = _proto.OP_ALLGATHER
    BROADCAST = _proto.OP_BROADCAST
    GATHER = _proto.OP_GATHER
    ALLTOALL = _proto.OP_ALLTOALL
    REDUCESCATTER = _proto.OP_REDUCESCATTER


@dataclasses.dataclass(frozen=True)
class Request:
    """One rank's intent to run a collective on a named tensor."""

    rank: int  # group-local rank submitting the request
    name: str
    op: CollectiveOp
    dtype: str
    shape: tuple[int, ...]
    root_rank: int = -1  # broadcast/gather only
    group: int = 0


@dataclasses.dataclass(frozen=True)
class Response:
    """Validated plan for one named tensor; ``tensor_sizes`` carries the
    per-rank first dimensions for allgather/gather."""

    name: str
    op: CollectiveOp
    dtype: str
    tensor_sizes: tuple[int, ...] = ()
    root_rank: int = -1


def validate_py(requests: Sequence[Request], group_size: int) -> Response:
    """Apply ``protocol.validate_requests``; raise on its error."""
    verdict = _proto.validate_requests(
        tuple(_proto.Req(rank=r.rank, name=r.name, op=r.op.value,
                         dtype=r.dtype, shape=tuple(r.shape),
                         root_rank=r.root_rank, group=r.group)
              for r in requests), group_size)
    if verdict.error is not None:
        raise HorovodError(verdict.error)
    return Response(name=verdict.name, op=CollectiveOp(verdict.op),
                    dtype=verdict.dtype, tensor_sizes=verdict.tensor_sizes,
                    root_rank=verdict.root_rank)


class Negotiator:
    """One process's side of the store exchange: per-group generations and
    negotiation indices, the stall reports the coordinator has recorded,
    and a count of store calls (``store_calls``). ``hvd.init`` creates it;
    :func:`negotiator` returns it."""

    def __init__(self, store, stall_seconds: float) -> None:
        self.store = store
        self.stall_seconds = stall_seconds
        self.store_calls = 0
        self._generation: dict[int, int] = {}
        self._seq: dict[int, int] = {}
        self._sched: dict[tuple[int, str], int] = {}
        self._stalls: dict[int, list[str]] = {}
        # group -> {tuple of the batch's fingerprints: its responses}
        self._verdicts: dict[int, dict[tuple, list[Response]]] = {}
        self._lock = threading.Lock()

    def next_index(self, group: int) -> tuple[int, int]:
        """``(generation, seq)`` of the group's next negotiation."""
        with self._lock:
            seq = self._seq.get(group, 0)
            self._seq[group] = seq + 1
            return self._generation.get(group, 0), seq

    def generation(self, group: int) -> int:
        """The group's current generation."""
        with self._lock:
            return self._generation.get(group, 0)

    def sched_index(self, group: int, tag: str) -> tuple[int, int]:
        """``(generation, epoch)`` of the group's next schedule validation
        of program ``tag`` (``core/multihost.py``)."""
        with self._lock:
            epoch = self._sched.get((group, tag), 0)
            self._sched[(group, tag)] = epoch + 1
            return self._generation.get(group, 0), epoch

    def bump_generation(self, group: int) -> int:
        """Move the group's keys to a fresh namespace; every member calls
        this at the same point of its sequence."""
        return self.set_generation(group, self.generation(group) + 1)

    def set_generation(self, group: int, gen: int) -> int:
        """Move the group's keys to generation ``gen`` (an elastic joiner
        adopts the members' new generation)."""
        with self._lock:
            self._generation[group] = gen
            self._seq[group] = 0
            self._verdicts.pop(group, None)
            for k in [k for k in self._sched if k[0] == group]:
                del self._sched[k]
            return gen

    def replayed(self, group: int, fps: tuple) -> list[Response] | None:
        """The responses validated before for the batch of fingerprints
        ``fps`` in the group's current generation, or None."""
        with self._lock:
            hit = self._verdicts.get(group, {}).get(fps)
            return None if hit is None else list(hit)

    def remember(self, group: int, fps: tuple,
                 responses: list[Response]) -> None:
        """Cache a validated batch's responses under its fingerprints."""
        with self._lock:
            self._verdicts.setdefault(group, {})[fps] = list(responses)

    def stalled(self, group: int) -> list[str]:
        """The stall reports recorded for ``group`` since the last call,
        each ``name [ready ranks: [...]] [missing ranks: [...]]``."""
        with self._lock:
            return self._stalls.pop(group, [])

    # -- store calls, counted, each through the bounded retry ----------------

    def _call(self, opname: str, key: str, fn, *args):
        self.store_calls += 1
        return _res.kv_call(opname, key, lambda: fn(*args))

    def set(self, key: str, value: str) -> None:
        self._call("set", key, self.store.set, key, value)

    def get(self, key: str) -> bytes:
        return self._call("get", key, self.store.get, key)

    def has(self, key: str) -> bool:
        return self._call("check", key, self.store.check, [key])

    def delete(self, key: str) -> None:
        self._call("delete", key, self.store.delete_key, key)

    # -- the two roles ------------------------------------------------------

    def collect(self, g: _state.Group, gen: int, seq: int, mine: list,
                names: list[str], table: "_NativeRound | None" = None
                ) -> list[list]:
        """Coordinator: every member's batch at this index (its own is
        ``mine``), stall-warning while some are missing; each batch goes
        into the native ``table`` as it arrives. Then frees the members'
        keys and the previous index's verdict."""
        batches: list = [mine] + [None] * (g.size - 1)
        missing = list(range(1, g.size))
        if table is not None:
            table.arrived(0, mine)
        last_warn = time.monotonic()
        pause = _POLL_MIN_S
        while missing:
            for r in list(missing):
                key = _proto.neg_key(gen, g.index, seq, r)
                if self.has(key):
                    batches[r] = json.loads(self.get(key))
                    missing.remove(r)
                    if table is not None:
                        table.arrived(r, batches[r])
            if not missing:
                break
            _res.liveness().maybe_check(
                self.store, [g.ranks[r] for r in missing],
                f"negotiating tensor {_batch_name(names)} (index {seq})")
            now = time.monotonic()
            if self.stall_seconds > 0 and now - last_warn > self.stall_seconds:
                last_warn = now
                self._warn_stalled(g, names, missing)
            time.sleep(pause)
            pause = min(2 * pause, _POLL_MAX_S)
        for r in range(1, g.size):
            self.delete(_proto.neg_key(gen, g.index, seq, r))
        if seq > 0:
            self.delete(_proto.verdict_key(gen, g.index, seq - 1))
        return batches

    def _warn_stalled(self, g: _state.Group, names: list[str],
                      missing: list[int]) -> None:
        ready = sorted(set(range(g.size)) - set(missing))
        gone = sorted(missing)
        reports = [f"{n} [ready ranks: {ready}] [missing ranks: {gone}]"
                   for n in names]
        with self._lock:
            self._stalls.setdefault(g.index, []).extend(reports)
        # The reference's text (multihost.py::_coordinate, after
        # CheckForStalledTensors, mpi_ops.cc:1380-1410).
        print("WARNING: One or more tensors were submitted to be "
              "reduced, gathered or broadcasted by subset of ranks and "
              "are waiting for remainder of ranks for more than "
              f"{int(self.stall_seconds)} seconds. This may indicate "
              "that different ranks are trying to submit different "
              "tensors or that only subset of ranks is submitting "
              "tensors, which will cause deadlock.\n"
              f"Stalled ops: {', '.join(reports)}", flush=True)

    def await_verdict(self, g: _state.Group, gen: int, seq: int,
                      name: str) -> dict:
        """A member other than the coordinator: the verdict at this index,
        waited for at most ``HOROVOD_NEGOTIATION_TIMEOUT``."""
        key = _proto.verdict_key(gen, g.index, seq)
        deadline = time.monotonic() + _env.negotiation_timeout_ms() / 1e3
        pause = _POLL_MIN_S
        while not self.has(key):
            _res.liveness().maybe_check(
                self.store, (g.ranks[0],),
                f"waiting for the coordinator's verdict on tensor {name} "
                f"(negotiation index {seq})")
            if time.monotonic() > deadline:
                # The reference's text (multihost.py::negotiate).
                raise HorovodError(
                    f"Timed out waiting for the coordinator's verdict on "
                    f"tensor {name} (negotiation index {seq}). With the "
                    f"eager verdict cache enabled this usually means this "
                    f"process issued a collective its peers did not (they "
                    f"replayed cached verdicts and never reached index "
                    f"{seq}) — a schedule divergence. Re-run with "
                    f"HOROVOD_EAGER_CACHE=0 to get per-call validation "
                    f"naming the diverging tensors.")
            time.sleep(pause)
            pause = min(2 * pause, _POLL_MAX_S)
        return json.loads(self.get(key))


def negotiator() -> Negotiator:
    """This process's :class:`Negotiator` (``hvd.init`` first)."""
    return _state._require_init().negotiator


def _batch_name(names: list[str]) -> str:
    if not names:
        return "(empty batch)"
    if len(names) == 1:
        return names[0]
    return f"{names[0]} (+{len(names) - 1} more)"


def _validate_native(native, requests: Sequence[Request],
                     group_size: int) -> Response:
    """Validate one name's requests (one a rank) through the native request
    table, as the reference's ``negotiate._validate_native`` does: one
    submit a rank, the response ready when the last rank lands."""
    first = requests[0]
    if len(requests) != group_size:
        raise HorovodError(
            f"Tensor {first.name} has {len(requests)} request(s) but the "
            f"group has {group_size} rank(s); every rank must submit the "
            f"collective.")
    status, err = 0, ""
    for r in requests:
        status, err = native.submit(
            first.group, r.name, r.op.value, r.dtype, r.shape, r.root_rank,
            r.rank)
        if status < 0:
            break
    return _native_response(native, first.group, first, status, err)


def _native_response(native, group: int, first: Request, status: int,
                     err: str) -> Response:
    """The table's response to ``first``'s name after its last submit
    (``status``, ``err``), released from the table; raises its error."""
    if status < 0:
        raise HorovodError(err)
    if status != 1:
        raise HorovodError(
            f"Tensor {first.name} did not complete negotiation "
            f"(internal error).")
    sizes = native.response_sizes(group, first.name) or []
    root = native.response_root(group, first.name)
    native.response_done(group, first.name)
    return Response(name=first.name, op=first.op, dtype=first.dtype,
                    tensor_sizes=tuple(sizes), root_rank=root)


class _NativeRound:
    """The coordinator's native request table over one round: each member's
    requests go in as its batch arrives (so ``NativeCore.stalled`` names
    the ranks still missing), the table validates each name when its last
    rank lands, and :meth:`drain` releases whatever a failed round left in
    the table, which stays usable for the next round."""

    def __init__(self, core, g: _state.Group, names: list[str]) -> None:
        self.core = core
        self.g = g
        self.names = names
        self.status: list = [None] * len(names)  # last submit's (status, err)
        self.consumed = [False] * len(names)

    def arrived(self, r: int, batch: list) -> None:
        # A request whose name is not the coordinator's at its position
        # stays out: the round fails on coordinate's desync text.
        for i, (name, op, dtype, shape, root) in enumerate(
                batch[:len(self.names)]):
            if name == self.names[i]:
                self.status[i] = self.core.submit(
                    self.g.index, name, op, dtype, tuple(shape), root, r)

    def verdict(self, i: int, first: Request) -> Response:
        self.consumed[i] = True
        return _native_response(self.core, self.g.index, first,
                                *self.status[i])

    def drain(self) -> None:
        for i, name in enumerate(self.names):
            st = self.status[i]
            if st is None or self.consumed[i]:
                continue
            if st[0] == 0:
                # Still waiting on a rank: a second submission by the
                # coordinator erases the entry (the table's "submitted
                # twice" path).
                self.core.submit(self.g.index, name, 0, "", (), -1, 0)
            elif st[0] == 1:
                self.core.response_done(self.g.index, name)


def _native_round(names: list[str], g: _state.Group) -> _NativeRound | None:
    """A native table for this round, or None (Python validation): no
    native core, or a batch that names a tensor twice (the table keys on
    the name)."""
    core = _state.native_core()
    if (core is None or not names or len(set(names)) != len(names)
            or g.index >= len(core.group_sizes)
            or core.group_sizes[g.index] != g.size):
        return None
    return _NativeRound(core, g, names)


def _wire(r: int, req: list, group: int) -> dict:
    name, op, dtype, shape, root = req
    return {"rank": r, "name": name, "op": op, "dtype": dtype,
            "shape": list(shape), "root_rank": root, "group": group}


def _desync_text(gathered: list[list], i: int, seq: int,
                 g: _state.Group) -> str:
    """``protocol.coordinate``'s text for members whose ``i``-th requests
    name different tensors at negotiation index ``seq``; in a batch of
    more than one, the index is followed by the request's position."""
    per_proc = {r: {"name": theirs[i][0],
                    "requests": [_wire(r, theirs[i], g.index)]}
                for r, theirs in enumerate(gathered)}
    text = _proto.coordinate(per_proc, gathered[0][i][0], seq,
                             g.size)["error"]
    n = len(gathered[0])
    if n > 1:
        text = text.replace(
            f"at negotiation index {seq},",
            f"at negotiation index {seq} (request {i} of a batch of {n}),",
            1)
    return text


def _validate(gathered: list[list], g: _state.Group, seq: int,
              table: _NativeRound | None = None) -> list[Response]:
    """The coordinator's verdict over every member's batch: the same length
    and names in the same order, then each name validated (by the native
    ``table`` when there is one); raises the reference's messages."""
    for r, theirs in enumerate(gathered):
        if len(theirs) != len(gathered[0]):
            raise HorovodError(
                f"Mismatched negotiation batches: group-local rank {r} "
                f"submitted {len(theirs)} request(s) while rank 0 "
                f"submitted {len(gathered[0])}. All ranks must issue the "
                f"same collectives in the same order.")
    tl = _tl.session()
    # The native table writes its own NEGOTIATE span and rank ticks, as
    # each batch arrived, into the writer of the core that owns it.
    py_events = tl.active and (table is None
                               or table.core is not tl.native_core)
    out = []
    for i, first in enumerate(gathered[0]):
        name = first[0]
        if any(theirs[i][0] != name for theirs in gathered):
            raise HorovodError(_desync_text(gathered, i, seq, g))
        reqs = [Request(rank=r, name=theirs[i][0],
                        op=CollectiveOp(theirs[i][1]), dtype=theirs[i][2],
                        shape=tuple(theirs[i][3]), root_rank=theirs[i][4],
                        group=g.index)
                for r, theirs in enumerate(gathered)]
        tag = f"NEGOTIATE_{reqs[0].op.name}"
        if py_events:
            tl.start_activity(name, tag)
            for req in reqs:
                tl.rank_ready(name, req.rank)
        try:
            out.append(table.verdict(i, reqs[0]) if table is not None
                       else validate_py(reqs, g.size))
        finally:
            if py_events:
                tl.end_activity(name, tag)
    return out


def _fingerprints(requests: Sequence[Request], group_size: int
                  ) -> tuple | None:
    """The batch's replay key: every request's ``replay_fingerprint``, or
    None when one has none (or the cache is off)."""
    enabled = _env.eager_cache_enabled()
    fps = []
    for r in requests:
        fp = _proto.replay_fingerprint(r.name, r.op.value, group_size,
                                       (r.op.value,), enabled)
        if fp is None:
            return None
        fps.append(fp)
    return tuple(fps) or None


def negotiate(requests: Sequence[Request],
              g: _state.Group) -> list[Response]:
    """Exchange this rank's batch of requests with every member of ``g`` and
    validate each name across ranks. Collective over the group: every
    member must call it with a batch of the same length and names in the
    same order. Returns one :class:`Response` per request; a batch validated
    before replays its verdict (module docstring)."""
    neg = negotiator()
    fps = _fingerprints(requests, g.size)
    if fps is not None:
        hit = neg.replayed(g.index, fps)
        if hit is not None:
            return hit
    mine = [[r.name, r.op.value, r.dtype, list(r.shape), r.root_rank]
            for r in requests]
    names = [r.name for r in requests]
    gen, seq = neg.next_index(g.index)
    me = g.group_rank_of(_state.global_rank())
    try:
        if me == 0:
            table = _native_round(names, g)
            try:
                try:
                    gathered = neg.collect(g, gen, seq, mine, names, table)
                except _res.WorkerLost as lost:
                    neg.set(_proto.verdict_key(gen, g.index, seq),
                            json.dumps({"error": str(lost), "lost": [
                                list(lost.ranks), list(lost.pids)]}))
                    raise
                try:
                    out = _validate(gathered, g, seq, table)
                except HorovodError as e:
                    verdict = {"error": str(e)}
                    out = None
                else:
                    verdict = {"responses": [
                        [o.name, o.op.value, o.dtype, list(o.tensor_sizes),
                         o.root_rank] for o in out]}
            finally:
                if table is not None:
                    table.drain()
            neg.set(_proto.verdict_key(gen, g.index, seq),
                    json.dumps(verdict))
        else:
            neg.set(_proto.neg_key(gen, g.index, seq, me), json.dumps(mine))
            verdict = neg.await_verdict(g, gen, seq, _batch_name(names))
            out = None
    except HorovodError:
        raise
    except RuntimeError as e:  # the store itself failed
        raise HorovodError(
            f"Coordination service failed while negotiating tensor "
            f"{_batch_name(names)}: {e}") from e
    if verdict.get("lost"):
        ranks, pids = verdict["lost"]
        raise _res.WorkerLost(verdict["error"], ranks=ranks, pids=pids)
    if verdict.get("error"):
        raise HorovodError(verdict["error"])
    if out is None:
        out = [Response(name=n, op=CollectiveOp(op), dtype=dt,
                        tensor_sizes=tuple(sizes), root_rank=root)
               for n, op, dt, sizes, root in verdict["responses"]]
    if fps is not None:
        neg.remember(g.index, fps, out)
    return out

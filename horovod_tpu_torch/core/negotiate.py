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
* every other member waits for the verdict at most
  ``HOROVOD_NEGOTIATION_TIMEOUT`` seconds (default 600), then raises.

A mismatch in dtype, op, shape or root raises :class:`HorovodError` with the
reference's message on every member, before any data moves. A batch of
requests (one per fusion bucket, one per broadcast variable) is one round,
which is what lets the optimizer negotiate its whole gradient plan once per
gradient signature: a step whose plan is cached makes no store call.
"""

from __future__ import annotations

import dataclasses
import enum
import json
import threading
import time
from typing import Sequence

from horovod_tpu_torch.analysis import protocol as _proto
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
        with self._lock:
            gen = self._generation.get(group, 0) + 1
            self._generation[group] = gen
            self._seq[group] = 0
            for k in [k for k in self._sched if k[0] == group]:
                del self._sched[k]
            return gen

    def stalled(self, group: int) -> list[str]:
        """The stall reports recorded for ``group`` since the last call,
        each ``name [ready ranks: [...]] [missing ranks: [...]]``."""
        with self._lock:
            return self._stalls.pop(group, [])

    # -- store calls, counted -----------------------------------------------

    def _call(self, fn, *args):
        self.store_calls += 1
        return fn(*args)

    def set(self, key: str, value: str) -> None:
        self._call(self.store.set, key, value)

    def get(self, key: str) -> bytes:
        return self._call(self.store.get, key)

    def has(self, key: str) -> bool:
        return self._call(self.store.check, [key])

    def delete(self, key: str) -> None:
        self._call(self.store.delete_key, key)

    # -- the two roles ------------------------------------------------------

    def collect(self, g: _state.Group, gen: int, seq: int, mine: list,
                names: list[str]) -> list[list]:
        """Coordinator: every member's batch at this index (its own is
        ``mine``), stall-warning while some are missing; then frees the
        members' keys and the previous index's verdict."""
        batches: list = [mine] + [None] * (g.size - 1)
        missing = list(range(1, g.size))
        last_warn = time.monotonic()
        pause = _POLL_MIN_S
        while missing:
            for r in list(missing):
                key = _proto.neg_key(gen, g.index, seq, r)
                if self.has(key):
                    batches[r] = json.loads(self.get(key))
                    missing.remove(r)
            if not missing:
                break
            now = time.monotonic()
            if self.stall_seconds > 0 and now - last_warn > self.stall_seconds:
                last_warn = now
                self._warn_stalled(g, names, missing)
            time.sleep(pause)
            pause = min(2 * pause, _POLL_MAX_S)
        for r in range(1, g.size):
            self.delete(_proto.neg_key(gen, g.index, seq, r))
        if seq > 0 and g.size > 1:
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
            if time.monotonic() > deadline:
                # The reference's text (multihost.py::negotiate), with its
                # hint adapted: the port has no HOROVOD_EAGER_CACHE.
                raise HorovodError(
                    f"Timed out waiting for the coordinator's verdict on "
                    f"tensor {name} (negotiation index {seq}). With the "
                    f"negotiation plan cache this usually means this "
                    f"process issued a collective its peers did not (they "
                    f"replayed cached plans and never reached index "
                    f"{seq}) — a schedule divergence. Compare the ranks' "
                    f"collective sequences; pass explicit name= arguments "
                    f"to collectives issued from conditional code.")
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


def _validate(gathered: list[list], g: _state.Group) -> list[Response]:
    """The coordinator's verdict over every member's batch: the same length
    and names in the same order, then each name validated; raises the
    reference's messages."""
    for r, theirs in enumerate(gathered):
        if len(theirs) != len(gathered[0]):
            raise HorovodError(
                f"Mismatched negotiation batches: group-local rank {r} "
                f"submitted {len(theirs)} request(s) while rank 0 "
                f"submitted {len(gathered[0])}. All ranks must issue the "
                f"same collectives in the same order.")
    tl = _tl.session()
    out = []
    for i, first in enumerate(gathered[0]):
        name = first[0]
        for r, theirs in enumerate(gathered):
            if theirs[i][0] != name:
                raise HorovodError(
                    f"Mismatched collective sequence across ranks: at "
                    f"negotiation index {i}, rank 0 submitted tensor {name} "
                    f"while rank {r} submitted tensor {theirs[i][0]}. All "
                    f"ranks must issue the same collectives in the same "
                    f"order; pass explicit name= arguments to collectives "
                    f"issued from conditional code.")
        reqs = [Request(rank=r, name=theirs[i][0],
                        op=CollectiveOp(theirs[i][1]), dtype=theirs[i][2],
                        shape=tuple(theirs[i][3]), root_rank=theirs[i][4],
                        group=g.index)
                for r, theirs in enumerate(gathered)]
        tag = f"NEGOTIATE_{reqs[0].op.name}"
        tl.start_activity(name, tag)
        for req in reqs:
            tl.rank_ready(name, req.rank)
        try:
            out.append(validate_py(reqs, g.size))
        finally:
            tl.end_activity(name, tag)
    return out


def negotiate(requests: Sequence[Request],
              g: _state.Group) -> list[Response]:
    """Exchange this rank's batch of requests with every member of ``g`` and
    validate each name across ranks. Collective over the group: every
    member must call it with a batch of the same length and names in the
    same order. Returns one :class:`Response` per request."""
    neg = negotiator()
    mine = [[r.name, r.op.value, r.dtype, list(r.shape), r.root_rank]
            for r in requests]
    names = [r.name for r in requests]
    gen, seq = neg.next_index(g.index)
    me = g.group_rank_of(_state.global_rank())
    try:
        if me == 0:
            gathered = neg.collect(g, gen, seq, mine, names)
            try:
                out = _validate(gathered, g)
            except HorovodError as e:
                verdict = {"error": str(e)}
                out = None
            else:
                verdict = {"responses": [
                    [o.name, o.op.value, o.dtype, list(o.tensor_sizes),
                     o.root_rank] for o in out]}
            if g.size > 1:
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
    if verdict.get("error"):
        raise HorovodError(verdict["error"])
    if out is None:
        out = [Response(name=n, op=CollectiveOp(op), dtype=dt,
                        tensor_sizes=tuple(sizes), root_rank=root)
               for n, op, dt, sizes, root in verdict["responses"]]
    return out

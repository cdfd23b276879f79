"""Name-keyed negotiation: every rank's requests are exchanged and checked.

Counterpart of ``horovod_tpu/core/negotiate.py``. In the JAX package one
controller sees every rank's request; here each rank is a process, so each
member of the group submits its own :class:`Request` s and the batch is
exchanged with ``all_gather_object`` over the group's gloo side group. Every
member then applies the same pure ``validate_requests`` to the same gathered
list, so all members reach the same verdict: a mismatch in dtype, op, shape
or root raises :class:`HorovodError` with the reference's message on every
rank, before any data moves.

A batch of requests (one per fusion bucket, one per broadcast variable) is
exchanged in ONE round, which is what lets the optimizer negotiate its whole
gradient plan once per gradient signature.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Sequence

import torch.distributed as dist

from horovod_tpu_torch.analysis import protocol as _proto
from horovod_tpu_torch.core import state as _state
from horovod_tpu_torch.core import timeline as _tl
from horovod_tpu_torch.core.state import HorovodError


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


def negotiate(requests: Sequence[Request],
              g: _state.Group) -> list[Response]:
    """Exchange this rank's batch of requests with every member of ``g`` and
    validate each name across ranks. Collective over the group: every
    member must call it with a batch of the same length and names in the
    same order. Returns one :class:`Response` per request."""
    mine = [(r.name, r.op.value, r.dtype, tuple(r.shape), r.root_rank)
            for r in requests]
    gathered: list = [None] * g.size
    dist.all_gather_object(gathered, mine, group=g.side)
    for r, theirs in enumerate(gathered):
        if len(theirs) != len(mine):
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
                        shape=theirs[i][3], root_rank=theirs[i][4],
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

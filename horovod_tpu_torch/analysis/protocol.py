"""Request validation for the negotiation layer — a copy of the subset of
``horovod_tpu/analysis/protocol.py`` that the port's runtime calls.

Stdlib-only and side-effect free: ``validate_requests`` is a pure transition
function (requests in, verdict out). The port keeps its own copy rather than
importing the JAX package, whose ``__init__`` pulls in jax. The error strings
are byte-identical to the reference's (``tests/test_torch_collectives.py``
compares them with the JAX package's ``validate_py``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

OP_ALLREDUCE = 0
OP_ALLGATHER = 1
OP_BROADCAST = 2
OP_GATHER = 3
OP_ALLTOALL = 4
OP_REDUCESCATTER = 5

OP_NAMES: dict[int, str] = {
    OP_ALLREDUCE: "allreduce",
    OP_ALLGATHER: "allgather",
    OP_BROADCAST: "broadcast",
    OP_GATHER: "gather",
    OP_ALLTOALL: "alltoall",
    OP_REDUCESCATTER: "reducescatter",
}


@dataclasses.dataclass(frozen=True)
class Req:
    """One rank's intent to run a collective (ints for ops)."""

    rank: int
    name: str
    op: int
    dtype: str
    shape: tuple[int, ...]
    root_rank: int = -1
    group: int = 0


@dataclasses.dataclass(frozen=True)
class Verdict:
    """A validated execution plan, or an error (``error`` set)."""

    name: str = ""
    op: int = -1
    dtype: str = ""
    tensor_sizes: tuple[int, ...] = ()
    root_rank: int = -1
    error: Optional[str] = None


def _dims_str(shape: Sequence[int]) -> str:
    return "[" + ", ".join(str(d) for d in shape) + "]"


def validate_requests(requests: Sequence[Req], group_size: int) -> Verdict:
    """Cross-validate all ranks' requests for one tensor name: dtype match,
    op match, exact shape match for allreduce/broadcast, rank-count +
    trailing-dim match with per-rank first-dim collection for
    allgather/gather, root-rank agreement for broadcast/gather."""
    if not requests:
        return Verdict(error="No requests to validate.")
    first = requests[0]
    name = first.name
    if len(requests) != group_size:
        return Verdict(error=(
            f"Tensor {name} has {len(requests)} request(s) but the group has "
            f"{group_size} rank(s); every rank must submit the collective."))

    seen: set[int] = set()
    for r in requests:
        if r.rank in seen:
            return Verdict(error=(
                f"Tensor {name} was submitted twice by rank {r.rank}."))
        seen.add(r.rank)

    for r in requests[1:]:
        if r.dtype != first.dtype:
            return Verdict(error=(
                f"Mismatched data types: One or more ranks sent tensors of "
                f"type {first.dtype}, but one or more other ranks sent "
                f"tensors of type {r.dtype} for tensor {name}."))
        if r.op != first.op:
            return Verdict(error=(
                f"Mismatched collective operations: One or more ranks did an "
                f"{OP_NAMES[first.op]}, but one or more other ranks did an "
                f"{OP_NAMES[r.op]} on tensor {name}."))

    op = first.op
    tensor_sizes: tuple[int, ...] = ()

    if op in (OP_ALLTOALL, OP_REDUCESCATTER):
        lname = OP_NAMES[op]
        for r in requests[1:]:
            if r.shape != first.shape:
                return Verdict(error=(
                    f"Mismatched {lname} tensor shapes: One or more ranks "
                    f"sent tensors of shape {_dims_str(first.shape)}, but "
                    f"one or more other ranks sent tensors of shape "
                    f"{_dims_str(r.shape)} on tensor {name}."))
        if len(first.shape) == 0 or first.shape[0] % group_size != 0:
            return Verdict(error=(
                f"Invalid {lname} tensor shape: first dimension of tensor "
                f"{name} ({_dims_str(first.shape)}) must be divisible by "
                f"the group size {group_size}."))
    elif op in (OP_ALLREDUCE, OP_BROADCAST):
        for r in requests[1:]:
            if r.shape != first.shape:
                return Verdict(error=(
                    f"Mismatched {OP_NAMES[op]} tensor shapes: One or more "
                    f"ranks sent tensors of shape {_dims_str(first.shape)}, "
                    f"but one or more other ranks sent tensors of shape "
                    f"{_dims_str(r.shape)} on tensor {name}."))
    else:  # ALLGATHER / GATHER: trailing dims must agree, first may vary
        if len(first.shape) == 0:
            return Verdict(error=(
                f"Rank zero tried to {OP_NAMES[op]} a rank-zero tensor "
                f"{name}, which is not allowed."))
        for r in requests[1:]:
            if len(r.shape) != len(first.shape):
                return Verdict(error=(
                    f"Mismatched {OP_NAMES[op]} tensor shapes: One or more "
                    f"ranks sent tensors of rank {len(first.shape)}, but "
                    f"one or more other ranks sent tensors of rank "
                    f"{len(r.shape)} on tensor {name}."))
            if r.shape[1:] != first.shape[1:]:
                return Verdict(error=(
                    f"Mismatched {OP_NAMES[op]} tensor shapes: trailing "
                    f"dimensions of tensor {name} differ between ranks "
                    f"({_dims_str(first.shape)} vs {_dims_str(r.shape)}); "
                    f"only the first dimension may vary."))
        by_rank = sorted(requests, key=lambda r: r.rank)
        tensor_sizes = tuple(r.shape[0] for r in by_rank)

    root_rank = -1
    if op in (OP_BROADCAST, OP_GATHER):
        root_rank = first.root_rank
        for r in requests[1:]:
            if r.root_rank != first.root_rank:
                return Verdict(error=(
                    f"Mismatched {OP_NAMES[op]} root ranks: One rank "
                    f"specified root rank {first.root_rank}, but another "
                    f"rank specified root rank {r.root_rank} for tensor "
                    f"{name}."))
        if not 0 <= root_rank < group_size:
            return Verdict(error=(
                f"Invalid root rank {root_rank} for tensor {name} in a "
                f"group of size {group_size}."))

    return Verdict(name=name, op=op, dtype=first.dtype,
                   tensor_sizes=tensor_sizes, root_rank=root_rank)

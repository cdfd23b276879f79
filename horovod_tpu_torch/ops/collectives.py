"""The fork's four collectives — allreduce, allgather, broadcast, gather.

Counterpart of ``horovod_tpu/ops/collectives.py``'s eager path. There one
controller holds every rank's value and validates them together; here each
rank is a process that passes its own tensor, as each MPI process does in
the reference. Every call:

1. names itself (``name=`` or an auto name ``Horovod<Op>_<k>``, one counter
   per op type — the name is the cross-rank correlation key);
2. negotiates: the ranks exchange their requests and validate them
   (``core/negotiate.py``), so a dtype, shape, op or root mismatch raises
   :class:`HorovodError` with the reference's message on every rank before
   any data moves;
3. moves the data over ``torch.distributed`` on the group's process group
   (NCCL on the GPU, gloo on the CPU).

Return conventions follow the reference: ``allreduce``/``broadcast`` return
a tensor of the input's shape; ``allgather`` the concatenation along dim 0
(first dims may differ across ranks); ``gather`` the concatenation at
``root_rank`` and the rank's own input, unchanged, everywhere else. A rank
that is not a member of ``group`` takes no part and gets ``None`` (``[]``
from ``gather``), the reference's convention for a process that hosts no
member of the group.

Inside an ``spmd`` program (``core/context.py``) a collective registers in
the program's schedule and skips step 2: the program's one schedule
validation (``core/multihost.py``) stands in for it, except in the
program's first, eager call, which negotiates as well. There, as in the
reference's traced collectives, shapes are the same on every rank (the
validation compares them), and ``gather`` gives every member the
concatenation.

``alltoall``, ``reducescatter`` and group families are not ported yet.
"""

from __future__ import annotations

import threading

import torch
import torch.distributed as dist

from horovod_tpu_torch.core import context as _ctx
from horovod_tpu_torch.core import negotiate as _neg
from horovod_tpu_torch.core import state as _state
from horovod_tpu_torch.core import timeline as _tl

_name_counters: dict[str, int] = {}
_name_lock = threading.Lock()


def _auto_name(prefix: str, name: str | None) -> str:
    """Explicit ``name`` or the next ``<prefix>_<k>``. Auto names stay in
    lockstep across ranks only if every rank issues the same sequence of
    auto-named collectives; pass ``name=`` from conditional code."""
    if name is not None:
        return name
    with _name_lock:
        n = _name_counters.get(prefix, 0)
        _name_counters[prefix] = n + 1
        return f"{prefix}_{n}"


def reset_auto_names() -> None:
    """Restart every auto-name counter at 0 (``shutdown`` calls this)."""
    with _name_lock:
        _name_counters.clear()


def dtype_name(dtype: torch.dtype) -> str:
    """The numpy-style dtype name the reference's requests carry
    (``float32``, ``bfloat16``, ``int64``, ``bool``)."""
    return str(dtype).removeprefix("torch.")


def program_register(g: _state.Group, name: str, op: _neg.CollectiveOp,
                     dtype: torch.dtype, shape, root_rank: int = -1,
                     members=None) -> bool:
    """Register a collective in the active ``spmd`` program, if any.
    Returns whether the per-call negotiation runs: outside a program, or
    in a program's first, eager call."""
    ctx = _ctx.current()
    if ctx is None:
        return True
    ctx.register(name, op.name, dtype_name(dtype), tuple(shape), g.index,
                 None if root_rank < 0 else root_rank, members)
    return ctx.negotiate


def _sizes(g: _state.Group, name: str, op: _neg.CollectiveOp,
           x: torch.Tensor, root_rank: int = -1) -> tuple[int, ...] | None:
    """Register and negotiate a gathering collective; the members' first
    dims, equal on every rank when a program skips the negotiation.
    None on a rank that is not a member."""
    negotiating = program_register(g, name, op, x.dtype, x.shape, root_rank)
    if g.pg is None:
        return None
    if negotiating:
        return _negotiate_one(g, name, op, x, root_rank).tensor_sizes
    return (x.shape[0],) * g.size


def _negotiate_one(g: _state.Group, name: str, op: _neg.CollectiveOp,
                   t: torch.Tensor, root_rank: int = -1) -> _neg.Response:
    req = _neg.Request(rank=g.group_rank_of(_state.global_rank()),
                       name=name, op=op, dtype=dtype_name(t.dtype),
                       shape=tuple(t.shape), root_rank=root_rank,
                       group=g.index)
    return _neg.negotiate([req], g)[0]


def divide_avg(x: torch.Tensor, n: int) -> torch.Tensor:
    """Average as the reference does: integer division for integer types."""
    if x.dtype.is_floating_point or x.dtype.is_complex:
        return x / n
    return torch.div(x, n, rounding_mode="floor")


def sum_into(buf: torch.Tensor, g: _state.Group) -> torch.Tensor:
    """Group sum of ``buf``, in place except for bool, which is summed as
    int32 and cast back, as the reference does."""
    if buf.dtype == torch.bool:
        wide = buf.to(torch.int32)
        dist.all_reduce(wide, group=g.pg)
        return wide.to(torch.bool)
    dist.all_reduce(buf, group=g.pg)
    return buf


def allreduce(x: torch.Tensor, group: int = 0, average: bool = True,
              name: str | None = None) -> torch.Tensor | None:
    """Sum (``average=True``: mean) of every member's tensor."""
    name = _auto_name("HorovodAllreduce", name)
    g = _state.get_group(group)
    op = _neg.CollectiveOp.ALLREDUCE
    negotiating = program_register(g, name, op, x.dtype, x.shape)
    if g.pg is None:
        return None
    if negotiating:
        _negotiate_one(g, name, op, x)
    with _tl.activity(name, "ALLREDUCE"):
        out = sum_into(x.clone(), g)
    return divide_avg(out, g.size) if average else out


def _allgather_padded(x: torch.Tensor, g: _state.Group,
                      sizes: tuple[int, ...]) -> torch.Tensor:
    """All-gather with a variable first dim: pad to the negotiated largest
    first dim, gather, trim each rank's block, concatenate."""
    dmax = max(sizes)
    buf = x.new_zeros((dmax,) + tuple(x.shape[1:]))
    buf[: x.shape[0]] = x
    if buf.dtype == torch.bool:
        buf = buf.to(torch.uint8)
    parts = [torch.empty_like(buf) for _ in range(g.size)]
    dist.all_gather(parts, buf, group=g.pg)
    out = torch.cat([p[:s] for p, s in zip(parts, sizes)], dim=0)
    return out.to(x.dtype)


def allgather(x: torch.Tensor, group: int = 0,
              name: str | None = None) -> torch.Tensor | None:
    """Concatenate every member's tensor along dim 0; first dims may
    differ (sizes are exchanged by the negotiation)."""
    name = _auto_name("HorovodAllgather", name)
    g = _state.get_group(group)
    sizes = _sizes(g, name, _neg.CollectiveOp.ALLGATHER, x)
    if sizes is None:
        return None
    with _tl.activity(name, "ALLGATHER"):
        return _allgather_padded(x, g, sizes)


def broadcast_(x: torch.Tensor, root_rank: int, g: _state.Group) -> None:
    """In-place broadcast of ``x`` from group-local ``root_rank`` (no
    negotiation: the caller negotiated). A bool or strided tensor moves
    through a dense staging copy."""
    if x.dtype == torch.bool or not x.is_contiguous():
        wide = x.to(torch.uint8) if x.dtype == torch.bool else x.contiguous()
        dist.broadcast(wide, src=g.ranks[root_rank], group=g.pg)
        x.copy_(wide)
    else:
        dist.broadcast(x, src=g.ranks[root_rank], group=g.pg)


def broadcast(x: torch.Tensor, root_rank: int, group: int = 0,
              name: str | None = None) -> torch.Tensor | None:
    """Every member receives the tensor of group-local rank ``root_rank``."""
    name = _auto_name("HorovodBroadcast", name)
    g = _state.get_group(group)
    op = _neg.CollectiveOp.BROADCAST
    negotiating = program_register(g, name, op, x.dtype, x.shape, root_rank)
    if g.pg is None:
        return None
    if negotiating:
        _negotiate_one(g, name, op, x, root_rank)
    out = x.clone()
    with _tl.activity(name, "BROADCAST"):
        broadcast_(out, root_rank, g)
    return out


def gather(x: torch.Tensor, root_rank: int, group: int = 0,
           name: str | None = None) -> torch.Tensor | list:
    """Rooted gather: the root receives the concatenation along dim 0; every
    other member keeps its own input unchanged — except inside an ``spmd``
    program, where every member receives the concatenation."""
    name = _auto_name("HorovodGather", name)
    g = _state.get_group(group)
    sizes = _sizes(g, name, _neg.CollectiveOp.GATHER, x, root_rank)
    if sizes is None:
        return []
    with _tl.activity(name, "GATHER"):
        gathered = _allgather_padded(x, g, sizes)
    if (_ctx.current() is not None
            or g.group_rank_of(_state.global_rank()) == root_rank):
        return gathered
    return x

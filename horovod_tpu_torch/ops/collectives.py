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

``reducescatter`` sums (never averages, as the reference) and gives each
member its dim-0 block of the sum; ``alltoall`` sends each member its
dim-0 block of every member's tensor. Dim 0 must divide by the group size
and shapes must be equal on every member.

Group families (``group=`` a tuple of group indices) exist only inside a
program, as in the reference: each rank runs the collective on the process
group of the one family group it belongs to. ``allreduce`` takes any
pairwise-disjoint family, and a rank in no listed group gets its input
back (it is a member of the program's group, so it is not ``None``);
``allgather``, ``alltoall`` and ``reducescatter`` need a family whose
groups have equal sizes and cover the program's group. The refusals keep
the reference's text.
"""

from __future__ import annotations

import numbers
import threading

import torch
import torch.distributed as dist

from horovod_tpu_torch.core import context as _ctx
from horovod_tpu_torch.core import negotiate as _neg
from horovod_tpu_torch.core import state as _state
from horovod_tpu_torch.core import timeline as _tl
from horovod_tpu_torch.core.state import HorovodError

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


def _negotiate_one(g: _state.Group, name: str, op: _neg.CollectiveOp,
                   t: torch.Tensor, root_rank: int = -1) -> _neg.Response:
    req = _neg.Request(rank=g.group_rank_of(_state.global_rank()),
                       name=name, op=op, dtype=dtype_name(t.dtype),
                       shape=tuple(t.shape), root_rank=root_rank,
                       group=g.index)
    return _neg.negotiate([req], g)[0]


def _is_group_index(group) -> bool:
    """True for one group index; a family is a sequence of them."""
    return isinstance(group, numbers.Integral)


def _family_positions(ctx: _ctx.ProgramContext, gi: int) -> list[int]:
    """Positions of group ``gi``'s members in the program's group, in
    group-rank order; raises if a member is outside the program's group."""
    target = _state.get_group(gi)
    if gi == ctx.group_index:
        return list(range(target.size))
    prog = _state.get_group(ctx.group_index)
    positions = []
    for r in target.ranks:
        if r not in prog.ranks:
            raise HorovodError(
                f"Group {gi} rank {r} is not part of the mesh the SPMD "
                f"program runs on (group {ctx.group_index}).")
        positions.append(prog.ranks.index(r))
    return positions


def _family_group(ctx: _ctx.ProgramContext, family: tuple, opname: str,
                  uniform: bool) -> _state.Group | None:
    """Check a group family as the reference does and return the family
    group this rank belongs to (None: it is in none). The allreduce family
    may be unequal and need not cover the program's group; the other
    families (``uniform``) must partition it into equal groups."""
    if not uniform and not family:
        raise HorovodError(
            "allreduce group family is empty; pass at least one group "
            "index (or a plain int group).")
    prog = _state.get_group(ctx.group_index)
    seen: set[int] = set()
    sizes = []
    for gi in family:
        pos = _family_positions(ctx, gi)
        overlap = seen & set(pos)
        if overlap and uniform:
            raise HorovodError(
                f"{opname} group family {list(family)} is not pairwise "
                f"disjoint.")
        if overlap:
            raise HorovodError(
                f"allreduce group family {list(family)} is not pairwise "
                f"disjoint (mesh positions {sorted(overlap)} appear twice); "
                f"run overlapping groups as separate collectives.")
        seen |= set(pos)
        sizes.append(len(pos))
    if uniform and len(set(sizes)) != 1:
        raise HorovodError(
            f"{opname} group family {list(family)} has unequal group sizes "
            f"{sorted(set(sizes))}; XLA requires a uniform partition.")
    if uniform and len(seen) != prog.size:
        raise HorovodError(
            f"{opname} group family {list(family)} must cover the "
            f"program's whole mesh ({len(seen)} of {prog.size} positions).")
    me = _state.global_rank()
    return next((g for g in map(_state.get_group, family) if me in g.ranks),
                None)


def _target(name: str, op: _neg.CollectiveOp, x: torch.Tensor, group,
            root_rank: int = -1) -> tuple[_state.Group | None, bool]:
    """Register a collective and resolve where it runs: its group (for a
    family, the family group this rank is in) and whether the per-call
    negotiation runs. The group is None on a rank that takes no part."""
    if _is_group_index(group):
        g = _state.get_group(int(group))
        negotiating = program_register(g, name, op, x.dtype, x.shape,
                                       root_rank)
        return (g if g.pg is not None else None), negotiating
    opname = op.name.lower()
    ctx = _ctx.current()
    if ctx is None:
        raise HorovodError(
            f"Group-family {opname} is only available inside hvd.spmd "
            f"traced code; eagerly, issue one {opname} per group.")
    family = tuple(int(gi) for gi in group)
    ctx.register(name, op.name, dtype_name(x.dtype), tuple(x.shape), family)
    g = _family_group(ctx, family, opname,
                      uniform=op != _neg.CollectiveOp.ALLREDUCE)
    return g, ctx.negotiate


def _sizes(g: _state.Group, negotiating: bool, name: str,
           op: _neg.CollectiveOp, x: torch.Tensor,
           root_rank: int = -1) -> tuple[int, ...]:
    """The members' first dims of a gathering collective: negotiated, or
    equal on every rank where a program skips the negotiation."""
    if negotiating:
        return _negotiate_one(g, name, op, x, root_rank).tensor_sizes
    return (x.shape[0],) * g.size


def _split_checked(g: _state.Group, negotiating: bool, name: str,
                   op: _neg.CollectiveOp, x: torch.Tensor) -> None:
    """Negotiate an alltoall/reducescatter, or, where a program skips the
    negotiation, check its first dim divides as the negotiation would."""
    if negotiating:
        _negotiate_one(g, name, op, x)
    elif x.dim() == 0 or x.shape[0] % g.size != 0:
        raise HorovodError(
            f"Invalid {op.name.lower()} tensor shape: first dimension of "
            f"tensor {name} ({list(x.shape)}) must be divisible by the "
            f"group size {g.size}.")


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


def allreduce(x: torch.Tensor, group=0, average: bool = True,
              name: str | None = None) -> torch.Tensor | None:
    """Sum (``average=True``: mean) of every member's tensor. ``group`` may
    be a family inside a program; a rank in none of its groups gets its
    input back."""
    name = _auto_name("HorovodAllreduce", name)
    op = _neg.CollectiveOp.ALLREDUCE
    g, negotiating = _target(name, op, x, group)
    if g is None:
        return None if _is_group_index(group) else x.clone()
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


def allgather(x: torch.Tensor, group=0,
              name: str | None = None) -> torch.Tensor | None:
    """Concatenate every member's tensor along dim 0; first dims may
    differ (sizes are exchanged by the negotiation). ``group`` may be a
    family of equal groups covering a program's group."""
    name = _auto_name("HorovodAllgather", name)
    op = _neg.CollectiveOp.ALLGATHER
    g, negotiating = _target(name, op, x, group)
    if g is None:
        return None
    sizes = _sizes(g, negotiating, name, op, x)
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
    op = _neg.CollectiveOp.BROADCAST
    g, negotiating = _target(name, op, x, group, root_rank)
    if g is None:
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
    op = _neg.CollectiveOp.GATHER
    g, negotiating = _target(name, op, x, group, root_rank)
    if g is None:
        return []
    sizes = _sizes(g, negotiating, name, op, x, root_rank)
    with _tl.activity(name, "GATHER"):
        gathered = _allgather_padded(x, g, sizes)
    if (_ctx.current() is not None
            or g.group_rank_of(_state.global_rank()) == root_rank):
        return gathered
    return x


def reducescatter(x: torch.Tensor, group=0,
                  name: str | None = None) -> torch.Tensor | None:
    """Sum every member's tensor and give group-local rank ``i`` the
    ``i``-th of ``size`` equal dim-0 blocks of the sum (never averaged).
    ``group`` may be a family of equal groups covering a program's
    group."""
    name = _auto_name("HorovodReducescatter", name)
    op = _neg.CollectiveOp.REDUCESCATTER
    g, negotiating = _target(name, op, x, group)
    if g is None:
        return None
    _split_checked(g, negotiating, name, op, x)
    # Bool is summed as int32 and cast back, as sum_into does.
    buf = (x.to(torch.int32) if x.dtype == torch.bool else x).contiguous()
    blocks = buf.view((g.size, x.shape[0] // g.size) + tuple(x.shape[1:]))
    out = torch.empty_like(blocks[0])
    with _tl.activity(name, "REDUCESCATTER"):
        dist.reduce_scatter(out, list(blocks.unbind(0)), group=g.pg)
    return out.to(x.dtype)


def alltoall(x: torch.Tensor, group=0,
             name: str | None = None) -> torch.Tensor | None:
    """Send group-local rank ``j`` the ``j``-th equal dim-0 block of this
    rank's tensor; the result holds, at block ``m``, what rank ``m`` sent
    here. ``group`` may be a family of equal groups covering a program's
    group."""
    name = _auto_name("HorovodAlltoall", name)
    op = _neg.CollectiveOp.ALLTOALL
    g, negotiating = _target(name, op, x, group)
    if g is None:
        return None
    _split_checked(g, negotiating, name, op, x)
    buf = (x.to(torch.uint8) if x.dtype == torch.bool else x).contiguous()
    out = torch.empty_like(buf)
    with _tl.activity(name, "ALLTOALL"):
        dist.all_to_all_single(out, buf, group=g.pg)
    return out.to(x.dtype)

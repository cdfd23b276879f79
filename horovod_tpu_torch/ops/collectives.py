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

Inside a program, ``allreduce`` also takes the reference's wire knobs:
``compression=`` (``ops/compression.py``), ``algo=`` and ``channels=``
(``ops/strategy.py``), ``cross_compression=`` and ``compression_key=``.
Eager calls always run uncompressed and flat, and refuse them with the
reference's text; a subset group takes the flat lowering (compressed or
not) and refuses phased algorithms and ``channels > 1``; a family refuses
compression and runs flat. The gradient path (``parallel/optimizer.py``)
reaches the same lowering, :func:`compressed_sum`, per fusion bucket.
"""

from __future__ import annotations

import contextlib
import numbers
import threading
import zlib

import torch
import torch.distributed as dist

from horovod_tpu_torch.core import context as _ctx
from horovod_tpu_torch.core import negotiate as _neg
from horovod_tpu_torch.core import state as _state
from horovod_tpu_torch.core import timeline as _tl
from horovod_tpu_torch.core.state import HorovodError
from horovod_tpu_torch.ops import compression as _compression
from horovod_tpu_torch.ops import strategy as _strategy
from horovod_tpu_torch.ops import wire as _wire

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


@contextlib.contextmanager
def preserve_auto_names():
    """Run a block without advancing the auto-name counters for good.

    The schedule drivers (``analysis/schedule.py``) run real step
    functions to record their wire calls; those runs draw auto names from
    the same per-process counters live collectives use, so a recording on
    one process of a job would shift that process's later names — the
    drift lint HVD003 exists to catch. The counters are saved on entry
    and restored on exit."""
    with _name_lock:
        snap = dict(_name_counters)
    try:
        yield
    finally:
        with _name_lock:
            _name_counters.clear()
            _name_counters.update(snap)


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
            root_rank: int = -1,
            members=None) -> tuple[_state.Group | None, bool]:
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
    ctx.register(name, op.name, dtype_name(x.dtype), tuple(x.shape), family,
                 members=members)
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
        _wire.all_reduce(wide, g.pg)
        return wide.to(torch.bool)
    _wire.all_reduce(buf, g.pg)
    return buf


def bucket_key(key, members, name: str, device):
    """The caller's per-step key mixed with the bucket's salt (crc32 of its
    member labels, else its name: stable across runs and ranks), so
    buckets of one step draw independent noise; None stays None."""
    if key is None:
        return None
    salt = "/".join(members) if members else name
    return _compression.mix_key(
        key, zlib.crc32(salt.encode("utf-8")) & 0x7FFFFFFF, device)


def compressed_sum(x: torch.Tensor, g: _state.Group, comp, key, name: str,
                   members=None, algo: str = "flat", topo=None,
                   cross_spec=None, channels: int = 1) -> torch.Tensor:
    """The group sum of ``x`` over ``g`` (this rank a member) through the
    wire compressor ``comp`` (None: uncompressed) and the decomposition
    ``algo``: a summable wire is quantized once, moved by every phase and
    dequantized once; an unsummable one (int4) is gathered
    (``strategy.lower_gathered``); a phase-asymmetric hierarchical bucket
    compresses only its cross-host hop (``strategy.
    lower_hierarchical_asym``). While error feedback collects, records
    this rank's local dequantized contribution (None where it is exact or
    not its own; ``compression.LocalContribution``)."""
    intra_comp, cross_comp, asym = _compression.resolve_phase_formats(
        comp, cross_spec)
    if algo == "hierarchical" and asym:
        _compression.record_local(None)
        return _strategy.lower_hierarchical_asym(
            x, g, topo, name, intra_comp, cross_comp,
            bucket_key(key, members, name, x.device), channels=channels)
    if comp is None or not comp.applies_to(x.dtype):
        _compression.record_local(None)
        return _strategy.lower_allreduce(x, algo, name, topo, g,
                                         channels=channels)
    key = bucket_key(key, members, name, x.device)
    rank = g.group_rank_of(_state.global_rank())
    if not comp.summable:
        return _strategy.lower_gathered(x, comp, algo, name, g, key, rank,
                                        channels=channels)
    wctx = _compression.WireContext(
        group_size=g.size, sum_width=g.size,
        pmax=((lambda v: _strategy.all_sum(v, g.pg, dist.ReduceOp.MAX))
              if g.size > 1 else (lambda v: v)),
        rank_data=rank, key=key)
    wire, meta = _strategy.quantize(name, comp, x, wctx)
    _compression.record_local(
        _compression.LocalContribution(comp, wire, meta, wctx))
    summed = _strategy.lower_allreduce(wire, algo, name, topo, g,
                                       channels=channels)
    return _strategy.dequantize(
        name, lambda: comp.decompress(summed, meta, x.dtype, wctx))


def select_bucket_algo(spec: str, comp, cross_spec, dtype: torch.dtype,
                       elems: int, g: _state.Group, restricted: bool,
                       name: str, nbytes: int, topo=None):
    """``strategy.select`` priced on what each candidate would move: the
    gather-form flat of an unsummable wire, the per-phase bytes of the
    phase-asymmetric hierarchical candidate."""
    kw = {}
    applies = comp is not None and comp.applies_to(dtype)
    if not restricted and (applies or cross_spec is not None):
        intra_c, cross_c, asym = _compression.resolve_phase_formats(
            comp, cross_spec)
        if asym and dtype.is_floating_point:
            kw["phase_nbytes"] = (
                _compression.wire_bytes(elems, dtype, intra_c),
                _compression.wire_bytes(elems, dtype, cross_c))
        if applies and not comp.summable:
            kw["gather"] = True
    return _strategy.select(spec, nbytes=nbytes, group=g,
                            restricted=restricted, name=name, topo=topo,
                            **kw)


def check_restricted_channels(channels: int, name: str) -> None:
    """Subset groups and families run one flat instance: an explicit
    multi-channel request raises."""
    if channels > 1:
        raise HorovodError(
            f"channels={channels} (tensor {name}) requires a full-axis "
            f"single group: subset groups and group families only "
            f"support the single-instance masked-psum lowering. Drop "
            f"channels= or reduce on the full group.")


def _refuse_eager_knobs(comp, cross_compression, algo_spec: str,
                        ch: int) -> None:
    """Eager value collectives run uncompressed and flat (the reference's
    texts)."""
    if comp is not None:
        raise HorovodError(
            f"compression={comp.name!r} is only supported inside hvd.spmd "
            f"traced programs (the compiled gradient path); eager value "
            f"collectives always run uncompressed. Drop compression= or "
            f"move the call inside hvd.spmd.")
    if cross_compression is not None:
        raise HorovodError(
            f"cross_compression={cross_compression!r} is only supported "
            f"inside hvd.spmd traced programs: the per-phase wire format "
            f"is a property of the compiled hierarchical lowering. Drop "
            f"it or move the call inside hvd.spmd.")
    if algo_spec != "flat":
        raise HorovodError(
            f"algo={algo_spec!r} is only supported inside hvd.spmd traced "
            f"programs: the decomposition is a property of the compiled "
            f"lowering. Eager collectives always run the flat psum; drop "
            f"algo= or move the call inside hvd.spmd.")
    if ch != 1:
        raise HorovodError(
            f"channels={ch} is only supported inside hvd.spmd traced "
            f"programs: the channel split is a property of the compiled "
            f"lowering. Eager collectives always run one instance; drop "
            f"channels= or move the call inside hvd.spmd.")


def allreduce(x: torch.Tensor, group=0, average: bool = True,
              name: str | None = None, members: tuple[str, ...] | None = None,
              compression=None, compression_key=None, algo=None,
              cross_compression=None, channels=None) -> torch.Tensor | None:
    """Sum (``average=True``: mean) of every member's tensor. ``group`` may
    be a family inside a program; a rank in none of its groups gets its
    input back. ``members``: the labels of a fusion bucket's tensors.

    Inside a program: ``compression`` (a format name or a
    :class:`~horovod_tpu_torch.ops.compression.Compressor`; None = off —
    ``HOROVOD_COMPRESSION`` is the gradient path's default, not this
    call's), ``compression_key`` (an int or a 0-d int64 tensor for the
    stochastic formats), ``algo`` (``flat``/``rs_ag``/``hierarchical``/
    ``auto``; None = flat), ``cross_compression`` (the hierarchical
    cross-host hop's format) and ``channels`` (None = 1)."""
    name = _auto_name("HorovodAllreduce", name)
    ch = _strategy.resolve_channels(channels)
    comp = (None if compression is None
            else _compression.active(compression))
    algo_spec = _strategy.resolve_spec(algo)
    op = _neg.CollectiveOp.ALLREDUCE
    ctx = _ctx.current()
    full = (ctx is not None and _is_group_index(group)
            and int(group) == ctx.group_index)
    if ctx is None:
        _refuse_eager_knobs(comp, cross_compression, algo_spec, ch)
    elif not full:
        # Subset groups and families: decided on every rank of the
        # program, a non-member included, before any data moves.
        if (not _is_group_index(group) and comp is not None
                and comp.applies_to(x.dtype)):
            raise HorovodError(
                f"Gradient compression ({comp.name}) does not support "
                f"group-family allreduce (tensor {name}): the slot-stacked "
                f"family lowering shares one wire buffer across groups with "
                f"different scales. Issue per-group compressed allreduces "
                f"or drop compression=.")
        _strategy.select(algo_spec, nbytes=0, group=None, restricted=True,
                         name=name)
        check_restricted_channels(ch, name)
    g, negotiating = _target(name, op, x, group, members=members)
    if g is None:
        return None if _is_group_index(group) else x.clone()
    if negotiating:
        _negotiate_one(g, name, op, x)
    concrete, topo = "flat", None
    if full:
        applies = comp is not None and comp.applies_to(x.dtype)
        concrete, topo = select_bucket_algo(
            algo_spec, comp, cross_compression, x.dtype, x.numel(), g,
            False, name, _compression.wire_bytes(
                x.numel(), x.dtype, comp if applies else None,
                sum_width=g.size))
    with _tl.activity(name, "ALLREDUCE"):
        if comp is None and cross_compression is None \
                and concrete == "flat" and ch == 1:
            out = sum_into(x.clone(), g)
        else:
            out = compressed_sum(x, g, comp, compression_key, name, members,
                                 algo=concrete, topo=topo,
                                 cross_spec=cross_compression, channels=ch)
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
    _wire.all_gather(parts, buf, g.pg)
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
        _wire.broadcast(wide, g.ranks[root_rank], g.pg)
        x.copy_(wide)
    else:
        _wire.broadcast(x, g.ranks[root_rank], g.pg)


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
        _wire.reduce_scatter(out, list(blocks.unbind(0)), g.pg)
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
        _wire.all_to_all_single(out, buf, g.pg)
    return out.to(x.dtype)


class AllToAll(torch.autograd.Function):
    """:func:`alltoall` over ``group`` (registered and, in a program's
    first call, negotiated) under ``name``, with an autograd transpose:
    the backward is the same exchange on ``ring``'s process group (the
    family group this rank is in), unregistered, as the reference's
    transposed all-to-all is XLA's and not a collective of its own. A rank
    outside the group gets its input back (and discards it)."""

    @staticmethod
    def forward(ctx, x, group, ring, name=None):
        ctx.ring = ring
        out = alltoall(x.contiguous(), group=group, name=name)
        return x.clone() if out is None else out

    @staticmethod
    def backward(ctx, g):
        if ctx.ring is None:
            return g, None, None, None
        g = g.contiguous()
        out = torch.empty_like(g)
        _wire.all_to_all_single(out, g, ctx.ring.pg)
        return out, None, None, None

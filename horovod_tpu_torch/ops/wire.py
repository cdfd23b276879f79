"""Every collective the port puts on the wire, in one place.

The data path's ``torch.distributed`` calls go through the functions here:
the gradient exchange's lowerings (``ops/strategy.py``), the collectives
and their families (``ops/collectives.py``), synced batch norm's
statistics (``ops/batchnorm.py``), the ring hop of sequence parallelism
(``parallel/sequence.py``) and the calibration probe
(``tune/calibrate.py``). So a :class:`Recorder` sees each call, and no
call can pass it by.

A recorded call is a :class:`~horovod_tpu_torch.analysis.hlo.
CollectiveInstr` in the reference's HLO vocabulary, the counterpart of
one collective instruction of the reference's lowered step:

* ``opcode``: ``all-reduce``, ``reduce-scatter``, ``all-gather``,
  ``all-to-all`` or ``collective-permute`` (the ring hop). A broadcast is
  recorded as ``all-reduce``, the reference's lowering of it (a masked
  psum);
* ``element_type``: the HLO name of what travels (``f32``, ``bf16``,
  ``s8``, ``s32`` ...): where ``strategy._wide`` widens bool or int16 to
  int32 for gloo and NCCL, ``s32``;
* the result's element count by HLO's convention: an all-gather counts
  the gathered size, a reduce-scatter the shard;
* ``replica_groups``: the partition of the world's ranks at the call's
  level (global ranks), as registered by the code that created the
  process groups (``ops/topology.py``), else the one group of the call;
* ``scope``: the innermost phase span (``strategy._phase``) of
  ``analysis.hlo.PHASE_SCOPES``, or None.

A recording pass is live (the calls run and are recorded: a captured
program's defining pass, ``parallel/spmd.py``) or dry (the calls are
recorded and nothing moves: each result is what a world of one would
give, as the reference lowers a step without running it;
``analysis/hlo.py::step_wire``). Outside a pass a call costs one test of
a module global.
"""

from __future__ import annotations

import contextlib
import threading

import torch
import torch.distributed as dist

from horovod_tpu_torch.analysis import hlo as _hlo

# torch dtype -> HLO element type name.
_ETYPE = {
    torch.float32: "f32", torch.float64: "f64", torch.float16: "f16",
    torch.bfloat16: "bf16", torch.int8: "s8", torch.uint8: "u8",
    torch.int16: "s16", torch.int32: "s32", torch.int64: "s64",
    torch.bool: "pred", torch.complex64: "c64", torch.complex128: "c128",
}


def etype(dtype: torch.dtype) -> str:
    """The HLO element type name of ``dtype``."""
    return _ETYPE.get(dtype, str(dtype).removeprefix("torch."))


class Recorder:
    """The collectives of one recording pass, in issue order
    (``instrs``). ``dry``: record without moving anything."""

    def __init__(self, dry: bool = False) -> None:
        self.dry = dry
        self.instrs: list[_hlo.CollectiveInstr] = []
        self._lock = threading.Lock()

    def add(self, opcode: str, dtype: torch.dtype, shape, partition,
            scope: str | None) -> None:
        shape = tuple(int(d) for d in shape)
        numel = 1
        for d in shape:
            numel *= d
        et = etype(dtype)
        with self._lock:
            k = len(self.instrs)
            self.instrs.append(_hlo.CollectiveInstr(
                opcode=opcode, element_type=et, shape=shape,
                replica_groups=partition,
                wire_bytes=numel * _hlo._ITEMSIZE.get(et, 1),
                scope=scope, op_name=None, instr_name=f"{opcode}.{k}",
                line=k + 1))


# The active pass (one a process: autograd runs a CUDA backward on a
# thread of its own, whose calls belong to the same pass).
_active: Recorder | None = None
_scopes = threading.local()
# id(process group) -> the partition of the world's ranks its level forms.
_partitions: dict[int, tuple[tuple[int, ...], ...]] = {}


@contextlib.contextmanager
def recording(dry: bool = False):
    """``with recording() as rec:`` — record every wire call into
    ``rec.instrs`` (``dry``: and move nothing)."""
    global _active
    prev, rec = _active, Recorder(dry)
    _active = rec
    try:
        yield rec
    finally:
        _active = prev


@contextlib.contextmanager
def scope(activity: str):
    """Mark the calls of a block with a phase span's name."""
    stack = getattr(_scopes, "stack", None)
    if stack is None:
        stack = _scopes.stack = []
    stack.append(activity)
    try:
        yield
    finally:
        stack.pop()


def _scope() -> str | None:
    for activity in reversed(getattr(_scopes, "stack", ())):
        if activity in _hlo.PHASE_SCOPES:
            return activity
    return None


def register_partition(pg, parts) -> None:
    """Record that process group ``pg`` is one group of the partition
    ``parts`` (global ranks) of its level."""
    if pg is not None:
        _partitions[id(pg)] = tuple(tuple(sorted(p)) for p in parts)


def forget_partitions() -> None:
    _partitions.clear()


def _partition(pg) -> tuple[tuple[int, ...], ...]:
    if pg is None:
        pg = dist.group.WORLD
    hit = _partitions.get(id(pg))
    if hit is not None:
        return hit
    return (tuple(dist.get_process_group_ranks(pg)),)


def _note(rec: Recorder, opcode: str, dtype, shape, pg) -> None:
    rec.add(opcode, dtype, shape, _partition(pg), _scope())


# -- the calls --------------------------------------------------------------------


def all_reduce(t: torch.Tensor, pg, op=dist.ReduceOp.SUM) -> None:
    """In-place all-reduce of ``t`` over ``pg``."""
    rec = _active
    if rec is not None:
        _note(rec, "all-reduce", t.dtype, t.shape, pg)
        if rec.dry:
            return
    dist.all_reduce(t, op=op, group=pg)


def broadcast(t: torch.Tensor, src: int, pg) -> None:
    """In-place broadcast of ``t`` from global rank ``src`` over ``pg``
    (recorded as the reference's masked-psum all-reduce)."""
    rec = _active
    if rec is not None:
        _note(rec, "all-reduce", t.dtype, t.shape, pg)
        if rec.dry:
            return
    dist.broadcast(t, src=src, group=pg)


def reduce_scatter(out: torch.Tensor, inputs: list, pg) -> None:
    """``out`` = the sum over ``pg`` of every member's block at this
    member's position in ``inputs``."""
    rec = _active
    if rec is not None:
        _note(rec, "reduce-scatter", out.dtype, out.shape, pg)
        if rec.dry:
            out.copy_(inputs[dist.get_rank(group=pg)])
            return
    dist.reduce_scatter(out, inputs, group=pg)


def all_gather(parts: list, t: torch.Tensor, pg) -> None:
    """``parts[j]`` = member j's ``t``."""
    rec = _active
    if rec is not None:
        shape = ((len(parts) * t.shape[0],) + tuple(t.shape[1:])
                 if t.dim() else (len(parts),))
        _note(rec, "all-gather", t.dtype, shape, pg)
        if rec.dry:
            for p in parts:
                p.copy_(t)
            return
    dist.all_gather(parts, t, group=pg)


def all_to_all_single(out: torch.Tensor, t: torch.Tensor, pg) -> None:
    """Tiled all-to-all of ``t`` along dim 0 into ``out``."""
    rec = _active
    if rec is not None:
        _note(rec, "all-to-all", out.dtype, out.shape, pg)
        if rec.dry:
            out.copy_(t)
            return
    dist.all_to_all_single(out, t, group=pg)


def permute(out: torch.Tensor, x: torch.Tensor, to: int, frm: int,
            pg) -> None:
    """Send ``x`` to global rank ``to`` and receive ``out`` from global
    rank ``frm`` on ``pg``, both posted together (a ring hop)."""
    rec = _active
    if rec is not None:
        _note(rec, "collective-permute", x.dtype, x.shape, pg)
        if rec.dry:
            out.copy_(x)
            return
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, x, to, group=pg),
        dist.P2POp(dist.irecv, out, frm, group=pg)])
    for r in reqs:
        r.wait()

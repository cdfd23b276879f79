"""Tensor fusion: batch many small tensors into few large collectives.

Counterpart of ``horovod_tpu/ops/fusion.py``. The enumeration-order plan
is the reference's: buckets are contiguous runs of same-dtype tensors in
submission order; a change of dtype, or a tensor that would push the
bucket past ``HOROVOD_FUSION_THRESHOLD`` bytes, closes the bucket; a
threshold of 0 gives every tensor its own bucket. The whole-step planner
(``ops/exchange.py``) builds on it: its ``priority`` schedule reorders and
resizes the buckets, and :func:`fused_apply_` issues a plan's buckets in
the plan's order. Each bucket is packed into one flat buffer
(``MEMCPY_IN_FUSION_BUFFER``), reduced by ONE collective, and unpacked
(``MEMCPY_OUT_FUSION_BUFFER``): :func:`apply_bucket_` is that step for one
bucket, which the overlapped exchange (``parallel/optimizer.py``) issues
from backward one bucket at a time.

Wire compression and the decomposition annotate a bucket (its wire dtype,
its algorithm, its channel count, and the per-phase wire of a
phase-asymmetric hierarchical bucket) but never move its boundaries, which
are planned on the logical bytes. A sparse gradient's exchange is planned
as one :class:`SparseBucket` row (``ops/sparse.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import torch

from horovod_tpu_torch.core import timeline as _tl


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


@dataclasses.dataclass(frozen=True)
class Bucket:
    """One fused collective: the indices of same-dtype tensors it carries,
    their dtype and total bytes.

    ``wire_dtype``: the dtype its collective moves under compression (None
    = ``dtype``); ``wire_bits``: bits per logical element where they
    differ from the wire dtype's width (int4: 4). ``algo``: its
    decomposition (``ops/strategy.py``); ``channels``: its channel count;
    ``priority``: its issue position. A phase-asymmetric hierarchical
    bucket has no single wire: ``intra_wire_dtype`` (None = the logical
    dtype) is what the intra-host phases move, ``cross_wire_dtype`` and
    ``cross_wire_bits`` what the cross-host hop moves.
    """

    indices: tuple[int, ...]
    dtype: torch.dtype
    total_bytes: int
    wire_dtype: torch.dtype | None = None
    algo: str = "flat"
    priority: int = 0
    wire_bits: int = 0
    intra_wire_dtype: torch.dtype | None = None
    cross_wire_dtype: torch.dtype | None = None
    cross_wire_bits: int = 0
    channels: int = 1

    @property
    def elems(self) -> int:
        return self.total_bytes // self.dtype.itemsize

    @property
    def bytes_on_wire(self) -> int:
        """Bytes the bucket's (single-phase) collective moves."""
        if self.wire_bits:
            return self.elems * self.wire_bits // 8
        if self.wire_dtype is None:
            return self.total_bytes
        return self.elems * self.wire_dtype.itemsize

    @property
    def cross_bytes_on_wire(self) -> int:
        """Full-bucket-equivalent bytes of the cross-host hop."""
        if self.cross_wire_dtype is None:
            return self.bytes_on_wire
        if self.cross_wire_bits:
            return self.elems * self.cross_wire_bits // 8
        return self.elems * self.cross_wire_dtype.itemsize

    @property
    def intra_bytes_on_wire(self) -> int:
        """Full-bucket-equivalent bytes of one intra-host phase."""
        if self.cross_wire_dtype is None:
            return self.bytes_on_wire
        if self.intra_wire_dtype is None:
            return self.total_bytes
        return self.elems * self.intra_wire_dtype.itemsize

    def describe(self) -> str:
        """One line: the reference's format."""
        if self.cross_wire_dtype is not None:
            intra = ("f" + str(self.dtype.itemsize * 8)
                     if self.intra_wire_dtype is None
                     else _dtype_name(self.intra_wire_dtype))
            wire = (f" wire=intra:{intra}"
                    f"/cross:{_dtype_name(self.cross_wire_dtype)}"
                    f":{self.cross_bytes_on_wire}B")
        elif self.wire_dtype is not None:
            wire = (f" wire={_dtype_name(self.wire_dtype)}"
                    f":{self.bytes_on_wire}B")
        else:
            wire = ""
        return (f"bucket[{len(self.indices)} tensors, {self.elems} "
                f"{_dtype_name(self.dtype)}, {self.total_bytes}B, "
                f"algo={self.algo}{wire}, ch={self.channels}, "
                f"prio={self.priority}]")


@dataclasses.dataclass(frozen=True)
class SparseBucket:
    """One sparse (IndexedSlices) gradient exchange, as
    ``ops/sparse.py::plan_sparse_exchange`` resolves it.

    ``index`` is the leaf's position among all the gradients; ``rows`` the
    padded per-rank row capacity of the gather wire; ``row_elems`` the
    elements of one slice row; ``dense_rows`` the table's row count
    (``dense_shape[0]``); ``algo`` the resolved exchange, ``gather``
    (padded allgather + dedup-and-merge) or ``dense`` (densify +
    allreduce). ``wire_dtype``/``wire_bits``: the gather-form value
    payload's wire under compression (None = the logical dtype); indices
    move uncompressed at ``index_itemsize`` bytes each.
    """

    index: int
    dtype: torch.dtype
    rows: int
    row_elems: int
    dense_rows: int
    algo: str = "gather"
    wire_dtype: torch.dtype | None = None
    wire_bits: int = 0
    index_itemsize: int = 4
    label: str = ""

    @property
    def values_bytes(self) -> int:
        """Logical bytes of one rank's padded value block."""
        return self.rows * self.row_elems * self.dtype.itemsize

    @property
    def payload_wire_bytes(self) -> int:
        """Bytes of one rank's gather payload: the value block in its wire
        format, and the indices."""
        if self.wire_bits:
            vals = self.rows * self.row_elems * self.wire_bits // 8
        elif self.wire_dtype is not None:
            vals = self.rows * self.row_elems * self.wire_dtype.itemsize
        else:
            vals = self.values_bytes
        return vals + self.rows * self.index_itemsize

    @property
    def dense_bytes(self) -> int:
        """Bytes of the densified table (the dense exchange's payload)."""
        return self.dense_rows * self.row_elems * self.dtype.itemsize

    def describe(self) -> str:
        wire = ""
        if self.wire_dtype is not None:
            wire = f" wire={_dtype_name(self.wire_dtype)}"
        return (f"sparse[leaf {self.index}"
                f"{' ' + self.label if self.label else ''}, "
                f"{self.rows}x{self.row_elems} {_dtype_name(self.dtype)} of "
                f"{self.dense_rows} rows, algo={self.algo}{wire}, "
                f"payload={self.payload_wire_bytes}B]")


def plan_buckets(leaves: Sequence[torch.Tensor], threshold_bytes: int,
                 compression=None, algo=None, group_size: int | None = None,
                 cross_compression=None) -> list[Bucket]:
    """The reference's plan, annotated: ``compression`` (a resolved
    compressor or None) stamps each bucket's wire dtype (``group_size``
    is the in-wire sum width of the block budget); ``algo`` (a name or a
    ``bucket -> name`` selector, which sees the wire-annotated bucket)
    its decomposition; ``cross_compression`` the per-phase wire of
    hierarchical buckets. Priorities are plan positions. The buckets come
    from the native planner (``hvd_core_plan_fusion``) when the native
    core is loaded, else from :func:`plan_buckets_py`: the same plan."""
    from horovod_tpu_torch.core import state as _state

    native = _state.native_core()
    if native is not None and leaves:
        buckets = plan_buckets_native(native, leaves, threshold_bytes)
    else:
        buckets = plan_buckets_py(leaves, threshold_bytes)
    buckets = _annotate_algo(_annotate_wire(buckets, compression,
                                            group_size), algo)
    buckets = _annotate_phase_wire(buckets, compression, cross_compression)
    return [dataclasses.replace(b, priority=i)
            for i, b in enumerate(buckets)]


def _annotate_wire(buckets: list[Bucket], compression,
                   group_size: int | None = None) -> list[Bucket]:
    if compression is None:
        return buckets
    from horovod_tpu_torch.ops import compression as _comp

    out = []
    for b in buckets:
        wire = _comp.wire_dtype_of(compression, b.dtype, group_size)
        if wire == b.dtype:
            out.append(b)
            continue
        bits = compression.WIRE_BITS
        out.append(dataclasses.replace(
            b, wire_dtype=wire,
            wire_bits=(bits if bits and bits != wire.itemsize * 8 else 0)))
    return out


def _annotate_phase_wire(buckets: list[Bucket], compression,
                         cross_compression=None) -> list[Bucket]:
    """Per-phase wire formats of phase-asymmetric hierarchical buckets
    (what ``strategy.lower_hierarchical_asym`` moves); their single-phase
    ``wire_dtype`` is cleared."""
    if compression is None and cross_compression is None:
        return buckets
    from horovod_tpu_torch.ops import compression as _comp

    intra, cross, asym = _comp.resolve_phase_formats(compression,
                                                     cross_compression)
    if not asym:
        return buckets
    out = []
    for b in buckets:
        if b.algo != "hierarchical" or not b.dtype.is_floating_point:
            out.append(b)
            continue
        cross_applies = cross is not None and cross.applies_to(b.dtype)
        intra_dt = (None if intra is None
                    else _comp.wire_dtype_of(intra, b.dtype, None))
        if intra_dt is not None and intra_dt == b.dtype:
            intra_dt = None
        if not cross_applies and intra_dt is None:
            out.append(dataclasses.replace(b, wire_dtype=None,
                                           wire_bits=0))
            continue
        cross_dt = (_comp.wire_dtype_of(cross, b.dtype, None)
                    if cross_applies else b.dtype)
        cross_bits = cross.WIRE_BITS if cross_applies else 0
        out.append(dataclasses.replace(
            b, wire_dtype=None, wire_bits=0,
            intra_wire_dtype=intra_dt, cross_wire_dtype=cross_dt,
            cross_wire_bits=(cross_bits if cross_bits
                             and cross_bits != cross_dt.itemsize * 8
                             else 0)))
    return out


def _annotate_algo(buckets: list[Bucket], algo) -> list[Bucket]:
    if algo is None:
        return buckets
    pick = algo if callable(algo) else (lambda b: algo)
    return [dataclasses.replace(b, algo=pick(b)) for b in buckets]


def _split_units(b: Bucket, world: int, slices: int, compression) -> int:
    """How many units the channelized lowering of ``b`` can cut: shard
    elements for the phased algorithms, packed block rows where a block
    wire is what splits."""
    elems = max(1, b.elems)
    block = getattr(compression, "block", 0) or 0
    unsummable = b.wire_bits == 4 or b.cross_wire_bits == 4
    if b.algo == "rs_ag":
        if unsummable and block:
            nb = -(-elems // block)
            return max(1, -(-nb // world))
        return max(1, -(-elems // world))
    if b.algo == "hierarchical":
        local = (world // slices
                 if slices > 1 and world % slices == 0 else 0)
        if local > 1:
            return max(1, -(-elems // local))
        return elems
    if unsummable and block:
        return max(1, -(-elems // block))
    return elems


def leaf_bytes(leaf) -> int:
    """Logical bytes of a tensor, or of any object with ``.numel()`` or
    an integer ``.size``, and a ``.dtype``."""
    numel = getattr(leaf, "numel", None)
    n = numel() if callable(numel) else leaf.size
    return int(n) * leaf.dtype.itemsize


def plan_buckets_native(native, leaves: Sequence[torch.Tensor],
                        threshold_bytes: int) -> list[Bucket]:
    """The reference's fusion plan by the native planner of ``native`` (a
    ``core/native`` ``NativeCore``): dtypes coded by first appearance, as
    the reference codes them."""
    dtype_codes: dict = {}
    codes = []
    nbytes = []
    for leaf in leaves:
        codes.append(dtype_codes.setdefault(str(leaf.dtype),
                                            len(dtype_codes)))
        nbytes.append(leaf_bytes(leaf))
    members: list[list[int]] = []
    for i, bid in enumerate(native.plan_fusion(threshold_bytes, nbytes,
                                               codes)):
        if bid == len(members):
            members.append([])
        members[bid].append(i)
    return [Bucket(tuple(ix), leaves[ix[0]].dtype,
                   sum(nbytes[i] for i in ix)) for ix in members]


def plan_buckets_py(leaves: Sequence[torch.Tensor],
                    threshold_bytes: int) -> list[Bucket]:
    """The reference's fusion planner over ``leaves`` in order."""
    buckets: list[Bucket] = []
    cur: list[int] = []
    cur_dtype = None
    cur_bytes = 0

    def flush():
        nonlocal cur, cur_bytes
        if cur:
            buckets.append(Bucket(tuple(cur), cur_dtype, cur_bytes))
            cur, cur_bytes = [], 0

    for i, leaf in enumerate(leaves):
        nbytes = leaf_bytes(leaf)
        if threshold_bytes <= 0:
            buckets.append(Bucket((i,), leaf.dtype, nbytes))
            continue
        if cur and (leaf.dtype != cur_dtype
                    or cur_bytes + nbytes > threshold_bytes):
            flush()
        cur_dtype = leaf.dtype
        cur.append(i)
        cur_bytes += nbytes
    flush()
    return buckets


def record_schedule(schedule) -> None:
    """Write ``schedule``'s SCHEDULE activity on the timeline (row
    ``_fusion_buffer``): the plan's hash and mode and each bucket, as the
    reference's does; once a step, before its buckets."""
    tl = _tl.session()
    if tl.active:
        tl.start_activity("_fusion_buffer", "SCHEDULE")
        tl.event("_fusion_buffer",
                 f"plan={schedule.plan_hash()} mode={schedule.mode}", "X")
        for bucket in schedule.buckets:
            tl.event("_fusion_buffer", bucket.describe(), "X")
        tl.end_activity("_fusion_buffer", "SCHEDULE")


def apply_bucket_(leaves: Sequence[torch.Tensor], bucket: Bucket,
                  collective: Callable[[torch.Tensor], torch.Tensor],
                  name: str) -> None:
    """One bucket's step: its members of ``leaves`` packed into one flat
    buffer, ``collective(flat) -> flat``, and the result written back
    into them in place."""
    with _tl.activity(name, "MEMCPY_IN_FUSION_BUFFER"):
        if len(bucket.indices) == 1:
            flat = leaves[bucket.indices[0]].reshape(-1).clone()
        else:
            flat = torch.cat([leaves[i].reshape(-1) for i in bucket.indices])
    flat = collective(flat)
    with _tl.activity(name, "MEMCPY_OUT_FUSION_BUFFER"):
        offset = 0
        for i in bucket.indices:
            n = leaves[i].numel()
            leaves[i].copy_(flat[offset: offset + n].view_as(leaves[i]))
            offset += n


def fused_apply_(leaves: Sequence[torch.Tensor], schedule,
                 collective: Callable[[torch.Tensor, int], torch.Tensor],
                 names: Sequence[str]) -> None:
    """Run ``collective(flat, b) -> flat`` once per bucket of ``schedule``
    (an :class:`~horovod_tpu_torch.ops.exchange.ExchangeSchedule`), ``b``
    its issue position, in the schedule's order, and write the results
    back into ``leaves`` in place. ``names[b]`` labels bucket ``b`` on the
    timeline, after the schedule's SCHEDULE activity
    (:func:`record_schedule`)."""
    record_schedule(schedule)
    for b, bucket in enumerate(schedule.buckets):
        apply_bucket_(leaves, bucket,
                      lambda flat, b=b: collective(flat, b), names[b])


def fused_tree_apply(tree, collective: Callable[[torch.Tensor],
                                                torch.Tensor],
                     threshold_bytes: int):
    """The reference's pytree wrapper: ``collective(flat) -> flat`` over
    the fused buckets of ``tree``'s tensors (nested dicts, lists and
    tuples), enumeration plan at ``threshold_bytes``; returns a new tree
    of the same structure and leaves ``tree`` as it was."""
    from torch.utils import _pytree as pytree

    from horovod_tpu_torch.ops import exchange as _exchange

    leaves, spec = pytree.tree_flatten(tree)
    out = [t.clone() for t in leaves]
    plan = _exchange.plan_exchange(out, threshold_bytes, mode="enum")
    fused_apply_(out, plan, lambda flat, b: collective(flat),
                 [f"fused_tree_apply.bucket_{b}"
                  for b in range(len(plan.buckets))])
    return pytree.tree_unflatten(out, spec)

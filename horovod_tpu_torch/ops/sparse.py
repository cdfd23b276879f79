"""Sparse gradient exchange — the reference's IndexedSlices path.

Counterpart of ``horovod_tpu/ops/sparse.py``. In the reference
``hvd.allreduce`` on a ``tf.IndexedSlices`` does not allreduce: it allgathers
values and indices, so every rank applies every rank's sparse update — the
mechanism behind word2vec's embedding gradients. :class:`IndexedSlices`
carries such a gradient (``dense[indices[i]] += values[i]``), and
:func:`allreduce_indexed_slices` exchanges it:

``gather`` (the default)
    Inside an ``spmd`` program on the program's group: each rank's (values,
    indices) are padded to a fixed row capacity (pad rows are index 0,
    value 0: scatter-add-neutral), allgathered, and **dedup-and-merged**
    (:func:`dedup_merge`): duplicate rows are summed once, so the apply
    adds one merged row per unique index. Indices travel as int32, as in
    the reference, and are widened to int64 only where torch indexes.
``dense``
    Densify and allreduce the whole table.

``auto``
    The density switch: ``gather`` or ``dense``, whichever the α–β cost
    model (``utils/costs.py``) prices cheaper over the group's topology;
    ``HOROVOD_SPARSE_DENSITY_THRESHOLD`` overrides the model's crossover.

``compression=`` quantizes the gather's VALUE payload in gather form: each
rank compresses with ``sum_width=1`` (local scales, the whole integer
range, nothing summed on the wire), the wire and its scales are gathered,
and every rank's rows are dequantized into an fp32 accumulator before the
merge; indices never compress. The dense exchange takes the same knob on
its allreduce.

Eager calls and subset groups run the reference's plain gather (no pad, no
merge, no compression; on a subset group the members average and a
non-member gets ``None``, the port's convention) and refuse everything
beyond it with the reference's text.

The merge is deterministic on every device: a stable sort, then each
segment's rows summed in order by ``torch.segment_reduce`` over offsets
found by ``searchsorted`` — no float atomics (``index_add_`` on CUDA sums
duplicates in an order that changes from run to run, which would let the
replicas' tables drift apart) and no shape read from the data, so the
exchange can be captured in a CUDA graph. Every rank merges the same
gathered rows, so the replicas stay identical.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.utils._pytree as pytree

from horovod_tpu_torch.core import context as _ctx
from horovod_tpu_torch.core import state as _state
from horovod_tpu_torch.core import timeline as _tl
from horovod_tpu_torch.core.state import HorovodError
from horovod_tpu_torch.ops import collectives as _coll
from horovod_tpu_torch.ops import compression as _compression
from horovod_tpu_torch.ops import fusion as _fusion
from horovod_tpu_torch.ops import strategy as _strategy
from horovod_tpu_torch.ops import topology as _topology
from horovod_tpu_torch.utils import costs as _costs
from horovod_tpu_torch.utils import env as _env

SPARSE_ALGORITHMS = ("gather", "dense")


@dataclasses.dataclass
class IndexedSlices:
    """Sparse rows of a larger dense tensor: ``dense[indices[i]] +=
    values[i]``. ``dense_shape[0]`` is the table's row count. A pytree node
    (``dense_shape`` its context), so it passes in and out of ``spmd``."""

    values: torch.Tensor  # (n, *slice_shape)
    indices: torch.Tensor  # (n,) integer
    dense_shape: tuple[int, ...]

    def to_dense(self) -> torch.Tensor:
        """The dense tensor: duplicate rows are merged first, in a fixed
        order, so the result does not depend on the device's atomics."""
        values, indices = dedup_merge(self.values, self.indices)
        out = values.new_zeros(self.dense_shape)
        return out.index_add_(0, indices.long(), values)


pytree.register_pytree_node(
    IndexedSlices,
    lambda s: ([s.values, s.indices], tuple(s.dense_shape)),
    lambda children, shape: IndexedSlices(children[0], children[1], shape),
    serialized_type_name="horovod_tpu_torch.ops.sparse.IndexedSlices")


def scatter_add_(dense: torch.Tensor, slices: IndexedSlices,
                 alpha: float = 1.0) -> torch.Tensor:
    """``dense[indices] += alpha * values`` in place, duplicate rows merged
    first (deterministic on the card: each index receives at most one
    nonzero row). Returns ``dense``."""
    values, indices = dedup_merge(slices.values, slices.indices)
    return dense.index_add_(0, indices.long(), values, alpha=alpha)


def resolve_sparse_algo(spec) -> str:
    """Normalize an ``algo=`` of the sparse exchange: ``None`` →
    ``"gather"``; strings are validated, typos raise."""
    if spec is None:
        return "gather"
    if not isinstance(spec, str):
        raise HorovodError(
            f"sparse algo= must be None or a string, got "
            f"{type(spec).__name__}.")
    value = spec.strip().lower()
    if value not in (*SPARSE_ALGORITHMS, "auto"):
        raise HorovodError(
            f"Unknown sparse exchange algorithm {spec!r}; choose one of "
            f"{list(SPARSE_ALGORITHMS)} or 'auto' "
            f"(allreduce_indexed_slices / allreduce_gradients "
            f"sparse_algo=).")
    return value


def dedup_merge(values: torch.Tensor, indices: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Sort rows by index and sum duplicates into one row per unique index —
    the dedup-and-merge half of the sparse exchange.

    Shapes are static: the result keeps the input's ``(N, *slice)``
    capacity, each unique index's summed row at its first sorted slot and
    the unused tail at (index 0, value 0), the pad-row convention. Each
    segment is summed in its rows' order (the stable sort keeps duplicates
    in input order), from zero, as the reference's scatter-add does; no
    float atomics and no host synchronisation."""
    n = indices.shape[0]
    if n == 0:
        return values, indices
    order = torch.argsort(indices, stable=True)
    sidx = indices[order]
    svals = values[order]
    first = torch.ones(n, dtype=torch.bool, device=indices.device)
    first[1:] = sidx[1:] != sidx[:-1]
    seg = torch.cumsum(first, 0) - 1  # segment id of each sorted row
    # offsets[s] = the first sorted row of segment s (n past the last).
    offsets = torch.searchsorted(
        seg, torch.arange(n + 1, device=indices.device))
    merged = torch.segment_reduce(svals, "sum", offsets=offsets, axis=0,
                                  unsafe=True)
    starts = offsets[:n]
    midx = torch.where(starts < n, sidx[starts.clamp(max=n - 1)],
                       torch.zeros_like(sidx))
    return merged, midx


def _resolve_capacity(n: int, pad_capacity) -> int:
    """The per-rank padded row capacity: explicit argument >
    ``HOROVOD_SPARSE_PAD_CAPACITY`` > the natural row count (no pad)."""
    cap = _env.sparse_pad_capacity() if pad_capacity is None \
        else int(pad_capacity)
    if cap <= 0:
        return n
    if cap < n:
        raise HorovodError(
            f"sparse pad capacity {cap} is smaller than the {n} rows this "
            f"rank holds — rows would be silently dropped. Raise "
            f"HOROVOD_SPARSE_PAD_CAPACITY / pad_capacity= to at least "
            f"the per-rank row count.")
    return cap


def _padded(slices: IndexedSlices, cap: int):
    """(values, indices) padded to ``cap`` rows; pad rows are (index 0,
    value 0) — in range and scatter-add-neutral."""
    n = slices.indices.shape[0]
    if cap == n:
        return slices.values, slices.indices
    values = torch.cat([slices.values, slices.values.new_zeros(
        (cap - n,) + tuple(slices.values.shape[1:]))])
    indices = torch.cat([slices.indices, slices.indices.new_zeros(cap - n)])
    return values, indices


def _density_threshold() -> float | None:
    """The density switch's threshold: explicit env > an applied tuned
    config (``tune/apply.py``) > None, the cost model's own crossover."""
    value = _env.sparse_density_threshold()
    if value is None:
        from horovod_tpu_torch.tune import apply as _tune_apply

        tuned = _tune_apply.override("HOROVOD_SPARSE_DENSITY_THRESHOLD")
        if tuned is not None:
            value = float(tuned)
    return value


def plan_sparse_exchange(slices: IndexedSlices, group: int = 0, algo=None,
                         compression=None, index: int = 0,
                         pad_capacity=None, label: str = ""
                         ) -> _fusion.SparseBucket:
    """Resolve one IndexedSlices exchange to its plan row — the one decision
    source of :func:`allreduce_indexed_slices` and ``allreduce_gradients``.
    Host-side and deterministic: the capacity from static shapes, ``auto``
    from the cost model over the discovered topology."""
    spec = resolve_sparse_algo(algo)
    comp = None if compression is None else _compression.active(compression)
    g = _state.get_group(group)
    n = int(slices.indices.shape[0])
    cap = _resolve_capacity(n, pad_capacity)
    shape = tuple(slices.values.shape[1:])
    row_elems = 1
    for d in shape:
        row_elems *= int(d)
    dense_rows = int(slices.dense_shape[0])
    dtype = slices.values.dtype
    idx_itemsize = slices.indices.dtype.itemsize
    applies = comp is not None and comp.applies_to(dtype)
    if spec == "auto":
        topo = _topology.discover(g)
        model = _costs.model_for(topo)
        # Gather-form wire: sum_width=1; the dense candidate moves its own
        # wire under the same knob.
        row_wire = _compression.wire_bytes(row_elems, dtype,
                                           comp if applies else None,
                                           sum_width=1)
        dense_elems = 1
        for d in slices.dense_shape:
            dense_elems *= int(d)
        dense_wire = _compression.wire_bytes(dense_elems, dtype,
                                             comp if applies else None,
                                             sum_width=g.size)
        spec = model.choose_sparse(
            rows_per_rank=cap, row_bytes=row_wire + idx_itemsize,
            dense_nbytes=dense_wire, dense_rows=dense_rows, topo=topo,
            density_threshold=_density_threshold(),
            gather_phases=3 if applies else 2,
            dense_gather=applies and not comp.summable)
    wire_dtype = None
    wire_bits = 0
    if spec == "gather" and applies:
        wire_dtype = _compression.wire_dtype_of(comp, dtype, 1)
        bits = comp.WIRE_BITS
        wire_bits = (bits if bits and bits != wire_dtype.itemsize * 8
                     else 0)
    return _fusion.SparseBucket(
        index=index, dtype=dtype, rows=cap, row_elems=row_elems,
        dense_rows=dense_rows, algo=spec, wire_dtype=wire_dtype,
        wire_bits=wire_bits, index_itemsize=idx_itemsize, label=label)


def allreduce_indexed_slices(slices: IndexedSlices, group: int = 0,
                             average: bool = True, name: str | None = None,
                             algo=None, compression=None,
                             compression_key=None, pad_capacity=None,
                             _plan: _fusion.SparseBucket | None = None
                             ) -> IndexedSlices | None:
    """Exchange sparse updates across the group (the reference's allgather
    of values and indices; ``average`` divides the values by the group's
    size). Inside an ``spmd`` program on its own group: the padded gather
    with dedup-and-merge (``algo="gather"``, the default), densify +
    allreduce (``"dense"``) or the density switch (``"auto"``);
    ``compression`` quantizes the gather's value payload (gather form) or
    the dense allreduce, ``compression_key`` keys its rounding. Eager calls
    and subset groups: the plain gather. ``pad_capacity``: per-rank row
    capacity (default ``HOROVOD_SPARSE_PAD_CAPACITY``; 0/unset = the
    natural row count). A rank outside ``group`` gets ``None``.
    ``_plan``: the row :func:`plan_sparse_exchange` resolved
    (``allreduce_gradients`` plans once). Internal."""
    name = _coll._auto_name("HorovodSparseAllreduce", name)
    if not _coll._is_group_index(group):
        raise HorovodError(
            "Group-family sparse allreduce is not supported: an "
            "IndexedSlices exchange targets a single group; issue one "
            "allreduce_indexed_slices per group.")
    spec = resolve_sparse_algo(algo)
    comp = None if compression is None else _compression.active(compression)
    ctx = _ctx.current()
    if ctx is None or int(group) != ctx.group_index:
        _refuse_beyond_gather(spec, comp, pad_capacity, name,
                              "eager calls" if ctx is None
                              else "subset groups")
        return _legacy_gather(slices, int(group), average, name)
    bucket = _plan if _plan is not None else plan_sparse_exchange(
        slices, group=group, algo=spec, compression=comp,
        pad_capacity=pad_capacity)
    if bucket.algo == "dense":
        return _dense_exchange(slices, group, average, name, comp,
                               compression_key)
    return _gather_exchange(slices, group, average, name, comp,
                            compression_key, bucket.rows)


def _refuse_beyond_gather(spec: str, comp, pad_capacity, name: str,
                          where: str) -> None:
    """Eager calls and subset groups run the plain gather only."""
    if spec != "gather":
        raise HorovodError(
            f"sparse algo={spec!r} (tensor {name}) requires the full-axis "
            f"single group inside hvd.spmd: {where} run the plain "
            f"reference gather exchange only. Drop algo= or reduce on "
            f"the full group.")
    if comp is not None:
        raise HorovodError(
            f"Sparse value-payload compression ({comp.name}) requires the "
            f"full-axis single group inside hvd.spmd (tensor {name}): "
            f"{where} run the uncompressed reference gather exchange. "
            f"Drop compression= or reduce on the full group.")
    if pad_capacity is not None:
        raise HorovodError(
            f"pad_capacity= (tensor {name}) requires the full-axis single "
            f"group inside hvd.spmd: {where} exchange the natural row "
            f"count. Drop the argument or reduce on the full group.")


def _legacy_gather(slices: IndexedSlices, group: int, average: bool,
                   name: str) -> IndexedSlices | None:
    """The reference's plain exchange: allgather of values and indices,
    members averaging; ``None`` on a rank outside ``group``."""
    values = _coll.allgather(slices.values, group=group,
                             name=name + "_values")
    indices = _coll.allgather(slices.indices, group=group,
                              name=name + "_indices")
    if values is None:
        return None
    if average:
        values = values / _state.get_group(group).size
    return IndexedSlices(values, indices, slices.dense_shape)


def _gather_exchange(slices: IndexedSlices, group: int, average: bool,
                     name: str, comp, key, cap: int) -> IndexedSlices:
    """Pad → (quantize) → allgather value (and scale) and index blocks →
    dequantize into the fp32 accumulator → dedup-and-merge → average."""
    g = _state.get_group(group)
    values, indices = _padded(slices, cap)
    orig_dtype = values.dtype
    if comp is not None and comp.applies_to(orig_dtype):
        # sum_width=1: nothing is summed on the wire, so every rank
        # quantizes at the full integer range with LOCAL scales (the
        # identity pmax), which travel beside the payload.
        wctx = _compression.WireContext(
            group_size=g.size, sum_width=1,
            rank_data=g.group_rank_of(_state.global_rank()), key=key)
        wire, meta = _strategy.quantize(name, comp, values, wctx)
        gfn = _named_gather(group, g.size, [name + "_values",
                                            name + "_scales"])
        with _tl.activity(name, "DEQUANTIZE"):
            rows = comp.gathered_rows(gfn, wire, meta, torch.float32, wctx)
        gvals = rows.reshape((g.size * cap,) + tuple(values.shape[1:]))
    else:
        gvals = _coll.allgather(values, group=group, name=name + "_values")
    gidx = _coll.allgather(indices, group=group, name=name + "_indices")
    with _tl.activity(name, "SPARSE_DEDUP"):
        mvals, midx = dedup_merge(gvals, gidx)
    if average:
        mvals = mvals / g.size
    return IndexedSlices(mvals.to(orig_dtype), midx.to(slices.indices.dtype),
                         slices.dense_shape)


def _named_gather(group: int, gsize: int, names: list[str]):
    """A ``gather_fn`` for :meth:`Compressor.gathered_rows`: each stacked
    gather is a registered ``allgather``, named in call order (the wire
    payload, then the scales)."""
    calls = {"i": 0}

    def gfn(a):
        i = calls["i"]
        calls["i"] = i + 1
        label = names[i] if i < len(names) else f"{names[0]}_extra{i}"
        a2 = a.reshape(1) if a.dim() == 0 else a
        out = _coll.allgather(a2, group=group, name=label)
        return out.reshape((gsize,) + tuple(a2.shape))

    return gfn


def _dense_exchange(slices: IndexedSlices, group: int, average: bool,
                    name: str, comp=None, key=None) -> IndexedSlices:
    """Densify + allreduce of the whole table, returned in IndexedSlices
    form (row i at index i) so sparse applies work unchanged."""
    summed = _coll.allreduce(slices.to_dense(), group=group, average=average,
                             name=name + "_dense", compression=comp,
                             compression_key=key)
    rows = slices.dense_shape[0]
    return IndexedSlices(
        summed, torch.arange(rows, dtype=slices.indices.dtype,
                             device=summed.device), slices.dense_shape)

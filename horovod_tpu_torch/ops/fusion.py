"""Tensor fusion: batch many small tensors into few large collectives.

Counterpart of ``horovod_tpu/ops/fusion.py`` (its uncompressed, flat,
enumeration-order plan). The plan is the reference's: buckets are
contiguous runs of same-dtype tensors in submission order; a change of dtype,
or a tensor that would push the bucket past ``HOROVOD_FUSION_THRESHOLD``
bytes, closes the bucket; a threshold of 0 gives every tensor its own
bucket. Each bucket is packed into one flat buffer
(``MEMCPY_IN_FUSION_BUFFER``), reduced by ONE collective, and unpacked
(``MEMCPY_OUT_FUSION_BUFFER``). A sparse gradient's exchange is planned as
one :class:`SparseBucket` row (``ops/sparse.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import torch

from horovod_tpu_torch.core import timeline as _tl


@dataclasses.dataclass(frozen=True)
class Bucket:
    """One fused collective: the indices of same-dtype tensors it carries,
    their dtype, and their total bytes."""

    indices: tuple[int, ...]
    dtype: torch.dtype
    total_bytes: int

    @property
    def elems(self) -> int:
        return self.total_bytes // self.dtype.itemsize


@dataclasses.dataclass(frozen=True)
class SparseBucket:
    """One sparse (IndexedSlices) gradient exchange, as
    ``ops/sparse.py::plan_sparse_exchange`` resolves it.

    ``index`` is the leaf's position among all the gradients; ``rows`` the
    padded per-rank row capacity of the gather wire; ``row_elems`` the
    elements of one slice row; ``dense_rows`` the table's row count
    (``dense_shape[0]``); ``algo`` the resolved exchange, ``gather``
    (padded allgather + dedup-and-merge) or ``dense`` (densify +
    allreduce). Values move in their own dtype (wire compression is ROADMAP
    §A item 12), indices at ``index_itemsize`` bytes each.
    """

    index: int
    dtype: torch.dtype
    rows: int
    row_elems: int
    dense_rows: int
    algo: str = "gather"
    index_itemsize: int = 4
    label: str = ""

    @property
    def values_bytes(self) -> int:
        """Bytes of one rank's padded value block."""
        return self.rows * self.row_elems * self.dtype.itemsize

    @property
    def payload_wire_bytes(self) -> int:
        """Bytes of one rank's gather payload: values and indices."""
        return self.values_bytes + self.rows * self.index_itemsize

    @property
    def dense_bytes(self) -> int:
        """Bytes of the densified table (the dense exchange's payload)."""
        return self.dense_rows * self.row_elems * self.dtype.itemsize

    def describe(self) -> str:
        dtype = str(self.dtype).removeprefix("torch.")
        return (f"sparse[leaf {self.index}"
                f"{' ' + self.label if self.label else ''}, "
                f"{self.rows}x{self.row_elems} {dtype} of "
                f"{self.dense_rows} rows, algo={self.algo}, "
                f"payload={self.payload_wire_bytes}B]")


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
        nbytes = leaf.numel() * leaf.dtype.itemsize
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


def fused_apply_(leaves: Sequence[torch.Tensor], buckets: Sequence[Bucket],
                 collective: Callable[[torch.Tensor, int], torch.Tensor],
                 names: Sequence[str]) -> None:
    """Run ``collective(flat, bucket_index) -> flat`` once per bucket and
    write the results back into ``leaves`` in place. ``names[b]`` labels
    bucket ``b`` on the timeline."""
    for b, bucket in enumerate(buckets):
        name = names[b]
        with _tl.activity(name, "MEMCPY_IN_FUSION_BUFFER"):
            if len(bucket.indices) == 1:
                flat = leaves[bucket.indices[0]].reshape(-1).clone()
            else:
                flat = torch.cat([leaves[i].reshape(-1)
                                  for i in bucket.indices])
        flat = collective(flat, b)
        with _tl.activity(name, "MEMCPY_OUT_FUSION_BUFFER"):
            offset = 0
            for i in bucket.indices:
                n = leaves[i].numel()
                leaves[i].copy_(flat[offset: offset + n].view_as(leaves[i]))
                offset += n

"""Tensor fusion: batch many small tensors into few large collectives.

Counterpart of ``horovod_tpu/ops/fusion.py`` (its uncompressed, flat,
enumeration-order plan). The plan is the reference's: buckets are
contiguous runs of same-dtype tensors in submission order; a change of dtype,
or a tensor that would push the bucket past ``HOROVOD_FUSION_THRESHOLD``
bytes, closes the bucket; a threshold of 0 gives every tensor its own
bucket. Each bucket is packed into one flat buffer
(``MEMCPY_IN_FUSION_BUFFER``), reduced by ONE collective, and unpacked
(``MEMCPY_OUT_FUSION_BUFFER``).
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

"""Topology discovery: where a group's ranks live.

Counterpart of ``horovod_tpu/ops/topology.py``. There a slice is an ICI
domain of TPU chips and slices talk over DCN; here a slice is a host: its
GPUs talk over NVLink, and hosts talk over InfiniBand. A rank's slice is
its global rank // ``LOCAL_WORLD_SIZE`` (the launcher sets it, and
``core/state.py`` reads it at ``hvd.init``), renumbered in first-appearance
order over the group's members. ``HOROVOD_TOPOLOGY_SLICES=N`` overrides
discovery with N equal contiguous slices of the group (the knob the tests
use to simulate hosts on one machine).

The per-level link constants (latency α, bandwidth β) are seeds that only
rank the decompositions (``utils/costs.py``); they are not measurements,
and a tuning cache overrides them. The two-level process groups the
hierarchical lowering runs on (:func:`level_groups`) are created on first
use by every rank of the world, which must be eager (``dist.new_group`` is
a group call and cannot be captured in a CUDA graph): the first call of a
step program is.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from horovod_tpu_torch.core import state as _state
from horovod_tpu_torch.core.state import HorovodError
from horovod_tpu_torch.ops import wire as _wire
from horovod_tpu_torch.utils import env as _env


@dataclasses.dataclass(frozen=True)
class Link:
    """One interconnect level of the α–β model: ``alpha_us`` the fixed cost
    of one collective (µs), ``gbps`` the ring bus bandwidth a GPU
    achieves (GB/s, NCCL's busbw convention)."""

    alpha_us: float
    gbps: float


# Seeds for an H100 SXM host, from NVIDIA's H100 data sheet: NVLink 4 is
# 900 GB/s per GPU in both directions together (450 GB/s each way), and
# the DGX H100 reference design gives each GPU one ConnectX-7 port of NDR
# InfiniBand, 400 Gb/s (50 GB/s). The α values are not published: they
# keep the reference's ICI/DCN ratio (intra-host 1 µs, cross-host 25 µs),
# enough to order the algorithms. A CPU (gloo) world keeps the reference's
# CPU constants.
_NVLINK_SEED = Link(alpha_us=1.0, gbps=450.0)
_IB_SEED = Link(alpha_us=25.0, gbps=50.0)
_NVLINK_CPU = Link(alpha_us=5.0, gbps=20.0)
_IB_CPU = Link(alpha_us=25.0, gbps=12.5)


@dataclasses.dataclass(frozen=True)
class Topology:
    """Where one group's ranks live. ``slice_of[i]`` is group rank i's
    (contiguous, renumbered) host; ``local_size`` is None when hosts hold
    unequal rank counts (the hierarchical decomposition then refuses)."""

    group_size: int
    slice_of: tuple[int, ...]
    num_slices: int
    local_size: int | None
    device_kind: str
    nvlink: Link
    ib: Link

    @property
    def multi_slice(self) -> bool:
        return self.num_slices > 1

    def slice_members(self) -> list[list[int]]:
        """Group ranks per slice, slice-major, rank-ascending."""
        out: list[list[int]] = [[] for _ in range(self.num_slices)]
        for r, s in enumerate(self.slice_of):
            out[s].append(r)
        return out


def seed_links(device_kind: str) -> tuple[Link, Link]:
    """``(nvlink, ib)`` seed links for a device kind without a live group:
    the CPU constants for ``cpu``/``host``, the H100 seeds otherwise."""
    if device_kind.lower() in ("cpu", "host"):
        return _NVLINK_CPU, _IB_CPU
    return _NVLINK_SEED, _IB_SEED


_discover_memo: dict[tuple, Topology] = {}


def discover(group: "_state.Group") -> Topology:
    """The topology of ``group`` (module docstring).
    ``HOROVOD_TOPOLOGY_SLICES=N`` must divide the group size."""
    st = _state._require_init()
    override = _env.topology_slices()
    key = (group.ranks, st.local_size, str(st.device), override)
    hit = _discover_memo.get(key)
    if hit is not None:
        return hit
    n = group.size
    if override:
        if n % override != 0:
            raise HorovodError(
                f"HOROVOD_TOPOLOGY_SLICES={override} does not divide the "
                f"group size {n}; the override must cut equal slices.")
        local = n // override
        slice_of = tuple(i // local for i in range(n))
    else:
        ids: dict[int, int] = {}
        per_host = max(1, st.local_size)
        slice_of = tuple(ids.setdefault(r // per_host, len(ids))
                         for r in group.ranks)
    num_slices = max(slice_of) + 1 if slice_of else 1
    counts = [0] * num_slices
    for s in slice_of:
        counts[s] += 1
    local_size = counts[0] if len(set(counts)) == 1 else None
    if st.device.type == "cuda":
        kind = torch.cuda.get_device_name(st.device)
    else:
        kind = "cpu"
    nvlink, ib = seed_links(kind)
    topo = Topology(group_size=n, slice_of=slice_of, num_slices=num_slices,
                    local_size=local_size, device_kind=kind, nvlink=nvlink,
                    ib=ib)
    _discover_memo[key] = topo
    return topo


# (group ranks, slice_of) -> (intra process group, cross process group) of
# this process.
_level_memo: dict[tuple, tuple] = {}


def level_groups(group: "_state.Group", topo: Topology):
    """``(intra, cross)`` process groups of this rank for the two-level
    decomposition: its host's ranks, and the ranks at its position on every
    host (positions follow the global rank, as a process group orders its
    members). Every rank of the world creates every one of them, in one
    order, at its first hierarchical call, so the group must be the
    world's."""
    key = (group.ranks, topo.slice_of)
    hit = _level_memo.get(key)
    if hit is not None:
        return hit
    if group.size != _state.global_size():
        raise HorovodError(
            f"allreduce algo='hierarchical' on group {group.index} "
            f"({group.size} of {_state.global_size()} ranks): the per-host "
            f"process groups are created by every rank of the world, so "
            f"the port runs the hierarchical decomposition on a group "
            f"that spans the world. Use algo='flat'/'rs_ag' here.")
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        raise HorovodError(
            "the hierarchical allreduce's process groups must be created "
            "eagerly: call the step once outside a CUDA graph capture "
            "(the first call of an hvd.spmd program is eager).")
    me = _state.global_rank()
    hosts = [sorted(group.ranks[r] for r in members)
             for members in topo.slice_members()]
    crosses = [[h[p] for h in hosts] for p in range(topo.local_size)]
    mine = [None, None]
    for level, ranks_lists in enumerate((hosts, crosses)):
        for ranks in ranks_lists:
            pg = dist.new_group(ranks)
            _wire.register_partition(pg, ranks_lists)
            if me in ranks:
                mine[level] = pg
    _level_memo[key] = tuple(mine)
    return _level_memo[key]


# (group ranks, fsdp size, data size, slice_of) -> (fsdp process group,
# data process group) of this process.
_fsdp_memo: dict[tuple, tuple] = {}


def fsdp_groups(group: "_state.Group", fmesh, topo: Topology):
    """``(fsdp, data)`` process groups of this rank for the ``data × fsdp``
    mesh ``fmesh`` (``ops/mesh.py``) of ``group``; ``data`` is None when
    the data axis is trivial. The default multi-host layout (fsdp = one
    host) reuses :func:`level_groups`' intra/cross groups, and an fsdp
    axis that covers the group is the group's own process group, so the
    sharded exchange runs on the very groups the replicated lowerings
    use. Any other layout makes a process group per partition of each
    axis: every rank of the world creates every one of them, in one order,
    eagerly, as :func:`level_groups` does."""
    if fmesh.multi_slice and fmesh.matches_slices():
        return level_groups(group, topo)
    fparts, dparts = fmesh.fsdp_groups(), fmesh.data_groups()
    if fparts is None:
        return group.pg, None
    key = (group.ranks, fmesh.fsdp_size, fmesh.data_size, topo.slice_of)
    hit = _fsdp_memo.get(key)
    if hit is not None:
        return hit
    if group.size != _state.global_size():
        raise HorovodError(
            f"the sharded exchange on group {group.index} ({group.size} of "
            f"{_state.global_size()} ranks) with fsdp_size="
            f"{fmesh.fsdp_size}: the fsdp and data process groups are "
            f"created by every rank of the world, so the port shards over "
            f"a group that spans the world.")
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        raise HorovodError(
            "the sharded exchange's process groups must be created "
            "eagerly: call the step once outside a CUDA graph capture "
            "(the first call of an hvd.spmd program is eager).")
    me = _state.global_rank()
    mine = [None, None]
    for axis, parts in enumerate((fparts, dparts)):
        level = [[group.ranks[r] for r in members] for members in parts or ()]
        for ranks in level:
            ranks = sorted(ranks)
            pg = dist.new_group(ranks)
            _wire.register_partition(pg, level)
            if me in ranks:
                mine[axis] = pg
    _fsdp_memo[key] = tuple(mine)
    return _fsdp_memo[key]


def forget_groups() -> None:
    """Destroy the two-level and fsdp process groups and drop the memoized
    topologies (``shutdown``)."""
    for pgs in (*_level_memo.values(), *_fsdp_memo.values()):
        for pg in pgs:
            if pg is not None:
                dist.destroy_process_group(pg)
    _level_memo.clear()
    _fsdp_memo.clear()
    _wire.forget_partitions()
    _discover_memo.clear()

"""The ``data × fsdp`` rank mesh behind the sharded (ZeRO-2/3) modes.

Counterpart of ``horovod_tpu/ops/mesh.py``. One fixed 2-D factorization of
a group's ranks::

    rank r  =  d * fsdp_size + f        (d: data index, f: fsdp index)

* The ``fsdp`` axis is CONTIGUOUS in rank order, so on a multi-host
  topology (``ops/topology.py``) its default size is one host: shards
  reduce-scatter and all-gather over NVLink, the intra-host partition the
  hierarchical allreduce already uses.
* The ``data`` axis is STRIDED (ranks ``f, F+f, 2F+f, ...``) and spans the
  hosts: gradient shards cross InfiniBand once, after the reduce-scatter.

``HOROVOD_FSDP_AXIS_SIZE`` overrides the fsdp size; it must divide the
ranks of a host (one host: the group size), so an fsdp group never
straddles hosts. The reference also exposes the layout as a
``jax.sharding.Mesh``; here :meth:`FsdpMesh.grid` is the same layout as a
plain ``(data, fsdp)`` grid of global ranks, with :data:`DATA_AXIS` and
:data:`FSDP_AXIS` naming its axes (a flat shard is split over ``fsdp`` and
replicated over ``data``). The process groups the lowerings run on are
``ops/topology.py::fsdp_groups``.
"""

from __future__ import annotations

import dataclasses

from horovod_tpu_torch.core import state as _state
from horovod_tpu_torch.core.state import HorovodError
from horovod_tpu_torch.ops import topology as _topology
from horovod_tpu_torch.utils import env as _env

DATA_AXIS = "data"
FSDP_AXIS = "fsdp"

#: The sharding modes ``HOROVOD_SHARDING`` / ``sharding=`` admit.
SHARDING_MODES = ("off", "zero2", "zero3")


def resolve_sharding(sharding: str | None) -> str:
    """Resolve a ``sharding=`` argument: ``None`` takes
    ``HOROVOD_SHARDING`` when set, else an applied tuned config's value
    (``tune/apply.py``), else ``off``; explicit strings are validated
    here so a typo'd literal raises at construction, not at the first
    step."""
    if sharding is None:
        from horovod_tpu_torch.tune import apply as _tune_apply

        sharding = _tune_apply.override("HOROVOD_SHARDING")
        if sharding is None:
            return _env.sharding_mode()
    value = str(sharding).strip().lower()
    if value not in SHARDING_MODES:
        raise HorovodError(
            f"sharding must be one of {list(SHARDING_MODES)}, got "
            f"{sharding!r}")
    return value


@dataclasses.dataclass(frozen=True)
class FsdpMesh:
    """One group's ``data × fsdp`` factorization of its ranks.

    ``fsdp_size * data_size == group_size`` always; ``fsdp_groups()`` /
    ``data_groups()`` return the partitions in group ranks — ``None``
    where the partition is the whole group (fsdp covers it) or trivial
    (one data group per rank)."""

    group_size: int
    fsdp_size: int
    data_size: int
    num_slices: int

    @property
    def multi_slice(self) -> bool:
        return self.num_slices > 1

    def fsdp_groups(self) -> list[list[int]] | None:
        """Contiguous fsdp-axis partitions (``None`` = the whole group)."""
        if self.fsdp_size == self.group_size:
            return None
        return [[d * self.fsdp_size + f for f in range(self.fsdp_size)]
                for d in range(self.data_size)]

    def data_groups(self) -> list[list[int]] | None:
        """Strided data-axis partitions (``None`` when data_size == 1 —
        no cross-replica exchange exists)."""
        if self.data_size == 1:
            return None
        return [[d * self.fsdp_size + f for d in range(self.data_size)]
                for f in range(self.fsdp_size)]

    def fsdp_index(self, rank: int) -> int:
        return rank % self.fsdp_size

    def data_index(self, rank: int) -> int:
        return rank // self.fsdp_size

    def matches_slices(self) -> bool:
        """True when the fsdp axis is exactly the intra-host partition (the
        default multi-host layout) — the precondition of the
        phase-asymmetric cross-host compression mirror
        (``ops/strategy.py::lower_fsdp_grad_exchange``)."""
        return self.data_size == self.num_slices

    def shard_len(self, padded_numel: int) -> int:
        if padded_numel % self.fsdp_size:
            raise HorovodError(
                f"padded leaf size {padded_numel} is not divisible by "
                f"fsdp_size={self.fsdp_size} — pad with "
                f"padded_numel() first.")
        return padded_numel // self.fsdp_size

    def padded_numel(self, numel: int, multiple: int = 1) -> int:
        """Smallest size >= ``numel`` that is a multiple of both
        ``multiple`` (a compressor block, when present) and
        ``fsdp_size`` — the flat layout every shard math runs in."""
        m = max(1, int(multiple))
        up = -(-numel // m) * m
        return -(-up // self.fsdp_size) * self.fsdp_size

    def grid(self, group: int = 0) -> list[list[int]]:
        """The layout as a ``(data, fsdp)`` grid of the group's global
        ranks, row-major: ``grid[d][f]`` is group rank ``d * fsdp_size +
        f`` (the reference's ``named_mesh`` device grid)."""
        ranks = _state.get_group(group).ranks
        if len(ranks) != self.group_size:
            raise HorovodError(
                f"group {group} has {len(ranks)} devices but this "
                f"mesh was built for group_size={self.group_size}.")
        return [list(ranks[d * self.fsdp_size:(d + 1) * self.fsdp_size])
                for d in range(self.data_size)]


def layout(topo: _topology.Topology,
           fsdp_size: int | None = None) -> FsdpMesh:
    """Build the :class:`FsdpMesh` for one topology.

    ``fsdp_size`` (default: ``HOROVOD_FSDP_AXIS_SIZE``, else an applied
    tuned config's, else auto) overrides the fsdp-axis size. Auto
    prefers NVLink: one host on a multi-host topology, the whole group on
    one host. An override must divide the ranks of a host — an fsdp group
    straddling hosts would put the hot gather path on the slow
    interconnect."""
    if fsdp_size is None:
        from horovod_tpu_torch.tune import apply as _tune_apply

        tuned = _tune_apply.override("HOROVOD_FSDP_AXIS_SIZE")
        fsdp_size = (_env.fsdp_axis_size() if tuned is None
                     else int(tuned))
    if topo.multi_slice and topo.local_size is None:
        raise HorovodError(
            "FSDP sharding requires equal-sized slices (the fsdp axis "
            "is cut from the intra-slice partition); this group's "
            "slices are ragged.")
    per_slice = topo.local_size if topo.multi_slice else topo.group_size
    if fsdp_size is None:
        fsdp_size = per_slice
    fsdp_size = int(fsdp_size)
    if fsdp_size < 1 or per_slice % fsdp_size:
        raise HorovodError(
            f"HOROVOD_FSDP_AXIS_SIZE={fsdp_size} must divide the "
            f"per-slice rank count {per_slice} (group_size="
            f"{topo.group_size}, num_slices={topo.num_slices}): fsdp "
            f"groups must not straddle a DCN slice boundary.")
    return FsdpMesh(
        group_size=topo.group_size,
        fsdp_size=fsdp_size,
        data_size=topo.group_size // fsdp_size,
        num_slices=topo.num_slices,
    )


def fsdp_mesh(group: int = 0,
              fsdp_size: int | None = None) -> FsdpMesh:
    """:func:`layout` for a live group (the runtime entry point)."""
    return layout(_topology.discover(_state.get_group(group)),
                  fsdp_size=fsdp_size)

"""Process-wide runtime state: ranks, collective groups, device, lifecycle.

Counterpart of ``horovod_tpu/core/state.py``. There a rank is a TPU device
driven by one controller; here a rank is a process, launched torchrun-style
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``) or by
:func:`horovod_tpu_torch.run.run`, and a group is a ``torch.distributed``
process group:

* group 0 is always the world; ``init([[0,1,2],[2,3,4]])`` adds one process
  group per listed rank set, created by every rank in the same order, and
  overlapping groups are allowed (a rank may belong to several);
* each group also carries a gloo *side* group over the same ranks, which
  carries the negotiation traffic (``core/negotiate.py``) so that request
  metadata never touches the device;
* a rank outside a group gets the reference's return conventions from the
  collectives (``ops/collectives.py``).

Entry points run on the GPU: ``init()`` with no ``device`` uses
``cuda:<LOCAL_RANK>`` and the NCCL backend, and raises where CUDA is absent.
``init(device="cpu")`` runs over gloo, which is how the tests run.
"""

from __future__ import annotations

import dataclasses
import os
import threading
from typing import Any, Sequence

import torch
import torch.distributed as dist

from horovod_tpu_torch.core import timeline as _timeline
from horovod_tpu_torch.utils import env as _env


class HorovodError(RuntimeError):
    """Raised when collective negotiation or runtime set-up fails."""


class NotInitializedError(HorovodError):
    """Operation requires ``hvd.init()`` first."""


@dataclasses.dataclass(frozen=True)
class Group:
    """One collective group: an ordered set of global ranks.

    ``pg`` is the process group that moves data (NCCL on the GPU, gloo on
    the CPU) and ``side`` the gloo group that moves negotiation metadata;
    both are None on a rank that is not a member.
    """

    index: int
    ranks: tuple[int, ...]
    pg: Any
    side: Any

    @property
    def size(self) -> int:
        return len(self.ranks)

    def group_rank_of(self, global_rank: int) -> int:
        """Group-local rank of a global rank, or -1 if not a member."""
        try:
            return self.ranks.index(global_rank)
        except ValueError:
            return -1


class _State:
    def __init__(self) -> None:
        self.lock = threading.Lock()
        self.initialized = False
        self.groups: list[Group] = []
        self.device = torch.device("cpu")
        self.rank = 0
        self.world = 1
        self.local_rank = 0
        self.local_size = 1
        self.fusion_threshold = _env.DEFAULT_FUSION_THRESHOLD
        self.owns_default_pg = False


_state = _State()


def _resolve_device(device, local_rank: int) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise HorovodError(
                "hvd.init: CUDA is not available on this host. The port "
                "runs on the GPU by default; pass device='cpu' to run on "
                "the CPU over the gloo backend.")
        dev = torch.device("cuda", local_rank if dev.index is None
                           else dev.index)
        torch.cuda.set_device(dev)
        return dev
    if dev.type != "cpu":
        raise HorovodError(
            f"hvd.init: unsupported device {str(dev)!r}; use 'cuda' or "
            f"'cpu'.")
    return dev


def _group_specs(group_ranks, world: int) -> list[tuple[int, ...]]:
    all_ranks = tuple(range(world))
    if not group_ranks:
        return [all_ranks]
    specs: list[tuple[int, ...]] = []
    for g in group_ranks:
        ranks = tuple(int(r) for r in g)
        if not ranks:
            raise HorovodError("Groups must contain at least one rank.")
        if len(set(ranks)) != len(ranks):
            raise HorovodError(f"Group {list(ranks)} contains duplicate ranks.")
        for r in ranks:
            if not 0 <= r < world:
                raise HorovodError(
                    f"Rank {r} out of range for world size {world}.")
        specs.append(ranks)
    if specs[0] != all_ranks:
        specs.insert(0, all_ranks)
    return specs


def init(group_ranks: Sequence[Sequence[int]] | None = None, *,
         device: str | torch.device | None = None) -> None:
    """Initialize the runtime (idempotent until :func:`shutdown`).

    ``group_ranks`` is the reference's 2-D group list; group 0 is the world
    and user groups follow (a first user group equal to the world becomes
    group 0). ``device``: ``None``/``"cuda"`` (NCCL) or ``"cpu"`` (gloo).

    The default process group is reused when a launcher already created it
    (:func:`horovod_tpu_torch.run.run` does); otherwise it is created here
    from ``env://`` when ``WORLD_SIZE`` > 1, or as a one-process world over
    an in-memory store.
    """
    with _state.lock:
        if _state.initialized:
            return
        _env.warn_unknown_env()
        local_rank = int(os.environ.get("LOCAL_RANK", "0"))
        dev = _resolve_device(device, local_rank)
        backend = "nccl" if dev.type == "cuda" else "gloo"
        owns = False
        if dist.is_initialized():
            have = dist.get_backend()
            if have != backend:
                raise HorovodError(
                    f"hvd.init: the existing process group uses backend "
                    f"{have!r}, but device {str(dev)!r} needs {backend!r}.")
        else:
            world = int(os.environ.get("WORLD_SIZE", "1"))
            rank = int(os.environ.get("RANK", "0"))
            if world == 1:
                dist.init_process_group(backend, store=dist.HashStore(),
                                        rank=0, world_size=1)
            else:
                dist.init_process_group(backend, init_method="env://",
                                        rank=rank, world_size=world)
            owns = True
        rank = dist.get_rank()
        world = dist.get_world_size()
        groups: list[Group] = []
        for i, ranks in enumerate(_group_specs(group_ranks, world)):
            if len(ranks) == world:
                pg = dist.group.WORLD
            else:
                pg = dist.new_group(list(ranks))
            side = (pg if backend == "gloo"
                    else dist.new_group(list(ranks), backend="gloo"))
            member = rank in ranks
            groups.append(Group(index=i, ranks=ranks,
                                pg=pg if member else None,
                                side=side if member else None))
        _state.groups = groups
        _state.device = dev
        _state.rank = rank
        _state.world = world
        _state.local_rank = local_rank
        _state.local_size = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        _state.fusion_threshold = _env.fusion_threshold_bytes()
        _state.owns_default_pg = owns
        _state.initialized = True
        if rank == 0:  # coordinator-only timeline, as in the reference
            _timeline.maybe_start()


def shutdown() -> None:
    """Tear the runtime down: the timeline, the groups init created, and the
    default process group when init created it."""
    from horovod_tpu_torch.ops import collectives as _coll  # imports us

    _timeline.stop()
    with _state.lock:
        if not _state.initialized:
            return
        if _state.owns_default_pg:
            dist.destroy_process_group()
        else:
            created = set()
            for g in _state.groups:
                for pg in (g.pg, g.side):
                    if (pg is not None and pg is not dist.group.WORLD
                            and id(pg) not in created):
                        created.add(id(pg))
                        dist.destroy_process_group(pg)
        _state.groups = []
        _state.initialized = False
    _coll.reset_auto_names()


def is_initialized() -> bool:
    return _state.initialized


def _require_init() -> _State:
    if not _state.initialized:
        raise NotInitializedError(
            "horovod_tpu_torch has not been initialized; call hvd.init() "
            "first.")
    return _state


def get_group(group: int = 0) -> Group:
    st = _require_init()
    if not 0 <= group < len(st.groups):
        raise HorovodError(
            f"Unknown group {group}; {len(st.groups)} group(s) are defined.")
    return st.groups[group]


def num_groups() -> int:
    return len(_require_init().groups)


def device() -> torch.device:
    """The device this rank computes on."""
    return _require_init().device


def fusion_threshold() -> int:
    return _require_init().fusion_threshold


def size(group: int = 0) -> int:
    """Number of ranks in the group."""
    return get_group(group).size


def rank(group: int = 0) -> int:
    """This process's rank within the group, or -1 if it is not a member."""
    return get_group(group).group_rank_of(_require_init().rank)


def global_rank() -> int:
    return _require_init().rank


def global_size() -> int:
    return _require_init().world


def local_rank() -> int:
    """This process's rank among the processes of its host."""
    return _require_init().local_rank


def local_size() -> int:
    """Number of processes on this host."""
    return _require_init().local_size

"""Process-wide runtime state: ranks, collective groups, device, lifecycle.

Counterpart of ``horovod_tpu/core/state.py``. There a rank is a TPU device
driven by one controller; here a rank is a process, launched torchrun-style
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``) or by
:func:`horovod_tpu_torch.run.run`, and a group is a ``torch.distributed``
process group:

* group 0 is always the world; ``init([[0,1,2],[2,3,4]])`` adds one process
  group per listed rank set, created by every rank in the same order, and
  overlapping groups are allowed (a rank may belong to several);
* negotiation metadata moves through the world's key-value store
  (``core/negotiate.py``), never through the device; its per-group key
  namespace carries a generation that :func:`bump_generation` advances;
* a rank outside a group gets the reference's return conventions from the
  collectives (``ops/collectives.py``);
* the native control plane (``core/native``: the request table, the
  fusion planner, stall detection and the timeline writer) is built at
  init over the groups' sizes when it loads (:func:`native_core`), and
  rebuilt by :func:`reconfigure`; without it the Python paths run;
* :func:`reconfigure` (``core/elastic.py``'s shrink and regrow) rebuilds
  group 0 over the survivors, or over the members after a regrow, under a
  bumped generation, and :func:`join` makes a new process a member of such
  a group. That group's process group is built straight from the
  rendezvous store under a generation prefix (``_elastic_pg``): the
  default process group still counts the dead rank, and a joiner was
  never in it.

Entry points run on the GPU: ``init()`` with no ``device`` uses
``cuda:<LOCAL_RANK>`` and the NCCL backend, and raises where CUDA is absent.
``init(device="cpu")`` runs over gloo, which is how the tests run.
"""

from __future__ import annotations

import dataclasses
import datetime
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
    the CPU); None on a rank that is not a member.
    """

    index: int
    ranks: tuple[int, ...]
    pg: Any

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
        self.negotiator = None  # core/negotiate.py's, made by init
        self.inits = 0  # init cycles so far: part of every program's key
        self.reconfigures = 0  # elastic group-0 rebuilds so far
        # A shrink left the default process group with a dead member: it is
        # never destroyed (NCCL's teardown would wait on the dead peer).
        self.default_pg_lost = False
        self.store = None  # the store negotiation and the heartbeat use
        self.native = None  # NativeCore when the native control plane loads
        # Cores replaced by a reconfigure whose writer the timeline still
        # writes to: closed at shutdown, after the timeline.
        self.retired_natives: list = []


_state = _State()

# The launcher's rendezvous store (``run.run`` sets it), which a joiner
# opens too; None = the default process group's store.
_rendezvous_store = None


def set_rendezvous_store(store) -> None:
    """Record the store the world met on (``run.run``): negotiation, the
    heartbeat and an elastic regrow's joiner all use it."""
    global _rendezvous_store
    _rendezvous_store = store


def pg_timeout() -> datetime.timedelta | None:
    """The wait bound of the process groups the port creates:
    ``HOROVOD_LIVENESS_TIMEOUT`` plus a minute for connection set-up when
    it is set (a collective whose peer died then fails instead of hanging
    at the backend's 10- or 30-minute default), else the default."""
    timeout = _env.liveness_timeout_seconds()
    if timeout <= 0:
        return None
    return datetime.timedelta(seconds=timeout + 60.0)


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


def _make_native(group_sizes: list[int]):
    """A native control-plane core over ``group_sizes``, or None when the
    library does not load (the loader has warned) — the reference's
    ``InitializeHorovodOnce`` building the C++ runtime."""
    from horovod_tpu_torch.core import native as _native

    try:
        return _native.NativeCore(group_sizes, _env.stall_warning_seconds())
    except RuntimeError:
        return None


def _replace_native(group_sizes: list[int]) -> None:
    """Rebuild the native core at new group sizes; a core whose writer the
    timeline holds stays open until shutdown."""
    old = _state.native
    if old is None:
        return
    if _timeline.session().native_core is old:
        _state.retired_natives.append(old)
    else:
        old.close()
    _state.native = _make_native(group_sizes)


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
         device: str | torch.device | None = None, devices=None) -> None:
    """Initialize the runtime (idempotent until :func:`shutdown`).

    ``group_ranks`` is the reference's 2-D group list; group 0 is the world
    and user groups follow (a first user group equal to the world becomes
    group 0). ``device``: ``None``/``"cuda"`` (NCCL) or ``"cpu"`` (gloo).
    The reference's ``devices=`` (the device list one controller drives)
    raises a ``TypeError`` naming ``device=``: a process is one rank with
    one device.

    The default process group is reused when a launcher already created it
    (:func:`horovod_tpu_torch.run.run` does); otherwise it is created here
    from ``env://`` when ``WORLD_SIZE`` > 1, or as a one-process world over
    an in-memory store.
    """
    if devices is not None:
        raise TypeError(
            "hvd.init(devices=...) is the reference's form, where one "
            "controller drives a list of devices. Here a process is one "
            "rank with one device: pass device= ('cuda', 'cuda:N' or "
            "'cpu'), and start one process per device "
            "(horovod_tpu_torch.run.run or torchrun).")
    with _state.lock:
        if _state.initialized:
            return
        _env.warn_unknown_env()
        _env.validate_resilience_knobs()
        _env.validate_sharding_knobs()
        _env.check_unported()
        _env.validate_serving_knobs()
        _env.validate_exchange_knobs()
        _env.validate_tuning_knobs()
        _env.sparse_pad_capacity()
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
            kw = {} if pg_timeout() is None else {"timeout": pg_timeout()}
            if world == 1:
                dist.init_process_group(backend, store=dist.HashStore(),
                                        rank=0, world_size=1, **kw)
            else:
                dist.init_process_group(backend, init_method="env://",
                                        rank=rank, world_size=world, **kw)
            owns = True
        rank = dist.get_rank()
        world = dist.get_world_size()
        groups: list[Group] = []
        for i, ranks in enumerate(_group_specs(group_ranks, world)):
            if len(ranks) == world:
                pg = dist.group.WORLD
            else:
                pg = dist.new_group(list(ranks))
            groups.append(Group(index=i, ranks=ranks,
                                pg=pg if rank in ranks else None))
        from horovod_tpu_torch.core import negotiate as _neg  # imports us

        _state.store = (_rendezvous_store if _rendezvous_store is not None
                        else dist.distributed_c10d._get_default_store())
        _state.negotiator = _neg.Negotiator(
            dist.PrefixStore("horovod_tpu_torch", _state.store),
            _env.stall_warning_seconds())
        _state.groups = groups
        _state.device = dev
        _state.rank = rank
        _state.world = world
        _state.local_rank = local_rank
        _state.local_size = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        _state.fusion_threshold = _env.fusion_threshold_bytes()
        _state.owns_default_pg = owns
        _state.default_pg_lost = False
        _state.inits += 1
        _state.native = _make_native([g.size for g in groups])
        _state.initialized = True
        if rank == 0:  # coordinator-only timeline, as in the reference
            _timeline.maybe_start(_state.native)
    _start_heartbeat()
    # Profile-guided configuration (``horovod_tpu_torch/tune``), outside
    # the lock: applying an artifact reads hvd.size(), and
    # HOROVOD_PROFILE=auto runs live collectives. With both knobs set,
    # auto tunes anew and commits to the HOROVOD_TUNED_CONFIG path.
    if _env.profile_mode() == "auto":
        from horovod_tpu_torch.tune import tune as _tune

        _tune()
    else:
        tuned_path = _env.tuned_config_path()
        if tuned_path is not None:
            from horovod_tpu_torch.tune import apply_committed

            apply_committed(tuned_path)


def shutdown() -> None:
    """Tear the runtime down: the timeline, the groups init created, and the
    default process group when init created it."""
    from horovod_tpu_torch.core import resilience as _res  # imports us
    from horovod_tpu_torch.ops import collectives as _coll  # imports us
    from horovod_tpu_torch.tune import apply as _tune_apply

    _res.stop_heartbeat()
    _timeline.stop()
    # A re-init at another world must not inherit the applied knobs.
    _tune_apply.deactivate()
    with _state.lock:
        if not _state.initialized:
            return
        from horovod_tpu_torch.ops import topology as _topology  # imports us

        _topology.forget_groups()
        if _state.reconfigures:
            _drop_pg(_state.groups[0].pg)
        if _state.owns_default_pg and not _state.default_pg_lost:
            dist.destroy_process_group()
        elif not _state.owns_default_pg:
            for g in _state.groups[1 if _state.reconfigures else 0:]:
                if g.pg is not None and g.pg is not dist.group.WORLD:
                    dist.destroy_process_group(g.pg)
        _state.groups = []
        _state.reconfigures = 0
        _state.negotiator = None
        for core in [_state.native, *_state.retired_natives]:
            if core is not None:
                core.close()
        _state.native = None
        _state.retired_natives = []
        _state.initialized = False
    _coll.reset_auto_names()


def is_initialized() -> bool:
    return _state.initialized


def native_core():
    """The loaded native control-plane core (``core/native``'s
    ``NativeCore``), or None: the Python control plane runs."""
    return _state.native if _state.initialized else None


def bump_generation(group: int = 0) -> int:
    """Advance the group's coordination generation without re-initializing
    — the checkpoint-resume path (``Trainer.restore``). The negotiation
    keys of the group carry the generation, so after a crash-restart the
    resumed run's negotiation can never meet stale keys of the run before
    it. A collective over the group: every member calls it at the same
    point. (The reference keeps one generation for the world; here each
    group negotiates on its own sequence, so each has its own.)"""
    get_group(group)
    gen = _state.negotiator.bump_generation(group)
    if group == 0:
        _beat()
    return gen


def default_pg_lost() -> bool:
    """Whether a shrink left the default process group with a dead member
    (``run.run`` then leaves it to the process's end)."""
    return _state.default_pg_lost


def reconfigures() -> int:
    """Elastic rebuilds of group 0 since init: a plan cached per group
    (``parallel/optimizer.py``) keys on it."""
    return _state.reconfigures


def kv_generation() -> int:
    """The generation of the world-level keys (the heartbeat, the elastic
    step agreement, the regrow plan) and of an elastic plan: 1 after
    ``hvd.init`` and one more at each resume or transition of group 0, as
    the reference's ``state.generation()`` counts (group 0's negotiation
    generation plus one)."""
    return _require_init().negotiator.generation(0) + 1


def _start_heartbeat() -> None:
    from horovod_tpu_torch.core import resilience as _res  # imports us

    _res.start_heartbeat()


def _beat() -> None:
    """Publish a heartbeat under a new generation at once: a member that
    dies before its next tick is then judged, not taken for one that has
    not started yet."""
    from horovod_tpu_torch.core import resilience as _res  # imports us

    hb = _res.heartbeat()
    if hb is not None:
        hb.beat()


def _elastic_pg(ranks: tuple[int, ...], gen: int):
    """Group 0's process group over ``ranks`` at generation ``gen``, built
    from the rendezvous store under a ``g<gen>`` prefix, so that survivors
    and a joiner can build it and a dead rank is not waited for. It is
    entered in c10d's rank table (``dist.broadcast``'s ``src`` and a P2P
    peer are global ranks), not in its group registry."""
    me = ranks.index(_state.rank)
    store = dist.PrefixStore(f"horovod_tpu_torch/pg/g{gen}", _state.store)
    timeout = pg_timeout() or datetime.timedelta(minutes=30)
    pg = dist.ProcessGroup(store, me, len(ranks))
    if _state.device.type == "cuda":
        opts = dist.ProcessGroupNCCL.Options()
        opts._timeout = timeout
        backend = dist.ProcessGroupNCCL(store, me, len(ranks), opts)
        kind = dist.ProcessGroup.BackendType.NCCL
    else:
        backend = dist.ProcessGroupGloo(store, me, len(ranks), timeout)
        kind = dist.ProcessGroup.BackendType.GLOO
    name = f"horovod_tpu_torch_g{gen}"
    pg._set_default_backend(kind)
    pg._register_backend(_state.device, kind, backend)
    pg._set_group_name(name)
    # c10d's tables of its groups, which dist.* read: the backend, the
    # name, and the global ranks (a broadcast's ``src``, a P2P peer).
    world = dist.distributed_c10d._world
    backend_name = "nccl" if _state.device.type == "cuda" else "gloo"
    world.pg_map[pg] = (backend_name, store)
    world.pg_names[pg] = name
    world.pg_group_ranks[pg] = {r: i for i, r in enumerate(ranks)}
    world.pg_backend_config[pg] = backend_name
    return pg


def _drop_pg(pg, abort: bool = False) -> None:
    """Forget an elastic process group. ``abort``: a peer of it died; a
    gloo group is aborted first, which releases a survivor still blocked
    in one of its collectives (NCCL's abort waits on the dead peer: a
    blocked NCCL collective ends at the group's timeout instead)."""
    if pg is None:
        return
    if abort and _state.device.type != "cuda":
        abort_pg(pg)
    if pg is not dist.group.WORLD:
        world = dist.distributed_c10d._world
        for table in (world.pg_map, world.pg_names, world.pg_group_ranks,
                      world.pg_backend_config):
            table.pop(pg, None)


def abort_pg(pg) -> None:
    """Abort a process group, best effort: a member blocked in one of its
    collectives is released."""
    try:
        pg.abort()
    except Exception:  # best effort: the backend may not abort
        pass


def _validate_members(rs: tuple[int, ...]) -> None:
    # The reference's refusals (core/state.py::reconfigure).
    if not rs:
        raise HorovodError(
            "Elastic reconfigure needs at least one surviving rank.")
    if len(set(rs)) != len(rs):
        raise HorovodError(f"Group {list(rs)} contains duplicate ranks.")
    for r in rs:
        if not 0 <= r < _state.world:
            raise HorovodError(
                f"Rank {r} out of range for world size {_state.world}.")


def _after_reconfigure() -> None:
    from horovod_tpu_torch.ops import collectives as _coll  # imports us
    from horovod_tpu_torch.ops import topology as _topology  # imports us

    # Auto-named collectives count anew (a joiner starts at 0), and the
    # memoized topologies and their groups were of the old membership.
    _coll.reset_auto_names()
    _topology.forget_groups()


def reconfigure(ranks: Sequence[int]) -> Group:
    """Elastic world change (``core/elastic.py``): rebuild the group layout
    as a single group 0 over ``ranks`` — a subset of the membership after
    a shrink, a superset after a regrow — without tearing the runtime
    down. Global ranks are kept (``hvd.global_rank()`` stays the
    process's own); ``hvd.rank(0)`` and ``hvd.size(0)`` become the new
    group's. The generation of group 0 bumps, so the store keys roll to a
    fresh namespace and every ``spmd`` program is recorded anew. User
    subset groups are not carried across: a subset naming a dropped rank
    has no meaning in the new world. Every member of the new group calls
    this (a joiner calls :func:`join`)."""
    with _state.lock:
        st = _require_init()
        rs = tuple(int(r) for r in ranks)
        _validate_members(rs)
        old = st.groups[0]
        shrink = not set(old.ranks) <= set(rs)
        gen = st.negotiator.bump_generation(0) + 1  # kv_generation()
        if st.reconfigures or shrink:
            _drop_pg(old.pg, abort=shrink)
        st.default_pg_lost |= shrink
        pg = _elastic_pg(rs, gen) if st.rank in rs else None
        for g in st.groups[1:]:
            if g.pg is not None and g.pg is not dist.group.WORLD:
                if shrink:
                    _drop_pg(g.pg, abort=True)
                else:
                    dist.destroy_process_group(g.pg)
        st.groups = [Group(index=0, ranks=rs, pg=pg)]
        st.reconfigures += 1
        _replace_native([len(rs)])
    _after_reconfigure()
    _beat()
    return st.groups[0]


def join(ranks: Sequence[int], gen: int, store, *,
         device: str | torch.device | None = None) -> Group:
    """A joiner's ``hvd.init`` (``core/elastic.py::rejoin``): this process
    (global rank ``RANK``) becomes a member of group 0 over ``ranks`` at
    generation ``gen``, which the members reach by :func:`reconfigure` at
    the same boundary. ``store`` is the world's rendezvous store. The
    process has no default process group."""
    with _state.lock:
        if _state.initialized:
            raise HorovodError(
                "hvd.join: this process is already initialized; a joiner "
                "is a new process.")
        _env.validate_resilience_knobs()
        _env.validate_sharding_knobs()
        local_rank = int(os.environ.get("LOCAL_RANK", "0"))
        _state.device = _resolve_device(device, local_rank)
        _state.rank = int(os.environ["RANK"])
        _state.world = int(os.environ.get("WORLD_SIZE", "1"))
        rs = tuple(int(r) for r in ranks)
        _validate_members(rs)
        if _state.rank not in rs:
            raise HorovodError(
                f"hvd.join: rank {_state.rank} is not among the admitted "
                f"members {list(rs)}.")
        from horovod_tpu_torch.core import negotiate as _neg  # imports us

        _state.store = store
        _state.negotiator = _neg.Negotiator(
            dist.PrefixStore("horovod_tpu_torch", store),
            _env.stall_warning_seconds())
        _state.negotiator.set_generation(0, gen - 1)  # kv_generation: gen
        _state.groups = [Group(index=0, ranks=rs, pg=_elastic_pg(rs, gen))]
        _state.local_rank = local_rank
        _state.local_size = int(os.environ.get("LOCAL_WORLD_SIZE",
                                               _state.world))
        _state.fusion_threshold = _env.fusion_threshold_bytes()
        _state.owns_default_pg = False
        _state.reconfigures = 1
        _state.inits += 1
        _state.native = _make_native([len(rs)])
        _state.initialized = True
    _after_reconfigure()
    _start_heartbeat()
    return _state.groups[0]


def generation(group: int = 0) -> tuple[int, int]:
    """``(init cycle, the group's coordination generation)``: what an
    ``spmd`` program is keyed on, so a program recorded before a
    ``shutdown``/``init`` cycle or a :func:`bump_generation` never runs
    again."""
    get_group(group)
    return _state.inits, _state.negotiator.generation(group)


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

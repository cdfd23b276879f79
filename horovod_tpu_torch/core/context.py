"""Program context: how collectives know they run inside an ``spmd`` program.

Counterpart of ``horovod_tpu/core/context.py``. There ``hvd.spmd`` traces a
step function once under a ``TraceContext`` so that the collectives lower
into the compiled program. Here :func:`horovod_tpu_torch.parallel.spmd.spmd`
runs the step function under a :class:`ProgramContext` while it records
the program (on the card: while it captures the CUDA graph). Inside it,
every collective registers ``(name, op, dtype, shape, group, root)`` — and,
for a fusion bucket, the labels of its members — in the program's ordered
schedule, which ``core/multihost.py::validate_schedule`` compares across
the group's ranks once per program instead of one store round a call.

A process is a rank here, so the context carries no axis index: ``hvd.rank()``
inside a program is the process's rank, as outside.
"""

from __future__ import annotations

import dataclasses
import threading


@dataclasses.dataclass
class ProgramContext:
    """Active while ``spmd`` runs a step function as a program of group
    ``group_index``.

    ``negotiate``: the collectives also run their per-call negotiation
    (the first, eager call of a program, which does what every later call
    skips); otherwise they only register.
    """

    group_index: int
    negotiate: bool = False
    # name -> (op, dtype, shape, group, root), in registration order. The
    # define-by-name contract makes the name the cross-rank key; two
    # different collectives under one name in one program is the
    # coordinator-error case of the reference.
    names: dict = dataclasses.field(default_factory=dict)
    # name -> labels of the tensors a fusion bucket carries; not part of
    # the metadata compare.
    members: dict = dataclasses.field(default_factory=dict)

    def register(self, name: str, op: str, dtype, shape,
                 group: int | tuple[int, ...],
                 root_rank: int | None = None,
                 members: tuple[str, ...] | None = None) -> None:
        """Add one collective to the schedule; raise the reference's error
        when ``name`` was registered before with other metadata. ``group``
        is a tuple for a group family, registered by every rank of the
        program, including one in none of the family's groups."""
        from horovod_tpu_torch.core.state import HorovodError

        meta = (op, str(dtype), tuple(shape), group, root_rank)
        prev = self.names.get(name)
        if prev is None:
            self.names[name] = meta
            if members:
                self.members[name] = tuple(members)
            return
        if prev == meta:
            return  # the same collective again (a K-step program) — fine
        if prev[0] != op:
            raise HorovodError(
                f"Mismatched collective operations: tensor {name} was "
                f"submitted as both {prev[0]} and {op} in one program.")
        if prev[1] != meta[1]:
            raise HorovodError(
                f"Mismatched data types: tensor {name} was submitted with "
                f"type {prev[1]} and type {meta[1]} in one program.")
        if prev[2] != meta[2]:
            raise HorovodError(
                f"Mismatched {op.lower()} tensor shapes: tensor {name} was "
                f"submitted with shape {list(prev[2])} and shape "
                f"{list(meta[2])} in one program.")
        raise HorovodError(
            f"Tensor {name} was submitted twice with conflicting group/root "
            f"({prev[3:]} vs {meta[3:]}); use distinct names.")

    def schedule(self) -> list:
        """The ordered schedule as JSON-ready rows: ``[name, op, dtype,
        shape, group (a list for a family), root (-1 for none), members]``,
        the reference's row layout (``parallel/spmd.py``)."""
        return [[nm, op, dtype, list(shape),
                 list(group) if isinstance(group, tuple) else group,
                 -1 if root is None else root,
                 list(self.members.get(nm, ()))]
                for nm, (op, dtype, shape, group, root) in self.names.items()]


_tls = threading.local()


def current() -> ProgramContext | None:
    """The active program context of this thread, or None (eager)."""
    return getattr(_tls, "ctx", None)


class _Scope:
    def __init__(self, ctx: ProgramContext) -> None:
        self.ctx = ctx
        self.prev: ProgramContext | None = None

    def __enter__(self) -> ProgramContext:
        self.prev = getattr(_tls, "ctx", None)
        _tls.ctx = self.ctx
        return self.ctx

    def __exit__(self, *exc) -> None:
        _tls.ctx = self.prev


def enter(group_index: int, negotiate: bool = False) -> _Scope:
    """``with enter(group) as ctx:`` — run collectives as part of a
    program of ``group``."""
    return _Scope(ProgramContext(group_index=group_index,
                                 negotiate=negotiate))


def resume(ctx: ProgramContext | None) -> _Scope:
    """``with resume(ctx):`` — make ``ctx`` (a program's context saved in
    an autograd function's forward) current again, for the collectives of
    its backward: autograd runs a CUDA backward on a thread of its own,
    where no context is set. None: run outside any program."""
    return _Scope(ctx)

"""DistributedOptimizer and variable broadcast — the training-loop API.

Counterpart of ``horovod_tpu/parallel/optimizer.py`` (its replicated path).
:func:`DistributedOptimizer` wraps any ``torch.optim.Optimizer``: before each
``step()`` the gradients are averaged over the group through fused buckets
(``ops/fusion.py``, ``HOROVOD_FUSION_THRESHOLD``), so the inner optimizer's
momentum and statistics see the same averaged gradient on every rank, as in
the reference where the allreduce happens before apply.

The bucket plan is negotiated once per gradient signature (the dtypes and
shapes of the gradients, in order) and cached; a step whose signature has
been seen moves data only. Inside an ``spmd`` program the buckets register
in the program's schedule instead (name, dtype, size and the labels of
their members), which the program's one schedule validation checks across
the ranks, as the JAX package validates once per trace.
:func:`broadcast_variables` syncs parameters, buffers and optimizer state
from a root rank. Overlapping the allreduce with backward is not done yet.
"""

from __future__ import annotations

from typing import Mapping

import torch

from horovod_tpu_torch.core import negotiate as _neg
from horovod_tpu_torch.core import state as _state
from horovod_tpu_torch.core import timeline as _tl
from horovod_tpu_torch.ops import collectives as _coll
from horovod_tpu_torch.ops import fusion as _fusion


class FusedAllreduce:
    """In-place fused allreduce of a list of tensors over one group, with
    the bucket plan negotiated once per signature and cached on the
    object (inside an ``spmd`` program: registered in its schedule)."""

    def __init__(self, name: str, group: int = 0, average: bool = True,
                 fusion_threshold: int | None = None) -> None:
        self.name = name
        self.group = group
        self.average = average
        self.fusion_threshold = fusion_threshold
        self._plans: dict = {}

    def _plan(self, tensors, g: _state.Group):
        sig = tuple((t.dtype, tuple(t.shape)) for t in tensors)
        plan = self._plans.get(sig)
        if plan is None:
            threshold = (_state.fusion_threshold()
                         if self.fusion_threshold is None
                         else self.fusion_threshold)
            buckets = _fusion.plan_buckets_py(tensors, threshold)
            names = [f"{self.name}.bucket_{b}" for b in range(len(buckets))]
            plan = (buckets, names, None)
        buckets, names, negotiated = plan
        # Inside a program the buckets register; the plan is negotiated
        # only where the per-call round runs (outside, or a first call).
        negotiating = False
        for b, bk in enumerate(buckets):
            negotiating |= _coll.program_register(
                g, names[b], _neg.CollectiveOp.ALLREDUCE, bk.dtype,
                (bk.elems,), members=tuple(f"{self.name}.{i}"
                                           for i in bk.indices))
        if negotiating and not negotiated and g.pg is not None:
            me = g.group_rank_of(_state.global_rank())
            _neg.negotiate(
                [_neg.Request(rank=me, name=names[b],
                              op=_neg.CollectiveOp.ALLREDUCE,
                              dtype=_coll.dtype_name(bk.dtype),
                              shape=(bk.elems,), group=g.index)
                 for b, bk in enumerate(buckets)], g)
            negotiated = True
        self._plans[sig] = (buckets, names, negotiated)
        return buckets, names

    def __call__(self, tensors: list[torch.Tensor]) -> list[torch.Tensor]:
        g = _state.get_group(self.group)
        if not tensors:
            return tensors
        buckets, names = self._plan(tensors, g)
        if g.pg is None:
            return tensors

        def reduce(flat, b):
            with _tl.activity(names[b], "ALLREDUCE"):
                flat = _coll.sum_into(flat, g)
            return _coll.divide_avg(flat, g.size) if self.average else flat

        _fusion.fused_apply_(tensors, buckets, reduce, names)
        return tensors


def allreduce_gradients(grads: list[torch.Tensor], group: int = 0,
                        average: bool = True,
                        fusion_threshold: int | None = None,
                        name: str = "allreduce_gradients"
                        ) -> list[torch.Tensor]:
    """Allreduce-average a list of gradient tensors in place, with tensor
    fusion; returns the list. Negotiates on every call: a training loop
    should hold a :class:`FusedAllreduce` (as :func:`DistributedOptimizer`
    does) to negotiate once per signature."""
    return FusedAllreduce(name, group, average, fusion_threshold)(grads)


class _DistributedOptimizer:
    """The wrapper :func:`DistributedOptimizer` returns. ``param_groups``
    and ``state`` are the inner optimizer's, so LR schedules and momentum
    correction act on it directly."""

    def __init__(self, optimizer: torch.optim.Optimizer, group: int,
                 average: bool, fusion_threshold: int | None) -> None:
        self.optimizer = optimizer
        self._allreduce = FusedAllreduce("DistributedOptimizer.grads", group,
                                         average, fusion_threshold)

    @property
    def param_groups(self):
        return self.optimizer.param_groups

    @property
    def state(self):
        return self.optimizer.state

    def synchronize(self) -> None:
        """Average every gradient over the group (in place)."""
        grads = [p.grad for pg in self.optimizer.param_groups
                 for p in pg["params"] if p.grad is not None]
        self._allreduce(grads)

    def step(self, closure=None):
        self.synchronize()
        return self.optimizer.step(closure)

    def zero_grad(self, set_to_none: bool = True) -> None:
        self.optimizer.zero_grad(set_to_none=set_to_none)

    def state_dict(self) -> dict:
        """The inner optimizer's ``state_dict`` (what a checkpoint saves)."""
        return self.optimizer.state_dict()

    def load_state_dict(self, state_dict: dict) -> None:
        self.optimizer.load_state_dict(state_dict)


def DistributedOptimizer(optimizer: torch.optim.Optimizer, group: int = 0,
                         average: bool = True,
                         fusion_threshold: int | None = None):
    """Wrap ``optimizer`` so each ``step()`` first averages the gradients
    across ``group`` — the drop-in analog of ``hvd.DistributedOptimizer``.
    ``fusion_threshold`` overrides ``HOROVOD_FUSION_THRESHOLD`` (bytes; 0
    gives one collective per gradient)."""
    if isinstance(optimizer, _DistributedOptimizer):
        raise TypeError("optimizer is already a DistributedOptimizer.")
    return _DistributedOptimizer(optimizer, group, average, fusion_threshold)


def _named_tensors(variables) -> list[tuple[str, torch.Tensor]]:
    if isinstance(variables, torch.nn.Module):
        return list(variables.state_dict(keep_vars=True).items())
    if isinstance(variables, Mapping):
        return list(variables.items())
    return [(str(i), t) for i, t in enumerate(variables)]


def broadcast_variables(variables, root_rank: int = 0, group: int = 0,
                        name: str = "broadcast_variables") -> None:
    """Overwrite, in place, every tensor of ``variables`` (an ``nn.Module``'s
    parameters and buffers, a ``{name: tensor}`` mapping, or a list) with
    the root rank's values — run once after init or restore so all replicas
    start identical. One negotiation round covers all the tensors."""
    g = _state.get_group(group)
    items = _named_tensors(variables)
    negotiating = False
    for k, t in items:
        negotiating |= _coll.program_register(
            g, f"{name}.{k}", _neg.CollectiveOp.BROADCAST, t.dtype, t.shape,
            root_rank)
    if g.pg is None:
        return
    me = g.group_rank_of(_state.global_rank())
    if negotiating:
        _neg.negotiate(
            [_neg.Request(rank=me, name=f"{name}.{k}",
                          op=_neg.CollectiveOp.BROADCAST,
                          dtype=_coll.dtype_name(t.dtype),
                          shape=tuple(t.shape), root_rank=root_rank,
                          group=g.index)
             for k, t in items], g)
    with torch.no_grad():
        for k, t in items:
            with _tl.activity(f"{name}.{k}", "BROADCAST"):
                _coll.broadcast_(t.data, root_rank, g)


def optimizer_state_tensors(optimizer) -> dict[str, torch.Tensor]:
    """The optimizer's state tensors (e.g. SGD momentum buffers), keyed by
    parameter position and state key."""
    out = {}
    params = [p for pg in optimizer.param_groups for p in pg["params"]]
    for i, p in enumerate(params):
        for key, value in sorted(optimizer.state.get(p, {}).items()):
            if isinstance(value, torch.Tensor):
                out[f"{i}.{key}"] = value
    return out


def broadcast_optimizer_state(optimizer, root_rank: int = 0,
                              group: int = 0) -> None:
    """Broadcast the optimizer's state tensors from the root rank. Every
    rank must hold the same state structure (the negotiation checks)."""
    broadcast_variables(optimizer_state_tensors(optimizer), root_rank, group,
                        name="optimizer_state")


def broadcast_global_variables(model: torch.nn.Module, optimizer=None,
                               root_rank: int = 0, group: int = 0) -> None:
    """Broadcast a model's parameters and buffers and, when given, the
    optimizer's state from ``root_rank``."""
    broadcast_variables(model, root_rank, group)
    if optimizer is not None:
        broadcast_optimizer_state(optimizer, root_rank, group)

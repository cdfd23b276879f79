"""DistributedOptimizer and variable broadcast — the training-loop API.

Counterpart of ``horovod_tpu/parallel/optimizer.py`` (its replicated path).
:func:`DistributedOptimizer` wraps any ``torch.optim.Optimizer``: before each
``step()`` the gradients are averaged over the group through fused buckets
(``ops/fusion.py``, ``HOROVOD_FUSION_THRESHOLD``), so the inner optimizer's
momentum and statistics see the same averaged gradient on every rank, as in
the reference where the allreduce happens before apply.

The exchange plan (``ops/exchange.py``: the enumeration plan, or with
``schedule="priority"`` reverse-layer issue order and per-region bucket
sizes) is built and negotiated once per gradient signature (the dtypes and
shapes of the gradients, in order) and cached; a step whose signature has
been seen moves data only, issuing the buckets in the plan's order. Inside
an ``spmd`` program the buckets register in the program's schedule instead
(name, dtype, size and the labels of their members), in plan order, which
the program's one schedule validation checks across the ranks, as the JAX
package validates once per trace. Each gradient exchange registers its
plan: ``exchange.last_plan()`` is the most recent one.
:func:`broadcast_variables` syncs parameters, buffers and optimizer state
from a root rank.

The exchange overlaps backward, as the reference's background thread does
(its replicated path only). ``zero_grad(set_to_none=False)``, when every
parameter that requires a gradient already holds a dense one (the
Trainer's step from its second call), arms the step: the plan is built,
registered and negotiated there, on the calling thread and inside the
program's context. Each parameter's post-accumulate-grad hook then marks
its gradient ready, and a bucket is issued as soon as all its members are
ready and every bucket before it in the plan's order has been issued:
the wire order is the plan's on every rank, whatever order autograd fires
the hooks in, and the results are bit for bit those of the exchange
after backward. When the backward pass ends, what is left is issued and
waited for, so ``.grad`` holds the averaged gradients when ``backward()``
returns, for whatever reads them before ``step()``; a second backward
pass before ``step()`` raises. On the card a bucket issued while backward
still owes gradients runs on an exchange stream of the wrapper's, which
forks from the backward stream at each such bucket and joins the stream
that called ``backward()`` as that pass ends (inside a captured step:
before the capture ends); the buckets issued once every gradient is in
run on the calling stream, as the exchange after backward does. Under the
``enum`` plan the first layers' bucket, whose gradients come last, is
issued first, so everything still goes out at the end of backward;
``schedule="priority"`` (reverse-layer issue order) is what overlaps. A
first step (no ``.grad`` yet), ``zero_grad()`` with ``set_to_none=True``
and a COO gradient stay unarmed and exchange after backward, in
``synchronize()``. A group family arms too: its buckets, each one family
allreduce under its auto name, are registered and negotiated when the
step is armed, and the hooks move their data. The sharded modes
(``parallel/sharded.py``) arm on the same mechanism
(``parallel/overlap.py``): ZeRO-2/3 issue each tensor's reduce-scatter
from backward, in reverse gather order; ZeRO-1, one reduce-scatter a
dtype, stays unarmed.

The exchange's knobs are the reference's, each resolved as there
(argument, then its environment default, then off): ``compression``
(``HOROVOD_COMPRESSION``; ``ops/compression.py``), ``algo``
(``HOROVOD_ALLREDUCE_ALGO``; ``ops/strategy.py``), ``cross_compression``
(``HOROVOD_COMPRESSION_CROSS_SLICE``), ``channels``
(``HOROVOD_EXCHANGE_CHANNELS``, and ``HOROVOD_MAX_CHANNELS`` for the
planner's own choice), ``schedule`` (``HOROVOD_EXCHANGE_SCHEDULE``) and,
on the wrapper, ``error_feedback``
(``HOROVOD_ERROR_FEEDBACK``): each rank keeps the residual of its own
quantization per float parameter, adds it to the next step's gradient and
keeps the new one, in place, so a captured step replays it. The wrapper's
``state_dict`` then holds ``{"inner": ..., "residual": ...}``, which
``load_state_dict``, a checkpoint and :func:`broadcast_optimizer_state`
carry bit for bit. Unlike the reference's, the gradient path also runs
eagerly, compressed as in a program.

Sparse gradients take the sparse exchange (``ops/sparse.py``): an
``IndexedSlices`` item of :func:`allreduce_gradients`, and a COO
``p.grad`` (``nn.Embedding(sparse=True)``) in :func:`DistributedOptimizer`,
whose ``synchronize`` writes back a COO gradient of the merged rows that
``torch.optim.SGD`` applies. On the card a COO gradient is exchanged
eagerly only: inside a captured step program it raises.
"""

from __future__ import annotations

import dataclasses
import functools
import os
from typing import Mapping

import torch

from horovod_tpu_torch.core import context as _ctx
from horovod_tpu_torch.core import negotiate as _neg
from horovod_tpu_torch.core import state as _state
from horovod_tpu_torch.core import timeline as _tl
from horovod_tpu_torch.core.state import HorovodError
from horovod_tpu_torch.ops import collectives as _coll
from horovod_tpu_torch.ops import compression as _compression
from horovod_tpu_torch.ops import exchange as _exchange
from horovod_tpu_torch.ops import fusion as _fusion
from horovod_tpu_torch.ops import mesh as _mesh
from horovod_tpu_torch.ops import sparse as _sparse
from horovod_tpu_torch.ops import strategy as _strategy
from horovod_tpu_torch.ops import topology as _topology
from horovod_tpu_torch.parallel import overlap as _overlap
from horovod_tpu_torch.parallel import sharded as _sharded
from horovod_tpu_torch.tune import apply as _tune_apply
from horovod_tpu_torch.utils import costs as _costs
from horovod_tpu_torch.utils import env as _env


class FusedAllreduce:
    """In-place fused allreduce of a list of tensors over one group, with
    the exchange plan (``ops/exchange.py``) built and negotiated once per
    signature and cached on the object (inside an ``spmd`` program: its
    buckets registered in the program's schedule, in plan order).

    The wire knobs (``compression``, ``algo``, ``cross_compression``,
    ``channels``; None = the environment default) are resolved when a
    signature is first planned; each bucket carries its wire dtype,
    algorithm and channel count (``Bucket.describe``). The planner's
    knobs are explicit: ``schedule`` is ``"enum"`` (None) or
    ``"priority"``; ``priority_fn(label, index)`` re-ranks a priority
    plan, where ``label`` is the member label the exchange registers for
    tensor ``index``: ``<name>.<index>``; ``max_channels`` caps the
    planner's channel choice (None: 1, off).

    ``gradient=True`` makes it the gradient path's exchange
    (:func:`allreduce_gradients`, :func:`DistributedOptimizer`): a None
    knob then resolves as the reference's gradient path does, explicit
    env > an applied tuned config (``tune/apply.py``) > default, for the
    algorithm, compression, cross-host wire, fusion threshold, schedule
    and channel cap; the fusion threshold comes from the tuning cache
    under ``HOROVOD_AUTOTUNE=1``; and a restricted group (a family, or
    another group than the program's) keeps the defaults. Without it (the
    Trainer's buffer sync) the tuned values never apply. :attr:`plan` is
    the plan of the most recent call."""

    def __init__(self, name: str, group: int = 0, average: bool = True,
                 fusion_threshold: int | None = None, compression=None,
                 algo=None, cross_compression=None, channels=None,
                 schedule=None, priority_fn=None,
                 max_channels: int | None = None,
                 gradient: bool = False) -> None:
        if schedule is not None:
            _exchange.resolve_mode(schedule)
        self.gradient = gradient
        self.name = name
        self.group = group
        self.average = average
        self.fusion_threshold = fusion_threshold
        self.compression = compression
        self.algo = algo
        self.cross_compression = cross_compression
        self.channels = channels
        self.schedule = schedule
        self.priority_fn = priority_fn
        self.max_channels = max_channels
        self.plan: _exchange.ExchangeSchedule | None = None
        self._plans: dict = {}

    def _group(self) -> _state.Group | None:
        """The exchange's group; None for a group family, whose members
        each reduce on their own family group's process group."""
        if _coll._is_group_index(self.group):
            return _state.get_group(self.group)
        return None

    def _resolve(self, tensors, g: _state.Group, restricted: bool):
        """The plan of a new signature (an ``ExchangeSchedule``), and the
        resolved compressor, cross format and topology."""
        def tuned(name):
            # The applied tuned value of an env knob: None unless a config
            # is active and the env leaves the knob unset. Restricted
            # groups keep their defaults, as in the reference.
            if not self.gradient or restricted:
                return None
            return _tune_apply.override(name)

        def knob(arg, name, default):
            if arg is not None:
                return arg
            value = tuned(name)
            return default() if value is None else value

        if self.gradient:
            mode = _exchange.resolve_mode(knob(
                self.schedule, "HOROVOD_EXCHANGE_SCHEDULE", lambda: None))
            cap = int(knob(self.max_channels, "HOROVOD_MAX_CHANNELS",
                           _env.max_channels))
        else:
            mode = ("enum" if self.schedule is None
                    else _exchange.resolve_mode(self.schedule))
            cap = 1 if self.max_channels is None else self.max_channels
        threshold = self.fusion_threshold
        if threshold is None:
            threshold = tuned("HOROVOD_FUSION_THRESHOLD")
            if threshold is not None:
                threshold = int(threshold)
            elif (self.gradient and _env.autotune_enabled()
                  and os.environ.get("HOROVOD_FUSION_THRESHOLD") is None):
                ctx = _ctx.current()
                threshold = _costs.tuned_fusion_threshold(
                    _topology.discover(g if g is not None else
                                       _state.get_group(
                                           0 if ctx is None
                                           else ctx.group_index)))
            else:
                threshold = _state.fusion_threshold()
        comp = _compression.active(
            knob(self.compression, "HOROVOD_COMPRESSION", lambda: None))
        algo = knob(self.algo, "HOROVOD_ALLREDUCE_ALGO", lambda: None)
        algo_spec = (_strategy.gradient_algo_default() if algo is None
                     else _strategy.resolve_spec(algo))
        cross_spec = knob(self.cross_compression,
                          "HOROVOD_COMPRESSION_CROSS_SLICE",
                          _env.compression_cross_slice_default)
        channels = (_strategy.resolve_channels(self.channels)
                    if self.channels is not None
                    else _env.exchange_channels_default())
        if restricted:
            if channels is not None and channels > 1:
                raise HorovodError(
                    f"channels={channels} requires the full-axis "
                    f"single group: subset groups and group families only "
                    f"support the single-instance masked-psum lowering. "
                    f"Use group=0 (the global group) or drop channels=.")
            channels, cap = None, 1
        # The priority planner's sizing floor and the channel model read
        # the topology's seed links (plan_exchange), never the tuning
        # cache, so every rank computes the same plan.
        topo = (_topology.discover(g) if not restricted
                and (algo_spec in ("auto", "hierarchical")
                     or mode == "priority" or cap > 1) else None)

        def bucket_algo(bucket):
            return _coll.select_bucket_algo(
                algo_spec, comp, cross_spec, bucket.dtype, bucket.elems, g,
                restricted, "gradient bucket", bucket.bytes_on_wire,
                topo=topo)[0]

        plan = _exchange.plan_exchange(
            tensors, threshold, mode=mode, compression=comp,
            algo=bucket_algo,
            labels=[f"{self.name}.{i}" for i in range(len(tensors))],
            topo=topo, world_size=None if g is None else g.size,
            priority_fn=self.priority_fn,
            cross_compression=cross_spec, channels=channels,
            max_channels=cap)
        return plan, comp, cross_spec, topo

    def _plan(self, tensors, g: _state.Group):
        restricted = _restricted_group(self.group)
        # An elastic rebuild of group 0 changes the world the plan was for.
        sig = (restricted, _state.reconfigures()) + tuple(
            (t.dtype, tuple(t.shape)) for t in tensors)
        plan = self._plans.get(sig)
        if plan is None:
            sched, comp, cross_spec, topo = self._resolve(tensors, g,
                                                          restricted)
            names = [f"{self.name}.bucket_{b}"
                     for b in range(len(sched.buckets))]
            plan = (sched, names, (comp, cross_spec, topo), None)
        sched, names, wire, negotiated = plan
        if g is None:
            # A family's buckets register and negotiate one by one, each
            # as a family allreduce (ops/collectives.py), as the
            # reference's do: _FamilyExchange.
            self._plans[sig] = plan
            self.plan = sched
            return sched, names, wire, restricted
        # Inside a program the buckets register; the plan is negotiated
        # only where the per-call round runs (outside, or a first call).
        negotiating = False
        for b, (bk, members) in enumerate(zip(sched.buckets,
                                              sched.members)):
            negotiating |= _coll.program_register(
                g, names[b], _neg.CollectiveOp.ALLREDUCE, bk.dtype,
                (bk.elems,), members=members)
        if negotiating and not negotiated and g.pg is not None:
            me = g.group_rank_of(_state.global_rank())
            _neg.negotiate(
                [_neg.Request(rank=me, name=names[b],
                              op=_neg.CollectiveOp.ALLREDUCE,
                              dtype=_coll.dtype_name(bk.dtype),
                              shape=(bk.elems,), group=g.index)
                 for b, bk in enumerate(sched.buckets)], g)
            negotiated = True
        self._plans[sig] = (sched, names, wire, negotiated)
        self.plan = sched
        return sched, names, wire, restricted

    def plan_of(self, tensors) -> _exchange.ExchangeSchedule:
        """``tensors``' plan (planned, not negotiated nor cached)."""
        g = self._group()
        return self._resolve(tensors, g, _restricted_group(self.group))[0]

    def buckets(self, tensors) -> list:
        """The buckets of ``tensors``' plan, in issue order."""
        return list(self.plan_of(tensors).buckets)

    def exchange(self, tensors, residuals=None,
                 compression_key=None) -> "_Exchange | None":
        """``tensors``' exchange planned, registered and negotiated: an
        :class:`_Exchange` (a family's: a :class:`_FamilyExchange`) whose
        buckets then issue one at a time, moving data only; None where
        nothing moves (this rank outside the group). ``residuals`` and
        ``compression_key`` as in :meth:`__call__`."""
        g = self._group()
        if g is None and _ctx.current() is None:
            raise HorovodError(
                "Group-family allreduce is only available inside "
                "hvd.spmd traced code; eagerly, issue one allreduce "
                "per group.")
        sched, names, wire, restricted = self._plan(tensors, g)
        _refuse_residuals(residuals, restricted)
        if g is None:
            return _FamilyExchange(self, sched, names, wire[0])
        if g.pg is None:
            return None
        return _Exchange(self, g, sched, names, wire, residuals,
                         compression_key)

    def __call__(self, tensors: list[torch.Tensor], residuals=None,
                 compression_key=None) -> list[torch.Tensor]:
        """Reduce ``tensors`` in place. ``residuals`` (error feedback): one
        tensor or None a tensor; each is overwritten with its tensor's
        local quantization residual (zero where the bucket's contribution
        was exact). ``compression_key``: the stochastic formats' per-step
        key."""
        if not tensors:
            return tensors
        ex = self.exchange(tensors, residuals, compression_key)
        if ex is not None:
            _fusion.record_schedule(ex.sched)
            for b in range(len(ex.sched.buckets)):
                ex.issue(tensors, b)
        return tensors


def _refuse_residuals(residuals, restricted: bool) -> None:
    if residuals is not None and restricted:
        raise HorovodError(
            "error_residual requires the full-axis single group: a "
            "subset-group or group-family exchange masks non-member "
            "contributions, which would corrupt the residual algebra. "
            "Use group=0 (the global group) or drop error feedback.")


class _Exchange:
    """One exchange of a :class:`FusedAllreduce` over one group, planned,
    registered and negotiated: :meth:`issue` packs, reduces and unpacks
    one bucket, moving data only, so a caller may issue the buckets one at
    a time (in the plan's order, ``sched.buckets``) while backward still
    runs."""

    def __init__(self, fused: FusedAllreduce, g: _state.Group, sched,
                 names, wire, residuals, compression_key) -> None:
        self.fused = fused
        self.g = g
        self.sched = sched
        self.names = names
        self.comp, self.cross_spec, self.topo = wire
        self.residuals = residuals
        self.key = compression_key

    def _reduce(self, flat: torch.Tensor, b: int) -> torch.Tensor:
        bk = self.sched.buckets[b]
        name = self.names[b]
        with _tl.activity(name, "ALLREDUCE"):
            if self.comp is None and self.cross_spec is None \
                    and bk.algo == "flat" and bk.channels == 1:
                _compression.record_local(None)
                out = _coll.sum_into(flat, self.g)
            else:
                out = _coll.compressed_sum(
                    flat, self.g, self.comp, self.key, name,
                    self.sched.members[b], algo=bk.algo, topo=self.topo,
                    cross_spec=self.cross_spec, channels=bk.channels)
        return (_coll.divide_avg(out, self.g.size) if self.fused.average
                else out)

    def _reduce_keeping_residuals(self, tensors, flat: torch.Tensor,
                                  b: int) -> torch.Tensor:
        with _compression.collect_local_contributions() as sink:
            out = self._reduce(flat, b)
        local = sink[0]
        # The residual is computed before the reduced value replaces the
        # contribution: the compressed lowerings leave ``flat`` as it was.
        resid = None if local is None else local.residual(flat)
        offset = 0
        for i in self.sched.buckets[b].indices:
            n = tensors[i].numel()
            r = self.residuals[i]
            if r is not None:
                if resid is None:
                    r.zero_()
                else:
                    r.copy_(resid[offset:offset + n].view_as(r))
            offset += n
        return out

    def issue(self, tensors, b: int) -> None:
        """Bucket ``b`` of ``tensors`` (the exchange's signature) reduced
        in place: pack, reduce, unpack. With error feedback the members'
        residuals are added first: ``grad + residual`` is what is
        compressed."""
        if self.residuals is None:
            fn = functools.partial(self._reduce, b=b)
        else:
            for i in self.sched.buckets[b].indices:
                r = self.residuals[i]
                if r is not None:
                    tensors[i].add_(r.to(tensors[i].dtype))
            fn = functools.partial(self._reduce_keeping_residuals, tensors,
                                   b=b)
        _fusion.apply_bucket_(tensors, self.sched.buckets[b], fn,
                              self.names[b])


class _FamilyExchange:
    """One exchange of a :class:`FusedAllreduce` over a group family. Each
    bucket is one family allreduce (``ops/collectives.py``): it reduces on
    this rank's family group (a rank in none keeps its values) and refuses
    compression with the reference's text; its name is the collective's
    auto name, as the reference's buckets'. Every bucket is registered and
    negotiated here, in the plan's order, on the calling thread
    (``collectives.prepare_allreduce``); :meth:`issue` moves one bucket's
    data only."""

    def __init__(self, fused: FusedAllreduce, sched, names, comp) -> None:
        self.sched = sched
        self.names = names
        self.runs = [_coll.prepare_allreduce(
            torch.empty((bk.elems,), dtype=bk.dtype, device="meta"),
            group=fused.group, average=fused.average,
            members=sched.members[b], compression=comp)
            for b, bk in enumerate(sched.buckets)]

    def issue(self, tensors, b: int) -> None:
        """Bucket ``b`` of ``tensors`` reduced in place on the family."""
        _fusion.apply_bucket_(tensors, self.sched.buckets[b], self.runs[b],
                              self.names[b])


def _restricted_group(group) -> bool:
    """A family, or a group other than the program's (eagerly: the
    world's): it takes the flat lowering only, and the gradient path's
    tuned values never reach it."""
    ctx = _ctx.current()
    return (not _coll._is_group_index(group)
            or int(group) != (0 if ctx is None else ctx.group_index))


def _exchange_sparse(item: _sparse.IndexedSlices, i: int, group: int,
                     average: bool, sparse_algo, name: str, compression=None,
                     compression_key=None):
    """One sparse gradient's exchange: planned once and exchanged on the
    program's group (its value payload compressed as ``compression``
    says); a subset group takes the reference's plain gather,
    uncompressed, and a rank outside it keeps its own gradient. Returns
    the exchanged slices and the plan's row (None on a subset group,
    which the reference leaves out of the plan)."""
    label = f"{name}.{i}"
    ctx = _ctx.current()
    if ctx is None or group != ctx.group_index:
        out = _sparse.allreduce_indexed_slices(
            item, group=group, average=average, name=label,
            algo=sparse_algo)
        return (item if out is None else out), None
    row = _sparse.plan_sparse_exchange(item, group=group, algo=sparse_algo,
                                       compression=compression, index=i,
                                       label=label)
    return _sparse.allreduce_indexed_slices(
        item, group=group, average=average, name=label, algo=row.algo,
        compression=compression, compression_key=compression_key,
        _plan=row), row


def allreduce_gradients(grads: list, group: int = 0, average: bool = True,
                        fusion_threshold: int | None = None,
                        name: str = "allreduce_gradients",
                        compression=None, compression_key=None, algo=None,
                        schedule=None, priority_fn=None,
                        cross_compression=None, error_residual=None,
                        channels=None, sparse_algo=None):
    """Allreduce-average a list of gradients with tensor fusion; returns
    the list. Dense tensors are reduced in place through fused buckets.
    An :class:`~horovod_tpu_torch.ops.sparse.IndexedSlices` item takes the
    sparse exchange (``ops/sparse.py``; ``sparse_algo``: ``"gather"``, the
    default, ``"dense"`` or ``"auto"``) and is replaced in the returned
    list by the exchanged slices. Negotiates on every call: a training loop
    should hold a :class:`FusedAllreduce` (as :func:`DistributedOptimizer`
    does) to negotiate once per signature.

    The wire knobs are the reference's (module docstring); ``compression``
    also quantizes the sparse items' value payloads, and
    ``compression_key`` (an int or a 0-d int64 tensor) keys the stochastic
    formats. ``error_residual``: a list congruent with ``grads`` (None for
    an item without one): each dense float gradient contributes ``grad +
    residual`` and the call returns ``(grads, new_residuals)``, the new
    residual being the local quantization error (zero for an exact
    bucket).

    ``schedule`` (``"enum"``, the default of ``HOROVOD_EXCHANGE_SCHEDULE``,
    or ``"priority"``) and ``priority_fn(label, index)`` pick the exchange
    plan (``ops/exchange.py``; ``HOROVOD_MAX_CHANNELS`` caps its channel
    choice); ``index`` is the tensor's position among the dense items and
    ``label`` is ``<name>.<index>``. The call's plan, the sparse items'
    rows included, is :func:`~horovod_tpu_torch.ops.exchange.last_plan`
    afterwards."""
    sparse = [i for i, g in enumerate(grads)
              if isinstance(g, _sparse.IndexedSlices)]
    if sparse and not _coll._is_group_index(group):
        raise HorovodError(
            "Group-family sparse allreduce is not supported: an "
            "IndexedSlices exchange targets a single group; issue one "
            "allreduce_indexed_slices per group.")
    if compression is None and not _restricted_group(group):
        compression = _tune_apply.override("HOROVOD_COMPRESSION")
    comp = _compression.active(compression)
    fused = FusedAllreduce(name, group, average, fusion_threshold,
                           compression=comp or "none", algo=algo,
                           cross_compression=cross_compression,
                           channels=channels, schedule=schedule,
                           priority_fn=priority_fn, gradient=True)
    rows = []
    for i in sparse:
        grads[i], row = _exchange_sparse(grads[i], i, group, average,
                                         sparse_algo, name, comp,
                                         compression_key)
        if row is not None:
            rows.append(row)
    dense = [i for i in range(len(grads)) if i not in sparse]
    outs = new_resid = None
    if error_residual is not None:
        if len(error_residual) != len(grads):
            raise HorovodError(
                f"error_residual pytree has {len(error_residual)} leaves "
                f"for {len(grads)} gradient leaves; it must mirror the "
                f"gradient structure (ErrorFeedbackState.residual).")
        # Sparse items keep their residual; an integer gradient is exact.
        new_resid = [None if r is None else r.clone()
                     for r in error_residual]
        outs = []
        for i in dense:
            r = new_resid[i]
            if r is not None and grads[i].dtype.is_floating_point:
                outs.append(r)
            else:
                if r is not None:
                    r.zero_()
                outs.append(None)
    fused([grads[i] for i in dense], residuals=outs,
          compression_key=compression_key)
    if dense or rows:
        # The whole exchange's plan: the dense buckets and the sparse rows.
        plan = fused.plan if dense else fused.plan_of([])
        _exchange.register_live_plan(
            dataclasses.replace(plan, sparse_buckets=tuple(rows)))
    return grads if error_residual is None else (grads, new_resid)


class _DistributedOptimizer:
    """The wrapper :func:`DistributedOptimizer` returns. ``param_groups``
    and ``state`` are the inner optimizer's, so LR schedules and momentum
    correction act on it directly; with error feedback, ``residual`` maps
    each float parameter's position to its residual tensor.

    The overlap: :meth:`zero_grad` with ``set_to_none=False``, when every
    parameter that requires a gradient already holds a dense one, arms the
    step (:class:`~horovod_tpu_torch.parallel.overlap.Overlap`): the
    exchange is planned, registered and negotiated there, on the calling
    thread, each parameter's
    post-accumulate-grad hook issues the buckets that become ready during
    backward, and the pass's end issues the rest and waits for them.
    ``hooks_fired`` and ``buckets_in_backward`` count the hooks
    that an armed step took and the buckets they issued. Unarmed (a first
    step, ``set_to_none=True``, a COO gradient) the step exchanges after
    backward, in :meth:`synchronize`."""

    def __init__(self, optimizer: torch.optim.Optimizer, group: int,
                 average: bool, fusion_threshold: int | None,
                 compression=None, algo=None, cross_compression=None,
                 channels=None, error_feedback: bool = False,
                 sparse_algo=None, schedule: str | None = None) -> None:
        self.optimizer = optimizer
        self._allreduce = FusedAllreduce(
            "DistributedOptimizer.grads", group, average, fusion_threshold,
            compression=compression, algo=algo,
            cross_compression=cross_compression, channels=channels,
            schedule=schedule, gradient=True)
        self.sparse_algo = sparse_algo
        self.error_feedback = error_feedback
        self.residual: dict[int, torch.Tensor] = {}
        self._armed: _overlap.Overlap | None = None
        # The exchange stream, made at the first armed step on the card.
        self._stream = None
        self.hooks_fired = 0
        self.buckets_in_backward = 0
        _overlap.hook_params(self, self._params())
        if error_feedback:
            # Zero on every rank; each then keeps its own residual.
            with torch.no_grad():
                self.residual = {
                    i: torch.zeros_like(p)
                    for i, p in enumerate(self._params())
                    if p.dtype.is_floating_point}

    def _params(self) -> list:
        return [p for pg in self.optimizer.param_groups for p in pg["params"]]

    @property
    def param_groups(self):
        return self.optimizer.param_groups

    @property
    def state(self):
        return self.optimizer.state

    def synchronize(self) -> None:
        """Average every gradient over the group: dense ones in place
        (with error feedback, ``grad + residual`` is what is compressed,
        and the residual is updated in place), and a sparse COO one
        (``nn.Embedding(sparse=True)``) through the sparse exchange,
        replaced by a COO gradient of the merged rows. An armed step
        whose backward has ended has nothing left to issue; one whose
        gradients no hook saw (``torch.autograd.grad`` written into
        ``.grad``) issues every bucket here."""
        armed, self._armed = self._armed, None
        if armed is not None:
            armed.finish()
            _exchange.register_live_plan(armed.plan)
            return
        params = [(i, p) for i, p in enumerate(self._params())
                  if p.grad is not None]
        dense = [(i, p) for i, p in params if not p.grad.is_sparse]
        coo = [p for _, p in params if p.grad.is_sparse]
        grads = [p.grad for _, p in dense]
        with torch.no_grad():
            self._allreduce(grads, residuals=(
                [self.residual.get(i) for i, _ in dense]
                if self.error_feedback else None))
        if grads:
            _exchange.register_live_plan(self._allreduce.plan)
        for i, p in enumerate(coo):
            p.grad = self._exchange_coo(p.grad, i)

    def _exchange_coo(self, grad: torch.Tensor, i: int) -> torch.Tensor:
        if grad.device.type != "cpu" and _ctx.current() is not None:
            raise HorovodError(
                "DistributedOptimizer: a sparse COO gradient (nn.Embedding("
                "sparse=True)) is not exchanged inside a captured step "
                "program on the card: a COO tensor's entry count lives on "
                "the host, so the port does not capture it. Compute the "
                "sparse gradient as hvd.IndexedSlices (value_and_sparse_grad "
                "of models/word2vec.py) and exchange it with "
                "hvd.allreduce_gradients, or step this optimizer eagerly.")
        g = self._allreduce.group
        if not _coll._is_group_index(g):
            raise HorovodError(
                "Group-family sparse allreduce is not supported: an "
                "IndexedSlices exchange targets a single group; issue one "
                "allreduce_indexed_slices per group.")
        slices = _sparse.IndexedSlices(
            grad._values(), grad._indices()[0].to(torch.int32),
            tuple(grad.shape))
        out, _ = _exchange_sparse(slices, i, g, self._allreduce.average,
                                  self.sparse_algo,
                                  f"{self._allreduce.name}.sparse",
                                  _compression.active(
                                      self._allreduce.compression))
        values, indices = _sparse.dedup_merge(out.values, out.indices)
        return torch.sparse_coo_tensor(indices.long()[None], values,
                                       grad.shape)

    def step(self, closure=None):
        self.synchronize()
        return self.optimizer.step(closure)

    def zero_grad(self, set_to_none: bool = True) -> None:
        """The inner optimizer's ``zero_grad``; with ``set_to_none=False``
        it also arms the step (class docstring). A step armed before and
        not stepped (its backward raised, or the caller dropped it) is
        dropped: the buckets it issued are waited for, the rest never
        go out."""
        armed, self._armed = self._armed, None
        if armed is not None:
            armed.close()
        self.optimizer.zero_grad(set_to_none=set_to_none)
        if not set_to_none:
            self._arm()

    def _arm(self) -> None:
        params = self._params()
        dense = [(i, p) for i, p in enumerate(params) if p.grad is not None]
        restricted = _restricted_group(self._allreduce.group)
        if (not dense or (self.error_feedback and restricted)
                or any(p.grad.is_sparse for _, p in dense)
                or any(p.requires_grad and p.grad is None for p in params)):
            return
        if not _coll._is_group_index(self._allreduce.group) \
                and _ctx.current() is None:
            return      # a family exchanges in a program only: step() says
        grads = [p.grad for _, p in dense]
        residuals = ([self.residual.get(i) for i, _ in dense]
                     if self.error_feedback else None)
        ex = self._allreduce.exchange(grads, residuals)
        if ex is None:
            return
        _fusion.record_schedule(ex.sched)
        ps = [p for _, p in dense]
        self._armed = _overlap.Overlap(
            ps, [list(bk.indices) for bk in ex.sched.buckets],
            lambda b: ex.issue([p.grad for p in ps], b),
            _overlap.exchange_stream(self, grads[0].device), _ctx.current(),
            plan=ex.sched)

    def state_dict(self) -> dict:
        """The inner optimizer's ``state_dict`` (what a checkpoint saves);
        with error feedback ``{"inner": ..., "residual": {position:
        tensor}}``."""
        if not self.error_feedback:
            return self.optimizer.state_dict()
        return {"inner": self.optimizer.state_dict(),
                "residual": {i: r.detach().clone()
                             for i, r in self.residual.items()}}

    def load_state_dict(self, state_dict: dict) -> None:
        """Restore :meth:`state_dict`; the residuals are copied into the
        wrapper's own tensors, bit for bit."""
        if not self.error_feedback:
            self.optimizer.load_state_dict(state_dict)
            return
        if set(state_dict) != {"inner", "residual"}:
            raise HorovodError(
                f"DistributedOptimizer(error_feedback=True) restores a "
                f"state dict of 'inner' and 'residual', got "
                f"{sorted(state_dict)}.")
        residual = {int(i): r for i, r in state_dict["residual"].items()}
        if set(residual) != set(self.residual):
            raise HorovodError(
                f"error-feedback residuals for parameters "
                f"{sorted(residual)}, but this optimizer keeps "
                f"{sorted(self.residual)}.")
        self.optimizer.load_state_dict(state_dict["inner"])
        with torch.no_grad():
            for i, r in residual.items():
                self.residual[i].copy_(r)


def DistributedOptimizer(optimizer: torch.optim.Optimizer, group: int = 0,
                         average: bool = True,
                         fusion_threshold: int | None = None,
                         sharded: bool = False, compression=None, algo=None,
                         schedule=None, cross_compression=None,
                         error_feedback: bool | None = None, channels=None,
                         sparse_algo=None, sharding: str | None = None,
                         fsdp_size: int | None = None, params=None):
    """Wrap ``optimizer`` so each ``step()`` first averages the gradients
    across ``group`` — the drop-in analog of ``hvd.DistributedOptimizer``.
    ``fusion_threshold`` overrides ``HOROVOD_FUSION_THRESHOLD`` (bytes; 0
    gives one collective per gradient). ``compression``, ``algo``,
    ``cross_compression``, ``channels`` and ``error_feedback`` are the
    reference's (module docstring); ``sparse_algo`` (``"gather"``,
    ``"dense"`` or ``"auto"``) is the COO gradients' exchange.
    ``schedule`` (``"enum"``/``"priority"``, default
    ``HOROVOD_EXCHANGE_SCHEDULE``) picks the exchange plan
    (``ops/exchange.py``; ``HOROVOD_MAX_CHANNELS`` caps its channel
    choice), both knobs read here; a step's plan is ``last_plan()`` after
    it (the COO gradients' rows are not in it).

    ``sharded=True`` is ZeRO-1 and ``sharding="zero2"|"zero3"`` (None:
    ``HOROVOD_SHARDING``; ``fsdp_size``: ``HOROVOD_FSDP_AXIS_SIZE``, else
    one host) ZeRO-2/3 over the ``data × fsdp`` mesh
    (``parallel/sharded.py``); their steps run inside ``hvd.spmd``, and
    ``zero3`` returns a :class:`~horovod_tpu_torch.parallel.sharded.
    Zero3Optimizer`, whose step shape ``Trainer(sharding='zero3')`` drives.
    Gradient ``compression`` composes (bf16 for ZeRO-1; none, bf16, int8
    and int8_block for ZeRO-2/3); the knobs a sharded exchange leaves no
    room for raise, with the reference's texts. A sharded mode also takes
    an optimizer builder (``training.sgd``/``adam``) for ``optimizer``,
    built over the shards of ``params``."""
    if isinstance(optimizer, _DistributedOptimizer):
        raise TypeError("optimizer is already a DistributedOptimizer.")
    if error_feedback is None:
        error_feedback = _env.error_feedback_default()
    sharding_mode = _mesh.resolve_sharding(sharding)
    if sharding_mode != "off":
        if sharded:
            raise HorovodError(
                f"sharded=True (ZeRO-1) and sharding={sharding_mode!r} "
                f"(ZeRO-2/3) are different sharded-state schemes; pick "
                f"one. Drop sharded=True to use the FSDP modes.")
        for arg, value, why in (
                ("sparse_algo", sparse_algo,
                 "sparse IndexedSlices gradients are not supported"),
                ("channels", channels,
                 "its per-leaf exchange has no bucket channel instances"),
                ("cross_compression", cross_compression,
                 "the cross-slice wire format is fixed by the "
                 "compressor's own phase-asymmetric policy"),
                ("fusion_threshold", fusion_threshold,
                 "the exchange is per-leaf by construction (shards must "
                 "map back to layers for gather-on-use)"),
                ("algo", algo,
                 "the exchange already IS the reduce-scatter prefix of "
                 "the topology's own decomposition"),
                ("schedule", schedule,
                 "issue order is the plan's fsdp gather order, not a "
                 "bucket schedule")):
            if value is not None:
                raise HorovodError(
                    f"{arg}= does not apply to the sharded "
                    f"({sharding_mode}) optimizer: {why}. Drop the "
                    f"argument or use sharding='off'.")
        if error_feedback:
            raise HorovodError(
                f"error_feedback is not supported by the sharded "
                f"({sharding_mode}) optimizer: its state is a flat "
                f"per-leaf shard pytree and the shard-keeping exchange "
                f"has no per-rank attributable quantization error. Use "
                f"sharding='off' (or compression='bf16', which needs no "
                f"compensation).")
        cls = (_sharded.Zero2Optimizer if sharding_mode == "zero2"
               else _sharded.Zero3Optimizer)
        return cls(optimizer, group=group, average=average,
                   compression=compression, fsdp_size=fsdp_size,
                   params=params)
    if sharded:
        if sparse_algo is not None:
            raise HorovodError(
                "sparse_algo= does not apply to the sharded (ZeRO-1) "
                "optimizer: sparse IndexedSlices gradients are not "
                "supported there at all. Drop the argument or use "
                "sharded=False.")
        if channels is not None:
            raise HorovodError(
                "channels= does not apply to the sharded (ZeRO-1) "
                "optimizer: its exchange is one flat reduce-scatter per "
                "dtype, not per-bucket channel instances. Drop the "
                "argument or use sharded=False.")
        if cross_compression is not None:
            raise HorovodError(
                "cross_compression does not apply to the sharded "
                "(ZeRO-1) optimizer: its exchange is one flat "
                "reduce-scatter per dtype with no hierarchical phases. "
                "Drop the argument or use sharded=False.")
        if error_feedback:
            raise HorovodError(
                "error_feedback is not supported by the sharded (ZeRO-1) "
                "optimizer: its state is a flat 1/n shard pytree, not "
                "per-parameter, so there is nowhere to carry per-leaf "
                "residuals. Use sharded=False (or compression='bf16', "
                "which needs no compensation).")
        if fusion_threshold is not None:
            raise HorovodError(
                "fusion_threshold does not apply to the sharded (ZeRO-1) "
                "optimizer: it already moves one flat reduce-scatter per "
                "dtype, so there is nothing to fuse. Drop the argument or "
                "use sharded=False.")
        if algo is not None:
            raise HorovodError(
                "algo= does not apply to the sharded (ZeRO-1) optimizer: "
                "its exchange already IS the reduce-scatter + all-gather "
                "decomposition. Drop the argument or use sharded=False.")
        if schedule is not None:
            raise HorovodError(
                "schedule= does not apply to the sharded (ZeRO-1) "
                "optimizer: it moves one flat reduce-scatter per dtype, "
                "so there is no bucket issue order to schedule. Drop the "
                "argument or use sharded=False.")
        return _sharded.ShardedOptimizer(optimizer, group=group,
                                         average=average,
                                         compression=compression,
                                         params=params)
    _sparse.resolve_sparse_algo(sparse_algo)
    _exchange.resolve_mode(schedule)  # typos raise here, not at a step
    _env.max_channels()
    return _DistributedOptimizer(
        optimizer, group, average, fusion_threshold,
        compression=compression, algo=algo,
        cross_compression=cross_compression, channels=channels,
        error_feedback=bool(error_feedback), sparse_algo=sparse_algo,
        schedule=schedule)


def _named_tensors(variables) -> list[tuple[str, torch.Tensor]]:
    if isinstance(variables, torch.nn.Module):
        return list(variables.state_dict(keep_vars=True).items())
    if isinstance(variables, Mapping):
        return list(variables.items())
    return [(str(i), t) for i, t in enumerate(variables)]


def sharded_optimizer(optimizer, group: int = 0, average: bool = True,
                      compression=None, params=None):
    """ZeRO-1 (the reference's ``sharded_optimizer``): reduce-scatter the
    gradients, update a 1/n state shard, all-gather the parameters —
    :class:`~horovod_tpu_torch.parallel.sharded.ShardedOptimizer`, which
    ``DistributedOptimizer(sharded=True)`` also returns. ``optimizer`` is
    a ``torch.optim`` optimizer that has not stepped, or a
    ``training.sgd``/``adam`` builder with the ``params`` it shards (the
    reference takes an optax transformation). ``compression="bf16"``
    moves both collectives in bfloat16; int8 and the block formats are
    refused with the reference's text."""
    return _sharded.ShardedOptimizer(optimizer, group=group, average=average,
                                     compression=compression, params=params)


def sharded_zero2_optimizer(optimizer, group: int = 0, average: bool = True,
                            compression=None, fsdp_size: int | None = None,
                            params=None):
    """ZeRO-2 on the ``data × fsdp`` mesh (the reference's
    ``sharded_zero2_optimizer``):
    :class:`~horovod_tpu_torch.parallel.sharded.Zero2Optimizer`, which
    ``DistributedOptimizer(sharding="zero2")`` also returns; ``optimizer``
    and ``params`` as in :func:`sharded_optimizer`."""
    return _sharded.Zero2Optimizer(optimizer, group=group, average=average,
                                   compression=compression,
                                   fsdp_size=fsdp_size, params=params)


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
    parameter position and state key; a :func:`DistributedOptimizer` with
    error feedback adds its residuals (``residual.<position>``)."""
    out = {}
    params = [p for pg in optimizer.param_groups for p in pg["params"]]
    for i, p in enumerate(params):
        for key, value in sorted(optimizer.state.get(p, {}).items()):
            if isinstance(value, torch.Tensor):
                out[f"{i}.{key}"] = value
    for i, r in sorted(getattr(optimizer, "residual", {}).items()):
        out[f"residual.{i}"] = r
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

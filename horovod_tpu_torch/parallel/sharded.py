"""ZeRO: the sharded optimizers — ZeRO-1, and ZeRO-2/3 on the ``data ×
fsdp`` mesh.

Counterpart of ``horovod_tpu/parallel/optimizer.py``'s ``sharded_optimizer``
(ZeRO-1), ``sharded_zero2_optimizer`` and ``Zero3Optimizer``.
:func:`~horovod_tpu_torch.parallel.optimizer.DistributedOptimizer` returns
them for ``sharded=True`` and ``sharding="zero2"|"zero3"``; ``Trainer``
drives them (``training/loop.py``). Their steps run inside an ``hvd.spmd``
program, as the reference's run inside a traced step.

The torch idiom, written down once:

* A torch optimizer binds to its parameters when it is built, so each
  wrapper builds its inner optimizer ANEW over this rank's shard tensors:
  the same class with each param group's hyperparameters (a 0-d tensor
  learning rate is shared, so ``set_lr`` reaches it), or, given a
  ``training.sgd``/``adam`` builder, the builder called on the shards. The
  full-size optimizer state is never allocated. An optimizer that has
  stepped already is refused (its state would be dropped).
* A torch optimizer applies its own update, so ZeRO-1 and ZeRO-2 step the
  inner optimizer on the parameter shards, all-gather the NEW shards and
  ``copy_`` them into the module's parameters: the reference's
  ``fsdp_apply=True`` form, element for element ``param +
  gathered(update)`` for an elementwise optimizer.
* Each shard's gradient is a buffer kept between steps and written by
  ``copy_``, so a captured step (and kernel A1's launch table) sees the
  same addresses at every replay.

ZeRO-1 (:class:`ShardedOptimizer`) flattens the parameters into one vector
per (param group, dtype), in order of first appearance — with one param
group exactly the reference's per-dtype layout — padded to ``group size ×
shard length``; rank i owns slice i. ZeRO-2/3 shard each parameter on its
own, over the fsdp axis (``ops/mesh.py``), and reduce each gradient by the
reduce-scatter prefix of the replicated lowering
(``ops/strategy.py::lower_fsdp_grad_exchange``), so the losses equal the
replicated path's bit for bit. ZeRO-3 (:class:`Zero3Optimizer`) keeps only
the shards: the module's parameters are released after
:meth:`Zero3Optimizer.init_shards`, each step gathers them
(:meth:`~Zero3Optimizer.gather_params`), runs the forward and backward on
the gathered tensors (:meth:`~Zero3Optimizer.swapped`) and updates shard to
shard (:meth:`~Zero3Optimizer.apply_gradients`). Elementwise inner
optimizers only: one that reads a parameter's shape would see a flat shard.

The exchange overlaps compute, as the reference's XLA scheduler overlaps
its per-leaf collectives, once a step is armed: ``zero_grad(set_to_none=
False)`` inside the step's program (the Trainer's step from its second
call; ``parallel/overlap.py``). ZeRO-2 arms when every parameter that
requires a gradient holds one, ZeRO-3 once a step has been applied. The
step's plan and reduce rows are registered there, on the calling thread,
and each parameter's post-accumulate-grad hook marks its gradient ready:
a tensor's reduce-scatter prefix is issued once its gradient is in and
every tensor after it in the gather order has gone, so the wire order is
reverse gather order (the order backward produces the gradients) on
every rank, whatever order the hooks fire in; the end of backward issues
the rest and joins. An armed ZeRO-3 step also leaves its gathers in
flight: :meth:`~Zero3Optimizer.gather_params` issues them in the plan's
gather order (on the card on a gather stream forked from the calling
stream, an event a parameter; on gloo asynchronously), and
:meth:`~Zero3Optimizer.swapped` waits for each where the forward first
reads the parameter, once. The results are bit for bit the unarmed
step's. ZeRO-1 (one reduce-scatter a dtype, which needs every gradient,
in the reference too) never arms. Unarmed steps (a first step,
``set_to_none=True``, a step whose shape skips ``zero_grad``) exchange
after backward and gather before the forward.
"""

from __future__ import annotations

import contextlib
import functools
import inspect
import math
import weakref

import torch

from horovod_tpu_torch.core import context as _ctx
from horovod_tpu_torch.core import negotiate as _neg
from horovod_tpu_torch.core import state as _state
from horovod_tpu_torch.core.state import HorovodError
from horovod_tpu_torch.ops import collectives as _coll
from horovod_tpu_torch.ops import compression as _compression
from horovod_tpu_torch.ops import exchange as _exchange
from horovod_tpu_torch.ops import mesh as _mesh
from horovod_tpu_torch.ops import sparse as _sparse
from horovod_tpu_torch.ops import strategy as _strategy
from horovod_tpu_torch.ops import topology as _topology
from horovod_tpu_torch.parallel import overlap as _overlap

#: Label prefix of the gradients (``<name>.<index>``), as the replicated
#: path's.
NAME = "DistributedOptimizer.grads"


def _param_lists(optimizer, params) -> list[list[torch.Tensor]]:
    """The parameters to shard, per param group: ``optimizer``'s, or for a
    builder (a callable that makes the optimizer) ``params`` as one
    group."""
    if isinstance(optimizer, torch.optim.Optimizer):
        if optimizer.state:
            raise HorovodError(
                "the sharded optimizers build their inner optimizer anew "
                "over the parameter shards, so the wrapped optimizer must "
                "not have stepped yet (its state would be dropped).")
        return [list(pg["params"]) for pg in optimizer.param_groups]
    if params is None:
        raise HorovodError(
            "a sharded optimizer made from an optimizer builder needs the "
            "parameters it shards (params=).")
    return [list(params)]


def _rebuild(optimizer, shard_lists) -> torch.optim.Optimizer:
    """The inner optimizer over the shards (module docstring)."""
    if not isinstance(optimizer, torch.optim.Optimizer):
        return optimizer([s for shards in shard_lists for s in shards])
    cls = type(optimizer)
    accepted = inspect.signature(cls.__init__).parameters
    takes_all = any(p.kind is p.VAR_KEYWORD for p in accepted.values())
    kwargs = {k: v for k, v in optimizer.defaults.items()
              if takes_all or k in accepted}
    groups = [dict({k: v for k, v in pg.items() if k != "params"},
                   params=shards)
              for pg, shards in zip(optimizer.param_groups, shard_lists)]
    return cls(groups, **kwargs)


def _slice_of(tensors, lo: int, hi: int, dtype, device) -> torch.Tensor:
    """Elements ``[lo, hi)`` of the tensors' values flattened and
    concatenated, zero past their end: a new tensor."""
    out = torch.zeros(hi - lo, dtype=dtype, device=device)
    off = 0
    for t in tensors:
        n = t.numel()
        a, b = max(lo, off), min(hi, off + n)
        if a < b:
            out[a - lo:b - lo] = t.detach().reshape(-1)[a - off:b - off]
        off += n
    return out


def _new_shard(tensors, lo: int, hi: int, like: torch.Tensor):
    """A shard tensor (a leaf the inner optimizer owns) with a gradient
    buffer kept between steps."""
    shard = _slice_of(tensors, lo, hi, like.dtype, like.device)
    shard.grad = torch.zeros_like(shard)
    return shard


def _grads_of(params, mode_name: str, off_hint: str) -> list:
    """Each parameter's gradient (zeros where backward left none); a
    sparse one is refused with the reference's text."""
    out = []
    for p in params:
        g = p.grad
        if g is not None and (g.is_sparse
                              or isinstance(g, _sparse.IndexedSlices)):
            raise HorovodError(
                f"Sparse IndexedSlices gradients are not supported by the "
                f"sharded ({mode_name}) optimizer; use {off_hint}.")
        out.append(torch.zeros_like(p) if g is None else g)
    return out


class _Sharded:
    """What the three wrappers share: the parameters they shard, the inner
    optimizer's ``param_groups``/``state``/``state_dict``, and
    ``zero_grad`` over the module's parameters (the shards' gradients are
    overwritten each step)."""

    def __init__(self, optimizer, group, average: bool, params) -> None:
        self.group = group
        self.average = average
        self._lists = _param_lists(optimizer, params)
        self._params = [p for ps in self._lists for p in ps]
        self._source = optimizer
        self.optimizer: torch.optim.Optimizer | None = None
        self.shards: list[torch.Tensor] = []
        # The armed step (ZeRO-2/3; ZeRO-1 never arms) and what armed
        # steps took: the hooks and the units they issued.
        self._armed: _overlap.Overlap | None = None
        self.hooks_fired = 0
        self.buckets_in_backward = 0

    @property
    def param_groups(self):
        return self.optimizer.param_groups

    @property
    def state(self):
        return self.optimizer.state

    def zero_grad(self, set_to_none: bool = True) -> None:
        for p in self._params:
            if p.grad is None:
                continue
            if set_to_none:
                p.grad = None
            else:
                p.grad.detach_()
                p.grad.zero_()

    def state_dict(self) -> dict:
        """The inner optimizer's ``state_dict``: this rank's shard of the
        state (save it with ``checkpoint.save_sharded``)."""
        return self.optimizer.state_dict()

    def load_state_dict(self, state_dict: dict) -> None:
        self.optimizer.load_state_dict(state_dict)

    def _build_inner(self, shard_lists) -> None:
        """The inner optimizer over ``shard_lists`` (one list a param
        group); :attr:`shards` is their concatenation."""
        self.shards = [s for shards in shard_lists for s in shards]
        self.optimizer = _rebuild(self._source, shard_lists)
        self._source = None

    def _per_group(self, shards) -> list[list]:
        """One shard a parameter, grouped as the param groups."""
        out, i = [], 0
        for ps in self._lists:
            out.append(list(shards[i:i + len(ps)]))
            i += len(ps)
        return out


# -- ZeRO-1 --------------------------------------------------------------------


class ShardedOptimizer(_Sharded):
    """ZeRO-1: reduce-scatter the gradients → update a 1/n state shard →
    all-gather the new parameters (module docstring for the layout).

    Non-members of a subset ``group`` take no part: their parameters hold
    still (the reference's zero updates). ``compression="bf16"`` moves
    both collectives in bfloat16; the gather then carries each shard's
    update (the new shard minus the old), which every rank adds to its
    parameters, since a bf16 gather of the parameters themselves would
    round them. ``int8`` and the block formats are refused with the
    reference's text."""

    def __init__(self, optimizer, group: int = 0, average: bool = True,
                 compression=None, params=None) -> None:
        comp = _compression.active(compression)
        if comp is not None and not comp.elementwise:
            raise HorovodError(
                f"{comp.name} compression is not supported by the sharded "
                f"(ZeRO-1) optimizer: the update allgather would inject "
                f"stochastic quantization noise directly into parameters "
                f"(and unsummable wire formats cannot ride its summing "
                f"reduce-scatter). Use compression='bf16' or "
                f"sharded=False.")
        if not _coll._is_group_index(group):
            raise HorovodError(
                "sharded DistributedOptimizer takes a single group index, "
                "not a group family.")
        super().__init__(optimizer, group, average, params)
        self.comp = comp
        g = _state.get_group(group)
        grank = g.group_rank_of(_state.global_rank())
        self._member = grank >= 0
        rc = max(grank, 0)
        # (indices into _params, total elements, shard length) a bucket.
        self._buckets: list[tuple[list[int], int, int]] = []
        shard_lists, base = [], 0
        for ps in self._lists:
            by_dt: dict[torch.dtype, list[int]] = {}
            for j, p in enumerate(ps):
                by_dt.setdefault(p.dtype, []).append(base + j)
            shard_lists.append([])
            for idx in by_dt.values():
                total = sum(self._params[i].numel() for i in idx)
                shard_len = -(-total // g.size)
                self._buckets.append((idx, total, shard_len))
                shard_lists[-1].append(_new_shard(
                    [self._params[i] for i in idx], rc * shard_len,
                    (rc + 1) * shard_len, self._params[idx[0]]))
            base += len(ps)
        self._build_inner(shard_lists)

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        if _ctx.current() is None:
            raise HorovodError(
                "sharded (ZeRO-1) DistributedOptimizer.update must run "
                "inside an hvd.spmd-wrapped step function.")
        g = _state.get_group(self.group)
        grads = _grads_of(self._params, "ZeRO-1", "sharded=False")
        comp = self.comp
        olds = {}
        for b, (idx, total, shard_len) in enumerate(self._buckets):
            shard = self.shards[b]
            # Reduce in the gradients' own (promoted) dtype, then cast to
            # the bucket's parameter dtype: a bf16-ward cast before the
            # sum would accumulate across ranks in bf16.
            reduce_dt = functools.reduce(torch.promote_types,
                                         [grads[i].dtype for i in idx])
            flat = torch.cat([grads[i].reshape(-1).to(reduce_dt)
                              for i in idx])
            pad = g.size * shard_len - total
            if pad:
                flat = torch.cat([flat, flat.new_zeros(pad)])
            name = f"{NAME}.zero1_{b}"
            if comp is not None and comp.applies_to(flat.dtype):
                wctx = _compression.WireContext(group_size=g.size)
                wire, meta = _strategy.quantize(name, comp, flat, wctx)
                red = _coll.reducescatter(wire, group=self.group, name=name)
                if red is not None:
                    red = _strategy.dequantize(name, lambda: comp.decompress(
                        red, meta, reduce_dt, wctx))
            else:
                red = _coll.reducescatter(flat, group=self.group, name=name)
            if red is None:
                continue
            if self.average:
                red = red / g.size
            shard.grad.copy_(red)
            if comp is not None and comp.applies_to(shard.dtype):
                olds[b] = shard.clone()
        if self._member:
            self.optimizer.step()
        for b, (idx, total, shard_len) in enumerate(self._buckets):
            shard = self.shards[b]
            name = f"{NAME}.zero1_{b}.gather"
            params = [self._params[i] for i in idx]
            if comp is not None and comp.applies_to(shard.dtype):
                delta = shard - olds[b] if b in olds else shard
                wctx = _compression.WireContext(group_size=g.size)
                wire, meta = _strategy.quantize(name, comp, delta, wctx)
                got = _coll.allgather(wire, group=self.group, name=name)
                if got is None:
                    continue
                full = _strategy.dequantize(name, lambda: comp.decompress(
                    got, meta, delta.dtype, wctx))[:total]
                off = 0
                for p in params:
                    p.add_(full[off:off + p.numel()].view_as(p))
                    off += p.numel()
                rc = g.group_rank_of(_state.global_rank())
                shard.copy_(_slice_of(params, rc * shard_len,
                                      (rc + 1) * shard_len, shard.dtype,
                                      shard.device))
                continue
            got = _coll.allgather(shard, group=self.group, name=name)
            if got is None:
                continue
            off = 0
            for p in params:
                p.copy_(got[off:off + p.numel()].view_as(p))
                off += p.numel()
        return loss


# -- ZeRO-2/3 on the data × fsdp mesh -------------------------------------------


def _fsdp_setup(group, fsdp_size):
    """(FsdpMesh, Topology) of a live group."""
    topo = _topology.discover(_state.get_group(group))
    return _mesh.layout(topo, fsdp_size), topo


def _fsdp_multiple(comp, fmesh) -> int:
    """The extra pad multiple of the flat shard layout: a blocked
    compressor with one data group exchanges the BLOCK-wire flat layout
    (``lower_fsdp_grad_exchange``'s second case), so shards live in
    block-padded coordinates; every other case pads to the fsdp size
    only."""
    block = getattr(comp, "block", None) if comp is not None else None
    return block if (block and fmesh.data_size == 1) else 1


def fsdp_resolve_comp(compression):
    """The gradient wire's compressor for the sharded modes (None:
    ``HOROVOD_COMPRESSION``, or an applied tuned config's value when the
    env leaves it unset): summable formats only, since the exchange keeps
    a reduce-scatter prefix and int4's gather scheme has none."""
    if compression is None:
        from horovod_tpu_torch.tune import apply as _tune_apply

        compression = _tune_apply.override("HOROVOD_COMPRESSION")
    comp = _compression.active(compression)
    if comp is not None and not comp.summable:
        raise HorovodError(
            f"{comp.name} compression is not supported by the sharded "
            f"(ZeRO-2/3) modes: its wire format is unsummable, so the "
            f"gather-based exchange has no reduce-scatter prefix to "
            f"keep a shard from. Use none/bf16/int8/int8_block, or "
            f"sharding='off'.")
    return comp


def _check_group_index(mode: str, group) -> None:
    if not _coll._is_group_index(group):
        raise HorovodError(
            f"the sharded ({mode}) optimizer takes a single group "
            f"index, not a group family: shards partition one group's "
            f"rank space.")


def _fsdp_check_ctx(mode: str, group) -> _ctx.ProgramContext:
    tctx = _ctx.current()
    if tctx is None:
        raise HorovodError(
            f"the sharded ({mode}) optimizer must run inside an "
            f"hvd.spmd-wrapped step function: its shard layout is a "
            f"per-rank view with no eager rank-stacked equivalent.")
    _check_group_index(mode, group)
    if int(group) != tctx.group_index:
        raise HorovodError(
            f"the sharded ({mode}) optimizer requires the full-axis "
            f"single group (group {int(group)} inside a group-"
            f"{tctx.group_index} program): subset groups have no "
            f"uniform fsdp partition. Run the spmd program on group "
            f"{int(group)} itself.")
    return tctx


def fsdp_plan(mode: str, leaves, labels, comp, fmesh, topo,
              gather_order) -> _exchange.ExchangeSchedule:
    """The whole-step FSDP exchange plan (``ops/exchange.py``): the
    per-tensor reduce rows (threshold 0: the exchange is per tensor by
    construction) plus the ``fsdp`` section — mode, mesh shape, and the
    zero3 gather order with each tensor's bytes and wire dtype. Its JSON
    equals the JAX package's for the same leaves and labels."""
    algo_tag = ("hierarchical"
                if fmesh.multi_slice and fmesh.matches_slices()
                else "rs_ag")
    plan = _exchange.plan_exchange(
        leaves, 0, mode="enum", compression=comp,
        algo=lambda bucket: algo_tag, labels=labels, topo=topo,
        world_size=fmesh.group_size)
    meta = _exchange.FsdpMeta(
        mode=mode, fsdp_size=fmesh.fsdp_size, data_size=fmesh.data_size,
        gather_order=tuple(gather_order),
        leaf_bytes=tuple(l.numel() * l.dtype.itemsize for l in leaves),
        wire_dtypes=tuple(_coll.dtype_name(l.dtype) for l in leaves))
    return plan.with_fsdp(meta)


class _Fsdp(_Sharded):
    """ZeRO-2 and ZeRO-3's shared layout and exchange: one flat shard a
    parameter, ``[f·L, (f+1)·L)`` of its zero-padded flat layout for fsdp
    index ``f``; a tensor's reduce-scatter issued after backward, or from
    backward in reverse gather order once the step is armed (module
    docstring). ``hooks_fired`` and ``buckets_in_backward`` count the
    hooks armed steps took and the reduce-scatters they issued."""

    mode = "zero2"

    def __init__(self, optimizer, group, average, compression, fsdp_size,
                 params) -> None:
        self.comp = fsdp_resolve_comp(compression)
        _check_group_index(self.mode, group)
        super().__init__(optimizer, group, average, params)
        self._fsdp_size = fsdp_size
        self.fmesh, self.topo = _fsdp_setup(group, fsdp_size)
        m = _fsdp_multiple(self.comp, self.fmesh)
        g = _state.get_group(group)
        self._f = (max(g.group_rank_of(_state.global_rank()), 0)
                   % self.fmesh.fsdp_size)
        self._shapes = [tuple(p.shape) for p in self._params]
        self._padded = [self.fmesh.padded_numel(p.numel(), m)
                        for p in self._params]
        self.labels = [f"{NAME}.{i}" for i in range(len(self._params))]
        self._plans: dict = {}
        self._negotiated: set = set()
        self._stream = None     # the exchange stream, made when first armed

    def mesh(self) -> _mesh.FsdpMesh:
        return self.fmesh

    def _shard_len(self, i: int) -> int:
        return self.fmesh.shard_len(self._padded[i])

    def shard_params(self, params=None) -> list[torch.Tensor]:
        """This rank's shards of full parameters (default: the module's),
        as new tensors: the re-shard path of a restore."""
        params = self._params if params is None else list(params)
        out = []
        for i, p in enumerate(params):
            L = self._shard_len(i)
            out.append(_slice_of([p], self._f * L, (self._f + 1) * L,
                                 p.dtype, p.device))
        return out

    def _make_shards(self, params=None) -> list[torch.Tensor]:
        """This rank's shard of each of ``params`` (default: the
        optimizer's), each with its gradient buffer."""
        params = self._params if params is None else list(params)
        out = []
        for i, p in enumerate(params):
            L = self._shard_len(i)
            out.append(_new_shard([p], self._f * L, (self._f + 1) * L, p))
        return out

    def _register(self, key, rows) -> None:
        """Register ``rows`` ((name, op, dtype, shape)) in the program and,
        in a program's first call, negotiate them in one round (once per
        ``key``)."""
        g = _state.get_group(self.group)
        negotiating = False
        for name, op, dtype, shape in rows:
            negotiating |= _coll.program_register(g, name, op, dtype, shape)
        if negotiating and key not in self._negotiated and g.size > 1:
            me = g.group_rank_of(_state.global_rank())
            _neg.negotiate([_neg.Request(
                rank=me, name=name, op=op, dtype=_coll.dtype_name(dtype),
                shape=tuple(shape), group=g.index)
                for name, op, dtype, shape in rows], g)
            self._negotiated.add(key)

    def _gather(self, i: int, shard: torch.Tensor) -> torch.Tensor:
        g = _state.get_group(self.group)
        full = _strategy.lower_fsdp_param_gather(shard, self.fmesh,
                                                 self.labels[i], g, self.topo)
        n = 1
        for d in self._shapes[i]:
            n *= d
        return full[:n].view(self._shapes[i])

    def _gather_rows(self) -> list:
        return [(f"{label}.gather", _neg.CollectiveOp.ALLGATHER, s.dtype,
                 (s.numel(),)) for label, s in zip(self.labels, self.shards)]

    def _plan_reduce(self, grads, gather_order):
        """The step's plan (:func:`fsdp_plan`, cached per signature),
        registered live (:func:`~horovod_tpu_torch.ops.exchange.
        last_plan`), and its reduce rows registered in the program
        (negotiated in a program's first call). ``grads`` may be ``meta``
        tensors: only their dtypes and shapes are read."""
        sig = tuple((t.dtype, tuple(t.shape)) for t in grads)
        plan = self._plans.get(sig)
        if plan is None:
            plan = self._plans[sig] = fsdp_plan(
                self.mode, grads, self.labels, self.comp, self.fmesh,
                self.topo, gather_order)
        _exchange.register_live_plan(plan)
        self._register(("reduce", sig), [
            (label, _neg.CollectiveOp.ALLREDUCE, t.dtype, tuple(t.shape))
            for label, t in zip(self.labels, grads)])
        return plan

    def _reduce_one(self, i: int, t: torch.Tensor) -> None:
        """Gradient ``i`` reduced to this rank's shard, divided by the
        group size for the average, into the shard's gradient buffer."""
        shard, _ = _strategy.lower_fsdp_grad_exchange(
            t, self.fmesh, self.labels[i], self.comp, None,
            _state.get_group(self.group), self.topo)
        if self.average:
            shard = _coll.divide_avg(shard, self.fmesh.group_size)
        self.shards[i].grad.copy_(shard)

    def _reduce(self, grads, gather_order) -> None:
        """Each gradient reduced to this rank's shard (:meth:`_reduce_one`),
        in enumeration order, after the step's plan is registered."""
        self._plan_reduce(grads, gather_order)
        for i, t in enumerate(grads):
            self._reduce_one(i, t)

    def _arm_reduce(self, params, grads, gather_order, grad_of):
        """Arm the step's reduce-scatters: the plan registered now (on
        the calling thread, inside the program's context), and an
        :class:`~horovod_tpu_torch.parallel.overlap.Overlap` whose unit k
        reduces tensor ``n-1-k`` (reverse gather order: the order backward
        produces them, the same wire order on every rank), reading its
        gradient from ``grad_of(i)`` when issued. ``params``: the leaves
        whose hooks mark the gradients accumulated."""
        plan = self._plan_reduce(grads, gather_order)
        n = len(grads)

        def issue(k: int) -> None:
            self._reduce_one(n - 1 - k, grad_of(n - 1 - k))

        self._armed = _overlap.Overlap(
            params, [[i] for i in reversed(range(n))], issue,
            _overlap.exchange_stream(self, self.shards[0].device),
            _ctx.current(), plan=plan)
        return self._armed

    def _drop_armed(self) -> None:
        """A step armed and not stepped (its backward raised, or the
        caller dropped it) is dropped: the units it issued are waited for,
        the rest never go out."""
        armed, self._armed = self._armed, None
        if armed is not None:
            armed.close()

    def _in_program(self) -> bool:
        tctx = _ctx.current()
        return (tctx is not None and _coll._is_group_index(self.group)
                and int(self.group) == tctx.group_index)


class Zero2Optimizer(_Fsdp):
    """ZeRO-2 on the ``data × fsdp`` mesh: reduce-scatter each gradient to
    a 1/fsdp_size shard (summing over the ``data`` axis in the same chain:
    the replicated lowering's prefix), update that shard with optimizer
    state kept sharded for good, and all-gather the NEW parameter shards
    into the module's replicated parameters (module docstring). The gather
    moves the parameter dtype: compressing it would put unaveraged
    quantization noise straight into the parameters."""

    mode = "zero2"

    def __init__(self, optimizer, group: int = 0, average: bool = True,
                 compression=None, fsdp_size: int | None = None,
                 params=None) -> None:
        super().__init__(optimizer, group, average, compression, fsdp_size,
                         params)
        self._build_inner(self._per_group(self._make_shards()))
        _overlap.hook_params(self, self._params)

    def zero_grad(self, set_to_none: bool = True) -> None:
        """Zero the module's gradients; with ``set_to_none=False`` inside
        the step's program, when every parameter that requires a gradient
        already holds a dense one (the Trainer's step from its second
        call), it also arms the step: the plan is registered here and each
        parameter's post-accumulate-grad hook issues reduce-scatters from
        backward, in reverse gather order (class docstring)."""
        self._drop_armed()
        super().zero_grad(set_to_none)
        params = self._params
        if (set_to_none or not self._in_program()
                or any(p.grad is None and p.requires_grad for p in params)
                or any(p.grad is not None and p.grad.is_sparse
                       for p in params)):
            return
        grads = [p.grad if p.grad is not None else p.detach().new_empty(
            p.shape, device="meta") for p in params]

        def grad_of(i: int) -> torch.Tensor:
            g = params[i].grad
            return torch.zeros_like(params[i]) if g is None else g

        self._arm_reduce(params, grads, (), grad_of)

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        _fsdp_check_ctx("zero2", self.group)
        armed, self._armed = self._armed, None
        if armed is not None:
            armed.finish()
        else:
            grads = _grads_of(self._params, "zero2", "sharding='off'")
            self._reduce(grads, gather_order=())
        self.optimizer.step()
        self._register("gather", self._gather_rows())
        for i, p in enumerate(self._params):
            p.copy_(self._gather(i, self.shards[i]))
        return loss


class Zero3Optimizer(_Fsdp):
    """ZeRO-3 on the ``data × fsdp`` mesh: parameters AND optimizer state
    live sharded; each step all-gathers every parameter's shard on use
    (:meth:`gather_params`, in the plan's gather order), runs forward and
    backward on the gathered tensors (:meth:`swapped`), reduces the
    gradients to shards by the replicated lowerings' reduce-scatter
    prefix and updates shard to shard (:meth:`apply_gradients`) with no
    parameter all-gather at all. An armed step (:meth:`zero_grad` with
    ``set_to_none=False``, once a step has been applied) gathers beside
    the forward, each parameter waited for at its first read, and
    reduce-scatters beside backward (module docstring); ``gathers`` holds
    the newest armed step's waits, ``gather_waits`` counts them all.

    Its step shape differs from an optimizer's, so ``Trainer(sharding=
    'zero3')`` drives it::

        opt = hvd.DistributedOptimizer(inner, sharding="zero3")
        opt.bind(model)                  # eager, once: the layout
        shards = opt.init_shards()       # eager: the module's params go
        opt.init(shards)                 # the inner optimizer on shards
        # inside hvd.spmd:
        opt.zero_grad(set_to_none=False) # arms the step from the second
        full = opt.gather_params(shards)
        with opt.swapped(model, full):
            loss_fn(model, batch).backward()
        opt.apply_gradients([t.grad for t in full], shards)

    The gathered tensors are leaves that require grad, allocated by the
    step (inside a capture, from the graph's pool); the module's buffers
    stay in the module, replicated."""

    mode = "zero3"

    def __init__(self, optimizer, group: int = 0, average: bool = True,
                 compression=None, fsdp_size: int | None = None,
                 params=None) -> None:
        super().__init__(optimizer, group, average, compression, fsdp_size,
                         params)
        self._bound = False
        self._sites: list[list[tuple[torch.nn.Module, str]]] = []
        self._order = tuple(range(len(self._params)))
        self._steps = 0             # apply_gradients calls so far
        self._arm_next = False      # zero_grad(set_to_none=False) armed it
        self._full: list | None = None   # the armed step's gathered leaves
        self._gather_stream = None  # made at the first armed step (card)
        #: The newest armed step's gathers (:class:`_Gathers`), and the
        #: gathers waited for over every armed step.
        self.gathers: _Gathers | None = None
        self.gather_waits = 0

    # -- eager (host-side) layout -------------------------------------------

    def bind(self, params_template=None) -> "Zero3Optimizer":
        """Record the parameter layout (shapes, dtypes, labels, padded flat
        sizes, gather order) — eagerly, once, before any step.
        ``params_template``: the ``nn.Module`` holding the parameters (what
        :meth:`swapped` needs), a sequence congruent with the optimizer's
        parameters, or None. The gather order is enumeration order: first
        needed first for the forward pass."""
        template = params_template
        if isinstance(template, torch.nn.Module):
            self._sites = self._find_sites(template)
        elif template is not None:
            template = list(template)
            for leaf in template:
                if isinstance(leaf, _sparse.IndexedSlices) or (
                        isinstance(leaf, torch.Tensor) and leaf.is_sparse):
                    raise HorovodError(
                        "Sparse IndexedSlices parameters are not supported "
                        "by the sharded (zero3) optimizer.")
            if [tuple(t.shape) for t in template] != self._shapes:
                raise HorovodError(
                    "Zero3Optimizer.bind: the template's shapes "
                    f"{[tuple(t.shape) for t in template]} are not the "
                    f"optimizer's parameters' {self._shapes}.")
        self._bound = True
        return self

    def _find_sites(self, model: torch.nn.Module) -> list:
        """Where each parameter lives in ``model``: every (module, name)
        holding it (a tied parameter has several)."""
        where: dict[int, list] = {id(p): [] for p in self._params}
        for mod in model.modules():
            for name, p in mod._parameters.items():
                if p is not None and id(p) in where:
                    where[id(p)].append((mod, name))
        missing = [i for i, p in enumerate(self._params) if not where[id(p)]]
        if missing:
            raise HorovodError(
                f"Zero3Optimizer.bind: parameters {missing} of the optimizer "
                f"are not parameters of the module.")
        return [where[id(p)] for p in self._params]

    def _require_bound(self) -> None:
        if not self._bound:
            raise HorovodError(
                "Zero3Optimizer.bind(params_template) must run (eagerly, "
                "once) before any traced method — the shard layout is "
                "host-side static metadata.")

    def init_shards(self, params=None) -> list[torch.Tensor]:
        """This rank's parameter shards (rank ``d·F + f`` holds shard
        ``f`` of each parameter's zero-padded flat layout), taken from
        ``params`` (default: the optimizer's own), whose storage is then
        released: the shards are where the parameters live from now on."""
        self._require_bound()
        shards = self._make_shards(params)
        for p in self._params:
            p.data = torch.empty(0, dtype=p.dtype, device=p.device)
        self.shards = shards
        return shards

    def init(self, param_shards) -> torch.optim.Optimizer:
        """The inner optimizer over the shards (its state shard-shaped:
        1/fsdp_size of the replicated state a rank)."""
        self._build_inner(self._per_group(list(param_shards)))
        return self.optimizer

    # -- the step (inside hvd.spmd) -----------------------------------------

    def zero_grad(self, set_to_none: bool = True) -> None:
        """Drop a step armed and not stepped; with ``set_to_none=False``
        inside the step's program, once a step has been applied (the
        Trainer's step from its second call), arm the next one: its
        :meth:`gather_params` leaves the gathers in flight and hooks the
        gathered leaves (class docstring)."""
        self._drop_armed()
        super().zero_grad(set_to_none)
        self._arm_next = (not set_to_none and self._steps > 0
                          and self._in_program())

    def _drop_armed(self) -> None:
        super()._drop_armed()
        self._arm_next = False
        if self._full is not None:
            self.gather_waits += self.gathers.wait_all()
            self._full = None

    def gather_params(self, param_shards=None) -> list[torch.Tensor]:
        """Gather-on-use: every parameter all-gathered over the fsdp
        process group, in the plan's gather order, as a full tensor that
        is a leaf and requires grad as its parameter does. An armed step
        (:meth:`zero_grad`) leaves the gathers in flight: :meth:`swapped`
        waits for each at its first read."""
        self._require_bound()
        _fsdp_check_ctx("zero3", self.group)
        shards = self.shards if param_shards is None else list(param_shards)
        self._register("gather", self._gather_rows())
        if self._arm_next:
            self._arm_next = False
            return self._gather_armed(shards)
        out: list = [None] * len(shards)
        for i in self._order:
            out[i] = self._gather(i, shards[i]).detach().requires_grad_(
                self._params[i].requires_grad)
        return out

    def _gather_armed(self, shards) -> list[torch.Tensor]:
        """The armed step's gathers, issued in the plan's gather order and
        left in flight, and its reduce-scatters armed on the gathered
        leaves' post-accumulate-grad hooks. The full tensors are allocated
        on the calling stream before the gather stream forks from it, so
        the caching allocator cannot hand them out again while a gather
        still writes them; on the card each gather records an event, on
        gloo it is an asynchronous call whose work is kept."""
        g = _state.get_group(self.group)
        dev = shards[0].device
        F = self.fmesh.fsdp_size
        outs = [torch.empty(F * s.numel(), dtype=s.dtype, device=dev)
                for s in shards]
        waiters: list = [None] * len(shards)

        def issue(i, async_op=False):
            return _strategy.issue_fsdp_param_gather(
                outs[i], shards[i], self.fmesh, self.labels[i], g, self.topo,
                async_op=async_op)

        if dev.type == "cuda":
            if self._gather_stream is None:
                self._gather_stream = torch.cuda.Stream(dev)
            gs = self._gather_stream
            gs.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(gs):
                for i in self._order:
                    issue(i)
                    waiters[i] = torch.cuda.Event()
                    waiters[i].record(gs)
        else:
            for i in self._order:
                waiters[i] = issue(i, async_op=True)
        self.gathers = _Gathers(waiters, dev)
        full = [out[:math.prod(shape)].view(shape).detach().requires_grad_(
                    p.requires_grad)
                for out, shape, p in zip(outs, self._shapes, self._params)]
        metas = [torch.empty(shape, dtype=s.dtype, device="meta")
                 for shape, s in zip(self._shapes, shards)]

        def grad_of(i: int) -> torch.Tensor:
            t = full[i].grad
            return torch.zeros_like(full[i]) if t is None else t

        armed = self._arm_reduce(full, metas, self._order, grad_of)
        ref = weakref.ref(self)
        for t in full:
            if t.requires_grad:
                t.register_post_accumulate_grad_hook(functools.partial(
                    _overlap.accumulated, ref, armed=armed))
        self._full = full
        return full

    @contextlib.contextmanager
    def swapped(self, model: torch.nn.Module, full):
        """Within the block ``model``'s parameters are the gathered
        tensors ``full`` (the module's attributes read them); the released
        parameters come back after. ``full`` of an armed step: each
        holding module's ``_parameters`` is a :class:`_WaitingParameters`
        for the block, so a parameter's gather is waited for where the
        forward first reads it (``lm_head``, which the LM's root holds and
        reads last, last), once."""
        if not self._sites:
            self._sites = self._find_sites(model)
        gathers = self.gathers if full is self._full else None
        holders: dict[int, tuple] = {}
        for i, sites in enumerate(self._sites):
            for mod, name in sites:
                holders.setdefault(id(mod), (mod, {}))[1][name] = i
        saved = []
        try:
            for mod, index in holders.values():
                own = mod.__dict__["_parameters"]
                items = {**own, **{name: full[i] for name, i in index.items()}}
                saved.append((mod, own))
                mod.__dict__["_parameters"] = (
                    items if gathers is None
                    else _WaitingParameters(items, index, gathers))
            yield model
        finally:
            for mod, own in reversed(saved):
                mod.__dict__["_parameters"] = own

    @torch.no_grad()
    def apply_gradients(self, grads, param_shards=None,
                        compression_key=None) -> list[torch.Tensor]:
        """Reduce each gradient to this rank's shard (quantize →
        reduce-scatter → cross-data all-reduce → dequantize,
        ``ops/strategy.py``), run the inner update shard to shard, in
        place. Returns the shards."""
        self._require_bound()
        _fsdp_check_ctx("zero3", self.group)
        grads = list(grads)
        for t in grads:
            if isinstance(t, _sparse.IndexedSlices) or (
                    isinstance(t, torch.Tensor) and t.is_sparse):
                raise HorovodError(
                    "Sparse IndexedSlices gradients are not supported "
                    "by the sharded (zero3) optimizer; use "
                    "sharding='off'.")
        if param_shards is not None and list(param_shards) != self.shards:
            raise HorovodError(
                "Zero3Optimizer.apply_gradients updates the shards it "
                "holds (init_shards); pass those or none.")
        armed, full, gathers = self._armed, self._full, self.gathers
        self._armed, self._full = None, None
        if armed is not None:
            if any(t is not None and t is not f.grad
                   for t, f in zip(grads, full)):
                raise HorovodError(
                    "Zero3Optimizer.apply_gradients: an armed step "
                    "(zero_grad(set_to_none=False) before gather_params) "
                    "reduces the gathered tensors' own gradients as "
                    "backward produces them; pass [t.grad for t in full], "
                    "or zero_grad(set_to_none=True) for a step that "
                    "reduces the gradients given here.")
            # Every gather is waited for before the update writes the
            # shards it reads (an unused parameter's too).
            self.gather_waits += gathers.wait_all()
            armed.finish()
            _exchange.register_live_plan(armed.plan)
        else:
            grads = [torch.zeros(s, dtype=p.dtype, device=p.device)
                     if t is None else t
                     for t, s, p in zip(grads, self._shapes, self.shards)]
            self._reduce(grads, gather_order=self._order)
        self.optimizer.step()
        self._steps += 1
        return self.shards


class _Gathers:
    """An armed zero3 step's parameter gathers in flight: a waiter a
    parameter (an event of the gather stream on the card, the call's work
    on gloo, None where nothing is in flight). :meth:`wait` waits for one
    the first time it is asked, and never again; ``waits[i]`` counts the
    waits of parameter ``i`` and ``order`` lists them as they came."""

    def __init__(self, waiters: list, device) -> None:
        self.waiters = waiters
        self.device = device
        self.waits = [0] * len(waiters)
        self.order: list[int] = []

    def wait(self, i: int) -> int:
        if self.waits[i]:
            return 0
        w, self.waiters[i] = self.waiters[i], None   # a work holds buffers
        if isinstance(w, torch.cuda.Event):
            torch.cuda.current_stream(self.device).wait_event(w)
        elif w is not None:
            w.wait()
        self.waits[i] += 1
        self.order.append(i)
        return 1

    def wait_all(self) -> int:
        """Wait for every gather not yet waited for; returns the count of
        waits of the whole step."""
        for i in range(len(self.waiters)):
            self.wait(i)
        return sum(self.waits)


class _WaitingParameters(dict):
    """A module's ``_parameters`` while an armed zero3 step runs: looking
    up a gathered parameter (``module.weight``, ``named_parameters()``)
    first makes the calling stream wait for its gather (gloo: waits for
    the call), once a step. ``index`` maps the module's names of the
    gathered parameters to their positions in the optimizer."""

    def __init__(self, items: dict, index: dict, gathers: _Gathers) -> None:
        super().__init__(items)
        self._index = index
        self._gathers = gathers

    def __getitem__(self, name):
        i = self._index.get(name)
        if i is not None:
            self._gathers.wait(i)
        return super().__getitem__(name)

    def get(self, name, default=None):
        return self[name] if name in self else default

    def items(self):
        return [(k, self[k]) for k in self]

    def values(self):
        return [self[k] for k in self]

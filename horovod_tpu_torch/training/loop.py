"""Trainer — the Keras-style fit loop hosting the callbacks.

Counterpart of ``horovod_tpu/training/loop.py`` (its replicated path). Each
rank is a process running its own :class:`Trainer` on its own batches; a
step is forward, backward, gradient averaging through
:func:`~horovod_tpu_torch.parallel.optimizer.DistributedOptimizer` (fused),
the optimizer update, and then the averaging of the model's floating-point
buffers — the BatchNorm running statistics — over the group, as the
reference's ResNet step does after its update.

The step runs through :func:`~horovod_tpu_torch.parallel.spmd.spmd`, as the
reference's runs through ``hvd.spmd``: on the card its first call is eager
and its second is captured as a CUDA graph that every later call replays;
on the CPU it runs eagerly under a schedule validated once. The step
zeroes the gradients with ``set_to_none=False``, so from its second call
on the optimizer's step is armed and the gradient exchange overlaps
backward (``parallel/optimizer.py``; ``schedule="priority"`` is the plan
whose buckets go out while backward still runs); on the card the capture
records the exchange stream's fork and join.
``steps_per_call=K`` makes the program K steps (the reference's
``lax.scan``), and ``fit`` then feeds K batches a call.

:func:`sgd`, :func:`adam` and :func:`adadelta` are the reference's
builders: their optimizers hold the learning rate in a 0-d tensor on the
parameters' device, as ``optax.inject_hyperparams`` keeps it in the
optimizer state, so
:meth:`LRControlMixin.set_lr` reaches a captured step. :meth:`Trainer.
restore` (``fit(resume=...)``) resumes from the newest checkpoint every
rank can load (``training/checkpoint.py``).

``Trainer(sharded=True)`` trains with ZeRO-1 and ``sharding="zero2"|
"zero3"`` (None: ``HOROVOD_SHARDING``) with ZeRO-2/3 over the ``data ×
fsdp`` mesh (``parallel/sharded.py``). ZeRO-1 and zero2 keep the step's
shape: the wrapper's ``step()`` reduces the gradients to shards, updates
them and gathers the new parameters. zero3 changes it: the module's
parameters live as shards, and each step gathers them, runs forward and
backward on the gathered tensors, and updates shard to shard. From the
second call zero2's and zero3's steps are armed as the replicated one
is: backward's hooks issue the reduce-scatters, and zero3's gathers run
beside the forward, each waited for at its first read (ZeRO-1 never
arms). Sharded
state persists through ``checkpoint.save_sharded``/``load_sharded``:
``restore`` and ``sync_state`` refuse it, as the reference's do.

Under ``HOROVOD_ELASTIC=1`` ``fit`` survives the loss of a rank
(``core/elastic.py``): at each call boundary it admits joiners due at a
``regrow@step=S`` boundary, checks for an injected crash, and on
:class:`~horovod_tpu_torch.core.resilience.WorkerLost` shrinks the world to
the survivors, re-broadcasts the state from the elected root and retries
the same boundary at the new size. A process feeds its own batch, so a
dropped rank simply feeds nothing. A joiner (``elastic.rejoin``) enters
``fit`` at the step the members agree on, with their state.
"""

from __future__ import annotations

import json
import time
import weakref
from typing import Callable, Iterable

import torch
import torch.utils._pytree as pytree

from horovod_tpu_torch.core import elastic as _elastic
from horovod_tpu_torch.core import resilience as _res
from horovod_tpu_torch.core import state as _state
from horovod_tpu_torch.core.state import HorovodError
from horovod_tpu_torch.ops import mesh as _mesh
from horovod_tpu_torch.ops import optim as _optim
from horovod_tpu_torch.parallel import optimizer as _opt
from horovod_tpu_torch.parallel import sharded as _sharded
from horovod_tpu_torch.parallel import spmd as _spmd
from horovod_tpu_torch.utils import env as _env


class SGD(torch.optim.Optimizer):
    """``optax.sgd``'s update: ``t = g + momentum·t`` (``t`` from zeros;
    ``g + momentum·t`` again with ``nesterov``), then ``p += t·(−lr)``, as
    foreach kernels over a param group. ``lr`` may be a 0-d fp32 tensor on
    the parameters' device, read by the kernels (what :func:`sgd` builds).
    The momentum buffers are ``state[p]["momentum_buffer"]``.

    ``torch.optim.SGD`` is not used: it multiplies by a tensor learning
    rate through ``.item()``, which a CUDA graph capture refuses, and a
    float learning rate would be fixed in the graph."""

    def __init__(self, params, lr, momentum: float = 0.0,
                 nesterov: bool = False) -> None:
        super().__init__(params, dict(lr=lr, momentum=momentum,
                                      nesterov=nesterov))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            upd = [p.grad for p in params]
            m = group["momentum"]
            if m:
                bufs = []
                for p in params:
                    st = self.state[p]
                    if "momentum_buffer" not in st:
                        st["momentum_buffer"] = torch.zeros_like(p)
                    bufs.append(st["momentum_buffer"])
                torch._foreach_mul_(bufs, m)
                torch._foreach_add_(bufs, upd)
                if group["nesterov"]:
                    upd = torch._foreach_mul(bufs, m)
                    torch._foreach_add_(upd, [p.grad for p in params])
                else:
                    upd = bufs
            lr = group["lr"]
            torch._foreach_add_(params, torch._foreach_mul(upd, -lr))
        return loss

    def load_state_dict(self, state_dict) -> None:
        _optim.keep_lr_tensors(self, super().load_state_dict, state_dict)


class Adadelta(torch.optim.Optimizer):
    """``optax.adadelta``'s update, as foreach kernels over a param group::

        a = rho·a + (1 − rho)·g²
        u = g·√(d + eps) / √(a + eps)
        d = rho·d + (1 − rho)·u²
        p += u·(−lr)

    (``a`` and ``d`` from zeros: ``state[p]["square_avg"]`` and
    ``["acc_delta"]``). ``torch.optim.Adadelta`` computes the same
    function, but it reads a tensor learning rate on the host and keeps a
    step count, neither of which a CUDA graph capture allows; ``lr`` may be
    a 0-d fp32 tensor on the parameters' device, read by the kernels (what
    :func:`adadelta` builds)."""

    def __init__(self, params, lr, rho: float = 0.9,
                 eps: float = 1e-6) -> None:
        super().__init__(params, dict(lr=lr, rho=rho, eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            grads = [p.grad for p in params]
            rho, eps = group["rho"], group["eps"]
            avgs, deltas = [], []
            for p in params:
                st = self.state[p]
                if "square_avg" not in st:
                    st["square_avg"] = torch.zeros_like(p)
                    st["acc_delta"] = torch.zeros_like(p)
                avgs.append(st["square_avg"])
                deltas.append(st["acc_delta"])
            torch._foreach_mul_(avgs, rho)
            torch._foreach_addcmul_(avgs, grads, grads, value=1 - rho)
            std = torch._foreach_add(avgs, eps)
            torch._foreach_sqrt_(std)
            upd = torch._foreach_add(deltas, eps)
            torch._foreach_sqrt_(upd)
            torch._foreach_div_(upd, std)
            torch._foreach_mul_(upd, grads)
            torch._foreach_mul_(deltas, rho)
            torch._foreach_addcmul_(deltas, upd, upd, value=1 - rho)
            torch._foreach_add_(params, torch._foreach_mul(upd, -group["lr"]))
        return loss

    def load_state_dict(self, state_dict) -> None:
        _optim.keep_lr_tensors(self, super().load_state_dict, state_dict)


class OptimizerBuilder:
    """What :func:`sgd`, :func:`adam` and :func:`adadelta` return: called
    with a model's parameters (the :class:`Trainer` does), it builds the
    optimizer with the learning rate in a 0-d fp32 tensor on their
    device."""

    def __init__(self, cls, learning_rate: float, **kwargs) -> None:
        self.cls = cls
        self.learning_rate = float(learning_rate)
        self.kwargs = kwargs

    def __call__(self, params) -> torch.optim.Optimizer:
        params = list(params)
        lr = torch.full((), self.learning_rate, dtype=torch.float32,
                        device=params[0].device)
        return self.cls(params, lr=lr, **self.kwargs)


def sgd(learning_rate: float, momentum: float = 0.0,
        nesterov: bool = False) -> OptimizerBuilder:
    """SGD with a runtime-adjustable LR (what LR-schedule callbacks need):
    ``optax.inject_hyperparams(optax.sgd)``'s counterpart."""
    return OptimizerBuilder(SGD, learning_rate, momentum=momentum,
                            nesterov=nesterov)


def adam(learning_rate: float, **kwargs) -> OptimizerBuilder:
    """Adam with a runtime-adjustable LR: the port's
    :class:`~horovod_tpu_torch.ops.optim.AdamW` (kernel A1 on the card)
    with no weight decay and fp32 moments, ``optax.adam``'s update.
    ``kwargs``: ``b1``, ``b2``, ``eps``."""
    return OptimizerBuilder(_optim.AdamW, learning_rate, weight_decay=0.0,
                            moment_dtype=torch.float32, **kwargs)


def adadelta(learning_rate: float = 1.0, **kwargs) -> OptimizerBuilder:
    """Adadelta with a runtime-adjustable LR (keras_mnist uses it):
    ``optax.inject_hyperparams(optax.adadelta)``'s counterpart.
    ``kwargs``: ``rho``, ``eps``."""
    return OptimizerBuilder(Adadelta, learning_rate, **kwargs)


class LRControlMixin:
    """Runtime LR and momentum control over ``self.optimizer``'s
    ``param_groups`` and state — what the LR-schedule callbacks drive. A
    learning rate held in a tensor (:func:`sgd`, :func:`adam`) is written
    in place; a float one only until the step program that reads it is
    recorded, after which :meth:`set_lr` raises, as the reference's does
    for an optimizer without injected hyperparameters."""

    def _lr_fixed(self) -> bool:
        step = getattr(self, "_step", None)
        return step is not None and step.recorded

    def get_lr(self) -> float:
        return float(self.optimizer.param_groups[0]["lr"])

    def set_lr(self, value: float) -> None:
        groups = self.optimizer.param_groups
        if self._lr_fixed() and not all(isinstance(g["lr"], torch.Tensor)
                                        for g in groups):
            raise HorovodError(
                "LR schedule callbacks need an optimizer built with "
                "horovod_tpu_torch.training.sgd/adam/... (a learning rate "
                "held in a device tensor, as optax.inject_hyperparams "
                "holds it): the recorded step keeps this optimizer's float "
                "learning rate fixed.")
        for group in groups:
            if isinstance(group["lr"], torch.Tensor):
                group["lr"].fill_(value)
            else:
                group["lr"] = value

    def scale_momentum(self, factor: float) -> None:
        """Momentum correction: rescale the momentum buffers when the LR
        changes so update magnitudes stay smooth."""
        if abs(factor - 1.0) < 1e-12:
            return
        with torch.no_grad():
            for st in self.optimizer.state.values():
                buf = st.get("momentum_buffer")
                if buf is not None:
                    buf.mul_(factor)


def _capturable(optimizer: torch.optim.Optimizer) -> None:
    """Ready ``optimizer`` for a step captured on the card: a torch.optim
    optimizer that takes ``capturable`` gets it (its step counts then live
    on the device, and its update reads nothing on the host). One without
    it reads its step count on the host, which a graph would freeze, and is
    refused; ``torch.optim.SGD`` keeps no step count and needs none."""
    params = [p for g in optimizer.param_groups for p in g["params"]]
    if not params or params[0].device.type != "cuda":
        return
    if "capturable" in optimizer.defaults:
        optimizer.defaults["capturable"] = True
        for group in optimizer.param_groups:
            group["capturable"] = True
        for p, st in optimizer.state.items():
            step = st.get("step")
            if isinstance(step, torch.Tensor) and step.device != p.device:
                st["step"] = step.to(p.device)
    elif (type(optimizer).__module__.startswith("torch.optim.")
          and not isinstance(optimizer, torch.optim.SGD)):
        raise HorovodError(
            f"Trainer: {type(optimizer).__name__} cannot run in a step "
            f"captured as a CUDA graph (it takes no capturable flag and "
            f"reads its step count on the host). Use training.sgd/adam, "
            f"horovod_tpu_torch.ops.optim.AdamW, or a torch.optim optimizer "
            f"that takes capturable.")


class Trainer(LRControlMixin):
    """Data-parallel trainer for one rank.

    ``loss_fn(model, batch) -> loss`` (or ``(loss, aux)`` with
    ``has_aux=True``). ``optimizer``: a ``torch.optim.Optimizer`` (wrapped
    here in :func:`DistributedOptimizer`), one already wrapped, or what
    :func:`sgd`/:func:`adam` return (built here over the model's
    parameters). ``steps_per_call``: optimizer steps in one program (one
    call of :meth:`train_step`, which then takes K batches stacked along a
    new leading dim and returns the mean loss of its K steps).
    ``schedule``: the gradient exchange's plan (``"enum"``/``"priority"``;
    None defers to ``HOROVOD_EXCHANGE_SCHEDULE``), passed to the
    :func:`DistributedOptimizer` made here. ``sharded=True`` (ZeRO-1) and
    ``sharding`` (``"off"``/``"zero2"``/``"zero3"``; None defers to
    ``HOROVOD_SHARDING``) pick the sharded modes (module docstring); a
    builder is then built over the shards.

    On the card the step is captured as a CUDA graph (:func:`spmd`), so
    ``loss_fn`` must not synchronise with the host, and the optimizer must
    be capturable: torch.optim's get ``capturable=True`` here, and those
    without the flag (``SGD`` apart) are refused. :attr:`step_fn` is the
    step uncaptured. Loading the inner optimizer's state (through the
    wrapper or not) recaptures the step, since torch replaces the state
    tensors the graph updates.
    """

    def __init__(self, model: torch.nn.Module, loss_fn: Callable, optimizer,
                 group: int = 0, has_aux: bool = False,
                 fusion_threshold: int | None = None,
                 steps_per_call: int = 1, schedule: str | None = None,
                 sharded: bool = False, sharding: str | None = None) -> None:
        if steps_per_call < 1:
            raise HorovodError("steps_per_call must be >= 1.")
        self.model = model
        self.loss_fn = loss_fn
        self.sharding = _mesh.resolve_sharding(sharding)
        if self.sharding != "off" and _env.elastic_enabled():
            raise HorovodError(
                f"HOROVOD_ELASTIC=1 is incompatible with Trainer("
                f"sharding={self.sharding!r}): the elastic shrink/regrow "
                f"path re-replicates training state and would desync "
                f"sharded (ZeRO-2/3) layouts. Use the replicated path "
                f"(sharding='off') with elastic training.")
        if isinstance(optimizer, OptimizerBuilder) and not (
                sharded or self.sharding != "off"):
            optimizer = optimizer(model.parameters())
        if not isinstance(optimizer, (_opt._DistributedOptimizer,
                                      _sharded._Sharded)):
            optimizer = _opt.DistributedOptimizer(
                optimizer, group=group, fusion_threshold=fusion_threshold,
                schedule=schedule, sharded=sharded, sharding=self.sharding,
                params=list(model.parameters()))
        if self.sharding == "zero3":
            optimizer.bind(model)
            optimizer.init(optimizer.init_shards())
        self.optimizer = optimizer
        self.group = group
        self.has_aux = has_aux
        self.epoch = 0
        self.last_aux = None
        self._sync_buffers = _opt.FusedAllreduce(
            "Trainer.buffers", group, average=True,
            fusion_threshold=fusion_threshold)
        self.steps_per_call = steps_per_call
        self._step = self._build_step()
        _capturable(optimizer.optimizer)
        me = weakref.ref(self)

        def recapture(_optimizer):
            trainer = me()
            if trainer is not None:
                trainer._step.reset()

        optimizer.optimizer.register_load_state_dict_post_hook(recapture)

    def sync_state(self, root_rank: int = 0, group: int | None = None) -> None:
        """Broadcast parameters, buffers and optimizer state from
        ``root_rank`` — what BroadcastGlobalVariablesCallback runs. The
        step is recorded anew at its next call. Sharded (zero2/zero3)
        state is rank-divergent and refused."""
        if self.sharding != "off":
            raise HorovodError(
                f"Trainer.sync_state does not apply to sharding="
                f"{self.sharding!r}: optimizer state (and for zero3, "
                f"parameters) is intentionally rank-divergent — rank "
                f"d*F+f holds fsdp shard f — so broadcasting one rank's "
                f"rows would overwrite every other shard. Sharded state "
                f"persists via checkpoint.save_sharded/load_sharded.")
        g = self.group if group is None else group
        _opt.broadcast_global_variables(self.model, self.optimizer,
                                        root_rank, g)
        self._step.reset()

    def init_state(self, *reference_args, **reference_kwargs):
        """The reference's ``init_state(params)`` returns rank-stacked
        parameters and optimizer state from one set of parameters. Here a
        process is a rank: ``Trainer(model, ...)`` holds fresh parameters
        and optimizer state already, and :meth:`sync_state` replicates
        them across the group. The call raises a ``TypeError`` naming
        that form."""
        raise TypeError(
            "Trainer.init_state(params) is the reference's form: here a "
            "process is a rank, so there are no rank-stacked trees to "
            "build. Trainer(model, loss_fn, optimizer) already holds fresh "
            "parameters and optimizer state; call trainer.sync_state() to "
            "replicate them across the group.")

    def train_state(self) -> dict:
        """What a checkpoint holds: the model's and the optimizer's state
        dicts and the epoch; under zero3 also this rank's parameter shards
        (``"shards"``; the module's own parameters are released)."""
        state = {"model": self.model.state_dict(),
                 "optimizer": self.optimizer.state_dict(),
                 "epoch": self.epoch}
        if self.sharding == "zero3":
            state["shards"] = list(self.optimizer.shards)
        return state

    def load_state(self, state: dict, *reference_args,
                   **reference_kwargs) -> None:
        """Load what :meth:`train_state` returned (e.g. from
        ``checkpoint.load_sharded``) into this trainer, in place. The
        reference's ``load_state(params_stacked, opt_state_stacked,
        epoch=0)`` takes rank-stacked trees, which the port has none of (a
        process is a rank): that call raises a ``TypeError``."""
        if reference_args or reference_kwargs or not isinstance(state,
                                                                dict):
            raise TypeError(
                "Trainer.load_state takes one argument, the dict that "
                "train_state() returns ({'model', 'optimizer', 'epoch'}), "
                "not the reference's (params_stacked, opt_state_stacked, "
                "epoch): a process is a rank here, so there are no "
                "rank-stacked trees. Load a checkpoint's state dicts "
                "through train_state()'s form.")
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        if self.sharding == "zero3":
            with torch.no_grad():
                for shard, t in zip(self.optimizer.shards, state["shards"]):
                    shard.copy_(t)
        self.epoch = int(state["epoch"])

    def restore(self, directory: str) -> int:
        """Crash-safe resume (what ``fit(resume=...)`` calls): agree with
        every rank on the newest epoch ALL can load
        (:func:`checkpoint.agree_on_resume_epoch` — torn/corrupt epochs are
        already skipped by the manifest scan), restore it, bump the group's
        coordination generation so the restarted run's negotiation keys can
        never collide with stale keys of the run before it (and the step is
        recorded anew), and re-broadcast rank 0's state so every replica
        resumes bit-identical.

        Returns the epoch training will resume at (``self.epoch``;
        unchanged when the directory holds no loadable checkpoint)."""
        from horovod_tpu_torch.training import checkpoint as _ckpt

        if self.sharding != "off":
            raise HorovodError(
                f"Trainer.restore/fit(resume=...) supports only the "
                f"replicated path; sharding={self.sharding!r} state is "
                f"rank-divergent (each rank holds its own fsdp shard) "
                f"and must round-trip via "
                f"checkpoint.save_sharded/load_sharded.")
        if _state.rank(self.group) < 0:
            # The agreement hands a memberless process only its LOCAL scan,
            # so it could branch away from the members' restore sequence
            # (generation bump + re-broadcast). Refuse loudly instead.
            raise HorovodError(
                f"Trainer.restore/fit(resume=...) called on a process "
                f"hosting no members of group {self.group}: restore's "
                f"generation bump and state re-broadcast are group "
                f"collectives this process cannot follow consistently. "
                f"Run restore only where the trainer's group has members.")
        epoch = _ckpt.agree_on_resume_epoch(directory, group=self.group)
        if epoch < 0:
            return self.epoch
        # agree_on_resume_epoch CRC-verified the agreed epoch on THIS rank
        # before returning it: verify=False skips a second full read.
        restored = _ckpt.load(directory, self.train_state(), epoch=epoch,
                              verify=False)
        self.model.load_state_dict(restored["model"])
        self.optimizer.load_state_dict(restored["optimizer"])
        self.epoch = epoch + 1
        _state.bump_generation(self.group)
        self.sync_state(group=self.group)
        return self.epoch

    # -- the step ------------------------------------------------------------

    def _one_step(self, batch):
        """One DP step on this rank's batch: ``(loss, aux)``, the loss a
        detached 0-d tensor. The gradients stay allocated between steps
        (``set_to_none=False``), so a captured step reads and writes the
        same tensors at every replay."""
        self.model.train()
        if self.sharding == "zero3":
            loss, aux = self._zero3_grads(batch)
        else:
            self.optimizer.zero_grad(set_to_none=False)
            out = self.loss_fn(self.model, batch)
            loss, aux = out if self.has_aux else (out, {})
            loss.backward()
            self.optimizer.step()
        self._sync_buffers([b for b in self.model.buffers()
                            if b.dtype.is_floating_point])
        return loss.detach(), aux

    def _zero3_grads(self, batch):
        """The zero3 step shape: gather the parameters, forward and
        backward on the gathered tensors, update shard to shard. From the
        second call the step is armed (``parallel/sharded.py``): the
        gathers run beside the forward, each waited for at its first
        read, and backward's hooks issue the reduce-scatters."""
        opt = self.optimizer
        opt.zero_grad(set_to_none=False)
        full = opt.gather_params()
        with opt.swapped(self.model, full):
            out = self.loss_fn(self.model, batch)
            loss, aux = out if self.has_aux else (out, {})
            loss.backward()
        opt.apply_gradients([t.grad for t in full])
        return loss, aux

    def _build_step(self) -> _spmd.Spmd:
        # The program reaches the trainer through a weak reference: the
        # trainer owns the program (and its CUDA graph's memory pool), which
        # then goes with the trainer instead of waiting for a cycle
        # collection.
        me = weakref.ref(self)
        k = self.steps_per_call

        def one_step(batch):
            return me()._one_step(batch)

        def multi_step(batches):
            # `batches` leaves carry a leading loop axis of length K.
            losses = []
            aux = {}
            for i in range(k):
                loss, aux = me()._one_step(
                    pytree.tree_map(lambda t: t[i], batches))
                losses.append(loss)
            # Mean over the K steps: epoch metrics must not become a
            # 1-in-K sample of the loss curve when steps_per_call changes.
            return torch.stack(losses).mean(), aux

        return _spmd.spmd(one_step if k == 1 else multi_step,
                          group=self.group)

    @property
    def step_fn(self) -> Callable:
        """The function the step program runs (K steps when
        ``steps_per_call`` is K), uncaptured: calling it is the eager
        step."""
        return self._step.fn

    def train_step(self, batch):
        """One call of the step program on this rank's batch (K batches
        stacked along a new leading dim when ``steps_per_call`` is K);
        returns ``(loss, aux)`` with the loss a 0-d tensor on the model's
        device (the mean over the K steps)."""
        loss, aux = self._step(batch)
        self.last_aux = aux
        return loss, aux

    def fit(self, data: Iterable, epochs: int, steps_per_epoch: int,
            callbacks: list | None = None, verbose: bool = True,
            initial_epoch: int | None = None,
            resume: str | None = None) -> dict:
        """Keras-shaped fit from ``initial_epoch`` (default ``self.epoch``)
        to ``epochs``: ``data`` yields this rank's batches (a finite
        re-iterable is cycled across epochs).

        ``resume=<checkpoint dir>`` restores the newest complete checkpoint
        every rank can load before training (see :meth:`restore`) — the
        crash-restart entry point: a killed job relaunches with the same
        ``fit`` call plus ``resume=`` and continues from the last complete
        epoch. A directory with no loadable checkpoint starts fresh.

        With ``steps_per_call`` K, each call of the step takes K batches
        (``steps_per_epoch`` must be a multiple of K) and the batch
        callbacks fire once a call, with ``batch_idx = call_idx·K``.

        Returns ``{metric: [per-epoch values]}``; the host reads the loss
        once per epoch, not per step."""
        if resume is not None:
            if initial_epoch is not None:
                # initial_epoch would silently override the restored resume
                # point: the LR schedule would replay from scratch and the
                # checkpoint callback would overwrite the history restore
                # exists to protect.
                raise HorovodError(
                    "fit(resume=...) and initial_epoch are mutually "
                    "exclusive: resume restores the agreed epoch and "
                    "continues from it. Drop initial_epoch, or load "
                    "explicitly and pass initial_epoch without resume.")
            self.restore(resume)
        callbacks = list(callbacks or [])
        for cb in callbacks:
            cb.set_trainer(self)
        history: dict[str, list] = {"loss": []}
        for cb in callbacks:
            cb.on_train_begin()
        data_iter = iter(data)

        def next_batch():
            nonlocal data_iter
            try:
                return next(data_iter)
            except StopIteration:
                data_iter = iter(data)
                try:
                    return next(data_iter)
                except StopIteration:
                    raise HorovodError(
                        "Training data iterator is exhausted and not "
                        "re-iterable; pass an infinite generator or a "
                        "re-iterable collection of batches.") from None

        spc = self.steps_per_call
        if spc > 1 and steps_per_epoch % spc != 0:
            raise HorovodError(
                f"steps_per_epoch ({steps_per_epoch}) must be divisible by "
                f"steps_per_call ({spc}).")

        start = self.epoch if initial_epoch is None else initial_epoch
        first_call = 0
        self._elastic = (_elastic.ElasticController(self.group)
                         if _env.elastic_enabled() else None)
        self._elastic_snapshot_due = None
        admitted = (_elastic.take_admission()
                    if self._elastic is not None else None)
        if admitted is not None:
            step = self._join_world(admitted)
            start = step // steps_per_epoch
            first_call = (step % steps_per_epoch) // spc
        for epoch in range(start, epochs):
            self.epoch = epoch
            for cb in callbacks:
                cb.on_epoch_begin(epoch)
            losses = []
            call_idx = first_call if epoch == start else 0
            while call_idx < steps_per_epoch // spc:
                # Callbacks see the true step index: schedules compute
                # fractional epochs as step/steps_per_epoch.
                batch_idx = call_idx * spc
                global_step = epoch * steps_per_epoch + batch_idx
                if self._elastic is not None:
                    self._maybe_regrow(global_step, spc)
                g = _state.get_group(self.group)
                me = g.group_rank_of(_state.global_rank())
                try:
                    # The crash-injection rank space is group-local.
                    _res.maybe_crash(
                        global_step, [me], span=spc,
                        peers=[r for r in range(g.size) if r != me])
                    for cb in callbacks:
                        cb.on_batch_begin(batch_idx)
                    if spc > 1:
                        batch = pytree.tree_map(
                            lambda *leaves: torch.stack(leaves),
                            *[next_batch() for _ in range(spc)])
                    else:
                        batch = next_batch()
                    loss, _ = self.train_step(batch)
                except _res.WorkerLost as err:
                    if self._elastic is None:
                        raise
                    self._elastic_shrink(err)
                    continue  # retry this call boundary at the new size
                if self._elastic_snapshot_due is not None:
                    # The re-planned exchange exists once a step has run at
                    # the new world size: stamp it now.
                    self._elastic.snapshot_live_plan(
                        self._elastic_snapshot_due,
                        dropped=self._elastic.dropped)
                    self._elastic_snapshot_due = None
                losses.append(loss)
                for cb in callbacks:
                    cb.on_batch_end(batch_idx, {"loss": loss})
                call_idx += 1
            logs = {"loss": float(torch.stack(losses).float().mean())}
            for cb in callbacks:
                cb.on_epoch_end(epoch, logs)
            for k, v in logs.items():
                history.setdefault(k, []).append(v)
            if verbose and _state.rank(self.group) == 0:
                print(f"Epoch {epoch + 1}/{epochs} - loss: {logs['loss']:.4f}"
                      f" - lr: {self.get_lr():.6g}")
            self.epoch = epoch + 1
        for cb in callbacks:
            cb.on_train_end()
        return history

    # -- elastic transitions (core/elastic.py) -------------------------------

    def _elastic_shrink(self, err: _res.WorkerLost) -> None:
        """Execute the shrink contract: plan (or refuse, chaining the
        loss), snapshot the live exchange plan, reconfigure group 0 to the
        survivors, and re-broadcast the state from the elected root —
        group-local rank 0 of the new group — which records the step anew
        so the exchange re-plans at the new world size."""
        ctl = self._elastic
        t0 = time.perf_counter()
        dead = ctl.resolve_dead(err)
        try:
            plan = ctl.plan_shrink(dead)
        except HorovodError as refusal:
            raise refusal from err
        ctl.snapshot_live_plan("pre_shrink")
        ctl.commit_shrink(plan)
        self.sync_state(root_rank=0, group=self.group)
        self._elastic_snapshot_due = "post_shrink"
        ctl.finish_shrink(t0)
        print(f"horovod_tpu_torch elastic: shrunk to world "
              f"{list(plan.survivors)} (generation {plan.generation}); "
              f"training continues.", flush=True)

    def _maybe_regrow(self, step: int, span: int) -> None:
        """Admit announced joiners at this step boundary, if any: the
        mirror of the shrink — reconfigure over the union, hand the joiner
        the optimizer state's layout, re-broadcast the state from a current
        member (the joiner has none) and agree on the step."""
        ctl = self._elastic
        src = min(ctl.members())  # a current member, never a joiner
        plan = ctl.poll_regrow(step, span)
        if plan is None:
            return
        t0 = time.perf_counter()
        ctl.commit_regrow(plan)
        root = plan.members.index(src)
        store = _elastic.kv_store()
        if _state.global_rank() == src:
            _res.kv_set(store, _estate_key(plan.generation),
                        json.dumps(_optimizer_layout(self.optimizer)))
        self.sync_state(root_rank=root, group=self.group)
        _elastic.agree_step(store, plan.generation, _state.global_rank(),
                            plan.members, step)
        self._elastic_snapshot_due = "post_regrow"
        ctl.finish_regrow(t0)
        print(f"horovod_tpu_torch elastic: regrew to world "
              f"{list(plan.members)} (admitted {list(plan.joined)}, "
              f"generation {plan.generation}); training continues.",
              flush=True)

    def _join_world(self, plan) -> int:
        """A joiner's side of :meth:`_maybe_regrow`: adopt the optimizer
        state's layout, receive the state, and return the step the members
        resume at."""
        src = min(set(plan.members) - set(plan.joined))
        store = _elastic.kv_store()
        layout = _res.wait_kv(
            store, _estate_key(plan.generation),
            _env.negotiation_timeout_ms(), pids=(src,),
            context="waiting for the optimizer state's layout")
        _adopt_layout(self.optimizer, json.loads(layout))
        self.sync_state(root_rank=plan.members.index(src), group=self.group)
        return _elastic.agree_step(store, plan.generation,
                                   _state.global_rank(), plan.members,
                                   _elastic.JOINER_STEP)


def _estate_key(generation: int) -> str:
    return f"hvd/estate/g{generation}"


def _optimizer_layout(optimizer) -> list:
    """``[position, key, dtype, shape, on_cpu]`` of each state tensor of
    ``optimizer`` and ``[position, key, None, value, None]`` of each other
    state entry: what a joiner allocates before the state broadcast, which
    needs the same tensors on every rank."""
    params = [p for pg in optimizer.param_groups for p in pg["params"]]
    out = []
    for i, p in enumerate(params):
        for k, v in sorted(optimizer.state.get(p, {}).items()):
            if isinstance(v, torch.Tensor):
                out.append([i, k, str(v.dtype).removeprefix("torch."),
                            list(v.shape), v.device.type == "cpu"])
            else:
                out.append([i, k, None, v, None])
    return out


def _adopt_layout(optimizer, layout: list) -> None:
    params = [p for pg in optimizer.param_groups for p in pg["params"]]
    for i, k, dtype, shape, on_cpu in layout:
        p = params[i]
        optimizer.state.setdefault(p, {})[k] = (
            shape if dtype is None else torch.zeros(
                shape, dtype=getattr(torch, dtype),
                device="cpu" if on_cpu else p.device))

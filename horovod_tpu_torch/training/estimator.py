"""Estimator — the ``tf.estimator``-style ``model_fn`` workload.

Counterpart of ``horovod_tpu/training/estimator.py``. A ``model_fn`` returns
an :class:`EstimatorSpec` per mode: TRAIN a loss, EVAL a loss and metrics,
PREDICT a predictions dict. The Estimator owns the lifecycle: it restores
the newest checkpoint every rank can load from ``model_dir`` at start,
broadcasts rank 0's weights implicitly (the reference's
``BroadcastGlobalVariablesHook``, which forgetting is only ever a bug), and
checkpoints on rank 0 only.

In torch's idiom: ``init_fn(seed, features) -> nn.Module`` builds the
model from one batch of this rank's features, and ``model_fn(model,
features, labels, mode, seed) -> EstimatorSpec`` runs it, where ``seed`` is
a 0-d int64 tensor on the device, decorrelated per step and per rank (the
reference's per-rank ``rng``). Each mode is one
:func:`~horovod_tpu_torch.parallel.spmd.spmd` program: TRAIN is forward,
backward, the fused gradient allreduce of
:func:`~horovod_tpu_torch.parallel.optimizer.DistributedOptimizer` and the
update; EVAL is the forward and its metrics averaged over the group; PREDICT
the forward alone. On the card each is captured as a CUDA graph at its
second call, so ``model_fn`` must not synchronise with the host.

A process is a rank: ``input_fn()`` yields this rank's ``(features,
labels)`` batches (numpy arrays or tensors; they are moved to the rank's
device), and :meth:`Estimator.predict` yields this rank's examples.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterable, Mapping

import numpy as np
import torch
import torch.utils._pytree as pytree

from horovod_tpu_torch.core import state as _state
from horovod_tpu_torch.core.state import HorovodError
from horovod_tpu_torch.models.transformer import _splitmix64
from horovod_tpu_torch.ops import collectives as _coll
from horovod_tpu_torch.parallel import optimizer as _opt
from horovod_tpu_torch.parallel import spmd as _spmd
from horovod_tpu_torch.training import checkpoint as _ckpt
from horovod_tpu_torch.training.loop import LRControlMixin, _capturable


class ModeKeys:
    """Mode names for ``model_fn`` (tf.estimator.ModeKeys analog)."""

    TRAIN = "train"
    EVAL = "eval"
    PREDICT = "predict"


@dataclasses.dataclass(frozen=True)
class EstimatorSpec:
    """What ``model_fn`` returns (tf.estimator.EstimatorSpec analog).

    TRAIN: ``loss`` required. EVAL: ``loss`` required, ``metrics`` optional
    — a dict of per-batch 0-d metric tensors, averaged across ranks and
    batches by :meth:`Estimator.evaluate`. PREDICT: ``predictions``
    required — a dict of tensors with a leading per-example axis.
    """

    loss: Any = None
    predictions: Any = None
    metrics: Mapping[str, Any] | None = None


class Estimator(LRControlMixin):
    """``model_fn``-driven train/evaluate/predict with owned checkpointing.

    ``optimizer``: what :func:`~horovod_tpu_torch.training.sgd`/``adam``/
    ``adadelta`` return, or any callable building a ``torch.optim``
    optimizer from the model's parameters; it is wrapped in
    :func:`DistributedOptimizer` over ``group``. ``model_dir``: the
    checkpoint directory (only rank 0 writes; a checkpoint's epoch is the
    global step). ``save_checkpoints_steps``: also save every that many
    steps."""

    def __init__(self, model_fn: Callable, init_fn: Callable, optimizer,
                 model_dir: str | None = None, group: int = 0,
                 seed: int = 0,
                 save_checkpoints_steps: int | None = None) -> None:
        self.model_fn = model_fn
        self.init_fn = init_fn
        self.build_optimizer = optimizer
        self.model_dir = model_dir
        self.group = group
        self.seed = seed
        self.save_checkpoints_steps = save_checkpoints_steps
        self.model: torch.nn.Module | None = None
        self.optimizer = None
        self.global_step = 0
        self._train_calls = 0
        self._programs: dict[str, _spmd.Spmd] = {}

    # -- state ----------------------------------------------------------------

    def _device_batch(self, batch):
        dev = _state.device()
        return pytree.tree_map(
            lambda a: torch.as_tensor(a).to(dev)
            if isinstance(a, (np.ndarray, torch.Tensor)) else a, batch)

    def _ensure_state(self, features) -> None:
        if self.model is not None:
            return
        self.model = self.init_fn(self.seed, features).to(_state.device())
        self.optimizer = _opt.DistributedOptimizer(
            self.build_optimizer(self.model.parameters()), group=self.group)
        _capturable(self.optimizer.optimizer)
        # tf.estimator lifecycle: resume from the newest checkpoint every
        # rank can load, if model_dir has one.
        if self.model_dir:
            step = _ckpt.agree_on_resume_epoch(self.model_dir,
                                               group=self.group)
            if step >= 0:
                # The agreement CRC-verified the agreed step on this rank.
                state = _ckpt.load(self.model_dir, self._state_dict(),
                                   epoch=step, verify=False)
                self.model.load_state_dict(state["model"])
                self.optimizer.load_state_dict(state["optimizer"])
                self.global_step = step
        # The implicit BroadcastGlobalVariablesHook: rank 0's weights win,
        # whether fresh or restored.
        self.sync_state()

    def _state_dict(self) -> dict:
        """What a checkpoint holds; its epoch is the global step."""
        return {"model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict(),
                "epoch": self.global_step}

    def sync_state(self, root_rank: int = 0, group: int | None = None
                   ) -> None:
        """Broadcast the model and the optimizer state from ``root_rank``
        (what BroadcastGlobalVariablesHook runs); the programs record
        anew."""
        g = self.group if group is None else group
        _opt.broadcast_global_variables(self.model, self.optimizer,
                                        root_rank, g)
        for prog in self._programs.values():
            prog.reset()

    def _save(self) -> None:
        if self.model_dir and _state.rank(self.group) == 0:
            _ckpt.save(self.model_dir, self._state_dict(),
                       epoch=self.global_step)

    # -- per-mode programs ----------------------------------------------------

    def _rank_seed(self, step: torch.Tensor) -> torch.Tensor:
        """The step's seed (from the Estimator's seed and the step count,
        a device tensor), decorrelated per rank."""
        base = _splitmix64(torch.full((), self.seed, dtype=torch.long,
                                      device=step.device))
        return _splitmix64(_splitmix64(base ^ step) ^ _state.rank(
            self.group))

    def _spec(self, mode: str, what: str, features, labels, step):
        spec = self.model_fn(self.model, features, labels, mode,
                             self._rank_seed(step))
        if getattr(spec, what) is None:
            raise HorovodError(
                f"model_fn must set EstimatorSpec.{what} in "
                f"{mode.upper()} mode.")
        return spec

    def _program(self, mode: str) -> _spmd.Spmd:
        prog = self._programs.get(mode)
        if prog is not None:
            return prog
        if mode == ModeKeys.TRAIN:
            def train_step(step, batch):
                features, labels = batch
                self.model.train()
                self.optimizer.zero_grad(set_to_none=False)
                loss = self._spec(mode, "loss", features, labels, step).loss
                loss.backward()
                self.optimizer.step()
                return loss.detach()

            prog = _spmd.spmd(train_step, group=self.group)
            self._step = prog  # the LR callbacks' view (LRControlMixin)
        elif mode == ModeKeys.EVAL:
            @torch.no_grad()
            def evaluate(step, batch):
                features, labels = batch
                self.model.eval()
                spec = self._spec(mode, "loss", features, labels, step)
                metrics = dict(spec.metrics or {})
                metrics["loss"] = spec.loss
                # Averaged over the group inside the program (the
                # MetricAverageCallback semantics), one named allreduce a
                # metric in sorted order.
                return {k: _coll.allreduce(
                    torch.as_tensor(metrics[k]).float(), group=self.group,
                    name=f"EvalMetric_{k}") for k in sorted(metrics)}

            prog = _spmd.spmd(evaluate, group=self.group)
        elif mode == ModeKeys.PREDICT:
            @torch.no_grad()
            def predict(step, features):
                self.model.eval()
                return self._spec(mode, "predictions", features, None,
                                  step).predictions

            prog = _spmd.spmd(predict, group=self.group)
        else:
            raise HorovodError(f"Unknown mode {mode!r}.")
        self._programs[mode] = prog
        return prog

    def _step_tensor(self) -> torch.Tensor:
        return torch.full((), self.global_step, dtype=torch.long,
                          device=_state.device())

    # -- public surface -------------------------------------------------------

    def train(self, input_fn: Callable[[], Iterable], steps: int | None = None,
              callbacks: list | None = None) -> "Estimator":
        """Run ``steps`` training steps (or until ``input_fn``'s iterable is
        exhausted when ``steps`` is None), then checkpoint. ``input_fn()``
        yields this rank's ``(features, labels)`` batches. Returns self."""
        data = iter(input_fn())
        callbacks = list(callbacks or [])
        # State must exist before callbacks fire (LR callbacks read the
        # optimizer at train begin): initialize/restore from the first
        # batch.
        batch = next(data, None)
        if batch is not None:
            batch = self._device_batch(batch)
            self._ensure_state(batch[0])
        # Epoch-driven callbacks see one train() call as one epoch:
        # tf.estimator has no epochs, only steps.
        epoch = self._train_calls
        self._train_calls += 1
        for cb in callbacks:
            cb.set_trainer(self)
            cb.on_train_begin()
            cb.on_epoch_begin(epoch)
        done = 0
        loss = None
        while steps is None or done < steps:
            if batch is None:
                if steps is not None:
                    raise HorovodError(
                        f"input_fn exhausted after {done} of {steps} steps; "
                        f"yield enough batches or pass steps=None.")
                break
            for cb in callbacks:
                cb.on_batch_begin(self.global_step)
            loss = self._program(ModeKeys.TRAIN)(self._step_tensor(), batch)
            self.global_step += 1
            done += 1
            for cb in callbacks:
                cb.on_batch_end(self.global_step, {"loss": loss})
            if (self.save_checkpoints_steps
                    and self.global_step % self.save_checkpoints_steps == 0):
                self._save()
            batch = next(data, None)
            if batch is not None:
                batch = self._device_batch(batch)
        self._save()
        logs = {} if loss is None else {"loss": float(loss)}
        for cb in callbacks:
            cb.on_epoch_end(epoch, logs)
            cb.on_train_end(logs)
        return self

    def evaluate(self, input_fn: Callable[[], Iterable],
                 steps: int | None = None) -> dict:
        """Average loss and metrics over the eval stream (and over ranks
        inside the program); returns ``{metric: float, ..., "global_step":
        n}`` like the reference's ``eval_results``."""
        totals: dict[str, float] = {}
        count = 0
        for batch in input_fn():
            if steps is not None and count >= steps:
                break
            batch = self._device_batch(batch)
            self._ensure_state(batch[0])
            out = self._program(ModeKeys.EVAL)(self._step_tensor(), batch)
            for k, v in out.items():
                totals[k] = totals.get(k, 0.0) + float(v)
            count += 1
        if count == 0:
            raise HorovodError("evaluate: input_fn yielded no batches.")
        result = {k: v / count for k, v in totals.items()}
        result["global_step"] = self.global_step
        return result

    def predict(self, input_fn: Callable[[], Iterable]):
        """Yield this rank's per-example prediction dicts (numpy), batch
        by batch. ``input_fn()`` yields feature batches (or ``(features,
        labels)`` tuples — labels are ignored, as in the reference)."""
        for batch in input_fn():
            features = batch[0] if isinstance(batch, tuple) else batch
            features = self._device_batch(features)
            self._ensure_state(features)
            preds = self._program(ModeKeys.PREDICT)(self._step_tensor(),
                                                    features)
            for row in _spmd.local_values(preds, self.group):
                n = pytree.tree_leaves(row)[0].shape[0]
                for j in range(n):
                    yield pytree.tree_map(lambda t: t[j], row)

"""Trainer — the Keras-style fit loop hosting the callbacks.

Counterpart of ``horovod_tpu/training/loop.py`` (its replicated path). Each
rank is a process running its own :class:`Trainer` on its own batches; a
step is forward, backward, gradient averaging through
:func:`~horovod_tpu_torch.parallel.optimizer.DistributedOptimizer` (fused,
negotiated once per gradient signature), the optimizer update, and then the
averaging of the model's floating-point buffers — the BatchNorm running
statistics — over the group, as the reference's ResNet step does after its
update. :meth:`Trainer.restore` (``fit(resume=...)``) resumes from the
newest checkpoint every rank can load (``training/checkpoint.py``).
Elastic training, ZeRO and ``steps_per_call`` are not ported yet.
"""

from __future__ import annotations

from typing import Callable, Iterable

import torch

from horovod_tpu_torch.core import state as _state
from horovod_tpu_torch.core.state import HorovodError
from horovod_tpu_torch.parallel import optimizer as _opt


class LRControlMixin:
    """Runtime LR and momentum control over ``self.optimizer``'s
    ``param_groups`` and state — what the LR-schedule callbacks drive."""

    def get_lr(self) -> float:
        return float(self.optimizer.param_groups[0]["lr"])

    def set_lr(self, value: float) -> None:
        for group in self.optimizer.param_groups:
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


class Trainer(LRControlMixin):
    """Data-parallel trainer for one rank.

    ``loss_fn(model, batch) -> loss`` (or ``(loss, aux)`` with
    ``has_aux=True``). ``optimizer``: a ``torch.optim.Optimizer`` (wrapped
    here in :func:`DistributedOptimizer`) or one already wrapped.
    """

    def __init__(self, model: torch.nn.Module, loss_fn: Callable, optimizer,
                 group: int = 0, has_aux: bool = False,
                 fusion_threshold: int | None = None) -> None:
        self.model = model
        self.loss_fn = loss_fn
        if not isinstance(optimizer, _opt._DistributedOptimizer):
            optimizer = _opt.DistributedOptimizer(
                optimizer, group=group, fusion_threshold=fusion_threshold)
        self.optimizer = optimizer
        self.group = group
        self.has_aux = has_aux
        self.epoch = 0
        self._sync_buffers = _opt.FusedAllreduce(
            "Trainer.buffers", group, average=True,
            fusion_threshold=fusion_threshold)

    def sync_state(self, root_rank: int = 0, group: int | None = None) -> None:
        """Broadcast parameters, buffers and optimizer state from
        ``root_rank`` — what BroadcastGlobalVariablesCallback runs."""
        g = self.group if group is None else group
        _opt.broadcast_global_variables(self.model, self.optimizer.optimizer,
                                        root_rank, g)

    def train_state(self) -> dict:
        """What a checkpoint holds: the model's and the optimizer's state
        dicts and the epoch."""
        return {"model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict(),
                "epoch": self.epoch}

    def restore(self, directory: str) -> int:
        """Crash-safe resume (what ``fit(resume=...)`` calls): agree with
        every rank on the newest epoch ALL can load
        (:func:`checkpoint.agree_on_resume_epoch` — torn/corrupt epochs are
        already skipped by the manifest scan), restore it, bump the group's
        coordination generation so the restarted run's negotiation keys can
        never collide with stale keys of the run before it, and re-broadcast
        rank 0's state so every replica resumes bit-identical.

        Returns the epoch training will resume at (``self.epoch``;
        unchanged when the directory holds no loadable checkpoint)."""
        from horovod_tpu_torch.training import checkpoint as _ckpt

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

    def train_step(self, batch):
        """One DP step on this rank's batch; returns ``(loss, aux)`` with the
        loss a detached 0-d tensor on the model's device."""
        self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        out = self.loss_fn(self.model, batch)
        loss, aux = out if self.has_aux else (out, {})
        loss.backward()
        self.optimizer.step()
        self._sync_buffers([b for b in self.model.buffers()
                            if b.dtype.is_floating_point])
        return loss.detach(), aux

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

        start = self.epoch if initial_epoch is None else initial_epoch
        for epoch in range(start, epochs):
            self.epoch = epoch
            for cb in callbacks:
                cb.on_epoch_begin(epoch)
            losses = []
            for batch_idx in range(steps_per_epoch):
                for cb in callbacks:
                    cb.on_batch_begin(batch_idx)
                loss, _ = self.train_step(next_batch())
                losses.append(loss)
                for cb in callbacks:
                    cb.on_batch_end(batch_idx, {"loss": loss})
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

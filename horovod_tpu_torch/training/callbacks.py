"""Training callbacks — the reference's Keras callback vocabulary.

Counterpart of ``horovod_tpu/training/callbacks.py``:
``BroadcastGlobalVariablesCallback`` (weight and optimizer-state sync at
train begin), ``MetricAverageCallback`` (epoch metrics averaged over the
group), ``LearningRateScheduleCallback`` with momentum correction and
``LearningRateWarmupCallback`` (the Goyal et al. ramp ``lr/size → lr``). LR
and momentum act on the optimizer's ``param_groups`` and momentum buffers.
"""

from __future__ import annotations

from typing import Callable

import torch

from horovod_tpu_torch.core import state as _state
from horovod_tpu_torch.core.state import HorovodError
from horovod_tpu_torch.ops import collectives as _coll


class Callback:
    """Keras-style callback: the Trainer calls these hooks around the loop."""

    trainer = None  # set by Trainer.fit

    def set_trainer(self, trainer) -> None:
        self.trainer = trainer

    def on_train_begin(self, logs: dict | None = None) -> None: ...

    def on_train_end(self, logs: dict | None = None) -> None: ...

    def on_epoch_begin(self, epoch: int, logs: dict | None = None) -> None: ...

    def on_epoch_end(self, epoch: int, logs: dict | None = None) -> None: ...

    def on_batch_begin(self, batch: int, logs: dict | None = None) -> None: ...

    def on_batch_end(self, batch: int, logs: dict | None = None) -> None: ...


class BroadcastGlobalVariablesCallback(Callback):
    """Broadcast parameters, buffers and optimizer state from ``root_rank``
    at the start of training, so every replica starts identical."""

    def __init__(self, root_rank: int = 0, group: int = 0) -> None:
        self.root_rank = root_rank
        self.group = group

    def on_train_begin(self, logs: dict | None = None) -> None:
        self.trainer.sync_state(self.root_rank, self.group)


class MetricAverageCallback(Callback):
    """Average epoch metrics over the group's ranks before they are
    reported, so every rank logs the same value. ``keys`` names the metrics
    to average (absent keys are skipped); ``None`` averages every numeric
    log value. One named allreduce per key, in sorted key order, so all
    ranks issue the same sequence."""

    def __init__(self, group: int = 0, *,
                 keys: list[str] | None = None) -> None:
        self.keys = None if keys is None else set(keys)
        self.group = group

    def on_epoch_end(self, epoch: int, logs: dict | None = None) -> None:
        if not logs:
            return
        dev = _state.device()
        for key in sorted(logs):
            if self.keys is not None and key not in self.keys:
                continue
            value = torch.as_tensor(logs[key], dtype=torch.float64,
                                    device=dev)
            mean = _coll.allreduce(value, group=self.group, average=True,
                                   name=f"MetricAverage.{key}")
            if mean is not None:
                logs[key] = float(mean) if mean.ndim == 0 \
                    else mean.cpu().numpy()


class LearningRateScheduleCallback(Callback):
    """Multiply the initial LR by ``multiplier(epoch)`` within an epoch
    window. ``staircase=True`` applies it per epoch; ``staircase=False`` per
    batch at the fractional epoch ``epoch + batch/steps_per_epoch``. With
    ``momentum_correction`` the momentum buffers are rescaled by
    ``new_lr / old_lr`` whenever the LR changes."""

    def __init__(self, multiplier: Callable[[float], float] | float,
                 start_epoch: int = 0, end_epoch: int | None = None,
                 staircase: bool = True, momentum_correction: bool = True,
                 steps_per_epoch: int | None = None) -> None:
        self.start_epoch = start_epoch
        self.end_epoch = end_epoch
        self.staircase = staircase
        self.momentum_correction = momentum_correction
        self.steps_per_epoch = steps_per_epoch
        self.initial_lr: float | None = None
        self.current_epoch: int | None = None
        if callable(multiplier):
            self.multiplier = multiplier
        else:
            self.multiplier = lambda epoch: multiplier

    def _in_window(self, epoch: int) -> bool:
        if epoch < self.start_epoch:
            return False
        return self.end_epoch is None or epoch < self.end_epoch

    def _adjust(self, epoch: float) -> None:
        old_lr = self.trainer.get_lr()
        new_lr = self.initial_lr * self.multiplier(epoch)
        self.trainer.set_lr(new_lr)
        if self.momentum_correction and old_lr > 0:
            self.trainer.scale_momentum(new_lr / old_lr)

    def on_train_begin(self, logs: dict | None = None) -> None:
        if self.initial_lr is None:
            self.initial_lr = self.trainer.get_lr()

    def on_epoch_begin(self, epoch: int, logs: dict | None = None) -> None:
        self.current_epoch = epoch
        if self.staircase and self._in_window(epoch):
            self._adjust(epoch)

    def on_batch_begin(self, batch: int, logs: dict | None = None) -> None:
        if self.staircase or not self._in_window(self.current_epoch or 0):
            return
        if not self.steps_per_epoch:
            raise HorovodError(
                "LearningRateScheduleCallback with staircase=False requires "
                "steps_per_epoch.")
        epoch = (self.current_epoch or 0) + float(batch) / self.steps_per_epoch
        self._adjust(epoch)


class LearningRateWarmupCallback(LearningRateScheduleCallback):
    """Linear LR warmup from ``lr / size`` to ``lr`` over ``warmup_epochs``:
    ``lr = initial_lr · (epoch·(size − 1)/warmup_epochs + 1) / size``."""

    def __init__(self, warmup_epochs: int = 5, momentum_correction: bool = True,
                 steps_per_epoch: int | None = None, verbose: bool = False,
                 group: int = 0) -> None:
        self.group = group
        self.verbose = verbose

        def multiplier(epoch: float) -> float:
            size = _state.size(self.group)
            return (epoch * (size - 1) / warmup_epochs + 1) / size

        super().__init__(multiplier=multiplier, start_epoch=0,
                         end_epoch=warmup_epochs, staircase=False,
                         momentum_correction=momentum_correction,
                         steps_per_epoch=steps_per_epoch)

    def on_epoch_end(self, epoch: int, logs: dict | None = None) -> None:
        if self.end_epoch is not None and epoch == self.end_epoch - 1 \
                and self.verbose:
            print(f"Epoch {epoch + 1}: finished gradual learning rate warmup "
                  f"to {self.trainer.get_lr():.6g}.")

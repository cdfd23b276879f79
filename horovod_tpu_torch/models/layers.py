"""Shared model layers: the fused BatchNorm and its plain flax-style twin.

Counterparts of ``horovod_tpu/models/layers.py::FusedBatchNorm`` and of
``flax.linen.BatchNorm``. Both keep flax's semantics, not
``nn.BatchNorm2d``'s:

* they take channels-last ``(..., C)`` tensors;
* running averages update as ``ra = momentum·ra + (1 − momentum)·batch``
  with ``momentum = 0.9``;
* the running variance is the biased batch variance (``nn.BatchNorm2d``
  keeps the unbiased one);
* ``epsilon`` is 1e-5, and parameters are fp32 whatever the compute dtype.

The mode is the module's ``training`` flag (``model.train()`` /
``model.eval()``), the counterpart of flax's ``use_running_average``.
"""

from __future__ import annotations

import torch
from torch import nn

from horovod_tpu_torch.ops import batchnorm as _bn


class _BatchNormBase(nn.Module):
    def __init__(self, num_features: int, momentum: float = 0.9,
                 epsilon: float = 1e-5, dtype: torch.dtype | None = None,
                 scale_init: float = 1.0) -> None:
        super().__init__()
        self.momentum = momentum
        self.epsilon = epsilon
        self.dtype = dtype
        self.scale = nn.Parameter(torch.full((num_features,), scale_init))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("mean", torch.zeros(num_features))
        self.register_buffer("var", torch.ones(num_features))

    def _update_running(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        m = self.momentum
        with torch.no_grad():
            self.mean.copy_(m * self.mean + (1.0 - m) * mean)
            self.var.copy_(m * self.var + (1.0 - m) * var)


class FusedBatchNorm(_BatchNormBase):
    """BatchNorm whose training statistics and gradient sums run through
    the channel-sum kernels (:mod:`horovod_tpu_torch.ops.batchnorm`): B1 in
    the forward, B2 in the backward; the normalize is one multiply-add in
    the compute dtype. ``group``: sum the statistics over that group's
    ranks (synced BN, the reference's ``axis_name``)."""

    def __init__(self, num_features: int, *, group: int | None = None,
                 **kwargs) -> None:
        super().__init__(num_features, **kwargs)
        self.group = group

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = self.dtype or x.dtype
        if not self.training:
            rstd = torch.rsqrt(self.var + self.epsilon)
            a = (self.scale * rstd).to(dtype)
            b = (self.bias - self.scale * rstd * self.mean).to(dtype)
            return x.to(dtype) * a + b
        y, mean, var = _bn.batch_norm_train(
            x.to(dtype), self.scale, self.bias, self.epsilon, self.group)
        self._update_running(mean, var)
        return y


class BatchNorm(_BatchNormBase):
    """Plain PyTorch BatchNorm with ``flax.linen.BatchNorm``'s arithmetic
    (the ``norm_impl="flax"`` path; no kernel): fp32 statistics by the fast
    variance ``E[x²] − E[x]²`` clipped at 0, and
    ``y = (x − mean)·rsqrt(var + eps)·scale + bias`` in fp32, cast to the
    compute dtype. Statistics are per rank: synced BN is the fused
    module's."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = self.dtype or x.dtype
        xf = x.float()
        if self.training:
            c = x.shape[-1]
            rows = xf.reshape(-1, c)
            mean = rows.mean(0)
            var = torch.clamp((rows * rows).mean(0) - mean * mean, min=0.0)
            self._update_running(mean.detach(), var.detach())
        else:
            mean, var = self.mean, self.var
        y = (xf - mean) * (torch.rsqrt(var + self.epsilon) * self.scale)
        return (y + self.bias).to(dtype)

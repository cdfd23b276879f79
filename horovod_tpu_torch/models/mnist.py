"""MNIST convolutional models — the reference examples' workloads.

Counterpart of ``horovod_tpu/models/mnist.py``: the same two networks,
layer for layer, so that flax weights carry across
(:func:`from_flax_params`) and both frameworks compute the same function.

* :class:`ConvModel` — 32×5×5 conv → 2×2 max-pool → 64×5×5 conv → 2×2
  max-pool → dense 1024 + dropout 0.5 → dense 10 (SAME convs pad 2 on each
  side; the SAME pools on 28 and 14 pad nothing).
* :class:`KerasMnistModel` — 32×3×3 conv → 64×3×3 conv → 2×2 max-pool →
  dropout 0.25 → dense 128 → dropout 0.5 → dense 10 (VALID: 28 → 26 → 24
  → 12).

Inputs are NHWC ``(B, 28, 28, 1)`` (or ``(B, 784)``, ``(B, 28, 28)``), as
in JAX; the convolutions run on the NCHW view, and the activations go back
to NHWC before the flatten, so the first dense kernel is flax's, transposed.
Parameters are fp32 and cast to the compute ``dtype`` per op (bf16 by
default, as flax's ``dtype``); the logits come out fp32.

Dropout is the port's own stream (ROADMAP §C): the mask is drawn from
splitmix64 over (the key, the layer, the element index) on the device, and
:func:`make_loss_fn` derives the key from (seed, ``labels.sum()``) as the
reference folds its key, but without reading the sum on the host — so the
loss is a pure function of its inputs and the step can be captured as a
CUDA graph.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from horovod_tpu_torch.models.resnet import lecun_normal_
from horovod_tpu_torch.models.transformer import _splitmix64, _srl


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    if x.ndim == 2:
        return x.reshape(-1, 28, 28, 1)
    if x.ndim == 3:
        return x[..., None]
    return x


def dropout_key(seed, labels: torch.Tensor) -> torch.Tensor:
    """The dropout key of a batch: splitmix64 of ``seed`` (an int or an
    int64 tensor on the labels' device) mixed with ``labels.sum()``, a 0-d
    int64 tensor that never leaves the device."""
    # A fill, never a copy from the host: a capture refuses the latter.
    s = seed if isinstance(seed, torch.Tensor) else torch.full(
        (), int(seed), dtype=torch.long, device=labels.device)
    return _splitmix64(_splitmix64(s) ^ labels.sum(dtype=torch.long))


def dropout(x: torch.Tensor, rate: float, key: torch.Tensor,
            layer: int) -> torch.Tensor:
    """Inverted dropout: keep each element with probability ``1 − rate``
    and scale it by ``1/(1 − rate)``, as flax's ``nn.Dropout``. The keep
    bit of element ``i`` is ``u < 1 − rate`` with ``u`` uniform in [0, 1)
    from splitmix64 over (``key``, ``layer``, ``i``)."""
    keep = 1.0 - rate
    h = _splitmix64(key ^ layer)
    h = _splitmix64(h ^ torch.arange(x.numel(), device=x.device))
    u = _srl(h, 11).double() * 2.0 ** -53
    mask = (u < keep).reshape(x.shape)
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))


class _Dense(nn.Module):
    def __init__(self, cin: int, cout: int, generator=None) -> None:
        super().__init__()
        self.weight = nn.Parameter(lecun_normal_(torch.empty(cout, cin), cin,
                                                 generator))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


class _Conv(nn.Module):
    def __init__(self, cin: int, cout: int, k: int, padding: int,
                 generator=None) -> None:
        super().__init__()
        self.padding = padding
        self.weight = nn.Parameter(lecun_normal_(
            torch.empty(cout, cin, k, k), cin * k * k, generator))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, self.weight.to(x.dtype), self.bias.to(x.dtype),
                        padding=self.padding)


class _MnistNet(nn.Module):
    """What both models share: the input handling, the dtype, the dropout
    switch. ``forward(x, train=None, dropout_key=None)``: ``train``
    defaults to ``self.training``; training needs ``dropout_key`` (as the
    reference's needs ``dropout_rng``)."""

    def __init__(self, num_classes: int, dtype: torch.dtype) -> None:
        super().__init__()
        self.num_classes = num_classes
        self.dtype = dtype

    def forward(self, x: torch.Tensor, *, train: bool | None = None,
                dropout_key: torch.Tensor | None = None) -> torch.Tensor:
        train = self.training if train is None else train
        if train and dropout_key is None:
            raise ValueError(
                f"{type(self).__name__}: training applies dropout and needs "
                f"a dropout_key (models.mnist.dropout_key); pass train=False "
                f"or call .eval() for inference.")
        x = _nhwc(x).to(self.dtype).permute(0, 3, 1, 2)
        return self._body(x, dropout_key if train else None).float()

    def _drop(self, x, rate: float, key, layer: int):
        return x if key is None else dropout(x, rate, key, layer)


class ConvModel(_MnistNet):
    """2-layer convolution model (the reference's tensorflow_mnist.py)."""

    def __init__(self, num_classes: int = 10,
                 dtype: torch.dtype = torch.bfloat16,
                 generator: torch.Generator | None = None) -> None:
        super().__init__(num_classes, dtype)
        self.conv1 = _Conv(1, 32, 5, 2, generator)
        self.conv2 = _Conv(32, 64, 5, 2, generator)
        self.fc1 = _Dense(7 * 7 * 64, 1024, generator)
        self.fc2 = _Dense(1024, num_classes, generator)

    def _body(self, x, key):
        x = F.max_pool2d(F.relu(self.conv1(x)), 2, 2)
        x = F.max_pool2d(F.relu(self.conv2(x)), 2, 2)
        x = x.permute(0, 2, 3, 1).flatten(1)  # flax's NHWC order
        x = self._drop(F.relu(self.fc1(x)), 0.5, key, 0)
        return self.fc2(x)


class KerasMnistModel(_MnistNet):
    """The Keras example model (the reference's keras_mnist.py)."""

    def __init__(self, num_classes: int = 10,
                 dtype: torch.dtype = torch.bfloat16,
                 generator: torch.Generator | None = None) -> None:
        super().__init__(num_classes, dtype)
        self.conv1 = _Conv(1, 32, 3, 0, generator)
        self.conv2 = _Conv(32, 64, 3, 0, generator)
        self.fc1 = _Dense(12 * 12 * 64, 128, generator)
        self.fc2 = _Dense(128, num_classes, generator)

    def _body(self, x, key):
        x = F.relu(self.conv2(F.relu(self.conv1(x))))
        x = F.max_pool2d(x, 2, 2)
        x = self._drop(x.permute(0, 2, 3, 1), 0.25, key, 0).flatten(1)
        x = self._drop(F.relu(self.fc1(x)), 0.5, key, 1)
        return self.fc2(x)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       num_classes: int = 10) -> torch.Tensor:
    """Softmax cross-entropy against integer labels, mean over the batch —
    the loss every reference MNIST example uses."""
    target = F.one_hot(labels.long(), num_classes).to(logits.dtype)
    return -(target * F.log_softmax(logits, dim=-1)).sum(-1).mean()


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return (logits.argmax(-1) == labels).float().mean()


def make_loss_fn(model: _MnistNet, train: bool = True, seed: int = 0):
    """``loss_fn(model, batch) -> loss`` for the
    :class:`~horovod_tpu_torch.Trainer`; ``batch`` is ``(images, labels)``.
    The dropout key comes from (``seed``, the batch's labels) on the
    device (:func:`dropout_key`), so the loss is a pure function of its
    inputs."""
    k = model.num_classes

    def loss_fn(model: _MnistNet, batch):
        images, labels = batch
        key = dropout_key(seed, labels) if train else None
        logits = model(images, train=train, dropout_key=key)
        return cross_entropy_loss(logits, labels, k)

    return loss_fn


def synthetic_mnist(batch_size: int, seed: int = 0,
                    device: str | torch.device = "cuda"):
    """A deterministic synthetic MNIST-shaped batch on ``device``: images
    (B, 28, 28, 1) fp32 uniform in [0, 1) and int64 labels in [0, 10),
    drawn from a ``torch.Generator`` seeded with ``seed`` on the CPU, so
    the batch is the same on every device. (The reference draws its batch
    with ``jax.random``, which torch cannot reproduce: ROADMAP §C.)"""
    g = torch.Generator().manual_seed(seed)
    images = torch.rand((batch_size, 28, 28, 1), generator=g)
    labels = torch.randint(0, 10, (batch_size,), generator=g)
    return images.to(device), labels.to(device)


# -- weights carried across from flax -----------------------------------------

def from_flax_params(params) -> dict[str, torch.Tensor]:
    """The port's ``state_dict`` for the flax parameters of
    ``horovod_tpu.models.mnist.ConvModel`` or ``KerasMnistModel`` (numpy
    leaves): conv kernels HWIO → OIHW, dense kernels (in, out) → (out,
    in)."""
    def t(a):
        return torch.from_numpy(np.array(a, dtype=np.float32))

    out: dict[str, torch.Tensor] = {}
    for i in range(2):
        conv, dense = params[f"Conv_{i}"], params[f"Dense_{i}"]
        out[f"conv{i + 1}.weight"] = t(np.transpose(
            np.asarray(conv["kernel"]), (3, 2, 0, 1)))
        out[f"conv{i + 1}.bias"] = t(conv["bias"])
        out[f"fc{i + 1}.weight"] = t(np.asarray(dense["kernel"]).T)
        out[f"fc{i + 1}.bias"] = t(dense["bias"])
    return out

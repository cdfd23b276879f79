"""ResNet v1.5 (ResNet-50 = stages [3, 4, 6, 3]) — the flagship workload.

Counterpart of ``horovod_tpu/models/resnet.py``: the same network, layer for
layer, so that weights carry across (:func:`from_flax_variables`) and both
frameworks compute the same function.

* **Layout.** The model's input and every activation between layers are
  NHWC, as in JAX. Convolutions and pooling run on the NCHW view of those
  tensors, which is ``torch.channels_last`` in memory (conv weights are kept
  channels_last too), so the BatchNorm input's ``(N·H·W, C)`` view is
  contiguous and the channel-sum kernels read it without a copy.
* **Padding.** Flax ``"SAME"`` padding is asymmetric on strided layers
  (the 7×7/2 stem on 224 px pads 2 low, 3 high; each 3×3/2 pads 0 low,
  1 high); PyTorch's ``padding=k//2`` is symmetric. :func:`same_pads`
  computes flax's pads, applied with ``F.pad`` (max-pool pads with −inf).
* **Dtypes.** Parameters are fp32 and are cast to the compute ``dtype`` per
  op (bf16 by default), as flax's ``dtype``/``param_dtype`` do; the logits
  come out fp32.
* **Norms.** ``norm_impl="flax"`` (the default, as in JAX) runs the plain
  :class:`~horovod_tpu_torch.models.layers.BatchNorm`; ``"fused"`` runs
  :class:`~horovod_tpu_torch.models.layers.FusedBatchNorm` on kernels B1/B2.
* **Presets.** ``ResNet18``, ``ResNet50``, ``ResNet101``, ``ResNet152`` and
  ``create_resnet50``, as in the reference. Its ``init_variables`` (flax's
  ``model.init`` on a dummy batch) has no counterpart: the module draws its
  weights in its constructor (``generator=``), and ``state_dict()`` holds
  what the reference's variables hold.
"""

from __future__ import annotations

import functools
import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from horovod_tpu_torch.models.layers import BatchNorm, FusedBatchNorm

_NORMS = {"fused": FusedBatchNorm, "flax": BatchNorm}


def same_pads(size: int, k: int, s: int) -> tuple[int, int]:
    """Flax/XLA ``"SAME"`` padding of one spatial dim: (low, high)."""
    total = max((math.ceil(size / s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def _pad_nchw(x: torch.Tensor, k: int, s: int, value: float = 0.0):
    """Pad an NCHW tensor for a SAME k×k/s window; returns (x, padding)
    where ``padding`` is what the conv/pool call should still apply
    (symmetric pads go there, asymmetric ones through ``F.pad``)."""
    ph = same_pads(x.shape[2], k, s)
    pw = same_pads(x.shape[3], k, s)
    if ph[0] == ph[1] and pw[0] == pw[1] and value == 0.0:
        return x, (ph[0], pw[0])
    return F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=value), (0, 0)


def lecun_normal_(w: torch.Tensor, fan_in: int,
                  generator: torch.Generator | None = None) -> torch.Tensor:
    """Flax's default kernel init: a normal truncated at ±2σ, scaled so the
    variance is 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / .87962566103423978
    return nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                                 generator=generator)


class Conv(nn.Module):
    """Bias-free k×k conv with stride ``s`` and flax SAME padding on NHWC
    tensors; weight OIHW fp32 (channels_last), cast to ``dtype`` per op."""

    def __init__(self, cin: int, cout: int, k: int, s: int = 1,
                 dtype: torch.dtype = torch.bfloat16,
                 generator: torch.Generator | None = None) -> None:
        super().__init__()
        self.k, self.s, self.dtype = k, s, dtype
        w = lecun_normal_(torch.empty(cout, cin, k, k), cin * k * k,
                          generator)
        self.weight = nn.Parameter(w.to(memory_format=torch.channels_last))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xc, padding = _pad_nchw(x.permute(0, 3, 1, 2), self.k, self.s)
        y = F.conv2d(xc.to(self.dtype), self.weight.to(self.dtype),
                     stride=self.s, padding=padding)
        return y.permute(0, 2, 3, 1)


def max_pool_same(x: torch.Tensor, k: int = 3, s: int = 2) -> torch.Tensor:
    """Flax ``max_pool(padding="SAME")`` on NHWC (pads with −inf)."""
    xc, _ = _pad_nchw(x.permute(0, 3, 1, 2), k, s, value=float("-inf"))
    return F.max_pool2d(xc, k, s).permute(0, 2, 3, 1)


class BottleneckBlock(nn.Module):
    """1×1 → 3×3 (stride here, v1.5) → 1×1 bottleneck with a projection
    shortcut where the shape changes; the last norm's scale starts at 0."""

    def __init__(self, cin: int, filters: int, stride: int, norm,
                 dtype: torch.dtype, generator=None) -> None:
        super().__init__()
        conv = functools.partial(Conv, dtype=dtype, generator=generator)
        self.conv1 = conv(cin, filters, 1)
        self.norm1 = norm(filters)
        self.conv2 = conv(filters, filters, 3, stride)
        self.norm2 = norm(filters)
        self.conv3 = conv(filters, filters * 4, 1)
        self.norm3 = norm(filters * 4, scale_init=0.0)
        self.conv_proj = self.norm_proj = None
        if cin != filters * 4 or stride != 1:
            self.conv_proj = conv(cin, filters * 4, 1, stride)
            self.norm_proj = norm(filters * 4)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.norm1(self.conv1(x)))
        y = F.relu(self.norm2(self.conv2(y)))
        y = self.norm3(self.conv3(y))
        residual = x
        if self.conv_proj is not None:
            residual = self.norm_proj(self.conv_proj(x))
        return F.relu(residual + y)


class ResNet(nn.Module):
    """ResNet v1.5 over ``stage_sizes``; input NHWC ``(B, H, W, 3)``,
    output fp32 logits ``(B, num_classes)``. ``group``: synced BN over that
    group (``norm_impl="fused"`` only). Weights are initialised as flax
    initialises the reference (LeCun-normal kernels, zero dense bias, unit
    BN scales but a zero last scale in each block), drawing from
    ``generator`` (the global generator when None)."""

    def __init__(self, stage_sizes: Sequence[int], num_classes: int = 1000,
                 num_filters: int = 64, dtype: torch.dtype = torch.bfloat16,
                 norm_impl: str = "flax", group: int | None = None,
                 generator: torch.Generator | None = None) -> None:
        super().__init__()
        if norm_impl not in _NORMS:
            raise ValueError(f"Unknown norm_impl {norm_impl!r}; choose from "
                             f"{sorted(_NORMS)}.")
        if group is not None and norm_impl != "fused":
            raise ValueError("Synced BatchNorm (group=...) needs "
                             "norm_impl='fused'.")
        self.stage_sizes = list(stage_sizes)
        self.num_classes = num_classes
        self.dtype = dtype
        self.norm_impl = norm_impl
        kw = {"dtype": dtype}
        if group is not None:
            kw["group"] = group

        def norm(c, **extra):
            return _NORMS[norm_impl](c, **kw, **extra)

        self.conv_init = Conv(3, num_filters, 7, 2, dtype=dtype,
                              generator=generator)
        self.bn_init = norm(num_filters)
        blocks = []
        cin = num_filters
        for i, count in enumerate(self.stage_sizes):
            for j in range(count):
                filters = num_filters * 2 ** i
                stride = 2 if i > 0 and j == 0 else 1
                blocks.append(BottleneckBlock(cin, filters, stride, norm,
                                              dtype, generator))
                cin = filters * 4
        self.blocks = nn.ModuleList(blocks)
        self.head = nn.Linear(cin, num_classes)
        with torch.no_grad():
            lecun_normal_(self.head.weight, cin, generator)
            self.head.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        x = F.relu(self.bn_init(self.conv_init(x)))
        x = max_pool_same(x)
        for block in self.blocks:
            x = block(x)
        x = x.mean(dim=(1, 2))
        x = F.linear(x, self.head.weight.to(self.dtype),
                     self.head.bias.to(self.dtype))
        return x.float()


# The reference's presets (``horovod_tpu/models/resnet.py:108-111``); its
# ResNet-18 uses bottleneck blocks too.
def ResNet18(**kwargs) -> ResNet:
    return ResNet(stage_sizes=[2, 2, 2, 2], **kwargs)


def ResNet50(**kwargs) -> ResNet:
    return ResNet(stage_sizes=[3, 4, 6, 3], **kwargs)


def ResNet101(**kwargs) -> ResNet:
    return ResNet(stage_sizes=[3, 4, 23, 3], **kwargs)


def ResNet152(**kwargs) -> ResNet:
    return ResNet(stage_sizes=[3, 8, 36, 3], **kwargs)


def create_resnet50(num_classes: int = 1000, dtype=torch.bfloat16,
                    group: int | None = None, **kwargs) -> ResNet:
    """The reference's ``create_resnet50``; its ``axis_name`` (BN synced
    over a mesh axis) is ``group`` here (BN synced over that group, with
    ``norm_impl="fused"``)."""
    return ResNet50(num_classes=num_classes, dtype=dtype, group=group,
                    **kwargs)


def is_kernel(name: str) -> bool:
    """True for conv and dense weights — the tensors the L2 term covers
    (flax's ``kernel`` leaves); BN scales/biases and the dense bias are
    excluded."""
    return name.endswith(".weight")


def make_loss_fn(model: ResNet, weight_decay: float = 1e-4,
                 label_smoothing: float = 0.1):
    """``loss_fn(model, batch) -> (loss, {"accuracy": acc})``: label-smoothed
    softmax cross-entropy averaged over the batch, plus
    ``0.5·weight_decay·Σ‖W‖²`` over conv and dense kernels. The BN running
    statistics update in place during the forward."""
    k = model.num_classes

    def loss_fn(model: ResNet, batch):
        images, labels = batch
        logits = model(images)
        target = F.one_hot(labels, k).to(logits.dtype)
        if label_smoothing:
            target = target * (1.0 - label_smoothing) + label_smoothing / k
        loss = -(target * F.log_softmax(logits, dim=-1)).sum(-1).mean()
        if weight_decay:
            l2 = sum(p.float().pow(2).sum()
                     for name, p in model.named_parameters() if is_kernel(name))
            loss = loss + weight_decay * 0.5 * l2
        acc = (logits.argmax(-1) == labels).float().mean()
        return loss, {"accuracy": acc.detach()}

    return loss_fn


def synthetic_imagenet(batch_size: int, image_size: int = 224, seed: int = 0,
                       num_classes: int = 1000,
                       device: str | torch.device = "cuda"):
    """Synthetic ImageNet-shaped batch from a seeded ``torch.Generator`` on
    ``device``: NHWC fp32 images ~ N(0, 1) and int64 labels."""
    device = torch.device(device)
    g = torch.Generator(device=device).manual_seed(seed)
    images = torch.randn((batch_size, image_size, image_size, 3),
                         generator=g, device=device)
    labels = torch.randint(0, num_classes, (batch_size,), generator=g,
                           device=device)
    return images, labels


# -- weights carried across from flax ------------------------------------------

def from_flax_variables(variables) -> dict[str, torch.Tensor]:
    """The port's ``state_dict`` for the flax variables of
    ``horovod_tpu.models.resnet.ResNet`` (``{'params': ..., 'batch_stats':
    ...}``, numpy leaves). Conv kernels go HWIO → OIHW, the dense kernel
    (in, out) → (out, in); the norm layers are ``BatchNorm_k`` or
    ``FusedBatchNorm_k`` by ``norm_impl``."""
    params, stats = variables["params"], variables.get("batch_stats", {})
    out: dict[str, torch.Tensor] = {}

    def t(a):
        return torch.from_numpy(np.array(a, dtype=np.float32))

    def conv(dst, src):
        out[f"{dst}.weight"] = t(np.transpose(np.asarray(src["kernel"]),
                                              (3, 2, 0, 1)))

    def norm(dst, p, s):
        for key, src in (("scale", p), ("bias", p), ("mean", s), ("var", s)):
            out[f"{dst}.{key}"] = t(src[key])

    conv("conv_init", params["conv_init"])
    norm("bn_init", params["bn_init"], stats["bn_init"])
    i = 0
    while f"BottleneckBlock_{i}" in params:
        p, s = params[f"BottleneckBlock_{i}"], stats[f"BottleneckBlock_{i}"]
        kind = "FusedBatchNorm" if "FusedBatchNorm_0" in p else "BatchNorm"
        for j in range(3):
            conv(f"blocks.{i}.conv{j + 1}", p[f"Conv_{j}"])
            norm(f"blocks.{i}.norm{j + 1}", p[f"{kind}_{j}"], s[f"{kind}_{j}"])
        if "conv_proj" in p:
            conv(f"blocks.{i}.conv_proj", p["conv_proj"])
            norm(f"blocks.{i}.norm_proj", p["norm_proj"], s["norm_proj"])
        i += 1
    dense = params["Dense_0"]
    out["head.weight"] = t(np.asarray(dense["kernel"]).T)
    out["head.bias"] = t(dense["bias"])
    return out

"""BatchNorm channel sums — CUDA kernels B1/B2 and the training-mode BN.

Counterpart of ``horovod_tpu/ops/batchnorm.py``. The TPU package reduces the
(batch·spatial) dimension with two Pallas kernels; here the same two
reductions are CUDA C++ kernels written for Hopper
(``horovod_tpu_torch/csrc/batchnorm.cu``):

* **B1** :func:`channel_sums` — Σx and Σx² per channel, fp32, one pass;
* **B2** :func:`channel_grad_sums` — Σdy and Σdy·x̂ per channel with
  x̂ = (x − mean)·rstd recomputed on the fly, never written to memory.

:func:`batch_norm_train` ties them into a training-mode batch norm as a
``torch.autograd.Function``: B1 in the forward, B2 in the backward. The
normalize ``y = x·a + b`` and ``dx`` stay plain torch, as they stay plain JAX
in the reference.

Dispatch is by the tensor's device alone: a CPU tensor takes the plain
PyTorch version (:func:`channel_sums_plain`, :func:`channel_grad_sums_plain`),
which is what the CPU tests run; any other tensor launches the kernel or
raises. There is no fallback. Each wrapper counts its kernel launches in
:data:`LAUNCHES`.

Both the kernels and the plain versions square and form x̂ in fp32 (the
Pallas kernel did both in the input dtype; the JAX CPU path, which the tests
compare against, does them in fp32 — ROADMAP §C).
"""

from __future__ import annotations

import ctypes

import torch
import torch.distributed as dist

from horovod_tpu_torch.ops import _build

# Kernel launches per wrapper since the last reset_launch_counts(); only the
# CUDA branch counts, where the kernel is actually launched.
LAUNCHES = {"channel_sums": 0, "channel_grad_sums": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_VEC = {torch.float32: 4, torch.bfloat16: 8}  # elements per 16-byte load

_lib = None


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _kernels():
    global _lib
    if _lib is None:
        lib = _build.load("batchnorm")
        vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.hvd_bn_slabs.argtypes = [ll, i, i]
        lib.hvd_bn_slabs.restype = i
        lib.hvd_channel_sums.argtypes = [vp, vp, vp, vp, ll, i, i, i, i, vp]
        lib.hvd_channel_sums.restype = i
        lib.hvd_channel_grad_sums.argtypes = [vp, vp, vp, vp, vp, vp, vp, ll,
                                              i, i, i, i, vp]
        lib.hvd_channel_grad_sums.restype = i
        _lib = lib
    return _lib


def _rows(t: torch.Tensor) -> tuple[int, int]:
    c = t.shape[-1]
    return (t.numel() // c if c else 0), c


def _check_kernel_input(name: str, t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise RuntimeError(
            f"{name}: no kernel for device {t.device}; tensors on the CPU take "
            f"the plain version, others must be CUDA tensors.")
    if t.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name}: the kernel takes bfloat16 or float32, got "
                        f"{t.dtype}.")
    if not t.is_contiguous():
        raise ValueError(
            f"{name}: the kernel reads a contiguous channels-last (..., C) "
            f"tensor; got shape {tuple(t.shape)} with strides {t.stride()}. "
            f"Run the convolutions on torch.channels_last tensors so the "
            f"(N, H, W, C) view is contiguous; the wrapper does not copy.")


def _vec(t: torch.Tensor, c: int, *others: torch.Tensor) -> int:
    vec = _VEC[t.dtype]
    aligned = all(u.data_ptr() % 16 == 0 for u in (t, *others))
    return vec if c % vec == 0 and aligned else 1


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at kernel launch.")


# -- B1 ----------------------------------------------------------------------

def channel_sums_plain(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch B1: (Σx, Σx²) over all leading dims, fp32 (C,) each."""
    xf = x.reshape(-1, x.shape[-1]).float()
    return xf.sum(0), (xf * xf).sum(0)


def channel_sums(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(Σx, Σx²) over all leading dims of a channels-last ``(..., C)`` tensor,
    fp32 ``(C,)`` each. CPU tensors take :func:`channel_sums_plain`; CUDA
    tensors launch kernel B1."""
    if x.device.type == "cpu":
        return channel_sums_plain(x)
    _check_kernel_input("channel_sums", x)
    n, c = _rows(x)
    lib = _kernels()
    vec = _vec(x, c)
    slabs = lib.hvd_bn_slabs(n, c, vec)
    partial = torch.empty((slabs, 2, c), dtype=torch.float32, device=x.device)
    s1 = torch.empty(c, dtype=torch.float32, device=x.device)
    s2 = torch.empty(c, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.hvd_channel_sums(
            x.data_ptr(), partial.data_ptr(), s1.data_ptr(), s2.data_ptr(),
            n, c, _DTYPE_CODES[x.dtype], vec, slabs, _stream(x))
    _raise_on(err, "channel_sums")
    LAUNCHES["channel_sums"] += 1
    return s1, s2


# -- B2 ----------------------------------------------------------------------

def channel_grad_sums_plain(dy: torch.Tensor, x: torch.Tensor,
                            mean: torch.Tensor, rstd: torch.Tensor):
    """Plain PyTorch B2: (Σdy, Σdy·x̂), x̂ = (x − mean)·rstd in fp32."""
    c = x.shape[-1]
    dyf = dy.reshape(-1, c).float()
    xhat = (x.reshape(-1, c).float() - mean) * rstd
    return dyf.sum(0), (dyf * xhat).sum(0)


def channel_grad_sums(dy: torch.Tensor, x: torch.Tensor, mean: torch.Tensor,
                      rstd: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(Σdy, Σdy·x̂) over all leading dims, fp32 ``(C,)`` each — the BN
    backward sums. ``mean``/``rstd``: fp32 ``(C,)``. CPU tensors take
    :func:`channel_grad_sums_plain`; CUDA tensors launch kernel B2."""
    if x.device.type == "cpu":
        return channel_grad_sums_plain(dy, x, mean, rstd)
    _check_kernel_input("channel_grad_sums", x)
    _check_kernel_input("channel_grad_sums", dy)
    n, c = _rows(x)
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError(
            f"channel_grad_sums: dy {tuple(dy.shape)} {dy.dtype} must match "
            f"x {tuple(x.shape)} {x.dtype}.")
    for name, v in (("mean", mean), ("rstd", rstd)):
        if (v.dtype != torch.float32 or v.shape != (c,)
                or v.device != x.device or not v.is_contiguous()):
            raise ValueError(
                f"channel_grad_sums: {name} must be a contiguous float32 "
                f"({c},) tensor on {x.device}, got {tuple(v.shape)} "
                f"{v.dtype} on {v.device}.")
    lib = _kernels()
    vec = _vec(x, c, dy)
    slabs = lib.hvd_bn_slabs(n, c, vec)
    partial = torch.empty((slabs, 2, c), dtype=torch.float32, device=x.device)
    sdy = torch.empty(c, dtype=torch.float32, device=x.device)
    sdx = torch.empty(c, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.hvd_channel_grad_sums(
            dy.data_ptr(), x.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
            partial.data_ptr(), sdy.data_ptr(), sdx.data_ptr(), n, c,
            _DTYPE_CODES[x.dtype], vec, slabs, _stream(x))
    _raise_on(err, "channel_grad_sums")
    LAUNCHES["channel_grad_sums"] += 1
    return sdy, sdx


# -- training-mode batch norm --------------------------------------------------

def _group_sum(s1, s2, n: float, group):
    """Synced statistics: sum the (C,) partial sums over the group's ranks
    (the counterpart of the reference's ``lax.psum`` over ``axis_name``)."""
    if group is None:
        return s1, s2, n
    from horovod_tpu_torch.core import state as _state

    g = _state.get_group(group)
    both = torch.stack([s1, s2])
    dist.all_reduce(both, group=g.pg)
    return both[0], both[1], n * g.size


class _BatchNormTrain(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, gamma, beta, eps, group):
        n = float(_rows(x)[0])
        s1, s2 = channel_sums(x)
        s1, s2, n = _group_sum(s1, s2, n, group)
        mean = s1 / n
        var = torch.clamp(s2 / n - mean * mean, min=0.0)
        rstd = torch.rsqrt(var + eps)
        # One multiply-add pass in x's dtype: y = x·a + b.
        a = (gamma * rstd).to(x.dtype)
        b = (beta - gamma * rstd * mean).to(x.dtype)
        y = x * a + b
        ctx.save_for_backward(x, gamma, mean, rstd)
        ctx.group = group
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        # mean/var feed only the running averages, which carry no gradient.
        x, gamma, mean, rstd = ctx.saved_tensors
        n = float(_rows(x)[0])
        sdy, sdx = channel_grad_sums(dy, x, mean, rstd)
        sdy, sdx, n = _group_sum(sdy, sdx, n, ctx.group)
        # dx = γ·rstd·(dy − Σdy/n − x̂·Σ(dy·x̂)/n), one elementwise pass.
        a = (gamma * rstd).to(x.dtype)
        c1 = (sdy / n).to(x.dtype)
        c2 = (gamma * rstd * rstd * (sdx / n)).to(x.dtype)
        dx = a * dy - a * c1 - (x - mean.to(x.dtype)) * c2
        return dx, sdx, sdy, None, None


def batch_norm_train(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                     eps: float = 1e-5, group: int | None = None):
    """Training-mode batch norm; returns ``(y, mean, var)``.

    ``x``: channels-last ``(..., C)`` bf16/fp32; ``gamma``/``beta``: fp32
    ``(C,)``. ``mean``/``var`` are the fp32 batch statistics (biased
    variance, as flax) for the caller's running-average update. With
    ``group`` (a group index) the statistics and the backward sums are
    summed over that group's ranks — synced BN.
    """
    return _BatchNormTrain.apply(x, gamma, beta, eps, group)

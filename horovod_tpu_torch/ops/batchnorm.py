"""BatchNorm channel sums — CUDA kernels B1/B2 and the training-mode BN.

Counterpart of ``horovod_tpu/ops/batchnorm.py``. The TPU package reduces the
(batch·spatial) dimension with two Pallas kernels; here the same two
reductions are CUDA C++ kernels written for Hopper:

* **B1** :func:`channel_sums` — Σx and Σx² per channel, fp32, one pass and
  one launch (``horovod_tpu_torch/csrc/bn_sums.cu``: a bulk-copy ring, a
  grid barrier, and a combine spread over the grid; its plan is
  :func:`sums_plan`);
* **B2** :func:`channel_grad_sums` — Σdy and Σdy·x̂ per channel with
  x̂ = (x − mean)·rstd recomputed on the fly, never written to memory
  (``horovod_tpu_torch/csrc/batchnorm.cu``, slab partials and a second
  pass).

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
from typing import NamedTuple

import torch
import torch.distributed as dist

from horovod_tpu_torch.ops import _build
from horovod_tpu_torch.ops import launches as _launches

# Kernel launches per wrapper since the last reset_launch_counts(); only the
# CUDA branch counts, where the kernel is actually launched (a captured launch
# at each replay of its graph: ops/launches.py).
LAUNCHES = {"channel_sums": 0, "channel_grad_sums": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_VEC = {torch.float32: 4, torch.bfloat16: 8}  # elements per 16-byte load
_ELEM_BYTES = {torch.float32: 4, torch.bfloat16: 2}

_lib = None   # batchnorm.cu: B2
_sums = None  # bn_sums.cu: B1


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

# The launch plan of B1's kernel (csrc/bn_sums.cu), mirrored from its
# constants: 256 consumer threads a block, each owning at most 4 channel
# vectors of 16 bytes; a ring stage of 16 KB. The plan's own choices: rows
# cut into channel tiles of at most SUMS_TILE_BYTES on the bulk-copy path,
# and at least SUMS_MIN_BLOCK_BYTES of input a block.
SUMS_THREADS = 256
SUMS_MAX_VECS = 4
SUMS_STAGE_BYTES = 16384
SUMS_TILE_BYTES = 512
SUMS_MIN_BLOCK_BYTES = 32768


class SumsPlan(NamedTuple):
    """B1's grid ``(gx, gy)``, its channel tile ``ct`` (channels a block
    along y sums), the whole rows a ring stage holds (``rows_per_stage``, 0
    when the rows are read with ordinary loads) and the fp32 scratch it
    needs: Σx, Σx², then one (2, C) partial row per block along x. Its grid
    barrier takes one 64-bit word per channel tile."""
    gx: int
    gy: int
    ct: int
    rows_per_stage: int
    scratch: int


def sums_plan(n: int, c: int, elem_bytes: int, vec: int,
              max_blocks: int) -> SumsPlan:
    """B1's launch plan for an (n, c) input of ``elem_bytes`` per element
    read ``vec`` elements at a time, on a card that keeps ``max_blocks``
    blocks resident at once. ``vec`` > 1 (a 16-byte aligned input, C a
    multiple of ``vec``; the wrapper passes ``vec`` = 1 otherwise) takes
    the bulk-copy ring, the rows cut into tiles of SUMS_TILE_BYTES so that
    wide rows leave fewer partial rows. Blocks own rows ``block_rows``; no
    block is empty when n > 0."""
    bulk = vec > 1
    ct = min(c, SUMS_TILE_BYTES // elem_bytes if bulk
             else SUMS_MAX_VECS * SUMS_THREADS * vec)
    gy = -(-c // ct)
    gx = max(1, min(n, max(1, max_blocks // gy),
                    n * ct * elem_bytes // SUMS_MIN_BLOCK_BYTES))
    return SumsPlan(gx=gx, gy=gy, ct=ct,
                    rows_per_stage=SUMS_STAGE_BYTES // (ct * elem_bytes)
                    if bulk else 0,
                    scratch=2 * c + gx * 2 * c)


def block_rows(plan: SumsPlan, n: int, b: int) -> tuple[int, int]:
    """Rows [r0, r1) of block ``b`` along x, as the kernel computes them."""
    return b * n // plan.gx, (b + 1) * n // plan.gx


_plans: dict[tuple, SumsPlan] = {}
_barriers: dict[tuple[int, int], torch.Tensor] = {}
_max_blocks: dict[int, int] = {}


def _sums_lib():
    global _sums
    if _sums is None:
        lib = _build.load("bn_sums")
        vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.hvd_bn_sums_max_blocks.argtypes = [i]
        lib.hvd_bn_sums_max_blocks.restype = i
        lib.hvd_channel_sums.argtypes = [vp, vp, vp, ll, i, i, i, i, i, i, i,
                                         i, vp]
        lib.hvd_channel_sums.restype = i
        _sums = lib
    return _sums


def _plan(lib, n: int, c: int, dtype: torch.dtype, vec: int,
          device: int) -> SumsPlan:
    key = (n, c, dtype, vec, device)
    plan = _plans.get(key)
    if plan is None:
        most = _max_blocks.get(device)
        if most is None:
            most = lib.hvd_bn_sums_max_blocks(device)
            if most <= 0:
                raise RuntimeError(f"channel_sums: CUDA error {-most} sizing "
                                   f"the grid on cuda:{device}.")
            _max_blocks[device] = most
        plan = _plans[key] = sums_plan(n, c, _ELEM_BYTES[dtype], vec, most)
    return plan


def _barrier(plan: SumsPlan, device: torch.device,
             stream: int) -> torch.Tensor:
    """B1's grid-barrier words on ``stream`` (a raw CUDA stream handle), one
    64-bit word per channel tile of ``plan``, the arrival counts zero: the
    kernel leaves them so, and calls on one stream run in order, so two
    calls in flight never share one."""
    key = (device.index, stream)
    t = _barriers.get(key)
    if t is None or t.numel() < plan.gy:
        t = _barriers[key] = torch.zeros(max(32, plan.gy), dtype=torch.int64,
                                         device=device)
    return t


def launch_plan(x: torch.Tensor) -> SumsPlan:
    """The plan B1 launches for the CUDA tensor ``x`` (which must be one
    :func:`channel_sums` takes)."""
    _check_kernel_input("channel_sums", x)
    n, c = _rows(x)
    return _plan(_sums_lib(), n, c, x.dtype, _vec(x, c), x.device.index)


def channel_sums_plain(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch B1: (Σx, Σx²) over all leading dims, fp32 (C,) each."""
    xf = x.reshape(-1, x.shape[-1]).float()
    return xf.sum(0), (xf * xf).sum(0)


def channel_sums(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(Σx, Σx²) over all leading dims of a channels-last ``(..., C)`` tensor,
    fp32 ``(C,)`` each. CPU tensors take :func:`channel_sums_plain`; CUDA
    tensors launch kernel B1, one launch a call."""
    if x.device.type == "cpu":
        return channel_sums_plain(x)
    _check_kernel_input("channel_sums", x)
    n, c = _rows(x)
    if c == 0:
        raise ValueError("channel_sums: the kernel needs at least one "
                         "channel, got shape " f"{tuple(x.shape)}.")
    lib = _sums_lib()
    vec = _vec(x, c)
    device = x.device.index
    plan = _plan(lib, n, c, x.dtype, vec, device)
    buf = torch.empty(plan.scratch, dtype=torch.float32, device=x.device)
    stream = torch._C._cuda_getCurrentRawStream(device)
    err = lib.hvd_channel_sums(
        x.data_ptr(), buf.data_ptr(),
        _barrier(plan, x.device, stream).data_ptr(), n, c,
        _DTYPE_CODES[x.dtype], vec, plan.gx, plan.gy, plan.ct,
        plan.rows_per_stage, device, stream)
    _raise_on(err, "channel_sums")
    _launches.count(LAUNCHES, "channel_sums")
    return buf[:c], buf[c:2 * c]


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
    _launches.count(LAUNCHES, "channel_grad_sums")
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

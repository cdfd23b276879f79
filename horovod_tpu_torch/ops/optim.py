"""AdamW with moments stored in bf16 — the LM's optimizer — and kernel A1.

Counterpart of ``horovod_tpu/ops/optim.py::adamw``. The update of a large
model is bound by memory traffic: fp32 AdamW moves 28 bytes per parameter
per step (read p, m, v, g; write p, m, v). This optimizer keeps the update
math in fp32 but stores both moments in ``moment_dtype`` (bf16 by default),
20 bytes per parameter per step.

The update is the reference's, which is ``optax.adamw``'s: bias-corrected
moments, and decoupled weight decay *added to the update* and scaled by the
learning rate::

    m = b1·m + (1 − b1)·g          v = b2·v + (1 − b2)·g²
    p += −lr·(m̂ / (√v̂ + eps) + weight_decay·p),  m̂ = m/(1 − b1ᵗ), v̂ = v/(1 − b2ᵗ)

On the card the whole param group's update is ONE launch of kernel A1
(``horovod_tpu_torch/csrc/adamw.cu``, :func:`adamw_update`): one pass a
parameter, reading p, g, m, v and writing p, m, v — the 20 bytes the
reference's XLA-fused leaf update moves, where the eager chain of
:func:`adamw_update_plain` runs ~20 kernels a tensor, each with an fp32
temporary. The plain version is the same function in PyTorch, and the one
that CPU tensors take. Each parameter's step count is an int32 tensor on
the parameter's device, and the bias corrections are computed from it on
the device, so no step reads a value back to the host.

``torch.optim.AdamW`` is not substituted: it decays the parameter first
(``p *= 1 − lr·wd``) and then takes the Adam step — the same update in exact
arithmetic, but another order of fp32 operations — and it keeps fp32
moments. With ``moment_dtype=torch.float32`` this optimizer matches optax's
adamw to fp32 rounding.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from horovod_tpu_torch.ops import _build
from horovod_tpu_torch.ops import launches as _launches

# Kernel launches since the last reset_launch_counts(); only the CUDA branch
# counts, where the kernel is actually launched (a captured launch at each
# replay of its graph: ops/launches.py).
LAUNCHES = {"adamw": 0}

_KERNEL_DTYPES = (torch.float32, torch.bfloat16)
_PARAM_BF16, _MOMENT_BF16, _ALIGNED = 1, 2, 4  # csrc/adamw.cu's flags

_lib = None
_sms: dict[int, int] = {}


def reset_launch_counts() -> None:
    LAUNCHES["adamw"] = 0


def _kernels():
    global _lib
    if _lib is None:
        lib = _build.load("adamw")
        vp, ll, i, f = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                        ctypes.c_float)
        lib.hvd_adamw_chunk_elems.argtypes = []
        lib.hvd_adamw_chunk_elems.restype = ll
        lib.hvd_adamw_blocks_per_sm.argtypes = []
        lib.hvd_adamw_blocks_per_sm.restype = i
        lib.hvd_adamw.argtypes = [vp, vp, i, ll, i, f, f, f, f, f, f, vp, vp]
        lib.hvd_adamw.restype = i
        _lib = lib
    return _lib


def lr_tensor(lr, device) -> torch.Tensor:
    """The learning rate as the 0-d fp32 tensor on ``device`` that the
    update reads: ``lr`` itself when it is one, else a tensor filled with
    it on the device (a fill, never a copy from the host: under a CUDA
    graph the value is then fixed at capture)."""
    if isinstance(lr, torch.Tensor):
        if (lr.dtype != torch.float32 or lr.dim() != 0
                or lr.device != device):
            raise ValueError(
                f"adamw: the learning rate must be a 0-d float32 tensor on "
                f"{device}, got {lr.dtype} of shape {tuple(lr.shape)} on "
                f"{lr.device}.")
        return lr
    return torch.full((), float(lr), dtype=torch.float32, device=device)


def adamw_update_plain(params, grads, mus, nus, steps, *, lr,
                       b1: float, b2: float, eps: float,
                       weight_decay: float) -> None:
    """The plain version: the reference's update, tensor by tensor, in
    fp32, in place. ``steps`` are the parameters' int32 step counts (0-d),
    advanced by one here; ``lr`` is a 0-d fp32 tensor (or a float)."""
    lr = lr_tensor(lr, params[0].device) if params else lr
    for p, g, mu, nu, step in zip(params, grads, mus, nus, steps):
        step.add_(1)
        # Bias corrections in fp32 from the device count, as the reference
        # computes them (a scalar base: no copy from the host, no sync).
        count = step.float()
        c1 = 1.0 - torch.pow(b1, count)
        c2 = 1.0 - torch.pow(b2, count)
        gf = g.float()
        mf = b1 * mu.float() + (1.0 - b1) * gf
        vf = b2 * nu.float() + (1.0 - b2) * gf * gf
        upd = -lr * ((mf / c1) / ((vf / c2).sqrt() + eps)
                     + weight_decay * p.float())
        p.add_(upd.to(p.dtype))
        mu.copy_(mf.to(mu.dtype))
        nu.copy_(vf.to(nu.dtype))


def keep_lr_tensors(optimizer: torch.optim.Optimizer, load,
                    state_dict) -> None:
    """``load(state_dict)``, then each param group's tensor learning rate
    back in the tensor it had, holding the loaded value: torch's loader
    replaces a group's entries, and a captured step reads the old
    tensor."""
    before = [g["lr"] for g in optimizer.param_groups]
    load(state_dict)
    for group, lr in zip(optimizer.param_groups, before):
        if isinstance(lr, torch.Tensor):
            lr.fill_(float(group["lr"]))
            group["lr"] = lr


@dataclasses.dataclass
class A1Table:
    """A1's launch table for one parameter list: one record of 8 int64 a
    tensor (the addresses of p, g, m, v and the step count, the element
    count, the tensor's first chunk, dtype and alignment flags), one int32
    arrival counter a tensor, both on the card, and the chunks of all
    tensors. ``key`` is what it was built from; :func:`adamw_update`
    rebuilds it when that changes."""

    key: tuple
    records: torch.Tensor
    arrived: torch.Tensor
    chunks: int


def _table_key(params, grads, mus, nus, steps) -> tuple:
    return tuple((p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(),
                  s.data_ptr(), p.numel(), p.dtype, m.dtype)
                 for p, g, m, v, s in zip(params, grads, mus, nus, steps))


def _check_kernel_inputs(params, grads, mus, nus, steps) -> torch.device:
    dev = params[0].device
    if dev.type != "cuda":
        raise RuntimeError(
            f"adamw: no kernel for device {dev}; tensors on the CPU take the "
            f"plain version, others must be CUDA tensors.")
    for p, g, m, v, s in zip(params, grads, mus, nus, steps):
        for name, t in (("param", p), ("grad", g), ("exp_avg", m),
                        ("exp_avg_sq", v), ("step", s)):
            if t.device != dev:
                raise RuntimeError(
                    f"adamw: every tensor of a launch must be on {dev}; a "
                    f"{name} is on {t.device}.")
            if not t.is_contiguous():
                raise ValueError(
                    f"adamw: the kernel reads contiguous tensors; a {name} "
                    f"of shape {tuple(t.shape)} has strides {t.stride()}.")
        if p.dtype not in _KERNEL_DTYPES or m.dtype not in _KERNEL_DTYPES:
            raise TypeError(
                f"adamw: the kernel takes float32 or bfloat16 parameters and "
                f"moments, got {p.dtype} and {m.dtype}.")
        if g.dtype != p.dtype or v.dtype != m.dtype:
            raise TypeError(
                f"adamw: a gradient takes its parameter's dtype ({p.dtype}, "
                f"got {g.dtype}) and both moments one dtype ({m.dtype}, "
                f"{v.dtype}).")
        if not (g.numel() == m.numel() == v.numel() == p.numel()):
            raise ValueError("adamw: a parameter, its gradient and its "
                             "moments must have the same number of elements.")
        if s.dtype != torch.int32 or s.numel() != 1:
            raise TypeError(f"adamw: a step count is one int32, got "
                            f"{s.dtype} of {s.numel()} elements.")
    return dev


def build_table(params, grads, mus, nus, steps, key=None) -> A1Table:
    """A1's table for these tensors, on their device (``key``: their
    ``_table_key``, when the caller has it). Copies from the host, so it
    refuses to run while a CUDA graph is being captured: a captured update
    takes the table its program's first, eager call built."""
    dev = params[0].device
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            "adamw: A1's launch table must be rebuilt (a parameter, "
            "gradient or moment moved) while a CUDA graph is being "
            "captured; keep the gradients allocated between steps "
            "(zero_grad(set_to_none=False)) so the table of the program's "
            "first call holds.")
    chunk = _kernels().hvd_adamw_chunk_elems()
    records = []
    first = 0
    for p, g, m, v, s in zip(params, grads, mus, nus, steps):
        ptrs = (p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr())
        flags = ((_PARAM_BF16 if p.dtype == torch.bfloat16 else 0)
                 | (_MOMENT_BF16 if m.dtype == torch.bfloat16 else 0)
                 | (_ALIGNED if all(a % 16 == 0 for a in ptrs) else 0))
        n = p.numel()
        records.append([*ptrs, s.data_ptr(), n, first, flags])
        first += max(1, -(-n // chunk))
    return A1Table(
        key if key is not None else _table_key(params, grads, mus, nus,
                                               steps),
        torch.tensor(records, dtype=torch.int64).to(dev),
        torch.zeros(len(records), dtype=torch.int32, device=dev), first)


def launch(table: A1Table, *, lr, b1: float, b2: float, eps: float,
           weight_decay: float, chunks: int | None = None) -> None:
    """One launch of A1 over ``table`` (all its chunks unless ``chunks``
    says fewer), reading the learning rate from ``lr``, a 0-d fp32 tensor
    on the table's device (a float is filled into one first). Counts the
    launch."""
    lib = _kernels()
    dev = table.records.device
    if dev.index not in _sms:
        _sms[dev.index] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    n = table.chunks if chunks is None else chunks
    grid = min(n, _sms[dev.index] * lib.hvd_adamw_blocks_per_sm())
    with torch.cuda.device(dev):
        err = lib.hvd_adamw(
            table.records.data_ptr(), table.arrived.data_ptr(),
            table.records.shape[0], n, grid, b1, 1.0 - b1, b2, 1.0 - b2, eps,
            weight_decay, lr_tensor(lr, dev).data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"adamw: CUDA error {err} at kernel launch.")
    _launches.count(LAUNCHES, "adamw")


def adamw_update(params, grads, mus, nus, steps, *, lr, b1: float,
                 b2: float, eps: float, weight_decay: float,
                 table: A1Table | None = None) -> A1Table | None:
    """The AdamW update of a list of parameters, in place: one launch of A1
    on CUDA tensors, :func:`adamw_update_plain` on CPU tensors; any other
    device raises. ``lr``: a 0-d fp32 tensor on the parameters' device
    (read when the update runs) or a float. ``table`` is the launch table
    the previous call returned, used again while it matches these tensors;
    returns the table launched (None on the CPU)."""
    if not params:
        return None
    if all(p.device.type == "cpu" for p in params):
        adamw_update_plain(params, grads, mus, nus, steps, lr=lr, b1=b1,
                           b2=b2, eps=eps, weight_decay=weight_decay)
        return None
    _check_kernel_inputs(params, grads, mus, nus, steps)
    key = _table_key(params, grads, mus, nus, steps)
    if table is None or table.key != key:
        table = build_table(params, grads, mus, nus, steps, key)
    launch(table, lr=lr, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay)
    return table


class AdamW(torch.optim.Optimizer):
    """AdamW with ``moment_dtype`` moment storage (see the module
    docstring). ``lr`` is read from ``param_groups`` each step, so
    learning-rate callbacks drive it: a float, or a 0-d fp32 tensor on the
    parameters' device that the update reads on the device (what
    ``training.adam`` builds, and what a CUDA graph of the step needs to
    follow a schedule). Each parameter keeps its own step
    count (an int32 tensor on its device); parameters that step together
    keep the reference's one count. On the card a param group's update is
    one launch of A1."""

    def __init__(self, params, lr: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 1e-4,
                 moment_dtype: torch.dtype = torch.bfloat16) -> None:
        if lr < 0.0:
            raise ValueError(f"Invalid learning rate: {lr}")
        defaults = dict(lr=lr, b1=b1, b2=b2, eps=eps,
                        weight_decay=weight_decay, moment_dtype=moment_dtype)
        super().__init__(params, defaults)
        self._a1: dict[int, A1Table | None] = {}  # launch table per group

    def _update(self, params, grads, mus, nus, steps, group,
                table: A1Table | None) -> A1Table | None:
        return adamw_update(params, grads, mus, nus, steps, lr=group["lr"],
                            b1=group["b1"], b2=group["b2"], eps=group["eps"],
                            weight_decay=group["weight_decay"], table=table)

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for gi, group in enumerate(self.param_groups):
            mdt = group["moment_dtype"]
            cols: tuple[list, ...] = ([], [], [], [], [])
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                if not st:
                    st["step"] = torch.zeros((), dtype=torch.int32,
                                             device=p.device)
                    st["mu"] = torch.zeros(p.shape, dtype=mdt, device=p.device)
                    st["nu"] = torch.zeros(p.shape, dtype=mdt, device=p.device)
                for col, t in zip(cols, (p, p.grad, st["mu"], st["nu"],
                                         st["step"])):
                    col.append(t)
            self._a1[gi] = self._update(*cols, group, self._a1.get(gi))
        return loss

    def load_state_dict(self, state_dict) -> None:
        """``torch.optim.Optimizer.load_state_dict``, then the moments back
        to each group's ``moment_dtype`` and the step counts to int32 on
        the parameter's device (torch casts floating state to the
        parameter's dtype and leaves a step count where it was loaded),
        and a tensor learning rate back in its tensor
        (:func:`keep_lr_tensors`). bf16 → fp32 → bf16 is exact, so the
        moments are restored bit for bit."""
        keep_lr_tensors(self, super().load_state_dict, state_dict)
        for group in self.param_groups:
            for p in group["params"]:
                st = self.state.get(p)
                if not st:
                    continue
                for k in ("mu", "nu"):
                    st[k] = st[k].to(group["moment_dtype"])
                st["step"] = st["step"].to(dtype=torch.int32,
                                           device=p.device)

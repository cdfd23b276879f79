"""AdamW with moments stored in bf16 — the LM's optimizer.

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

``torch.optim.AdamW`` is not substituted: it decays the parameter first
(``p *= 1 − lr·wd``) and then takes the Adam step — the same update in exact
arithmetic, but another order of fp32 operations — and it keeps fp32
moments. With ``moment_dtype=torch.float32`` this optimizer matches optax's
adamw to fp32 rounding.
"""

from __future__ import annotations

import torch


class AdamW(torch.optim.Optimizer):
    """AdamW with ``moment_dtype`` moment storage (see the module
    docstring). ``lr`` is read from ``param_groups`` each step, so
    learning-rate callbacks drive it. Each parameter keeps its own step
    count; parameters that step together keep the reference's one count."""

    def __init__(self, params, lr: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 1e-4,
                 moment_dtype: torch.dtype = torch.bfloat16) -> None:
        if lr < 0.0:
            raise ValueError(f"Invalid learning rate: {lr}")
        defaults = dict(lr=lr, b1=b1, b2=b2, eps=eps,
                        weight_decay=weight_decay, moment_dtype=moment_dtype)
        super().__init__(params, defaults)

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            lr, b1, b2 = group["lr"], group["b1"], group["b2"]
            eps, wd = group["eps"], group["weight_decay"]
            mdt = group["moment_dtype"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                if not st:
                    st["step"] = 0
                    st["mu"] = torch.zeros(p.shape, dtype=mdt, device=p.device)
                    st["nu"] = torch.zeros(p.shape, dtype=mdt, device=p.device)
                st["step"] += 1
                # Bias corrections in fp32, as the reference computes them.
                count = torch.tensor(float(st["step"]), dtype=torch.float32)
                c1 = float(1.0 - torch.tensor(b1, dtype=torch.float32) ** count)
                c2 = float(1.0 - torch.tensor(b2, dtype=torch.float32) ** count)
                gf = p.grad.float()
                mf = b1 * st["mu"].float() + (1.0 - b1) * gf
                vf = b2 * st["nu"].float() + (1.0 - b2) * gf * gf
                upd = -lr * ((mf / c1) / ((vf / c2).sqrt() + eps)
                             + wd * p.float())
                p.add_(upd.to(p.dtype))
                st["mu"].copy_(mf.to(mdt))
                st["nu"].copy_(vf.to(mdt))
        return loss

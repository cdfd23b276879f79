"""The reference's first training steps, in float32 with TF32 off: the plain
model of the cell's family (``reference/<family>.py``), the plain
optimizer, the same weights and batches the program was given.

A data-parallel cell averages each rank's gradient with ``average`` (a
plain ``torch.distributed`` mean the benchmark passes in); the reference
imports nothing of the program.
"""

from __future__ import annotations

import importlib

import torch


class AdamW:
    """AdamW with bias-corrected moments and decoupled weight decay added to
    the update and scaled by the learning rate (optax's ``adamw``):
    ``p -= lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)``, every tensor
    decayed, moments in float32."""

    def __init__(self, params, lr: float, b1: float, b2: float, eps: float,
                 weight_decay: float) -> None:
        self.params = list(params)
        self.lr, self.b1, self.b2 = lr, b1, b2
        self.eps, self.wd = eps, weight_decay
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]
        self.t = 0

    @torch.no_grad()
    def step(self) -> None:
        self.t += 1
        c1 = 1.0 - self.b1 ** self.t
        c2 = 1.0 - self.b2 ** self.t
        for p, m, v in zip(self.params, self.m, self.v):
            g = p.grad
            m.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            upd = (m / c1) / ((v / c2).sqrt() + self.eps) + self.wd * p
            p.sub_(self.lr * upd)


def optimizer(spec: dict, params):
    kw = {k: v for k, v in spec.items() if k not in ("name", "moment_dtype")}
    return {"adamw": AdamW}[spec["name"]](params, **kw)


def run(cfg: dict, weights: dict, batches, steps: int = 3, cast=None,
        average=None) -> dict:
    """``steps`` steps of the reference from ``weights`` (fp32 tensors by
    state-dict name) on ``batches[0..steps-1]``. ``cast``: the products'
    operand rounding (None: float32); ``average``: a function that
    averages a list of gradients across the ranks in place (None: this
    rank's alone). Returns the losses (``losses``), the per-leaf norms of
    the first step's (averaged) gradient (``first``) and of the last
    step's (``late``), and the per-leaf norms of the parameters' change
    over the steps (``change``), in the order of ``named_parameters()``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    family = importlib.import_module(f"hvdbench.reference.{cfg['family']}")
    dev = next(iter(weights.values())).device
    with torch.device("meta"):
        model = family.build(cfg)
    model = model.to_empty(device=dev)
    model.load_state_dict(weights)
    params = [p for _, p in model.named_parameters()]
    start = [p.detach().clone() for p in params]
    opt = optimizer(cfg["optimizer"], params)
    kw = {} if cast is None else {"cast": cast}
    out = {"losses": []}
    for k in range(steps):
        for p in params:
            p.grad = None
        out["losses"].append(family.loss_and_grads(model, cfg, batches[k],
                                                   **kw))
        grads = [p.grad for p in params]
        if average is not None:
            average(grads)
        if k in (0, steps - 1):
            out["first" if k == 0 else "late"] = [float(g.norm())
                                                  for g in grads]
        opt.step()
    out["change"] = [float((p.detach() - s).norm())
                     for p, s in zip(params, start)]
    return out

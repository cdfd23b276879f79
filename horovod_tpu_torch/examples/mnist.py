"""MNIST CNN with a hand-written training loop — the reference's
``examples/mnist.py``: gradients averaged with ``allreduce_gradients``, the
initial weights broadcast from rank 0, rank-0-only checkpointing, a
different synthetic batch on every rank. The step is one ``hvd.spmd``
program (a CUDA graph on the card).

Run:  python -m horovod_tpu_torch.examples.mnist [--steps 100] [--device cpu]
"""

from __future__ import annotations

import argparse

import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch.models import mnist
from horovod_tpu_torch.ops.optim import lr_tensor
from horovod_tpu_torch.training import checkpoint


class _RMSprop(torch.optim.Optimizer):
    """``optax.rmsprop``'s update, which the reference calls:
    ``nu = decay·nu + (1 − decay)·g²`` from zeros, ``p −= lr·g/√(nu +
    eps)``. ``torch.optim.RMSprop`` decays by 0.99 and adds eps outside the
    square root: a different function. ``lr`` may be a 0-d device tensor."""

    def __init__(self, params, lr, decay: float = 0.9,
                 eps: float = 1e-8) -> None:
        super().__init__(params, dict(lr=lr, decay=decay, eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            grads = [p.grad for p in params]
            nus = []
            for p in params:
                st = self.state[p]
                if "nu" not in st:
                    st["nu"] = torch.zeros_like(p)
                nus.append(st["nu"])
            decay = group["decay"]
            torch._foreach_mul_(nus, decay)
            torch._foreach_addcmul_(nus, grads, grads, value=1 - decay)
            upd = torch._foreach_add(nus, group["eps"])
            torch._foreach_sqrt_(upd)
            upd = torch._foreach_div(grads, upd)
            torch._foreach_add_(params, torch._foreach_mul(upd, -group["lr"]))
        return loss


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=100)
    parser.add_argument("--batch-size", type=int, default=64)
    parser.add_argument("--lr", type=float, default=0.001)
    parser.add_argument("--checkpoint-dir", default=None)
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = parser.parse_args(argv)

    hvd.init(device=args.device)
    dev = hvd.device()

    model = mnist.ConvModel(
        generator=torch.Generator().manual_seed(0)).to(dev)
    loss_fn = mnist.make_loss_fn(model)
    params = list(model.parameters())
    # LR scaled by world size (the reference examples' large-batch
    # convention).
    opt = _RMSprop(params, lr=lr_tensor(args.lr * hvd.size(), dev))

    def train_step(batch):
        opt.zero_grad(set_to_none=False)
        loss = loss_fn(model, batch)
        loss.backward()
        hvd.allreduce_gradients([p.grad for p in params])
        opt.step()
        return hvd.allreduce(loss.detach(), name="mnist.loss")

    step = hvd.spmd(train_step)
    # Initial weight sync from rank 0 (BroadcastGlobalVariablesHook).
    hvd.broadcast_global_variables(model, root_rank=0)

    losses = []
    for it in range(args.steps):
        # Each rank gets a different shard of the stream (seeded per rank
        # and step).
        batch = mnist.synthetic_mnist(args.batch_size,
                                      seed=1000 * it + hvd.rank(), device=dev)
        loss = step(batch)
        losses.append(loss)
        if it % 10 == 0 and hvd.rank() == 0:
            print(f"step {it}: loss = {float(loss):.4f}")

    # The rank-0-writes checkpoint convention.
    if args.checkpoint_dir and hvd.rank() == 0:
        checkpoint.save(args.checkpoint_dir,
                        {"model": model.state_dict(),
                         "optimizer": opt.state_dict()}, epoch=0)
    losses = [float(v) for v in losses]
    if hvd.rank() == 0:
        print(f"final loss: {losses[-1]:.4f}")
    return {"losses": losses, "runs": step.runs, "replays": step.replays}


if __name__ == "__main__":
    main()

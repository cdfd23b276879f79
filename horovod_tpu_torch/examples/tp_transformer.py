"""Tensor-parallel transformer training, DP × TP — the reference's
``examples/tp_transformer.py``. The world is partitioned twice: TP pairs
shard every attention head and MLP matrix (Megatron-style, one collective
a block a direction), DP families average the sharded parameters'
gradients, and the world group averages the replicated ones (the
embedding and the head).

Topology on 8 ranks: 4 TP pairs × 4 DP replicas (the reference's groups).
Each rank is a process holding its own shards (``hvd.shard_columns``/
``shard_rows`` return this rank's). On one GPU, run it over gloo on the
CPU:

    python -c "from horovod_tpu_torch.run import run; \\
        from horovod_tpu_torch.examples import tp_transformer as m; \\
        run(m.main, 8, device='cpu', args=(['--device', 'cpu'],))"

With another number of ranks it says so and returns.

:func:`loss_fn` and :func:`train_step` are the example's arithmetic, for
any TP and DP family (a world of one rank: ``hvd.init([[0], [0], [0]])``,
``tp_family=(1,)``, ``dp_family=(2,)``); :func:`from_jax_params` carries
the reference example's arrays into the port's tensors.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

import horovod_tpu_torch as hvd
from horovod_tpu_torch import training

TP_GROUPS = [[0, 1], [2, 3], [4, 5], [6, 7]]
DP_GROUPS = [[0, 2, 4, 6], [1, 3, 5, 7]]
TP_FAMILY = (1, 2, 3, 4)
DP_FAMILY = (5, 6)
REPLICATED = ("embed", "out")
SHARDED = {"wq": "columns", "wk": "columns", "wv": "columns",
           "wo": "rows", "w1": "columns", "w2": "rows"}


def _world() -> int:
    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def init_params(vocab: int, e: int, f: int, seed: int = 0, device="cpu",
                dtype=torch.float32) -> dict:
    """The full (unsharded) parameters, drawn as the reference draws them:
    N(0, 0.02²) each, from a seeded ``torch.Generator``."""
    g = torch.Generator().manual_seed(seed)
    shapes = {"embed": (vocab, e), "out": (e, vocab), "wq": (e, e),
              "wk": (e, e), "wv": (e, e), "wo": (e, e), "w1": (e, f),
              "w2": (f, e)}
    return {k: (torch.randn(s, generator=g) * 0.02).to(device, dtype)
            for k, s in shapes.items()}


def from_jax_params(params: dict, device="cpu",
                    dtype=torch.float32) -> dict:
    """The reference example's arrays (as numpy: ``embed``, ``out`` and the
    full ``wq``/``wk``/``wv``/``wo``/``w1``/``w2``) as the port's
    tensors."""
    return {k: torch.tensor(np.asarray(v), dtype=dtype, device=device)
            for k, v in params.items()}


def split(full: dict, tp_family) -> tuple[dict, dict]:
    """(replicated, this rank's shards) of the full parameters, as leaf
    tensors that take gradients."""
    rep = {k: full[k].clone().requires_grad_(True) for k in REPLICATED}
    shd = {k: (hvd.shard_columns if how == "columns" else hvd.shard_rows)(
        full[k], tp_family).clone().requires_grad_(True)
        for k, how in SHARDED.items()}
    return rep, shd


def loss_fn(rep: dict, shd: dict, tokens, num_heads: int,
            tp_family=TP_FAMILY):
    """The reference example's loss: embed, one TP attention block and one
    TP MLP block with residuals, the head, next-token cross-entropy."""
    x = rep["embed"][tokens]                               # (B, T, E)
    x = x + hvd.tp_attention(x, shd["wq"], shd["wk"], shd["wv"], shd["wo"],
                             tp_family, num_heads=num_heads, causal=True,
                             name="attn")
    x = x + hvd.tp_mlp(x, shd["w1"], None, shd["w2"], None, tp_family,
                       name="mlp")
    logits = x @ rep["out"]
    v = logits.shape[-1]
    return F.cross_entropy(logits[:, :-1].float().reshape(-1, v),
                           tokens[:, 1:].reshape(-1))


def train_step(rep: dict, shd: dict, opt, num_heads: int,
               tp_family=TP_FAMILY, dp_family=DP_FAMILY):
    """``step(tokens) -> loss`` averaged over the world: the replicated
    parameters' gradients averaged over the world, the shards' over the DP
    family (the ranks holding the same shard), then ``opt``."""
    def step(tokens):
        opt.zero_grad(set_to_none=False)
        loss = loss_fn(rep, shd, tokens, num_heads, tp_family)
        loss.backward()
        hvd.allreduce_gradients([p.grad for p in rep.values()])
        hvd.allreduce_gradients([p.grad for p in shd.values()],
                                group=dp_family)
        opt.step()
        return hvd.allreduce(loss.detach(), name="tp_transformer.loss")

    return step


def main(argv=None) -> dict | None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=10)
    parser.add_argument("--seq-len", type=int, default=32)
    parser.add_argument("--batch-size", type=int, default=2)
    parser.add_argument("--embed-dim", type=int, default=64)
    parser.add_argument("--mlp-dim", type=int, default=128)
    parser.add_argument("--num-heads", type=int, default=4)
    parser.add_argument("--vocab-size", type=int, default=128)
    parser.add_argument("--lr", type=float, default=1e-2)
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = parser.parse_args(argv)

    n = _world()
    if n != 8:
        print(f"needs 8 ranks as 4 TP pairs x 4 DP replicas (have {n}); "
              f"try horovod_tpu_torch.run.run(main, 8, device='cpu', "
              f"args=(['--device', 'cpu'],))")
        return None
    hvd.init(TP_GROUPS + DP_GROUPS, device=args.device)
    dev = hvd.device()
    full = init_params(args.vocab_size, args.embed_dim, args.mlp_dim,
                       device=dev)
    rep, shd = split(full, TP_FAMILY)
    opt = training.adam(args.lr)(list(rep.values()) + list(shd.values()))
    step = hvd.spmd(train_step(rep, shd, opt, args.num_heads))

    rng = np.random.RandomState(0)
    # Each TP pair (= DP replica) sees its own batch; both pair members
    # see the same tokens (activations are replicated within a pair).
    per_pair = [rng.randint(0, args.vocab_size,
                            (args.batch_size, args.seq_len))
                for _ in range(n // 2)]
    tokens = torch.from_numpy(per_pair[hvd.rank() // 2]).to(dev)

    losses = []
    for i in range(args.steps):
        losses.append(float(step(tokens)))
        if i % 2 == 0 and hvd.rank() == 0:
            print(f"step {i}: loss = {losses[-1]:.4f} (4x 2-way TP, "
                  f"4-way DP)")
    first, last = losses[0], losses[-1]
    assert last < first, (first, last)
    if hvd.rank() == 0:
        print(f"TP transformer trained: {first:.4f} -> {last:.4f}")
    return {"losses": losses, "runs": step.runs, "replays": step.replays}


if __name__ == "__main__":
    main()

"""Mixture-of-Experts transformer training, expert parallelism end to end —
the reference's ``examples/moe_transformer.py``. One expert a rank:
attention and the embeddings are ordinary data-parallel parameters
(replicated, their gradients averaged over the world); the MLP is
``hvd.moe_mlp``, whose expert weights are per-rank parameters. The
all-to-all's transpose routes each expert's cotangents back to its owner,
so the expert gradients stay out of the allreduce and the experts
specialise.

    python -m horovod_tpu_torch.examples.moe_transformer [--device cpu]

runs one expert at one rank; on more ranks, e.g. over gloo on the CPU:

    python -c "from horovod_tpu_torch.run import run; \\
        from horovod_tpu_torch.examples import moe_transformer as m; \\
        run(m.main, 8, device='cpu', args=(['--device', 'cpu'],))"

:func:`loss_fn` and :func:`train_step` are the example's arithmetic;
:func:`from_jax_params` carries the reference example's arrays (its
replicated tree and this rank's row of its expert stack) into the port's
tensors.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.nn.functional as F

import horovod_tpu_torch as hvd
from horovod_tpu_torch import training
from horovod_tpu_torch.parallel.sequence import local_attention

REPLICATED = ("embed", "wq", "wk", "wv", "wo", "gate", "out")
EXPERT = ("w1", "b1", "w2", "b2")


def init_params(vocab: int, e_dim: int, f_dim: int, n_experts: int,
                expert: int, seed: int = 0, device="cpu",
                dtype=torch.float32) -> tuple[dict, dict]:
    """(replicated, this rank's expert), drawn as the reference draws them:
    N(0, 0.02²) weights, zero expert biases; the replicated ones from a
    ``torch.Generator`` seeded with ``seed``, expert ``expert``'s from one
    seeded with ``(seed, expert)`` (each expert its own draw)."""
    g = torch.Generator().manual_seed(seed)

    def normal(shape, gen):
        return (torch.randn(shape, generator=gen) * 0.02).to(device, dtype)

    shapes = {"embed": (vocab, e_dim), "wq": (e_dim, e_dim),
              "wk": (e_dim, e_dim), "wv": (e_dim, e_dim),
              "wo": (e_dim, e_dim), "gate": (e_dim, n_experts),
              "out": (e_dim, vocab)}
    rep = {k: normal(s, g) for k, s in shapes.items()}
    ge = torch.Generator().manual_seed(seed * 1_000_003 + 1 + expert)
    exp = {"w1": normal((e_dim, f_dim), ge),
           "b1": torch.zeros(f_dim, device=device, dtype=dtype),
           "w2": normal((f_dim, e_dim), ge),
           "b2": torch.zeros(e_dim, device=device, dtype=dtype)}
    return rep, exp


def from_jax_params(replicated: dict, experts: dict, expert: int,
                    device="cpu", dtype=torch.float32) -> tuple[dict, dict]:
    """The reference example's ``(replicated, experts)`` arrays (as numpy;
    ``experts`` stacked over the ranks) as the port's tensors: the
    replicated tree and row ``expert`` of the stack."""
    def t(a):
        return torch.tensor(np.asarray(a), dtype=dtype, device=device)

    return ({k: t(v) for k, v in replicated.items()},
            {k: t(np.asarray(v)[expert]) for k, v in experts.items()})


def forward(rep: dict, exp: dict, tokens, num_heads: int):
    """(logits, aux): embed, a replicated attention block (B3/B4 on a CUDA
    tensor above 2048 tokens), the MoE block over the world's experts."""
    b, t = tokens.shape
    x = rep["embed"][tokens]                           # (B, T, E)
    d_head = x.shape[-1] // num_heads

    def qkv(w):
        return (x @ w).reshape(b, t, num_heads, d_head)

    attn = local_attention(qkv(rep["wq"]), qkv(rep["wk"]), qkv(rep["wv"]),
                           causal=True, impl="auto")
    x = x + attn.reshape(b, t, -1) @ rep["wo"]
    moe_out, aux = hvd.moe_mlp(x, rep["gate"], exp["w1"], exp["b1"],
                               exp["w2"], exp["b2"])
    x = x + moe_out
    return x @ rep["out"], aux


def loss_fn(rep: dict, exp: dict, tokens, num_heads: int,
            aux_weight: float = 0.01):
    """Next-token cross-entropy plus ``aux_weight`` × the load-balancing
    loss."""
    logits, aux = forward(rep, exp, tokens, num_heads)
    v = logits.shape[-1]
    loss = F.cross_entropy(logits[:, :-1].float().reshape(-1, v),
                           tokens[:, 1:].reshape(-1))
    return loss + aux_weight * aux


def train_step(rep: dict, exp: dict, opt, num_heads: int,
               aux_weight: float = 0.01):
    """``step(tokens) -> loss`` averaged over the world: the replicated
    parameters' gradients averaged over the world, the expert's kept on
    its owner, then ``opt``."""
    def step(tokens):
        opt.zero_grad(set_to_none=False)
        loss = loss_fn(rep, exp, tokens, num_heads, aux_weight)
        loss.backward()
        hvd.allreduce_gradients([p.grad for p in rep.values()])
        opt.step()
        return hvd.allreduce(loss.detach(), name="moe_transformer.loss")

    return step


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=10)
    parser.add_argument("--seq-len", type=int, default=64)
    parser.add_argument("--batch-size", type=int, default=2)
    parser.add_argument("--embed-dim", type=int, default=64)
    parser.add_argument("--mlp-dim", type=int, default=128)
    parser.add_argument("--num-heads", type=int, default=4)
    parser.add_argument("--vocab-size", type=int, default=256)
    parser.add_argument("--aux-weight", type=float, default=0.01)
    parser.add_argument("--lr", type=float, default=1e-2)
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = parser.parse_args(argv)

    hvd.init(device=args.device)
    n = hvd.size()
    dev = hvd.device()
    rep, exp = init_params(args.vocab_size, args.embed_dim, args.mlp_dim,
                           n, hvd.rank(), device=dev)
    params = list(rep.values()) + list(exp.values())
    for p in params:
        p.requires_grad_(True)
    opt = training.adam(args.lr)(params)
    step = hvd.spmd(train_step(rep, exp, opt, args.num_heads,
                               args.aux_weight))

    rng = np.random.RandomState(0)
    tokens = rng.randint(0, args.vocab_size,
                         (n, args.batch_size, args.seq_len))
    tokens = torch.from_numpy(tokens[hvd.rank()]).to(dev)

    losses = []
    for i in range(args.steps):
        losses.append(float(step(tokens)))
        if i % 2 == 0 and hvd.rank() == 0:
            print(f"step {i}: loss = {losses[-1]:.4f} ({n} experts over "
                  f"alltoall)")
    first, last = losses[0], losses[-1]
    assert last < first, (first, last)
    if hvd.rank() == 0:
        print(f"MoE transformer trained: {first:.4f} -> {last:.4f}")
    return {"losses": losses, "runs": step.runs, "replays": step.replays}


if __name__ == "__main__":
    main()

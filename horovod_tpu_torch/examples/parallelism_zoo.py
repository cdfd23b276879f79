"""Every parallelism mode on one world — the reference's
``examples/parallelism_zoo.py``: a tiny example of each mode (data,
tensor, pipeline, sequence and expert parallelism), one ``hvd.init``/
``hvd.shutdown`` cycle a mode, one line a mode.

    python -m horovod_tpu_torch.examples.parallelism_zoo [--device cpu]

The tensor-parallel mode needs the reference's 8-rank topology; at another
world size it is skipped and says so. Over gloo on the CPU:

    python -c "from horovod_tpu_torch.run import run; \\
        from horovod_tpu_torch.examples import parallelism_zoo as m; \\
        run(m.main, 8, device='cpu', args=(['--device', 'cpu'],))"

The sequence-parallel mode's head dim (8) is below the flash kernels'
smallest (16), so its ring runs the blockwise body on every device.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch
import torch.distributed as dist

import horovod_tpu_torch as hvd

TP_WORLD = 8


def _say(line: str) -> str:
    if hvd.rank() == 0:
        print(line)
    return line


def data_parallel(device) -> str:
    hvd.init(device=device)
    n = hvd.size()
    dev = hvd.device()

    @hvd.spmd
    def step(w, x):
        w = w.clone().requires_grad_(True)
        loss = ((x @ w) ** 2).mean()
        (g,) = torch.autograd.grad(loss, w)
        return hvd.allreduce(loss.detach()), hvd.allreduce_gradients([g])[0]

    w = torch.ones((4, 2), device=dev)
    x = torch.full((3, 4), float(hvd.rank()), device=dev)
    loss, _ = step(w, x)
    line = _say(f"DP : {n}-way data parallel, fused gradient allreduce, "
                f"loss {float(loss):.3f}")
    hvd.shutdown()
    return line


def tensor_parallel(device) -> str:
    hvd.init([[0, 1], [2, 3], [4, 5], [6, 7], [0, 2, 4, 6], [1, 3, 5, 7]],
             device=device)
    tp_family, dp_family = (1, 2, 3, 4), (5, 6)
    dev = hvd.device()
    rng = np.random.RandomState(0)
    w1 = torch.from_numpy(rng.randn(8, 16).astype(np.float32)).to(dev)
    w2 = torch.from_numpy(rng.randn(16, 8).astype(np.float32)).to(dev)
    x = torch.from_numpy(rng.randn(4, 8).astype(np.float32)).to(dev)

    @hvd.spmd
    def f(xs, w1s, w2s):
        y = hvd.tp_mlp(xs, w1s, None, w2s, None, tp_family, act=torch.relu)
        w1g = w1s.clone().requires_grad_(True)
        (g,) = torch.autograd.grad((hvd.tp_mlp(
            xs, w1g, None, w2s, None, tp_family) ** 2).sum(), w1g)
        return y, hvd.allreduce(g, group=dp_family)

    y, _ = f(x, hvd.shard_columns(w1, tp_family),
             hvd.shard_rows(w2, tp_family))
    dense = torch.relu(x @ w1) @ w2
    err = float((y - dense).abs().max())
    line = _say(f"TP : 4x 2-way Megatron MLP, DP-family grad sync, "
                f"max err vs dense {err:.2e}")
    hvd.shutdown()
    return line


def pipeline_parallel(device) -> str:
    hvd.init(device=device)
    n = hvd.size()
    dev = hvd.device()
    rng = np.random.RandomState(1)
    stages = [{"w": torch.from_numpy(rng.randn(6, 6).astype(np.float32)
                                     * 0.5).to(dev)} for _ in range(n)]
    params = hvd.stage_split(stages)
    mbs = torch.from_numpy(rng.randn(4, 2, 6).astype(np.float32)).to(dev)

    @hvd.spmd
    def f(params, mbs):
        return hvd.gpipe(lambda p, x: torch.tanh(x @ p["w"]), params, mbs)

    out = f(params, mbs)
    seq = mbs
    for p in stages:
        seq = torch.tanh(seq @ p["w"])
    err = float((out - seq).abs().max()) if hvd.rank() == n - 1 else 0.0
    err = float(hvd.allreduce(torch.tensor(err, device=dev),
                              average=False))
    line = _say(f"PP : {n}-stage GPipe over the mesh ring, "
                f"max err vs sequential {err:.2e}")
    hvd.shutdown()
    return line


def sequence_parallel(device) -> str:
    hvd.init(device=device)
    n = hvd.size()
    dev = hvd.device()
    rng = np.random.RandomState(2)
    t_total = 8 * n
    q, k, v = (torch.from_numpy(rng.randn(1, t_total, 2, 8).astype(
        np.float32)).to(dev) for _ in range(3))

    @hvd.spmd
    def f(qs, ks, vs):
        return hvd.ring_attention(qs, ks, vs, causal=True, impl="blockwise")

    def shard(x):
        return x.chunk(n, dim=1)[hvd.rank()].contiguous()

    out = f(shard(q), shard(k), shard(v))
    line = _say(f"SP : ring attention over {n} sequence shards "
                f"(context {t_total} tokens), output {tuple(out.shape)}")
    hvd.shutdown()
    return line


def expert_parallel(device) -> str:
    hvd.init(device=device)
    n = hvd.size()
    dev = hvd.device()
    rng = np.random.RandomState(3)

    def arr(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dev)

    gate_w = arr(8, n)
    w1 = arr(n, 8, 16)[hvd.rank()]
    b1 = torch.zeros(16, device=dev)
    w2 = arr(n, 16, 8)[hvd.rank()]
    b2 = torch.zeros(8, device=dev)
    toks = arr(n, 1, 6, 8)[hvd.rank()]

    @hvd.spmd
    def f(toks, w1, b1, w2, b2):
        out, aux = hvd.moe_mlp(toks, gate_w, w1, b1, w2, b2)
        return out, hvd.allreduce(aux.detach())

    _, aux = f(toks, w1, b1, w2, b2)
    line = _say(f"EP : {n} experts, top-1 routing over alltoall, "
                f"aux loss {float(aux):.3f}")
    hvd.shutdown()
    return line


def _world_and_rank() -> tuple[int, int]:
    if dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return (int(os.environ.get("WORLD_SIZE", "1")),
            int(os.environ.get("RANK", "0")))


MODES = {"DP": data_parallel, "TP": tensor_parallel,
         "PP": pipeline_parallel, "SP": sequence_parallel,
         "EP": expert_parallel}


def main(argv=None) -> dict:
    """Runs every mode the world can form; returns each mode's line, and
    ``"skipped"`` for a mode it cannot (TP off 8 ranks)."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = parser.parse_args(argv)
    world, rank = _world_and_rank()
    out = {}
    for mode, fn in MODES.items():
        out[mode] = ("skipped" if mode == "TP" and world != TP_WORLD
                     else fn(args.device))
    skipped = [m for m, line in out.items() if line == "skipped"]
    if rank == 0:
        print("all parallelism modes OK" if not skipped else
              f"parallelism modes OK; skipped {skipped} (the TP mode needs "
              f"{TP_WORLD} ranks)")
    return out


if __name__ == "__main__":
    main()

"""Long-context Transformer training with DP × SP groups — the reference's
``examples/long_context_transformer.py``: the custom group API doubles as
the context-parallel topology. ``n`` ranks = ``n // s`` DP × ``s`` SP with
``s = max(2, n // 2)`` (4 ranks: 2 × 2); groups 1, 2, ... are the
sequence-parallel rings, and the gradients are averaged over the global
group.

Each rank is a process holding one shard of its replica's sequence, and
builds its model with its own SP group as ``sp_group`` under ``--attention
ring`` (the ring's hops are point-to-point, outside the program's
schedule). Under ``--attention ulysses`` the model's ``sp_group`` is the
family of all the SP groups: its all-to-alls are registered collectives,
which every rank of the program must name alike, and over a family each
rank exchanges within its own group (the reference's program holds every
group's exchange instead, each device keeping its own group's result).

It needs an even number of ranks, at least 2, one process each; on one
GPU, run it over gloo on the CPU:

    python -c "from horovod_tpu_torch.run import run; \\
        from horovod_tpu_torch.examples import long_context_transformer \\
        as m; run(m.main, 4, device='cpu', args=(['--device', 'cpu'],))"

With fewer ranks it says so and returns.
"""

from __future__ import annotations

import argparse
import os
import zlib

import numpy as np
import torch
import torch.distributed as dist

import horovod_tpu_torch as hvd
from horovod_tpu_torch import training
from horovod_tpu_torch.models import transformer


def _world() -> int:
    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def main(argv=None) -> dict | None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=10)
    parser.add_argument("--seq-len", type=int, default=512,
                        help="GLOBAL sequence length (sharded over SP ranks)")
    parser.add_argument("--batch-size", type=int, default=2)
    parser.add_argument("--num-layers", type=int, default=2)
    parser.add_argument("--embed-dim", type=int, default=256)
    parser.add_argument("--num-heads", type=int, default=8)
    parser.add_argument("--attention", choices=["ring", "ulysses"],
                        default="ring")
    parser.add_argument("--repeat-batch", action="store_true",
                        help="train on the first batch at every step (a "
                             "short run then shows the loss falling; the "
                             "default draws a fresh random batch a step)")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = parser.parse_args(argv)

    n = _world()
    if n < 2 or n % 2 != 0:
        print(f"needs an even device count >= 2 (have {n}); try "
              f"horovod_tpu_torch.run.run(main, 4, device='cpu', "
              f"args=(['--device', 'cpu'],))")
        return None
    sp_ways = max(2, n // 2)
    dp_ways = n // sp_ways
    sp_groups = [list(range(d * sp_ways, (d + 1) * sp_ways))
                 for d in range(dp_ways)]
    hvd.init(sp_groups, device=args.device)
    dev = hvd.device()
    if hvd.rank() == 0:
        print(f"{n} devices as {dp_ways}-way DP x {sp_ways}-way SP; "
              f"groups: {sp_groups}")

    t_local = args.seq_len // sp_ways
    replica = hvd.rank() // sp_ways
    own = replica + 1
    sp_group = (own if args.attention == "ring"
                else tuple(range(1, dp_ways + 1)))
    cfg = transformer.TransformerConfig(
        vocab_size=1024, num_layers=args.num_layers,
        num_heads=args.num_heads, embed_dim=args.embed_dim,
        mlp_dim=args.embed_dim * 4, max_seq_len=args.seq_len,
        dtype=torch.bfloat16, attention=args.attention, sp_group=sp_group)
    # Seed 0 on every rank: the replicas start equal.
    model = transformer.init_params(cfg, device=dev)
    loss_fn = transformer.make_loss_fn(cfg, sp_rank=lambda: hvd.rank(own))
    opt = hvd.DistributedOptimizer(training.adam(3e-4)(model.parameters()))

    @hvd.spmd
    def step(shard):
        opt.zero_grad(set_to_none=False)
        loss = loss_fn(model, shard)
        loss.backward()
        opt.step()          # gradients averaged over group 0: DP × SP
        return hvd.allreduce(loss.detach(), name="long_context.loss")

    rng = np.random.RandomState(0)
    sp_rank = hvd.rank(own)
    losses = []
    for it in range(args.steps):
        if args.repeat_batch:
            rng = np.random.RandomState(0)
        # Every rank draws every replica's stream and keeps its own shard.
        streams = [rng.randint(0, 1024, (args.batch_size, args.seq_len))
                   for _ in range(dp_ways)]
        shard = streams[replica][:, sp_rank * t_local:
                                 (sp_rank + 1) * t_local]
        losses.append(step(torch.from_numpy(shard).to(dev)))
        if it % 2 == 0 and hvd.rank() == 0:
            print(f"step {it}: loss = {float(losses[-1]):.4f} "
                  f"(ctx {args.seq_len} over {sp_ways} chips)")
    flat = torch.cat([p.detach().float().reshape(-1).cpu()
                      for p in model.parameters()])
    return {"losses": [float(v) for v in losses], "runs": step.runs,
            "replays": step.replays,
            "params_crc": zlib.crc32(flat.numpy().tobytes())}


if __name__ == "__main__":
    main()

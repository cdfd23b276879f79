"""Embedding-bag recommender tower with the sparse gradient exchange — the
JAX package's ``examples/embedding_bag.py``: a large id table looked up by
Zipf-hot bags, mean-pooled into a small classifier head. The table's
gradient is an ``hvd.IndexedSlices``; ``hvd.allreduce_gradients`` exchanges
it through the padded gather with dedup-and-merge (``--sparse-algo
gather``), densify + allreduce (``dense``) or the density switch
(``auto``), and the head's gradients through the fused dense buckets;
``--compression`` quantizes the sparse value payload (gather form) and the
dense buckets. The step is one ``hvd.spmd`` program (a CUDA graph on the
card). Rank 0 closes with the exchange plan's hash and its sparse row
(``ops/exchange.py``).

Run:  python -m horovod_tpu_torch.examples.embedding_bag [--steps 100]
          [--sparse-algo dense] [--device cpu]
"""

from __future__ import annotations

import argparse

import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch.models import embedding_bag
from horovod_tpu_torch.ops import exchange as hvd_exchange


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=100)
    parser.add_argument("--batch-size", type=int, default=64)
    parser.add_argument("--num-embeddings", type=int, default=60_000)
    parser.add_argument("--embedding-dim", type=int, default=32)
    parser.add_argument("--bag-size", type=int, default=8)
    parser.add_argument("--classes", type=int, default=2)
    parser.add_argument("--lr", type=float, default=0.5)
    parser.add_argument("--sparse-algo", default="gather",
                        choices=["gather", "dense", "auto"],
                        help="sparse exchange (ops/sparse.py)")
    parser.add_argument("--compression", default="none",
                        choices=["none", "bf16", "int8", "int8_block",
                                 "int4"],
                        help="wire format of the exchange "
                             "(ops/compression.py)")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = parser.parse_args(argv)
    comp = None if args.compression == "none" else args.compression

    hvd.init(device=args.device)
    dev = hvd.device()
    cfg = embedding_bag.EmbeddingBagConfig(
        num_embeddings=args.num_embeddings,
        embedding_dim=args.embedding_dim,
        bag_size=args.bag_size, num_classes=args.classes)
    model = embedding_bag.EmbeddingBag(
        cfg, generator=torch.Generator().manual_seed(0)).to(dev)

    def train_step(bags, labels):
        loss, grads = embedding_bag.value_and_sparse_grad(model, bags,
                                                          labels)
        keys = list(grads)
        synced = hvd.allreduce_gradients([grads[k] for k in keys],
                                         name="embedding_bag.grads",
                                         sparse_algo=args.sparse_algo,
                                         compression=comp)
        embedding_bag.apply_sgd(model, dict(zip(keys, synced)), lr=args.lr)
        return hvd.allreduce(loss, name="embedding_bag.loss")

    step = hvd.spmd(train_step)
    hvd.broadcast_global_variables(model, root_rank=0)

    losses = []
    for it in range(args.steps):
        # This rank's batch: the reference's per-rank seed.
        bags, labels = embedding_bag.synthetic_batch(
            cfg, args.batch_size, seed=1000 * it + hvd.rank())
        losses.append(step(torch.from_numpy(bags).to(dev),
                           torch.from_numpy(labels).to(dev)))
        if it % 20 == 0 and hvd.rank() == 0:
            print(f"step {it}: loss = {float(losses[-1]):.4f}")
    losses = [float(v) for v in losses]
    plan = hvd_exchange.last_plan()
    if hvd.rank() == 0:
        print(f"final loss {losses[-1]:.4f} (from {losses[0]:.4f})")
        if plan is not None and plan.sparse_buckets:
            row = plan.sparse_buckets[0]
            ratio = (hvd.size() * row.payload_wire_bytes
                     / max(1, 2 * row.dense_bytes))
            print(f"exchange plan {plan.plan_hash()}: {row.describe()}, "
                  f"sparse-vs-dense wire ratio {ratio:.4f}")
    return {"losses": losses, "runs": step.runs, "replays": step.replays,
            "model": model, "plan": plan}


if __name__ == "__main__":
    main()

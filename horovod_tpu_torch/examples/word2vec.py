"""Skip-gram word2vec with the sparse gradient exchange — the reference's
``examples/tensorflow_word2vec.py`` as the JAX package's
``examples/word2vec.py`` runs it: the embedding lookups give IndexedSlices
gradients, which ``hvd.allreduce_gradients`` exchanges by allgather with
dedup-and-merge instead of a dense allreduce, and SGD applies them by
scatter-add. The step is one ``hvd.spmd`` program (a CUDA graph on the
card).

Trains on text8 when ``text8.zip`` is in ``--data-dir`` /
``$HOROVOD_DATA_DIR`` (the port never downloads it) and falls back to the
reference's synthetic Zipf corpus otherwise, or with ``--synthetic``. Each
rank reads its own window of the corpus and keeps its own draw of the
negative samples, drawn in the reference's rank order, so stacked over the
ranks the batches are the reference's.

Run:  python -m horovod_tpu_torch.examples.word2vec [--steps 200]
          [--data-dir DIR] [--synthetic] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch.models import word2vec
from horovod_tpu_torch.training import data as hvd_data


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=200)
    parser.add_argument("--batch-size", type=int, default=128)
    parser.add_argument("--vocab-size", type=int, default=5000)
    parser.add_argument("--embedding-dim", type=int, default=128)
    parser.add_argument("--num-sampled", type=int, default=64)
    parser.add_argument("--skip-window", type=int, default=1)
    parser.add_argument("--num-skips", type=int, default=2)
    parser.add_argument("--lr", type=float, default=1.0)
    parser.add_argument("--data-dir", default=None,
                        help="Directory with text8.zip.")
    parser.add_argument("--max-words", type=int, default=2_000_000,
                        help="Cap on corpus words read from text8.")
    parser.add_argument("--synthetic", action="store_true",
                        help="Skip real data (the CI/offline path).")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return parser.parse_args(argv)


def setup(args: argparse.Namespace):
    """``(model, train_step, batches)`` on ``hvd.device()``: the seeded
    model, the uncaptured step function and this rank's endless batches
    ``(centers, contexts, negatives)``. Needs ``hvd.init``."""
    dev = hvd.device()
    cfg = word2vec.Word2VecConfig(args.vocab_size, args.embedding_dim,
                                  args.num_sampled)
    model = word2vec.Word2Vec(
        cfg, generator=torch.Generator().manual_seed(0)).to(dev)

    def train_step(centers, contexts, negs):
        loss, grads = word2vec.value_and_sparse_grad(model, centers,
                                                     contexts, negs)
        keys = list(grads)
        synced = hvd.allreduce_gradients([grads[k] for k in keys],
                                         name="word2vec.grads")
        word2vec.apply_sparse_sgd(model, dict(zip(keys, synced)), lr=args.lr)
        return hvd.allreduce(loss, name="word2vec.loss")

    rng = np.random.RandomState(1234)
    corpus = None
    if not args.synthetic:
        try:
            words = hvd_data.load_text8(args.data_dir,
                                        max_words=args.max_words)
            corpus, counts, _, _ = hvd_data.build_vocab(words,
                                                        args.vocab_size)
            if hvd.rank() == 0:
                print(f"text8: {len(corpus)} tokens, vocab "
                      f"{args.vocab_size}, UNK rate "
                      f"{counts[0][1] / len(corpus):.3f}")
        except (OSError, ValueError) as e:
            if hvd.rank() == 0:
                print(f"Real text8 unavailable ({e}); using synthetic "
                      f"corpus.")
    if corpus is None:
        corpus = rng.zipf(1.5, size=200_000).clip(
            0, args.vocab_size - 1).astype(np.int32)

    def batches():
        index = len(corpus) // hvd.size() * hvd.rank()
        while True:
            centers, contexts, index = word2vec.generate_batch(
                corpus, args.batch_size, args.num_skips, args.skip_window,
                index)
            for r in range(hvd.size()):  # every rank's draw, in rank order
                negs = rng.randint(0, args.vocab_size, (args.num_sampled,))
                if r == hvd.rank():
                    mine = negs.astype(np.int32)
            yield tuple(torch.from_numpy(a).to(dev)
                        for a in (centers, contexts, mine))

    return model, train_step, batches()


def main(argv=None) -> dict:
    args = parse_args(argv)
    hvd.init(device=args.device)
    model, train_step, batches = setup(args)
    step = hvd.spmd(train_step)
    hvd.broadcast_global_variables(model, root_rank=0)

    losses = []
    for it in range(args.steps):
        losses.append(step(*next(batches)))
        if it % 20 == 0 and hvd.rank() == 0:
            print(f"step {it}: nce loss = {float(losses[-1]):.4f}")
    losses = [float(v) for v in losses]
    if hvd.rank() == 0:
        norms = model.embeddings.detach().norm(dim=1)
        print(f"trained embeddings: {tuple(model.embeddings.shape)}, mean "
              f"norm {float(norms.mean()):.3f}")
    return {"losses": losses, "runs": step.runs, "replays": step.replays,
            "model": model}


if __name__ == "__main__":
    main()

"""MNIST via the high-level Trainer — the reference's
``examples/keras_mnist.py``: a model.fit-style loop, Adadelta scaled by the
world size, the initial-state broadcast callback. Real MNIST through
``ShardedDataset`` when the IDX files are in ``--data-dir`` (or
``HOROVOD_DATA_DIR``); otherwise, or with ``--synthetic``, synthetic data
(the example's own choice, as the reference's).

Run:  python -m horovod_tpu_torch.examples.keras_mnist [--epochs 2]
          [--synthetic] [--device cpu]
"""

from __future__ import annotations

import argparse

import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch import training
from horovod_tpu_torch.models import mnist


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("--epochs", type=int, default=2)
    parser.add_argument("--steps-per-epoch", type=int, default=20)
    parser.add_argument("--batch-size", type=int, default=128)
    parser.add_argument("--data-dir", default=None,
                        help="Directory with the MNIST IDX files.")
    parser.add_argument("--synthetic", action="store_true",
                        help="Skip real data (the CI/offline path).")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = parser.parse_args(argv)

    hvd.init(device=args.device)
    dev = hvd.device()

    model = mnist.KerasMnistModel(
        generator=torch.Generator().manual_seed(0)).to(dev)
    # Adjust LR by number of ranks (keras_mnist.py:60-62 of the reference).
    trainer = training.Trainer(model, mnist.make_loss_fn(model),
                               training.adadelta(1.0 * hvd.size()))

    # Real MNIST when available; --synthetic or missing files fall back.
    dataset = None
    if not args.synthetic:
        try:
            (x, y), _ = training.data.load_mnist(args.data_dir)
            x = (x.astype("float32") / 255.0)[..., None]     # (N,28,28,1)
            dataset = training.data.ShardedDataset(
                [x, y.astype("int64")], hvd.size(), args.batch_size)
            print(f"MNIST: {len(x)} examples, "
                  f"{dataset.steps_per_epoch} steps/epoch/rank")
        except (OSError, ValueError) as e:
            print(f"Real MNIST unavailable ({e}); using synthetic data.")

    if dataset is not None:
        def batches():
            epoch = 0
            while True:
                yield from training.data.prefetch_to_device(
                    dataset.batches(epoch))
                epoch += 1
        steps = min(args.steps_per_epoch, dataset.steps_per_epoch)
    else:
        def batches():
            it = 0
            while True:
                yield mnist.synthetic_mnist(
                    args.batch_size, seed=1000 * it + hvd.rank(), device=dev)
                it += 1
        steps = args.steps_per_epoch

    history = trainer.fit(
        batches(), epochs=args.epochs, steps_per_epoch=steps,
        callbacks=[
            # Sync the initial state from rank 0.
            training.BroadcastGlobalVariablesCallback(root_rank=0),
        ],
        verbose=True)
    return {"losses": history["loss"], "runs": trainer._step.runs,
            "replays": trainer._step.replays}


if __name__ == "__main__":
    main()

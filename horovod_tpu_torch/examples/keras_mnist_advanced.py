"""MNIST with the full callback suite — the reference's
``examples/keras_mnist_advanced.py``: LR warmup over the first epochs,
metric averaging across ranks, rank-0 checkpointing, broadcast at train
begin. The optimizer is ``training.adam``, whose update is kernel A1 on the
card.

Run:  python -m horovod_tpu_torch.examples.keras_mnist_advanced
          [--epochs 4] [--device cpu]
"""

from __future__ import annotations

import argparse
import tempfile

import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch import training
from horovod_tpu_torch.models import mnist


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("--epochs", type=int, default=4)
    parser.add_argument("--steps-per-epoch", type=int, default=10)
    parser.add_argument("--batch-size", type=int, default=128)
    parser.add_argument("--checkpoint-dir", default=None)
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = parser.parse_args(argv)

    hvd.init(device=args.device)
    dev = hvd.device()
    ckpt_dir = args.checkpoint_dir or tempfile.mkdtemp(prefix="hvd_mnist_")

    model = mnist.KerasMnistModel(
        generator=torch.Generator().manual_seed(0)).to(dev)
    # Adam LR scaled by world size; the warmup ramps into it.
    trainer = training.Trainer(model, mnist.make_loss_fn(model),
                               training.adam(1e-3 * hvd.size()))

    def batches():
        it = 0
        while True:
            yield mnist.synthetic_mnist(
                args.batch_size, seed=1000 * it + hvd.rank(), device=dev)
            it += 1

    callbacks = [
        training.BroadcastGlobalVariablesCallback(root_rank=0),
        training.MetricAverageCallback(),
        training.LearningRateWarmupCallback(
            warmup_epochs=2, steps_per_epoch=args.steps_per_epoch,
            verbose=True),
        # Rank-0-only checkpoint writer.
        training.ModelCheckpointCallback(ckpt_dir),
    ]
    history = trainer.fit(batches(), epochs=args.epochs,
                          steps_per_epoch=args.steps_per_epoch,
                          callbacks=callbacks, verbose=True)
    latest = training.checkpoint.latest_epoch(ckpt_dir)
    if hvd.rank() == 0:
        print(f"checkpoints in {ckpt_dir}: epoch {latest}")
    return {"losses": history["loss"], "runs": trainer._step.runs,
            "replays": trainer._step.replays, "latest_epoch": latest}


if __name__ == "__main__":
    main()

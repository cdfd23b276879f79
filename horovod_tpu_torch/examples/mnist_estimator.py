"""MNIST CNN in the Estimator style — the reference's
``examples/mnist_estimator.py``: a ``model_fn(model, features, labels,
mode, seed)`` returning an ``EstimatorSpec`` per mode, a momentum optimizer
with the LR scaled by the world size, steps divided by the world size,
rank-0-only ``model_dir`` checkpointing, the implicit initial weight
broadcast, and a final evaluate printout.

Run:  python -m horovod_tpu_torch.examples.mnist_estimator [--steps 200]
          [--device cpu]
"""

from __future__ import annotations

import argparse

import torch
import torch.nn.functional as F

import horovod_tpu_torch as hvd
from horovod_tpu_torch import training
from horovod_tpu_torch.models import mnist
from horovod_tpu_torch.training import Estimator, EstimatorSpec, ModeKeys


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=200,
                        help="total steps across all ranks (divided by size)")
    parser.add_argument("--batch-size", type=int, default=100)
    parser.add_argument("--lr", type=float, default=0.001)
    parser.add_argument("--model-dir", default=None)
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = parser.parse_args(argv)

    hvd.init(device=args.device)
    dev = hvd.device()
    size = hvd.size()

    def model_fn(model, features, labels, mode, seed):
        """The cnn_model_fn analog: one function, three modes."""
        logits = model(features, train=mode == ModeKeys.TRAIN,
                       dropout_key=seed)
        if mode == ModeKeys.PREDICT:
            return EstimatorSpec(predictions={
                "classes": logits.argmax(-1),
                "probabilities": F.softmax(logits, dim=-1),
            })
        loss = mnist.cross_entropy_loss(logits, labels)
        if mode == ModeKeys.EVAL:
            return EstimatorSpec(loss=loss, metrics={
                "accuracy": mnist.accuracy(logits, labels)})
        return EstimatorSpec(loss=loss)

    def init_fn(seed, features):
        return mnist.ConvModel(generator=torch.Generator().manual_seed(seed))

    est = Estimator(model_fn, init_fn,
                    # LR scaled by the number of ranks.
                    training.sgd(args.lr * size, momentum=0.9),
                    model_dir=args.model_dir)

    def make_input_fn(seed0: int, steps: int | None = None):
        def input_fn():
            step = 0
            while steps is None or step < steps:
                yield mnist.synthetic_mnist(
                    args.batch_size, seed=seed0 + 1000 * step + hvd.rank(),
                    device=dev)
                step += 1
        return input_fn

    losses = []

    class LossLog(training.Callback):
        def on_batch_end(self, batch, logs=None):
            losses.append(logs["loss"])

    # Steps divided across workers.
    steps = max(1, args.steps // size)
    est.train(make_input_fn(0), steps=steps, callbacks=[LossLog()])
    if hvd.rank() == 0:
        print(f"trained {steps} steps (global_step={est.global_step})")

    eval_results = est.evaluate(make_input_fn(90_000, steps=4))
    if hvd.rank() == 0:
        print({k: round(float(v), 4) for k, v in eval_results.items()})

    # A few predictions, in the reference's predictions dict.
    first = next(est.predict(lambda: [
        mnist.synthetic_mnist(4, seed=7, device=dev)[0]]))
    if first["classes"].shape != () or first["probabilities"].shape != (10,):
        raise RuntimeError(f"predict: unexpected shapes "
                           f"{first['classes'].shape}, "
                           f"{first['probabilities'].shape}")
    if hvd.rank() == 0:
        print("predict OK:", int(first["classes"]))
    train = est._programs[ModeKeys.TRAIN]
    return {"losses": [float(v) for v in losses], "eval": eval_results,
            "runs": train.runs, "replays": train.replays,
            "global_step": est.global_step}


if __name__ == "__main__":
    main()

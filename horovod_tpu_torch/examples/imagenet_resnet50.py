"""ResNet-50 data-parallel training with checkpoint/resume — the reference's
``examples/imagenet_resnet50.py``: LR warmup then staircase decay,
checkpoint-resume agreement, rank-0 checkpoint writes, metric averaging.
``--data-dir`` trains on an ImageNet-style ``root/<class>/*.jpg`` directory
through ``ImageFolderDataset`` (decoded in the background) and
``prefetch_to_device`` (bf16 copies on a side stream); without it, on
synthetic ImageNet batches made on the device.

The reference's ``CarryBatchStats`` callback has no counterpart: there the
BatchNorm statistics come back from the step as flax's mutable collection
and a callback writes them into the variables, while here they are module
buffers that the forward updates in place and the Trainer averages over
the group after each update.

Run:  python -m horovod_tpu_torch.examples.imagenet_resnet50 [--epochs 3
          --tiny] [--device cpu]
      python -m horovod_tpu_torch.examples.imagenet_resnet50 --data-dir
          /data/imagenet/train
"""

from __future__ import annotations

import argparse
import tempfile

import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch import training
from horovod_tpu_torch.models import resnet


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("--epochs", type=int, default=3)
    parser.add_argument("--steps-per-epoch", type=int, default=5)
    parser.add_argument("--batch-size", type=int, default=32,
                        help="per-GPU batch")
    parser.add_argument("--image-size", type=int, default=224)
    parser.add_argument("--base-lr", type=float, default=0.0125,
                        help="per-GPU LR (keras_imagenet_resnet50.py:36)")
    parser.add_argument("--checkpoint-dir", default=None)
    parser.add_argument("--tiny", action="store_true",
                        help="1-block-per-stage ResNet at 64px (CPU/demo)")
    parser.add_argument("--data-dir", default=None,
                        help="ImageNet-style root/<class>/*.jpg directory; "
                             "default: synthetic data")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = parser.parse_args(argv)

    hvd.init(device=args.device)
    dev = hvd.device()
    ckpt_dir = args.checkpoint_dir or tempfile.mkdtemp(prefix="hvd_rn50_")

    ds = None
    if args.data_dir:
        ds = training.data.ImageFolderDataset(
            args.data_dir, size=hvd.size(), batch_size=args.batch_size,
            image_size=64 if args.tiny else args.image_size, train=True)

    g = torch.Generator().manual_seed(0)
    if args.tiny:
        num_classes = len(ds.classes) if ds else 100
        model = resnet.ResNet(stage_sizes=[1, 1, 1, 1],
                              num_classes=num_classes, dtype=torch.float32,
                              generator=g)
        image_size = 64
    else:
        num_classes = len(ds.classes) if ds else 1000
        model = resnet.ResNet50(num_classes=num_classes, generator=g)
        image_size = args.image_size
    model = model.to(dev)

    # LR scaled linearly with the ranks, warmup into it, staircase decay at
    # 30/60/80 epochs.
    trainer = training.Trainer(
        model, resnet.make_loss_fn(model),
        training.sgd(args.base_lr * hvd.size(), momentum=0.9), has_aux=True)

    # Checkpoint/resume agreement: the newest epoch every rank can load.
    start = trainer.restore(ckpt_dir)
    if start > 0 and hvd.rank() == 0:
        print(f"resumed from epoch {start - 1}")

    if ds is not None:
        if ds.steps_per_epoch < args.steps_per_epoch and hvd.rank() == 0:
            print(f"note: dataset supports {ds.steps_per_epoch} "
                  f"steps/epoch; cycling within the epoch")

        def batches():
            epoch = 0
            while True:
                # bf16 copies on a side stream, overlapping the decode AND
                # the host-to-device copy with training.
                for images, labels in training.data.prefetch_to_device(
                        ds.batches(epoch), dtype=torch.bfloat16):
                    yield images, labels.long()
                epoch += 1
    else:
        def batches():
            it = 0
            while True:
                yield resnet.synthetic_imagenet(
                    args.batch_size, image_size, seed=1000 * it + hvd.rank(),
                    num_classes=num_classes, device=dev)
                it += 1

    callbacks = [
        training.BroadcastGlobalVariablesCallback(root_rank=0),
        training.MetricAverageCallback(),
        training.LearningRateWarmupCallback(
            warmup_epochs=min(5, args.epochs),
            steps_per_epoch=args.steps_per_epoch, verbose=True),
        training.LearningRateScheduleCallback(
            multiplier=lambda e: 0.1 ** (e // 30), start_epoch=5),
        training.ModelCheckpointCallback(ckpt_dir),
    ]
    history = trainer.fit(batches(), epochs=args.epochs,
                          steps_per_epoch=args.steps_per_epoch,
                          callbacks=callbacks, verbose=True)
    return {"losses": history["loss"], "runs": trainer._step.runs,
            "replays": trainer._step.replays, "start_epoch": start}


if __name__ == "__main__":
    main()

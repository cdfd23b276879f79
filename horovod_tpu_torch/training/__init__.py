"""Training layer: the fit loop, its optimizer builders, callbacks and
checkpoints."""

from horovod_tpu_torch.training.loop import (  # noqa: F401
    SGD,
    Trainer,
    adam,
    sgd,
)

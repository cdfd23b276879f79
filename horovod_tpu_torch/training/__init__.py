"""Training layer: the fit loop, its optimizer builders, callbacks,
checkpoints, the input pipeline and the Estimator."""

from horovod_tpu_torch.training import checkpoint  # noqa: F401
from horovod_tpu_torch.training import data  # noqa: F401
from horovod_tpu_torch.training.callbacks import (  # noqa: F401
    BroadcastGlobalVariablesCallback,
    Callback,
    LearningRateScheduleCallback,
    LearningRateWarmupCallback,
    MetricAverageCallback,
    ModelCheckpointCallback,
    StallWarningCallback,
)
from horovod_tpu_torch.training.estimator import (  # noqa: F401
    Estimator,
    EstimatorSpec,
    ModeKeys,
)
from horovod_tpu_torch.training.loop import (  # noqa: F401
    SGD,
    Adadelta,
    Trainer,
    adadelta,
    adam,
    sgd,
)

# The reference exposes the broadcast-on-start behavior twice: as a Keras
# callback and as a tf.train.SessionRunHook. Here both are the same object
# — the Trainer consumes it as a callback, the Estimator applies it
# implicitly.
BroadcastGlobalVariablesHook = BroadcastGlobalVariablesCallback

"""horovod_tpu_torch — Horovod-style data-parallel training in PyTorch on CUDA.

The PyTorch/CUDA port of ``horovod_tpu`` (which stays the JAX reference).
Each rank is a process with one GPU; collectives run over
``torch.distributed`` (NCCL on the GPU, gloo on the CPU); the JAX package's
Pallas kernels are CUDA kernels written for Hopper (``csrc/``).

    import horovod_tpu_torch as hvd
    hvd.init()                         # cuda:<LOCAL_RANK>, NCCL
    opt = hvd.DistributedOptimizer(torch.optim.SGD(model.parameters(), 0.1,
                                                   momentum=0.9))
    trainer = hvd.Trainer(model, loss_fn, opt, has_aux=True)

The long-context LM (``models/transformer.py``) trains the same way, with
``ops.optim.AdamW`` and ``make_loss_fn(config, fused_head=True)``; its
attention above 2048 tokens runs on the flash kernels B3/B4.

The package imports no JAX and nothing of ``horovod_tpu``.
"""

from horovod_tpu_torch.core.state import (  # noqa: F401
    HorovodError,
    NotInitializedError,
    device,
    get_group,
    global_rank,
    global_size,
    init,
    is_initialized,
    local_rank,
    local_size,
    num_groups,
    rank,
    shutdown,
    size,
)
from horovod_tpu_torch.ops.collectives import (  # noqa: F401
    allgather,
    allreduce,
    broadcast,
    gather,
)
from horovod_tpu_torch.ops.flash_attention import (  # noqa: F401
    blockwise_attention,
    flash_attention,
    flash_attention_lse,
)
from horovod_tpu_torch.parallel.sequence import local_attention  # noqa: F401
from horovod_tpu_torch.parallel.optimizer import (  # noqa: F401
    DistributedOptimizer,
    allreduce_gradients,
    broadcast_global_variables,
    broadcast_optimizer_state,
    broadcast_variables,
)
from horovod_tpu_torch.run import run  # noqa: F401
from horovod_tpu_torch.training.callbacks import (  # noqa: F401
    BroadcastGlobalVariablesCallback,
    Callback,
    LearningRateScheduleCallback,
    LearningRateWarmupCallback,
    MetricAverageCallback,
)
from horovod_tpu_torch.training.loop import Trainer  # noqa: F401

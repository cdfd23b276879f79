"""horovod_tpu_torch — Horovod-style data-parallel training in PyTorch on CUDA.

The PyTorch/CUDA port of ``horovod_tpu`` (which stays the JAX reference).
Each rank is a process with one GPU; collectives run over
``torch.distributed`` (NCCL on the GPU, gloo on the CPU); the JAX package's
Pallas kernels are CUDA kernels written for Hopper (``csrc/``).

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import training
    hvd.init()                         # cuda:<LOCAL_RANK>, NCCL
    trainer = hvd.Trainer(model, loss_fn, training.sgd(0.1, momentum=0.9),
                          has_aux=True, steps_per_call=5)

The trainer's step runs through ``hvd.spmd``: on the card it is captured
once as a CUDA graph and replayed (K = ``steps_per_call`` steps a replay),
and its collective schedule is validated across the ranks once. The
``training.sgd``/``training.adam`` builders keep the learning rate in a
device tensor, so LR-schedule callbacks reach the captured step. A
``torch.optim`` optimizer works too if it can be captured: the Trainer
sets its ``capturable`` flag (``SGD`` needs none; one without the flag is
refused), and its float learning rate is fixed once the step is recorded.
``hvd.spmd(fn)`` wraps any step function the same
way; ``rank_stack``, ``replicate`` and ``local_values`` are the JAX
package's rank-axis helpers for a world where a process is a rank.

The long-context LM (``models/transformer.py``) trains the same way, with
``ops.optim.AdamW`` and ``make_loss_fn(config, fused_head=True)``; its
attention above 2048 tokens runs on the flash kernels B3/B4. The same LM
serves through ``hvd.serving.Engine`` (paged KV cache, continuous batching)
and ``models.transformer.generate`` (dense KV cache).

The reference's training entry points are here too: the MNIST models
(``models/mnist.py``), the input pipeline (``training.data``: sharded
datasets, ``prefetch_to_device``), ``training.Estimator``, and the nine
examples, ``python -m horovod_tpu_torch.examples.<name>``.

Sparse gradients are ``hvd.IndexedSlices``: ``allreduce_gradients`` and
``allreduce_indexed_slices`` exchange them by allgather with
dedup-and-merge (``ops/sparse.py``), as word2vec (``models/word2vec.py``)
and the embedding bag (``models/embedding_bag.py``) train.

The package imports no JAX and nothing of ``horovod_tpu``.
"""

from horovod_tpu_torch.core.state import (  # noqa: F401
    HorovodError,
    NotInitializedError,
    bump_generation,
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
    alltoall,
    broadcast,
    gather,
    reducescatter,
)
from horovod_tpu_torch.ops.flash_attention import (  # noqa: F401
    blockwise_attention,
    flash_attention,
    flash_attention_lse,
)
from horovod_tpu_torch.ops.sparse import (  # noqa: F401
    IndexedSlices,
    allreduce_indexed_slices,
)
from horovod_tpu_torch.parallel.sequence import local_attention  # noqa: F401
from horovod_tpu_torch.parallel.spmd import (  # noqa: F401
    device_put_ranked,
    local_values,
    rank_stack,
    replicate,
    spmd,
)
from horovod_tpu_torch.parallel.optimizer import (  # noqa: F401
    DistributedOptimizer,
    allreduce_gradients,
    broadcast_global_variables,
    broadcast_optimizer_state,
    broadcast_variables,
)
from horovod_tpu_torch.run import run  # noqa: F401
from horovod_tpu_torch import serving  # noqa: F401
from horovod_tpu_torch.serving import (  # noqa: F401
    AdmissionError,
    BlockPool,
    Engine,
    EngineStalled,
    RequestJournal,
)
from horovod_tpu_torch.training.callbacks import (  # noqa: F401
    BroadcastGlobalVariablesCallback,
    Callback,
    LearningRateScheduleCallback,
    LearningRateWarmupCallback,
    MetricAverageCallback,
    ModelCheckpointCallback,
    StallWarningCallback,
)
from horovod_tpu_torch import training  # noqa: F401
from horovod_tpu_torch.training.loop import Trainer  # noqa: F401

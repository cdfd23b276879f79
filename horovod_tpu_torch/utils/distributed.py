"""Multi-host initialization — the launcher story.

Counterpart of ``horovod_tpu/utils/distributed.py``. The reference's cluster
boundary is ``mpirun`` + ``MPI_Init_thread``; the JAX package's is
``jax.distributed.initialize``. Here it is ``torch.distributed``'s
``env://`` rendezvous: :func:`init_distributed` sets ``MASTER_ADDR``,
``MASTER_PORT``, ``RANK`` and ``WORLD_SIZE`` from its arguments, where
given, and calls ``hvd.init``, which creates the default process group
from them. Under ``torchrun`` (or any launcher that exports those
variables) ``init_distributed()`` with no arguments is the whole launcher.
"""

from __future__ import annotations

import os

import torch.distributed as dist


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     group_ranks=None, *, device=None) -> None:
    """The rendezvous and ``hvd.init`` in one call.

    ``coordinator_address`` is ``host:port`` of the rendezvous store
    (process 0 serves it), ``num_processes`` the world size,
    ``process_id`` this process's rank; ``group_ranks`` and ``device`` go
    to ``hvd.init`` (``device=None`` is the GPU, ``"cpu"`` gloo). When a
    default process group already exists the rendezvous is skipped and
    ``hvd.init`` reuses it, as the reference skips a second
    initialization."""
    if not dist.is_initialized():
        if coordinator_address is not None:
            host, sep, port = coordinator_address.rpartition(":")
            if not sep or not host or not port.isdigit():
                raise ValueError(
                    f"init_distributed: coordinator_address must be "
                    f"'host:port', got {coordinator_address!r}")
            os.environ["MASTER_ADDR"] = host
            os.environ["MASTER_PORT"] = port
        if num_processes is not None:
            os.environ["WORLD_SIZE"] = str(int(num_processes))
        if process_id is not None:
            os.environ["RANK"] = str(int(process_id))

    import horovod_tpu_torch as hvd

    hvd.init(group_ranks, device=device)


def shutdown_distributed() -> None:
    """Tear down the hvd state and the default process group (job end)."""
    import horovod_tpu_torch as hvd

    hvd.shutdown()
    if dist.is_initialized():
        dist.destroy_process_group()

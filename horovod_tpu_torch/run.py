"""Launch a function once per rank — the counterpart of ``hvd.spmd`` and of
``mpirun``/``horovodrun``.

In the JAX package one controller drives every device; here each rank is a
process. ``run(fn, np)`` starts ``np`` processes (``spawn`` start method),
sets the torchrun-style environment in each (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``), creates the default process group
from a ``file://`` rendezvous, calls ``fn(*args)`` and returns the ranks'
results in rank order. ``fn`` calls ``hvd.init(...)`` itself, which reuses
that process group. ``fn``, its arguments and its result must pickle.

On the GPU (``device="cuda"``, NCCL) rank ``r`` uses card ``r``: NCCL refuses
two ranks on one card. ``device="cpu"`` runs the world over gloo.
"""

from __future__ import annotations

import os
import queue
import tempfile
import traceback
from typing import Any, Callable, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _worker(rank: int, np_: int, device: str, init_file: str, fn, args,
            results) -> None:
    os.environ.update({"RANK": str(rank), "WORLD_SIZE": str(np_),
                       "LOCAL_RANK": str(rank),
                       "LOCAL_WORLD_SIZE": str(np_)})
    torch.set_num_threads(1)
    try:
        backend = "nccl" if device == "cuda" else "gloo"
        if device == "cuda":
            torch.cuda.set_device(rank)
        dist.init_process_group(backend, init_method=f"file://{init_file}",
                                rank=rank, world_size=np_)
        try:
            out = fn(*args)
        finally:
            from horovod_tpu_torch.core import state as _state

            _state.shutdown()
            if dist.is_initialized():
                dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:  # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))


def run(fn: Callable, np: int, *, device: str = "cuda",
        args: Sequence[Any] = (), timeout: float = 300.0) -> list:
    """Run ``fn(*args)`` in ``np`` rank processes; returns their results in
    rank order. Raises ``RuntimeError`` with the failing rank's traceback
    if any rank fails, or if the world does not finish within
    ``timeout`` seconds (its processes are then killed)."""
    if device not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    if device == "cuda" and torch.cuda.device_count() < np:
        raise RuntimeError(
            f"run(np={np}, device='cuda') needs {np} GPUs (NCCL runs one rank "
            f"per GPU); {torch.cuda.device_count()} visible. Use "
            f"device='cpu' for a gloo world.")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="hvd_run_") as tmp:
        init_file = os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_worker,
                             args=(r, np, device, init_file, fn, tuple(args),
                                   results), daemon=True)
                 for r in range(np)]
        for p in procs:
            p.start()
        got: dict[int, tuple[bool, Any]] = {}
        try:
            while len(got) < np:
                try:
                    rank, ok, out = results.get(timeout=timeout)
                except queue.Empty:
                    raise RuntimeError(
                        f"run: {np - len(got)} rank(s) did not finish within "
                        f"{timeout} s.") from None
                got[rank] = (ok, out)
                if not ok:
                    raise RuntimeError(f"run: rank {rank} failed:\n{out}")
            for p in procs:
                p.join(timeout=timeout)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
    return [got[r][1] for r in range(np)]

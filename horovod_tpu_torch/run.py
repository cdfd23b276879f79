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

The fault drills run through it too: a rank listed in ``crashes`` may end
with the injected crash's exit code (``HOROVOD_FAULT_INJECT="crash@..."``)
instead of a result, and ``rejoin={rank: (fn, args)}`` then starts a new
process in its place — an elastic regrow's joiner
(``core/elastic.py::rejoin``), which meets the world through the same
rendezvous store.
"""

from __future__ import annotations

import os
import queue
import tempfile
import time
import traceback
from typing import Any, Callable, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _worker(rank: int, np_: int, device: str, init_file: str, fn, args,
            results, join: bool = False) -> None:
    os.environ.update({"RANK": str(rank), "WORLD_SIZE": str(np_),
                       "LOCAL_RANK": str(rank),
                       "LOCAL_WORLD_SIZE": str(np_)})
    torch.set_num_threads(1)
    try:
        from horovod_tpu_torch.core import state as _state

        if device == "cuda":
            torch.cuda.set_device(rank)
        # The store the world meets on, opened again by a joiner (which
        # has no default process group).
        store = dist.FileStore(init_file, -1 if join else np_)
        _state.set_rendezvous_store(store)
        if not join:
            timeout = _state.pg_timeout()
            dist.init_process_group(
                "nccl" if device == "cuda" else "gloo", store=store,
                rank=rank, world_size=np_,
                **({} if timeout is None else {"timeout": timeout}))
        try:
            out = fn(*args)
        finally:
            _state.shutdown()
            # A default group that lost a member is left to the process's
            # end: NCCL's teardown would wait on the dead peer.
            if dist.is_initialized() and not _state.default_pg_lost():
                dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:  # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))


def run(fn: Callable, np: int, *, device: str = "cuda",
        args: Sequence[Any] = (), timeout: float = 300.0,
        crashes: Sequence[int] = (), rejoin=None) -> list:
    """Run ``fn(*args)`` in ``np`` rank processes; returns their results in
    rank order. Raises ``RuntimeError`` with the failing rank's traceback
    if any rank fails, if a rank's process ends without a result, or if
    the world does not finish within ``timeout`` seconds (its processes
    are then killed).

    ``crashes``: ranks whose process may end with ``CRASH_EXIT_CODE``
    (an injected crash); such a rank's result is None. ``rejoin`` maps a
    rank of ``crashes`` to ``(join_fn, join_args)``: at the rank's first
    crash a new process runs ``join_fn(*join_args)`` in its place, whose
    result then stands for the rank (and which may crash in turn)."""
    from horovod_tpu_torch.core.resilience import CRASH_EXIT_CODE

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

        def start(r, target_fn, target_args, join=False):
            p = ctx.Process(target=_worker,
                            args=(r, np, device, init_file, target_fn,
                                  tuple(target_args), results, join),
                            daemon=True)
            p.start()
            return p

        procs = {r: start(r, fn, args) for r in range(np)}
        started = list(procs.values())
        got: dict[int, tuple[bool, Any]] = {}
        rejoin = dict(rejoin or {})
        deadline = time.monotonic() + timeout
        try:
            while len(got) < np:
                try:
                    rank, ok, out = results.get(timeout=0.2)
                except queue.Empty:
                    if time.monotonic() > deadline:
                        raise RuntimeError(
                            f"run: {np - len(got)} rank(s) did not finish "
                            f"within {timeout} s.") from None
                    for r, p in list(procs.items()):
                        code = p.exitcode
                        if r in got or code is None or code == 0:
                            continue  # running, or its result is queued
                        if r in crashes and code == CRASH_EXIT_CODE:
                            if r in rejoin:
                                join_fn, join_args = rejoin.pop(r)
                                procs[r] = start(r, join_fn, join_args,
                                                 join=True)
                                started.append(procs[r])
                            else:
                                got[r] = (True, None)
                            continue
                        raise RuntimeError(
                            f"run: rank {r}'s process ended with exit code "
                            f"{code} without a result.")
                    continue
                got[rank] = (ok, out)
                if not ok:
                    raise RuntimeError(f"run: rank {rank} failed:\n{out}")
            for p in started:
                p.join(timeout=timeout)
        finally:
            for p in started:
                if p.is_alive():
                    p.kill()
                    p.join()
    return [got[r][1] for r in range(np)]

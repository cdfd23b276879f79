"""Device-true timeline spans from a ``torch.profiler`` session.

Counterpart of ``horovod_tpu/core/xprof.py``. The reference samples one
execution of a compiled step under ``jax.profiler`` and maps the XLA ops
of the captured trace back onto the negotiated collective schedule; here
one call of an ``spmd`` program (an eager first call or a graph replay)
runs under ``torch.profiler``, whose CUDA activity (CUPTI) records every
kernel and copy the card ran with device timestamps, and the same mapping
writes them into the timeline.

A kernel-name classifier of the port's own (:func:`kernel_base`) takes the
place of the reference's ``hlo_base``: it gives each device event the HLO
opcode the reference's rules speak of, so :func:`map_device_spans` and
:func:`_merge_async` keep the reference's logic:

* NCCL's collective kernels (``ncclDevKernel_AllReduce_*``, or
  ``ncclKernel_AllReduce_*`` of older NCCL; AllGather, ReduceScatter,
  Broadcast, and SendRecv, NCCL's point-to-point form) are the collectives
  ``all-reduce``, ``all-gather``, ``reduce-scatter``,
  ``collective-broadcast`` and ``collective-permute``, matched in device
  order against same-kind entries of the schedule and written as
  ``XLA_<OP>`` on the tensor's row (the reference's activity names);
* the fusion buffer's pack, ``torch.cat``'s kernel
  (``CatArrayBatchedCopy``), is ``concatenate``, and a device-to-device
  copy (the unpack's ``copy_`` into each gradient, a ``cudaMemcpyAsync``,
  or ATen's ``direct_copy_kernel``) is ``slice``: within one gap between
  two collectives they are ``MEMCPY_IN_FUSION_BUFFER`` and
  ``MEMCPY_OUT_FUSION_BUFFER`` on the ``_fusion_buffer`` row;
* any other kernel is its function's name (``flash_fwd_kernel``), compute;
* the whole call is ``DEVICE_STEP`` on the ``_device`` row.

Beyond the reference, :func:`kernel_spans` writes each launch of the
port's own kernels (``ops/launches.py::KERNELS``: B1-B4, A1, A2) on the
``_kernels`` row, named by its device function.

Times are µs from the profiler session's start.
"""

from __future__ import annotations

import re
import sys
import time

import torch

_COLL_KIND = {
    "all-reduce": "ALLREDUCE",
    "all-gather": "ALLGATHER",
    "reduce-scatter": "REDUCESCATTER",
    "all-to-all": "ALLTOALL",
    "collective-permute": "PPERMUTE",
    "collective-broadcast": "BROADCAST",
}
# Schedule op -> the device kinds it may run as.
_SCHED_ACCEPTS = {
    "ALLREDUCE": {"ALLREDUCE"},
    "GROUPED_ALLREDUCE": {"ALLREDUCE"},
    "ALLGATHER": {"ALLGATHER"},
    "GROUPED_ALLGATHER": {"ALLGATHER"},
    "BROADCAST": {"BROADCAST", "ALLREDUCE", "PPERMUTE"},
    "GATHER": {"ALLGATHER"},
    "REDUCESCATTER": {"REDUCESCATTER", "ALLREDUCE", "PPERMUTE"},
    "ALLTOALL": {"ALLTOALL", "PPERMUTE"},
}
_PACK_BASES = {"concatenate"}
_UNPACK_BASES = {"slice", "dynamic-slice"}

# NCCL's kernel families -> the opcode of the collective they run.
_NCCL_KERNEL = re.compile(r"nccl(?:Dev)?Kernel_([A-Za-z]+)")
_NCCL_BASE = {
    "AllReduce": "all-reduce",
    "AllGather": "all-gather",
    "ReduceScatter": "reduce-scatter",
    "Broadcast": "collective-broadcast",
    "SendRecv": "collective-permute",
}


def kernel_base(name: str) -> str:
    """The opcode a device event stands for (module docstring): NCCL's
    collectives and the fusion buffer's copies by the reference's HLO
    names, any other kernel by its function's unqualified name."""
    m = _NCCL_KERNEL.search(name)
    if m:
        return _NCCL_BASE.get(m.group(1), f"nccl-{m.group(1)}")
    if "CatArrayBatchedCopy" in name:
        return "concatenate"
    if "direct_copy_kernel" in name or name.startswith("Memcpy DtoD"):
        return "slice"
    base = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    cut = min((i for i in (base.find("<"), base.find("(")) if i > 0),
              default=len(base))
    return base[:cut].strip().rsplit("::", 1)[-1]


def _instr_key(name: str) -> str:
    m = re.match(r"%?([a-zA-Z0-9_.-]+)", name)
    return m.group(1) if m else name


def device_op_events(prof) -> list:
    """``[(name, start_us, dur_us)]`` of the kernels and copies a finished
    ``torch.profiler`` session recorded on the device, sorted by start;
    ``[]`` when it recorded none (a CPU session)."""
    out = []
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA \
                or getattr(e, "is_user_annotation", False):
            continue
        start = e.time_range.start
        out.append((e.name, start, e.time_range.end - start))
    out.sort(key=lambda t: t[1])
    return out


def on_card() -> bool:
    """Whether the runtime's device (``hvd.init``'s; before it, whether
    CUDA is there) is a GPU."""
    from horovod_tpu_torch.core import state as _state

    if _state.is_initialized():
        return _state.device().type == "cuda"
    return torch.cuda.is_available()


def profiled_events(run_once):
    """``(run_once(), device events, anchor_us)``: one call under
    ``torch.profiler`` (CUDA activity on the card, the CPU's elsewhere,
    where no device event exists), the device drained before the session
    stops, and the session stopped even when the call raises (the
    profiler is global: a session left open breaks every later one).
    ``anchor_us`` is the host monotonic clock at the session's start, in
    µs, to which the events' times are relative."""
    from torch.profiler import ProfilerActivity, profile

    cuda = on_card()
    if cuda:
        torch.cuda.synchronize()
    prof = profile(activities=[ProfilerActivity.CUDA if cuda
                               else ProfilerActivity.CPU])
    anchor_us = time.monotonic_ns() / 1e3
    prof.start()
    try:
        out = run_once()
        if cuda:
            torch.cuda.synchronize()
    finally:
        prof.stop()
    return out, device_op_events(prof), anchor_us


def timed_steps(run_once, steps: int, trials: int = 3,
                strict: bool = False, info: dict | None = None) -> float:
    """Best seconds a step over ``trials`` calls of ``run_once`` (each
    running ``steps`` steps and waiting for them).

    On the card: the device window of a profiler session (the last
    device event's end less the first's start), free of the host's
    dispatch. Elsewhere: the wall clock. A session on the card with no
    device event raises when ``strict`` and otherwise falls back to the
    wall clock with a warning on stderr. ``info["timing"]`` is set to
    ``"device"``, ``"host-fallback"`` (a session on the card had no
    device event) or ``"host"`` (not on the card)."""
    cuda = on_card()
    if info is not None:
        info["timing"] = "device" if cuda else "host"
    best = 1e9
    for _ in range(trials):
        if cuda:
            t0 = time.perf_counter()
            _, evs, _ = profiled_events(run_once)
            wall = time.perf_counter() - t0
            if evs:
                start = min(s for _, s, _ in evs)
                end = max(s + dur for _, s, dur in evs)
                best = min(best, (end - start) / 1e6 / steps)
            else:
                if strict:
                    raise RuntimeError(
                        "timed_steps: CUDA profiler session has no device "
                        "events — refusing to report host-clock numbers "
                        "in strict mode.")
                print("timed_steps: WARNING — no device events in the CUDA "
                      "profiler session; falling back to host wall clock "
                      "(includes dispatch overhead).", file=sys.stderr)
                if info is not None:
                    info["timing"] = "host-fallback"
                best = min(best, wall / steps)
        else:
            t0 = time.perf_counter()
            run_once()
            best = min(best, (time.perf_counter() - t0) / steps)
    return best


def _merge_async(events):
    """Merge ``-start``/``-done`` pairs into one span; pass others through.

    Returns [(base, start_us, end_us)] sorted by start.
    """
    merged = []
    pending = {}  # instr suffix key -> (base, start)
    for name, start, dur in events:
        base = kernel_base(name)
        if base.endswith("-start"):
            key = _instr_key(name).replace("-start", "")
            pending[key] = (base[:-6], start)
            continue
        if base.endswith("-done"):
            key = _instr_key(name).replace("-done", "")
            if key in pending:
                b, s = pending.pop(key)
                merged.append((b, s, start + dur))
                continue
            base = base[:-5]
        merged.append((base, start, start + dur))
    # Unterminated -start pairs: emit what we saw.
    for b, s in pending.values():
        merged.append((b, s, s))
    merged.sort(key=lambda t: t[1])
    return merged


def map_device_spans(schedule, events):
    """Map device events onto the negotiated schedule.

    ``schedule``: [[name, op, dtype, shape, group, root, members], ...] in
    record order. ``events``: [(kernel_name, start_us, dur_us)] in device
    order. Returns [(row, activity, start_us, dur_us)], session-relative
    times.
    """
    if not events:
        return []
    spans = []
    merged = _merge_async(events)
    start0 = min(s for _, s, _ in merged)
    end_last = max(e for _, _, e in merged)
    spans.append(("_device", "DEVICE_STEP", start0, end_last - start0))

    colls = [(b, s, e) for b, s, e in merged if _COLL_KIND.get(b)]
    queue = list(schedule)
    matched = []  # (tensor_row, kind, start, end, members)
    for base, s, e in colls:
        kind = _COLL_KIND[base]
        for i, entry in enumerate(queue):
            accepts = _SCHED_ACCEPTS.get(entry[1], {entry[1]})
            if kind in accepts:
                members = tuple(entry[6]) if len(entry) > 6 else ()
                matched.append((entry[0], kind, s, e, members))
                del queue[i]
                break
    for row, kind, s, e, members in matched:
        spans.append((row, f"XLA_{kind}", s, e - s))
        # A fusion bucket's span repeats on each member tensor's row, the
        # bucket's row named in the activity.
        for m in members:
            spans.append((m, f"XLA_{kind} [{row}]", s, e - s))

    # Pack/unpack: an op qualifies only when it lies wholly inside one gap
    # between two adjacent matched collectives (start of the trace counts
    # as a gap edge for packs, its end for unpacks).
    if matched:
        windows = sorted([(s, e) for _, _, s, e, _ in matched])
        for base, s, e in merged:
            if base not in _PACK_BASES and base not in _UNPACK_BASES:
                continue
            pi = next((i for i in reversed(range(len(windows)))
                       if windows[i][1] <= s), None)
            ni = next((i for i in range(len(windows))
                       if windows[i][0] >= e), None)
            adjacent = (pi is not None and ni is not None
                        and ni == pi + 1)
            if base in _PACK_BASES and (
                    adjacent or (pi is None and ni == 0)):
                spans.append(("_fusion_buffer",
                              "MEMCPY_IN_FUSION_BUFFER", s, e - s))
            elif base in _UNPACK_BASES and (
                    adjacent or (ni is None and pi == len(windows) - 1)):
                spans.append(("_fusion_buffer",
                              "MEMCPY_OUT_FUSION_BUFFER", s, e - s))
    return spans


def kernel_spans(events) -> list:
    """``[("_kernels", function, start_us, dur_us)]``: the launches of the
    port's own kernels among ``events``, named by their device function."""
    from horovod_tpu_torch.ops import launches as _launches

    names = {f for fs in _launches.KERNELS.values() for f in fs}
    out = []
    for name, start, dur in events:
        base = kernel_base(name)
        if base in names:
            out.append(("_kernels", base, start, dur))
    return out


def step_span_rows(spans, events) -> list:
    """``[("_step", "STEP_<NAME>", start_us, dur_us)]``: the step spans of
    the call a profiler session ran (``core/timeline.py::step_spans``) on
    the session's clock, the latest span end placed at the end of the last
    device event (the replay's output copies after the step cost a few
    µs); ``[]`` without spans or device events."""
    if not spans or not events:
        return []
    end_us = max(s + d for _, s, d in events)
    zero = end_us - 1e3 * max(e for _, _, _, e, _ in spans)
    return [("_step", f"STEP_{name.upper()}", zero + 1e3 * start,
             1e3 * (stop - start)) for name, _, start, stop, _ in spans]

"""The benchmark's yardstick for device traces: kernel names, categories and
interval arithmetic, frozen here so that a later change to the program
cannot move what the per-layer metrics read.

* :func:`kernel_base` is a copy of ``horovod_tpu_torch/core/xprof.py::
  kernel_base`` (NCCL's kernels by the collective they run, any other
  kernel by its function's unqualified name);
* :func:`category` is a copy of ``tools/profile_torch_step.py``'s
  ``_OWN``/``_CATEGORIES`` table (first match wins);
* :func:`union` and :func:`exposed` are a copy of
  ``horovod_tpu_torch/ops/exchange.py::exposed_comm_from_spans``'s union
  arithmetic.

A span is ``(start, duration)`` in one unit (µs from the profiler).
"""

from __future__ import annotations

import re

# -- kernel names (copy of core/xprof.py::kernel_base) ------------------------

_NCCL_KERNEL = re.compile(r"nccl(?:Dev)?Kernel_([A-Za-z]+)")
_NCCL_BASE = {
    "AllReduce": "all-reduce",
    "AllGather": "all-gather",
    "ReduceScatter": "reduce-scatter",
    "Broadcast": "collective-broadcast",
    "SendRecv": "collective-permute",
}
COLLECTIVES = frozenset(_NCCL_BASE.values()) | {"all-to-all"}


def kernel_base(name: str) -> str:
    """The opcode a device event stands for: NCCL's collectives by their
    HLO names, the fusion buffer's pack and unpack copies as
    ``concatenate`` and ``slice``, any other kernel by its function's
    unqualified name."""
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


def is_comm(name: str) -> bool:
    """Whether a device event is one of NCCL's collective kernels."""
    return kernel_base(name) in COLLECTIVES or "nccl" in name.lower()


# -- categories (copy of tools/profile_torch_step.py) -------------------------

_OWN = (  # the port's kernels, by category
    ("bn_channel_sums", ("channel_sums_ring_kernel", "channel_sums_kernel",
                         "channel_grad_sums_kernel", "finalize_kernel")),
    ("flash_attention", ("flash_fwd_kernel", "flash_bwd_dkdv_kernel",
                         "flash_bwd_dq_kernel")),
    ("adamw", ("adamw_kernel",)),
)
_CATEGORIES = (  # first match wins
    ("nccl", ("nccl",)),
    ("conv_and_matmul", ("conv", "gemm", "xmma", "cutlass", "cudnn",
                         "implicit", "wgrad", "dgrad", "fprop", "sm90",
                         "nvjet")),
    ("reduction", ("reduce_kernel",)),
    ("copy_and_cast", ("copy", "memcpy", "memset")),
    ("elementwise", ("elementwise",)),
)


def category(name: str) -> str:
    for cat, keys in _OWN:
        if any(k in name for k in keys):
            return cat
    low = name.lower()
    for cat, keys in _CATEGORIES:
        if any(k in low for k in keys):
            return cat
    return "other"


# -- intervals (copy of ops/exchange.py::exposed_comm_from_spans) -------------

def union(spans) -> list[tuple[float, float]]:
    """The union of ``(start, duration)`` spans as sorted, disjoint
    ``(start, end)`` intervals; empty spans are left out."""
    ivs = sorted((s, s + d) for s, d in spans if d > 0)
    out: list[tuple[float, float]] = []
    for s, e in ivs:
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def covered(spans) -> float:
    """The length of the union of ``spans``."""
    return sum(e - s for s, e in union(spans))


def exposed(comm_spans, compute_spans) -> float:
    """The part of the union of ``comm_spans`` that the union of
    ``compute_spans`` does not cover."""
    comm = union(comm_spans)
    compute = union(compute_spans)
    out = 0.0
    for cs, ce in comm:
        hidden = 0.0
        for ks, ke in compute:
            lo, hi = max(cs, ks), min(ce, ke)
            if hi > lo:
                hidden += hi - lo
        out += (ce - cs) - hidden
    return out


def gaps(spans, start: float, end: float) -> list[tuple[float, float]]:
    """The idle ``(start, duration)`` stretches of ``[start, end]`` that no
    span covers, longest first."""
    out = []
    t = start
    for s, e in union(spans):
        if s > t:
            out.append((t, s - t))
        t = max(t, e)
    if end > t:
        out.append((t, end - t))
    return sorted(out, key=lambda g: -g[1])


# -- what a profiled slice of steps holds ------------------------------------

class RankTrace:
    """One rank's profiled slice of steady steps and what the per-layer
    readers need around it. ``events``: ``[(name, start_us, dur_us)]`` of
    the device's kernels and copies; ``host``: ``[(name, start_us, dur_us,
    depth)]`` of the host's operations in the same clock; ``slice_s``: the
    slice's length, from the first step's start to the last step's end on
    the device; ``steps``: the steps in the slice; ``work``: the cell's
    counts (``hvdbench/work.py``)."""

    def __init__(self, events, host, slice_s: float, start_us: float,
                 steps: int, unit: str, work: dict) -> None:
        self.events = events
        self.host = host
        self.slice_s = slice_s
        self.start_us = start_us
        self.steps = steps
        self.unit = unit
        self.work = work

    def spans(self, match=None) -> list[tuple[float, float]]:
        """``(start, dur)`` of the events whose name ``match`` accepts (all
        when None)."""
        return [(s, d) for n, s, d in self.events
                if match is None or match(n)]

    def device_us(self, match=None) -> float:
        """Summed device µs of the matching events."""
        return sum(d for n, _, d in self.events if match is None or match(n))

    def busy_us(self) -> float:
        return covered(self.spans())

    def per_step_ms(self, us: float) -> float:
        return us / 1e3 / self.steps


def named(*names: str):
    """A match for events whose name contains one of ``names``."""
    return lambda n: any(k in n for k in names)


def top_ops(trace: RankTrace, n: int = 10) -> list[list]:
    """The ``n`` device operations (by :func:`kernel_base`) with the most
    time, ``[[name, seconds a step], ...]``."""
    by: dict[str, float] = {}
    for name, _, dur in trace.events:
        base = kernel_base(name)
        by[base] = by.get(base, 0.0) + dur
    top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
    return [[k, v / 1e6 / trace.steps] for k, v in top]


def idle_gaps(trace: RankTrace, n: int = 10) -> list[list]:
    """The ``n`` longest stretches of the slice in which the device ran
    nothing, each named by the innermost host operation running at its
    start (``host idle`` where none ran), ``[[name, seconds], ...]``."""
    end = trace.start_us + trace.slice_s * 1e6
    out = []
    for start, dur in gaps(trace.spans(), trace.start_us, end)[:n]:
        inner = [(depth, name) for name, s, d, depth in trace.host
                 if s <= start < s + d]
        out.append([max(inner)[1] if inner else "host idle", dur / 1e6])
    return out

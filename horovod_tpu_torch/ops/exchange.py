"""Whole-step exchange planner: plan the ENTIRE gradient exchange.

Counterpart of ``horovod_tpu/ops/exchange.py`` (its planner, artifact and
exposed-communication accounting). The plan is computed on the host once
per gradient signature, and its buckets are issued in the plan's order;
a captured step replays them in that order.

**Priority ordering**: backward produces gradients in reverse layer order,
so issuing buckets in *reverse enumeration* order lets each bucket's
collective start while the rest of the backward pass is still computing:
``DistributedOptimizer``'s armed step issues each bucket from backward
once its gradients are accumulated and the buckets before it have gone
(``parallel/optimizer.py``), so under ``enum`` the first layers' bucket,
ready last, holds every bucket to the end of backward. An optional ``priority_fn(label,
index) -> key`` re-ranks the gradients (lower key = issued earlier; ties
keep reverse enumeration). Pure and deterministic: identical on every
rank for identical shapes.

**Per-region bucket sizing**: the reversed sequence is split into
``N_REGIONS`` byte-quantile regions whose thresholds ramp geometrically
from a cost-model floor up to the fusion threshold, power-of-two
quantized. The floor comes from the topology's seed links, never from
the per-host tuning cache, so every rank computes the same plan. When the
compressor couples a bucket's members (a shared scale or block grid:
``Compressor.elementwise`` False), the planner keeps the enumeration
plan's bucket membership and reorders its issue only, so the numbers stay
bit-exact.

**Channels**: ``channels=`` (``HOROVOD_EXCHANGE_CHANNELS``) stamps every
eligible bucket; otherwise the cheapest power-of-two count up to
``max_channels`` (``HOROVOD_MAX_CHANNELS``, default 1 = off) from the
per-channel α–β model (``utils/costs.py``).

The committed plan is an :class:`ExchangeSchedule`, a JSON artifact
(``.exchange.json``) whose bytes and hash equal the JAX package's for the
same inputs: its layout names no interconnect level, and dtypes are
written by numpy's names (``float32``, ``bfloat16``, ``int8``).

**The measured half**: ``plan_exchange(compute_window_s=)`` takes the
tuner's measured compute window into the sizing floor;
:func:`measured_exposed_comm_ms` reads exposed communication off a
profiler session; the :class:`Recalibrator` refits the α–β constants from
measured collectives and persists them to the tuning cache (levels
``nvlink``/``ib``), fed by the device timeline's sampled calls through
:func:`observe_xla_spans` (``HOROVOD_RECALIBRATION``, default on). The
planner itself never reads the cache (above); ``HOROVOD_AUTOTUNE=1`` and
``hvd.tune()`` do.
"""

from __future__ import annotations

import dataclasses
import json
import zlib

import torch

from horovod_tpu_torch.core.state import HorovodError
from horovod_tpu_torch.ops import fusion as _fusion
from horovod_tpu_torch.utils import costs as _costs
from horovod_tpu_torch.utils import env as _env

# The reference's artifact layout, byte for byte.
ARTIFACT_SCHEMA = "horovod_tpu/exchange-schedule/v1"

MODES = ("enum", "priority")

# Regions of the per-layer sizing ramp.
N_REGIONS = 4


def resolve_mode(spec) -> str:
    """Normalize a ``schedule=`` argument: ``None`` defers to
    ``HOROVOD_EXCHANGE_SCHEDULE`` (default ``enum``); strings are
    validated — typos raise."""
    if spec is None:
        return _env.exchange_schedule_default()
    if not isinstance(spec, str):
        raise HorovodError(
            f"schedule= must be None or a string, got "
            f"{type(spec).__name__}.")
    value = spec.strip().lower()
    if value not in MODES:
        raise HorovodError(
            f"Unknown exchange schedule {spec!r}; choose one of "
            f"{list(MODES)} (HOROVOD_EXCHANGE_SCHEDULE / schedule=).")
    return value


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


@dataclasses.dataclass(frozen=True)
class ElasticMeta:
    """Provenance of an elastically re-planned schedule: the surviving
    global ranks, the ranks the transition dropped and the runtime
    generation. Serialized only when present: ``core/elastic.py`` stamps
    the plans of a shrink and a regrow (``with_elastic``)."""

    survivors: tuple[int, ...]
    dropped: tuple[int, ...]
    generation: int


@dataclasses.dataclass(frozen=True)
class FsdpMeta:
    """The plan's FSDP section: the sharding mode, the mesh factorization,
    and for zero3 the gather order with each leaf's gathered bytes and
    wire dtype. Serialized only when present (ROADMAP §A item 12(d) makes
    it)."""

    mode: str                       # "zero2" | "zero3"
    fsdp_size: int
    data_size: int
    gather_order: tuple[int, ...]   # leaf indices, issue order (zero3)
    leaf_bytes: tuple[int, ...]     # gathered bytes per leaf, leaf order
    wire_dtypes: tuple[str, ...]    # gather wire dtype per leaf


@dataclasses.dataclass(frozen=True)
class ExchangeSchedule:
    """The committed whole-step exchange plan.

    ``buckets`` are :class:`~horovod_tpu_torch.ops.fusion.Bucket` records
    in issue order (``bucket.priority`` == position); ``members`` carries
    each bucket's gradient labels (empty tuples when the caller had
    none). ``leaf_bytes`` are the logical bytes of every gradient in
    enumeration order. ``sparse_buckets`` are the plan's sparse
    exchanges (:class:`~horovod_tpu_torch.ops.fusion.SparseBucket`),
    serialized only when present.
    """

    mode: str
    world_size: int
    num_slices: int
    threshold_bytes: int
    region_thresholds: tuple[int, ...]
    leaf_bytes: tuple[int, ...]
    buckets: tuple[_fusion.Bucket, ...]
    members: tuple[tuple[str, ...], ...]
    sparse_buckets: tuple = ()
    elastic: ElasticMeta | None = None
    fsdp: FsdpMeta | None = None

    def to_json(self) -> str:
        """Canonical (sorted-keys, compact) JSON: byte-identical across
        processes for identical inputs, and to the JAX package's."""
        data = {
            "schema": ARTIFACT_SCHEMA,
            "mode": self.mode,
            "world_size": self.world_size,
            "num_slices": self.num_slices,
            "threshold_bytes": self.threshold_bytes,
            "region_thresholds": list(self.region_thresholds),
            "leaf_bytes": list(self.leaf_bytes),
            "buckets": [
                self._bucket_row(b, m)
                for b, m in zip(self.buckets, self.members)
            ],
        }
        # The optional sections serialize only when present, so a plan
        # without them keeps its bytes and hash.
        if self.sparse_buckets:
            data["sparse_buckets"] = [self._sparse_row(b)
                                      for b in self.sparse_buckets]
        if self.elastic is not None:
            data["elastic"] = {
                "survivors": list(self.elastic.survivors),
                "dropped": list(self.elastic.dropped),
                "generation": self.elastic.generation,
            }
        if self.fsdp is not None:
            data["fsdp"] = {
                "mode": self.fsdp.mode,
                "fsdp_size": self.fsdp.fsdp_size,
                "data_size": self.fsdp.data_size,
                "gather_order": list(self.fsdp.gather_order),
                "leaf_bytes": list(self.fsdp.leaf_bytes),
                "wire_dtypes": list(self.fsdp.wire_dtypes),
            }
        return json.dumps(data, sort_keys=True, separators=(",", ":"))

    @staticmethod
    def _bucket_row(b: _fusion.Bucket, m) -> dict:
        name = _fusion._dtype_name
        row = {
            "priority": b.priority,
            "indices": list(b.indices),
            "dtype": name(b.dtype),
            "total_bytes": b.total_bytes,
            "wire_dtype": (None if b.wire_dtype is None
                           else name(b.wire_dtype)),
            "algo": b.algo,
            "members": list(m),
        }
        # Set only where they differ from the default, as in the
        # reference, so single-wire single-channel plans keep their hash.
        if b.channels != 1:
            row["channels"] = b.channels
        if b.wire_bits:
            row["wire_bits"] = b.wire_bits
        if b.cross_wire_dtype is not None:
            row["cross_wire_dtype"] = name(b.cross_wire_dtype)
            if b.cross_wire_bits:
                row["cross_wire_bits"] = b.cross_wire_bits
            if b.intra_wire_dtype is not None:
                row["intra_wire_dtype"] = name(b.intra_wire_dtype)
        return row

    @staticmethod
    def _sparse_row(b: _fusion.SparseBucket) -> dict:
        name = _fusion._dtype_name
        row = {
            "leaf": b.index,
            "dtype": name(b.dtype),
            "rows": b.rows,
            "row_elems": b.row_elems,
            "dense_rows": b.dense_rows,
            "algo": b.algo,
            "index_itemsize": b.index_itemsize,
        }
        if b.label:
            row["label"] = b.label
        if b.wire_dtype is not None:
            row["wire_dtype"] = name(b.wire_dtype)
            if b.wire_bits:
                row["wire_bits"] = b.wire_bits
        return row

    def plan_hash(self) -> str:
        """Stable 8-hex-digit identity of the plan: crc32 of the
        canonical JSON."""
        return f"{zlib.crc32(self.to_json().encode('utf-8')) & 0xFFFFFFFF:08x}"

    def save(self, path: str) -> str:
        """Write the artifact (pretty-printed; the hash is computed over
        the canonical form, so formatting doesn't change identity)."""
        with open(path, "w") as f:
            json.dump(json.loads(self.to_json()), f, indent=1,
                      sort_keys=True)
            f.write("\n")
        return path

    @staticmethod
    def from_json(text: str) -> "ExchangeSchedule":
        """Parse a serialized artifact; an unknown schema raises (never
        field-guessed)."""
        try:
            data = json.loads(text)
        except ValueError as e:
            raise HorovodError(f"unreadable ExchangeSchedule JSON: {e}")
        if not isinstance(data, dict) \
                or data.get("schema") != ARTIFACT_SCHEMA:
            raise HorovodError(
                f"ExchangeSchedule schema mismatch: expected "
                f"{ARTIFACT_SCHEMA!r}, got {data.get('schema')!r} — "
                f"refusing to guess a stale layout.")
        buckets, members = [], []
        for row in data["buckets"]:
            buckets.append(_fusion.Bucket(
                indices=tuple(row["indices"]),
                dtype=_dtype(row["dtype"]),
                total_bytes=int(row["total_bytes"]),
                wire_dtype=(None if row["wire_dtype"] is None
                            else _dtype(row["wire_dtype"])),
                algo=row["algo"],
                priority=int(row["priority"]),
                wire_bits=int(row.get("wire_bits", 0)),
                intra_wire_dtype=(_dtype(row["intra_wire_dtype"])
                                  if row.get("intra_wire_dtype") else None),
                cross_wire_dtype=(_dtype(row["cross_wire_dtype"])
                                  if row.get("cross_wire_dtype") else None),
                cross_wire_bits=int(row.get("cross_wire_bits", 0)),
                channels=int(row.get("channels", 1))))
            members.append(tuple(row["members"]))
        sparse = []
        for row in data.get("sparse_buckets", []):
            sparse.append(_fusion.SparseBucket(
                index=int(row["leaf"]),
                dtype=_dtype(row["dtype"]),
                rows=int(row["rows"]),
                row_elems=int(row["row_elems"]),
                dense_rows=int(row["dense_rows"]),
                algo=row["algo"],
                wire_dtype=(_dtype(row["wire_dtype"])
                            if row.get("wire_dtype") else None),
                wire_bits=int(row.get("wire_bits", 0)),
                index_itemsize=int(row.get("index_itemsize", 4)),
                label=row.get("label", "")))
        el = data.get("elastic")
        elastic = (None if el is None else ElasticMeta(
            survivors=tuple(int(r) for r in el["survivors"]),
            dropped=tuple(int(r) for r in el["dropped"]),
            generation=int(el["generation"])))
        fs = data.get("fsdp")
        fsdp = (None if fs is None else FsdpMeta(
            mode=str(fs["mode"]),
            fsdp_size=int(fs["fsdp_size"]),
            data_size=int(fs["data_size"]),
            gather_order=tuple(int(i) for i in fs["gather_order"]),
            leaf_bytes=tuple(int(b) for b in fs["leaf_bytes"]),
            wire_dtypes=tuple(str(d) for d in fs["wire_dtypes"])))
        return ExchangeSchedule(
            mode=data["mode"],
            world_size=int(data["world_size"]),
            num_slices=int(data["num_slices"]),
            threshold_bytes=int(data["threshold_bytes"]),
            region_thresholds=tuple(data["region_thresholds"]),
            leaf_bytes=tuple(data["leaf_bytes"]),
            buckets=tuple(buckets),
            members=tuple(members),
            sparse_buckets=tuple(sparse),
            elastic=elastic,
            fsdp=fsdp)

    def with_elastic(self, survivors, dropped,
                     generation: int) -> "ExchangeSchedule":
        """A copy of the plan stamped with elastic provenance (a new plan
        hash)."""
        return dataclasses.replace(self, elastic=ElasticMeta(
            survivors=tuple(int(r) for r in survivors),
            dropped=tuple(int(r) for r in dropped),
            generation=int(generation)))

    def with_fsdp(self, meta: FsdpMeta) -> "ExchangeSchedule":
        """A copy of the plan carrying the FSDP section (a new plan
        hash)."""
        return dataclasses.replace(self, fsdp=meta)

    def describe_rows(self) -> list[str]:
        """One line per exchange in issue order: the sparse exchanges
        (issued first), then the buckets."""
        return ([b.describe() for b in self.sparse_buckets]
                + [b.describe() for b in self.buckets])


# -- planning ---------------------------------------------------------------


def _pow2(x: int) -> int:
    """Round to the nearest power of two (>= 1): a calibrated constant
    must move 2x before the plan moves."""
    if x <= 1:
        return 1
    lower = 1 << (x.bit_length() - 1)
    return lower << 1 if x - lower > (lower >> 1) else lower


def _region_thresholds(base: int, model, topo,
                       compute_window_s: float | None) -> tuple[int, ...]:
    """Per-region bucket-size thresholds in issue order (small early,
    large late), power-of-two quantized. ``base`` (the fusion threshold)
    is the ceiling; the floor is the α–β model's 90%-busbw point / 8 and,
    when a measured compute window is known, at least the bytes a
    1/(2R)-window chunk of communication carries."""
    if base <= 0:
        return ()  # fusion disabled: every leaf is its own bucket
    floor = max(1, base >> (N_REGIONS - 1))
    hint = None
    if model is not None and topo is not None and topo.group_size > 1:
        hint = model.fusion_threshold_bytes(topo) >> 3
        if compute_window_s is not None and compute_window_s > 0:
            link = model.ib if topo.multi_slice else model.nvlink
            window_bytes = int(link.gbps * 1e9 * compute_window_s
                               / (2 * N_REGIONS))
            hint = max(hint, window_bytes)
        hint = min(base, max(1 << 20, _pow2(hint)))
    if hint is not None:
        floor = min(base, max(floor, hint))
    out = [min(base, _pow2(floor << k)) for k in range(N_REGIONS)]
    out[-1] = base
    return tuple(out)


def _plan_ordered(order, leaves, thresholds, total_bytes):
    """Bucket the leaf sequence ``order`` (original indices) into
    contiguous same-dtype runs, each region's threshold chosen by the
    cumulative byte position."""
    buckets: list[_fusion.Bucket] = []
    cur: list[int] = []
    cur_dtype = None
    cur_bytes = 0
    seen_bytes = 0
    n_regions = max(1, len(thresholds))

    def threshold_at(pos_bytes: int) -> int:
        if not thresholds:
            return 0
        region = min(n_regions - 1,
                     pos_bytes * n_regions // max(1, total_bytes))
        return thresholds[region]

    def flush():
        nonlocal cur, cur_bytes
        if cur:
            buckets.append(_fusion.Bucket(tuple(cur), cur_dtype, cur_bytes))
            cur, cur_bytes = [], 0

    for i in order:
        leaf = leaves[i]
        nbytes = _fusion.leaf_bytes(leaf)
        limit = threshold_at(seen_bytes)
        seen_bytes += nbytes
        if limit <= 0:
            flush()
            buckets.append(_fusion.Bucket((i,), leaf.dtype, nbytes))
            cur_dtype = None
            continue
        if cur and (leaf.dtype != cur_dtype
                    or cur_bytes + nbytes > limit):
            flush()
        cur_dtype = leaf.dtype
        cur.append(i)
        cur_bytes += nbytes
    flush()
    return buckets


def plan_exchange(leaves, threshold_bytes: int, *, mode: str,
                  compression=None, algo=None, labels=None,
                  topo=None, model=None, world_size: int | None = None,
                  priority_fn=None,
                  compute_window_s: float | None = None,
                  cross_compression=None,
                  channels: int | None = None,
                  max_channels: int | None = None,
                  sparse=None) -> ExchangeSchedule:
    """Plan the whole-step exchange over ``leaves`` (tensors, or any
    object with ``.numel()`` or ``.size`` and a ``.dtype``: only sizes and
    dtypes are read, so meta tensors do).

    ``mode``: ``enum`` is the enumeration plan of
    :func:`~horovod_tpu_torch.ops.fusion.plan_buckets` exactly;
    ``priority`` applies reverse-layer issue order and per-region sizing.
    ``compression`` is a resolved compressor or None; ``algo`` a name or
    a per-bucket selector. ``topo``/``model`` feed the sizing floor and
    the artifact's partition shape; omitted, the plan is world
    ``world_size`` (default 1), one slice, byte-ramp floor only.

    Cross-rank determinism: without an explicit ``model`` the floor and
    the channel model come from the topology's seed links
    (``CostModel(nvlink=topo.nvlink, ib=topo.ib)``), never from the
    per-host tuning cache: a cache-fed floor could cross a power-of-two
    boundary on one rank only and split the ranks across two plans. Pass
    ``model=`` only when every rank is guaranteed the same constants.

    ``compute_window_s``: a measured compute window of the step (the
    tuner's profile, ``tune/calibrate.py``), which raises the priority
    plan's sizing floor to what a window's share of the wire carries.

    ``channels``: explicit channel count for every eligible bucket;
    ``max_channels``: cap of the planner's per-bucket choice (default 1 =
    channelization off). ``sparse``: the step's sparse exchange rows
    (``ops/sparse.py::plan_sparse_exchange``), recorded on the plan."""
    leaves = list(leaves)
    if mode not in MODES:
        raise HorovodError(f"unknown exchange mode {mode!r}")
    if labels is not None and len(labels) != len(leaves):
        raise HorovodError(
            f"plan_exchange: {len(labels)} labels for {len(leaves)} "
            f"leaves.")
    leaf_bytes = tuple(_fusion.leaf_bytes(l) for l in leaves)
    world = (topo.group_size if topo is not None
             else (world_size or 1))
    slices = topo.num_slices if topo is not None else 1
    if model is None and topo is not None:
        model = _costs.CostModel(nvlink=topo.nvlink, ib=topo.ib)

    comp_elementwise = (compression is None
                        or getattr(compression, "elementwise", False))
    regions: tuple[int, ...] = ()
    if mode == "enum":
        buckets = _fusion.plan_buckets(leaves, threshold_bytes,
                                       compression=compression, algo=algo,
                                       group_size=world,
                                       cross_compression=cross_compression)
    elif not comp_elementwise:
        # Scale-coupled compressor (int8 and the block formats): bucket
        # membership IS numerics, so keep the enumeration plan's
        # membership and reverse its issue order only.
        planned = _fusion.plan_buckets(leaves, threshold_bytes,
                                       compression=compression, algo=algo,
                                       group_size=world,
                                       cross_compression=cross_compression)
        buckets = [dataclasses.replace(b, priority=i)
                   for i, b in enumerate(reversed(planned))]
    else:
        order = list(range(len(leaves)))[::-1]  # reverse enumeration
        if priority_fn is not None:
            def key(i):
                label = labels[i] if labels is not None else str(i)
                # Stable among equal keys: keep reverse-enumeration order.
                return (priority_fn(label, i), -i)
            order = sorted(range(len(leaves)), key=key)
        regions = _region_thresholds(threshold_bytes, model, topo,
                                     compute_window_s)
        raw = _plan_ordered(order, leaves, regions, sum(leaf_bytes))
        raw = _fusion._annotate_algo(
            _fusion._annotate_wire(raw, compression, world), algo)
        raw = _fusion._annotate_phase_wire(raw, compression,
                                           cross_compression)
        buckets = [dataclasses.replace(b, priority=i)
                   for i, b in enumerate(raw)]
    buckets = _assign_channels(buckets, topo, model, world, slices,
                               channels, max_channels, compression)
    members = tuple(
        tuple(labels[i] for i in b.indices) if labels is not None else ()
        for b in buckets)
    return ExchangeSchedule(
        mode=mode, world_size=world, num_slices=slices,
        threshold_bytes=int(threshold_bytes),
        region_thresholds=regions, leaf_bytes=leaf_bytes,
        buckets=tuple(buckets), members=members,
        sparse_buckets=tuple(sparse or ()))


def _assign_channels(buckets, topo, model, world: int, slices: int,
                     channels: int | None,
                     max_channels: int | None, compression) -> list:
    """Stamp each bucket's channel count: ``channels`` wins outright;
    otherwise the per-channel α–β model's cheapest power-of-two count
    <= ``max_channels``. Both resolve to 1 on 1-rank worlds and for a
    bucket whose algorithm is not a concrete decomposition, and a count is
    clamped to the units its lowering can cut
    (:func:`~horovod_tpu_torch.ops.fusion._split_units`)."""
    if channels is not None and channels < 1:
        raise HorovodError(
            f"plan_exchange: channels must be >= 1, got {channels}.")
    cap = 1 if max_channels is None else int(max_channels)
    if (channels is None and cap <= 1) or world <= 1:
        return buckets
    out = []
    for b in buckets:
        c = 1
        if b.algo in _costs.ALGORITHMS:
            if channels is not None:
                c = channels
            elif model is not None and topo is not None:
                kwargs = {}
                if b.algo == "hierarchical" \
                        and b.cross_wire_dtype is not None:
                    kwargs["cross_nbytes"] = b.cross_bytes_on_wire
                    nbytes = b.intra_bytes_on_wire
                else:
                    nbytes = b.bytes_on_wire
                if b.wire_bits == 4 and b.algo == "flat":
                    kwargs["gather"] = True  # int4 gather-form pricing
                c = model.choose_channels(b.algo, nbytes, topo, cap,
                                          **kwargs)
            c = max(1, min(c, _fusion._split_units(b, world, slices,
                                                   compression)))
        out.append(dataclasses.replace(b, channels=c) if c != b.channels
                   else b)
    return out


# -- exposed-communication accounting ------------------------------------------


def planned_exposed_comm_ms(sched: ExchangeSchedule, topo, model,
                            compute_ms: float,
                            comm_scale: float = 1.0) -> float:
    """The α–β model's exposed (non-overlapped) communication of one step
    under ``sched``, in ms — a prediction, not a measurement.

    Backward runs ``[0, compute_ms]`` producing gradients in reverse
    enumeration order at a rate proportional to their bytes; a bucket's
    collective starts once its members exist and every earlier-issued
    collective has finished (one serial wire), and lasts the model's
    prediction for its wire bytes (x ``comm_scale``). Exposed time is the
    wire-busy time after compute ends."""
    total = sum(sched.leaf_bytes) or 1
    ready_at = {}
    cum = 0
    for i in reversed(range(len(sched.leaf_bytes))):
        cum += sched.leaf_bytes[i]
        ready_at[i] = compute_ms * cum / total
    t = 0.0
    exposed = 0.0
    for b in sched.buckets:
        ready = max((ready_at[i] for i in b.indices), default=0.0)
        algo = b.algo
        if algo == "auto":
            algo = (model.choose(b.bytes_on_wire, topo)
                    if model is not None and topo is not None else "flat")
        dur = 0.0
        if model is not None and topo is not None and topo.group_size > 1:
            if algo == "hierarchical" and b.cross_wire_dtype is not None:
                pred = model.predict_us(
                    algo, b.intra_bytes_on_wire, topo,
                    cross_nbytes=b.cross_bytes_on_wire,
                    channels=b.channels)
            else:
                pred = model.predict_us(algo, b.bytes_on_wire, topo,
                                        channels=b.channels)
            if pred != float("inf"):
                dur = pred * 1e-3 * comm_scale
        start = max(t, ready)
        end = start + dur
        if end > compute_ms:
            exposed += end - max(start, compute_ms)
        t = end
    return exposed


def exposed_comm_from_spans(comm_spans, compute_spans) -> float:
    """Exposed communication from measured spans: the part of the union
    of ``comm_spans`` not covered by the union of ``compute_spans``.
    Spans are ``(start, duration)`` in one unit; the result is in it."""
    def union(spans):
        ivs = sorted((s, s + d) for s, d in spans if d > 0)
        out = []
        for s, e in ivs:
            if out and s <= out[-1][1]:
                out[-1] = (out[-1][0], max(out[-1][1], e))
            else:
                out.append((s, e))
        return out

    comm = union(comm_spans)
    compute = union(compute_spans)
    exposed = 0.0
    for cs, ce in comm:
        covered = 0.0
        for ks, ke in compute:
            lo, hi = max(cs, ks), min(ce, ke)
            if hi > lo:
                covered += hi - lo
        exposed += (ce - cs) - covered
    return exposed


def measured_exposed_comm_ms(run_once, steps: int = 1) -> float | None:
    """Exposed communication per step as the device ran it: one call of
    ``run_once`` under ``torch.profiler``, its device events split into
    communication (NCCL's collectives, ``core/xprof.py``'s classifier) and
    compute (every other kernel or copy), and the non-overlapped
    communication ms through :func:`exposed_comm_from_spans`. None when
    the session has no device events (the CPU): callers fall back to the
    planned estimate."""
    from horovod_tpu_torch.core import xprof as _xprof

    events = _xprof.profiled_events(run_once)[1]
    if not events:
        return None
    comm, compute = [], []
    for name, start, dur in events:
        base = _xprof.kernel_base(name)
        base = base.removesuffix("-start").removesuffix("-done")
        (comm if base in _xprof._COLL_KIND else compute).append(
            (start, dur))
    return exposed_comm_from_spans(comm, compute) / 1e3 / max(1, steps)


# -- always-on α–β recalibration --------------------------------------------


def _itemsize(dtype) -> int:
    """Bytes an element of a schedule row's dtype name (``float32`` or
    ``torch.float32``)."""
    name = str(dtype).removeprefix("torch.")
    return torch.empty((), dtype=getattr(torch, name)).element_size()


class Recalibrator:
    """Online least-squares refresh of the α–β constants from measured
    collective times, persisted to the tuning cache (``utils/costs.py``).

    Per level (``"nvlink"``/``"ib"``) the running sums of a straight-line
    fit ``t = α + x/β`` over the ring-normalized regressor ``x = ring·S``
    are kept (n, Σx, Σt, Σxt, Σx²), so samples of different world sizes,
    and sums continued from a prior run's cache, mix correctly; every
    ``PERSIST_EVERY`` observations the merged constants are written to
    ``HOROVOD_TUNING_CACHE``, continuing a prior run's sums (its
    ``recalibration`` section; a cache of another schema or device kind
    is ignored). Constants are rounded (α to 0.01 µs, β to 0.001 GB/s) so
    that equal measurements write byte-identical caches on every rank.
    The reference's class, with the port's level names."""

    PERSIST_EVERY = 8

    def __init__(self) -> None:
        self._sums: dict[str, dict] = {}
        self._since_persist = 0
        self._seeded = False

    # -- observation ---------------------------------------------------------

    def observe(self, level: str, nbytes: int, seconds: float,
                world: int) -> None:
        """One measured collective: ``nbytes`` on the wire took
        ``seconds`` over a ``world``-rank group at interconnect
        ``level``. A world of one rank moves nothing and is ignored."""
        if nbytes <= 0 or seconds <= 0 or world < 2:
            return
        x = 2 * (world - 1) / world * float(nbytes)  # ring-normalized
        s = self._sums.setdefault(level, dict(
            n=0, s=0.0, t=0.0, st=0.0, ss=0.0))
        s["n"] += 1
        s["s"] += x
        s["t"] += float(seconds)
        s["st"] += x * float(seconds)
        s["ss"] += x ** 2
        self._since_persist += 1

    def observe_channels(self, level: str, channels: int, nbytes: int,
                         seconds: float, world: int) -> None:
        """One measured multi-channel collective: ``channels`` concurrent
        instances together moved ``nbytes`` wire bytes in ``seconds`` of
        wall time. The implied bandwidth multiplier against the level's
        single-channel β fit is one efficiency sample (``eta = 1 +
        (C-1)·eff``, ``utils/costs.py::CostModel.channel_eta``), folded
        into a running mean that persists as the level's ``ch_eff``.
        Skipped while the level has no β fit to compare with."""
        if channels < 2 or nbytes <= 0 or seconds <= 0 or world < 2:
            return
        fit = self._fit(self._sums.get(level, {}) or {"n": 0})
        if fit is None:
            return
        _, gbps = fit
        ring = 2 * (world - 1) / world
        t1 = ring * float(nbytes) / (gbps * 1e9)  # single-channel bw time
        eta = t1 / float(seconds)
        eff = max(0.0, min(1.0, (eta - 1.0) / (channels - 1)))
        s = self._sums.setdefault(level, dict(
            n=0, s=0.0, t=0.0, st=0.0, ss=0.0))
        s["ch_n"] = int(s.get("ch_n", 0)) + 1
        s["ch_e"] = float(s.get("ch_e", 0.0)) + eff
        self._since_persist += 1

    def _fit(self, s: dict):
        """(alpha_us, gbps) from one level's sums, or None when the fit
        is degenerate (fewer than 2 distinct sizes)."""
        n = s["n"]
        if n < 2:
            return None
        var = n * s["ss"] - s["s"] ** 2
        if var <= 0:
            return None  # one size observed repeatedly: no slope
        slope = (n * s["st"] - s["s"] * s["t"]) / var
        intercept = (s["t"] - slope * s["s"]) / n
        # Clamped to physical values rather than poisoning the cache: a
        # noisy host can fit a negative α. The slope is 1/β directly.
        alpha_us = max(intercept * 1e6, 0.1)
        gbps = max(1.0 / max(slope, 1e-15) / 1e9, 0.01)
        return round(alpha_us, 2), round(gbps, 3)

    def constants(self) -> dict:
        """Fitted ``{"nvlink": {"alpha_us", "gbps"[, "ch_eff"]}, ...}``
        for every level with a non-degenerate fit (the cache's layout);
        ``ch_eff`` once a multi-channel observation was folded in (rounded
        to 0.01)."""
        out = {}
        for level, s in self._sums.items():
            fit = self._fit(s)
            if fit is not None:
                entry = {"alpha_us": fit[0], "gbps": fit[1]}
                if s.get("ch_n", 0) > 0:
                    entry["ch_eff"] = round(s["ch_e"] / s["ch_n"], 2)
                out[level] = entry
        return out

    # -- persistence ---------------------------------------------------------

    def _seed_from_cache(self, device_kind: str, path=None) -> None:
        """Continue a previous run's fit: fold the cache's recalibration
        sums into ours, once. An unreadable or stale section is absent."""
        self._seeded = True
        cache = _costs.load_tuning_cache(path)
        if not cache or cache.get("device_kind") != device_kind:
            return
        prior = cache.get("recalibration")
        if not isinstance(prior, dict):
            return
        for level, p in prior.items():
            if not isinstance(p, dict):
                continue
            try:
                vals = {k: float(p[k]) for k in ("s", "t", "st", "ss")}
                n = int(p["n"])
            except (KeyError, TypeError, ValueError):
                continue  # corrupt section: ignored, never misread
            if n < 0 or vals["s"] < 0 or vals["t"] < 0:
                continue
            s = self._sums.setdefault(level, dict(
                n=0, s=0.0, t=0.0, st=0.0, ss=0.0))
            s["n"] += n
            for k in ("s", "t", "st", "ss"):
                s[k] += vals[k]
            # Channel-efficiency sums are optional and validated on their
            # own: a corrupt pair is dropped, the α–β sums are kept.
            try:
                ch_n = int(p.get("ch_n", 0))
                ch_e = float(p.get("ch_e", 0.0))
            except (TypeError, ValueError):
                continue
            if ch_n > 0 and 0.0 <= ch_e <= ch_n:
                s["ch_n"] = int(s.get("ch_n", 0)) + ch_n
                s["ch_e"] = float(s.get("ch_e", 0.0)) + ch_e

    def maybe_persist(self, topo, path=None, force: bool = False) -> bool:
        """Write the refreshed constants when due (every
        ``PERSIST_EVERY`` observations, or ``force``). Returns whether a
        write happened."""
        if not _env.recalibration_enabled():
            return False
        if not force and self._since_persist < self.PERSIST_EVERY:
            return False
        if not self._seeded:
            self._seed_from_cache(topo.device_kind, path)
        constants = self.constants()
        if not constants:
            return False
        # Keep what a prior calibration measured: the other level's
        # constants, a measured fusion threshold (HOROVOD_AUTOTUNE=1 reads
        # it) and the raw measurement rows.
        cache = _costs.load_tuning_cache(path)
        merged: dict = {}
        measured = None
        threshold = None
        if cache and cache.get("device_kind") == topo.device_kind:
            merged = dict(cache.get("constants") or {})
            measured = cache.get("measured")
            raw = cache.get("fusion_threshold")
            if isinstance(raw, (int, float)) and raw > 0:
                threshold = int(raw)
        merged.update(constants)
        if threshold is None:
            # Power-of-two quantized like the region thresholds: every
            # rank plans HOROVOD_AUTOTUNE=1 buckets with it, and a raw
            # per-host fit would split the ranks' plans.
            model = _costs.model_from_constants(merged, topo)
            threshold = min(256 << 20, max(
                1 << 20, _pow2(model.fusion_threshold_bytes(topo))))
        _costs.save_tuning_cache(
            merged, device_kind=topo.device_kind, world=topo.group_size,
            fusion_threshold=threshold, measured=measured,
            recalibration={level: dict(s)
                           for level, s in self._sums.items()},
            path=path)
        self._since_persist = 0
        return True


_recalibrator = Recalibrator()


def recalibrator() -> Recalibrator:
    return _recalibrator


def reset_recalibration() -> None:
    """Fresh in-process recalibration state."""
    global _recalibrator
    _recalibrator = Recalibrator()


# -- the live plan and the device-span feedback -----------------------------

_live_plan: ExchangeSchedule | None = None


def register_live_plan(sched: ExchangeSchedule) -> None:
    """Record the plan of the most recent gradient exchange
    (:func:`last_plan`)."""
    global _live_plan
    _live_plan = sched


def last_plan() -> ExchangeSchedule | None:
    return _live_plan


_SPAN_ACTIVITIES = ("XLA_ALLREDUCE", "XLA_REDUCESCATTER", "XLA_ALLGATHER")


def observe_xla_spans(spans, sched_entries) -> None:
    """Feed the device timeline's collective spans into the recalibrator.
    ``spans`` are ``(row, activity, start_us, dur_us)`` from
    ``core/xprof.py::map_device_spans``; ``sched_entries`` the program's
    schedule rows ``[name, op, dtype, shape, group, root, members]``,
    which give each row its payload bytes (the registered plan's wire
    bytes where its members match). The level is ``ib`` when the plan
    spans hosts, else ``nvlink``. Never raises: a feedback fault must not
    take the timeline down. (The reference's name: the spans are the
    device's, named as the reference names them.)"""
    if not _env.recalibration_enabled():
        return
    try:
        from horovod_tpu_torch.core import state as _state
        from horovod_tpu_torch.ops import topology as _topology

        by_name = {e[0]: e for e in sched_entries}
        plan = _live_plan
        wire_by_members = {}
        ch_by_members = {}
        if plan is not None:
            for b, m in zip(plan.buckets, plan.members):
                wire_by_members[m] = b.bytes_on_wire
                ch_by_members[m] = b.channels
        # Memoized discovery: the persist's device kind. The level and
        # world come from the registered plan when there is one.
        topo = _topology.discover(_state.get_group(0))
        if plan is not None:
            level = "ib" if plan.num_slices > 1 else "nvlink"
            world = plan.world_size
        else:
            level = "ib" if topo.multi_slice else "nvlink"
            world = topo.group_size
        rec = recalibrator()
        fed = False
        # The C per-channel spans of one bucket are one concurrent
        # observation: their union's wall time against the bucket's wire
        # bytes feeds the channel efficiency (each span alone would pair
        # partial bytes with the α–β fit and corrupt β).
        by_row: dict = {}
        for row, activity, start, dur_us in spans:
            if activity not in _SPAN_ACTIVITIES or dur_us <= 0:
                continue
            by_row.setdefault(row, []).append((start, dur_us))
        for row, row_spans in by_row.items():
            entry = by_name.get(row)
            if entry is None:
                continue
            members = tuple(entry[6]) if len(entry) > 6 else ()
            nbytes = wire_by_members.get(members)
            if nbytes is None:
                n = 1
                for d in entry[3] or [1]:
                    n *= int(d)
                nbytes = n * _itemsize(entry[2])
            ch = ch_by_members.get(members, 1)
            if ch > 1:
                if len(row_spans) < ch:
                    continue  # a partial capture: skip the row
                wall_us = (max(s + d for s, d in row_spans)
                           - min(s for s, _ in row_spans))
                rec.observe_channels(level, ch, nbytes, wall_us * 1e-6,
                                     world)
                fed = True
                continue
            for _start, dur_us in row_spans:
                rec.observe(level, nbytes, dur_us * 1e-6, world)
                fed = True
        if fed:
            rec.maybe_persist(topo)
    except Exception:
        pass  # feedback is best-effort by contract

"""Allreduce decompositions: how a fusion bucket becomes wire collectives.

Counterpart of ``horovod_tpu/ops/strategy.py``: its replicated lowerings,
and at the end the FSDP ones of the sharded modes (the reduce-scatter
prefix of a replicated lowering, and the parameter gather). Each
replicated lowering computes the same
group sum; a decomposition may re-associate the floating-point reduction,
so results are bit-exact across algorithms on integer-valued data:

``flat``
    One ``all_reduce`` on the group's process group — the only lowering of
    subset groups and families.
``rs_ag``
    A reduce-scatter, then an all-gather, of the bucket padded with
    explicit zeros to a multiple of the group size.
``hierarchical``
    Reduce-scatter over each host's ranks (NVLink), all-reduce of the 1/L
    shard across hosts (InfiniBand), all-gather over the host: the
    reference's intra-slice / cross-slice scheme, on the two process
    groups ``ops/topology.py::level_groups`` makes for this rank.

Selection: an explicit ``algo=`` (infeasible choices raise with the
reference's text) or ``"auto"``, which the α–β model (``utils/costs.py``)
prices per bucket over the discovered topology.

``channels=C > 1`` splits the already-quantized wire into C contiguous
shards, each its own collective (shard-major for the phased lowerings,
so each rank's reassembled shard is the single-channel one element for
element): bit-exact against ``channels=1`` for every algorithm and wire
format. Whether channels overlap on the wire can only be seen at more than
one GPU; the port carries their semantics.

Each phase stamps the reference's activity on the bucket's timeline row:
``REDUCE_SCATTER``, ``CROSS_SLICE``, ``ALL_GATHER``, ``QUANTIZE``,
``DEQUANTIZE``, and ``CH<c>`` around each channel instance (the
reference's HLO scope of that name).
"""

from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist

from horovod_tpu_torch.core import state as _state
from horovod_tpu_torch.core import timeline as _tl
from horovod_tpu_torch.core.state import HorovodError
from horovod_tpu_torch.ops import compression as _compression
from horovod_tpu_torch.ops import topology as _topology
from horovod_tpu_torch.ops import wire as _wire
from horovod_tpu_torch.utils import costs as _costs
from horovod_tpu_torch.utils import env as _env
from horovod_tpu_torch.utils import rng as _rng

ALGORITHMS = _costs.ALGORITHMS  # ("flat", "rs_ag", "hierarchical")


def resolve_spec(spec) -> str:
    """An ``algo=`` argument: None → ``"flat"`` (the gradient path
    resolves None against ``HOROVOD_ALLREDUCE_ALGO`` first); strings are
    validated."""
    if spec is None:
        return "flat"
    if not isinstance(spec, str):
        raise HorovodError(
            f"algo= must be None or a string, got {type(spec).__name__}.")
    value = spec.strip().lower()
    if value not in (*ALGORITHMS, "auto"):
        raise HorovodError(
            f"Unknown allreduce algorithm {spec!r}; choose one of "
            f"{list(ALGORITHMS)} or 'auto' "
            f"(HOROVOD_ALLREDUCE_ALGO / algo=).")
    return value


def resolve_channels(spec) -> int:
    """A ``channels=`` argument: None → 1; integers are validated."""
    if spec is None:
        return 1
    if isinstance(spec, bool) or not isinstance(spec, int):
        raise HorovodError(
            f"channels= must be None or a positive integer, got "
            f"{spec!r}.")
    if spec < 1:
        raise HorovodError(
            f"channels= must be >= 1 (1 = the single-channel lowering), "
            f"got {spec}.")
    return int(spec)


def select(spec: str, *, nbytes: int, group, restricted: bool = False,
           name: str = "", topo: "_topology.Topology | None" = None,
           phase_nbytes: tuple[int, int] | None = None,
           gather: bool = False
           ) -> tuple[str, "_topology.Topology | None"]:
    """The concrete algorithm of one collective: ``auto`` resolved by the
    cost model, feasibility enforced. ``restricted``: a subset group or a
    family (flat only: explicit phased algorithms raise, ``auto`` is
    flat). Returns ``(algo, topology)``; the topology is None where it was
    not needed."""
    if restricted:
        if spec in ("rs_ag", "hierarchical"):
            raise HorovodError(
                f"allreduce algo={spec!r} (tensor {name}) requires a "
                f"full-axis single group: subset groups and group "
                f"families only support the flat masked-psum lowering. "
                f"Use algo='flat'/'auto' or reduce on the full group.")
        return "flat", None
    if spec == "flat":
        return "flat", None
    if spec == "rs_ag":
        return "rs_ag", topo
    if topo is None:
        topo = _topology.discover(group)
    if spec == "auto":
        if topo.group_size <= 1:
            return "flat", topo
        model = _costs.model_for(topo)
        return model.choose(nbytes, topo, phase_nbytes=phase_nbytes,
                            gather=gather), topo
    if spec == "hierarchical":
        if not topo.multi_slice:
            raise HorovodError(
                f"allreduce algo='hierarchical' (tensor {name}) needs a "
                f"multi-slice topology; this group's {topo.group_size} "
                f"rank(s) live on one slice. Use 'flat'/'rs_ag'/'auto', "
                f"or HOROVOD_TOPOLOGY_SLICES=N to simulate slices in "
                f"tests.")
        if topo.local_size is None or topo.local_size < 2:
            raise HorovodError(
                f"allreduce algo='hierarchical' (tensor {name}) needs "
                f"equal-sized slices with >=2 ranks each (XLA "
                f"replica_groups must be uniform); got per-slice sizes "
                f"{[len(m) for m in topo.slice_members()]}.")
    return spec, topo


def gradient_algo_default() -> str:
    """The gradient path's ``algo=None``: ``HOROVOD_ALLREDUCE_ALGO``."""
    return _env.allreduce_algo_default()


# -- wire primitives on one process group ----------------------------------------


def _wide(t: torch.Tensor) -> torch.Tensor:
    """Neither NCCL nor gloo sums bool or int16: they ride as int32 (the
    sums fit by the wire budget, so the narrowing back is exact)."""
    if t.dtype in (torch.bool, torch.int16):
        return t.to(torch.int32)
    return t.contiguous()


def all_sum(t: torch.Tensor, pg, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """The all-reduce of ``t`` over ``pg`` into a new tensor."""
    buf = _wide(t)
    if buf is t or buf.data_ptr() == t.data_ptr():
        buf = buf.clone()
    _wire.all_reduce(buf, pg, op)
    return buf.to(t.dtype)


def _reduce_scatter(flat: torch.Tensor, pg, n: int) -> torch.Tensor:
    """Tiled reduce-scatter of a 1-D tensor: position j of ``pg`` gets
    the sum of every member's j-th of ``n`` equal chunks."""
    buf = _wide(flat)
    out = torch.empty(buf.shape[0] // n, dtype=buf.dtype, device=buf.device)
    _wire.reduce_scatter(out, list(buf.chunk(n)), pg)
    return out.to(flat.dtype)


def _gather_stack(t: torch.Tensor, pg, n: int) -> torch.Tensor:
    """``(n, *t.shape)``: every member's tensor, in ``pg`` order."""
    if n <= 1:
        return t[None].clone()
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(n)]
    _wire.all_gather(parts, t, pg)
    return torch.stack(parts)


def _all_gather(t: torch.Tensor, pg, n: int) -> torch.Tensor:
    """Tiled all-gather: the members' tensors concatenated along dim 0."""
    return _gather_stack(t, pg, n).reshape((-1,) + tuple(t.shape[1:]))


def _all_to_all(t: torch.Tensor, pg) -> torch.Tensor:
    """Tiled all-to-all along dim 0."""
    t = t.contiguous()
    out = torch.empty_like(t)
    _wire.all_to_all_single(out, t, pg)
    return out


@contextlib.contextmanager
def _phase(name: str, activity: str):
    with _tl.activity(name, activity):
        if _wire._active is None:
            yield
        else:
            with _wire.scope(activity):
                yield


def _ch(name: str, c: int):
    """One channel instance's span (the reference's ``CH<c>`` scope)."""
    return _tl.activity(name, f"CH{c}")


def _channel_sizes(total: int, channels: int) -> list[int]:
    """Near-equal contiguous split of ``total`` units over ``channels``
    (leading channels take the remainder; zero-size tails dropped): a pure
    function of its arguments, so every rank derives the same split."""
    channels = max(1, int(channels))
    base, rem = divmod(total, channels)
    return [base + (1 if c < rem else 0)
            for c in range(channels) if base or c < rem]


def _flatten_pad(x: torch.Tensor, multiple: int):
    """(flat zero-padded to a multiple, original size)."""
    flat = x.reshape(-1)
    size = flat.shape[0]
    pad = (-size) % multiple
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat, size


def _shard_parts(flat: torch.Tensor, n: int, sizes):
    """Channel c's part of ``flat`` viewed as ``(n, per)``: every rank's
    shard slice ``[o_c, o_c + q_c)`` — the shard-major split."""
    per = flat.shape[0] // n
    cols = flat.reshape(n, per)
    parts, o = [], 0
    for q in sizes:
        parts.append(cols[:, o:o + q].reshape(-1))
        o += q
    return parts


def _merge_gathered(parts, n: int, sizes):
    """Per-channel all-gather results back in single-channel order."""
    cols = [p.reshape(n, q) for p, q in zip(parts, sizes)]
    merged = cols[0] if len(cols) == 1 else torch.cat(cols, dim=1)
    return merged.reshape(-1)


# -- the lowerings ------------------------------------------------------------------


def lower_allreduce(x: torch.Tensor, algo: str, name: str,
                    topo: "_topology.Topology | None", g: "_state.Group",
                    channels: int = 1) -> torch.Tensor:
    """``algo``'s wire collectives for the group sum of ``x`` over group
    ``g`` (this rank a member); a new tensor of ``x``'s shape and dtype.
    ``hierarchical`` needs the discovered topology."""
    gsize = g.size
    if gsize <= 1:
        return all_sum(x, g.pg) if algo == "flat" else x.clone()
    if algo == "flat":
        if channels <= 1:
            return all_sum(x, g.pg)
        return _flat_channels(x, g, name, channels)
    if algo == "rs_ag":
        return _rs_ag(x, g, name, channels)
    if algo == "hierarchical":
        assert topo is not None, "hierarchical needs a discovered topology"
        return _hierarchical(x, g, topo, name, channels)
    raise HorovodError(f"unknown allreduce algorithm {algo!r}")


def _flat_channels(x, g, name: str, channels: int):
    """C all-reduces over contiguous chunks: elementwise, so exact."""
    flat = x.reshape(-1)
    parts, o = [], 0
    for c, q in enumerate(_channel_sizes(flat.shape[0], channels)):
        with _ch(name, c):
            parts.append(all_sum(flat[o:o + q], g.pg))
        o += q
    return torch.cat(parts).reshape(x.shape)


def _rs_ag(x, g, name: str, channels: int = 1):
    n = g.size
    flat, size = _flatten_pad(x, n)
    if channels <= 1:
        with _phase(name, "REDUCE_SCATTER"):
            shard = _reduce_scatter(flat, g.pg, n)
        with _phase(name, "ALL_GATHER"):
            full = _all_gather(shard, g.pg, n)
        return full[:size].reshape(x.shape)
    sizes = _channel_sizes(flat.shape[0] // n, channels)
    outs = []
    for c, part in enumerate(_shard_parts(flat, n, sizes)):
        with _ch(name, c):
            with _phase(name, "REDUCE_SCATTER"):
                shard = _reduce_scatter(part, g.pg, n)
            with _phase(name, "ALL_GATHER"):
                outs.append(_all_gather(shard, g.pg, n))
    return _merge_gathered(outs, n, sizes)[:size].reshape(x.shape)


def _hierarchical(x, g, topo, name: str, channels: int = 1):
    intra, cross = _topology.level_groups(g, topo)
    L, M = topo.local_size, topo.num_slices
    flat, size = _flatten_pad(x, L)
    if channels <= 1:
        with _phase(name, "REDUCE_SCATTER"):
            shard = _reduce_scatter(flat, intra, L)
        with _phase(name, "CROSS_SLICE"):
            shard = all_sum(shard, cross)
        with _phase(name, "ALL_GATHER"):
            full = _all_gather(shard, intra, L)
        return full[:size].reshape(x.shape)
    sizes = _channel_sizes(flat.shape[0] // L, channels)
    outs = []
    for c, part in enumerate(_shard_parts(flat, L, sizes)):
        with _ch(name, c):
            with _phase(name, "REDUCE_SCATTER"):
                shard = _reduce_scatter(part, intra, L)
            with _phase(name, "CROSS_SLICE"):
                shard = all_sum(shard, cross)
            with _phase(name, "ALL_GATHER"):
                outs.append(_all_gather(shard, intra, L))
    return _merge_gathered(outs, L, sizes)[:size].reshape(x.shape)


# -- compressed lowerings beyond compress-once / sum / decompress ---------------


def quantize(name: str, comp, value, wctx):
    """``comp.compress`` under the QUANTIZE span."""
    with _phase(name, "QUANTIZE"):
        return comp.compress(value, wctx)


def dequantize(name: str, fn):
    with _phase(name, "DEQUANTIZE"):
        return fn()


def bitsum_key(value: torch.Tensor, salt: int) -> torch.Tensor:
    """A rounding key from ``value``'s raw bits through an integer sum,
    which no restructuring of the program can change (a float sum could
    move an ulp between the channelized and single-channel programs)."""
    bits = value.reshape(-1).to(torch.float32).view(torch.int32)
    return _rng.splitmix64(bits.sum(dtype=torch.int64) ^ salt)


def _cross_sum_channels(name: str, value, cross, channels: int):
    """The cross-host all-reduce, split over ``channels`` along dim 0."""
    if channels <= 1:
        with _phase(name, "CROSS_SLICE"):
            return all_sum(value, cross)
    parts, o = [], 0
    for c, q in enumerate(_channel_sizes(value.shape[0], channels)):
        with _ch(name, c):
            with _phase(name, "CROSS_SLICE"):
                parts.append(all_sum(value[o:o + q], cross))
        o += q
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def lower_hierarchical_asym(x, g, topo, name: str, intra_comp, cross_comp,
                            key, channels: int = 1):
    """Phase-asymmetric two-level allreduce: the intra-host reduce-scatter
    and all-gather move ``intra_comp``'s wire (None = full precision); the
    cross-host hop moves ``cross_comp``'s, with the integer budget scoped
    to the host count. A summable cross wire (int8_block) is summed across
    hosts; an unsummable one (int4) is gathered and summed in fp32. With
    ``channels > 1`` the cross hop quantizes the reassembled shard once
    (the single-channel block grid and keys) and splits its wire rows."""
    intra, cross = _topology.level_groups(g, topo)
    L, M = topo.local_size, topo.num_slices
    flat, size = _flatten_pad(x, L)
    orig_dtype = x.dtype
    sizes = (_channel_sizes(flat.shape[0] // L, channels)
             if channels > 1 else [flat.shape[0] // L])
    C = len(sizes)

    def to_intra(v):
        return (v if intra_comp is None
                else v.to(intra_comp.wire_dtype(orig_dtype)))

    def from_intra(v):
        return v if intra_comp is None else v.to(flat.dtype)

    if C <= 1:
        with _phase(name, "REDUCE_SCATTER"):
            shard = from_intra(_reduce_scatter(to_intra(flat), intra, L))
    else:
        shard_parts = []
        for c, part in enumerate(_shard_parts(flat, L, sizes)):
            with _ch(name, c):
                with _phase(name, "REDUCE_SCATTER"):
                    shard_parts.append(from_intra(
                        _reduce_scatter(to_intra(part), intra, L)))
        shard = torch.cat(shard_parts)
    if cross_comp is None or not cross_comp.applies_to(shard.dtype):
        red = _cross_sum_channels(name, shard, cross, C)
    else:
        wctx = _compression.WireContext(
            group_size=topo.group_size,
            sum_width=M if cross_comp.summable else 1,
            pmax=lambda v: all_sum(v, cross, dist.ReduceOp.MAX),
            rank_data=g.group_rank_of(_state.global_rank()),
            key=key if key is not None else bitsum_key(shard, 0x5319))
        wire, meta = quantize(name, cross_comp, shard, wctx)
        if cross_comp.summable:
            summed = _cross_sum_channels(name, wire, cross, C)
            red = dequantize(name, lambda: cross_comp.decompress(
                summed, meta, shard.dtype, wctx))
        elif C <= 1:
            with _phase(name, "CROSS_SLICE"):
                red = cross_comp.gathered_sum(
                    lambda a: _gather_stack(a, cross, M),
                    wire, meta, shard.dtype, wctx)
        else:
            unit, orig_shape = meta
            totals, o = [], 0
            for c, q in enumerate(_channel_sizes(wire.shape[0], C)):
                with _ch(name, c):
                    with _phase(name, "CROSS_SLICE"):
                        gw = _gather_stack(wire[o:o + q], cross, M)
                        gu = _gather_stack(unit[o:o + q], cross, M)
                        totals.append(cross_comp.stacked_sum(gw, gu))
                o += q
            total = totals[0] if len(totals) == 1 else torch.cat(totals)
            red = cross_comp._restore(total, orig_shape, shard.dtype)
    if C <= 1:
        with _phase(name, "ALL_GATHER"):
            full = from_intra(_all_gather(to_intra(red), intra, L))
        return full[:size].reshape(x.shape)
    outs, o = [], 0
    for c, q in enumerate(sizes):
        with _ch(name, c):
            with _phase(name, "ALL_GATHER"):
                outs.append(from_intra(
                    _all_gather(to_intra(red[o:o + q]), intra, L)))
        o += q
    return _merge_gathered(outs, L, sizes)[:size].reshape(x.shape)


def lower_gathered(x, comp, algo: str, name: str, g, key, rank_data,
                   channels: int = 1):
    """Unsummable-wire (int4) reduction for the single-level algorithms.
    ``flat``: quantize with local block scales, gather wire and scales,
    sum dequantized in fp32. ``rs_ag``: one all-to-all of the block rows
    (rank j sums every rank's j-th chunk), the reduced chunk re-quantized
    with fresh local scales and all-gathered packed. Records this rank's
    local stage-1 contribution for error feedback. ``channels > 1`` splits
    only the wire's block rows; both quantizations run once."""
    gsize = g.size
    wctx = _compression.WireContext(
        group_size=gsize, sum_width=1, rank_data=rank_data, key=key)
    wire, meta = quantize(name, comp, x, wctx)
    _compression.record_local(
        _compression.LocalContribution(comp, wire, meta, wctx))
    if algo == "flat" or gsize <= 1:
        if channels <= 1 or gsize <= 1:
            with _phase(name, "ALL_GATHER"):
                return comp.gathered_sum(
                    lambda a: _gather_stack(a, g.pg, gsize),
                    wire, meta, x.dtype, wctx)
        unit, orig_shape = meta
        totals, o = [], 0
        for c, q in enumerate(_channel_sizes(wire.shape[0], channels)):
            with _ch(name, c):
                with _phase(name, "ALL_GATHER"):
                    gw = _gather_stack(wire[o:o + q], g.pg, gsize)
                    gu = _gather_stack(unit[o:o + q], g.pg, gsize)
                    totals.append(comp.stacked_sum(gw, gu))
            o += q
        total = totals[0] if len(totals) == 1 else torch.cat(totals)
        return comp._restore(total, orig_shape, x.dtype)
    assert algo == "rs_ag", algo
    unit, orig_shape = meta
    nb = wire.shape[0]
    pad_b = (-nb) % gsize
    if pad_b:  # zero blocks quantize to zero: an explicit pad
        wire = torch.cat([wire, wire.new_zeros((pad_b, wire.shape[1]))])
        unit = torch.cat([unit, unit.new_zeros(pad_b)])
    chunk = (nb + pad_b) // gsize
    csizes = _channel_sizes(chunk, channels) if channels > 1 else [chunk]
    if len(csizes) <= 1:
        with _phase(name, "REDUCE_SCATTER"):
            w_recv = _all_to_all(wire, g.pg)
            u_recv = _all_to_all(unit, g.pg)
            shard = comp.stacked_sum(w_recv.reshape(gsize, chunk, -1),
                                     u_recv.reshape(gsize, chunk))
    else:
        w3 = wire.reshape(gsize, chunk, -1)
        u2 = unit.reshape(gsize, chunk)
        shard_parts, o = [], 0
        for c, q in enumerate(csizes):
            with _ch(name, c):
                with _phase(name, "REDUCE_SCATTER"):
                    wc = w3[:, o:o + q, :].reshape(gsize * q, -1)
                    uc = u2[:, o:o + q].reshape(-1)
                    w_recv = _all_to_all(wc, g.pg)
                    u_recv = _all_to_all(uc, g.pg)
                    shard_parts.append(comp.stacked_sum(
                        w_recv.reshape(gsize, q, -1),
                        u_recv.reshape(gsize, q)))
            o += q
        shard = torch.cat(shard_parts)  # (chunk, B) fp32
    key2 = (bitsum_key(shard, 0x5318) if key is None
            else _compression.mix_key(key, 1, shard.device))
    wctx2 = _compression.WireContext(
        group_size=gsize, sum_width=1, rank_data=rank_data, key=key2)
    wire2, meta2 = quantize(name, comp, shard.reshape(-1), wctx2)
    if channels <= 1:
        with _phase(name, "ALL_GATHER"):
            full = comp.gathered_concat(
                lambda a: _gather_stack(a, g.pg, gsize),
                wire2, (meta2[0], (chunk * comp.block * gsize,)),
                torch.float32, wctx2)
    else:
        unit2 = meta2[0]
        parts, o = [], 0
        for c, q in enumerate(_channel_sizes(wire2.shape[0], channels)):
            with _ch(name, c):
                with _phase(name, "ALL_GATHER"):
                    gw = _gather_stack(wire2[o:o + q], g.pg, gsize)
                    gu = _gather_stack(unit2[o:o + q], g.pg, gsize)
                    parts.append(comp._deq_stack(gw, gu))
            o += q
        full3 = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
        full = full3.reshape(-1)
    size = 1
    for d in orig_shape:
        size *= d
    return full.reshape(-1)[:size].reshape(orig_shape).to(x.dtype)


# -- the FSDP lowerings (ops/mesh.py's data × fsdp mesh) ------------------------
# The ZeRO-2/3 gradient exchange is the reduce-scatter PREFIX of the
# replicated decompositions, with the trailing all-gather left out, and the
# ZeRO-3 gather-on-use is one all-gather of a parameter shard. Each case
# below runs the same collectives, on the same process groups and tensors,
# as the matching replicated lowering (one host: the ``rs_ag`` prefix;
# several: the ``hierarchical`` / ``lower_hierarchical_asym`` prefix), so
# the reduced shard IS that lowering's shard before its all-gather, element
# for element.


def fsdp_exchange_groups(fmesh, g, topo):
    """``(fsdp, data)`` process groups of this rank for one FSDP exchange
    (``ops/topology.py::fsdp_groups``): in the default multi-host layout
    the hierarchical lowering's intra/cross groups themselves."""
    return _topology.fsdp_groups(g, fmesh, topo)


def lower_fsdp_grad_exchange(x, fmesh, name: str, comp, key, g, topo):
    """Reduce one gradient tensor to this rank's flat shard: quantize (per
    the case below) → reduce-scatter over the ``fsdp`` process group →
    all-reduce over the ``data`` one → dequantize the SHARD. Returns
    ``(shard, size)``: the group-SUMMED shard (the caller divides for the
    average) of the zero-padded flat layout ``fmesh.padded_numel(numel,
    block)``, and the size of that layout before the fsdp padding.

    * ``comp`` None or elementwise / one scale (none, bf16, int8): quantize
      once on the whole tensor (the scale is shape-agnostic, so the shard
      dequantizes directly); reduce-scatter and all-reduce the wire.
    * blocked summable (int8_block), one data group: the ``rs_ag`` path on
      the flattened block wire; the shard dequantizes through the
      per-element scales sliced at this rank's offset (a shard boundary
      may cut a block).
    * blocked summable across hosts with fsdp = one host: the
      ``lower_hierarchical_asym`` mirror — full-precision reduce-scatter
      over NVLink, quantize the shard, integer all-reduce across hosts,
      dequantize. Other layouts refuse.

    Unsummable wires (int4) have no shard-keeping prefix and raise."""
    F, D, W = fmesh.fsdp_size, fmesh.data_size, fmesh.group_size
    fpg, dpg = fsdp_exchange_groups(fmesh, g, topo)
    block = getattr(comp, "block", None) if comp is not None else None
    orig_dtype = x.dtype
    rank = g.group_rank_of(_state.global_rank())
    if comp is not None and not comp.summable:
        raise HorovodError(
            f"compression {comp.name!r} (tensor {name}) has an "
            f"unsummable wire format: its gather-based exchange has no "
            f"reduce-scatter prefix for the sharded modes to keep. Use "
            f"none/bf16/int8/int8_block with sharding, or sharding='off'.")

    def scatter(flat):
        with _phase(name, "REDUCE_SCATTER"):
            return _reduce_scatter(flat, fpg, F) if F > 1 else flat.clone()

    def group_max(v):
        return all_sum(v, g.pg, dist.ReduceOp.MAX) if W > 1 else v

    if comp is None or block is None:
        if comp is not None:
            wctx = _compression.WireContext(
                group_size=W, sum_width=W, pmax=group_max, rank_data=rank,
                key=key)
            wire, meta = quantize(name, comp, x, wctx)
        else:
            wire, meta, wctx = x, None, None
        flat, size = _flatten_pad(wire, F)
        shard = scatter(flat)
        if D > 1:
            with _phase(name, "CROSS_SLICE"):
                shard = all_sum(shard, dpg)
        if comp is not None:
            summed = shard
            shard = dequantize(name, lambda: comp.decompress(
                summed, meta, orig_dtype, wctx))
        return shard, size

    if D == 1:
        wctx = _compression.WireContext(
            group_size=W, sum_width=W, pmax=group_max, rank_data=rank,
            key=key)
        wire, meta = quantize(name, comp, x, wctx)
        unit, _shape = meta
        wflat, wsize = _flatten_pad(wire, F)
        shard = scatter(wflat)
        shard_len = wflat.shape[0] // F
        # Per-element scales in the wire-flat layout, sliced at this rank's
        # element offset: a shard boundary may cut a block.
        unit_flat = unit.repeat_interleave(block)
        if wflat.shape[0] > wsize:
            unit_flat = torch.cat(
                [unit_flat, unit_flat.new_zeros(wflat.shape[0] - wsize)])
        local = rank % F
        u = unit_flat[local * shard_len:(local + 1) * shard_len]
        summed = shard
        return dequantize(name, lambda: (summed * u).to(orig_dtype)), wsize

    if not (fmesh.multi_slice and fmesh.matches_slices()):
        raise HorovodError(
            f"compression {comp.name!r} (tensor {name}) with sharding "
            f"requires the fsdp axis to be exactly one ICI slice "
            f"(fsdp_size={F}, data_size={D}, num_slices="
            f"{fmesh.num_slices}): the phase-asymmetric cross-slice "
            f"scheme quantizes the per-slice shard. Drop "
            f"HOROVOD_FSDP_AXIS_SIZE or use none/bf16 compression.")
    flat, size = _flatten_pad(x, F)
    shard = scatter(flat)
    wctx = _compression.WireContext(
        group_size=W, sum_width=D,
        pmax=lambda v: all_sum(v, dpg, dist.ReduceOp.MAX),
        rank_data=rank,
        key=key if key is not None else bitsum_key(shard, 0x5319))
    wire, meta = quantize(name, comp, shard, wctx)
    summed = _cross_sum_channels(name, wire, dpg, 1)
    out = dequantize(name, lambda: comp.decompress(summed, meta, orig_dtype,
                                                   wctx))
    return out.reshape(-1), size


def lower_fsdp_param_gather(shard, fmesh, name: str, g, topo):
    """The ZeRO-3 gather-on-use (and the ZeRO-2 gather of the new
    parameters): all-gather one flat parameter shard over the ``fsdp``
    process group, at the parameter dtype (a quantized wire would change
    the forward's numerics), under its own ``FSDP_GATHER`` activity. At
    fsdp size 1 the shard is the whole tensor and is returned as it is."""
    if fmesh.fsdp_size <= 1:
        return shard
    fpg, _ = fsdp_exchange_groups(fmesh, g, topo)
    with _phase(name, "FSDP_GATHER"):
        return _all_gather(shard, fpg, fmesh.fsdp_size)

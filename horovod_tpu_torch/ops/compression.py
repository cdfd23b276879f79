"""Gradient compression: fewer bytes per allreduce on the wire.

Counterpart of ``horovod_tpu/ops/compression.py``. A :class:`Compressor` is
applied per fusion bucket by the allreduce lowering (``ops/collectives.py``,
``ops/strategy.py``): quantize → wire collective(s) in the wire dtype →
dequantize. Four wire formats:

* ``bf16`` — deterministic round-to-nearest-even cast (half the bytes); the
  cross-rank sum runs in bf16.
* ``int8`` — one scale per bucket (the group abs-max, one ``MAX``
  all-reduce) and stochastic rounding to multiples of ``scale / qcap``,
  with ``qcap = 127 // ranks summed`` so the integer sum cannot overflow.
* ``int8_block`` — a scale per ``HOROVOD_COMPRESSION_BLOCK`` elements
  (default 256; one vector ``MAX`` all-reduce), the budget divided by the
  ranks the wire actually sums; past 127 summing ranks the wire widens to
  int16, past 32767 it is refused.
* ``int4`` — per-block local scales, stochastic rounding to ±7, two
  elements nibble-packed per int8 byte; never summed on the wire: every
  exchange gathers the packed payloads and scales and sums them in fp32.

Rounding is stochastic and unbiased: ``q = floor(x / unit + u)``, ``u``
uniform in [0, 1). The reference draws ``u`` from ``jax.random``, which
torch cannot reproduce; the port's stream is :func:`_uniform`: splitmix64
over (key, group rank, element index) on the tensor's device, the top 24
bits as a float in [0, 1). The key is the caller's ``compression_key`` (an
int, or a 0-d int64 tensor a captured step can refill each replay) mixed
with the bucket's salt (``ops/collectives.py::bucket_key``), or, without
one, the bits of the bucket's fp32 sum. Nothing reads back to the host, so
a compressed exchange captures in a CUDA graph.

Error feedback (``DistributedOptimizer(error_feedback=True)``) keeps each
rank's local quantization residual; the collector below carries each
bucket's local dequantized contribution from the lowering to the
optimizer. ``compression=None``/``"none"`` takes the exact uncompressed
path.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable

import torch

from horovod_tpu_torch.core.state import HorovodError
from horovod_tpu_torch.utils import rng as _rng

_TINY = torch.finfo(torch.float32).tiny
_DATA_KEY_SALT = 0x5317


@dataclasses.dataclass
class WireContext:
    """What a compressor may need from the collective lowering.

    ``group_size``: ranks in the exchange. ``pmax``: the cross-rank max of
    a non-negative scalar or vector tensor (``all_reduce(MAX)`` on the
    summing phase's process group; the identity for a single-rank view).
    ``rank_data``: this rank's group rank, mixed into the rounding stream
    so ranks draw independent noise (None: not mixed). ``key``: the
    caller's per-step key (an int or a 0-d int64 tensor), or None.
    ``sum_width``: ranks whose wire values the collective SUMS (the
    integer budget divides by it; 1 for gather exchanges; None = the
    group size).
    """

    group_size: int
    pmax: Callable = lambda v: v
    rank_data: object = None
    key: object = None
    sum_width: int | None = None

    @property
    def effective_sum_width(self) -> int:
        return self.group_size if self.sum_width is None else self.sum_width


def key_tensor(key, device) -> torch.Tensor:
    """A key (int or 0-d integer tensor) as a 0-d int64 tensor on
    ``device``."""
    if isinstance(key, torch.Tensor):
        return key.to(device=device, dtype=torch.int64).reshape(())
    return torch.full((), _rng.i64(int(key) & ((1 << 64) - 1)),
                      dtype=torch.int64, device=device)


def mix_key(key, salt: int, device) -> torch.Tensor:
    """``splitmix64(key ^ salt)``: a derived key, on the device."""
    return _rng.splitmix64(key_tensor(key, device) ^ salt)


def _stochastic_key(x: torch.Tensor, ctx: WireContext) -> torch.Tensor:
    """The rounding key: ``ctx.key`` when the caller threads one, else the
    bits of ``x``'s fp32 sum (so a captured step draws new noise each
    step); the group rank mixed in either way."""
    if ctx.key is None:
        bits = x.sum(dtype=torch.float32).view(torch.int32).to(torch.int64)
        key = _rng.splitmix64((bits & 0xFFFFFFFF) ^ _DATA_KEY_SALT)
    else:
        key = key_tensor(ctx.key, x.device)
    if ctx.rank_data is not None:
        key = _rng.splitmix64(key ^ int(ctx.rank_data))
    return key


def _uniform(x: torch.Tensor, ctx: WireContext) -> torch.Tensor:
    """fp32 noise in [0, 1) of ``x``'s shape: splitmix64 of (the key,
    element index), the top 24 bits scaled by 2^-24 (exact in fp32)."""
    key = _stochastic_key(x, ctx)
    h = _rng.splitmix64(
        key ^ torch.arange(x.numel(), dtype=torch.int64, device=x.device))
    return (_rng.srl(h, 40).to(torch.float32) * 2.0 ** -24).reshape(x.shape)


def _per(scale: torch.Tensor, qcap: int) -> torch.Tensor:
    """``max(scale, tiny) / qcap`` as the reference's compiled program
    computes it: XLA turns a division by a constant into a product by the
    constant's fp32 reciprocal, so this is ``scale * fp32(1 / qcap)``, a
    product by a tensor on the same device (the same rounding on every
    device)."""
    scale = torch.clamp_min(scale, _TINY)
    inv = torch.tensor(1.0, dtype=torch.float32) / float(qcap)
    return scale * torch.full_like(scale, float(inv))


# -- error-feedback residual collector ---------------------------------------
# While a collection is active, the compressed lowering records each
# bucket's LOCAL contribution (what this rank injected into the sum: its
# wire and scales, a LocalContribution) in bucket order; None marks a
# bucket whose contribution was exact or whose quantization error is not
# this rank's own (the hierarchical cross hop quantizes the intra-host sum),
# so its residual stays zero.


@dataclasses.dataclass
class LocalContribution:
    """One bucket's quantized local contribution: ``residual(x)`` is
    ``x`` minus its dequantized value."""

    comp: "Compressor"
    wire: torch.Tensor
    meta: object
    ctx: WireContext

    def residual(self, contribution: torch.Tensor) -> torch.Tensor:
        return self.comp.residual(contribution, self.wire, self.meta,
                                  self.ctx)

_local_sink: list | None = None


@contextlib.contextmanager
def collect_local_contributions():
    """Collect each compressed bucket's local dequantized contribution."""
    global _local_sink
    prev = _local_sink
    _local_sink = sink = []
    try:
        yield sink
    finally:
        _local_sink = prev


def record_local(value) -> None:
    """One entry per bucket collective, in issue order."""
    if _local_sink is not None:
        _local_sink.append(value)


class Compressor:
    """Interface: reversible dtype reduction of one flat fusion bucket.

    ``wire_dtype(dtype)`` names the dtype the collective moves (the input
    dtype: the compressor does not apply). ``compress`` maps the bucket to
    its wire and the metadata ``decompress`` needs; the wire of all ranks
    is SUMMED by the collective (``summable``), or gathered and reduced by
    :meth:`gathered_sum` (``summable=False``, int4). ``elementwise``: each
    element's wire is independent of its neighbours (bf16).
    ``phase_asymmetric``: on the hierarchical decomposition, compress only
    the cross-host hop. ``WIRE_BITS``: bits per logical element when they
    differ from the wire dtype's width (0 = its width).
    """

    name = "none"
    elementwise = False
    summable = True
    phase_asymmetric = False
    WIRE_BITS = 0

    def wire_dtype(self, dtype: torch.dtype,
                   sum_width: int | None = None) -> torch.dtype:
        return dtype

    def applies_to(self, dtype: torch.dtype) -> bool:
        return self.wire_dtype(dtype) != dtype

    def compress(self, flat: torch.Tensor, ctx: WireContext):
        return flat, None

    def decompress(self, wire, meta, orig_dtype, ctx: WireContext):
        return wire

    def residual(self, x, wire, meta, ctx: WireContext):
        """The error-feedback residual of contribution ``x``: ``x`` minus
        its dequantized wire."""
        return x - self.decompress(wire, meta, x.dtype, ctx)

    def gathered_sum(self, gather_fn, wire, meta, orig_dtype,
                     ctx: WireContext):
        """Unsummable compressors: ``gather_fn(t) -> (m, *t.shape)`` stacks
        every contributor's tensor; return the dequantized sum."""
        raise NotImplementedError(
            f"{self.name} wire values are summed in the collective; "
            f"gathered_sum applies only to summable=False compressors.")

    def gathered_concat(self, gather_fn, wire, meta, orig_dtype,
                        ctx: WireContext):
        """Unsummable compressors: reassemble reduced shards (rank j's
        dequantized shard at position j)."""
        raise NotImplementedError(
            f"{self.name} does not implement gathered shard reassembly.")

    def gathered_rows(self, gather_fn, wire, meta, orig_dtype,
                      ctx: WireContext):
        """Per-rank dequantized payloads of a pure gather (the sparse value
        payload, compressed with ``sum_width=1``): the ``(m, *shape)``
        stack in ``orig_dtype``."""
        return gather_fn(wire).to(orig_dtype)


class NoneCompressor(Compressor):
    """Identity: selecting it is the uncompressed path."""


class Bf16Compressor(Compressor):
    """Deterministic fp32/fp64 → bfloat16 wire cast (half the bytes)."""

    name = "bf16"
    elementwise = True

    def wire_dtype(self, dtype, sum_width=None):
        if dtype.is_floating_point and dtype.itemsize > 2:
            return torch.bfloat16
        return dtype

    def compress(self, flat, ctx):
        return flat.to(torch.bfloat16), None

    def decompress(self, wire, meta, orig_dtype, ctx):
        return wire.to(orig_dtype)


class Int8Compressor(Compressor):
    """One scale per bucket (the group abs-max) and stochastic rounding to
    int8 multiples of ``scale / (127 // ranks summed)``: unbiased, and the
    int8 sum cannot overflow. Refused past 127 summing ranks."""

    name = "int8"

    def wire_dtype(self, dtype, sum_width=None):
        return torch.int8 if dtype.is_floating_point else dtype

    @staticmethod
    def qcap(group_size: int) -> int:
        return 127 // max(1, group_size)

    def compress(self, flat, ctx):
        sum_width = ctx.effective_sum_width
        if sum_width > 127:
            raise HorovodError(
                f"int8 compression supports at most 127 ranks summing in "
                f"the wire, got {sum_width}: the per-rank integer budget "
                f"127 // sum_width vanishes and the summed wire values "
                f"would overflow int8. Use compression='int8_block' — its "
                f"per-block budget is local to the summing phase (and "
                f"widens the accumulator past 127 in-wire ranks) — or "
                f"compression='bf16'.")
        x = flat.to(torch.float32)
        scale = ctx.pmax(x.abs().max())
        qcap = self.qcap(sum_width)
        unit = _per(scale, qcap)
        u = _uniform(x, ctx)
        # Clamp: float rounding at the bucket's abs-max can land one unit
        # over the budget, and one excess would wrap the int8 sum.
        q = torch.clamp(torch.floor(x / unit + u), -qcap, qcap)
        return q.to(torch.int8), unit

    def decompress(self, wire, meta, orig_dtype, ctx):
        return (wire.to(torch.float32) * meta).to(orig_dtype)

    def residual(self, x, wire, meta, ctx):
        """fp32: ``x - wire * unit`` as one fused multiply-add (XLA fuses
        the product into the difference)."""
        if x.dtype != torch.float32:
            return super().residual(x, wire, meta, ctx)
        return torch.addcmul(x, wire.to(torch.float32), meta, value=-1)

    def gathered_rows(self, gather_fn, wire, meta, orig_dtype, ctx):
        """Each rank's scalar unit travels with its payload (a sum_width=1
        context keeps the scale local)."""
        g_wire = gather_fn(wire)
        g_unit = gather_fn(meta.reshape(1))
        unit = g_unit.reshape((-1,) + (1,) * wire.dim())
        return (g_wire.to(torch.float32) * unit).to(orig_dtype)


class _BlockCompressor(Compressor):
    """The per-block-scale formats: the bucket viewed as ``block``-element
    rows (tail zero-padded; zeros quantize to zero), each with its own fp32
    scale; ``meta`` is ``(units (nblocks,), orig_shape)``. The block size
    is ``HOROVOD_COMPRESSION_BLOCK`` unless pinned here."""

    def __init__(self, block: int | None = None) -> None:
        if block is None:
            from horovod_tpu_torch.utils import env as _env

            block = _env.compression_block()
        if block < 8 or block % 2:
            raise HorovodError(
                f"compression block size must be an even element count "
                f">= 8 (int4 packs two elements per wire byte), got "
                f"{block}.")
        self.block = int(block)

    def _blocked(self, flat):
        x = flat.to(torch.float32).reshape(-1)
        pad = (-x.shape[0]) % self.block
        if pad:
            x = torch.cat([x, x.new_zeros(pad)])
        return x.reshape(-1, self.block), tuple(flat.shape)

    def _units(self, x2d, ctx, qcap: int, shared: bool):
        """Per-block units; ``shared``: the GROUP abs-max per block (the
        summed wire needs one unit on every rank), else local."""
        scale = x2d.abs().amax(dim=1)
        if shared:
            scale = ctx.pmax(scale)
        return _per(scale, qcap)

    @staticmethod
    def _restore(flat_padded, orig_shape, orig_dtype):
        size = 1
        for d in orig_shape:
            size *= d
        return flat_padded.reshape(-1)[:size].reshape(orig_shape) \
            .to(orig_dtype)

    def _levels(self, wire):
        """The wire's integer levels as fp32, ``(..., block)``."""
        raise NotImplementedError

    def _deq_stack(self, wire_stack, unit_stack):
        """Stacked ``(m, nblocks, ·)`` wire and ``(m, nblocks)`` units,
        dequantized to fp32 ``(m, nblocks, block)``."""
        return self._levels(wire_stack) * unit_stack[..., None]

    def decompress(self, wire, meta, orig_dtype, ctx):
        unit, orig_shape = meta
        return self._restore(self._levels(wire) * unit[:, None],
                             orig_shape, orig_dtype)

    def residual(self, x, wire, meta, ctx):
        """fp32: ``x - levels * unit`` as one fused multiply-add."""
        if x.dtype != torch.float32:
            return super().residual(x, wire, meta, ctx)
        unit, orig_shape = meta
        x2d, _ = self._blocked(x)
        r = torch.addcmul(x2d, self._levels(wire), unit[:, None], value=-1)
        return self._restore(r, orig_shape, x.dtype)

    def gathered_rows(self, gather_fn, wire, meta, orig_dtype, ctx):
        unit, orig_shape = meta
        g_wire = gather_fn(wire)                      # (m, nb, B')
        g_unit = gather_fn(unit)                      # (m, nb)
        deq = self._deq_stack(g_wire, g_unit)         # (m, nb, B) fp32
        size = 1
        for d in orig_shape:
            size *= d
        m = deq.shape[0]
        return deq.reshape(m, -1)[:, :size] \
            .reshape((m,) + tuple(orig_shape)).to(orig_dtype)


class Int8BlockCompressor(_BlockCompressor):
    """Per-block scales and stochastic rounding to an integer wire whose
    budget divides by the ranks the collective sums: int8 up to 127 of
    them, int16 up to 32767 (half of fp32, still unbiased), refused beyond.
    On the hierarchical decomposition only the cross-host hop is
    quantized, so the budget divides by the host count."""

    name = "int8_block"
    phase_asymmetric = True

    @staticmethod
    def sum_budget(sum_width: int) -> tuple[int, torch.dtype]:
        """(qcap, wire dtype) such that ``qcap * sum_width`` never
        overflows the wire integer."""
        sw = max(1, int(sum_width))
        if sw <= 127:
            return max(1, 127 // sw), torch.int8
        if sw <= 32767:
            return max(1, 32767 // sw), torch.int16
        raise HorovodError(
            f"int8_block cannot sum {sw} ranks in an integer wire (even "
            f"an int16 accumulator overflows); use algo='hierarchical' "
            f"so the DCN hop sums slice counts, not ranks.")

    def wire_dtype(self, dtype, sum_width=None):
        if dtype.is_floating_point:
            return (torch.int8 if sum_width is None
                    else self.sum_budget(sum_width)[1])
        return dtype

    def compress(self, flat, ctx):
        qcap, wdt = self.sum_budget(ctx.effective_sum_width)
        x2d, orig_shape = self._blocked(flat)
        unit = self._units(x2d, ctx, qcap, shared=True)
        u = _uniform(x2d, ctx)
        q = torch.clamp(torch.floor(x2d / unit[:, None] + u), -qcap, qcap)
        return q.to(wdt), (unit, orig_shape)

    def _levels(self, wire):
        return wire.to(torch.float32)


def _dequantized_sum(q: torch.Tensor, unit: torch.Tensor) -> torch.Tensor:
    """``sum_r q[r] * unit[r]`` in fp32, in rank order, each step one fused
    multiply-add from zero (``addcmul``) — the rounding of the reference's
    fused XLA reduction."""
    total = torch.zeros_like(q[0])
    for r in range(q.shape[0]):
        total = torch.addcmul(total, q[r], unit[r])
    return total


class Int4Compressor(_BlockCompressor):
    """Per-block local scales, stochastic rounding to ±7, two elements
    nibble-packed per int8 byte (12.5% of fp32). Never summed on the wire
    (``summable=False``): every exchange gathers the packed payloads and
    their scales and sums them dequantized in fp32 (``decompress`` is the
    local roundtrip the error-feedback residual reads). ``_pack``/``_unpack``
    are the nibble layout the serving engine's int4 KV pages share."""

    name = "int4"
    summable = False
    phase_asymmetric = True
    WIRE_BITS = 4
    QCAP = 7  # ±7 in 4 offset-binary bits

    def wire_dtype(self, dtype, sum_width=None):
        return torch.int8 if dtype.is_floating_point else dtype

    @staticmethod
    def _pack(q):
        """(nb, B) integers in [-7, 7] -> (nb, B//2) int8 carrier bytes."""
        u = (q + 8).to(torch.uint8)
        pairs = u.reshape(q.shape[0], -1, 2)
        return (pairs[..., 0] | (pairs[..., 1] << 4)).view(torch.int8)

    @staticmethod
    def _unpack(wire):
        """(..., B//2) int8 carrier -> (..., B) fp32 integers in [-7, 7]."""
        u = wire.view(torch.uint8)
        lo = (u & 0xF).to(torch.float32) - 8.0
        hi = ((u >> 4) & 0xF).to(torch.float32) - 8.0
        return torch.stack([lo, hi], dim=-1).reshape(
            *wire.shape[:-1], wire.shape[-1] * 2)

    def compress(self, flat, ctx):
        x2d, orig_shape = self._blocked(flat)
        unit = self._units(x2d, ctx, self.QCAP, shared=False)
        u = _uniform(x2d, ctx)
        q = torch.clamp(torch.floor(x2d / unit[:, None] + u),
                        -self.QCAP, self.QCAP)
        return self._pack(q), (unit, orig_shape)

    def gathered_sum(self, gather_fn, wire, meta, orig_dtype, ctx):
        unit, orig_shape = meta
        total = self.stacked_sum(gather_fn(wire), gather_fn(unit))
        return self._restore(total, orig_shape, orig_dtype)

    def gathered_concat(self, gather_fn, wire, meta, orig_dtype, ctx):
        unit, orig_shape = meta
        g_wire = gather_fn(wire)        # (m, nb, B//2), rank-major
        g_unit = gather_fn(unit)
        full = (self._unpack(g_wire) * g_unit[..., None]).reshape(-1)
        return self._restore(full, orig_shape, orig_dtype)

    def stacked_sum(self, wire_stack, unit_stack):
        """fp32 sum of stacked (m, nb, B//2) wire and (m, nb) units."""
        return _dequantized_sum(self._unpack(wire_stack),
                                unit_stack[..., None])

    def _levels(self, wire):
        return self._unpack(wire)


_REGISTRY: dict[str, Callable[[], Compressor]] = {
    "none": NoneCompressor,
    "bf16": Bf16Compressor,
    "int8": Int8Compressor,
    "int8_block": Int8BlockCompressor,
    "int4": Int4Compressor,
}


def registered_names() -> frozenset[str]:
    """Names :func:`resolve` accepts."""
    return frozenset(_REGISTRY)


def resolve(spec) -> Compressor:
    """A ``compression=`` argument as a :class:`Compressor`: None defers to
    ``HOROVOD_COMPRESSION`` (unset = ``none``), a string names a registered
    compressor, an instance passes through."""
    if isinstance(spec, Compressor):
        return spec
    if spec is None:
        from horovod_tpu_torch.utils import env as _env

        spec = _env.compression_default()
    if isinstance(spec, str):
        try:
            return _REGISTRY[spec.strip().lower()]()
        except KeyError:
            raise HorovodError(
                f"Unknown gradient compression {spec!r}; choose one of "
                f"{sorted(_REGISTRY)} (HOROVOD_COMPRESSION / compression=).")
    raise HorovodError(
        f"compression= must be None, a string, or a Compressor instance, "
        f"got {type(spec).__name__}.")


def active(spec) -> Compressor | None:
    """:func:`resolve`, with ``none`` as None (the uncompressed path)."""
    comp = resolve(spec)
    return None if isinstance(comp, NoneCompressor) else comp


def wire_dtype_of(compressor: Compressor, dtype,
                  sum_width: int | None = None) -> torch.dtype:
    """``compressor.wire_dtype`` with the in-wire sum width, tolerant of a
    custom compressor whose ``wire_dtype`` takes only the dtype."""
    try:
        return compressor.wire_dtype(dtype, sum_width=sum_width)
    except TypeError:
        return compressor.wire_dtype(dtype)


def wire_bytes(n_elements: int, dtype, compressor: Compressor | None,
               sum_width: int | None = None) -> int:
    """Bytes a bucket puts on the wire under ``compressor`` (packed
    formats count ``WIRE_BITS`` a logical element)."""
    if compressor is None or not compressor.applies_to(dtype):
        return int(n_elements) * dtype.itemsize
    if compressor.WIRE_BITS:
        return (int(n_elements) * compressor.WIRE_BITS + 7) // 8
    return int(n_elements) * wire_dtype_of(compressor, dtype,
                                           sum_width).itemsize


def resolve_phase_formats(compressor: Compressor | None, cross_spec=None
                          ) -> tuple[Compressor | None, Compressor | None,
                                     bool]:
    """``(intra, cross, asymmetric)``: the per-phase wire policy of the
    hierarchical decomposition. Not asymmetric: ``(comp, comp, False)``,
    every phase moves one wire. Asymmetric — a ``cross_spec`` override, or
    a ``phase_asymmetric`` compressor (int8_block/int4): the intra-host
    phases move ``intra``'s wire (None = full precision; elementwise casts
    only), the cross-host hop ``cross``'s (None = uncompressed)."""
    if cross_spec is not None:
        cross = resolve(cross_spec)
        if isinstance(cross, NoneCompressor):
            cross = None
        intra = (None if compressor is None
                 or compressor.phase_asymmetric else compressor)
        if intra is not None and not intra.elementwise:
            raise HorovodError(
                f"cross_compression composes only with an elementwise "
                f"bucket compressor (bf16) or none on the intra-slice "
                f"phases; {intra.name} couples elements through a shared "
                f"scale whose budget belongs to one summing phase. Use "
                f"compression='bf16'/'int8_block'/'int4' or drop the "
                f"cross-slice override.")
        return intra, cross, True
    if compressor is not None and compressor.phase_asymmetric:
        return None, compressor, True
    return compressor, compressor, False

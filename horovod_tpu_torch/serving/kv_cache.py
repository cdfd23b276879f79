"""Paged KV cache — fixed-size blocks in one preallocated pool.

Counterpart of ``horovod_tpu/serving/kv_cache.py``. A serving engine with
dense per-request caches reserves a worst-case ``(max_seq_len, Hkv, d)``
buffer per batch slot; the paged design (vLLM's PagedAttention) carves ONE
pool of ``num_blocks`` blocks of ``block_size`` tokens, and each request
holds a *block table*, the ordered block ids backing its sequence. Blocks
are allocated as the sequence crosses block boundaries and released when
the request finishes, so waste is bounded by one partial block a request.

Two capacity levers sit on top of paging:

* **Quantized pages** (``kv_dtype``): ``fp32``, ``bf16``, ``int8_block``
  (int8 payload plus one bf16 scale per (token, head) vector) or ``int4``
  (nibble-packed payload, same scale plane). Fresh K/V are quantized once,
  on write, by deterministic round-half-to-even, and the whole view is
  dequantized to fp32 inside the decode attend (``models/transformer.py``).
* **Copy-on-write prefix sharing**: identical full-block prompt prefixes map
  onto one set of refcounted pages (the radix index is in
  ``serving/scheduler.py``). Shared pages are always full and every write
  lands at a sequence's tail, so no page is ever copied.

Host side (plain Python/numpy): the :class:`BlockPool` allocator and the
block-table helpers. Device side (torch): :func:`make_kv_pools` and the
quantizers. Block id 0 is the reserved null block: padded table entries and
masked rows point at it, so fixed-shape gathers and scatters always index a
real block and garbage lands where no attend reads it unmasked.
"""

from __future__ import annotations

import numpy as np
import torch

from horovod_tpu_torch.core.state import HorovodError

NULL_BLOCK = 0

#: Pool storage formats. ``None``/"model" resolve to the model dtype
#: (fp32 or bf16).
KV_DTYPES = ("fp32", "bf16", "int8_block", "int4")

#: Guard for all-zero K/V vectors: the quantization unit never drops below
#: ``_SCALE_FLOOR / qcap``, so a zero vector quantizes to exact zeros with a
#: finite, bf16-representable unit.
_SCALE_FLOOR = 1e-6

#: ±7 in 4 offset-binary bits — the int4 packer's range
#: (``horovod_tpu/ops/compression.py::Int4Compressor.QCAP``).
INT4_QCAP = 7


class BlockPoolError(HorovodError):
    """An allocator invariant was violated (double free, foreign block)."""


class BlockPool:
    """Refcounted free-list allocator over ``num_blocks`` KV blocks.

    Block 0 is the reserved null block and is never handed out, so the
    usable capacity is ``num_blocks - 1``. ``alloc`` is all-or-nothing:
    a request that cannot get every block it asked for gets none (the
    scheduler then queues or preempts rather than holding a partial
    claim that deadlocks the pool).

    Prefix sharing turns alloc/free into acquire/release semantics:
    every allocated block carries a refcount (1 at ``alloc``);
    :meth:`acquire` adds a reference (a second request — or the prefix
    index — mapping the same immutable page), :meth:`release` drops one
    and reclaims the block only at zero. ``free`` is ``release`` — the
    pre-sharing name kept for callers that never share. Capacity math
    counts a shared page ONCE (``num_used`` is the unique block count).
    """

    def __init__(self, num_blocks: int, block_size: int):
        if not isinstance(num_blocks, int) or num_blocks < 2:
            raise ValueError(
                f"num_blocks must be an int >= 2 (one reserved null block "
                f"plus at least one usable), got {num_blocks!r}")
        if not isinstance(block_size, int) or block_size < 1:
            raise ValueError(
                f"block_size must be a positive int, got {block_size!r}")
        self.num_blocks = num_blocks
        self.block_size = block_size
        # LIFO free list: recently freed blocks are reused first (their
        # pool pages are the warmest).
        self._free: list[int] = list(range(num_blocks - 1, 0, -1))
        self._refs: dict[int, int] = {}

    @property
    def capacity(self) -> int:
        """Usable blocks (the null block excluded)."""
        return self.num_blocks - 1

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_used(self) -> int:
        """UNIQUE allocated blocks — a page shared by N requests counts
        once (the admission-accounting contract)."""
        return len(self._refs)

    @property
    def num_shared(self) -> int:
        """Blocks currently referenced more than once."""
        return sum(1 for c in self._refs.values() if c > 1)

    def refcount(self, block: int) -> int:
        """References held on ``block`` (0 when free)."""
        return self._refs.get(block, 0)

    def blocks_for(self, tokens: int) -> int:
        """Blocks needed to back ``tokens`` cache entries (ceil)."""
        return -(-max(0, int(tokens)) // self.block_size)

    def can_alloc(self, n: int) -> bool:
        return n <= len(self._free)

    def alloc(self, n: int) -> list[int] | None:
        """Claim ``n`` fresh blocks (refcount 1 each), or None (and
        claim NOTHING) if fewer than ``n`` are free — the caller
        queues, rejects, or preempts."""
        if n < 0:
            raise ValueError(f"cannot alloc a negative block count ({n})")
        if n > len(self._free):
            return None
        taken = [self._free.pop() for _ in range(n)]
        for b in taken:
            self._refs[b] = 1
        return taken

    def acquire(self, blocks: list[int]) -> None:
        """Add one reference to each already-allocated block — the
        prefix-sharing path mapping an immutable full page into another
        request's table (or into the prefix index itself). Acquiring a
        free or null block raises: a reference to a page nobody owns
        would be served stale or reused under the reader."""
        for b in blocks:
            if b == NULL_BLOCK:
                raise BlockPoolError(
                    "attempted to share the reserved null block 0")
            if b not in self._refs:
                raise BlockPoolError(
                    f"cannot acquire free/foreign block {b}: it is not "
                    f"allocated (a shared reference must point at a live "
                    f"page)")
            self._refs[b] += 1

    def release(self, blocks: list[int]) -> None:
        """Drop one reference per block; a block is returned to the
        free list only when its last reference goes. Double releases,
        the null block, and ids the pool never handed out all raise — a
        serving engine that corrupts its own allocator must die loudly,
        not serve one request's KV to another."""
        for b in blocks:
            if b == NULL_BLOCK:
                raise BlockPoolError(
                    "attempted to free the reserved null block 0")
            if b not in self._refs:
                raise BlockPoolError(
                    f"double free / foreign block: {b} is not allocated "
                    f"(free list corrupt or caller bug)")
            self._refs[b] -= 1
            if self._refs[b] == 0:
                del self._refs[b]
                self._free.append(b)

    # The pre-sharing name: releasing an unshared block IS freeing it.
    free = release

    def truncate(self, blocks: list, new_tokens: int):
        """Shrink a request's block table IN PLACE so it backs only
        ``new_tokens`` cache entries — the speculative-decoding rollback
        primitive: a verify step that rejects a draft tail hands back the
        whole blocks behind it (``Engine._spec_decode_step``).

        * Whole blocks past ``blocks_for(new_tokens)`` are released
          (one reference each — a tail page the prefix index or another
          request still holds survives with its other references; the
          rest return to the free list).
        * When the PARTIAL boundary block — the block holding the last
          kept, not-block-aligned token — is shared (refcount > 1), it
          is copy-on-write forked: a fresh private block replaces it in
          the table and the shared original keeps its other references
          untouched. The caller owns copying the page payload
          ``old → fresh`` in every pool array before the next write
          (the allocator moves ids, never bytes).

        Returns ``(released, cow)``: the tail block ids whose reference
        was dropped, and ``(old, fresh)`` when a fork happened (else
        None). Double truncates (a stale pre-truncate table whose tail
        was already released) and tables carrying foreign or null
        blocks raise :class:`BlockPoolError` BEFORE any mutation — an
        allocator fed a corrupt table must die loudly, not free another
        request's pages."""
        if new_tokens < 0:
            raise ValueError(
                f"cannot truncate to a negative token count "
                f"({new_tokens})")
        keep = self.blocks_for(new_tokens)
        if keep > len(blocks):
            raise BlockPoolError(
                f"truncate to {new_tokens} tokens keeps {keep} block(s) "
                f"but the table holds only {len(blocks)} — already "
                f"truncated past this point (double truncate), or a "
                f"table this pool never backed")
        tail = list(blocks[keep:])
        for b in tail:
            if b == NULL_BLOCK:
                raise BlockPoolError(
                    "truncate hit the reserved null block 0 — a PADDED "
                    "table was passed where the raw block list belongs")
            if b not in self._refs:
                raise BlockPoolError(
                    f"double truncate / foreign block: tail block {b} "
                    f"is not allocated (its reference was already "
                    f"dropped, or this pool never handed it out)")
        boundary_partial = keep > 0 and (new_tokens % self.block_size) != 0
        if boundary_partial:
            b = blocks[keep - 1]
            if b == NULL_BLOCK or b not in self._refs:
                raise BlockPoolError(
                    f"truncate boundary block {b} is not allocated — "
                    f"foreign or already-released table")
        # Every check passed: mutate. Tail first, so the fork below can
        # reuse a just-freed page even in a full pool.
        del blocks[keep:]
        self.release(tail)
        cow = None
        if boundary_partial and self._refs[blocks[keep - 1]] > 1:
            old = blocks[keep - 1]
            got = self.alloc(1)
            if got is None:
                raise BlockPoolError(
                    f"copy-on-write truncate needs one free block to "
                    f"fork shared boundary block {old}, but the pool is "
                    f"exhausted — the caller must free or preempt first")
            self.release([old])
            blocks[keep - 1] = got[0]
            cow = (old, got[0])
        return tail, cow

    def check_invariants(self) -> None:
        """Allocator self-check: every block is exactly one of
        {null, free, used}, the sets partition the pool, and every used
        block carries a positive refcount (no premature reuse of a page
        someone still references, no leak of a zero-ref page)."""
        free = set(self._free)
        if len(free) != len(self._free):
            raise BlockPoolError("free list carries duplicate blocks")
        bad_ids = sorted(b for b in free | self._refs.keys()
                         if not 1 <= b < self.num_blocks)
        if bad_ids:
            raise BlockPoolError(
                f"block ids outside the pool range [1, {self.num_blocks}):"
                f" {bad_ids} — a truncate/fork returned ids this pool "
                f"never owned")
        if free & self._refs.keys():
            raise BlockPoolError(
                f"blocks both free and used: "
                f"{sorted(free & self._refs.keys())}")
        if NULL_BLOCK in free or NULL_BLOCK in self._refs:
            raise BlockPoolError("null block leaked into the allocator")
        if len(free) + len(self._refs) != self.capacity:
            raise BlockPoolError(
                f"pool leak: {len(free)} free + {len(self._refs)} used != "
                f"{self.capacity} capacity")
        bad = sorted(b for b, c in self._refs.items() if c < 1)
        if bad:
            raise BlockPoolError(
                f"allocated blocks with non-positive refcount: {bad} — "
                f"a zero-ref page must be on the free list, not used")

    def utilization(self) -> float:
        """Fraction of usable blocks currently allocated."""
        return self.num_used / self.capacity if self.capacity else 0.0

    def internal_fragmentation(self, lengths, tables=None) -> int:
        """Tokens of allocated-but-unused cache across the live
        sequences. Without ``tables`` (the pre-sharing accounting) each
        sequence is charged independently: ``blocks*block_size - length``,
        bounded by ``block_size - 1`` per sequence. With ``tables`` (one
        block-id list per sequence, aligned with ``lengths``) a SHARED
        page is counted once: per unique block, the waste is
        ``block_size`` minus the deepest fill any referencing sequence
        gives it (shared prefix pages are always full — zero waste —
        so sharing never inflates the fragmentation number). A
        copy-on-write-forked boundary block (:meth:`truncate`) is a
        DISTINCT id from the shared original it forked off, so each is
        charged by its own holders exactly once — the fork never
        double-counts."""
        if tables is None:
            waste = 0
            for n in lengths:
                n = int(n)
                waste += self.blocks_for(n) * self.block_size - n
            return waste
        fill: dict[int, int] = {}
        for n, tab in zip(lengths, tables):
            n = int(n)
            for j in range(self.blocks_for(n)):
                b = int(tab[j])
                got = min(self.block_size, n - j * self.block_size)
                fill[b] = max(fill.get(b, 0), got)
        return sum(self.block_size - f for f in fill.values())


def padded_table(blocks: list[int], max_blocks: int) -> np.ndarray:
    """A request's block table as a fixed-shape int32 row, padded with
    the null block — what the engine stacks into its (B, max_blocks)
    device table each step."""
    if len(blocks) > max_blocks:
        raise ValueError(
            f"block table ({len(blocks)}) exceeds max_blocks_per_seq "
            f"({max_blocks}) — sequence longer than max_seq_len?")
    row = np.full((max_blocks,), NULL_BLOCK, np.int32)
    row[:len(blocks)] = blocks
    return row


# ---------------------------------------------------------------------------
# kv_dtype: pool storage formats
# ---------------------------------------------------------------------------


def resolve_kv_dtype(kv_dtype, model_dtype) -> str:
    """Normalize a ``kv_dtype=`` argument / ``HOROVOD_SERVE_KV_DTYPE`` value
    to one of :data:`KV_DTYPES`. ``None``/``"model"`` follow the model's
    compute dtype (bf16 models cache bf16, fp32 models fp32)."""
    if kv_dtype is None or kv_dtype == "model":
        if model_dtype == torch.bfloat16:
            return "bf16"
        if model_dtype == torch.float32:
            return "fp32"
        raise HorovodError(
            f"kv_dtype='model' maps the model compute dtype onto a pool "
            f"format, but {model_dtype} has none — pass an "
            f"explicit kv_dtype from {list(KV_DTYPES)} "
            f"(HOROVOD_SERVE_KV_DTYPE / kv_dtype=).")
    if kv_dtype not in KV_DTYPES:
        raise HorovodError(
            f"Unknown kv_dtype {kv_dtype!r}; choose one of "
            f"{['model', *KV_DTYPES]} (HOROVOD_SERVE_KV_DTYPE / "
            f"kv_dtype= — docs/inference.md 'Quantized KV cache').")
    return kv_dtype


def kv_quantized(kv_dtype: str) -> bool:
    return kv_dtype in ("int8_block", "int4")


def _head_dims(config) -> tuple[int, int, int]:
    hkv = config.num_kv_heads or config.num_heads
    d = config.embed_dim // config.num_heads
    return config.num_layers, hkv, d


def kv_bytes_per_token(config, kv_dtype=None) -> float:
    """Device bytes one cached token costs across all layers under
    ``kv_dtype``, K and V together, scale planes included."""
    kvd = resolve_kv_dtype(kv_dtype, config.dtype)
    nl, hkv, d = _head_dims(config)
    per_head = {"fp32": 4.0 * d, "bf16": 2.0 * d,
                "int8_block": 1.0 * d + 2.0,
                "int4": 0.5 * d + 2.0}[kvd]
    return 2.0 * nl * hkv * per_head  # K and V


def kv_bytes_per_block(config, block_size: int, kv_dtype=None) -> int:
    """Pool bytes one block occupies (all layers, K+V, scales included)."""
    return int(round(kv_bytes_per_token(config, kv_dtype) * block_size))


def num_blocks_for_bytes(config, block_size: int, kv_dtype,
                         budget_bytes: int) -> int:
    """Largest pool (``num_blocks``, null block included) that fits in
    ``budget_bytes``. Raises when the budget holds fewer than one usable
    block."""
    per = kv_bytes_per_block(config, block_size, kv_dtype)
    n = int(budget_bytes) // per
    if n < 2:
        raise HorovodError(
            f"pool_bytes={budget_bytes} holds {n} block(s) of {per} bytes "
            f"(kv_dtype={resolve_kv_dtype(kv_dtype, config.dtype)!r}); "
            f"need >= 2 (one null + one usable) — grow the budget or "
            f"shrink block_size")
    return n


def make_kv_pools(config, num_blocks: int, block_size: int,
                  kv_dtype=None, device: str | torch.device = "cuda"):
    """The device-side pools as a flat tuple, zeroed, on ``device``:

    * fp32/bf16: ``(k, v)`` of shape
      ``(num_layers, num_blocks, block_size, Hkv, head_dim)``;
    * int8_block: ``(k, v, k_scale, v_scale)`` — int8 payloads of the same
      shape plus bf16 scale planes ``(num_layers, num_blocks, block_size,
      Hkv)``;
    * int4: payloads nibble-packed along head_dim (``head_dim // 2`` int8
      carrier bytes), the same scale planes.

    All layers share one allocator: a block is a layer-stacked page."""
    kvd = resolve_kv_dtype(kv_dtype, config.dtype)
    nl, hkv, d = _head_dims(config)
    if kvd == "int4" and d % 2:
        raise HorovodError(
            f"kv_dtype='int4' nibble-packs two head-dim elements per "
            f"byte and needs an even head_dim, got {d}")
    base = (nl, num_blocks, block_size, hkv)
    if not kv_quantized(kvd):
        dt = torch.float32 if kvd == "fp32" else torch.bfloat16
        return (torch.zeros(base + (d,), dtype=dt, device=device),
                torch.zeros(base + (d,), dtype=dt, device=device))
    payload = base + (d if kvd == "int8_block" else d // 2,)
    return (torch.zeros(payload, dtype=torch.int8, device=device),
            torch.zeros(payload, dtype=torch.int8, device=device),
            torch.zeros(base, dtype=torch.bfloat16, device=device),
            torch.zeros(base, dtype=torch.bfloat16, device=device))


def _kv_qcap(kv_dtype: str) -> int:
    return 127 if kv_dtype == "int8_block" else INT4_QCAP


def int4_pack(q: torch.Tensor) -> torch.Tensor:
    """``(..., n)`` integers in [-7, 7] → ``(..., n // 2)`` int8 carrier
    bytes: element 2i in the low nibble, 2i+1 in the high, each offset by 8
    (``Int4Compressor._pack``'s layout)."""
    u = (q.to(torch.int16) + 8).to(torch.uint8)
    pairs = u.reshape(*q.shape[:-1], -1, 2)
    return (pairs[..., 0] | (pairs[..., 1] << 4)).view(torch.int8)


def int4_unpack(wire: torch.Tensor) -> torch.Tensor:
    """``(..., n // 2)`` int8 carrier → ``(..., n)`` fp32 integers in
    [-7, 7] (``Int4Compressor._unpack``)."""
    u = wire.view(torch.uint8)
    lo = (u & 0xF).float() - 8.0
    hi = ((u >> 4) & 0xF).float() - 8.0
    return torch.stack([lo, hi], dim=-1).reshape(
        *wire.shape[:-1], wire.shape[-1] * 2)


def quantize_kv(x: torch.Tensor, kv_dtype: str):
    """Quantize fresh K or V head vectors ``x (..., d)`` for the pool:
    ``(wire, unit)`` with ``wire`` int8 ``(..., d)`` (int8_block) or
    nibble-packed ``(..., d // 2)`` (int4) and ``unit (...,)`` the bf16
    per-head step, ``bf16(max(absmax, 1e-6) / qcap)``.

    Rounding is deterministic, half to even (``torch.round``, as
    ``jnp.rint``): the same token at the same position always quantizes to
    the same bits, which is what makes recompute-preemption and prefix
    sharing bit-identical per kv_dtype. The full integer range is used
    (±127 / ±7)."""
    qcap = _kv_qcap(kv_dtype)
    xf = x.float()
    absmax = xf.abs().amax(dim=-1)
    # The unit is rounded to bf16 BEFORE quantizing, so the stored scale
    # is exactly the scale the payload was built against.
    unit = (absmax.clamp_min(_SCALE_FLOOR) / qcap).to(torch.bfloat16)
    q = torch.round(xf / unit.float()[..., None]).clamp_(-qcap, qcap)
    if kv_dtype == "int4":
        return int4_pack(q.to(torch.int8)), unit
    return q.to(torch.int8), unit


def dequantize_kv(wire: torch.Tensor, unit: torch.Tensor,
                  kv_dtype: str) -> torch.Tensor:
    """fp32 reconstruction of quantized pages ``wire (..., d or d//2)`` with
    their scale plane ``unit (...,)``."""
    q = int4_unpack(wire) if kv_dtype == "int4" else wire.float()
    return q * unit.float()[..., None]


# ---------------------------------------------------------------------------
# pages on the wire: the prefill/decode split's transfers
# ---------------------------------------------------------------------------


def page_bytes(pools) -> int:
    """Bytes one block id's page takes across every plane of ``pools``
    (all layers; payloads and scale planes)."""
    return sum(p[:, 0].numel() * p.element_size() for p in pools)


def pack_pages(pools, ids: torch.Tensor) -> torch.Tensor:
    """The pages behind block ids ``ids`` (int64, on the pools' device) of
    every plane of ``pools`` — raw ``(k, v)`` or quantized ``(k, v,
    k_scale, v_scale)`` — as one flat uint8 tensor: each plane's
    ``(layers, len(ids), ...)`` gather in turn, byte for byte."""
    return torch.cat([p[:, ids].contiguous().view(torch.uint8).reshape(-1)
                      for p in pools])


def unpack_pages(pools, ids: torch.Tensor, buf: torch.Tensor) -> None:
    """Write what :func:`pack_pages` packed for ``ids`` back into ``pools``
    in place, bit for bit."""
    off = 0
    for p in pools:
        shape = (p.shape[0], ids.shape[0]) + tuple(p.shape[2:])
        n = int(np.prod(shape, dtype=np.int64)) * p.element_size()
        chunk = buf[off:off + n]
        if off % p.element_size():
            chunk = chunk.clone()  # a dtype view needs an aligned start
        p[:, ids] = chunk.view(p.dtype).view(shape)
        off += n
    if off != buf.numel():
        raise HorovodError(
            f"unpack_pages: {buf.numel()} bytes for {ids.shape[0]} pages "
            f"of {page_bytes(pools)} bytes each")

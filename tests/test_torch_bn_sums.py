"""Kernel B1's launch plan (``horovod_tpu_torch/ops/batchnorm.py::sums_plan``)
and the wrapper's host side, checked on this CPU-only host.

The CUDA kernel (``csrc/bn_sums.cu``) cannot run here; it is held against
``channel_sums_plain`` on the card by ``chip_smoke.py`` phase 3. What it
runs is decided here, in Python: the grid, the rows each block owns and
the bulk copies of its shared-memory ring. These tests hold that plan to
the kernel's rules: every row summed exactly once, no block empty, every
bulk copy 16-byte aligned and a multiple of 16 bytes, no stage over its
16 KB, and the combine after the grid barrier adding every channel once,
in shared memory that fits the ring.
"""

import re

import pytest
import torch

from horovod_tpu_torch.ops import _build
from horovod_tpu_torch.ops import batchnorm as tbn

# The 12 distinct (N, C) of ResNet-50's 53 BatchNorm inputs at batch 128.
RESNET50 = [(1605632, 64), (401408, 64), (401408, 256), (401408, 128),
            (100352, 128), (100352, 512), (100352, 256), (25088, 256),
            (25088, 1024), (25088, 512), (6272, 512), (6272, 2048)]
# chip_smoke.py's B1 edge cases and the ragged ResNet shape.
EDGE = [(3, 64), (1001, 3), (4097, 12), (4097, 16), (0, 64), (100003, 64),
        (6271, 2048), (7, 9000), (25087, 1024), (1, 1), (9, 20000),
        (5, 2500)]
# (bytes per element, vec): bf16 and fp32, each read 16 bytes at a time or
# one element at a time (odd C or an unaligned base).
LAYOUTS = [(2, 8), (4, 4), (2, 1), (4, 1)]
# Blocks resident at once: two or one an SM of an H100's 132, and a
# smaller card.
MAX_BLOCKS = [264, 132, 48]

# The kernel's ring: 4 stages of SUMS_STAGE_BYTES.
RING_BYTES = 4 * tbn.SUMS_STAGE_BYTES

CASES = [(n, c, es, vec) for n, c in RESNET50 + EDGE
         for es, vec in LAYOUTS if vec == 1 or c % vec == 0]


def _copies(plan, n, c, es, b, by):
    """(byte offset, bytes) of each bulk copy of block (``b``, ``by``): one a
    stage when the tile is the whole row, else one a row of the stage."""
    r0, r1 = tbn.block_rows(plan, n, b)
    rps = plan.rows_per_stage
    c0 = by * plan.ct
    w = min(plan.ct, c - c0)
    out = []
    for r in range(r0, r1, rps):
        nr = min(r1, r + rps) - r
        if w == c:
            out.append((r * c * es, nr * c * es))
        else:
            out.extend(((q * c + c0) * es, w * es) for q in range(r, r + nr))
    return out


@pytest.mark.parametrize("n,c,es,vec", CASES)
def test_plan_covers_every_row_once(n, c, es, vec):
    for most in MAX_BLOCKS:
        plan = tbn.sums_plan(n, c, es, vec, most)
        assert plan.gx * plan.gy <= max(most, plan.gy)
        ranges = [tbn.block_rows(plan, n, b) for b in range(plan.gx)]
        assert ranges[0][0] == 0 and ranges[-1][1] == n
        assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
        if n > 0:
            assert all(r1 > r0 for r0, r1 in ranges), "a block is empty"
            sizes = [r1 - r0 for r0, r1 in ranges]
            assert max(sizes) - min(sizes) <= 1
        else:
            assert plan.gx == 1
        # Channel tiles along y cover C once; each fits the kernel's
        # registers.
        assert (plan.gy - 1) * plan.ct < c <= plan.gy * plan.ct
        assert plan.ct <= tbn.SUMS_MAX_VECS * tbn.SUMS_THREADS * vec
        assert plan.scratch == 2 * c + plan.gx * 2 * c


@pytest.mark.parametrize("n,c,es,vec", CASES)
def test_bulk_copies_are_aligned_and_fit_a_stage(n, c, es, vec):
    for most in MAX_BLOCKS:
        plan = tbn.sums_plan(n, c, es, vec, most)
        if plan.rows_per_stage == 0:
            assert vec == 1  # ordinary loads: odd C or an unaligned base
            continue
        assert vec > 1 and plan.ct % vec == 0
        assert plan.ct * es <= tbn.SUMS_TILE_BYTES
        assert plan.rows_per_stage * plan.ct * es <= tbn.SUMS_STAGE_BYTES
        copies = sorted(cp for b in range(plan.gx) for by in range(plan.gy)
                        for cp in _copies(plan, n, c, es, b, by))
        seen = 0
        for off, size in copies:
            assert off % 16 == 0 and size % 16 == 0 and 0 < size
            assert off == seen  # every byte copied once
            seen += size
        assert seen == n * c * es


@pytest.mark.parametrize("n,c", RESNET50)
def test_resnet_shapes_take_the_ring_with_a_full_grid(n, c):
    """Every ResNet-50 shape takes the bulk-copy ring in bf16, its rows cut
    into tiles of at most SUMS_TILE_BYTES; all but the smallest fill the
    card's resident blocks, and the smallest keep 32 KB a block."""
    most = 264
    plan = tbn.sums_plan(n, c, 2, 8, most)
    assert plan.rows_per_stage > 0
    assert plan.ct == min(c, tbn.SUMS_TILE_BYTES // 2)
    if n * c * 2 >= most * tbn.SUMS_MIN_BLOCK_BYTES:
        assert plan.gx == most // plan.gy
    else:
        assert plan.gx * plan.gy * tbn.SUMS_MIN_BLOCK_BYTES <= n * c * 2


def _combine_slices(plan, c):
    """The kernel's combine, per tile: block b adds items [b·2w/gx,
    (b+1)·2w/gx) of the tile's 2w (Σx then Σx² of its w channels).
    Returns, per tile, 2w and the items in block order."""
    tiles = []
    for by in range(plan.gy):
        w2 = 2 * min(plan.ct, c - by * plan.ct)
        items = []
        for b in range(plan.gx):
            items.extend(range(b * w2 // plan.gx, (b + 1) * w2 // plan.gx))
        tiles.append((w2, items))
    return tiles


@pytest.mark.parametrize("n,c,es,vec", CASES)
def test_combine_adds_every_channel_once(n, c, es, vec):
    """After the grid barrier the blocks of a tile split its 2w sums among
    them, each summed once; the row lanes of the main pass fit the 64 KB
    ring they are added in."""
    for most in MAX_BLOCKS:
        plan = tbn.sums_plan(n, c, es, vec, most)
        for w2, items in _combine_slices(plan, c):
            assert items == list(range(w2))
            tv = -(-(w2 // 2) // vec)
            if tv <= tbn.SUMS_THREADS:  # rp row lanes of the main pass
                assert (tbn.SUMS_THREADS // tv) * w2 * 4 <= RING_BYTES


def test_plan_constants_mirror_the_kernel():
    """The wrapper plans with the kernel's own constants."""
    with open(f"{_build.CSRC}/bn_sums.cu") as f:
        src = f.read()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("kSumThreads") == tbn.SUMS_THREADS
    assert const("kMaxVecs") == tbn.SUMS_MAX_VECS
    assert const("kStageBytes") == tbn.SUMS_STAGE_BYTES
    assert const("kStages") * const("kStageBytes") == RING_BYTES
    # The kernel's block rows, [bx·n/gx, (bx+1)·n/gx), and combine slices,
    # [bx·2w/gx, (bx+1)·2w/gx), each item summed by a group of L lanes.
    assert "(long long)blockIdx.x * n / gridDim.x" in src
    assert "(long long)(blockIdx.x + 1) * n / gridDim.x" in src
    assert "(long long)blockIdx.x * w2 / gx" in src
    assert "(long long)(blockIdx.x + 1) * w2 / gx" in src
    assert "const int L = gx >= 32 ? 32 : 1 << (32 - __clz(gx - 1));" in src
    assert "constexpr int kSumBlock = kSumThreads + 32;" in src


class _FakeLib:
    def __init__(self, most):
        self.most = most
        self.asked = 0

    def hvd_bn_sums_max_blocks(self, device):
        self.asked += 1
        return self.most


@pytest.fixture
def fresh_caches(monkeypatch):
    monkeypatch.setattr(tbn, "_plans", {})
    monkeypatch.setattr(tbn, "_max_blocks", {})


def test_plan_is_cached_and_the_card_asked_once(fresh_caches):
    lib = _FakeLib(256)
    first = tbn._plan(lib, 25088, 256, torch.bfloat16, 8, 0)
    assert tbn._plan(lib, 25088, 256, torch.bfloat16, 8, 0) is first
    other = tbn._plan(lib, 6272, 2048, torch.bfloat16, 8, 0)
    assert other != first and lib.asked == 1
    assert first == tbn.sums_plan(25088, 256, 2, 8, 256)


def test_plan_for_another_dtype_or_vec_differs(fresh_caches):
    lib = _FakeLib(256)
    bf16 = tbn._plan(lib, 25088, 256, torch.bfloat16, 8, 0)
    fp32 = tbn._plan(lib, 25088, 256, torch.float32, 4, 0)
    scalar = tbn._plan(lib, 25088, 256, torch.bfloat16, 1, 0)
    assert bf16.ct == 2 * fp32.ct == 256 and fp32.gy == 2 * bf16.gy == 2
    assert bf16.rows_per_stage == fp32.rows_per_stage == 32
    assert scalar.rows_per_stage == 0


def test_sizing_error_raises(fresh_caches):
    with pytest.raises(RuntimeError, match="CUDA error 98 sizing the grid"):
        tbn._plan(_FakeLib(-98), 25088, 256, torch.bfloat16, 8, 0)


def test_zero_channels_raise_before_any_launch(monkeypatch):
    def refuse():
        raise AssertionError("the kernel library was loaded")

    monkeypatch.setattr(tbn, "_sums_lib", refuse)
    monkeypatch.setattr(tbn, "_check_kernel_input", lambda name, t: None)
    tbn.reset_launch_counts()
    with pytest.raises(ValueError, match="at least one channel"):
        tbn.channel_sums(torch.empty(4, 0, device="meta"))
    assert tbn.LAUNCHES["channel_sums"] == 0

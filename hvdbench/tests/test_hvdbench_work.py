"""The work counts reproduce the bounds of PERF.md's kernel table at the
LM cells' shapes (B3, B4, A1), and the MFU count from the shapes."""

import json
import os

import pytest

from hvdbench import work
from hvdbench.families import lm

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _load(*parts):
    with open(os.path.join(ROOT, *parts)) as f:
        return json.load(f)


@pytest.fixture
def lm_counts():
    return lm.counts(_load("hvdbench", "configs", "lm_t8k.json"),
                     _load("hvdbench", "traffic", "b2.json"))


def test_b3_bound(lm_counts):
    per_call = lm_counts["flash_fwd_flops"] / 8
    assert per_call == 4 * 128 * (2 * 8 * 8192 * 8193 // 2)
    assert per_call / 1e9 == pytest.approx(275, abs=0.5)
    assert per_call / work.BF16_FLOPS * 1e3 == pytest.approx(0.2780,
                                                             abs=5e-5)


def test_b4_bound(lm_counts):
    per_call = lm_counts["flash_bwd_flops"] / 8
    assert per_call / work.BF16_FLOPS * 1e3 == pytest.approx(0.6949,
                                                             abs=5e-5)


def test_a1_bytes(lm_counts):
    assert lm_counts["adamw_bytes"] == 3_188_019_736


def test_lm_params():
    cfg = _load("hvdbench", "configs", "lm_t8k.json")
    sizes = work.lm_param_sizes(cfg)
    assert len(sizes) == 67
    assert sum(sizes) == 159_400_960
    assert work.lm_matmul_params(cfg) == 125_829_120


def test_lm_mfu_count(lm_counts):
    six_nd = 6 * 125_829_120 * 2 * 8192
    attn = 3.5 * 8 * 4 * 128 * (2 * 8 * 8192 * 8193 // 2)
    assert lm_counts["flops"] == pytest.approx(six_nd + attn)
    assert lm_counts["flops"] / 1e12 == pytest.approx(20.067, abs=1e-3)
    assert lm_counts["items"] == 16_384

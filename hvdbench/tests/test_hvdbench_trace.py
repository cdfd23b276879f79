"""The frozen trace arithmetic on hand-made spans, and the per-layer readers
on a hand-made slice."""

import importlib.util
import os

import pytest

from hvdbench import trace, work

METRICS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "metrics")


def _read(name, t):
    s = importlib.util.spec_from_file_location(
        "m", os.path.join(METRICS, f"{name}.py"))
    mod = importlib.util.module_from_spec(s)
    s.loader.exec_module(mod)
    return mod.read(t)


def test_union_merges_overlaps_and_drops_empty():
    assert trace.union([(5, 5), (0, 2), (1, 2), (20, 0)]) == [(0, 3), (5, 10)]
    assert trace.covered([(0, 4), (2, 4), (10, 1)]) == 7


def test_exposed():
    # comm [0, 10), compute [2, 5) and [4, 8): their union covers 6.
    assert trace.exposed([(0, 10)], [(2, 3), (4, 4)]) == 4
    assert trace.exposed([(0, 10)], []) == 10
    assert trace.exposed([], [(0, 10)]) == 0
    # two comm spans that overlap count once
    assert trace.exposed([(0, 6), (4, 6)], [(8, 10)]) == 8


def test_gaps_longest_first():
    got = trace.gaps([(2, 2), (10, 1)], 0, 15)
    assert got == [(4, 6), (11, 4), (0, 2)]


@pytest.mark.parametrize("name,base", [
    ("ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgsStorage<4096ul>)",
     "all-reduce"),
    ("ncclKernel_ReduceScatter_RING_LL_Sum_float", "reduce-scatter"),
    ("void at::native::(anonymous namespace)::CatArrayBatchedCopy<float>",
     "concatenate"),
    ("Memcpy DtoD (Device -> Device)", "slice"),
    ("void flash_fwd_kernel<128>(Params)", "flash_fwd_kernel"),
    ("void at::native::vectorized_elementwise_kernel<4, Foo>(int)",
     "vectorized_elementwise_kernel"),
])
def test_kernel_base(name, base):
    assert trace.kernel_base(name) == base


@pytest.mark.parametrize("name,cat", [
    ("channel_sums_ring_kernel", "bn_channel_sums"),
    ("channel_grad_sums_kernel", "bn_channel_sums"),
    ("flash_bwd_dq_kernel", "flash_attention"),
    ("adamw_kernel", "adamw"),
    ("ncclDevKernel_AllReduce_Sum_f32_RING_LL", "nccl"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32", "conv_and_matmul"),
    ("void at::native::reduce_kernel<512, 1>", "reduction"),
    ("Memset (Device)", "copy_and_cast"),
    ("void at::native::vectorized_elementwise_kernel<4>", "elementwise"),
    ("some_other_kernel", "other"),
])
def test_category(name, cat):
    assert trace.category(name) == cat


def _slice(unit, events, counts, steps=2, slice_s=100e-6):
    return trace.RankTrace(events, [], slice_s, 0.0, steps, unit, counts)


def test_idle_and_elementwise():
    ev = [("vectorized_elementwise_kernel", 0.0, 20.0),
          ("sm90_xmma_gemm", 10.0, 30.0), ("Memcpy DtoD", 60.0, 20.0)]
    t = _slice("tokens", ev, {"flops": 1.0})
    assert _read("device_idle.tokens", t) == pytest.approx(40.0)
    # elementwise 20 us + copy 20 us over 2 steps
    assert _read("elementwise_ms.tokens", t) == pytest.approx(0.02)


def test_rooflines():
    counts = {"flash_fwd_flops": work.BF16_FLOPS * 1e-4,
              "adamw_bytes": work.HBM_BYTES * 2e-4}
    ev = [("flash_fwd_kernel", 0.0, 400.0), ("adamw_kernel", 500.0, 800.0)]
    t = _slice("tokens", ev, counts, steps=2)
    # bound 100 us a step, 200 us over 2 steps, against 400 us: 50 %
    assert _read("flash_fwd_roofline", t) == pytest.approx(50.0)
    assert _read("adamw_roofline", t) == pytest.approx(50.0)
    # no B4 kernel in the slice: nothing to read
    assert _read("flash_bwd_roofline", t) is None


def test_exchange_readers():
    ev = [("sm90_gemm", 0.0, 50.0),
          ("ncclDevKernel_AllReduce_Sum_f32_RING_LL", 40.0, 30.0)]
    t = _slice("tokens", ev, {}, steps=1)
    assert _read("nccl_ms.tokens", t) == pytest.approx(0.03)
    assert _read("exposed_comm_ms.tokens", t) == pytest.approx(0.02)
    alone = _slice("tokens", ev[:1], {}, steps=1)
    assert _read("nccl_ms.tokens", alone) is None
    assert _read("exposed_comm_ms.tokens", alone) is None


def test_mfu_reads_the_traced_slice():
    t = _slice("tokens", [("k", 0.0, 1.0)],
               {"flops": work.BF16_FLOPS * 1e-6}, steps=2, slice_s=1e-4)
    # 2 steps of a microsecond's peak work in 100 us of the device: 2 %
    assert _read("mfu.tokens", t) == pytest.approx(2.0)
    assert _read("mfu.tokens", _slice("tokens", [], {"flops": 1.0})) is None


def test_breakdown():
    ev = [("flash_fwd_kernel<1>", 0.0, 10.0), ("flash_fwd_kernel<1>", 30.0,
                                                10.0)]
    t = trace.RankTrace(ev, [("cudaGraphLaunch", 5.0, 30.0, 1),
                             ("train_step", 0.0, 50.0, 0)], 50e-6, 0.0, 2,
                        "tokens", {})
    assert t.per_step_ms(1000.0) == 0.5
    assert trace.top_ops(t) == [["flash_fwd_kernel", 10e-6]]
    assert trace.idle_gaps(t) == [["cudaGraphLaunch", 20e-6],
                                  ["train_step", 10e-6]]

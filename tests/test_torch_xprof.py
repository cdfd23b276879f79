"""The port's device timeline (``core/xprof.py``, ``core/timeline.py``'s
device mode, ``parallel/spmd.py``'s sampling) and the α–β recalibrator
(``ops/exchange.py``) against the JAX package's, on the CPU.

* ``map_device_spans`` on synthetic traces: the JAX side's events carry
  HLO names, the port's the CUDA kernel names the card runs (NCCL's
  collectives, ``torch.cat``'s kernel, device-to-device copies, compute
  kernels), at the same times; the spans (collective rows, member rows,
  pack/unpack windows, ``DEVICE_STEP``) must be equal.
* ``Recalibrator`` and ``observe_xla_spans`` against JAX's on the same
  samples, spans, schedule and plan: the constants and the persisted
  cache's numbers equal, with the level names mapped.
* ``plan_exchange(compute_window_s=)`` against JAX's.
* The timeline's device mode on the CPU: ``event_at``'s refusal in host
  mode, ``NO_DEVICE_PLANE``, the interval's sampled counts, and sampling
  that changes no result; ``timed_steps`` on the CPU; a step that raises
  leaves no profiler session open.
"""

import json
import os

import numpy as np
import pytest
import torch

LEVEL = {"nvlink": "ici", "ib": "dcn"}

# Device events as the H100 names them (torch.profiler, PyTorch 2.11,
# NCCL's current and older kernel names), each with the HLO op the JAX
# package's trace would show at the same place.
NCCL_AR = ("ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgs"
           "Storage<4096ul>)", "%all-reduce.{i} = f32[1024]{{0}} all-reduce("
           "f32[1024]{{0}} %p), replica_groups={{}}")
NCCL_AG = ("ncclKernel_AllGather_RING_LL_Sum_int8_t(ncclDevComm*, unsigned "
           "long, ncclWork*)", "%all-gather.{i} = s8[64]{{0}} all-gather()")
NCCL_RS = ("ncclDevKernel_ReduceScatter_Sum_bf16_RING_LL(ncclDevKernelArgs"
           "Storage<4096ul>)", "%reduce-scatter.{i} = bf16[8]{{0}} "
           "reduce-scatter()")
NCCL_BC = ("ncclDevKernel_Broadcast_RING_LL(ncclDevKernelArgsStorage<4096ul>)",
           "%collective-broadcast.{i} = f32[4]{{0}} collective-broadcast()")
NCCL_P2P = ("ncclDevKernel_SendRecv(ncclDevKernelArgsStorage<4096ul>)",
            "%collective-permute.{i} = f32[4]{{0}} collective-permute()")
CAT = ("void at::native::(anonymous namespace)::CatArrayBatchedCopy_"
       "vectorized<at::native::(anonymous namespace)::OpaqueType<4u>, "
       "unsigned int, 1, 128, 1, 16, 4>(char*, at::native::(anonymous "
       "namespace)::CatArrInputTensorMetadata<at::native::(anonymous "
       "namespace)::OpaqueType<4u>, unsigned int, 128, 1>, at::native::"
       "(anonymous namespace)::TensorSizeStride<unsigned int, 4u>, int, "
       "unsigned int)", "%concatenate.{i} = f32[1024]{{0}} concatenate()")
COPY = ("Memcpy DtoD (Device -> Device)", "%slice.{i} = f32[512]{{0}} slice()")
COPY_KERNEL = ("void at::native::unrolled_elementwise_kernel<at::native::"
               "direct_copy_kernel_cuda(at::TensorIteratorBase&)::"
               "{lambda()#3}::operator()() const::{lambda()#10}::operator()"
               "() const::{lambda(float)#1}, std::array<char*, 2ul>, 4, "
               "TrivialOffsetCalculator<1, unsigned int>>(int)",
               "%slice.{i} = f32[512]{{0}} slice()")
FLASH = ("void flash_fwd_kernel<128>(FlashParams)",
         "%fusion.{i} = bf16[2,8]{{1,0}} fusion()")
GEMM = ("sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize64x64x8_stage3_"
        "warpsize1x4x1_ffma_aligna4_alignc4_execute_kernel__5x_cublas",
        "%dot.{i} = f32[8,8]{{1,0}} dot()")
ADAMW = ("adamw_kernel(long const*, int, float, float, float, float)",
         "%fusion.{i} = f32[8]{{0}} fusion()")


def _trace(ops):
    """``ops``: [(pair, start_us, dur_us)] -> (JAX events, port events)."""
    jax_ev, port_ev = [], []
    for i, (pair, s, d) in enumerate(ops):
        port_ev.append((pair[0], float(s), float(d)))
        jax_ev.append((pair[1].format(i=i + 1), float(s), float(d)))
    return jax_ev, port_ev


SCHED = [["b0", "ALLREDUCE", "float32", [1024], 0, -1, ["g.0", "g.1"]],
         ["b1", "ALLREDUCE", "float32", [512], 0, -1, ["g.2"]],
         ["b2", "ALLREDUCE", "float32", [256], 0, -1, []]]
TRACES = {
    # Three buckets: packs before, unpacks after, compute between.
    "buckets": (SCHED, [(FLASH, 0, 50), (CAT, 52, 3), (NCCL_AR, 56, 20),
                        (COPY, 77, 2), (COPY, 80, 2), (CAT, 83, 2),
                        (NCCL_AR, 86, 10), (COPY_KERNEL, 97, 1),
                        (GEMM, 99, 5), (NCCL_AR, 105, 12), (COPY, 118, 1),
                        (ADAMW, 120, 9)]),
    # A copy overlapping a collective is its own work, not an unpack; a
    # pack before the first collective counts.
    "windows": (SCHED, [(CAT, 0, 2), (NCCL_AR, 3, 20), (COPY, 10, 4),
                        (CAT, 24, 1), (GEMM, 26, 3), (NCCL_AR, 30, 5),
                        (NCCL_AR, 36, 5), (COPY, 42, 1)]),
    # Mixed ops: the schedule's accepts (a broadcast may run as an
    # all-reduce or a permute; an allgather as all-gather only).
    "kinds": ([["x", "BROADCAST", "float32", [4], 0, 0],
               ["y", "ALLGATHER", "int8", [64], 0, -1],
               ["z", "REDUCESCATTER", "bfloat16", [8], 0, -1],
               ["w", "ALLTOALL", "float32", [4], 0, -1]],
              [(NCCL_P2P, 0, 4), (NCCL_AG, 5, 6), (NCCL_RS, 12, 3),
               (NCCL_BC, 16, 2), (NCCL_P2P, 19, 5), (FLASH, 25, 9)]),
    # More collectives than the schedule has rows: the extra is dropped.
    "unmatched": (SCHED[:1], [(NCCL_AR, 0, 5), (NCCL_AR, 6, 5),
                              (COPY, 12, 1)]),
    # No collective at all (one rank: NCCL launches nothing): the step's
    # window only.
    "compute_only": (SCHED, [(GEMM, 0, 5), (CAT, 6, 1), (COPY, 8, 1),
                             (FLASH, 10, 30)]),
}


@pytest.mark.parametrize("case", sorted(TRACES))
def test_map_device_spans_matches_jax(case):
    from horovod_tpu.core import xprof as jx
    from horovod_tpu_torch.core import xprof as tx

    sched, ops = TRACES[case]
    jev, tev = _trace(ops)
    want = jx.map_device_spans(sched, jev)
    got = tx.map_device_spans(sched, tev)
    assert got == want
    assert want[0][1] == "DEVICE_STEP"
    if case == "buckets":
        assert sum(a == "MEMCPY_IN_FUSION_BUFFER" for _, a, _, _ in got) == 2
        assert sum(a == "MEMCPY_OUT_FUSION_BUFFER" for _, a, _, _ in got) \
            == 4
        assert ("g.0", "XLA_ALLREDUCE [b0]", 56.0, 20.0) in got


@pytest.mark.parametrize("pair", [NCCL_AR, NCCL_AG, NCCL_RS, NCCL_BC,
                                  NCCL_P2P, CAT, COPY, COPY_KERNEL],
                         ids=["allreduce", "allgather", "reducescatter",
                              "broadcast", "sendrecv", "cat", "memcpy",
                              "copy_kernel"])
def test_kernel_names_classify_as_the_hlo_ops(pair):
    from horovod_tpu.core import xprof as jx
    from horovod_tpu_torch.core import xprof as tx

    assert tx.kernel_base(pair[0]) == jx.hlo_base(pair[1].format(i=1))


@pytest.mark.parametrize("name,want", [
    (FLASH[0], "flash_fwd_kernel"), (ADAMW[0], "adamw_kernel"),
    (GEMM[0], GEMM[0]), ("Memset (Device)", "Memset"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::"
     "CUDAFunctor_add<float>, std::array<char*, 3ul>>(int)",
     "vectorized_elementwise_kernel"),
    ("ncclDevKernel_Reduce_Sum_f32_RING_LL(ncclDevKernelArgsStorage<4096ul>)",
     "nccl-Reduce")])
def test_other_kernels_keep_their_function_names(name, want):
    """Compute kernels are their unqualified function names (never a
    collective, a pack or an unpack); an NCCL kernel of no collective the
    schedule knows keeps its family."""
    from horovod_tpu_torch.core import xprof as tx

    assert tx.kernel_base(name) == want
    assert want not in tx._COLL_KIND


def test_kernel_spans_name_the_ports_kernels():
    from horovod_tpu_torch.core import xprof as tx

    ev = [(FLASH[0], 0.0, 5.0), (GEMM[0], 6.0, 1.0), (ADAMW[0], 8.0, 2.0),
          ("void (anonymous namespace)::channel_sums_ring_kernel<__nv_"
           "bfloat16>(Params)", 11.0, 3.0), (NCCL_AR[0], 15.0, 1.0)]
    assert tx.kernel_spans(ev) == [
        ("_kernels", "flash_fwd_kernel", 0.0, 5.0),
        ("_kernels", "adamw_kernel", 8.0, 2.0),
        ("_kernels", "channel_sums_ring_kernel", 11.0, 3.0)]


# -- the recalibrator ------------------------------------------------------------

SAMPLES = [("nvlink", 1 << 16, 30e-6, 4), ("nvlink", 1 << 20, 180e-6, 4),
           ("nvlink", 8 << 20, 1.3e-3, 4), ("ib", 1 << 20, 900e-6, 8),
           ("ib", 1 << 22, 3.1e-3, 8), ("nvlink", 1 << 20, 1e-4, 1),
           ("ib", 0, 1e-4, 8)]


def _fed(mod, level_of, channels=True):
    rec = mod.Recalibrator()
    for level, n, s, w in SAMPLES:
        rec.observe(level_of(level), n, s, w)
    if channels:
        rec.observe_channels(level_of("nvlink"), 2, 8 << 20, 0.9e-3, 4)
        rec.observe_channels(level_of("ib"), 4, 1 << 22, 1.2e-3, 8)
    return rec


def _jax_level(level):
    return LEVEL[level]


def _port_topo(n=8, slices=1):
    from horovod_tpu.ops import topology as jtop
    from horovod_tpu_torch.ops import topology as ttop

    local = n // slices
    slice_of = tuple(i // local for i in range(n))
    return (jtop.Topology(n, slice_of, slices, local, "cpu",
                          *jtop.seed_links("cpu")),
            ttop.Topology(n, slice_of, slices, local, "cpu",
                          *ttop.seed_links("cpu")))


@pytest.mark.parametrize("channels", [False, True])
def test_recalibrator_constants_match_jax(channels):
    from horovod_tpu.ops import exchange as jex
    from horovod_tpu_torch.ops import exchange as tex

    t = _fed(tex, lambda lv: lv, channels).constants()
    j = _fed(jex, _jax_level, channels).constants()
    assert {LEVEL[k]: v for k, v in t.items()} == j
    assert set(t) == {"nvlink", "ib"}
    assert ("ch_eff" in t["nvlink"]) == channels


def _cache_numbers(path):
    with open(path) as f:
        data = json.load(f)
    consts = {LEVEL.get(k, k): v for k, v in data["constants"].items()}
    recal = {LEVEL.get(k, k): v for k, v in data["recalibration"].items()}
    return (data["device_kind"], data["world"], consts,
            data["fusion_threshold"], recal, data.get("measured"))


@pytest.mark.parametrize("slices", [1, 2])
def test_recalibrator_persists_like_jax(tmp_path, monkeypatch, slices):
    from horovod_tpu.ops import exchange as jex
    from horovod_tpu.utils import costs as jcosts
    from horovod_tpu_torch.ops import exchange as tex
    from horovod_tpu_torch.utils import costs as tcosts

    monkeypatch.delenv("HOROVOD_RECALIBRATION", raising=False)
    jt, tt = _port_topo(8, slices)
    paths = {"port": str(tmp_path / "port.json"),
             "jax": str(tmp_path / "jax.json")}
    # A prior run's cache of each layout: its sums are continued.
    prior = {"s": 2.0e6, "t": 0.4, "st": 9.0e2, "ss": 5.0e12, "n": 2,
             "ch_n": 1, "ch_e": 0.5}
    tcosts.save_tuning_cache({"nvlink": {"alpha_us": 9.0, "gbps": 3.0}},
                             device_kind="cpu", world=8,
                             measured=[{"bytes": 1}],
                             recalibration={"nvlink": dict(prior)},
                             path=paths["port"])
    jcosts.save_tuning_cache({"ici": {"alpha_us": 9.0, "gbps": 3.0}},
                             device_kind="cpu", world=8,
                             measured=[{"bytes": 1}],
                             recalibration={"ici": dict(prior)},
                             path=paths["jax"])
    t = _fed(tex, lambda lv: lv)
    j = _fed(jex, _jax_level)
    assert not t.maybe_persist(tt, path=paths["port"])  # 7 of 8 seen
    assert t.maybe_persist(tt, path=paths["port"], force=True)
    assert j.maybe_persist(jt, path=paths["jax"], force=True)
    assert _cache_numbers(paths["port"]) == _cache_numbers(paths["jax"])
    assert {LEVEL[k]: v for k, v in t.constants().items()} \
        == j.constants()
    monkeypatch.setenv("HOROVOD_RECALIBRATION", "0")
    assert not t.maybe_persist(tt, path=paths["port"], force=True)


def test_a_stale_or_foreign_cache_is_not_continued(tmp_path):
    from horovod_tpu.utils import costs as jcosts
    from horovod_tpu_torch.ops import exchange as tex

    path = str(tmp_path / "cache.json")
    # The JAX package's layout: another schema, ignored.
    jcosts.save_tuning_cache({}, device_kind="cpu", world=8,
                             recalibration={"nvlink": {
                                 "s": 1.0, "t": 1.0, "st": 1.0, "ss": 1.0,
                                 "n": 50}}, path=path)
    rec = tex.Recalibrator()
    rec._seed_from_cache("cpu", path)
    assert rec._sums == {}


def _plans(topo_pair):
    import jax

    from horovod_tpu.ops import compression as jc
    from horovod_tpu.ops import exchange as jex
    from horovod_tpu_torch.ops import compression as tc
    from horovod_tpu_torch.ops import exchange as tex

    sizes = (1 << 16, 3000, 1 << 15, 900)
    labels = [f"g.{i}" for i in range(len(sizes))]
    jt, tt = topo_pair
    j = jex.plan_exchange([jax.ShapeDtypeStruct((n,), "float32")
                           for n in sizes], 1 << 17, mode="priority",
                          compression=jc.resolve("bf16"), labels=labels,
                          topo=jt, max_channels=2)
    t = tex.plan_exchange([torch.empty(n, device="meta") for n in sizes],
                          1 << 17, mode="priority",
                          compression=tc.resolve("bf16"), labels=labels,
                          topo=tt, max_channels=2)
    assert t.to_json() == j.to_json()
    return j, t


@pytest.fixture
def worlds(monkeypatch, tmp_path):
    """Each package initialised on the CPU (the recalibrator's persist
    reads group 0's topology) with a tuning cache of its own."""
    import jax

    import horovod_tpu as jhvd
    import horovod_tpu_torch as hvd
    from horovod_tpu.ops import exchange as jex
    from horovod_tpu_torch.ops import exchange as tex

    for name in list(os.environ):
        if name.startswith("HOROVOD_"):
            monkeypatch.delenv(name)
    hvd.shutdown()
    jhvd.shutdown()
    hvd.init(device="cpu")
    jhvd.init(devices=jax.devices()[:1])
    jex.reset_recalibration()
    tex.reset_recalibration()
    before = (jex.last_plan(), tex.last_plan())
    yield monkeypatch, tmp_path
    jex.register_live_plan(before[0])
    tex.register_live_plan(before[1])
    jex.reset_recalibration()
    tex.reset_recalibration()
    hvd.shutdown()
    jhvd.shutdown()


@pytest.mark.parametrize("slices", [1, 2])
def test_observe_xla_spans_matches_jax(worlds, slices):
    from horovod_tpu.core import xprof as jx
    from horovod_tpu.ops import exchange as jex
    from horovod_tpu_torch.core import xprof as tx
    from horovod_tpu_torch.ops import exchange as tex

    monkeypatch, tmp_path = worlds
    jplan, tplan = _plans(_port_topo(8, slices))
    jex.register_live_plan(jplan)
    tex.register_live_plan(tplan)
    sched = [[f"grads.bucket_{b}", "ALLREDUCE", "float32",
              [sum(1 for _ in m)], 0, -1, list(m)]
             for b, m in enumerate(tplan.members)]
    sched.append(["metric", "ALLREDUCE", "float32", [3, 5], 0, -1, []])
    ops = []
    t = 0.0
    for i, b in enumerate(tplan.buckets):
        for c in range(b.channels):
            ops.append((NCCL_AR, t, 40.0 + 17 * i + c))
            t += 60.0
    ops.append((NCCL_AR, t, 9.0))
    # Repeated steps: enough observations to persist (every 8).
    steps = [(_trace(ops), 0)] * 3
    for (jev, tev), _ in steps:
        jspans = jx.map_device_spans(sched, jev)
        tspans = tx.map_device_spans(sched, tev)
        assert tspans == jspans
        monkeypatch.setenv("HOROVOD_TUNING_CACHE", str(tmp_path / "t.json"))
        tex.observe_xla_spans(tspans, sched)
        monkeypatch.setenv("HOROVOD_TUNING_CACHE", str(tmp_path / "j.json"))
        jex.observe_xla_spans(jspans, sched)
    got = tex.recalibrator().constants()
    want = jex.recalibrator().constants()
    assert got and {LEVEL[k]: v for k, v in got.items()} == want
    assert set(got) == {"ib" if slices == 2 else "nvlink"}
    assert _cache_numbers(str(tmp_path / "t.json")) \
        == _cache_numbers(str(tmp_path / "j.json"))


def test_observe_xla_spans_is_off_under_recalibration_0(worlds):
    from horovod_tpu_torch.core import xprof as tx
    from horovod_tpu_torch.ops import exchange as tex

    monkeypatch, _ = worlds
    monkeypatch.setenv("HOROVOD_RECALIBRATION", "0")
    _, tplan = _plans(_port_topo(8, 1))
    tex.register_live_plan(tplan)
    sched = [["b", "ALLREDUCE", "float32", [8], 0, -1, list(m)]
             for m in tplan.members[:1]]
    spans = tx.map_device_spans(sched, [(NCCL_AR[0], 0.0, 5.0)])
    tex.observe_xla_spans(spans, sched)
    assert tex.recalibrator().constants() == {}
    assert tex.recalibrator()._sums == {}


# -- the planner's compute window --------------------------------------------------

@pytest.mark.parametrize("window", [None, 1e-5, 2e-3, 50e-3])
@pytest.mark.parametrize("slices", [1, 2])
def test_compute_window_plans_match_jax(window, slices):
    import jax

    from horovod_tpu.ops import exchange as jex
    from horovod_tpu.utils import costs as jcosts
    from horovod_tpu_torch.ops import exchange as tex
    from horovod_tpu_torch.utils import costs as tcosts

    jt, tt = _port_topo(8, slices)
    sizes = [1 << 20, 1 << 18, 3 << 19, 1 << 21, 12345, 1 << 19]
    labels = [f"l{i}" for i in range(len(sizes))]
    kw = dict(mode="priority", labels=labels, compute_window_s=window)
    j = jex.plan_exchange([jax.ShapeDtypeStruct((n,), "float32")
                           for n in sizes], 1 << 22, topo=jt,
                          model=jcosts.CostModel(ici=jt.ici, dcn=jt.dcn),
                          **kw)
    t = tex.plan_exchange([torch.empty(n, device="meta") for n in sizes],
                          1 << 22, topo=tt,
                          model=tcosts.CostModel(nvlink=tt.nvlink, ib=tt.ib),
                          **kw)
    assert t.to_json() == j.to_json()
    assert t.region_thresholds[-1] == 1 << 22
    assert list(t.region_thresholds) == sorted(t.region_thresholds)


def test_a_long_window_raises_the_floor():
    """The window branch moves the plan: a long compute window carries
    more bytes per chunk, so the early regions' thresholds rise."""
    from horovod_tpu_torch.ops import exchange as tex

    _, tt = _port_topo(8, 1)
    leaves = [torch.empty(1 << 20, device="meta") for _ in range(16)]
    short = tex.plan_exchange(leaves, 1 << 24, mode="priority", topo=tt)
    long = tex.plan_exchange(leaves, 1 << 24, mode="priority", topo=tt,
                             compute_window_s=0.5)
    assert long.region_thresholds[0] > short.region_thresholds[0]


# -- the device mode on the CPU ----------------------------------------------------

@pytest.fixture
def timeline(monkeypatch, tmp_path):
    import horovod_tpu_torch as hvd

    for name in list(os.environ):
        if name.startswith("HOROVOD_"):
            monkeypatch.delenv(name)
    path = str(tmp_path / "timeline.json")
    monkeypatch.setenv("HOROVOD_TIMELINE", path)
    hvd.shutdown()
    yield monkeypatch, path
    hvd.shutdown()


def _events(path):
    with open(path) as f:
        rows = [json.loads(ln.strip().rstrip(",")) for ln in f
                if ln.strip() not in ("[", "]", "")]
    names = {e["pid"]: e["args"]["name"] for e in rows
             if e["name"] == "process_name"}
    return [dict(e, row=names.get(e["pid"])) for e in rows
            if e["ph"] != "M"]


def _program():
    import horovod_tpu_torch as hvd

    w = torch.nn.Parameter(torch.linspace(-1.0, 1.0, 6))
    opt = hvd.DistributedOptimizer(torch.optim.SGD([w], lr=0.05))

    def step(x):
        opt.zero_grad(set_to_none=False)
        loss = torch.tanh(w * x).sum()
        loss.backward()
        opt.step()
        return loss.detach()

    return hvd.spmd(step), w


def _calls(n=5):
    prog, w = _program()
    losses = [prog(torch.arange(6.0) * 0.1 + i) for i in range(n)]
    return prog, torch.stack(losses), w.detach().clone()


@pytest.mark.parametrize("interval,want", [(None, 1), ("0", 1), ("1", 5),
                                           ("2", 3), ("3", 2), ("x", 1)])
def test_the_interval_samples_the_first_and_every_nth_call(timeline,
                                                           interval, want):
    import horovod_tpu_torch as hvd

    monkeypatch, path = timeline
    monkeypatch.setenv("HOROVOD_TIMELINE_DEVICE", "1")
    if interval is not None:
        monkeypatch.setenv("HOROVOD_TIMELINE_DEVICE_INTERVAL", interval)
    hvd.init(device="cpu")
    prog, losses, w = _calls()
    hvd.shutdown()
    assert prog.sampled == want
    notes = [e for e in _events(path) if e["name"] == "NO_DEVICE_PLANE"]
    assert len(notes) == want
    assert all(e["row"] == "_device" and e["ph"] == "X" for e in notes)
    # Sampling changes no result: the same calls without the device mode.
    monkeypatch.delenv("HOROVOD_TIMELINE_DEVICE")
    hvd.init(device="cpu")
    plain, plain_losses, plain_w = _calls()
    assert plain.sampled == 0
    assert torch.equal(losses, plain_losses) and torch.equal(w, plain_w)


NATIVE_HOST_WARNING = (
    "Timeline.event_at called while only the native writer is active "
    "(HOROVOD_TIMELINE_DEVICE was not set when the timeline started) — "
    "device-true span dropped. Set the variable before horovod_tpu.init().")
PY_HOST_WARNING = (
    "Timeline.event_at called while the timeline is in host mode "
    "(HOROVOD_TIMELINE_DEVICE was not set when the timeline started) — "
    "device-true span dropped. Set the variable before "
    "horovod_tpu_torch.init().")


def test_host_mode_keeps_its_spans_and_refuses_device_spans(timeline):
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.core import timeline as tl

    _, path = timeline
    hvd.init(device="cpu")
    assert not tl.session().device_mode
    prog, _, _ = _calls(3)
    with pytest.warns(UserWarning) as rec:
        tl.session().event_at("_device", "DEVICE_STEP", 0.0, 1.0)
    # The warning of the writer that is active: the native writer's is the
    # reference's text, the Python writer's in host mode the port's.
    assert str(rec[0].message) == (
        NATIVE_HOST_WARNING if tl.session().native_core is not None
        else PY_HOST_WARNING)
    hvd.shutdown()
    events = _events(path)
    assert prog.sampled == 0
    assert not [e for e in events if e["name"] in ("DEVICE_STEP",
                                                   "NO_DEVICE_PLANE")]
    assert [e for e in events if e["name"] == "GRAPH_ALLREDUCE"]


def test_the_native_writers_warning_is_the_references(tmp_path):
    """With the native writer active, ``event_at`` warns with the JAX
    package's own text for its native writer."""
    from horovod_tpu.core import native as jnative
    from horovod_tpu.core import timeline as jtl
    from horovod_tpu_torch.core import native as tnative
    from horovod_tpu_torch.core import timeline as ttl

    texts = []
    for mod, native in ((jtl, jnative), (ttl, tnative)):
        core = native.NativeCore([1])
        t = mod.Timeline()
        t.start(str(tmp_path / f"{mod.__name__}.json"), core)
        with pytest.warns(UserWarning) as rec:
            t.event_at("_device", "DEVICE_STEP", 0.0, 1.0)
        t.stop()
        core.close()
        texts.append(str(rec[0].message))
    assert texts[0] == texts[1] == NATIVE_HOST_WARNING


def test_the_python_writer_in_host_mode_refuses_device_spans(tmp_path):
    from horovod_tpu_torch.core import timeline as ttl

    t = ttl.Timeline()
    t.start(str(tmp_path / "py.json"))
    assert t.native_core is None and not t.device_mode
    with pytest.warns(UserWarning) as rec:
        t.event_at("_device", "DEVICE_STEP", 0.0, 1.0)
    t.stop()
    assert str(rec[0].message) == PY_HOST_WARNING


def test_the_device_mode_is_latched_at_start(timeline):
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.core import timeline as tl

    monkeypatch, path = timeline
    monkeypatch.setenv("HOROVOD_TIMELINE_DEVICE", "1")
    hvd.init(device="cpu")
    monkeypatch.setenv("HOROVOD_TIMELINE_DEVICE", "0")
    assert tl.session().device_mode
    tl.session().event_at("_device", "DEVICE_STEP", 5.0, 2.5)
    hvd.shutdown()
    assert not tl.session().device_mode
    [step] = [e for e in _events(path) if e["name"] == "DEVICE_STEP"]
    assert step["dur"] == 2.5 and step["row"] == "_device"


def test_a_step_that_raises_leaves_no_profiler_session(timeline):
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.core import xprof as tx

    monkeypatch, _ = timeline
    monkeypatch.setenv("HOROVOD_TIMELINE_DEVICE", "1")
    hvd.init(device="cpu")

    def boom(x):
        raise RuntimeError("step failed")

    with pytest.raises(RuntimeError, match="step failed"):
        hvd.spmd(boom)(torch.ones(2))
    assert not torch.autograd.profiler._is_profiler_enabled
    out, events, _ = tx.profiled_events(lambda: torch.ones(3).sum())
    assert float(out) == 3.0 and events == []


def test_timed_steps_uses_the_wall_clock_on_the_cpu(timeline):
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.core import xprof as tx

    hvd.init(device="cpu")
    calls = []
    info = {}
    best = tx.timed_steps(lambda: calls.append(1), 4, trials=3, strict=True,
                          info=info)
    assert info == {"timing": "host"} and len(calls) == 3
    assert 0 < best < 1.0


@pytest.mark.parametrize("raw,want", [(None, 0), ("", 0), ("3", 3),
                                      ("-2", 0), ("x", 0)])
def test_the_interval_parses_like_jax(monkeypatch, raw, want):
    from horovod_tpu.utils import env as jenv
    from horovod_tpu_torch.utils import env as tenv

    if raw is None:
        monkeypatch.delenv("HOROVOD_TIMELINE_DEVICE_INTERVAL", raising=False)
    else:
        monkeypatch.setenv("HOROVOD_TIMELINE_DEVICE_INTERVAL", raw)
    assert tenv.timeline_device_interval() == jenv.timeline_device_interval() \
        == want
    np.testing.assert_equal(tenv.timeline_device_mode(),
                            jenv.timeline_device_mode())


def test_measured_exposed_comm_is_none_without_device_events(timeline):
    """The CPU's session has no device plane: None, as the JAX package's
    on the CPU, so callers fall back to the planned estimate."""
    import horovod_tpu_torch as hvd
    from horovod_tpu.ops import exchange as jex
    from horovod_tpu_torch.ops import exchange as tex

    hvd.init(device="cpu")
    ran = []
    assert tex.measured_exposed_comm_ms(lambda: ran.append(1), steps=2) \
        is None
    assert jex.measured_exposed_comm_ms(lambda: ran.append(2)) is None
    assert ran == [1, 2]


def test_exposed_comm_from_classified_spans():
    """What measured_exposed_comm_ms computes from a session: NCCL's
    kernels against the compute around them."""
    from horovod_tpu.ops import exchange as jex
    from horovod_tpu_torch.core import xprof as tx
    from horovod_tpu_torch.ops import exchange as tex

    _, ops = TRACES["buckets"]
    _, tev = _trace(ops)
    comm = [(s, d) for n, s, d in tev if tx.kernel_base(n) == "all-reduce"]
    compute = [(s, d) for n, s, d in tev
               if tx.kernel_base(n) != "all-reduce"]
    got = tex.exposed_comm_from_spans(comm, compute)
    assert got == jex.exposed_comm_from_spans(comm, compute) == 42.0

"""Port parity: the allreduce decompositions (``ops/strategy.py``), the
topology (``ops/topology.py``), the α–β cost model and tuning cache
(``utils/costs.py``) and the exchange knobs, against ``horovod_tpu``'s.

Single-process cases mirror the reference's unit tests
(``tests/test_strategy.py``, ``tests/test_channels.py``): the same inputs
give the same choices, with the reference's ``ici``/``dcn`` levels as the
port's ``nvlink``/``ib``.

One spawned 4-rank gloo world (module-scoped, ``HOROVOD_TOPOLOGY_SLICES=2``:
two simulated hosts of 2 ranks) runs ``flat``, ``rs_ag`` and
``hierarchical`` at 1 and 3 channels under every wire format, the
phase-asymmetric ``cross_compression`` cases and the gradient path under
``auto``; the JAX side runs the same per-rank numpy inputs over 4 CPU
devices inside ``hvd.spmd``, with the same rounding noise fed to both
(``tests/torch_wire_support.py``). The data is integer-valued, so every
decomposition is held bit for bit; on random data each channel count is
held against one channel inside the port (bit for bit on an integer
wire). The subset-group,
family and topology refusals are the reference's texts, on every rank,
and a compressed hierarchical program stamps the reference's phase
activities on the timeline.
"""

import json
import os

import numpy as np
import pytest
import torch

from torch_wire_support import WORLD, install_port_noise, jax_noise

FORMATS = ("none", "bf16", "int8", "int8_block", "int4")
ALGOS = ("flat", "rs_ag", "hierarchical")
CHANNELS = (1, 3)
CROSS = (("bf16", "int4"), ("none", "int8_block"), ("int4", "none"))
N = 1001        # not a multiple of the world, of a host, or of a block
SHAPES = ((300,), (7, 9), (513,))
CASES = [(a, c, f) for a in ALGOS for c in CHANNELS for f in FORMATS]
CROSS_CASES = [(f, x, c) for f, x in CROSS for c in CHANNELS]


def _data(kind: str = "int") -> np.ndarray:
    rng = np.random.RandomState(21 if kind == "int" else 22)
    if kind == "int":
        return rng.randint(-20, 21, (WORLD, N)).astype(np.float32)
    return rng.randn(WORLD, N).astype(np.float32)


def _grads():
    rng = np.random.RandomState(23)
    return [rng.randint(-9, 10, (WORLD,) + s).astype(np.float32)
            for s in SHAPES]


# -- the port's world ---------------------------------------------------------


def _program(fed, hvd, x):
    fed.reset()
    out = [hvd.allreduce(x, average=False, name=f"{a}_{c}_{f}",
                         compression=f, algo=a, channels=c)
           for a, c, f in CASES]
    out += [hvd.allreduce(x, average=False, name=f"cross_{f}_{xc}_{c}",
                          compression=f, cross_compression=xc,
                          algo="hierarchical", channels=c)
            for f, xc, c in CROSS_CASES]
    return out


def _message(fn):
    import horovod_tpu_torch as hvd

    try:
        fn()
    except (hvd.HorovodError, NotImplementedError) as e:
        return f"{type(e).__name__}: {e}"
    return None


def _refusals(hvd, x):
    def prog(f):
        return lambda: hvd.spmd(f)(x)

    def slices(n, f):
        old = os.environ["HOROVOD_TOPOLOGY_SLICES"]
        os.environ["HOROVOD_TOPOLOGY_SLICES"] = n
        try:
            return _message(prog(f))
        finally:
            os.environ["HOROVOD_TOPOLOGY_SLICES"] = old

    return {
        "subset_rs_ag": _message(prog(lambda x: hvd.allreduce(
            x, group=1, algo="rs_ag", name="s1"))),
        "subset_hierarchical": _message(prog(lambda x: hvd.allreduce(
            x, group=1, algo="hierarchical", name="s2"))),
        "subset_channels": _message(prog(lambda x: hvd.allreduce(
            x, group=1, channels=2, name="s3"))),
        "family_compression": _message(prog(lambda x: hvd.allreduce(
            x, group=(1,), compression="int8", name="s4"))),
        "family_algo": _message(prog(lambda x: hvd.allreduce(
            x, group=(1,), algo="rs_ag", name="s5"))),
        "gradients_channels": _message(prog(
            lambda x: hvd.allreduce_gradients([x.clone()], group=1,
                                              channels=2))),
        "one_slice": slices("1", lambda x: hvd.allreduce(
            x, algo="hierarchical", name="s6")),
        "three_slices": slices("3", lambda x: hvd.allreduce(
            x, algo="hierarchical", name="s7")),
        "unknown_algo": _message(prog(lambda x: hvd.allreduce(
            x, algo="ring", name="s8"))),
        "bad_channels": _message(prog(lambda x: hvd.allreduce(
            x, channels=0, name="s9"))),
    }


def _port_world(tmpdir):
    os.environ["HOROVOD_TOPOLOGY_SLICES"] = "2"
    os.environ["HOROVOD_TIMELINE"] = os.path.join(tmpdir, "port.json")
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.core import state
    from horovod_tpu_torch.ops import topology

    from horovod_tpu_torch.ops import compression

    hvd.init([[0, 1, 2]], device="cpu")
    r = hvd.rank()
    own_stream = compression._uniform
    fed = install_port_noise(r)
    out = {"topology": topology.discover(state.get_group(0))}
    x = torch.from_numpy(_data()[r])
    out["program"] = [t.numpy() for t in hvd.spmd(
        lambda x: _program(fed, hvd, x))(x)]
    xr = torch.from_numpy(_data("rand")[r])
    compression._uniform = own_stream
    out["random"] = [t.numpy() for t in hvd.spmd(
        lambda x: _program(fed, hvd, x))(xr)]
    fed = install_port_noise(r)

    def grads(*ts):
        fed.reset()
        plain = hvd.allreduce_gradients([t.clone() for t in ts], algo="auto",
                                        fusion_threshold=1200, name="auto")
        comp = hvd.allreduce_gradients(
            [t.clone() for t in ts], algo="hierarchical",
            compression="int8_block", fusion_threshold=1200, channels=2,
            name="hier")
        return plain + comp

    out["gradients"] = [t.numpy() for t in hvd.spmd(grads)(
        *[torch.from_numpy(g[r]) for g in _grads()])]
    out["errors"] = _refusals(hvd, torch.ones(6))

    def timed(x):
        fed.reset()
        return hvd.allreduce(x, average=False, name="tl",
                             compression="int8_block", algo="hierarchical",
                             channels=2)

    hvd.spmd(timed)(x)
    out["after"] = float(hvd.allreduce(torch.ones(1), name="after"))
    return out


@pytest.fixture(scope="module")
def tmpdir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("strategy"))


@pytest.fixture(scope="module")
def port(tmpdir):
    from horovod_tpu_torch.run import run

    return run(_port_world, WORLD, device="cpu", timeout=240, args=(tmpdir,))


# -- the JAX side -------------------------------------------------------------


@pytest.fixture(scope="module")
def jhvd():
    import jax

    import horovod_tpu as jhvd

    jhvd.shutdown()
    jhvd.init([[0, 1, 2]], devices=jax.devices()[:WORLD])
    yield jhvd
    jhvd.shutdown()


def _jax_message(jhvd, fn):
    with pytest.raises(jhvd.HorovodError) as info:
        fn()
    return f"HorovodError: {info.value}"


@pytest.fixture(scope="module")
def jax_side(jhvd, tmpdir):
    from horovod_tpu.core import timeline as jtl

    mp = pytest.MonkeyPatch()
    mp.setenv("HOROVOD_TOPOLOGY_SLICES", "2")
    res = {}
    try:
        with jax_noise() as fed:
            def prog(x):
                fed.reset()
                out = [jhvd.allreduce(x, average=False, name=f"{a}_{c}_{f}",
                                      compression=f, algo=a, channels=c)
                       for a, c, f in CASES]
                out += [jhvd.allreduce(
                    x, average=False, name=f"cross_{f}_{xc}_{c}",
                    compression=f, cross_compression=xc,
                    algo="hierarchical", channels=c)
                    for f, xc, c in CROSS_CASES]
                return out

            res["program"] = [np.asarray(t)
                              for t in jhvd.spmd(prog)(_data())]

            def grads(*ts):
                fed.reset()
                plain = jhvd.allreduce_gradients(
                    list(ts), algo="auto", fusion_threshold=1200)
                comp = jhvd.allreduce_gradients(
                    list(ts), algo="hierarchical", compression="int8_block",
                    fusion_threshold=1200, channels=2)
                return plain + comp

            res["gradients"] = [np.asarray(t)
                                for t in jhvd.spmd(grads)(*_grads())]

            path = os.path.join(tmpdir, "jax.json")
            jtl.session().start(path)
            try:
                def timed(x):
                    fed.reset()
                    return jhvd.allreduce(x, average=False, name="tl",
                                          compression="int8_block",
                                          algo="hierarchical", channels=2)
                jhvd.spmd(timed)(_data())
            finally:
                jtl.session().stop()
        xs = np.ones((WORLD, 6), np.float32)

        def prog_raises(f):
            return _jax_message(jhvd, lambda: jhvd.spmd(f)(xs))

        def slices(n, f):
            mp.setenv("HOROVOD_TOPOLOGY_SLICES", n)
            try:
                return prog_raises(f)
            finally:
                mp.setenv("HOROVOD_TOPOLOGY_SLICES", "2")

        res["errors"] = {
            "subset_rs_ag": prog_raises(lambda x: jhvd.allreduce(
                x, group=1, algo="rs_ag", name="s1")),
            "subset_hierarchical": prog_raises(lambda x: jhvd.allreduce(
                x, group=1, algo="hierarchical", name="s2")),
            "subset_channels": prog_raises(lambda x: jhvd.allreduce(
                x, group=1, channels=2, name="s3")),
            "family_compression": prog_raises(lambda x: jhvd.allreduce(
                x, group=(1,), compression="int8", name="s4")),
            "family_algo": prog_raises(lambda x: jhvd.allreduce(
                x, group=(1,), algo="rs_ag", name="s5")),
            "gradients_channels": prog_raises(
                lambda x: jhvd.allreduce_gradients([x], group=1,
                                                   channels=2)),
            "one_slice": slices("1", lambda x: jhvd.allreduce(
                x, algo="hierarchical", name="s6")),
            "three_slices": slices("3", lambda x: jhvd.allreduce(
                x, algo="hierarchical", name="s7")),
            "unknown_algo": prog_raises(lambda x: jhvd.allreduce(
                x, algo="ring", name="s8")),
            "bad_channels": prog_raises(lambda x: jhvd.allreduce(
                x, channels=0, name="s9")),
        }
    finally:
        mp.undo()
    return res


# -- the collectives ----------------------------------------------------------


@pytest.mark.parametrize("case", CASES + CROSS_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_decomposition_matches_jax(port, jax_side, case):
    j = (CASES + CROSS_CASES).index(case)
    want = jax_side["program"][j]
    for r in range(WORLD):
        got = port[r]["program"][j]
        assert got.dtype == want[r].dtype
        np.testing.assert_array_equal(got, want[r], err_msg=str(r))


RANDOM_CASES = [(a, f) for a in ALGOS for f in FORMATS
                if not (a == "hierarchical" and f in ("int8_block", "int4"))]


@pytest.mark.parametrize("algo,fmt", RANDOM_CASES,
                         ids=lambda c: str(c))
def test_channels_equal_one_channel_on_random_data(port, algo, fmt):
    """The channel split is below the quantization (the port's own noise
    stream, keyed by the data: the same for both counts). On data where
    addition order matters, an integer wire quantized from the input
    (int8, int8_block, int4) is bit for bit at any channel count. A float
    wire (none, bf16) is summed by the backend's ring, whose order for an
    element depends on where the chunk boundaries fall, so 3 channels agree
    with 1 to the 3 roundings of sum|x| (2^-24 fp32, 2^-8 bf16) — the
    reference's XLA sum is elementwise and does not move (ROADMAP §C).
    The phase-asymmetric hierarchical formats quantize that float
    intra-host sum, so they are held bit for bit on integer data only
    (``test_decomposition_matches_jax``)."""
    one = CASES.index((algo, 1, fmt))
    three = CASES.index((algo, 3, fmt))
    for r in range(WORLD):
        got, want = port[r]["random"][three], port[r]["random"][one]
        if fmt in ("none", "bf16"):
            ulp = 2.0 ** (-24 if fmt == "none" else -8)
            tol = 3 * ulp * np.abs(_data("rand")).sum(0)
            assert np.all(np.abs(got - want) <= tol)
        else:
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("j", range(2 * len(SHAPES)))
def test_gradient_path_auto_and_compressed_hierarchical_match_jax(
        port, jax_side, j):
    for r in range(WORLD):
        np.testing.assert_array_equal(port[r]["gradients"][j],
                                      jax_side["gradients"][j][r])


@pytest.mark.parametrize("key", ["subset_rs_ag", "subset_hierarchical",
                                 "subset_channels", "family_compression",
                                 "family_algo", "gradients_channels",
                                 "one_slice", "three_slices",
                                 "unknown_algo", "bad_channels"])
def test_refusals_match_jax_on_every_rank(port, jax_side, key):
    for r in range(WORLD):
        assert port[r]["errors"][key] == jax_side["errors"][key], r


def _phases(path: str, row: str) -> list:
    with open(path) as f:
        lines = [ln.rstrip(",\n") for ln in f if ln.startswith("{")]
    events = [json.loads(ln) for ln in lines]
    pid = next(e["pid"] for e in events if e.get("ph") == "M"
               and e["name"] == "process_name" and e["args"]["name"] == row)
    return [(e["name"], e["ph"]) for e in events
            if e.get("pid") == pid and e.get("ph") in ("B", "E")]


def test_timeline_phases_of_a_compressed_hierarchical_program(
        port, jax_side, tmpdir):
    """The reference's phase spans, in order; the port also spans each
    channel instance (the reference's CH<c> scope)."""
    phases = {"REDUCE_SCATTER", "CROSS_SLICE", "ALL_GATHER", "QUANTIZE",
              "DEQUANTIZE"}
    got = _phases(os.path.join(tmpdir, "port.json"), "tl")
    want = _phases(os.path.join(tmpdir, "jax.json"), "tl")
    assert [e for e in got if e[0] in phases] == \
        [e for e in want if e[0] in phases]
    assert {"CH0", "CH1"} <= {n for n, _ in got}
    assert ("QUANTIZE", "B") in want and ("CROSS_SLICE", "B") in want


def test_two_simulated_hosts(port):
    for r in range(WORLD):
        topo = port[r]["topology"]
        assert (topo.slice_of, topo.num_slices, topo.local_size) == \
            ((0, 0, 1, 1), 2, 2)
        assert topo.device_kind == "cpu"
        assert port[r]["after"] == 1.0


# -- single-process: the cost model, topology and knobs --------------------------


def _topologies():
    """(group size, slices) pairs, the ragged one included."""
    return [(1, 1), (2, 1), (8, 1), (4, 2), (16, 4), (256, 32), (6, None)]


def _both_topologies(n, slices, kind="cpu"):
    from horovod_tpu.ops import topology as jtop
    from horovod_tpu_torch.ops import topology as ttop

    if slices is None:  # ragged: 4 + 2
        slice_of = (0, 0, 0, 0, 1, 1)
        num, local = 2, None
    else:
        local = n // slices
        slice_of = tuple(i // local for i in range(n))
        num = slices
    j_ici, j_dcn = jtop.seed_links(kind)
    t_nv, t_ib = ttop.seed_links(kind)
    jt = jtop.Topology(n, slice_of, num, local, kind, j_ici, j_dcn)
    tt = ttop.Topology(n, slice_of, num, local, kind, t_nv, t_ib)
    return jt, tt


SIZES = (0, 1000, 1 << 16, 1 << 20, 64 << 20, 1 << 30)


@pytest.mark.parametrize("n,slices", _topologies())
def test_cost_model_predictions_and_choices_match_jax(n, slices):
    from horovod_tpu.utils import costs as jcosts
    from horovod_tpu_torch.utils import costs as tcosts

    jt, tt = _both_topologies(n, slices)
    jm = jcosts.CostModel(ici=jt.ici, dcn=jt.dcn)
    tm = tcosts.CostModel(nvlink=tt.nvlink, ib=tt.ib)
    for s in SIZES:
        for algo in ("flat", "rs_ag", "hierarchical"):
            for ch in (1, 2, 4, 8):
                kw = dict(gather=algo == "flat" and ch == 2,
                          channels=ch, cross_nbytes=s // 8 if ch > 2
                          else None)
                assert tm.predict_us(algo, s, tt, **kw) == \
                    jm.predict_us(algo, s, jt, **kw)
            assert tm.choose_channels(algo, s, tt, 8) == \
                jm.choose_channels(algo, s, jt, 8)
        for pb in (None, (s, s // 8), (s // 2, s // 8)):
            for gather in (False, True):
                assert tm.choose(s, tt, phase_nbytes=pb, gather=gather) == \
                    jm.choose(s, jt, phase_nbytes=pb, gather=gather)
    assert tm.fusion_threshold_bytes(tt) == jm.fusion_threshold_bytes(jt)
    if n == 1:
        return  # a 1-rank group costs nothing, whatever the name
    with pytest.raises(ValueError) as want:
        jm.predict_us("ring", 1, jt)
    with pytest.raises(ValueError) as got:
        tm.predict_us("ring", 1, tt)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("n,slices", _topologies())
def test_sparse_density_switch_matches_jax(n, slices):
    from horovod_tpu.utils import costs as jcosts
    from horovod_tpu_torch.utils import costs as tcosts

    jt, tt = _both_topologies(n, slices)
    jm = jcosts.CostModel(ici=jt.ici, dcn=jt.dcn)
    tm = tcosts.CostModel(nvlink=tt.nvlink, ib=tt.ib)
    for rows in (1, 64, 4096):
        for dense_rows in (100, 50_000):
            for thr in (None, 0.05, 1.0):
                kw = dict(rows_per_rank=rows, row_bytes=516,
                          dense_nbytes=dense_rows * 512,
                          dense_rows=dense_rows, density_threshold=thr)
                assert tm.choose_sparse(topo=tt, **kw) == \
                    jm.choose_sparse(topo=jt, **kw)
            assert tm.sparse_crossover_density(516, dense_rows, 512, tt) == \
                jm.sparse_crossover_density(516, dense_rows, 512, jt)


def test_h100_seeds_rank_hierarchical_for_large_multi_host_buckets():
    """The port's NVLink/InfiniBand seeds order the algorithms as the
    reference's ICI/DCN ones: flat for small buckets, hierarchical for
    large ones across hosts, rs_ag for large ones within a host."""
    from horovod_tpu_torch.utils import costs as tcosts

    _, multi = _both_topologies(16, 2, "NVIDIA H100 80GB HBM3")
    _, single = _both_topologies(8, 1, "NVIDIA H100 80GB HBM3")
    assert multi.nvlink.gbps > multi.ib.gbps
    m = tcosts.CostModel(nvlink=multi.nvlink, ib=multi.ib)
    assert m.choose(1000, multi) == "flat"
    assert m.choose(256 << 20, multi) == "hierarchical"
    assert m.choose(256 << 20, single) == "rs_ag"


def test_tuning_cache_round_trip_and_hygiene(tmp_path, monkeypatch):
    """The reference's cache tests on the port's layout: a written cache
    calibrates the model for its device kind only; another schema, a
    corrupt file or a missing one leaves the seeds."""
    from horovod_tpu_torch.utils import costs as tcosts

    path = str(tmp_path / "tune.json")
    monkeypatch.setenv("HOROVOD_TUNING_CACHE", path)
    _, topo = _both_topologies(4, 2)
    assert tcosts.model_for(topo).source == "analytic"
    tcosts.save_tuning_cache({"nvlink": {"alpha_us": 2.0, "gbps": 40.0,
                                         "ch_eff": 0.5}},
                             device_kind="cpu", world=4,
                             fusion_threshold=1 << 22)
    m = tcosts.model_for(topo)
    assert (m.source, m.nvlink.gbps, m.nvlink_ch_eff) == \
        ("calibrated", 40.0, 0.5)
    assert m.ib == topo.ib
    assert tcosts.tuned_fusion_threshold(topo) == 1 << 22
    other = tcosts.save_tuning_cache({}, device_kind="tpu", world=4,
                                     path=str(tmp_path / "other.json"))
    assert tcosts.model_for(topo, other).source == "analytic"
    data = json.load(open(path))
    data["schema"] = "horovod_tpu/allreduce-tuning/v3"
    json.dump(data, open(path, "w"))
    os.utime(path, ns=(1, 1))
    assert tcosts.load_tuning_cache() is None
    open(path, "w").write("{not json")
    os.utime(path, ns=(2, 2))
    assert tcosts.model_for(topo).source == "analytic"
    os.remove(path)
    assert tcosts.load_tuning_cache() is None


@pytest.mark.parametrize("total", [0, 1, 2, 3, 7, 16, 100, 1001])
@pytest.mark.parametrize("channels", [1, 2, 3, 4, 8, 64])
def test_channel_sizes_match_jax(total, channels):
    from horovod_tpu.ops import strategy as jstrat
    from horovod_tpu_torch.ops import strategy as tstrat

    assert tstrat._channel_sizes(total, channels) == \
        jstrat._channel_sizes(total, channels)


@pytest.mark.parametrize("spec", [None, "flat", " RS_AG ", "hierarchical",
                                  "auto", "ring", 3, "channels:1", 0, 2,
                                  True, "x"])
def test_algo_and_channels_arguments_resolve_like_the_reference(spec):
    from horovod_tpu.ops import strategy as jstrat
    from horovod_tpu_torch.ops import strategy as tstrat

    for fn in ("resolve_spec", "resolve_channels"):
        def outcome(mod):
            try:
                return getattr(mod, fn)(spec)
            except Exception as e:
                return (type(e).__name__, str(e))
        assert outcome(tstrat) == outcome(jstrat)


KNOB_VALUES = {
    "HOROVOD_ALLREDUCE_ALGO": ["flat", "Auto", "hierarchical", "ring", ""],
    "HOROVOD_COMPRESSION": ["int8", " BF16 ", "", "none"],
    "HOROVOD_COMPRESSION_BLOCK": ["64", "7", "6", "x", ""],
    "HOROVOD_COMPRESSION_CROSS_SLICE": ["int4", "none", "int5", ""],
    "HOROVOD_ERROR_FEEDBACK": ["1", "0", "yes", ""],
    "HOROVOD_EXCHANGE_CHANNELS": ["4", "0", "two", ""],
    "HOROVOD_TOPOLOGY_SLICES": ["2", "-1", "x", ""],
    "HOROVOD_SPARSE_DENSITY_THRESHOLD": ["0.25", "inf", "0", "nan", "x",
                                         ""],
}
READERS = {
    "HOROVOD_ALLREDUCE_ALGO": "allreduce_algo_default",
    "HOROVOD_COMPRESSION": "compression_default",
    "HOROVOD_COMPRESSION_BLOCK": "compression_block",
    "HOROVOD_COMPRESSION_CROSS_SLICE": "compression_cross_slice_default",
    "HOROVOD_ERROR_FEEDBACK": "error_feedback_default",
    "HOROVOD_EXCHANGE_CHANNELS": "exchange_channels_default",
    "HOROVOD_TOPOLOGY_SLICES": "topology_slices",
    "HOROVOD_SPARSE_DENSITY_THRESHOLD": "sparse_density_threshold",
}


@pytest.mark.parametrize("knob", sorted(KNOB_VALUES))
def test_exchange_knobs_parse_like_the_reference(monkeypatch, knob):
    from horovod_tpu.utils import env as jenv
    from horovod_tpu_torch.utils import env as tenv

    for raw in [None] + KNOB_VALUES[knob]:
        if raw is None:
            monkeypatch.delenv(knob, raising=False)
        else:
            monkeypatch.setenv(knob, raw)

        def outcome(mod):
            try:
                return getattr(mod, READERS[knob])()
            except ValueError as e:
                return str(e)
        assert outcome(tenv) == outcome(jenv), raw


def test_bucket_annotations_and_descriptions_match_jax():
    """Wire dtype, per-phase wire and channel clamp of the enumeration
    plan, through ``describe``: the reference's strings."""
    import jax.numpy as jnp

    from horovod_tpu.ops import compression as jc
    from horovod_tpu.ops import exchange as jex
    from horovod_tpu.ops import fusion as jf
    from horovod_tpu_torch.ops import compression as tc
    from horovod_tpu_torch.ops import exchange as tex
    from horovod_tpu_torch.ops import fusion as tf

    shapes = [(300,), (7, 9), (513,), (2, 2)]
    dts = ["float32", "float32", "float32", "int32"]
    jl = [jnp.zeros(s, d) for s, d in zip(shapes, dts)]
    tl = [torch.zeros(s, dtype=getattr(torch, d))
          for s, d in zip(shapes, dts)]
    for comp in ("bf16", "int8", "int8_block", "int4", None):
        for cross in (None, "int4", "none"):
            for algo in ("flat", "rs_ag", "hierarchical"):
                jcomp = None if comp is None else jc.resolve(comp)
                tcomp = None if comp is None else tc.resolve(comp)
                try:
                    jb = jf.plan_buckets(jl, 1500, compression=jcomp,
                                         algo=algo, group_size=4,
                                         cross_compression=cross)
                except Exception as e:
                    with pytest.raises(Exception) as got:
                        tf.plan_buckets(tl, 1500, compression=tcomp,
                                        algo=algo, group_size=4,
                                        cross_compression=cross)
                    assert str(got.value) == str(e)
                    continue
                tb = tf.plan_buckets(tl, 1500, compression=tcomp, algo=algo,
                                     group_size=4, cross_compression=cross)
                jb = jex._assign_channels(jb, None, None, 4, 2, 3, 1, jcomp)
                tb = tex._assign_channels(tb, None, None, 4, 2, 3, 1, tcomp)
                assert [b.describe() for b in tb] == \
                    [b.describe() for b in jb]
                assert [(b.bytes_on_wire, b.intra_bytes_on_wire,
                         b.cross_bytes_on_wire) for b in tb] == \
                    [(b.bytes_on_wire, b.intra_bytes_on_wire,
                      b.cross_bytes_on_wire) for b in jb]

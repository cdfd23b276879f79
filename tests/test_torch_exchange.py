"""Port parity: the whole-step exchange planner (``ops/exchange.py``) and its
wiring into the gradient path, against ``horovod_tpu``'s.

Pure cases (no world) hold the port's plans against the JAX package's
``plan_exchange`` for the same leaf sizes, dtypes, labels, threshold,
compressor, algorithm, world, slices and link constants: ``to_json()``
byte for byte and ``plan_hash()``, across the modes, ``priority_fn``, the
compressors, ``channels=``/``max_channels=`` and sparse rows; the
``priority`` plan at 8 ranks x 2 slices under the CPU seed links is the
reference's golden plan (``tests/golden_schedules.json``). The texts of
``resolve_mode``, the knobs and ``from_json``'s refusal are the
reference's, and the exposed-communication model gives its numbers.

One spawned 4-rank gloo world (``HOROVOD_TOPOLOGY_SLICES=2``: two
simulated hosts) runs the gradient path: on integer-valued gradients
``priority`` equals ``enum`` bit for bit for every decomposition under
none, bf16, int8 and int8_block; on random data the scale-coupled formats
(int8, int8_block, int4) stay bit for bit, error-feedback residuals
included, and a float wire (none, bf16) agrees to its roundings (the
re-bucketing divergence, ROADMAP §C). With the same rounding noise fed to
both packages (``tests/torch_wire_support.py``), the port's ``priority``
outputs equal the JAX package's ``allreduce_gradients(schedule=
"priority")`` over 4 CPU devices, bit for bit, on the integer cases and
on the scale-coupled ones, residuals included. Each rank also plans under
its own tuning cache, and the plans' hashes agree.
"""

import ast
import json
import os

import numpy as np
import pytest
import torch

from torch_wire_support import install_port_noise, jax_noise

WORLD = 4
SIZES = (1000, 64, 8192, 300, 4096, 16)
LABELS = tuple(f"layer{i}/w" for i in range(len(SIZES)))
# Large enough that the per-channel model picks more than one channel.
BIG = (1 << 20, 3000, 1 << 22, 77, 1 << 18, 1 << 21)
FORMATS = (None, "bf16", "int8", "int8_block", "int4")
MODES = ("enum", "priority")
GRAD_SHAPES = [(37,), (64,), (17,), (128,), (5,)]
THRESHOLD = 256             # bytes: several buckets of GRAD_SHAPES
# The float-wire cases: buckets large enough that the backend's ring cuts
# them into chunks, so re-bucketing moves an element's chunk.
FLOAT_SHAPES = [(1001,), (517,), (2048,), (333,), (4099,)]
FLOAT_THRESHOLD = 8192
INT_ALGOS = ("flat", "rs_ag", "hierarchical", "auto")
INT_FORMATS = (None, "bf16", "int8", "int8_block")
COUPLED = ("int8", "int8_block", "int4")
FIXED_ALGOS = ("flat", "rs_ag", "hierarchical")
KEY = 4099                  # the coupled cases' compression_key


def _both(comp):
    from horovod_tpu.ops import compression as jc
    from horovod_tpu_torch.ops import compression as tc

    if comp is None:
        return None, None
    return jc.resolve(comp), tc.resolve(comp)


def _leaves(sizes, dtype="float32"):
    import jax

    jl = [jax.ShapeDtypeStruct((n,), dtype) for n in sizes]
    tl = [torch.empty(n, dtype=getattr(torch, dtype), device="meta")
          for n in sizes]
    return jl, tl


def _topologies(n=8, slices=2):
    from horovod_tpu.ops import topology as jtop
    from horovod_tpu_torch.ops import topology as ttop

    local = n // slices
    slice_of = tuple(i // local for i in range(n))
    jt = jtop.Topology(n, slice_of, slices, local, "cpu",
                       *jtop.seed_links("cpu"))
    tt = ttop.Topology(n, slice_of, slices, local, "cpu",
                       *ttop.seed_links("cpu"))
    return jt, tt


def _plans(sizes=SIZES, threshold=16384, comp=None, topo=False, **kw):
    from horovod_tpu.ops import exchange as jex
    from horovod_tpu_torch.ops import exchange as tex

    jl, tl = _leaves(sizes)
    jcomp, tcomp = _both(comp)
    jt, tt = _topologies() if topo else (None, None)
    if not topo:
        kw.setdefault("world_size", 8)
    j = jex.plan_exchange(jl, threshold, compression=jcomp,
                          labels=list(LABELS[:len(sizes)]), topo=jt, **kw)
    t = tex.plan_exchange(tl, threshold, compression=tcomp,
                          labels=list(LABELS[:len(sizes)]), topo=tt, **kw)
    return j, t


def _same(j, t):
    assert t.to_json() == j.to_json()
    assert t.plan_hash() == j.plan_hash()


# -- the plans, against the JAX package's -----------------------------------


@pytest.mark.parametrize("comp", FORMATS, ids=str)
@pytest.mark.parametrize("mode", MODES)
def test_plan_matches_jax(mode, comp):
    j, t = _plans(mode=mode, comp=comp)
    _same(j, t)
    if comp in COUPLED and mode == "priority":
        # Membership is the enumeration plan's; only the issue order moves.
        enum = _plans(mode="enum", comp=comp)[1]
        assert [b.indices for b in t.buckets] == \
            [b.indices for b in enum.buckets][::-1]


@pytest.mark.parametrize("comp,cross", [
    (None, None), (None, "int4"), ("bf16", None), ("bf16", "int4"),
    ("bf16", "none"), ("int8", None), ("int8_block", None), ("int4", None)],
    ids=str)
@pytest.mark.parametrize("mode", MODES)
def test_hierarchical_plan_with_topology_matches_jax(mode, comp, cross):
    """At 8 ranks x 2 slices (the CPU seed links), the sizing floor from
    the cost model and the per-phase wire of hierarchical buckets."""
    j, t = _plans(sizes=BIG, threshold=8 << 20, comp=comp, topo=True,
                  mode=mode, algo="hierarchical", cross_compression=cross)
    _same(j, t)


@pytest.mark.parametrize("fn", ["even_first", "constant", "by_label"])
def test_priority_fn_plan_matches_jax(fn):
    priority_fn = {"even_first": lambda label, i: i % 2,
                   "constant": lambda label, i: 0,
                   "by_label": lambda label, i: label}[fn]
    for threshold in (0, 16384):
        j, t = _plans(threshold=threshold, mode="priority",
                      priority_fn=priority_fn)
        _same(j, t)
    if fn == "even_first":
        first = t.buckets[0].indices
        assert all(i % 2 == 0 for i in first), first


@pytest.mark.parametrize("algo", FIXED_ALGOS)
@pytest.mark.parametrize("kind,n", [("channels", 1), ("channels", 2),
                                    ("channels", 4), ("max_channels", 1),
                                    ("max_channels", 2),
                                    ("max_channels", 4)])
@pytest.mark.parametrize("mode", MODES)
def test_channel_plan_matches_jax(mode, kind, n, algo):
    j, t = _plans(sizes=BIG, threshold=8 << 20, topo=True, mode=mode,
                  algo=algo, **{kind: n})
    _same(j, t)
    chans = {b.channels for b in t.buckets}
    if n == 1:
        assert chans == {1}
    elif kind == "max_channels":
        assert max(chans) > 1 and max(chans) <= n, chans


def test_sparse_rows_serialize_like_jax():
    import jax.numpy as jnp

    from horovod_tpu.ops import exchange as jex
    from horovod_tpu.ops import fusion as jf
    from horovod_tpu_torch.ops import exchange as tex
    from horovod_tpu_torch.ops import fusion as tf

    rows = [dict(index=1, rows=64, row_elems=16, dense_rows=500,
                 algo="gather", label="emb"),
            dict(index=4, rows=8, row_elems=32, dense_rows=10000,
                 algo="dense", wire_bits=4, index_itemsize=8)]
    jrows = [jf.SparseBucket(dtype=jnp.float32,
                             wire_dtype=jnp.uint8 if "wire_bits" in r
                             else None, **r) for r in rows]
    trows = [tf.SparseBucket(dtype=torch.float32,
                             wire_dtype=torch.uint8 if "wire_bits" in r
                             else None, **r) for r in rows]
    for mode in MODES:
        jl, tl = _leaves((300, 20, 7000))
        j = jex.plan_exchange(jl, 4096, mode=mode, world_size=4,
                              labels=["a", "b", "c"], sparse=jrows)
        t = tex.plan_exchange(tl, 4096, mode=mode, world_size=4,
                              labels=["a", "b", "c"], sparse=trows)
        _same(j, t)
        back = tex.ExchangeSchedule.from_json(t.to_json())
        assert back == t
        assert t.describe_rows() == j.describe_rows()
    dense_only = tex.plan_exchange(tl, 4096, mode="enum", world_size=4)
    assert "sparse_buckets" not in dense_only.to_json()


def _chip_smoke_constants() -> dict:
    """``chip_smoke.py``'s module-level constants, read without running it."""
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    out = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            try:
                out[node.targets[0].id] = ast.literal_eval(node.value)
            except ValueError:
                pass
    return out


def test_chip_smoke_pins_the_jax_plan_hash(monkeypatch):
    """``chip_smoke.py`` phase 17(b) holds the plan of the card's step
    against ``PLAN_HASHES``: the JAX package's ``priority`` plan of
    ResNet-50's gradients (the card's leaves and labels, one rank, the
    default threshold, ``flat``), which the port's plan equals."""
    import jax

    from horovod_tpu.ops import compression as jc
    from horovod_tpu.ops import exchange as jex
    from horovod_tpu_torch.models import resnet
    from horovod_tpu_torch.ops import compression as tc
    from horovod_tpu_torch.ops import exchange as tex
    from horovod_tpu_torch.utils import env as tenv

    monkeypatch.delenv("HOROVOD_FUSION_THRESHOLD", raising=False)
    consts = _chip_smoke_constants()
    pinned = consts["PLAN_HASHES"]
    assert set(pinned) == {comp for comp, _ in consts["PLAN_CASES"]}
    with torch.device("meta"):
        model = resnet.ResNet50(num_classes=consts["CLASSES"],
                                dtype=torch.bfloat16, norm_impl="fused",
                                generator=torch.Generator())
    leaves = list(model.parameters())
    jleaves = [jax.ShapeDtypeStruct(tuple(p.shape),
                                    str(p.dtype).removeprefix("torch."))
               for p in leaves]
    labels = [f"DistributedOptimizer.grads.{i}" for i in range(len(leaves))]
    threshold = tenv.fusion_threshold_bytes()
    for comp, want in pinned.items():
        t = tex.plan_exchange(leaves, threshold, mode="priority",
                              compression=tc.active(comp), algo="flat",
                              labels=labels, world_size=1)
        j = jex.plan_exchange(jleaves, threshold, mode="priority",
                              compression=None if comp == "none"
                              else jc.resolve(comp), algo="flat",
                              labels=labels, world_size=1)
        _same(j, t)
        assert t.plan_hash() == want


def _golden(key):
    with open(os.path.join(os.path.dirname(__file__),
                           "golden_schedules.json")) as f:
        return json.load(f)["exchange_plans"][key]


@pytest.mark.parametrize("key,channels", [("priority/none", None),
                                          ("priority/none/ch2", 2)])
def test_priority_plan_is_the_reference_golden_plan(key, channels):
    """The reference's golden plan (``tests/test_exchange.py``): 6 fp32
    leaves, threshold 16384, 8 ranks x 2 slices, the CPU seed links."""
    from horovod_tpu_torch.ops import exchange as tex

    _, tt = _topologies()
    plan = tex.plan_exchange(_leaves(SIZES)[1], 16384, mode="priority",
                             topo=tt, labels=list(LABELS),
                             channels=channels)
    got = [[b.priority, list(b.indices), str(b.dtype).removeprefix("torch."),
            b.total_bytes, None, b.algo]
           + ([b.channels] if channels else []) for b in plan.buckets]
    assert got == _golden(key)


@pytest.mark.parametrize("comp", FORMATS, ids=str)
def test_enum_is_todays_plan_buckets_plan(comp, monkeypatch):
    """``enum`` (the default) is :func:`fusion.plan_buckets`'s plan, bucket
    for bucket, over mixed dtypes; with the knob unset ``resolve_mode``
    picks it."""
    from horovod_tpu_torch.ops import exchange as tex
    from horovod_tpu_torch.ops import fusion as tf

    monkeypatch.delenv("HOROVOD_EXCHANGE_SCHEDULE", raising=False)
    leaves = [torch.empty(n, dtype=d, device="meta") for n, d in (
        (1000, torch.float32), (64, torch.float32), (33, torch.bfloat16),
        (8192, torch.bfloat16), (300, torch.int32), (4096, torch.float32))]
    _, tcomp = _both(comp)
    plan = tex.plan_exchange(leaves, 4096, mode=tex.resolve_mode(None),
                             compression=tcomp, algo="rs_ag", world_size=4)
    assert plan.mode == "enum" and plan.region_thresholds == ()
    assert list(plan.buckets) == tf.plan_buckets(
        leaves, 4096, compression=tcomp, algo="rs_ag", group_size=4)


# -- texts, artifact, knobs -----------------------------------------------------


def _outcome(fn, *args):
    try:
        return ("value", fn(*args))
    except Exception as e:  # noqa: BLE001 — the text is what is compared
        return (type(e).__name__, str(e))


@pytest.mark.parametrize("spec", [None, "enum", " Priority ", "reverse",
                                  "", 3])
@pytest.mark.parametrize("env", [None, "priority", "priorty"])
def test_resolve_mode_matches_jax(monkeypatch, spec, env):
    from horovod_tpu.ops import exchange as jex
    from horovod_tpu_torch.ops import exchange as tex

    if env is None:
        monkeypatch.delenv("HOROVOD_EXCHANGE_SCHEDULE", raising=False)
    else:
        monkeypatch.setenv("HOROVOD_EXCHANGE_SCHEDULE", env)
    assert _outcome(tex.resolve_mode, spec) == \
        _outcome(jex.resolve_mode, spec)
    assert tex.MODES == jex.MODES and tex.N_REGIONS == jex.N_REGIONS
    assert tex.ARTIFACT_SCHEMA == jex.ARTIFACT_SCHEMA


@pytest.mark.parametrize("raw", [None, "", "enum", "PRIORITY", "prio",
                                 "1", "4", "0", "-2", "x", " 2 "])
def test_schedule_and_channel_knobs_parse_like_jax(monkeypatch, raw):
    from horovod_tpu.utils import env as jenv
    from horovod_tpu_torch.utils import env as tenv

    for name in ("HOROVOD_EXCHANGE_SCHEDULE", "HOROVOD_MAX_CHANNELS"):
        if raw is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, raw)
    for fn in ("exchange_schedule_default", "max_channels"):
        assert _outcome(getattr(tenv, fn)) == _outcome(getattr(jenv, fn))


def test_from_json_refusals_match_jax():
    from horovod_tpu.ops import exchange as jex
    from horovod_tpu_torch.ops import exchange as tex

    stale = json.loads(_plans(mode="priority")[1].to_json())
    stale["schema"] = "horovod_tpu/exchange-schedule/v0"
    for text in (json.dumps(stale), "{not json"):
        got = _outcome(tex.ExchangeSchedule.from_json, text)
        want = _outcome(jex.ExchangeSchedule.from_json, text)
        assert got == want and got[0] == "HorovodError"


def test_artifact_round_trips_and_reads_the_jax_artifact(tmp_path):
    """``save`` -> ``from_json`` gives the same plan; the JAX package's
    artifact (elastic and FSDP sections included) reads back to the same
    bytes."""
    from horovod_tpu.ops import exchange as jex
    from horovod_tpu_torch.ops import exchange as tex

    j, t = _plans(sizes=BIG, threshold=8 << 20, topo=True, mode="priority",
                  comp="int4", algo="rs_ag", max_channels=4)
    path = str(tmp_path / "plan.exchange.json")
    t.save(path)
    with open(path) as f:
        back = tex.ExchangeSchedule.from_json(f.read())
    assert back == t and back.plan_hash() == t.plan_hash()
    meta = jex.FsdpMeta("zero3", 2, 4, (2, 0, 1), (40, 8, 12),
                        ("bfloat16", "float32", "int8"))
    jfull = j.with_elastic((0, 1, 3), (2,), 5).with_fsdp(meta)
    tfull = t.with_elastic((0, 1, 3), (2,), 5).with_fsdp(
        tex.FsdpMeta(*dataclass_values(meta)))
    assert tfull.to_json() == jfull.to_json()
    assert tex.ExchangeSchedule.from_json(jfull.to_json()).to_json() == \
        jfull.to_json()


def dataclass_values(obj):
    import dataclasses

    return [getattr(obj, f.name) for f in dataclasses.fields(obj)]


def test_a_plan_that_cannot_be_built_raises():
    """No quiet fallback to ``enum``: a bad mode, mismatched labels, a
    bad channel count and a failing ``priority_fn`` all raise."""
    from horovod_tpu_torch.core.state import HorovodError
    from horovod_tpu_torch.ops import exchange as tex

    tl = _leaves(SIZES)[1]
    with pytest.raises(HorovodError, match="unknown exchange mode"):
        tex.plan_exchange(tl, 4096, mode="reverse")
    with pytest.raises(HorovodError, match="6 leaves"):
        tex.plan_exchange(tl, 4096, mode="priority", labels=["a"])
    with pytest.raises(HorovodError, match="channels must be >= 1"):
        tex.plan_exchange(tl, 4096, mode="priority", world_size=4,
                          channels=0)

    def broken(label, i):
        raise ZeroDivisionError(label)

    with pytest.raises(ZeroDivisionError, match="layer"):
        tex.plan_exchange(tl, 4096, mode="priority", labels=list(LABELS),
                          priority_fn=broken)


@pytest.mark.parametrize("mode", MODES)
def test_exposed_comm_model_matches_jax(mode):
    """The α–β model of exposed communication (a prediction) gives the
    reference's numbers."""
    from horovod_tpu.ops import exchange as jex
    from horovod_tpu.utils import costs as jcosts
    from horovod_tpu_torch.ops import exchange as tex
    from horovod_tpu_torch.utils import costs as tcosts

    jt, tt = _topologies()
    jm = jcosts.CostModel(ici=jt.ici, dcn=jt.dcn)
    tm = tcosts.CostModel(nvlink=tt.nvlink, ib=tt.ib)
    for threshold in (0, 4096, 16384, 1 << 20):
        j, t = _plans(threshold=threshold, topo=True, mode=mode,
                      algo="rs_ag")
        for compute_ms in (0.05, 0.5, 5.0, 50.0):
            got = tex.planned_exposed_comm_ms(t, tt, tm, compute_ms)
            assert got == jex.planned_exposed_comm_ms(j, jt, jm, compute_ms)
    rng = np.random.RandomState(5)
    comm = [tuple(v) for v in rng.rand(20, 2) * (10, 3)]
    compute = [tuple(v) for v in rng.rand(20, 2) * (10, 1)]
    assert tex.exposed_comm_from_spans(comm, compute) == \
        jex.exposed_comm_from_spans(comm, compute)


def test_fused_tree_apply_matches_jax():
    """Nested dicts, lists and tuples; an order-sensitive collective (a
    cumulative sum over each flat bucket) on integer-valued data."""
    import jax.numpy as jnp

    from horovod_tpu.ops import fusion as jf
    from horovod_tpu_torch.ops import fusion as tf

    rng = np.random.RandomState(3)
    arrays = [rng.randint(-9, 10, s).astype(np.float32)
              for s in ((3, 4), (50,), (2, 2, 2), (7,), (100,))]
    ttree = {"a": [torch.from_numpy(arrays[0]),
                   (torch.from_numpy(arrays[1]),
                    torch.from_numpy(arrays[2]))],
             "b": {"c": torch.from_numpy(arrays[3]),
                   "d": torch.from_numpy(arrays[4])}}
    jtree = {"a": [jnp.asarray(arrays[0]),
                   (jnp.asarray(arrays[1]), jnp.asarray(arrays[2]))],
             "b": {"c": jnp.asarray(arrays[3]), "d": jnp.asarray(arrays[4])}}
    calls = []

    def collective(flat):
        calls.append(flat.numel())
        return flat.cumsum(0)

    got = tf.fused_tree_apply(ttree, collective, 256)
    want = jf.fused_tree_apply(jtree, jnp.cumsum, 256)
    assert len(calls) == 3
    assert np.array_equal(ttree["a"][0].numpy(), arrays[0])
    assert torch.utils._pytree.tree_structure(got) == \
        torch.utils._pytree.tree_structure(ttree)
    for g, w in zip(torch.utils._pytree.tree_leaves(got),
                    [want["a"][0], want["a"][1][0], want["a"][1][1],
                     want["b"]["c"], want["b"]["d"]]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# -- the 4-rank world -------------------------------------------------------------


def _int_grads(r):
    # The reference's convention: every partial sum is exact.
    return [torch.from_numpy(np.arange(int(np.prod(s)), dtype=np.float32)
                             .reshape(s) % 13 + r) for s in GRAD_SHAPES]


def _rand_grads(r, seed=31, shapes=GRAD_SHAPES):
    rng = np.random.RandomState(seed + r)
    return [torch.from_numpy(rng.randn(*s).astype(np.float32))
            for s in shapes]


def _float_all():
    return np.stack([np.concatenate([g.numpy().ravel() for g in _rand_grads(
        r, shapes=FLOAT_SHAPES)]) for r in range(WORLD)])


def _cache_for(rank, path):
    """A tuning cache whose constants move the priority floor per rank."""
    from horovod_tpu_torch.utils import costs

    costs.save_tuning_cache(
        {"nvlink": {"alpha_us": 5.0 * 16 ** rank, "gbps": 20.0},
         "ib": {"alpha_us": 25.0 * 16 ** rank, "gbps": 12.5}},
        device_kind="cpu", world=WORLD, path=path)


def _name(key) -> str:
    return "_".join(map(str, key))


def _port_world(tmpdir):
    r = int(os.environ["RANK"])
    os.environ["HOROVOD_TOPOLOGY_SLICES"] = "2"
    os.environ["HOROVOD_TUNING_CACHE"] = os.path.join(tmpdir, "absent.json")
    if r == 0:
        os.environ["HOROVOD_TIMELINE"] = os.path.join(tmpdir, "port.json")
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.core import state
    from horovod_tpu_torch.ops import exchange

    hvd.init(device="cpu")
    plans = {}
    out = {"plans": plans}

    def exchange_(ts, key, mode, resid=None, threshold=THRESHOLD, **kw):
        # One name a case, the same under both modes (the labels are the
        # noise salt of a compressed bucket), unique in its program.
        got = hvd.allreduce_gradients(
            [t.clone() if isinstance(t, torch.Tensor) else t for t in ts],
            fusion_threshold=threshold, name=_name(key), schedule=mode,
            error_residual=resid, **kw)
        plans[key + (mode,)] = exchange.last_plan()
        return list(got[0]) + list(got[1]) if resid is not None else got

    def integer(mode):
        def prog(*ts):
            res = []
            for algo in INT_ALGOS:
                for comp in INT_FORMATS:
                    res += exchange_(ts, ("int", algo, comp), mode,
                                     algo=algo, compression=comp)
            return res
        return prog

    def floats(mode):
        def prog(*ts):
            res = []
            for algo in FIXED_ALGOS:
                for comp in (None, "bf16"):
                    res += exchange_(ts, ("float", algo, comp), mode,
                                     threshold=FLOAT_THRESHOLD, algo=algo,
                                     compression=comp)
            return res
        return prog

    def random(mode):
        def prog(*ts):
            res = []
            for algo in FIXED_ALGOS:
                for comp in COUPLED:
                    resid = [torch.full_like(t, 0.01 * (i + 1))
                             for i, t in enumerate(ts)]
                    res += exchange_(ts, ("coupled", algo, comp), mode,
                                     resid=resid, algo=algo,
                                     compression=comp, compression_key=KEY)
            return res
        return prog

    for kind, make, grads in (("int", integer, _int_grads(r)),
                              ("float", floats,
                               _rand_grads(r, shapes=FLOAT_SHAPES)),
                              ("rand", random, _rand_grads(r))):
        out[kind] = {mode: [t.numpy() for t in hvd.spmd(make(mode))(*grads)]
                     for mode in MODES}

    # The JAX package's noise, fed: the priority runs held against it.
    from horovod_tpu_torch.ops import compression

    own_stream = compression._uniform
    fed = install_port_noise(r)

    def fed_noise(prog):
        def step(*ts):
            fed.reset()
            return prog(*ts)
        return step

    out["jax_int"] = [t.numpy() for t in hvd.spmd(fed_noise(integer(
        "priority")))(*_int_grads(r))]
    out["jax_rand"] = [t.numpy() for t in hvd.spmd(fed_noise(random(
        "priority")))(*_rand_grads(r))]
    compression._uniform = own_stream
    hvd.spmd(lambda *ts: exchange_(
        ts, ("int", "priority_fn"), "priority", algo="rs_ag",
        priority_fn=lambda label, i: i % 2))(*_int_grads(r))

    def with_sparse(values, *ts):
        item = hvd.IndexedSlices(values, torch.tensor([1, 5, 5, 9], dtype=
                                                      torch.int32), (12, 3))
        return exchange_([item] + list(ts), ("sparse",), "priority",
                         algo="flat")[1:]

    hvd.spmd(with_sparse)(torch.ones(4, 3) * (r + 1), *_int_grads(r))

    # Each rank plans under its own tuning cache: the planner reads the
    # topology's seed links, so the hashes agree; a cache-fed model
    # (what the planner must not use) splits them.
    from horovod_tpu_torch.ops import topology
    from horovod_tpu_torch.parallel.optimizer import FusedAllreduce
    from horovod_tpu_torch.utils import costs

    cache = os.path.join(tmpdir, f"tuning.{r}.json")
    _cache_for(r, cache)
    os.environ["HOROVOD_TUNING_CACHE"] = cache
    big = [torch.empty(n, device="meta") for n in BIG]
    fused = FusedAllreduce("det", algo="rs_ag", schedule="priority",
                           max_channels=4)
    plan = fused._resolve(big, state.get_group(0), False)[0]
    topo = topology.discover(state.get_group(0))
    out["hashes"] = {
        "seed": plan.plan_hash(),
        "cache": exchange.plan_exchange(
            big, state.fusion_threshold(), mode="priority", topo=topo,
            model=costs.model_for(topo), algo="rs_ag",
            max_channels=4).plan_hash()}
    out["channels"] = [b.channels for b in plan.buckets]
    return out


@pytest.fixture(scope="module")
def tmpdir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("exchange"))


@pytest.fixture(scope="module")
def port(tmpdir):
    from horovod_tpu_torch.run import run

    return run(_port_world, WORLD, device="cpu", timeout=240, args=(tmpdir,))


def _nints():
    return len(GRAD_SHAPES)


def _case(port, r, kind, at, width):
    """Rank ``r``'s outputs of the case at position ``at`` of program
    ``kind`` under each mode."""
    return {mode: port[r][kind][mode][at:at + width] for mode in MODES}


@pytest.mark.parametrize("comp", INT_FORMATS, ids=str)
@pytest.mark.parametrize("algo", INT_ALGOS)
def test_priority_equals_enum_on_integer_gradients(port, algo, comp):
    """The reference's ``test_priority_bit_exact_vs_enum``: integer-valued
    fp32 gradients, threshold 256 bytes, two simulated hosts."""
    at = (INT_ALGOS.index(algo) * len(INT_FORMATS)
          + INT_FORMATS.index(comp)) * _nints()
    want_sum = sum(_int_grads(r)[0].numpy() for r in range(WORLD)) / WORLD
    for r in range(WORLD):
        got = _case(port, r, "int", at, _nints())
        for e, p in zip(got["enum"], got["priority"]):
            np.testing.assert_array_equal(e, p)
        if comp in (None, "bf16"):
            np.testing.assert_array_equal(got["enum"][0], want_sum)
        plan = port[r]["plans"][("int", algo, comp, "priority")]
        assert plan.mode == "priority" and plan.num_slices == 2
        assert plan.to_json() == port[0]["plans"][
            ("int", algo, comp, "priority")].to_json()


@pytest.mark.parametrize("comp", INT_FORMATS, ids=str)
@pytest.mark.parametrize("algo", FIXED_ALGOS)
@pytest.mark.parametrize("mode", MODES)
def test_the_gradient_path_plan_equals_jax(port, mode, algo, comp):
    """``last_plan()`` of the world's exchange is the JAX package's plan of
    the same leaves: its labels ``<name>.<i>``, the topology discovered
    under the reference's rule (``priority``, or a hierarchical
    decomposition)."""
    import jax

    from horovod_tpu.ops import exchange as jex

    jt, _ = _topologies(WORLD, 2)
    jcomp, _ = _both(comp)
    leaves = [jax.ShapeDtypeStruct(s, "float32") for s in GRAD_SHAPES]
    topo = jt if mode == "priority" or algo == "hierarchical" else None
    name = _name(("int", algo, comp))
    want = jex.plan_exchange(
        leaves, THRESHOLD, mode=mode, compression=jcomp, algo=algo,
        labels=[f"{name}.{i}" for i in range(len(leaves))], topo=topo,
        world_size=WORLD)
    assert port[0]["plans"][("int", algo, comp, mode)].to_json() == \
        want.to_json()
    if (mode, algo, comp) == ("priority", "rs_ag", None):
        name = _name(("int", "priority_fn"))
        fn = jex.plan_exchange(
            leaves, THRESHOLD, mode=mode, algo=algo,
            labels=[f"{name}.{i}" for i in range(len(leaves))], topo=jt,
            priority_fn=lambda label, i: i % 2)
        assert port[0]["plans"][("int", "priority_fn", "priority")] \
            .to_json() == fn.to_json()


@pytest.mark.parametrize("comp", (None, "bf16"), ids=str)
@pytest.mark.parametrize("algo", FIXED_ALGOS)
def test_a_float_wire_agrees_to_its_roundings_when_rebucketed(
        port, algo, comp):
    """The recorded divergence (ROADMAP §C): ``priority`` re-buckets, which
    moves an element's chunk boundary in the backend's ring, so on random
    data a float wire agrees with ``enum`` to the ring's roundings only:
    within 3 roundings of sum|x| over the ranks (2^-24 fp32, 2^-8 bf16),
    as for channels (``test_torch_strategy.py``). The reference's XLA sum
    is elementwise and does not move."""
    at = (FIXED_ALGOS.index(algo) * 2 + (0 if comp is None else 1)) \
        * _nints()
    ulp = 2.0 ** (-24 if comp is None else -8)
    tol = 3 * ulp * np.abs(_float_all()).sum(0) / WORLD
    for r in range(WORLD):
        got = {m: np.concatenate([a.ravel() for a in v]) for m, v in
               _case(port, r, "float", at, _nints()).items()}
        gap = np.abs(got["priority"] - got["enum"])
        assert np.all(gap <= tol), float(np.max(gap / tol))
        plans = [port[r]["plans"][("float", algo, comp, m)] for m in MODES]
        assert [b.indices for b in plans[0].buckets] != \
            [b.indices for b in plans[1].buckets]


# Per decomposition in the random program: each coupled format's
# gradients, then its residuals.
RAND_PER_ALGO = 2 * len(COUPLED) * len(GRAD_SHAPES)


@pytest.mark.parametrize("comp", COUPLED)
@pytest.mark.parametrize("algo", FIXED_ALGOS)
def test_a_scale_coupled_format_stays_bit_exact_on_random_data(
        port, algo, comp):
    """Membership is the enumeration plan's, so each bucket's scale, block
    grid and noise salt are too: outputs and error-feedback residuals are
    bit for bit, only the issue order differs."""
    width = 2 * _nints()    # gradients, then residuals
    at = FIXED_ALGOS.index(algo) * RAND_PER_ALGO + COUPLED.index(comp) \
        * width
    for r in range(WORLD):
        got = _case(port, r, "rand", at, width)
        for e, p in zip(got["enum"], got["priority"]):
            np.testing.assert_array_equal(e, p)
        if algo != "hierarchical":  # whose block formats keep none
            assert any(np.any(a != 0) for a in got["enum"][_nints():])
        pe = port[r]["plans"][("coupled", algo, comp, "enum")]
        pp = port[r]["plans"][("coupled", algo, comp, "priority")]
        assert [b.indices for b in pp.buckets] == \
            [b.indices for b in pe.buckets][::-1]


@pytest.fixture(scope="module")
def jax_priority():
    """The JAX package's ``allreduce_gradients(schedule="priority")`` over 4
    CPU devices (two simulated hosts) on the port world's per-rank inputs,
    the port world's noise fed: the integer program, then the coupled
    formats with error feedback (each case's gradients, then its
    residuals)."""
    import jax
    import jax.numpy as jnp

    import horovod_tpu as jhvd

    mp = pytest.MonkeyPatch()
    mp.setenv("HOROVOD_TOPOLOGY_SLICES", "2")
    jhvd.shutdown()
    jhvd.init(devices=jax.devices()[:WORLD])

    def stacked(make):
        return [np.stack([make(r)[k].numpy() for r in range(WORLD)])
                for k in range(len(GRAD_SHAPES))]

    try:
        with jax_noise() as fed:
            def integer(*ts):
                fed.reset()
                return [t for algo in INT_ALGOS for comp in INT_FORMATS
                        for t in jhvd.allreduce_gradients(
                            list(ts), fusion_threshold=THRESHOLD,
                            algo=algo, compression=comp,
                            schedule="priority")]

            def coupled(*ts):
                fed.reset()
                res = []
                for algo in FIXED_ALGOS:
                    for comp in COUPLED:
                        resid = [jnp.full_like(t, 0.01 * (i + 1))
                                 for i, t in enumerate(ts)]
                        red, new = jhvd.allreduce_gradients(
                            list(ts), fusion_threshold=THRESHOLD,
                            algo=algo, compression=comp,
                            schedule="priority", error_residual=resid,
                            compression_key=jax.random.PRNGKey(KEY))
                        res += list(red) + list(new)
                return res

            return {"int": [np.asarray(t) for t in jhvd.spmd(integer)(
                        *stacked(_int_grads))],
                    "rand": [np.asarray(t) for t in jhvd.spmd(coupled)(
                        *stacked(_rand_grads))]}
    finally:
        jhvd.shutdown()
        mp.undo()


@pytest.mark.parametrize("comp", INT_FORMATS, ids=str)
@pytest.mark.parametrize("algo", INT_ALGOS)
def test_priority_on_integer_gradients_equals_jax(port, jax_priority, algo,
                                                  comp):
    """The port's ``priority`` exchange is the JAX package's, bit for bit,
    on integer-valued gradients, for every decomposition and format."""
    at = (INT_ALGOS.index(algo) * len(INT_FORMATS)
          + INT_FORMATS.index(comp)) * _nints()
    for r in range(WORLD):
        for k in range(at, at + _nints()):
            np.testing.assert_array_equal(port[r]["jax_int"][k],
                                          jax_priority["int"][k][r])


@pytest.mark.parametrize("comp", COUPLED)
@pytest.mark.parametrize("algo", FIXED_ALGOS)
def test_priority_in_a_scale_coupled_format_equals_jax(port, jax_priority,
                                                       algo, comp):
    """On random data, outputs and error-feedback residuals of a
    scale-coupled format under ``priority`` are the JAX package's, bit
    for bit."""
    width = 2 * _nints()
    at = FIXED_ALGOS.index(algo) * RAND_PER_ALGO + COUPLED.index(comp) \
        * width
    for r in range(WORLD):
        for k in range(at, at + width):
            np.testing.assert_array_equal(port[r]["jax_rand"][k],
                                          jax_priority["rand"][k][r])


def test_the_plan_carries_the_sparse_rows(port):
    name = _name(("sparse",))
    for r in range(WORLD):
        plan = port[r]["plans"][("sparse", "priority")]
        (row,) = plan.sparse_buckets
        assert (row.index, row.label, row.dense_rows, row.row_elems) == \
            (0, f"{name}.0", 12, 3)
        assert plan.members[0] and all(m.startswith(f"{name}.")
                                       for ms in plan.members for m in ms)
        assert plan.to_json() == \
            port[0]["plans"][("sparse", "priority")].to_json()
        assert '"sparse_buckets"' in plan.to_json()


def test_every_rank_computes_the_same_plan_under_its_own_cache(port):
    seeds = {port[r]["hashes"]["seed"] for r in range(WORLD)}
    caches = {port[r]["hashes"]["cache"] for r in range(WORLD)}
    assert len(seeds) == 1
    assert len(caches) > 1   # the caches would have split the plan
    assert max(port[0]["channels"]) > 1


def test_the_schedule_activity_names_the_plan(port, tmpdir):
    """Rank 0's timeline: a SCHEDULE span on ``_fusion_buffer`` holding
    ``plan=<hash> mode=<mode>`` and the buckets, as the reference writes."""
    with open(os.path.join(tmpdir, "port.json")) as f:
        events = [json.loads(ln.rstrip(",\n")) for ln in f
                  if ln.startswith("{")]
    pid = next(e["pid"] for e in events if e.get("ph") == "M"
               and e["name"] == "process_name"
               and e["args"]["name"] == "_fusion_buffer")
    row = [e["name"] for e in events if e.get("pid") == pid
           and e.get("ph") in ("B", "E", "X")]
    plan = port[0]["plans"][("int", "hierarchical", "int8", "priority")]
    want = (["SCHEDULE", f"plan={plan.plan_hash()} mode=priority"]
            + [b.describe() for b in plan.buckets] + ["SCHEDULE"])
    n = len(want)
    assert any(row[i:i + n] == want for i in range(len(row) - n + 1))


# -- one rank, in this process -------------------------------------------------


@pytest.fixture
def one_rank(monkeypatch):
    import horovod_tpu_torch as hvd

    for name in list(os.environ):
        if name.startswith("HOROVOD_"):
            monkeypatch.delenv(name)
    hvd.shutdown()
    hvd.init(device="cpu")
    yield hvd
    hvd.shutdown()


def _trainer_run(hvd, schedule):
    from horovod_tpu_torch import training

    g = torch.Generator().manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(6, 16), torch.nn.ReLU(),
                                torch.nn.Linear(16, 3))
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.3)

    def loss_fn(m, batch):
        x, y = batch
        return torch.nn.functional.cross_entropy(m(x), y)

    trainer = hvd.Trainer(model, loss_fn, training.sgd(0.1, momentum=0.9),
                          schedule=schedule, fusion_threshold=256)
    x = torch.randn(8, 6, generator=g)
    y = torch.randint(0, 3, (8,), generator=g)
    losses = [trainer.train_step((x, y))[0].clone() for _ in range(2)]
    return losses, [p.detach().clone() for p in model.parameters()]


def test_the_trainer_takes_the_priority_schedule(one_rank):
    from horovod_tpu_torch.ops import exchange

    prio = _trainer_run(one_rank, "priority")
    plan = exchange.last_plan()
    enum = _trainer_run(one_rank, "enum")
    assert plan.mode == "priority" and exchange.last_plan().mode == "enum"
    assert [b.indices for b in plan.buckets][0] == (3,)
    for a, b in zip(prio[0] + prio[1], enum[0] + enum[1]):
        assert torch.equal(a, b)


def test_the_knobs_leave_the_trainers_buffer_sync_on_enum(one_rank,
                                                          monkeypatch):
    """``HOROVOD_EXCHANGE_SCHEDULE`` and ``HOROVOD_MAX_CHANNELS`` are the
    gradient path's: the Trainer's BatchNorm buffer sync keeps the
    enumeration plan, one channel a bucket, and ``last_plan()`` is the
    gradients' plan."""
    from horovod_tpu_torch import training
    from horovod_tpu_torch.ops import exchange

    hvd = one_rank
    monkeypatch.setenv("HOROVOD_EXCHANGE_SCHEDULE", "priority")
    monkeypatch.setenv("HOROVOD_MAX_CHANNELS", "4")
    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(6, 16),
                                torch.nn.BatchNorm1d(16),
                                torch.nn.Linear(16, 3))

    def loss_fn(m, batch):
        x, y = batch
        return torch.nn.functional.cross_entropy(m(x), y)

    trainer = hvd.Trainer(model, loss_fn, training.sgd(0.1),
                          fusion_threshold=64)
    trainer.train_step((torch.randn(8, 6), torch.randint(0, 3, (8,))))
    buffers = trainer._sync_buffers.plan
    grads = trainer.optimizer._allreduce.plan
    assert buffers.mode == "enum" and buffers.region_thresholds == ()
    assert {b.channels for b in buffers.buckets} == {1}
    assert grads.mode == "priority"
    assert exchange.last_plan() is grads


@pytest.mark.parametrize("where", ["allreduce_gradients",
                                   "DistributedOptimizer", "Trainer",
                                   "knob"])
def test_a_typo_raises_the_reference_text(one_rank, monkeypatch, where):
    hvd = one_rank
    text = ("Unknown exchange schedule 'prioritize'; choose one of "
            "['enum', 'priority'] (HOROVOD_EXCHANGE_SCHEDULE / schedule=).")
    sgd = torch.optim.SGD([torch.nn.Parameter(torch.zeros(2))], lr=0.1)
    if where == "knob":
        monkeypatch.setenv("HOROVOD_EXCHANGE_SCHEDULE", "prioritize")
        with pytest.raises(ValueError) as info:
            hvd.allreduce_gradients([torch.zeros(2)])
        assert str(info.value) == ("HOROVOD_EXCHANGE_SCHEDULE must be "
                                   "enum|priority, got 'prioritize'")
        return
    with pytest.raises(hvd.HorovodError) as info:
        if where == "allreduce_gradients":
            hvd.allreduce_gradients([torch.zeros(2)], schedule="prioritize")
        elif where == "DistributedOptimizer":
            hvd.DistributedOptimizer(sgd, schedule="prioritize")
        else:
            hvd.Trainer(torch.nn.Linear(2, 2), lambda m, b: 0, sgd,
                        schedule="prioritize")
    assert str(info.value) == text


def test_the_embedding_bag_example_prints_its_plan(one_rank, capsys):
    from horovod_tpu_torch.examples import embedding_bag

    res = embedding_bag.main(["--steps", "3", "--num-embeddings", "200",
                              "--embedding-dim", "8", "--batch-size", "8",
                              "--device", "cpu"])
    plan = res["plan"]
    (row,) = plan.sparse_buckets
    assert row.label == "embedding_bag.grads.0"
    assert f"exchange plan {plan.plan_hash()}: {row.describe()}" in \
        capsys.readouterr().out

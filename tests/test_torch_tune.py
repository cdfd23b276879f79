"""The port's profile-guided tuning (``horovod_tpu_torch/tune``) against
the JAX package's, on the CPU.

* ``TunedConfig``: round trip, ``config_hash``, and JSON equal to the JAX
  package's for the same fields once the schema and the level names
  (``nvlink``/``ib`` for ``ici``/``dcn``) are mapped; the refusals' texts.
* ``search`` against ``horovod_tpu.tune.search`` on the same leaves and
  labels, worlds 1/2/4/8, slices 1/2, compute windows None/1 ms/20 ms and
  a cost model of the same numbers: knobs, predicted ms and plan hashes
  equal; the five pricing functions likewise.
* ``calibrate(measure=fake, lm=False)``'s constants equal JAX's at worlds
  1 and 2 (and on two simulated hosts).
* One 2-rank gloo world: ``hvd.tune(measure=fake)`` commits a pair that
  verifies, whose plan hash equals the JAX package's ``hvd.tune`` over 2
  CPU devices; restricted groups and the Trainer's buffer sync keep their
  defaults under a tuned config; env beats tuned; ``apply_committed``'s
  world-mismatch text.
* ``HOROVOD_PROFILE=auto`` and ``HOROVOD_TUNED_CONFIG`` at ``hvd.init``,
  ``apply_committed``'s failed-verification text and ``tune_report()``
  against JAX's.

Exact equality throughout (the planners and the fit are the same float
arithmetic).
"""

import importlib
import json
import os

import pytest
import torch

LEVEL = {"nvlink": "ici", "ib": "dcn"}
TORCH_SCHEMA = "horovod_tpu_torch/tuned-config/v1"
JAX_SCHEMA = "horovod_tpu/tuned-config/v1"
# A configuration off every default, numerics-neutral where it can be.
TUNED = {"HOROVOD_ALLREDUCE_ALGO": "rs_ag",
         "HOROVOD_COMPRESSION": "bf16",
         "HOROVOD_EXCHANGE_SCHEDULE": "priority",
         "HOROVOD_FUSION_THRESHOLD": 1 << 12,
         "HOROVOD_MAX_CHANNELS": 2}


def _fake_measure(nbytes, channels):
    """The reference's deterministic stand-in for the live timer."""
    base = 20e-6 + nbytes / 5e9
    return base * (0.65 if channels == 2 else 1.0)


def _jax_constants(constants: dict) -> dict:
    return {LEVEL[k]: v for k, v in constants.items()}


def _as_jax_json(text: str) -> str:
    """A port TunedConfig's canonical JSON in the JAX package's layout."""
    d = json.loads(text)
    d["schema"] = JAX_SCHEMA
    d["constants"] = _jax_constants(d["constants"])
    return json.dumps(d, sort_keys=True, separators=(",", ":"))


@pytest.fixture
def clean_env(monkeypatch):
    import horovod_tpu as jhvd
    import horovod_tpu_torch as hvd
    from horovod_tpu.tune import apply as japply
    from horovod_tpu_torch.tune import apply as tapply

    for name in list(os.environ):
        if name.startswith("HOROVOD_"):
            monkeypatch.delenv(name)
    hvd.shutdown()
    jhvd.shutdown()
    japply.deactivate()
    tapply.deactivate()
    yield monkeypatch
    hvd.shutdown()
    jhvd.shutdown()
    japply.deactivate()
    tapply.deactivate()


def _configs(**extra):
    from horovod_tpu.tune import TunedConfig as JConfig
    from horovod_tpu_torch.tune import TunedConfig as TConfig

    consts = {"nvlink": {"alpha_us": 3.5, "gbps": 17.25, "ch_eff": 0.5},
              "ib": {"alpha_us": 40.0, "gbps": 9.125}}
    fields = dict(device_kind="cpu", world_size=4, num_slices=2,
                  knobs=dict(TUNED), exchange_artifact="pod.exchange.json",
                  exchange_plan_hash="0badf00d", **extra)
    return (JConfig(constants=_jax_constants(consts), **fields),
            TConfig(constants=consts, **fields))


# -- the artifact -------------------------------------------------------------

@pytest.mark.parametrize("extra", [
    {},
    {"compute_window_ms": 1.25,
     "predicted_exposed_ms": {"default": 0.5, "tuned": 0.25}},
    {"compute_window_ms": 3.0, "predicted_exposed_ms": {"default": 1.0,
                                                        "tuned": 0.75},
     "measured_lm_step_ms": {"default": 2.0, "tuned": 2.5}}])
def test_tuned_config_round_trips_like_jax(tmp_path, extra):
    from horovod_tpu_torch.tune import TunedConfig, load_tuned_config

    jc, tc = _configs(**extra)
    assert tc.to_json() != jc.to_json()
    assert _as_jax_json(tc.to_json()) == jc.to_json()
    assert json.loads(tc.to_json())["schema"] == TORCH_SCHEMA
    back = TunedConfig.from_json(tc.to_json())
    assert back == tc and back.config_hash() == tc.config_hash()
    path = tc.save(str(tmp_path / "pod.tuned.json"))
    assert load_tuned_config(path).config_hash() == tc.config_hash()


def _refusal(mod, text):
    try:
        mod.TunedConfig.from_json(text)
    except mod.TunedConfigError as e:
        return str(e)
    raise AssertionError("not refused")


@pytest.mark.parametrize("mutate", ["unreadable", "unknown_knob",
                                    "corrupt_field", "no_knobs"])
def test_tuned_config_refusals_match_jax(mutate):
    # ``hvd.tune`` is the function: the packages by their module names.
    jtune = importlib.import_module("horovod_tpu.tune")
    ttune = importlib.import_module("horovod_tpu_torch.tune")

    jc, tc = _configs()

    def mutated(text):
        if mutate == "unreadable":
            return '{"schema": '  # the same bytes to both
        d = json.loads(text)
        if mutate == "unknown_knob":
            d["knobs"]["HOROVOD_FUSION_THRESHHOLD"] = 1
        elif mutate == "corrupt_field":
            d["world_size"] = "four"
        else:
            del d["knobs"]
        return json.dumps(d)

    assert (_refusal(ttune, mutated(tc.to_json()))
            == _refusal(jtune, mutated(jc.to_json())))


def test_a_tpu_artifact_is_refused_not_misread():
    ttune = importlib.import_module("horovod_tpu_torch.tune")

    jc, _ = _configs()
    msg = _refusal(ttune, jc.to_json())
    assert msg == (f"TunedConfig schema mismatch: expected {TORCH_SCHEMA!r}, "
                   f"got {JAX_SCHEMA!r} — refusing to guess a stale layout.")


def test_exchange_path_for_matches_jax():
    from horovod_tpu.tune import artifact as ja
    from horovod_tpu_torch.tune import artifact as ta

    assert ta.exchange_path_for("/x/a.tuned.json") \
        == ja.exchange_path_for("/x/a.tuned.json") == "/x/a.exchange.json"
    with pytest.raises(ta.TunedConfigError) as t:
        ta.exchange_path_for("/x/a.json")
    with pytest.raises(ja.TunedConfigError) as j:
        ja.exchange_path_for("/x/a.json")
    assert str(t.value) == str(j.value)
    assert ta.TUNABLE_KNOBS == ja.TUNABLE_KNOBS


# -- the search and the pricing -------------------------------------------------

def _topologies(n, slices):
    from horovod_tpu.ops import topology as jtop
    from horovod_tpu_torch.ops import topology as ttop

    local = n // slices
    slice_of = tuple(i // local for i in range(n))
    return (jtop.Topology(n, slice_of, slices, local, "cpu",
                          *jtop.seed_links("cpu")),
            ttop.Topology(n, slice_of, slices, local, "cpu",
                          *ttop.seed_links("cpu")))


def _models():
    from horovod_tpu.ops import topology as jtop
    from horovod_tpu.utils import costs as jcosts
    from horovod_tpu_torch.ops import topology as ttop
    from horovod_tpu_torch.utils import costs as tcosts

    return (jcosts.CostModel(ici=jtop.Link(2.0, 0.75),
                             dcn=jtop.Link(30.0, 0.25), source="calibrated",
                             ici_ch_eff=0.6, dcn_ch_eff=0.8),
            tcosts.CostModel(nvlink=ttop.Link(2.0, 0.75),
                             ib=ttop.Link(30.0, 0.25), source="calibrated",
                             nvlink_ch_eff=0.6, ib_ch_eff=0.8))


def _search_modules():
    """Both packages' ``tune/search.py`` (the packages re-export a
    function ``search``, so by module name)."""
    return (importlib.import_module("horovod_tpu.tune.search"),
            importlib.import_module("horovod_tpu_torch.tune.search"))


SEARCH_SIZES = (1 << 18, 3000, 1 << 16, 77, 1 << 17, 5000)


def _search_leaves():
    import jax

    labels = [f"g{i}" for i in range(len(SEARCH_SIZES))]
    return ([jax.ShapeDtypeStruct((n,), "float32") for n in SEARCH_SIZES],
            [torch.empty(n, device="meta") for n in SEARCH_SIZES], labels)


@pytest.mark.parametrize("window", [None, 1e-3, 20e-3],
                         ids=["no_window", "1ms", "20ms"])
@pytest.mark.parametrize("world,slices", [(1, 1), (2, 1), (2, 2), (4, 1),
                                          (4, 2), (8, 1), (8, 2)])
def test_search_matches_jax(clean_env, world, slices, window):
    jsearch, tsearch = _search_modules()

    jt, tt = _topologies(world, slices)
    jm, tm = _models()
    jl, tl, labels = _search_leaves()
    j = jsearch.search(jl, jt, jm, labels=labels, compute_window_s=window)
    t = tsearch.search(tl, tt, tm, labels=labels, compute_window_s=window)
    assert t.knobs == j.knobs and t.default_knobs == j.default_knobs
    assert (t.predicted_default_ms, t.predicted_tuned_ms, t.candidates) \
        == (j.predicted_default_ms, j.predicted_tuned_ms, j.candidates)
    assert t.plan.to_json() == j.plan.to_json()
    assert t.plan.plan_hash() == j.plan.plan_hash()
    assert t.default_plan.plan_hash() == j.default_plan.plan_hash()


def _outcome(fn, *args, **kw):
    try:
        return ("ok", fn(*args, **kw))
    except Exception as e:  # noqa: BLE001 — the texts are compared
        return ("raises", type(e).__name__, str(e))


@pytest.mark.parametrize("args", [(0.0, 4), (0.5, 0), (0.7, 3), (1.0, 5),
                                  (0.9, 8, 0.5), (1.2, 2), (0.5, -1),
                                  (0.5, 2, 0.0)])
@pytest.mark.parametrize("fn", ["price_speculation", "shrink_speculate_k",
                                "speculation_knob"])
def test_speculation_pricing_matches_jax(fn, args):
    jsearch, tsearch = _search_modules()

    assert (_outcome(getattr(tsearch, fn), *args)
            == _outcome(getattr(jsearch, fn), *args))


@pytest.mark.parametrize("kw", [
    dict(param_bytes=1 << 24, fsdp_size=4),
    dict(param_bytes=1 << 24, fsdp_size=4, n_leaves=12,
         compute_window_s=2e-3),
    dict(param_bytes=1 << 20, fsdp_size=1),
    dict(param_bytes=-1, fsdp_size=2)])
def test_price_sharding_matches_jax(kw):
    jsearch, tsearch = _search_modules()

    jt, tt = _topologies(8, 2)
    jm, tm = _models()
    j = _outcome(jsearch.price_sharding, topo=jt, model=jm, **kw)
    t = _outcome(tsearch.price_sharding, topo=tt, model=tm, **kw)
    assert t == j


@pytest.mark.parametrize("kw", [
    dict(param_bytes=1 << 24, opt_state_bytes=1 << 25),
    dict(param_bytes=1 << 24, opt_state_bytes=1 << 25, hbm_bytes=1 << 25),
    dict(param_bytes=1 << 24, opt_state_bytes=1 << 25, hbm_bytes=1 << 22),
    dict(param_bytes=1 << 24, opt_state_bytes=1 << 25, fsdp_size=2,
         hbm_bytes=(1 << 24) + (1 << 23), n_leaves=4)])
@pytest.mark.parametrize("slices", [1, 2])
def test_sharding_knob_matches_jax(kw, slices):
    jsearch, tsearch = _search_modules()

    jt, tt = _topologies(8, slices)
    jm, tm = _models()
    assert (_outcome(tsearch.sharding_knob, topo=tt, model=tm, **kw)
            == _outcome(jsearch.sharding_knob, topo=jt, model=jm, **kw))


# -- calibration ---------------------------------------------------------------

def test_calibrate_world1_matches_jax(clean_env):
    import jax

    import horovod_tpu as jhvd
    import horovod_tpu_torch as hvd
    from horovod_tpu.tune import calibrate as jcal
    from horovod_tpu_torch.tune.calibrate import calibrate as tcal

    hvd.init(device="cpu")
    jhvd.init(devices=jax.devices()[:1])
    t = tcal(measure=_fake_measure, lm=False, budget_s=30.0)
    j = jcal(measure=_fake_measure, lm=False, budget_s=30.0)
    assert t.constants == j.constants == {}
    assert (t.samples, t.compute_window_s, t.leaves) \
        == (j.samples, j.compute_window_s, j.leaves) == (3, None, ())


def _jax_world2_calibrations(monkeypatch):
    import jax

    import horovod_tpu as jhvd
    from horovod_tpu.tune import calibrate as jcal

    jhvd.init(devices=jax.devices()[:2])
    out = {"one": jcal(measure=_fake_measure, lm=False, budget_s=30.0)}
    monkeypatch.setenv("HOROVOD_TOPOLOGY_SLICES", "2")
    out["two"] = jcal(measure=_fake_measure, lm=False, budget_s=30.0)
    monkeypatch.delenv("HOROVOD_TOPOLOGY_SLICES")
    return {k: (v.constants, v.samples) for k, v in out.items()}


# -- the 2-rank world --------------------------------------------------------------

def _port_world(tmpdir, world1_pair):
    r = int(os.environ["RANK"])
    os.environ["HOROVOD_TUNING_CACHE"] = os.path.join(tmpdir,
                                                      f"cache.{r}.json")
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.analysis import schedule as verify
    from horovod_tpu_torch.ops import exchange
    from horovod_tpu_torch.tune import TunedConfig
    from horovod_tpu_torch.tune import apply as tapply
    from horovod_tpu_torch.tune.calibrate import calibrate

    # Group 1 has the world's ranks under another index: restricted in a
    # program of group 0.
    hvd.init([[0, 1], [0, 1]], device="cpu")
    out = {"calibrate": {}}
    for key, slices in (("one", None), ("two", "2")):
        if slices:
            os.environ["HOROVOD_TOPOLOGY_SLICES"] = slices
        cal = calibrate(measure=_fake_measure, lm=False, budget_s=30.0)
        out["calibrate"][key] = (cal.constants, cal.samples)
        os.environ.pop("HOROVOD_TOPOLOGY_SLICES", None)

    path = os.path.join(tmpdir, f"rank{r}", "pod.tuned.json")
    config = hvd.tune(path=path, measure=_fake_measure, budget_s=30.0)
    with open(path) as f:
        findings = verify.verify_tuned_config(f.read(), path=path)
    out["tune"] = {"json": config.to_json(), "findings": findings,
                   "report": hvd.tune_report()}

    # A configuration off every default, then each exchange's plan.
    tapply.activate(TunedConfig(
        device_kind="cpu", world_size=2, num_slices=1, constants={},
        knobs=dict(TUNED), exchange_artifact="x.exchange.json",
        exchange_plan_hash="00000000"))
    grads = [torch.full((n,), float(r + 1)) for n in (1000, 3000, 500)]

    def plan_of(**kw):
        def step(*ts):
            got = hvd.allreduce_gradients(list(ts), **kw)
            return got[0] if isinstance(got, list) else got
        hvd.spmd(step)(*grads)
        p = exchange.last_plan()
        return {"mode": p.mode, "threshold": p.threshold_bytes,
                "algos": [b.algo for b in p.buckets],
                "wire": [None if b.wire_dtype is None else str(b.wire_dtype)
                         for b in p.buckets],
                "channels": [b.channels for b in p.buckets]}

    out["plans"] = {"group0": plan_of(), "group1": plan_of(group=1),
                    "family": plan_of(group=(1,))}

    model = torch.nn.Sequential(torch.nn.Linear(4, 4),
                                torch.nn.BatchNorm1d(4))
    trainer = hvd.Trainer(model, lambda m, b: m(b).pow(2).mean(),
                          hvd.DistributedOptimizer(torch.optim.SGD(
                              model.parameters(), lr=0.1)))
    trainer.train_step(torch.arange(8.0).reshape(2, 4) + r)
    plans = {"buffers": trainer._sync_buffers.plan,
             "grads": trainer.optimizer._allreduce.plan}
    out["trainer"] = {k: (p.mode, p.threshold_bytes,
                          [str(b.wire_dtype) for b in p.buckets],
                          [b.algo for b in p.buckets])
                      for k, p in plans.items()}
    # Explicit env beats tuned: set before the activation snapshot.
    tapply.deactivate()
    os.environ["HOROVOD_EXCHANGE_SCHEDULE"] = "enum"
    tapply.activate(TunedConfig(
        device_kind="cpu", world_size=2, num_slices=1, constants={},
        knobs=dict(TUNED), exchange_artifact="x.exchange.json",
        exchange_plan_hash="00000000"))
    out["env_beats_tuned"] = plan_of()
    del os.environ["HOROVOD_EXCHANGE_SCHEDULE"]
    tapply.deactivate()

    try:
        from horovod_tpu_torch.tune import apply_committed

        apply_committed(world1_pair)
        out["mismatch"] = None
    except hvd.HorovodError as e:
        out["mismatch"] = str(e)
    hvd.shutdown()
    return out


@pytest.fixture(scope="module")
def tmpdir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("tune"))


@pytest.fixture(scope="module")
def world1_pairs(tmpdir):
    """A pair committed at world 1 by each package (the mismatch drill)."""
    import jax

    import horovod_tpu as jhvd
    import horovod_tpu_torch as hvd
    from horovod_tpu.tune import apply as japply
    from horovod_tpu_torch.tune import apply as tapply

    saved = {k: os.environ.pop(k) for k in list(os.environ)
             if k.startswith("HOROVOD_")}
    try:
        hvd.shutdown()
        jhvd.shutdown()
        hvd.init(device="cpu")
        jhvd.init(devices=jax.devices()[:1])
        paths = {}
        for side, pkg in (("port", hvd), ("jax", jhvd)):
            os.makedirs(os.path.join(tmpdir, side), exist_ok=True)
            paths[side] = os.path.join(tmpdir, side, "one.tuned.json")
            pkg.tune(path=paths[side], measure=_fake_measure, apply=False)
    finally:
        hvd.shutdown()
        jhvd.shutdown()
        japply.deactivate()
        tapply.deactivate()
        os.environ.update(saved)
    return paths


@pytest.fixture(scope="module")
def port(tmpdir, world1_pairs):
    from horovod_tpu_torch.run import run

    return run(_port_world, 2, device="cpu", timeout=240,
               args=(tmpdir, world1_pairs["port"]))


def test_calibrate_world2_matches_jax(clean_env, port):
    want = _jax_world2_calibrations(clean_env)
    for r in range(2):
        got = port[r]["calibrate"]
        assert {k: (_jax_constants(c), n) for k, (c, n) in got.items()} \
            == want
    assert "dcn" in want["two"][0] and "ch_eff" in want["two"][0]["dcn"]


def test_tune_commits_the_jax_packages_plan(clean_env, port, tmp_path):
    import jax

    import horovod_tpu as jhvd

    jhvd.init(devices=jax.devices()[:2])
    path = str(tmp_path / "pod.tuned.json")
    j = jhvd.tune(path=path, measure=_fake_measure, budget_s=30.0)
    for r in range(2):
        got = port[r]["tune"]
        assert got["findings"] == []
        assert json.loads(got["json"])["exchange_plan_hash"] \
            == j.exchange_plan_hash
        assert _as_jax_json(got["json"]) == j.to_json()
        assert got["report"]["active"] is True
    assert port[0]["tune"]["json"] == port[1]["tune"]["json"]


def test_restricted_groups_keep_their_defaults(port):
    for r in range(2):
        plans = port[r]["plans"]
        tuned = plans["group0"]
        assert tuned["mode"] == "priority" and tuned["threshold"] == 1 << 12
        assert set(tuned["algos"]) == {"rs_ag"}
        assert set(tuned["wire"]) == {"torch.bfloat16"}
        for key in ("group1", "family"):
            assert plans[key]["mode"] == "enum"
            assert plans[key]["threshold"] == 64 << 20
            assert set(plans[key]["algos"]) == {"flat"}
            assert set(plans[key]["wire"]) == {None}
            assert set(plans[key]["channels"]) == {1}


def test_the_trainers_buffer_sync_keeps_its_defaults(port):
    for r in range(2):
        t = port[r]["trainer"]
        assert t["buffers"] == ("enum", 64 << 20, ["None"], ["flat"])
        mode, threshold, wire, algos = t["grads"]
        assert (mode, threshold) == ("priority", 1 << 12)
        assert set(wire) == {"torch.bfloat16"} and set(algos) == {"rs_ag"}


def test_env_beats_tuned_on_the_gradient_path(port):
    for r in range(2):
        plan = port[r]["env_beats_tuned"]
        assert plan["mode"] == "enum"
        assert set(plan["algos"]) == {"rs_ag"}
        assert set(plan["wire"]) == {"torch.bfloat16"}


def test_world_mismatch_refusal_matches_jax(clean_env, port, world1_pairs):
    import jax

    import horovod_tpu as jhvd
    from horovod_tpu.tune import apply_committed as japply_committed

    jhvd.init(devices=jax.devices()[:2])
    with pytest.raises(jhvd.HorovodError) as j:
        japply_committed(world1_pairs["jax"])
    got = port[0]["mismatch"]
    assert got == str(j.value).replace(world1_pairs["jax"],
                                       world1_pairs["port"])
    assert "was tuned for world 1, live world is 2" in got
    assert port[1]["mismatch"] == got


# -- hvd.init's hooks and the report --------------------------------------------

def _fast_live_timer(monkeypatch):
    """The live timer's collectives replaced by the fake's numbers (the
    tiny LM's profile still runs)."""
    cal = importlib.import_module("horovod_tpu_torch.tune.calibrate")
    monkeypatch.setattr(cal, "allreduce_seconds",
                        lambda nbytes, channels, **kw:
                        _fake_measure(nbytes, channels))


def test_profile_auto_tunes_at_init(clean_env, tmp_path):
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.analysis import schedule as verify

    _fast_live_timer(clean_env)
    path = str(tmp_path / "auto.tuned.json")
    clean_env.setenv("HOROVOD_PROFILE", "auto")
    clean_env.setenv("HOROVOD_TUNED_CONFIG", path)
    clean_env.setenv("HOROVOD_TUNING_CACHE", str(tmp_path / "cache.json"))
    hvd.init(device="cpu")
    report = hvd.tune_report()
    assert report["active"] and report["path"] == path
    with open(path) as f:
        text = f.read()
    assert verify.verify_tuned_config(text, path=path) == []
    config = json.loads(text)
    assert config["world_size"] == 1 and config["compute_window_ms"] > 0
    # Ties keep the defaults at one rank.
    assert config["predicted_exposed_ms"] == {"default": 0.0, "tuned": 0.0}
    assert config["knobs"]["HOROVOD_EXCHANGE_SCHEDULE"] == "enum"
    hvd.shutdown()
    assert hvd.tune_report()["active"] is False


def test_tuned_config_applies_at_init(clean_env, tmp_path):
    import horovod_tpu_torch as hvd

    path = str(tmp_path / "one.tuned.json")
    hvd.init(device="cpu")
    config = hvd.tune(path=path, measure=_fake_measure, apply=False)
    assert hvd.tune_report()["active"] is False
    hvd.shutdown()
    clean_env.setenv("HOROVOD_TUNED_CONFIG", path)
    hvd.init(device="cpu")
    report = hvd.tune_report()
    assert report["hash"] == config.config_hash()
    assert {v["source"] for v in report["knobs"].values()} \
        == {"tuned", "default"}


def _failed_verification(pkg_apply_committed, path):
    try:
        pkg_apply_committed(path)
    except Exception as e:  # noqa: BLE001 — the texts are compared
        return str(e)
    raise AssertionError("applied")


def test_failed_verification_refusal_matches_jax(clean_env, world1_pairs,
                                                 tmp_path):
    import jax

    import horovod_tpu as jhvd
    import horovod_tpu_torch as hvd
    from horovod_tpu.tune import apply_committed as japply_committed
    from horovod_tpu_torch.tune import apply_committed as tapply_committed

    hvd.init(device="cpu")
    jhvd.init(devices=jax.devices()[:1])
    texts = {}
    for side, fn in (("port", tapply_committed), ("jax", japply_committed)):
        src = world1_pairs[side]
        d = json.loads(open(src).read())
        d["exchange_plan_hash"] = "deadbeef"
        os.makedirs(tmp_path / side)
        dst = str(tmp_path / side / "one.tuned.json")
        with open(dst, "w") as f:
            json.dump(d, f)
        with open(src.replace(".tuned.json", ".exchange.json")) as f:
            ex = f.read()
        with open(dst.replace(".tuned.json", ".exchange.json"), "w") as f:
            f.write(ex)
        texts[side] = _failed_verification(fn, dst).replace(dst, "<path>")
    assert texts["port"] == texts["jax"]
    assert "failed verification — refusing to apply" in texts["port"]
    assert hvd.tune_report()["active"] is False


def test_tune_report_matches_jax(clean_env):
    from horovod_tpu.tune import apply as japply
    from horovod_tpu_torch.tune import apply as tapply

    clean_env.setenv("HOROVOD_COMPRESSION", "int8")
    jc, tc = _configs(predicted_exposed_ms={"default": 1.0, "tuned": 0.5})
    assert tapply.report() == japply.report()
    japply.activate(jc, path="pod.tuned.json")
    tapply.activate(tc, path="pod.tuned.json")
    t, j = tapply.report(), japply.report()
    assert t["hash"] == tc.config_hash() != j["hash"]
    t.pop("hash")
    j.pop("hash")
    assert t == j
    assert t["knobs"]["HOROVOD_COMPRESSION"] == {"value": "int8",
                                                 "source": "env"}
    assert t["knobs"]["HOROVOD_ALLREDUCE_ALGO"]["source"] == "tuned"


def test_other_sites_resolve_env_then_tuned(clean_env):
    """The sharding mode and fsdp axis (``ops/mesh.py``), the sparse
    density switch (``ops/sparse.py``) and the speculate knob
    (``serving/engine.py``) take a tuned value only where the env leaves
    the knob unset."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import transformer as tt
    from horovod_tpu_torch.ops import mesh, sparse
    from horovod_tpu_torch.tune import TunedConfig
    from horovod_tpu_torch.tune import apply as tapply

    def activate():
        tapply.activate(TunedConfig(
            device_kind="cpu", world_size=4, num_slices=1, constants={},
            knobs={"HOROVOD_SHARDING": "zero2", "HOROVOD_FSDP_AXIS_SIZE": 2,
                   "HOROVOD_SPARSE_DENSITY_THRESHOLD": 0.25,
                   "HOROVOD_SERVE_SPECULATE": 2},
            exchange_artifact="x.exchange.json",
            exchange_plan_hash="00000000"))

    _, topo = _topologies(4, 1)
    cfg = tt.TransformerConfig(vocab_size=17, num_layers=1, num_heads=2,
                               embed_dim=8, mlp_dim=16, max_seq_len=8,
                               dtype=torch.float32)
    model = tt.init_params(cfg, device="cpu")
    assert mesh.resolve_sharding(None) == "off"
    activate()
    assert mesh.resolve_sharding(None) == "zero2"
    assert mesh.layout(topo).fsdp_size == 2
    assert sparse._density_threshold() == 0.25
    assert hvd.serving.Engine(cfg, model, device="cpu").speculate_k == 2
    assert mesh.resolve_sharding("off") == "off"
    tapply.deactivate()
    for k, v in (("HOROVOD_SHARDING", "zero3"), ("HOROVOD_FSDP_AXIS_SIZE",
                                                 "4"),
                 ("HOROVOD_SPARSE_DENSITY_THRESHOLD", "0.5"),
                 ("HOROVOD_SERVE_SPECULATE", "0")):
        clean_env.setenv(k, v)
    activate()
    assert mesh.resolve_sharding(None) == "zero3"
    assert mesh.layout(topo).fsdp_size == 4
    assert sparse._density_threshold() == 0.5
    assert hvd.serving.Engine(cfg, model, device="cpu").speculate_k == 0
    assert {k: v["source"] for k, v in tapply.report()["knobs"].items()
            if v["source"] != "default"} == {
        "HOROVOD_SHARDING": "env", "HOROVOD_FSDP_AXIS_SIZE": "env",
        "HOROVOD_SPARSE_DENSITY_THRESHOLD": "env",
        "HOROVOD_SERVE_SPECULATE": "env"}


def test_autotune_reads_the_tuning_cache(clean_env, tmp_path):
    """``HOROVOD_AUTOTUNE=1``: the gradient path's fusion threshold is the
    tuning cache's when nothing pins it."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import exchange
    from horovod_tpu_torch.utils import costs

    cache = str(tmp_path / "cache.json")
    clean_env.setenv("HOROVOD_TUNING_CACHE", cache)
    costs.save_tuning_cache({}, device_kind="cpu", world=1,
                            fusion_threshold=1 << 13, path=cache)
    hvd.init(device="cpu")
    grads = [torch.ones(1000), torch.ones(3000)]
    hvd.allreduce_gradients([g.clone() for g in grads])
    assert exchange.last_plan().threshold_bytes == 64 << 20
    clean_env.setenv("HOROVOD_AUTOTUNE", "1")
    hvd.allreduce_gradients([g.clone() for g in grads])
    assert exchange.last_plan().threshold_bytes == 1 << 13
    clean_env.setenv("HOROVOD_FUSION_THRESHOLD", "4096")
    hvd.allreduce_gradients([g.clone() for g in grads])
    assert exchange.last_plan().threshold_bytes == 64 << 20  # init's value

"""Elastic training of the port (``core/elastic.py``, ``Trainer.fit``'s
elastic loop) against the JAX package's, on the CPU.

The JAX package runs its drill in one process over the 8-device pod of
``tests/conftest.py``; the port runs it in one spawned world of 8 gloo
ranks (module-scoped), where a process is a rank: the target of
``crash@rank=2`` exits 43, the survivors observe the loss at the same
boundary and shrink, and a new process takes rank 2's place at the
``regrow`` boundary (``elastic.rejoin``, started by ``run(rejoin=...)``).
The world runs the reference's four drill scenarios one after another —
without elastic, an uninterrupted reference fit, the full drill
(``crash@rank=2,step=2;regrow@step=5``), a shrink alone and the min-world
refusal — and each rank writes what it saw to a file (two ranks die on
the way). The same data (numpy, seed 0) and the same SGD feed both
packages; float32 results agree within ``RTOL``/``ATOL`` (the gradient
average sums in another order). The plan functions and the store
handshake are held against the JAX package's on the reference tests'
cases.
"""

from __future__ import annotations

import json
import os
import pathlib

import numpy as np
import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch.analysis import protocol as tproto
from horovod_tpu_torch.core import elastic as tel
from horovod_tpu_torch.core import resilience as tres
from horovod_tpu_torch.run import run
from horovod_tpu_torch.training import callbacks as tcb
from horovod_tpu_torch.training import loop as tloop

N = 8  # the JAX pod's devices (tests/conftest.py)
LR = 0.05
DRILL = "crash@rank=2,step=2;regrow@step=5"
RTOL, ATOL = 1e-5, 1e-6
LABEL = "DistributedOptimizer.grads.0"
ELASTIC_VARS = ("HOROVOD_ELASTIC", "HOROVOD_ELASTIC_MIN_WORLD",
                "HOROVOD_ELASTIC_JOIN_TIMEOUT", "HOROVOD_FAULT_INJECT")


# -- the port's world (children import this module: no JAX at top level) -----


class _Linear(torch.nn.Module):
    def __init__(self, w):
        super().__init__()
        self.w = torch.nn.Parameter(torch.tensor(w))


def _loss(model, batch):
    x, y = batch
    return torch.mean((x @ model.w - y) ** 2)


def _data():
    """The reference test's data: ``w0`` and a batch a rank."""
    rng = np.random.RandomState(0)
    w0 = rng.randn(4, 2).astype(np.float32)
    xs = rng.randn(N, 8, 4).astype(np.float32)
    ys = rng.randn(N, 8, 2).astype(np.float32)
    return w0, xs, ys


def _trainer():
    w0, xs, ys = _data()
    model = _Linear(w0)
    r = hvd.global_rank()
    batch = (torch.tensor(xs[r]), torch.tensor(ys[r]))
    return model, tloop.Trainer(model, _loss, tloop.sgd(LR)), batch


class _LossLog(tcb.Callback):
    """Appends ``[global step, loss]`` to a file at every batch end (a
    rank may die mid-fit)."""

    def __init__(self, path, steps_per_epoch):
        self.path = path
        self.spe = steps_per_epoch

    def on_batch_end(self, batch, logs=None):
        step = self.trainer.epoch * self.spe + batch
        with open(self.path, "a") as f:
            f.write(json.dumps([step, float(logs["loss"])]) + "\n")


def _env(**kw):
    for k in ELASTIC_VARS:
        os.environ.pop(k, None)
    os.environ.update(kw)
    tres.reset_injector()
    tel._reset_for_tests()


def _write(out, scenario, record):
    d = pathlib.Path(out) / scenario
    d.mkdir(exist_ok=True)
    (d / f"rank{hvd.global_rank()}.json").write_text(json.dumps(record))


def _fit_drill(out):
    model, tr, batch = _trainer()
    log = _LossLog(pathlib.Path(out) / f"drill_loss{hvd.global_rank()}",
                   4)
    hist = tr.fit([batch], epochs=2, steps_per_epoch=4, callbacks=[log],
                  verbose=False)
    ctl = tr._elastic
    if hvd.rank() == 0 and ctl.snapshots:
        ctl.save_artifacts(out)
    _write(out, "drill", {
        "history": hist["loss"], "w": model.w.tolist(), "size": hvd.size(),
        "tags": [t for t, _ in ctl.snapshots],
        "generations": ctl.generation_history, "dropped": list(ctl.dropped),
        "metrics": tel.last_metrics(),
        "plans": [p.to_json() for _, p in ctl.snapshots]})


def _after_drill(out):
    """The scenarios after the drill, in the world it left (group 0 = all 8
    ranks again, the joiner among them)."""
    # A shrink alone: the joiner (rank 2) exits, 7 ranks continue.
    _env(HOROVOD_ELASTIC="1", HOROVOD_FAULT_INJECT="crash@rank=2,step=2")
    model, tr, batch = _trainer()
    tr.fit([batch], epochs=1, steps_per_epoch=4, verbose=False)
    _write(out, "shrink", {"w": model.w.tolist(), "size": hvd.size()})
    # The min-world refusal at world 7: group rank 2 (global 3) exits.
    _env(HOROVOD_ELASTIC="1", HOROVOD_ELASTIC_MIN_WORLD=str(N),
         HOROVOD_FAULT_INJECT="crash@rank=2,step=1")
    model, tr, batch = _trainer()
    try:
        tr.fit([batch], epochs=1, steps_per_epoch=4, verbose=False)
        refusal = None
    except hvd.HorovodError as e:
        refusal = [type(e).__name__, str(e), type(e.__cause__).__name__]
    _write(out, "min_world", {"refusal": refusal})
    return True


def _member(out):
    hvd.init(device="cpu")
    # Without HOROVOD_ELASTIC a WorkerLost propagates and nothing shrinks.
    _env()
    model, tr, batch = _trainer()

    def boom(step, ranks, span=1, peers=()):
        raise tres.WorkerLost("peer lost", ranks=(2,))

    real, tres.maybe_crash = tres.maybe_crash, boom
    try:
        tr.fit([batch], epochs=1, steps_per_epoch=2, verbose=False)
        raised = None
    except tres.WorkerLost as e:
        raised = str(e)
    finally:
        tres.maybe_crash = real
    _write(out, "no_elastic", {"raised": raised, "size": hvd.size()})
    # The uninterrupted reference.
    model, tr, batch = _trainer()
    tr.fit([batch], epochs=1, steps_per_epoch=4, verbose=False)
    _write(out, "reference", {"w": model.w.tolist()})
    _env(HOROVOD_ELASTIC="1", HOROVOD_FAULT_INJECT=DRILL,
         HOROVOD_ELASTIC_JOIN_TIMEOUT="60")
    _fit_drill(out)
    return _after_drill(out)


def _joiner(out):
    _env(HOROVOD_ELASTIC="1", HOROVOD_FAULT_INJECT=DRILL,
         HOROVOD_ELASTIC_JOIN_TIMEOUT="60")
    plan = tel.rejoin(device="cpu")
    _write(out, "admission", {"members": list(plan.members),
                              "joined": list(plan.joined),
                              "coordinator": plan.coordinator,
                              "generation": plan.generation})
    _fit_drill(out)
    return _after_drill(out)


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    out = tmp_path_factory.mktemp("elastic")
    saved = {k: os.environ.pop(k) for k in ELASTIC_VARS if k in os.environ}
    try:
        results = run(_member, N, device="cpu", args=(str(out),),
                      timeout=240, crashes=(2, 3),
                      rejoin={2: (_joiner, (str(out),))})
    finally:
        os.environ.update(saved)
    assert results == [True, True, None, None, True, True, True, True]

    def read(scenario):
        return {int(p.stem[4:]): json.loads(p.read_text())
                for p in (out / scenario).glob("rank*.json")}

    losses = {}
    for r in range(N):
        for line in (out / f"drill_loss{r}").read_text().splitlines():
            step, loss = json.loads(line)
            losses.setdefault(step, {})[r] = loss
    return {s: read(s) for s in ("no_elastic", "reference", "drill",
                                 "admission", "shrink", "min_world")} | {
        "dir": out, "losses": losses}


# -- the JAX package's drill (the reference tests' _make_trainer) ------------


def _jax_trainer():
    import horovod_tpu as jhvd
    import jax.numpy as jnp
    from horovod_tpu.training import loop as jloop

    def loss_fn(p, b):
        x, y = b
        return jnp.mean((x @ p["w"] - y) ** 2)

    w0, xs, ys = _data()
    batch = (jhvd.rank_stack([xs[r] for r in range(N)]),
             jhvd.rank_stack([ys[r] for r in range(N)]))
    tr = jloop.Trainer(loss_fn, jloop.sgd(LR))
    tr.init_state({"w": w0})
    return tr, batch


@pytest.fixture
def jax_world(monkeypatch):
    import horovod_tpu as jhvd
    from horovod_tpu.core import elastic as jel
    from horovod_tpu.core import resilience as jres

    for k in ELASTIC_VARS:
        monkeypatch.delenv(k, raising=False)
    jhvd.shutdown()
    jhvd.init()
    jres.reset_injector()
    jel._reset_for_tests()
    assert jhvd.size() == N
    yield monkeypatch
    jhvd.shutdown()
    jres.reset_injector()
    jel._reset_for_tests()


def _jax_fit(monkeypatch, spec, epochs, **env):
    import horovod_tpu as jhvd
    from horovod_tpu.core import resilience as jres
    from horovod_tpu.core import state as jstate

    for k, v in env.items():
        monkeypatch.setenv(k, v)
    if spec:
        monkeypatch.setenv("HOROVOD_FAULT_INJECT", spec)
    jres.reset_injector()
    tr, batch = _jax_trainer()
    gen0 = jstate.generation()
    hist = tr.fit([batch], epochs=epochs, steps_per_epoch=4, verbose=False)
    return tr, hist, gen0, jhvd.size()


def _rows_equal(port_ranks, w):
    for rec in port_ranks.values():
        np.testing.assert_allclose(np.asarray(rec["w"], np.float32), w,
                                   rtol=RTOL, atol=ATOL)


def test_shrink_continue_regrow(port, jax_world):
    """``crash@rank=2,step=2;regrow@step=5``: the survivors shrink to 7 at
    step 2, rank 2 is readmitted at step 5, and the loss history and the
    final parameters equal the JAX drill's."""
    tr, hist, _, size = _jax_fit(jax_world, DRILL, 2,
                                 HOROVOD_ELASTIC="1")
    assert size == N
    drill = port["drill"]
    assert sorted(drill) == list(range(N))  # rank 2's record: the joiner's
    want = np.asarray(tr.params["w"])[0]
    _rows_equal(drill, want)
    # The JAX history: per call, the mean over the members; per epoch,
    # the mean over the calls. The port's from every rank's logged losses.
    members = {s: len(port["losses"][s]) for s in range(8)}
    assert members == {0: 8, 1: 8, 2: 7, 3: 7, 4: 7, 5: 8, 6: 8, 7: 8}
    per_step = [np.mean(list(port["losses"][s].values())) for s in range(8)]
    np.testing.assert_allclose([np.mean(per_step[:4]),
                                np.mean(per_step[4:])], hist["loss"],
                               rtol=RTOL, atol=ATOL)
    for r, rec in drill.items():
        assert rec["size"] == N
        if r != 2:  # the members' controllers ran both transitions
            assert rec["tags"] == ["pre_shrink", "post_shrink",
                                   "post_regrow"]
            assert rec["tags"] == [t for t, _ in tr._elastic.snapshots]
            assert rec["dropped"] == list(tr._elastic.dropped) == []
            assert len(rec["generations"]) == 2 == len(
                tr._elastic.generation_history)
            assert rec["metrics"]["elastic_shrink_recovery_ms"] is not None
            assert rec["metrics"]["elastic_regrow_admit_ms"] is not None
    assert port["admission"] == {2: {"members": list(range(N)),
                                     "joined": [2], "coordinator": 0,
                                     "generation": 3}}


def test_exchange_artifacts_equal_jax(port, jax_world):
    """The pre-shrink, post-shrink and post-regrow ``.exchange.json`` files
    equal the JAX package's bytes for the same plan and provenance, and
    each snapshot equals the JAX drill's (its label ``w`` the port's
    ``<name>.<i>``; its generations counted from the drill's start, which
    is 1 in the port's fresh world)."""
    import jax

    from horovod_tpu.ops import exchange as jex

    tr, _, gen0, _ = _jax_fit(jax_world, DRILL, 2, HOROVOD_ELASTIC="1")
    jsnaps = dict(tr._elastic.snapshots)
    plans = port["drill"][0]["plans"]
    assert len(plans) == 3
    for tag, raw in zip(("pre_shrink", "post_shrink", "post_regrow"),
                        plans):
        meta = json.loads(raw)["elastic"]
        path = port["dir"] / f"{tag}.exchange.json"
        mine = path.read_bytes()
        want = jex.plan_exchange(
            [jax.ShapeDtypeStruct((4, 2), "float32")], 64 * 1024 * 1024,
            mode="enum", algo="flat", labels=[LABEL],
            world_size=len(meta["survivors"])).with_elastic(
                meta["survivors"], meta["dropped"], meta["generation"])
        jpath = port["dir"] / f"jax_{tag}.exchange.json"
        want.save(str(jpath))
        assert mine == jpath.read_bytes()
        jmeta = json.loads(jsnaps[tag].to_json())["elastic"]
        jmeta["generation"] += 1 - gen0  # the port's world starts at 1
        assert meta == jmeta
        shifted = jsnaps[tag].with_elastic(
            jmeta["survivors"], jmeta["dropped"], jmeta["generation"])
        assert raw == shifted.to_json().replace('"w"', f'"{LABEL}"')


def test_shrink_changes_trajectory(port, jax_world):
    """A shrink alone leaves 7 ranks whose parameters leave the
    uninterrupted run's, and equal the JAX package's shrunk run."""
    tr_ref, _, _, _ = _jax_fit(jax_world, None, 1)
    ref = np.asarray(tr_ref.params["w"])[0]
    _rows_equal(port["reference"], ref)
    tr, _, _, size = _jax_fit(jax_world, "crash@rank=2,step=2", 1,
                              HOROVOD_ELASTIC="1")
    assert size == N - 1
    got = np.asarray(tr.params["w"])[0]
    assert not np.array_equal(got, ref)
    shrunk = port["shrink"]
    assert sorted(shrunk) == [0, 1, 3, 4, 5, 6, 7]
    assert {rec["size"] for rec in shrunk.values()} == {N - 1}
    _rows_equal(shrunk, got)


def test_min_world_refusal_propagates(port, jax_world):
    """Below ``HOROVOD_ELASTIC_MIN_WORLD`` the shrink is refused with the
    reference's text, chained to the loss."""
    import horovod_tpu as jhvd

    with pytest.raises(jhvd.HorovodError,
                       match="HOROVOD_ELASTIC_MIN_WORLD") as info:
        _jax_fit(jax_world, "crash@rank=2,step=1", 1, HOROVOD_ELASTIC="1",
                 HOROVOD_ELASTIC_MIN_WORLD=str(N))
    want = str(info.value).replace("7 survivor(s)", "6 survivor(s)")
    refused = port["min_world"]
    assert sorted(refused) == [0, 1, 4, 5, 6, 7]  # global 3 was rank 2
    for rec in refused.values():
        assert rec["refusal"] == ["HorovodError", want, "WorkerLost"]


def test_without_elastic_worker_lost_propagates(port, jax_world):
    """Without HOROVOD_ELASTIC the loop re-raises a WorkerLost and never
    shrinks, as the JAX package's does."""
    from horovod_tpu.core import resilience as jres

    tr, batch = _jax_trainer()

    def boom(step, ranks, span=1):
        raise jres.WorkerLost("peer lost", ranks=(2,))

    jax_world.setattr(jres, "maybe_crash", boom)
    with pytest.raises(jres.WorkerLost, match="peer lost"):
        tr.fit([batch], epochs=1, steps_per_epoch=2, verbose=False)
    assert port["no_elastic"] == {r: {"raised": "peer lost", "size": N}
                                  for r in range(N)}


# -- the plans, the handshake and the refusals (no world) --------------------


@pytest.mark.parametrize("members,dead,gen", [
    ((0, 1, 2, 3), (2,), 5), ((0, 1, 2, 3), (0,), 0),
    ((0, 1, 2, 3), (0, 3), 7), ((4, 2, 9), (2,), 1), ((0, 1), (), 3)])
def test_plan_shrink_matches_jax(members, dead, gen):
    from horovod_tpu.analysis import protocol as jproto

    j = jproto.plan_shrink(members, dead, gen)
    t = tproto.plan_shrink(members, dead, gen)
    assert (t.survivors, t.coordinator, t.generation) == \
        (j.survivors, j.coordinator, j.generation)


@pytest.mark.parametrize("members,joiners,gen", [
    ((0, 1, 3), (2,), 6), ((1, 3), (0, 2), 1), ((5,), (9, 7), 0)])
def test_plan_regrow_matches_jax(members, joiners, gen):
    from horovod_tpu.analysis import protocol as jproto

    j = jproto.plan_regrow(members, joiners, gen)
    t = tproto.plan_regrow(members, joiners, gen)
    assert (t.members, t.joined, t.coordinator, t.generation) == \
        (j.members, j.joined, j.coordinator, j.generation)


@pytest.mark.parametrize("fn,args", [
    ("plan_shrink", ((0, 1), (0, 1), 0)),
    ("plan_regrow", ((0, 1), (), 0)),
    ("plan_regrow", ((0, 1, 2), (2, 3), 0))])
def test_plan_refusals_match_jax(fn, args):
    from horovod_tpu.analysis import protocol as jproto

    with pytest.raises(ValueError) as j:
        getattr(jproto, fn)(*args)
    with pytest.raises(ValueError) as t:
        getattr(tproto, fn)(*args)
    assert str(t.value) == str(j.value)


@pytest.mark.parametrize("spec,step,span,want", [
    ("regrow@step=5", 5, 1, True), ("regrow@step=5", 4, 2, True),
    ("regrow@step=5", 6, 1, False), ("regrow@rank=2,step=3", 0, 4, True),
    ("crash@rank=2,step=5;regrow@step=9", 9, 1, True)])
def test_regrow_matcher_matches_jax(spec, step, span, want):
    from horovod_tpu.analysis import protocol as jproto

    j = jproto.regrow_fault_matching(jproto.parse_fault_spec(spec), step,
                                     span)
    t = tproto.regrow_fault_matching(tproto.parse_fault_spec(spec), step,
                                     span)
    assert (t is not None) == (j is not None) == want
    if t is not None:
        assert t.describe() == j.describe()


def test_regrow_fires_once_like_jax(monkeypatch):
    from horovod_tpu.core import resilience as jres

    monkeypatch.setenv("HOROVOD_FAULT_INJECT", "regrow@step=4")
    jres.reset_injector()
    tres.reset_injector()
    seen = [(jres.injector().regrow_due(s) is not None,
             tres.injector().regrow_due(s) is not None)
            for s in (3, 4, 4, 5)]
    assert seen == [(False, False), (True, True), (False, False),
                    (False, False)]
    jres.reset_injector()
    tres.reset_injector()


class _FakeStore:
    """A dict behind the torch store calls the handshake makes."""

    def __init__(self):
        self.d = {}

    def set(self, key, value):
        self.d[key] = value.encode() if isinstance(value, str) else value

    def get(self, key):
        return self.d[key]

    def check(self, keys):
        return all(k in self.d for k in keys)

    def delete_key(self, key):
        return self.d.pop(key, None) is not None


class _JaxClientOf:
    """The JAX client's calls over the same dict, so the two packages'
    handshakes can read each other's keys."""

    def __init__(self, store):
        self.s = store

    def key_value_set(self, key, value, allow_overwrite=False):
        self.s.set(key, value)

    def blocking_key_value_get(self, key, timeout_ms):
        if key not in self.s.d:
            raise RuntimeError(f"DEADLINE_EXCEEDED: GetKeyValue() timed "
                               f"out with key: {key}")
        return self.s.d[key].decode()


def test_handshake_keys_and_payloads_match_jax():
    """announce/pending/publish/await and agree_step write the JAX
    package's keys and payloads: each side reads what the other wrote."""
    from horovod_tpu.analysis import protocol as jproto
    from horovod_tpu.core import elastic as jel

    store = _FakeStore()
    jkv = _JaxClientOf(store)
    tel.announce_join(store, 0, 2)
    assert jel.pending_joiners(jkv, 0, [1, 2, 3]) == (2,)
    assert tel.pending_joiners(store, 0, [1, 2, 3]) == (2,)
    plan = tproto.plan_regrow((0, 1, 3), (2,), 4)
    store.d.clear()
    jel.publish_admission(jkv, jproto.plan_regrow((0, 1, 3), (2,), 4))
    jkeys = dict(store.d)
    store.d.clear()
    tel.publish_admission(store, plan)
    assert store.d == jkeys
    got = tel.await_admission(store, 0, 2, timeout_s=1)
    assert got == plan
    assert jel.await_admission(jkv, 0, 2, timeout_s=1).members == \
        plan.members
    jel.agree_step(jkv, 5, 0, [0], 7)
    assert tel.agree_step(store, 5, 1, [0, 1], 9) == 7
    for key in store.d:
        assert tproto.key_generation(key) == jproto.key_generation(key)


def test_await_admission_times_out_with_the_reference_text():
    from horovod_tpu.core import elastic as jel

    store = _FakeStore()
    with pytest.raises(hvd.HorovodError) as t:
        tel.await_admission(store, 0, 5, timeout_s=0.05)
    with pytest.raises(Exception) as j:
        jel.await_admission(_JaxClientOf(store), 0, 5, timeout_s=0.05)
    assert str(t.value) == str(j.value)


def test_the_refusal_texts_match_jax(monkeypatch):
    """The controller's refusal of a loss outside the group and
    reconfigure's refusals are the reference's."""
    import horovod_tpu as jhvd
    from horovod_tpu.core import elastic as jel
    from horovod_tpu.core import state as jstate

    from horovod_tpu_torch.core import state as tstate

    for k in ELASTIC_VARS:
        monkeypatch.delenv(k, raising=False)
    jhvd.shutdown()
    jhvd.init()
    hvd.shutdown()
    hvd.init(device="cpu")
    try:
        texts = []
        for ctl, err in ((jel.ElasticController(0), jhvd.HorovodError),
                         (tel.ElasticController(0), hvd.HorovodError)):
            with pytest.raises(err) as a:
                ctl.plan_shrink((99,))
            texts.append(str(a.value).replace(
                f"({list(ctl.members())})", "(M)"))
        assert texts[0] == texts[1]
        for bad in ([], [0, 0], [5]):
            with pytest.raises(jhvd.HorovodError) as j:
                jstate.reconfigure(bad if bad != [5] else [N])
            with pytest.raises(hvd.HorovodError) as t:
                tstate.reconfigure(bad if bad != [5] else [1])
            assert str(t.value) == str(j.value).replace(
                f"Rank {N} out of range for world size {N}",
                "Rank 1 out of range for world size 1")
    finally:
        jhvd.shutdown()
        hvd.shutdown()


def test_a_world_of_one_refuses_with_the_min_world_text(monkeypatch):
    """At world 1 no rank survives a loss: the controller refuses with the
    min-world text (the reference's ``plan_shrink`` would raise its
    no-survivor ValueError first: ROADMAP §C), chained to the loss."""
    for k in ELASTIC_VARS:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("HOROVOD_ELASTIC", "1")
    tres.reset_injector()
    hvd.shutdown()
    hvd.init(device="cpu")
    try:
        model, tr, batch = _trainer()

        def lost(step, ranks, span=1, peers=()):
            if step == 1:
                raise tres.WorkerLost("peer lost", ranks=(0,))

        monkeypatch.setattr(tres, "maybe_crash", lost)
        with pytest.raises(hvd.HorovodError) as info:
            tr.fit([batch], epochs=1, steps_per_epoch=2, verbose=False)
        assert str(info.value) == (
            "Elastic shrink refused: 0 survivor(s) would fall below "
            "HOROVOD_ELASTIC_MIN_WORLD=1. Restart the failed host(s) and "
            "resume from the last complete checkpoint "
            "(Trainer.fit(resume=...)).")
        assert isinstance(info.value.__cause__, tres.WorkerLost)
        assert hvd.size() == 1
    finally:
        hvd.shutdown()


@pytest.mark.parametrize("make", ["sgd_momentum", "adam"])
def test_a_joiner_adopts_the_optimizer_states_layout(make):
    """A joiner allocates the members' optimizer state (its tensors'
    positions, keys, dtypes and shapes, and its other entries) before the
    state broadcast, which needs the same tensors on every rank."""
    def build():
        model = _Linear(np.ones((4, 2), np.float32))
        make_opt = (tloop.sgd(LR, momentum=0.9) if make == "sgd_momentum"
                    else tloop.adam(LR))
        return model, make_opt(model.parameters())

    model, member = build()
    model.w.grad = torch.ones(4, 2)
    member.step()
    layout = json.loads(json.dumps(tloop._optimizer_layout(member)))
    assert layout
    _, joiner = build()
    tloop._adopt_layout(joiner, layout)
    params = [p for g in member.param_groups for p in g["params"]]
    jparams = [p for g in joiner.param_groups for p in g["params"]]
    for p, q in zip(params, jparams):
        a, b = member.state[p], joiner.state[q]
        assert sorted(a) == sorted(b)
        for k in a:
            if isinstance(a[k], torch.Tensor):
                assert (a[k].dtype, a[k].shape, a[k].device) == \
                    (b[k].dtype, b[k].shape, b[k].device)
            else:
                assert a[k] == b[k]

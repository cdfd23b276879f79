"""Port parity: group families on the dense gradient path
(``allreduce_gradients(group=(g1, g2, ...))`` and
``DistributedOptimizer(group=...)``), against ``horovod_tpu``'s.

One spawned 4-rank gloo world (module-scoped), ``hvd.init([[0, 1], [2,
3]])``: groups 1 and 2 are two 2-rank groups, so the family ``(1, 2)``
covers the world and ``(1,)`` leaves ranks 2 and 3 in none of its groups.
The JAX side runs the same per-rank numpy inputs over 4 CPU devices
(``jhvd.init([[0, 1], [2, 3]], devices=jax.devices()[:4])``) inside
``hvd.spmd``. Gradients are integer-valued float32, so a family's
two-term sum and its halving are exact in either order:

* ``allreduce_gradients(group=family)`` equals JAX's bit for bit, under
  fusion thresholds that give one bucket and several, and a rank outside
  the family gets its gradients back unchanged;
* 3 steps of ``DistributedOptimizer(SGD(0.5), group=family)`` equal
  JAX's ``DistributedOptimizer(optax.sgd(0.5), group=family)``;
* the live exchange plan (``exchange.last_plan()``) equals JAX's, JSON and
  hash, for both entry points;
* every rank of the program registers each bucket under the family tuple;
* every refusal is the reference's text: channels > 1, error feedback,
  compression, a phased algorithm, a sparse item, the sharded optimizers,
  and a family outside a program (the family allreduce's text).

The spawned children import this module, so JAX is imported only inside
the parent-side functions.
"""

import numpy as np
import pytest
import torch

WORLD = 4
GROUPS = [[0, 1], [2, 3]]
FAMILIES = {"cover": (1, 2), "partial": (1,)}
SHAPES = ((7, 3), (16,), (5,), (4, 4))
THRESHOLDS = (None, 64)     # the default (one bucket) and several buckets
OPT_STEPS = 3
LR = 0.5


def _names(prefix):
    return [f"{prefix}.{i}" for i in range(len(SHAPES))]


def _grads(seed):
    """Per tensor, the (WORLD, *shape) integer-valued gradients."""
    rng = np.random.RandomState(seed)
    return [rng.randint(-9, 10, (WORLD,) + s).astype(np.float32)
            for s in SHAPES]


def _params0():
    rng = np.random.RandomState(3)
    return [(rng.randint(-8, 9, s) / 2).astype(np.float32) for s in SHAPES]


def _step_grads():
    return [_grads(10 + i) for i in range(OPT_STEPS)]


# -- the port's world ---------------------------------------------------------


def _message(fn):
    import horovod_tpu_torch as hvd

    try:
        fn()
    except (hvd.HorovodError, ValueError) as e:
        return f"{type(e).__name__}: {e}"
    return None


def _gradients(hvd, r):
    from horovod_tpu_torch.ops import exchange

    out = {}
    for fam_name, fam in FAMILIES.items():
        for thr in THRESHOLDS:
            gs = [torch.from_numpy(g[r].copy()) for g in _grads(1)]
            prog = hvd.spmd(lambda *gs: hvd.allreduce_gradients(
                list(gs), group=fam, fusion_threshold=thr))
            vals = [t.numpy() for t in prog(*gs)]
            plan = exchange.last_plan()
            sched = next(iter(prog.programs.values())).schedule
            out[(fam_name, thr)] = {
                "values": vals, "json": plan.to_json(),
                "hash": plan.plan_hash(),
                "groups": [row[4] for row in sched],
                "ops": [row[1] for row in sched]}
    return out


def _optimizer(hvd, r):
    from horovod_tpu_torch.ops import exchange

    out = {}
    for fam_name, fam in FAMILIES.items():
        params = [torch.nn.Parameter(torch.from_numpy(p.copy()))
                  for p in _params0()]
        opt = hvd.DistributedOptimizer(torch.optim.SGD(params, lr=LR),
                                       group=fam)

        def step(*gs):
            for p, g in zip(params, gs):
                p.grad = g.clone()
            opt.step()
            return [p.detach().clone() for p in params]

        prog = hvd.spmd(step)
        for grads in _step_grads():
            res = prog(*[torch.from_numpy(g[r].copy()) for g in grads])
        plan = exchange.last_plan()
        out[fam_name] = {"params": [t.numpy() for t in res],
                         "json": plan.to_json(), "hash": plan.plan_hash()}
    return out


def _refusals(hvd):
    from horovod_tpu_torch.ops import collectives as coll
    from horovod_tpu_torch.ops import sparse
    from horovod_tpu_torch.training import loop

    x = [torch.ones(8), torch.ones(3)]

    def prog(fn):
        return lambda: hvd.spmd(fn)(*[t.clone() for t in x])

    def compressed(*gs):
        # The bucket's auto name counts from 0, as on the JAX side.
        coll.reset_auto_names()
        return hvd.allreduce_gradients(list(gs), group=(1, 2),
                                       compression="bf16")

    def sharded(**kw):
        def run():
            p = torch.nn.Parameter(torch.ones(8))
            opt = hvd.DistributedOptimizer(loop.SGD([p], 0.1), group=(1, 2),
                                           **kw)
            p.grad = torch.ones(8)
            hvd.spmd(lambda g: opt.step())(torch.ones(8))
        return run

    slices = sparse.IndexedSlices(torch.ones(2, 3),
                                  torch.tensor([0, 1], dtype=torch.int32),
                                  (4, 3))
    return {
        "channels": _message(prog(lambda *gs: hvd.allreduce_gradients(
            list(gs), group=(1, 2), channels=2))),
        "error_residual": _message(prog(lambda *gs: hvd.allreduce_gradients(
            list(gs), group=(1, 2),
            error_residual=[torch.zeros_like(g) for g in gs]))),
        "compression": _message(prog(compressed)),
        "algo": _message(prog(lambda *gs: hvd.allreduce_gradients(
            list(gs), group=(1, 2), algo="rs_ag"))),
        "sparse": _message(prog(lambda *gs: hvd.allreduce_gradients(
            list(gs) + [slices], group=(1, 2)))),
        "zero1": _message(sharded(sharded=True)),
        "zero2": _message(sharded(sharding="zero2")),
        "eager": _message(lambda: hvd.allreduce_gradients(
            [t.clone() for t in x], group=(1, 2))),
    }


def _port_world():
    import horovod_tpu_torch as hvd

    hvd.init(GROUPS, device="cpu")
    r = hvd.rank()
    return {"gradients": _gradients(hvd, r), "optimizer": _optimizer(hvd, r),
            "errors": _refusals(hvd)}


@pytest.fixture(scope="module")
def port():
    from horovod_tpu_torch.run import run

    return run(_port_world, WORLD, device="cpu", timeout=300)


# -- the JAX side -------------------------------------------------------------


@pytest.fixture(scope="module")
def jhvd():
    import jax

    import horovod_tpu as jhvd

    jhvd.shutdown()
    jhvd.init(GROUPS, devices=jax.devices()[:WORLD])
    yield jhvd
    jhvd.shutdown()


def _jax_message(fn):
    from horovod_tpu.core.state import HorovodError

    try:
        fn()
    except (HorovodError, ValueError) as e:
        return f"{type(e).__name__}: {e}"
    return None


@pytest.fixture(scope="module")
def jax_gradients(jhvd):
    from horovod_tpu.ops import exchange as jex

    names = _names("allreduce_gradients")
    out = {}
    for fam_name, fam in FAMILIES.items():
        for thr in THRESHOLDS:
            grads = dict(zip(names, _grads(1)))
            red = jhvd.spmd(lambda g: jhvd.allreduce_gradients(
                g, group=fam, fusion_threshold=thr))(grads)
            plan = jex.last_plan()
            out[(fam_name, thr)] = {
                "values": [np.asarray(red[n]) for n in names],
                "json": plan.to_json(), "hash": plan.plan_hash()}
    return out


@pytest.fixture(scope="module")
def jax_optimizer(jhvd):
    import optax

    from horovod_tpu.ops import exchange as jex

    names = _names("DistributedOptimizer.grads")
    out = {}
    for fam_name, fam in FAMILIES.items():
        opt = jhvd.DistributedOptimizer(optax.sgd(LR), group=fam)
        p0 = dict(zip(names, _params0()))

        @jhvd.spmd
        def step(p, s, g):
            upd, s = opt.update(g, s, p)
            return optax.apply_updates(p, upd), s

        params = jhvd.replicate(p0)
        state = jhvd.replicate(opt.init(p0))
        for grads in _step_grads():
            params, state = step(params, state, dict(zip(names, grads)))
        plan = jex.last_plan()
        out[fam_name] = {"params": [np.asarray(params[n]) for n in names],
                         "json": plan.to_json(), "hash": plan.plan_hash()}
    return out


@pytest.fixture(scope="module")
def jax_refusals(jhvd):
    import jax.numpy as jnp
    import optax

    from horovod_tpu.ops import collectives as jcoll
    from horovod_tpu.ops import sparse as jsparse

    x = {"a": np.ones((WORLD, 8), np.float32),
         "b": np.ones((WORLD, 3), np.float32)}

    def prog(fn):
        return lambda: jhvd.spmd(fn)(x)

    def compressed(g):
        jcoll.reset_auto_names()
        return jhvd.allreduce_gradients(g, group=(1, 2), compression="bf16")

    def sharded(**kw):
        # The sharded inits cannot size a family's shards: the update is
        # given a stand-in state and refuses first.
        def run():
            opt = jhvd.DistributedOptimizer(optax.sgd(0.1), group=(1, 2),
                                            **kw)
            g = {"w": np.ones((WORLD, 8), np.float32)}
            jhvd.spmd(lambda g, s: opt.update(g, s, g))(
                g, {"w": np.zeros((WORLD, 2), np.float32)})
        return run

    def sparse_item(g):
        g = dict(g)
        g["c"] = jsparse.IndexedSlices(values=jnp.ones((2, 3)),
                                       indices=jnp.array([0, 1]),
                                       dense_shape=(4, 3))
        return jhvd.allreduce_gradients(g, group=(1, 2))

    return {
        "channels": _jax_message(prog(lambda g: jhvd.allreduce_gradients(
            g, group=(1, 2), channels=2))),
        "error_residual": _jax_message(prog(
            lambda g: jhvd.allreduce_gradients(
                g, group=(1, 2),
                error_residual={k: jnp.zeros_like(v)
                                for k, v in g.items()}))),
        "compression": _jax_message(prog(compressed)),
        "algo": _jax_message(prog(lambda g: jhvd.allreduce_gradients(
            g, group=(1, 2), algo="rs_ag"))),
        "sparse": _jax_message(prog(sparse_item)),
        "zero1": _jax_message(sharded(sharded=True)),
        "zero2": _jax_message(sharded(sharding="zero2")),
        # Outside a program the port's family refusal is the family
        # allreduce's, where the reference's allreduce_gradients refuses
        # every eager call.
        "eager": _jax_message(lambda: jhvd.allreduce(
            np.ones((WORLD, 8), np.float32), group=(1, 2))),
    }


# -- the tests ------------------------------------------------------------------


def _cases():
    return [(f, t) for f in FAMILIES for t in THRESHOLDS]


@pytest.mark.parametrize("family,threshold", _cases(),
                         ids=lambda v: str(v))
def test_allreduce_gradients_family_matches_jax(port, jax_gradients, family,
                                                threshold):
    want = jax_gradients[(family, threshold)]["values"]
    for r, rank_out in enumerate(port):
        got = rank_out["gradients"][(family, threshold)]["values"]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w[r])


@pytest.mark.parametrize("threshold", THRESHOLDS, ids=str)
def test_a_rank_outside_the_family_keeps_its_gradients(port, threshold):
    grads = _grads(1)
    for r in (2, 3):
        got = port[r]["gradients"][("partial", threshold)]["values"]
        for g, w in zip(got, grads):
            np.testing.assert_array_equal(g, w[r])
    for r in (0, 1):
        got = port[r]["gradients"][("partial", threshold)]["values"]
        for g, w in zip(got, grads):
            np.testing.assert_array_equal(g, (w[0] + w[1]) / 2)


@pytest.mark.parametrize("family,threshold", _cases(),
                         ids=lambda v: str(v))
def test_the_live_plan_is_the_references(port, jax_gradients, family,
                                         threshold):
    want = jax_gradients[(family, threshold)]
    for rank_out in port:
        got = rank_out["gradients"][(family, threshold)]
        assert got["json"] == want["json"]
        assert got["hash"] == want["hash"]


@pytest.mark.parametrize("family,threshold", _cases(),
                         ids=lambda v: str(v))
def test_every_rank_registers_the_family_tuple(port, family, threshold):
    """Each bucket registers once, as an ALLREDUCE of the family, on every
    rank of the program, one outside the family included."""
    for rank_out in port:
        got = rank_out["gradients"][(family, threshold)]
        assert got["ops"] and set(got["ops"]) == {"ALLREDUCE"}
        assert got["groups"] == [list(FAMILIES[family])] * len(got["ops"])
    # Several buckets under the small threshold, one under the default.
    n = len(port[0]["gradients"][(family, threshold)]["ops"])
    assert (n == 1) == (threshold is None)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_distributed_optimizer_family_matches_jax(port, jax_optimizer,
                                                  family):
    want = jax_optimizer[family]
    for r, rank_out in enumerate(port):
        got = rank_out["optimizer"][family]
        for g, w in zip(got["params"], want["params"]):
            np.testing.assert_array_equal(g, w[r])
        assert got["json"] == want["json"]
        assert got["hash"] == want["hash"]


REFUSALS = ("channels", "error_residual", "compression", "algo", "sparse",
            "zero1", "zero2", "eager")


@pytest.mark.parametrize("case", REFUSALS)
def test_refusals_are_the_references_text(port, jax_refusals, case):
    want = jax_refusals[case]
    assert want is not None
    for rank_out in port:
        assert rank_out["errors"][case] == want

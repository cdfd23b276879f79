"""Port parity: pipeline parallelism (``parallel/pipeline.py``: the GPipe
and 1F1B schedules over the ring hop, ``stage_split``) against
``horovod_tpu``'s.

One spawned 4-rank gloo world (module-scoped), ``hvd.init([[0, 1, 2]])``:
group 0 is a 4-stage pipeline and group 1 a 3-stage one whose non-member
is rank 3. The stage is the JAX tests' ``tanh(x @ w + b)`` (width 6,
microbatches of 3, M = 5), its weights made from a seed with numpy. The
JAX side runs the same arrays over 4 CPU devices under ``hvd.spmd``:

* ``gpipe`` (with and without ``remat``) — outputs and each stage's
  gradients (the loss masked to the last stage), at the JAX package's own
  tolerances (``tests/test_pipeline_parallel.py``: 1e-5 outputs, 1e-4
  gradients), and against the stages run one after another in torch;
* ``pipeline_1f1b`` — loss (1e-5) and gradients (1e-4) against JAX's 1F1B
  and against the port's own ``gpipe`` plus autograd;
* the subset group: members as above, the non-member zeros;
* the refusal texts (the stage count, eager calls) byte for byte,
  ``stage_split`` returning this rank's stage, and (at one rank, in this
  process) an ``nn.Module`` stage applied by ``functional_call``.

The spawned children import this module, so JAX is imported only inside
the parent-side functions.
"""

import numpy as np
import pytest
import torch

WORLD = 4
GROUPS = [[0, 1, 2]]
E, MB, M = 6, 3, 5
OUT_TOL, GRAD_TOL = 1e-5, 1e-4
LOSS_RTOL, LOSS_ATOL = 1e-5, 1e-6


def _stages(n, seed):
    rng = np.random.RandomState(seed)
    return [{"w": rng.randn(E, E).astype(np.float32) * 0.6,
             "b": rng.randn(E).astype(np.float32) * 0.1} for _ in range(n)]


def _data(seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(M, MB, E).astype(np.float32),
            rng.randn(M, MB, E).astype(np.float32),
            rng.randn(M, MB, E).astype(np.float32))


# name: (group, its size, remat)
GPIPE_CASES = {"world": (0, WORLD, True), "world_no_remat": (0, WORLD, False),
               "subset": (1, 3, True)}
# name: (group, its size, with targets)
F1B_CASES = {"world_targets": (0, WORLD, True), "world": (0, WORLD, False),
             "subset": (1, 3, False)}


def _stage(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


def _mse(y, t=None):
    return ((y if t is None else y - t) ** 2).mean()


# -- the port's world ---------------------------------------------------------


def _message(fn):
    import horovod_tpu_torch as hvd

    try:
        fn()
    except hvd.HorovodError as e:
        return f"{type(e).__name__}: {e}"
    return None


def _as_torch(stage):
    return {k: torch.from_numpy(v) for k, v in stage.items()}


def _port_gpipe(hvd, r):
    out = {}
    for name, (group, n, remat) in GPIPE_CASES.items():
        params = _as_torch(hvd.stage_split(_stages(n, 0), group=group))
        mbs, _, g = (torch.from_numpy(a) for a in _data(1))
        last = hvd.rank(group) == n - 1

        def prog(params, mbs, group=group, remat=remat, last=last):
            p = {k: v.clone().requires_grad_(True) for k, v in
                 params.items()}
            y = hvd.gpipe(_stage, p, mbs, group=group, remat=remat)
            loss = (y * g).sum() * (1.0 if last else 0.0)
            grads = torch.autograd.grad(loss, list(p.values()))
            return {"out": y.detach().numpy(),
                    "grads": [t.numpy() for t in grads]}

        out[name] = hvd.spmd(prog)(params, mbs)
    return out


def _port_1f1b(hvd, r):
    out = {}
    for name, (group, n, with_targets) in F1B_CASES.items():
        params = _as_torch(hvd.stage_split(_stages(n, 2), group=group))
        mbs, tgts, _ = (torch.from_numpy(a) for a in _data(3))
        kw = dict(targets=tgts) if with_targets else {}

        def prog(params, mbs, group=group, kw=kw):
            loss, grads = hvd.pipeline_1f1b(_stage, params, mbs, _mse,
                                            group=group, **kw)
            return {"loss": float(loss),
                    "grads": [grads[k].numpy() for k in ("w", "b")]}

        def via_gpipe(params, mbs, group=group, n=n, kw=kw):
            # The same mean loss through gpipe and autograd.
            p = {k: v.clone().requires_grad_(True) for k, v in
                 params.items()}
            y = hvd.gpipe(_stage, p, mbs, group=group)
            t = kw.get("targets")
            loss = sum(_mse(y[j], None if t is None else t[j])
                       for j in range(M)) / M
            loss = loss * (1.0 if hvd.rank(group) == n - 1 else 0.0)
            return [t.numpy() for t in torch.autograd.grad(
                loss, list(p.values()))]

        res = hvd.spmd(prog)(params, mbs)
        res["gpipe_grads"] = hvd.spmd(via_gpipe)(params, mbs)
        out[name] = res
    return out


def _refusal_cases(hvd, mbs, params, spmd):
    return {
        "stage_count": lambda: hvd.stage_split([params] * 3),
        "gpipe_eager": lambda: hvd.gpipe(_stage, params, mbs),
        "1f1b_eager": lambda: hvd.pipeline_1f1b(_stage, params, mbs, _mse),
    }


def _port_world():
    import horovod_tpu_torch as hvd

    hvd.init(GROUPS, device="cpu")
    r = hvd.rank()
    mbs = torch.from_numpy(_data(1)[0])
    params = _as_torch(_stages(1, 0)[0])
    errors = {n: _message(f) for n, f in _refusal_cases(
        hvd, mbs, params, hvd.spmd).items()}
    stages = _stages(3, 0)
    split = hvd.stage_split(stages, group=1)
    return {"gpipe": _port_gpipe(hvd, r), "1f1b": _port_1f1b(hvd, r),
            "errors": errors,
            "split_index": next(i for i, s in enumerate(stages)
                                if s is split)}


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


def _jstage(p, x):
    import jax.numpy as jnp

    return jnp.tanh(x @ p["w"] + p["b"])


def _jmse(y, t=None):
    import jax.numpy as jnp

    return jnp.mean((y if t is None else y - t) ** 2)


@pytest.fixture(scope="module")
def jax_gpipe(jhvd):
    import jax
    import jax.numpy as jnp

    out = {}
    for name, (group, n, remat) in GPIPE_CASES.items():
        params = jhvd.stage_split(_stages(n, 0), group=group)
        mbs, _, g = _data(1)

        def prog(params, mbs, group=group, n=n, remat=remat):
            def loss(params):
                y = jhvd.gpipe(_jstage, params, mbs, group=group,
                               remat=remat)
                return jnp.where(jhvd.rank(group) == n - 1,
                                 jnp.sum(y * g), 0.0), y

            (_, y), grads = jax.value_and_grad(loss, has_aux=True)(params)
            return {"out": y, "grads": [grads["w"], grads["b"]]}

        out[name] = jax.tree.map(np.asarray, jhvd.spmd(prog)(
            params, jhvd.replicate(mbs)))
    return out


@pytest.fixture(scope="module")
def jax_1f1b(jhvd):
    import jax

    out = {}
    for name, (group, n, with_targets) in F1B_CASES.items():
        params = jhvd.stage_split(_stages(n, 2), group=group)
        mbs, tgts, _ = _data(3)

        def prog(params, mbs, tgts, group=group, with_targets=with_targets):
            loss, grads = jhvd.pipeline_1f1b(
                _jstage, params, mbs, _jmse,
                targets=tgts if with_targets else None, group=group)
            return {"loss": loss, "grads": [grads["w"], grads["b"]]}

        out[name] = jax.tree.map(np.asarray, jhvd.spmd(prog)(
            params, jhvd.replicate(mbs), jhvd.replicate(tgts)))
    return out


@pytest.fixture(scope="module")
def jax_refusals(jhvd):
    import jax.numpy as jnp

    from horovod_tpu.core.state import HorovodError

    def message(fn):
        try:
            fn()
        except HorovodError as e:
            return f"{type(e).__name__}: {e}"
        return None

    params = {k: jnp.asarray(v) for k, v in _stages(1, 0)[0].items()}
    cases = _refusal_cases(jhvd, jnp.asarray(_data(1)[0]), params, None)
    return {n: message(f) for n, f in cases.items()}


# -- the tests -----------------------------------------------------------------


def _members(group):
    return range(WORLD) if group == 0 else range(3)


@pytest.mark.parametrize("name", list(GPIPE_CASES))
def test_gpipe_outputs_match_jax(port, jax_gpipe, name):
    for r, rank_out in enumerate(port):
        np.testing.assert_allclose(rank_out["gpipe"][name]["out"],
                                   jax_gpipe[name]["out"][r],
                                   rtol=OUT_TOL, atol=OUT_TOL)


@pytest.mark.parametrize("name", list(GPIPE_CASES))
def test_gpipe_gradients_match_jax(port, jax_gpipe, name):
    for r, rank_out in enumerate(port):
        for got, want in zip(rank_out["gpipe"][name]["grads"],
                             jax_gpipe[name]["grads"]):
            np.testing.assert_allclose(got, want[r], rtol=GRAD_TOL,
                                       atol=GRAD_TOL)


@pytest.mark.parametrize("name", list(GPIPE_CASES))
def test_gpipe_matches_the_stages_run_in_turn(port, name):
    """The last stage's outputs are the stages applied one after another;
    every other member's (and a non-member's) are zero."""
    group, n, _ = GPIPE_CASES[name]
    x = torch.from_numpy(_data(1)[0])
    for stage in _stages(n, 0):
        x = _stage(_as_torch(stage), x)
    for r, rank_out in enumerate(port):
        got = rank_out["gpipe"][name]["out"]
        if r == n - 1:
            np.testing.assert_allclose(got, x.numpy(), rtol=OUT_TOL,
                                       atol=OUT_TOL)
        else:
            np.testing.assert_array_equal(got, 0.0)


@pytest.mark.parametrize("name", list(F1B_CASES))
def test_1f1b_loss_matches_jax(port, jax_1f1b, name):
    for r, rank_out in enumerate(port):
        np.testing.assert_allclose(rank_out["1f1b"][name]["loss"],
                                   jax_1f1b[name]["loss"][r],
                                   rtol=LOSS_RTOL, atol=LOSS_ATOL)


@pytest.mark.parametrize("name", list(F1B_CASES))
def test_1f1b_gradients_match_jax(port, jax_1f1b, name):
    for r, rank_out in enumerate(port):
        for got, want in zip(rank_out["1f1b"][name]["grads"],
                             jax_1f1b[name]["grads"]):
            np.testing.assert_allclose(got, want[r], rtol=GRAD_TOL,
                                       atol=1e-5)


@pytest.mark.parametrize("name", list(F1B_CASES))
def test_1f1b_gradients_match_gpipe_and_autograd(port, name):
    for rank_out in port:
        res = rank_out["1f1b"][name]
        for got, want in zip(res["grads"], res["gpipe_grads"]):
            np.testing.assert_allclose(got, want, rtol=GRAD_TOL, atol=1e-5)


def test_subset_non_members_get_zeros(port):
    """Rank 3 is outside group 1: zero outputs, loss and gradients."""
    rank3 = port[3]
    np.testing.assert_array_equal(rank3["gpipe"]["subset"]["out"], 0.0)
    for g in rank3["gpipe"]["subset"]["grads"]:
        np.testing.assert_array_equal(g, 0.0)
    assert rank3["1f1b"]["subset"]["loss"] == 0.0
    for g in rank3["1f1b"]["subset"]["grads"]:
        np.testing.assert_array_equal(g, 0.0)


@pytest.mark.parametrize("case", ["stage_count", "gpipe_eager",
                                  "1f1b_eager"])
def test_refusals_are_the_references_text(port, jax_refusals, case):
    want = jax_refusals[case]
    assert want is not None
    for rank_out in port:
        assert rank_out["errors"][case] == want


def test_stage_split_returns_this_ranks_stage(port):
    """A process is a rank: ``stage_split`` returns ``layers[group rank]``
    (the reference's row of its stack), ``layers[0]`` outside the
    group."""
    assert [rank_out["split_index"] for rank_out in port] == [0, 1, 2, 0]


def test_a_module_stage_is_applied_with_functional_call():
    """An ``nn.Module`` as ``stage_fn`` runs with this rank's parameter
    dict (``torch.func.functional_call``): at one rank, gpipe and 1F1B
    over a ``Linear`` + ``Tanh`` stage equal the same stage as a
    function."""
    import horovod_tpu_torch as hvd

    stage = torch.nn.Sequential(torch.nn.Linear(E, E), torch.nn.Tanh())
    w, b = (torch.from_numpy(_stages(1, 0)[0][k]) for k in ("w", "b"))
    params = {"0.weight": w.T.contiguous(), "0.bias": b}
    mbs = torch.from_numpy(_data(1)[0])
    hvd.shutdown()
    hvd.init(device="cpu")
    try:
        def run(fn, p):
            out = hvd.gpipe(fn, p, mbs)
            loss, grads = hvd.pipeline_1f1b(fn, p, mbs, _mse)
            return out, loss, list(grads.values())

        got = hvd.spmd(lambda p: run(stage, p))(params)
        want = hvd.spmd(lambda p: run(
            lambda q, x: torch.tanh(x @ q["0.weight"].T + q["0.bias"]),
            p))(params)
    finally:
        hvd.shutdown()
    torch.testing.assert_close(got[0], want[0])
    torch.testing.assert_close(got[1], want[1])
    for g, h in zip(got[2], want[2]):
        torch.testing.assert_close(g, h)

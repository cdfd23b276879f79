"""Port parity: expert parallelism (``parallel/expert.py``: top-1 and top-2
routing, capacity packing and drops, the two all-to-alls with their
autograd transpose, the aux loss) against ``horovod_tpu``'s.

One spawned 4-rank gloo world (module-scoped), ``hvd.init([[0, 1], [2, 3],
[0, 1, 2]])``: group 0 is a 4-expert EP group, the family ``(1, 2)`` two
2-expert groups side by side (DP × EP), and groups 1 and 3 are strict
subsets (refused). The JAX side runs the same per-rank numpy inputs
(float32, made from a seed: each rank's tokens and its own expert) over 4
CPU devices under ``hvd.spmd`` with the same groups. Each case's output,
aux loss and the gradients of x, the router and the rank's expert (of a
seeded cotangent plus 0.1 × aux) are held at the JAX package's own
tolerances (``tests/test_expert_parallel.py``: 1e-4 outputs, 1e-3
gradients). The router's ties are planted (equal router columns, and an
all-zero router) so the tie rule shows; every refusal text is compared
byte for byte.

The spawned children import this module, so JAX is imported only inside
the parent-side functions.
"""

import numpy as np
import pytest
import torch

WORLD = 4
GROUPS = [[0, 1], [2, 3], [0, 1, 2]]
B, T, E, F_DIM = 1, 8, 8, 16
OUT_TOL, GRAD_TOL = 1e-4, 1e-3
AUX_WEIGHT = 0.1
# name: moe_mlp keywords; ``router``: which router ("ties": columns 0 = 1
# and 2 = 3, "zero": all ties).
CASES = {
    "k1": dict(),
    "k2": dict(k=2),
    "drop_k1": dict(capacity_factor=0.5),
    "drop_k2": dict(k=2, capacity_factor=0.5),
    "family_k1": dict(group=(1, 2)),
    "family_k2": dict(group=(1, 2), k=2),
    "ties_k1": dict(router="ties"),
    "ties_k2": dict(k=2, router="ties"),
    "zero_router_k2": dict(k=2, router="zero"),
}


def _inputs():
    rng = np.random.RandomState(0)

    def n(*shape, s=1.0):
        return (rng.randn(*shape) * s).astype(np.float32)

    gate = n(E, WORLD)
    ties = gate.copy()
    ties[:, 1], ties[:, 3] = ties[:, 0], ties[:, 2]
    return {"x": n(WORLD, B, T, E, s=0.5), "gate": gate, "ties": ties,
            "zero": np.zeros((E, WORLD), np.float32),
            "w1": n(WORLD, E, F_DIM, s=0.3), "b1": n(WORLD, F_DIM, s=0.1),
            "w2": n(WORLD, F_DIM, E, s=0.3), "b2": n(WORLD, E, s=0.1),
            "g": n(WORLD, B, T, E)}


def _case(x, r, kw):
    """(params in order x, gate, w1, b1, w2, b2; keywords) of a case on
    rank ``r``; a family's 2-expert groups route over the router's first
    two columns."""
    kw = dict(kw)
    gate = x[kw.pop("router", "gate")]
    if "group" in kw:
        gate = gate[:, :2]
    return [x["x"][r], gate] + [x[k][r] for k in
                                ("w1", "b1", "w2", "b2")], kw


# -- the port's world ---------------------------------------------------------


def _message(fn):
    import horovod_tpu_torch as hvd

    try:
        fn()
    except hvd.HorovodError as e:
        return f"{type(e).__name__}: {e}"
    return None


def _port_cases(hvd, r):
    x = {k: torch.from_numpy(v) for k, v in _inputs().items()}
    out = {}
    for name, kw in CASES.items():
        params, kw = _case(x, r, kw)

        def prog(*params, kw=kw):
            params = [p.clone().requires_grad_(True) for p in params]
            y, aux = hvd.moe_mlp(*params, **kw, name="moe")
            grads = torch.autograd.grad(
                (y * x["g"][r]).sum() + AUX_WEIGHT * aux, params)
            return {"out": y.detach().numpy(), "aux": float(aux),
                    "grads": [t.numpy() for t in grads]}

        out[name] = hvd.spmd(prog)(*params)
    return out


def _refusal_cases(hvd, params, spmd):
    """The refusals; ``params``: (x, gate, w1, b1, w2, b2) of this rank."""
    x, gate, *expert = params

    def moe(**kw):
        return lambda: spmd(lambda *p: hvd.moe_mlp(*p, **kw))(x, gate,
                                                             *expert)

    return {
        "eager": lambda: hvd.moe_mlp(x, gate, *expert),
        "subset": moe(group=1),
        "unequal_family": moe(group=(1, 3)),
        "router_width": lambda: spmd(lambda *p: hvd.moe_mlp(*p))(
            x, gate[..., :3], *expert),
        "k3": moe(k=3),
    }


def _port_world():
    import horovod_tpu_torch as hvd

    hvd.init(GROUPS, device="cpu")
    r = hvd.rank()
    x = {k: torch.from_numpy(v) for k, v in _inputs().items()}
    params, _ = _case(x, r, {})
    return {"cases": _port_cases(hvd, r),
            "errors": {n: _message(f) for n, f in _refusal_cases(
                hvd, params, hvd.spmd).items()}}


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


def _stacked_case(x, kw):
    """A case's rank-stacked params (the router replicated)."""
    per_rank = [_case(x, r, kw)[0] for r in range(WORLD)]
    return [np.stack(col) for col in zip(*per_rank)], _case(x, 0, kw)[1]


@pytest.fixture(scope="module")
def jax_cases(jhvd):
    import jax

    x = _inputs()
    out = {}
    for name, kw in CASES.items():
        params, kw = _stacked_case(x, kw)

        def prog(g, *params, kw=kw):
            (y, aux), vjp = jax.vjp(
                lambda *p: jhvd.moe_mlp(*p, **kw, name="moe"), *params)
            return {"out": y, "aux": aux,
                    "grads": list(vjp((g, np.float32(AUX_WEIGHT))))}

        out[name] = jax.tree.map(np.asarray, jhvd.spmd(prog)(x["g"],
                                                             *params))
    return out


@pytest.fixture(scope="module")
def jax_refusals(jhvd):
    from horovod_tpu.core.state import HorovodError

    def message(fn):
        try:
            fn()
        except HorovodError as e:
            return f"{type(e).__name__}: {e}"
        return None

    params, _ = _stacked_case(_inputs(), {})

    def spmd(fn):
        return lambda *p: jhvd.spmd(fn)(*p)

    cases = _refusal_cases(jhvd, params, spmd)
    # The eager call takes one rank's arrays.
    cases["eager"] = lambda: jhvd.moe_mlp(*(p[0] for p in params))
    return {n: message(f) for n, f in cases.items()}


# -- the tests -----------------------------------------------------------------


@pytest.mark.parametrize("name", list(CASES))
def test_outputs_and_aux_match_jax(port, jax_cases, name):
    want = jax_cases[name]
    for r, rank_out in enumerate(port):
        got = rank_out["cases"][name]
        np.testing.assert_allclose(got["out"], want["out"][r],
                                   rtol=OUT_TOL, atol=OUT_TOL)
        np.testing.assert_allclose(got["aux"], want["aux"][r],
                                   rtol=OUT_TOL, atol=OUT_TOL)


@pytest.mark.parametrize("name", list(CASES))
def test_gradients_match_jax(port, jax_cases, name):
    """x, the router and the rank's own expert (w1, b1, w2, b2): the
    all-to-alls' transpose routes each expert's cotangents to its owner."""
    want = jax_cases[name]["grads"]
    for r, rank_out in enumerate(port):
        got = rank_out["cases"][name]["grads"]
        assert len(got) == 6
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w[r], rtol=GRAD_TOL,
                                       atol=GRAD_TOL)


@pytest.mark.parametrize("name", ["drop_k1", "drop_k2"])
def test_capacity_drops_the_overflow_tokens(port, jax_cases, name):
    """At capacity factor 0.5 (one slot an expert a source rank) tokens
    drop: their output rows are 0 on both sides, the same rows."""
    dropped = 0
    for r, rank_out in enumerate(port):
        rows = rank_out["cases"][name]["out"].reshape(-1, E)
        zero = np.all(rows == 0, axis=1)
        want = np.all(jax_cases[name]["out"][r].reshape(-1, E) == 0, axis=1)
        np.testing.assert_array_equal(zero, want)
        dropped += int(zero.sum())
    assert dropped > 0


@pytest.mark.parametrize("k", [1, 2])
def test_planted_ties_take_the_lower_index_like_lax_top_k(k):
    """The router's tie rule: ``top_k`` equals ``jax.lax.top_k``, indices
    and values, on probabilities with planted ties (all equal; pairs
    equal; the maximum twice)."""
    import jax

    from horovod_tpu_torch.parallel.expert import top_k

    probs = np.array([[0.25, 0.25, 0.25, 0.25],
                      [0.1, 0.4, 0.1, 0.4],
                      [0.3, 0.3, 0.2, 0.2],
                      [0.2, 0.1, 0.35, 0.35],
                      [0.1, 0.2, 0.3, 0.4]], np.float32)
    want_p, want_e = jax.lax.top_k(probs, k)
    got_p, got_e = top_k(torch.from_numpy(probs), k)
    np.testing.assert_array_equal(got_e.numpy(), np.asarray(want_e))
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))


def test_the_zero_router_sends_every_token_to_experts_0_and_1(port):
    """All four probabilities tie: every first choice is expert 0 and every
    second expert 1, so with 8 tokens a rank and capacity 3 the last two
    tokens of each source rank drop out of both buffers."""
    for rank_out in port:
        rows = rank_out["cases"]["zero_router_k2"]["out"].reshape(-1, E)
        zero = np.all(rows == 0, axis=1)
        np.testing.assert_array_equal(zero, [False] * 3 + [True] * 5)


REFUSALS = ("eager", "subset", "unequal_family", "router_width", "k3")


@pytest.mark.parametrize("case", REFUSALS)
def test_refusals_are_the_references_text(port, jax_refusals, case):
    want = jax_refusals[case]
    assert want is not None
    for rank_out in port:
        assert rank_out["errors"][case] == want


def test_moe_capacity_is_the_references():
    from horovod_tpu.parallel import expert as jexp
    from horovod_tpu_torch.parallel import expert as texp

    for args in [(8, 4), (8, 4, 0.5), (1, 8), (100, 3, 1.25), (7, 2, 2.0)]:
        assert texp.moe_capacity(*args) == jexp.moe_capacity(*args)

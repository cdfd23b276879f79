"""Port parity: the four collectives with ``group=`` and the negotiation
errors of ``horovod_tpu_torch`` against ``horovod_tpu``'s eager collectives.

One spawned gloo world of 3 ranks (module-scoped) runs every port-side case
with the overlapping groups ``[[0, 1], [1, 2]]``; the JAX side runs the same
per-rank inputs through ``hvd.init([[0, 1], [1, 2]])`` over the first 3
devices of the simulated 8-device world, so group 0 is the same 3-rank world
on both sides. The spawned children import this module to find their
target, so JAX is imported only inside the parent-side functions.

Tolerance: allreduce of fp32 sums 3 values in possibly another order
(rtol 1e-6); everything else moves data unchanged and must be exact.
"""

import numpy as np
import pytest
import torch

GROUPS = [[0, 1], [1, 2]]
GROUP_RANKS = {0: [0, 1, 2], 1: [0, 1], 2: [1, 2]}
GRAD_SHAPES = [(4, 3), (5,), (2, 2, 2)]  # 48, 20, 32 bytes: fused at 64


def _value(rank, shape=(4, 3), dtype=np.float32, seed=0):
    rng = np.random.RandomState(100 * seed + rank)
    return (rng.randn(*shape) * 5).astype(dtype)


def _ints(rank):
    return np.arange(6, dtype=np.int32).reshape(2, 3) * (rank + 1) + 7


def _gather_rows(rank):
    return _value(rank, shape=(rank + 1, 3), seed=3)


def _port_world():
    """Target of each spawned rank: every port-side case, as numpy."""
    import horovod_tpu_torch as hvd

    hvd.init(GROUPS, device="cpu")
    r = hvd.global_rank()
    out = {"rank_in": {g: hvd.rank(g) for g in GROUP_RANKS}}

    def np_(t):
        return None if t is None else (
            t if isinstance(t, list) else t.numpy())

    for g in GROUP_RANKS:
        x = torch.from_numpy(_value(r, seed=g))
        out[("sum", g)] = np_(hvd.allreduce(x, group=g, average=False,
                                            name=f"sum{g}"))
        out[("avg", g)] = np_(hvd.allreduce(x, group=g, name=f"avg{g}"))
        out[("iavg", g)] = np_(hvd.allreduce(torch.from_numpy(_ints(r)),
                                             group=g, name=f"iavg{g}"))
        rows = torch.from_numpy(_gather_rows(r))
        out[("allgather", g)] = np_(hvd.allgather(rows, group=g,
                                                  name=f"ag{g}"))
        out[("broadcast", g)] = np_(hvd.broadcast(
            torch.from_numpy(_value(r, seed=5)), root_rank=1 if g == 0 else 0,
            group=g, name=f"bc{g}"))
        out[("gather", g)] = np_(hvd.gather(rows, root_rank=1 if g == 0
                                            else 0, group=g, name=f"ga{g}"))
    for g in (0, 2):
        grads = [torch.from_numpy(_value(r, shape=s, seed=7 + i))
                 for i, s in enumerate(GRAD_SHAPES)]
        out[("grads", g)] = [t.numpy() for t in hvd.allreduce_gradients(
            grads, group=g, fusion_threshold=64, name=f"grads{g}")]
    # Auto names advance one counter per op type, in lockstep on all ranks.
    out["auto"] = [float(hvd.allreduce(torch.ones(1)).item())
                   for _ in range(3)]

    errors = {}
    cases = {
        "dtype": lambda: hvd.allreduce(
            torch.ones(4, 3, dtype=torch.float64 if r == 1
                       else torch.float32), name="bad_dtype"),
        "shape": lambda: hvd.allreduce(
            torch.ones((5, 3) if r == 2 else (4, 3)), name="bad_shape"),
        "root": lambda: hvd.broadcast(torch.ones(2), root_rank=r % 2,
                                      name="bad_root"),
        "trailing": lambda: hvd.allgather(
            torch.ones(2, 3 if r == 0 else 4), name="bad_trailing"),
    }
    for key, case in cases.items():
        try:
            case()
            errors[key] = None
        except hvd.HorovodError as e:
            errors[key] = str(e)
    out["errors"] = errors
    # The world still works after refused collectives.
    out["after"] = float(hvd.allreduce(torch.full((1,), float(r)),
                                       name="after").item())
    return out


@pytest.fixture(scope="module")
def port_results():
    from horovod_tpu_torch.run import run

    return run(_port_world, 3, device="cpu", timeout=120)


@pytest.fixture(scope="module")
def jax_hvd():
    import jax

    import horovod_tpu as jhvd

    jhvd.shutdown()
    jhvd.init(GROUPS, devices=jax.devices()[:3])
    yield jhvd
    jhvd.shutdown()


def _jax_per_rank(jhvd, fn, g, make):
    """Run a JAX eager collective on group ``g`` with per-member values;
    returns {global rank: numpy result}."""
    import jax.numpy as jnp

    ranks = GROUP_RANKS[g]
    res = fn([jnp.asarray(make(r)) for r in ranks], g)
    if not isinstance(res, list):
        res = [res] * len(ranks)
    return {r: np.asarray(v) for r, v in zip(ranks, res)}


@pytest.mark.parametrize("g", [0, 1, 2])
def test_ranks_and_non_members(port_results, g):
    for r, out in enumerate(port_results):
        want = GROUP_RANKS[g].index(r) if r in GROUP_RANKS[g] else -1
        assert out["rank_in"][g] == want
        if want < 0:
            for op in ("sum", "avg", "allgather", "broadcast"):
                assert out[(op, g)] is None
            assert out[("gather", g)] == []


@pytest.mark.parametrize("average", [False, True])
@pytest.mark.parametrize("g", [0, 1, 2])
def test_allreduce_matches_jax(port_results, jax_hvd, g, average):
    want = _jax_per_rank(
        jax_hvd, lambda xs, gg: jax_hvd.allreduce(xs, group=gg,
                                                  average=average), g,
        lambda r: _value(r, seed=g))
    for r in GROUP_RANKS[g]:
        got = port_results[r][("avg" if average else "sum", g)]
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want[r], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("g", [0, 1, 2])
def test_integer_average_floors_like_jax(port_results, jax_hvd, g):
    want = _jax_per_rank(
        jax_hvd, lambda xs, gg: jax_hvd.allreduce(xs, group=gg), g, _ints)
    for r in GROUP_RANKS[g]:
        got = port_results[r][("iavg", g)]
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want[r])


@pytest.mark.parametrize("g", [0, 1, 2])
def test_allgather_unequal_first_dims_matches_jax(port_results, jax_hvd, g):
    want = _jax_per_rank(
        jax_hvd, lambda xs, gg: jax_hvd.allgather(xs, group=gg), g,
        _gather_rows)
    for r in GROUP_RANKS[g]:
        np.testing.assert_array_equal(port_results[r][("allgather", g)],
                                      want[r])


@pytest.mark.parametrize("g", [0, 1, 2])
def test_broadcast_matches_jax(port_results, jax_hvd, g):
    root = 1 if g == 0 else 0
    want = _jax_per_rank(
        jax_hvd, lambda xs, gg: jax_hvd.broadcast(xs, root_rank=root,
                                                  group=gg), g,
        lambda r: _value(r, seed=5))
    for r in GROUP_RANKS[g]:
        np.testing.assert_array_equal(port_results[r][("broadcast", g)],
                                      want[r])


@pytest.mark.parametrize("g", [0, 1, 2])
def test_rooted_gather_matches_jax(port_results, jax_hvd, g):
    """The root receives the concatenation; every other member keeps its
    own input unchanged."""
    root = 1 if g == 0 else 0
    want = _jax_per_rank(
        jax_hvd, lambda xs, gg: jax_hvd.gather(xs, root_rank=root, group=gg),
        g, _gather_rows)
    for r in GROUP_RANKS[g]:
        got = port_results[r][("gather", g)]
        np.testing.assert_array_equal(got, want[r])
        if GROUP_RANKS[g].index(r) != root:
            np.testing.assert_array_equal(got, _gather_rows(r))


@pytest.mark.parametrize("g", [0, 2])
def test_allreduce_gradients_fused_matches_jax(port_results, jax_hvd, g):
    """Fused (64-byte buckets), averaged, in place; a non-member's
    tensors are left as they were."""
    for i, shape in enumerate(GRAD_SHAPES):
        want = _jax_per_rank(
            jax_hvd, lambda xs, gg: jax_hvd.allreduce(xs, group=gg), g,
            lambda r: _value(r, shape=shape, seed=7 + i))
        for r in range(3):
            got = port_results[r][("grads", g)][i]
            if r in GROUP_RANKS[g]:
                np.testing.assert_allclose(got, want[r], rtol=1e-6,
                                           atol=1e-6)
            else:
                np.testing.assert_array_equal(
                    got, _value(r, shape=shape, seed=7 + i))


def _jax_error(requests):
    from horovod_tpu.core import negotiate as jneg

    with pytest.raises(jneg.HorovodError) as info:
        jneg.validate_py(requests, len(requests))
    return str(info.value)


def _jreq(rank, name, op, dtype, shape, root=-1):
    from horovod_tpu.core import negotiate as jneg

    return jneg.Request(rank=rank, name=name,
                        op=getattr(jneg.CollectiveOp, op), dtype=dtype,
                        shape=shape, root_rank=root)


@pytest.mark.parametrize("case", ["dtype", "shape", "root", "trailing"])
def test_negotiation_errors_match_jax(port_results, case):
    """A mismatch across ranks raises HorovodError on EVERY rank, with the
    reference's message byte for byte."""
    reqs = {
        "dtype": [_jreq(r, "bad_dtype", "ALLREDUCE",
                        "float64" if r == 1 else "float32", (4, 3))
                  for r in range(3)],
        "shape": [_jreq(r, "bad_shape", "ALLREDUCE", "float32",
                        (5, 3) if r == 2 else (4, 3)) for r in range(3)],
        "root": [_jreq(r, "bad_root", "BROADCAST", "float32", (2,), r % 2)
                 for r in range(3)],
        "trailing": [_jreq(r, "bad_trailing", "ALLGATHER", "float32",
                           (2, 3 if r == 0 else 4)) for r in range(3)],
    }[case]
    want = _jax_error(reqs)
    for out in port_results:
        assert out["errors"][case] == want


def test_auto_names_and_world_survives_errors(port_results):
    for out in port_results:
        assert out["auto"] == [1.0, 1.0, 1.0]
        assert out["after"] == pytest.approx(1.0)  # mean of 0, 1, 2

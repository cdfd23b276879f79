"""Port parity: the sparse gradient exchange of ``horovod_tpu_torch``
(``ops/sparse.py``, ``IndexedSlices`` through ``allreduce_gradients`` and
``DistributedOptimizer``) against ``horovod_tpu``'s.

One spawned 4-rank gloo world (module-scoped) runs every port-side case
with ``hvd.init([[0, 1, 2]])`` (group 1; rank 3 is outside it); the JAX side
runs the same per-rank numpy inputs over the first 4 devices of the
8-device CPU world with the same groups, inside ``hvd.spmd``. The spawned
children import this module to find their target, so JAX is imported only
inside the parent-side functions.

The data is integer-valued float32 with duplicate indices within and
across ranks: addition is exact in any order, so the exchanges are held
bit for bit (the averages divide by 4 or 3: bit for bit by 4, rtol 1e-6 by
3). Refusal texts are the reference's byte for byte. ``algo="auto"`` and
``compression=`` (ROADMAP §A item 12) run in a program here and are held
against the JAX package in ``tests/test_torch_compression.py``.
"""

import numpy as np
import pytest
import torch

GROUPS = [[0, 1, 2]]
WORLD = 4
R, D = 16, 3


def _data():
    """Per-rank (4, D) integer-valued values and (4,) int32 indices: in-rank
    duplicates and a hot row 7 on every rank."""
    rng = np.random.RandomState(0)
    vals = rng.randint(-4, 5, (WORLD, 4, D)).astype(np.float32)
    idx = rng.randint(0, R, (WORLD, 4)).astype(np.int32)
    idx[:, 1] = idx[:, 0]
    idx[:, 2] = 7
    return vals, idx


def _expected_dense(vals, idx, ranks):
    out = np.zeros((R, D), np.float32)
    for r in ranks:
        for j in range(idx.shape[1]):
            out[idx[r, j]] += vals[r, j]
    return out


EXCHANGES = {  # name: allreduce_indexed_slices kwargs
    "gather": dict(average=False, algo="gather"),
    "dense": dict(average=False, algo="dense"),
    "gather_avg": dict(average=True),
    "dense_avg": dict(average=True, algo="dense"),
    "padded": dict(average=False, pad_capacity=11),
}


def _slices(v, i):
    import horovod_tpu_torch as hvd

    return hvd.IndexedSlices(v, i, (R, D))


def _exchange_step(v, i):
    import horovod_tpu_torch as hvd

    out = {}
    for key, kw in EXCHANGES.items():
        s = hvd.allreduce_indexed_slices(_slices(v, i), name=f"x_{key}",
                                         **kw)
        out[key] = (s.values, s.indices, s.to_dense())
    return out


def _gradients_step(v, i, w):
    import horovod_tpu_torch as hvd

    # Dense gradients are reduced in place: each call gets its own copy.
    grads = hvd.allreduce_gradients([_slices(v, i), w.clone(),
                                     _slices(2 * v, i)], name="grads")
    sub = hvd.allreduce_gradients([_slices(v, i), w.clone()], group=1,
                                  name="subgrads")
    return ([g.to_dense() if isinstance(g, hvd.IndexedSlices) else g
             for g in grads],
            [g.to_dense() if isinstance(g, hvd.IndexedSlices) else g
             for g in sub])


def _coo_step(rank):
    """Eager DistributedOptimizer with an nn.Embedding(sparse=True)."""
    import horovod_tpu_torch as hvd

    vals, idx = _data()
    emb = torch.nn.Embedding(R, D, sparse=True)
    with torch.no_grad():
        emb.weight.copy_(torch.arange(R * D, dtype=torch.float32
                                      ).reshape(R, D))
    opt = hvd.DistributedOptimizer(torch.optim.SGD(emb.parameters(),
                                                   lr=0.5))
    rows = emb(torch.from_numpy(idx[rank]).long())
    (rows * torch.from_numpy(vals[rank])).sum().backward()
    opt.step()
    grad = emb.weight.grad
    return (emb.weight.detach().numpy().copy(), grad.is_sparse,
            grad.to_dense().numpy())


def _message(fn, exc=None):
    import horovod_tpu_torch as hvd

    try:
        fn()
    except exc or hvd.HorovodError as e:
        return f"{type(e).__name__}: {e}"
    return None


def _port_world():
    import horovod_tpu_torch as hvd

    hvd.init(GROUPS, device="cpu")
    r = hvd.global_rank()
    vals, idx = _data()
    v, i = torch.from_numpy(vals[r]), torch.from_numpy(idx[r])
    out = {}
    step = hvd.spmd(_exchange_step)
    calls = [step(v, i), step(v, i)]
    out["exchange"] = [{k: tuple(t.numpy() for t in ts)
                        for k, ts in c.items()} for c in calls]

    # IndexedSlices in and out of a program.
    through = hvd.spmd(lambda s: hvd.allreduce_indexed_slices(
        s, average=False, name="through"))(_slices(v, i))
    out["through"] = (type(through).__name__, through.dense_shape,
                      through.to_dense().numpy())

    # The reference's plain gather: a subset group in a program, and eager.
    sub = hvd.spmd(lambda s: hvd.allreduce_indexed_slices(
        s, group=1, average=True, name="subset"))(
        hvd.IndexedSlices(torch.full((1, 1), 6.0),
                          torch.zeros(1, dtype=torch.int64), (8, 1)))
    out["subset"] = None if sub is None else (sub.values.numpy(),
                                              sub.indices.numpy())
    rows = torch.full((r + 1, D), float(r + 1))
    eager = hvd.allreduce_indexed_slices(
        hvd.IndexedSlices(rows, torch.arange(r + 1, dtype=torch.int32),
                          (R, D)), name="eager")
    out["eager"] = (eager.values.numpy(), eager.indices.numpy())

    w = torch.full((2, 2), float(r))
    gstep = hvd.spmd(_gradients_step)
    out["grads"] = [[[t.numpy() for t in part]
                     for part in gstep(v, i, w)] for _ in range(2)]
    out["coo"] = _coo_step(r)

    s = _slices(v, i)
    errors = {
        "capacity": _message(lambda: hvd.spmd(
            lambda s: hvd.allreduce_indexed_slices(
                s, pad_capacity=2, name="cap").values)(s)),
        "subset_dense": _message(lambda: hvd.spmd(
            lambda s: hvd.allreduce_indexed_slices(
                s, group=1, algo="dense", name="sub_dense").values)(s)),
        "subset_pad": _message(lambda: hvd.spmd(
            lambda s: hvd.allreduce_indexed_slices(
                s, group=1, pad_capacity=64, name="sub_pad").values)(s)),
        "eager_dense": _message(lambda: hvd.allreduce_indexed_slices(
            s, algo="dense", name="eager_dense")),
        "unknown": _message(lambda: hvd.allreduce_indexed_slices(
            s, algo="ring", name="unknown")),
        "family": _message(lambda: hvd.spmd(
            lambda s: hvd.allreduce_indexed_slices(
                s, group=(0,), name="fam").values)(s)),
        "family_gradients": _message(lambda: hvd.spmd(
            lambda s: hvd.allreduce_gradients([s], group=(1,)))(s)),
        "auto": _message(lambda: hvd.spmd(
            lambda s: hvd.allreduce_indexed_slices(
                s, algo="auto", name="auto").values)(s),
            NotImplementedError),
        "auto_gradients": _message(lambda: hvd.spmd(
            lambda s: hvd.allreduce_gradients(
                [s], sparse_algo="auto"))(s), NotImplementedError),
        "compression": _message(lambda: hvd.allreduce_indexed_slices(
            s, compression="int8", name="comp")),
    }
    out["errors"] = errors
    out["after"] = float(hvd.allreduce(torch.ones(1), name="after"))
    return out


@pytest.fixture(scope="module")
def port():
    from horovod_tpu_torch.run import run

    return run(_port_world, WORLD, device="cpu", timeout=240)


@pytest.fixture(scope="module")
def jhvd():
    import jax

    import horovod_tpu as jhvd

    jhvd.shutdown()
    jhvd.init(GROUPS, devices=jax.devices()[:WORLD])
    yield jhvd
    jhvd.shutdown()


def _jax_message(jhvd, fn):
    with pytest.raises(jhvd.HorovodError) as info:
        fn()
    return f"HorovodError: {info.value}"


@pytest.fixture(scope="module")
def jax_side(jhvd):
    import jax.numpy as jnp

    vals, idx = _data()

    def step(v, i):
        out = {}
        for key, kw in EXCHANGES.items():
            s = jhvd.allreduce_indexed_slices(
                jhvd.IndexedSlices(v, i, (R, D)), name=f"x_{key}", **kw)
            out[key] = (s.values, s.indices, s.to_dense())
        return out

    res = {"exchange": {k: tuple(np.asarray(t) for t in ts)
                        for k, ts in jhvd.spmd(step)(vals, idx).items()}}

    def sub(v, i):
        s = jhvd.IndexedSlices(v, i, (8, 1))
        return jhvd.allreduce_indexed_slices(s, group=1, average=True,
                                             name="subset").values

    res["subset"] = np.asarray(jhvd.spmd(sub)(
        np.full((WORLD, 1, 1), 6.0, np.float32),
        np.zeros((WORLD, 1), np.int64)))

    def grads(v, i, w):
        g = jhvd.allreduce_gradients(
            {"a": jhvd.IndexedSlices(v, i, (R, D)), "b": w,
             "c": jhvd.IndexedSlices(2 * v, i, (R, D))})
        s = jhvd.allreduce_gradients(
            {"a": jhvd.IndexedSlices(v, i, (R, D)), "b": w}, group=1)
        dense = lambda x: x.to_dense() if isinstance(
            x, jhvd.IndexedSlices) else x
        return ([dense(g[k]) for k in "abc"], [dense(s[k]) for k in "ab"])

    ws = np.stack([np.full((2, 2), float(r), np.float32)
                   for r in range(WORLD)])
    res["grads"] = [[np.asarray(t) for t in part]
                    for part in jhvd.spmd(grads)(vals, idx, ws)]

    def spmd_raises(fn, **kw):
        return _jax_message(jhvd, lambda: jhvd.spmd(
            lambda v, i: fn(jhvd.IndexedSlices(v, i, (R, D)), **kw).values)(
            vals, idx))

    one = jhvd.IndexedSlices(jnp.asarray(vals[0]), jnp.asarray(idx[0]),
                             (R, D))
    ais = jhvd.allreduce_indexed_slices
    res["errors"] = {
        "capacity": spmd_raises(ais, pad_capacity=2, name="cap"),
        "subset_dense": spmd_raises(ais, group=1, algo="dense",
                                    name="sub_dense"),
        "subset_pad": spmd_raises(ais, group=1, pad_capacity=64,
                                  name="sub_pad"),
        "eager_dense": _jax_message(jhvd, lambda: ais(
            one, algo="dense", name="eager_dense")),
        "unknown": _jax_message(jhvd, lambda: ais(one, algo="ring",
                                                  name="unknown")),
        "family": spmd_raises(ais, group=(0,), name="fam"),
        "compression": _jax_message(jhvd, lambda: ais(
            one, compression="int8", name="comp")),
    }
    return res


@pytest.mark.parametrize("call", [0, 1])
@pytest.mark.parametrize("key", sorted(EXCHANGES))
def test_exchange_in_a_program_matches_jax(port, jax_side, key, call):
    """Merged values, merged indices and the dense result, bit for bit, on
    the recorded call and the next one."""
    want = jax_side["exchange"][key]
    vals, idx = _data()
    dense = _expected_dense(vals, idx, range(WORLD))
    if key.endswith("_avg"):
        dense = dense / WORLD
    for r in range(WORLD):
        got = port[r]["exchange"][call][key]
        for g, w in zip(got, want):
            assert g.dtype == w[r].dtype
            np.testing.assert_array_equal(g, w[r])
        np.testing.assert_array_equal(got[2], dense)


def test_hot_rows_merge_once_and_the_tail_is_neutral(port):
    for r in range(WORLD):
        values, indices, _ = port[r]["exchange"][0]["gather"]
        live = indices[np.any(values != 0, axis=1)]
        assert (live == 7).sum() == 1
        n_unique = len(set(_data()[1].ravel()))
        assert np.all(indices[n_unique:] == 0)
        assert np.all(values[n_unique:] == 0)


def test_indexed_slices_pass_through_a_program(port):
    vals, idx = _data()
    for r in range(WORLD):
        name, shape, dense = port[r]["through"]
        assert (name, shape) == ("IndexedSlices", (R, D))
        np.testing.assert_array_equal(
            dense, _expected_dense(vals, idx, range(WORLD)))


def test_subset_group_takes_the_plain_gather_with_the_masked_average(
        port, jax_side):
    """Members average the gathered rows (6/3 each, no merge); the rank
    outside the group gets None."""
    for r in range(WORLD):
        got = port[r]["subset"]
        if r in GROUPS[0]:
            np.testing.assert_allclose(got[0], jax_side["subset"][r],
                                       rtol=1e-6)
            np.testing.assert_array_equal(got[1], [0, 0, 0])
        else:
            assert got is None


def test_eager_exchange_gathers_unequal_row_counts(port):
    want_vals = np.concatenate([np.full((r + 1, D), (r + 1) / WORLD,
                                        np.float32) for r in range(WORLD)])
    want_idx = np.concatenate([np.arange(r + 1) for r in range(WORLD)])
    for r in range(WORLD):
        vals, idx = port[r]["eager"]
        np.testing.assert_array_equal(vals, want_vals)
        np.testing.assert_array_equal(idx, want_idx)
        assert idx.dtype == np.int32


@pytest.mark.parametrize("part", [0, 1])
def test_allreduce_gradients_mixed_sparse_and_dense_matches_jax(
        port, jax_side, part):
    """Part 0: the full group (sparse leaves merged, the dense one fused);
    part 1: group 1, where the sparse leaf takes the plain gather and the
    rank outside keeps its own gradients."""
    vals, idx = _data()
    for r in range(WORLD):
        for call in range(2):
            got = port[r]["grads"][call][part]
            if part == 1 and r not in GROUPS[0]:
                np.testing.assert_array_equal(
                    got[0], _expected_dense(vals, idx, [r]))
                np.testing.assert_array_equal(got[1], np.full((2, 2), r))
                continue
            for g, w in zip(got, jax_side["grads"][part]):
                np.testing.assert_allclose(g, w[r], rtol=1e-6, atol=0)


def test_coo_gradient_through_distributed_optimizer(port):
    """nn.Embedding(sparse=True) + DistributedOptimizer(SGD), eager: the
    COO gradient is exchanged, merged and applied; replicas are equal."""
    vals, idx = _data()
    mean = _expected_dense(vals, idx, range(WORLD)) / WORLD
    w0 = np.arange(R * D, dtype=np.float32).reshape(R, D)
    for r in range(WORLD):
        weight, is_sparse, grad = port[r]["coo"]
        assert is_sparse
        np.testing.assert_allclose(grad, mean, rtol=1e-6, atol=0)
        np.testing.assert_allclose(weight, w0 - 0.5 * mean, rtol=1e-6,
                                   atol=0)
        np.testing.assert_array_equal(weight, port[0]["coo"][0])


@pytest.mark.parametrize("key", ["capacity", "subset_dense", "subset_pad",
                                 "eager_dense", "unknown", "family"])
def test_refusals_match_jax(port, jax_side, key):
    """On every rank, the one outside group 1 included: each refusal is
    decided before any data moves."""
    want = jax_side["errors"][key]
    for r in range(WORLD):
        assert port[r]["errors"][key] == want, r


@pytest.mark.parametrize("key", ["family_gradients", "auto",
                                 "auto_gradients", "compression"])
def test_unported_options_and_sparse_families_raise(port, jax_side, key):
    """A family with a sparse item raises. ``algo="auto"`` and the
    compressed value payload are ported (ROADMAP §A item 12): ``auto``
    runs in a program, and ``compression=`` on an eager call raises the
    reference's text."""
    for r in range(WORLD):
        got = port[r]["errors"][key]
        if key == "family_gradients":
            assert got.startswith("HorovodError: Group-family sparse "
                                  "allreduce is not supported"), got
        elif key == "compression":
            assert got == jax_side["errors"]["compression"]
        else:
            assert got is None, got


def test_the_world_survives_refusals(port):
    for r in range(WORLD):
        assert port[r]["after"] == 1.0


# -- single-process cases -----------------------------------------------------


def _merge_cases():
    rng = np.random.RandomState(3)
    hot = rng.randint(0, 50, 6)
    big_idx = np.where(rng.rand(512) < 0.8, hot[rng.randint(0, 6, 512)],
                       rng.randint(0, 50, 512)).astype(np.int32)
    return {
        "duplicates": (np.arange(12, dtype=np.float32).reshape(6, 2),
                       np.array([3, 3, 0, 5, 3, 0], np.int32)),
        "pad_rows": (np.array([[1.0], [5.0], [0.0], [0.0]], np.float32),
                     np.array([0, 2, 0, 0], np.int32)),
        "zipf_hot_integers": (rng.randint(-9, 10, (512, 4)
                                          ).astype(np.float32), big_idx),
        "zipf_hot_random": (rng.randn(512, 4).astype(np.float32), big_idx),
        "one_row": (np.ones((1, 3), np.float32), np.array([4], np.int32)),
    }


@pytest.mark.parametrize("case", sorted(_merge_cases()))
def test_dedup_merge_matches_jax(case):
    """Bit for bit: both sum each segment in its rows' order from zero."""
    import jax.numpy as jnp

    from horovod_tpu.ops import sparse as jsparse
    from horovod_tpu_torch.ops import sparse as tsparse

    vals, idx = _merge_cases()[case]
    wm, wi = jsparse.dedup_merge(jnp.asarray(vals), jnp.asarray(idx))
    gm, gi = tsparse.dedup_merge(torch.from_numpy(vals),
                                 torch.from_numpy(idx))
    np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    assert gi.dtype == torch.int32


def test_to_dense_and_scatter_add_merge_first():
    from horovod_tpu_torch.ops import sparse as tsparse

    vals, idx = _merge_cases()["zipf_hot_random"]
    s = tsparse.IndexedSlices(torch.from_numpy(vals), torch.from_numpy(idx),
                              (50, 4))
    want = np.zeros((50, 4), np.float32)
    np.add.at(want, idx, vals)
    np.testing.assert_allclose(s.to_dense().numpy(), want, rtol=1e-5,
                               atol=1e-5)
    base = torch.ones(50, 4)
    tsparse.scatter_add_(base, s, alpha=-0.5)
    np.testing.assert_array_equal(base.numpy(),
                                  1 + (-0.5) * s.to_dense().numpy())


@pytest.mark.parametrize("raw", [None, "", "0", "5", " 7 ", "-1", "x",
                                 "2.5"])
def test_pad_capacity_knob_parses_like_the_reference(monkeypatch, raw):
    from horovod_tpu.utils import env as jenv
    from horovod_tpu_torch.utils import env as tenv

    if raw is None:
        monkeypatch.delenv("HOROVOD_SPARSE_PAD_CAPACITY", raising=False)
    else:
        monkeypatch.setenv("HOROVOD_SPARSE_PAD_CAPACITY", raw)

    def outcome(fn):
        try:
            return fn()
        except ValueError as e:
            return str(e)

    assert (outcome(tenv.sparse_pad_capacity)
            == outcome(jenv.sparse_pad_capacity))


def test_a_typo_in_the_pad_capacity_raises_at_init(monkeypatch):
    import horovod_tpu_torch as hvd

    monkeypatch.setenv("HOROVOD_SPARSE_PAD_CAPACITY", "lots")
    hvd.shutdown()
    with pytest.raises(ValueError, match="HOROVOD_SPARSE_PAD_CAPACITY"):
        hvd.init(device="cpu")
    assert not hvd.is_initialized()


@pytest.mark.parametrize("pad", [None, 9])
def test_plan_row_matches_jax(jhvd, monkeypatch, pad):
    """The plan row: capacity (argument, then the knob), sizes, payload
    bytes and its description."""
    import jax.numpy as jnp

    import horovod_tpu_torch as hvd
    from horovod_tpu.ops import sparse as jsparse
    from horovod_tpu_torch.ops import sparse as tsparse

    monkeypatch.setenv("HOROVOD_SPARSE_PAD_CAPACITY", "6")
    vals, idx = _data()
    hvd.shutdown()
    hvd.init(device="cpu")
    try:
        got = tsparse.plan_sparse_exchange(
            tsparse.IndexedSlices(torch.from_numpy(vals[0]),
                                  torch.from_numpy(idx[0]), (R, D)),
            algo="dense" if pad else None, index=2, pad_capacity=pad,
            label="emb")
    finally:
        hvd.shutdown()
    want = jsparse.plan_sparse_exchange(
        jsparse.IndexedSlices(jnp.asarray(vals[0]), jnp.asarray(idx[0]),
                              (R, D)),
        algo="dense" if pad else None, index=2, pad_capacity=pad,
        label="emb")
    for field in ("index", "rows", "row_elems", "dense_rows", "algo",
                  "index_itemsize", "label", "values_bytes",
                  "payload_wire_bytes", "dense_bytes"):
        assert getattr(got, field) == getattr(want, field), field
    assert got.describe() == want.describe()
    assert got.rows == (pad or 6)


def test_sparse_algo_is_validated_like_the_reference():
    from horovod_tpu.ops import sparse as jsparse
    from horovod_tpu_torch.ops import sparse as tsparse

    for spec in (None, "gather", " Dense ", "auto"):
        assert tsparse.resolve_sparse_algo(spec) == \
            jsparse.resolve_sparse_algo(spec)
    for spec in ("ring", 3):
        with pytest.raises(Exception) as want:
            jsparse.resolve_sparse_algo(spec)
        with pytest.raises(Exception) as got:
            tsparse.resolve_sparse_algo(spec)
        assert str(got.value) == str(want.value)


"""Port parity: gradient wire compression (``ops/compression.py``) and error
feedback against ``horovod_tpu``'s.

Single-process cases hold each compressor's ``compress``, ``decompress``,
``gathered_rows`` and ``gathered_sum`` against the JAX compressor bit for
bit, with the same noise array fed to both (``tests/torch_wire_support.py``),
and mirror the reference's unit tests (``tests/test_compression.py``,
``tests/test_block_compression.py``) on the port's own noise stream:
budgets, refusals, zero buckets, the nibble layout, wire bytes,
unbiasedness and determinism.

One spawned 4-rank gloo world (module-scoped) runs the collectives; the
JAX side runs the same per-rank numpy inputs over 4 CPU devices inside
``hvd.spmd``. With fed noise every format is bit for bit on integer-valued
data, and int8/int8_block/int4 on random data too (the integer wire sums
exactly; int4's fp32 sum is one fused multiply-add a rank, as XLA's
fused reduction does it). On random data gloo and XLA add the 4 ranks in
their own orders, so fp32 (none) and bf16 are held to 3 roundings of
sum|x|: 3 × 2^-24 and 3 × 2^-8 of it. Refusal texts are the reference's
byte for byte.
"""

import copy
import os

import numpy as np
import pytest
import torch

from torch_wire_support import (WORLD, fed_noise, install_port_noise,
                                jax_noise)

FORMATS = ("none", "bf16", "int8", "int8_block", "int4")
N = 1000          # not a multiple of the world, nor of a 256-block
SHAPES = ((17, 5), (33,), (4, 4, 3))
THRESHOLD = 200   # bytes: three buckets of the three gradients
R, D = 24, 6      # the sparse table


def _data(kind: str) -> np.ndarray:
    """(WORLD, N) float32: integer-valued or normal."""
    rng = np.random.RandomState(1 if kind == "int" else 2)
    if kind == "int":
        return rng.randint(-20, 21, (WORLD, N)).astype(np.float32)
    return rng.randn(WORLD, N).astype(np.float32)


def _grads(step: int):
    """Per-rank gradients of SHAPES, integer-valued halves."""
    rng = np.random.RandomState(10 + step)
    return [(rng.randint(-40, 41, (WORLD,) + s) / 2).astype(np.float32)
            for s in SHAPES]


def _sparse():
    rng = np.random.RandomState(5)
    vals = rng.randint(-6, 7, (WORLD, 5, D)).astype(np.float32)
    idx = rng.randint(0, R, (WORLD, 5)).astype(np.int32)
    idx[:, 1] = 3
    return vals, idx


# -- the port's world ---------------------------------------------------------


def _allreduce_step(fed, x):
    import horovod_tpu_torch as hvd

    fed.reset()
    return [hvd.allreduce(x, average=False, name=f"ar_{f}", compression=f)
            for f in FORMATS]


def _gradients_step(fed, fmt, *ts):
    import horovod_tpu_torch as hvd

    fed.reset()
    grads = [t.clone() for t in ts[:3]]
    return hvd.allreduce_gradients(grads, compression=fmt,
                                   fusion_threshold=THRESHOLD,
                                   error_residual=list(ts[3:]),
                                   name="grads")


def _sparse_step(fed, v, i):
    import horovod_tpu_torch as hvd

    fed.reset()
    out = []
    for f in FORMATS[1:]:
        s = hvd.allreduce_indexed_slices(hvd.IndexedSlices(v, i, (R, D)),
                                         average=False, compression=f,
                                         name=f"sp_{f}")
        out.append(s.to_dense())
    auto = hvd.allreduce_indexed_slices(hvd.IndexedSlices(v, i, (R, D)),
                                        average=True, algo="auto",
                                        compression="int8", name="sp_auto")
    out.append(auto.to_dense())
    return out


def _message(fn):
    import horovod_tpu_torch as hvd

    try:
        fn()
    except (hvd.HorovodError, NotImplementedError) as e:
        return f"{type(e).__name__}: {e}"
    return None


def _linear(seed: int):
    model = torch.nn.Linear(8, 3)
    with torch.no_grad():
        g = torch.Generator().manual_seed(seed)
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=g))
    return model


def _optimizer_state(rank: int, tmpdir: str, fed) -> dict:
    """DistributedOptimizer(int8_block, error_feedback=True) over SGD with
    momentum: 2 steps, then its state through state_dict, a checkpoint and
    broadcast_optimizer_state."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.training import checkpoint

    def build():
        model = _linear(0)
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9),
            compression="int8_block", error_feedback=True)
        return model, opt

    def step(model, opt, k):
        fed.reset()  # the same noise for the same step
        g = torch.Generator().manual_seed(100 * k + rank)
        x = torch.randn(16, 8, generator=g)
        opt.zero_grad()
        (model(x) ** 2).mean().backward()
        opt.step()

    model, opt = build()
    for k in range(2):
        step(model, opt, k)
    sd = opt.state_dict()
    out = {"keys": sorted(sd), "residual_nonzero": any(
        bool(r.abs().sum() > 0) for r in opt.residual.values())}
    twin, topt = build()
    twin.load_state_dict(model.state_dict())
    # torch's load_state_dict keeps the given tensors: load a copy, so the
    # two optimizers own their momenta.
    topt.load_state_dict(copy.deepcopy(sd))
    out["loaded_equal"] = all(torch.equal(a, topt.residual[i])
                              for i, a in opt.residual.items())
    step(model, opt, 2)
    step(twin, topt, 2)
    out["next_step_equal"] = all(torch.equal(a, b) for a, b in zip(
        model.parameters(), twin.parameters()))
    d = os.path.join(tmpdir, f"rank{rank}")
    checkpoint.save(d, {"optimizer": opt.state_dict()}, 0)
    back = checkpoint.load(d, {"optimizer": None, "epoch": 0}, group=0)
    out["checkpoint_equal"] = all(
        torch.equal(back["optimizer"]["residual"][i], r)
        for i, r in opt.residual.items())
    hvd.broadcast_optimizer_state(opt, root_rank=0)
    out["residual"] = {i: r.numpy().copy() for i, r in opt.residual.items()}
    out["plain_keys"] = sorted(hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1)).state_dict())
    return out


def _coo_dense(rank: int):
    """The COO route with sparse_algo='dense', in a program."""
    import horovod_tpu_torch as hvd

    vals, idx = _sparse()
    emb = torch.nn.Embedding(R, D, sparse=True)
    with torch.no_grad():
        emb.weight.copy_(torch.arange(R * D, dtype=torch.float32
                                      ).reshape(R, D))
    opt = hvd.DistributedOptimizer(torch.optim.SGD(emb.parameters(),
                                                   lr=0.5),
                                   sparse_algo="dense")

    def step(i, v):
        (emb(i.long()) * v).sum().backward()
        opt.step()
        return emb.weight.grad.to_dense()

    grad = hvd.spmd(step)(torch.from_numpy(idx[rank]),
                          torch.from_numpy(vals[rank]))
    return grad.numpy(), emb.weight.detach().numpy().copy()


def _port_world(tmpdir):
    import horovod_tpu_torch as hvd

    hvd.init([[0, 1, 2]], device="cpu")
    r = hvd.rank()
    fed = install_port_noise(r)
    out = {}
    for kind in ("int", "rand"):
        x = torch.from_numpy(_data(kind)[r])
        out[("allreduce", kind)] = [
            t.numpy() for t in hvd.spmd(
                lambda x: _allreduce_step(fed, x))(x)]
    for fmt in FORMATS:
        res = [torch.zeros(s) for s in SHAPES]
        steps = []
        for k in range(2):
            ts = [torch.from_numpy(g[r]) for g in _grads(k)]
            red, res = hvd.spmd(lambda *a: _gradients_step(fed, fmt, *a))(
                *ts, *res)
            steps.append(([t.numpy() for t in red],
                          [t.numpy() for t in res]))
        fed.reset()
        plain = hvd.allreduce_gradients(
            [torch.from_numpy(g[r]) for g in _grads(0)], compression=fmt,
            fusion_threshold=THRESHOLD, name="plain")
        out[("gradients", fmt)] = steps
        out[("plain", fmt)] = [t.numpy() for t in plain]
    vals, idx = _sparse()
    out["sparse"] = [t.numpy() for t in hvd.spmd(
        lambda v, i: _sparse_step(fed, v, i))(
        torch.from_numpy(vals[r]), torch.from_numpy(idx[r]))]
    out["optimizer"] = _optimizer_state(r, tmpdir, fed)
    out["coo_dense"] = _coo_dense(r)
    x = torch.ones(6)
    s = hvd.IndexedSlices(torch.ones(2, D), torch.zeros(2, dtype=torch.int32),
                          (R, D))
    out["errors"] = {
        "eager_compression": _message(lambda: hvd.allreduce(
            x, compression="int8", name="e1")),
        "eager_cross": _message(lambda: hvd.allreduce(
            x, cross_compression="int4", name="e2")),
        "eager_algo": _message(lambda: hvd.allreduce(
            x, algo="rs_ag", name="e3")),
        "eager_channels": _message(lambda: hvd.allreduce(
            x, channels=2, name="e4")),
        "eager_sparse": _message(lambda: hvd.allreduce_indexed_slices(
            s, compression="int4", name="e5")),
        "unknown": _message(lambda: hvd.spmd(lambda x: hvd.allreduce(
            x, compression="int5", name="e6"))(x)),
        "cross_int8": _message(lambda: hvd.spmd(lambda x: hvd.allreduce(
            x, compression="int8", cross_compression="int4",
            algo="flat", name="e7"))(x)),
        "residual_subset": _message(lambda: hvd.spmd(
            lambda x: hvd.allreduce_gradients(
                [x.clone()], group=1, compression="int8",
                error_residual=[torch.zeros(6)]))(x)),
    }
    out["after"] = float(hvd.allreduce(torch.ones(1), name="after"))
    return out


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    from horovod_tpu_torch.run import run

    return run(_port_world, WORLD, device="cpu", timeout=240,
               args=(str(tmp_path_factory.mktemp("ef")),))


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
def jax_side(jhvd):
    import jax.numpy as jnp

    res = {}
    with jax_noise() as fed:
        for kind in ("int", "rand"):
            def step(x):
                fed.reset()
                return [jhvd.allreduce(x, average=False, name=f"ar_{f}",
                                       compression=f) for f in FORMATS]
            res[("allreduce", kind)] = [
                np.asarray(t) for t in jhvd.spmd(step)(_data(kind))]
        for fmt in FORMATS:
            def gstep(*ts):
                fed.reset()
                return jhvd.allreduce_gradients(
                    list(ts[:3]), compression=fmt,
                    fusion_threshold=THRESHOLD, error_residual=list(ts[3:]))
            resid = [np.zeros((WORLD,) + s, np.float32) for s in SHAPES]
            steps = []
            for k in range(2):
                red, resid = jhvd.spmd(gstep)(*_grads(k), *resid)
                resid = [np.asarray(t) for t in resid]
                steps.append(([np.asarray(t) for t in red], resid))
            res[("gradients", fmt)] = steps
        vals, idx = _sparse()

        def sstep(v, i):
            fed.reset()
            out = []
            for f in FORMATS[1:]:
                s = jhvd.allreduce_indexed_slices(
                    jhvd.IndexedSlices(v, i, (R, D)), average=False,
                    compression=f, name=f"sp_{f}")
                out.append(s.to_dense())
            auto = jhvd.allreduce_indexed_slices(
                jhvd.IndexedSlices(v, i, (R, D)), average=True,
                algo="auto", compression="int8", name="sp_auto")
            out.append(auto.to_dense())
            return out

        res["sparse"] = [np.asarray(t) for t in jhvd.spmd(sstep)(vals, idx)]

    def coo(v, i):
        return jhvd.allreduce_gradients(
            {"w": jhvd.IndexedSlices(v, i, (R, D))},
            sparse_algo="dense")["w"].to_dense()

    res["coo_dense"] = np.asarray(jhvd.spmd(coo)(vals, idx))
    x = jnp.ones(6)
    one = jhvd.IndexedSlices(jnp.ones((2, D)), jnp.zeros(2, jnp.int32),
                             (R, D))
    xs = np.ones((WORLD, 6), np.float32)
    res["errors"] = {
        "eager_compression": _jax_message(jhvd, lambda: jhvd.allreduce(
            x, compression="int8", name="e1")),
        "eager_cross": _jax_message(jhvd, lambda: jhvd.allreduce(
            x, cross_compression="int4", name="e2")),
        "eager_algo": _jax_message(jhvd, lambda: jhvd.allreduce(
            x, algo="rs_ag", name="e3")),
        "eager_channels": _jax_message(jhvd, lambda: jhvd.allreduce(
            x, channels=2, name="e4")),
        "eager_sparse": _jax_message(jhvd, lambda: jhvd.
                                     allreduce_indexed_slices(
                                         one, compression="int4",
                                         name="e5")),
        "unknown": _jax_message(jhvd, lambda: jhvd.spmd(
            lambda x: jhvd.allreduce(x, compression="int5",
                                     name="e6"))(xs)),
        "cross_int8": _jax_message(jhvd, lambda: jhvd.spmd(
            lambda x: jhvd.allreduce(x, compression="int8",
                                     cross_compression="int4",
                                     algo="flat", name="e7"))(xs)),
        "residual_subset": _jax_message(jhvd, lambda: jhvd.spmd(
            lambda x: jhvd.allreduce_gradients(
                [x], group=1, compression="int8",
                error_residual=[jnp.zeros(6)]))(xs)),
    }
    return res


# -- the collectives ----------------------------------------------------------


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("kind", ["int", "rand"])
def test_allreduce_in_a_program_matches_jax(port, jax_side, kind, fmt):
    j = FORMATS.index(fmt)
    want = jax_side[("allreduce", kind)][j]
    for r in range(WORLD):
        got = port[r][("allreduce", kind)][j]
        assert got.dtype == want[r].dtype
        if kind == "rand" and fmt in ("none", "bf16"):
            # gloo and XLA sum the 4 ranks' values in their own orders:
            # each of the 3 additions rounds to within half an ulp of
            # sum|x| (2^-24 in fp32, 2^-8 in bf16).
            ulp = 2.0 ** (-24 if fmt == "none" else -8)
            tol = 3 * ulp * np.abs(_data(kind)).sum(0)
            assert np.all(np.abs(got - want[r]) <= tol)
        else:
            np.testing.assert_array_equal(got, want[r])


@pytest.mark.parametrize("fmt", FORMATS)
def test_gradients_and_error_feedback_residuals_match_jax(port, jax_side,
                                                          fmt):
    """Two steps of allreduce_gradients(error_residual=...): the reduced
    gradients and each rank's residuals, bit for bit."""
    want = jax_side[("gradients", fmt)]
    for r in range(WORLD):
        got = port[r][("gradients", fmt)]
        carried = [np.zeros(sh, np.float32) for sh in SHAPES]
        for k, ((gred, gres), (wred, wres)) in enumerate(zip(got, want)):
            for j, (g, w) in enumerate(zip(gred, wred)):
                np.testing.assert_array_equal(
                    g, w[r], err_msg=f"rank {r} step {k} gradient {j}")
            for j, (g, w) in enumerate(zip(gres, wres)):
                # residual = x - levels * unit, with the levels equal (the
                # gradients are): XLA's CPU code fuses the product into
                # the difference for some elements of a tensor and not
                # others (by its vector layout), the port everywhere, so
                # each step adds at most one rounding of
                # |x| + |levels * unit| <= 2 |x| + |residual| to the
                # difference its contribution x carried in.
                x = np.abs(_grads(k)[j][r]
                           + (want[k - 1][1][j][r] if k else 0))
                tol = np.spacing(2 * x + np.abs(w[r])) + carried[j]
                diff = np.abs(g - w[r])
                assert np.all(diff <= tol), (r, k, j)
                carried[j] = diff
        if fmt == "none":
            assert all(not np.any(t) for t in got[1][1])
        # Step 1's residual is zero, so its reduction is the plain one.
        for g, p in zip(got[0][0], port[r][("plain", fmt)]):
            np.testing.assert_array_equal(g, p)


@pytest.mark.parametrize("j", range(len(FORMATS)))
def test_compressed_sparse_payload_and_auto_match_jax(port, jax_side, j):
    """bf16/int8/int8_block/int4 value payloads in gather form, then the
    density switch with an int8 payload, merged dense, bit for bit."""
    for r in range(WORLD):
        np.testing.assert_array_equal(port[r]["sparse"][j],
                                      jax_side["sparse"][j][r])


def test_coo_gradient_with_sparse_algo_dense_matches_jax(port, jax_side):
    vals, idx = _sparse()
    w0 = np.arange(R * D, dtype=np.float32).reshape(R, D)
    for r in range(WORLD):
        grad, weight = port[r]["coo_dense"]
        np.testing.assert_array_equal(grad, jax_side["coo_dense"][r])
        np.testing.assert_allclose(weight, w0 - 0.5 * grad, rtol=1e-6)


@pytest.mark.parametrize("key", ["eager_compression", "eager_cross",
                                 "eager_algo", "eager_channels",
                                 "eager_sparse", "unknown", "cross_int8",
                                 "residual_subset"])
def test_refusals_match_jax(port, jax_side, key):
    for r in range(WORLD):
        assert port[r]["errors"][key] == jax_side["errors"][key], r


def test_error_feedback_state_round_trips(port):
    """state_dict holds inner and residual; load_state_dict, a checkpoint
    and the next step restore it bit for bit; broadcast_optimizer_state
    hands every rank rank 0's residuals; without error feedback the
    state_dict is the inner optimizer's."""
    for r in range(WORLD):
        o = port[r]["optimizer"]
        assert o["keys"] == ["inner", "residual"]
        assert o["residual_nonzero"]
        assert o["loaded_equal"] and o["next_step_equal"]
        assert o["checkpoint_equal"]
        assert o["plain_keys"] == ["param_groups", "state"]
        for i, v in o["residual"].items():
            np.testing.assert_array_equal(v, port[0]["optimizer"]
                                          ["residual"][i])


def test_the_world_survives_refusals(port):
    for r in range(WORLD):
        assert port[r]["after"] == 1.0


# -- single-process: each compressor against the JAX one ------------------------


def _pair(name, block=None):
    from horovod_tpu.ops import compression as jc
    from horovod_tpu_torch.ops import compression as tc

    if block is None:
        return jc.resolve(name), tc.resolve(name)
    cls = {"int8_block": "Int8BlockCompressor", "int4": "Int4Compressor"}
    return getattr(jc, cls[name])(block), getattr(tc, cls[name])(block)


def _contexts(sum_width=None):
    from horovod_tpu.ops import compression as jc
    from horovod_tpu_torch.ops import compression as tc

    return (jc.WireContext(group_size=4, sum_width=sum_width),
            tc.WireContext(group_size=4, sum_width=sum_width))


@pytest.fixture
def fed(monkeypatch):
    from torch_wire_support import PortNoise

    from horovod_tpu_torch.ops import compression as tc

    port_fed = PortNoise(0)
    monkeypatch.setattr(tc, "_uniform", port_fed)
    with jax_noise(traced=False) as jfed:
        yield port_fed, jfed


def _unit_cases():
    rng = np.random.RandomState(3)
    heavy = rng.standard_cauchy(700).astype(np.float32)
    return {"int": rng.randint(-20, 21, 700).astype(np.float32),
            "normal": rng.randn(700).astype(np.float32),
            "heavy": heavy,
            "zero": np.zeros(300, np.float32),
            "matrix": rng.randn(9, 13).astype(np.float32)}


@pytest.mark.parametrize("case", sorted(_unit_cases()))
@pytest.mark.parametrize("name", ["bf16", "int8", "int8_block", "int4"])
def test_compress_and_decompress_match_jax(fed, name, case):
    """Against the JAX compressor compiled, as it runs in the reference's
    programs (XLA takes a division by a constant as a product by its
    reciprocal, and fuses a product into the sum that follows it)."""
    import jax
    import jax.numpy as jnp

    jcomp, tcomp = _pair(name, 64 if name in ("int8_block", "int4")
                         else None)
    jctx, tctx = _contexts()
    x = _unit_cases()[case]

    def jax_fn(x):
        w, m = jcomp.compress(x, jctx)
        unit = m[0] if isinstance(m, tuple) else m
        return w, unit, jcomp.decompress(w, m, jnp.float32, jctx)

    jw, ju, jd = jax.jit(jax_fn)(jnp.asarray(x))
    tw, tm = tcomp.compress(torch.from_numpy(x), tctx)
    tu = tm[0] if isinstance(tm, tuple) else tm
    assert str(tw.dtype).removeprefix("torch.") == np.asarray(jw).dtype.name
    got_w, want_w = tw.float().numpy(), np.asarray(jw).astype(np.float32)
    if tu is not None:
        ju = np.asarray(ju)
        tu = tu.numpy()
        # XLA's CPU runtime flushes subnormals to zero: an all-zero
        # block's unit (tiny / qcap) reads 0 there, so 0 / 0 quantizes a
        # NaN, which XLA converts to byte 0 (int4 packs level 0 as 0x88);
        # the port keeps the subnormal unit, as the card does. Those
        # blocks' dequantized values agree, and are compared below.
        flushed = (ju == 0) & (tu > 0) & (tu < np.finfo(np.float32).tiny)
        np.testing.assert_array_equal(np.where(flushed, 0, tu), ju)
        if name == "int4" and flushed.any():
            rows = np.broadcast_to(flushed.reshape(-1, 1), want_w.shape)
            got_w, want_w = got_w[~rows], want_w[~rows]
    np.testing.assert_array_equal(got_w, want_w)
    np.testing.assert_array_equal(
        tcomp.decompress(tw, tm, torch.float32, tctx).numpy(),
        np.asarray(jd))


@pytest.mark.parametrize("name", ["bf16", "int8", "int8_block", "int4"])
def test_gathered_rows_and_sum_match_jax(fed, name):
    """Three ranks' payloads (sum_width=1: local scales) through the
    gather-form reductions, the JAX side compiled."""
    import jax
    import jax.numpy as jnp

    jcomp, tcomp = _pair(name, 32 if name in ("int8_block", "int4")
                         else None)
    xs = np.random.RandomState(4).randn(3, 7, 11).astype(np.float32)
    jctx, tctx = _contexts(sum_width=1)

    def run(comp, ctx, parts, stack, dtype, reduce):
        fields = [[w] + ([] if m is None else
                         [m[0]] if isinstance(m, tuple) else [m])
                  for w, m in parts]
        box = {"k": 0}

        def gfn(a):
            k = box["k"]
            box["k"] += 1
            return stack([f[k].reshape(a.shape) for f in fields])

        return getattr(comp, reduce)(gfn, *parts[0], dtype, ctx)

    reduces = ["gathered_rows"] + (["gathered_sum"] if name == "int4"
                                   else [])
    for reduce in reduces:
        def jax_fn(xs):
            parts = [jcomp.compress(xs[i], jctx) for i in range(3)]
            return run(jcomp, jctx, parts, jnp.stack, jnp.float32, reduce)

        want = np.asarray(jax.jit(jax_fn)(jnp.asarray(xs)))
        tparts = [tcomp.compress(torch.from_numpy(x), tctx) for x in xs]
        got = run(tcomp, tctx, tparts, torch.stack, torch.float32, reduce)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", ["none", "bf16", "int8", "int8_block",
                                  "int4"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
def test_wire_dtype_and_bytes_match_jax(name, dtype):
    import jax.numpy as jnp

    from horovod_tpu.ops import compression as jc
    from horovod_tpu_torch.ops import compression as tc

    jcomp, tcomp = jc.resolve(name), tc.resolve(name)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    for sw in (None, 1, 4, 200):
        assert (str(tc.wire_dtype_of(tcomp, tdt, sw)).removeprefix("torch.")
                == np.dtype(jc.wire_dtype_of(jcomp, jdt, sw)).name)
        for n in (1, 255, 1001):
            assert tc.wire_bytes(n, tdt, tcomp, sw) == \
                jc.wire_bytes(n, jdt, jcomp, sw)
    assert tcomp.applies_to(tdt) == jcomp.applies_to(jdt)


def test_resolve_and_phase_formats_match_jax():
    from horovod_tpu.ops import compression as jc
    from horovod_tpu_torch.ops import compression as tc

    assert tc.registered_names() == jc.registered_names()
    for spec in ("bf16", " INT8 ", "int8_block", "int4", "none"):
        assert tc.resolve(spec).name == jc.resolve(spec).name
    for spec in ("int5", 3):
        with pytest.raises(Exception) as want:
            jc.resolve(spec)
        with pytest.raises(Exception) as got:
            tc.resolve(spec)
        assert str(got.value) == str(want.value)

    def names(t):
        return tuple(None if c is None else c.name for c in t[:2]) + (t[2],)

    for comp in (None, "bf16", "int8", "int8_block", "int4"):
        for cross in (None, "none", "int4", "int8_block"):
            jcomp = None if comp is None else jc.resolve(comp)
            tcomp = None if comp is None else tc.resolve(comp)
            try:
                want = names(jc.resolve_phase_formats(jcomp, cross))
            except Exception as e:
                with pytest.raises(Exception) as got:
                    tc.resolve_phase_formats(tcomp, cross)
                assert str(got.value) == str(e)
                continue
            assert names(tc.resolve_phase_formats(tcomp, cross)) == want


@pytest.mark.parametrize("width,want", [(1, (127, "int8")), (4, (31, "int8")),
                                        (127, (1, "int8")),
                                        (128, (255, "int16")),
                                        (32767, (1, "int16"))])
def test_block_budget_matches_jax(width, want):
    from horovod_tpu.ops import compression as jc
    from horovod_tpu_torch.ops import compression as tc

    q, dt = tc.Int8BlockCompressor.sum_budget(width)
    jq, jdt = jc.Int8BlockCompressor.sum_budget(width)
    assert (q, str(dt).removeprefix("torch.")) == want == \
        (jq, np.dtype(jdt).name)


@pytest.mark.parametrize("case", ["int8_128", "block_32768", "block_odd",
                                  "block_small"])
def test_refusals_of_the_compressors_match_jax(case):
    import jax.numpy as jnp

    from horovod_tpu.ops import compression as jc
    from horovod_tpu_torch.ops import compression as tc

    def run(mod, arr):
        if case == "int8_128":
            return mod.Int8Compressor().compress(
                arr(np.ones(8, np.float32)),
                mod.WireContext(group_size=128))
        if case == "block_32768":
            return mod.Int8BlockCompressor.sum_budget(32768)
        return getattr(mod, "Int4Compressor")(
            7 if case == "block_odd" else 6)

    with pytest.raises(Exception) as want:
        run(jc, jnp.asarray)
    with pytest.raises(Exception) as got:
        run(tc, torch.from_numpy)
    assert type(got.value).__name__ == type(want.value).__name__
    assert str(got.value) == str(want.value)


def test_int4_pack_unpack_round_trip_matches_jax():
    import jax.numpy as jnp

    from horovod_tpu.ops import compression as jc
    from horovod_tpu_torch.ops import compression as tc

    q = np.arange(-7, 8, dtype=np.float32)
    q = np.tile(q, 4)[:56].reshape(4, 14)
    tw = tc.Int4Compressor._pack(torch.from_numpy(q))
    jw = jc.Int4Compressor._pack(jnp.asarray(q))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(tc.Int4Compressor._unpack(tw).numpy(), q)


# -- single-process: the port's own noise stream --------------------------------


def _ctx(**kw):
    from horovod_tpu_torch.ops import compression as tc

    return tc.WireContext(group_size=kw.pop("group_size", 1), **kw)


def test_the_stream_is_uniform_deterministic_and_keyed():
    from horovod_tpu_torch.ops import compression as tc

    x = torch.zeros(4096)
    u = tc._uniform(x, _ctx(key=7))
    assert u.dtype == torch.float32 and u.shape == x.shape
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
    assert abs(float(u.mean()) - 0.5) < 0.02
    np.testing.assert_array_equal(u.numpy(),
                                  tc._uniform(x, _ctx(key=7)).numpy())
    # The key, a tensor key, the rank and the data each move the stream.
    assert torch.equal(u, tc._uniform(x, _ctx(
        key=torch.tensor(7, dtype=torch.int64))))
    assert not torch.equal(u, tc._uniform(x, _ctx(key=8)))
    assert not torch.equal(u, tc._uniform(x, _ctx(key=7, rank_data=1)))
    assert not torch.equal(tc._uniform(x, _ctx()),
                           tc._uniform(x + 1, _ctx()))
    # Top 24 bits: every value is a multiple of 2^-24.
    assert torch.equal(u * 2 ** 24, torch.floor(u * 2 ** 24))


@pytest.mark.parametrize("name", ["int8", "int8_block", "int4"])
def test_rounding_is_unbiased_on_the_ports_stream(name):
    """The reference's test on the port's stream: over K = 512 keys the
    mean of decompress(compress(x)) is within 6 standard errors
    (unit / sqrt(12 K)) of x, element by element, and the overall mean
    within one."""
    from horovod_tpu_torch.ops import compression as tc

    comp = tc.resolve(name) if name == "int8" else (
        tc.Int8BlockCompressor(16) if name == "int8_block"
        else tc.Int4Compressor(16))
    x = torch.from_numpy(np.random.RandomState(0).uniform(-1, 1, 64)
                         .astype(np.float32))
    K = 512
    outs, unit = [], None
    for k in range(K):
        ctx = _ctx(group_size=8, key=k)
        w, m = comp.compress(x, ctx)
        unit = m if name == "int8" else m[0].repeat_interleave(comp.block)
        outs.append(comp.decompress(w, m, torch.float32, ctx))
    outs = torch.stack(outs)
    assert torch.all((outs - x).abs() <= unit * (1 + 1e-6))
    stderr = unit / np.sqrt(12 * K)
    assert torch.all((outs.mean(0) - x).abs() <= 6 * stderr + 1e-7)
    assert abs(float(outs.mean() - x.mean())) < float(stderr.max())


@pytest.mark.parametrize("name", ["int8", "int8_block", "int4"])
def test_bounds_zero_buckets_and_determinism_on_the_ports_stream(name):
    from horovod_tpu_torch.ops import compression as tc

    comp = tc.resolve(name)
    x = torch.from_numpy(np.random.RandomState(7).standard_cauchy(1000)
                         .astype(np.float32))
    ctx = _ctx(group_size=4, key=3)
    w, m = comp.compress(x, ctx)
    again, _ = comp.compress(x, ctx)
    assert torch.equal(w, again)
    if name == "int4":
        q = tc.Int4Compressor._unpack(w)
        assert float(q.abs().max()) <= 7
    else:
        assert int(w.abs().max()) <= 127 // 4
    deq = comp.decompress(w, m, torch.float32, ctx)
    unit = m if name == "int8" else m[0].repeat_interleave(comp.block)[
        :1000]
    assert torch.all((deq - x).abs() <= unit * (1 + 1e-6))
    zw, zm = comp.compress(torch.zeros(300), ctx)
    levels = tc.Int4Compressor._unpack(zw) if name == "int4" else zw
    assert not levels.any()
    assert not comp.decompress(zw, zm, torch.float32, ctx).any()


def test_a_data_key_moves_each_step_and_a_tensor_key_needs_no_host():
    """Without a key the noise comes from the bucket's bits; a 0-d int64
    tensor key gives the noise of the same int key."""
    from horovod_tpu_torch.ops import compression as tc

    comp = tc.resolve("int8")
    x = torch.linspace(-1, 1, 513)
    a, _ = comp.compress(x, _ctx(group_size=2))
    b, _ = comp.compress(x * 1.001, _ctx(group_size=2))
    assert not torch.equal(a, b)
    k1, _ = comp.compress(x, _ctx(group_size=2, key=11))
    k2, _ = comp.compress(x, _ctx(group_size=2,
                                  key=torch.tensor(11, dtype=torch.int64)))
    assert torch.equal(k1, k2)


def test_fed_noise_is_deterministic_per_call_and_rank():
    a = fed_noise(3, 1, (5, 4))
    assert a.dtype == np.float32 and a.shape == (5, 4)
    np.testing.assert_array_equal(a, fed_noise(3, 1, (5, 4)))
    assert not np.array_equal(a, fed_noise(3, 2, (5, 4)))

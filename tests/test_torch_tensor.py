"""Port parity: tensor parallelism (``parallel/tensor.py``: the sharded
matmuls, Megatron's f and g operators, the sequence-parallel MLP and
head-sharded attention) against ``horovod_tpu``'s.

One spawned 4-rank gloo world (module-scoped), ``hvd.init([[0, 1], [2, 3],
[0, 2], [1, 3], [3]])``: the TP family ``(1, 2)`` (two TP pairs), the DP
family ``(3, 4)``, and group 5 for a family of unequal groups. The JAX
side runs the same numpy inputs (float32, made from a seed) over 4 CPU
devices under ``hvd.spmd`` with the same groups.
Every case runs in one program on each side; outputs and gradients (of a
seeded cotangent, or of the JAX tests' ``sum(out ** 2)``) are held at the
JAX package's own tolerances (``tests/test_tensor_parallel.py``: 2e-4 for
the matmuls and MLPs, 3e-3 / 3e-2 for attention's output / gradients,
whose scores are bf16). Also: a two-step DP × TP train step, each
program's schedule against the reference's, every refusal text byte for
byte, and the shard-is-this-rank divergence.

The spawned children import this module, so JAX is imported only inside
the parent-side functions.
"""

import numpy as np
import pytest
import torch

WORLD = 4
GROUPS = [[0, 1], [2, 3], [0, 2], [1, 3], [3]]
TP, DP = (1, 2), (3, 4)
TOL = 2e-4
ATTN_TOL, ATTN_GRAD_TOL = 3e-3, 3e-2
B, T, E, F_DIM, HEADS = 2, 16, 8, 12, 4
D = E // HEADS * 2
# name: (causal, attn_impl on the port). The JAX side runs 'xla' (the same
# function; its flash body is the Pallas kernel in interpret mode).
ATTN_CASES = {"causal_xla": (True, "xla"), "noncausal_xla": (False, "xla"),
              "causal_flash": (True, "flash"),
              "noncausal_flash": (False, "flash")}
LR = 0.1


def _inputs():
    rng = np.random.RandomState(0)

    def n(*shape, s=0.5):
        return (rng.randn(*shape) * s).astype(np.float32)

    return {"x": n(B, T, E), "x2": n(4, E, s=1.0), "x0": n(4, 3, s=1.0),
            "w0": n(3, E, s=1.0), "w1": n(E, F_DIM, s=0.4),
            "b1": n(F_DIM, s=0.1), "w2": n(F_DIM, E, s=0.4),
            "b2": n(E, s=0.1), "wq": n(E, HEADS * D, s=0.4),
            "wk": n(E, HEADS * D, s=0.4), "wv": n(E, HEADS * D, s=0.4),
            "wo": n(HEADS * D, E, s=0.4), "g": n(B, T, E, s=1.0),
            "g2": n(4, E, s=1.0),
            "gsp": n(B, T // 2, E, s=1.0)}


def _train_data():
    """Per TP pair (= DP replica) a (4, 4) batch and (4, 2) targets, and
    the (4, 8) / (8, 2) weights."""
    rng = np.random.RandomState(1)
    return (rng.randn(4, 8).astype(np.float32) * 0.3,
            rng.randn(8, 2).astype(np.float32) * 0.3,
            rng.randn(2, 4, 4).astype(np.float32),
            rng.randn(2, 4, 2).astype(np.float32))


# -- the cases, written once for both sides -----------------------------------


def _cases(hvd, api, x, shard_c, shard_r):
    """(name, fn(*params) -> output, params) of every case: ``hvd`` is the
    port or the JAX package, ``api`` the framework's functions,
    ``shard_c``/``shard_r`` give this rank's column / row shard."""
    x_sp = api.seq_shard(x["x"])
    cases = {
        "column_row": (lambda w1, b1, w2: hvd.row_parallel(
            api.relu(hvd.column_parallel(x["x2"], w1, TP, b_shard=b1)),
            w2, TP, b=x["b2"], name="cr"),
            (shard_c(x["w1"]), shard_c(x["b1"]), shard_r(x["w2"]))),
        "upstream_f": (lambda w0: hvd.row_parallel(api.relu(
            hvd.column_parallel(x["x0"] @ w0, shard_c(x["w1"]), TP)),
            shard_r(x["w2"]), TP), (x["w0"],)),
        "tp_mlp": (lambda w1, b1, w2, b2: hvd.tp_mlp(
            x["x"], w1, b1, w2, b2, TP, name="mlp"),
            (shard_c(x["w1"]), shard_c(x["b1"]), shard_r(x["w2"]),
             x["b2"])),
        "tp_mlp_sp": (lambda w1, b1, w2, b2: hvd.tp_mlp_sp(
            x_sp, w1, b1, w2, b2, TP, name="sp"),
            (shard_c(x["w1"]), shard_c(x["b1"]), shard_r(x["w2"]),
             x["b2"])),
    }
    # The activation among the parameters: the f operators' backward
    # collectives run.
    cases["tp_mlp_dx"] = (lambda xx, w1, w2: hvd.tp_mlp(
        xx, w1, None, w2, None, TP, name="mlpx"),
        (x["x"], shard_c(x["w1"]), shard_r(x["w2"])))
    cases["attn_dx"] = (lambda xx, wq, wo: hvd.tp_attention(
        xx, wq, wq, wq, wo, TP, num_heads=HEADS, attn_impl="xla",
        name="attnx"), (x["x"], shard_c(x["wq"]), shard_r(x["wo"])))
    for name, (causal, _impl) in ATTN_CASES.items():
        cases["attn_" + name] = (
            lambda wq, wk, wv, wo, causal=causal, name=name:
            hvd.tp_attention(x["x"], wq, wk, wv, wo, TP, num_heads=HEADS,
                             causal=causal, attn_impl=api.impl(name),
                             name="attn"),
            tuple(shard_c(x[k]) for k in ("wq", "wk", "wv"))
            + (shard_r(x["wo"]),))
    return cases


def _cotangent(x, name):
    if name.startswith("attn"):
        return x["g"]
    return {"column_row": x["g2"], "upstream_f": x["g2"],
            "tp_mlp_sp": x["gsp"]}.get(name, x["g"])


# -- the port's world -----------------------------------------------------------


class _TorchApi:
    relu = staticmethod(torch.relu)
    tp_rank = 0

    @staticmethod
    def impl(name):
        return ATTN_CASES[name][1]

    @classmethod
    def seq_shard(cls, x):
        """This rank's half of the sequence within its TP pair."""
        half = T // 2
        return x[:, cls.tp_rank * half:(cls.tp_rank + 1) * half]


def _message(fn):
    import horovod_tpu_torch as hvd

    try:
        fn()
    except hvd.HorovodError as e:
        return f"{type(e).__name__}: {e}"
    return None


def _port_cases(hvd, r):
    x = {k: torch.from_numpy(v) for k, v in _inputs().items()}
    _TorchApi.tp_rank = r % 2
    cases = _cases(hvd, _TorchApi, x, lambda w: hvd.shard_columns(w, TP),
                   lambda w: hvd.shard_rows(w, TP))
    out = {}
    for name, (fn, params) in cases.items():
        def prog(*params, fn=fn, name=name):
            params = [p.clone().requires_grad_(True) for p in params]
            y = fn(*params)
            g = _cotangent(x, name)
            res = {"out": y.detach().numpy(),
                   "grads": [t.numpy() for t in torch.autograd.grad(
                       (y * g).sum(), params)],
                   "sq_grads": [t.numpy() for t in torch.autograd.grad(
                       (fn(*params) ** 2).sum(), params)]}
            return res

        p = hvd.spmd(prog)
        res = p(*params)
        res["schedule"] = [row[0] for row in
                           next(iter(p.programs.values())).schedule]
        out[name] = res
    return out


def _port_train(hvd, r):
    w1, w2, xs, ys = (torch.from_numpy(a) for a in _train_data())
    w1s, w2s = hvd.shard_columns(w1, TP), hvd.shard_rows(w2, TP)

    def step(w1s, w2s, xb, yb):
        w1s, w2s = (t.clone().requires_grad_(True) for t in (w1s, w2s))
        h = torch.relu(hvd.column_parallel(xb, w1s, TP))
        p = hvd.row_parallel(h, w2s, TP, name="rp")
        g1, g2 = torch.autograd.grad(((p - yb) ** 2).mean(), (w1s, w2s))
        g1 = hvd.allreduce(g1, group=DP, name="g1")
        g2 = hvd.allreduce(g2, group=DP, name="g2")
        return w1s.detach() - LR * g1, w2s.detach() - LR * g2

    prog = hvd.spmd(step)
    for _ in range(2):
        w1s, w2s = prog(w1s, w2s, xs[r // 2], ys[r // 2])
    return [w1s.numpy(), w2s.numpy()]


def _refusals(hvd):
    x = {k: torch.from_numpy(v) for k, v in _inputs().items()}
    return {name: _message(fn) for name, fn in _refusal_cases(
        hvd, x, torch.zeros, hvd.spmd).items()}


def _refusal_cases(hvd, x, zeros, spmd):
    """The refusal cases, the same closures on both sides."""
    w = zeros((E, 4))
    x3 = zeros((2, 4, E))
    return {
        "not_disjoint": lambda: hvd.shard_columns(w, (1, 3)),
        "unequal": lambda: hvd.shard_columns(w, (1, 5)),
        "cover": lambda: hvd.shard_columns(w, (1,)),
        "columns_divisible": lambda: hvd.shard_columns(zeros((4, 7)), TP),
        "rows_divisible": lambda: hvd.shard_rows(zeros((7, 4)), TP),
        "column_eager": lambda: hvd.column_parallel(x3, w, TP),
        "row_eager": lambda: hvd.row_parallel(x3, zeros((E, E)), TP),
        "attention_eager": lambda: hvd.tp_attention(
            x3, w, w, w, zeros((4, E)), TP, num_heads=2),
        "mlp_eager": lambda: hvd.tp_mlp(x3, w, None, zeros((4, E)), None,
                                        TP),
        "mlp_sp_eager": lambda: hvd.tp_mlp_sp(x3, w, None, zeros((4, E)),
                                              None, TP),
        "heads_divisible": lambda: spmd(lambda xs: hvd.tp_attention(
            xs, zeros((E, 3)), zeros((E, 3)), zeros((E, 3)),
            zeros((3, E)), TP, num_heads=3))(x3),
        "mlp_sp_cover": lambda: spmd(lambda xs: hvd.tp_mlp_sp(
            xs, zeros((E, 4)), None, zeros((4, E)), None, (1,)))(x3),
    }


def _port_world():
    import horovod_tpu_torch as hvd

    hvd.init(GROUPS, device="cpu")
    r = hvd.rank()
    w = torch.from_numpy(_inputs()["w1"])
    return {"cases": _port_cases(hvd, r), "train": _port_train(hvd, r),
            "errors": _refusals(hvd),
            "shards": [hvd.shard_columns(w, TP).numpy(),
                       hvd.shard_rows(w, TP).numpy()]}


@pytest.fixture(scope="module")
def port():
    from horovod_tpu_torch.run import run

    return run(_port_world, WORLD, device="cpu", timeout=300)


# -- the JAX side ---------------------------------------------------------------


@pytest.fixture(scope="module")
def jhvd():
    import jax

    import horovod_tpu as jhvd

    jhvd.shutdown()
    jhvd.init(GROUPS, devices=jax.devices()[:WORLD])
    yield jhvd
    jhvd.shutdown()


def _jax_schedule(wrapped):
    """The schedule rows' names of the one program ``jhvd.spmd`` compiled."""
    cell = wrapped.__closure__[wrapped.__code__.co_freevars.index(
        "schedules")]
    (sched,) = cell.cell_contents.values()
    return [row[0] for row in sched]


@pytest.fixture(scope="module")
def jax_cases(jhvd):
    import jax
    import jax.numpy as jnp

    from horovod_tpu.core import context as jctx

    class Api:
        relu = staticmethod(jax.nn.relu)

        @staticmethod
        def impl(name):
            return "xla"

        @staticmethod
        def seq_shard(x):
            half = T // 2
            return jax.lax.dynamic_slice_in_dim(
                x, (jctx.current().rank(0) % 2) * half, half, axis=1)

    x = {k: jnp.asarray(v) for k, v in _inputs().items()}
    out = {}
    for name in _port_case_names():
        def prog(_unused, name=name):
            fn, params = _cases(jhvd, Api, x,
                                lambda w: _rank_shard(jhvd, w, "c"),
                                lambda w: _rank_shard(jhvd, w, "r"))[name]
            y, vjp = jax.vjp(fn, *params)
            sq = jax.grad(lambda *p: jnp.sum(fn(*p) ** 2),
                          argnums=tuple(range(len(params))))(*params)
            return {"out": y, "grads": list(vjp(_cotangent(x, name))),
                    "sq_grads": list(sq)}

        wrapped = jhvd.spmd(prog)
        res = jax.tree.map(np.asarray, wrapped(np.zeros((WORLD, 1),
                                                        np.float32)))
        res["schedule"] = _jax_schedule(wrapped)
        out[name] = res
    return out


def _rank_shard(jhvd, w, kind):
    """This traced rank's shard of ``w`` from the reference's rank-stacked
    shards."""
    import jax.numpy as jnp

    from horovod_tpu.core import context as jctx

    stacked = (jhvd.shard_columns(w, TP) if kind == "c"
               else jhvd.shard_rows(w, TP))
    return jnp.take(stacked, jctx.current().rank(0), axis=0)


def _port_case_names():
    return ["column_row", "upstream_f", "tp_mlp", "tp_mlp_sp", "tp_mlp_dx",
            "attn_dx"] + ["attn_" + n for n in ATTN_CASES]


@pytest.fixture(scope="module")
def jax_train(jhvd):
    import jax
    import jax.numpy as jnp

    w1, w2, xs, ys = _train_data()
    w1s, w2s = jhvd.shard_columns(w1, TP), jhvd.shard_rows(w2, TP)
    xb = jhvd.rank_stack([xs[r // 2] for r in range(WORLD)])
    yb = jhvd.rank_stack([ys[r // 2] for r in range(WORLD)])

    @jhvd.spmd
    def step(w1s, w2s, xb, yb):
        def loss(w1s, w2s):
            h = jnp.maximum(jhvd.column_parallel(xb, w1s, TP), 0.0)
            p = jhvd.row_parallel(h, w2s, TP, name="rp")
            return jnp.mean((p - yb) ** 2)

        g1, g2 = jax.grad(loss, argnums=(0, 1))(w1s, w2s)
        g1 = jhvd.allreduce(g1, group=DP, name="g1")
        g2 = jhvd.allreduce(g2, group=DP, name="g2")
        return w1s - LR * g1, w2s - LR * g2

    for _ in range(2):
        w1s, w2s = step(w1s, w2s, xb, yb)
    return np.asarray(w1s), np.asarray(w2s)


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

    x = {k: jnp.asarray(v) for k, v in _inputs().items()}

    def spmd(fn):
        return lambda x3: jhvd.spmd(fn)(jhvd.replicate(x3))

    return {name: message(fn) for name, fn in _refusal_cases(
        jhvd, x, jnp.zeros, spmd).items()}


# -- the tests ---------------------------------------------------------------------


def _tols(name):
    if name.startswith("attn"):
        return ATTN_TOL, ATTN_GRAD_TOL
    return TOL, TOL


@pytest.mark.parametrize("name", _port_case_names())
def test_outputs_match_jax(port, jax_cases, name):
    tol, _ = _tols(name)
    for r, rank_out in enumerate(port):
        np.testing.assert_allclose(rank_out["cases"][name]["out"],
                                   jax_cases[name]["out"][r],
                                   rtol=tol, atol=tol)


@pytest.mark.parametrize("which", ["grads", "sq_grads"])
@pytest.mark.parametrize("name", _port_case_names())
def test_gradients_match_jax(port, jax_cases, name, which):
    """Each parameter's gradient on each rank: of a seeded cotangent, and
    of the JAX tests' ``sum(out ** 2)``."""
    _, tol = _tols(name)
    for r, rank_out in enumerate(port):
        got = rank_out["cases"][name][which]
        want = jax_cases[name][which]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, np.asarray(w)[r], rtol=tol,
                                       atol=tol)


def test_the_f_operator_gives_the_dense_upstream_gradient(port):
    """An upstream replicated parameter gets its dense gradient on every
    rank: the f operator's backward sums the column blocks' parts."""
    x = _inputs()
    w0 = torch.from_numpy(x["w0"]).requires_grad_(True)
    h = torch.relu(torch.from_numpy(x["x0"]) @ w0 @ torch.from_numpy(x["w1"]))
    p = h @ torch.from_numpy(x["w2"])
    (want,) = torch.autograd.grad((p ** 2).sum(), w0)
    for rank_out in port:
        np.testing.assert_allclose(rank_out["cases"]["upstream_f"][
            "sq_grads"][0], want.numpy(), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("name", _port_case_names())
def test_each_program_schedule_is_the_references(port, jax_cases, name):
    """The forward collectives and the backward ones (``name + '_bwd'``,
    auto names where the reference has none) in the reference's order."""
    want = jax_cases[name]["schedule"]
    for rank_out in port:
        got = rank_out["cases"][name]["schedule"]
        assert [n.rsplit("_", 1)[0] if n.startswith("Horovod") else n
                for n in got] == [n.rsplit("_", 1)[0]
                                  if n.startswith("Horovod") else n
                                  for n in want]


def test_named_backward_rows_are_named_like_the_reference(port):
    for rank_out in port:
        assert rank_out["cases"]["tp_mlp_dx"]["schedule"] == [
            "mlpx", "mlpx_col_bwd"]
        assert rank_out["cases"]["tp_mlp_sp"]["schedule"] == [
            "sp_ag", "sp", "sp_bwd"]
        assert rank_out["cases"]["attn_dx"]["schedule"] == [
            "attnx", "attnx_qkv_bwd"]


def test_two_step_dp_x_tp_train_step_matches_jax(port, jax_train):
    for r, rank_out in enumerate(port):
        for got, want in zip(rank_out["train"], jax_train):
            np.testing.assert_allclose(got, want[r], rtol=TOL, atol=TOL)


def test_dp_replicas_hold_identical_shards(port):
    for r in (2, 3):
        for a, b in zip(port[r]["train"], port[r - 2]["train"]):
            np.testing.assert_array_equal(a, b)


REFUSALS = ("not_disjoint", "unequal", "cover", "columns_divisible",
            "rows_divisible", "column_eager", "row_eager",
            "attention_eager", "mlp_eager", "mlp_sp_eager",
            "heads_divisible", "mlp_sp_cover")


@pytest.mark.parametrize("case", REFUSALS)
def test_refusals_are_the_references_text(port, jax_refusals, case):
    want = jax_refusals[case]
    assert want is not None
    for rank_out in port:
        assert rank_out["errors"][case] == want


def test_a_shard_is_this_ranks_row_of_the_references_stack(port, jhvd):
    """``shard_columns``/``shard_rows`` return this rank's shard (a process
    is a rank), the row of the reference's rank-stacked array."""
    w = _inputs()["w1"]
    cols = np.asarray(jhvd.shard_columns(w, TP))
    rows = np.asarray(jhvd.shard_rows(w, TP))
    assert cols.shape == (WORLD, E, F_DIM // 2)
    for r, rank_out in enumerate(port):
        np.testing.assert_array_equal(rank_out["shards"][0], cols[r])
        np.testing.assert_array_equal(rank_out["shards"][1], rows[r])
        assert rank_out["shards"][0].shape == (E, F_DIM // 2)

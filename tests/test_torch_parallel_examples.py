"""Port parity: the reference's three parallelism examples,
``tp_transformer``, ``moe_transformer`` and ``parallelism_zoo``, in one
spawned 8-rank gloo world (module-scoped), at the examples' small
defaults.

* ``tp_transformer`` and ``moe_transformer``: each rank's first loss on
  the reference example's weights (drawn with ``jax.random`` as the
  reference draws them, carried by the port example's
  ``from_jax_params``) against the reference example's loss function
  (written here from the JAX package's functions, as the example writes
  it inside its ``main``) over 8 CPU devices, within 1e-4 relative; then
  the port example's ``main``, whose losses must fall (the reference's own
  assertion, kept in the port's ``main``).
* ``parallelism_zoo``: every mode runs (TP at 8 ranks), its TP and PP
  errors against dense and sequential under 1e-5, and the reference's
  closing line.

The spawned children import this module, so JAX is imported only inside
the parent-side functions.
"""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

WORLD = 8
REPO = pathlib.Path(__file__).resolve().parents[1]
LOSS_RTOL = 1e-4
# tp_transformer's defaults
TP_ARGS = dict(seq_len=32, batch=2, embed=64, mlp=128, heads=4, vocab=128)
# moe_transformer's defaults
MOE_ARGS = dict(seq_len=64, batch=2, embed=64, mlp=128, heads=4, vocab=256,
                aux=0.01)


def _tp_tokens():
    rng = np.random.RandomState(0)
    per_pair = [rng.randint(0, TP_ARGS["vocab"],
                            (TP_ARGS["batch"], TP_ARGS["seq_len"]))
                for _ in range(WORLD // 2)]
    return np.stack([per_pair[r // 2] for r in range(WORLD)])


def _moe_tokens():
    return np.random.RandomState(0).randint(
        0, MOE_ARGS["vocab"], (WORLD, MOE_ARGS["batch"], MOE_ARGS["seq_len"]))


# -- the port's world ---------------------------------------------------------


def _port_world(tp_params, moe_params):
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.examples import moe_transformer as moe
    from horovod_tpu_torch.examples import parallelism_zoo as zoo
    from horovod_tpu_torch.examples import tp_transformer as tp

    out = {}
    hvd.init(tp.TP_GROUPS + tp.DP_GROUPS, device="cpu")
    r = hvd.rank()
    rep, shd = tp.split(tp.from_jax_params(tp_params), tp.TP_FAMILY)
    tokens = torch.from_numpy(_tp_tokens()[r])
    out["tp_first"] = float(hvd.spmd(lambda t: tp.loss_fn(
        rep, shd, t, TP_ARGS["heads"]))(tokens))
    hvd.shutdown()
    out["tp_main"] = tp.main(["--device", "cpu"])
    hvd.shutdown()

    hvd.init(device="cpu")
    rep, exp = moe.from_jax_params(*moe_params, hvd.rank())
    tokens = torch.from_numpy(_moe_tokens()[r])
    out["moe_first"] = float(hvd.spmd(lambda t: moe.loss_fn(
        rep, exp, t, MOE_ARGS["heads"], MOE_ARGS["aux"]))(tokens))
    hvd.shutdown()
    out["moe_main"] = moe.main(["--device", "cpu"])
    hvd.shutdown()

    out["zoo"] = zoo.main(["--device", "cpu"])
    return out


# -- the reference examples' weights and losses --------------------------------


def _jax_tp_params():
    """The reference example's draws (``examples/tp_transformer.py``)."""
    import jax

    a = TP_ARGS
    e, f, d_head = a["embed"], a["mlp"], a["embed"] // a["heads"]
    ks = jax.random.split(jax.random.PRNGKey(0), 8)
    shapes = [("embed", (a["vocab"], e)), ("out", (e, a["vocab"])),
              ("wq", (e, a["heads"] * d_head)),
              ("wk", (e, a["heads"] * d_head)),
              ("wv", (e, a["heads"] * d_head)),
              ("wo", (a["heads"] * d_head, e)), ("w1", (e, f)),
              ("w2", (f, e))]
    return {name: np.asarray(jax.random.normal(k, s) * 0.02)
            for k, (name, s) in zip(ks, shapes)}


def _ref_moe_module():
    spec = importlib.util.spec_from_file_location(
        "reference_moe_transformer", REPO / "examples" / "moe_transformer.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def params():
    import jax

    a = MOE_ARGS
    rep, experts = _ref_moe_module().init_params(
        jax.random.PRNGKey(0), a["vocab"], a["embed"], a["mlp"], a["heads"],
        WORLD, WORLD)
    moe = (jax.tree.map(np.asarray, rep), jax.tree.map(np.asarray, experts))
    return _jax_tp_params(), moe


@pytest.fixture(scope="module")
def port(params):
    from horovod_tpu_torch.run import run

    return run(_port_world, WORLD, device="cpu", timeout=300, args=params)


@pytest.fixture(scope="module")
def jax_losses(params):
    import jax
    import jax.numpy as jnp
    import optax

    import horovod_tpu as jhvd
    from horovod_tpu.parallel.sequence import local_attention

    tp_params, (mrep, mexp) = params
    tp_family = (1, 2, 3, 4)
    jhvd.shutdown()
    jhvd.init([[0, 1], [2, 3], [4, 5], [6, 7], [0, 2, 4, 6], [1, 3, 5, 7]],
              devices=jax.devices()[:WORLD])
    try:
        rep = {k: tp_params[k] for k in ("embed", "out")}
        shd = {k: (jhvd.shard_columns if k in ("wq", "wk", "wv", "w1")
                   else jhvd.shard_rows)(tp_params[k], tp_family)
               for k in ("wq", "wk", "wv", "wo", "w1", "w2")}

        def tp_loss(rep, shd, tokens):
            x = rep["embed"][tokens]
            x = x + jhvd.tp_attention(x, shd["wq"], shd["wk"], shd["wv"],
                                      shd["wo"], tp_family,
                                      num_heads=TP_ARGS["heads"],
                                      causal=True, name="attn")
            x = x + jhvd.tp_mlp(x, shd["w1"], None, shd["w2"], None,
                                tp_family, name="mlp")
            logits = x @ rep["out"]
            return optax.softmax_cross_entropy_with_integer_labels(
                logits[:, :-1].astype(jnp.float32), tokens[:, 1:]).mean()

        tp = np.asarray(jhvd.spmd(tp_loss)(
            jhvd.replicate(rep), shd, _tp_tokens().astype(np.int32)))
        jhvd.shutdown()
        jhvd.init(devices=jax.devices()[:WORLD])
        heads = MOE_ARGS["heads"]

        def moe_loss(rep, exp, tokens):
            b, t = tokens.shape
            x = rep["embed"][tokens]
            h = x
            d_head = x.shape[-1] // heads

            def qkv(w):
                return (h @ w).reshape(b, t, heads, d_head)

            attn = local_attention(qkv(rep["wq"]), qkv(rep["wk"]),
                                   qkv(rep["wv"]), causal=True, impl="auto")
            x = x + attn.reshape(b, t, -1) @ rep["wo"]
            moe_out, aux = jhvd.moe_mlp(x, rep["gate"], exp["w1"],
                                        exp["b1"], exp["w2"], exp["b2"])
            x = x + moe_out
            logits = x @ rep["out"]
            loss = optax.softmax_cross_entropy_with_integer_labels(
                logits[:, :-1].astype(jnp.float32), tokens[:, 1:]).mean()
            return loss + MOE_ARGS["aux"] * aux

        moe = np.asarray(jhvd.spmd(moe_loss)(
            jhvd.replicate(mrep), mexp, _moe_tokens().astype(np.int32)))
    finally:
        jhvd.shutdown()
    return {"tp": tp, "moe": moe}


# -- the tests -----------------------------------------------------------------


@pytest.mark.parametrize("example", ["tp", "moe"])
def test_first_loss_on_carried_weights_matches_the_reference(
        port, jax_losses, example):
    got = [rank_out[f"{example}_first"] for rank_out in port]
    np.testing.assert_allclose(got, jax_losses[example], rtol=LOSS_RTOL)


@pytest.mark.parametrize("example", ["tp", "moe"])
def test_the_example_trains_and_its_loss_falls(port, example):
    for rank_out in port:
        res = rank_out[f"{example}_main"]
        assert len(res["losses"]) == 10
        assert all(np.isfinite(res["losses"]))
        assert res["losses"][-1] < res["losses"][0]
    # The loss returned is the world's average: the same on every rank.
    first = [rank_out[f"{example}_main"]["losses"][0] for rank_out in port]
    assert max(first) == min(first)


def test_the_zoo_runs_every_mode_in_eight_ranks(port):
    for rank_out in port:
        zoo = rank_out["zoo"]
        assert list(zoo) == ["DP", "TP", "PP", "SP", "EP"]
        assert "skipped" not in zoo.values()
        tp_err = float(zoo["TP"].rsplit(" ", 1)[1])
        pp_err = float(zoo["PP"].rsplit(" ", 1)[1])
        assert tp_err < 1e-5 and pp_err < 1e-5
        assert zoo["SP"].endswith("output (1, 8, 2, 8)")
        assert zoo["EP"].startswith("EP : 8 experts")


@pytest.mark.parametrize("name", ["tp_transformer", "parallelism_zoo"])
def test_at_one_rank_the_topology_bound_parts_step_aside(name, capsys):
    """At one rank ``tp_transformer`` returns None without a launch and the
    zoo skips (and names) its TP mode, as ``long_context_transformer``
    returns below two ranks."""
    import importlib

    mod = importlib.import_module(f"horovod_tpu_torch.examples.{name}")
    got = mod.main(["--device", "cpu"])
    if name == "tp_transformer":
        assert got is None
        assert "needs 8 ranks" in capsys.readouterr().out
    else:
        assert got["TP"] == "skipped"
        assert "skipped ['TP']" in capsys.readouterr().out

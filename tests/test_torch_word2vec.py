"""Port parity: word2vec and the embedding bag (``models/word2vec.py``,
``models/embedding_bag.py``) and their examples, ``horovod_tpu_torch``
against ``horovod_tpu``.

* Loss and sparse gradients of each model against the JAX package's on the
  same weights, carried across as numpy arrays (rtol 1e-5: fp32 on both
  sides, products summed in another order); the batch generators exactly.
* One spawned 2-rank gloo world (module-scoped) trains each model for six
  steps inside ``hvd.spmd`` — value_and_sparse_grad → allreduce_gradients
  (gather, and dense for the embedding bag) → sparse SGD — against the JAX
  package's ``hvd.spmd`` run on the same per-rank batches (rtol 1e-5), and
  the two replicas must be equal bit for bit. It also runs both examples
  at a small width. The spawned children import this module, so JAX is
  imported only inside the parent-side functions.
"""

import numpy as np
import pytest
import torch

W2V = dict(vocab_size=200, embedding_dim=16, num_sampled=8)
BAG = dict(num_embeddings=128, embedding_dim=8, bag_size=4, num_classes=2)
BATCH = 16
STEPS = 6
WORLD = 2


def _w2v_params(seed=0):
    rng = np.random.RandomState(seed)
    v, d = W2V["vocab_size"], W2V["embedding_dim"]
    return {"embeddings": rng.uniform(-1, 1, (v, d)).astype(np.float32),
            "nce_weights": (rng.randn(v, d) / 4).astype(np.float32),
            "nce_biases": (rng.randn(v) / 10).astype(np.float32)}


def _bag_params(seed=0):
    rng = np.random.RandomState(seed)
    n, d, c = BAG["num_embeddings"], BAG["embedding_dim"], BAG["num_classes"]
    return {"table": (rng.randn(n, d) / np.sqrt(d)).astype(np.float32),
            "w": (rng.randn(d, c) / np.sqrt(d)).astype(np.float32),
            "b": (rng.randn(c) / 10).astype(np.float32)}


def _corpus():
    rng = np.random.RandomState(1234)
    corpus = rng.zipf(1.5, size=20_000).clip(0, W2V["vocab_size"] - 1)
    return corpus.astype(np.int32), rng


def _w2v_batches():
    """(centers, contexts, negatives) a step, each (WORLD, ...): the
    reference example's per-rank windows and rank-ordered draws."""
    from horovod_tpu_torch.models import word2vec

    corpus, rng = _corpus()
    index = [len(corpus) // WORLD * r for r in range(WORLD)]
    out = []
    for _ in range(STEPS):
        c, t, n = [], [], []
        for r in range(WORLD):
            ci, ti, index[r] = word2vec.generate_batch(corpus, BATCH, 2, 1,
                                                       index[r])
            c.append(ci)
            t.append(ti)
            n.append(rng.randint(0, W2V["vocab_size"],
                                 (W2V["num_sampled"],)).astype(np.int32))
        out.append((np.stack(c), np.stack(t), np.stack(n)))
    return out


def _bag_batches():
    """Each rank's batch, the same every step, as the JAX package's own
    test trains it: fresh batches carry nothing from one step to the next
    (each draws its own hot ids, and the label is the parity of the ids'
    sum), so only a repeated batch shows the loss falling."""
    from horovod_tpu_torch.models import embedding_bag

    cfg = embedding_bag.EmbeddingBagConfig(**BAG)
    pairs = [embedding_bag.synthetic_batch(cfg, BATCH, seed=r)
             for r in range(WORLD)]
    batch = (np.stack([b for b, _ in pairs]),
             np.stack([lb for _, lb in pairs]))
    return [batch] * STEPS


def _port_train(which: str, algo: str):
    """Six steps of one model in a program on this rank."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import embedding_bag, word2vec

    r = hvd.rank()
    if which == "word2vec":
        model = word2vec.Word2Vec.from_jax_params(_w2v_params())
        batches = _w2v_batches()

        def step(c, t, n):
            loss, grads = word2vec.value_and_sparse_grad(model, c, t, n)
            keys = list(grads)
            synced = hvd.allreduce_gradients([grads[k] for k in keys],
                                             name="w2v")
            word2vec.apply_sparse_sgd(model, dict(zip(keys, synced)), 1.0)
            return hvd.allreduce(loss, name="w2v.loss")
    else:
        model = embedding_bag.EmbeddingBag.from_jax_params(
            _bag_params(), bag_size=BAG["bag_size"])
        batches = _bag_batches()

        def step(bags, labels):
            loss, grads = embedding_bag.value_and_sparse_grad(model, bags,
                                                              labels)
            keys = list(grads)
            synced = hvd.allreduce_gradients([grads[k] for k in keys],
                                             name=f"bag.{algo}",
                                             sparse_algo=algo)
            embedding_bag.apply_sgd(model, dict(zip(keys, synced)), 0.5)
            return hvd.allreduce(loss, name="bag.loss")

    prog = hvd.spmd(step)
    losses = [float(prog(*(torch.from_numpy(a[r]) for a in batch)))
              for batch in batches]
    return {"losses": losses, "runs": prog.runs,
            "params": {k: v.detach().numpy().copy()
                       for k, v in model.state_dict().items()}}


def _port_world():
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.examples import embedding_bag as ex_bag
    from horovod_tpu_torch.examples import word2vec as ex_w2v

    hvd.init(device="cpu")
    out = {("train", w, a): _port_train(w, a)
           for w, a in (("word2vec", "gather"), ("bag", "gather"),
                        ("bag", "dense"))}

    def example(mod, argv):
        res = mod.main(argv + ["--device", "cpu"])
        return {"losses": res["losses"], "runs": res["runs"],
                "replays": res["replays"],
                "params": {k: v.detach().numpy().copy()
                           for k, v in res["model"].state_dict().items()}}

    out["ex_word2vec"] = example(ex_w2v, [
        "--steps", "30", "--vocab-size", "300", "--embedding-dim", "16",
        "--num-sampled", "8", "--batch-size", "32"])
    for algo in ("gather", "dense"):
        out[f"ex_bag_{algo}"] = example(ex_bag, [
            "--steps", "12", "--num-embeddings", "500", "--embedding-dim",
            "8", "--batch-size", "16", "--sparse-algo", algo])
    refusals = {}
    for key, argv in (("auto", ["--sparse-algo", "auto"]),
                      ("compression", ["--compression", "int8"])):
        try:
            ex_bag.main(argv + ["--steps", "1", "--num-embeddings", "64",
                                "--device", "cpu"])
            refusals[key] = None
        except NotImplementedError as e:
            refusals[key] = str(e)
    out["refusals"] = refusals
    return out


@pytest.fixture(scope="module")
def port():
    from horovod_tpu_torch.run import run

    return run(_port_world, WORLD, device="cpu", timeout=240)


def _jax_train(which: str, algo: str):
    import jax
    import jax.numpy as jnp

    import horovod_tpu as jhvd
    from horovod_tpu.models import embedding_bag as jbag
    from horovod_tpu.models import word2vec as jw2v

    if which == "word2vec":
        params, batches = _w2v_params(), _w2v_batches()

        def step(params, c, t, n):
            loss, grads = jw2v.value_and_sparse_grad(params, c, t, n)
            grads = jhvd.allreduce_gradients(grads)
            return jw2v.apply_sparse_sgd(params, grads, 1.0), \
                jhvd.allreduce(loss)
    else:
        params, batches = _bag_params(), _bag_batches()

        def step(params, bags, labels):
            loss, grads = jbag.value_and_sparse_grad(params, bags, labels)
            grads = jhvd.allreduce_gradients(grads, sparse_algo=algo)
            return jbag.apply_sgd(params, grads, 0.5), jhvd.allreduce(loss)

    jhvd.shutdown()
    jhvd.init(devices=jax.devices()[:WORLD])
    try:
        prog = jhvd.spmd(step)
        ps = jhvd.replicate({k: jnp.asarray(v) for k, v in params.items()})
        losses = []
        for batch in batches:
            ps, loss = prog(ps, *batch)
            losses.append(float(np.asarray(loss)[0]))
        return {"losses": losses,
                "params": {k: np.asarray(v) for k, v in ps.items()}}
    finally:
        jhvd.shutdown()


@pytest.mark.parametrize("which,algo", [("word2vec", "gather"),
                                        ("bag", "gather"), ("bag", "dense")])
def test_six_two_rank_steps_match_jax_spmd(port, which, algo):
    want = _jax_train(which, algo)
    for r in range(WORLD):
        got = port[r][("train", which, algo)]
        assert got["runs"] == STEPS  # the CPU runs the Python every call
        np.testing.assert_allclose(got["losses"], want["losses"],
                                   rtol=1e-5)
        for k, v in want["params"].items():
            np.testing.assert_allclose(got["params"][k], v[r], rtol=1e-5,
                                       atol=1e-6, err_msg=k)
            np.testing.assert_array_equal(
                got["params"][k], port[0][("train", which, algo)]["params"][k])
    assert want["losses"][-1] < want["losses"][0]


@pytest.mark.parametrize("name", ["ex_word2vec", "ex_bag_gather",
                                  "ex_bag_dense"])
def test_examples_run_on_the_cpu_at_a_small_width(port, name):
    for r in range(WORLD):
        out = port[r][name]
        assert np.all(np.isfinite(out["losses"]))
        assert (out["runs"], out["replays"]) == (len(out["losses"]), 0)
        for k, v in out["params"].items():
            np.testing.assert_array_equal(v, port[0][name]["params"][k])
    if name == "ex_word2vec":
        losses = port[0][name]["losses"]
        assert np.mean(losses[-5:]) < np.mean(losses[:5])


def test_embedding_bag_gather_and_dense_examples_agree(port):
    a = port[0]["ex_bag_gather"]
    b = port[0]["ex_bag_dense"]
    np.testing.assert_allclose(a["losses"], b["losses"], rtol=1e-5)
    for k in a["params"]:
        np.testing.assert_allclose(a["params"][k], b["params"][k],
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("key", ["auto", "compression"])
def test_embedding_bag_example_refuses_item_12_options(port, key):
    for r in range(WORLD):
        assert "ROADMAP §A item 12" in port[r]["refusals"][key]


# -- single-process cases -----------------------------------------------------


def test_word2vec_loss_and_sparse_grads_match_jax():
    import jax.numpy as jnp

    from horovod_tpu.models import word2vec as jw2v
    from horovod_tpu_torch.models import word2vec

    params = _w2v_params()
    c, t, n = (a[0] for a in _w2v_batches()[0])
    jloss, jgrads = jw2v.value_and_sparse_grad(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(c),
        jnp.asarray(t), jnp.asarray(n))
    model = word2vec.Word2Vec.from_jax_params(params)
    loss, grads = word2vec.value_and_sparse_grad(
        model, torch.from_numpy(c), torch.from_numpy(t), torch.from_numpy(n))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert sorted(grads) == sorted(jgrads)
    for k, g in grads.items():
        np.testing.assert_allclose(g.values.numpy(),
                                   np.asarray(jgrads[k].values), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
        np.testing.assert_array_equal(g.indices.numpy(),
                                      np.asarray(jgrads[k].indices))
        assert g.indices.dtype == torch.int32
        assert tuple(g.dense_shape) == tuple(jgrads[k].dense_shape)


def test_embedding_bag_loss_and_grads_match_jax():
    import jax.numpy as jnp

    from horovod_tpu.models import embedding_bag as jbag
    from horovod_tpu_torch.models import embedding_bag

    params = _bag_params()
    bags, labels = (a[0] for a in _bag_batches()[0])
    jloss, jgrads = jbag.value_and_sparse_grad(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(bags),
        jnp.asarray(labels))
    model = embedding_bag.EmbeddingBag.from_jax_params(
        params, bag_size=BAG["bag_size"])
    loss, grads = embedding_bag.value_and_sparse_grad(
        model, torch.from_numpy(bags), torch.from_numpy(labels))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(grads["table"].values.numpy(),
                               np.asarray(jgrads["table"].values),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_array_equal(grads["table"].indices.numpy(),
                                  np.asarray(jgrads["table"].indices))
    for k in ("w", "b"):
        np.testing.assert_allclose(grads[k].numpy(), np.asarray(jgrads[k]),
                                   rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("batch,skips,window,start", [
    (16, 2, 1, 0), (33, 2, 2, 7), (12, 4, 2, 19_990), (8, 1, 1, 5)])
def test_generate_batch_matches_jax_exactly(batch, skips, window, start):
    from horovod_tpu.models import word2vec as jw2v
    from horovod_tpu_torch.models import word2vec

    corpus, _ = _corpus()
    got = word2vec.generate_batch(corpus, batch, skips, window, start)
    want = jw2v.generate_batch(corpus, batch, skips, window, start)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype
    assert got[2] == want[2]


@pytest.mark.parametrize("seed", [0, 7])
def test_synthetic_batch_matches_jax_exactly(seed):
    from horovod_tpu.models import embedding_bag as jbag
    from horovod_tpu_torch.models import embedding_bag

    got = embedding_bag.synthetic_batch(
        embedding_bag.EmbeddingBagConfig(), 64, seed=seed)
    want = jbag.synthetic_batch(jbag.EmbeddingBagConfig(), 64, seed=seed)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype


def test_configs_are_the_references():
    from horovod_tpu.models import embedding_bag as jbag
    from horovod_tpu.models import word2vec as jw2v
    from horovod_tpu_torch.models import embedding_bag, word2vec

    assert tuple(word2vec.Word2VecConfig()) == tuple(jw2v.Word2VecConfig())
    assert tuple(embedding_bag.EmbeddingBagConfig()) == \
        tuple(jbag.EmbeddingBagConfig())


def test_init_draws_the_references_distributions():
    from horovod_tpu_torch.models import embedding_bag, word2vec

    g = torch.Generator().manual_seed(0)
    w2v = word2vec.Word2Vec(word2vec.Word2VecConfig(2000, 64), generator=g)
    assert float(w2v.embeddings.min()) >= -1 and \
        float(w2v.embeddings.max()) <= 1
    assert abs(float(w2v.nce_weights.std()) - 1 / 8) < 0.005
    assert float(w2v.nce_biases.abs().max()) == 0
    bag = embedding_bag.EmbeddingBag(embedding_bag.EmbeddingBagConfig(
        4000, 16), generator=torch.Generator().manual_seed(0))
    assert abs(float(bag.table.std()) - 0.25) < 0.01
    again = word2vec.Word2Vec(word2vec.Word2VecConfig(2000, 64),
                              generator=torch.Generator().manual_seed(0))
    assert torch.equal(again.embeddings, w2v.embeddings)

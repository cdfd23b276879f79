"""The Estimator: ``horovod_tpu_torch.training.Estimator`` against
``horovod_tpu.training.Estimator`` on the CPU.

A dropout-free linear ``model_fn`` (the JAX package's own estimator test
model) from the same weights on the same numpy-seeded batches: TRAIN's
losses and the final weights, EVAL's averaged metrics (one of them
rank-dependent, so the average over ranks shows) and PREDICT's rows, within
1e-5. The port runs in a spawned 2-rank gloo world where rank 1 starts from
other weights (the implicit rank-0 broadcast must erase them) against the
JAX package's 2-device mesh, then resumes from its ``model_dir`` into an
Estimator built from garbage weights; a 1-rank in-process run drives the LR
through a schedule callback on both sides.

The spawned ranks import this module, so JAX is imported inside the
functions that only the parent runs.
"""

import functools

import numpy as np
import pytest
import torch

SIZE = 2
DIM = 4
STEPS = 3
LR = 0.05


def _w0():
    return np.random.RandomState(0).randn(DIM, 2).astype(np.float32)


def _batches(steps, size, seed=1, batch=8):
    rng = np.random.RandomState(seed)
    return [(rng.randn(size, batch, DIM).astype(np.float32),
             rng.randn(size, batch, 2).astype(np.float32))
            for _ in range(steps)]


class _Linear(torch.nn.Module):
    def __init__(self, w):
        super().__init__()
        self.w = torch.nn.Parameter(torch.from_numpy(w.copy()))


def _port_model_fn(model, features, labels, mode, seed):
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.training import EstimatorSpec, ModeKeys

    assert seed.dtype == torch.int64 and seed.dim() == 0
    logits = features @ model.w
    if mode == ModeKeys.PREDICT:
        return EstimatorSpec(predictions={
            "pred": logits, "norm": (logits ** 2).sum(-1)})
    loss = ((logits - labels) ** 2).mean()
    if mode == ModeKeys.EVAL:
        return EstimatorSpec(loss=loss, metrics={
            "mae": (logits - labels).abs().mean(),
            "rank_id": torch.full((), float(hvd.rank()))})
    return EstimatorSpec(loss=loss)


def _port_init(offset):
    def init_fn(seed, features):
        import horovod_tpu_torch as hvd

        assert features.shape[-1] == DIM  # this rank's batch
        return _Linear(_w0() + offset * hvd.rank())
    return init_fn


def _rank_input(batches, r):
    return lambda: ((x[r], y[r]) for x, y in batches)


def _port_world(model_dir):
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import training

    hvd.init(device="cpu")
    r = hvd.rank()
    losses = []

    class Spy(training.Callback):
        def on_batch_end(self, batch, logs=None):
            losses.append(float(logs["loss"]))

    est = training.Estimator(_port_model_fn, _port_init(1.0),
                             training.sgd(LR), model_dir=model_dir)
    est.train(_rank_input(_batches(STEPS, SIZE), r), steps=STEPS,
              callbacks=[Spy()])
    w = est.model.w.detach().numpy().copy()
    ev = est.evaluate(_rank_input(_batches(2, SIZE, seed=2), r))
    preds = list(est.predict(lambda: [_batches(1, SIZE, seed=3)[0][0][r]]))
    # Resume from model_dir into an Estimator built from garbage weights.
    again = training.Estimator(_port_model_fn, _port_init(5.0),
                               training.sgd(LR), model_dir=model_dir)
    ev2 = again.evaluate(_rank_input(_batches(2, SIZE, seed=2), r))
    return {"losses": losses, "w": w, "eval": ev, "preds": preds,
            "resumed_w": again.model.w.detach().numpy().copy(),
            "resumed_step": again.global_step, "resumed_eval": ev2,
            "train_runs": est._programs["train"].runs}


def _jax_estimator(world, callbacks=()):
    import jax
    import jax.numpy as jnp
    import optax  # noqa: F401

    import horovod_tpu as jhvd
    from horovod_tpu import training as jtraining
    from horovod_tpu.training import EstimatorSpec, ModeKeys

    def model_fn(params, features, labels, mode, rng):
        logits = features @ params["w"]
        if mode == ModeKeys.PREDICT:
            return EstimatorSpec(predictions={
                "pred": logits, "norm": jnp.sum(logits ** 2, axis=-1)})
        loss = jnp.mean((logits - labels) ** 2)
        if mode == ModeKeys.EVAL:
            return EstimatorSpec(loss=loss, metrics={
                "mae": jnp.mean(jnp.abs(logits - labels)),
                "rank_id": jnp.float32(jhvd.rank())})
        return EstimatorSpec(loss=loss)

    def init_fn(rng, features):
        return {"w": jnp.asarray(_w0())}

    jhvd.shutdown()
    jhvd.init(devices=jax.devices()[:world])
    try:
        losses = []

        class Spy(jtraining.Callback):
            def on_batch_end(self, batch, logs=None):
                losses.append(float(np.asarray(logs["loss"])))

        est = jtraining.Estimator(model_fn, init_fn, jtraining.sgd(LR))

        def stacked(batches):
            return lambda: ((jnp.asarray(x), jnp.asarray(y))
                            for x, y in batches)

        est.train(stacked(_batches(STEPS, world)), steps=STEPS,
                  callbacks=[Spy(), *callbacks])
        w = np.asarray(jhvd.local_values(est.params)[0]["w"])
        ev = est.evaluate(stacked(_batches(2, world, seed=2)))
        preds = list(est.predict(lambda: [
            jnp.asarray(_batches(1, world, seed=3)[0][0])]))
        preds = [{k: np.asarray(v) for k, v in p.items()} for p in preds]
    finally:
        jhvd.shutdown()
    return {"losses": losses, "w": w, "eval": ev, "preds": preds}


@pytest.fixture(scope="module")
def two_rank(tmp_path_factory):
    from horovod_tpu_torch.run import run

    model_dir = str(tmp_path_factory.mktemp("est"))
    port = run(_port_world, SIZE, device="cpu", args=(model_dir,),
               timeout=180)
    return port, _jax_estimator(SIZE)


def test_train_losses_and_weights_match_jax(two_rank):
    port, want = two_rank
    # The JAX callback logs the mean over ranks; each port rank its own.
    mean = np.mean([p["losses"] for p in port], axis=0)
    np.testing.assert_allclose(mean, want["losses"], rtol=1e-5, atol=1e-6)
    for p in port:
        np.testing.assert_allclose(p["w"], want["w"], rtol=1e-5, atol=1e-6)


def test_the_rank0_broadcast_is_implicit(two_rank):
    port, _ = two_rank
    # Rank 1 was built from other weights; the replicas end bit-identical.
    assert np.array_equal(port[0]["w"], port[1]["w"])


def test_evaluate_averages_metrics_over_ranks_like_jax(two_rank):
    port, want = two_rank
    for p in port:
        assert set(p["eval"]) == set(want["eval"])
        for k, v in want["eval"].items():
            assert p["eval"][k] == pytest.approx(float(v), rel=1e-5,
                                                 abs=1e-6), k
    assert port[0]["eval"]["rank_id"] == 0.5
    assert port[0]["eval"]["global_step"] == STEPS


def test_predict_yields_this_ranks_examples_like_jax(two_rank):
    port, want = two_rank
    # The JAX package yields rank 0's rows, then rank 1's.
    rows = port[0]["preds"] + port[1]["preds"]
    assert len(rows) == len(want["preds"]) == SIZE * 8
    for got, exp in zip(rows, want["preds"]):
        assert set(got) == set(exp)
        for k in exp:
            np.testing.assert_allclose(got[k], exp[k], rtol=1e-5, atol=1e-6)


def test_resume_from_model_dir(two_rank):
    port, _ = two_rank
    for p in port:
        assert p["resumed_step"] == STEPS
        assert np.array_equal(p["resumed_w"], p["w"])
        assert p["resumed_eval"] == p["eval"]


def test_train_is_one_program(two_rank):
    port, _ = two_rank
    # On the CPU every call runs the step's Python (the card captures it).
    assert [p["train_runs"] for p in port] == [STEPS, STEPS]


@functools.lru_cache(maxsize=None)
def _lr_schedule_runs():
    import horovod_tpu as jhvd  # noqa: F401
    from horovod_tpu import training as jtraining

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import training

    def mult(epoch):
        return 0.5 if epoch < 0.5 else 2.0

    want = _jax_estimator(1, callbacks=[jtraining.LearningRateScheduleCallback(
        mult, staircase=False, steps_per_epoch=2, momentum_correction=False)])
    hvd.init(device="cpu")
    try:
        losses = []

        class Spy(training.Callback):
            def on_batch_end(self, batch, logs=None):
                losses.append(float(logs["loss"]))

        est = training.Estimator(_port_model_fn, _port_init(0.0),
                                 training.sgd(LR))
        est.train(_rank_input(_batches(STEPS, 1), 0), steps=STEPS,
                  callbacks=[Spy(), training.LearningRateScheduleCallback(
                      mult, staircase=False, steps_per_epoch=2,
                      momentum_correction=False)])
        got = {"losses": losses, "w": est.model.w.detach().numpy().copy(),
               "lr": est.get_lr()}
    finally:
        hvd.shutdown()
    return got, want


def test_lr_callbacks_drive_the_estimator_like_jax():
    got, want = _lr_schedule_runs()
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(got["w"], want["w"], rtol=1e-5, atol=1e-6)
    assert got["lr"] == pytest.approx(2.0 * LR)


def test_errors_match_the_reference(tmp_path):
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import training
    from horovod_tpu_torch.training import EstimatorSpec

    hvd.init(device="cpu")
    try:
        est = training.Estimator(lambda *a: EstimatorSpec(),
                                 _port_init(0.0), training.sgd(LR))
        with pytest.raises(hvd.HorovodError,
                           match="must set EstimatorSpec.loss in TRAIN"):
            est.train(_rank_input(_batches(1, 1), 0), steps=1)
        est = training.Estimator(_port_model_fn, _port_init(0.0),
                                 training.sgd(LR))
        with pytest.raises(hvd.HorovodError, match="exhausted after 2 of 5"):
            est.train(_rank_input(_batches(2, 1), 0), steps=5)
        assert est.global_step == 2
        with pytest.raises(hvd.HorovodError, match="yielded no batches"):
            est.evaluate(lambda: iter(()))
    finally:
        hvd.shutdown()

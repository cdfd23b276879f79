"""``Trainer(steps_per_call=K)``: K optimizer steps in one program, the port
against the JAX package's ``Trainer(steps_per_call=K)``.

A tiny ResNet with the fused BatchNorm (``test_torch_train.py``'s), 2
ranks, ``training.sgd(0.003, momentum=0.9)``, K = 2, ``fit`` for one epoch
of 6 steps with ``MetricAverageCallback``: the port in one spawned gloo world
(module-scoped), the JAX package over 2 devices of the simulated world,
from the same (perturbed) flax weights on the same per-rank batches.

* The epoch loss (the mean of the calls' K-step means, averaged over the
  ranks), each call's loss and the parameters against the JAX ``Trainer``;
  the batch callbacks fire once a call, at batch indices 0, 2, 4 on both
  sides.
* The BatchNorm running statistics against ``test_torch_train.py``'s
  reference step run for the same 6 steps: the JAX ``Trainer`` leaves
  them where they started (its step returns them in ``aux``), the port's
  ``Trainer`` averages them over the group after each update, as the
  reference's ResNet step does.
* The reference's errors for ``steps_per_call < 1`` and for
  ``steps_per_epoch`` not divisible by ``steps_per_call``.

Tolerance: ``test_torch_train.py``'s — fp32 on the CPU, convolutions and
sums in other orders in the two frameworks, over 6 steps: losses rtol
1e-4; each tensor within 1e-4 × its largest magnitude. The learning rate
is 0.003 because this net on batches of 8 amplifies rounding fast at
larger ones: at 0.01 the JAX package's own ``Trainer`` and its ResNet
step, the same arithmetic in two programs, end 6 steps 3e-3 apart; at
0.003 they agree to 4e-7, and the port to both within 2e-6.
"""

import numpy as np
import pytest
import torch

from test_torch_train import _check_state, _flax_setup, _jax_train

K = 2
EPOCHS = 1
STEPS = 6
LR = 0.003


def _batches():
    """STEPS steps of per-rank (images, labels), numpy, from a seed."""
    rng = np.random.RandomState(7)
    return [[(rng.randn(8, 32, 32, 3).astype(np.float32),
              rng.randint(0, 10, size=8).astype(np.int64))
             for _ in range(2)] for _ in range(STEPS)]


def _port_world(state_dict, batches):
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import training
    from horovod_tpu_torch.models import resnet
    from test_torch_train import _port_model

    hvd.init(device="cpu")
    r = hvd.rank()
    model = _port_model(state_dict)
    trainer = hvd.Trainer(model, resnet.make_loss_fn(model),
                          training.sgd(LR, momentum=0.9), has_aux=True,
                          steps_per_call=K)
    seen = []

    class Spy(hvd.Callback):
        def on_batch_end(self, batch, logs=None):
            seen.append((batch, float(logs["loss"])))

    data = [(torch.from_numpy(i), torch.from_numpy(l))
            for i, l in (step[r] for step in batches)]
    history = trainer.fit(data, epochs=EPOCHS, steps_per_epoch=len(data),
                          verbose=False,
                          callbacks=[Spy(), hvd.MetricAverageCallback()])
    return {"history": history["loss"], "seen": seen,
            "trace_count": trainer._step.trace_count,
            "state": {k: v.detach().numpy().copy()
                      for k, v in model.state_dict().items()}}


def _jax_fit(batches):
    import jax
    import jax.numpy as jnp

    import horovod_tpu as jhvd
    from horovod_tpu import training as jtraining
    from horovod_tpu.models import resnet as jresnet
    from horovod_tpu_torch.models import resnet as tresnet

    model, variables, _ = _flax_setup()
    seen = []

    class Spy(jtraining.Callback):
        def on_batch_end(self, batch, logs=None):
            seen.append((batch, float(logs["loss"])))

    jhvd.shutdown()
    jhvd.init(devices=jax.devices()[:2])
    try:
        trainer = jtraining.Trainer(
            jresnet.make_loss_fn(model, weight_decay=1e-4,
                                 label_smoothing=0.1),
            jtraining.sgd(LR, momentum=0.9), has_aux=True,
            steps_per_call=K)
        trainer.init_state(variables)
        data = [jhvd.rank_stack([(jnp.asarray(i), jnp.asarray(l))
                                 for i, l in step]) for step in batches]
        history = trainer.fit(data, epochs=EPOCHS, steps_per_epoch=STEPS,
                              callbacks=[Spy()], verbose=False)
        final = jax.device_get(jax.tree.map(lambda t: t[0], trainer.params))
    finally:
        jhvd.shutdown()
    state = {k: v.numpy()
             for k, v in tresnet.from_flax_variables(final).items()}
    return history["loss"], seen, state


@pytest.fixture(scope="module")
def runs():
    from horovod_tpu_torch.run import run

    _, _, sd = _flax_setup()
    batches = _batches()
    port = run(_port_world, 2, device="cpu", args=(sd, batches), timeout=240)
    jhistory, jseen, jstate = _jax_fit(batches)
    _, ref_state = _jax_train(2, batches, lr=LR)
    return port, jhistory, jseen, jstate, ref_state


def _is_stat(name):
    return name.endswith((".mean", ".var"))


def test_epoch_losses_match_the_jax_trainer(runs):
    port, jhistory, jseen, _, _ = runs
    for r in range(2):
        np.testing.assert_allclose(port[r]["history"], jhistory, rtol=1e-4)
    assert len(jhistory) == EPOCHS
    # Each call's loss: the JAX side logs the mean over the ranks.
    calls = np.mean([[v for _, v in p["seen"]] for p in port], axis=0)
    np.testing.assert_allclose(calls, [v for _, v in jseen], rtol=1e-4)


def test_batch_callbacks_fire_once_a_call_at_the_true_step(runs):
    port, _, jseen, _, _ = runs
    want = [b for b, _ in jseen]
    assert want == [0, 2, 4] * EPOCHS
    for r in range(2):
        assert [b for b, _ in port[r]["seen"]] == want
    # One program for every call.
    assert [p["trace_count"] for p in port] == [1, 1]


@pytest.mark.parametrize("rank", [0, 1])
def test_parameters_match_the_jax_trainer(runs, rank):
    port, _, _, jstate, _ = runs
    got = {k: v for k, v in port[rank]["state"].items() if not _is_stat(k)}
    want = {k: v for k, v in jstate.items() if not _is_stat(k)}
    assert got  # the tiny ResNet's parameters
    _check_state(got, want)


@pytest.mark.parametrize("rank", [0, 1])
def test_state_with_running_statistics_matches_the_reference_step(runs,
                                                                  rank):
    port, _, _, _, ref_state = runs
    assert any(_is_stat(k) for k in ref_state)
    _check_state(port[rank]["state"], ref_state)


@pytest.fixture
def both_worlds():
    import jax

    import horovod_tpu as jhvd
    import horovod_tpu_torch as hvd

    hvd.shutdown()
    hvd.init(device="cpu")
    jhvd.shutdown()
    jhvd.init(devices=jax.devices()[:1])
    yield
    jhvd.shutdown()
    hvd.shutdown()


def _error(fn):
    with pytest.raises(Exception) as info:
        fn()
    return str(info.value)


@pytest.mark.parametrize("spc", [0, -1])
def test_steps_per_call_below_one_raises_the_reference_text(both_worlds,
                                                            spc):
    from horovod_tpu import training as jtraining
    import horovod_tpu_torch as hvd

    want = _error(lambda: jtraining.Trainer(lambda p, b: 0.0,
                                            jtraining.sgd(0.1),
                                            steps_per_call=spc))
    model = torch.nn.Linear(2, 1)
    got = _error(lambda: hvd.Trainer(model, lambda m, b: m(b).sum(),
                                     hvd.training.sgd(0.1),
                                     steps_per_call=spc))
    assert got == want == "steps_per_call must be >= 1."


@pytest.mark.parametrize("spc,steps", [(4, 10), (3, 5)])
def test_indivisible_steps_per_epoch_raises_the_reference_text(both_worlds,
                                                               spc, steps):
    import jax.numpy as jnp

    from horovod_tpu import training as jtraining
    import horovod_tpu_torch as hvd

    jt = jtraining.Trainer(lambda p, b: jnp.sum(p["w"] * b),
                           jtraining.sgd(0.1), steps_per_call=spc)
    jt.init_state({"w": np.zeros(2, np.float32)})
    want = _error(lambda: jt.fit([np.ones((1, 2), np.float32)], epochs=1,
                                 steps_per_epoch=steps, verbose=False))
    model = torch.nn.Linear(2, 1)
    trainer = hvd.Trainer(model, lambda m, b: m(b).sum(),
                          hvd.training.sgd(0.1), steps_per_call=spc)
    got = _error(lambda: trainer.fit([torch.ones(1, 2)], epochs=1,
                                     steps_per_epoch=steps, verbose=False))
    assert got == want
    assert "must be divisible by steps_per_call" in got

"""The MNIST models, their loss, dropout and the examples' optimizers:
``horovod_tpu_torch`` against ``horovod_tpu`` (and optax) on the CPU.

* ``ConvModel`` and ``KerasMnistModel`` from the same flax weights
  (``from_flax_params``) on the same numpy-seeded images: at
  ``dtype=float32`` logits and every parameter's gradient within 1e-4
  (atol = rtol; the convolutions sum in different orders); at the bf16
  default the logits within 3e-2 (one bf16 rounding, 2^-8, of activations
  of order 1 after 4 layers).
* ``cross_entropy_loss`` and ``accuracy`` within 1e-6.
* Dropout is the port's own stream (ROADMAP §C): a pure function of (seed,
  labels) that keeps 1 − rate of the units, scaled by 1/(1 − rate).
* ``training.adadelta`` and the mnist example's rmsprop against
  ``optax.adadelta`` / ``optax.rmsprop`` over 5 steps, within 1e-6
  relative.
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from horovod_tpu.models import mnist as jm
from horovod_tpu_torch.models import mnist as tm

MODELS = {"conv": (jm.ConvModel, tm.ConvModel),
          "keras": (jm.KerasMnistModel, tm.KerasMnistModel)}
DTYPES = {"fp32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


@functools.lru_cache(maxsize=None)
def _flax(kind: str, dtype: str):
    jcls, tcls = MODELS[kind]
    jdt, tdt = DTYPES[dtype]
    jmodel = jcls(dtype=jdt)
    params = jax.jit(functools.partial(jmodel.init, train=False))(
        jax.random.PRNGKey(0), jnp.zeros((1, 28, 28, 1)))["params"]
    params = jax.tree.map(np.asarray, params)
    tmodel = tcls(dtype=tdt)
    tmodel.load_state_dict(tm.from_flax_params(params))
    return jmodel, params, tmodel


def _batch(n=4, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.rand(n, 28, 28, 1).astype(np.float32),
            rng.randint(0, 10, size=n).astype(np.int32))


@pytest.mark.parametrize("kind", sorted(MODELS))
def test_fp32_logits_and_gradients_match_flax(kind):
    jmodel, params, tmodel = _flax(kind, "fp32")
    x, y = _batch()

    def loss(p):
        logits = jmodel.apply({"params": p}, x, train=False)
        return jm.cross_entropy_loss(logits, y), logits

    (jloss, jlogits), jgrads = jax.jit(
        jax.value_and_grad(loss, has_aux=True))(params)
    tmodel.zero_grad()
    logits = tmodel(torch.from_numpy(x), train=False)
    tloss = tm.cross_entropy_loss(logits, torch.from_numpy(y))
    tloss.backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(tloss.detach()), float(jloss),
                               rtol=1e-4)
    want = tm.from_flax_params(jax.tree.map(np.asarray, jgrads))
    for name, p in tmodel.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   rtol=1e-4, atol=1e-4, err_msg=name)


@pytest.mark.parametrize("kind", sorted(MODELS))
def test_bf16_logits_match_flax(kind):
    jmodel, params, tmodel = _flax(kind, "bf16")
    x, _ = _batch()
    jlogits = np.asarray(jmodel.apply({"params": params}, x, train=False))
    logits = tmodel(torch.from_numpy(x), train=False)
    assert logits.dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in tmodel.parameters())
    np.testing.assert_allclose(logits.detach().numpy(), jlogits, rtol=3e-2,
                               atol=3e-2)


@pytest.mark.parametrize("shape", [(3, 784), (3, 28, 28), (3, 28, 28, 1)])
def test_input_shapes_are_accepted_like_flax(shape):
    jmodel, params, tmodel = _flax("conv", "fp32")
    x = np.random.RandomState(1).rand(*shape).astype(np.float32)
    jlogits = np.asarray(jmodel.apply({"params": params}, x, train=False))
    logits = tmodel(torch.from_numpy(x), train=False).detach().numpy()
    np.testing.assert_allclose(logits, jlogits, rtol=1e-4, atol=1e-4)


def test_cross_entropy_and_accuracy_match_jax():
    rng = np.random.RandomState(3)
    logits = rng.randn(16, 10).astype(np.float32)
    labels = rng.randint(0, 10, size=16).astype(np.int32)
    labels[:5] = logits[:5].argmax(-1)
    tl, ty = torch.from_numpy(logits), torch.from_numpy(labels)
    np.testing.assert_allclose(float(tm.cross_entropy_loss(tl, ty)),
                               float(jm.cross_entropy_loss(logits, labels)),
                               rtol=1e-6)
    assert float(tm.accuracy(tl, ty)) == pytest.approx(
        float(jm.accuracy(logits, labels)), abs=1e-7)


def test_dropout_mask_is_a_pure_function_of_seed_and_labels():
    x = torch.ones(64, 1024)
    labels = torch.tensor([1, 2, 3])
    key = tm.dropout_key(0, labels)
    a = tm.dropout(x, 0.25, key, 0)
    assert torch.equal(a, tm.dropout(x, 0.25, tm.dropout_key(0, labels), 0))
    # Only the labels' sum enters the key, as the reference folds it.
    assert torch.equal(key, tm.dropout_key(0, torch.tensor([3, 3, 0])))
    for other in (tm.dropout_key(1, labels),
                  tm.dropout_key(0, torch.tensor([1, 2, 4]))):
        assert not torch.equal(a, tm.dropout(x, 0.25, other, 0))
    assert not torch.equal(a, tm.dropout(x, 0.25, key, 1))
    kept = a != 0
    # Kept units are scaled by 1/(1 - rate); 1 - rate of them are kept
    # (65,536 draws: 4 sigma of a binomial is 0.7%).
    assert torch.equal(a[kept], torch.full_like(a[kept], 1 / 0.75))
    assert abs(kept.float().mean().item() - 0.75) < 0.007
    b = tm.dropout(x, 0.5, key, 0)
    assert abs((b != 0).float().mean().item() - 0.5) < 0.008


@pytest.mark.parametrize("kind", sorted(MODELS))
def test_training_loss_is_pure_and_needs_a_key(kind):
    _, _, tmodel = _flax(kind, "fp32")
    x, y = _batch(8, seed=4)
    batch = (torch.from_numpy(x), torch.from_numpy(y))
    loss_fn = tm.make_loss_fn(tmodel, seed=5)
    first = loss_fn(tmodel, batch)
    assert torch.equal(first, loss_fn(tmodel, batch))
    eval_loss = tm.make_loss_fn(tmodel, train=False)(tmodel, batch)
    assert not torch.equal(first, eval_loss)
    tmodel.train()
    with pytest.raises(ValueError, match="dropout_key"):
        tmodel(batch[0])


def test_synthetic_mnist_is_seeded_and_device_independent():
    x, y = tm.synthetic_mnist(6, seed=3, device="cpu")
    assert x.shape == (6, 28, 28, 1) and x.dtype == torch.float32
    assert y.shape == (6,) and y.dtype == torch.int64
    assert float(x.min()) >= 0 and float(x.max()) < 1
    assert int(y.min()) >= 0 and int(y.max()) < 10
    x2, y2 = tm.synthetic_mnist(6, seed=3, device="cpu")
    assert torch.equal(x, x2) and torch.equal(y, y2)
    assert not torch.equal(x, tm.synthetic_mnist(6, seed=4, device="cpu")[0])


# -- the examples' optimizers against optax -----------------------------------

def _params_and_grads(steps=5):
    rng = np.random.RandomState(7)
    params = {"w": rng.randn(3, 4).astype(np.float32),
              "b": rng.randn(4).astype(np.float32)}
    grads = [{k: rng.randn(*v.shape).astype(np.float32)
              for k, v in params.items()} for _ in range(steps)]
    return params, grads


def _run_both(optax_opt, torch_builder):
    params, grads = _params_and_grads()
    state = optax_opt.init(params)
    jp = params
    for g in grads:
        upd, state = optax_opt.update(g, state, jp)
        jp = optax.apply_updates(jp, upd)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in params.items()}
    opt = torch_builder(list(tp.values()))
    for g in grads:
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
    for k in params:
        np.testing.assert_allclose(tp[k].detach().numpy(),
                                   np.asarray(jp[k]), rtol=1e-6, atol=1e-7,
                                   err_msg=k)


@pytest.mark.parametrize("lr", [1.0, 0.3])
def test_adadelta_matches_optax(lr):
    from horovod_tpu_torch import training

    _run_both(optax.adadelta(lr), training.adadelta(lr))


@pytest.mark.parametrize("lr", [1e-3, 1e-2])
def test_the_mnist_examples_rmsprop_matches_optax(lr):
    from horovod_tpu_torch.examples.mnist import _RMSprop

    _run_both(optax.rmsprop(lr),
              lambda ps: _RMSprop(ps, lr=torch.tensor(lr)))


def test_adadelta_lr_lives_in_a_device_tensor():
    from horovod_tpu_torch import training

    p = torch.nn.Parameter(torch.ones(3))
    opt = training.adadelta(2.0)([p])
    lr = opt.param_groups[0]["lr"]
    assert isinstance(lr, torch.Tensor) and lr.dim() == 0
    assert float(lr) == 2.0
    p.grad = torch.ones(3)
    opt.step()
    sd = copy.deepcopy(opt.state_dict())
    lr.fill_(5.0)
    opt.load_state_dict(sd)
    assert opt.param_groups[0]["lr"] is lr and float(lr) == 2.0

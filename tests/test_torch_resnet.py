"""Port parity: ResNet v1.5 of ``horovod_tpu_torch`` against the flax model
of ``horovod_tpu``, with the weights carried across by
``from_flax_variables``.

A tiny ResNet (stages [1, 1, 1, 1], 8 filters, 10 classes, fp32) on 32 px
inputs (every strided layer pads asymmetrically, flax SAME) and 33 px inputs
(odd sizes, symmetric pads). The flax variables are perturbed with seeded
noise so that no BN scale is zero and the running statistics are not the
identity, which makes every layer count.

Tolerance: the two frameworks convolve and sum in different orders, fp32
throughout: rtol/atol 1e-4 on logits, loss, running stats and gradients.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.models import resnet as jresnet
from horovod_tpu_torch.models import resnet as tresnet

TOL = dict(rtol=1e-4, atol=1e-4)


def _perturbed_variables(model, seed=0):
    dummy = jnp.zeros((1, 32, 32, 3), jnp.float32)
    variables = jax.jit(functools.partial(model.init, train=False))(
        jax.random.PRNGKey(seed), dummy)
    rng = np.random.RandomState(seed)

    def bump(path, leaf):
        a = np.asarray(leaf, np.float32)
        key = path[-1].key
        if key == "var":
            return (a + rng.rand(*a.shape) + 0.5).astype(np.float32)
        if key == "scale":
            return (a + rng.rand(*a.shape) * 0.5 + 0.5).astype(np.float32)
        return (a + rng.randn(*a.shape) * 0.1).astype(np.float32)

    return jax.tree_util.tree_map_with_path(bump, variables)


@functools.lru_cache(maxsize=None)
def _flax_model(norm_impl):
    """The flax model and its perturbed variables (traced once per
    norm_impl: eager flax on the CPU is slow)."""
    jmodel = jresnet.ResNet(stage_sizes=[1, 1, 1, 1], num_classes=10,
                            num_filters=8, dtype=jnp.float32,
                            norm_impl=norm_impl)
    return jmodel, _perturbed_variables(jmodel)


def _pair(norm_impl):
    jmodel, variables = _flax_model(norm_impl)
    tmodel = tresnet.ResNet([1, 1, 1, 1], num_classes=10, num_filters=8,
                            dtype=torch.float32, norm_impl=norm_impl)
    tmodel.load_state_dict(tresnet.from_flax_variables(variables))
    return jmodel, variables, tmodel


def _batch(n, size, seed=1):
    rng = np.random.RandomState(seed)
    images = rng.randn(n, size, size, 3).astype(np.float32)
    labels = rng.randint(0, 10, size=n).astype(np.int64)
    return images, labels


def _close(got, want, **kw):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), **(kw or TOL))


@pytest.mark.parametrize("size", [5, 6, 32, 33, 224])
@pytest.mark.parametrize("k,s", [(7, 2), (3, 2), (1, 2), (3, 1), (1, 1)])
def test_same_pads_match_xla(size, k, s):
    want = jax.lax.padtype_to_pads((size,), (k,), (s,), "SAME")[0]
    assert tresnet.same_pads(size, k, s) == tuple(want)


def test_stem_pads_low_2_high_3_at_224():
    assert tresnet.same_pads(224, 7, 2) == (2, 3)
    assert tresnet.same_pads(56, 3, 2) == (0, 1)
    assert tresnet.same_pads(112, 3, 2) == (0, 1)


@pytest.mark.parametrize("norm_impl", ["fused", "flax"])
def test_state_dict_covers_the_model(norm_impl):
    _, variables, tmodel = _pair(norm_impl)
    sd = tresnet.from_flax_variables(variables)
    assert set(sd) == set(tmodel.state_dict())


@pytest.mark.parametrize("size", [32, 33])
@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("norm_impl", ["fused", "flax"])
def test_forward_matches_flax(norm_impl, train, size):
    jmodel, variables, tmodel = _pair(norm_impl)
    images, _ = _batch(3, size)
    if train:
        jlogits, mutated = jax.jit(functools.partial(
            jmodel.apply, train=True, mutable=["batch_stats"]))(
                variables, jnp.asarray(images))
    else:
        jlogits = jax.jit(functools.partial(jmodel.apply, train=False))(
            variables, jnp.asarray(images))
    tmodel.train(train)
    with torch.no_grad():
        tlogits = tmodel(torch.from_numpy(images))
    assert tlogits.dtype == torch.float32 and tlogits.shape == (3, 10)
    _close(tlogits, jlogits)
    if train:
        want = tresnet.from_flax_variables(
            {"params": variables["params"],
             "batch_stats": jax.device_get(mutated["batch_stats"])})
        got = tmodel.state_dict()
        for name in got:
            if name.endswith((".mean", ".var")):
                _close(got[name], want[name], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("norm_impl", ["fused", "flax"])
def test_loss_and_grads_match_jax(norm_impl):
    """Label-smoothed CE + 0.5·wd·Σ‖kernel‖², and its gradient w.r.t. every
    parameter."""
    jmodel, variables, tmodel = _pair(norm_impl)
    images, labels = _batch(4, 32, seed=2)
    jloss_fn = jresnet.make_loss_fn(jmodel, weight_decay=1e-4,
                                    label_smoothing=0.1)
    (jloss, jaux), jgrads = jax.jit(
        jax.value_and_grad(jloss_fn, has_aux=True))(
        variables, (jnp.asarray(images), jnp.asarray(labels)))
    tloss_fn = tresnet.make_loss_fn(tmodel, weight_decay=1e-4,
                                    label_smoothing=0.1)
    tmodel.train()
    tloss, taux = tloss_fn(tmodel, (torch.from_numpy(images),
                                    torch.from_numpy(labels)))
    tloss.backward()
    _close(tloss.detach(), jloss)
    _close(taux["accuracy"], jaux["accuracy"])
    want = tresnet.from_flax_variables(
        {"params": jax.device_get(jgrads["params"]),
         "batch_stats": variables["batch_stats"]})
    for name, p in tmodel.named_parameters():
        scale = float(np.abs(want[name].numpy()).max())
        _close(p.grad, want[name], rtol=1e-4, atol=1e-4 * scale)

"""Port parity: BatchNorm channel sums (B1/B2), the training-mode BN and the
BN modules of ``horovod_tpu_torch`` against ``horovod_tpu``.

On this host every tensor is on the CPU, so the port runs the kernels'
plain versions; the CUDA kernels themselves are held against those plain
versions on the card by ``chip_smoke.py``. Inputs are float32, made with
numpy from a seed and handed to both frameworks.

Tolerance: the two frameworks sum in different orders, so fp32 sums over
n rows agree to ~n·eps relative; rtol 1e-5 with a small atol covers the
sizes here. Elementwise results (y, dx) agree to rtol 1e-5.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.models.layers import FusedBatchNorm as JaxFusedBatchNorm
from horovod_tpu.ops import batchnorm as jbn
from horovod_tpu_torch.models.layers import BatchNorm, FusedBatchNorm
from horovod_tpu_torch.ops import batchnorm as tbn

RTOL, ATOL = 1e-5, 1e-4

# Ragged leading shapes: N = 37, 149 and 2·3·13 = 78 rows, none a multiple
# of any block size either side uses.
SHAPES = [((37,), 8), ((149,), 64), ((2, 3, 13), 200), ((5, 7), 64)]


def _x(shape, c, seed, scale=3.0, shift=2.0):
    rng = np.random.RandomState(seed)
    return (rng.randn(*shape, c) * scale + shift).astype(np.float32)


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("interpret", [True, None])
@pytest.mark.parametrize("shape,c", SHAPES)
def test_channel_sums_matches_jax(shape, c, interpret):
    x = _x(shape, c, seed=c)
    j1, j2 = jbn.channel_sums(jnp.asarray(x), interpret=interpret)
    t1, t2 = tbn.channel_sums(torch.from_numpy(x))
    assert t1.dtype == t2.dtype == torch.float32 and t1.shape == (c,)
    _close(t1, j1)
    _close(t2, j2, atol=1e-3)


@pytest.mark.parametrize("interpret", [True, None])
@pytest.mark.parametrize("shape,c", SHAPES)
def test_channel_grad_sums_matches_jax(shape, c, interpret):
    x = _x(shape, c, seed=c + 1)
    dy = _x(shape, c, seed=c + 2, scale=1.0, shift=0.0)
    xf = x.reshape(-1, c)
    mean = xf.mean(0).astype(np.float32)
    rstd = (1.0 / np.sqrt(xf.var(0) + 1e-5)).astype(np.float32)
    j1, j2 = jbn.channel_grad_sums(jnp.asarray(dy), jnp.asarray(x),
                                   jnp.asarray(mean), jnp.asarray(rstd),
                                   interpret=interpret)
    t1, t2 = tbn.channel_grad_sums(torch.from_numpy(dy), torch.from_numpy(x),
                                   torch.from_numpy(mean),
                                   torch.from_numpy(rstd))
    _close(t1, j1)
    _close(t2, j2)


@pytest.mark.parametrize("shape,c", [((4, 6, 6), 16), ((37,), 8),
                                     ((2, 5, 3), 200)])
def test_batch_norm_train_fwd_bwd_matches_jax_vjp(shape, c):
    rng = np.random.RandomState(7)
    x = _x(shape, c, seed=11, scale=2.0, shift=1.5)
    gamma = (rng.rand(c) + 0.5).astype(np.float32)
    beta = rng.randn(c).astype(np.float32)
    g = rng.randn(*shape, c).astype(np.float32)

    (jy, jm, jv), vjp = jax.vjp(
        lambda a, b, cc: jbn.batch_norm_train(a, b, cc, 1e-5, None),
        jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta))
    jdx, jdg, jdb = vjp((jnp.asarray(g), jnp.zeros(c, jnp.float32),
                         jnp.zeros(c, jnp.float32)))

    tx = torch.from_numpy(x).requires_grad_()
    tg = torch.from_numpy(gamma).requires_grad_()
    tb = torch.from_numpy(beta).requires_grad_()
    ty, tm, tv = tbn.batch_norm_train(tx, tg, tb, 1e-5)
    assert not tm.requires_grad and not tv.requires_grad
    ty.backward(torch.from_numpy(g))

    _close(ty.detach(), jy)
    _close(tm, jm, atol=1e-6)
    _close(tv, jv, atol=1e-6)
    _close(tx.grad, jdx)
    _close(tg.grad, jdg, atol=1e-3)
    _close(tb.grad, jdb, atol=1e-3)


def _flax_vars(rng, c):
    return {"params": {"scale": (rng.rand(c) + 0.5).astype(np.float32),
                       "bias": rng.randn(c).astype(np.float32)},
            "batch_stats": {"mean": rng.randn(c).astype(np.float32),
                            "var": (rng.rand(c) + 0.3).astype(np.float32)}}


def _load(mod, v):
    with torch.no_grad():
        mod.scale.copy_(torch.from_numpy(v["params"]["scale"]))
        mod.bias.copy_(torch.from_numpy(v["params"]["bias"]))
        mod.mean.copy_(torch.from_numpy(v["batch_stats"]["mean"]))
        mod.var.copy_(torch.from_numpy(v["batch_stats"]["var"]))
    return mod


@pytest.mark.parametrize("port_cls,ref_cls", [
    (FusedBatchNorm, JaxFusedBatchNorm), (BatchNorm, fnn.BatchNorm)])
@pytest.mark.parametrize("train", [True, False])
def test_bn_module_matches_flax(port_cls, ref_cls, train):
    """Output and running-average update (ra = 0.9·ra + 0.1·batch, biased
    variance) of the port's BN modules against their flax counterparts."""
    c = 16
    rng = np.random.RandomState(3)
    v = _flax_vars(rng, c)
    x = _x((4, 5, 5), c, seed=5, scale=2.0, shift=1.5)
    ref = ref_cls(use_running_average=not train, momentum=0.9, epsilon=1e-5,
                  dtype=jnp.float32, param_dtype=jnp.float32)
    jy, mut = ref.apply(jax.tree.map(jnp.asarray, v), jnp.asarray(x),
                        mutable=["batch_stats"])
    mod = _load(port_cls(c, dtype=torch.float32), v).train(train)
    with torch.no_grad():
        ty = mod(torch.from_numpy(x))
    _close(ty, jy)
    new = mut["batch_stats"] if train else v["batch_stats"]
    _close(mod.mean, new["mean"], atol=1e-6)
    _close(mod.var, new["var"], atol=1e-6)


def test_running_var_is_biased():
    """Flax keeps the biased batch variance; nn.BatchNorm2d the unbiased."""
    x = torch.from_numpy(_x((3, 4), 8, seed=9))
    mod = FusedBatchNorm(8, dtype=torch.float32).train()
    with torch.no_grad():
        mod(x)
    rows = x.reshape(-1, 8).double()
    want = 0.9 + 0.1 * rows.var(0, unbiased=False)
    _close(mod.var, want, atol=1e-6)

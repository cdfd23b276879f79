"""Fused chunked-vocab cross-entropy of the port against the JAX package's.

``horovod_tpu_torch.ops.losses.fused_cross_entropy`` and
``horovod_tpu.ops.losses.fused_cross_entropy`` on the same numpy inputs
(seeded, float32): V = 97 with chunk 32 (three full chunks and a
remainder of 1), the value and dx/dW. fp32 on both sides, the sums in
another order: rtol 1e-5.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from horovod_tpu.ops import losses as jlosses
from horovod_tpu_torch.ops import losses as tlosses

TOL = dict(rtol=1e-5, atol=1e-6)


def _inputs(n=24, e=16, v=97, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, e).astype(np.float32),
            (rng.randn(e, v) * 0.5).astype(np.float32),
            rng.randint(0, v, size=n).astype(np.int32))


def _port(x, w, t, chunk):
    xt, wt = (torch.from_numpy(a).requires_grad_() for a in (x, w))
    loss = tlosses.fused_cross_entropy(xt, wt, torch.from_numpy(t).long(),
                                       chunk)
    loss.backward()
    return loss.item(), xt.grad.numpy(), wt.grad.numpy()


@pytest.mark.parametrize("chunk", [32, 97, 128])
def test_fused_cross_entropy_matches_jax(chunk):
    x, w, t = _inputs()
    # Targets in the remainder chunk (96) and in the first and last
    # columns of full chunks.
    t[:4] = [96, 0, 31, 32]
    loss, dx, dw = _port(x, w, t, chunk)
    jloss, (jdx, jdw) = jax.value_and_grad(
        lambda x, w: jlosses.fused_cross_entropy(x, w, jnp.asarray(t), chunk),
        argnums=(0, 1))(x, w)
    np.testing.assert_allclose(loss, float(jloss), **TOL)
    np.testing.assert_allclose(dx, np.asarray(jdx), **TOL)
    np.testing.assert_allclose(dw, np.asarray(jdw), **TOL)


def test_fused_cross_entropy_equals_materialized_logits():
    x, w, t = _inputs(seed=1)
    loss, dx, dw = _port(x, w, t, 32)
    xt, wt = (torch.from_numpy(a).requires_grad_() for a in (x, w))
    ref = F.cross_entropy(xt @ wt, torch.from_numpy(t).long())
    ref.backward()
    np.testing.assert_allclose(loss, ref.item(), **TOL)
    np.testing.assert_allclose(dx, xt.grad.numpy(), **TOL)
    np.testing.assert_allclose(dw, wt.grad.numpy(), **TOL)


def test_bf16_operands_match_jax():
    """bf16 x and w (the LM's head): fp32 logits from bf16 operands on both
    sides, bf16 gradients; tolerance one bf16 ulp (2^-8) of the largest
    gradient entry."""
    x, w, t = _inputs(seed=2)
    xb, wb = (a.astype(jnp.bfloat16) for a in (jnp.asarray(x),
                                               jnp.asarray(w)))
    jloss, (jdx, jdw) = jax.value_and_grad(
        lambda x, w: jlosses.fused_cross_entropy(x, w, jnp.asarray(t), 32),
        argnums=(0, 1))(xb, wb)
    xt = torch.tensor(np.asarray(xb.astype(jnp.float32))).bfloat16()
    wt = torch.tensor(np.asarray(wb.astype(jnp.float32))).bfloat16()
    xt.requires_grad_()
    wt.requires_grad_()
    loss = tlosses.fused_cross_entropy(xt, wt, torch.from_numpy(t).long(), 32)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    for got, want in ((xt.grad, jdx), (wt.grad, jdw)):
        want = np.asarray(want.astype(jnp.float32))
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                                   atol=np.abs(want).max() * 2 ** -8)


def test_default_chunk_matches_jax():
    for v in (97, 8192, 32_768, 50_257):
        assert tlosses.default_chunk(v) == jlosses.default_chunk(v)
    assert tlosses.DEFAULT_CHUNK == jlosses.DEFAULT_CHUNK

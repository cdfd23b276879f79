"""The port's AdamW (``horovod_tpu_torch.ops.optim.AdamW``) against the JAX
package's (``horovod_tpu.ops.optim.adamw`` + ``optax.apply_updates``).

Three steps on the same parameter and gradient sequence (numpy, seeded,
float32). With fp32 moments the two compute the same fp32 arithmetic:
parameters and moments to rtol 1e-6. With bf16 moments (the default) the
stored moments may differ by one bf16 rounding (2^-8 relative) where the
fp32 values straddle a rounding boundary; parameters then stay within
1e-6 relative of the update's size.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import optax

from horovod_tpu.ops import optim as joptim
from horovod_tpu_torch.ops import optim as toptim

KW = dict(b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.1)
LR = 3e-3
STEPS = 3


def _sequence(seed=0):
    rng = np.random.RandomState(seed)
    params = {"w": rng.randn(8, 5).astype(np.float32),
              "b": rng.randn(5).astype(np.float32)}
    grads = [{k: (rng.randn(*v.shape) * 10 ** rng.uniform(-3, 1))
              .astype(np.float32) for k, v in params.items()}
             for _ in range(STEPS)]
    return params, grads


def _jax(params, grads, moment_dtype):
    opt = joptim.adamw(LR, moment_dtype=moment_dtype, **KW)
    p = {k: jnp.asarray(v) for k, v in params.items()}
    state = opt.init(p)
    for g in grads:
        upd, state = opt.update({k: jnp.asarray(v) for k, v in g.items()},
                                state, p)
        p = optax.apply_updates(p, upd)
    f = lambda t: {k: np.asarray(v.astype(jnp.float32)) for k, v in t.items()}
    return f(p), f(state.mu), f(state.nu)


def _port(params, grads, moment_dtype):
    p = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
         for k, v in params.items()}
    opt = toptim.AdamW(list(p.values()), LR, moment_dtype=moment_dtype, **KW)
    for g in grads:
        for k, v in g.items():
            p[k].grad = torch.from_numpy(v)
        opt.step()
    f = lambda key: {k: opt.state[v][key].float().numpy()
                     for k, v in p.items()}
    return ({k: v.detach().numpy() for k, v in p.items()}, f("mu"), f("nu"))


def test_fp32_moments_match_jax():
    params, grads = _sequence()
    got = _port(params, grads, torch.float32)
    want = _jax(params, grads, jnp.float32)
    for g, w, what in zip(got, want, ("params", "mu", "nu")):
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-6, atol=0,
                                       err_msg=f"{what}.{k}")


def test_bf16_moments_within_one_ulp_of_jax():
    params, grads = _sequence(seed=1)
    got = _port(params, grads, torch.bfloat16)
    want = _jax(params, grads, jnp.bfloat16)
    for g, w, what in zip(got[1:], want[1:], ("mu", "nu")):
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=2 ** -8, atol=0,
                                       err_msg=f"{what}.{k}")
    for k in want[0]:
        step = np.abs(want[0][k] - params[k]).max()
        np.testing.assert_allclose(got[0][k], want[0][k], rtol=0,
                                   atol=1e-6 * max(step, 1.0), err_msg=k)


def test_moments_are_stored_in_moment_dtype():
    p = torch.nn.Parameter(torch.ones(3))
    opt = toptim.AdamW([p], 0.1)
    p.grad = torch.ones(3)
    opt.step()
    assert opt.state[p]["mu"].dtype == torch.bfloat16
    assert opt.state[p]["nu"].dtype == torch.bfloat16


def test_same_update_as_torch_adamw_in_exact_arithmetic():
    """torch.optim.AdamW decays the parameter first (p·(1 − lr·wd)) and
    then applies the Adam step; the reference adds lr·wd·p to the step.
    In exact arithmetic that is the same update, so the two agree to fp32
    rounding over 3 steps; the port keeps the reference's order of fp32
    operations and its moment storage."""
    params, grads = _sequence(seed=2)
    w = torch.nn.Parameter(torch.from_numpy(params["w"].copy()))
    mine = torch.nn.Parameter(torch.from_numpy(params["w"].copy()))
    ref = torch.optim.AdamW([w], lr=LR, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=0.1)
    opt = toptim.AdamW([mine], LR, moment_dtype=torch.float32, **KW)
    for g in grads:
        for p in (w, mine):
            p.grad = torch.from_numpy(g["w"])
        ref.step()
        opt.step()
    np.testing.assert_allclose(mine.detach().numpy(), w.detach().numpy(),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("lr", [-1.0])
def test_negative_lr_refused(lr):
    with pytest.raises(ValueError):
        toptim.AdamW([torch.nn.Parameter(torch.ones(1))], lr)

"""A1's plain version (``horovod_tpu_torch/ops/optim.py::
adamw_update_plain``) against the reference's leaf update
(``horovod_tpu/ops/optim.py::adamw`` + ``optax.apply_updates``), with the
port's step counts: one int32 tensor a parameter, on its device, advanced
by the update itself.

* With fp32 moments the two compute the same fp32 arithmetic: parameters
  and moments to rtol 1e-6 (the bias corrections come from each side's own
  ``pow``); with bf16 moments the stored moments within one bf16 rounding
  (2^-8 relative) and the parameters within 1e-6 of the update's size.
* A parameter that skips a step (no gradient) keeps its own count: it
  equals a reference optimizer that only saw that parameter's steps.
* The step counts are int32 device tensors; ``load_state_dict`` restores
  moments and counts bit for bit in their dtypes.
* ``adamw_update`` dispatches on the device: CPU tensors take the plain
  version and never load the kernel; any other device launches A1 or
  raises.

No test here runs A1: ``chip_smoke.py`` phase 11 holds it against the plain
version on the card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import optax

from horovod_tpu.ops import optim as joptim
from horovod_tpu_torch.ops import optim as toptim

KW = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1)
LR = 1e-3
SHAPES = {"w": (16, 9), "b": (9,), "e": (3, 1, 5)}


def _steps(seed, n=4):
    rng = np.random.RandomState(seed)
    params = {k: rng.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
    grads = [{k: (rng.randn(*s) * 10 ** rng.uniform(-4, 1)).astype(np.float32)
              for k, s in SHAPES.items()} for _ in range(n)]
    return params, grads


def _reference(params, grads, moment_dtype):
    opt = joptim.adamw(LR, moment_dtype=moment_dtype, **KW)
    p = {k: jnp.asarray(v) for k, v in params.items()}
    state = opt.init(p)
    for g in grads:
        upd, state = opt.update({k: jnp.asarray(v) for k, v in g.items()},
                                state, p)
        p = optax.apply_updates(p, upd)
    f = lambda t: {k: np.asarray(v.astype(jnp.float32)) for k, v in t.items()}
    return f(p), f(state.mu), f(state.nu), int(state.count)


def _plain(params, grads, moment_dtype):
    p = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    mu = {k: torch.zeros(v.shape, dtype=moment_dtype) for k, v in p.items()}
    nu = {k: torch.zeros(v.shape, dtype=moment_dtype) for k, v in p.items()}
    steps = {k: torch.zeros((), dtype=torch.int32) for k in p}
    keys = sorted(p)
    for g in grads:
        toptim.adamw_update_plain(
            [p[k] for k in keys], [torch.from_numpy(g[k]) for k in keys],
            [mu[k] for k in keys], [nu[k] for k in keys],
            [steps[k] for k in keys], lr=LR, **KW)
    f = lambda t: {k: v.float().numpy() for k, v in t.items()}
    return f(p), f(mu), f(nu), {k: int(v) for k, v in steps.items()}


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_update_matches_the_reference_fp32(seed):
    params, grads = _steps(seed)
    got = _plain(params, grads, torch.float32)
    want = _reference(params, grads, jnp.float32)
    for g, w, what in zip(got[:3], want[:3], ("params", "mu", "nu")):
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-6, atol=0,
                                       err_msg=f"{what}.{k}")
    assert set(got[3].values()) == {want[3]} == {len(grads)}


@pytest.mark.parametrize("seed", [2, 3])
def test_plain_update_matches_the_reference_bf16_moments(seed):
    params, grads = _steps(seed)
    got = _plain(params, grads, torch.bfloat16)
    want = _reference(params, grads, jnp.bfloat16)
    for g, w, what in zip(got[1:3], want[1:3], ("mu", "nu")):
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=2 ** -8, atol=0,
                                       err_msg=f"{what}.{k}")
    for k in want[0]:
        step = np.abs(want[0][k] - params[k]).max()
        np.testing.assert_allclose(got[0][k], want[0][k], rtol=0,
                                   atol=1e-6 * max(step, 1.0), err_msg=k)


def test_each_parameter_keeps_its_own_step_count():
    """"b" has no gradient in the first step: its count is one behind, and
    its update equals a reference optimizer that saw only its own steps."""
    params, grads = _steps(4, n=3)
    p = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
         for k, v in params.items()}
    opt = toptim.AdamW(list(p.values()), LR, moment_dtype=torch.float32,
                       **KW)
    for i, g in enumerate(grads):
        for k, v in g.items():
            p[k].grad = None if (i == 0 and k == "b") else torch.from_numpy(v)
        opt.step()
    for k in p:
        st = opt.state[p[k]]["step"]
        assert st.dtype == torch.int32 and st.device == p[k].device
        assert int(st) == (2 if k == "b" else 3)
    want = _reference({"b": params["b"]}, [{"b": g["b"]} for g in grads[1:]],
                      jnp.float32)
    np.testing.assert_allclose(p["b"].detach().numpy(), want[0]["b"],
                               rtol=1e-6, atol=0)
    np.testing.assert_allclose(opt.state[p["b"]]["nu"].numpy(), want[2]["b"],
                               rtol=1e-6, atol=0)


@pytest.mark.parametrize("mdt", [torch.bfloat16, torch.float32])
def test_load_state_dict_restores_moments_and_counts_bit_for_bit(mdt):
    params, grads = _steps(5, n=2)
    p = [torch.nn.Parameter(torch.from_numpy(params[k].copy()))
         for k in sorted(params)]
    opt = toptim.AdamW(p, LR, moment_dtype=mdt, **KW)
    for g in grads:
        for t, k in zip(p, sorted(params)):
            t.grad = torch.from_numpy(g[k])
        opt.step()
    sd = opt.state_dict()
    fresh = toptim.AdamW([torch.nn.Parameter(t.detach().clone()) for t in p],
                         0.5, moment_dtype=mdt, **KW)
    fresh.load_state_dict(sd)
    got = fresh.state_dict()
    assert got["param_groups"][0]["lr"] == LR
    for i, st in sd["state"].items():
        for key in ("mu", "nu", "step"):
            a, b = got["state"][i][key], st[key]
            assert a.dtype == b.dtype
            assert torch.equal(a, b), (i, key)
    assert got["state"][0]["step"].dtype == torch.int32


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    def refuse():
        raise AssertionError("the kernel path was taken")

    monkeypatch.setattr(toptim, "_kernels", refuse)
    toptim.reset_launch_counts()
    p = torch.nn.Parameter(torch.ones(4))
    opt = toptim.AdamW([p], 0.1)
    p.grad = torch.ones(4)
    opt.step()
    assert toptim.LAUNCHES == {"adamw": 0}
    assert int(opt.state[p]["step"]) == 1


def test_a_non_cpu_tensor_never_falls_back():
    toptim.reset_launch_counts()
    t = [torch.empty(8, device="meta")]
    s = [torch.zeros((), dtype=torch.int32, device="meta")]
    with pytest.raises(RuntimeError, match="no kernel for device meta"):
        toptim.adamw_update(t, t, t, t, s, lr=0.1, b1=0.9, b2=0.999,
                            eps=1e-8, weight_decay=0.0)
    assert toptim.LAUNCHES["adamw"] == 0


def test_step_counts_are_broadcast_with_the_optimizer_state():
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.parallel import optimizer as popt

    p = torch.nn.Parameter(torch.ones(3))
    opt = toptim.AdamW([p], 0.1)
    p.grad = torch.ones(3)
    opt.step()
    tensors = popt.optimizer_state_tensors(opt)
    assert sorted(tensors) == ["0.mu", "0.nu", "0.step"]
    assert tensors["0.step"].dtype == torch.int32
    hvd.init(device="cpu")
    try:
        hvd.broadcast_optimizer_state(opt, 0)
    finally:
        hvd.shutdown()
    assert int(opt.state[p]["step"]) == 1

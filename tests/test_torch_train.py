"""The slice as a whole: data-parallel training of a tiny ResNet with the
fused BatchNorm, ``horovod_tpu_torch`` against ``horovod_tpu``.

JAX side: ``hvd.spmd`` over 2 devices, ``allreduce_gradients`` (fused
group allreduce), ``optax.sgd(0.1, momentum=0.9)`` and the BN running
statistics averaged over the group after each update — the reference's
ResNet step (``bench.py``). Port side: a spawned 2-rank gloo world running
``Trainer`` + ``DistributedOptimizer(SGD(0.1, momentum=0.9))``. Both start
from the same (perturbed) flax weights and see the same per-rank batches,
made with numpy from a seed. A 1-rank in-process variant keeps one cheap
check of the whole path.

Tolerance: fp32 on the CPU, with convolutions and sums in different orders
in the two frameworks, compounded over 3 steps: losses rtol 1e-4; each
parameter and running statistic within 1e-4 × the tensor's largest
magnitude.
"""

import functools

import numpy as np
import pytest
import torch

STEPS = 3
CFG = dict(stage_sizes=[1, 1, 1, 1], num_classes=10, num_filters=8)


def _batches(world, steps=STEPS, n=8, size=32):
    rng = np.random.RandomState(42)
    return [[(rng.randn(n, size, size, 3).astype(np.float32),
              rng.randint(0, 10, size=n).astype(np.int64))
             for _ in range(world)] for _ in range(steps)]


def _port_model(state_dict):
    from horovod_tpu_torch.models import resnet

    model = resnet.ResNet(**CFG, dtype=torch.float32, norm_impl="fused")
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in state_dict.items()})
    return model


def _port_train(state_dict, batches):
    """Each rank: Trainer steps on its own batches; returns its losses and
    final state as numpy."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import resnet

    if not hvd.is_initialized():
        hvd.init(device="cpu")
    r = hvd.rank()
    model = _port_model(state_dict)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9))
    trainer = hvd.Trainer(model, resnet.make_loss_fn(model), opt,
                          has_aux=True)
    losses = []
    for step in batches:
        images, labels = step[r]
        loss, _ = trainer.train_step((torch.from_numpy(images),
                                      torch.from_numpy(labels)))
        losses.append(float(loss))
    return {"losses": losses,
            "state": {k: v.detach().numpy().copy()
                      for k, v in model.state_dict().items()},
            "plans": len(opt._allreduce._plans)}


def _port_synced_bn():
    """Synced FusedBatchNorm over the world equals one BN over the
    concatenated batch (forward and input gradient)."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.layers import FusedBatchNorm

    hvd.init(device="cpu")
    r, n = hvd.rank(), hvd.size()
    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.randn(n * 4, 3, 3, 8).astype(np.float32) + 1)
    w = torch.from_numpy(rng.randn(n * 4, 3, 3, 8).astype(np.float32))
    synced = FusedBatchNorm(8, dtype=torch.float32, group=0).train()
    whole = FusedBatchNorm(8, dtype=torch.float32).train()
    mine = x[4 * r: 4 * r + 4].clone().requires_grad_()
    (synced(mine) * w[4 * r: 4 * r + 4]).sum().backward()
    full = x.clone().requires_grad_()
    (whole(full) * w).sum().backward()
    with torch.no_grad():
        want = whole.eval()(x[4 * r: 4 * r + 4])
        got = synced.eval()(x[4 * r: 4 * r + 4])
    return {"y": float((got - want).abs().max()),
            "dx": float((mine.grad - full.grad[4 * r: 4 * r + 4]).abs().max()),
            "var": float((synced.var - whole.var).abs().max())}


def _port_fit_from_different_weights():
    """Ranks start from different weights and momentum; ``fit`` with
    BroadcastGlobalVariablesCallback(root 1) and MetricAverageCallback must
    leave identical replicas and identical logged metrics."""
    import horovod_tpu_torch as hvd

    r = hvd.rank()
    torch.manual_seed(r)
    model = torch.nn.Sequential(torch.nn.Linear(4, 3), torch.nn.ReLU(),
                                torch.nn.Linear(3, 1))
    sgd = torch.optim.SGD(model.parameters(), lr=0.05, momentum=0.9)
    model(torch.ones(2, 4)).sum().backward()
    sgd.step()  # a local step: momentum buffers now differ across ranks
    start = {k: v.detach().clone() for k, v in model.state_dict().items()}
    g = torch.Generator().manual_seed(10 + r)
    data = [(torch.randn(8, 4, generator=g), torch.randn(8, 1, generator=g))]

    def loss_fn(m, batch):
        x, y = batch
        return torch.nn.functional.mse_loss(m(x), y)

    trainer = hvd.Trainer(model, loss_fn, sgd)
    history = trainer.fit(data, epochs=2, steps_per_epoch=2, verbose=False,
                          callbacks=[hvd.BroadcastGlobalVariablesCallback(1),
                                     hvd.MetricAverageCallback()])
    return {"start": {k: v.numpy() for k, v in start.items()},
            "final": {k: v.detach().numpy().copy()
                      for k, v in model.state_dict().items()},
            "history": history["loss"]}


def _port_world(state_dict, batches):
    import horovod_tpu_torch as hvd

    out = _port_train(state_dict, batches)
    out["fit"] = _port_fit_from_different_weights()
    hvd.shutdown()
    out["synced_bn"] = _port_synced_bn()
    return out


@functools.lru_cache(maxsize=None)
def _flax_setup():
    import jax
    import jax.numpy as jnp

    from horovod_tpu.models import resnet as jresnet
    from horovod_tpu_torch.models import resnet as tresnet

    model = jresnet.ResNet(**CFG, dtype=jnp.float32, norm_impl="fused")
    variables = jax.jit(functools.partial(model.init, train=False))(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3), jnp.float32))
    rng = np.random.RandomState(0)

    def bump(path, leaf):
        a = np.asarray(leaf, np.float32)
        if path[-1].key == "var":
            return (a + rng.rand(*a.shape) + 0.5).astype(np.float32)
        if path[-1].key == "scale":
            return (a + rng.rand(*a.shape) * 0.5 + 0.5).astype(np.float32)
        return (a + rng.randn(*a.shape) * 0.1).astype(np.float32)

    variables = jax.tree_util.tree_map_with_path(bump, variables)
    sd = {k: v.numpy() for k, v in
          tresnet.from_flax_variables(variables).items()}
    return model, variables, sd


def _jax_train(world, batches, lr=0.1):
    """The reference DP step over ``world`` devices (SGD at ``lr``, momentum
    0.9); returns per-step per-rank losses and the final variables as a
    port state dict."""
    import jax
    import jax.numpy as jnp
    import optax

    import horovod_tpu as jhvd
    from horovod_tpu.models import resnet as jresnet
    from horovod_tpu_torch.models import resnet as tresnet

    model, variables, _ = _flax_setup()
    loss_fn = jresnet.make_loss_fn(model, weight_decay=1e-4,
                                   label_smoothing=0.1)
    opt = optax.sgd(lr, momentum=0.9)

    def train_step(variables, opt_state, batch):
        (loss, aux), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            variables, batch)
        grads = jhvd.allreduce_gradients(grads)
        updates, opt_state = opt.update(grads, opt_state, variables)
        variables = optax.apply_updates(variables, updates)
        variables = {"params": variables["params"],
                     "batch_stats": jax.tree.map(jhvd.allreduce,
                                                 aux["batch_stats"])}
        return variables, opt_state, loss

    jhvd.shutdown()
    jhvd.init(devices=jax.devices()[:world])
    try:
        step = jhvd.spmd(train_step)
        vs = jhvd.replicate(variables)
        opt_state = jhvd.replicate(opt.init(variables))
        losses = []
        for per_rank in batches:
            batch = jhvd.rank_stack([(jnp.asarray(i), jnp.asarray(l))
                                     for i, l in per_rank])
            vs, opt_state, loss = step(vs, opt_state, batch)
            losses.append(np.asarray(loss))
        final = jax.device_get(jax.tree.map(lambda t: t[0], vs))
    finally:
        jhvd.shutdown()
    sd = {k: v.numpy() for k, v in tresnet.from_flax_variables(final).items()}
    return np.stack(losses), sd


def _check_state(got, want):
    assert set(got) == set(want)
    for k in want:
        scale = float(np.abs(want[k]).max()) or 1.0
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                   atol=1e-4 * scale, err_msg=k)


@pytest.fixture(scope="module")
def two_rank():
    from horovod_tpu_torch.run import run

    _, _, sd = _flax_setup()
    batches = _batches(2)
    port = run(_port_world, 2, device="cpu", args=(sd, batches), timeout=180)
    jlosses, jstate = _jax_train(2, batches)
    return port, jlosses, jstate


@pytest.mark.parametrize("rank", [0, 1])
def test_two_rank_losses_match_jax(two_rank, rank):
    port, jlosses, _ = two_rank
    np.testing.assert_allclose(port[rank]["losses"], jlosses[:, rank],
                               rtol=1e-4)


@pytest.mark.parametrize("rank", [0, 1])
def test_two_rank_final_params_and_stats_match_jax(two_rank, rank):
    port, _, jstate = two_rank
    _check_state(port[rank]["state"], jstate)


def test_two_rank_replicas_identical_and_plan_cached(two_rank):
    port, _, _ = two_rank
    for k, v in port[0]["state"].items():
        np.testing.assert_array_equal(v, port[1]["state"][k], err_msg=k)
    # One gradient signature over 3 steps: negotiated once.
    assert port[0]["plans"] == port[1]["plans"] == 1


def test_fit_broadcasts_state_and_averages_metrics(two_rank):
    port, _, _ = two_rank
    a, b = port[0]["fit"], port[1]["fit"]
    assert any(not np.array_equal(a["start"][k], b["start"][k])
               for k in a["start"])
    for k in a["final"]:
        np.testing.assert_array_equal(a["final"][k], b["final"][k],
                                      err_msg=k)
    assert a["history"] == b["history"] and len(a["history"]) == 2


def test_synced_bn_equals_global_batch_bn(two_rank):
    port, _, _ = two_rank
    for out in port:
        bn = out["synced_bn"]
        assert bn["y"] < 1e-5 and bn["dx"] < 1e-5 and bn["var"] < 1e-6


def test_one_rank_in_process_matches_jax():
    import horovod_tpu_torch as hvd

    _, _, sd = _flax_setup()
    batches = _batches(1, steps=2)
    hvd.init(device="cpu")
    try:
        port = _port_train(sd, batches)
    finally:
        hvd.shutdown()
    jlosses, jstate = _jax_train(1, batches)
    np.testing.assert_allclose(port["losses"], jlosses[:, 0], rtol=1e-4)
    _check_state(port["state"], jstate)

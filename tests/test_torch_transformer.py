"""The LM slice: the port's Transformer against the JAX package's, and
data-parallel training of it.

A tiny config (vocab 97, 2 layers, H=4, Hkv=2, E=64, mlp 128) in fp32: the
flax parameters are carried into the port with ``from_flax_params``, and the
same numpy tokens (seeded) go through both models. Logits, the loss with and
without ``fused_head``, and the gradient of every parameter are compared.

Tolerance: attention computes its scores from bf16-rounded q and k and
multiplies bf16-rounded probabilities with v, on both sides, but at
rounding points that differ by ulps elsewhere (rotary, norms), so a
rounding of q/k/P can flip between the two: logits and loss to atol = rtol
= 1e-3, each gradient to 2e-2 of its own largest entry.

The training slice: a spawned 2-rank gloo world runs ``Trainer`` with
``DistributedOptimizer(AdamW)`` for 2 steps, each rank on its own batch row;
the replicas must stay identical, and the parameters must match one JAX
process taking the same 2 AdamW steps on the concatenated batch (the mean
over both rows' tokens is the mean of the two ranks' losses). The spawned
ranks import this module, so JAX is imported inside the parent-side
functions only.
"""

import functools

import numpy as np
import pytest
import torch

VOCAB, LAYERS, HEADS, KV_HEADS, EMBED, MLP = 97, 2, 4, 2, 64, 128
T = 24
LOGIT_TOL = dict(atol=1e-3, rtol=1e-3)
GRAD_REL = 2e-2
LR, WD, STEPS = 1e-2, 0.1, 2


def _port_config(**kw):
    from horovod_tpu_torch.models import transformer as tt

    return tt.TransformerConfig(
        vocab_size=VOCAB, num_layers=LAYERS, num_heads=HEADS,
        num_kv_heads=KV_HEADS, embed_dim=EMBED, mlp_dim=MLP, max_seq_len=64,
        dtype=torch.float32, **kw)


@functools.lru_cache(maxsize=None)
def _flax(window=None):
    import jax
    import jax.numpy as jnp

    from horovod_tpu.models import transformer as jt
    from horovod_tpu_torch.models import transformer as tt

    cfg = jt.TransformerConfig(
        vocab_size=VOCAB, num_layers=LAYERS, num_heads=HEADS,
        num_kv_heads=KV_HEADS, embed_dim=EMBED, mlp_dim=MLP, max_seq_len=64,
        dtype=jnp.float32, window=window)
    params = jax.device_get(jt.init_params(cfg, seed=0))
    # Perturb the unit norm scales so a misplaced scale shows.
    rng = np.random.RandomState(1)
    params = jax.tree_util.tree_map_with_path(
        lambda path, a: (np.asarray(a) + (rng.rand(*a.shape) * 0.5
                                          if path[-1].key == "scale" else 0))
        .astype(np.float32), params)
    sd = {k: v.numpy() for k, v in tt.from_flax_params(params).items()}
    return cfg, params, sd


def _tokens(b=2, t=T, seed=0):
    return np.random.RandomState(seed).randint(0, VOCAB, (b, t)) \
        .astype(np.int32)


def _port_model(sd, **cfg_kw):
    from horovod_tpu_torch.models import transformer as tt

    model = tt.Transformer(_port_config(**cfg_kw))
    model.load_state_dict({k: torch.from_numpy(v.copy())
                           for k, v in sd.items()})
    return model


def test_state_dict_names_and_shapes_match_the_module():
    _, _, sd = _flax()
    model = _port_model(sd)
    assert set(sd) == set(model.state_dict())
    for k, v in model.state_dict().items():
        assert tuple(v.shape) == sd[k].shape, k
    assert list(model.buffers()) == []       # nothing for Trainer to average


@pytest.mark.parametrize("window", [None, 8])
def test_logits_match_flax(window):
    import jax.numpy as jnp

    from horovod_tpu.models import transformer as jt

    cfg, params, sd = _flax(window)
    tokens = _tokens()
    want = jt.Transformer(cfg).apply({"params": params}, jnp.asarray(tokens))
    got = _port_model(sd, window=window)(torch.from_numpy(tokens).long())
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **LOGIT_TOL)


def test_segment_ids_and_offset_match_flax():
    import jax.numpy as jnp

    from horovod_tpu.models import transformer as jt

    cfg, params, sd = _flax()
    tokens = _tokens(seed=4)
    seg = np.zeros_like(tokens)
    seg[:, 10:] = 1
    want = jt.Transformer(cfg).apply(
        {"params": params}, jnp.asarray(tokens), shard_offset=5,
        segment_ids=jnp.asarray(seg))
    got = _port_model(sd)(torch.from_numpy(tokens).long(), shard_offset=5,
                          segment_ids=torch.from_numpy(seg))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **LOGIT_TOL)


@pytest.mark.parametrize("fused_head", [False, True])
def test_loss_and_gradients_match_flax(fused_head):
    import jax
    import jax.numpy as jnp

    from horovod_tpu.models import transformer as jt
    from horovod_tpu_torch.models import transformer as tt

    cfg, params, sd = _flax()
    tokens = _tokens(seed=2)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        jt.make_loss_fn(cfg, fused_head=fused_head)))(params,
                                                      jnp.asarray(tokens))
    want = {k: v.numpy() for k, v in
            tt.from_flax_params(jax.device_get(jgrads)).items()}
    model = _port_model(sd)
    loss = tt.make_loss_fn(_port_config(), fused_head=fused_head)(
        model, torch.from_numpy(tokens))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), **LOGIT_TOL)
    for name, p in model.named_parameters():
        w = want[name]
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0,
                                   atol=GRAD_REL * np.abs(w).max(),
                                   err_msg=name)


def test_not_ported_paths_raise():
    """The sequence-parallel paths, once refused here, are ported
    (tests/test_torch_sequence.py): they build, and they raise only where
    the reference does — ring and Ulysses attention outside an
    ``hvd.spmd`` program, the zigzag layout under local attention."""
    from horovod_tpu_torch.core.state import HorovodError
    from horovod_tpu_torch.models import transformer as tt

    tokens = torch.zeros((1, 8), dtype=torch.long)
    for kw, match in ((dict(attention="ring"), "ring_attention must be "
                       "called inside an hvd.spmd-wrapped step function"),
                      (dict(attention="ulysses"), "ulysses_attention must "
                       "be called inside an hvd.spmd-wrapped step "
                       "function"),
                      (dict(sp_layout="zigzag"), "only applies to "
                       "attention='ring'")):
        model = tt.Transformer(_port_config(**kw))
        loss_fn = tt.make_loss_fn(_port_config(**kw))
        with pytest.raises((ValueError, HorovodError), match=match):
            loss_fn(model, tokens)
    # The decode side is ported (tests/test_torch_decode.py): a decode
    # config builds, and its forward points at decode().
    model = tt.Transformer(_port_config(decode=True))
    with pytest.raises(ValueError, match="call decode"):
        model(torch.zeros((1, 1), dtype=torch.long))


def test_config_errors_match_flax():
    import jax.numpy as jnp

    from horovod_tpu.models import transformer as jt
    from horovod_tpu_torch.models import transformer as tt

    for kw in (dict(num_heads=3), dict(num_heads=4, num_kv_heads=3),
               dict(embed_dim=12, num_heads=4)):
        base = dict(vocab_size=VOCAB, num_layers=1, embed_dim=EMBED,
                    mlp_dim=MLP)
        base.update(kw)
        with pytest.raises(ValueError) as jerr:
            jt.init_params(jt.TransformerConfig(dtype=jnp.float32, **base))
        with pytest.raises(ValueError) as terr:
            tt.Transformer(tt.TransformerConfig(dtype=torch.float32, **base))
        assert str(terr.value) == str(jerr.value)


def test_init_params_is_seeded():
    from horovod_tpu_torch.models import transformer as tt

    a = tt.init_params(_port_config(), seed=3, device="cpu").state_dict()
    b = tt.init_params(_port_config(), seed=3, device="cpu").state_dict()
    c = tt.init_params(_port_config(), seed=4, device="cpu").state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["lm_head"], c["lm_head"])
    # flax's initialisers: N(0, 0.02) embedding, LeCun-normal kernels.
    assert abs(float(a["embed"].std()) - 0.02) < 2e-3
    assert abs(float(a["lm_head"].std()) - EMBED ** -0.5) < 0.1 * EMBED ** -0.5


def test_synthetic_tokens_seeded_and_in_range():
    from horovod_tpu_torch.models import transformer as tt

    a = tt.synthetic_tokens(2, 16, VOCAB, seed=1, device="cpu")
    assert a.shape == (2, 16) and a.dtype == torch.int64
    assert int(a.min()) >= 0 and int(a.max()) < VOCAB
    assert torch.equal(a, tt.synthetic_tokens(2, 16, VOCAB, seed=1,
                                              device="cpu"))


# -- data-parallel training -----------------------------------------------------

def _port_train(sd, tokens):
    """One rank: Trainer + DistributedOptimizer(AdamW) on its own row."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import transformer as tt
    from horovod_tpu_torch.ops.optim import AdamW

    hvd.init(device="cpu")
    model = _port_model(sd)
    opt = hvd.DistributedOptimizer(AdamW(model.parameters(), LR,
                                         weight_decay=WD))
    trainer = hvd.Trainer(model, tt.make_loss_fn(_port_config(),
                                                 fused_head=True), opt)
    mine = torch.from_numpy(tokens[hvd.rank():hvd.rank() + 1])
    losses = [trainer.train_step(mine)[0].item() for _ in range(STEPS)]
    return {"losses": losses,
            "state": {k: v.detach().numpy().copy()
                      for k, v in model.state_dict().items()}}


def _jax_train(tokens):
    import jax
    import jax.numpy as jnp
    import optax

    from horovod_tpu.models import transformer as jt
    from horovod_tpu.ops import optim as joptim
    from horovod_tpu_torch.models import transformer as tt

    cfg, params, _ = _flax()
    loss_fn = jt.make_loss_fn(cfg, fused_head=True)
    opt = joptim.adamw(LR, weight_decay=WD)

    @jax.jit
    def step(params, state, tokens):
        grads = jax.grad(loss_fn)(params, tokens)
        upd, state = opt.update(grads, state, params)
        return optax.apply_updates(params, upd), state

    state = opt.init(params)
    for _ in range(STEPS):
        params, state = step(params, state, jnp.asarray(tokens))
    return {k: v.numpy() for k, v in
            tt.from_flax_params(jax.device_get(params)).items()}


@pytest.fixture(scope="module")
def two_rank():
    from horovod_tpu_torch.run import run

    _, _, sd = _flax()
    tokens = _tokens(seed=3)
    port = run(_port_train, 2, device="cpu", args=(sd, tokens), timeout=180)
    return port, _jax_train(tokens), sd


def test_two_rank_replicas_identical(two_rank):
    port, _, sd = two_rank
    for k in sd:
        np.testing.assert_array_equal(port[0]["state"][k],
                                      port[1]["state"][k], err_msg=k)
        assert not np.array_equal(port[0]["state"][k], sd[k]), k


@pytest.mark.parametrize("rank", [0, 1])
def test_two_rank_params_match_jax_on_concatenated_batch(two_rank, rank):
    """Each AdamW step moves a parameter by up to about lr (m̂/√v̂ is near
    ±1 where the gradient dominates eps). Where a gradient entry is as
    small as the two frameworks' rounding differences, m̂/√v̂ itself moves;
    1% of the two steps' reach bounds that, far below one step."""
    port, want, sd = two_rank
    for k, w in want.items():
        np.testing.assert_allclose(port[rank]["state"][k], w, rtol=0,
                                   atol=1e-2 * LR * STEPS, err_msg=k)

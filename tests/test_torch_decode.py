"""The decode side of the port's Transformer against the JAX package's.

A small config (vocab 128, 2 layers, H=4, Hkv=2 — grouped-query attention —,
E=64, mlp 128, max_seq_len 64, fp32), with and without a sliding
``window``; one numpy-seeded flax parameter tree feeds both (the port
through ``from_flax_params``), and the same numpy-seeded tokens go through
both.

* Teacher-forced ``decode_step`` over a 24-token prompt: the logits at
  every step, and the dense cache after it, within atol = rtol = 1e-4 of
  JAX's (fp32 on both sides; the two differ only in summation order, read
  ~1e-6).
* ``prefill`` then ``decode_step`` equals ``generate`` bit for bit; greedy
  ``generate`` gives JAX's tokens.
* The paged ``kv_view`` carrier: a view holding the dense cache's K/V,
  ragged per-row positions, W = 1 and W = 3, against the dense path (logits
  and fresh K/V within 1e-5: the batch of two rows and the window of three
  tokens change the projections' summation order), and against JAX's
  paged apply for fp32, int8_block and int4 pages (logits within 1e-4, fresh quantized K/V
  and scales bit-identical).
* Within the port, with no decode code on the other side: teacher-forced
  ``decode_step`` logits against the training forward ``model(tokens)``
  at bf16 (the forward's attention takes bf16 operands, so fp32 would
  compare roundings): every position's relative L2 error within
  ``FORWARD_TOL`` — the limit ``chip_smoke.py`` holds the full-width model
  to on the card — and a visibility frontier moved one position on must
  exceed it.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from horovod_tpu.models import transformer as jt
from horovod_tpu_torch.models import transformer as tt
from horovod_tpu_torch.serving import kv_cache as tkv

from torch_lm_support import ARCH, configs, numpy_params, port_model

TOL = dict(atol=1e-4, rtol=1e-4)
VIEW_TOL = dict(atol=1e-5, rtol=1e-5)
FORWARD_TOL = 3e-2


@functools.lru_cache(maxsize=None)
def _models(window=None):
    jcfg, tcfg = configs(window=window)
    params = numpy_params(jcfg)
    return jcfg, params, tcfg, port_model(tcfg, params)


def _tokens(b, t, seed=0):
    return np.random.RandomState(seed).randint(
        0, ARCH["vocab_size"], (b, t)).astype(np.int32)


@pytest.mark.parametrize("window", [None, 8])
def test_teacher_forced_decode_step_matches_jax(window):
    jcfg, params, tcfg, model = _models(window)
    toks = _tokens(2, 24)
    jcache = jt.init_cache(jcfg, 2)
    tcache = tt.init_cache(tcfg, 2, device="cpu")
    jstep = jax.jit(functools.partial(jt.decode_step, jcfg))
    for t in range(toks.shape[1]):
        jl, jcache = jstep(params, jcache, toks[:, t])
        tl, tcache = tt.decode_step(tcfg, model, tcache, toks[:, t])
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL,
                                   err_msg=f"step {t}")
    assert tcache.index == 24
    for layer in range(ARCH["num_layers"]):
        jc = jcache[f"block_{layer}"]["attn"]
        assert int(jc["idx"]) == 24
        for name, mine in (("k", tcache.k), ("v", tcache.v)):
            np.testing.assert_allclose(mine[layer].numpy(),
                                       np.asarray(jc[name]), **TOL)


def _decode_vs_forward_err(tcfg, model, toks):
    with torch.no_grad():
        want = model(toks)
    cache = tt.init_cache(tcfg, toks.shape[0], device="cpu")
    got = torch.stack([tt.decode_step(tcfg, model, cache, toks[:, t])[0]
                       for t in range(toks.shape[1])], dim=1)
    return float(((got - want).norm(dim=-1) / want.norm(dim=-1)).max())


@pytest.mark.parametrize("window", [None, 8])
def test_teacher_forced_decode_matches_the_training_forward(window,
                                                           monkeypatch):
    jcfg, params, tcfg, _ = _models(window)
    tcfg = tcfg._replace(dtype=torch.bfloat16)
    model = port_model(tcfg, params)
    toks = torch.from_numpy(_tokens(2, 24, seed=3)).long()
    assert _decode_vs_forward_err(tcfg, model, toks) <= FORWARD_TOL
    visibility = tt._visibility
    monkeypatch.setattr(tt, "_visibility", lambda f, k, w: visibility(
        f + 1, k, w))
    assert _decode_vs_forward_err(tcfg, model, toks) > FORWARD_TOL


def test_prefill_then_decode_equals_generate():
    _, _, tcfg, model = _models()
    prompt = _tokens(2, 10, seed=2)
    out = tt.generate(tcfg, model, prompt, 8, device="cpu")
    assert out.shape == (2, 18) and out.dtype == torch.long
    cache, logits = tt.prefill(tcfg, model, prompt, device="cpu")
    assert cache.index == 10
    toks = [logits.argmax(-1)]
    for _ in range(7):
        logits, cache = tt.decode_step(tcfg, model, cache, toks[-1])
        toks.append(logits.argmax(-1))
    assert torch.equal(out[:, 10:], torch.stack(toks, 1))
    assert torch.equal(out[:, :10], torch.from_numpy(prompt).long())


@pytest.mark.parametrize("window", [None, 8])
def test_greedy_generate_matches_jax(window):
    jcfg, params, tcfg, model = _models(window)
    prompt = _tokens(2, 12, seed=3)
    want = np.asarray(jt.generate(jcfg, params, prompt, 10))
    got = tt.generate(tcfg, model, prompt, 10, device="cpu").numpy()
    np.testing.assert_array_equal(got, want)


def _dense_run(tcfg, model, row, length, steps):
    """One row through the dense path: its first ``length`` tokens, then
    ``steps`` more one at a time. Returns the cache after the first
    ``length`` tokens and the logits of the next ``steps``."""
    cache, _ = tt.prefill(tcfg, model, row[None, :length], device="cpu")
    snap = tt.DecodeCache(cache.k.clone(), cache.v.clone(), cache.index)
    logits = []
    for t in range(length, length + steps):
        lg, cache = tt.decode_step(tcfg, model, cache, row[None, t])
        logits.append(lg[0])
    return snap, (torch.stack(logits) if logits else None), cache


def _views(snaps, k_len, kvd=None):
    """One paged view per layer holding each row's dense-cache K/V (in
    ``kvd``'s format) and zeros past it."""
    out = []
    for layer in range(ARCH["num_layers"]):
        planes = []
        for name in ("k", "v"):
            rows = []
            for snap in snaps:
                x = getattr(snap, name)[layer, 0].clone()
                x[snap.index:] = 0
                rows.append(x[:k_len])
            planes.append(torch.stack(rows))
        if kvd is not None:
            qk, uk = tkv.quantize_kv(planes[0], kvd)
            qv, uv = tkv.quantize_kv(planes[1], kvd)
            planes = [qk, qv, uk, uv]
        out.append(tuple(planes))
    return out


@pytest.mark.parametrize("w", [1, 3])
def test_paged_view_matches_dense(w):
    """Rows at different positions (12 and 9), W tokens each, through the
    paged view against each row's own dense run."""
    _, _, tcfg, model = _models(8)
    toks = _tokens(2, 20, seed=4)
    lengths = (12, 9)
    runs = [_dense_run(tcfg, model, toks[r], lengths[r], w)
            for r in range(2)]
    views = _views([r[0] for r in runs], ARCH["max_seq_len"])
    pos = torch.tensor([[n + i for i in range(w)] for n in lengths])
    inp = torch.stack([torch.from_numpy(toks[r, n:n + w]).long()
                       for r, n in enumerate(lengths)])
    with torch.no_grad():
        logits, fresh = model.decode(inp, positions=pos, kv_views=views)
    for r, (_, want, dense) in enumerate(runs):
        torch.testing.assert_close(logits[r], want, **VIEW_TOL)
        for plane, cache in zip(fresh, (dense.k, dense.v)):
            got = plane[:, r] if w > 1 else plane[:, r][:, None]
            torch.testing.assert_close(
                got, cache[:, 0, lengths[r]:lengths[r] + w], **VIEW_TOL)
    # The views now hold the fresh K/V at the window's positions.
    assert torch.equal(views[0][0][0, 12:12 + w],
                       fresh[0][0, 0].reshape(w, *fresh[0].shape[-2:]))


@pytest.mark.parametrize("kvd,w", [("fp32", 1), ("fp32", 3),
                                   ("int8_block", 1), ("int4", 1)])
def test_paged_view_matches_jax(kvd, w):
    jcfg, params, tcfg, model = _models()
    toks = _tokens(2, 16, seed=5)
    lengths = (10, 7)
    snaps = [_dense_run(tcfg, model, toks[r], lengths[r], 0)[0]
             for r in range(2)]
    quant = kvd if tkv.kv_quantized(kvd) else None
    views = _views(snaps, ARCH["max_seq_len"], quant)
    jviews = [tuple(jnp.asarray(p.numpy()) if p.dtype != torch.bfloat16
                    else jnp.asarray(p.float().numpy()).astype(jnp.bfloat16)
                    for p in layer) for layer in views]
    pos = np.array([[n + i for i in range(w)] for n in lengths], np.int32)
    inp = np.stack([toks[r, n:n + w] for r, n in enumerate(lengths)])
    jmodel = jt.Transformer(jt.decode_config(jcfg)._replace(kv_dtype=kvd))
    jl, mut = jmodel.apply({"params": params}, jnp.asarray(inp),
                           positions=jnp.asarray(pos), kv_views=jviews,
                           mutable=["paged_kv"])
    with torch.no_grad():
        tl, fresh = model.decode(torch.from_numpy(inp).long(),
                          positions=torch.from_numpy(pos), kv_views=views,
                          kv_dtype=kvd)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    names = ("k", "v", "k_scale", "v_scale")[:len(fresh)]
    for name, mine in zip(names, fresh):
        want = np.stack([np.asarray(
            mut["paged_kv"][f"block_{layer}"]["attn"][name][0])
            for layer in range(ARCH["num_layers"])])
        got = mine.numpy() if mine.dtype != torch.bfloat16 else \
            mine.view(torch.int16).numpy()
        if mine.dtype == torch.bfloat16:
            want = want.view(np.int16)
        if quant:
            np.testing.assert_array_equal(got, want, err_msg=name)
        else:
            np.testing.assert_allclose(got, want, **TOL, err_msg=name)


def test_decode_errors_match_jax():
    jcfg, params, tcfg, model = _models()
    long = _tokens(1, 65)
    with pytest.raises(ValueError) as je:
        jt.prefill(jcfg, params, long)
    with pytest.raises(ValueError) as te:
        tt.prefill(tcfg, model, long, device="cpu")
    assert str(te.value) == str(je.value)
    with pytest.raises(ValueError) as je:
        jt.generate(jcfg, params, long[:, :60], 5)
    with pytest.raises(ValueError) as te:
        tt.generate(tcfg, model, long[:, :60], 5, device="cpu")
    assert str(te.value) == str(je.value)
    cache = tt.init_cache(tcfg, 1, device="cpu")
    with pytest.raises(ValueError, match="ONE token per call"):
        model.decode(torch.zeros((1, 2), dtype=torch.long), cache=cache)
    with pytest.raises(ValueError, match="one .k_view, v_view. pair per"):
        model.decode(torch.zeros((1, 1), dtype=torch.long),
                     positions=torch.zeros((1, 1), dtype=torch.long),
                     kv_views=[(cache.k[0], cache.v[0])])
    with pytest.raises(ValueError, match="call decode"):
        tt.Transformer(tt.decode_config(tcfg))(torch.zeros((1, 1),
                                                           dtype=torch.long))
    with pytest.raises(ValueError, match="embed_dim"):
        tt.decode_step(tcfg._replace(embed_dim=32), model, cache, [0])


def test_sampler_is_keyed_by_seed_stream_and_position():
    """Sampling at temperature > 0: the same (seed, stream, position) gives
    the same token whatever else rides in the batch; another seed or
    position gives other draws; temperature 0 is argmax."""
    logits = torch.randn(3, 1000, generator=torch.Generator().manual_seed(0))
    a = tt.sample_tokens(logits, 1.0, 7, torch.tensor([4, 5, 6]),
                         torch.tensor([10, 11, 12]))
    b = tt.sample_tokens(logits[1:2], 1.0, 7, torch.tensor([5]),
                         torch.tensor([11]))
    assert a[1] == b[0]
    draws = {int(tt.sample_tokens(logits[:1], 1.0, s, 0, p)[0])
             for s in range(4) for p in range(4)}
    assert len(draws) > 8
    assert torch.equal(tt.sample_tokens(logits, 0.0, 7, 0, 0),
                       logits.argmax(-1))
    # At a low temperature the draw follows the largest logit.
    assert torch.equal(tt.sample_tokens(logits, 1e-4, 7, 0, 0),
                       logits.argmax(-1))

"""Flash attention of the port (``horovod_tpu_torch.ops.flash_attention``)
against the JAX package's (``horovod_tpu.ops.flash_attention``).

On the CPU the port's ``flash_attention``/``flash_attention_lse`` take the
plain versions of kernels B3/B4; the JAX side runs its Pallas kernels in
interpret mode with 32×32 blocks (forward and backward), so its ragged,
padded, multi-partial dq paths are exercised too. Inputs come from numpy
with a seed, as explicit float32.

Checked: the output, the LSE, and dq/dk/dv of
``loss = Σ out² + Σ lse·w``, which feeds an LSE cotangent into the backward
(di' = di − g_lse). Tolerances are the JAX package's own for its kernels:
atol = rtol = 3e-2 forward, 6e-2 gradients — both sides round q, k, v, P
and dS to bf16, at points that differ (the TPU kernels fold
√(scale·log2e) into the bf16 operands; the port scales fp32 scores).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from horovod_tpu.ops import flash_attention as jfa
from horovod_tpu_torch.ops import flash_attention as tfa

FWD_TOL = dict(atol=3e-2, rtol=3e-2)
GRAD_TOL = dict(atol=6e-2, rtol=6e-2)
JAX_BLOCKS = dict(block_q=32, block_k=32, block_q_bwd=32, block_k_bwd=32,
                  block_kv_mem=32)


def _inputs(b, tq, tk, h, hkv, d, seed):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, tq, h, d).astype(np.float32)
    k = rng.randn(b, tk, hkv, d).astype(np.float32)
    v = rng.randn(b, tk, hkv, d).astype(np.float32)
    w = rng.randn(b, tq, h).astype(np.float32)
    return q, k, v, w


def _segments(b, t, cuts, ids):
    seg = np.zeros((b, t), np.int32)
    for c, i in zip(cuts, ids):
        seg[:, c:] = i
    return seg


# (id, (B, Tq, Tk, H, Hkv, D), kwargs, segment ids or None)
CASES = [
    ("causal", (1, 64, 64, 2, 2, 16), dict(causal=True), None),
    ("non_causal", (1, 64, 64, 2, 2, 16), dict(causal=False), None),
    ("gqa", (1, 64, 64, 4, 2, 16), dict(causal=True), None),
    ("offsets_ragged", (1, 80, 112, 4, 2, 16),
     dict(causal=True, q_offset=48, kv_offset=16), None),
    ("window", (1, 80, 80, 4, 2, 16), dict(causal=True, window=24), None),
    # Lengths past one 128-row kernel tile with four q heads to a kv head,
    # as chip_smoke.py's "GQA tile edges" case at a smaller head dim.
    ("gqa_tile_edges", (1, 130, 130, 8, 2, 16), dict(causal=False), None),
    # q ids (0, 1, 2) against kv ids (0, 1, 3): the last 16 q rows see no
    # key — dead rows (out 0, LSE very negative, zero gradients).
    ("segments_dead_rows", (1, 80, 80, 2, 1, 16), dict(causal=True),
     ((0, 30, 64), (0, 1, 2), (0, 1, 3))),
]


def _run_both(shape, kw, segs, seed=0):
    b, tq, tk, h, hkv, d = shape
    q, k, v, w = _inputs(b, tq, tk, h, hkv, d, seed)
    jkw, tkw = dict(kw), dict(kw)
    if segs is not None:
        cuts, qids, kvids = segs
        qs, ks = _segments(b, tq, cuts, qids), _segments(b, tk, cuts, kvids)
        jkw.update(q_segment_ids=jnp.asarray(qs),
                   kv_segment_ids=jnp.asarray(ks))
        tkw.update(q_segment_ids=torch.from_numpy(qs),
                   kv_segment_ids=torch.from_numpy(ks))

    def jloss(q, k, v):
        out, lse = jfa.flash_attention_lse(q, k, v, **JAX_BLOCKS, **jkw)
        return jnp.sum(out ** 2) + jnp.sum(lse * w), (out, lse)

    (_, (jout, jlse)), jgrads = jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True)(q, k, v)
    tq_, tk_, tv_ = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out, lse = tfa.flash_attention_lse(tq_, tk_, tv_, **tkw)
    ((out ** 2).sum() + (lse * torch.from_numpy(w)).sum()).backward()
    return ((out.detach().numpy(), lse.detach().numpy(),
             [x.grad.numpy() for x in (tq_, tk_, tv_)]),
            (np.asarray(jout), np.asarray(jlse),
             [np.asarray(g) for g in jgrads]))


@pytest.mark.parametrize("name,shape,kw,segs", CASES,
                         ids=[c[0] for c in CASES])
def test_flash_attention_lse_matches_jax(name, shape, kw, segs):
    (out, lse, grads), (jout, jlse, jgrads) = _run_both(shape, kw, segs)
    np.testing.assert_allclose(out, jout, **FWD_TOL)
    np.testing.assert_allclose(lse, jlse, **FWD_TOL)
    for got, want, wrt in zip(grads, jgrads, "qkv"):
        np.testing.assert_allclose(got, want, err_msg=f"d{wrt}", **GRAD_TOL)
    if segs is not None:
        dead = lse < tfa._DEAD_LSE
        assert dead.sum() == shape[0] * 16 * shape[3]
        assert (jlse[dead] < tfa._DEAD_LSE).all()
        assert np.all(out.transpose(0, 2, 1, 3)[dead.transpose(0, 2, 1)] == 0)


def test_flash_attention_matches_jax_gradients():
    """flash_attention (no LSE output) against JAX's, loss Σ out²."""
    q, k, v, _ = _inputs(1, 96, 96, 4, 2, 16, seed=3)
    got = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    (tfa.flash_attention(*got, True) ** 2).sum().backward()
    want = jax.grad(lambda q, k, v: jnp.sum(jfa.flash_attention(
        q, k, v, True, **JAX_BLOCKS) ** 2), argnums=(0, 1, 2))(q, k, v)
    for g, w, wrt in zip(got, want, "qkv"):
        np.testing.assert_allclose(g.grad.numpy(), np.asarray(w),
                                   err_msg=f"d{wrt}", **GRAD_TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_blockwise_attention_matches_jax(causal):
    q, k, v, _ = _inputs(1, 64, 64, 4, 2, 16, seed=4)
    got = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = tfa.blockwise_attention(*got, causal=causal, block_k=32)
    (out ** 2).sum().backward()
    jout = jfa.blockwise_attention(q, k, v, causal=causal, block_k=32)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               **FWD_TOL)
    want = jax.grad(lambda q, k, v: jnp.sum(jfa.blockwise_attention(
        q, k, v, causal=causal, block_k=32) ** 2), argnums=(0, 1, 2))(q, k, v)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.grad.numpy(), np.asarray(w), **GRAD_TOL)


def test_blockwise_attention_with_window_segments_and_offsets():
    q, k, v, _ = _inputs(1, 40, 72, 2, 1, 16, seed=5)
    qs = _segments(1, 40, (0, 20), (0, 1))
    ks = _segments(1, 72, (0, 50), (0, 1))
    kw = dict(causal=True, q_offset=32, kv_offset=0, block_k=16, window=30)
    out = tfa.blockwise_attention(
        *(torch.from_numpy(x) for x in (q, k, v)),
        q_segment_ids=torch.from_numpy(qs),
        kv_segment_ids=torch.from_numpy(ks), **kw)
    jout = jfa.blockwise_attention(q, k, v, q_segment_ids=jnp.asarray(qs),
                                   kv_segment_ids=jnp.asarray(ks), **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **FWD_TOL)


def test_blockwise_backward_keeps_no_score_matrix():
    """Each kv block runs under checkpoint: the autograd graph saves no
    (Tq, block_k) score or probability matrix, only the running state and
    the blocks' inputs."""
    q, k, v, _ = _inputs(1, 64, 64, 2, 2, 16, seed=6)
    got = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    saved = []

    def pack(t):
        saved.append((tuple(t.shape), t.dtype.is_floating_point))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = tfa.blockwise_attention(*got, causal=True, block_k=32)
    assert ((1, 2, 64, 16), True) in saved      # the running accumulator
    # (64, 32) appears only as the bool visibility mask of a block.
    assert not any(s[-2:] == (64, 32) and fp for s, fp in saved), saved
    (out ** 2).sum().backward()
    assert all(g.grad is not None for g in got)


def test_plain_versions_are_the_autograd_functions_on_cpu():
    """On CPU tensors the autograd Function runs the plain B3/B4 and counts
    no launch."""
    q, k, v, w = _inputs(1, 48, 48, 2, 2, 16, seed=7)
    tfa.reset_launch_counts()
    tq_, tk_, tv_ = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out, lse = tfa.flash_attention_lse(tq_, tk_, tv_)
    g_out = torch.from_numpy(np.random.RandomState(8).randn(*out.shape)
                             .astype(np.float32))
    torch.autograd.backward([out, lse], [g_out, torch.from_numpy(w)])
    p_out, p_lse = tfa.flash_fwd_plain(*(torch.from_numpy(x)
                                         for x in (q, k, v)))
    grads = tfa.flash_bwd_plain(*(torch.from_numpy(x) for x in (q, k, v)),
                                p_out, p_lse, g_out,
                                torch.from_numpy(w))
    torch.testing.assert_close(out.detach(), p_out, rtol=0, atol=0)
    torch.testing.assert_close(lse.detach(), p_lse.transpose(1, 2),
                               rtol=0, atol=0)
    for got, want in zip((tq_, tk_, tv_), grads):
        torch.testing.assert_close(got.grad, want, rtol=0, atol=0)
    assert tfa.LAUNCHES == {"flash_fwd": 0, "flash_bwd": 0}


@pytest.mark.parametrize("hkv,kw", [
    (3, {}),
    (4, dict(causal=False, window=8)),
    (4, dict(causal=True, window=0)),
    (4, dict(q_segment_ids="given")),
], ids=["gqa", "window_causal", "window_positive", "segs_alone"])
def test_error_texts_match_jax(hkv, kw):
    q, k, v, _ = _inputs(1, 16, 16, 4, hkv, 16, seed=9)
    seg = np.zeros((1, 16), np.int32)

    def args(to):
        return ((to(q), to(k), to(v)),
                {n: (to(seg) if x == "given" else x) for n, x in kw.items()})

    a, k_ = args(jnp.asarray)
    with pytest.raises(ValueError) as jerr:
        jfa.flash_attention(*a, **k_)
    for fn in (tfa.flash_attention, tfa.flash_attention_lse,
               tfa.blockwise_attention):
        a, k_ = args(torch.from_numpy)
        with pytest.raises(ValueError) as terr:
            fn(*a, **k_)
        assert str(terr.value) == str(jerr.value)

"""``local_attention`` of the port against the JAX package's, per impl.

Same numpy inputs (seeded, float32) through
``horovod_tpu.parallel.sequence.local_attention`` and
``horovod_tpu_torch.parallel.sequence.local_attention``: output and
dq/dk/dv of ``Σ out²``. On the CPU the JAX package's ``'flash'`` is its
Pallas kernel in interpret mode, the port's is the plain version of B3/B4;
``'auto'`` picks ``'xla'`` up to 2048 tokens on both sides and
``'blockwise'`` above (the T = 2304 case crosses the switch). Tolerances:
atol = rtol = 3e-2 forward, 6e-2 gradients, the JAX package's own for
attention with bf16 scores.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from horovod_tpu.parallel import sequence as jseq
from horovod_tpu_torch.core.state import HorovodError
from horovod_tpu_torch.parallel import sequence as tseq

FWD_TOL = dict(atol=3e-2, rtol=3e-2)
GRAD_TOL = dict(atol=6e-2, rtol=6e-2)


def _inputs(b, t, h, hkv, d, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, t, h, d).astype(np.float32),
            rng.randn(b, t, hkv, d).astype(np.float32),
            rng.randn(b, t, hkv, d).astype(np.float32))


def _compare(q, k, v, grads=True, **kw):
    jkw = {n: (jnp.asarray(x) if isinstance(x, np.ndarray) else x)
           for n, x in kw.items()}
    tkw = {n: (torch.from_numpy(x) if isinstance(x, np.ndarray) else x)
           for n, x in kw.items()}
    got = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = tseq.local_attention(*got, **tkw)
    jout = jseq.local_attention(q, k, v, **jkw)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               **FWD_TOL)
    if not grads:
        return
    (out ** 2).sum().backward()
    want = jax.grad(lambda q, k, v: jnp.sum(
        jseq.local_attention(q, k, v, **jkw) ** 2), argnums=(0, 1, 2))(q, k, v)
    for g, w, wrt in zip(got, want, "qkv"):
        np.testing.assert_allclose(g.grad.numpy(), np.asarray(w),
                                   err_msg=f"d{wrt}", **GRAD_TOL)


@pytest.mark.parametrize("impl", ["xla", "flash", "blockwise", "auto"])
@pytest.mark.parametrize("causal", [True, False])
def test_local_attention_matches_jax(impl, causal):
    q, k, v = _inputs(1, 64, 4, 2, 16, seed=1)
    _compare(q, k, v, causal=causal, impl=impl)


@pytest.mark.parametrize("impl", ["xla", "flash", "blockwise"])
def test_local_attention_window_and_segments(impl):
    q, k, v = _inputs(1, 48, 2, 1, 16, seed=2)
    seg = np.zeros((1, 48), np.int32)
    seg[:, 20:] = 1
    _compare(q, k, v, causal=True, impl=impl, window=16, q_segment_ids=seg,
             kv_segment_ids=seg)


def test_auto_crosses_to_blockwise_above_2048():
    """T = 2304: both packages leave the (T, T) 'xla' path for the online
    softmax ('blockwise' off the TPU and on a CPU tensor)."""
    q, k, v = _inputs(1, 2304, 2, 1, 16, seed=3)
    _compare(q, k, v, grads=False, causal=True, impl="auto")


def test_auto_uses_flash_for_cuda_tensors_only(monkeypatch):
    calls = []
    monkeypatch.setattr(tseq._fa, "flash_attention",
                        lambda *a, **k: calls.append("flash"))
    monkeypatch.setattr(tseq._fa, "blockwise_attention",
                        lambda *a, **k: calls.append("blockwise"))
    q = torch.zeros(1, 2049, 2, 16)
    tseq.local_attention(q, q, q)
    assert calls == ["blockwise"]
    meta = torch.zeros(1, 2049, 2, 16, device="meta")
    tseq.local_attention(meta, meta, meta)       # not CUDA: blockwise
    assert calls == ["blockwise", "blockwise"]


@pytest.mark.parametrize("kw", [
    dict(q_segment_ids="seg"),
    dict(impl="bogus"),
], ids=["segs_alone", "unknown_impl"])
def test_horovod_error_texts_match_jax(kw):
    q, k, v = _inputs(1, 8, 2, 2, 16)
    seg = np.zeros((1, 8), np.int32)
    jkw = {n: (jnp.asarray(seg) if x == "seg" else x) for n, x in kw.items()}
    tkw = {n: (torch.from_numpy(seg) if x == "seg" else x)
           for n, x in kw.items()}
    with pytest.raises(Exception) as jerr:
        jseq.local_attention(q, k, v, **jkw)
    with pytest.raises(HorovodError) as terr:
        tseq.local_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                             **tkw)
    assert type(jerr.value).__name__ == "HorovodError"
    assert str(terr.value) == str(jerr.value)

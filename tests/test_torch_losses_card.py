"""Kernel A2 (``horovod_tpu_torch/csrc/ce_head.cu``) on a CUDA card, against
the plain versions of ``ops/losses.py`` run on the same card.

The fused head is run twice on the same inputs: through A2 (what a CUDA
tensor takes) and with each chunk's fold and dlogits taken by
``fold_plain`` / ``dlogits_plain`` (``losses.plain_chunks()``, the same
matmuls), at

* the LM's head: N = 16,382, E = 1,024, V = 32,768, chunk 8,192, bf16;
* a ragged vocabulary: V = 50,257, a last chunk of 1,105 (odd: one
  element a thread at a time);
* fp32 operands (fp32 dlogits);
* V = 97 with chunk 32, targets on the chunks' first and last columns and
  in the remainder chunk of one column.

Limits: the loss within 2e-6 relative (the sums of exp are taken in
another order); dx and dW within one bf16 ulp of their largest entry in
bf16 (``max|want| · 2^-7`` bounds it: a dlogit on a rounding boundary
may round the other way) and within 1e-5 of it in fp32. A2 reruns give
the same bits; each chunk launches A2 once a direction (4 + 4 at the
LM's head) and the plain versions launch nothing; a CUDA graph that
captured the head and its backward, replayed with another upstream
gradient, equals the eager call with that gradient (the scale g / N is
read from the device). Marked ``card``; without a card each test skips.
On the card: ``python -m pytest --noconftest tests/test_torch_losses_card.py
-m card``.
"""

import pytest
import torch

from horovod_tpu_torch.ops import losses

BF16_ULP = 2.0 ** -7
FP32_TOL = 1e-5
LOSS_TOL = 2e-6

CASES = {
    "lm": (16_382, 1_024, 32_768, 8_192, torch.bfloat16),
    "ragged": (4_096, 256, 50_257, 8_192, torch.bfloat16),
    "fp32": (2_048, 256, 20_000, 8_192, torch.float32),
    "edges": (64, 32, 97, 32, torch.bfloat16),
}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: A2 is CUDA C++ with no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _inputs(name, device, seed=0):
    n, e, v, chunk, dtype = CASES[name]
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(n, e, generator=g, device=device).to(dtype)
    w = (torch.randn(e, v, generator=g, device=device) * e ** -0.5).to(dtype)
    t = torch.randint(0, v, (n,), generator=g, device=device)
    if name == "edges":
        t[:6] = torch.tensor([0, 31, 32, 63, 95, 96], device=device)
    return x, w, t, chunk


def _head(x, w, t, chunk, gain=None):
    xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
    loss = losses.fused_cross_entropy(xg, wg, t, chunk)
    (loss if gain is None else loss * gain).backward()
    return loss.detach(), xg.grad, wg.grad


def _plain(*args, **kw):
    """The head with each chunk's work taken by the plain versions."""
    with losses.plain_chunks():
        return _head(*args, **kw)


def _close(got, want, dtype):
    tol = (BF16_ULP if dtype != torch.float32 else FP32_TOL) \
        * want.float().abs().max().item()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol, (err, tol)


@pytest.mark.card
@pytest.mark.parametrize("name", sorted(CASES))
def test_a2_matches_the_plain_versions(card, name):
    x, w, t, chunk = _inputs(name, card)
    losses.reset_launch_counts()
    loss, dx, dw = _head(x, w, t, chunk)
    chunks = len(losses._chunks(w.shape[1], chunk))
    assert losses.LAUNCHES == {"ce_chunk_fwd": chunks,
                               "ce_chunk_bwd": chunks}
    want_loss, want_dx, want_dw = _plain(x, w, t, chunk)
    assert losses.LAUNCHES["ce_chunk_fwd"] == chunks   # plain launched none
    assert dx.dtype == x.dtype and dw.dtype == w.dtype
    rel = abs(loss.item() - want_loss.item()) / abs(want_loss.item())
    assert rel <= LOSS_TOL, rel
    _close(dx, want_dx, x.dtype)
    _close(dw, want_dw, x.dtype)


@pytest.mark.card
@pytest.mark.parametrize("name", ["lm", "ragged"])
def test_a2_reruns_are_bit_identical(card, name):
    x, w, t, chunk = _inputs(name, card, seed=1)
    first = _head(x, w, t, chunk)
    again = _head(x, w, t, chunk)
    for a, b in zip(first, again):
        assert torch.equal(a, b)


@pytest.mark.card
def test_a_replayed_capture_equals_the_eager_call(card):
    """The head and its backward captured once; replayed after the upstream
    gradient changed, it equals the eager call with the new gradient: the
    backward reads g / N from the device at every replay."""
    x, w, t, chunk = _inputs("ragged", card, seed=3)
    xs, ws = x.clone().requires_grad_(), w.clone().requires_grad_()
    gain = torch.ones((), device=card)

    def step():
        loss = losses.fused_cross_entropy(xs, ws, t, chunk)
        return (loss, *torch.autograd.grad(loss * gain, (xs, ws)))

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = step()
    for value in (3.0, 0.25):
        gain.fill_(value)
        graph.replay()
        torch.cuda.synchronize()
        want = _head(x, w, t, chunk, gain=gain)
        for a, b in zip(out, want):
            assert torch.equal(a, b), value

"""Kernel A2's wrapper (``horovod_tpu_torch/ops/losses.py``) on this
CPU-only host: what surrounds the CUDA kernels, which run on a card only
(``tests/test_torch_losses_card.py``).

* The vector width: the widest of 8, 4, 2, 1 elements that divides the
  chunk's width and keeps every operand's base aligned to its access
  (16 bytes at most), for the LM's chunk, ragged remainders (50,257 % 8,192
  = 1,105, odd) and bases off their alignment.
* ``launches.KERNELS`` names A2's two device functions and
  ``_build.SOURCES`` builds ``csrc/ce_head.cu``, whose two kernels have a
  plain C interface.
* CPU tensors take the plain versions and never load the library; a
  tensor on another device reaches the kernel or raises, and counts no
  launch, except inside ``losses.plain_chunks()``.
* The plain versions, chunk by chunk, give the row's log-sum-exp, the
  target's logit and ``(softmax − onehot) · scale``.
"""

import re

import pytest
import torch
import torch.nn.functional as F

from horovod_tpu_torch.ops import _build, launches, losses


@pytest.mark.parametrize("width,bases,want", [
    (8192, (0, 0), 8),           # the LM's chunk
    (1105, (0, 0), 1),           # 50,257 % 8,192: odd
    (97, (0, 0), 1),
    (6, (0, 0), 2),
    (12, (0, 0), 4),
    (3616, (0, 0), 8),           # 20,000 % 8,192
    (8192, (8, 0), 2),           # fp32 tile on 8 bytes only
    (8192, (4, 0), 1),
    (8192, (16, 8), 4),          # 16-bit output on 8 bytes: 4 of them
    (8192, (16, 4), 2),
    (8192, (16, 2), 1),
])
def test_vector_width(width, bases, want):
    tile, out = bases
    assert losses.vector_width(width, [(tile, 4), (out, 2)]) == want


@pytest.mark.parametrize("width", [1, 3, 8, 24, 1105, 8192])
def test_vector_width_alone_follows_the_width(width):
    vec = losses.vector_width(width, [(0, 4)])
    assert vec in losses.VECTOR_WIDTHS and width % vec == 0
    assert vec == 8 or width % (2 * vec) != 0


def test_the_launch_table_names_a2():
    assert launches.KERNELS["ce_chunk_fwd"] == ("ce_chunk_fwd_kernel",)
    assert launches.KERNELS["ce_chunk_bwd"] == ("ce_chunk_bwd_kernel",)
    assert set(losses.LAUNCHES) == {"ce_chunk_fwd", "ce_chunk_bwd"}


def test_the_build_includes_ce_head():
    assert "ce_head" in _build.SOURCES
    text = open(f"{_build.CSRC}/ce_head.cu").read()
    for fn in ("ce_chunk_fwd_kernel", "ce_chunk_bwd_kernel"):
        assert re.search(rf"__launch_bounds__\(kThreads\)\s+{fn}\(", text)
    for entry in ("int hvd_ce_chunk_fwd(", "int hvd_ce_chunk_bwd("):
        assert entry in text.split('extern "C" {')[1]
    assert "__expf" not in text and "atomicAdd" not in text


def _inputs(n=24, e=16, v=97, dtype=torch.float32, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(n, e, generator=g).to(dtype)
    w = (torch.randn(e, v, generator=g) * 0.5).to(dtype)
    t = torch.randint(0, v, (n,), generator=g)
    t[:4] = torch.tensor([96, 0, 31, 32])
    return x, w, t


@pytest.fixture
def no_kernel(monkeypatch):
    def refuse():
        raise AssertionError("the kernel path was taken")

    monkeypatch.setattr(losses, "_kernels", refuse)
    losses.reset_launch_counts()
    yield
    losses.reset_launch_counts()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_tensors_take_the_plain_path(no_kernel, dtype):
    x, w, t = _inputs(dtype=dtype)
    x.requires_grad_()
    w.requires_grad_()
    losses.fused_cross_entropy(x, w, t, 32).backward()
    assert x.grad.dtype == dtype and w.grad.dtype == dtype
    assert losses.LAUNCHES == {"ce_chunk_fwd": 0, "ce_chunk_bwd": 0}


@pytest.mark.parametrize("which", ["ce_chunk_fwd", "ce_chunk_bwd"])
def test_non_cpu_tensor_never_falls_back(no_kernel, which):
    """A tile that is not on the CPU reaches A2 or raises. (A meta tensor.)"""
    n, w = 9, 32
    logits = torch.empty(n, w, device="meta")
    t = torch.zeros(n, dtype=torch.int64, device="meta")
    row = torch.empty(n, device="meta")
    with pytest.raises(RuntimeError, match="no kernel for device meta"):
        if which == "ce_chunk_fwd":
            losses._fold(row, row, row, logits, t, 0)
        else:
            losses._dlogits(logits, t, 0, row, torch.ones((), device="meta"),
                            torch.bfloat16)
    assert losses.LAUNCHES[which] == 0


def test_the_head_on_meta_tensors_raises():
    x = torch.empty(9, 16, device="meta")
    w = torch.empty(16, 40, device="meta")
    with pytest.raises(RuntimeError, match="ce_chunk_fwd: no kernel"):
        losses.fused_cross_entropy(x, w, torch.zeros(9, dtype=torch.int64,
                                                     device="meta"), 16)


def test_plain_chunks_takes_the_plain_versions_on_any_device(no_kernel):
    """Inside ``plain_chunks`` a meta tensor's head runs the plain versions;
    the dispatch comes back as it was, after an error too."""
    x = torch.empty(9, 16, device="meta")
    w = torch.empty(16, 40, device="meta")
    t = torch.zeros(9, dtype=torch.int64, device="meta")
    with losses.plain_chunks():
        assert losses._fold is losses.fold_plain
        assert losses._dlogits is losses.dlogits_plain
        loss = losses.fused_cross_entropy(x, w, t, 16)
    assert loss.device.type == "meta" and loss.shape == ()
    assert losses.LAUNCHES == {"ce_chunk_fwd": 0, "ce_chunk_bwd": 0}
    with pytest.raises(ValueError, match="inside"):
        with losses.plain_chunks():
            raise ValueError("inside")
    with pytest.raises(RuntimeError, match="ce_chunk_fwd: no kernel"):
        losses.fused_cross_entropy(x, w, t, 16)


@pytest.mark.parametrize("chunk", [32, 97, 128])
def test_the_plain_folds_give_the_rows_logsumexp(chunk):
    x, w, t = _inputs(seed=1)
    logits = x @ w
    n = x.shape[0]
    m = torch.full((n,), float("-inf"))
    s, tl = torch.zeros(n), torch.zeros(n)
    for start, end in losses._chunks(w.shape[1], chunk):
        m, s, tl = losses.fold_plain(m, s, tl, logits[:, start:end], t,
                                     start)
    torch.testing.assert_close(m + torch.log(s),
                               torch.logsumexp(logits, -1))
    assert torch.equal(tl, logits.gather(1, t[:, None])[:, 0])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_the_plain_dlogits_are_the_scaled_softmax_gradient(dtype):
    x, w, t = _inputs(seed=2)
    logits = x @ w
    lse = torch.logsumexp(logits, -1)
    scale = torch.tensor(0.5)
    want = (F.softmax(logits, -1) - F.one_hot(t, w.shape[1])) * scale
    parts = [losses.dlogits_plain(logits[:, s:e], t, s, lse, scale, dtype)
             for s, e in losses._chunks(w.shape[1], 32)]
    got = torch.cat(parts, dim=1)
    assert got.dtype == dtype
    torch.testing.assert_close(got.float(), want.to(dtype).float(),
                               atol=1e-6, rtol=0)

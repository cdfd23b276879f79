"""The port's ground rules, checked on this CPU-only host.

* No module of ``horovod_tpu_torch`` — nor ``chip_smoke.py`` or
  ``tools/profile_torch_step.py`` — imports JAX, flax, optax or the JAX
  package (AST walk, and a clean-interpreter import).
* Entry points run on the GPU by default: ``hvd.init()``, the LM's
  ``init_params`` and ``synthetic_tokens`` without ``device="cpu"`` raise
  where CUDA is absent instead of drifting to the CPU.
* Kernel wrappers dispatch on the tensor's device alone: a CPU tensor takes
  the plain version; any other tensor launches the kernel or raises — there
  is no fallback, and no launch is counted that did not happen.
* ``chip_smoke.py`` fails, and prints no result, without a GPU.
"""

import ast
import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch.core import state as tstate
from horovod_tpu_torch.ops import batchnorm as tbn
from horovod_tpu_torch.ops import flash_attention as tfa

REPO = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "horovod_tpu"}


def _port_sources():
    files = sorted((REPO / "horovod_tpu_torch").rglob("*.py"))
    return files + [REPO / "chip_smoke.py",
                    REPO / "tools" / "profile_torch_step.py"]


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_imports(path):
    bad = sorted(set(_imported_roots(path)) & FORBIDDEN)
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_importing_the_port_loads_no_jax():
    mods = ["horovod_tpu_torch"] + [
        "horovod_tpu_torch." + ".".join(
            p.relative_to(REPO / "horovod_tpu_torch").with_suffix("").parts)
        for p in (REPO / "horovod_tpu_torch").rglob("*.py")
        if p.name != "__init__.py"]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            f"bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{sorted(FORBIDDEN)!r})\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]


def test_init_without_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    hvd.shutdown()
    with pytest.raises(hvd.HorovodError, match="device='cpu'"):
        hvd.init()
    assert not hvd.is_initialized()


@pytest.mark.parametrize("entry", ["init_params", "synthetic_tokens"])
def test_lm_entry_points_default_to_the_gpu(monkeypatch, entry):
    """The LM's entry points build on the GPU unless the caller passes
    ``device='cpu'``: without CUDA they raise rather than train on the CPU."""
    from horovod_tpu_torch.models import transformer as tt

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tt.TransformerConfig(vocab_size=17, num_layers=1, num_heads=2,
                               embed_dim=8, mlp_dim=16, max_seq_len=8)
    call = {"init_params": lambda: tt.init_params(cfg),
            "synthetic_tokens": lambda: tt.synthetic_tokens(1, 8, 17)}[entry]
    with pytest.raises((RuntimeError, AssertionError)) as err:
        call()
    if entry == "init_params":
        assert "device='cpu'" in str(err.value)


def test_unsupported_device_raises():
    with pytest.raises(hvd.HorovodError, match="unsupported device"):
        tstate._resolve_device("meta", 0)


@pytest.fixture
def no_kernel_build(monkeypatch):
    """Make any attempt to build or load the CUDA library fail loudly."""
    def refuse():
        raise AssertionError("the kernel path was taken")

    monkeypatch.setattr(tbn, "_kernels", refuse)
    tbn.reset_launch_counts()
    yield
    tbn.reset_launch_counts()


def test_cpu_tensor_takes_the_plain_path(no_kernel_build):
    x = torch.randn(9, 16)
    s1, s2 = tbn.channel_sums(x)
    torch.testing.assert_close(s1, x.sum(0))
    torch.testing.assert_close(s2, (x * x).sum(0))
    mean, rstd = x.mean(0), torch.rsqrt(x.var(0, unbiased=False) + 1e-5)
    tbn.channel_grad_sums(torch.randn(9, 16), x, mean, rstd)
    y, _, _ = tbn.batch_norm_train(x.requires_grad_(), torch.ones(16),
                                   torch.zeros(16))
    y.sum().backward()
    assert tbn.LAUNCHES == {"channel_sums": 0, "channel_grad_sums": 0}


@pytest.mark.parametrize("which", ["channel_sums", "channel_grad_sums"])
def test_non_cpu_tensor_never_falls_back(which):
    """A tensor that is not on the CPU must reach the kernel or raise; it
    never silently takes the plain version. (Here: a meta tensor.)"""
    tbn.reset_launch_counts()
    x = torch.empty(9, 16, device="meta")
    c = torch.empty(16, device="meta")
    with pytest.raises(RuntimeError, match="no kernel for device meta"):
        if which == "channel_sums":
            tbn.channel_sums(x)
        else:
            tbn.channel_grad_sums(x, x, c, c)
    assert tbn.LAUNCHES[which] == 0


@pytest.fixture
def no_flash_build(monkeypatch):
    def refuse():
        raise AssertionError("the kernel path was taken")

    monkeypatch.setattr(tfa, "_kernels", refuse)
    tfa.reset_launch_counts()
    yield
    tfa.reset_launch_counts()


def test_cpu_tensors_take_the_plain_flash_path(no_flash_build):
    q = torch.randn(1, 40, 2, 16, requires_grad=True)
    out, lse = tfa.flash_attention_lse(q, q, q)
    (out.sum() + lse.sum()).backward()
    assert q.grad is not None
    assert tfa.LAUNCHES == {"flash_fwd": 0, "flash_bwd": 0}


@pytest.mark.parametrize("which", ["flash_fwd", "flash_bwd"])
def test_non_cpu_flash_tensor_never_falls_back(which):
    """A flash operand that is not on the CPU reaches B3/B4 or raises."""
    tfa.reset_launch_counts()
    x = torch.empty(1, 40, 2, 16, device="meta")
    lse = torch.empty(1, 2, 40, device="meta")
    with pytest.raises(RuntimeError, match="no kernel for device meta"):
        if which == "flash_fwd":
            tfa.flash_fwd(x, x, x)
        else:
            tfa.flash_bwd(x, x, x, x, lse, x)
    assert tfa.LAUNCHES[which] == 0


def test_flash_kernels_refuse_other_head_dims():
    """The CUDA kernels are built for head dims 16/32/64/128 (ROADMAP §C);
    another head dim raises before any launch."""
    tfa.reset_launch_counts()
    x = torch.empty(1, 40, 2, 48, device="meta")
    with pytest.raises(ValueError, match=r"head dims \(16, 32, 64, 128\)"):
        tfa.flash_fwd(x, x, x)
    assert tfa.LAUNCHES["flash_fwd"] == 0


def test_chip_smoke_fails_without_a_gpu(tmp_path):
    """Without CUDA the script exits non-zero before any result line."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                          cwd=tmp_path, env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode != 0
    for line in proc.stdout.splitlines():
        if line.startswith("{"):
            assert json.loads(line).get("ok") is not True

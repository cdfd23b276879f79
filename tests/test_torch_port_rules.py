"""The port's ground rules, checked on this CPU-only host.

* No module of ``horovod_tpu_torch`` — nor ``chip_smoke.py``,
  ``tools/profile_torch_step.py``, ``tools/serve_bench_torch.py``,
  ``tools/timeline_torch.py``, ``tools/fault_drill_torch.py``,
  ``tools/hvd_lint_torch.py``, ``tools/hvd_model_torch.py``,
  ``tools/allreduce_bench_torch.py`` or ``tools/cost_model_torch.py`` —
  imports JAX, flax, optax or the JAX package (AST walk, and a
  clean-interpreter import).
* Entry points run on the GPU by default: ``hvd.init()``, the LM's
  ``init_params``, ``synthetic_tokens``, ``init_cache``, ``prefill`` and
  ``generate``, ``serving.Engine`` and every example's ``main``, without
  ``device="cpu"`` (``--device cpu``), raise where CUDA is absent instead
  of drifting to the CPU. Importing an example runs nothing.
* What the serving slice leaves out raises ``NotImplementedError`` naming
  its ROADMAP item: speculative decoding and the prefill/decode group
  split.
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
                    REPO / "tools" / "profile_torch_step.py",
                    REPO / "tools" / "serve_bench_torch.py",
                    REPO / "tools" / "timeline_torch.py",
                    REPO / "tools" / "fault_drill_torch.py",
                    REPO / "tools" / "allreduce_bench_torch.py",
                    REPO / "tools" / "cost_model_torch.py",
                    REPO / "tools" / "hvd_lint_torch.py",
                    REPO / "tools" / "hvd_model_torch.py"]


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
    assert "horovod_tpu_torch.examples.lm_generate" in mods
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
    # The examples' main runs only under __main__: importing prints nothing.
    assert proc.stdout == ""


def test_init_without_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    hvd.shutdown()
    with pytest.raises(hvd.HorovodError, match="device='cpu'"):
        hvd.init()
    assert not hvd.is_initialized()


@pytest.mark.parametrize("entry", ["init_params", "synthetic_tokens",
                                   "init_cache", "prefill", "generate",
                                   "Engine"])
def test_lm_entry_points_default_to_the_gpu(monkeypatch, entry):
    """The LM's entry points build on the GPU unless the caller passes
    ``device='cpu'``: without CUDA they raise rather than train or serve on
    the CPU."""
    from horovod_tpu_torch.models import transformer as tt

    cfg = tt.TransformerConfig(vocab_size=17, num_layers=1, num_heads=2,
                               embed_dim=8, mlp_dim=16, max_seq_len=8,
                               dtype=torch.float32)
    model = tt.init_params(cfg, device="cpu")
    prompt = torch.zeros((1, 3), dtype=torch.long)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    call = {"init_params": lambda: tt.init_params(cfg),
            "synthetic_tokens": lambda: tt.synthetic_tokens(1, 8, 17),
            "init_cache": lambda: tt.init_cache(cfg, 1),
            "prefill": lambda: tt.prefill(cfg, model, prompt),
            "generate": lambda: tt.generate(cfg, model, prompt, 2),
            "Engine": lambda: hvd.serving.Engine(cfg, model)}[entry]
    with pytest.raises((RuntimeError, AssertionError)) as err:
        call()
    if entry != "synthetic_tokens":
        assert "device='cpu'" in str(err.value)


EXAMPLES = sorted(p.stem for p in (REPO / "horovod_tpu_torch" /
                                   "examples").glob("*.py")
                  if p.name != "__init__.py")


@pytest.mark.parametrize("name", EXAMPLES)
def test_examples_default_to_the_gpu(monkeypatch, name):
    """Each example's ``main`` runs on the card unless given ``--device
    cpu``: without CUDA it raises instead of training on the CPU."""
    import importlib

    mod = importlib.import_module(f"horovod_tpu_torch.examples.{name}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    # grouped_collectives returns early in a world of fewer than 5 ranks,
    # long_context_transformer in one of an odd number, tp_transformer in
    # one of other than 8.
    monkeypatch.setenv("WORLD_SIZE", "8")
    hvd.shutdown()
    with pytest.raises(hvd.HorovodError, match="device='cpu'"):
        mod.main([])
    assert not hvd.is_initialized()


NINE_EXAMPLES = ["embedding_bag", "grouped_collectives", "imagenet_resnet50",
                 "keras_mnist", "keras_mnist_advanced", "lm_generate",
                 "mnist", "mnist_estimator", "word2vec"]


def test_the_nine_examples_are_ported():
    assert set(NINE_EXAMPLES) <= set(EXAMPLES)


def test_the_ten_examples_are_ported():
    assert set(NINE_EXAMPLES + ["long_context_transformer"]) <= set(EXAMPLES)


def test_the_thirteen_examples_are_ported():
    """Every example of the reference's ``examples/`` has its port."""
    reference = sorted(p.stem for p in (REPO / "examples").glob("*.py"))
    assert EXAMPLES == sorted(NINE_EXAMPLES + [
        "long_context_transformer", "moe_transformer", "parallelism_zoo",
        "tp_transformer"]) == reference


@pytest.mark.parametrize("module", ["parallel/sequence.py",
                                    "examples/long_context_transformer.py"])
def test_the_sequence_modules_are_held_to_the_no_jax_rule(module):
    path = REPO / "horovod_tpu_torch" / module
    assert path in _port_sources()
    assert not sorted(set(_imported_roots(path)) & FORBIDDEN)


ITEM_13_MODULES = ("parallel/tensor.py", "parallel/expert.py",
                   "parallel/pipeline.py", "examples/tp_transformer.py",
                   "examples/moe_transformer.py",
                   "examples/parallelism_zoo.py")


@pytest.mark.parametrize("module", ITEM_13_MODULES)
def test_the_tensor_expert_pipeline_modules_are_held_to_the_no_jax_rule(
        module):
    path = REPO / "horovod_tpu_torch" / module
    assert path in _port_sources()
    assert not sorted(set(_imported_roots(path)) & FORBIDDEN)


@pytest.mark.parametrize("fn", ["tp_attention", "moe_mlp", "gpipe"])
def test_the_parallel_functions_run_on_the_gpu_by_default(monkeypatch, fn):
    """They run inside ``hvd.spmd`` on ``hvd.init``'s device: without CUDA
    the default init raises, and eagerly each refuses with the reference's
    text (they never drift to the CPU on their own)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    hvd.shutdown()
    with pytest.raises(hvd.HorovodError, match="device='cpu'"):
        hvd.init()
    with pytest.raises(hvd.HorovodError, match="spmd-wrapped"):
        x = torch.zeros((1, 4, 8))
        {"tp_attention": lambda: hvd.tp_attention(
            x, torch.zeros(8, 8), torch.zeros(8, 8), torch.zeros(8, 8),
            torch.zeros(8, 8), (0,), num_heads=2),
         "moe_mlp": lambda: hvd.moe_mlp(
             x, torch.zeros(8, 1), torch.zeros(8, 4), torch.zeros(4),
             torch.zeros(4, 8), torch.zeros(8)),
         "gpipe": lambda: hvd.gpipe(lambda p, y: y, {}, x)}[fn]()


def _reference_all() -> list[str]:
    """The reference's ``__all__``, read statically."""
    tree = ast.parse((REPO / "horovod_tpu" / "__init__.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "__all__" for t in node.targets):
            return ast.literal_eval(node.value)
    raise AssertionError("no __all__ in horovod_tpu/__init__.py")


# Recorded in ROADMAP §C as intended divergences.
TOP_LEVEL_DIVERGENCES = {
    "AXIS_NAME": "a JAX mesh axis name; a process is a rank here",
    "ErrorFeedbackState": "the residual lives in the optimizer wrapper's "
                          "state (DistributedOptimizer(error_feedback=))",
}
# Not ported yet, under their ROADMAP §A item: none is left.
NOT_YET_PORTED: dict[str, int] = {}


def test_every_name_of_the_references_all_is_ported_or_recorded():
    names = _reference_all()
    assert "tp_attention" in names and "__version__" in names
    missing = [n for n in names if not hasattr(hvd, n)]
    assert sorted(missing) == sorted(set(TOP_LEVEL_DIVERGENCES)
                                     | set(NOT_YET_PORTED))
    roadmap = (REPO / "ROADMAP.md").read_text()
    for n in TOP_LEVEL_DIVERGENCES:
        assert f"`{n}`" in roadmap


@pytest.mark.parametrize("name", ["Compressor", "Bf16Compressor",
                                  "Int8Compressor", "sharded_optimizer",
                                  "column_parallel", "row_parallel",
                                  "shard_columns", "shard_rows",
                                  "tp_attention", "tp_mlp", "tp_mlp_sp",
                                  "moe_capacity", "moe_mlp", "gpipe",
                                  "pipeline_1f1b", "stage_split"])
def test_the_names_this_slice_binds_are_the_ports_own(name):
    obj = getattr(hvd, name)
    assert obj.__module__.startswith("horovod_tpu_torch.")


@pytest.mark.parametrize("fn", ["sharded_optimizer",
                                "sharded_zero2_optimizer"])
def test_sharded_optimizers_take_the_references_parameters(fn):
    """The reference's parameters in its order (an optimizer or builder in
    place of the optax transformation), then ``params`` for a builder."""
    import inspect

    from horovod_tpu.parallel import optimizer as jopt
    from horovod_tpu_torch.parallel import optimizer as topt

    want = list(inspect.signature(getattr(jopt, fn)).parameters)
    got = list(inspect.signature(getattr(topt, fn)).parameters)
    assert got == want + ["params"]


def test_models_binds_the_references_modules():
    import horovod_tpu.models as jm
    import horovod_tpu_torch.models as tm

    assert tm.__all__ == jm.__all__
    for n in tm.__all__:
        assert getattr(tm, n).__name__ == f"horovod_tpu_torch.models.{n}"


def test_make_loss_fn_takes_the_references_parameters():
    """``make_loss_fn(config, sp_rank=None, fused_head=False)``: a caller
    passing ``fused_head`` by position gets it where the reference puts
    it."""
    import inspect

    from horovod_tpu.models import transformer as jt
    from horovod_tpu_torch.models import transformer as tt

    def params(fn):
        return [(p.name, p.default) for p in
                inspect.signature(fn).parameters.values()]

    assert params(tt.make_loss_fn) == params(jt.make_loss_fn)
    assert [n for n, _ in params(tt.make_loss_fn)] == [
        "config", "sp_rank", "fused_head"]


@pytest.mark.parametrize("kw", [dict(attention="ring"),
                                dict(attention="ring", sp_layout="zigzag"),
                                dict(attention="ulysses")],
                         ids=["ring", "zigzag", "ulysses"])
def test_sequence_parallel_lm_defaults_to_the_gpu(monkeypatch, kw):
    """A ring or Ulysses config builds like a local one: on the GPU by
    default, raising without CUDA, and on the CPU when asked."""
    from horovod_tpu_torch.models import transformer as tt

    cfg = tt.TransformerConfig(vocab_size=17, num_layers=1, num_heads=2,
                               embed_dim=8, mlp_dim=16, max_seq_len=8,
                               dtype=torch.float32, **kw)
    assert isinstance(tt.init_params(cfg, device="cpu"), tt.Transformer)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tt.init_params(cfg)


@pytest.mark.parametrize("kw,what", [
    (dict(prefill_group=0, decode_group=1), "prefill_group"),
    (dict(prefill_group=0), "prefill_group"),
])
def test_serving_parts_not_ported_raise(kw, what):
    from horovod_tpu_torch.models import transformer as tt

    cfg = tt.TransformerConfig(vocab_size=17, num_layers=1, num_heads=2,
                               embed_dim=8, mlp_dim=16, max_seq_len=8,
                               dtype=torch.float32)
    model = tt.init_params(cfg, device="cpu")
    with pytest.raises(NotImplementedError) as err:
        hvd.serving.Engine(cfg, model, device="cpu", **kw)
    assert what in str(err.value)
    assert "ROADMAP §A item 14" in str(err.value)


@pytest.mark.parametrize("kw,want", [
    (dict(speculate=2), dict(speculate_k=2, draft_kv_dtype="int4")),
    (dict(speculate=2, draft_kv_dtype="int8_block"),
     dict(speculate_k=2, draft_kv_dtype="int8_block")),
    (dict(speculate=2, min_accept=0.5),
     dict(speculate_k=2, min_accept=0.5)),
])
def test_speculation_options_build_a_speculating_engine(kw, want):
    """``speculate=k`` with its options (ROADMAP §A item 14(b), ported)
    builds a speculating engine that serves."""
    from horovod_tpu_torch.models import transformer as tt

    cfg = tt.TransformerConfig(vocab_size=17, num_layers=1, num_heads=2,
                               embed_dim=8, mlp_dim=16, max_seq_len=8,
                               dtype=torch.float32)
    model = tt.init_params(cfg, device="cpu")
    eng = hvd.serving.Engine(cfg, model, device="cpu", block_size=4, **kw)
    for attr, value in want.items():
        assert getattr(eng, attr) == value, attr
    req = eng.submit([1, 2, 3], 3)
    eng.run_until_idle()
    assert len(req.output) == 3
    assert eng.verify_trace_count == 1 and eng.decode_trace_count == 0


def test_speculate_knob_builds_a_speculating_engine(monkeypatch):
    from horovod_tpu_torch.models import transformer as tt

    cfg = tt.TransformerConfig(vocab_size=17, num_layers=1, num_heads=2,
                               embed_dim=8, mlp_dim=16, max_seq_len=8,
                               dtype=torch.float32)
    model = tt.init_params(cfg, device="cpu")
    monkeypatch.setenv("HOROVOD_SERVE_SPECULATE", "4")
    monkeypatch.setenv("HOROVOD_SERVE_DRAFT_KV_DTYPE", "int8_block")
    eng = hvd.serving.Engine(cfg, model, device="cpu")
    assert (eng.speculate_k, eng.draft_kv_dtype) == (4, "int8_block")
    assert eng.cache_stats()["speculate_k"] == 4
    monkeypatch.setenv("HOROVOD_SERVE_SPECULATE", "0")
    with pytest.raises(ValueError, match="speculate=0"):
        hvd.serving.Engine(cfg, model, device="cpu", draft_config=cfg)
    with pytest.raises(ValueError, match="speculate must be >= 0"):
        hvd.serving.Engine(cfg, model, device="cpu", speculate=-1)
    with pytest.raises(ValueError, match="passed together"):
        hvd.serving.Engine(cfg, model, device="cpu", speculate=2,
                           draft_config=cfg)


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


# -- the knob registry ---------------------------------------------------------
# Every knob of the reference is registered in the port, with the ROADMAP §A
# item that ports it. At hvd.init a knob that changes what a run computes
# raises NotImplementedError naming its item, a knob that only tunes timing
# or reporting warns, and the JAX-only knobs draw nothing.

import warnings  # noqa: E402

from horovod_tpu_torch.core import resilience as tres  # noqa: E402
from horovod_tpu_torch.utils import env as tenv  # noqa: E402

# A value the reference accepts that turns on each knob that was a result
# knob the port refused (UNPORTED_RESULT_KNOBS, empty now), and its reader.
RESULT_VALUES = {
    "HOROVOD_ELASTIC": "1",
}
RESULT_READERS = {
    "HOROVOD_ELASTIC": ("elastic_enabled", True),
}
OFF_VALUES = {
    "HOROVOD_ALLREDUCE_ALGO": "flat",
    "HOROVOD_COMPRESSION": "none",
    "HOROVOD_ERROR_FEEDBACK": "0",
    "HOROVOD_SHARDING": "off",
    "HOROVOD_ELASTIC": "0",
}


@pytest.fixture
def clean_env(monkeypatch):
    for name in list(os.environ):
        if name.startswith("HOROVOD_"):
            monkeypatch.delenv(name)
    tres.reset_injector()
    hvd.shutdown()
    yield monkeypatch
    hvd.shutdown()
    tres.reset_injector()


def test_every_reference_knob_is_registered_once():
    from horovod_tpu.utils import env as jenv

    assert tenv.KNOWN_ENV_VARS == jenv.KNOWN_ENV_VARS
    classes = (tenv.PORTED_KNOBS, set(tenv.UNPORTED_RESULT_KNOBS),
               set(tenv.UNPORTED_TUNING_KNOBS), tenv.JAX_ONLY_KNOBS)
    assert sum(len(c) for c in classes) == len(jenv.KNOWN_ENV_VARS)
    # Every result knob, every tuning knob and every fault kind is ported.
    assert not tenv.UNPORTED_RESULT_KNOBS and not tenv.UNPORTED_FAULTS
    assert not tenv.UNPORTED_TUNING_KNOBS
    assert set(RESULT_VALUES) <= tenv.PORTED_KNOBS


@pytest.mark.parametrize("name", sorted(RESULT_VALUES))
def test_a_result_knob_raises_at_init_naming_its_item(clean_env, name):
    """The knobs this test refused until they were ported (ROADMAP §A item
    15, HOROVOD_ELASTIC) are accepted now: set, each draws neither a
    refusal nor a warning at hvd.init and is read as the reference reads
    it."""
    clean_env.setenv(name, RESULT_VALUES[name])
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        hvd.init(device="cpu")
    assert hvd.is_initialized()
    reader, want = RESULT_READERS[name]
    assert getattr(tenv, reader)() == want


@pytest.mark.parametrize("name", sorted(OFF_VALUES))
def test_a_result_knob_left_off_is_accepted(clean_env, name):
    clean_env.setenv(name, OFF_VALUES[name])
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        hvd.init(device="cpu")
    assert hvd.is_initialized()


@pytest.mark.parametrize("value,enabled", [("0", False), ("1", True)])
def test_the_eager_cache_knob_is_ported(clean_env, value, enabled):
    """HOROVOD_EAGER_CACHE (ROADMAP §A item 1, the eager verdict replay)
    is read by ``core/negotiate.py`` as the reference reads it: set, it
    draws no warning at hvd.init, and "0" alone turns the replay off."""
    from horovod_tpu.utils import env as jenv

    assert "HOROVOD_EAGER_CACHE" in tenv.PORTED_KNOBS
    assert "HOROVOD_EAGER_CACHE" not in tenv.UNPORTED_TUNING_KNOBS
    clean_env.setenv("HOROVOD_EAGER_CACHE", value)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        hvd.init(device="cpu")
    assert hvd.is_initialized()
    assert tenv.eager_cache_enabled() == jenv.eager_cache_enabled() \
        == enabled


MODEL_KNOBS = {"HOROVOD_MODEL_FAULTS": ("crash@rank=0,step=1",
                                         "crash@rnk=0,step=1"),
               "HOROVOD_MODEL_MAX_STATES": ("5000", "many")}


@pytest.mark.parametrize("name", sorted(MODEL_KNOBS))
def test_a_tuning_knob_warns_not_ported(clean_env, name):
    """The two tuning knobs this test warned for until they were ported
    (ROADMAP §A item 17, the protocol checker's) are read now: set to a
    valid value each draws no warning at hvd.init, and a typo raises the
    reference's text there."""
    from horovod_tpu.utils import env as jenv

    good, typo = MODEL_KNOBS[name]
    assert name in tenv.PORTED_KNOBS
    assert name not in tenv.UNPORTED_TUNING_KNOBS
    clean_env.setenv(name, good)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        hvd.init(device="cpu")
    assert hvd.is_initialized()
    hvd.shutdown()
    clean_env.setenv(name, typo)
    reader = getattr(jenv, "model_faults" if name.endswith("FAULTS")
                     else "model_max_states")
    with pytest.raises(ValueError) as want:
        reader()
    with pytest.raises(ValueError) as got:
        hvd.init(device="cpu")
    assert str(got.value) == str(want.value)
    assert not hvd.is_initialized()


@pytest.mark.parametrize("name,value", [("HOROVOD_DATA_DIR", "/data"),
                                        ("HOROVOD_PREFETCH_DEPTH", "2"),
                                        ("HOROVOD_SPARSE_PAD_CAPACITY",
                                         "64")])
def test_the_input_pipeline_knobs_are_ported(clean_env, name, value):
    """HOROVOD_DATA_DIR and HOROVOD_PREFETCH_DEPTH (ROADMAP §A items 5-6)
    are read by ``training/data.py``, HOROVOD_SPARSE_PAD_CAPACITY (item
    11) by ``ops/sparse.py``: set, they draw no warning."""
    assert name in tenv.PORTED_KNOBS
    assert name not in tenv.UNPORTED_TUNING_KNOBS
    clean_env.setenv(name, value)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        hvd.init(device="cpu")
    assert hvd.is_initialized()


# The gradient exchange's knobs (ROADMAP §A item 12(a), the decomposition
# half of 12(b) and its planner), each with a value the reference accepts.
EXCHANGE_VALUES = {
    "HOROVOD_ALLREDUCE_ALGO": "rs_ag",
    "HOROVOD_COMPRESSION": "int8",
    "HOROVOD_COMPRESSION_BLOCK": "64",
    "HOROVOD_COMPRESSION_CROSS_SLICE": "int4",
    "HOROVOD_ERROR_FEEDBACK": "1",
    "HOROVOD_EXCHANGE_CHANNELS": "2",
    "HOROVOD_EXCHANGE_SCHEDULE": "priority",
    "HOROVOD_MAX_CHANNELS": "4",
    "HOROVOD_SPARSE_DENSITY_THRESHOLD": "0.5",
    "HOROVOD_TOPOLOGY_SLICES": "1",
    "HOROVOD_TUNING_CACHE": "tuning.json",
}
# ZeRO's knobs (ROADMAP §A item 12(d)), each with values the reference
# accepts: the two that were result knobs here, and one more of each.
SHARDING_VALUES = [("HOROVOD_SHARDING", "zero2"),
                   ("HOROVOD_SHARDING", "zero3"),
                   ("HOROVOD_FSDP_AXIS_SIZE", "2"),
                   ("HOROVOD_FSDP_AXIS_SIZE", "1")]


@pytest.mark.parametrize("name", sorted(EXCHANGE_VALUES))
def test_the_exchange_knobs_are_ported(clean_env, name):
    """Set to a value the reference accepts, each is read by the port and
    draws neither a refusal nor a warning at hvd.init."""
    assert name in tenv.PORTED_KNOBS
    assert name not in tenv.UNPORTED_RESULT_KNOBS
    assert name not in tenv.UNPORTED_TUNING_KNOBS
    clean_env.setenv(name, EXCHANGE_VALUES[name])
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        hvd.init(device="cpu")
    assert hvd.is_initialized()


@pytest.mark.parametrize("name,value", SHARDING_VALUES)
def test_the_sharding_knobs_are_ported(clean_env, name, value):
    """HOROVOD_SHARDING and HOROVOD_FSDP_AXIS_SIZE (ROADMAP §A item 12(d))
    are read by the port: set, they draw neither a refusal nor a warning
    at hvd.init, and the sharding mode is what ``sharding=None`` takes."""
    from horovod_tpu_torch.ops import mesh

    assert name in tenv.PORTED_KNOBS
    assert name not in tenv.UNPORTED_RESULT_KNOBS
    assert name not in tenv.UNPORTED_TUNING_KNOBS
    clean_env.setenv(name, value)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        hvd.init(device="cpu")
    assert hvd.is_initialized()
    if name == "HOROVOD_SHARDING":
        assert mesh.resolve_sharding(None) == value
    else:
        assert tenv.fsdp_axis_size() == int(value)


# The knobs of profile-guided tuning and the device timeline (ROADMAP §A
# item 16), each with a value the reference accepts, and the reader that
# takes it (HOROVOD_TUNED_CONFIG: a committed pair, made in the test).
TUNING_VALUES = {
    "HOROVOD_AUTOTUNE": ("1", "autotune_enabled", True),
    "HOROVOD_PROFILE": ("off", "profile_mode", None),
    "HOROVOD_RECALIBRATION": ("0", "recalibration_enabled", False),
    "HOROVOD_TIMELINE_DEVICE": ("1", "timeline_device_mode", True),
    "HOROVOD_TIMELINE_DEVICE_INTERVAL": ("3", "timeline_device_interval",
                                         3),
    "HOROVOD_TUNED_CONFIG": (None, "tuned_config_path", None),
    "HOROVOD_TUNE_BUDGET_S": ("12.5", "tune_budget_seconds", 12.5),
}


@pytest.mark.parametrize("name", sorted(TUNING_VALUES))
def test_the_tuning_knobs_are_ported(clean_env, tmp_path, name):
    """Set, each draws neither a refusal nor a warning at hvd.init and is
    read; HOROVOD_TUNED_CONFIG's pair is applied."""
    assert name in tenv.PORTED_KNOBS
    assert name not in tenv.UNPORTED_TUNING_KNOBS
    value, reader, want = TUNING_VALUES[name]
    if name == "HOROVOD_TUNED_CONFIG":
        hvd.init(device="cpu")
        value = want = str(tmp_path / "one.tuned.json")
        hvd.tune(path=value, measure=lambda n, c: 1e-5 + n / 1e9,
                 apply=False)
        hvd.shutdown()
    clean_env.setenv(name, value)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        hvd.init(device="cpu")
    assert hvd.is_initialized()
    assert getattr(tenv, reader)() == want
    assert hvd.tune_report()["active"] == (name == "HOROVOD_TUNED_CONFIG")


@pytest.mark.parametrize("name", sorted(tenv.JAX_ONLY_KNOBS))
def test_a_jax_only_knob_draws_nothing(clean_env, name):
    clean_env.setenv(name, "8")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        hvd.init(device="cpu")
    assert hvd.is_initialized()


@pytest.mark.parametrize("spec", ["crash@step=3", "kv_timeout@seq=2",
                                  "regrow@step=4",
                                  "torn_write@epoch=1;crash@rank=0,step=1"])
def test_training_faults_the_port_does_not_inject_raise(clean_env, spec):
    """The training faults this test refused until they were ported
    (``crash``, ``kv_timeout``, ``regrow``: ROADMAP §A item 15) are
    accepted at hvd.init now, and the injector holds them as parsed."""
    clean_env.setenv("HOROVOD_FAULT_INJECT", spec)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        hvd.init(device="cpu")
    assert hvd.is_initialized()
    tres.reset_injector()
    assert [f.describe() for f in tres.injector()._faults] == \
        [f.strip() for f in spec.split(";")]


@pytest.mark.parametrize("spec", ["torn_write@epoch=2",
                                  "engine_crash@step=2;torn_write@epoch=0"])
def test_torn_write_and_serving_faults_are_accepted(clean_env, spec):
    clean_env.setenv("HOROVOD_FAULT_INJECT", spec)
    hvd.init(device="cpu")
    assert hvd.is_initialized()


def test_torn_write_injects_once_like_the_reference(clean_env, tmp_path):
    """``torn_write@epoch=2`` tears the save of epoch 2, once: both
    packages leave the same truncated bytes, and a retried save of the same
    epoch is whole."""
    from horovod_tpu.core import resilience as jres
    from horovod_tpu.training import checkpoint as jck
    from horovod_tpu_torch.training import checkpoint as tck

    clean_env.setenv("HOROVOD_FAULT_INJECT", "torn_write@epoch=2")
    tres.reset_injector()
    jres.reset_injector()
    data = bytes(range(256)) * 3
    try:
        for mod, sub in ((jck, "j"), (tck, "t")):
            (tmp_path / sub).mkdir()
            path = str(tmp_path / sub / "x")
            mod._atomic_write(path, data, fault_epoch=1)
            assert open(path, "rb").read() == data
            mod._atomic_write(path, data, fault_epoch=2)
            assert open(path, "rb").read() == data[:len(data) // 2]
            mod._atomic_write(path, data, fault_epoch=2)
            assert open(path, "rb").read() == data
    finally:
        jres.reset_injector()


@pytest.mark.parametrize("raw", [None, "", "0", "1", "2.5", "-3", "inf",
                                 "nan", "x"])
def test_stall_and_negotiation_timeout_parse_like_the_reference(
        monkeypatch, raw):
    from horovod_tpu.utils import env as jenv

    for name in ("HOROVOD_STALL_CHECK_TIME", "HOROVOD_NEGOTIATION_TIMEOUT"):
        if raw is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, raw)
    def outcome(fn):
        try:
            v = fn()
        except ValueError as e:
            return ("raises", str(e))
        return ("nan",) if v != v else v

    assert (outcome(tenv.stall_warning_seconds)
            == outcome(jenv.stall_warning_seconds))
    assert (outcome(tenv.negotiation_timeout_ms)
            == outcome(jenv.negotiation_timeout_ms))


# -- the exchange's API surface (ROADMAP §A item 12) ----------------------------

NEW_MODULES = ("ops/compression.py", "ops/exchange.py", "ops/strategy.py",
               "ops/topology.py", "utils/costs.py", "utils/rng.py")


ITEM_16_MODULES = ("tune/__init__.py", "tune/apply.py", "tune/artifact.py",
                   "tune/calibrate.py", "tune/search.py", "core/xprof.py",
                   "analysis/hlo.py", "analysis/report.py",
                   "analysis/schedule.py")


@pytest.mark.parametrize("module", ITEM_16_MODULES)
def test_the_tuning_modules_are_held_to_the_no_jax_rule(module):
    path = REPO / "horovod_tpu_torch" / module
    assert path in _port_sources()
    assert not sorted(set(_imported_roots(path)) & FORBIDDEN)


@pytest.mark.parametrize("module", NEW_MODULES)
def test_the_exchange_modules_are_held_to_the_no_jax_rule(module):
    path = REPO / "horovod_tpu_torch" / module
    assert path in _port_sources()
    assert not sorted(set(_imported_roots(path)) & FORBIDDEN)


WIRE_KEYWORDS = ("compression", "compression_key", "algo",
                 "cross_compression", "channels", "error_residual",
                 "error_feedback", "sparse_algo", "schedule", "priority_fn",
                 "sharded", "sharding", "fsdp_size")


@pytest.mark.parametrize("fn", ["allreduce", "allreduce_gradients",
                                "DistributedOptimizer"])
def test_every_exchange_keyword_of_the_reference_is_taken(fn):
    """Every wire/algorithm/channel/schedule keyword of the reference's
    function is in the port's signature (ZeRO's too)."""
    import inspect

    import horovod_tpu as jhvd

    want = [k for k in inspect.signature(getattr(jhvd, fn)).parameters
            if k in WIRE_KEYWORDS]
    got = inspect.signature(getattr(hvd, fn)).parameters
    assert want and all(k in got for k in want), sorted(set(want) - set(got))


@pytest.mark.parametrize("kw,kind", [
    ({"sharded": True}, "ShardedOptimizer"),
    ({"sharding": "zero2"}, "Zero2Optimizer"),
    ({"sharding": "zero3"}, "Zero3Optimizer"),
    ({"sharding": "zero2", "fsdp_size": 1}, "Zero2Optimizer")])
def test_zero_is_taken_by_the_optimizer(clean_env, kw, kind):
    """``sharded=True`` and ``sharding="zero2"|"zero3"`` (with
    ``fsdp_size``; ROADMAP §A item 12(d)) no longer raise: the optimizer
    returns the sharded wrapper, its inner optimizer built over the
    shards."""
    hvd.init(device="cpu")
    param = torch.nn.Parameter(torch.zeros(2))
    opt = hvd.DistributedOptimizer(torch.optim.SGD([param], lr=0.1), **kw)
    assert type(opt).__name__ == kind
    if kind != "Zero3Optimizer":
        assert [p.shape for g in opt.param_groups for p in g["params"]] \
            == [(2,)]


@pytest.mark.parametrize("kw", [{"schedule": "priority"},
                                {"schedule": "enum"},
                                {"sharding": "off", "schedule": "priority"}])
def test_the_planner_is_taken_by_the_optimizer(kw):
    """``schedule=`` (ROADMAP §A item 12(b)'s planner) no longer raises."""
    opt = hvd.DistributedOptimizer(torch.optim.SGD(
        [torch.nn.Parameter(torch.zeros(2))], lr=0.1), **kw)
    assert opt._allreduce.schedule == kw["schedule"]


def test_priority_fn_is_taken_by_the_gradient_path(clean_env):
    from horovod_tpu_torch.ops import exchange

    hvd.init(device="cpu")
    hvd.allreduce_gradients([torch.zeros(2), torch.zeros(3)],
                            schedule="priority",
                            priority_fn=lambda label, i: i)
    plan = exchange.last_plan()
    assert plan.mode == "priority"
    assert plan.members == (("allreduce_gradients.0",
                             "allreduce_gradients.1"),)


def test_every_callback_of_the_reference_is_reachable_as_hvd_callbacks():
    """``hvd.callbacks.<name>`` for every name of the JAX package's
    ``training.callbacks`` module that the port has (ROADMAP §C)."""
    from horovod_tpu.training import callbacks as jcb
    from horovod_tpu_torch.training import callbacks as tcb

    names = [n for n in vars(jcb) if not n.startswith("_")
             and isinstance(getattr(jcb, n), type) and hasattr(tcb, n)]
    assert "BroadcastGlobalVariablesCallback" in names
    for n in names:
        assert getattr(hvd.callbacks, n) is getattr(tcb, n)


@pytest.mark.parametrize("fn,kind", [("sharded_optimizer",
                                      "ShardedOptimizer"),
                                     ("sharded_zero2_optimizer",
                                      "Zero2Optimizer")])
@pytest.mark.parametrize("inner", ["torch_optim", "builder"])
def test_sharded_optimizers_wrap_an_optimizer_or_a_builder(clean_env, fn,
                                                          kind, inner):
    """``sharded_optimizer``/``sharded_zero2_optimizer`` return the ZeRO-1
    and ZeRO-2 wrappers over this rank's shards, from a ``torch.optim``
    optimizer or a ``training.sgd``/``adam`` builder with ``params``."""
    from horovod_tpu_torch import training
    from horovod_tpu_torch.parallel import optimizer as topt

    hvd.init(device="cpu")
    param = torch.nn.Parameter(torch.zeros(5))
    if inner == "torch_optim":
        opt = getattr(topt, fn)(torch.optim.SGD([param], lr=0.1))
    else:
        opt = getattr(topt, fn)(training.adam(0.1), params=[param])
    assert type(opt).__name__ == kind
    assert sum(p.numel() for g in opt.param_groups
               for p in g["params"]) == 5


def _tool(name: str):
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_the_schedule_gate_defaults_to_the_gpu(monkeypatch, capsys):
    """``tools/hvd_lint_torch.py --schedule`` runs its world on the GPU, a
    card a rank, unless ``--device cpu``: without the cards it raises (and
    the CLI exits 2) instead of drifting to gloo."""
    lint = _tool("hvd_lint_torch")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="--device cpu"):
        lint.schedule_gate()
    assert lint.main(["--schedule", "--no-env-check"]) == 2
    assert "--device cpu" in capsys.readouterr().err


def test_the_analysis_package_exports_the_references_names():
    import horovod_tpu_torch.analysis as tana
    from horovod_tpu import analysis as jana

    assert tana.__all__ == jana.__all__
    for name in jana.__all__:
        assert hasattr(tana, name), name
    assert tana.RULES == jana.RULES
    assert tana.render([tana.Finding("HVD001", "f.py", 3, "m")]) \
        == jana.render([jana.Finding("HVD001", "f.py", 3, "m")])


WIRE_CALLS = {"all_reduce", "all_gather", "reduce_scatter",
              "all_to_all_single", "all_to_all", "broadcast",
              "batch_isend_irecv", "isend", "irecv", "send", "recv",
              "all_gather_into_tensor", "reduce_scatter_tensor"}


@pytest.mark.parametrize("path", sorted(
    (REPO / "horovod_tpu_torch").rglob("*.py")),
    ids=lambda p: str(p.relative_to(REPO)))
def test_every_wire_call_goes_through_ops_wire(path):
    """The data path's ``torch.distributed`` collectives are called in
    ``ops/wire.py`` alone, so its recorder sees every one."""
    if path == REPO / "horovod_tpu_torch" / "ops" / "wire.py":
        return
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = sorted(
        node.lineno for node in ast.walk(tree)
        if isinstance(node, ast.Attribute) and node.attr in WIRE_CALLS
        and isinstance(node.value, ast.Name) and node.value.id == "dist")
    assert not bad, f"{path.relative_to(REPO)} calls dist at lines {bad}"

"""The port's serving fault tools against the JAX package's
(``tools/serve_bench.py``, ``tools/fault_drill.py``), on the CPU.

* ``tools/serve_bench_torch.py::bench_recovery`` on the tiny LM (its
  ``--smoke`` config, numpy-seeded flax weights for both frameworks)
  returns the reference's keys with ``bit_identical`` true, and the same
  ``requests``, ``recovered`` and ``interrupt_steps`` as the reference's
  ``bench_recovery`` on the same config, prompts and seed.
* ``positive_count`` and ``positive_duration`` refuse what the reference's
  refuse, with the same texts; ``--fault`` refuses a malformed spec before
  anything runs and arms a valid one; ``--max-requests`` caps the load and
  ``--duration`` refuses a trace it truncates to nothing, with the
  reference's text.
* ``tools/fault_drill_torch.py``'s ``serve`` scenario passes at
  ``--device cpu``: a journaled engine hard-killed mid-batch in a child
  (exit 43), restarted from its journal, every output's CRC equal to an
  uninterrupted child's.
"""

import os

import pytest

from horovod_tpu_torch.core import resilience as tres
from horovod_tpu_torch.models import transformer as tt

from tools import serve_bench as jsb
from tools import serve_bench_torch as sbt
from torch_lm_support import numpy_params

RECOVERY_KEYS = {"requests", "recovered", "interrupt_steps",
                 "serve_recovery_ms", "bit_identical", "kv_dtype"}


@pytest.fixture(scope="module")
def tiny():
    jcfg = jsb.tiny_config()
    params = numpy_params(jcfg)
    tcfg = sbt.tiny_config()
    model = tt.Transformer(tcfg)
    model.load_state_dict(tt.from_flax_params(params))
    return jcfg, params, tcfg, model


@pytest.fixture
def no_fault(monkeypatch):
    """No fault armed before or after the test: ``--fault`` writes
    ``HOROVOD_FAULT_INJECT`` itself, so the teardown pops it (a
    monkeypatch there would restore the armed spec on undo)."""
    monkeypatch.delenv("HOROVOD_FAULT_INJECT", raising=False)
    tres.reset_injector()
    yield monkeypatch
    os.environ.pop("HOROVOD_FAULT_INJECT", None)
    tres.reset_injector()


def test_bench_recovery_matches_the_reference(tiny, tmp_path):
    import jax
    import jax.numpy as jnp

    jcfg, params, tcfg, model = tiny
    want = jsb.bench_recovery(jcfg, jax.tree.map(jnp.asarray, params),
                              str(tmp_path / "jax.journal.json"))
    got = sbt.bench_recovery(tcfg, model, str(tmp_path / "port.journal.json"),
                             device="cpu")
    assert set(got) == set(want) == RECOVERY_KEYS
    assert got["bit_identical"] is True and want["bit_identical"] is True
    assert got["recovered"] >= 1
    for key in ("requests", "recovered", "interrupt_steps", "kv_dtype"):
        assert got[key] == want[key], key
    assert got["serve_recovery_ms"] > 0


def test_bench_recovery_is_bit_identical_on_an_int8_block_pool(tiny,
                                                               tmp_path):
    _, _, tcfg, model = tiny
    got = sbt.bench_recovery(tcfg, model, str(tmp_path / "q.journal.json"),
                             interrupt_steps=5, kv_dtype="int8_block",
                             device="cpu")
    assert got["bit_identical"] is True
    assert (got["recovered"], got["interrupt_steps"], got["kv_dtype"]) \
        == (4, 5, "int8_block")


BAD_VALUES = ["nan", "0", "-3", "inf", "abc", None, "1e400"]


@pytest.mark.parametrize("name,raw", [
    (name, raw) for name in ("positive_count", "positive_duration",
                             "positive_rate") for raw in BAD_VALUES]
    + [("positive_count", "12.5")], ids=str)
def test_the_validators_refuse_with_the_references_texts(name, raw):
    with pytest.raises(ValueError) as want:
        getattr(jsb, name)(raw)
    with pytest.raises(ValueError) as got:
        getattr(sbt, name)(raw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("name,raw,value", [
    ("positive_count", "7", 7), ("positive_count", "3.0", 3),
    ("positive_duration", "2.5", 2.5), ("positive_rate", "0.5", 0.5)])
def test_the_validators_take_what_the_reference_takes(name, raw, value):
    assert getattr(sbt, name)(raw) == getattr(jsb, name)(raw) == value


@pytest.mark.parametrize("spec", ["engine_crash@stp=3", "bogus@step=1",
                                  "engine_crash@step=x"])
def test_a_malformed_fault_refuses_before_anything_runs(no_fault,
                                                        monkeypatch, spec):
    from horovod_tpu.core import resilience as jres

    def ran(*args, **kw):
        raise AssertionError("the bench ran with a malformed --fault")

    monkeypatch.setattr(sbt, "tiny_config", ran)
    with pytest.raises(ValueError) as want:
        jres.parse_fault_spec(spec)
    with pytest.raises(ValueError) as got:
        sbt.main(["--smoke", "--device", "cpu", "--fault", spec])
    assert str(got.value) == str(want.value)
    assert "HOROVOD_FAULT_INJECT" not in os.environ


def test_a_valid_fault_is_armed(no_fault):
    args = sbt.parse_args(["--smoke", "--device", "cpu", "--fault",
                           "stuck_decode@step=3,ms=9000"])
    assert args.fault == os.environ["HOROVOD_FAULT_INJECT"]
    assert tres.injector().serve_fault_due("stuck_decode", 3) is not None


@pytest.mark.parametrize("argv,want", [
    (["--max-requests", "3"], 3),
    (["--max-requests", "40"], 16),
    ([], 16)])
def test_max_requests_caps_the_load(no_fault, argv, want):
    assert sbt.parse_args(argv).num_requests == want


def test_a_duration_that_truncates_everything_refuses(no_fault):
    with pytest.raises(SystemExit) as err:
        sbt.main(["--smoke", "--device", "cpu", "--arrival-rate", "0.5",
                  "--duration", "0.001"])
    assert str(err.value) == (
        "--duration 0.001s truncates the trace to zero arrivals at "
        "--arrival-rate 0.5/s — nothing to measure")


def test_the_drill_serve_scenario_passes_on_the_cpu(no_fault, tmp_path,
                                                    capsys):
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "_fault_drill_torch", os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            "tools", "fault_drill_torch.py"))
    drill = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(drill)
    assert "serve" in drill.SCENARIOS
    out = drill.scenario_serve("cpu", str(tmp_path))
    assert out["recovered"] >= 1
    assert len(out["crcs"]) == drill.SERVE_REQUESTS
    assert set(out["children_s"]) == {"reference", "crash", "restart"}
    printed = capsys.readouterr().out
    assert "exit 43" in printed and "CRC-identical" in printed

"""The port's source lints (``horovod_tpu_torch/analysis/lints.py``), its
``tools/hvd_lint_torch.py`` and the fault drill's ``--lint`` preflights,
held to the JAX package's ``horovod_tpu/analysis/lints.py``.

* every ``.py`` fixture of ``tests/lint_corpus``, its package name replaced
  in memory, gives the port's lint the JAX lint's ``(rule, line)`` rows and
  messages (HVD006 names the port's registry);
* the port's vocabulary: ``torch.compile`` and ``with torch.cuda.graph``
  trace, ``.tolist()`` and ``torch.cuda.synchronize()`` are host syncs;
* the suppression comment, HVD000 on a parse error, HVD006 against the
  port's registry;
* the port's package, ``tools/*_torch.py`` and ``chip_smoke.py`` lint
  clean;
* the CLI exits 0, 1 and 2 as the reference's does, with neither JAX nor
  torch importable;
* ``tools/fault_drill_torch.py --lint`` runs both preflights clean in a
  2-rank gloo world, and a planted rank-conditional collective in the
  drill's step stops it before any scenario.
"""

import os
import pathlib
import re
import subprocess
import sys

import pytest

from horovod_tpu_torch.analysis import lints as tlints
from horovod_tpu_torch.utils import env as tenv

REPO = pathlib.Path(__file__).resolve().parents[1]
CORPUS = REPO / "tests" / "lint_corpus"
CLI = REPO / "tools" / "hvd_lint_torch.py"
DRILL = REPO / "tools" / "fault_drill_torch.py"
FIXTURES = sorted(p.name for p in CORPUS.glob("*.py"))


def _port_text(text: str) -> str:
    return text.replace("horovod_tpu", "horovod_tpu_torch")


def _rows(findings):
    return [(f.rule, f.line, f.message) for f in findings]


@pytest.mark.parametrize("name", FIXTURES)
def test_corpus_fixture_rows_equal_the_jax_lint(name):
    from horovod_tpu.analysis import lints as jlints
    from horovod_tpu.utils import env as jenv

    text = (CORPUS / name).read_text()
    want = _rows(jlints.lint_source(text, name,
                                    known_env=jenv.KNOWN_ENV_VARS))
    got = _rows(tlints.lint_source(_port_text(text), name,
                                   known_env=tenv.KNOWN_ENV_VARS))
    assert want, f"{name} trips nothing in the JAX lint"
    assert [r[:2] for r in got] == [r[:2] for r in want]
    for (rule, _, msg), (_, _, jmsg) in zip(got, want):
        if rule == "HVD006":
            msg = msg.replace("horovod_tpu_torch.utils", "horovod_tpu.utils")
        assert msg == jmsg


def _rules(src: str) -> list:
    return [(f.rule, f.line) for f in tlints.lint_source(src)]


VOCABULARY = {
    "torch_compile_call": ("""import torch
import horovod_tpu_torch as hvd
def make(neg):
    def step(x):
        neg.negotiate("t", [], 2)
        return x
    return torch.compile(step)
""", [("HVD005", 5)]),
    "torch_compile_decorator": ("""import torch
@torch.compile(mode="max-autotune")
def step(x):
    return x.sum().item()
""", [("HVD004", 4)]),
    "cuda_graph_block": ("""import torch
def capture(g, x):
    with torch.cuda.graph(g):
        y = x * 2
        torch.cuda.synchronize()
    torch.cuda.synchronize()
    return y
""", [("HVD004", 5)]),
    "tolist_in_spmd": ("""import horovod_tpu_torch as hvd
def make():
    def step(x):
        return hvd.allreduce(x, name="x").tolist()
    return hvd.spmd(step)
""", [("HVD004", 4)]),
    "tolist_in_hot_loop": ("""def fit(trainer, batches):
    out = []
    for b in batches:
        loss, _ = trainer.train_step(b)
        out.append(loss.tolist())
    return out
""", [("HVD004", 5)]),
    "re_compile_is_no_wrapper": ("""import re
def pat(x):
    return x.item()
P = re.compile(pat)
""", []),
}


@pytest.mark.parametrize("case", sorted(VOCABULARY))
def test_the_ports_vocabulary(case):
    src, want = VOCABULARY[case]
    assert _rules(src) == want


def test_the_package_alias_is_the_ports():
    src = ("import horovod_tpu_torch as hvd\n"
           "from horovod_tpu_torch import allreduce, rank\n"
           "def f(x):\n"
           "    if hvd.rank() == 0:\n"
           "        x = hvd.allreduce(x, name='a')\n"
           "    if rank() == 1:\n"
           "        x = allreduce(x, name='b')\n"
           "    return x\n")
    assert _rules(src) == [("HVD001", 5), ("HVD001", 7)]
    # The JAX package's name is not the port's.
    assert _rules(src.replace("horovod_tpu_torch", "horovod_tpu")) == []


def test_suppression_comment():
    src = ("import horovod_tpu_torch as hvd\n"
           "def f(x, debug):\n"
           "    if debug:\n"
           "        x = hvd.allreduce(x)  # hvd-lint: disable=HVD003\n"
           "    return x\n")
    assert _rules(src) == []
    assert _rules(src.replace("  # hvd-lint: disable=HVD003", "")) \
        == [("HVD003", 4)]


def test_parse_error_is_hvd000():
    findings = tlints.lint_source("def broken(:\n", "bad.py")
    assert [f.rule for f in findings] == ["HVD000"]
    assert "could not parse" in findings[0].message


def test_hvd006_reads_the_ports_registry():
    src = ("import os\n"
           "a = os.environ.get('HOROVOD_COMPRESION')\n"
           "b = os.environ.get('HOROVOD_MODEL_MAX_STATES')\n"
           "c = os.environ['HOROVOD_EAGER_CACHE']\n")
    findings = tlints.lint_source(src, known_env=tenv.KNOWN_ENV_VARS)
    assert [(f.rule, f.line) for f in findings] == [("HVD006", 2)]
    assert ("horovod_tpu_torch.utils.env.KNOWN_ENV_VARS"
            in findings[0].message)


def _port_files():
    return (sorted((REPO / "horovod_tpu_torch").rglob("*.py"))
            + sorted((REPO / "tools").glob("*_torch.py"))
            + [REPO / "chip_smoke.py"])


def test_the_port_lints_clean():
    files = _port_files()
    assert REPO / "tools" / "hvd_lint_torch.py" in files
    findings = [f for p in files
                for f in tlints.lint_file(str(p),
                                          known_env=tenv.KNOWN_ENV_VARS)]
    assert findings == [], "\n".join(map(str, findings))


@pytest.fixture(scope="module")
def bare(tmp_path_factory):
    """An environment in which ``import jax`` and ``import torch`` fail: the
    CLI runs on a bare interpreter."""
    blocker = tmp_path_factory.mktemp("bare")
    for mod in ("jax", "torch"):
        (blocker / f"{mod}.py").write_text(
            f"raise ImportError('{mod} blocked: the tool must not need "
            f"it')\n")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("HOROVOD_")}
    env["PYTHONPATH"] = str(blocker)
    return env


def _cli(env, *args):
    return subprocess.run([sys.executable, str(CLI), *args], env=env,
                          capture_output=True, text=True, timeout=120)


def test_cli_exits_one_on_the_corpus(bare, tmp_path):
    # The corpus's sources name the JAX package: in the port's vocabulary
    # they name none, so the port's copy of one goes beside them.
    ported = tmp_path / "bad_rank_conditional.py"
    ported.write_text(_port_text(
        (CORPUS / "bad_rank_conditional.py").read_text()))
    proc = _cli(bare, str(CORPUS), str(ported), "--no-env-check")
    assert proc.returncode == 1, proc.stdout + proc.stderr
    assert re.search(r"/bad_rank_conditional\.py:\d+: HVD001", proc.stdout)
    assert re.search(r"lint_corpus/bad_wire_dtype\.hlo:\d+: HVD102",
                     proc.stdout)


def test_cli_exits_zero_on_the_port(bare):
    proc = _cli(bare, str(REPO / "horovod_tpu_torch"), str(CLI),
                str(REPO / "chip_smoke.py"))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "hvd-lint: clean" in proc.stdout


@pytest.mark.parametrize("args", [["--no-env-check"],
                                  ["no/such/target.py"],
                                  ["--ranks", "0", "--schedule"]])
def test_cli_exits_two_on_usage_errors(bare, args):
    proc = _cli(bare, *args)
    assert proc.returncode == 2, proc.stdout + proc.stderr


def test_cli_lists_the_rules(bare):
    proc = _cli(bare, "--list-rules")
    assert proc.returncode == 0
    for rule in ("HVD000", "HVD001", "HVD007", "HVD101", "HVD106",
                 "HVD201", "HVD206"):
        assert rule in proc.stdout


def _drill(*args):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("HOROVOD_")}
    return subprocess.run([sys.executable, str(DRILL), "--device", "cpu",
                           "--lint", *args], env=env, cwd=str(REPO),
                          capture_output=True, text=True, timeout=240)


def test_the_drills_preflights_run_clean():
    proc = _drill("--scenario", "kv_timeout")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    out = proc.stdout
    assert "lint: training-step collective schedule verified" in out
    assert "on 2 rank(s)" in out
    assert "model: negotiation/checkpoint protocol swept clean" in out
    assert out.index("model:") < out.index("[kv_timeout]")
    assert "FAULT DRILL PASSED" in out


def test_a_planted_fault_stops_the_drill_before_any_scenario():
    proc = _drill("--plant-lint-fault", "--scenario", "kv_timeout")
    assert proc.returncode != 0
    assert "LINT PREFLIGHT FAILED" in proc.stdout + proc.stderr
    assert re.search(r"<fault-drill training step>:\d+: HVD103",
                     proc.stdout)
    assert "[kv_timeout]" not in proc.stdout
    assert "FAULT DRILL PASSED" not in proc.stdout

"""The port's protocol checker (``horovod_tpu_torch/analysis/model.py``)
and ``tools/hvd_model_torch.py``, held to the JAX package's
``horovod_tpu/analysis/model.py``.

* every protocol function the checker drives equals the JAX function on
  the reference's inputs;
* on the worlds where the two protocols coincide (one group, batches of
  one: eager, allgather, checkpoint, journal, shrink, regrow) the port's
  checker explores the JAX checker's states, transitions and terminals,
  with its findings, at 2 and 3 processes, with and without the default
  faults;
* the worlds where they differ sweep clean with pinned counts: the
  subset group (a non-member skips its rounds here; the reference's
  memberless process submits an empty request), the overlapping groups
  ``[[0, 1], [1, 2]]`` and the batched round;
* each broken variant is convicted (the reference's, and the port's two
  under the restated HVD206), with minimal counterexamples, the same
  verdicts with the partial-order reduction off;
* the corpus worlds exit exactly 1 from the CLI, a state-cap overflow 2;
* the knobs ``HOROVOD_MODEL_MAX_STATES`` and ``HOROVOD_MODEL_FAULTS``
  read and refuse as the JAX package's do.
"""

import json
import os
import pathlib
import subprocess
import sys

import pytest

from horovod_tpu_torch.analysis import model as tmodel
from horovod_tpu_torch.analysis import protocol as tproto
from horovod_tpu_torch.analysis.model import Collective, World
from horovod_tpu_torch.utils import env as tenv

REPO = pathlib.Path(__file__).resolve().parents[1]
CORPUS = REPO / "tests" / "lint_corpus"
CLI = REPO / "tools" / "hvd_model_torch.py"
SHARED_KINDS = ("eager", "allgather", "checkpoint", "journal", "shrink",
                "regrow")


def _kind(label: str) -> str:
    return label.split(":")[1].split("-")[0]


def _specs(n: int) -> list:
    return [None] + tmodel.default_fault_specs(n)


# -- the protocol functions against the JAX package's ---------------------------


def _wire(rank, name, op, dtype="f32", shape=(4,), root=-1):
    return {"rank": rank, "name": name, "op": op, "dtype": dtype,
            "shape": list(shape), "root_rank": root, "group": 0}


PROTOCOL_CASES = {
    "coordinate": [
        ("coordinate", ({0: {"name": "g", "requests": [_wire(0, "g", 0)]},
                         1: {"name": "g", "requests": [_wire(1, "g", 0)]}},
                        "g", 3, 2)),
        ("coordinate", ({0: {"name": "g", "requests": [_wire(0, "g", 0)]},
                         1: {"name": "h", "requests": [_wire(1, "h", 0)]}},
                        "g", 7, 2)),
        ("coordinate", ({0: {"name": "x", "requests": [
            _wire(0, "x", 1, shape=(4, 2))]},
            1: {"name": "x", "requests": [_wire(1, "x", 1, shape=(6, 2))]}},
            "x", 0, 2)),
        ("coordinate", ({0: {"name": "b", "requests": [
            _wire(0, "b", 0, dtype="f32")]},
            1: {"name": "b", "requests": [_wire(1, "b", 0, dtype="f64")]}},
            "b", 1, 2)),
    ],
    "replay_fingerprint": [
        ("replay_fingerprint", ("grad", 0, 2, (0,), True)),
        ("replay_fingerprint", ("HorovodAllreduce_3", 0, 2, (0,), True)),
        ("replay_fingerprint", ("g", 1, 2, (1,), True)),
        ("replay_fingerprint", ("g", 0, 2, (0,), False)),
        ("replay_fingerprint", ("g", 2, 3, (), True)),
    ],
    "keys": [
        ("verdict_key", None), ("key_generation", ("hvd/neg/g7/s3/p2",)),
        ("key_generation", ("not/a/gen/key",)),
        ("join_key", (2, 5)), ("admit_key", (2, 5)),
        ("regrow_key", (4, 1)), ("hb_key", (3, 1)),
    ],
    "store": [
        ("classify_kv_message", (m,)) for m in (
            "DEADLINE_EXCEEDED: GetKeyValue() timed out",
            "UNAVAILABLE: connection timed out",
            "CANCELLED: coordination service has stopped",
            "something novel")] + [
        ("retry_decision", a) for a in (
            ("pending", "get", 0, 3, "x"), ("transient", "get", 0, 3, "x"),
            ("transient", "get", 3, 3, "x"),
            ("fatal", "set", 1, 3, "ALREADY_EXISTS: key"),
            ("fatal", "set", 0, 3, "ALREADY_EXISTS: key"))],
    "faults": [
        ("kv_fault_covering", (tproto.parse_fault_spec(
            "kv_timeout@seq=2,times=3"), s)) for s in range(6)] + [
        ("crash_fault_matching", (tproto.parse_fault_spec(
            "crash@rank=1,step=5"), 5, r)) for r in ((1,), (0,))] + [
        ("torn_write_index", (tproto.parse_fault_spec(
            "torn_write@epoch=1"), e, ())) for e in (0, 1)],
    "liveness_and_elastic": [
        ("judge_dead", ({0: 120.0, 1: 240.0}, 240.0, 60.0)),
        ("agree_epochs", ([{0, 1, 3}, {0, 3}, {1, 3}],)),
        ("agree_epochs", ([{0, 1}, {2}],)),
        ("agree_epochs", ([],)),
        ("plan_shrink", ((0, 1, 2, 3), (2,), 5)),
        ("plan_shrink", ((0, 1, 2), (0,), 1)),
        ("plan_regrow", ((0, 1), {2: "hvd/join/j0/p2"}, 3)),
    ],
    "journal": [
        ("journal_committed", ([{"kind": "admit", "rid": 0, "max_new": 4},
                                {"kind": "emit", "rid": 0, "start": 0,
                                 "tokens": [101]},
                                {"kind": "torn"}],), {"include_torn": torn})
        for torn in (False, True)],
}


def _call(mod, fname, args, kwargs):
    try:
        return ("ok", getattr(mod, fname)(*args, **kwargs))
    except ValueError as e:
        return ("raise", str(e))


@pytest.mark.parametrize("family", sorted(PROTOCOL_CASES))
def test_protocol_functions_equal_the_jax_package(family):
    from horovod_tpu.analysis import protocol as jproto

    for fname, args, *kw in PROTOCOL_CASES[family]:
        kwargs = kw[0] if kw else {}
        if fname == "verdict_key":
            # The port's keys carry the group (ROADMAP §C): the group-0
            # key is the reference's with a grp segment.
            assert tproto.verdict_key(7, 0, 4) == "hvd/resp/g7/grp0/s4"
            assert jproto.verdict_key(7, 4) == "hvd/resp/g7/s4"
            assert tproto.neg_key(7, 2, 3, 1) == "hvd/neg/g7/grp2/s3/p1"
            assert (tproto.key_generation(tproto.neg_key(7, 2, 3, 1))
                    == jproto.key_generation(jproto.neg_key(7, 3, 1)) == 7)
            continue
        got = _call(tproto, fname, args, kwargs)
        want = _call(jproto, fname, args, kwargs)
        if fname in ("plan_shrink", "plan_regrow"):
            got = ("ok", vars(got[1])) if got[0] == "ok" else got
            want = ("ok", vars(want[1])) if want[0] == "ok" else want
        assert got == want, (fname, args)


def test_op_table_and_verdict_canonical_equal_the_jax_package():
    from horovod_tpu.analysis import protocol as jproto

    assert tproto.OP_BY_NAME == jproto.OP_BY_NAME
    for kw in ({"name": "g", "op": 1, "dtype": "f32",
                "tensor_sizes": (2, 3), "root_rank": -1},
               {"error": "Mismatched data types"}):
        assert (tproto.Verdict(**kw).canonical()
                == jproto.Verdict(**kw).canonical())


# -- the shared worlds: the JAX checker's counts and findings --------------------


@pytest.mark.parametrize("n,spec", [(n, s) for n in (2, 3)
                                    for s in _specs(n)])
def test_shared_worlds_explore_what_the_jax_checker_explores(n, spec):
    from horovod_tpu.analysis import model as jmodel
    from horovod_tpu.analysis import protocol as jproto

    jw = {_kind(w.label): w
          for w in jmodel.standard_worlds(n, jproto.parse_fault_spec(spec))}
    seen = set()
    for world in tmodel.standard_worlds(n, tproto.parse_fault_spec(spec)):
        kind = _kind(world.label)
        if kind not in SHARED_KINDS:
            continue
        seen.add(kind)
        got = tmodel.check_world(world)
        want = jmodel.check_world(jw[kind])
        assert world.label == jw[kind].label
        assert (got.states, got.transitions, got.terminals) == (
            want.states, want.transitions, want.terminals), world.label
        assert ([(f.rule, f.line) for f in got.findings]
                == [(f.rule, f.line) for f in want.findings])
    assert seen == set(jw) & set(SHARED_KINDS)


# The port's own worlds: (kind, n, spec index) -> (states, transitions).
PORT_COUNTS = {
    ("memberless", 2, 0): (10, 13), ("batch", 2, 0): (11, 13),
    ("memberless", 3, 0): (16, 24), ("batch", 3, 0): (22, 34),
    ("overlap", 3, 0): (25, 39),
    ("memberless", 2, 1): (14, 19), ("batch", 2, 1): (15, 17),
    ("memberless", 3, 1): (22, 34), ("batch", 3, 1): (28, 44),
    ("overlap", 3, 1): (31, 49),
    ("memberless", 3, 3): (22, 38), ("overlap", 3, 3): (25, 41),
}


@pytest.mark.parametrize("n,spec", [(n, s) for n in (2, 3)
                                    for s in range(4)])
def test_the_ports_own_worlds_sweep_clean(n, spec):
    faults = tproto.parse_fault_spec(_specs(n)[spec])
    for world in tmodel.standard_worlds(n, faults):
        if _kind(world.label) in SHARED_KINDS:
            continue
        res = tmodel.check_world(world)
        assert res.ok, "\n".join(map(str, res.findings))
        pin = PORT_COUNTS.get((_kind(world.label), n, spec))
        if pin is not None:
            assert (res.states, res.transitions) == pin, world.label


def test_the_memberless_world_differs_from_the_reference_as_recorded():
    """ROADMAP §C: a non-member skips a subset group's rounds, so the
    subset world is smaller than the reference's, where every process
    negotiates every round; the reference's "skip_memberless" variant is
    the port's shipped protocol and convicts nothing here."""
    from horovod_tpu.analysis import model as jmodel

    port = {_kind(w.label): w for w in tmodel.standard_worlds(3)}
    ref = {_kind(w.label): w for w in jmodel.standard_worlds(3)}
    got = tmodel.check_world(port["memberless"])
    want = jmodel.check_world(ref["memberless"])
    assert got.ok and want.ok
    assert (got.states, want.states) == (16, 22)
    sub = _ar("subset_sum", (0, 1))
    world = World("w", 3, tuple((("negotiate", sub),) for _ in range(3)),
                  variant="skip_memberless")
    assert tmodel.check_world(world).ok


def test_overlapping_groups_negotiate_on_their_own_sequences():
    world = [w for w in tmodel.standard_worlds(3)
             if _kind(w.label) == "overlap"][0]
    res = tmodel.check_world(world)
    assert res.ok and res.terminals == 1
    # Rank 1 is in both groups: each keeps its own index and coordinator.
    state = tmodel.initial_state(world)
    while True:
        succ = tmodel.successors(world, state)
        if not succ:
            break
        state = succ[0][1]
    procs = state[0]
    assert all(p.status == "done" for p in procs)
    assert dict(procs[1].seqs) == {1: 2, 2: 2}
    assert dict(procs[0].seqs) == {1: 2} and dict(procs[2].seqs) == {2: 2}


def test_a_batched_round_replays_with_no_new_index():
    world = [w for w in tmodel.standard_worlds(2)
             if _kind(w.label) == "batch"][0]
    state = tmodel.initial_state(world)
    labels = []
    while True:
        succ = tmodel.successors(world, state)
        if not succ:
            break
        label, state, _ = succ[0]
        labels.append(label)
    names = "+".join(f"DistributedOptimizer.grads.{i}" for i in range(3))
    assert f"p0: replay {names}" in labels
    assert f"p1: replay {names}" in labels
    assert all(dict(p.seqs) == {0: 2} for p in state[0])


# -- broken variants ------------------------------------------------------------


def _ar(name, members):
    return Collective(name, tproto.OP_ALLREDUCE, tuple(members))


def _deadlock_world(faults=()):
    return World("w", 2, (
        (("negotiate", _ar("a", (0, 1))),),
        (("negotiate", _ar("a", (0, 1))), ("negotiate", _ar("b", (0, 1))))),
        faults=faults)


VARIANTS = {
    "premature_verdict": (World(
        "w", 2, tuple((("negotiate", Collective(
            "gather_x", tproto.OP_ALLGATHER, (0, 1),
            shapes=((4, 2), (6, 2)))),) for _ in range(2)),
        variant="premature_verdict"), {"HVD201"}),
    "deadlock": (_deadlock_world(), {"HVD202"}),
    "faulted_deadlock": (_deadlock_world(tproto.parse_fault_spec(
        "kv_timeout@seq=1")), {"HVD203"}),
    "elect_unverified": (World(
        "w", 2, tuple((("save", 0), ("save", 1), ("restore", 0),
                       ("negotiate", _ar("post", (0, 1))))
                      for _ in range(2)),
        variant="elect_unverified",
        faults=tproto.parse_fault_spec("torn_write@epoch=1")), {"HVD204"}),
    "replay_torn_tail": (World(
        "w", 2, ((("jadmit", 0), ("jemit", 0), ("jemit", 0), ("crash",)),
                 (("jreplay", 0),)),
        variant="replay_torn_tail",
        faults=tproto.parse_fault_spec("torn_write@epoch=1")), {"HVD204"}),
    "stale_generation_read": (World(
        "w", 2, tuple((("negotiate", _ar("a", (0, 1))), ("restore", 0),
                       ("negotiate", _ar("b", (0, 1)))) for _ in range(2)),
        variant="stale_generation_read"), {"HVD201", "HVD205"}),
    "skip_round": (World(
        "w", 2, tuple((("negotiate", _ar("a", (0, 1))),
                       ("negotiate", _ar("b", (0, 1)))) for _ in range(2)),
        variant="skip_round"), {"HVD206"}),
    "stale_replay": (World(
        "w", 2, tuple((("negotiate", _ar("a", (0, 1))), ("restore", 0),
                       ("negotiate", _ar("a", (0, 1)))) for _ in range(2)),
        variant="stale_replay"), {"HVD202", "HVD206"}),
}


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_each_variant_is_convicted_with_and_without_por(name):
    world, rules = VARIANTS[name]
    reduced = tmodel.check_world(world)
    full = tmodel.check_world(world, por=False)
    assert {f.rule for f in reduced.findings} == rules
    assert {f.rule for f in full.findings} == rules
    assert full.states >= reduced.states
    for f in reduced.findings:
        assert "Counterexample" in f.message


def test_hvd206_names_the_round_and_the_decisions():
    msg = [f.message for f in tmodel.check_world(
        VARIANTS["stale_replay"][0]).findings if f.rule == "HVD206"][0]
    assert "group 0 fell out of lockstep at its round 0 of generation 1" \
        in msg
    assert "decided 'replay'" in msg and "decided 'negotiate'" in msg


def test_counterexample_traces_are_minimal():
    msg = tmodel.check_world(_deadlock_world()).findings[0].message
    assert "Counterexample (5 steps)" in msg
    skip = tmodel.check_world(VARIANTS["skip_round"][0]).findings[0]
    assert "Counterexample (2 steps)" in skip.message


@pytest.mark.parametrize("n", [2, 3])
def test_por_off_reaches_the_same_verdict_on_every_world(n):
    for world in tmodel.standard_worlds(n):
        reduced = tmodel.check_world(world)
        full = tmodel.check_world(world, por=False)
        assert full.ok == reduced.ok
        assert full.states >= reduced.states


def test_the_shrink_spec_ends_in_one_terminal():
    for n in (2, 3):
        world = [w for w in tmodel.standard_worlds(n)
                 if _kind(w.label) == "shrink"][0]
        res = tmodel.check_world(world)
        assert res.ok and res.terminals == 1


# -- world files and the CLI ---------------------------------------------------------


@pytest.fixture(scope="module")
def bare(tmp_path_factory):
    """``import jax`` and ``import torch`` fail: the checker is stdlib-only."""
    blocker = tmp_path_factory.mktemp("bare")
    for mod in ("jax", "torch"):
        (blocker / f"{mod}.py").write_text(
            f"raise ImportError('{mod} blocked')\n")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("HOROVOD_")}
    env["PYTHONPATH"] = str(blocker)
    return env


def _cli(env, *args):
    return subprocess.run([sys.executable, str(CLI), *args], env=env,
                          capture_output=True, text=True, timeout=120)


@pytest.mark.parametrize("fixture,rule", [
    ("bad_protocol_deadlock.world.json", "HVD202"),
    ("bad_split_brain.world.json", "HVD201"),
    ("bad_stale_generation.world.json", "HVD205"),
])
def test_corpus_world_exits_exactly_one(bare, fixture, rule):
    proc = _cli(bare, str(CORPUS / fixture))
    assert proc.returncode == 1, proc.stdout + proc.stderr
    assert f"{fixture}:1: {rule}" in proc.stdout


def test_the_sweep_exits_zero(bare):
    proc = _cli(bare)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "protocol sweep" in proc.stdout
    assert "<model:overlap-3p>" in proc.stdout


@pytest.mark.parametrize("args,needle", [
    (["--max-states", "3"], "max_states"),
    (["--faults", "kv_timeout@sq=3"], "sq"),
    ([str(CORPUS / "bad_wire_dtype.hlo")], "hvd-lint owns"),
])
def test_usage_and_overflow_exit_two(bare, args, needle):
    proc = _cli(bare, *args)
    assert proc.returncode == 2, proc.stdout + proc.stderr
    assert needle in proc.stdout + proc.stderr


def test_list_rules_shows_the_protocol_rules(bare):
    proc = _cli(bare, "--list-rules")
    assert proc.returncode == 0
    for rule in ("HVD201", "HVD202", "HVD203", "HVD204", "HVD205",
                 "HVD206"):
        assert rule in proc.stdout
    assert "HVD101" not in proc.stdout


def test_world_files_parse_as_the_references(tmp_path):
    text = json.dumps({
        "label": "w", "nprocs": 2, "cache": False,
        "faults": "kv_timeout@seq=1,times=2",
        "scripts": [[{"step": "negotiate", "name": "a", "op": "broadcast",
                      "members": [0, 1], "root": 1}, {"step": "restore"}]]
        * 2})
    world = tmodel.world_from_json(text)
    assert world.nprocs == 2 and not world.cache_enabled
    assert world.scripts[0][1] == ("restore", 0)
    assert tmodel.check_world(world).ok
    batch = json.dumps({"scripts": [[{"step": "batch", "requests": [
        {"name": f"g{i}", "op": "allreduce", "members": [0, 1]}
        for i in range(3)]}]] * 2})
    world = tmodel.world_from_json(batch)
    assert world.scripts[0][0][0] == "batch"
    assert len(world.scripts[0][0][1]) == 3
    assert tmodel.check_world(world).ok
    for bad in ({"scripts": "oops"}, {"scripts": [[{"no": "step"}]]},
                {"scripts": [[{"step": "batch", "requests": []}]]}):
        with pytest.raises(ValueError, match="w:"):
            tmodel.world_from_json(json.dumps(bad), path="w")


# -- the knobs ----------------------------------------------------------------------


def _text(fn):
    try:
        return ("ok", fn())
    except ValueError as e:
        return ("raise", str(e))


@pytest.mark.parametrize("knob,value", [
    ("HOROVOD_MODEL_MAX_STATES", None), ("HOROVOD_MODEL_MAX_STATES", "5000"),
    ("HOROVOD_MODEL_MAX_STATES", "many"), ("HOROVOD_MODEL_MAX_STATES", "0"),
    ("HOROVOD_MODEL_FAULTS", None),
    ("HOROVOD_MODEL_FAULTS", "crash@rank=0,step=1"),
    ("HOROVOD_MODEL_FAULTS", "crash@rnk=1,step=2"),
    ("HOROVOD_MODEL_FAULTS", "meteor@strike=1"),
])
def test_knob_texts_equal_the_jax_packages(monkeypatch, knob, value):
    from horovod_tpu.utils import env as jenv

    if value is None:
        monkeypatch.delenv(knob, raising=False)
    else:
        monkeypatch.setenv(knob, value)
    reader = ("model_max_states" if knob.endswith("STATES")
              else "model_faults")
    assert _text(getattr(tenv, reader)) == _text(getattr(jenv, reader))

"""The recorded wire schedules (``ops/wire.py``, ``analysis/hlo.py::
step_wire``, ``analysis/schedule.py``'s drivers) against the JAX package's
golden schedules, in one 8-rank gloo world at
``HOROVOD_TOPOLOGY_SLICES=2``, the goldens' topology.

Every case runs once in the world; each test reads its own rows:

* ``gradient_step``'s merged ``schedule_summary`` equals
  ``tests/golden_schedules.json``'s ``schedules`` for the 30 combinations
  of {flat, rs_ag, hierarchical} x {none, bf16, int8, int8_block, int4} x
  {1, 2 channels}, ``fsdp_step``'s the ``zero3`` section and
  ``sparse_step``'s the ``sparse_schedules``. The goldens' scope column is
  None (lowered HLO carries no op metadata), so it is dropped. Where the
  port's wire honestly differs (ROADMAP §C), the port's rows are pinned
  here: the same rows as the golden's, in the port's order;
* every recorded listing verifies clean under its golden's contract (the
  sparse steps under none: their index gather is never compressed);
* ``verify_lm_step`` is clean at slices {1, 2, 4} x {flat, rs_ag,
  hierarchical} and refuses hierarchical at one slice; the LM step's
  listing has collectives; recording mid-job leaves the live auto-name
  counters where they were; a rank-conditional extra collective gives
  every rank the same HVD103.
"""

import json
import pathlib

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
GOLDEN = json.loads((REPO / "tests" / "golden_schedules.json").read_text())
WORLD = GOLDEN["world_size"]
SLICES = GOLDEN["slices"]
LM_CASES = [(s, a) for s in (1, 2, 4)
            for a in ("flat", "rs_ag", "hierarchical")]
LM_ARMS = [(s, k) for s in (1, 2, 4)
           for k in ("exchange", "channels", "zero3")]


def _combo(key: str):
    parts = key.split("/")
    return parts[0], parts[1], (int(parts[2][2:]) if len(parts) == 3
                                else None)


def _world_cases():
    """Runs on every rank of the gloo world: each case's merged summary
    and findings."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.analysis import hlo, schedule
    from horovod_tpu_torch.ops import collectives as coll

    hvd.init(device="cpu")
    out = {"dense": {}, "sparse": {}, "zero": {}, "lm": {}, "arms": {}}

    def record(fn, args, slices=SLICES, **verify):
        with schedule._with_slices(slices):
            mine = hlo.step_wire(fn, args)
        summary: list = []
        listings = schedule.gather_listings(mine)
        findings = schedule.verify_listings(listings, slices=slices,
                                            summary=summary, **verify)
        return {"rows": summary, "findings": [str(f) for f in findings]}

    for key in GOLDEN["schedules"]:
        algo, comp, ch = _combo(key)
        with schedule._with_slices(SLICES):
            fn, args = schedule.gradient_step(algo=algo, compression=comp,
                                              channels=ch, device="cpu")
        out["dense"][key] = record(fn, args, algo=algo, compression=comp)
    for key in GOLDEN["sparse_schedules"]:
        algo, comp = key.split("/")
        fn, args = schedule.sparse_step(algo=algo, compression=comp,
                                        device="cpu")
        # No wire contract: the index gather is never compressed (as the
        # reference's gate verifies its sparse step).
        out["sparse"][key] = record(fn, args)
    for key in GOLDEN["zero3"]:
        mode, comp = key.split("/")
        with schedule._with_slices(SLICES):
            fn, args = schedule.fsdp_step(sharding=mode, compression=comp,
                                          device="cpu")
        out["zero"][key] = record(fn, args, compression=comp,
                                  sharding=mode, fsdp_size=WORLD // SLICES)
    for slices, algo in LM_CASES:
        try:
            got = schedule.verify_lm_step(algo=algo, slices=slices,
                                          device="cpu")
            out["lm"][(slices, algo)] = [str(f) for f in got]
        except hvd.HorovodError as e:
            out["lm"][(slices, algo)] = f"refused: {e}"
    for slices, arm in LM_ARMS:
        kw = {"exchange": {"exchange": "priority"},
              "channels": {"channels": 2},
              "zero3": {"sharding": "zero3"}}[arm]
        got = schedule.verify_lm_step(slices=slices, device="cpu", **kw)
        out["arms"][(slices, arm)] = [str(f) for f in got]
    with schedule._with_slices(1):
        fn, args = schedule.lm_step(algo="flat", device="cpu")
        out["lm_rows"] = schedule.schedule_summary(hlo.step_wire(fn, args))

    coll.reset_auto_names()
    coll._auto_name("HorovodAllreduce", None)
    fn, args = schedule.gradient_step(device="cpu")
    out["auto_findings"] = [str(f) for f in schedule.verify_step(fn, args)]
    out["auto_next"] = coll._auto_name("HorovodAllreduce", None)

    def bad(x):
        if hvd.rank() == 3:
            hvd.allreduce(x, name="rank3_extra")
        return hvd.allreduce_gradients([x], fusion_threshold=0)[0].sum()

    out["bad"] = [str(f) for f in schedule.verify_step(
        bad, [torch.ones(4)], path="<bad>")]
    hvd.shutdown()
    return out


@pytest.fixture(scope="module")
def world():
    from horovod_tpu_torch.run import run

    results = run(_world_cases, WORLD, device="cpu", timeout=600.0)
    return results


def _strip(rows):
    """The goldens' columns but the scope (lowered HLO carries none)."""
    return [list(r[:5]) for r in rows]


# The port's rows where its wire differs from the golden (ROADMAP §C):
# (1) the sparse gather moves the value payload (and its scales) before
# the indices — ops/sparse.py gathers values first; (2) zero2 reduces
# every gradient to its shard before it re-gathers any new parameter — the
# step boundary of parallel/sharded.py's Zero2Optimizer. The rows are the
# golden's rows, in the port's order.
def _sparse_port_order(rows):
    assert rows[0][:2] == ["all-gather", "s32"], rows
    k = 2 if any(r[1] == "s8" for r in rows) else 1  # the wire's scales
    return rows[1:1 + k] + rows[:1] + rows[1 + k:]


def _zero2_port_order(rows):
    return ([r for r in rows if r[0] != "all-gather"]
            + [r for r in rows if r[0] == "all-gather"])


PINNED = {
    ("sparse", "gather/none"): _sparse_port_order,
    ("sparse", "gather/bf16"): _sparse_port_order,
    ("sparse", "gather/int8_block"): _sparse_port_order,
    ("sparse", "gather/int4"): _sparse_port_order,
    ("zero", "zero2/none"): _zero2_port_order,
    ("zero", "zero2/bf16"): _zero2_port_order,
    ("zero", "zero2/int8_block"): _zero2_port_order,
}


def _check(world, section, key, golden):
    got = [_strip(r[section][key]["rows"]) for r in world]
    assert all(g == got[0] for g in got), "ranks merged different programs"
    want = _strip(golden)
    pin = PINNED.get((section, key))
    if pin is not None:
        assert sorted(map(str, got[0])) == sorted(map(str, want))
        want = pin(want)
    assert got[0] == want, (f"{section} {key}\n  want {want}\n  "
                            f"got  {got[0]}")
    for r in world:
        assert r[section][key]["findings"] == [], r[section][key]


@pytest.mark.parametrize("key", sorted(GOLDEN["schedules"]))
def test_gradient_step_schedule_equals_the_golden(world, key):
    _check(world, "dense", key, GOLDEN["schedules"][key])


@pytest.mark.parametrize("key", sorted(GOLDEN["sparse_schedules"]))
def test_sparse_step_schedule_equals_the_golden(world, key):
    _check(world, "sparse", key, GOLDEN["sparse_schedules"][key])


@pytest.mark.parametrize("key", sorted(GOLDEN["zero3"]))
def test_fsdp_step_schedule_equals_the_golden(world, key):
    _check(world, "zero", key, GOLDEN["zero3"][key])


def test_the_pinned_orders_are_the_goldens_rows_reordered():
    rows = GOLDEN["sparse_schedules"]["gather/int4"]
    assert _strip(_sparse_port_order(rows)) == _strip(
        [rows[1], rows[2], rows[0], rows[3], rows[4]])
    rows = GOLDEN["zero3"]["zero2/none"]
    assert [r[0] for r in _zero2_port_order(rows)] == (
        ["reduce-scatter", "all-reduce"] * 3 + ["all-gather"] * 3)


@pytest.mark.parametrize("slices,algo", LM_CASES)
def test_verify_lm_step(world, slices, algo):
    for r in world:
        got = r["lm"][(slices, algo)]
        if algo == "hierarchical" and slices == 1:
            assert isinstance(got, str) and "multi-slice" in got, got
        else:
            assert got == [], got


@pytest.mark.parametrize("slices,arm", LM_ARMS)
def test_verify_lm_step_with_a_plan(world, slices, arm):
    for r in world:
        assert r["arms"][(slices, arm)] == [], r["arms"][(slices, arm)]


def test_the_lm_step_has_collectives(world):
    rows = world[0]["lm_rows"]
    assert any(r[0] == "all-reduce" and r[2] > 1 for r in rows), rows


def test_recording_mid_job_leaves_the_auto_names(world):
    for r in world:
        assert r["auto_findings"] == []
        assert r["auto_next"] == "HorovodAllreduce_1"


def test_a_rank_conditional_collective_gives_every_rank_one_hvd103(world):
    bad = world[0]["bad"]
    assert any(": HVD103 rank 3's schedule diverges from rank 0's" in f
               for f in bad), bad
    assert all(r["bad"] == bad for r in world)


def test_a_program_records_its_wire_at_its_defining_pass():
    """A program keeps the wire listing of the pass that defines it (on the
    CPU its first call); later calls leave it as it was, a new key records
    its own, and under a dry pass already active the program's listing is
    that pass's."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.analysis import hlo, schedule

    hvd.shutdown()
    hvd.init(device="cpu")
    try:
        def step(x):
            return hvd.allreduce_gradients([x * 2, x[:3]],
                                           fusion_threshold=0)

        prog = hvd.spmd(step)
        x = np.arange(8, dtype=np.float32)
        first = prog(torch.from_numpy(x))
        wire = prog.wire
        assert schedule.schedule_summary(wire) == [
            ["all-reduce", "f32", 8, 1, 1, None],
            ["all-reduce", "f32", 3, 1, 1, None]]
        assert schedule.verify_listings([wire], algo="flat") == []
        for _ in range(2):
            again = prog(torch.from_numpy(x))
            assert all(torch.equal(a, b) for a, b in zip(first, again))
        assert prog.wire is wire and len(wire) == 2
        prog(torch.from_numpy(x[:5]))
        assert schedule.schedule_summary(prog.wire) == [
            ["all-reduce", "f32", 5, 1, 1, None],
            ["all-reduce", "f32", 3, 1, 1, None]]
        assert sorted(len(p.wire) for p in prog.programs.values()) == [2, 2]
        fresh = hvd.spmd(step)
        assert hlo.step_wire(fresh, (torch.from_numpy(x),)) == fresh.wire
    finally:
        hvd.shutdown()

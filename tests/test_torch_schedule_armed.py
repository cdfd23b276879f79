"""The armed ZeRO-2/3 steps' recorded wire against the JAX package's
golden schedules (``tests/golden_schedules.json``'s ``zero3`` section), in
one 8-rank gloo world at ``HOROVOD_TOPOLOGY_SLICES=2``, the goldens'
topology.

An armed step (``parallel/sharded.py``; the Trainer's step from its
second call) issues each tensor's reduce-scatter prefix from backward, in
reverse gather order, and zero3 gathers every parameter first, in the
plan's gather order: ``analysis/schedule.py::fsdp_step(armed=True)``.
Its rows are the golden's rows reordered (ROADMAP §C: the reference's XLA
order is per leaf): the same multiset of rows, the reduce rows of each
leaf kept together and the leaves' reduce groups reversed. Every rank
records the same program, and it verifies clean under the golden's
contract. The unarmed rows stay pinned by ``tests/test_torch_schedule.py``.
"""

import json
import pathlib

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
GOLDEN = json.loads((REPO / "tests" / "golden_schedules.json").read_text())
WORLD = GOLDEN["world_size"]
SLICES = GOLDEN["slices"]


def _world():
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.analysis import hlo, schedule

    hvd.init(device="cpu")
    out = {}
    for key in GOLDEN["zero3"]:
        mode, comp = key.split("/")
        with schedule._with_slices(SLICES):
            fn, args = schedule.fsdp_step(sharding=mode, compression=comp,
                                          device="cpu", armed=True)
            mine = hlo.step_wire(fn, args)
        summary: list = []
        findings = schedule.verify_listings(
            schedule.gather_listings(mine), slices=SLICES, summary=summary,
            compression=comp, sharding=mode, fsdp_size=WORLD // SLICES)
        out[key] = {"rows": summary, "findings": [str(f) for f in findings]}
    hvd.shutdown()
    return out


@pytest.fixture(scope="module")
def world():
    from horovod_tpu_torch.run import run

    return run(_world, WORLD, device="cpu", timeout=300.0)


def _strip(rows):
    """The goldens' columns but the scope (lowered HLO carries none)."""
    return [list(r[:5]) for r in rows]


def armed_order(rows, mode: str):
    """The golden's rows in the armed step's order: each leaf's reduce
    rows (its reduce-scatter and the rows after it up to the next
    reduce-scatter or all-gather) kept together, the leaves' groups
    reversed; zero3's gathers first, zero2's after."""
    gathers = [r for r in rows if r[0] == "all-gather"]
    groups: list = []
    for r in rows:
        if r[0] == "reduce-scatter":
            groups.append([r])
        elif r[0] != "all-gather":
            groups[-1].append(r)
    reduces = [r for grp in reversed(groups) for r in grp]
    return gathers + reduces if mode == "zero3" else reduces + gathers


def test_the_armed_order_reverses_the_leaves_reduce_groups():
    rows = GOLDEN["zero3"]["zero3/int8_block"]
    got = armed_order(rows, "zero3")
    assert [r[0] for r in got[:3]] == ["all-gather"] * 3
    assert [(r[0], r[2]) for r in got[3:]] == [
        ("reduce-scatter", 48), ("all-reduce", 1), ("all-reduce", 256),
        ("reduce-scatter", 32), ("all-reduce", 1), ("all-reduce", 256),
        ("reduce-scatter", 16), ("all-reduce", 1), ("all-reduce", 256)]
    got = armed_order(GOLDEN["zero3"]["zero2/none"], "zero2")
    assert [(r[0], r[2]) for r in got] == [
        ("reduce-scatter", 48), ("all-reduce", 48), ("reduce-scatter", 32),
        ("all-reduce", 32), ("reduce-scatter", 16), ("all-reduce", 16),
        ("all-gather", 64), ("all-gather", 128), ("all-gather", 192)]


@pytest.mark.parametrize("key", sorted(GOLDEN["zero3"]))
def test_the_armed_rows_are_the_goldens_rows_reordered(world, key):
    got = [_strip(r[key]["rows"]) for r in world]
    assert all(g == got[0] for g in got), "ranks merged different programs"
    want = _strip(GOLDEN["zero3"][key])
    assert sorted(map(str, got[0])) == sorted(map(str, want))
    assert got[0] == armed_order(want, key.split("/")[0]), (
        f"{key}\n  want {armed_order(want, key.split('/')[0])}\n  "
        f"got  {got[0]}")
    for r in world:
        assert r[key]["findings"] == [], r[key]

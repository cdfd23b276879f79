"""The harness driven end to end on the CPU at tiny widths, past its look for
a card: a sound run comes out correct, and a run with the timed path broken
underneath comes out not correct. The tiny models read more than the
cells do (the port's attention rounds queries and keys to bf16 at every
width, and at a tiny width that shows), so they are held to limits of
their own (``data/limits_tiny.json``, 5-10x what sound tiny runs read). The
faults: a step that leaves the state unchanged, half of the batch left
out (the mean over the rest), the exchange between ranks left out, and
the exchange left out of the armed steps alone (every step after the
first, the window's path), which the last step's gradient shows.
The control (the reference in fp8, in the program's place) reads at least
three times what the program reads."""

import json
import os

import pytest

from hvdbench import cell, check, run

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


def _data(name: str) -> dict:
    with open(os.path.join(DATA, f"{name}.json")) as f:
        return json.load(f)


def _cell(name: str, ranks: int) -> dict:
    """The cell ``name`` (its metrics) over a tiny model, a tiny mix on
    ``ranks`` ranks and the tiny limits."""
    c = run.load_cell(name)
    c.update(limits=_data("limits_tiny"), config=_data("lm_tiny"),
             mix=dict(_data("tokens_tiny"), ranks=ranks))
    return c


def faulty_rank(job: dict) -> dict:
    """``cell.run_rank`` with ``job["fault"]`` planted in the program, and
    taken out again after the run (a one-rank run shares the test's
    process)."""
    from horovod_tpu_torch.ops import fusion, optim
    from horovod_tpu_torch.parallel import overlap

    fam = cell.family(job["config"])
    build = fam.build

    def halved(cfg, weights, device):
        model, opt, loss_fn = build(cfg, weights, device)
        return model, opt, lambda m, b: loss_fn(m, fam.half(b))

    def unchanged(self, closure=None):
        return None

    plant = {"state": [(optim.AdamW, "step", unchanged)],
             "half": [(fam, "build", halved)],
             "exchange": [(fusion, "apply_bucket_",
                           lambda *args, **kwargs: None)],
             "armed_exchange": [(overlap.Overlap, "_issue",
                                 lambda self, k: None)]}[job["fault"]]
    saved = [(owner, attr, getattr(owner, attr)) for owner, attr, _ in plant]
    try:
        for owner, attr, value in plant:
            setattr(owner, attr, value)
        return cell.run_rank(job)
    finally:
        for owner, attr, value in saved:
            setattr(owner, attr, value)


def _run(name: str, ranks: int, fault=None, trace=False) -> dict:
    c = _cell(name, ranks)
    job = dict(run.job_for(c, 2 ** 31 + 7, 0.2, trace, "cpu"), fault=fault)
    fn = cell.run_rank if fault is None else faulty_rank
    return run.merge(c, run.run_ranks(fn, job, ranks, "cpu"), trace,
                     {"platform": "cpu", "kind": "cpu"})


@pytest.mark.parametrize("name,ranks", [("lm_t8k.b2", 1), ("lm_t8k.dp4", 2)])
def test_sound_run_is_correct(name, ranks):
    out = _run(name, ranks)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 3 and out["failed"] == 0
    assert list(out)[-1] == "checks"
    assert set(out["metrics"]) == {m["name"] for m in _cell(
        name, ranks)["end_to_end"]}


def test_traced_run_reports_the_slice():
    out = _run("lm_t8k.b2", 1, trace=True)
    assert out["correct"]
    assert out["device"]["window_s"] > 0
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    # no device trace on the CPU: no per-layer metric is read
    assert out["metrics"] == {}


@pytest.mark.parametrize("name,ranks,fault", [
    ("lm_t8k.b2", 1, "state"), ("lm_t8k.b2", 1, "half"),
    ("lm_t8k.dp4", 2, "state"), ("lm_t8k.dp4", 2, "half"),
    ("lm_t8k.dp4", 2, "exchange"), ("lm_t8k.dp4", 2, "armed_exchange")])
def test_broken_run_is_not_correct(name, ranks, fault):
    out = _run(name, ranks, fault)
    assert not out["correct"], out["checks"]
    json.dumps(out, allow_nan=False)  # the line stays strict JSON
    if fault == "armed_exchange":
        # the eager first step exchanged: its gradient reads sound
        checks = out["checks"]
        assert checks["grad_gap"]["value"] <= checks["grad_gap"]["limit"]
        assert (checks["late_grad_gap"]["value"]
                > checks["late_grad_gap"]["limit"])


@pytest.mark.parametrize("name,ranks", [("lm_t8k.b2", 1),
                                        ("lm_t8k.dp4", 2)])
def test_control_reads_three_times_the_program(name, ranks):
    c = _cell(name, ranks)
    job = dict(run.job_for(c, 11, 0.0, False, "cpu"), seeds=[11],
               control_seeds=1)
    rows = run.run_ranks(cell.calibrate_rank, job, ranks, "cpu")
    for rank_rows in rows:
        row = rank_rows[0]
        worst = max(row["control"][k] / max(row["program"][k], 1e-12)
                    for k in check.NUMBERS)
        assert worst >= 3.0, row

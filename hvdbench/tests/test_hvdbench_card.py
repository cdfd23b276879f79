"""On a CUDA card, at each cell's own size: the control (the reference
computed in fp8, put in the program's place) comes out not correct against
the cell's limits on three seeds, while the program comes out correct on
them. Skipped, with a reason, on a host without enough cards.

    python -m pytest hvdbench/tests/test_hvdbench_card.py -m card
"""

import json
import os

import pytest

from hvdbench import cell, check, run

with open(os.path.join(run.ROOT, "BENCHMARK.json")) as _f:
    CELLS = [w["name"] for w in json.load(_f)["workloads"]]
SEEDS = [90001, 90002, 90003]


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_at_the_cells_size(card, name):
    import torch

    c = run.load_cell(name)
    if torch.cuda.device_count() < c["cell"]["chips"]:
        pytest.skip(f"{name} needs {c['cell']['chips']} cards")
    from horovod_tpu_torch.ops import _build

    _build.build()
    job = dict(run.job_for(c, 0, 0.0, False, "cuda"), seeds=SEEDS,
               control_seeds=len(SEEDS))
    ranks = run.run_ranks(cell.calibrate_rank, job, c["cell"]["chips"],
                          "cuda")
    for i in range(len(SEEDS)):
        worst = {arm: {k: max(r[i][arm][k] for r in ranks)
                       for k in check.NUMBERS}
                 for arm in ("program", "control")}
        assert check.judge(worst["program"], c["limits"]), worst
        assert not check.judge(worst["control"], c["limits"]), worst

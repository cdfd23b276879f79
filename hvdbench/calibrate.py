"""The readings a cell's limits are set from (``hvdbench/limits/``): the
program's numbers on many seeds, and the control's and the planted
faults' on a few, all at the cell's own size, in one process a rank and
with no window.

    python hvdbench/calibrate.py --workload <cell> --seeds 11,12,13 \
        [--control-seeds 3] [--out readings.json]

``cell.py::calibrate_rank`` says what each arm is. Prints one JSON line a
seed (the worst over the ranks of each number) and writes them all to
``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True,
                   help="comma-separated seeds")
    p.add_argument("--control-seeds", type=int, default=3,
                   help="how many of the seeds also run the control and "
                        "the faults")
    p.add_argument("--out", default=None)
    a = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    from hvdbench import run

    run.use_checkout_caches()
    from hvdbench import cell

    c = run.load_cell(a.workload)
    from horovod_tpu_torch.ops import _build

    _build.build()
    job = dict(run.job_for(c, 0, 0.0, False, "cuda"),
               seeds=[int(s) for s in a.seeds.split(",")],
               control_seeds=a.control_seeds)
    ranks = run.run_ranks(cell.calibrate_rank, job, c["cell"]["chips"],
                          "cuda")
    rows = []
    for i, row in enumerate(ranks[0]):
        merged = dict(row)
        for arm, nums in row.items():
            if isinstance(nums, dict):
                merged[arm] = {k: max(r[i][arm][k] for r in ranks)
                               for k in nums}
        rows.append(merged)
        print(json.dumps(merged), flush=True)
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "w") as f:
            json.dump({"workload": a.workload, "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

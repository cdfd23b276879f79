"""Custom collective groups — the fork's feature, the reference's
``examples/grouped_collectives.py``: ``hvd.init([[0,1,2],[2,3,4]])`` builds
overlapping sub-communicators and every collective takes ``group=``,
including the rooted ``gather``.

It needs 5 ranks, one process each; on one GPU, run it over gloo on the
CPU:

    python -c "from horovod_tpu_torch.run import run; \\
        from horovod_tpu_torch.examples import grouped_collectives as g; \\
        run(g.main, 5, device='cpu', args=(['--device', 'cpu'],))"

With fewer ranks it says so and returns.
"""

from __future__ import annotations

import argparse
import os

import torch
import torch.distributed as dist

import horovod_tpu_torch as hvd

N = 5


def _world() -> int:
    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def main(argv=None) -> dict | None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = parser.parse_args(argv)

    if _world() < N:
        print(f"needs >= {N} devices; have {_world()} (try "
              f"horovod_tpu_torch.run.run(main, {N}, device='cpu', "
              f"args=(['--device', 'cpu'],)))")
        return None

    # Group 1 = ranks {0,1,2}, group 2 = ranks {2,3,4}; rank 2 is a member
    # of both — the README's example. Group 0 is always the whole world.
    hvd.init([[0, 1, 2], [2, 3, 4]], device=args.device)
    if hvd.rank() == 0:
        print(f"world size {hvd.size()}; groups: "
              f"{[hvd.get_group(g).ranks for g in range(hvd.num_groups())]}")

    def step(x):
        # A process outside a group takes no part in its collectives and
        # gets None ([] from gather); the reference's traced program gives
        # it its own value, which is what this example prints.
        def own(y, mine):
            return mine if y is None or isinstance(y, list) else y

        summed_g1 = own(hvd.allreduce(x, group=1, average=False), x)
        summed_g2 = own(hvd.allreduce(x, group=2, average=False), x)
        rows = own(hvd.allgather(x[None], group=1), x[None])
        gathered = own(hvd.gather(x[None], root_rank=0, group=2), x[None])
        bcast = own(hvd.broadcast(x, root_rank=1, group=1), x)
        return summed_g1, summed_g2, rows.sum(), gathered.sum(), bcast

    spmd_step = hvd.spmd(step)
    # Rank r holds the value r.
    x = torch.full((), float(hvd.rank()), device=hvd.device())
    out = spmd_step(x)
    # Every rank's five results, rank by rank, on every rank.
    s1, s2, rows, gath, bc = (
        hvd.allgather(v.reshape(1), name=f"grouped.result_{i}").tolist()
        for i, v in enumerate(out))

    if hvd.rank() == 0:
        print(f"per-rank input:            {list(map(float, range(N)))}")
        print(f"allreduce over group 1:    {s1}   (members 0,1,2 → 3.0)")
        print(f"allreduce over group 2:    {s2}   (members 2,3,4 → 9.0)")
        print(f"broadcast root 1, group 1: {bc}")
    if not (s1[0] == s1[1] == s1[2] == 3.0
            and s2[2] == s2[3] == s2[4] == 9.0
            # Non-members see a group's collective as identity.
            and s1[4] == 4.0 and s2[0] == 0.0 and s2[1] == 1.0
            and bc[:3] == [1.0, 1.0, 1.0]):
        raise RuntimeError(f"grouped collectives: wrong values {s1} {s2} "
                           f"{bc}")
    if hvd.rank() == 0:
        print("grouped collectives OK")
    return {"s1": s1, "s2": s2, "rows": rows, "gathered": gath, "bcast": bc}


if __name__ == "__main__":
    main()

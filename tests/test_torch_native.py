"""The port's native control plane (``horovod_tpu_torch/core/native``, a copy
of ``hvd_core.cc`` with its own loader) against the JAX package's
(``horovod_tpu/core/native``), after ``tests/test_native_core.py``.

* The reference's ``MISMATCH_CASES``: the port's native table, the port's
  Python path and the JAX package's native table raise the same text on
  the same requests; success responses, the gather root, and a table that
  stays usable after an error.
* The fusion planner at the reference's thresholds: native, the port's
  Python planner and the JAX package's plan alike.
* Stall detection: a partial submission names the missing ranks, and none
  is reported within the window.
* The timeline: the native writer's Chrome trace holds the same events,
  pids and names as the Python writer's (and as the JAX package's native
  writer's) for one event sequence.
* One spawned 2-rank gloo world: the core loads on both ranks; while the
  coordinator waits on a late rank its table names that rank as missing;
  a shape mismatch negotiated through the table raises the reference's
  text on both ranks and the name then negotiates again; a fit under
  ``HOROVOD_TIMELINE`` leaves each bucket's NEGOTIATE span with a ready
  tick a rank.
* ``utils/distributed.py::init_distributed`` in two processes started
  with the rendezvous address, the process count and the process id.

The native tests skip only when ``g++`` is not on PATH: a failed build is
a failure. The spawned children import this module, so JAX is imported
only inside the parent-side functions.
"""

import json
import multiprocessing
import os
import shutil
import socket
import threading
import time

import numpy as np
import pytest
import torch

from horovod_tpu_torch.core import native as tnative
from horovod_tpu_torch.core import negotiate as tneg
from horovod_tpu_torch.core.state import HorovodError

pytestmark = pytest.mark.skipif(
    shutil.which("g++") is None,
    reason="g++ is not on PATH: the native control plane cannot be built")

LATE_S = 2.2


def _spec(rank, name="t", op="ALLREDUCE", dtype="float32", shape=(2, 3),
          root=-1):
    return (rank, name, op, dtype, tuple(shape), root)


def _port_reqs(specs):
    return [tneg.Request(rank=r, name=n, op=tneg.CollectiveOp[op], dtype=d,
                         shape=s, root_rank=root)
            for r, n, op, d, s, root in specs]


def _jax_reqs(specs):
    from horovod_tpu.core import negotiate as jneg

    return [jneg.Request(rank=r, name=n, op=jneg.CollectiveOp[op], dtype=d,
                         shape=s, root_rank=root)
            for r, n, op, d, s, root in specs]


# (requests, expected match): each one check of ConstructMPIResponse, as
# the reference's tests/test_native_core.py lists them.
MISMATCH_CASES = [
    ([_spec(0), _spec(1, dtype="int32")] + [_spec(r) for r in range(2, 8)],
     "Mismatched data types"),
    ([_spec(0), _spec(1, op="ALLGATHER")] + [_spec(r) for r in range(2, 8)],
     "Mismatched collective operations"),
    ([_spec(0), _spec(1, shape=(3, 3))] + [_spec(r) for r in range(2, 8)],
     "Mismatched allreduce tensor shapes"),
    ([_spec(r, op="ALLGATHER") for r in range(7)]
     + [_spec(7, op="ALLGATHER", shape=(2,))],
     "Mismatched allgather tensor shapes"),
    ([_spec(r, op="ALLGATHER") for r in range(7)]
     + [_spec(7, op="ALLGATHER", shape=(4, 9))],
     "trailing dimensions"),
    ([_spec(r, op="GATHER", root=0) for r in range(7)]
     + [_spec(7, op="GATHER", root=3)],
     "Mismatched gather root ranks"),
    ([_spec(r, op="BROADCAST", root=55) for r in range(8)],
     "Invalid root rank"),
    ([_spec(r, op="ALLGATHER", shape=()) for r in range(8)],
     "rank-zero tensor"),
    ([_spec(0), _spec(0)] + [_spec(r) for r in range(2, 8)],
     "submitted twice"),
]


@pytest.fixture(scope="module")
def cores():
    """A port core and a JAX package core over one group of 8."""
    from horovod_tpu.core import native as jnative

    assert tnative.available() and jnative.available()
    t, j = tnative.NativeCore([8]), jnative.NativeCore([8])
    yield t, j
    t.close()
    j.close()


@pytest.mark.parametrize("case", range(len(MISMATCH_CASES)))
def test_native_and_python_raise_the_jax_packages_text(cores, case):
    from horovod_tpu.core import negotiate as jneg

    tcore, jcore = cores
    specs, expected = MISMATCH_CASES[case]
    with pytest.raises(HorovodError, match=expected) as native_err:
        tneg._validate_native(tcore, _port_reqs(specs), 8)
    with pytest.raises(HorovodError, match=expected) as py_err:
        tneg.validate_py(_port_reqs(specs), 8)
    with pytest.raises(Exception, match=expected) as jax_err:
        jneg._validate_native(jcore, _jax_reqs(specs), 8)
    assert str(native_err.value) == str(py_err.value) == str(jax_err.value)


def test_success_responses_match(cores):
    from horovod_tpu.core import negotiate as jneg

    tcore, jcore = cores
    specs = [_spec(r, op="ALLGATHER", shape=(r + 1, 4)) for r in range(8)]
    rn = tneg._validate_native(tcore, _port_reqs(specs), 8)
    rp = tneg.validate_py(_port_reqs(specs), 8)
    rj = jneg._validate_native(jcore, _jax_reqs(specs), 8)
    assert rn == rp
    assert rn.tensor_sizes == rj.tensor_sizes == tuple(range(1, 9))


def test_gather_root_recorded(cores):
    tcore, _ = cores
    specs = [_spec(r, op="GATHER", shape=(2, 2), root=5) for r in range(8)]
    rn = tneg._validate_native(tcore, _port_reqs(specs), 8)
    assert rn.root_rank == 5 == tneg.validate_py(_port_reqs(specs),
                                                 8).root_rank


def test_table_reusable_after_error(cores):
    """An errored negotiation does not poison the next one of the same
    name (the reference erases the entry, mpi_ops.cc:589)."""
    tcore, _ = cores
    bad = [_spec(0), _spec(1, dtype="int32")] + [_spec(r)
                                                 for r in range(2, 8)]
    with pytest.raises(HorovodError):
        tneg._validate_native(tcore, _port_reqs(bad), 8)
    resp = tneg._validate_native(tcore, _port_reqs([_spec(r)
                                                    for r in range(8)]), 8)
    assert resp.name == "t"


@pytest.mark.parametrize("threshold", [0, 24, 40, 1 << 20])
def test_the_native_planner_matches_python_and_jax(cores, threshold):
    import jax.numpy as jnp
    from horovod_tpu.ops import fusion as jfusion

    from horovod_tpu_torch.ops import fusion as tfusion

    tcore, _ = cores
    rng = np.random.RandomState(0)
    tl, jl = [], []
    for _ in range(20):
        n = int(rng.randint(1, 30))
        k = int(rng.randint(3))
        tl.append(torch.empty((n,), dtype=(torch.float32, torch.float64,
                                           torch.int32)[k], device="meta"))
        jl.append(jnp.zeros((n,), (np.float32, np.float64, np.int32)[k]))
    a = tfusion.plan_buckets_native(tcore, tl, threshold)
    b = tfusion.plan_buckets_py(tl, threshold)
    c = jfusion.plan_buckets_py(jl, threshold)
    assert [x.indices for x in a] == [y.indices for y in b] == \
        [z.indices for z in c]
    assert [x.total_bytes for x in a] == [y.total_bytes for y in b] == \
        [z.total_bytes for z in c]
    assert [x.dtype for x in a] == [y.dtype for y in b]


def test_partial_submission_reports_missing_ranks():
    core = tnative.NativeCore([4], stall_seconds=0.0)
    try:
        core.submit(0, "grad/w", 0, "float32", (2,), -1, 0)
        core.submit(0, "grad/w", 0, "float32", (2,), -1, 2)
        time.sleep(0.01)
        assert core.stalled(0) == [
            "grad/w [ready ranks: [0, 2]] [missing ranks: [1, 3]]"]
    finally:
        core.close()


def test_no_stall_within_window():
    core = tnative.NativeCore([4], stall_seconds=60.0)
    try:
        core.submit(0, "grad/w", 0, "float32", (2,), -1, 0)
        assert core.stalled(0) == []
    finally:
        core.close()


def _trace(path):
    with open(path) as f:
        rows = [json.loads(ln.strip().rstrip(",")) for ln in f
                if ln.strip() not in ("[", "]", "")]
    for e in rows:
        e.pop("ts", None)
    return rows


def test_the_native_writer_writes_the_python_writers_events(tmp_path):
    from horovod_tpu.core import native as jnative

    from horovod_tpu_torch.core import timeline as ttl

    events = [("gradA", "NEGOTIATE_ALLREDUCE", "B"), ("gradA", "0", "X"),
              ("gradA", "1", "X"), ("gradA", "NEGOTIATE_ALLREDUCE", "E"),
              ("_fusion_buffer", "SCHEDULE", "B"),
              ("_fusion_buffer", "plan=ab12 mode=enum", "X"),
              ("_fusion_buffer", "SCHEDULE", "E"),
              ("gradB", "MEMCPY_IN_FUSION_BUFFER", "B"),
              ("gradB", "MEMCPY_IN_FUSION_BUFFER", "E"),
              ("gradA", "ALLREDUCE", "B"), ("gradA", "ALLREDUCE", "E")]
    paths = {}
    for writer in ("python", "native", "jax_native"):
        path = str(tmp_path / f"{writer}.json")
        core = {"python": None, "native": tnative.NativeCore([2]),
                "jax_native": jnative.NativeCore([2])}[writer]
        if writer == "jax_native":
            assert core.timeline_start(path)
            for ev in events:
                core.timeline_event(*ev)
            core.timeline_stop()
        else:
            t = ttl.Timeline()
            t.start(path, core)
            assert t.native_core is core
            for tensor, activity, phase in events:
                t.event(tensor, activity, phase)
            t.stop()
        if core is not None:
            core.close()
        paths[writer] = path
    py = _trace(paths["python"])
    assert _trace(paths["native"]) == _trace(paths["jax_native"]) == py
    assert {e["name"] for e in py if e["ph"] == "M"} == {
        "process_name", "process_sort_index"}
    assert all(e["dur"] == 0 for e in py if e["ph"] == "X")


def test_init_builds_the_core_at_the_groups_sizes_and_shutdown_drops_it():
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.core import state as tstate

    hvd.shutdown()
    hvd.init(device="cpu")
    try:
        core = tstate.native_core()
        assert core is not None and core.group_sizes == [1]
    finally:
        hvd.shutdown()
    assert tstate.native_core() is None


# -- one 2-rank world ---------------------------------------------------------


class _Linear(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.tensor(
            np.random.RandomState(0).randn(4, 2).astype(np.float32)))
        self.b = torch.nn.Parameter(torch.zeros(2))


def _native_world(path):
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.core import state as tstate

    os.environ["HOROVOD_STALL_CHECK_TIME"] = "1"
    os.environ["HOROVOD_TIMELINE"] = path
    os.environ["HOROVOD_FUSION_THRESHOLD"] = "0"
    hvd.init(device="cpu")
    r = hvd.global_rank()
    core = tstate.native_core()
    out = {"loaded": core is not None and core.group_sizes == [2]}
    seen = []
    if r == 0:
        def sample():
            time.sleep(1.5)
            seen.extend(core.stalled(0))

        probe = threading.Thread(target=sample)
        probe.start()
    else:
        time.sleep(LATE_S)
    hvd.allreduce(torch.ones(2), name="late_native")
    if r == 0:
        probe.join()
    out["stalled"] = seen
    try:
        hvd.allreduce(torch.ones(2 + r), name="shape_mismatch")
    except hvd.HorovodError as e:
        out["mismatch"] = str(e)
    out["again"] = hvd.allreduce(torch.ones(2), name="shape_mismatch",
                                 average=False).tolist()
    model = _Linear()
    rng = np.random.RandomState(1 + r)
    batch = (torch.tensor(rng.randn(8, 4).astype(np.float32)),
             torch.tensor(rng.randn(8, 2).astype(np.float32)))
    trainer = hvd.Trainer(
        model, lambda m, b: torch.mean((b[0] @ m.w + m.b - b[1]) ** 2),
        hvd.DistributedOptimizer(torch.optim.SGD(model.parameters(),
                                                 lr=0.05)))
    trainer.fit([batch], epochs=1, steps_per_epoch=2, verbose=False)
    out["w"] = model.w.tolist()
    hvd.shutdown()
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    from horovod_tpu_torch.run import run

    path = str(tmp_path_factory.mktemp("native") / "timeline.json")
    results = run(_native_world, 2, device="cpu", args=(path,), timeout=120)
    return results, path


def test_the_native_core_loads_on_every_rank(world):
    results, _ = world
    assert all(out["loaded"] for out in results)


def test_the_coordinators_table_names_the_missing_rank_while_it_waits(world):
    results, _ = world
    assert results[0]["stalled"] == [
        "late_native [ready ranks: [0]] [missing ranks: [1]]"]


def test_a_mismatch_through_the_table_raises_the_reference_text(world):
    from horovod_tpu.core import negotiate as jneg

    results, _ = world
    with pytest.raises(Exception) as info:
        jneg.validate_py(_jax_reqs([
            _spec(0, name="shape_mismatch", shape=(2,)),
            _spec(1, name="shape_mismatch", shape=(3,))]), 2)
    assert results[0]["mismatch"] == results[1]["mismatch"] == \
        str(info.value)
    # The failed round left nothing in the table: the name negotiates.
    assert results[0]["again"] == results[1]["again"] == [2.0, 2.0]


def test_a_two_rank_fit_shows_the_rank_ready_ticks(world):
    results, path = world
    assert results[0]["w"] == results[1]["w"]
    events = _trace(path)
    rows = {e["pid"]: e["args"]["name"] for e in events
            if e["name"] == "process_name"}
    buckets = sorted(n for n in rows.values()
                     if n.startswith("DistributedOptimizer.grads.bucket_"))
    assert buckets == ["DistributedOptimizer.grads.bucket_0",
                       "DistributedOptimizer.grads.bucket_1"]
    for name in buckets + ["late_native"]:
        row = [(e["name"], e["ph"]) for e in events
               if rows.get(e["pid"]) == name and e["ph"] != "M"]
        # The table's span brackets one tick a rank, each written as that
        # rank's requests reached the coordinator.
        assert row[:4] == [("NEGOTIATE_allreduce", "B"), ("0", "X"),
                           ("1", "X"), ("NEGOTIATE_allreduce", "E")], row


# -- init_distributed ---------------------------------------------------------


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _init_distributed_rank(rank: int, port: int, results) -> None:
    import torch.distributed as dist

    from horovod_tpu_torch.utils import distributed

    for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        os.environ.pop(k, None)
    try:
        import horovod_tpu_torch as hvd

        distributed.init_distributed(f"127.0.0.1:{port}", 2, rank,
                                     device="cpu")
        pg = dist.group.WORLD
        total = hvd.allreduce(torch.tensor([float(rank + 1)]), name="sum",
                              average=False)
        # A second call is a no-op on the rendezvous and on hvd.init.
        distributed.init_distributed(f"127.0.0.1:{port + 1}", 7, 5,
                                     device="cpu")
        same = (dist.group.WORLD is pg and hvd.size() == 2
                and hvd.rank() == rank)
        env = (os.environ["MASTER_ADDR"], os.environ["MASTER_PORT"],
               os.environ["WORLD_SIZE"], os.environ["RANK"])
        distributed.shutdown_distributed()
        results.put((rank, total.tolist(), same, env,
                     dist.is_initialized()))
    except BaseException as e:  # reported to the parent
        results.put((rank, repr(e)))


def test_init_distributed_meets_at_the_given_address():
    port = _free_port()
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_init_distributed_rank,
                         args=(r, port, results)) for r in range(2)]
    for p in procs:
        p.start()
    try:
        got = dict((r[0], r[1:]) for r in (results.get(timeout=90)
                                           for _ in procs))
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
    for r in range(2):
        total, same, env, still = got[r]
        assert total == [3.0]
        assert same
        assert env == ("127.0.0.1", str(port), "2", str(r))
        assert not still

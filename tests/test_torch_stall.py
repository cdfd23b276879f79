"""Stall detection in the port's negotiation (``core/negotiate.py``) against
the reference's per-process negotiator (``horovod_tpu/core/multihost.py``).

One spawned 2-rank gloo world (module-scoped) runs three scenarios in turn:

* rank 1 reaches a named allreduce about 2.5 s after rank 0, under
  ``HOROVOD_STALL_CHECK_TIME=1``: the coordinator (rank 0) prints the
  reference's stall warning naming ready rank 0 and missing rank 1, and
  ``StallWarningCallback`` prints the recorded report;
* a ``Trainer`` steps on a cached gradient plan: after the first step, no
  step makes a store call;
* under ``HOROVOD_NEGOTIATION_TIMEOUT=1`` rank 1 negotiates while the
  coordinator never does: rank 1 raises the reference's timeout error
  (with its hint adapted, ROADMAP §C) instead of hanging.

The reference's texts come from its own ``Negotiator`` in this process,
with the coordination-service calls stubbed (no JAX world of 2 processes
here). The spawned children import this module, so JAX is imported only
inside the parent-side functions.
"""

import contextlib
import io
import json
import os
import time

import pytest
import torch

LATE_S = 2.5
# The one sentence of the timeout error the port adapts: it has no
# HOROVOD_EAGER_CACHE (ROADMAP §C, intended divergences).
REF_HINT = ("With the eager verdict cache enabled this usually means this "
            "process issued a collective its peers did not (they replayed "
            "cached verdicts and never reached index {seq}) — a schedule "
            "divergence. Re-run with HOROVOD_EAGER_CACHE=0 to get per-call "
            "validation naming the diverging tensors.")
PORT_HINT = ("With the negotiation plan cache this usually means this "
             "process issued a collective its peers did not (they replayed "
             "cached plans and never reached index {seq}) — a schedule "
             "divergence. Compare the ranks' collective sequences; pass "
             "explicit name= arguments to collectives issued from "
             "conditional code.")


def _stall_world():
    """Target of each spawned rank."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.core import negotiate

    os.environ["HOROVOD_STALL_CHECK_TIME"] = "1"
    hvd.init(device="cpu")
    r = hvd.global_rank()
    neg = negotiate.negotiator()
    out = {}
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        if r == 1:
            time.sleep(LATE_S)
        hvd.allreduce(torch.ones(2), name="late")
        hvd.StallWarningCallback().on_batch_end(0)
    out["stdout"] = buf.getvalue()

    torch.manual_seed(0)
    model = torch.nn.Linear(3, 2)
    trainer = hvd.Trainer(model, lambda m, b: m(b).square().mean(),
                          torch.optim.SGD(model.parameters(), lr=0.1))
    batch = torch.randn(4, 3)
    trainer.train_step(batch)
    first = neg.store_calls
    for _ in range(3):
        trainer.train_step(batch)
    out["steady_calls"] = neg.store_calls - first
    out["plans"] = len(trainer.optimizer._allreduce._plans)

    os.environ["HOROVOD_NEGOTIATION_TIMEOUT"] = "1"
    out["seq"] = neg._seq.get(0, 0)  # the orphan's index on rank 1
    if r == 1:
        t0 = time.monotonic()
        try:
            hvd.allreduce(torch.ones(2), name="orphan")
        except hvd.HorovodError as e:
            out["timeout"] = str(e)
        out["waited"] = time.monotonic() - t0
    return out


@pytest.fixture(scope="module")
def world():
    from horovod_tpu_torch.run import run

    return run(_stall_world, 2, device="cpu", timeout=120)


def _reference_stall_text(monkeypatch, capsys) -> str:
    """What the reference's coordinator prints while rank 1 is missing
    from the negotiation of tensor ``late`` (stall time 1 s)."""
    import jax
    from horovod_tpu.core import multihost as jmh

    def submission(pid):
        return json.dumps({"name": "late", "requests": [
            {"rank": pid, "name": "late", "op": 0, "dtype": "float32",
             "shape": [2], "root_rank": -1, "group": 0}]})

    t0 = time.monotonic()

    class Pending(Exception):
        pass

    def kv_get(client, key, timeout_ms):
        if key.endswith("/p1") and time.monotonic() - t0 < 1.3:
            time.sleep(timeout_ms / 1e3)
            raise Pending(key)
        return submission(int(key.rsplit("/p", 1)[1]))

    class NoLiveness:
        def maybe_check(self, *a, **k):
            pass

    monkeypatch.setattr(jax, "process_count", lambda: 2)
    monkeypatch.setattr(jmh._res, "kv_get", kv_get)
    monkeypatch.setattr(jmh, "_is_kv_timeout",
                        lambda e: isinstance(e, Pending))
    monkeypatch.setattr(jmh._res, "liveness", lambda: NoLiveness())
    monkeypatch.setattr(jmh, "_kv_delete", lambda client, key: None)
    neg = jmh.Negotiator(0)
    neg.stall_seconds = 1.0
    capsys.readouterr()
    neg._coordinate(None, "late", 0, 2)
    return capsys.readouterr().out


def _reference_timeout_text(monkeypatch, seq: int) -> str:
    """The reference's error for a process whose coordinator never
    publishes the verdict on tensor ``orphan`` at index ``seq``."""
    import jax
    from horovod_tpu.core import multihost as jmh
    from horovod_tpu.core import negotiate as jneg

    def no_verdict(*a, **k):
        raise jmh._res.KVTimeout("verdict")

    monkeypatch.setattr(jax, "process_index", lambda: 1)
    monkeypatch.setattr(jmh, "_kv_client", lambda: None)
    monkeypatch.setattr(jmh._res, "kv_set", lambda *a, **k: None)
    monkeypatch.setattr(jmh._res, "wait_kv", no_verdict)
    neg = jmh.Negotiator(0)
    neg._seq = seq
    req = jneg.Request(rank=1, name="orphan",
                       op=jneg.CollectiveOp.ALLREDUCE, dtype="float32",
                       shape=(2,))
    with pytest.raises(jneg.HorovodError) as info:
        neg.negotiate("orphan", [req], 2)
    return str(info.value)


def test_coordinator_prints_the_reference_stall_warning(world, monkeypatch,
                                                        capsys):
    want = _reference_stall_text(monkeypatch, capsys)
    assert "[ready ranks: [0]] [missing ranks: [1]]" in want
    got = world[0]["stdout"]
    assert got.startswith(want), (got, want)
    # About 2.5 s late at a 1 s period: one or two warnings, no more.
    assert 1 <= got.count("Stalled ops: late ") <= 2
    assert "WARNING" not in world[1]["stdout"]


def test_stall_callback_prints_the_recorded_reports(world):
    line = ("WARNING: One or more tensors were submitted to be reduced, "
            "gathered or broadcasted by subset of ranks and are waiting "
            "for remainder of ranks: late [ready ranks: [0]] "
            "[missing ranks: [1]]\n")
    assert line in world[0]["stdout"]


def test_steady_state_makes_no_store_calls(world):
    for out in world:
        assert out["steady_calls"] == 0
        assert out["plans"] == 1


def test_missing_coordinator_times_out_with_the_reference_text(world,
                                                               monkeypatch):
    out = world[1]
    want = _reference_timeout_text(monkeypatch, out["seq"])
    seq = out["seq"]
    assert REF_HINT.format(seq=seq) in want
    assert out["timeout"] == want.replace(REF_HINT.format(seq=seq),
                                          PORT_HINT.format(seq=seq))
    assert 1.0 <= out["waited"] < 10.0
    assert "timeout" not in world[0]

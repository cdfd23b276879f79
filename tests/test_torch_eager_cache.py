"""The eager verdict replay (``HOROVOD_EAGER_CACHE``) and the desync texts of
the port's negotiation (``core/negotiate.py``) against the JAX package's
(``horovod_tpu/core/multihost.py``, ``analysis/protocol.py``), after
``tests/multihost_worker.py``'s cache and desync scenarios.

* Protocol: ``CACHEABLE_OPS``, ``AUTO_NAME``, ``coordinate`` and
  ``replay_fingerprint`` equal the JAX package's on the same cases.
* One spawned 2-rank gloo world runs, in turn:
  - a named allreduce: after its first call every call replays with no
    store call and no new negotiation index, and gives the bits the same
    calls give under ``HOROVOD_EAGER_CACHE=0``, where every call makes
    store calls;
  - an auto-named allreduce, a named allgather and a named gather never
    replay;
  - ``bump_generation`` drops the group's cache;
  - at a negotiation index past 0, rank 1 issues an unnamed allreduce
    where rank 0 issues a named one: both raise ``protocol.coordinate``'s
    text with that index (the JAX function's text for the same
    submissions), and a matching named collective then completes, the
    named one of the failed round included;
  - a batch of two whose second names differ raises the same text with
    the request's position; batches of different lengths raise the port's
    "Mismatched negotiation batches" text;
  - last: a collective only rank 1 issues, under a 2-s
    ``HOROVOD_NEGOTIATION_TIMEOUT``, raises the reference's timeout text
    naming the tensor and ``HOROVOD_EAGER_CACHE=0``.

The spawned children import this module, so JAX is imported only inside
the parent-side functions.
"""

import os
import time

import numpy as np
import pytest
import torch

from horovod_tpu_torch.analysis import protocol as tproto

# -- protocol ------------------------------------------------------------------


def _wire(rank, name, op=0, dtype="float32", shape=(2,), root=-1):
    return {"rank": rank, "name": name, "op": op, "dtype": dtype,
            "shape": list(shape), "root_rank": root, "group": 0}


COORDINATE_CASES = [
    # every process submitted the same valid collective
    ({0: {"name": "g", "requests": [_wire(0, "g")]},
      1: {"name": "g", "requests": [_wire(1, "g")]}}, "g", 0, 2),
    # an auto-named drift, at index 7
    ({0: {"name": "g", "requests": [_wire(0, "g")]},
      1: {"name": "HorovodAllreduce_3",
          "requests": [_wire(1, "HorovodAllreduce_3")]}}, "g", 7, 2),
    # a process with no members of the group submits no request
    ({0: {"name": "g", "requests": [_wire(0, "g")]},
      1: {"name": "h", "requests": []}}, "g", 2, 1),
    # the names agree, the metadata does not
    ({0: {"name": "g", "requests": [_wire(0, "g")]},
      1: {"name": "g", "requests": [_wire(1, "g", dtype="int32")]}},
     "g", 4, 2),
    # allgather sizes, three processes
    ({p: {"name": "ag", "requests": [_wire(p, "ag", op=1,
                                           shape=(p + 1, 3))]}
      for p in range(3)}, "ag", 1, 3),
    # a broadcast root out of range
    ({p: {"name": "b", "requests": [_wire(p, "b", op=2, root=5)]}
      for p in range(2)}, "b", 9, 2),
]

FINGERPRINT_CASES = [
    ("grads", 0, 2, (0,), True),
    ("grads", 0, 2, (0,), False),
    ("grads", None, 2, (), True),
    ("grads", 1, 2, (1,), True),
    ("grads", 3, 4, (3, 3), True),
    ("grads", 2, 4, (2,), True),
    ("grads", 4, 4, (4,), True),
    ("grads", 5, 4, (5,), True),
    ("HorovodAllreduce_12", 0, 2, (0,), True),
    ("HorovodAllreduce_x", 0, 2, (0,), True),
    ("grads", 0, 2, (0, 2), True),
    ("grads", 0, 3, (), True),
]


def test_the_replay_constants_are_the_jax_packages():
    from horovod_tpu.analysis import protocol as jproto

    assert tproto.CACHEABLE_OPS == jproto.CACHEABLE_OPS
    assert tproto.AUTO_NAME.pattern == jproto.AUTO_NAME.pattern


@pytest.mark.parametrize("case", range(len(COORDINATE_CASES)))
def test_coordinate_equals_jax(case):
    from horovod_tpu.analysis import protocol as jproto

    per_proc, name, seq, size = COORDINATE_CASES[case]
    assert tproto.coordinate(per_proc, name, seq, size) == \
        jproto.coordinate(per_proc, name, seq, size)


@pytest.mark.parametrize("case", range(len(FINGERPRINT_CASES)))
def test_replay_fingerprint_equals_jax(case):
    from horovod_tpu.analysis import protocol as jproto

    args = FINGERPRINT_CASES[case]
    assert tproto.replay_fingerprint(*args) == \
        jproto.replay_fingerprint(*args)


# -- one 2-rank world ------------------------------------------------------------


def _calls(fn, n: int):
    """``n`` calls of ``fn``: their results, and the store calls and
    negotiation indices they cost."""
    from horovod_tpu_torch.core import negotiate

    neg = negotiate.negotiator()
    calls0, seq0 = neg.store_calls, neg._seq.get(0, 0)
    outs = [fn() for _ in range(n)]
    return outs, neg.store_calls - calls0, neg._seq.get(0, 0) - seq0


def _cache_world():
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.core import negotiate
    from horovod_tpu_torch.core import state as tstate
    from horovod_tpu_torch.ops import collectives as tcoll

    hvd.init(device="cpu")
    r = hvd.global_rank()
    neg = negotiate.negotiator()
    out = {}
    x = torch.tensor(np.random.RandomState(r).randn(5).astype(np.float32))

    def steady():
        return hvd.allreduce(x, name="steady", average=False)

    first, out["first_calls"], _ = _calls(steady, 1)
    cached, out["cached_calls"], out["cached_seqs"] = _calls(steady, 20)
    os.environ["HOROVOD_EAGER_CACHE"] = "0"
    plain, out["plain_calls"], out["plain_seqs"] = _calls(steady, 5)
    del os.environ["HOROVOD_EAGER_CACHE"]
    out["same_bits"] = all(torch.equal(t, first[0])
                           for t in cached + plain)
    out["sum"] = first[0].tolist()

    never = {
        "auto": lambda: hvd.allreduce(x, average=False),
        "allgather": lambda: hvd.allgather(x[None], name="ag"),
        "gather": lambda: hvd.gather(x[None], root_rank=0, name="ga"),
    }
    out["never"] = {k: _calls(fn, 3)[1:] for k, fn in never.items()}

    _, out["before_bump"], _ = _calls(steady, 2)
    tstate.bump_generation(0)
    _, out["after_bump"], _ = _calls(steady, 1)
    _, out["after_bump_again"], _ = _calls(steady, 2)

    # Desync at a negotiation index past 0: rank 1's unnamed collective
    # meets rank 0's named one.
    out["desync_seq"] = neg._seq.get(0, 0)
    k = tcoll._name_counters.get("HorovodAllreduce", 0)
    out["auto_name"] = f"HorovodAllreduce_{k}"
    try:
        if r == 1:
            hvd.allreduce(torch.ones(2), average=False)
        else:
            hvd.allreduce(torch.ones(2), name="sync_after_desync",
                          average=False)
    except hvd.HorovodError as e:
        out["desync"] = str(e)
    out["recover"] = hvd.allreduce(torch.ones(1), name="desync_recover",
                                   average=False).tolist()
    out["named_again"] = hvd.allreduce(torch.ones(2),
                                       name="sync_after_desync",
                                       average=False).tolist()

    g = tstate.get_group(0)

    def req(name):
        return negotiate.Request(rank=r, name=name,
                                 op=negotiate.CollectiveOp.ALLREDUCE,
                                 dtype="float32", shape=(3,))

    out["batch_seq"] = neg._seq.get(0, 0)
    try:
        negotiate.negotiate([req("batch_a"),
                             req("batch_b" if r == 0 else "batch_c")], g)
    except hvd.HorovodError as e:
        out["batch_desync"] = str(e)
    try:
        negotiate.negotiate([req("len_a")] + ([req("len_b")] if r == 1
                                              else []), g)
    except hvd.HorovodError as e:
        out["batch_lengths"] = str(e)

    # Last: a collective only rank 1 issues (the indices stay misaligned).
    out["orphan_seq"] = neg._seq.get(0, 0)
    if r == 1:
        os.environ["HOROVOD_NEGOTIATION_TIMEOUT"] = "2"
        t0 = time.monotonic()
        try:
            hvd.allreduce(torch.ones(2), name="only_p1", average=False)
        except hvd.HorovodError as e:
            out["timeout"] = str(e)
        out["waited"] = time.monotonic() - t0
    return out


@pytest.fixture(scope="module")
def world():
    from horovod_tpu_torch.run import run

    saved = {k: os.environ.pop(k) for k in ("HOROVOD_EAGER_CACHE",
                                            "HOROVOD_NEGOTIATION_TIMEOUT")
             if k in os.environ}
    try:
        return run(_cache_world, 2, device="cpu", timeout=120)
    finally:
        os.environ.update(saved)


def test_a_named_allreduce_replays_with_no_store_call(world):
    want = (np.random.RandomState(0).randn(5).astype(np.float32)
            + np.random.RandomState(1).randn(5).astype(np.float32))
    for out in world:
        assert out["first_calls"] > 0
        assert out["cached_calls"] == 0 and out["cached_seqs"] == 0
        # HOROVOD_EAGER_CACHE=0: every call renegotiates.
        assert out["plain_calls"] >= 5 and out["plain_seqs"] == 5
        assert out["same_bits"]
        np.testing.assert_array_equal(np.float32(out["sum"]), want)


@pytest.mark.parametrize("kind", ["auto", "allgather", "gather"])
def test_auto_names_and_the_allgather_family_never_replay(world, kind):
    for out in world:
        calls, seqs = out["never"][kind]
        assert calls >= 3 and seqs == 3


def test_a_bumped_generation_drops_the_cache(world):
    for out in world:
        assert out["before_bump"] == 0
        assert out["after_bump"] > 0
        assert out["after_bump_again"] == 0


def test_a_desync_past_index_0_raises_coordinates_text(world):
    from horovod_tpu.analysis import protocol as jproto

    seq = world[0]["desync_seq"]
    assert seq > 0 and world[1]["desync_seq"] == seq
    auto = world[1]["auto_name"]
    want = jproto.coordinate(
        {0: {"name": "sync_after_desync",
             "requests": [_wire(0, "sync_after_desync")]},
         1: {"name": auto, "requests": [_wire(1, auto)]}},
        "sync_after_desync", seq, 2)["error"]
    assert f"at negotiation index {seq}," in want
    assert world[0]["desync"] == world[1]["desync"] == want
    # A matching named collective then completes, and so does the name the
    # failed round left in the coordinator's table.
    for out in world:
        assert out["recover"] == [2.0]
        assert out["named_again"] == [2.0, 2.0]


def test_a_batch_desync_names_the_request_position(world):
    from horovod_tpu.analysis import protocol as jproto

    seq = world[0]["batch_seq"]
    one = jproto.coordinate(
        {0: {"name": "batch_b",
             "requests": [_wire(0, "batch_b", shape=(3,))]},
         1: {"name": "batch_c",
             "requests": [_wire(1, "batch_c", shape=(3,))]}},
        "batch_b", seq, 2)["error"]
    want = one.replace(f"at negotiation index {seq},",
                       f"at negotiation index {seq} (request 1 of a batch "
                       f"of 2),")
    assert want != one
    assert world[0]["batch_desync"] == world[1]["batch_desync"] == want
    lengths = ("Mismatched negotiation batches: group-local rank 1 "
               "submitted 2 request(s) while rank 0 submitted 1. All ranks "
               "must issue the same collectives in the same order.")
    assert world[0]["batch_lengths"] == world[1]["batch_lengths"] == lengths


def test_a_collective_only_one_rank_issues_times_out_naming_the_cache(world):
    out = world[1]
    seq = out["orphan_seq"]
    assert out["timeout"] == (
        f"Timed out waiting for the coordinator's verdict on tensor only_p1 "
        f"(negotiation index {seq}). With the eager verdict cache enabled "
        f"this usually means this process issued a collective its peers "
        f"did not (they replayed cached verdicts and never reached index "
        f"{seq}) — a schedule divergence. Re-run with HOROVOD_EAGER_CACHE=0 "
        f"to get per-call validation naming the diverging tensors.")
    assert 2.0 <= out["waited"] < 10.0
    assert "timeout" not in world[0]

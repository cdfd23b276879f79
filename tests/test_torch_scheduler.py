"""The port's serving scheduler against the JAX package's
(``horovod_tpu_torch/serving/scheduler.py`` vs ``horovod_tpu/serving/
scheduler.py``).

Each scenario is written once against a namespace of ``BlockPool``,
``PrefixIndex``, ``Scheduler``, ``Request`` and ``AdmissionError``, and run
on both packages; its trace — every admission (ids, block tables, shared
spans, prefill skips, admission order), refusal (error type and message),
deadline drop, eviction, prefix-index hit and miss, and the allocator's free
list and refcounts after each operation — must be equal. The scenarios are
those of ``tests/test_serving.py``'s ``TestScheduler``, ``TestPrefixIndex``
and deadline-gate tests, plus a mixed one. The scheduler is host-side
Python, so equality is exact.
"""

import types

import numpy as np
import pytest

from horovod_tpu.serving import kv_cache as jkv
from horovod_tpu.serving import scheduler as jsched
from horovod_tpu_torch.serving import kv_cache as tkv
from horovod_tpu_torch.serving import scheduler as tsched

JAX = types.SimpleNamespace(kv=jkv, s=jsched)
PORT = types.SimpleNamespace(kv=tkv, s=tsched)


def _req(m, rid, tenant="a", plen=8, max_new=4, prompt=None, deadline=None):
    prompt = (np.zeros((plen,), np.int32) if prompt is None
              else np.asarray(prompt, np.int32))
    r = m.s.Request(request_id=rid, tenant=tenant, prompt=prompt,
                    max_new_tokens=max_new, orig_prompt=prompt.copy())
    r.deadline_ms = deadline
    return r


def _pool_state(pool):
    return list(pool._free), dict(sorted(pool._refs.items()))


def _reqs(rs):
    return [(r.request_id, r.tenant, list(r.blocks), r.shared_blocks,
             r.skip_tokens, r.state.value, r.admitted_seq, r.preemptions,
             r.deadline_missed) for r in rs]


def _try(fn):
    try:
        return ("ok", fn())
    except Exception as e:  # refusals are part of the contract
        return ("raised", type(e).__name__, str(e))


def fairness(m):
    pool = m.kv.BlockPool(num_blocks=64, block_size=8)
    sched = m.s.Scheduler(pool, max_batch=8)
    for i in range(4):
        sched.submit(_req(m, i, tenant="a"))
    for i in range(4, 8):
        sched.submit(_req(m, i, tenant="b"))
    trace = [_reqs(sched.admit(4))]
    late = m.s.Scheduler(m.kv.BlockPool(64, 8), max_batch=8)
    for i in range(5):
        late.submit(_req(m, i, tenant="flood"))
    trace.append(_reqs(late.admit(1)))
    late.submit(_req(m, 99, tenant="late"))
    trace += [_reqs(late.admit(1)), _reqs(late.admit(3)), late.queued,
              _pool_state(pool)]
    return trace


def exhaustion_and_queue_bound(m):
    pool = m.kv.BlockPool(num_blocks=3, block_size=8)
    sched = m.s.Scheduler(pool, max_batch=8)
    sched.submit(_req(m, 0, plen=16))
    sched.submit(_req(m, 1, plen=8))
    first = sched.admit(8)
    trace = [_reqs(first), sched.queued, _pool_state(pool)]
    sched.release(first[0])
    trace += [_reqs(sched.admit(8)), _pool_state(pool)]
    small = m.s.Scheduler(m.kv.BlockPool(4, 8), max_batch=1, max_queue=2)
    for i in range(3):
        trace.append(_try(lambda i=i: small.submit(_req(m, i)).request_id))
    return trace


def preemption_requeue(m):
    pool = m.kv.BlockPool(num_blocks=16, block_size=4)
    sched = m.s.Scheduler(pool, max_batch=3)
    for i in range(4):
        sched.submit(_req(m, i, tenant="ab"[i % 2], plen=6))
    running = sched.admit(3)
    trace = [_reqs(running), _pool_state(pool)]
    victim = running[-1]
    sched.release(victim)
    victim.prompt = np.concatenate([victim.prompt, [5, 6]]).astype(np.int32)
    sched.requeue_front(victim)
    trace += [sched.queued, _pool_state(pool), _reqs(sched.admit(2)),
              _pool_state(pool)]
    return trace


def prefix_index(m):
    trace = []
    pool = m.kv.BlockPool(16, 4)
    idx = m.s.PrefixIndex(pool)
    toks = np.arange(10, dtype=np.int32)
    blocks = pool.alloc(3)
    other = toks.copy()
    other[5] = 99
    trace += [idx.insert(toks, blocks), idx.match(toks), idx.match(other),
              idx.match(np.asarray([7, 7, 7, 7])), _pool_state(pool)]
    pool.release(blocks)
    second = pool.alloc(2)
    trace += [idx.insert(toks, second), idx.match(toks, record=False),
              len(idx), sorted(idx.blocks()), idx.hits, idx.misses]
    # LRU order, protect, refcount-pinned pages, cascading interior nodes.
    pool2 = m.kv.BlockPool(16, 4)
    idx2 = m.s.PrefixIndex(pool2)
    chain = pool2.alloc(3)
    idx2.insert(np.arange(12, dtype=np.int32), chain)
    a, b = pool2.alloc(1), pool2.alloc(1)
    idx2.insert(np.arange(20, 24, dtype=np.int32), a)
    idx2.insert(np.arange(30, 34, dtype=np.int32), b)
    trace += [idx2.reclaimable(), _pool_state(pool2)]
    pool2.release(a)
    pool2.release(b)
    pool2.release(chain[1:])
    # Distinct LRU stamps: both packages break ties by object address.
    idx2.match(np.arange(30, 34, dtype=np.int32))
    idx2.match(np.arange(20, 24, dtype=np.int32))
    trace += [idx2.reclaimable(), idx2.reclaimable(protect=frozenset(a)),
              idx2.evict(1), _pool_state(pool2),
              idx2.evict(5, protect=frozenset(a)), _pool_state(pool2)]
    pool2.release([chain[0]])
    trace += [idx2.evict(10), _pool_state(pool2), len(idx2),
              _try(lambda: idx2.insert(np.arange(4), [m.kv.NULL_BLOCK]))]
    pool2.check_invariants()
    return trace


def shared_prefix_admission(m):
    """Admissions through the index: shared spans mapped, the rest fresh;
    cached pages evicted only when that covers the shortfall."""
    pool = m.kv.BlockPool(num_blocks=12, block_size=4)
    idx = m.s.PrefixIndex(pool)
    sched = m.s.Scheduler(pool, max_batch=4, prefix_index=idx)
    base = np.arange(100, 110, dtype=np.int32)       # 2 full blocks + 2
    sched.submit(_req(m, 0, prompt=base))
    first = sched.admit(4)
    sched.note_prefilled(first[0])
    trace = [_reqs(first), _pool_state(pool)]
    for rid, tail in ((1, [1, 2, 3]), (2, [7]), (3, list(range(9)))):
        sched.submit(_req(m, rid, tenant="t", prompt=np.concatenate(
            [base[:8], tail])))
    got = sched.admit(4)
    trace += [_reqs(got), _pool_state(pool), idx.hits, idx.misses]
    for r in got:
        sched.note_prefilled(r)
    for r in first + got:
        sched.release(r)
    trace += [_pool_state(pool), sorted(idx.blocks())]
    # A request larger than the free pages evicts cached ones to fit.
    sched.submit(_req(m, 9, tenant="big", plen=40))
    trace += [_reqs(sched.admit(1)), _pool_state(pool), len(idx)]
    pool.check_invariants()
    return trace


def deadlines(m):
    pool = m.kv.BlockPool(num_blocks=64, block_size=8)
    slow = m.s.Scheduler(pool, max_batch=4, prefill_rate=lambda: 0.01)
    slow.submit(_req(m, 0, plen=8, deadline=1000.0))     # needs 800 ms
    slow.submit(_req(m, 1, plen=8, deadline=400.0))      # expired
    slow.submit(_req(m, 2, plen=8))                      # no deadline
    trace = [_reqs(slow.admit(4, now_ms=500.0)),
             _reqs(slow.deadline_dropped), _pool_state(pool)]
    fast = m.s.Scheduler(m.kv.BlockPool(64, 8), max_batch=4,
                         prefill_rate=lambda: 1.0)
    fast.submit(_req(m, 3, plen=8, deadline=1000.0))
    trace += [_reqs(fast.admit(4, now_ms=500.0)), fast.deadline_dropped,
              [r.request_id for r in fast.pending_requests()]]
    return trace


SCENARIOS = (fairness, exhaustion_and_queue_bound, preemption_requeue,
             prefix_index, shared_prefix_admission, deadlines)


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_scheduler_matches_jax(scenario):
    want = scenario(JAX)
    got = scenario(PORT)
    assert got == want


def test_constructor_refusals_match_jax():
    for kw in (dict(max_batch=0), dict(max_batch=1, max_queue=-1),
               dict(max_batch=1, headroom_tokens=-1)):
        with pytest.raises(ValueError) as je:
            jsched.Scheduler(jkv.BlockPool(4, 4), **kw)
        with pytest.raises(ValueError) as te:
            tsched.Scheduler(tkv.BlockPool(4, 4), **kw)
        assert str(te.value) == str(je.value)

"""The port's serving engine (``horovod_tpu_torch.serving.Engine``) on the
CPU, against the JAX package's engine and against the port's own
``generate``.

The LM is ``tests/test_serving.py``'s small config (vocab 128, 2 layers,
H=4, Hkv=2, E=64, mlp 128, max_seq_len 64), fp32 unless a test says bf16,
with one numpy-seeded flax parameter tree feeding both frameworks
(``from_flax_params``); prompts are numpy-seeded too.

Every comparison here is exact (token for token): greedy tokens against
JAX's engine; the one-slot engine against ``generate`` (the same attend at
the same shapes); a row against its solo run in the same engine shape; a
preempted request's recompute and a copy-on-write prefix fork against their
undisturbed runs, in bf16 and int8_block pages (quantize once, on write);
sampled tokens across batch compositions. The trace counters stay at 1
across composition churn, and the env knobs' typo messages are the
reference's byte for byte. The load driver (``tools/serve_bench_torch.py``)
draws the reference driver's open-loop trace and runs end to end.
"""

import numpy as np
import pytest
import torch

from horovod_tpu import serving as jserving
from horovod_tpu.utils import env as jenv
from horovod_tpu_torch import serving
from horovod_tpu_torch.models import transformer as tt
from horovod_tpu_torch.utils import env as tenv

from torch_lm_support import configs, numpy_params, port_model, tokens


@pytest.fixture(scope="module")
def lm():
    jcfg, tcfg = configs()
    params = numpy_params(jcfg)
    return jcfg, params, tcfg, port_model(tcfg, params)


@pytest.fixture(scope="module")
def lm_bf16():
    _, tcfg = configs("bf16")
    return tcfg, port_model(tcfg, numpy_params(tcfg))


def _prompt(n, seed=0):
    return tokens(1, n, seed=seed)[0]


def _engine(tcfg, model, **kw):
    kw.setdefault("block_size", 8)
    kw.setdefault("max_batch", 3)
    return serving.Engine(tcfg, model, device="cpu", **kw)


def test_greedy_tokens_match_the_jax_engine(lm):
    jcfg, params, tcfg, model = lm
    prompts = [_prompt(n, seed=n) for n in (5, 9, 13, 3)]
    want = jserving.Engine(jcfg, params, block_size=8, max_batch=3,
                           max_prompt_len=16).generate_batch(prompts, 10)
    got = _engine(tcfg, model, max_prompt_len=16).generate_batch(prompts, 10)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_one_slot_engine_bit_identical_to_generate(lm, lm_bf16, dtype):
    tcfg, model = (lm[2], lm[3]) if dtype == "fp32" else lm_bf16
    eng = _engine(tcfg, model, max_batch=1, max_prompt_len=16)
    assert eng.kv_dtype == dtype
    for seed, n in ((9, 5), (2, 11)):
        prompt = _prompt(n, seed=seed)
        want = tt.generate(tcfg, model, prompt[None], 8, device="cpu")[0]
        np.testing.assert_array_equal(eng.generate_batch([prompt], 8)[0],
                                      want.numpy())


def test_rows_unchanged_under_continuous_batching(lm):
    """Staggered arrivals of other tenants, different lengths: every row
    equals its solo run in an engine of the same shape."""
    _, _, tcfg, model = lm
    work = [(_prompt(5, 9), 10, "a"), (_prompt(4, 1), 6, "b"),
            (_prompt(7, 2), 12, "c"), (_prompt(3, 3), 5, "b")]
    solo = _engine(tcfg, model, max_batch=4, max_prompt_len=16)
    want = [solo.generate_batch([p], n)[0] for p, n, _ in work]
    eng = _engine(tcfg, model, max_batch=4, max_prompt_len=16)
    reqs = [eng.submit(*work[0][:2])]
    eng.step()
    eng.step()
    reqs.append(eng.submit(*work[1][:2], tenant="b"))
    eng.step()
    reqs += [eng.submit(p, n, tenant=t) for p, n, t in work[2:]]
    eng.run_until_idle()
    for r, w in zip(reqs, want):
        np.testing.assert_array_equal(r.full_sequence(), w)
    assert eng.stats["finished"] == 4 and eng.pool.num_used == 0


@pytest.mark.parametrize("kvd", ["bf16", "int8_block"])
def test_preemption_recompute_bit_identical(lm_bf16, kvd):
    """A pool too small for both requests preempts the newest; its
    recomputed continuation equals the undisturbed run — the re-prefilled
    pages carry the bits the evicted ones did."""
    tcfg, model = lm_bf16
    prompts = [_prompt(5, seed=s) for s in (9, 3)]
    ample = _engine(tcfg, model, block_size=4, max_batch=2,
                    max_prompt_len=32, kv_dtype=kvd)
    want = ample.generate_batch(prompts, 12)
    scarce = _engine(tcfg, model, block_size=4, max_batch=2, num_blocks=7,
                     max_prompt_len=32, kv_dtype=kvd)
    reqs = [scarce.submit(p, 12) for p in prompts]
    scarce.run_until_idle()
    assert scarce.stats["preemptions"] >= 1
    assert sum(r.preemptions for r in reqs) >= 1
    for r, w in zip(reqs, want):
        np.testing.assert_array_equal(r.full_sequence(), w)
    scarce.pool.check_invariants()


@pytest.mark.parametrize("kvd", ["fp32", "int8_block"])
def test_shared_prefix_cow_fork_outputs_unchanged(lm, kvd):
    """A cold prompt seeds the prefix cache, then two requests fork off
    the shared 12 tokens at once: the span is not prefilled again, and all
    three outputs equal their unshared runs."""
    _, _, tcfg, model = lm
    pre = _prompt(12, seed=7)
    prompts = [np.concatenate([pre, _prompt(2, seed=50 + s)])
               for s in range(3)]
    plain = _engine(tcfg, model, block_size=4, max_prompt_len=24,
                    kv_dtype=kvd)
    want = [plain.generate_batch([p], 5)[0] for p in prompts]
    eng = _engine(tcfg, model, block_size=4, max_prompt_len=24,
                  kv_dtype=kvd, prefix_cache=True)
    reqs = [eng.submit(prompts[0], 5)]
    eng.run_until_idle()
    reqs += [eng.submit(p, 5) for p in prompts[1:]]
    eng.step()
    assert [r.skip_tokens for r in reqs[1:]] == [12, 12]
    eng.run_until_idle()
    for r, w in zip(reqs, want):
        np.testing.assert_array_equal(r.full_sequence(), w)
    assert eng.stats["prefix_hit_tokens"] == 24
    assert eng.stats["prefill_steps"] == 14 + 2
    stats = eng.cache_stats()
    assert stats["prefix_index_hits"] == 2
    assert stats["prefix_index_misses"] == 1
    # A fully cached, block-aligned prompt still gets its first token.
    req = eng.submit(pre[:8], 5)
    eng.step()
    assert req.skip_tokens == req.prompt_len == 8
    eng.run_until_idle()
    np.testing.assert_array_equal(req.full_sequence(),
                                  plain.generate_batch([pre[:8]], 5)[0])
    eng.pool.check_invariants()


def test_trace_counts_stay_one_across_churn(lm):
    _, _, tcfg, model = lm
    eng = _engine(tcfg, model, block_size=4, max_batch=4, num_blocks=25,
                  max_prompt_len=16, kv_dtype="int8_block",
                  prefix_cache=True)
    assert (eng.decode_trace_count, eng.prefill_trace_count) == (0, 0)
    pre = _prompt(8, seed=11)
    for s in range(6):
        eng.submit(np.concatenate([pre, _prompt(3, seed=100 + s)]), 6,
                   tenant=f"t{s % 2}")
        eng.step()
    eng.run_until_idle()
    eng.submit(_prompt(2, seed=4), 4)   # a second wave, empty engine
    eng.run_until_idle()
    assert eng.stats["prefix_hit_tokens"] > 0
    assert eng.decode_trace_count == 1
    assert eng.prefill_trace_count == 1
    eng.pool.check_invariants()


def test_sampling_deterministic_and_composition_independent(lm):
    """temperature > 0: a request's draws are keyed by (engine seed,
    request seed, position), so it reproduces its tokens alone, beside
    another request, and across a preemption's recompute."""
    _, _, tcfg, model = lm
    prompt = _prompt(5, seed=4)
    kw = dict(block_size=4, max_prompt_len=32, temperature=1.0, seed=7)
    a = _engine(tcfg, model, max_batch=1, **kw)
    ra = a.submit(prompt, 12, sample_seed=11)
    a.run_until_idle()
    b = _engine(tcfg, model, max_batch=4, **kw)
    rb = b.submit(prompt, 12, sample_seed=11)
    b.submit(_prompt(4, seed=5), 6, sample_seed=12)
    b.run_until_idle()
    assert ra.output == rb.output
    c = _engine(tcfg, model, max_batch=2, num_blocks=7, **kw)
    rc = [c.submit(_prompt(5, seed=9), 12, sample_seed=3),
          c.submit(prompt, 12, sample_seed=11)]
    c.run_until_idle()
    assert c.stats["preemptions"] >= 1
    assert rc[1].output == ra.output
    other = _engine(tcfg, model, max_batch=1, **dict(kw, seed=8))
    assert other.generate_batch([prompt], 12)[0].tolist() != \
        ra.full_sequence().tolist()


def test_admission_refusals_match_the_jax_engine(lm):
    jcfg, params, tcfg, model = lm
    cases = [(dict(num_blocks=3, max_prompt_len=16), (_prompt(16), 20)),
             (dict(), (_prompt(16), 64)),
             (dict(max_prompt_len=8), (_prompt(9), 2))]
    for kw, args in cases:
        with pytest.raises(jserving.AdmissionError) as je:
            jserving.Engine(jcfg, params, block_size=8, max_batch=1,
                            **kw).submit(*args)
        eng = _engine(tcfg, model, max_batch=1, **kw)
        with pytest.raises(serving.AdmissionError) as te:
            eng.submit(*args)
        assert str(te.value) == str(je.value)
        assert eng.stats["rejected"] == 1
    with pytest.raises(Exception, match="kv_dtype"):
        _engine(tcfg, model, kv_dtype="int8")


def test_pool_exhaustion_queues_then_serves(lm):
    _, _, tcfg, model = lm
    eng = _engine(tcfg, model, max_batch=2, num_blocks=4, max_prompt_len=16)
    r0, r1 = eng.submit(_prompt(16, 1), 4), eng.submit(_prompt(16, 2), 4)
    eng.step()
    assert serving.RequestState.QUEUED in (r0.state, r1.state)
    eng.run_until_idle()
    assert r0.state == r1.state == serving.RequestState.FINISHED
    assert eng.pool.num_used == 0
    eng.pool.check_invariants()


def test_eos_stops_early(lm):
    _, _, tcfg, model = lm
    prompt = _prompt(5, seed=9)
    ref = tt.generate(tcfg, model, prompt[None], 8, device="cpu")[0].numpy()
    eos = int(ref[5])
    stop = int(np.argmax(ref[5:] == eos)) + 1
    eng = _engine(tcfg, model, max_batch=1, max_prompt_len=16, eos_id=eos)
    req = eng.submit(prompt, 8)
    eng.run_until_idle()
    assert req.output[-1] == eos and len(req.output) == stop
    np.testing.assert_array_equal(req.full_sequence(), ref[:5 + stop])


def test_engine_writes_the_serving_timeline_row(lm, tmp_path):
    from horovod_tpu_torch.core import timeline

    _, _, tcfg, model = lm
    tl = timeline.session()
    path = tmp_path / "serve.json"
    tl.start(str(path))
    try:
        _engine(tcfg, model, max_batch=1).generate_batch([_prompt(3)], 2)
    finally:
        tl.stop()
    text = path.read_text()
    for name in ("PREFILL", "DECODE", "ADMIT", "EVICT"):
        assert f'"name": "{name}"' in text
    assert '"name": "serving"' in text


# -- the env knobs: the reference's messages, byte for byte --------------------

KNOB_TYPOS = [
    ("HOROVOD_SERVE_BLOCK_SIZE", "serve_block_size", ["sixteen", "0", "-4"]),
    ("HOROVOD_SERVE_MAX_BATCH", "serve_max_batch", ["eight", "2.0", "0"]),
    ("HOROVOD_SERVE_KV_DTYPE", "serve_kv_dtype", ["int7", "fp16"]),
    ("HOROVOD_SERVE_PREFIX_CACHE", "serve_prefix_cache", ["maybe", "2"]),
    ("HOROVOD_SERVE_SPECULATE", "serve_speculate", ["four", "-1"]),
    ("HOROVOD_SERVE_DRAFT_KV_DTYPE", "serve_draft_kv_dtype", ["int2"]),
    ("HOROVOD_SERVE_DEADLINE_MS", "serve_deadline_ms",
     ["soon", "nan", "0", "inf"]),
    ("HOROVOD_SERVE_JOURNAL", "serve_journal_path", ["serve.json"]),
    ("HOROVOD_SERVE_WATCHDOG_TIMEOUT", "serve_watchdog_timeout",
     ["fast", "nan", "-1", "inf"]),
    ("HOROVOD_SERVE_MIN_ACCEPT", "serve_min_accept", ["most", "nan", "1.5"]),
]


@pytest.mark.parametrize("var,fn,bads", KNOB_TYPOS,
                         ids=[k[0] for k in KNOB_TYPOS])
def test_knob_typos_raise_the_reference_message(monkeypatch, var, fn, bads):
    monkeypatch.delenv(var, raising=False)
    assert getattr(tenv, fn)() == getattr(jenv, fn)()     # the default
    for bad in bads:
        monkeypatch.setenv(var, bad)
        with pytest.raises(ValueError) as je:
            getattr(jenv, fn)()
        with pytest.raises(ValueError) as te:
            getattr(tenv, fn)()
        assert str(te.value) == str(je.value)
    assert var in tenv.KNOWN_ENV_VARS


def test_knob_values_read_as_the_reference_reads_them(monkeypatch):
    for var, fn, good in (
            ("HOROVOD_SERVE_BLOCK_SIZE", "serve_block_size", "32"),
            ("HOROVOD_SERVE_KV_DTYPE", "serve_kv_dtype", " INT4 "),
            ("HOROVOD_SERVE_PREFIX_CACHE", "serve_prefix_cache", "1"),
            ("HOROVOD_SERVE_DEADLINE_MS", "serve_deadline_ms", "250.5"),
            ("HOROVOD_SERVE_JOURNAL", "serve_journal_path",
             " a/b.journal.json "),
            ("HOROVOD_SERVE_MIN_ACCEPT", "serve_min_accept", "0.25")):
        monkeypatch.setenv(var, good)
        assert getattr(tenv, fn)() == getattr(jenv, fn)()
    assert tenv.unknown_horovod_vars(
        {"HOROVOD_SERVE_KV_DTYP": "x", "HOROVOD_SERVE_KV_DTYPE": "x"}) == [
        "HOROVOD_SERVE_KV_DTYP"]


def test_knob_typos_raise_at_init(monkeypatch):
    import horovod_tpu_torch as hvd

    hvd.shutdown()
    monkeypatch.setenv("HOROVOD_SERVE_KV_DTYPE", "int7")
    with pytest.raises(ValueError, match="HOROVOD_SERVE_KV_DTYPE"):
        hvd.init(device="cpu")
    assert not hvd.is_initialized()


def test_engine_reads_the_knobs(lm, monkeypatch):
    _, _, tcfg, model = lm
    monkeypatch.setenv("HOROVOD_SERVE_BLOCK_SIZE", "4")
    monkeypatch.setenv("HOROVOD_SERVE_MAX_BATCH", "2")
    monkeypatch.setenv("HOROVOD_SERVE_KV_DTYPE", "int4")
    monkeypatch.setenv("HOROVOD_SERVE_PREFIX_CACHE", "1")
    eng = serving.Engine(tcfg, model, device="cpu")
    assert (eng.block_size, eng.max_batch, eng.kv_dtype) == (4, 2, "int4")
    assert eng.prefix_index is not None
    assert [tuple(p.shape) for p in eng._pools] == [
        (2, 2 * 16 + 1, 4, 2, 8)] * 2 + [(2, 2 * 16 + 1, 4, 2)] * 2
    assert eng.cache_stats()["kv_cache_bytes_per_token"] == \
        serving.kv_bytes_per_token(tcfg, "int4")


# -- the load driver (tools/serve_bench_torch.py) ------------------------------

def test_workload_is_the_reference_drivers():
    """The open-loop trace is the reference driver's, draw for draw."""
    from tools import serve_bench, serve_bench_torch

    for kw in (dict(), dict(shared_prefix_len=16, prompt_range=(8, 20))):
        want = serve_bench.sample_workload(20, rate=10.0, seed=1, **kw)
        got = serve_bench_torch.sample_workload(20, rate=10.0, seed=1, **kw)
        assert [(w["arrival"], w["max_new"], w["tenant"]) for w in got] == \
            [(w["arrival"], w["max_new"], w["tenant"]) for w in want]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g["prompt"], w["prompt"])
    arrivals = np.asarray([w["arrival"] for w in want])
    assert (np.diff(arrivals) >= 0).all()
    assert 0.03 < np.diff(arrivals).mean() < 0.3


def test_load_driver_end_to_end(lm):
    from tools import serve_bench_torch as sb

    _, _, tcfg, model = lm
    engine = _engine(tcfg, model, block_size=16, max_batch=4,
                     max_prompt_len=16)
    sb.warm_engine(engine)
    assert engine.stats["tokens_generated"] == 0
    load = sb.run_load(engine, sb.sample_workload(
        12, rate=50.0, vocab=tcfg.vocab_size))
    assert load["completed"] == 12 and load["rejected"] == 0
    assert 0 < load["serve_p50_ms"] <= load["serve_max_ms"]
    assert load["serve_p99_ms"] is None     # 12 samples hold no p99
    assert load["kv_dtype"] == "fp32"
    assert sb.bench_decode_tokens_per_sec(tcfg, model, 2, steps=4,
                                          device="cpu") > 0
    assert len(sb.decode_rates(tcfg, model, 2, steps=2, windows=3,
                               device="cpu")) == 3
    rates = sb.prefill_rates(tcfg, model, 2, 6, windows=2, device="cpu")
    assert len(rates) == 2 and min(rates) > 0
    prof = sb.profile_decode(tcfg, model, 2, steps=2, prompt_len=4,
                             device="cpu")
    assert prof["wall_ms_per_step"] > 0 and prof["device_ms_per_step"] is None
    with pytest.raises(ValueError, match="max_seq_len"):
        sb.bench_decode_tokens_per_sec(tcfg, model, 1, steps=100,
                                       prompt_len=8, device="cpu")
    with pytest.raises(ValueError, match="--arrival-rate"):
        sb.positive_rate("nan")

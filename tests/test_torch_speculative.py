"""Speculative decoding in the port's serving engine
(``horovod_tpu_torch.serving.Engine(speculate=k)``) on the CPU, against the
JAX package and against the port's own plain engine.

Each test mirrors one of ``tests/test_serving.py``'s
``TestSpeculativeEngine`` and ``TestSpecAutoOff`` tests, on the same small
LM (vocab 128, 2 layers, H=4, Hkv=2, E=64, mlp 128, max_seq_len 64, fp32)
with one numpy-seeded flax parameter tree feeding both frameworks. Every
comparison is exact, token for token: greedy speculation against JAX's
``transformer.generate`` (module-scoped, so each JAX shape compiles once);
quantized pools, sampling and the degraded mode against the port's plain
engine (sampled tokens differ from JAX's ``jax.random`` stream by design,
ROADMAP §C). On the CPU the forwards run eagerly; the trace counters count
signatures, and a speculating engine has one each of prefill, verify,
draft prefill and draft propose, and none of decode. The captured graphs
run on the card only (``chip_smoke.py`` phase 13).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from horovod_tpu.analysis import protocol as jproto
from horovod_tpu.models import transformer as jt
from horovod_tpu_torch import serving
from horovod_tpu_torch.analysis import protocol as tproto
from horovod_tpu_torch.models import transformer as tt

from torch_lm_support import (configs, distilled_draft_pair, numpy_params,
                              port_model, tokens)


@pytest.fixture(scope="module")
def lm():
    jcfg, tcfg = configs()
    params = numpy_params(jcfg)
    return jcfg, params, tcfg, port_model(tcfg, params)


def _prompt(n, seed=0):
    return tokens(1, n, seed=seed)[0]


def _jax_generate(lm, prompt, new: int) -> np.ndarray:
    jcfg, params, _, _ = lm
    return np.asarray(jt.generate(jcfg, params, jnp.asarray(prompt[None]),
                                  max_new_tokens=new))[0]


@pytest.fixture(scope="module")
def want_b1(lm):
    """JAX ``generate`` of the 5-token prompt of seed 9, 12 new tokens."""
    return _jax_generate(lm, _prompt(5, seed=9), 12)


def _engine(tcfg, model, **kw):
    kw.setdefault("block_size", 8)
    kw.setdefault("max_batch", 1)
    kw.setdefault("max_prompt_len", 16)
    return serving.Engine(tcfg, model, device="cpu", **kw)


def test_b1_greedy_bit_identical_to_generate(lm, want_b1):
    _, _, tcfg, model = lm
    eng = _engine(tcfg, model, speculate=3, draft_kv_dtype="model")
    got = eng.generate_batch([_prompt(5, seed=9)], 12)[0]
    np.testing.assert_array_equal(got, want_b1)
    # Self-drafting at the model's own pool format agrees with the target:
    # every proposal accepted, nothing rolled back.
    assert eng.spec_accept_rate == 1.0
    assert eng.stats["spec_rollback_tokens"] == 0


def test_unchanged_under_continuous_batching(lm):
    """Staggered arrivals, mixed tenants: every stream equals its solo JAX
    ``generate``."""
    _, _, tcfg, model = lm
    prompts = [_prompt(5, seed=s) for s in (9, 1, 2, 3)]
    wants = [_jax_generate(lm, p, 10) for p in prompts]
    eng = _engine(tcfg, model, max_batch=2, speculate=3,
                  draft_kv_dtype="model")
    reqs = [eng.submit(prompts[0], 10)]
    eng.step()  # the first request speculates alone
    reqs += [eng.submit(p, 10, tenant=f"t{i}")
             for i, p in enumerate(prompts[1:])]
    eng.run_until_idle()
    for req, want in zip(reqs, wants):
        np.testing.assert_array_equal(req.full_sequence(), want)


def test_two_target_two_draft_programs(lm):
    """Across admission churn, finishes and a second wave, one prefill,
    verify, draft prefill and draft propose each, and no decode."""
    _, _, tcfg, model = lm
    eng = _engine(tcfg, model, max_batch=4, speculate=2,
                  draft_kv_dtype="model")
    eng.submit(_prompt(5, seed=1), 8)
    eng.step()
    eng.submit(_prompt(3, seed=2), 3, tenant="b")
    eng.submit(_prompt(7, seed=3), 11)
    eng.run_until_idle()
    eng.submit(_prompt(2, seed=4), 4)  # a second wave, empty engine
    eng.run_until_idle()
    assert eng.prefill_trace_count == 1
    assert eng.verify_trace_count == 1
    assert eng.draft_prefill_trace_count == 1
    assert eng.draft_trace_count == 1
    assert eng.decode_trace_count == 0  # verify is the decode path
    eng.pool.check_invariants()


def test_int4_draft_cache_still_bit_identical(lm, want_b1):
    """The default draft pool (int4) can lower the accept rate, never
    change the output: every emitted token is the target's own choice."""
    _, _, tcfg, model = lm
    eng = _engine(tcfg, model, speculate=3)
    assert eng.draft_kv_dtype == "int4"  # the unset default
    got = eng.generate_batch([_prompt(5, seed=9)], 12)[0]
    np.testing.assert_array_equal(got, want_b1)
    assert 0.0 <= eng.spec_accept_rate <= 1.0


def test_preemption_recompute_bit_identical(lm):
    """Mid-decode preemption under a scarce pool with speculation on: the
    victim's recomputed continuation is its undisturbed stream."""
    _, _, tcfg, model = lm
    prompts = [_prompt(5, seed=s) for s in (9, 3)]
    wants = [_jax_generate(lm, p, 12) for p in prompts]
    eng = _engine(tcfg, model, block_size=4, max_batch=2, num_blocks=7,
                  max_prompt_len=32, speculate=2, draft_kv_dtype="model")
    reqs = [eng.submit(p, 12) for p in prompts]
    eng.run_until_idle()
    assert eng.stats["preemptions"] >= 1  # the pool forced it
    for req, want in zip(reqs, wants):
        np.testing.assert_array_equal(req.full_sequence(), want)
    eng.pool.check_invariants()


def test_horizon_clamps_at_max_seq_len(lm):
    """A request running to the model's sequence capacity: the per-row
    horizon shrinks the window so no write lands past max_seq_len, and the
    stream still equals generate."""
    _, _, tcfg, model = lm
    prompt = _prompt(5, seed=9)
    max_new = tcfg.max_seq_len - 5  # exactly to capacity
    want = _jax_generate(lm, prompt, max_new)
    eng = _engine(tcfg, model, speculate=5, draft_kv_dtype="model")
    got = eng.generate_batch([prompt], max_new)[0]
    np.testing.assert_array_equal(got, want)
    eng.pool.check_invariants()
    assert eng.pool.num_used == 0


def test_prefix_sharing_cow_fork_with_speculation(lm):
    """Copy-on-write prefix forks and speculative rollback together: two
    requests fork off a cached prefix and speculate (an int4 draft, so
    rollbacks happen); no rollback touches the shared pages."""
    _, _, tcfg, model = lm
    eng = _engine(tcfg, model, block_size=4, max_batch=3, max_prompt_len=24,
                  prefix_cache=True, speculate=3)
    pre = _prompt(12, seed=7)
    prompts = [np.concatenate([pre, _prompt(2, seed=50 + s)])
               for s in range(3)]
    reqs = [eng.submit(prompts[0], 5)]
    eng.run_until_idle()  # cold: prefills and caches the prefix
    reqs += [eng.submit(p, 5) for p in prompts[1:]]  # the fork
    eng.run_until_idle()
    for req, p in zip(reqs, prompts):
        np.testing.assert_array_equal(req.full_sequence(),
                                      _jax_generate(lm, p, 5))
    assert eng.stats["prefix_hit_tokens"] == 24
    eng.pool.check_invariants()


@pytest.mark.parametrize("kvd", ["bf16", "int8_block", "int4"])
def test_kv_dtype_sweep_spec_matches_plain_engine(lm, kvd):
    """Every target pool format: speculation emits the plain engine's
    stream at that format."""
    _, _, tcfg, model = lm
    prompts = [_prompt(5, seed=s) for s in (9, 3)]
    wants = _engine(tcfg, model, max_batch=2,
                    kv_dtype=kvd).generate_batch(prompts, 10)
    spec = _engine(tcfg, model, max_batch=2, kv_dtype=kvd, speculate=3,
                   draft_kv_dtype=kvd)
    for got, want in zip(spec.generate_batch(prompts, 10), wants):
        np.testing.assert_array_equal(got, want)


def test_sampling_deterministic_under_speculation(lm):
    """temperature > 0: the (seed, request, position) keys are positional,
    so a speculative engine reproduces the port's plain engine's sampled
    stream token for token."""
    _, _, tcfg, model = lm
    prompt = _prompt(5, seed=4)
    a = _engine(tcfg, model, temperature=1.0, seed=7)
    ra = a.submit(prompt, 6, sample_seed=11)
    a.run_until_idle()
    b = _engine(tcfg, model, temperature=1.0, seed=7, speculate=3,
                draft_kv_dtype="model")
    rb = b.submit(prompt, 6, sample_seed=11)
    b.run_until_idle()
    assert ra.output == rb.output
    assert b.spec_accept_rate == 1.0  # the draft keys its proposals alike


def test_cache_stats_and_accept_rate_surface(lm):
    _, _, tcfg, model = lm
    eng = _engine(tcfg, model, speculate=2, draft_kv_dtype="model")
    assert eng.spec_accept_rate is None  # nothing proposed yet
    stats = eng.cache_stats()
    assert stats["speculate_k"] == 2
    assert stats["draft_kv_dtype"] == "fp32"  # the model's dtype
    assert stats["spec_disabled"] is False
    eng.generate_batch([_prompt(5, seed=1)], 6)
    assert eng.cache_stats()["spec_accept_rate"] == 1.0
    assert eng.stats["verify_calls"] == eng.stats["draft_calls"] > 0
    assert eng.stats["spec_proposed"] == 2 * eng.stats["verify_calls"]


@pytest.mark.parametrize("window,floor", [
    ([0.05] * 8, 0.5), ([0.05] * 8, 0.0), ([0.05] * 7, 0.5),
    ([0.9] * 8, 0.5), ([0.5] * 8, 0.5), ([0.2, 0.9] * 8, 0.6),
    ([0.0] * 32, 1.0), ([], 0.5)])
def test_accept_rate_collapse_judgement_matches_jax(window, floor):
    assert (tproto.accept_rate_collapsed(window, floor)
            == jproto.accept_rate_collapsed(window, floor))
    assert (tproto.accept_rate_collapsed(window, floor, min_samples=2)
            == jproto.accept_rate_collapsed(window, floor, min_samples=2))


@pytest.mark.parametrize("kvd", [None, "int8_block"])
def test_collapsed_draft_auto_disables_bit_identical(lm, kvd):
    """A draft the target never agrees with, under min_accept: speculation
    latches off (DEGRADE) without changing one token, on the same
    programs."""
    _, _, tcfg, model = lm
    garbage = port_model(tcfg, numpy_params(tcfg, seed=7))
    prompts = [_prompt(5, seed=11), _prompt(6, seed=12)]
    wants = _engine(tcfg, model, max_batch=2,
                    kv_dtype=kvd).generate_batch(prompts, 24)
    eng = _engine(tcfg, model, max_batch=2, kv_dtype=kvd, speculate=2,
                  draft_config=tcfg, draft_params=garbage,
                  draft_kv_dtype="model", min_accept=0.5)
    outs = eng.generate_batch(prompts, 24)
    assert eng.cache_stats()["spec_disabled"] is True
    for got, want in zip(outs, wants):
        np.testing.assert_array_equal(got, want)
    # Degraded steps skip the draft...
    assert eng.stats["draft_calls"] < eng.stats["verify_calls"]
    # ...on the same programs.
    assert eng.verify_trace_count == 1
    assert eng.draft_trace_count == 1
    assert eng.decode_trace_count == 0


@pytest.mark.parametrize("kw", [{}, {"num_layers": 2},
                                {"num_layers": 1, "mlp_dim": 32}])
def test_draft_config_matches_jax(kw):
    jcfg, tcfg = configs()
    want, got = jt.draft_config(jcfg, **kw), tt.draft_config(tcfg, **kw)
    for field in ("vocab_size", "num_layers", "num_heads", "num_kv_heads",
                  "embed_dim", "mlp_dim", "max_seq_len", "window",
                  "attention", "decode", "kv_dtype"):
        assert getattr(got, field) == getattr(want, field), field
    with pytest.raises(ValueError, match="draft num_layers must be >= 1"):
        tt.draft_config(tcfg, num_layers=0)
    with pytest.raises(ValueError, match="draft num_layers must be >= 1"):
        jt.draft_config(jcfg, num_layers=0)


def test_distilled_pair_draft_equals_target_on_both_sides():
    """The perfectly distilled pair: on each side the 1-layer draft's logits
    equal the target's, and the port's equal JAX's."""
    (jcfg, jparams, jd, jdparams), (tcfg, target, td, draft) = \
        distilled_draft_pair(num_layers=3)
    toks = tokens(2, 9, seed=5)
    want = np.asarray(jt.Transformer(jcfg).apply({"params": jparams},
                                                 jnp.asarray(toks)))
    jdraft = np.asarray(jt.Transformer(jd).apply({"params": jdparams},
                                                 jnp.asarray(toks)))
    np.testing.assert_array_equal(jdraft, want)
    with torch.no_grad():
        got = target(torch.from_numpy(toks).long()).numpy()
        tdraft = draft(torch.from_numpy(toks).long()).numpy()
    np.testing.assert_array_equal(tdraft, got)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    # And the pair serves: an int4 draft pool, the plain engine's stream.
    prompt = _prompt(5, seed=9)
    plain = _engine(tcfg, target).generate_batch([prompt], 10)[0]
    eng = _engine(tcfg, target, speculate=3, draft_config=td,
                  draft_params=draft)
    np.testing.assert_array_equal(eng.generate_batch([prompt], 10)[0], plain)

"""The port's serving resilience (``horovod_tpu_torch/serving/resilience.py``,
``core/resilience.py`` and the engine's deadline, fault and recovery paths)
against the JAX package's, on the CPU.

* The watchdog convicts as the reference does (phase, step, age; the same
  message), and not when disabled, cleared or fresh.
* The journal is the reference's format: the same records give the same
  bytes, a journal written by the port loads in the JAX package and one
  written by the JAX package loads in the port, with the same records, committed runs and replay plan; torn tails,
  mid-file corruption, stale schemas and bad prompt CRCs are refused with
  the reference's messages.
* ``recover()`` after a simulated crash (the engine abandoned mid-batch)
  gives tokens bit-identical to the uninterrupted run, and the fault specs
  ``deadline_storm``, ``stuck_decode`` and ``engine_crash`` fire through
  ``Engine.step`` as they do in the reference; evicting an expired request
  leaves the survivors' tokens bit-identical.

The LM is the small config of ``tests/test_serving.py`` in fp32 with
numpy-seeded weights; comparisons of tokens are exact.
"""

import json
import time

import numpy as np
import pytest

from horovod_tpu.analysis import protocol as jproto
from horovod_tpu.core import resilience as jcore_res
from horovod_tpu.serving import resilience as jres
from horovod_tpu_torch import serving
from horovod_tpu_torch.analysis import protocol as tproto
from horovod_tpu_torch.core import resilience as tcore_res
from horovod_tpu_torch.core.state import HorovodError
from horovod_tpu_torch.models import transformer as tt
from horovod_tpu_torch.serving import resilience as tres

from torch_lm_support import configs, numpy_params, port_model, tokens


@pytest.fixture(scope="module")
def lm():
    _, tcfg = configs()
    return tcfg, port_model(tcfg, numpy_params(tcfg))


@pytest.fixture
def fault_env(monkeypatch):
    """Arm ``HOROVOD_FAULT_INJECT`` for one test; the cached injector is
    rebuilt both ways."""
    def arm(spec):
        monkeypatch.setenv("HOROVOD_FAULT_INJECT", spec)
        tcore_res.reset_injector()
    yield arm
    monkeypatch.delenv("HOROVOD_FAULT_INJECT", raising=False)
    tcore_res.reset_injector()


def _prompt(n, seed=0):
    return tokens(1, n, seed=seed)[0]


def _engine(tcfg, model, **kw):
    return serving.Engine(tcfg, model, block_size=8, max_batch=2,
                          max_prompt_len=16, device="cpu", **kw)


def _fingerprint(**kw):
    return dict(dict(block_size=8, kv_dtype="fp32", temperature=0.0, seed=0,
                     speculate_k=0), **kw)


# -- the watchdog ------------------------------------------------------------

@pytest.mark.parametrize("timeout,backdate,override,clear,convicted", [
    (5.0, 9.0, None, False, True),
    (0.0, 3600.0, None, False, False),     # disabled: never judges
    (1.0, 50.0, None, True, False),        # the dispatch returned
    (60.0, 0.0, None, False, False),       # fresh
    (0.0, 2.0, 1.0, False, True),          # the fault hook's override
])
def test_watchdog_convicts_as_the_reference(timeout, backdate, override,
                                            clear, convicted):
    results = []
    for mod in (jres, tres):
        wd = mod.Watchdog(timeout)
        wd.stamp("DECODE", 3)
        wd.backdate(backdate)
        if clear:
            wd.clear()
        try:
            wd.check(override)
            results.append(None)
        except Exception as e:  # each package's own EngineStalled
            assert type(e).__name__ == "EngineStalled"
            results.append((e.phase, e.step, round(e.age),
                            str(e).split(" has not completed")[0]))
    assert results[0] == results[1]
    assert (results[1] is not None) == convicted
    tres.Watchdog(1.0).check()   # no open stamp: nothing to judge


def test_pure_judgements_match_the_reference():
    window = [1, 0] * 4
    assert tres.pool_pressure_high(window) == jres.pool_pressure_high(window)
    for w in ([1] * 7, [1] * 8, [1, 0, 0, 0] * 2, [0] * 16):
        assert tres.pool_pressure_high(w) == jres.pool_pressure_high(w)
    for args in ((100, None, 0.5), (100, 0.0, 0.5), (100, 1.0, 0.0),
                 (100, 200.0, 0.5), (101, 200.0, 0.5)):
        assert (tproto.admission_feasible(*args)
                == jproto.admission_feasible(*args))
    for args in ((5.0, None), (5.0, 5.0), (4.9, 5.0)):
        assert tproto.deadline_expired(*args) == jproto.deadline_expired(*args)
    spec = ("engine_crash@step=2;stuck_decode@step=1,ms=500;"
            "deadline_storm@step=0;crash@rank=1,step=5")
    assert ([(f.kind, f.attrs) for f in tcore_res.parse_fault_spec(spec)]
            == [(f.kind, f.attrs) for f in jcore_res.parse_fault_spec(spec)])
    for bad in ("engine_crush@step=2", "stuck_decode@ms=5",
                "deadline_storm@step=x", "engine_crash@when=1"):
        with pytest.raises(ValueError) as je:
            jcore_res.parse_fault_spec(bad)
        with pytest.raises(ValueError) as te:
            tcore_res.parse_fault_spec(bad)
        assert str(te.value) == str(je.value)
    assert tcore_res.CRASH_EXIT_CODE == jcore_res.CRASH_EXIT_CODE


# -- the journal: one format for both packages -------------------------------

def _write_journal(mod, path):
    jr = mod.RequestJournal(path, _fingerprint())
    jr.record_admit(0, [5, 9, 2], tenant="a", seed=0, max_new=6,
                    deadline_ms=None, budget_ms=250.0, t=1.0)
    jr.record_admit(1, [3], tenant="b", seed=7, max_new=2,
                    deadline_ms=None, budget_ms=None, t=1.5)
    jr.flush(t=1.5)
    jr.record_emit(0, 0, 11)
    jr.record_emit(0, 1, 12)
    jr.record_emit(1, 0, 4)
    jr.flush(t=2.0)
    jr.record_emit(1, 1, 8)
    jr.record_finish(1, 2, t=3.0)
    jr.close()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_journal_round_trip_across_packages(tmp_path, writer):
    path = str(tmp_path / f"{writer}.journal.json")
    _write_journal(jres if writer == "jax" else tres, path)
    loaded = [mod.load_journal(path) for mod in (jres, tres)]
    assert loaded[0] == loaded[1]
    header, records, committed, torn = loaded[1]
    assert torn == 0 and header["engine"] == _fingerprint()
    assert committed == {0: (11, 12), 1: (4, 8)}
    assert (tres.replay_plan(records, committed)
            == jres.replay_plan(records, committed))
    other = str(tmp_path / "other.journal.json")
    _write_journal(jres if writer == "port" else tres, other)
    assert open(other, "rb").read() == open(path, "rb").read()


def test_journal_refusals_match_the_reference(tmp_path):
    def torn(path):
        _write_journal(tres, path)
        with open(path, "ab") as f:
            f.write(b'{"crc": 123, "rec": {"kind": "emit", "rid"')

    def rot(path):
        _write_journal(tres, path)
        lines = open(path, "rb").read().splitlines(keepends=True)
        lines[1] = b'{"crc": 1, "rec": {"kind": "admit"}}\n'
        open(path, "wb").write(b"".join(lines))

    def stale(path):
        open(path, "wb").write(tres._line({
            "kind": "header", "schema": "horovod_tpu/serve-journal/v0",
            "engine": _fingerprint()}))

    def skew(path):
        with open(path, "wb") as f:
            f.write(tres._line({"kind": "header",
                                "schema": tres.JOURNAL_SCHEMA,
                                "engine": _fingerprint()}))
            f.write(tres._line({"kind": "admit", "rid": 0, "tenant": "a",
                                "seed": 0, "max_new": 4, "prompt": [3, 4],
                                "prompt_crc": tres.prompt_crc([3, 4]),
                                "deadline_ms": None, "budget_ms": None,
                                "t": 1.0}))
            f.write(tres._line({"kind": "emit", "rid": 0, "start": 2,
                                "tokens": [9], "t": 2.0}))

    for make in (torn, rot, stale, skew):
        path = str(tmp_path / f"{make.__name__}.journal.json")
        make(path)
        outcome = []
        for mod in (jres, tres):
            try:
                h, r, c, t = mod.load_journal(path)
                outcome.append(("ok", c, t))
            except Exception as e:
                outcome.append((type(e).__name__, str(e)))
        assert outcome[0] == outcome[1], make.__name__
    records = [{"kind": "admit", "rid": 0, "prompt": [3, 4],
                "prompt_crc": 1, "max_new": 4}]
    with pytest.raises(HorovodError, match="CRC32"):
        tres.replay_plan(records, {0: ()})
    with pytest.raises(ValueError, match="journal.json"):
        tres.RequestJournal(str(tmp_path / "x.json"), _fingerprint())


# -- the engine: recovery, deadlines, faults ---------------------------------

def test_crash_recovery_bit_identical(lm, tmp_path):
    tcfg, model = lm
    jpath = str(tmp_path / "crash.journal.json")
    prompts = [_prompt(6, seed=4), _prompt(5, seed=5)]
    want = [tt.generate(tcfg, model, p[None], 8, device="cpu")[0].numpy()
            for p in prompts]
    eng1 = _engine(tcfg, model, journal=jpath)
    for p in prompts:
        eng1.submit(p, 8)
    for _ in range(3):
        eng1.step()
    del eng1  # the crash: no close, no final flush

    eng2 = _engine(tcfg, model, journal=jpath)
    resumed = eng2.recover()
    assert len(resumed) == 2 and eng2.stats["recovered"] == 2
    assert all(len(r.output) >= 1 for r in resumed)
    eng2.run_until_idle()
    for req, w in zip(resumed, want):
        np.testing.assert_array_equal(req.full_sequence(), w)
    eng2.pool.check_invariants()
    _, records, committed, torn = jres.load_journal(jpath)   # JAX reads it
    assert torn == 0
    assert [r["kind"] for r in records].count("recover") == 2
    for rid, p in enumerate(prompts):
        np.testing.assert_array_equal(
            np.concatenate([p, np.asarray(committed[rid])]), want[rid])
    other = str(tmp_path / "other.journal.json")
    tres.RequestJournal(other, _fingerprint(block_size=16)).close()
    with pytest.raises(HorovodError, match="fingerprint mismatch"):
        eng2.recover(journal=other)
    with pytest.raises(HorovodError, match="needs a journal"):
        _engine(tcfg, model).recover()


def test_journaled_run_commits_its_tokens(lm, tmp_path):
    tcfg, model = lm
    jpath = str(tmp_path / "run.journal.json")
    eng = _engine(tcfg, model, journal=jpath)
    prompts = [_prompt(6, seed=1), _prompt(5, seed=2)]
    outs = eng.generate_batch(prompts, 6)
    header, records, committed, torn = tres.load_journal(jpath)
    assert header["engine"] == eng.fingerprint() == _fingerprint()
    kinds = [r["kind"] for r in records]
    assert kinds.count("admit") == 2 and kinds.count("finish") == 2
    for rid, p in enumerate(prompts):
        assert committed[rid] == tuple(outs[rid][len(p):])
    assert tres.replay_plan(records, committed) == []


def test_expired_request_evicted_survivor_bit_identical(lm):
    tcfg, model = lm
    prompt = _prompt(6, seed=9)
    want = tt.generate(tcfg, model, prompt[None], 8, device="cpu")[0]
    eng = _engine(tcfg, model)
    doomed = eng.submit(_prompt(6, seed=3), 8, deadline_ms=250.0)
    live = eng.submit(prompt, 8)
    eng.step()
    time.sleep(0.3)
    done = eng.run_until_idle()
    assert doomed in done and doomed.deadline_missed
    assert len(doomed.output) < 8 and not live.deadline_missed
    np.testing.assert_array_equal(live.full_sequence(), want.numpy())
    assert eng.stats["deadline_missed"] == 1 and eng.pool.num_used == 0
    # Budgets: the engine default, an opt-out, an explicit one; a queued
    # request already past its deadline is refused before prefill.
    eng = _engine(tcfg, model, deadline_ms=5000)
    assert eng.submit(_prompt(4, 1), 4).budget_ms == 5000.0
    assert eng.submit(_prompt(4, 2), 4, deadline_ms=0).deadline_ms is None
    late = _engine(tcfg, model)
    doomed = late.submit(_prompt(4, 5), 4, deadline_ms=0.001)
    late.submit(_prompt(4, 6), 4)
    assert doomed in late.run_until_idle() and doomed.output == []


def test_deadline_storm_evicts_and_survivors_stay_bit_identical(lm,
                                                                fault_env):
    """The storm force-expires every deadline-carrying request at step 1;
    the request without a deadline runs on and equals its solo run."""
    tcfg, model = lm
    survivor_prompt = _prompt(5, seed=8)
    want = _engine(tcfg, model).generate_batch([survivor_prompt], 6)[0]
    eng = serving.Engine(tcfg, model, block_size=8, max_batch=3,
                         max_prompt_len=16, device="cpu")
    reqs = [eng.submit(_prompt(4, seed=s), 6, deadline_ms=60_000)
            for s in (1, 2)]
    survivor = eng.submit(survivor_prompt, 6)
    eng.step()
    fault_env("deadline_storm@step=1")
    done = eng.step()
    assert sorted(r.request_id for r in done) == [0, 1]
    assert all(r.deadline_missed for r in reqs)
    assert eng.stats["deadline_missed"] == 2
    eng.run_until_idle()
    assert not survivor.deadline_missed
    mine = serving.Engine(tcfg, model, block_size=8, max_batch=3,
                          max_prompt_len=16, device="cpu")
    np.testing.assert_array_equal(survivor.full_sequence(),
                                  mine.generate_batch([survivor_prompt],
                                                      6)[0])
    np.testing.assert_array_equal(want, survivor.full_sequence())
    eng.pool.check_invariants()


def test_stuck_decode_raises_engine_stalled(lm, fault_env):
    tcfg, model = lm
    fault_env("stuck_decode@step=1,ms=9000")
    eng = serving.Engine(tcfg, model, block_size=8, max_batch=1,
                         max_prompt_len=16, watchdog_timeout=2.0,
                         device="cpu")
    eng.submit(_prompt(4, seed=1), 6)
    eng.step()
    with pytest.raises(serving.EngineStalled) as ei:
        eng.step()
    assert ei.value.phase == "DECODE" and ei.value.step == 1
    assert ei.value.age >= 8.9


def test_engine_crash_exits_hard(lm, fault_env, monkeypatch, capsys):
    import horovod_tpu_torch.serving.engine as eng_mod

    codes = []

    def fake_exit(code):
        codes.append(code)
        raise SystemExit(code)

    monkeypatch.setattr(eng_mod.os, "_exit", fake_exit)
    fault_env("engine_crash@step=1")
    tcfg, model = lm
    eng = serving.Engine(tcfg, model, block_size=8, max_batch=1,
                         max_prompt_len=16, device="cpu")
    eng.submit(_prompt(4, seed=2), 6)
    eng.step()
    with pytest.raises(SystemExit):
        eng.step()
    assert codes == [tcore_res.CRASH_EXIT_CODE]
    assert "simulating engine crash at serving step 1" in \
        capsys.readouterr().out


def test_shed_latch_refuses_then_recovers(lm):
    from horovod_tpu_torch.core import timeline

    tcfg, model = lm
    eng = _engine(tcfg, model)
    tl = timeline.session()
    for _ in range(8):
        eng._update_shed_latch(1, tl)
    assert eng._shedding and eng.cache_stats()["shedding"] is True
    with pytest.raises(serving.AdmissionError, match="shedding"):
        eng.submit(_prompt(4, seed=1), 4)
    assert eng.stats["shed_rejected"] == 1
    for _ in range(16):
        eng._update_shed_latch(0, tl)
    assert not eng._shedding
    assert eng.submit(_prompt(4, seed=1), 4).request_id == 0


def test_journal_lines_carry_their_crc(tmp_path):
    import zlib

    path = str(tmp_path / "crc.journal.json")
    _write_journal(tres, path)
    for line in open(path, "rb").read().splitlines():
        entry = json.loads(line)
        body = json.dumps(entry["rec"], sort_keys=True,
                          separators=(",", ":")).encode()
        assert zlib.crc32(body) & 0xFFFFFFFF == entry["crc"]

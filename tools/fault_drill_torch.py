"""Fault drill of the PyTorch port: every ``HOROVOD_FAULT_INJECT`` path of
training, end to end, on the CPU or on the GPU.

Scenarios (``--scenario all`` runs each in turn):

* ``kv_timeout`` — an injected transient store fault is retried with
  decorrelated-jitter backoff and succeeds; an injection that outlasts
  ``HOROVOD_KV_RETRIES`` surfaces as a ``HorovodError`` naming the key.
* ``liveness`` — a peer whose heartbeat went stale turns a blocking wait
  into ``WorkerLost`` naming the dead process and its last-seen age,
  instead of waiting out the 60-s bound.
* ``torn_write`` — a checkpoint whose payload is torn mid-write fails its
  CRC32 manifest; the resume scan skips it with a warning and lands on the
  previous complete epoch with identical parameters.
* ``crash`` — a training process is hard-killed mid-run
  (``crash@rank=0,step=9``, exit 43), then restarted with
  ``Trainer.fit(resume=...)``: it resumes at the last complete epoch with
  bit-identical restored parameters and trains to the end.
* ``elastic`` — under ``HOROVOD_ELASTIC=1`` rank 2 of a 4-rank world is
  lost (``crash@rank=2,step=5``): the survivors shrink and continue, a new
  process takes rank 2's place at a later step boundary
  (``regrow@step=9``), and training ends at world 4. The run is made twice
  and the final parameters must be CRC-identical; the pre- and post-shrink
  and post-regrow exchange plans pass the verifier
  (``analysis/schedule.py::verify_exchange_artifact``). It needs four
  ranks: four GPUs with ``--device cuda`` (NCCL), else it is skipped there.
* ``serve`` — a journaled serving engine is hard-killed mid-batch
  (``engine_crash@step=4``, exit 43) in a child process; a new child
  replays the journal (``Engine.recover``) and finishes the batch, and
  every request's output CRC equals an uninterrupted child's, with the
  pool's invariants clean. Three children: the tiny LM of
  ``tools/serve_bench_torch.py --smoke`` on the CPU, the full-width
  serving LM (``serve_bench_torch.lm_config``) at ``SERVE_LAYERS``
  layers on the GPU.

``--lint`` runs two preflights before any scenario, as the reference's
drill does: ``preflight_lint`` records the drill's own training step (the
Trainer's step over the 4x2 linear map) on every rank of a world — two
gloo ranks on the CPU, one rank a card (up to four) on the GPU — and
verifies the members' wire listings together
(``analysis/schedule.py::verify_step``: replica groups, per-rank identity,
wait graph); ``preflight_model`` sweeps the drill's fault specs through
the protocol checker at two processes (``analysis/model.py``, HVD201-
HVD206). A finding stops the drill before any fault is injected, so a
scenario failure is never a protocol bug in disguise.

Usage::

    python tools/fault_drill_torch.py [--device cpu|cuda] [--lint]
        [--scenario all|NAME[,NAME...]]

where NAME is kv_timeout, liveness, torn_write, crash, elastic or serve.

``--device cuda`` (the default) runs every training step on the GPU and
raises where CUDA is absent. Exit 0 and a last ``FAULT DRILL PASSED`` line
on success.
"""

from __future__ import annotations

import argparse
import faulthandler
import json
import os
import subprocess
import sys
import tempfile
import time
import warnings
import zlib

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

EPOCHS = 4
STEPS_PER_EPOCH = 4
CRASH_STEP = 9  # epoch 2, batch 1: epochs 0 and 1 are checkpointed by then
ELASTIC_CRASH_STEP = 5  # epoch 1, batch 1
ELASTIC_REGROW_STEP = 9  # epoch 2, batch 1
ELASTIC_RANKS = 4
TAGS = ("pre_shrink", "post_shrink", "post_regrow")
HANG_DUMP_S = 150
SERVE_CRASH_STEP = 4  # mid-batch: admissions journaled, decode under way
SERVE_REQUESTS = 4
SERVE_PROMPT_LEN = 6
SERVE_MAX_NEW = 10
SERVE_LAYERS = 2  # the GPU's serving LM: full width, this depth by default


def _set_env(**kv):
    for k, v in kv.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


def _init(device: str) -> None:
    import horovod_tpu_torch as hvd

    hvd.init(device="cpu" if device == "cpu" else None)


def _crc(t) -> int:
    return zlib.crc32(t.detach().cpu().contiguous().numpy().tobytes()) \
        & 0xFFFFFFFF


def scenario_kv_timeout(device: str) -> None:
    import torch.distributed as dist

    from horovod_tpu_torch.core import resilience as res
    from horovod_tpu_torch.core.state import HorovodError

    _set_env(HOROVOD_KV_RETRIES="3", HOROVOD_KV_BACKOFF_MS="5",
             HOROVOD_FAULT_INJECT="kv_timeout@seq=1,times=2")
    try:
        res._reset_for_tests()
        store = dist.HashStore()
        store.set("hvd/resp/g1/s0", "verdict")
        assert res.kv_get(store, "hvd/resp/g1/s0", 100) == "verdict"  # seq 0
        got = res.kv_get(store, "hvd/resp/g1/s0", 100)  # 1, 2 fault; 3 ok
        assert got == "verdict" and res.retry_count() == 2, res.retry_count()
        print(f"  kv_timeout: transient fault retried with backoff "
              f"({res.retry_count()} retries) then succeeded")
        _set_env(HOROVOD_FAULT_INJECT="kv_timeout@seq=0,times=99")
        res._reset_for_tests()
        try:
            res.kv_get(store, "hvd/resp/g1/s7", 100)
            raise AssertionError("exhausted retries did not raise")
        except HorovodError as e:
            assert ("hvd/resp/g1/s7" in str(e)
                    and "HOROVOD_KV_RETRIES" in str(e)), str(e)
            print(f"  kv_timeout: retry budget exhausted -> surfaced with "
                  f"the failing key: {str(e)[:88]}...")
    finally:
        _set_env(HOROVOD_KV_RETRIES=None, HOROVOD_KV_BACKOFF_MS=None,
                 HOROVOD_FAULT_INJECT=None)
        res._reset_for_tests()


def scenario_liveness(device: str) -> None:
    import torch.distributed as dist

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.core import resilience as res
    from horovod_tpu_torch.core import state as _state

    _set_env(HOROVOD_LIVENESS_TIMEOUT="1")
    try:
        res._reset_for_tests()
        _init(device)
        store = dist.HashStore()
        # Peer process 1's heartbeat stopped 30 s ago (a dead rank).
        store.set(res._hb_key(_state.kv_generation(), 1),
                  json.dumps({"t": time.time() - 30.0}))
        t0 = time.monotonic()
        try:
            res.wait_kv(store, "hvd/resp/g0/s0", 60_000, pids=(1,),
                        context="waiting for the coordinator's verdict on "
                                "tensor drill_tensor")
            raise AssertionError("dead peer did not raise")
        except res.WorkerLost as e:
            took = time.monotonic() - t0
            assert "process 1" in str(e) and "last heartbeat" in str(e)
            assert took < 30, took  # far below the 60-s wait budget
            print(f"  liveness: dead peer named in {took:.1f}s (not the 60s "
                  f"timeout): {str(e)[:100]}...")
    finally:
        hvd.shutdown()
        _set_env(HOROVOD_LIVENESS_TIMEOUT=None)
        res._reset_for_tests()


def scenario_torn_write(device: str, workdir: str) -> None:
    import torch

    from horovod_tpu_torch.core import resilience as res
    from horovod_tpu_torch.training import checkpoint as ckpt

    dev = "cpu" if device == "cpu" else "cuda"
    d = os.path.join(workdir, "torn_ckpt")
    saved = {}
    try:
        for e in range(3):
            if e == 2:
                _set_env(HOROVOD_FAULT_INJECT="torn_write@epoch=2")
                res.reset_injector()
            w = torch.arange(8, dtype=torch.float32, device=dev) + e
            ckpt.save(d, {"w": w}, epoch=e)
            saved[e] = w.cpu().clone()
    finally:
        _set_env(HOROVOD_FAULT_INJECT=None)
        res.reset_injector()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        latest = ckpt.latest_epoch(d)
    assert latest == 1, latest
    assert any("torn write" in str(w.message) for w in caught), \
        [str(w.message) for w in caught]
    restored = ckpt.load(d, {"w": None, "epoch": -1})
    assert torch.equal(restored["w"], saved[1])
    print("  torn_write: epoch 2's torn payload skipped (CRC manifest "
          "mismatch); resume landed on epoch 1 with identical params")


# -- the training workers -----------------------------------------------------


def _linear_trainer(device: str):
    """The reference drill's model (a 4x2 linear map, seed 0) and this
    rank's batch, on the device."""
    import numpy as np
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.training import loop

    dev = hvd.device()
    rng = np.random.RandomState(0)
    w0 = rng.randn(4, 2).astype(np.float32)
    n = ELASTIC_RANKS
    xs = rng.randn(n, 8, 4).astype(np.float32)
    ys = rng.randn(n, 8, 2).astype(np.float32)
    r = hvd.global_rank() % n

    class Linear(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.tensor(w0, device=dev))

    def loss_fn(m, b):
        x, y = b
        return torch.mean((x @ m.w - y) ** 2)

    model = Linear()
    batch = (torch.tensor(xs[r], device=dev), torch.tensor(ys[r],
                                                          device=dev))
    return model, loop.Trainer(model, loss_fn, loop.sgd(0.05)), batch


def _crash_worker(ckdir: str, resume: bool, device: str) -> None:
    """One training process with a checkpoint an epoch: launched first with
    a crash injected, then restarted with ``fit(resume=...)``."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.training import callbacks

    _init(device)
    model, tr, batch = _linear_trainer(device)
    cb = callbacks.ModelCheckpointCallback(ckdir, every_epochs=1)
    t0 = time.perf_counter()
    if resume:
        tr.restore(ckdir)
        print(f"DRILL_RESUMED epoch={tr.epoch} crc={_crc(model.w)} "
              f"seconds={time.perf_counter() - t0:.3f}", flush=True)
    tr.fit([batch], epochs=EPOCHS, steps_per_epoch=STEPS_PER_EPOCH,
           callbacks=[cb], verbose=False)
    print(f"DRILL_DONE epoch={tr.epoch} crc={_crc(model.w)}", flush=True)
    hvd.shutdown()


def scenario_crash(device: str, workdir: str) -> None:
    import torch

    from horovod_tpu_torch.core import resilience as res

    ckdir = os.path.join(workdir, "crash_ckpt")
    cmd = [sys.executable, os.path.abspath(__file__), "--crash-worker",
           ckdir, "--device", device]
    env = dict(os.environ, HOROVOD_FAULT_INJECT=f"crash@rank=0,"
                                                f"step={CRASH_STEP}")
    r1 = subprocess.run(cmd, env=env, capture_output=True, text=True,
                        timeout=600)
    assert r1.returncode == res.CRASH_EXIT_CODE, (
        f"worker exited {r1.returncode}, wanted {res.CRASH_EXIT_CODE}\n"
        f"{r1.stdout[-2000:]}\n{r1.stderr[-2000:]}")
    assert "simulating hard crash" in r1.stdout, r1.stdout[-2000:]
    print(f"  crash: worker hard-killed mid-epoch-2 by injection "
          f"(exit {r1.returncode})")
    # The last complete checkpoint is epoch 1: its parameters are what the
    # restarted worker must restore, bit for bit.
    with open(os.path.join(ckdir, "checkpoint-00001.pt"), "rb") as f:
        state = torch.load(f, map_location="cpu", weights_only=True)
    want = _crc(state["model"]["w"])
    env.pop("HOROVOD_FAULT_INJECT")
    r2 = subprocess.run(cmd + ["--resume"], env=env, capture_output=True,
                        text=True, timeout=600)
    assert r2.returncode == 0, (
        f"resume worker exited {r2.returncode}\n{r2.stdout[-2000:]}\n"
        f"{r2.stderr[-2000:]}")
    lines = {ln.split()[0]: dict(kv.split("=") for kv in ln.split()[1:])
             for ln in r2.stdout.splitlines() if ln.startswith("DRILL_")}
    resumed, done = lines["DRILL_RESUMED"], lines["DRILL_DONE"]
    assert int(resumed["epoch"]) == 2, resumed
    assert int(resumed["crc"]) == want, (resumed, want)
    assert int(done["epoch"]) == EPOCHS, done
    print(f"  crash: restart resumed at epoch 2 from the last complete "
          f"checkpoint in {resumed['seconds']} s, restored params "
          f"bit-identical (crc {want}), trained to epoch {EPOCHS}")


def _elastic_fit(artdir: str, device: str):
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.core import elastic

    model, tr, batch = _linear_trainer(device)
    hist = tr.fit([batch], epochs=EPOCHS, steps_per_epoch=STEPS_PER_EPOCH,
                  verbose=False)
    ctl = tr._elastic
    if hvd.rank() == 0:
        os.makedirs(artdir, exist_ok=True)
        ctl.save_artifacts(artdir)
    return {"epoch": tr.epoch, "world": hvd.size(), "crc": _crc(model.w),
            "loss": hist["loss"][-1], "tags": [t for t, _ in ctl.snapshots],
            "metrics": elastic.last_metrics()}


def _elastic_member(artdir: str, device: str):
    # A rank still running after HANG_DUMP_S prints every thread's stack:
    # a transition that hangs says where.
    faulthandler.dump_traceback_later(HANG_DUMP_S)
    _init(device)
    return _elastic_fit(artdir, device)


def _elastic_joiner(artdir: str, device: str):
    from horovod_tpu_torch.core import elastic

    faulthandler.dump_traceback_later(HANG_DUMP_S)
    elastic.rejoin(device="cpu" if device == "cpu" else None)
    return _elastic_fit(artdir, device)


def scenario_elastic(device: str, workdir: str) -> None:
    import torch

    from horovod_tpu_torch.analysis import report, schedule
    from horovod_tpu_torch.run import run

    if device == "cuda" and torch.cuda.device_count() < ELASTIC_RANKS:
        print(f"  elastic: skipped — it needs {ELASTIC_RANKS} ranks, one a "
              f"GPU (NCCL), and {torch.cuda.device_count()} GPU(s) are "
              f"visible; the CPU drill (--device cpu) runs it over gloo")
        return
    fault = (f"crash@rank=2,step={ELASTIC_CRASH_STEP};"
             f"regrow@step={ELASTIC_REGROW_STEP}")
    done = []
    for attempt in (1, 2):
        artdir = os.path.join(workdir, f"elastic_art{attempt}")
        _set_env(HOROVOD_ELASTIC="1", HOROVOD_FAULT_INJECT=fault,
                 HOROVOD_ELASTIC_JOIN_TIMEOUT="90")
        try:
            out = run(_elastic_member, ELASTIC_RANKS, device=device,
                      args=(artdir, device), timeout=600, crashes=(2,),
                      rejoin={2: (_elastic_joiner, (artdir, device))})
        finally:
            _set_env(HOROVOD_ELASTIC=None, HOROVOD_FAULT_INJECT=None,
                     HOROVOD_ELASTIC_JOIN_TIMEOUT=None)
        for rec in out:
            assert rec["epoch"] == EPOCHS and rec["world"] == ELASTIC_RANKS
            assert rec["crc"] == out[0]["crc"], out
        assert out[0]["tags"] == list(TAGS), out[0]["tags"]
        for tag in TAGS:
            path = os.path.join(artdir, f"{tag}.exchange.json")
            with open(path) as f:
                findings = schedule.verify_exchange_artifact(f.read(), path)
            if findings:
                print(report.render(findings))
                raise AssertionError(
                    f"the verifier found {len(findings)} finding(s) in the "
                    f"{tag} exchange artifact")
        done.append(out[0])
    assert done[0]["crc"] == done[1]["crc"], done
    m = done[0]["metrics"]
    print(f"  elastic: rank 2 lost at step {ELASTIC_CRASH_STEP}, survivors "
          f"[0, 1, 3] continued (shrink recovery "
          f"{m['elastic_shrink_recovery_ms']:.1f} ms); a new process took "
          f"rank 2 at the step-{ELASTIC_REGROW_STEP} boundary (admission "
          f"{m['elastic_regrow_admit_ms']:.1f} ms); trained to epoch "
          f"{EPOCHS} at world {ELASTIC_RANKS}")
    print(f"  elastic: two runs bit-identical (crc {done[0]['crc']}); "
          f"the three exchange artifacts verify clean")


# -- serving ----------------------------------------------------------------------


def _serve_worker(jdir: str, resume: bool, device: str) -> None:
    """The serve scenario's child: a journaled engine decoding a seeded
    batch. The first run is launched with ``engine_crash@step=N`` armed and
    is hard-killed mid-batch (exit 43), leaving the journal; the restart
    replays it (``Engine.recover``) and finishes; the reference run (no
    fault, a fresh journal) gives the CRCs the recovered outputs must
    equal bit for bit."""
    import numpy as np

    from horovod_tpu_torch.models import transformer
    from horovod_tpu_torch.serving import Engine
    from tools.serve_bench_torch import lm_config, tiny_config

    dev = "cpu" if device == "cpu" else "cuda"
    cfg = tiny_config() if dev == "cpu" else lm_config(SERVE_LAYERS)
    model = transformer.init_params(cfg, seed=0, device=dev)
    engine = Engine(
        cfg, model, block_size=16, max_batch=SERVE_REQUESTS,
        max_prompt_len=SERVE_PROMPT_LEN + SERVE_MAX_NEW,
        journal=os.path.join(jdir, "serve.journal.json"), device=dev)
    outputs: dict[int, list[int]] = {}
    t0 = time.perf_counter()
    if resume:
        recovered = engine.recover()
        print(f"DRILL_SERVE_RESUMED recovered={len(recovered)} "
              f"seconds={time.perf_counter() - t0:.4f}", flush=True)
    else:
        rng = np.random.default_rng(7)
        for _ in range(SERVE_REQUESTS):
            engine.submit(
                rng.integers(0, cfg.vocab_size,
                             size=SERVE_PROMPT_LEN).astype(np.int32),
                SERVE_MAX_NEW)
    while engine.has_work():
        for done in engine.step():
            outputs[done.request_id] = list(done.output)
    engine.pool.check_invariants()
    for rid in sorted(outputs):
        crc = zlib.crc32(
            ",".join(str(t) for t in outputs[rid]).encode()) & 0xFFFFFFFF
        print(f"DRILL_SERVE_CRC rid={rid} crc={crc}", flush=True)
    print(f"DRILL_SERVE_DONE finished={len(outputs)} "
          f"steps={engine.stats['steps']} captures="
          f"{sum(engine._captures.values())}", flush=True)


def scenario_serve(device: str, workdir: str) -> dict:
    """The serve scenario (module docstring). Returns the children's
    seconds and the recovered count."""
    from horovod_tpu_torch.core import resilience as res

    timings = {}

    def _run(tag, jdir, resume=False, fault=None, want_rc=0):
        os.makedirs(jdir, exist_ok=True)
        env = dict(os.environ)
        env.pop("HOROVOD_FAULT_INJECT", None)
        if fault:
            env["HOROVOD_FAULT_INJECT"] = fault
        cmd = [sys.executable, os.path.abspath(__file__), "--serve-worker",
               jdir, "--device", device]
        if resume:
            cmd.append("--resume")
        t0 = time.perf_counter()
        r = subprocess.run(cmd, env=env, capture_output=True, text=True,
                           timeout=240)
        timings[tag] = time.perf_counter() - t0
        assert r.returncode == want_rc, (
            f"serve worker exited {r.returncode}, wanted {want_rc}\n"
            f"{r.stdout[-2000:]}\n{r.stderr[-2000:]}")
        return r.stdout

    def _crcs(out):
        return {ln.split()[1]: ln.split()[2]
                for ln in out.splitlines()
                if ln.startswith("DRILL_SERVE_CRC")}

    # The uninterrupted reference: a fresh journal, no fault.
    ref = _run("reference", os.path.join(workdir, "serve_ref"))
    want = _crcs(ref)
    assert len(want) == SERVE_REQUESTS, ref[-2000:]

    # The crash run: the injector hard-kills the engine mid-batch.
    jdir = os.path.join(workdir, "serve_crash")
    out = _run("crash", jdir, fault=f"engine_crash@step={SERVE_CRASH_STEP}",
               want_rc=res.CRASH_EXIT_CODE)
    assert "simulating engine crash" in out, out[-2000:]
    print(f"  serve: engine hard-killed mid-batch at step "
          f"{SERVE_CRASH_STEP} by injection (exit {res.CRASH_EXIT_CODE})",
          flush=True)

    # The restart: replay the journal, finish the batch, compare CRCs.
    out = _run("restart", jdir, resume=True)
    resumed = [ln for ln in out.splitlines()
               if ln.startswith("DRILL_SERVE_RESUMED")]
    assert resumed, out[-2000:]
    fields = dict(kv.split("=") for kv in resumed[0].split()[1:])
    nrec = int(fields["recovered"])
    assert nrec >= 1, resumed[0]
    got = _crcs(out)
    assert got == want, (
        f"recovered outputs differ from the uninterrupted run — replay "
        f"is not bit-identical:\n  want {want}\n  got  {got}")
    print(f"  serve: restart replayed {nrec} journaled request(s) "
          f"(recover() {float(fields['seconds']) * 1e3:.1f} ms), finished "
          f"the batch; all {len(got)} outputs CRC-identical to the "
          f"uninterrupted run, pool invariants clean", flush=True)
    return {"recovered": nrec, "recover_s": float(fields["seconds"]),
            "children_s": timings, "crcs": got}


# -- the preflights -------------------------------------------------------------


def _lint_rank(device: str, plant: bool) -> list:
    """One rank of the lint preflight: the drill's training step recorded
    and verified with every member's (``plant``: rank 1 issues one extra
    collective, the fault the preflight must catch)."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.analysis import schedule

    _init(device)
    _model, tr, batch = _linear_trainer(device)
    step = tr.step_fn

    def planted(b):
        # The fault the preflight exists to catch, planted on purpose.
        if hvd.rank() == 1:
            hvd.allreduce(b[0], name="planted_extra")  # hvd-lint: disable=HVD001
        return step(b)

    findings = schedule.verify_step(planted if plant else step, [batch],
                                    path="<fault-drill training step>")
    out = [(f.rule, f.path, f.line, f.message) for f in findings]
    hvd.shutdown()
    return out


def preflight_lint(device: str, plant: bool = False) -> None:
    """Schedule-verify the drill's training step before injecting faults
    (module docstring); raises ``SystemExit`` with the findings."""
    import torch

    from horovod_tpu_torch.analysis import render
    from horovod_tpu_torch.analysis.report import Finding
    from horovod_tpu_torch.run import run

    ranks = (2 if device == "cpu"
             else max(1, min(torch.cuda.device_count(), ELASTIC_RANKS)))
    res = run(_lint_rank, ranks, device=device, args=(device, plant))
    findings = [Finding(*f) for f in res[0]]
    if any(r != res[0] for r in res[1:]):
        findings.append(Finding(
            "HVD103", "<fault-drill training step>", 1,
            "the ranks' verifiers returned different findings."))
    if findings:
        print(render(findings))
        raise SystemExit(
            f"[drill] LINT PREFLIGHT FAILED: {len(findings)} schedule "
            f"finding(s) — the training step's collective schedule is "
            f"broken BEFORE any fault injection; fix the protocol bug "
            f"first.")
    print(f"  lint: training-step collective schedule verified (replica "
          f"groups, per-rank identity, wait graph) on {ranks} rank(s)",
          flush=True)


# The model-level preflight sweeps the drill's own fault specs (the
# scenarios inject exactly these shapes) plus anything the caller set in
# HOROVOD_FAULT_INJECT / HOROVOD_MODEL_FAULTS.
_MODEL_PREFLIGHT_SPECS = [
    None,  # the fault-free baseline
    "kv_timeout@seq=1,times=2",  # scenario_kv_timeout's bounded burst
    "torn_write@epoch=2",  # scenario_torn_write
    "crash@rank=0,step=1",  # scenario_crash, scaled to the model script
]


def preflight_model() -> int:
    """Bounded hvd-model sweep of the drill's world (two simulated
    processes, with and without the drill's fault injections):
    HVD201-HVD206 must hold before any scenario runs. Returns the number
    of worlds swept; raises ``SystemExit`` with the findings."""
    from horovod_tpu_torch.analysis import model as _model
    from horovod_tpu_torch.analysis import protocol as _proto
    from horovod_tpu_torch.analysis import render
    from horovod_tpu_torch.utils import env as _env

    specs = list(_MODEL_PREFLIGHT_SPECS)
    for extra in (os.environ.get("HOROVOD_FAULT_INJECT"),
                  _env.model_faults()):
        if extra and extra not in specs:
            specs.append(extra)
    max_states = _env.model_max_states()
    findings = []
    worlds = 0
    for spec in specs:
        faults = _proto.parse_fault_spec(spec)
        for world in _model.standard_worlds(2, faults):
            findings.extend(
                _model.check_world(world, max_states=max_states).findings)
            worlds += 1
    if findings:
        print(render(findings))
        raise SystemExit(
            f"[drill] MODEL PREFLIGHT FAILED: {len(findings)} protocol "
            f"finding(s) — the negotiation protocol is broken BEFORE any "
            f"fault injection; fix the protocol bug first.")
    print(f"  model: negotiation/checkpoint protocol swept clean "
          f"({worlds} worlds, {len(specs)} fault spec(s), HVD201-HVD206)",
          flush=True)
    return worlds


SCENARIOS = ("kv_timeout", "liveness", "torn_write", "crash", "elastic",
             "serve")


def _scenarios(raw: str) -> tuple[str, ...]:
    names = SCENARIOS if raw == "all" else tuple(raw.split(","))
    bad = [n for n in names if n not in SCENARIOS]
    if bad:
        raise argparse.ArgumentTypeError(
            f"unknown scenario(s) {bad}: choose 'all' or names from "
            f"{list(SCENARIOS)}, comma-separated")
    return names


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    ap.add_argument("--scenario", default=SCENARIOS, type=_scenarios,
                    help="all, or names of " + ", ".join(SCENARIOS)
                         + " separated by commas")
    ap.add_argument("--lint", action="store_true",
                    help="preflight: verify the drill's training-step "
                         "schedule and sweep the protocol checker before "
                         "injecting any fault")
    ap.add_argument("--plant-lint-fault", action="store_true",
                    help=argparse.SUPPRESS)  # the preflight's own check
    ap.add_argument("--crash-worker", metavar="CKDIR")
    ap.add_argument("--serve-worker", metavar="JDIR")
    ap.add_argument("--resume", action="store_true")
    args = ap.parse_args(argv)
    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            raise SystemExit("fault_drill_torch: CUDA is not available; "
                             "pass --device cpu for the CPU drill.")
    if args.crash_worker:
        _crash_worker(args.crash_worker, args.resume, args.device)
        return 0
    if args.serve_worker:
        _serve_worker(args.serve_worker, args.resume, args.device)
        return 0
    if args.lint:
        print("[drill] lint preflight", flush=True)
        preflight_lint(args.device, plant=args.plant_lint_fault)
        preflight_model()
    with tempfile.TemporaryDirectory(prefix="hvd_drill_") as workdir:
        for name in args.scenario:
            print(f"[{name}]", flush=True)
            fn = globals()[f"scenario_{name}"]
            if name in ("kv_timeout", "liveness"):
                fn(args.device)
            else:
                fn(args.device, workdir)
    print("FAULT DRILL PASSED", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

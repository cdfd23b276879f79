"""Open-loop load driver for the port's serving engine
(``horovod_tpu_torch/serving/engine.py``) — the counterpart of
``tools/serve_bench.py``. It imports only the port.

The measurements, each reusable as a library (``chip_smoke.py`` phases 9
and 13 call them):

* :func:`decode_rates` — steady-state decode throughput at a fixed
  concurrent batch: fill every slot, warm up, then time ``windows``
  consecutive windows of N engine steps, each → B·N / seconds
  (:func:`bench_decode_tokens_per_sec` is their median);
  :func:`decode_ab` times the engine's captured forwards against the same
  bodies run eagerly (:func:`eager_bodies`), window for window in turns;
* :func:`speculative_rates` — B=1 draft-and-verify throughput, the accept
  rate and the draft's ms a step, with self-speculation or a draft model
  (:func:`distilled_draft_pair` builds the perfectly distilled one);
* :func:`prefill_rates` — prompt tokens ingested per second by the prefill
  loop, B prompts admitted in one step, one rate per admission;
* :func:`run_load` — the open-loop driver: Poisson arrivals at a stated
  rate with sampled prompt and output lengths, submitted on schedule
  whatever the completions, so queueing delay shows in the latencies.
  Reports p50 and maximum request latency, and p99 once at least
  ``P99_MIN_SAMPLES`` requests completed; throughput, rejects and
  preemptions;
* :func:`profile_decode` — where a decode step's time goes: its wall time
  beside the device's kernel time (``torch.profiler``), the kernels a step
  launches, and the kernels that take the most device time;
* :func:`bench_recovery` — the crash-recovery drill as a measurement
  (``tools/serve_bench.py::bench_recovery``): a journaled batch abandoned
  mid-decode, a fresh engine's ``recover()`` timed
  (``serve_recovery_ms``), the batch finished and held bit for bit
  against an uninterrupted run (``bit_identical``);
* :func:`split_rank` — one rank of the prefill/decode split
  (``Engine(prefill_group=1, decode_group=2)`` in a world initialised
  with ``[[0], [1]]``): the decode rank serves each case, the prefill
  rank answers its admissions. ``--split`` runs it over two ranks
  (:func:`horovod_tpu_torch.run.run`), each case beside the unsplit
  engine on the decode rank's device, with prefill and decode tokens/s
  of both and the bytes the split moves per admission.

Every time is the host's clock around engine steps; each step ends with a
host sync (the sampled tokens are read back), so the times cover the
device's work.

Run on one GPU (bench.py's LM at full width, random weights):

    python tools/serve_bench_torch.py                      # 8 layers
    python tools/serve_bench_torch.py --kv-dtype int8_block
    python tools/serve_bench_torch.py --shared-prefix-len 64
    python tools/serve_bench_torch.py --num-requests 300 --arrival-rate 0.5 \
        --prompt-range 32 128 --output-range 16 64
    python tools/serve_bench_torch.py --speculate 4   # + B=1 speculation
    python tools/serve_bench_torch.py --split --layers 8  # two GPUs

and on the CPU, a seconds-long drill of a tiny model:

    python tools/serve_bench_torch.py --smoke --device cpu
    python tools/serve_bench_torch.py --split --smoke --device cpu

``--fault SPEC`` arms ``HOROVOD_FAULT_INJECT`` for the run (parsed first,
so a malformed spec refuses before anything runs); ``--max-requests N``
caps the load's requests and ``--duration S`` truncates its arrival trace
to the first S seconds. Every run ends with the recovery row
(:func:`bench_recovery`): ``serve_recovery_ms`` and ``bit_identical`` on
a line of their own, beside the card's name and power limit.

Decode is measured as ``chip_smoke.py`` phase 9 measures it: a 128-token
prompt behind every slot, ``WINDOWS`` windows of 32 steps, each reported,
then one profiled window. ``--speculate K`` adds B=1 speculative decoding
at draft length K with the full-width distilled pair (an 8-layer target
whose upper blocks add nothing, and a 1-layer draft sharing its first
block, on an int4 draft pool): ``lm_decode_tokens_per_sec_b1_spec``,
``serve_speculative_accept_rate`` and ``serve_draft_overhead_ms`` (null
when off). The output is one JSON line; on the GPU it carries the card's
name and power limit (``nvidia-smi``).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch


# Fewer completed requests than this and run_load reports no p99: with n
# samples the 99th percentile is an interpolation between the two largest
# latencies once n < 100, i.e. nearly the maximum.
P99_MIN_SAMPLES = 100
# The command line's decode and prefill measurements: timed windows (and
# measured prefill admissions), steps per window, prompt behind each slot.
WINDOWS = 5
DECODE_STEPS = 32
DECODE_PROMPT = 128


def _positive(raw, flag: str, unit: str) -> float:
    """Unparsable, NaN, inf and non-positive values raise: a typo'd load
    knob must refuse, not benchmark a different workload."""
    try:
        val = float(raw)
    except (TypeError, ValueError):
        val = float("nan")
    if val != val:
        raise ValueError(f"{flag} must be a number of {unit}, got {raw!r}")
    if math.isinf(val) or val <= 0:
        raise ValueError(
            f"{flag} must be a finite positive number of {unit}, "
            f"got {raw!r}")
    return val


def positive_rate(raw) -> float:
    """Parse an arrival rate (requests/second)."""
    return _positive(raw, "--arrival-rate", "requests/second")


def positive_duration(raw) -> float:
    """Parse a trace duration (seconds): the open-loop arrival trace is
    truncated to arrivals within this window."""
    return _positive(raw, "--duration", "seconds")


def positive_count(raw) -> int:
    """Parse a request cap: a positive INTEGER (12.5 requests is as
    much a typo as NaN requests)."""
    val = _positive(raw, "--max-requests", "requests")
    if val != int(val):
        raise ValueError(
            f"--max-requests must be a whole number of requests, "
            f"got {raw!r}")
    return int(val)


def tiny_config(max_seq_len: int = 64):
    """The CPU-serveable LM of the ``--smoke`` drill."""
    from horovod_tpu_torch.models import transformer

    return transformer.TransformerConfig(
        vocab_size=512, num_layers=2, num_heads=4, num_kv_heads=2,
        embed_dim=64, mlp_dim=128, max_seq_len=max_seq_len,
        dtype=torch.float32)


def lm_config(num_layers: int = 8, max_seq_len: int = 2048):
    """bench.py's LM at full width (``_lm_extra``): vocab 32768, E=1024,
    H=8, Hkv=4 (head dim 128), mlp 4096, bf16."""
    from horovod_tpu_torch.models import transformer

    return transformer.TransformerConfig(
        vocab_size=32_768, num_layers=num_layers, num_heads=8,
        num_kv_heads=4, embed_dim=1024, mlp_dim=4096,
        max_seq_len=max_seq_len, dtype=torch.bfloat16)


def sample_workload(n: int, rate: float, prompt_range=(4, 12),
                    output_range=(4, 16), vocab: int = 512,
                    seed: int = 0, shared_prefix_len: int = 0):
    """Pre-drawn open-loop trace: Poisson arrivals (exponential gaps at
    ``rate``/s), uniformly sampled prompt and output lengths, two tenants.
    ``shared_prefix_len`` > 0 starts every prompt with the same tokens
    (drawn once) — repeated-system-prompt traffic."""
    rng = np.random.default_rng(seed)
    arrivals = np.cumsum(rng.exponential(1.0 / rate, size=n))
    plens = rng.integers(prompt_range[0], prompt_range[1] + 1, size=n)
    outs = rng.integers(output_range[0], output_range[1] + 1, size=n)
    shared = rng.integers(0, vocab, size=shared_prefix_len).astype(np.int32)
    prompts = [np.concatenate(
        [shared, rng.integers(0, vocab, size=p).astype(np.int32)])
        for p in plens]
    return [{"arrival": float(arrivals[i]), "prompt": prompts[i],
             "max_new": int(outs[i]),
             "tenant": f"tenant{i % 2}"} for i in range(n)]


def run_load(engine, workload, max_wall_seconds: float = 300.0) -> dict:
    """Drive the engine open-loop through a :func:`sample_workload` trace;
    returns the latency/throughput metric dict."""
    from horovod_tpu_torch.serving import AdmissionError

    t0 = time.monotonic()
    pending = sorted(workload, key=lambda w: w["arrival"])
    latencies, rejected, submitted = [], 0, {}
    idx = 0
    while len(latencies) + rejected < len(workload):
        now = time.monotonic() - t0
        if now > max_wall_seconds:
            raise RuntimeError(
                f"load run exceeded {max_wall_seconds}s wall cap with "
                f"{len(workload) - len(latencies) - rejected} requests "
                f"outstanding")
        while idx < len(pending) and pending[idx]["arrival"] <= now:
            w = pending[idx]
            try:
                req = engine.submit(w["prompt"], w["max_new"],
                                    tenant=w["tenant"])
                submitted[req.request_id] = w["arrival"]
            except AdmissionError:
                rejected += 1
            idx += 1
        if not engine.has_work():
            if idx < len(pending):  # open-loop idle: wait for the next
                time.sleep(max(0.0, pending[idx]["arrival"]
                               - (time.monotonic() - t0)))
            continue
        for done in engine.step():
            end = time.monotonic() - t0
            latencies.append((end - submitted[done.request_id]) * 1e3)
    wall = time.monotonic() - t0
    lat = np.asarray(latencies) if latencies else np.asarray([float("nan")])
    ingested = (engine.stats["prefill_tokens"]
                + engine.stats["prefix_hit_tokens"])
    return {
        "requests": len(workload),
        "completed": len(latencies),
        "rejected": rejected,
        "serve_p50_ms": float(np.percentile(lat, 50)),
        "serve_p99_ms": (float(np.percentile(lat, 99))
                         if len(latencies) >= P99_MIN_SAMPLES else None),
        "serve_max_ms": float(lat.max()),
        "serve_mean_ms": float(lat.mean()),
        "requests_per_sec": len(latencies) / wall,
        "gen_tokens_per_sec": engine.stats["tokens_generated"] / wall,
        "preemptions": engine.stats["preemptions"],
        "prefill_tokens": engine.stats["prefill_tokens"],
        "prefill_steps": engine.stats["prefill_steps"],
        "serve_prefix_hit_tokens_ratio": (
            engine.stats["prefix_hit_tokens"] / ingested if ingested
            else 0.0),
        "kv_cache_bytes_per_token":
            engine.cache_stats()["kv_cache_bytes_per_token"],
        "kv_dtype": engine.kv_dtype,
        "wall_seconds": wall,
    }


def _prompts(config, batch: int, prompt_len: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, config.vocab_size,
                         size=prompt_len).astype(np.int32)
            for _ in range(batch)]


def eager_bodies(engine):
    """Make ``engine`` run its forwards' bodies eagerly — the functions its
    CUDA graphs capture, called directly — instead of capturing and
    replaying them: the eager side of :func:`decode_ab` and of
    ``chip_smoke.py``'s graph-against-body check. Returns the engine."""
    engine._run = lambda name: engine._bodies[name]()
    return engine


def distilled_draft_pair(config, seed: int = 0, device="cuda"):
    """A (target, draft config, draft) whose draft agrees with the target:
    the target's blocks 1.. have their attention out-projection and MLP
    down-projection zeroed, so the target computes its first block only,
    and a 1-layer draft shares the embedding, block 0, the final norm and
    the LM head (``tools/serve_bench.py::distilled_draft_pair``, here at
    the caller's width, weights from ``init_params(config, seed)``). The
    measured speculative speedup then isolates what the draft-and-verify
    machinery delivers when the draft is right."""
    from horovod_tpu_torch.models import transformer

    target = transformer.init_params(config, seed=seed, device=device)
    with torch.no_grad():
        for block in target.blocks[1:]:
            block.attn.out.zero_()
            block.mlp_out.zero_()
    dcfg = transformer.draft_config(config, num_layers=1)
    draft = transformer.Transformer(dcfg).to(device)
    draft.load_state_dict({k: v for k, v in target.state_dict().items()
                           if not k.startswith("blocks.")
                           or k.startswith("blocks.0.")})
    return target, dcfg, draft


def _filled_engine(config, params, batch, prompt_len, max_new, block_size,
                   kv_dtype, device, eager: bool = False, **engine_kw):
    """An engine with every one of its ``batch`` slots busy after one step
    (admission, prefill, first decode); ``eager``: its bodies run eagerly
    (:func:`eager_bodies`)."""
    from horovod_tpu_torch.serving import Engine

    need = prompt_len + max_new
    if need > config.max_seq_len:
        raise ValueError(
            f"prompt_len+warmup+steps ({need}) exceeds max_seq_len "
            f"({config.max_seq_len}) — shrink the measurement")
    engine = Engine(config, params, block_size=block_size,
                    max_batch=batch, max_prompt_len=prompt_len,
                    kv_dtype=kv_dtype, device=device, **engine_kw)
    if eager:
        eager_bodies(engine)
    for p in _prompts(config, batch, prompt_len):
        engine.submit(p, max_new_tokens=max_new)
    engine.step()
    return engine


def _decode_window(engine, batch: int, steps: int) -> float:
    """Time ``steps`` engine steps that each advance all ``batch`` slots;
    tokens/s."""
    tok0 = engine.stats["tokens_generated"]
    t0 = time.monotonic()
    for _ in range(steps):
        engine.step()
    dt = time.monotonic() - t0
    produced = engine.stats["tokens_generated"] - tok0
    if produced != batch * steps or engine.stats["preemptions"]:
        raise RuntimeError(
            f"decode measurement not clean: {produced} tokens in the "
            f"timed window (expected {batch * steps}), "
            f"{engine.stats['preemptions']} preemptions — the reported "
            f"throughput would be wrong")
    return produced / dt


def decode_rates(config, params, batch: int, steps: int = 16,
                 prompt_len: int = 8, block_size: int = 16,
                 warmup: int = 2, windows: int = 1,
                 kv_dtype: str | None = None, device="cuda") -> list[float]:
    """Steady-state decode throughput with every slot busy: prefill B
    prompts, warm up, then time ``windows`` consecutive windows of
    ``steps`` engine steps (each advances all B slots one token) in the
    same engine; one tokens/s figure per window."""
    # Token budget: 2 land in the first (admit+prefill+decode) step, one a
    # warm-up step, one a timed step, plus one spare, so no request
    # finishes inside a timed window.
    engine = _filled_engine(config, params, batch, prompt_len,
                            warmup + windows * steps + 3, block_size,
                            kv_dtype, device)
    for _ in range(warmup):
        engine.step()
    return [_decode_window(engine, batch, steps) for _ in range(windows)]


def decode_ab(config, params, batch: int, steps: int = 16,
              prompt_len: int = 8, block_size: int = 16, warmup: int = 2,
              windows: int = 1, device="cuda") -> dict:
    """Decode throughput of the captured forwards against the same bodies
    run eagerly (:func:`eager_bodies`): two engines filled alike, then
    ``windows`` windows of ``steps`` steps each, in turns (graph, eager,
    eager, graph, ...). Returns the tokens/s of each side by window."""
    max_new = warmup + windows * steps + 3
    engines = {side: _filled_engine(config, params, batch, prompt_len,
                                    max_new, block_size, None, device,
                                    eager=side == "eager")
               for side in ("graph", "eager")}
    for engine in engines.values():
        for _ in range(warmup):
            engine.step()
    rates: dict[str, list[float]] = {"graph": [], "eager": []}
    for w in range(windows):
        for side in (("graph", "eager") if w % 2 == 0
                     else ("eager", "graph")):
            rates[side].append(_decode_window(engines[side], batch, steps))
    return rates


def speculative_rates(config, params, *, speculate: int = 4,
                      steps: int = 12, prompt_len: int = 8,
                      block_size: int = 16, warmup: int = 2,
                      windows: int = 1, draft_kv_dtype: str | None = None,
                      draft_config=None, draft_params=None,
                      device="cuda") -> dict:
    """Steady-state B=1 draft-and-verify throughput (the low-batch regime
    speculation is for), as ``tools/serve_bench.py::
    bench_speculative_decode`` measures it: one request, ``windows``
    windows of ``steps`` engine steps. With no draft the target
    self-speculates. Returns each window's tokens/s, the accept rate and
    the draft's ms a step (host clock around the draft forward, which ends
    in reading its proposals back). Raises when a window is not clean (a
    finish or a preemption inside it)."""
    from horovod_tpu_torch.serving import Engine

    need = prompt_len + 1 + (warmup + windows * steps + 1) * (speculate + 1)
    if need > config.max_seq_len:
        raise ValueError(
            f"speculative window needs {need} positions but max_seq_len "
            f"is {config.max_seq_len} — shrink steps/k or grow the model")
    engine = Engine(config, params, block_size=block_size, max_batch=1,
                    max_prompt_len=prompt_len, speculate=speculate,
                    draft_kv_dtype=draft_kv_dtype, draft_config=draft_config,
                    draft_params=draft_params, device=device)
    engine.submit(_prompts(config, 1, prompt_len)[0],
                  max_new_tokens=config.max_seq_len - prompt_len)
    engine.step()  # admit + prefill (+ first burst)
    for _ in range(warmup):
        engine.step()
    draft0, calls0 = engine.stats["draft_time_s"], engine.stats["draft_calls"]
    rates = []
    for _ in range(windows):
        tok0 = engine.stats["tokens_generated"]
        t0 = time.monotonic()
        for _ in range(steps):
            engine.step()
        rates.append((engine.stats["tokens_generated"] - tok0)
                     / (time.monotonic() - t0))
    if engine.stats["finished"] or engine.stats["preemptions"]:
        raise RuntimeError(
            "speculative decode measurement not clean: a request "
            "finished or was preempted inside the timed window")
    return {
        "tokens_per_sec": rates,
        "accept_rate": engine.spec_accept_rate,
        "draft_overhead_ms": ((engine.stats["draft_time_s"] - draft0) * 1e3
                              / max(1, engine.stats["draft_calls"] - calls0)),
        "speculate_k": speculate,
        "draft_kv_dtype": engine.draft_kv_dtype,
    }


def bench_decode_tokens_per_sec(config, params, batch: int,
                                steps: int = 16, prompt_len: int = 8,
                                block_size: int = 16, warmup: int = 2,
                                windows: int = 1,
                                kv_dtype: str | None = None,
                                device="cuda") -> float:
    """The median of :func:`decode_rates`."""
    return statistics.median(decode_rates(
        config, params, batch, steps, prompt_len, block_size, warmup,
        windows, kv_dtype, device))


def prefill_rates(config, params, batch: int, prompt_len: int,
                  block_size: int = 16, windows: int = 1,
                  kv_dtype: str | None = None, device="cuda") -> list[float]:
    """Prompt tokens per second through the prefill loop: B prompts of
    ``prompt_len`` tokens admitted in one step, after one warm-up admission
    of the same shape in the same engine; one rate per each of
    ``windows`` measured admissions."""
    from horovod_tpu_torch.serving import Engine

    engine = Engine(config, params, block_size=block_size, max_batch=batch,
                    max_prompt_len=prompt_len, kv_dtype=kv_dtype,
                    device=device)
    rates = []
    for seed in range(windows + 1):  # warm-up, then the measured admissions
        for p in _prompts(config, batch, prompt_len, seed):
            engine.submit(p, max_new_tokens=1)
        before = (engine.stats["prefill_tokens"], engine._prefill_time_s)
        engine.run_until_idle()
        rates.append((engine.stats["prefill_tokens"] - before[0])
                     / (engine._prefill_time_s - before[1]))
    return rates[1:]


def profile_decode(config, params, batch: int, steps: int = 16,
                   prompt_len: int = 128, block_size: int = 16,
                   top: int = 10, kv_dtype: str | None = None,
                   device="cuda") -> dict:
    """Where a decode step's time goes, every slot busy: the wall ms of a
    step without the profiler (median of three windows), then one window
    under ``torch.profiler`` — the device's kernel ms per step (the sum of
    its kernels' durations, no overlap counted twice on one stream), the
    kernels launched per step, the busy share (kernel time over the wall
    time), and the ``top`` kernels by device time. The profiled engine is
    built, and its graphs captured, under the profiler, which sees a
    replay's kernels only so; the window is the kernels after its
    ``record_function`` mark. Kernel figures are None when the profiler saw
    no device activity."""
    engine = _filled_engine(config, params, batch, prompt_len,
                            2 + 3 * steps + 3, block_size, kv_dtype, device)
    for _ in range(2):
        engine.step()
    wall = [batch * 1e3 / _decode_window(engine, batch, steps)
            for _ in range(3)]
    del engine
    cuda = torch.device(device).type == "cuda"
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        engine = _filled_engine(config, params, batch, prompt_len,
                                2 + steps + 3, block_size, kv_dtype, device)
        for _ in range(2):
            engine.step()
        if cuda:
            torch.cuda.synchronize()
        with torch.profiler.record_function("profiled_window"):
            for _ in range(steps):
                engine.step()
    events = prof.events()
    start = min(e.time_range.start for e in events
                if e.name == "profiled_window")
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and e.time_range.start >= start]
    out = {"batch": batch, "steps": steps, "prompt_len": prompt_len,
           "wall_ms_per_step": statistics.median(wall),
           "wall_ms_per_step_windows": wall,
           "device_ms_per_step": None, "kernels_per_step": None,
           "busy_share": None, "top_kernels": None}
    if not kernels:
        return out
    by_name: dict[str, list[float]] = {}
    for e in kernels:
        by_name.setdefault(e.name, []).append(e.time_range.elapsed_us())
    device_ms = sum(map(sum, by_name.values())) / 1e3 / steps
    out.update(
        device_ms_per_step=device_ms,
        kernels_per_step=len(kernels) / steps,
        busy_share=device_ms / out["wall_ms_per_step"],
        top_kernels=[{"name": n[:120], "ms_per_step": sum(d) / 1e3 / steps,
                      "calls_per_step": len(d) / steps}
                     for n, d in sorted(by_name.items(),
                                        key=lambda kv: -sum(kv[1]))[:top]])
    return out


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def bench_recovery(config, model, journal_path: str, *,
                   num_requests: int = 4, interrupt_steps: int = 3,
                   prompt_len: int = 6, max_new: int = 10,
                   block_size: int = 16, kv_dtype: str | None = None,
                   seed: int = 0, device="cuda") -> dict:
    """Crash-recovery drill as a measurement, as
    ``tools/serve_bench.py::bench_recovery`` runs it: an uninterrupted
    batch; the same batch journaled and abandoned after
    ``interrupt_steps`` steps (no close, no flush beyond the per-step one:
    what a dead process leaves); a fresh engine's ``recover()`` timed; the
    batch finished. ``bit_identical`` says whether the outputs equal the
    uninterrupted run's, ``serve_recovery_ms`` what the replay took (the
    device synchronized before each clock read)."""
    from horovod_tpu_torch.serving import Engine

    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, config.vocab_size,
                            size=prompt_len).astype(np.int32)
               for _ in range(num_requests)]

    def _engine(journal=None):
        return Engine(config, model, block_size=block_size,
                      max_batch=num_requests,
                      max_prompt_len=prompt_len + max_new,
                      kv_dtype=kv_dtype, journal=journal, device=device)

    def _drain(eng, outputs):
        while eng.has_work():
            for done in eng.step():
                outputs[done.request_id] = list(done.output)

    reference: dict[int, list[int]] = {}
    ref = _engine()
    for p in prompts:
        ref.submit(p, max_new)
    _drain(ref, reference)
    del ref

    outputs: dict[int, list[int]] = {}
    interrupted = _engine(journal=journal_path)
    for p in prompts:
        interrupted.submit(p, max_new)
    for _ in range(interrupt_steps):
        for done in interrupted.step():
            outputs[done.request_id] = list(done.output)
    # The simulated crash: the engine is abandoned here.
    del interrupted

    restarted = _engine(journal=journal_path)
    _sync(device)
    t0 = time.monotonic()
    recovered = restarted.recover()
    _sync(device)
    recovery_ms = (time.monotonic() - t0) * 1e3
    _drain(restarted, outputs)

    return {
        "requests": num_requests,
        "recovered": len(recovered),
        "interrupt_steps": interrupt_steps,
        "serve_recovery_ms": round(recovery_ms, 3),
        "bit_identical": outputs == reference,
        "kv_dtype": restarted.kv_dtype,
    }


# -- the prefill/decode split -------------------------------------------------
# A case is plain data, so that it pickles into the ranks: ``name``,
# ``engine`` (Engine keywords beside the split's), ``prompts`` (lists of
# token ids, served in ``batches`` submit-and-drain rounds), ``max_new``,
# and optionally ``forget`` (the decode rank forgets which pages the
# prefill rank holds between rounds, so it ships them), ``interrupt``
# (journaled: the decode-side engine is abandoned after that many steps,
# the session closed, and a new engine pair recovers the batch),
# ``record`` (the wire rows of the case, recorded on each rank),
# ``timed`` (prefill and decode tokens/s of the rounds) and ``groups``
# (the prefill and decode group indices, default 1 and 2).

SPLIT_GROUPS = [[0], [1]]  # group 1 leads at rank 0, group 2 at rank 1
SPLIT_HANG_DUMP_S = 150


def serve_case(make_engine, case: dict, journal: str | None = None) -> dict:
    """Run one case on this rank's engine(s) from ``make_engine(**kw)``:
    the prefill rank answers admissions until each session closes; the
    decode rank (or an unsplit engine) serves the prompts. Returns the
    role, the ranks, each request's output by id, the trace counts, the
    split's byte counts, with ``record`` this rank's wire rows, and on a
    rank that does not serve, the text ``submit`` raises there."""
    from horovod_tpu_torch.core.state import HorovodError
    from horovod_tpu_torch.ops import wire

    kw = dict(case.get("engine", {}))
    interrupt = case.get("interrupt")
    if interrupt is not None:
        kw["journal"] = journal
    eng = make_engine(**kw)
    out = {"role": eng.role, "prefill_rank": eng.prefill_rank,
           "decode_rank": eng.decode_rank, "outputs": {}}
    if eng.role in ("prefill", "idle"):
        try:
            eng.submit(np.zeros((1,), np.int32), 1)
        except HorovodError as e:
            out["refusal"] = str(e)
    if eng.role == "idle":  # it builds nothing to report on
        return out
    with (wire.recording() if case.get("record")
          else contextlib.nullcontext()) as rec:
        if eng.role == "prefill":
            out["served"] = eng.serve_prefill()
            if interrupt is not None:
                eng = None
                eng = make_engine(**kw)
                out["served"] += eng.serve_prefill()
        else:
            eng = _drive(eng, make_engine, kw, case, out)
    if rec is not None:
        out["rows"] = [(i.opcode, i.element_type, list(i.shape))
                       for i in rec.instrs]
    out.update(prefill_traces=eng.prefill_trace_count,
               decode_traces=eng.decode_trace_count,
               captures=dict(eng._captures), split=dict(eng.split_stats),
               stats={k: eng.stats[k] for k in (
                   "preemptions", "prefix_hit_tokens", "recovered",
                   "prefill_calls", "prefill_steps")})
    return out


def _drive(eng, make_engine, kw, case, out):
    """The decode rank's (or an unsplit engine's) side of a case; returns
    the engine that finished it. The session is closed on any way out, so
    a failure here never leaves the prefill rank waiting."""
    device = eng.device
    prompts = [np.asarray(p, np.int32) for p in case["prompts"]]
    rounds = case.get("batches", 1)
    per = -(-len(prompts) // rounds)
    prefill_s = decode_s = 0.0
    prefill_tok = decode_tok = 0
    try:
        if case.get("timed"):
            # One untimed request first: the captures and, split, the
            # pair's first NCCL call (its communicator) are one-time
            # costs. Its prompt is the first one reversed, so it shares
            # no prefix.
            eng.submit(prompts[0][::-1].copy(), 2)
            eng.run_until_idle()
        for r in range(rounds):
            if r and case.get("forget"):
                eng._remote_valid.clear()
            for p in prompts[r * per:(r + 1) * per]:
                eng.submit(p, case["max_new"])
            steps = 0
            while eng.has_work():
                if steps == case.get("interrupt"):
                    # The decode-side engine is abandoned mid-batch; its
                    # journal is what the next engine pair recovers.
                    eng.close()
                    eng = None
                    eng = make_engine(**kw)
                    eng.recover()
                    out["recovered"] = eng.stats["recovered"]
                _sync(device)
                t0 = time.monotonic()
                before = (eng.stats["prefill_tokens"], eng._prefill_time_s,
                          eng.stats["tokens_generated"])
                for done in eng.step():
                    out["outputs"][done.request_id] = list(done.output)
                _sync(device)
                dt = time.monotonic() - t0
                pre = eng._prefill_time_s - before[1]
                if eng.stats["prefill_tokens"] > before[0]:
                    prefill_s += pre
                    prefill_tok += eng.stats["prefill_tokens"] - before[0]
                else:
                    decode_s += dt
                    decode_tok += eng.stats["tokens_generated"] - before[2]
                steps += 1
    finally:
        if eng is not None:
            eng.close()
    if case.get("timed"):
        out["prefill_tokens_per_sec"] = prefill_tok / prefill_s
        out["decode_tokens_per_sec"] = decode_tok / decode_s
    return eng


def split_rank(config, state: dict | None, cases: list, workdir: str,
               device: str = "cuda", seed: int = 0) -> dict:
    """One rank of a two-rank world (:func:`horovod_tpu_torch.run.run`):
    ``hvd.init(SPLIT_GROUPS)``, the model from ``state`` (a state dict;
    None: ``init_params(config, seed)``), then every case through the
    split engine. Returns ``{case name: serve_case's result}``."""
    import faulthandler

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import transformer
    from horovod_tpu_torch.serving import Engine

    # A rank still here after SPLIT_HANG_DUMP_S prints every thread's
    # stack: a transfer that hangs says where.
    faulthandler.dump_traceback_later(SPLIT_HANG_DUMP_S)
    hvd.init(SPLIT_GROUPS, device="cpu" if device == "cpu" else None)
    dev = hvd.device()
    if state is None:
        model = transformer.init_params(config, seed=seed, device=dev)
    else:
        model = transformer.Transformer(config).to(dev)
        model.load_state_dict(state)
    results = {}
    for case in cases:
        groups = case.get("groups", (1, 2))

        def make(**kw):
            return Engine(config, model, prefill_group=groups[0],
                          decode_group=groups[1], device=dev, **kw)
        results[case["name"]] = serve_case(make, case, os.path.join(
            workdir, f"{case['name']}.split.journal.json"))
    faulthandler.cancel_dump_traceback_later()
    return results


def unsplit_case(config, model, case: dict, workdir: str, device) -> dict:
    """The same case through the unsplit engine, in this process."""
    from horovod_tpu_torch.serving import Engine

    def make(**kw):
        return Engine(config, model, device=device, **kw)
    return serve_case(make, case, os.path.join(
        workdir, f"{case['name']}.serve.journal.json"))


def split_cases(config, block_size: int = 16, smoke: bool = False) -> list:
    """``--split``'s cases at ``config``: four requests that share a
    two-block prefix, served in two rounds with the prefix cache (timed),
    the same under ``int8_block``, the same with the decode rank
    forgetting what the prefill rank holds between the rounds (so the
    second round ships the prefix's pages), and the journaled recovery."""
    rng = np.random.default_rng(0)
    lens = (6, 9, 12, 15) if smoke else (96, 160, 224, 288)
    shared = rng.integers(0, config.vocab_size, 2 * block_size)
    prompts = [np.concatenate([shared, rng.integers(
        0, config.vocab_size, n)]).astype(np.int32).tolist() for n in lens]
    new = 8 if smoke else 64
    base = dict(block_size=block_size, max_batch=4,
                max_prompt_len=max(map(len, prompts)) + new)
    return [
        dict(name="prefix", engine=dict(base, prefix_cache=True),
             prompts=prompts, batches=2, max_new=new, timed=True),
        dict(name="int8_block", engine=dict(base, prefix_cache=True,
                                            kv_dtype="int8_block"),
             prompts=prompts, batches=2, max_new=new),
        dict(name="ship", engine=dict(base, prefix_cache=True),
             prompts=prompts, batches=2, max_new=new, forget=True),
        dict(name="recover", engine=base, prompts=prompts, max_new=new,
             interrupt=3),
    ]


def bench_split(config, cases: list, device: str = "cuda",
                seed: int = 0) -> dict:
    """The split over two ranks (two GPUs, or two gloo ranks with
    ``device='cpu'``) against the unsplit engine in this process on the
    same weights (``init_params(config, seed)``): per case, whether every
    request's output equals, the bytes moved per admission, and for the
    timed cases prefill and decode tokens/s of both."""
    import tempfile

    from horovod_tpu_torch.models import transformer
    from horovod_tpu_torch.run import run

    with tempfile.TemporaryDirectory(prefix="serve_split_") as workdir:
        ranks = run(split_rank, 2, device=device,
                    args=(config, None, cases, workdir, device, seed),
                    timeout=1200)
        dev = torch.device("cuda", 0) if device != "cpu" else "cpu"
        model = transformer.init_params(config, seed=seed, device=dev)
        rows = {}
        for case in cases:
            ref = unsplit_case(config, model, case, workdir, dev)
            pre, dec = ranks[0][case["name"]], ranks[1][case["name"]]
            sp = dec["split"]
            row = {"equal": dec["outputs"] == ref["outputs"],
                   "requests": len(ref["outputs"]),
                   "admissions": sp["admissions"],
                   "bytes_per_admission": (sp["bytes_sent"]
                                           + sp["bytes_received"])
                   / max(1, sp["admissions"]),
                   "pages_shipped": sp["pages_shipped"],
                   "pages_written": sp["pages_written"],
                   "prefill_captures": pre["captures"],
                   "decode_captures": dec["captures"]}
            if case.get("timed"):
                row.update({f"split_{k}": dec[k] for k in (
                    "prefill_tokens_per_sec", "decode_tokens_per_sec")})
                row.update({f"unsplit_{k}": ref[k] for k in (
                    "prefill_tokens_per_sec", "decode_tokens_per_sec")})
            rows[case["name"]] = row
    return rows


def warm_engine(engine) -> None:
    """Serve one throwaway request so the first request of a measured load
    pays no one-time cost (allocator growth, library handles)."""
    engine.generate_batch([np.zeros((2,), np.int32)], 2)
    for k in ("tokens_generated", "preemptions", "prefill_tokens",
              "prefix_hit_tokens", "prefill_steps"):
        engine.stats[k] = 0


def card_identity() -> str:
    """``nvidia-smi``'s name and power limit of the card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def parse_args(argv=None):
    """The command line, validated: a malformed ``--fault`` spec refuses
    here, before anything runs; a valid one is armed
    (``HOROVOD_FAULT_INJECT``, the injector re-read)."""
    from horovod_tpu_torch.serving.kv_cache import KV_DTYPES

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--smoke", action="store_true",
                        help="a tiny fp32 model and a light load (seconds, "
                             "runs on the CPU with --device cpu)")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    parser.add_argument("--layers", type=int, default=8,
                        help="depth of the full-width LM (not --smoke)")
    parser.add_argument("--arrival-rate", type=positive_rate, default=4.0,
                        help="open-loop Poisson arrival rate, requests/s")
    parser.add_argument("--num-requests", type=int, default=16)
    parser.add_argument("--max-requests", type=positive_count, default=None,
                        help="hard cap on the load's requests (a positive "
                             "whole number)")
    parser.add_argument("--duration", type=positive_duration, default=None,
                        help="truncate the open-loop trace to arrivals "
                             "within this many seconds")
    parser.add_argument("--fault", default=None,
                        help="fault spec for HOROVOD_FAULT_INJECT "
                             "(core/resilience.py grammar, e.g. "
                             "'stuck_decode@step=3,ms=9000'), parsed first "
                             "so that a malformed spec refuses")
    parser.add_argument("--max-batch", type=int, default=8)
    parser.add_argument("--block-size", type=int, default=16)
    parser.add_argument("--prompt-range", type=int, nargs=2,
                        default=None, metavar=("MIN", "MAX"))
    parser.add_argument("--output-range", type=int, nargs=2,
                        default=None, metavar=("MIN", "MAX"))
    parser.add_argument("--kv-dtype", default="model",
                        choices=["model", *KV_DTYPES])
    parser.add_argument("--shared-prefix-len", type=int, default=0,
                        help="every prompt starts with the same N tokens; "
                             "turns the prefix cache on")
    parser.add_argument("--decode-batches", type=int, nargs="*",
                        default=[1, 8])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--speculate", type=int, default=0, metavar="K",
                        help="also measure B=1 speculative decoding at draft "
                             "length K with the distilled pair (0 = off)")
    parser.add_argument("--split", action="store_true",
                        help="only the prefill/decode split: two ranks "
                             "(two GPUs, or gloo with --device cpu) against "
                             "the unsplit engine")
    args = parser.parse_args(argv)
    if 0 < args.shared_prefix_len < args.block_size:
        raise SystemExit(
            f"--shared-prefix-len {args.shared_prefix_len} is shorter "
            f"than one block (--block-size {args.block_size}): a prefix "
            f"shares as full blocks only. Use 0 (off) or >= block_size.")
    if args.max_requests is not None:
        args.num_requests = min(args.num_requests, args.max_requests)
    if args.fault is not None:
        from horovod_tpu_torch.analysis import protocol
        from horovod_tpu_torch.core import resilience

        protocol.parse_fault_spec(args.fault)  # a malformed spec refuses
        os.environ["HOROVOD_FAULT_INJECT"] = args.fault
        resilience.reset_injector()
    return args


def main(argv=None) -> int:
    import tempfile

    from horovod_tpu_torch.models import transformer
    from horovod_tpu_torch.serving import Engine

    args = parse_args(argv)
    if args.smoke:
        cfg = tiny_config(max_seq_len=max(64, args.shared_prefix_len + 32))
        prange, orange = args.prompt_range or (4, 12), args.output_range or (4, 16)
    else:
        cfg = lm_config(args.layers)
        prange = args.prompt_range or (128, 512)
        orange = args.output_range or (32, 128)
    card = card_identity() if args.device != "cpu" else None
    if args.split:
        cases = split_cases(cfg, args.block_size, args.smoke)
        rows = bench_split(cfg, cases, device=args.device, seed=args.seed)
        print(json.dumps({"metric": "serve_bench_torch_split",
                          "device": args.device, "layers": cfg.num_layers,
                          "card": card, "cases": rows}))
        shipped = all(rows[c["name"]]["pages_shipped"] > 0
                      for c in cases if c.get("forget"))
        return 0 if shipped and all(
            r["equal"] for r in rows.values()) else 1
    workload = sample_workload(
        args.num_requests, args.arrival_rate, prompt_range=prange,
        output_range=orange, vocab=cfg.vocab_size, seed=args.seed,
        shared_prefix_len=args.shared_prefix_len)
    if args.duration is not None:
        workload = [w for w in workload if w["arrival"] <= args.duration]
        if not workload:
            raise SystemExit(
                f"--duration {args.duration}s truncates the trace to zero "
                f"arrivals at --arrival-rate {args.arrival_rate}/s — "
                f"nothing to measure")
    params = transformer.init_params(cfg, seed=args.seed, device=args.device)
    kvd = None if args.kv_dtype == "model" else args.kv_dtype
    result = {"metric": "serve_bench_torch", "device": args.device,
              "layers": cfg.num_layers, "arrival_rate_per_sec":
              args.arrival_rate}
    if card is not None:
        result["card"] = card
    steps, dprompt = ((4, 8) if args.smoke
                      else (DECODE_STEPS, DECODE_PROMPT))
    for b in args.decode_batches:
        rates = decode_rates(cfg, params, b, steps=steps, prompt_len=dprompt,
                             block_size=args.block_size, windows=WINDOWS,
                             kv_dtype=kvd, device=args.device)
        result[f"lm_decode_tokens_per_sec_b{b}"] = statistics.median(rates)
        result[f"lm_decode_tokens_per_sec_b{b}_windows"] = rates
        result[f"decode_profile_b{b}"] = profile_decode(
            cfg, params, b, steps=steps, prompt_len=dprompt,
            block_size=args.block_size, kv_dtype=kvd, device=args.device)
    rates = prefill_rates(cfg, params, args.max_batch, prange[1],
                          block_size=args.block_size, windows=WINDOWS,
                          kv_dtype=kvd, device=args.device)
    result["lm_prefill_tokens_per_sec"] = statistics.median(rates)
    result["lm_prefill_tokens_per_sec_windows"] = rates
    result.update(lm_decode_tokens_per_sec_b1_spec=None,
                  serve_speculative_accept_rate=None,
                  serve_draft_overhead_ms=None)
    if args.speculate:
        target, dcfg, draft = distilled_draft_pair(cfg, seed=args.seed,
                                                   device=args.device)
        spec = speculative_rates(
            cfg, target, speculate=args.speculate, steps=steps,
            prompt_len=dprompt, block_size=args.block_size,
            windows=1 if args.smoke else WINDOWS, draft_config=dcfg, draft_params=draft, device=args.device)
        del target, draft
        result.update(
            lm_decode_tokens_per_sec_b1_spec=statistics.median(
                spec["tokens_per_sec"]),
            lm_decode_tokens_per_sec_b1_spec_windows=spec["tokens_per_sec"],
            serve_speculative_accept_rate=spec["accept_rate"],
            serve_draft_overhead_ms=spec["draft_overhead_ms"],
            serve_speculate_k=args.speculate,
            serve_draft_kv_dtype=spec["draft_kv_dtype"])
    prefix_on = args.shared_prefix_len >= args.block_size
    engine = Engine(cfg, params, block_size=args.block_size,
                    max_batch=args.max_batch,
                    max_prompt_len=prange[1] + args.shared_prefix_len,
                    kv_dtype=kvd, prefix_cache=prefix_on,
                    device=args.device)
    warm_engine(engine)
    if args.device != "cpu":
        torch.cuda.reset_peak_memory_stats()
    # Twice the arrivals' span and five minutes: a load the engine keeps up
    # with ends well inside it, and a run that falls behind without end
    # stops.
    result.update(run_load(engine, workload, max_wall_seconds=(
        2 * workload[-1]["arrival"] + 300)))
    if args.device != "cpu":
        result["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
    del engine
    print(json.dumps(result))

    with tempfile.TemporaryDirectory(prefix="serve_bench_") as td:
        rec = bench_recovery(cfg, params,
                             os.path.join(td, "serve_bench.journal.json"),
                             block_size=args.block_size, kv_dtype=kvd,
                             seed=args.seed, device=args.device)
    print(json.dumps({"metric": "serve_bench_torch_recovery",
                      "serve_recovery_ms": rec["serve_recovery_ms"],
                      "bit_identical": rec["bit_identical"],
                      "recovered": rec["recovered"], "card": card}))
    if not rec["bit_identical"]:
        raise SystemExit(
            "serve_bench_recovery: journal replay produced outputs that "
            "differ from the uninterrupted run — recovery is not "
            "bit-identical")
    return 0


if __name__ == "__main__":
    sys.exit(main())

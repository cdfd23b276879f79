"""Continuous-batching generation engine over the paged KV cache.

Counterpart of ``horovod_tpu/serving/engine.py`` without speculation. The
reference jits two fixed-shape executables; the port runs the same two
forwards eagerly, at shapes that never change with the batch's
composition:

* **prefill** — a loop of one-token forwards over the data window
  ``[min(skip, plen - 1), max(plen))`` of the newly admitted rows (the
  earliest position any of them needs, to the end of the longest prompt).
  Inactive rows, and admitted rows inside a shared prefix span, write their
  fresh K/V to the null block; the last prompt position's logits give each
  row its first token.
* **decode** — one token for every slot: gather each slot's paged view
  through its block table, run the model's decode step (the attend
  :func:`~horovod_tpu_torch.models.transformer.generate` runs, so greedy
  tokens are bit-identical to it at equal shapes), scatter the fresh K/V
  into the pools in place at ``(tables[row, len // bs], len % bs)``
  (``index_put_``), sample.

Batch slots are padded to ``max_batch``: admitting, finishing or preempting
requests changes the contents of the mask, table and length tensors, never
their shapes. :attr:`Engine.decode_trace_count` and
:attr:`Engine.prefill_trace_count` count the distinct signatures (shape,
dtype, device) of the tensors each forward handed the model's decode step —
the counterpart of the reference's trace counts — and stay at 1 across
composition churn.

``kv_dtype`` selects the pool format at construction (fp32/bf16 raw pages,
int8_block/int4 payloads plus bf16 scale planes — ``serving/kv_cache.py``).
The scheduler (``serving/scheduler.py``) owns admission, fairness and prefix
matching; the block pool owns memory; ``serving/resilience.py`` owns
deadlines, the watchdog and the journal. Timeline: PREFILL/DECODE spans and
ADMIT/EVICT ticks on a ``serving`` row (``core/timeline.py``).

Sampling at ``temperature > 0`` is Gumbel-max over a counter hash keyed by
(engine seed, request seed, position)
(:func:`~horovod_tpu_torch.models.transformer.sample_tokens`): deterministic,
independent of the batch composition and stable under recompute, but not
the reference's ``jax.random`` stream (ROADMAP §C). Greedy is ``argmax``.

Not ported yet, each raising ``NotImplementedError`` (ROADMAP §A item 14):
speculative decoding (``speculate > 0``, and its ``draft_kv_dtype`` and
``min_accept`` options), the prefill/decode split across two subset groups
(``prefill_group``/``decode_group``). The reference's
tuned-config override of the speculate knob (``tune/apply.py``) is not read:
the port reads ``HOROVOD_SERVE_SPECULATE`` only.
"""

from __future__ import annotations

import os
import time
from collections import deque

import numpy as np
import torch

from horovod_tpu_torch.analysis import protocol as _proto
from horovod_tpu_torch.core import resilience as _res
from horovod_tpu_torch.core import timeline as _timeline
from horovod_tpu_torch.core.state import HorovodError
from horovod_tpu_torch.models import transformer
from horovod_tpu_torch.serving import kv_cache as _kv
from horovod_tpu_torch.serving import resilience as _serve_res
from horovod_tpu_torch.serving.resilience import (RequestJournal, Watchdog,
                                                  now_ms as _now_ms_clock)
from horovod_tpu_torch.serving.scheduler import (AdmissionError, PrefixIndex,
                                                 Request, RequestState,
                                                 Scheduler)
from horovod_tpu_torch.utils import env as _env

_NOT_PORTED = "is not ported to horovod_tpu_torch yet: ROADMAP §A item 14"


def _signature(*tensors) -> tuple:
    return tuple((tuple(t.shape), t.dtype, t.device) for t in tensors)


class Engine:
    """Continuous-batching LM serving engine.

    ``config``/``params``: the LM's config and the port's
    :class:`~horovod_tpu_torch.models.transformer.Transformer` holding its
    weights (``init_params``, or ``from_flax_params`` loaded into one), on
    ``device`` — the GPU unless the caller passes ``device='cpu'``.
    ``block_size`` / ``max_batch`` / ``kv_dtype`` / ``prefix_cache``
    default from ``HOROVOD_SERVE_BLOCK_SIZE`` / ``HOROVOD_SERVE_MAX_BATCH``
    / ``HOROVOD_SERVE_KV_DTYPE`` / ``HOROVOD_SERVE_PREFIX_CACHE``.
    ``num_blocks`` sizes the shared pool (default: every slot's worst case)
    or ``pool_bytes`` sizes it by a byte budget, scale planes included.
    ``max_prompt_len`` bounds prompts (longer ones are rejected at submit).
    ``temperature=0`` is greedy, bit-identical to ``transformer.generate``
    at fp32/bf16 KV and equal shapes.

    Resilience (``serving/resilience.py``): ``deadline_ms`` is the default
    per-request budget (``HOROVOD_SERVE_DEADLINE_MS``); ``journal`` names a
    crash-safe request journal (``HOROVOD_SERVE_JOURNAL``) that
    :meth:`recover` replays; ``watchdog_timeout`` (seconds,
    ``HOROVOD_SERVE_WATCHDOG_TIMEOUT``, 0 = off) arms the stall watchdog.
    ``speculate``, ``draft_config`` and ``draft_params`` are validated as
    the reference validates them; ``speculate > 0``, ``draft_kv_dtype``,
    ``min_accept`` and ``prefill_group``/``decode_group`` raise
    ``NotImplementedError``.
    """

    def __init__(self, config, params, *,
                 block_size: int | None = None,
                 max_batch: int | None = None,
                 num_blocks: int | None = None,
                 pool_bytes: int | None = None,
                 kv_dtype: str | None = None,
                 prefix_cache: bool | None = None,
                 max_prompt_len: int | None = None,
                 max_queue: int = 1024,
                 temperature: float = 0.0,
                 seed: int = 0,
                 eos_id: int | None = None,
                 prefill_group: int | None = None,
                 decode_group: int | None = None,
                 speculate: int | None = None,
                 draft_config=None,
                 draft_params=None,
                 draft_kv_dtype: str | None = None,
                 deadline_ms: float | None = None,
                 journal: str | None = None,
                 watchdog_timeout: float | None = None,
                 min_accept: float | None = None,
                 device: str | torch.device = "cuda"):
        self.device = transformer._require_device(device, "Engine", "serve")
        if prefill_group is not None or decode_group is not None:
            raise NotImplementedError(
                f"prefill_group=/decode_group= (prefill and decode placed "
                f"on two subset groups) {_NOT_PORTED}. Serve on one "
                f"device.")
        if draft_kv_dtype is not None or min_accept is not None:
            raise NotImplementedError(
                f"draft_kv_dtype=/min_accept= (options of speculative "
                f"decoding) {_NOT_PORTED}. Leave them unset.")
        transformer.check_model(config, params)
        have = next(params.parameters()).device
        if have.type != self.device.type or (
                self.device.index is not None
                and have.index != self.device.index):
            raise ValueError(
                f"the model's parameters are on {have} but the engine "
                f"serves on {self.device}: build the model there "
                f"(init_params(..., device=)) or pass device=")
        self.model = params
        self.config = config
        if kv_dtype is None:
            kv_dtype = _env.serve_kv_dtype()
        self.kv_dtype = _kv.resolve_kv_dtype(kv_dtype, config.dtype)
        self._cfg = transformer.decode_config(config)._replace(
            kv_dtype=self.kv_dtype)
        self.block_size = (block_size if block_size is not None
                           else _env.serve_block_size())
        self.max_batch = (max_batch if max_batch is not None
                          else _env.serve_max_batch())
        if self.block_size < 1:
            raise ValueError(
                f"block_size must be >= 1, got {self.block_size}")
        if self.max_batch < 1:
            raise ValueError(
                f"max_batch must be >= 1, got {self.max_batch}")
        self.blocks_per_seq = -(-self._cfg.max_seq_len // self.block_size)
        self.view_len = self.blocks_per_seq * self.block_size
        if pool_bytes is not None:
            if num_blocks is not None:
                raise ValueError(
                    "pass num_blocks or pool_bytes, not both — they are "
                    "two ways of sizing the same pool")
            num_blocks = _kv.num_blocks_for_bytes(
                self._cfg, self.block_size, self.kv_dtype, pool_bytes)
        elif num_blocks is None:
            # No-scarcity default: every slot can hold a max-length
            # sequence. Size it down to overcommit; admission control and
            # preemption keep an overcommitted pool correct.
            num_blocks = self.max_batch * self.blocks_per_seq + 1
        self.pool = _kv.BlockPool(num_blocks, self.block_size)

        if speculate is None:
            speculate = _env.serve_speculate()
        self.speculate_k = int(speculate)
        if self.speculate_k < 0:
            raise ValueError(
                f"speculate must be >= 0 (0 disables speculation), got "
                f"{speculate}")
        if self.speculate_k:
            raise NotImplementedError(
                f"speculate={self.speculate_k} (speculative decoding: the "
                f"draft_propose/verify_step pair and truncate rollback) "
                f"{_NOT_PORTED}. Use speculate=0.")
        if draft_config is not None or draft_params is not None:
            raise ValueError(
                "draft_config/draft_params were passed but speculate=0 — "
                "set speculate=k (or HOROVOD_SERVE_SPECULATE) to enable "
                "speculative decoding; a silently ignored draft model "
                "would serve without the speedup it was configured for")

        if prefix_cache is None:
            prefix_cache = _env.serve_prefix_cache()
        self.prefix_index = PrefixIndex(self.pool) if prefix_cache else None
        self.scheduler = Scheduler(
            self.pool, self.max_batch, max_queue,
            prefix_index=self.prefix_index, headroom_tokens=0,
            seq_cap=self._cfg.max_seq_len,
            prefill_rate=self._measured_prefill_rate)
        self.max_prompt_len = (max_prompt_len if max_prompt_len is not None
                               else self._cfg.max_seq_len)
        if not 1 <= self.max_prompt_len <= self._cfg.max_seq_len:
            raise ValueError(
                f"max_prompt_len must be in [1, max_seq_len="
                f"{self._cfg.max_seq_len}], got {self.max_prompt_len}")
        self.temperature = float(temperature)
        self.seed = int(seed)
        self.eos_id = eos_id

        # Device state: the paged pools, updated in place — (k, v) raw
        # pages, or (k, v, k_scale, v_scale) for the quantized formats.
        self._pools = _kv.make_kv_pools(self._cfg, num_blocks,
                                        self.block_size, self.kv_dtype,
                                        device=self.device)

        # Host state: fixed-shape numpy mirrors of the batch slots.
        mb = self.max_batch
        self._slots: list[Request | None] = [None] * mb
        self._tables = np.zeros((mb, self.blocks_per_seq), np.int64)
        self._lengths = np.zeros((mb,), np.int64)
        self._plens = np.zeros((mb,), np.int64)
        self._skips = np.zeros((mb,), np.int64)
        self._prompts = np.zeros((mb, self.max_prompt_len), np.int64)
        self._last_tok = np.zeros((mb,), np.int64)
        self._seeds = np.zeros((mb,), np.int64)

        self._next_id = 0
        self._decode_sigs: set[tuple] = set()
        self._prefill_sigs: set[tuple] = set()
        self.stats = {"steps": 0, "prefill_calls": 0, "decode_calls": 0,
                      "tokens_generated": 0, "preemptions": 0,
                      "finished": 0, "rejected": 0,
                      "prefill_tokens": 0, "prefix_hit_tokens": 0,
                      "prefill_steps": 0,
                      "deadline_missed": 0, "shed_rejected": 0,
                      "recovered": 0}

        # -- resilience state (serving/resilience.py) ------------------
        self.default_deadline_ms = (float(deadline_ms)
                                    if deadline_ms is not None
                                    else _env.serve_deadline_ms())
        if (self.default_deadline_ms is not None
                and not self.default_deadline_ms > 0):
            raise ValueError(
                f"deadline_ms must be > 0, got {self.default_deadline_ms}")
        self.watchdog = Watchdog(
            watchdog_timeout if watchdog_timeout is not None
            else _env.serve_watchdog_timeout())
        self._shedding = False          # pool-pressure load-shed latch
        self._pressure_window: deque[int] = deque(maxlen=16)
        self._prefill_time_s = 0.0      # wall inside _call_prefill
        self._now_ms = _now_ms_clock()  # step-boundary deadline clock
        journal_path = (journal if journal is not None
                        else _env.serve_journal_path())
        self.journal = (RequestJournal(journal_path, self.fingerprint())
                        if journal_path else None)

    # ------------------------------------------------------------------
    # the two forwards
    # ------------------------------------------------------------------

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.tensor(a, device=self.device)

    def _forward(self, tables, lengths, toks, active,
                 sigs: set) -> torch.Tensor:
        """One token for every slot: gather views → the model's decode step
        → scatter the fresh K/V into the pools (inactive rows land in the
        null block). Adds the signature of what the decode step is handed
        to ``sigs``. Returns (B, V) fp32 logits."""
        nl, b, lv = self._cfg.num_layers, tables.shape[0], self.view_len
        views = [p[:, tables].reshape(nl, b, lv, *p.shape[3:])
                 for p in self._pools]
        kv_views = [tuple(v[layer] for v in views) for layer in range(nl)]
        toks, positions = toks[:, None], lengths[:, None]
        sigs.add(_signature(toks, positions, *kv_views[0]))
        logits, fresh = self.model.decode(
            toks, positions=positions, kv_views=kv_views,
            kv_dtype=self.kv_dtype)
        self._scatter(tables, lengths, active, fresh)
        return logits[:, 0]

    def _scatter(self, tables, lengths, active, fresh) -> None:
        """Write each row's fresh K/V (and scales) into the pools in place,
        at ``(tables[row, len // bs], len % bs)``; inactive rows write to
        the null block."""
        bs, b = self.block_size, tables.shape[0]
        col = torch.clamp(lengths // bs, max=tables.shape[1] - 1)
        bi = tables[torch.arange(b, device=tables.device), col]
        bi = torch.where(active, bi, _kv.NULL_BLOCK)
        off = lengths % bs
        for p, s in zip(self._pools, fresh):
            p[:, bi, off] = s

    def _sample(self, logits, positions, seeds) -> torch.Tensor:
        """Next token per row: greedy at temperature 0, else keyed by
        (engine seed, request seed, position)."""
        return transformer.sample_tokens(logits, self.temperature, self.seed,
                                         seeds, positions)

    @torch.no_grad()
    def _call_decode(self, mask: np.ndarray) -> np.ndarray:
        args = (self._dev(self._tables), self._dev(self._lengths),
                self._dev(self._last_tok), self._dev(mask),
                self._dev(self._seeds))
        tables, lengths, toks, active, seeds = args
        logits = self._forward(tables, lengths, toks, active,
                               self._decode_sigs)
        return self._sample(logits, lengths, seeds).cpu().numpy()

    @torch.no_grad()
    def _call_prefill(self, admit_mask: np.ndarray):
        """Ingest the admitted rows' prompts: one-token forwards over the
        window ``[t0, t1)`` — from the earliest position an admitted row
        needs (its shared-prefix span ends at ``skips``, but the last
        prompt position always runs, for the first token's logits) to the
        end of the longest prompt. Positions inside a row's shared span are
        not written: those pages are already in the pool. Returns the first
        sampled token per row and the window's length."""
        args = (self._dev(self._tables), self._dev(self._prompts),
                self._dev(self._plens), self._dev(self._skips),
                self._dev(admit_mask), self._dev(self._seeds))
        tables, prompts, plens, skips, admit, seeds = args
        rows = np.flatnonzero(admit_mask)
        t1 = int(self._plens[rows].max())
        t0 = min(int(np.minimum(self._skips[rows],
                                self._plens[rows] - 1).min()), t1)
        mb, vocab = self.max_batch, self._cfg.vocab_size
        last = torch.zeros((mb, vocab), dtype=torch.float32,
                           device=self.device)
        for t in range(t0, t1):
            active = admit & (t >= skips) & (t < plens)
            logits = self._forward(
                tables, torch.full((mb,), t, device=self.device),
                prompts[:, t], active, self._prefill_sigs)
            if (self._plens[rows] - 1 == t).any():
                done = admit & (plens - 1 == t)
                last = torch.where(done[:, None], logits, last)
        first = self._sample(last, plens - 1, seeds)
        return first.cpu().numpy(), t1 - t0

    # ------------------------------------------------------------------
    # request lifecycle
    # ------------------------------------------------------------------

    def fingerprint(self) -> dict:
        """The engine identity a journal is only replayable against
        (``serving/resilience.py`` FINGERPRINT_FIELDS)."""
        return {"block_size": self.block_size,
                "kv_dtype": self.kv_dtype,
                "temperature": self.temperature,
                "seed": self.seed,
                "speculate_k": self.speculate_k}

    def _measured_prefill_rate(self) -> float:
        """Measured prefill throughput (tokens/ms) for the scheduler's
        deadline-feasibility gate; 0.0 before any prefill ran (no
        evidence, no refusal)."""
        if self._prefill_time_s <= 0.0:
            return 0.0
        return self.stats["prefill_tokens"] / (self._prefill_time_s * 1e3)

    def submit(self, prompt, max_new_tokens: int, *, tenant: str = "default",
               sample_seed: int | None = None,
               deadline_ms: float | None = None) -> Request:
        """Queue a generation request. Raises :class:`AdmissionError` when
        the bounded queue is full, the engine is shedding load, or the
        request can never be served. ``deadline_ms`` is a relative budget
        in milliseconds (default: the engine's; 0 or negative opts out):
        past it the request is evicted at the next step boundary with
        whatever it produced."""
        if self._shedding:
            self.stats["shed_rejected"] += 1
            self.stats["rejected"] += 1
            raise AdmissionError(
                "engine is shedding load: sustained pool pressure has "
                "been preempting live work every step — retry later, or "
                "grow num_blocks/pool_bytes (docs/troubleshooting.md)")
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        plen = prompt.shape[0]
        if plen < 1:
            raise ValueError("prompt must carry at least one token")
        if max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {max_new_tokens}")
        if plen > self.max_prompt_len:
            self._reject(
                f"prompt ({plen} tokens) exceeds max_prompt_len="
                f"{self.max_prompt_len} — raise it (engine rebuild) or "
                f"truncate the prompt")
        total = plen + max_new_tokens
        if total > self._cfg.max_seq_len:
            self._reject(
                f"prompt ({plen}) + max_new_tokens ({max_new_tokens}) "
                f"exceeds max_seq_len ({self._cfg.max_seq_len}) — the KV "
                f"capacity bound transformer.generate enforces too")
        need_blocks = self.pool.blocks_for(total)
        if need_blocks > self.pool.capacity:
            self._reject(
                f"request needs {need_blocks} blocks but "
                f"the pool holds {self.pool.capacity}: it can NEVER be "
                f"admitted — grow num_blocks or shrink the request")
        budget = (float(deadline_ms) if deadline_ms is not None
                  else self.default_deadline_ms)
        if budget is not None and budget <= 0:
            budget = None  # explicit opt-out of the engine default
        now = _now_ms_clock()
        req = Request(
            request_id=self._next_id, tenant=tenant, prompt=prompt,
            max_new_tokens=int(max_new_tokens), orig_prompt=prompt.copy(),
            sample_seed=(self._next_id if sample_seed is None
                         else int(sample_seed)),
            deadline_ms=(now + budget if budget is not None else None),
            budget_ms=budget)
        self._next_id += 1
        try:
            self.scheduler.submit(req)
        except AdmissionError:
            self.stats["rejected"] += 1
            raise
        if self.journal is not None:
            # Admissions are flushed at once (one fsync per submit): an
            # admitted-then-crashed request must replay.
            self.journal.record_admit(
                req.request_id, prompt, tenant=tenant,
                seed=req.sample_seed, max_new=int(max_new_tokens),
                deadline_ms=req.deadline_ms, budget_ms=budget, t=now)
            self.journal.flush(t=now)
        return req

    def _reject(self, msg: str) -> None:
        """Every rejection path counts into stats['rejected']."""
        self.stats["rejected"] += 1
        raise AdmissionError(msg)

    # -- internal slot bookkeeping ----------------------------------------

    def _active_slots(self) -> list[int]:
        return [i for i, r in enumerate(self._slots) if r is not None]

    def _install(self, req: Request, slot: int) -> None:
        req.slot = slot
        self._slots[slot] = req
        self._tables[slot] = _kv.padded_table(req.blocks,
                                              self.blocks_per_seq)
        self._lengths[slot] = 0
        self._plens[slot] = req.prompt_len
        self._skips[slot] = req.skip_tokens
        self._prompts[slot] = 0
        self._prompts[slot, :req.prompt_len] = req.prompt
        self._seeds[slot] = req.sample_seed
        self._last_tok[slot] = 0

    def _clear_slot(self, slot: int) -> None:
        self._slots[slot] = None
        self._tables[slot] = _kv.NULL_BLOCK
        self._lengths[slot] = 0
        self._plens[slot] = 0
        self._skips[slot] = 0

    def _finish(self, req: Request, tl) -> None:
        req.state = RequestState.FINISHED
        req.finished_at = time.monotonic()
        self.scheduler.release(req)
        self._clear_slot(req.slot)
        req.slot = None
        self.stats["finished"] += 1
        if self.journal is not None:
            self.journal.record_finish(req.request_id, len(req.output),
                                       t=self._now_ms)
        tl.event("serving", "EVICT", "X")

    def _record_token(self, req: Request, token: int, tl) -> bool:
        """Append a generated token; True when the request just finished
        (max_new reached or EOS sampled)."""
        if self.journal is not None:
            self.journal.record_emit(req.request_id, len(req.output),
                                     int(token))
        req.output.append(int(token))
        self._last_tok[req.slot] = token
        self.stats["tokens_generated"] += 1
        done = (len(req.output) >= req.max_new_tokens
                or (self.eos_id is not None and int(token) == self.eos_id))
        if done:
            self._finish(req, tl)
        return done

    def _preempt(self, victim: Request, tl) -> None:
        """Recompute-preemption: release the victim's blocks and requeue it
        front-of-line with prompt := prompt + generated-so-far, so
        re-admission rebuilds its KV (identical values per kv_dtype — same
        positions, same weights, deterministic quantization) and the
        continuation picks up where it stopped."""
        self.scheduler.release(victim)
        self._clear_slot(victim.slot)
        victim.prompt = np.concatenate(
            [victim.orig_prompt, np.asarray(victim.output, np.int32)])
        self.scheduler.requeue_front(victim)
        self.stats["preemptions"] += 1
        tl.event("serving", "EVICT", "X")

    def _ensure_block(self, req: Request, tl) -> bool:
        """Guarantee the block backing cache position ``lengths[slot]``
        exists before the step's write. May evict index-only cached pages,
        then preempt newest-admitted requests (recompute policy); returns
        False when ``req`` itself was preempted and must skip this
        step."""
        slot = req.slot
        need = min(self.pool.blocks_for(int(self._lengths[slot]) + 1),
                   self.blocks_per_seq)
        while len(req.blocks) < need:
            got = self.pool.alloc(1)
            if got is None and self.prefix_index is not None:
                # Cached prefix pages nobody references are the cheapest
                # memory to reclaim — before preempting live work.
                if self.prefix_index.evict(1):
                    got = self.pool.alloc(1)
            if got is not None:
                req.blocks.extend(got)
                self._tables[slot] = _kv.padded_table(req.blocks,
                                                      self.blocks_per_seq)
                continue
            # Preempt the newest admission whose resumed prompt still fits
            # the prompt buffer — the least sunk work, and recomputable.
            victims = [r for r in self._slots
                       if r is not None
                       and len(r.orig_prompt) + len(r.output)
                       <= self.max_prompt_len]
            if not victims:
                raise HorovodError(
                    "block pool exhausted and no running request is "
                    "preemptable (resumed prompts would exceed "
                    "max_prompt_len) — grow num_blocks or max_prompt_len")
            victim = max(victims, key=lambda r: r.admitted_seq)
            self._preempt(victim, tl)
            if victim is req:
                return False
        return True

    # ------------------------------------------------------------------
    # resilience: fault injection, deadlines, degradation
    # ------------------------------------------------------------------

    def _maybe_serve_faults(self, step_idx: int, tl) -> None:
        """Serving fault injection (``HOROVOD_FAULT_INJECT``,
        ``core/resilience.py``): ``engine_crash@step`` exits hard (exit 43;
        the journal is deliberately not flushed — the previous step
        boundary's fsync is what recovery replays); ``stuck_decode@step[,
        ms=M]`` ages an open watchdog stamp and judges it, so the
        conviction is immediate, never a real hang; ``deadline_storm@step``
        force-expires every deadline-carrying request."""
        inj = _res.injector()
        f = inj.serve_fault_due("engine_crash", step_idx)
        if f is not None:
            print(f"HOROVOD_FAULT_INJECT: simulating engine crash at "
                  f"serving step {step_idx} ({f.describe()}); exiting "
                  f"{_res.CRASH_EXIT_CODE}.", flush=True)
            os._exit(_res.CRASH_EXIT_CODE)
        f = inj.serve_fault_due("stuck_decode", step_idx)
        if f is not None:
            timeout = (self.watchdog.timeout
                       if self.watchdog.timeout > 0 else 1.0)
            age = f.attrs.get("ms", int(timeout * 2000)) / 1000.0
            self.watchdog.stamp("DECODE", step_idx)
            self.watchdog.backdate(age)
            self.watchdog.check(timeout=timeout)
        f = inj.serve_fault_due("deadline_storm", step_idx)
        if f is not None:
            expired = self._now_ms - 1.0
            for req in self._slots:
                if req is not None and req.deadline_ms is not None:
                    req.deadline_ms = expired
            for req in self.scheduler.pending_requests():
                if req.deadline_ms is not None:
                    req.deadline_ms = expired

    def _evict_expired(self, tl) -> list[Request]:
        """Step-boundary deadline eviction of running requests: pages
        released, slot cleared, ``DEADLINE`` tick, journal evict record."""
        evicted: list[Request] = []
        for slot in range(self.max_batch):
            req = self._slots[slot]
            if req is None or not _proto.deadline_expired(
                    self._now_ms, req.deadline_ms):
                continue
            req.deadline_missed = True
            req.state = RequestState.FINISHED
            req.finished_at = time.monotonic()
            self.scheduler.release(req)
            self._clear_slot(slot)
            req.slot = None
            self.stats["deadline_missed"] += 1
            if self.journal is not None:
                self.journal.record_evict(req.request_id, "deadline",
                                          t=self._now_ms)
            tl.event("serving", "DEADLINE", "X")
            evicted.append(req)
        return evicted

    def _drain_deadline_dropped(self, tl) -> list[Request]:
        """Queued requests the admission gate refused for deadline reasons:
        accounted and journaled here, as observable as an eviction."""
        dropped = self.scheduler.deadline_dropped
        if not dropped:
            return []
        self.scheduler.deadline_dropped = []
        for req in dropped:
            self.stats["deadline_missed"] += 1
            if self.journal is not None:
                self.journal.record_evict(req.request_id, "deadline",
                                          t=self._now_ms)
            tl.event("serving", "DEADLINE", "X")
        return dropped

    def _update_shed_latch(self, preempted: int, tl) -> None:
        """Load shedding under sustained pool pressure: while recent steps
        keep preempting live work, ``submit`` refuses with a retryable
        error until a full pressure window passes clean."""
        self._pressure_window.append(preempted)
        if not self._shedding and _serve_res.pool_pressure_high(
                self._pressure_window):
            self._shedding = True
            tl.event("serving", "SHED", "X")
        elif self._shedding and sum(self._pressure_window) == 0:
            self._shedding = False

    # ------------------------------------------------------------------
    # the step loop
    # ------------------------------------------------------------------

    def step(self) -> list[Request]:
        """One continuous-batching step: admit and prefill new requests,
        decode one token for every running one. Returns the requests that
        finished during this step — deadline-evicted ones included (check
        ``Request.deadline_missed``)."""
        tl = _timeline.session()
        step_idx = self.stats["steps"]
        self._maybe_serve_faults(step_idx, tl)
        finished: list[Request] = []
        self.stats["steps"] += 1
        self._now_ms = _now_ms_clock()
        preempt_before = self.stats["preemptions"]

        # 0. Deadline pass: evict expired running requests before
        #    admission spends pool blocks on newcomers.
        finished.extend(self._evict_expired(tl))

        # 1. Admission at the step boundary: fill free slots from the
        #    tenant-fair queue.
        free = [i for i, r in enumerate(self._slots) if r is None]
        admitted = self.scheduler.admit(len(free), now_ms=self._now_ms)
        finished.extend(self._drain_deadline_dropped(tl))
        if admitted:
            admit_mask = np.zeros((self.max_batch,), np.bool_)
            for req in admitted:
                slot = free.pop(0)
                self._install(req, slot)
                admit_mask[slot] = True
                self.stats["prefill_tokens"] += (req.prompt_len
                                                 - req.skip_tokens)
                self.stats["prefix_hit_tokens"] += req.skip_tokens
                tl.event("serving", "ADMIT", "X")
            tl.start_activity("serving", "PREFILL")
            self.watchdog.stamp("PREFILL", step_idx)
            t0 = time.monotonic()
            first, nsteps = self._call_prefill(admit_mask)
            self._prefill_time_s += time.monotonic() - t0
            self.watchdog.clear()
            tl.end_activity("serving", "PREFILL")
            self.stats["prefill_calls"] += 1
            self.stats["prefill_steps"] += int(nsteps)
            for req in admitted:
                slot = req.slot
                self._lengths[slot] = req.prompt_len
                # The prompt's full blocks are now valid pool pages:
                # index them so identical future prefixes share.
                self.scheduler.note_prefilled(req)
                if self._record_token(req, int(first[slot]), tl):
                    finished.append(req)

        # 2. One decode token for every running request. Block guarantees
        #    run first for ALL slots; preemption may clear slots mid-loop,
        #    so the stepped set is whatever survives.
        if self._active_slots():
            for slot in range(self.max_batch):
                req = self._slots[slot]
                if req is None:
                    continue  # free, or preempted by an earlier iteration
                self._ensure_block(req, tl)
            stepped = [r for r in self._slots if r is not None]
            if stepped:
                mask = np.zeros((self.max_batch,), np.bool_)
                for req in stepped:
                    mask[req.slot] = True
                tl.start_activity("serving", "DECODE")
                self.watchdog.stamp("DECODE", step_idx)
                nxt = self._call_decode(mask)
                self.watchdog.clear()
                tl.end_activity("serving", "DECODE")
                self.stats["decode_calls"] += 1
                for req in stepped:
                    slot = req.slot
                    self._lengths[slot] += 1
                    if self._record_token(req, int(nxt[slot]), tl):
                        finished.append(req)

        # 3. Step-boundary bookkeeping: the pressure window (load-shed
        #    latch) and ONE journal flush — the step's durability point.
        self._update_shed_latch(
            self.stats["preemptions"] - preempt_before, tl)
        if self.journal is not None:
            self.journal.flush(t=self._now_ms)
        return finished

    # ------------------------------------------------------------------
    # convenience drivers
    # ------------------------------------------------------------------

    def has_work(self) -> bool:
        return bool(self._active_slots()) or self.scheduler.has_pending()

    def run_until_idle(self, max_steps: int = 100_000) -> list[Request]:
        """Step until every submitted request finished; returns them in
        completion order."""
        done: list[Request] = []
        steps = 0
        while self.has_work():
            done.extend(self.step())
            steps += 1
            if steps > max_steps:
                raise HorovodError(
                    f"run_until_idle exceeded {max_steps} steps with work "
                    f"still pending — scheduling livelock? "
                    f"(stats: {self.stats})")
        return done

    def generate_batch(self, prompts, max_new_tokens: int,
                       tenant: str = "default") -> list[np.ndarray]:
        """Submit-and-drain: each request's full sequence (prompt +
        generated) in submit order — the layout ``transformer.generate``
        returns."""
        reqs = [self.submit(p, max_new_tokens, tenant=tenant)
                for p in prompts]
        self.run_until_idle()
        return [r.full_sequence() for r in reqs]

    # ------------------------------------------------------------------
    # crash recovery
    # ------------------------------------------------------------------

    def recover(self, journal: str | None = None) -> list[Request]:
        """Replay a crash-safe request journal: every admitted request that
        neither finished nor was evicted is resubmitted through the
        recompute-preemption path — ``prompt := original + committed
        tokens`` with its original request id and sampling seed — so every
        continuation is bit-identical to the uninterrupted run. The torn
        tail is dropped, never replayed; a journal whose engine
        fingerprint differs from this engine's is refused. Returns the
        resumed requests in admission order (``RECOVER`` tick each)."""
        path = journal if journal is not None else (
            self.journal.path if self.journal is not None else None)
        if path is None:
            raise HorovodError(
                "recover() needs a journal: pass journal= or construct "
                "the engine with one (HOROVOD_SERVE_JOURNAL)")
        header, records, committed, _torn = _serve_res.load_journal(path)
        theirs = header.get("engine", {})
        mine = self.fingerprint()
        for field in _serve_res.FINGERPRINT_FIELDS:
            if theirs.get(field) != mine[field]:
                raise HorovodError(
                    f"{path}: journal fingerprint mismatch — {field} was "
                    f"{theirs.get(field)!r} at write time but this engine "
                    f"has {mine[field]!r}; a replay could not be "
                    f"bit-identical, refusing")
        tl = _timeline.session()
        now = _now_ms_clock()
        resumed: list[Request] = []
        for item in _serve_res.replay_plan(records, committed):
            rid = item["rid"]
            orig = np.asarray(item["prompt"], np.int32)
            toks = list(item["committed"])
            prompt = np.concatenate([orig, np.asarray(toks, np.int32)])
            if prompt.shape[0] > self.max_prompt_len:
                raise HorovodError(
                    f"journal request {rid}: resumed prompt "
                    f"({prompt.shape[0]} tokens) exceeds max_prompt_len="
                    f"{self.max_prompt_len} — it cannot be recomputed; "
                    f"grow max_prompt_len on the recovering engine")
            budget = item["budget_ms"]
            req = Request(
                request_id=rid, tenant=item["tenant"], prompt=prompt,
                max_new_tokens=item["max_new"], orig_prompt=orig,
                sample_seed=item["seed"],
                deadline_ms=(now + budget if budget is not None else None),
                budget_ms=budget)
            req.output.extend(toks)
            self._next_id = max(self._next_id, rid + 1)
            self.scheduler.submit(req)
            if self.journal is not None:
                self.journal.record_recover(rid, len(toks), t=now)
            tl.event("serving", "RECOVER", "X")
            self.stats["recovered"] += 1
            resumed.append(req)
        if self.journal is not None:
            self.journal.flush(t=now)
        return resumed

    # ------------------------------------------------------------------
    # observability
    # ------------------------------------------------------------------

    def cache_stats(self) -> dict:
        """Pool-level accounting: occupancy, the internal fragmentation of
        the live sequences (shared pages counted once), prefix-cache pages,
        and the kv_dtype's bytes per token (scale planes included)."""
        self.pool.check_invariants()
        active = self._active_slots()
        lengths = [int(self._lengths[i]) for i in active]
        tables = [self._tables[i] for i in active]
        return {
            "num_blocks": self.pool.num_blocks,
            "block_size": self.block_size,
            "kv_dtype": self.kv_dtype,
            "kv_cache_bytes_per_token": _kv.kv_bytes_per_token(
                self._cfg, self.kv_dtype),
            "blocks_used": self.pool.num_used,
            "blocks_free": self.pool.num_free,
            "blocks_shared": self.pool.num_shared,
            "prefix_cached_blocks": (len(self.prefix_index.blocks())
                                     if self.prefix_index else 0),
            "prefix_index_hits": (self.prefix_index.hits
                                  if self.prefix_index else 0),
            "prefix_index_misses": (self.prefix_index.misses
                                    if self.prefix_index else 0),
            "utilization": round(self.pool.utilization(), 4),
            "internal_frag_tokens":
                self.pool.internal_fragmentation(lengths, tables),
            "active_requests": len(lengths),
            "queued_requests": self.scheduler.queued,
            "speculate_k": self.speculate_k,
            "draft_kv_dtype": None,
            "spec_accept_rate": None,
            "spec_disabled": False,
            "shedding": self._shedding,
        }

    @property
    def decode_trace_count(self) -> int:
        """Distinct signatures of the tensors the decode forward handed the
        model's decode step — 1 for the engine's whole life is the
        fixed-shape contract (0 before the first decode)."""
        return len(self._decode_sigs)

    @property
    def prefill_trace_count(self) -> int:
        """Distinct signatures of the tensors the prefill loop handed the
        model's decode step — 1 for the engine's whole life (0 before the
        first admission)."""
        return len(self._prefill_sigs)

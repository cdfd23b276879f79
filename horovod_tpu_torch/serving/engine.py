"""Continuous-batching generation engine over the paged KV cache.

Counterpart of ``horovod_tpu/serving/engine.py``. The reference jits its
forwards once as fixed-shape executables; the port captures each once as a
CUDA graph (``utils/graphs.py``) and replays it, at shapes that never change
with the batch's composition:

* **prefill** — one one-token forward at position ``t``, held in a 0-d
  device tensor that the graph advances. The host replays it over the data
  window ``[min(skip, plen - 1), max(plen))`` of the newly admitted rows
  (the earliest position any of them needs, to the end of the longest
  prompt), as the reference's ``while_loop`` runs it. Inactive rows, and
  admitted rows inside a shared prefix span, write their fresh K/V to the
  null block; the last prompt position's logits give each row its first
  token (a second, small graph samples them).
* **decode** — one token for every slot: gather each slot's paged view
  through its block table, run the model's decode step (the attend
  :func:`~horovod_tpu_torch.models.transformer.generate` runs, so greedy
  tokens are bit-identical to it at equal shapes), scatter the fresh K/V
  into the pools in place at ``(tables[row, len // bs], len % bs)``
  (``index_put_``), sample.

Speculative decoding (``speculate=k`` > 0, ``HOROVOD_SERVE_SPECULATE``)
swaps decode for a draft-and-verify pair: the engine then captures the
target's prefill and **verify** and the draft's **draft prefill** and
**draft propose**, four graphs for its life (decode is never captured):

* **draft propose** — the draft model (its own pools, mirroring the
  target's allocator; int4 pages by default) proposes k tokens a slot:
  k + 1 one-token forwards, unrolled in one graph, over a view gathered
  once and carried (each forward writes its fresh K/V into it), then one
  pool scatter. Forward 0 re-ingests the token at position L - 1 (the
  draft's pool runs one write behind the target's after a full accept).
* **verify** — the target scores all k + 1 positions (the last token and
  the k proposals) in one ``(B, k + 1)`` forward, its causal visibility
  keeping each position blind to the ones after it. The host accepts
  proposals while they equal the target's own choice (the same keyed
  sampler) and emits the target's choice at the first mismatch, so the
  stream is the target's sequential stream: greedy speculation equals
  ``generate``, sampled speculation the plain engine. The rejected tail
  rolls back through ``BlockPool.truncate``; a windowed accept rate below
  ``min_accept`` latches speculation off (verify with horizon 0, no draft),
  on the same graphs.

The host keeps fixed-shape numpy mirrors of the batch slots (tables,
lengths, tokens, masks, prompts) as views of one pinned staging buffer;
before a forward one ``copy_(non_blocking=True)`` moves them into the
static device buffers the graphs read, and after it one copy brings back
the sampled tokens. The pools are allocated once and updated in place by
every replay. On the card a capture that fails raises
:class:`~horovod_tpu_torch.core.state.HorovodError`; the engine never
serves eagerly. On the CPU there is no graph: the same bodies run eagerly.
:attr:`Engine.decode_trace_count` and its siblings count captures on the
card and, on the CPU, the distinct signatures (shape, dtype, device) of
the tensors each forward handed the model's decode step — the counterpart
of the reference's trace counts. Each stays at 1 across composition churn.

``kv_dtype`` selects the pool format at construction (fp32/bf16 raw pages,
int8_block/int4 payloads plus bf16 scale planes — ``serving/kv_cache.py``).
The scheduler (``serving/scheduler.py``) owns admission, fairness and prefix
matching; the block pool owns memory; ``serving/resilience.py`` owns
deadlines, the watchdog and the journal. Timeline: PREFILL/DECODE/DRAFT/
VERIFY spans and ADMIT/EVICT/ROLLBACK/DEGRADE ticks on a ``serving`` row
(``core/timeline.py``).

Sampling at ``temperature > 0`` is Gumbel-max over a counter hash keyed by
(engine seed, request seed, position)
(:func:`~horovod_tpu_torch.models.transformer.sample_tokens`): deterministic,
independent of the batch composition and stable under recompute, but not
the reference's ``jax.random`` stream (ROADMAP §C). Greedy is ``argmax``.

``speculate=None`` resolves as the reference's does:
``HOROVOD_SERVE_SPECULATE`` when set, else an applied tuned config's value
(``tune/apply.py``), else 0.

**The prefill/decode split** (``prefill_group=p, decode_group=d``). The
reference's one process places prefill on the lead device of group ``p``
and decode on the lead device of group ``d``, moving the whole pools
between them. Here a process is a rank with one device, so the split
spans two processes, and every rank of the world builds the engine with
the same arguments (the pair's process group is made by the whole
world, ``ops/topology.py::pair_group``):

* the group-local rank 0 of ``d`` is the **decode rank**. It owns the
  scheduler, the allocator and its block ids, the prefix index, the
  journal and the draft; ``submit``, ``step``, ``generate_batch``,
  ``recover`` and finally :meth:`Engine.close` run there, and it captures
  ``decode`` (with speculation ``verify``, ``draft`` and
  ``draft_prefill``: the draft's prefill stays on the decode rank, as the
  reference's does);
* the group-local rank 0 of ``p`` is the **prefill rank**. It holds a copy
  of the model and of the target's pools, and :meth:`Engine.serve_prefill`
  answers the decode rank's admissions until :meth:`Engine.close` ends the
  session (a decode rank that dies without closing leaves it blocked
  until the process group's timeout); it captures ``prefill`` and
  ``first``;
* any other rank is **idle**: it builds no pools, staging buffer or
  scheduler, and every serving call raises there. Where one
  rank leads both groups it serves unsplit (role ``serve``) and moves
  nothing, as the reference's ``device_put`` to the same device moves
  nothing.

Each admission, the decode rank sends a header (the window ``[t0, t1)``
and two page counts), the staging buffer's prefill segments (``tables``,
``seeds``, ``plens``, ``skips``, ``admit``, ``prompts``) with the block
ids of the pages it ships and of the pages the prefill will write, and
the pages an admitted row's attention reads (``[0, skip)``) that the
prefill rank's copy does not hold — every plane, payload and scale
planes, byte for byte (``kv_cache.pack_pages``). The prefill rank replays
its ``prefill`` graph over the window and its ``first`` graph, and sends
back the first tokens and the pages it wrote. The decode rank tracks
which pages the prefill rank's copy holds as its own: a page the prefill
wrote or was sent is held; a page the decode rank writes (decode, verify)
is held no more. A page shared through the prefix index was written by a
prefill, so it is held; the rule ships what is stale, never more. Each
step of an admission is one ``ops/wire.py::pair_transfer``, one direction
a call (the request's tensors posted together, then the reply), matched
by the peer at the same step, between graph replays.
"""

from __future__ import annotations

import os
import time
from collections import Counter, deque

import numpy as np
import torch

from horovod_tpu_torch.analysis import protocol as _proto
from horovod_tpu_torch.core import resilience as _res
from horovod_tpu_torch.core import timeline as _timeline
from horovod_tpu_torch.core.state import HorovodError
from horovod_tpu_torch.models import transformer
from horovod_tpu_torch.ops import wire as _wire
from horovod_tpu_torch.serving import kv_cache as _kv
from horovod_tpu_torch.serving import resilience as _serve_res
from horovod_tpu_torch.serving.resilience import (RequestJournal, Watchdog,
                                                  now_ms as _now_ms_clock)
from horovod_tpu_torch.serving.scheduler import (AdmissionError, PrefixIndex,
                                                 Request, RequestState,
                                                 Scheduler)
from horovod_tpu_torch.utils import env as _env
from horovod_tpu_torch.utils import graphs as _graphs

# The split's header: (command, t0, t1, pages shipped, pages written,
# unused...). Commands:
_HEADER = 8
_PREFILL, _CLOSE = 1, 2
# The staging buffer's segments the prefill rank reads, in their order on
# the wire (``t`` travels in the header).
_SPLIT_SEGMENTS = ("tables", "seeds", "plens", "skips", "admit", "prompts")

_CAPTURE_RULES = (
    "A captured forward must not synchronise with the host (.item(), a "
    "copy to the host) or copy from pageable host memory; the engine "
    "stages its inputs through pinned memory and never serves eagerly on "
    "the card.")


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

    ``speculate=k`` (default ``HOROVOD_SERVE_SPECULATE``, 0 = off) turns on
    draft-and-verify speculative decoding: ``draft_config`` /
    ``draft_params`` name the draft model (same vocabulary, a
    :class:`~horovod_tpu_torch.models.transformer.Transformer` on the
    engine's device; omit both for self-speculation, the target drafting
    for itself) and ``draft_kv_dtype`` its pool format (default
    ``HOROVOD_SERVE_DRAFT_KV_DTYPE``, unset = ``int4``). The emitted
    tokens are the non-speculative engine's at every temperature.

    ``prefill_group``/``decode_group`` (set together or not at all) split
    the two phases over the lead ranks of two subset groups (the module's
    docstring): :attr:`role` is ``"decode"``, ``"prefill"``, ``"idle"``,
    or ``"serve"`` for an engine that serves unsplit; :attr:`prefill_rank`
    and :attr:`decode_rank` are the two lead ranks (None unsplit).

    Resilience (``serving/resilience.py``): ``deadline_ms`` is the default
    per-request budget (``HOROVOD_SERVE_DEADLINE_MS``); ``journal`` names a
    crash-safe request journal (``HOROVOD_SERVE_JOURNAL``) that
    :meth:`recover` replays; ``watchdog_timeout`` (seconds,
    ``HOROVOD_SERVE_WATCHDOG_TIMEOUT``, 0 = off) arms the stall watchdog;
    ``min_accept`` (``HOROVOD_SERVE_MIN_ACCEPT``, 0 = off) turns
    speculation off when the windowed accept rate falls below it (the
    tokens do not change).
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
        self.role, self.prefill_rank, self.decode_rank = \
            self._resolve_groups(prefill_group, decode_group)
        transformer.check_model(config, params)
        self._check_device(params, "model")
        self.model = params
        self.config = config
        if self.role == "idle":
            # No part in serving: no pools, staging buffer or scheduler.
            return
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

        # Speculative decoding: resolve k and the draft model before the
        # scheduler, whose admission headroom depends on k.
        if speculate is None:
            # env > tuned > default: override() is None unless a tuned
            # config is active and the env leaves the knob unset.
            from horovod_tpu_torch.tune import apply as _tune_apply

            tuned = _tune_apply.override("HOROVOD_SERVE_SPECULATE")
            speculate = (int(tuned) if tuned is not None
                         else _env.serve_speculate())
        self.speculate_k = int(speculate)
        if self.speculate_k < 0:
            raise ValueError(
                f"speculate must be >= 0 (0 disables speculation), got "
                f"{speculate}")
        if self.speculate_k == 0 and (draft_config is not None
                                      or draft_params is not None):
            raise ValueError(
                "draft_config/draft_params were passed but speculate=0 — "
                "set speculate=k (or HOROVOD_SERVE_SPECULATE) to enable "
                "speculative decoding; a silently ignored draft model "
                "would serve without the speedup it was configured for")
        self.draft_kv_dtype = None
        self._draft_cfg = None
        self._draft = None
        if self.speculate_k:
            if (draft_config is None) != (draft_params is None):
                raise ValueError(
                    "draft_config and draft_params must be passed "
                    "together (a config without weights, or weights "
                    "without their shape story, cannot draft)")
            if draft_config is None:
                # Self-speculation: the target drafts for itself.
                draft_config, draft_params = config, params
            if draft_config.vocab_size != config.vocab_size:
                raise ValueError(
                    f"draft vocab_size ({draft_config.vocab_size}) must "
                    f"match the target's ({config.vocab_size}) — "
                    f"proposals are target token ids")
            transformer.check_model(draft_config, draft_params)
            self._check_device(draft_params, "draft model")
            if draft_kv_dtype is None:
                draft_kv_dtype = _env.serve_draft_kv_dtype()
            if draft_kv_dtype is None:
                draft_kv_dtype = "int4"
            self.draft_kv_dtype = _kv.resolve_kv_dtype(
                draft_kv_dtype, draft_config.dtype)
            # The draft serves the target's positions and block tables:
            # align its sequence capacity with the target's.
            self._draft_cfg = transformer.decode_config(
                draft_config)._replace(kv_dtype=self.draft_kv_dtype,
                                       max_seq_len=self._cfg.max_seq_len)
            self._draft = draft_params

        if prefix_cache is None:
            prefix_cache = _env.serve_prefix_cache()
        self.prefix_index = PrefixIndex(self.pool) if prefix_cache else None
        self.scheduler = Scheduler(
            self.pool, self.max_batch, max_queue,
            prefix_index=self.prefix_index,
            headroom_tokens=(self.speculate_k + 1 if self.speculate_k
                             else 0),
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

        # Device state: the paged pools, allocated once and updated in
        # place — (k, v) raw pages, or (k, v, k_scale, v_scale) for the
        # quantized formats. The draft's pools mirror the target's
        # allocator: same block ids, same tables, their own pages.
        self._pools = _kv.make_kv_pools(self._cfg, num_blocks,
                                        self.block_size, self.kv_dtype,
                                        device=self.device)
        self._draft_pools = None
        if self.speculate_k and self.role != "prefill":
            self._draft_pools = _kv.make_kv_pools(
                self._draft_cfg, num_blocks, self.block_size,
                self.draft_kv_dtype, device=self.device)
        self._pool_ptrs = [p.data_ptr() for p in self._all_pools()]

        # Host state: fixed-shape numpy mirrors of the batch slots, views
        # of one staging buffer (pinned on the card) whose device twin
        # holds the static inputs every forward reads.
        self._slots: list[Request | None] = [None] * self.max_batch
        self._stage_host, self._stage_dev, self._stage_end = self._staging()
        self._d = self._views(self._stage_dev)  # by segment name
        for name, view in self._views(self._stage_host).items():
            setattr(self, f"_{name}", view.numpy())  # self._tables, ...

        # Static device buffers the forwards write and read across calls:
        # the last prompt position's logits (prefill), the draft's
        # proposals (read by verify).
        mb, vocab = self.max_batch, self._cfg.vocab_size
        self._last = torch.zeros((mb, vocab), dtype=torch.float32,
                                 device=self.device)
        self._props = (torch.zeros((mb, self.speculate_k), dtype=torch.long,
                                   device=self.device)
                       if self.speculate_k else None)

        # The forwards: each a body reading the static buffers, captured
        # once on the card into one graph pool, on one side stream.
        self._bodies = {"decode": self._decode_body,
                        "prefill": self._prefill_body,
                        "first": self._first_body}
        if self.speculate_k and self.role != "prefill":
            self._bodies.update(verify=self._verify_body,
                                draft=self._draft_body,
                                draft_prefill=self._draft_prefill_body)
        self._graphs: dict[str, _graphs.Graph] = {}
        self._captures: Counter = Counter()  # graphs captured, by forward
        self._replays: Counter = Counter()   # graph replays, by forward
        self._graph_pool = None
        self._stream = None
        if self.device.type == "cuda":
            self._graph_pool = torch.cuda.graph_pool_handle()
            self._stream = torch.cuda.Stream(self.device)

        self._next_id = 0
        self._decode_sigs: set[tuple] = set()
        self._prefill_sigs: set[tuple] = set()
        self._verify_sigs: set[tuple] = set()
        self._draft_sigs: set[tuple] = set()
        self._draft_prefill_sigs: set[tuple] = set()
        self.stats = {"steps": 0, "prefill_calls": 0, "decode_calls": 0,
                      "tokens_generated": 0, "preemptions": 0,
                      "finished": 0, "rejected": 0,
                      "prefill_tokens": 0, "prefix_hit_tokens": 0,
                      "prefill_steps": 0,
                      "draft_calls": 0, "verify_calls": 0,
                      "spec_proposed": 0, "spec_accepted": 0,
                      "spec_rollback_tokens": 0, "draft_time_s": 0.0,
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
        self.min_accept = (float(min_accept) if min_accept is not None
                           else _env.serve_min_accept())
        if not 0.0 <= self.min_accept <= 1.0:
            raise ValueError(
                f"min_accept must be in [0, 1], got {self.min_accept}")
        self._spec_disabled = False     # accept-rate collapse latch
        self._accept_window: deque[float] = deque(maxlen=32)
        self._shedding = False          # pool-pressure load-shed latch
        self._pressure_window: deque[int] = deque(maxlen=16)
        self._prefill_time_s = 0.0      # wall inside _call_prefill
        self._now_ms = _now_ms_clock()  # step-boundary deadline clock
        journal_path = (journal if journal is not None
                        else _env.serve_journal_path())
        # The decode rank owns the journal; the prefill rank never opens it.
        self.journal = (RequestJournal(journal_path, self.fingerprint())
                        if journal_path and self.role in ("serve", "decode")
                        else None)

        # -- the split (the module's docstring) --------------------------
        self._link = None
        self._closed = False
        self._page_bytes = _kv.page_bytes(self._pools)
        # Block ids whose page the prefill rank's copy holds as this
        # rank's pool does: nothing is assumed of a fresh peer.
        self._remote_valid: set[int] = set()
        self.split_stats = {"admissions": 0, "pages_shipped": 0,
                            "pages_written": 0, "bytes_sent": 0,
                            "bytes_received": 0}
        if self.role in ("prefill", "decode"):
            self._link = _WireLink(self)

    def _resolve_groups(self, prefill_group, decode_group):
        """``(role, prefill rank, decode rank)``: the lead (group-local
        rank 0) of each group, and what this rank does."""
        if prefill_group is None and decode_group is None:
            return "serve", None, None
        if prefill_group is None or decode_group is None:
            raise ValueError(
                "prefill_group and decode_group must be set together "
                "(the split maps the two phases onto two subset groups).")
        from horovod_tpu_torch.core import state as _state

        prank = _state.get_group(prefill_group).ranks[0]
        drank = _state.get_group(decode_group).ranks[0]
        me = _state.global_rank()
        if prank == drank:
            return ("serve" if me == prank else "idle"), prank, drank
        # Made by every rank of the world, in one order: new_group is a
        # call of the whole world.
        from horovod_tpu_torch.ops import topology as _topology

        _topology.pair_group(prank, drank)
        role = ("prefill" if me == prank
                else "decode" if me == drank else "idle")
        return role, prank, drank

    def _require_role(self, what: str, *roles: str) -> None:
        if self.role in roles:
            return
        if self.role == "prefill":
            raise HorovodError(
                f"serving: {what} runs on the decode rank "
                f"({self.decode_rank}); this is the split's prefill rank "
                f"({self.prefill_rank}), which answers the decode rank's "
                f"admissions in Engine.serve_prefill()")
        if self.role == "decode":
            raise HorovodError(
                f"serving: {what} runs on the split's prefill rank "
                f"({self.prefill_rank}); this is its decode rank "
                f"({self.decode_rank})")
        raise HorovodError(
            f"serving: {what}: this rank leads neither the prefill group "
            f"(rank {self.prefill_rank}) nor the decode group (rank "
            f"{self.decode_rank}), so it takes no part in serving")

    def _check_device(self, model, what: str) -> None:
        have = next(model.parameters()).device
        if have.type != self.device.type or (
                self.device.index is not None
                and have.index != self.device.index):
            raise ValueError(
                f"the {what}'s parameters are on {have} but the engine "
                f"serves on {self.device}: build the model there "
                f"(init_params(..., device=)) or pass device=")

    def _all_pools(self) -> tuple:
        return tuple(self._pools) + tuple(self._draft_pools or ())

    # ------------------------------------------------------------------
    # static inputs: the staging buffer
    # ------------------------------------------------------------------

    def _segments(self) -> list:
        """The staging buffer's int64 segments, in order: what decode (and
        a speculative step) reads first, through ``horizon``; prefill
        copies the whole buffer."""
        mb = self.max_batch
        return [("tables", (mb, self.blocks_per_seq)), ("seeds", (mb,)),
                ("lengths", (mb,)), ("last_tok", (mb,)),
                ("prev_tok", (mb,)), ("mask", (mb,)), ("horizon", (mb,)),
                ("plens", (mb,)), ("skips", (mb,)), ("admit", (mb,)),
                ("t", ()), ("draft_t", ()),
                ("prompts", (mb, self.max_prompt_len))]

    def _staging(self):
        total, ends = 0, {}
        for name, shape in self._segments():
            total += int(np.prod(shape, dtype=np.int64))
            ends[name] = total
        host = torch.zeros((total,), dtype=torch.long,
                           pin_memory=self.device.type == "cuda")
        return host, torch.zeros_like(host, device=self.device), ends

    def _views(self, buf) -> dict:
        out, start = {}, 0
        for name, shape in self._segments():
            n = int(np.prod(shape, dtype=np.int64))
            out[name] = buf[start:start + n].view(shape)
            start += n
        return out

    def _stage(self, upto: str) -> None:
        """Copy the host mirrors, up to the end of segment ``upto``, into
        the static device inputs (one copy, asynchronous from pinned
        memory; each step reads its tokens back before the host writes the
        mirrors again)."""
        n = self._stage_end[upto]
        self._stage_dev[:n].copy_(self._stage_host[:n], non_blocking=True)

    # ------------------------------------------------------------------
    # the forwards' bodies: what each graph captures
    # ------------------------------------------------------------------

    def _forward(self, tables, lengths, toks, active, sigs: set,
                 draft: bool = False) -> torch.Tensor:
        """One token for every slot: gather views → the (target or draft)
        model's decode step → scatter the fresh K/V into its pools
        (inactive rows land in the null block). Adds the signature of what
        the decode step is handed to ``sigs``. Returns (B, V) fp32
        logits."""
        model, pools, kvd, nl = (
            (self._draft, self._draft_pools, self.draft_kv_dtype,
             self._draft_cfg.num_layers) if draft
            else (self.model, self._pools, self.kv_dtype,
                  self._cfg.num_layers))
        b, lv = tables.shape[0], self.view_len
        views = [p[:, tables].reshape(nl, b, lv, *p.shape[3:])
                 for p in pools]
        kv_views = [tuple(v[layer] for v in views) for layer in range(nl)]
        toks, positions = toks[:, None], lengths[:, None]
        sigs.add(_signature(toks, positions, *kv_views[0]))
        logits, fresh = model.decode(toks, positions=positions,
                                     kv_views=kv_views, kv_dtype=kvd)
        if draft:
            self._scatter(tables, lengths, active, fresh, pools=pools)
        else:
            self._scatter(tables, lengths, active, fresh)
        return logits[:, 0]

    def _scatter(self, tables, lengths, active, fresh, pools=None) -> None:
        """Write each row's fresh K/V (and scales) into the pools (the
        target's unless ``pools``) in place, at ``(tables[row, len // bs],
        len % bs)``; inactive rows write to the null block."""
        self._scatter_window(self._pools if pools is None else pools,
                             tables, lengths[:, None], active[:, None],
                             [f.unsqueeze(2) for f in fresh])

    def _scatter_window(self, pools, tables, posw, actw, fresh) -> None:
        """The (B, W) form of :meth:`_scatter`: every window position's
        fresh K/V (planes shaped (layers, B, W, ...)) at ``(tables[row,
        pos // bs], pos % bs)``, masked positions to the null block."""
        bs = self.block_size
        col = torch.clamp(posw // bs, 0, tables.shape[1] - 1)
        bi = tables.gather(1, col).masked_fill(~actw, _kv.NULL_BLOCK)
        off = posw % bs
        for p, s in zip(pools, fresh):
            p[:, bi, off] = s

    def _sample(self, logits, positions, seeds) -> torch.Tensor:
        """Next token per row: greedy at temperature 0, else keyed by
        (engine seed, request seed, position). ``positions`` and ``seeds``
        are tensors (a Python int would be a pageable host copy, which a
        capture refuses)."""
        return transformer.sample_tokens(logits, self.temperature, self.seed,
                                         seeds, positions)

    def _decode_body(self) -> torch.Tensor:
        """decode: the next token of every slot, (B,)."""
        d = self._d
        logits = self._forward(d["tables"], d["lengths"], d["last_tok"],
                               d["mask"] != 0, self._decode_sigs)
        return self._sample(logits, d["lengths"], d["seeds"])

    def _prompt_step(self, t, sigs: set, draft: bool) -> torch.Tensor:
        """One prefill position ``t`` (a 0-d device tensor, advanced by
        one): the admitted rows' prompt tokens at ``t`` through one
        forward, writes masked outside ``[skips, plens)``."""
        d = self._d
        mb = self.max_batch
        toks = d["prompts"].gather(1, t.expand(mb, 1))[:, 0]
        active = (d["admit"] != 0) & (t >= d["skips"]) & (t < d["plens"])
        logits = self._forward(d["tables"], t.expand(mb), toks, active, sigs,
                               draft=draft)
        t.add_(1)
        return logits

    def _prefill_body(self) -> None:
        """prefill: one prompt position; the rows whose last prompt
        position it is keep its logits in ``_last``."""
        d = self._d
        t = d["t"]
        done = (d["admit"] != 0) & (d["plens"] - 1 == t)
        logits = self._prompt_step(t, self._prefill_sigs, draft=False)
        self._last.copy_(torch.where(done[:, None], logits, self._last))

    def _first_body(self) -> torch.Tensor:
        """The first token of each admitted row from ``_last``, which is
        then cleared for the next admission."""
        d = self._d
        first = self._sample(self._last, d["plens"] - 1, d["seeds"])
        self._last.zero_()
        return first

    def _draft_prefill_body(self) -> None:
        """draft prefill: one prompt position into the draft's pools."""
        self._prompt_step(self._d["draft_t"], self._draft_prefill_sigs,
                          draft=True)

    def _verify_body(self) -> torch.Tensor:
        """verify: one (B, k + 1) target forward over the last token and
        the k proposals at positions ``lengths + i``; window positions
        past a row's ``horizon`` write to the null block. Returns the
        target's choice at each position, (B, k + 1)."""
        d = self._d
        k, nl = self.speculate_k, self._cfg.num_layers
        tables, lengths = d["tables"], d["lengths"]
        b, w, lv = tables.shape[0], k + 1, self.view_len
        iidx = torch.arange(w, device=tables.device)
        posw = lengths[:, None] + iidx[None, :]
        views = [p[:, tables].reshape(nl, b, lv, *p.shape[3:])
                 for p in self._pools]
        kv_views = [tuple(v[layer] for v in views) for layer in range(nl)]
        toks = torch.cat([d["last_tok"][:, None], self._props], 1)
        # Window positions past the view (a row near the sequence
        # capacity; past its horizon, so never read or kept) repeat the
        # row's last position inside it, token and all: every position is
        # written into the view before the one attend, and a repeat writes
        # the same K/V there, so the view keeps the decode's length.
        inside = torch.minimum(iidx[None, :], (lv - 1 - lengths)[:, None])
        toks, posv = toks.gather(1, inside), lengths[:, None] + inside
        self._verify_sigs.add(_signature(toks, posv, *kv_views[0]))
        logits, fresh = self.model.decode(toks, positions=posv,
                                          kv_views=kv_views,
                                          kv_dtype=self.kv_dtype)
        actw = (d["mask"] != 0)[:, None] & (iidx[None, :]
                                            <= d["horizon"][:, None])
        self._scatter_window(self._pools, tables, posw, actw, fresh)
        seeds = d["seeds"][:, None].expand(b, w)
        return self._sample(logits.reshape(b * w, -1), posw.reshape(-1),
                            seeds.reshape(-1)).reshape(b, w)

    def _draft_body(self) -> torch.Tensor:
        """draft propose: k + 1 one-token draft forwards over one gathered
        view carried through them (each writes its fresh K/V into it),
        then one scatter of the window into the draft's pools. Forward 0
        re-ingests ``prev_tok`` at ``lengths - 1``; forward i ≥ 1 proposes
        the token after position ``lengths + i - 1``, keyed as the target
        keys its choice there. Returns the k proposals, (B, k), also left
        in ``_props`` for verify."""
        d = self._d
        k, nl = self.speculate_k, self._draft_cfg.num_layers
        tables, lengths, seeds = d["tables"], d["lengths"], d["seeds"]
        b, lv = tables.shape[0], self.view_len
        views = [p[:, tables].reshape(nl, b, lv, *p.shape[3:])
                 for p in self._draft_pools]
        kv_views = [tuple(v[layer] for v in views) for layer in range(nl)]
        tok, raw, fresh = d["prev_tok"], [], []
        for i in range(k + 1):
            pos = lengths + (i - 1)
            # A position outside the view (an inactive row's -1, a row
            # past its horizon) is never consumed: clamp it into the view.
            # Forwards run in order, so a clamped write can only land
            # where a later, unconsumed forward reads.
            inside = pos.clamp(0, lv - 1)[:, None]
            if i == 0:
                self._draft_sigs.add(_signature(tok[:, None], inside,
                                                *kv_views[0]))
            logits, f = self._draft.decode(
                tok[:, None], positions=inside, kv_views=kv_views,
                kv_dtype=self.draft_kv_dtype)
            fresh.append(f)
            nxt = self._sample(logits[:, 0], pos, seeds)
            raw.append(nxt)
            tok = d["last_tok"] if i == 0 else nxt
        iidx = torch.arange(k + 1, device=tables.device)
        posw = lengths[:, None] + iidx[None, :] - 1
        actw = (d["mask"] != 0)[:, None] & (iidx[None, :]
                                            <= d["horizon"][:, None] + 1)
        self._scatter_window(self._draft_pools, tables, posw, actw,
                             [torch.stack(p, dim=2) for p in zip(*fresh)])
        props = torch.stack(raw[1:], dim=1)
        self._props.copy_(props)
        return props

    # ------------------------------------------------------------------
    # running a forward: eager on the CPU, a graph on the card
    # ------------------------------------------------------------------

    def _run(self, name: str):
        """Run forward ``name`` once. On the CPU its body runs. On the card
        the first call runs the body eagerly on the engine's side stream
        (the step's work, and the lazy initialisation a capture cannot do)
        and captures it into one graph in the engine's pool; every later
        call replays the graph. Returns the body's output: on the card
        the graph's static tensors, valid until the next replay."""
        body = self._bodies[name]
        if self.device.type != "cuda":
            return body()
        graph = self._graphs.get(name)
        if graph is None:
            graph = _graphs.Graph(self._stream)
            out = graph.eager(self.device, body)
            graph.capture(body, pool=self._graph_pool,
                          what=f"serving: the engine's {name} forward",
                          rules=_CAPTURE_RULES)
            self._graphs[name] = graph
            self._captures[name] += 1
            return out
        out = graph.replay(clone=False)
        self._replays[name] += 1
        if [p.data_ptr() for p in self._all_pools()] != self._pool_ptrs:
            raise HorovodError(
                f"serving: the {name} replay left the KV pools at new "
                f"addresses; the graphs write them in place and must never "
                f"see them reallocated")
        return out

    @torch.no_grad()
    def _call_decode(self, mask: np.ndarray) -> np.ndarray:
        self._mask[:] = mask
        self._stage("horizon")
        self._note_decode_writes(np.flatnonzero(mask), 0)
        return self._run("decode").cpu().numpy()

    def _note_decode_writes(self, rows, horizon) -> None:
        """Pages this rank writes at positions ``lengths .. lengths +
        horizon`` of ``rows`` (a step's decode or verify) are no longer
        held by the prefill rank's copy."""
        if not self._remote_valid:
            return
        bs, horizon = self.block_size, np.broadcast_to(horizon,
                                                       (self.max_batch,))
        for r in rows:
            first = int(self._lengths[r])
            last = min(first + int(horizon[r]), self.view_len - 1)
            for col in range(first // bs, last // bs + 1):
                self._remote_valid.discard(int(self._tables[r, col]))

    @torch.no_grad()
    def _call_prefill(self, admit_mask: np.ndarray):
        """Ingest the admitted rows' prompts: one-token forwards over the
        window ``[t0, t1)`` — from the earliest position an admitted row
        needs (its shared-prefix span ends at ``skips``, but the last
        prompt position always runs, for the first token's logits) to the
        end of the longest prompt. Positions inside a row's shared span are
        not written: those pages are already in the pool. The draft ingests
        the same window into its pools while speculation is on. Returns the
        first sampled token per row and the window's length."""
        rows = np.flatnonzero(admit_mask)
        t1 = int(self._plens[rows].max())
        t0 = min(int(np.minimum(self._skips[rows],
                                self._plens[rows] - 1).min()), t1)
        self._admit[:] = admit_mask
        self._t[...] = t0
        self._draft_t[...] = t0
        self._stage("prompts")
        if self._link is not None:
            first = self._remote_prefill(rows, t0, t1)
        else:
            for _ in range(t1 - t0):
                self._run("prefill")
            first = self._run("first").clone()
        if self.speculate_k and not self._spec_disabled:
            for _ in range(t1 - t0):
                self._run("draft_prefill")
        return first.cpu().numpy(), t1 - t0

    # ------------------------------------------------------------------
    # the split: the decode rank's request, the prefill rank's answer
    # ------------------------------------------------------------------

    def _meta_len(self, shipped: int, written: int) -> int:
        return (sum(getattr(self, f"_{n}").size for n in _SPLIT_SEGMENTS)
                + shipped + written)

    def _count_admission(self, shipped: int, written: int, sent: int,
                         received: int) -> None:
        st = self.split_stats
        st["admissions"] += 1
        st["pages_shipped"] += shipped
        st["pages_written"] += written
        st["bytes_sent"] += sent
        st["bytes_received"] += received

    def _remote_prefill(self, rows, t0: int, t1: int) -> torch.Tensor:
        """The decode rank's side of one admission: send the window, the
        prefill segments and the pages the prefill rank lacks; receive the
        first tokens (returned) and the pages it wrote into this rank's
        pools."""
        bs, mb = self.block_size, self.max_batch
        reads, writes = set(), set()
        for r in rows:
            table = self._tables[r]
            skip, plen = int(self._skips[r]), int(self._plens[r])
            reads.update(int(b) for b in table[:-(-skip // bs)])
            if plen > skip:
                writes.update(int(b) for b in table[skip // bs:-(-plen // bs)])
        reads.discard(_kv.NULL_BLOCK)
        writes.discard(_kv.NULL_BLOCK)
        shipped = sorted(reads - self._remote_valid)
        written = sorted(writes)
        header = torch.tensor([_PREFILL, t0, t1, len(shipped), len(written),
                               0, 0, 0], dtype=torch.long, device=self.device)
        meta = torch.from_numpy(np.concatenate(
            [getattr(self, f"_{n}").reshape(-1) for n in _SPLIT_SEGMENTS]
            + [np.asarray(shipped + written, np.int64)])).to(self.device)
        ids = meta[meta.numel() - len(shipped) - len(written):]
        pages = (_kv.pack_pages(self._pools, ids[:len(shipped)])
                 if shipped else None)
        reply = torch.empty((mb * 8 + len(written) * self._page_bytes,),
                            dtype=torch.uint8, device=self.device)
        self._link.request(header, meta, pages, reply)
        if written:
            _kv.unpack_pages(self._pools, ids[len(shipped):], reply[mb * 8:])
        self._remote_valid.update(shipped)
        self._remote_valid.update(written)
        self._count_admission(
            len(shipped), len(written),
            (header.numel() + meta.numel()) * 8 + (
                0 if pages is None else pages.numel()), reply.numel())
        return reply[:mb * 8].view(torch.long)

    @torch.no_grad()
    def _answer(self, header: torch.Tensor, meta: torch.Tensor,
                pages: torch.Tensor | None) -> torch.Tensor:
        """The prefill rank's side of one admission: take the segments and
        the shipped pages, replay ``prefill`` over the window and
        ``first``; returns the reply (the first tokens' bytes, then the
        written pages)."""
        _cmd, t0, t1, shipped, written = (int(v)
                                          for v in header.tolist()[:5])
        host = meta.cpu().numpy()
        off = 0
        for name in _SPLIT_SEGMENTS:
            view = getattr(self, f"_{name}")
            view[...] = host[off:off + view.size].reshape(view.shape)
            off += view.size
        if shipped:
            _kv.unpack_pages(self._pools, meta[off:off + shipped], pages)
        self._t[...] = t0
        self._stage("prompts")
        for _ in range(t1 - t0):
            self._run("prefill")
        first = self._run("first").reshape(-1).to(torch.long)
        self.stats["prefill_calls"] += 1
        self.stats["prefill_steps"] += t1 - t0
        reply = torch.cat([first.view(torch.uint8), _kv.pack_pages(
            self._pools, meta[off + shipped:off + shipped + written])])
        self._count_admission(
            shipped, written, reply.numel(),
            (header.numel() + meta.numel()) * 8 + (
                0 if pages is None else pages.numel()))
        return reply

    def serve_prefill(self) -> int:
        """The prefill rank's loop: answer the decode rank's admissions
        until it calls :meth:`close`. Returns the admissions answered."""
        self._require_role("serve_prefill", "prefill")
        return self._link.serve()

    def close(self) -> None:
        """End the split's session: on the decode rank, tell the prefill
        rank to leave :meth:`serve_prefill` (once). Elsewhere a no-op.
        ``with Engine(...) as eng:`` closes it on the way out, an
        exception's way too."""
        if self.role == "decode" and not self._closed:
            self._closed = True
            self._link.close()

    def __enter__(self) -> "Engine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


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
        self._require_role("submit", "serve", "decode")
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
        if self.speculate_k:
            # Speculative headroom: an admission (a preempted re-admission
            # too, whose prompt grew by its output) must back up to k + 1
            # write positions past its prompt.
            need_blocks = self.pool.blocks_for(
                min(total + self.speculate_k + 1, self._cfg.max_seq_len))
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
        # The token at cache position L - 1: the draft's catch-up input.
        self._prev_tok[slot] = int(req.prompt[req.prompt_len - 1])

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

    def _ensure_block(self, req: Request, tl, horizon: int = 0) -> bool:
        """Guarantee the blocks backing cache positions ``lengths[slot] ..
        lengths[slot] + horizon`` exist before the step's writes
        (``horizon=0`` is the plain one-token decode; a speculative step
        writes up to k + 1 positions). May evict index-only cached pages,
        then preempt newest-admitted requests (recompute policy); returns
        False when ``req`` itself was preempted and must skip this
        step."""
        slot = req.slot
        need = min(self.pool.blocks_for(
            int(self._lengths[slot]) + 1 + horizon), self.blocks_per_seq)
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
        self._require_role("step", "serve", "decode")
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

        # 2. One decode token (or one draft-and-verify burst) for every
        #    running request. Block guarantees run first for ALL slots;
        #    preemption may clear slots mid-loop, so the stepped set is
        #    whatever survives.
        if self._active_slots() and self.speculate_k:
            finished.extend(self._spec_decode_step(tl))
        elif self._active_slots():
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

    def _spec_decode_step(self, tl) -> list[Request]:
        """One draft-and-verify burst for every running request: the draft
        proposes k tokens a slot (one forward), the target scores all
        k + 1 positions (one forward), and the host accepts the longest
        proposal prefix matching the target's own choices — 1..k + 1
        tokens a slot a step. Rejected tails roll back through refcounted
        page truncation."""
        k = self.speculate_k
        step_idx = self.stats["steps"] - 1
        finished: list[Request] = []
        hz = 0 if self._spec_disabled else k
        for slot in range(self.max_batch):
            req = self._slots[slot]
            if req is None:
                continue  # free, or preempted by an earlier iteration
            self._ensure_block(req, tl, horizon=hz)
        stepped = [r for r in self._slots if r is not None]
        if not stepped:
            return finished
        self._mask[:] = 0
        self._horizon[:] = 0
        for req in stepped:
            self._mask[req.slot] = 1
            # Per-row speculation window: never write past the model's
            # sequence capacity (writes beyond go to the null block).
            remaining = self._cfg.max_seq_len - int(self._lengths[req.slot])
            self._horizon[req.slot] = min(hz, remaining - 1)
        horizon = self._horizon.copy()
        self._stage("horizon")
        self._note_decode_writes([r.slot for r in stepped], horizon)

        with torch.no_grad():
            if self._spec_disabled:
                # Degraded mode (accept-rate collapse): no draft, and a
                # verify with horizon 0 scores only the last token, whose
                # choice is exactly the plain decode's (same positions,
                # same keys): the tokens stay the same, nothing rolls back.
                props = np.zeros((self.max_batch, k), np.int64)
            else:
                t0 = time.monotonic()
                tl.start_activity("serving", "DRAFT")
                self.watchdog.stamp("DRAFT", step_idx)
                props = self._run("draft").cpu().numpy()  # props[:, i]: d_{i+1}
                self.watchdog.clear()
                tl.end_activity("serving", "DRAFT")
                self.stats["draft_time_s"] += time.monotonic() - t0
                self.stats["draft_calls"] += 1
            tl.start_activity("serving", "VERIFY")
            self.watchdog.stamp("VERIFY", step_idx)
            choices = self._run("verify").cpu().numpy()  # choices[:, i]: c_i
            self.watchdog.clear()
            tl.end_activity("serving", "VERIFY")
        self.stats["verify_calls"] += 1

        rejected_total = 0
        proposed_step = accepted_step = 0
        for req in stepped:
            slot = req.slot
            h = int(horizon[slot])
            last = int(self._last_tok[slot])
            # Accept while the draft's proposal equals the target's own
            # choice, d_{i+1} == c_i: the emitted c_0..c_a is then the
            # sequential target stream.
            a = 0
            while a < h and props[slot, a] == choices[slot, a]:
                a += 1
            self.stats["spec_proposed"] += h
            self.stats["spec_accepted"] += a
            proposed_step += h
            accepted_step += a
            done = False
            for i in range(a + 1):
                self._lengths[slot] += 1
                done = self._record_token(req, int(choices[slot, i]), tl)
                if done:
                    finished.append(req)
                    break
            rejected_total += h - a
            if done:
                continue  # _finish already released every block
            # The new second-to-last token (the draft's catch-up input).
            self._prev_tok[slot] = int(choices[slot, a - 1] if a >= 1
                                       else last)
            # Roll back the rejected tail: drop whole freed blocks; stale
            # entries inside kept blocks are overwritten before any attend
            # can see them (writes are sequential and the visibility mask
            # stops at the query position).
            new_len = int(self._lengths[slot])
            if len(req.blocks) > self.pool.blocks_for(new_len):
                _, cow = self.pool.truncate(req.blocks, new_len)
                if cow is not None:
                    raise HorovodError(
                        "speculative rollback forked a shared boundary "
                        "block — engine tail blocks are private by "
                        "construction; the allocator or the prefix "
                        "index violated that invariant")
                self._tables[slot] = _kv.padded_table(
                    req.blocks, self.blocks_per_seq)
        if rejected_total:
            self.stats["spec_rollback_tokens"] += rejected_total
            tl.event("serving", "ROLLBACK", "X")
        if proposed_step:
            # Accept-rate degradation latch: a windowed collapse below
            # min_accept means drafting costs more than it saves — turn
            # speculation off (DEGRADE tick). Lossless either way: only
            # the speed changes.
            self._accept_window.append(accepted_step / proposed_step)
            if (not self._spec_disabled
                    and _proto.accept_rate_collapsed(self._accept_window,
                                                     self.min_accept)):
                self._spec_disabled = True
                tl.event("serving", "DEGRADE", "X")
        return finished

    # ------------------------------------------------------------------
    # convenience drivers
    # ------------------------------------------------------------------

    def has_work(self) -> bool:
        self._require_role("has_work", "serve", "decode")
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
        self._require_role("recover", "serve", "decode")
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
            "draft_kv_dtype": self.draft_kv_dtype,
            "spec_accept_rate": self.spec_accept_rate,
            "spec_disabled": self._spec_disabled,
            "shedding": self._shedding,
        }

    def _traces(self, name: str, sigs: set) -> int:
        """Graphs captured for forward ``name`` on the card; on the CPU the
        distinct signatures it handed the model's decode step."""
        if self.device.type == "cuda":
            return self._captures[name]
        return len(sigs)

    @property
    def decode_trace_count(self) -> int:
        """Captures (the CPU: signatures) of the decode forward — 1 for the
        engine's whole life is the fixed-shape contract (0 before the first
        decode, and 0 when speculation replaces decode with verify)."""
        return self._traces("decode", self._decode_sigs)

    @property
    def prefill_trace_count(self) -> int:
        """Captures (the CPU: signatures) of the prefill forward — 1 for
        the engine's whole life (0 before the first admission)."""
        return self._traces("prefill", self._prefill_sigs)

    @property
    def verify_trace_count(self) -> int:
        """Captures (the CPU: signatures) of the speculative verify forward
        — 1 for the engine's whole life (0 with speculation off)."""
        return self._traces("verify", self._verify_sigs)

    @property
    def draft_trace_count(self) -> int:
        """Captures (the CPU: signatures) of the draft-propose forward — 1
        for the engine's whole life (0 with speculation off)."""
        return self._traces("draft", self._draft_sigs)

    @property
    def draft_prefill_trace_count(self) -> int:
        """Captures (the CPU: signatures) of the draft prefill forward — 1
        for the engine's whole life (0 with speculation off)."""
        return self._traces("draft_prefill", self._draft_prefill_sigs)

    @property
    def spec_accept_rate(self) -> float | None:
        """Fraction of draft proposals the target accepted (None before
        any speculative step, or with speculation off)."""
        proposed = self.stats["spec_proposed"]
        if not proposed:
            return None
        return self.stats["spec_accepted"] / proposed


class _WireLink:
    """One end of the split's link over the pair's process group
    (``ops/topology.py::pair_group``): every transfer is one
    ``ops/wire.py::pair_transfer``."""

    def __init__(self, engine: Engine) -> None:
        from horovod_tpu_torch.ops import topology as _topology

        self.engine = engine
        self.pg = _topology.pair_group(engine.prefill_rank,
                                       engine.decode_rank)
        self.peer = (engine.prefill_rank if engine.role == "decode"
                     else engine.decode_rank)

    def request(self, header, meta, pages, reply) -> None:
        """The decode rank: send one admission, then receive its reply."""
        sends = [header, meta] + ([] if pages is None else [pages])
        _wire.pair_transfer(sends, self.peer, self.pg, send=True)
        _wire.pair_transfer([reply], self.peer, self.pg, send=False)

    def close(self) -> None:
        header = torch.zeros((_HEADER,), dtype=torch.long,
                             device=self.engine.device)
        header[0] = _CLOSE
        _wire.pair_transfer([header], self.peer, self.pg, send=True)

    def serve(self) -> int:
        """The prefill rank: answer admissions until the close."""
        eng, served = self.engine, 0
        while True:
            header = torch.zeros((_HEADER,), dtype=torch.long,
                                 device=eng.device)
            _wire.pair_transfer([header], self.peer, self.pg, send=False)
            cmd, _t0, _t1, shipped, written = header.tolist()[:5]
            if cmd == _CLOSE:
                return served
            if cmd != _PREFILL:
                raise HorovodError(
                    f"serving: the prefill rank received command {cmd} "
                    f"from the decode rank; the split knows {_PREFILL} "
                    f"(prefill) and {_CLOSE} (close)")
            meta = torch.empty((eng._meta_len(shipped, written),),
                               dtype=torch.long, device=eng.device)
            pages = (torch.empty((shipped * eng._page_bytes,),
                                 dtype=torch.uint8, device=eng.device)
                     if shipped else None)
            _wire.pair_transfer([meta] + ([] if pages is None else [pages]),
                                self.peer, self.pg, send=False)
            reply = eng._answer(header, meta, pages)
            _wire.pair_transfer([reply], self.peer, self.pg, send=True)
            served += 1


class _LocalLink:
    """Both halves of the split in one process (one card holds one NCCL
    rank): the decode engine's request goes to the prefill engine's
    :meth:`Engine._answer` as the tensors the wire would carry, and only
    the ``torch.distributed`` call is left out."""

    def __init__(self, prefill: Engine) -> None:
        self.prefill = prefill

    def request(self, header, meta, pages, reply) -> None:
        reply.copy_(self.prefill._answer(header, meta, pages))

    def close(self) -> None:
        pass


def loopback_split(prefill: Engine, decode: Engine) -> None:
    """Make two unsplit engines of one process the split's two halves:
    ``decode`` keeps the scheduler, the journal and the draft and sends
    each admission to ``prefill``, through the same pack and unpack code
    as the two-rank split (:class:`_LocalLink`). The engines must have
    the same shapes (block size, slots, prompt bound, pool, kv_dtype)."""
    for eng in (prefill, decode):
        if eng.role != "serve":
            raise HorovodError(
                f"loopback_split pairs two unsplit engines; one has role "
                f"{eng.role!r}")
    for attr in ("block_size", "max_batch", "max_prompt_len", "kv_dtype",
                 "blocks_per_seq", "device"):
        if getattr(prefill, attr) != getattr(decode, attr):
            raise ValueError(
                f"loopback_split: the engines differ in {attr} "
                f"({getattr(prefill, attr)!r} against "
                f"{getattr(decode, attr)!r})")
    if prefill.pool.num_blocks != decode.pool.num_blocks:
        raise ValueError(
            f"loopback_split: the engines' pools differ "
            f"({prefill.pool.num_blocks} against {decode.pool.num_blocks} "
            f"blocks)")
    prefill.role, decode.role = "prefill", "decode"
    decode._link = _LocalLink(prefill)

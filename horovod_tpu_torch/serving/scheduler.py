"""Request scheduler — in-flight (continuous) batching in the Orca style.

Counterpart of ``horovod_tpu/serving/scheduler.py``, a near copy: host-side
Python and numpy, no device work.

The unit of scheduling is the ENGINE STEP, not the request: at every step
boundary the scheduler may admit queued requests into free batch slots
(they get prefilled this step), every running request advances one decode
token, and finished requests are evicted immediately — so a 5-token reply
never waits for the 500-token reply it was batched with (the continuous-
batching insight, Orca/vLLM).

Policies, deliberately simple and testable:

* **Admission control**: a request is admitted only when a batch slot is
  free AND the block pool can back its whole prompt. ``submit`` queues
  (bounded by ``max_queue``; beyond that it REJECTS with
  :class:`AdmissionError` — the open-loop load driver counts those).
  Requests that could never fit (prompt + max_new exceeds the pool or
  the model's ``max_seq_len``) are rejected at submit, not queued to
  deadlock.
* **Per-tenant fairness**: round-robin over tenants with queued work —
  one admission moves the cursor, so a flooding tenant cannot starve the
  others regardless of queue depth. Within a tenant, FIFO. No
  head-of-line bypass: if the next tenant's head request doesn't fit,
  admission stops for this step (a big request is delayed, never
  starved).
* **Preemption requeue**: when the engine must evict a running request
  to free blocks (mid-decode pool exhaustion), the request returns to
  the FRONT of its tenant's queue carrying prompt+generated-so-far, so
  re-admission recomputes its KV and continues exactly where it stopped
  (the vLLM "recompute" policy; greedy continuations are bit-identical
  — tests/test_torch_serving.py pins this).
* **Prefix sharing** (:class:`PrefixIndex`, opt-in): admissions whose
  prompt starts with token runs already cached as FULL pool blocks map
  those blocks straight into their table (refcount acquired per
  request) and skip prefilling the shared span — the radix-cache idea
  (SGLang/vLLM automatic prefix caching) on this pool's refcounts.
  Partial tail blocks are always private; eviction of cached pages
  respects refcounts (only index-held pages are reclaimable).
"""

from __future__ import annotations

import collections
import dataclasses
import enum
import time
from typing import Deque

import numpy as np

from horovod_tpu_torch.analysis import protocol as _proto
from horovod_tpu_torch.core.state import HorovodError
from horovod_tpu_torch.serving.kv_cache import NULL_BLOCK, BlockPool


class AdmissionError(HorovodError):
    """The request was rejected at submit (queue full, or it can never
    be served by this engine's pool/model capacity)."""


class RequestState(enum.Enum):
    QUEUED = "queued"
    RUNNING = "running"
    FINISHED = "finished"


@dataclasses.dataclass
class Request:
    """One generation request's full lifecycle record."""

    request_id: int
    tenant: str
    prompt: np.ndarray            # CURRENT teacher-forced prefix (int32);
                                  # grows by generated tokens on preemption
    max_new_tokens: int
    orig_prompt: np.ndarray       # the prompt as submitted (result assembly)
    sample_seed: int = 0
    state: RequestState = RequestState.QUEUED
    output: list = dataclasses.field(default_factory=list)  # generated ids
    blocks: list = dataclasses.field(default_factory=list)  # block table
    slot: int | None = None
    admitted_seq: int = -1        # admission order; preemption victims are
                                  # chosen newest-first
    submitted_at: float = 0.0
    finished_at: float = 0.0
    preemptions: int = 0
    shared_blocks: int = 0        # leading blocks of ``blocks`` mapped from
                                  # the prefix index (immutable, refcounted)
    skip_tokens: int = 0          # prompt tokens covered by those blocks —
                                  # prefill starts here, not at 0
    deadline_ms: float | None = None  # absolute deadline on the serving
                                  # monotonic clock (resilience.now_ms)
    budget_ms: float | None = None    # the original relative budget —
                                  # journaled so recovery can re-arm it
    deadline_missed: bool = False  # evicted/refused past its deadline

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])

    def full_sequence(self) -> np.ndarray:
        """Submitted prompt followed by every generated token — the same
        layout ``transformer.generate`` returns."""
        return np.concatenate(
            [self.orig_prompt, np.asarray(self.output, np.int32)])


class _PrefixNode:
    __slots__ = ("block", "children", "last_used")

    def __init__(self, block: int):
        self.block = block
        self.children: dict[tuple, _PrefixNode] = {}
        self.last_used = 0


class PrefixIndex:
    """Radix-style trie mapping full-block prompt-token runs onto pool
    blocks.

    Each edge is one block's worth of tokens (a ``block_size``-tuple);
    each node names the pool block whose pages hold the K/V of that
    token run *given the whole path above it* — cache contents depend
    only on (tokens, positions, params), and pool writes are
    deterministic per kv_dtype, so any request whose prompt walks the
    same path can attend to the same pages bit-for-bit.

    The index holds ONE pool reference per cached node (acquired at
    insert), so pages outlive the requests that wrote them — that is
    what turns a repeated system prompt into a cache hit minutes later.
    :meth:`evict` walks leaves least-recently-matched-first and frees
    only pages whose sole reference is the index's own (live requests
    pin theirs via refcount — eviction respects sharing by
    construction).
    """

    def __init__(self, pool: BlockPool):
        self.pool = pool
        self._root_children: dict[tuple, _PrefixNode] = {}
        self._clock = 0
        self.hits = 0
        self.misses = 0

    # -- internals --------------------------------------------------------

    def _keys(self, tokens):
        """The prompt's FULL-block token runs, yielded lazily (the
        partial tail block is never indexed — it stays private to its
        request). A generator so :meth:`_walk` only materializes keys
        down to the first trie miss: a blocked head-of-line request
        re-peeking every step pays for its matched depth, not for
        tuple-izing its whole prompt each time."""
        toks = np.asarray(tokens).reshape(-1)
        bs = self.pool.block_size
        for i in range(len(toks) // bs):
            yield tuple(int(t) for t in toks[i * bs:(i + 1) * bs])

    def __len__(self) -> int:
        n = 0
        stack = list(self._root_children.values())
        while stack:
            node = stack.pop()
            n += 1
            stack.extend(node.children.values())
        return n

    def blocks(self) -> set[int]:
        """Every pool block the index currently holds a reference on."""
        out = set()
        stack = list(self._root_children.values())
        while stack:
            node = stack.pop()
            out.add(node.block)
            stack.extend(node.children.values())
        return out

    # -- match / insert / evict ------------------------------------------

    def _walk(self, tokens) -> tuple[list[int], list[_PrefixNode]]:
        """Pure peek: the longest cached full-block prefix as
        ``(blocks, nodes)`` — no clocks, no counters, no references."""
        out: list[int] = []
        nodes: list[_PrefixNode] = []
        children = self._root_children
        for key in self._keys(tokens):
            node = children.get(key)
            if node is None:
                break
            out.append(node.block)
            nodes.append(node)
            children = node.children
        return out, nodes

    def _record(self, nodes: list[_PrefixNode]) -> None:
        """Commit a walk's accounting: touch the path's LRU clock and
        the hit/miss counters. Kept separate from :meth:`_walk` so the
        admission path peeks first and records ONCE, only when the
        request is actually backed — a head-of-line request retrying
        every step under a full pool must neither inflate the counters
        nor pin its path MRU (which would starve every OTHER cached
        prefix out of eviction) — and without re-walking the trie."""
        self._clock += 1
        for node in nodes:
            node.last_used = self._clock
        if nodes:
            self.hits += 1
        else:
            self.misses += 1

    def match(self, tokens, record: bool = True) -> list[int]:
        """Longest cached full-block prefix of ``tokens`` → the pool
        blocks backing it, shallowest first. ``record=False`` skips the
        LRU/hit-counter update (a pure peek). The caller must
        :meth:`BlockPool.acquire` the returned blocks before using
        them — match itself takes no references (all-or-nothing
        admission may still back out)."""
        out, nodes = self._walk(tokens)
        if record:
            self._record(nodes)
        return out

    def insert(self, tokens, blocks) -> int:
        """Index a prefilled prompt's full blocks. ``blocks`` is the
        request's block table; entry ``i`` must hold the K/V of token
        run ``i``. Walks the existing path (matched spans already point
        at these very blocks, or at an older equivalent page — the
        existing node wins either way) and acquires an index-owned
        reference on each NEWLY cached block. Returns how many nodes
        were added."""
        keys = self._keys(tokens)
        added = 0
        children = self._root_children
        for key, block in zip(keys, blocks):
            node = children.get(key)
            if node is None:
                if block == NULL_BLOCK:
                    raise HorovodError(
                        "prefix index cannot cache the null block")
                self.pool.acquire([block])
                node = _PrefixNode(int(block))
                node.last_used = self._clock
                children[key] = node
                added += 1
            children = node.children
        return added

    def reclaimable(self, protect=frozenset()) -> int:
        """How many cached pages :meth:`evict` could actually free
        right now: nodes whose block refcount is 1 (the index's own),
        not protected, and whose whole subtree also qualifies (children
        must cascade out first). Lets the admission path skip an
        eviction that cannot cover its shortfall anyway — destroying
        the cache for a doomed admission is pure thrash."""
        count = 0
        # Post-order via two stacks: children resolved before parents.
        order: list[_PrefixNode] = []
        stack = list(self._root_children.values())
        while stack:
            node = stack.pop()
            order.append(node)
            stack.extend(node.children.values())
        ok: dict[int, bool] = {}
        for node in reversed(order):
            ok[id(node)] = (node.block not in protect
                            and self.pool.refcount(node.block) == 1
                            and all(ok[id(c)]
                                    for c in node.children.values()))
            if ok[id(node)]:
                count += 1
        return count

    def evict(self, want: int, protect=frozenset()) -> int:
        """Reclaim up to ``want`` cached pages nobody else references:
        leaves whose block refcount is exactly 1 (the index's own),
        least-recently-matched first, cascading — an interior node
        becomes evictable the moment its last child goes. Blocks in
        ``protect`` (e.g. pages the current admission just matched) are
        never evicted. One trie walk total (a leaf heap ordered by
        ``last_used``, parents pushed as they become leaves — evict is
        on the pool-pressure path, where per-freed-block rescans would
        compound). Returns the number of blocks actually freed."""
        import heapq

        if want <= 0:
            return 0
        # One DFS: parent linkage + child counts for the cascade.
        info: dict[int, tuple] = {}  # id(node) -> (parent_dict, key,
                                     #              parent_node, node)
        kids: dict[int, int] = {}
        stack = [(self._root_children, k, None, n)
                 for k, n in self._root_children.items()]
        while stack:
            pdict, key, pnode, node = stack.pop()
            info[id(node)] = (pdict, key, pnode, node)
            kids[id(node)] = len(node.children)
            for k, c in node.children.items():
                stack.append((node.children, k, node, c))
        heap = [(node.last_used, nid)
                for nid, (_, _, _, node) in info.items()
                if kids[nid] == 0]
        heapq.heapify(heap)
        freed = 0
        while heap and freed < want:
            _, nid = heapq.heappop(heap)
            pdict, key, pnode, node = info[nid]
            if node.block in protect:
                continue
            if self.pool.refcount(node.block) != 1:
                continue  # a live request still attends to this page
            del pdict[key]
            self.pool.release([node.block])
            freed += 1
            if pnode is not None:
                kids[id(pnode)] -= 1
                if kids[id(pnode)] == 0:
                    heapq.heappush(heap, (pnode.last_used, id(pnode)))
        return freed


class Scheduler:
    """Tenant-fair admission over a shared :class:`BlockPool`,
    optionally with prefix sharing via a :class:`PrefixIndex`."""

    def __init__(self, pool: BlockPool, max_batch: int,
                 max_queue: int = 1024,
                 prefix_index: PrefixIndex | None = None,
                 headroom_tokens: int = 0,
                 seq_cap: int | None = None,
                 prefill_rate=None):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if max_queue < 0:
            raise ValueError(f"max_queue must be >= 0, got {max_queue}")
        if headroom_tokens < 0:
            raise ValueError(
                f"headroom_tokens must be >= 0, got {headroom_tokens}")
        self.pool = pool
        self.max_batch = max_batch
        self.max_queue = max_queue
        self.prefix_index = prefix_index
        # Speculative admission accounting (serving/engine.py): a slot
        # under speculation writes up to k+1 cache positions per step
        # (the k-token draft tail plus the carried last token), so an
        # admission must be backed for prompt_len + k + 1 tokens — not
        # just its prompt — or the very first verify step preempts
        # someone. ``seq_cap`` (the model's max_seq_len) bounds the
        # headroom: writes past the cap are masked, never backed.
        self.headroom_tokens = int(headroom_tokens)
        self.seq_cap = seq_cap
        self._queues: dict[str, Deque[Request]] = collections.OrderedDict()
        # Round-robin anchor: the NAME of the last-served tenant (tenant
        # entries persist once seen), so the rotation is stable while
        # tenants drain empty or appear mid-flight — a positional cursor
        # over the nonempty set would skip or double-serve on churn.
        self._last_tenant: str | None = None
        self._admit_seq = 0
        # Deadline admission (serving/resilience.py): ``prefill_rate``
        # is a zero-arg callable returning the engine's MEASURED prefill
        # throughput in tokens/ms (0.0 before any measurement — no
        # evidence, no refusal). Requests the gate drops land in
        # ``deadline_dropped`` for the engine to drain (DEADLINE tick,
        # journal evict record) — admission never silently loses one.
        self.prefill_rate = prefill_rate
        self.deadline_dropped: list[Request] = []

    # -- queue state ------------------------------------------------------

    @property
    def queued(self) -> int:
        return sum(len(q) for q in self._queues.values())

    def has_pending(self) -> bool:
        return any(self._queues.values())

    # -- submit / requeue -------------------------------------------------

    def submit(self, req: Request) -> Request:
        """Enqueue, or raise :class:`AdmissionError` when the bounded
        queue is full — the backpressure signal an open-loop driver
        measures as rejects."""
        if self.queued >= self.max_queue:
            raise AdmissionError(
                f"queue full ({self.queued} >= max_queue="
                f"{self.max_queue}); request {req.request_id} rejected — "
                f"shed load or raise max_queue/pool capacity")
        req.state = RequestState.QUEUED
        req.submitted_at = req.submitted_at or time.monotonic()
        self._queues.setdefault(req.tenant, collections.deque()).append(req)
        return req

    def requeue_front(self, req: Request) -> None:
        """Preemption path: back to the FRONT of its tenant's queue (it
        already waited its turn once), prompt already extended with the
        generated prefix by the engine."""
        req.state = RequestState.QUEUED
        req.slot = None
        req.preemptions += 1
        self._queues.setdefault(
            req.tenant, collections.deque()).appendleft(req)

    # -- admission --------------------------------------------------------

    def _tenant_order(self) -> list[str]:
        """Tenants with queued work, starting AFTER the last-served
        tenant in the (persistent, insertion-ordered) tenant ring."""
        names = list(self._queues)
        if not names:
            return []
        k = ((names.index(self._last_tenant) + 1) % len(names)
             if self._last_tenant in self._queues else 0)
        rotated = names[k:] + names[:k]
        return [t for t in rotated if self._queues[t]]

    def _back_blocks(self, req: Request) -> bool:
        """Build ``req.blocks`` for its whole prompt: the longest cached
        full-block prefix from the index (shared, acquired per request)
        plus fresh private blocks for the rest. All-or-nothing like the
        bare pool: on a shortfall, cached-but-unreferenced pages are
        evicted and the alloc retried once; failure claims nothing."""
        backed = req.prompt_len + self.headroom_tokens
        if self.seq_cap is not None:
            backed = min(backed, self.seq_cap)
        need_total = self.pool.blocks_for(backed)
        shared: list[int] = []
        nodes: list = []
        if self.prefix_index is not None:
            # Peek only: LRU/hit accounting is recorded below, once the
            # admission actually succeeds (a blocked head-of-line
            # request retries every step).
            shared, nodes = self.prefix_index._walk(req.prompt)
        need = need_total - len(shared)
        blocks = self.pool.alloc(need)
        if blocks is None and self.prefix_index is not None:
            # Evict cached pages only when eviction can actually cover
            # the shortfall — otherwise the admission fails either way
            # and the cache was destroyed for nothing.
            shortfall = need - self.pool.num_free
            protect = frozenset(shared)
            if self.prefix_index.reclaimable(protect) >= shortfall:
                self.prefix_index.evict(shortfall, protect=protect)
                blocks = self.pool.alloc(need)
        if blocks is None:
            return False
        if shared:
            self.pool.acquire(shared)
        if self.prefix_index is not None:
            self.prefix_index._record(nodes)  # commit the hit/LRU once
        req.blocks = shared + blocks
        req.shared_blocks = len(shared)
        req.skip_tokens = len(shared) * self.pool.block_size
        return True

    def pending_requests(self):
        """Every queued request, in tenant-ring order (deadline-storm
        injection and drain-time accounting walk these)."""
        for q in self._queues.values():
            yield from q

    def _deadline_refused(self, req: Request, now_ms: float) -> bool:
        """The deadline admission gate: an already-expired head request,
        or one whose prefill cannot finish inside its remaining budget
        at the measured prefill rate, is refused — its pages are never
        backed. Decisions are the shared protocol judgements
        (``deadline_expired`` / ``admission_feasible``), so the engine's
        step-boundary eviction and this gate can never disagree."""
        if req.deadline_ms is None:
            return False
        if not _proto.deadline_expired(now_ms, req.deadline_ms):
            rate = float(self.prefill_rate()) if self.prefill_rate else 0.0
            if _proto.admission_feasible(req.prompt_len,
                                         req.deadline_ms - now_ms, rate):
                return False
        req.state = RequestState.FINISHED
        req.deadline_missed = True
        req.finished_at = time.monotonic()
        self.deadline_dropped.append(req)
        return True

    def admit(self, free_slots: int,
              now_ms: float | None = None) -> list[Request]:
        """Admit up to ``free_slots`` requests round-robin across
        tenants, backing each one's prompt with pool blocks (shared
        prefix pages first when the index knows them). Stops at the
        first head request the pool cannot back (no bypass — see the
        module docstring). With ``now_ms`` (the engine's step-boundary
        clock), head requests that are past their deadline — or that
        could not finish prefill before it — are dropped into
        ``deadline_dropped`` instead of wasting pool pages."""
        admitted: list[Request] = []
        while free_slots > 0:
            order = self._tenant_order()
            if not order:
                break
            tenant = order[0]
            req = self._queues[tenant][0]
            if now_ms is not None and self._deadline_refused(req, now_ms):
                self._queues[tenant].popleft()
                continue  # refusal consumes no slot and moves no ring
            if not self._back_blocks(req):
                break  # pool exhausted: everyone behind waits too
            self._queues[tenant].popleft()
            req.state = RequestState.RUNNING
            req.admitted_seq = self._admit_seq
            self._admit_seq += 1
            admitted.append(req)
            free_slots -= 1
            self._last_tenant = tenant  # one admission moves the ring
        return admitted

    # -- release / indexing ----------------------------------------------

    def release(self, req: Request) -> None:
        """Drop a finished/preempted request's references. Pages the
        prefix index also holds survive (contents intact — that is the
        cache); everything else returns to the free list."""
        if req.blocks:
            self.pool.release(req.blocks)
            req.blocks = []
        req.shared_blocks = 0
        req.skip_tokens = 0

    def note_prefilled(self, req: Request) -> None:
        """Called by the engine once ``req``'s prompt K/V is fully in
        the pool: index its full-block prefix for future admissions
        (no-op without a prefix index)."""
        if self.prefix_index is not None:
            full = req.prompt_len // self.pool.block_size
            self.prefix_index.insert(req.prompt, req.blocks[:full])

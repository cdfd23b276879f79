"""Pure protocol judgements — a copy of the subset of
``horovod_tpu/analysis/protocol.py`` that the port's runtime calls and its
protocol checker (``analysis/model.py``) drives: request
validation and the store key namespace of the negotiation layer, the
comparison of two programs' collective schedules, the
fault-injection grammar (``HOROVOD_FAULT_INJECT``) with its matchers,
store error classification and the bounded-retry decision, the liveness
judgement, the checkpoint-resume agreement, the elastic shrink and
regrow plans, and the serving judgements (deadlines, the journal's
committed-token fold, stall verdicts, the speculation auto-off).

Stdlib-only and side-effect free: every function is a pure transition
(inputs in, verdict out). The port keeps its own copy rather than
importing the JAX package, whose ``__init__`` pulls in jax. The error strings
are byte-identical to the reference's (``tests/test_torch_collectives.py``
compares them with the JAX package's ``validate_py``).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Iterable, Mapping, Optional, Sequence

OP_ALLREDUCE = 0
OP_ALLGATHER = 1
OP_BROADCAST = 2
OP_GATHER = 3
OP_ALLTOALL = 4
OP_REDUCESCATTER = 5

OP_NAMES: dict[int, str] = {
    OP_ALLREDUCE: "allreduce",
    OP_ALLGATHER: "allgather",
    OP_BROADCAST: "broadcast",
    OP_GATHER: "gather",
    OP_ALLTOALL: "alltoall",
    OP_REDUCESCATTER: "reducescatter",
}
OP_BY_NAME: dict[str, int] = {v: k for k, v in OP_NAMES.items()}

# Ops whose negotiated verdict is fully determined by the validated
# metadata: replaying a cached verdict for an identical resubmission is
# sound. ALLGATHER/GATHER are excluded — their verdict carries per-rank
# first-dim sizes, which OTHER processes may legitimately change while
# this process's own metadata stays identical (core/negotiate.py).
CACHEABLE_OPS = frozenset({OP_ALLREDUCE, OP_BROADCAST,
                           OP_REDUCESCATTER, OP_ALLTOALL})

# Auto-generated collective names ("Horovod<Op>_<counter>") are fresh
# every call — a fingerprint built on one can never be hit again
# (core/negotiate.py documents the stable-name replay contract).
AUTO_NAME = re.compile(r"^Horovod[A-Za-z]+_\d+$")


@dataclasses.dataclass(frozen=True)
class Req:
    """One rank's intent to run a collective (ints for ops)."""

    rank: int
    name: str
    op: int
    dtype: str
    shape: tuple[int, ...]
    root_rank: int = -1
    group: int = 0


@dataclasses.dataclass(frozen=True)
class Verdict:
    """A validated execution plan, or an error (``error`` set)."""

    name: str = ""
    op: int = -1
    dtype: str = ""
    tensor_sizes: tuple[int, ...] = ()
    root_rank: int = -1
    error: Optional[str] = None

    def canonical(self) -> str:
        """Stable string form for cross-process agreement comparison."""
        if self.error is not None:
            return f"error:{self.error}"
        return (f"{self.name}|{self.op}|{self.dtype}|"
                f"{','.join(str(s) for s in self.tensor_sizes)}|"
                f"{self.root_rank}")


def _dims_str(shape: Sequence[int]) -> str:
    return "[" + ", ".join(str(d) for d in shape) + "]"


def validate_requests(requests: Sequence[Req], group_size: int) -> Verdict:
    """Cross-validate all ranks' requests for one tensor name: dtype match,
    op match, exact shape match for allreduce/broadcast, rank-count +
    trailing-dim match with per-rank first-dim collection for
    allgather/gather, root-rank agreement for broadcast/gather."""
    if not requests:
        return Verdict(error="No requests to validate.")
    first = requests[0]
    name = first.name
    if len(requests) != group_size:
        return Verdict(error=(
            f"Tensor {name} has {len(requests)} request(s) but the group has "
            f"{group_size} rank(s); every rank must submit the collective."))

    seen: set[int] = set()
    for r in requests:
        if r.rank in seen:
            return Verdict(error=(
                f"Tensor {name} was submitted twice by rank {r.rank}."))
        seen.add(r.rank)

    for r in requests[1:]:
        if r.dtype != first.dtype:
            return Verdict(error=(
                f"Mismatched data types: One or more ranks sent tensors of "
                f"type {first.dtype}, but one or more other ranks sent "
                f"tensors of type {r.dtype} for tensor {name}."))
        if r.op != first.op:
            return Verdict(error=(
                f"Mismatched collective operations: One or more ranks did an "
                f"{OP_NAMES[first.op]}, but one or more other ranks did an "
                f"{OP_NAMES[r.op]} on tensor {name}."))

    op = first.op
    tensor_sizes: tuple[int, ...] = ()

    if op in (OP_ALLTOALL, OP_REDUCESCATTER):
        lname = OP_NAMES[op]
        for r in requests[1:]:
            if r.shape != first.shape:
                return Verdict(error=(
                    f"Mismatched {lname} tensor shapes: One or more ranks "
                    f"sent tensors of shape {_dims_str(first.shape)}, but "
                    f"one or more other ranks sent tensors of shape "
                    f"{_dims_str(r.shape)} on tensor {name}."))
        if len(first.shape) == 0 or first.shape[0] % group_size != 0:
            return Verdict(error=(
                f"Invalid {lname} tensor shape: first dimension of tensor "
                f"{name} ({_dims_str(first.shape)}) must be divisible by "
                f"the group size {group_size}."))
    elif op in (OP_ALLREDUCE, OP_BROADCAST):
        for r in requests[1:]:
            if r.shape != first.shape:
                return Verdict(error=(
                    f"Mismatched {OP_NAMES[op]} tensor shapes: One or more "
                    f"ranks sent tensors of shape {_dims_str(first.shape)}, "
                    f"but one or more other ranks sent tensors of shape "
                    f"{_dims_str(r.shape)} on tensor {name}."))
    else:  # ALLGATHER / GATHER: trailing dims must agree, first may vary
        if len(first.shape) == 0:
            return Verdict(error=(
                f"Rank zero tried to {OP_NAMES[op]} a rank-zero tensor "
                f"{name}, which is not allowed."))
        for r in requests[1:]:
            if len(r.shape) != len(first.shape):
                return Verdict(error=(
                    f"Mismatched {OP_NAMES[op]} tensor shapes: One or more "
                    f"ranks sent tensors of rank {len(first.shape)}, but "
                    f"one or more other ranks sent tensors of rank "
                    f"{len(r.shape)} on tensor {name}."))
            if r.shape[1:] != first.shape[1:]:
                return Verdict(error=(
                    f"Mismatched {OP_NAMES[op]} tensor shapes: trailing "
                    f"dimensions of tensor {name} differ between ranks "
                    f"({_dims_str(first.shape)} vs {_dims_str(r.shape)}); "
                    f"only the first dimension may vary."))
        by_rank = sorted(requests, key=lambda r: r.rank)
        tensor_sizes = tuple(r.shape[0] for r in by_rank)

    root_rank = -1
    if op in (OP_BROADCAST, OP_GATHER):
        root_rank = first.root_rank
        for r in requests[1:]:
            if r.root_rank != first.root_rank:
                return Verdict(error=(
                    f"Mismatched {OP_NAMES[op]} root ranks: One rank "
                    f"specified root rank {first.root_rank}, but another "
                    f"rank specified root rank {r.root_rank} for tensor "
                    f"{name}."))
        if not 0 <= root_rank < group_size:
            return Verdict(error=(
                f"Invalid root rank {root_rank} for tensor {name} in a "
                f"group of size {group_size}."))

    return Verdict(name=name, op=op, dtype=first.dtype,
                   tensor_sizes=tensor_sizes, root_rank=root_rank)


# ---------------------------------------------------------------------------
# Coordinator: per-seq submission merge + verdict
# ---------------------------------------------------------------------------


def _req_from_wire(d: Mapping[str, Any]) -> Req:
    return Req(rank=int(d["rank"]), name=str(d["name"]), op=int(d["op"]),
               dtype=str(d["dtype"]),
               shape=tuple(int(s) for s in d["shape"]),
               root_rank=int(d["root_rank"]), group=int(d.get("group", 0)))


def coordinate(per_proc: Mapping[int, Mapping[str, Any]], name: str,
               seq: int, group_size: int) -> dict[str, Any]:
    """The coordinator's decision at one negotiation index, given every
    process's parsed submission ``{"name": str, "requests": [wire dicts]}``:
    cross-check that every process's i-th collective IS the same collective
    (the crisp desync error), then merge the per-rank requests and
    validate. Returns the verdict as a JSON-ready dict (``error`` set on
    failure). In the port a process is a group member and ``p`` its
    group-local rank; the group-local rank 0 coordinates."""
    for p in sorted(per_proc):
        other = str(per_proc[p]["name"])
        if other != name:
            ops = {str(per_proc[q]["name"]):
                   (per_proc[q]["requests"][0]["op"]
                    if per_proc[q]["requests"] else "?")
                   for q in (0, p)}
            return {"error": (
                f"Mismatched collective sequence across processes: at "
                f"negotiation index {seq}, process 0 submitted tensor "
                f"{name} ({ops.get(name, '?')}) while process {p} "
                f"submitted tensor {other} ({ops.get(other, '?')}). "
                f"All processes must issue the same collectives in the "
                f"same order; if auto-generated names have drifted "
                f"(e.g. one process issued an extra unnamed "
                f"collective), pass explicit name= arguments.")}
    merged: list[Req] = []
    for p in sorted(per_proc):
        for r in per_proc[p]["requests"]:
            merged.append(_req_from_wire(r))
    v = validate_requests(merged, group_size)
    if v.error is not None:
        return {"error": v.error}
    return {"name": v.name, "op": v.op, "dtype": v.dtype,
            "tensor_sizes": list(v.tensor_sizes),
            "root_rank": v.root_rank, "error": None}


# ---------------------------------------------------------------------------
# Eager verdict-cache replay: the seq-lockstep fingerprint
# ---------------------------------------------------------------------------


def replay_fingerprint(name: str, op: Optional[int], group_size: int,
                       request_ops: Sequence[int],
                       cache_enabled: bool) -> Optional[tuple[str, int, int]]:
    """The fingerprint under which a validated verdict may be replayed
    without a store round, or None when this submission must negotiate.

    Every member must decide alike, or their negotiation sequence
    counters drift apart; anything metadata-dependent here would let one
    member hit while another misses. Hence ``(name, op, group_size)``
    only."""
    if not cache_enabled or op is None or op not in CACHEABLE_OPS:
        return None
    if AUTO_NAME.match(name):
        return None
    if any(o != op for o in request_ops):
        return None
    return (name, op, group_size)


# ---------------------------------------------------------------------------
# Fault-injection grammar (HOROVOD_FAULT_INJECT)
# ---------------------------------------------------------------------------

FAULT_ATTRS: dict[str, set[str]] = {
    "kv_timeout": {"seq", "times"},
    "crash": {"rank", "step"},
    "torn_write": {"epoch"},
    # Elastic join event: previously-dropped rank(s) rejoin at the step
    # boundary S (rank omitted = every dropped rank rejoins). Not a
    # fault in the failure sense — it shares the injection grammar so
    # one deterministic spec scripts a whole shrink->continue->regrow
    # drill: "crash@rank=2,step=5;regrow@step=9".
    "regrow": {"rank", "step"},
    # Serving-engine faults: engine_crash kills the serving process at engine step S
    # (the continuous-batching twin of crash@step); stuck_decode freezes
    # the decode dispatch at step S for ms milliseconds (default: past
    # the watchdog timeout) so the Watchdog must convict it;
    # deadline_storm force-expires every in-flight deadline at step S.
    "engine_crash": {"step"},
    "stuck_decode": {"step", "ms"},
    "deadline_storm": {"step"},
}
FAULT_REQUIRED: dict[str, set[str]] = {
    "kv_timeout": {"seq"},
    "crash": {"step"},
    "torn_write": {"epoch"},
    "regrow": {"step"},
    "engine_crash": {"step"},
    "stuck_decode": {"step"},
    "deadline_storm": {"step"},
}


class Fault:
    """One parsed fault-spec entry: a kind plus integer attrs."""

    def __init__(self, kind: str, attrs: Mapping[str, int]):
        self.kind = kind
        self.attrs = dict(attrs)

    def describe(self) -> str:
        attrs = ",".join(f"{k}={v}" for k, v in sorted(self.attrs.items()))
        return f"{self.kind}@{attrs}" if attrs else self.kind

    def __repr__(self) -> str:  # test/debug readability
        return f"Fault({self.describe()})"


def parse_fault_spec(raw: Optional[str]) -> tuple[Fault, ...]:
    """Parse ``"kv_timeout@seq=3;crash@rank=1,step=5;torn_write@epoch=2"``.

    Grammar: ``entry (';' entry)*`` where ``entry := kind '@' name=int
    (',' name=int)*``. Unknown kinds/attrs and non-integer values raise
    ``ValueError`` — a typo'd injection spec must not silently run a
    fault-free drill that then "passes".
    """
    faults: list[Fault] = []
    for entry in (raw or "").split(";"):
        entry = entry.strip()
        if not entry:
            continue
        kind, _, attrstr = entry.partition("@")
        kind = kind.strip()
        if kind not in FAULT_ATTRS:
            raise ValueError(
                f"HOROVOD_FAULT_INJECT: unknown fault kind {kind!r} in "
                f"{entry!r}; valid kinds: {sorted(FAULT_ATTRS)}")
        attrs: dict[str, int] = {}
        for item in attrstr.split(","):
            item = item.strip()
            if not item:
                continue
            name, eq, val = item.partition("=")
            name = name.strip()
            if not eq or name not in FAULT_ATTRS[kind]:
                raise ValueError(
                    f"HOROVOD_FAULT_INJECT: bad attribute {item!r} for "
                    f"{kind!r}; valid attributes: "
                    f"{sorted(FAULT_ATTRS[kind])} (name=int)")
            try:
                attrs[name] = int(val)
            except ValueError:
                raise ValueError(
                    f"HOROVOD_FAULT_INJECT: attribute {name!r} must be an "
                    f"integer, got {val.strip()!r}") from None
        missing = FAULT_REQUIRED[kind] - attrs.keys()
        if missing:
            raise ValueError(
                f"HOROVOD_FAULT_INJECT: {kind!r} requires attribute(s) "
                f"{sorted(missing)} (got {entry!r})")
        faults.append(Fault(kind, attrs))
    return tuple(faults)


def kv_fault_covering(faults: Sequence[Fault], seq: int) -> Optional[str]:
    """The matching ``kv_timeout`` fault's description for KV-call counter
    ``seq``, or None. The fault covers ``seq <= s < seq + times`` (times
    default 1), so ``times`` > the retry budget exhausts it and surfaces
    the failure — the exact matcher the live ``FaultInjector`` uses."""
    for f in faults:
        if f.kind != "kv_timeout":
            continue
        start = f.attrs["seq"]
        times = f.attrs.get("times", 1)
        if start <= seq < start + times:
            return f.describe()
    return None


def crash_fault_matching(faults: Sequence[Fault], step: int,
                         ranks: Iterable[int],
                         span: int = 1) -> Optional[Fault]:
    """The matching ``crash`` fault for the steps ``step <= s < step +
    span`` and one of ``ranks``, or None (omitted rank = any process)."""
    rankset = set(ranks)
    for f in faults:
        if f.kind != "crash" or not step <= f.attrs["step"] < step + span:
            continue
        r = f.attrs.get("rank")
        if r is None or r in rankset:
            return f
    return None


def regrow_fault_matching(faults: Sequence[Fault], step: int,
                          span: int = 1) -> Optional[Fault]:
    """The matching ``regrow`` join event for the steps ``step <= s <
    step + span``, or None. The window mirrors ``crash_fault_matching``:
    a join step that is not call-aligned still fires at the covering
    call's boundary instead of silently never admitting the rank."""
    for f in faults:
        if f.kind == "regrow" and step <= f.attrs["step"] < step + span:
            return f
    return None


def serve_fault_matching(faults: Sequence[Fault], kind: str, step: int,
                         span: int = 1) -> Optional[Fault]:
    """The matching serving-engine fault of ``kind`` (``engine_crash``,
    ``stuck_decode``, or ``deadline_storm``) for the engine steps
    ``step <= s < step + span``, or None: a spec'd step the loop skips
    past still fires at the covering boundary instead of silently never
    firing."""
    for f in faults:
        if f.kind == kind and step <= f.attrs["step"] < step + span:
            return f
    return None



def torn_write_index(faults: Sequence[Fault], epoch: Optional[int],
                     consumed: Iterable[int]) -> Optional[int]:
    """Index of the first unconsumed ``torn_write`` fault matching
    ``epoch``, or None. The caller owns the consumed set (consume-once:
    a retried save of the same epoch succeeds)."""
    if epoch is None:
        return None
    done = set(consumed)
    for i, f in enumerate(faults):
        if (f.kind == "torn_write" and i not in done
                and f.attrs["epoch"] == epoch):
            return i
    return None


# ---------------------------------------------------------------------------
# Store key namespace — generation-scoped key builders
# ---------------------------------------------------------------------------

KEY_PREFIX = "hvd"


def neg_key(generation: int, group: int, seq: int, rank: int) -> str:
    """One member's request batch at one negotiation index of a group.
    (The reference keys a process's submission by ``(generation, seq,
    pid)`` over one world-wide sequence; here each group negotiates on its
    own sequence, so the group is part of the key.)"""
    return f"{KEY_PREFIX}/neg/g{generation}/grp{group}/s{seq}/p{rank}"


def verdict_key(generation: int, group: int, seq: int) -> str:
    """The coordinator's published verdict for one negotiation index of a
    group."""
    return f"{KEY_PREFIX}/resp/g{generation}/grp{group}/s{seq}"


def sched_key(generation: int, tag: str, epoch: int) -> str:
    """Base key for one compiled program's schedule validation round;
    call sites append ``/p<pid>`` and ``/verdict``."""
    return f"{KEY_PREFIX}/sched/g{generation}/{tag}/{epoch}"


def hb_key(generation: int, pid: int) -> str:
    """One process's heartbeat key (core/resilience.py)."""
    return f"{KEY_PREFIX}/hb/g{generation}/p{pid}"


def join_key(jid: int, pid: int) -> str:
    """A (re)joining process's announcement for join round ``jid``.

    Deliberately NOT generation-scoped: the joiner does not know the
    running world's generation — learning it is the point of the
    admission handshake (it reads the admit key's payload). ``jid``
    separates join rounds so a stale announcement from an earlier round
    can never be admitted twice."""
    return f"{KEY_PREFIX}/join/j{jid}/p{pid}"


def admit_key(jid: int, pid: int) -> str:
    """The coordinator's admission verdict for one joiner: carries the
    regrow plan (members, coordinator, generation) the joiner adopts.
    Generation-free like :func:`join_key` — the payload IS the
    generation handshake."""
    return f"{KEY_PREFIX}/admit/j{jid}/p{pid}"


def regrow_key(generation: int, jid: int) -> str:
    """The coordinator's published regrow plan for the OLD generation's
    members (survivors read it at the step boundary, then all bump to
    the plan's new generation together)."""
    return f"{KEY_PREFIX}/regrow/g{generation}/j{jid}"


_KEY_GEN = re.compile(r"(?:^|/)g(\d+)(?:/|$)")


def key_generation(key: str) -> Optional[int]:
    """The generation a store key is namespaced under, or None. Every
    generation-scoped key family carries a ``g<generation>`` path segment:
    post-bump processes can never consume pre-bump keys, because they
    never compute a pre-bump name."""
    m = _KEY_GEN.search(key)
    return int(m.group(1)) if m else None


# ---------------------------------------------------------------------------
# Store error classification + bounded-retry decision
# ---------------------------------------------------------------------------

# The reference's tables, for the JAX coordination service's messages.
# Order matters: a transient marker wins over the generic TIMEOUT substring
# (e.g. "UNAVAILABLE: ... connection timed out" must be retried, not treated
# as a pending poll), and fatal markers win over everything that remains.
# Each table then takes torch's store messages (TCPStore, FileStore):
# "Broken pipe" and "failed to recv" from a store whose server went away
# (transient), a FileStore whose file is gone (fatal), and the TCPStore's
# "Socket Timeout" / "wait timeout" of a key not set yet (pending; TIMEOUT
# already covers both, listed for the record).
TRANSIENT_MARKERS: tuple[str, ...] = (
    "UNAVAILABLE", "CONNECTION REFUSED", "CONNECTION RESET",
    "FAILED TO CONNECT", "SOCKET CLOSED",
    "INJECTED COORDINATION-SERVICE FAULT",
    "BROKEN PIPE", "FAILED TO RECV",
)
FATAL_MARKERS: tuple[str, ...] = (
    "CANCELLED", "SHUT DOWN", "SHUTDOWN", "HAS STOPPED",
    "FAILED_PRECONDITION", "PERMISSION_DENIED", "INVALID_ARGUMENT",
    "ALREADY_EXISTS",
    "NO SUCH FILE OR DIRECTORY",
)
PENDING_MARKERS: tuple[str, ...] = ("DEADLINE", "TIMED OUT", "TIMEOUT",
                                    "NOT FOUND", "NOT_FOUND",
                                    "SOCKET TIMEOUT", "WAIT TIMEOUT")


def classify_kv_message(message: str) -> str:
    """``"pending"`` (key not set yet — the caller's poll loop handles it),
    ``"transient"`` (service fault worth a bounded retry), or ``"fatal"``
    (service dead/shutting down, or unrecognized — never retried, so a
    dead service can never be retried forever)."""
    msg = message.upper()
    for m in TRANSIENT_MARKERS:
        if m in msg:
            return "transient"
    for m in FATAL_MARKERS:
        if m in msg:
            return "fatal"
    for m in PENDING_MARKERS:
        if m in msg:
            return "pending"
    return "fatal"


def retry_decision(kind: str, opname: str, attempt: int, retries: int,
                   message: str) -> str:
    """The pure branch of ``resilience._kv_call`` after one failed KV
    attempt: ``"duplicate_ok"`` (a RETRIED set whose earlier attempt
    actually landed — the value is there, that IS success), ``"raise"``
    (pending/fatal pass through to the caller), ``"retry"`` (transient,
    budget remains — back off and go again), or ``"exhausted"``
    (transient, budget spent — surface a bounded-retry error).
    ``attempt`` counts PREVIOUS failed attempts (0 on the first)."""
    if (kind == "fatal" and opname == "set" and attempt > 0
            and "ALREADY_EXISTS" in message.upper()):
        return "duplicate_ok"
    if kind != "transient":
        return "raise"
    if attempt + 1 > retries:
        return "exhausted"
    return "retry"


# ---------------------------------------------------------------------------
# Schedule comparison
# ---------------------------------------------------------------------------


def first_divergence(a: Sequence[object], b: Sequence[object]
                     ) -> Optional[tuple[int, object, object]]:
    """First position where two ordered collective schedules differ, or
    None when identical (used by ``validate_schedule`` and the checker)."""
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return (i, x, y)
    if len(a) != len(b):
        i = min(len(a), len(b))
        return (i, a[i] if i < len(a) else "<end>",
                b[i] if i < len(b) else "<end>")
    return None


# ---------------------------------------------------------------------------
# Checkpoint-resume agreement
# ---------------------------------------------------------------------------


def agree_epochs(per_rank: Sequence[Iterable[int]]) -> tuple[int, int]:
    """``(agreed, newest)``: the newest epoch present in EVERY rank's
    verified set (-1 if none) and the newest epoch ANY rank reported (-1
    if none). A set intersection, not a scalar min over newest: the agreed
    epoch is one every rank itself verified, never merely the smallest of
    the newest (a rank whose newest epochs are torn must not steer the
    group onto an epoch some OTHER rank can't load). Pure — every rank
    computing this over the same gathered sets gets the same answer, which
    is what makes the agreement a non-negotiated local computation."""
    sets = [set(int(e) for e in s) for s in per_rank]
    common: set[int] = set.intersection(*sets) if sets else set()
    agreed = max(common) if common else -1
    newest = max((max(s) for s in sets if s), default=-1)
    return agreed, newest

# ---------------------------------------------------------------------------
# Serving judgements
# ---------------------------------------------------------------------------


def deadline_expired(now_ms: float, deadline_ms: Optional[float]) -> bool:
    """The deadline judgement the engine applies at every step boundary
    and the scheduler at admission: a request with an
    absolute monotonic deadline is expired once ``now_ms`` reaches it.
    ``None`` = no deadline, never expires."""
    if deadline_ms is None:
        return False
    return now_ms >= deadline_ms


def admission_feasible(prompt_tokens: int, budget_ms: Optional[float],
                       prefill_tokens_per_ms: float) -> bool:
    """The scheduler's deadline admission gate: can ``prompt_tokens`` of
    prefill finish inside ``budget_ms`` at the measured prefill rate? A request that cannot make its own deadline is
    refused at submit time — pages it would pin are never backed.
    ``budget_ms`` None = no deadline; a non-positive budget is already
    expired; an unmeasured rate (<= 0) admits (no evidence to refuse)."""
    if budget_ms is None:
        return True
    if budget_ms <= 0:
        return False
    if prefill_tokens_per_ms <= 0:
        return True
    return prompt_tokens / prefill_tokens_per_ms <= budget_ms


def accept_rate_collapsed(window: Sequence[float], min_accept: float,
                          min_samples: int = 8) -> bool:
    """The speculation auto-off judgement: the rolling window of
    per-step acceptance fractions has enough samples and its mean sits
    below ``min_accept``. Pure so the engine, the tests, and the drill
    agree on when degradation triggers (min_accept <= 0 disables)."""
    if min_accept <= 0 or len(window) < min_samples:
        return False
    return sum(window) / len(window) < min_accept


def journal_committed(records: Sequence[Mapping[str, Any]],
                      *, include_torn: bool = False
                      ) -> tuple[dict[int, tuple[int, ...]], bool]:
    """Fold an ordered serve-journal record stream into the committed
    per-request token runs — the replay decision ``Engine.recover``
    (``serving/resilience.py::load_journal``) trusts.

    A ``torn`` marker (a record whose CRC or shape failed — the torn
    tail a crash mid-append leaves) ENDS the committed stream: it and
    everything after it are refused, never replayed as committed
    tokens. ``include_torn=True`` consumes the marker and keeps folding
    (the reference's deliberately broken variant, kept so the two
    folds stay identical). Returns ``(committed, used_torn)``. Malformed
    streams — duplicate or missing admissions, emits after
    finish/evict, non-monotone emit runs — raise ``ValueError`` naming
    the record index."""
    committed: dict[int, list[int]] = {}
    closed: set[int] = set()
    used_torn = False
    for i, rec in enumerate(records):
        kind = rec.get("kind")
        if kind == "torn":
            if not include_torn:
                break
            used_torn = True
            continue
        if kind in ("header", "recover"):
            continue
        if kind not in ("admit", "emit", "finish", "evict"):
            raise ValueError(
                f"record {i}: unknown journal record kind {kind!r}")
        rid = int(rec.get("rid", -1))
        if kind == "admit":
            if rid in committed:
                raise ValueError(
                    f"record {i}: duplicate admission of request {rid}")
            committed[rid] = []
            continue
        if rid not in committed:
            raise ValueError(
                f"record {i}: {kind} for request {rid} before its "
                f"admission")
        if kind == "emit":
            if rid in closed:
                raise ValueError(
                    f"record {i}: emit for request {rid} after its "
                    f"finish/evict record")
            run = committed[rid]
            start = int(rec.get("start", -1))
            if start != len(run):
                raise ValueError(
                    f"record {i}: non-monotone emit run for request "
                    f"{rid}: start={start} but {len(run)} token(s) "
                    f"committed so far")
            run.extend(int(t) for t in rec.get("tokens", ()))
        else:  # finish / evict
            closed.add(rid)
    return {rid: tuple(run) for rid, run in committed.items()}, used_torn


def liveness_probe_order(cached: Mapping[int, Optional[float]], now: float,
                         timeout: float, cap: int) -> list[int]:
    """Which heartbeat keys to freshly read this check, stalest cached
    sightings FIRST and never-seen peers last (a never-seen peer has
    startup grace and cannot be judged this call, so it must not starve
    the refresh of a judgeable peer whose stale cache would otherwise
    falsely age it into a dead verdict); a peer whose cached sighting is
    younger than half the timeout needs no refresh yet. At most ``cap``
    keys — the caller's stall is bounded, never the set of peers judged."""
    probe = [p for p, t in cached.items()
             if t is None or now - t > timeout / 2]
    probe.sort(key=lambda p: (cached[p] is None, cached[p] or 0.0))
    return probe[:cap]


def judge_dead(cached: Mapping[int, Optional[float]], now: float,
               timeout: float) -> list[tuple[int, float]]:
    """``(pid, age)`` for every peer whose last cached heartbeat is older
    than ``timeout`` (the serving watchdog judges its one open dispatch
    as peer 0). A peer that has NEVER heartbeat is given startup
    grace (None sightings are skipped — the caller's own timeout bounds
    that wait)."""
    dead: list[tuple[int, float]] = []
    for p, t_pub in sorted(cached.items()):
        if t_pub is None:
            continue
        age = now - t_pub
        if age > timeout:
            dead.append((p, age))
    return dead


# ---------------------------------------------------------------------------
# Elastic transitions: shrink -> continue -> regrow
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShrinkPlan:
    """The survivors' agreed continuation after a liveness fatal: who
    remains, who coordinates, and the fresh KV generation. Every survivor
    computes this from the same inputs (the member list and the liveness
    verdict's dead set), so agreement needs no extra negotiation round."""

    survivors: tuple[int, ...]
    coordinator: int
    generation: int


def plan_shrink(members: Sequence[int], dead: Iterable[int],
                generation: int) -> ShrinkPlan:
    """Deterministic shrink transition: drop the dead processes, elect the
    lowest surviving pid as coordinator, bump the generation (fresh KV /
    heartbeat namespace — pre-crash keys become unreachable by
    construction). Raises ``ValueError`` when no process survives (there
    is no world to continue)."""
    deadset = set(dead)
    survivors = tuple(p for p in members if p not in deadset)
    if not survivors:
        raise ValueError(
            "Shrink has no survivors: every member of the world is dead.")
    return ShrinkPlan(survivors=survivors, coordinator=min(survivors),
                      generation=generation + 1)


@dataclasses.dataclass(frozen=True)
class RegrowPlan:
    """The mirror of :class:`ShrinkPlan`: the agreed continuation after
    admitting joiner(s) at a step boundary. Deterministic from (current
    members, announced joiners, generation), so every member computes
    the identical plan; the joiner receives it through the admission
    handshake."""

    members: tuple[int, ...]
    joined: tuple[int, ...]
    coordinator: int
    generation: int


def plan_regrow(members: Sequence[int], joiners: Iterable[int],
                generation: int) -> RegrowPlan:
    """Deterministic regrow transition: admit ``joiners`` into
    ``members``, re-elect the lowest member as coordinator, and bump the
    generation (the joiners must never see — and by key construction
    cannot see — the pre-admission KV namespace). Raises ``ValueError`` on
    an empty join set or a joiner that is already a member (admitting a
    live rank twice would double its contribution to every subsequent
    collective)."""
    joinset = tuple(sorted(set(joiners)))
    if not joinset:
        raise ValueError("Regrow has no joiners: nothing to admit.")
    overlap = sorted(set(members) & set(joinset))
    if overlap:
        raise ValueError(
            f"Regrow joiners {overlap} are already members of the world; "
            f"a rank cannot be admitted twice.")
    new_members = tuple(sorted(set(members) | set(joinset)))
    return RegrowPlan(members=new_members, joined=joinset,
                      coordinator=min(new_members),
                      generation=generation + 1)

"""Pure protocol judgements — a copy of the subset of
``horovod_tpu/analysis/protocol.py`` that the port's runtime calls: request
validation and the store key namespace of the negotiation layer, the
comparison of two programs' collective schedules, the
fault-injection grammar (``HOROVOD_FAULT_INJECT``) with its torn-write
matcher, the checkpoint-resume agreement, and the serving judgements
(deadlines, the journal's committed-token fold, stall verdicts, the
speculation auto-off).

Stdlib-only and side-effect free: every function is a pure transition
(inputs in, verdict out). The port keeps its own copy rather than
importing the JAX package, whose ``__init__`` pulls in jax. The error strings
are byte-identical to the reference's (``tests/test_torch_collectives.py``
compares them with the JAX package's ``validate_py``).
"""

from __future__ import annotations

import dataclasses
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
    fault-free drill that then "passes". The port injects the serving
    kinds and ``torn_write`` (``core/resilience.py``); the others parse as
    the reference parses them, and ``hvd.init`` refuses them
    (``utils/env.py::check_unported``).
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

"""hvd-model: exhaustive-interleaving model checker for the port's
negotiation protocol — ``horovod_tpu/analysis/model.py``, copied and aimed
at the port (``core/negotiate.py``).

The checker builds a small-world transition system of N simulated processes
— an in-model key-value store, per-process negotiation state, disks,
crashes — and explores EVERY interleaving of their enabled transitions
(DFS over a canonically-hashed state graph, with a simple partial-order
reduction that collapses commuting per-process-local steps). The
*decisions* inside every transition are the protocol functions the live
runtime executes (:mod:`horovod_tpu_torch.analysis.protocol`): request
validation and the desync text (``coordinate``/``validate_requests``),
the verdict-replay fingerprint (``replay_fingerprint``), the group- and
generation-scoped keys (``neg_key``/``verdict_key``), store error
classification and the bounded retry (``classify_kv_message``/
``retry_decision``), the liveness judgement (``judge_dead``), the
agreed-epoch intersection (``agree_epochs``), the elastic plans
(``plan_shrink``/``plan_regrow``) and the journal fold
(``journal_committed``).

The protocol is the port's, where it differs from the reference's on
purpose (ROADMAP §C):

* each group negotiates on its own sequence, coordinated by its
  group-local rank 0; a process that is not a member of a collective's
  group never takes part in its rounds (the reference's memberless
  processes submit an empty request list on one world-wide sequence);
* a member's batch lies under ``neg_key(generation, group, seq, rank)``
  (the coordinator holds its own batch and writes no key), the verdict
  under ``verdict_key(generation, group, seq)``;
* a round submits a batch of requests (a ``("batch", (Collective, ...))``
  step: one fusion bucket a request), validated request by request;
* a batch replays its cached verdict, with no store call and no new
  index, when every request has a fingerprint and the tuple of them
  validated before, in a cache per group that a generation move drops;
  the generation starts at 0, as the negotiator's.

What the model abstracts: the store is an atomic map; unbounded waits are
blocked transitions, so a wait that can never complete is a DEADLOCK state;
time does not advance — liveness judgements use symbolic ages through the
real ``judge_dead``; every transition that touches a round is one abstract
store tick (fault matching counts these); the restore agreement's
transport is a barrier of per-process keys.

Invariants, reported as HVD2xx findings with a minimal counterexample
trace (see :data:`horovod_tpu_torch.analysis.report.RULES`):

* **HVD201 agreement** — all members commit the same verdict (and the
  same agreed epoch / shrink and regrow plan) for each negotiation.
* **HVD202 no-deadlock** — every non-terminal global state has an
  enabled transition.
* **HVD203 progress under transient faults** — kv_timeouts within the
  retry budget can neither wedge the sweep nor fail a process.
* **HVD204 crash-safe restore** — the agreed epoch is loadable by every
  surviving rank; torn writes are never elected.
* **HVD205 generation isolation** — post-bump processes never consume
  pre-bump keys.
* **HVD206 per-group lockstep**, restated for the port (non-members never
  negotiate a group's rounds): all members of a group decide each round
  alike (replay, renegotiate), and stand at the same per-group sequence
  after it.

Faults come from the ``HOROVOD_FAULT_INJECT`` grammar
(``protocol.parse_fault_spec``): ``kv_timeout@seq=N[,times=M]``,
``crash@rank=R,step=S``, ``torn_write@epoch=E`` and ``regrow@step=S``.

Stdlib-only: ``tools/hvd_model_torch.py`` runs it without torch.
"""

from __future__ import annotations

import dataclasses
import functools
import json
from collections import deque
from typing import Any, Optional, Sequence

from horovod_tpu_torch.analysis import protocol as proto
from horovod_tpu_torch.analysis.report import Finding

DEFAULT_MAX_STATES = 200_000

# The negotiator's first generation (core/negotiate.py).
_GEN0 = 0

# Symbolic liveness clock: the judged age of a crashed/failed peer. Only
# the comparison against the timeout matters in the model; the real
# judge_dead runs on these numbers.
_LIVENESS_TIMEOUT = 60.0
_DEAD_AGE = 2 * _LIVENESS_TIMEOUT


class ModelLimit(RuntimeError):
    """The sweep exceeded ``max_states`` (HOROVOD_MODEL_MAX_STATES)."""


# ---------------------------------------------------------------------------
# World specification
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Collective:
    """One negotiated collective in a script. ``members`` are the pids of
    its group's ranks (group-local rank = position in ``members``; rank 0
    coordinates); every OTHER process skips the step, as a non-member
    skips the collective in the port. ``shapes`` is per-member (defaults
    to ``(4,)`` everywhere)."""

    name: str
    op: int
    members: tuple[int, ...]
    shapes: tuple[tuple[int, ...], ...] = ()
    dtype: str = "f32"
    root: int = 0

    @property
    def group_size(self) -> int:
        return len(self.members)

    def shape_of(self, member_index: int) -> tuple[int, ...]:
        if self.shapes:
            return self.shapes[member_index]
        return (4,)


# Script steps: ("negotiate", Collective) | ("batch", (Collective, ...))
# (one round of several requests of one group) | ("save", epoch) |
# ("restore", rid) | ("crash",) | ("shrink", sid) | ("join", jid) |
# ("regrow", jid) | ("jadmit", rid) | ("jemit", rid) | ("jreplay", rid)
Step = tuple[Any, ...]


@dataclasses.dataclass(frozen=True)
class World:
    """One closed model-checking problem: per-process scripts plus the
    protocol configuration and injected faults."""

    label: str
    nprocs: int
    scripts: tuple[tuple[Step, ...], ...]
    cache_enabled: bool = True
    liveness: bool = True
    retries: int = 3
    faults: tuple[proto.Fault, ...] = ()
    # Pids that start OUTSIDE the world (group ()) and enter only through
    # a scripted ("join", jid) admission handshake — the regrow mirror of
    # the shrink spec. Everyone else starts as a member.
    joiners: tuple[int, ...] = ()
    # None = the shipped protocol. Deliberately-broken variants for the
    # checker's own regression corpus (tests/lint_corpus/*.world.json):
    # "premature_verdict" publishes (and overwrites) verdicts before every
    # submission arrived; "stale_generation_read" reads a previous
    # generation's verdict key when one survives in the store;
    # "skip_memberless" is the reference's memberless skip, which is the
    # port's shipped behaviour (a non-member never negotiates), so it
    # changes nothing here; "skip_round" lets a group's last member skip
    # its first round of the group (HVD206); "stale_replay" lets the last
    # member of the world keep its verdict cache across a generation move,
    # so it replays while the others renegotiate (HVD206); "elect_unverified"
    # offers UNVERIFIED epochs (torn writes included) to the restore
    # agreement — the pre-manifest bug HVD204 must catch;
    # "replay_torn_tail" lets journal replayers consume a torn journal
    # record as committed tokens (include_torn in
    # protocol.journal_committed) — the serving-journal mirror of
    # elect_unverified, convicted by the same HVD204 check.
    variant: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class Proc:
    """One process's protocol state (immutable — part of the state key,
    apart from the two round logs, which the invariant checks read)."""

    pc: int = 0
    phase: str = "idle"  # idle | wait | agree
    seqs: tuple[tuple[int, int], ...] = ()  # (group, next index) pairs
    cur_seq: int = -1  # in-flight negotiation index
    gen: int = _GEN0  # store generation
    kvseq: int = 0  # per-process KV-op counter (fault matching)
    attempt: int = 0  # failed attempts of the in-flight KV op
    coord: int = 0  # current coordinator pid
    group: tuple[int, ...] = ()  # current world membership (pids)
    cache: tuple[tuple[Any, str], ...] = ()  # ((group, fps), verdict)
    verdicts: tuple[tuple[str, str], ...] = ()  # (name, canonical verdict)
    agreed: tuple[int, ...] = ()  # agreed epochs from restores
    published: int = 0  # premature-variant: submissions in last publish
    disk: tuple[tuple[int, str], ...] = ()  # (epoch, "ok"|"torn")
    torn: tuple[int, ...] = ()  # consumed torn-fault indices
    status: str = "run"  # run | done | crashed | failed
    reason: str = ""
    # (gen, group, decision) per round entered: "replay" | "negotiate" |
    # "skip"; and (gen, group, index after) per round finished.
    decided: tuple = dataclasses.field(default=(), compare=False)
    finished: tuple = dataclasses.field(default=(), compare=False)


State = tuple[tuple[Proc, ...], tuple[tuple[str, str], ...]]

# One explored transition: (label, successor, events). Events drive the
# invariant checks: ("read", pid, key), ("complete", pid, name, verdict),
# ("agreed", pid, rid, agreed, sets), ("exhausted", pid),
# ("round", pid, "decided"|"finished", gen, group, k, value).
Transition = tuple[str, State, tuple[tuple[Any, ...], ...]]


def initial_state(world: World) -> State:
    members = tuple(q for q in range(world.nprocs)
                    if q not in world.joiners)
    coord = min(members) if members else 0
    return (tuple(
        Proc(group=(() if pid in world.joiners else members), coord=coord,
             status=("run" if world.scripts[pid] else "done"))
        for pid in range(world.nprocs)), ())


def _kv_get_map(kv: tuple[tuple[str, str], ...]) -> dict[str, str]:
    return dict(kv)


def _kv_freeze(kv: dict[str, str]) -> tuple[tuple[str, str], ...]:
    return tuple(sorted(kv.items()))


def _agree_key(gen: int, pid: int) -> str:
    # Model-side transport for the restore agreement barrier; generation-
    # scoped like every live key family (protocol.key_generation parses it).
    return f"{proto.KEY_PREFIX}/agree/g{gen}/p{pid}"


def _batch(step: Step) -> tuple[Collective, ...]:
    return step[1] if step[0] == "batch" else (step[1],)


def _label(batch: Sequence[Collective]) -> str:
    return "+".join(c.name for c in batch)


@functools.lru_cache(maxsize=None)
def _subsets(world: World) -> tuple[tuple[int, ...], ...]:
    """Every distinct member set the world's scripts negotiate on."""
    out = set()
    for script in world.scripts:
        for step in script:
            if step[0] in ("negotiate", "batch"):
                out.add(tuple(sorted(_batch(step)[0].members)))
    return tuple(sorted(out))


def _group_index(world: World, p: Proc, members: Sequence[int]) -> int:
    """The group a collective runs on: 0 for the process's current world
    (rebuilt in place by a shrink or regrow, as the port's group 0), else
    one index a member set."""
    key = tuple(sorted(members))
    if key == tuple(sorted(p.group)):
        return 0
    return 1 + _subsets(world).index(key)


def _submission(batch: Sequence[Collective], pid: int) -> list:
    """This member's batch as ``core/negotiate.py`` writes it:
    ``[name, op, dtype, shape, root]`` a request."""
    out = []
    for coll in batch:
        rank = coll.members.index(pid)
        out.append([coll.name, coll.op, coll.dtype,
                    list(coll.shape_of(rank)),
                    (coll.root if coll.op in
                     (proto.OP_BROADCAST, proto.OP_GATHER) else -1)])
    return out


def _fingerprints(world: World, batch: Sequence[Collective]
                  ) -> Optional[tuple]:
    """The batch's replay key (``core/negotiate.py::_fingerprints``):
    every request's fingerprint, or None when one has none."""
    fps = []
    for coll in batch:
        fp = proto.replay_fingerprint(coll.name, coll.op, coll.group_size,
                                      (coll.op,), world.cache_enabled)
        if fp is None:
            return None
        fps.append(fp)
    return tuple(fps) or None


def _coordinate_round(present: dict[int, list], seq: int, size: int,
                      group: int) -> dict[str, Any]:
    """The coordinator's verdict over the members' batches
    (``core/negotiate.py::_validate``): equal lengths, then each request
    through ``protocol.coordinate``."""
    first = present[0]
    for r in sorted(present):
        if len(present[r]) != len(first):
            return {"error": (
                f"Mismatched negotiation batches: group-local rank {r} "
                f"submitted {len(present[r])} request(s) while rank 0 "
                f"submitted {len(first)}. All ranks must issue the same "
                f"collectives in the same order.")}
    responses = []
    for i, req in enumerate(first):
        per_proc = {r: {"name": b[i][0], "requests": [
            {"rank": r, "name": b[i][0], "op": b[i][1], "dtype": b[i][2],
             "shape": b[i][3], "root_rank": b[i][4], "group": group}]}
            for r, b in sorted(present.items())}
        v = proto.coordinate(per_proc, req[0], seq, size)
        if v.get("error"):
            return {"error": v["error"]}
        responses.append([v["name"], v["op"], v["dtype"],
                          v["tensor_sizes"], v["root_rank"]])
    return {"responses": responses}


def _round_count(log: tuple, gen: int, group: int) -> int:
    return sum(1 for e in log if e[0] == gen and e[1] == group)


def _decide(p: Proc, group: int, decision: str
            ) -> tuple[Proc, tuple[Any, ...]]:
    k = _round_count(p.decided, p.gen, group)
    return (dataclasses.replace(p, decided=p.decided + (
        (p.gen, group, decision),)), ("decided", p.gen, group, k, decision))


def _finish(p: Proc, group: int, seq_after: int
            ) -> tuple[Proc, tuple[Any, ...]]:
    k = _round_count(p.finished, p.gen, group)
    return (dataclasses.replace(p, finished=p.finished + (
        (p.gen, group, seq_after),)),
        ("finished", p.gen, group, k, seq_after))


def _moved_cache(world: World, p: Proc, pid: int) -> tuple:
    """The verdict cache after a generation move: dropped, except under
    the broken "stale_replay" variant on the world's last member."""
    if world.variant == "stale_replay" and p.group and pid == max(p.group):
        return p.cache
    return ()


def _with_seq(p: Proc, group: int, seq: int) -> tuple:
    d = dict(p.seqs)
    d[group] = seq
    return tuple(sorted(d.items()))


def _verified_epochs(p: Proc) -> list[int]:
    # The model's analog of the size-only manifest scan: torn epochs are
    # excluded by verification, never offered for agreement.
    return sorted((e for e, st in p.disk if st == "ok"), reverse=True)


def _journal_key(idx: int) -> str:
    # Generation-FREE (key_generation -> None): the journal outlives its
    # writer, and the replayers consume it at whatever generation they
    # hold — the join/admit-key precedent, no HVD205 false positive.
    return f"{proto.KEY_PREFIX}/journal/{idx:04d}"


def _journal_records(kv: dict[str, str]
                     ) -> tuple[list[str], list[dict[str, Any]]]:
    keys = sorted(k for k in kv if "/journal/" in k)
    return keys, [json.loads(kv[k]) for k in keys]


def _dead_pids(procs: Sequence[Proc], pids: Sequence[int]) -> list[int]:
    """Peers in ``pids`` a liveness check would judge dead — routed through
    the real judgement (a crashed/failed process stops heartbeating, so
    its symbolic age exceeds the timeout)."""
    cached: dict[int, Optional[float]] = {}
    for q in pids:
        if procs[q].status in ("crashed", "failed"):
            cached[q] = _DEAD_AGE  # last heartbeat: long ago
        else:
            cached[q] = 2 * _DEAD_AGE  # fresh heartbeat, age ~0
    judged = proto.judge_dead(cached, now=2 * _DEAD_AGE,
                              timeout=_LIVENESS_TIMEOUT)
    return [pid for pid, _age in judged]


# ---------------------------------------------------------------------------
# Successor generation — one function, every transition kind
# ---------------------------------------------------------------------------


def _fault_kv_tick(world: World, p: Proc) -> tuple[Proc, Optional[str]]:
    """Apply one KV-op tick with fault injection: returns the process
    after the tick and the retry action taken (None = the op went
    through). Uses the real fault matcher, classifier, and retry budget."""
    fault = proto.kv_fault_covering(world.faults, p.kvseq)
    p2 = dataclasses.replace(p, kvseq=p.kvseq + 1)
    if fault is None:
        return dataclasses.replace(p2, attempt=0), None
    msg = (f"UNAVAILABLE: injected coordination-service fault "
           f"({fault} at kv seq {p.kvseq})")
    kind = proto.classify_kv_message(msg)
    action = proto.retry_decision(kind, "get", p.attempt, world.retries, msg)
    if action == "retry":
        return dataclasses.replace(p2, attempt=p.attempt + 1), "retry"
    return dataclasses.replace(p2, status="failed",
                               reason="retry_exhausted"), "exhausted"


def _advance(p: Proc, world_script: tuple[Step, ...], **changes: Any) -> Proc:
    """pc+1 (and done when the script is exhausted), resetting the
    per-step machinery."""
    nxt = dataclasses.replace(
        p, pc=p.pc + 1, phase="idle", cur_seq=-1, attempt=0, published=0,
        **changes)
    if nxt.pc >= len(world_script) and nxt.status == "run":
        nxt = dataclasses.replace(nxt, status="done")
    return nxt


def _record(p: Proc, name: str, verdict: str) -> Proc:
    return dataclasses.replace(p, verdicts=p.verdicts + ((name, verdict),))


def successors(world: World, state: State) -> list[Transition]:
    """Every enabled transition of ``state``, deterministically ordered."""
    procs, kv_t = state
    kv = _kv_get_map(kv_t)
    out: list[Transition] = []
    for pid, p in enumerate(procs):
        if p.status != "run":
            continue
        script = world.scripts[pid]
        step = script[p.pc] if p.pc < len(script) else None
        if step is None:  # defensive: _advance marks done at the boundary
            continue

        def emit(label: str, new_p: Proc,
                 new_kv: Optional[dict[str, str]] = None,
                 events: tuple[tuple[Any, ...], ...] = (),
                 _pid: int = pid) -> None:
            new_procs = tuple(new_p if i == _pid else q
                              for i, q in enumerate(procs))
            frozen = kv_t if new_kv is None else _kv_freeze(new_kv)
            out.append((f"p{_pid}: {label}", (new_procs, frozen), events))

        # Injected crash replaces the step it lands on (the live
        # maybe_crash fires at the top of the call) — real matcher.
        if (p.phase == "idle"
                and proto.crash_fault_matching(world.faults, p.pc, (pid,))
                is not None):
            emit(f"crash (injected, step {p.pc})",
                 dataclasses.replace(p, status="crashed"))
            continue

        kind = step[0]
        if kind in ("negotiate", "batch"):
            batch = _batch(step)
            members = batch[0].members
            label = _label(batch)
            if pid not in members:
                # A non-member takes no part in the group's rounds.
                emit(f"skip {label} (not a member)", _advance(p, script))
                continue
            gidx = _group_index(world, p, members)
            name = label if gidx == 0 else f"{label}@grp{gidx}"
            rank = members.index(pid)
            coord = members[0]
            size = len(members)
            seq = dict(p.seqs).get(gidx, 0)
            if p.phase == "idle":
                if (world.variant == "skip_round" and pid == members[-1]
                        and size > 1 and p.cur_seq < 0
                        and not _round_count(p.decided, p.gen, gidx)):
                    # BROKEN variant: the last member skips its first
                    # round of the group — the lockstep drift HVD206 must
                    # catch.
                    p2, dev = _decide(p, gidx, "skip")
                    p2, fev = _finish(p2, gidx, seq)
                    emit(f"skip {label} (member, broken)",
                         _advance(p2, script),
                         events=(("round", pid) + dev,
                                 ("round", pid) + fev))
                    continue
                fps = _fingerprints(world, batch)
                cache = dict(p.cache)
                if fps is not None and (gidx, fps) in cache:
                    # Verdict replay: no store round, the group's index
                    # does NOT advance — the decision every member must
                    # make alike (HVD206).
                    vstr = cache[(gidx, fps)]
                    p2, dev = _decide(p, gidx, "replay")
                    p2, fev = _finish(p2, gidx, seq)
                    emit(f"replay {label}",
                         _advance(_record(p2, name, vstr), script),
                         events=(("complete", pid, name, vstr),
                                 ("round", pid) + dev,
                                 ("round", pid) + fev))
                    continue
                events: tuple[tuple[Any, ...], ...] = ()
                base = p
                if p.cur_seq < 0:
                    base, dev = _decide(p, gidx, "negotiate")
                    events = (("round", pid) + dev,)
                p2, action = _fault_kv_tick(world, base)
                cur = p.cur_seq if p.cur_seq >= 0 else seq
                nseq = seq + 1 if p.cur_seq < 0 else seq
                p2 = dataclasses.replace(p2, cur_seq=cur,
                                         seqs=_with_seq(p2, gidx, nseq))
                if action == "retry":
                    emit(f"submit {label} (kv retry)", p2, events=events)
                    continue
                if action == "exhausted":
                    emit(f"submit {label} (retries exhausted)", p2,
                         events=events + (("exhausted", pid),))
                    continue
                kv2 = None
                if pid != coord:  # the coordinator holds its own batch
                    kv2 = dict(kv)
                    kv2[proto.neg_key(p.gen, gidx, cur, rank)] = \
                        json.dumps(_submission(batch, pid))
                emit(f"submit {label} seq={cur}",
                     dataclasses.replace(p2, phase="wait"), kv2, events)
                continue
            # phase == "wait"
            vkey = proto.verdict_key(p.gen, gidx, p.cur_seq)
            if pid == coord:
                sub_keys = {r: proto.neg_key(p.gen, gidx, p.cur_seq, r)
                            for r in range(1, size)}
                present = {0: _submission(batch, pid)}
                present.update({r: json.loads(kv[k])
                                for r, k in sub_keys.items() if k in kv})
                if len(present) == size:
                    p2, action = _fault_kv_tick(world, p)
                    if action == "retry":
                        emit(f"collect {label} (kv retry)", p2)
                        continue
                    if action == "exhausted":
                        emit(f"collect {label} (retries exhausted)", p2,
                             events=(("exhausted", pid),))
                        continue
                    verdict = _coordinate_round(present, p.cur_seq, size,
                                                gidx)
                    vstr = json.dumps(verdict, sort_keys=True)
                    kv2 = dict(kv)
                    kv2[vkey] = vstr
                    for k in sub_keys.values():
                        kv2.pop(k, None)
                    if p.cur_seq > 0:
                        kv2.pop(proto.verdict_key(p.gen, gidx,
                                                  p.cur_seq - 1), None)
                    events = (("complete", pid, name, vstr),)
                    if verdict.get("error"):
                        emit(f"collect {label} (error verdict)",
                             dataclasses.replace(
                                 _record(p2, name, vstr),
                                 status="failed", reason="verdict_error"),
                             kv2, events)
                        continue
                    p3, fev = _finish(_record(p2, name, vstr), gidx, seq)
                    fps = _fingerprints(world, batch)
                    if fps is not None:
                        c = dict(p3.cache)
                        c[(gidx, fps)] = vstr
                        p3 = dataclasses.replace(
                            p3, cache=tuple(sorted(c.items())))
                    emit(f"collect {label} seq={p.cur_seq}",
                         _advance(p3, script), kv2,
                         events + (("round", pid) + fev,))
                    continue
                if (world.variant == "premature_verdict"
                        and len(present) > p.published):  # broken publish
                    # BROKEN variant: publish from whoever has arrived,
                    # overwriting as more land — the split-brain the
                    # checker's corpus fixture must detect.
                    verdict = _coordinate_round(present, p.cur_seq,
                                                max(1, len(present)), gidx)
                    kv2 = dict(kv)
                    kv2[vkey] = json.dumps(verdict, sort_keys=True)
                    emit(f"collect {label} (premature, "
                         f"{len(present)}/{size})",
                         dataclasses.replace(p, published=len(present)),
                         kv2)
                    continue
                # Blocked on missing batches: a dead member turns the wait
                # into a liveness fatal (real judgement).
                missing = [members[r] for r in range(size)
                           if r not in present]
                dead = _dead_pids(procs, missing) if world.liveness else []
                if dead:
                    emit(f"liveness fatal (waiting on {dead})",
                         dataclasses.replace(p, status="failed",
                                             reason="liveness"))
                continue
            # A member waiting for the coordinator's verdict.
            if (world.variant == "stale_generation_read"
                    and p.gen > _GEN0):
                stale = proto.verdict_key(p.gen - 1, gidx, p.cur_seq)
                if stale in kv:
                    # BROKEN variant: consume the previous generation's
                    # surviving verdict key (the "forgot the bump" bug).
                    vstr = kv[stale]
                    emit(f"read stale verdict {stale}",
                         _advance(_record(p, name, vstr), script),
                         events=(("read", pid, stale),
                                 ("complete", pid, name, vstr)))
                    continue
            if vkey in kv:
                p2, action = _fault_kv_tick(world, p)
                if action == "retry":
                    emit(f"read verdict {label} (kv retry)", p2)
                    continue
                if action == "exhausted":
                    emit(f"read verdict {label} (retries exhausted)",
                         p2, events=(("exhausted", pid),))
                    continue
                vstr = kv[vkey]
                verdict = json.loads(vstr)
                events = (("read", pid, vkey),
                          ("complete", pid, name, vstr))
                if verdict.get("error"):
                    emit(f"read verdict {label} (error)",
                         dataclasses.replace(
                             _record(p2, name, vstr),
                             status="failed", reason="verdict_error"),
                         events=events)
                    continue
                p3, fev = _finish(_record(p2, name, vstr), gidx, seq)
                fps = _fingerprints(world, batch)
                if fps is not None:
                    c = dict(p3.cache)
                    c[(gidx, fps)] = vstr
                    p3 = dataclasses.replace(
                        p3, cache=tuple(sorted(c.items())))
                emit(f"read verdict {label} seq={p.cur_seq}",
                     _advance(p3, script),
                     events=events + (("round", pid) + fev,))
                continue
            if world.liveness and _dead_pids(procs, (coord,)):
                emit(f"liveness fatal (coordinator p{coord} dead)",
                     dataclasses.replace(p, status="failed",
                                         reason="liveness"))
            continue

        if kind == "save":
            epoch = int(step[1])
            i = proto.torn_write_index(world.faults, epoch, p.torn)
            if i is not None:
                emit(f"save epoch {epoch} (torn write)",
                     _advance(dataclasses.replace(
                         p, disk=p.disk + ((epoch, "torn"),),
                         torn=p.torn + (i,)), script))
            else:
                emit(f"save epoch {epoch}",
                     _advance(dataclasses.replace(
                         p, disk=p.disk + ((epoch, "ok"),)), script))
            continue

        if kind == "restore":
            rid = int(step[1])
            akey = _agree_key(p.gen, pid)
            if p.phase == "idle":
                p2, action = _fault_kv_tick(world, p)
                if action == "retry":
                    emit("agree submit (kv retry)", p2)
                    continue
                if action == "exhausted":
                    emit("agree submit (retries exhausted)", p2,
                         events=(("exhausted", pid),))
                    continue
                kv2 = dict(kv)
                if world.variant == "elect_unverified":
                    # BROKEN variant: offer the raw directory scan, torn
                    # writes and all (no manifest verification).
                    offered = sorted((e for e, _st in p.disk),
                                     reverse=True)
                else:
                    offered = _verified_epochs(p)
                kv2[akey] = json.dumps(offered)
                emit(f"agree submit (restore {rid})",
                     dataclasses.replace(p2, phase="agree"), kv2)
                continue
            keys = {q: _agree_key(p.gen, q) for q in p.group}
            if all(k in kv for k in keys.values()):
                sets = [json.loads(kv[keys[q]]) for q in sorted(keys)]
                agreed, newest = proto.agree_epochs(sets)
                aev: tuple[tuple[Any, ...], ...] = tuple(
                    ("read", pid, keys[q]) for q in sorted(keys))
                aev += (("agreed", pid, rid, agreed, tuple(
                    tuple(s) for s in sets)),
                    # agreed-epoch agreement rides the HVD201 check too
                    ("complete", pid, f"__agree_{rid}",
                     "no-common" if agreed < 0 and newest >= 0
                     else str(agreed)))
                if agreed < 0 and newest >= 0:
                    # The live layer's loud refusal (no epoch loadable
                    # everywhere) — a clean failure, not a wedge.
                    emit(f"agree (restore {rid}): no common epoch",
                         dataclasses.replace(
                             _record(p, f"__agree_{rid}", "no-common"),
                             status="failed", reason="no_common_epoch"),
                         events=aev)
                    continue
                # Agreement -> restore -> generation bump: fresh KV
                # namespace, fresh negotiator (seq and verdict cache
                # reset) — exactly Trainer.restore's sequence.
                emit(f"agree (restore {rid}): epoch {agreed}, bump "
                     f"gen {p.gen}->{p.gen + 1}",
                     _advance(dataclasses.replace(
                         _record(p, f"__agree_{rid}", str(agreed)),
                         gen=p.gen + 1, seqs=(), cache=_moved_cache(world, p, pid),
                         agreed=p.agreed + (agreed,)), script),
                     events=aev)
                continue
            waiting = [q for q in p.group if keys[q] not in kv]
            dead = _dead_pids(procs, waiting) if world.liveness else []
            if dead:
                emit(f"liveness fatal (restore waiting on {dead})",
                     dataclasses.replace(p, status="failed",
                                         reason="liveness"))
            continue

        if kind == "crash":
            emit(f"crash (scripted, step {p.pc})",
                 dataclasses.replace(p, status="crashed"))
            continue

        if kind == "shrink":
            sid = int(step[1])
            dead = _dead_pids(procs, [q for q in p.group if q != pid])
            if not dead:
                continue  # blocked until the liveness verdict names a peer
            plan = proto.plan_shrink(p.group, dead, p.gen)
            plan_str = (f"{plan.survivors}|{plan.coordinator}|"
                        f"{plan.generation}")
            emit(f"shrink {sid}: survivors {list(plan.survivors)}, "
                 f"coord p{plan.coordinator}, gen {plan.generation}",
                 _advance(dataclasses.replace(
                     _record(p, f"__shrink_{sid}", plan_str),
                     group=plan.survivors, coord=plan.coordinator,
                     gen=plan.generation, seqs=(),
                     cache=_moved_cache(world, p, pid)), script),
                 # shrink-plan agreement rides the HVD201 check too
                 events=(("complete", pid, f"__shrink_{sid}", plan_str),))
            continue

        if kind == "join":
            # A (re)joining process: announce under the generation-FREE
            # join key (the joiner does not know the current generation —
            # learning it IS the handshake), then block until the
            # coordinator's admission verdict carries the regrow plan.
            jid = int(step[1])
            jkey = proto.join_key(jid, pid)
            akey = proto.admit_key(jid, pid)
            if p.phase == "idle":
                p2, action = _fault_kv_tick(world, p)
                if action == "retry":
                    emit(f"join {jid} announce (kv retry)", p2)
                    continue
                if action == "exhausted":
                    emit(f"join {jid} announce (retries exhausted)", p2,
                         events=(("exhausted", pid),))
                    continue
                kv2 = dict(kv)
                kv2[jkey] = json.dumps({"pid": pid})
                emit(f"join {jid}: announce p{pid}",
                     dataclasses.replace(p2, phase="wait"), kv2)
                continue
            # phase == "wait": admitted only when the verdict lands.
            if akey in kv:
                p2, action = _fault_kv_tick(world, p)
                if action == "retry":
                    emit(f"join {jid} admit (kv retry)", p2)
                    continue
                if action == "exhausted":
                    emit(f"join {jid} admit (retries exhausted)", p2,
                         events=(("exhausted", pid),))
                    continue
                plan = json.loads(kv[akey])
                members = tuple(plan["members"])
                plan_str = (f"{members}|{plan['coordinator']}|"
                            f"{plan['generation']}")
                kv2 = dict(kv)
                kv2.pop(akey, None)
                emit(f"join {jid}: admitted, gen {plan['generation']}",
                     _advance(dataclasses.replace(
                         _record(p2, f"__regrow_{jid}", plan_str),
                         group=members, coord=plan["coordinator"],
                         gen=plan["generation"], seqs=(),
                         cache=_moved_cache(world, p, pid)), script),
                     kv2,
                     # the admission read is generation-free by design
                     # (key_generation -> None, no HVD205 false positive);
                     # the completion drives the HVD201 agreement check.
                     events=(("read", pid, akey),
                             ("complete", pid, f"__regrow_{jid}",
                              plan_str)))
            continue

        if kind == "regrow":
            # Members at a step boundary: the coordinator waits for every
            # scripted joiner's announcement, computes the deterministic
            # plan_regrow, and publishes it twice — under the OLD
            # generation for the other members, and under the generation-
            # free admit keys for the joiners. Everyone adopts the plan:
            # new group, re-elected coordinator, bumped generation, seq 0.
            jid = int(step[1])
            rkey = proto.regrow_key(p.gen, jid)
            if pid == p.coord:
                jkeys = {q: proto.join_key(jid, q)
                         for q in sorted(world.joiners)}
                if not jkeys or not all(k in kv for k in jkeys.values()):
                    continue  # blocked until every joiner has announced
                p2, action = _fault_kv_tick(world, p)
                if action == "retry":
                    emit(f"regrow {jid} (kv retry)", p2)
                    continue
                if action == "exhausted":
                    emit(f"regrow {jid} (retries exhausted)", p2,
                         events=(("exhausted", pid),))
                    continue
                plan = proto.plan_regrow(p.group, jkeys, p.gen)
                plan_str = (f"{plan.members}|{plan.coordinator}|"
                            f"{plan.generation}")
                payload = json.dumps(
                    {"members": list(plan.members),
                     "coordinator": plan.coordinator,
                     "generation": plan.generation}, sort_keys=True)
                kv2 = dict(kv)
                kv2[rkey] = payload
                for q, k in jkeys.items():
                    kv2[proto.admit_key(jid, q)] = payload
                    kv2.pop(k, None)
                emit(f"regrow {jid}: members {list(plan.members)}, "
                     f"coord p{plan.coordinator}, gen {plan.generation}",
                     _advance(dataclasses.replace(
                         _record(p2, f"__regrow_{jid}", plan_str),
                         group=plan.members, coord=plan.coordinator,
                         gen=plan.generation, seqs=(),
                     cache=_moved_cache(world, p, pid)), script),
                     kv2,
                     # regrow-plan agreement rides the HVD201 check too
                     events=(("complete", pid, f"__regrow_{jid}",
                              plan_str),))
                continue
            # Non-coordinator member: read the published plan — an OLD-
            # generation key consumed while still AT the old generation,
            # so HVD205-clean by construction (the bump happens in the
            # same transition as the read, judged pre-transition).
            if rkey in kv:
                p2, action = _fault_kv_tick(world, p)
                if action == "retry":
                    emit(f"regrow {jid} read (kv retry)", p2)
                    continue
                if action == "exhausted":
                    emit(f"regrow {jid} read (retries exhausted)", p2,
                         events=(("exhausted", pid),))
                    continue
                plan = json.loads(kv[rkey])
                members = tuple(plan["members"])
                plan_str = (f"{members}|{plan['coordinator']}|"
                            f"{plan['generation']}")
                emit(f"regrow {jid}: adopt gen {plan['generation']}",
                     _advance(dataclasses.replace(
                         _record(p2, f"__regrow_{jid}", plan_str),
                         group=members, coord=plan["coordinator"],
                         gen=plan["generation"], seqs=(),
                         cache=_moved_cache(world, p, pid)), script),
                     events=(("read", pid, rkey),
                             ("complete", pid, f"__regrow_{jid}",
                              plan_str)))
            continue

        # -- serving-journal spec: a writer appends admit/emit records
        # (torn_write faults tear a record, the crash-mid-append
        # artifact), crashes, and replayers fold the survivors through
        # the SAME protocol.journal_committed the live Engine.recover
        # and the hvd-lint verifier run — HVD201 on the committed runs,
        # HVD204 on a torn record ever replaying as committed tokens.
        if kind == "jadmit":
            rid = int(step[1])
            p2, action = _fault_kv_tick(world, p)
            if action == "retry":
                emit(f"jadmit {rid} (kv retry)", p2)
                continue
            if action == "exhausted":
                emit(f"jadmit {rid} (retries exhausted)", p2,
                     events=(("exhausted", pid),))
                continue
            keys, _recs = _journal_records(kv)
            kv2 = dict(kv)
            kv2[_journal_key(len(keys))] = json.dumps(
                {"kind": "admit", "rid": rid, "max_new": 4},
                sort_keys=True)
            emit(f"jadmit {rid}", _advance(p2, script), kv2)
            continue

        if kind == "jemit":
            rid = int(step[1])
            p2, action = _fault_kv_tick(world, p)
            if action == "retry":
                emit(f"jemit {rid} (kv retry)", p2)
                continue
            if action == "exhausted":
                emit(f"jemit {rid} (retries exhausted)", p2,
                     events=(("exhausted", pid),))
                continue
            keys, recs = _journal_records(kv)
            idx = len(keys)
            kv2 = dict(kv)
            i = proto.torn_write_index(world.faults, idx, p.torn)
            if i is not None:
                # The record tears mid-append: a CRC-failing line, the
                # artifact _read_records drops as the torn tail.
                kv2[_journal_key(idx)] = json.dumps({"kind": "torn"})
                emit(f"jemit {rid} (torn write)",
                     _advance(dataclasses.replace(
                         p2, torn=p.torn + (i,)), script), kv2)
                continue
            run = sum(len(r.get("tokens", ()))
                      for r in recs
                      if r.get("kind") == "emit" and r.get("rid") == rid)
            kv2[_journal_key(idx)] = json.dumps(
                {"kind": "emit", "rid": rid, "start": run,
                 "tokens": [100 + idx]}, sort_keys=True)
            emit(f"jemit {rid} #{run}", _advance(p2, script), kv2)
            continue

        if kind == "jreplay":
            rid = int(step[1])
            if world.liveness and not _dead_pids(procs, (0,)):
                continue  # blocked until liveness convicts the writer
            p2, action = _fault_kv_tick(world, p)
            if action == "retry":
                emit(f"jreplay {rid} (kv retry)", p2)
                continue
            if action == "exhausted":
                emit(f"jreplay {rid} (retries exhausted)", p2,
                     events=(("exhausted", pid),))
                continue
            keys, recs = _journal_records(kv)
            include_torn = world.variant == "replay_torn_tail"
            try:
                committed, used_torn = proto.journal_committed(
                    recs, include_torn=include_torn)
            except ValueError as e:
                emit(f"jreplay {rid}: inconsistent journal ({e})",
                     dataclasses.replace(p2, status="failed",
                                         reason="journal_inconsistent"))
                continue
            committed_str = json.dumps(
                {str(r): list(toks) for r, toks in
                 sorted(committed.items())}, sort_keys=True)
            events: tuple[tuple[Any, ...], ...] = tuple(
                ("read", pid, k) for k in keys)
            events += (
                # committed-run agreement rides the HVD201 check too
                ("complete", pid, f"__journal_{rid}", committed_str),
                ("jreplayed", pid, rid, used_torn))
            emit(f"jreplay {rid}: {len(recs)} records"
                 + (" (used torn)" if used_torn else ""),
                 _advance(_record(p2, f"__journal_{rid}", committed_str),
                          script), events=events)
            continue

        raise ValueError(f"unknown step kind {kind!r} in world "
                         f"{world.label!r}")
    return out


def _safe_transition(world: World, label: str) -> bool:
    """Partial-order reduction: a transition that commutes with every
    other enabled transition (purely process-local, or a write to a fresh
    per-process key no enabled transition reads) may be explored as the
    ONLY successor of its state. Submissions stop being safe under the
    premature-verdict variant, where a partial collect reads whatever
    subset has arrived."""
    body = label.split(": ", 1)[1]
    if body.startswith(("replay ", "save epoch")):
        return True
    if body.endswith("(not a member)"):
        return True
    if "(kv retry)" in body:
        return True
    if body.startswith("submit ") and "(" not in body:
        return world.variant != "premature_verdict"
    return False


# ---------------------------------------------------------------------------
# Invariant checks
# ---------------------------------------------------------------------------


def _max_kv_burst(faults: Sequence[proto.Fault]) -> int:
    """Longest run of CONSECUTIVE KV-op indices covered by kv_timeout
    faults (adjacent entries merge) — the burst the retry budget must
    absorb for the sweep to count as bounded-fault (HVD203)."""
    covered: set[int] = set()
    for f in faults:
        if f.kind == "kv_timeout":
            start = f.attrs["seq"]
            covered.update(range(start, start + f.attrs.get("times", 1)))
    best = run = 0
    for x in sorted(covered):
        run = run + 1 if (x - 1) in covered else 1
        best = max(best, run)
    return best


def _latest_verdict(p: Proc, name: str) -> Optional[str]:
    for n, v in reversed(p.verdicts):
        if n == name:
            return v
    return None


def _check_events(world: World, state: State,
                  events: tuple[tuple[Any, ...], ...],
                  violations: dict[tuple[str, str], str],
                  trace_msg: str) -> None:
    """Record invariant violations triggered by one transition's events.
    ``state`` is the PRE-transition state: a read is judged against the
    reader's generation AT read time (the restore transition reads its
    agreement keys and bumps in one step — those reads are pre-bump)."""
    procs, _ = state
    for ev in events:
        if ev[0] == "read":
            _, pid, key = ev
            kg = proto.key_generation(key)
            if kg is not None and kg < procs[pid].gen:
                violations.setdefault(
                    ("HVD205", f"p{pid}:{key}"),
                    f"process {pid} (generation {procs[pid].gen}) consumed "
                    f"the pre-bump KV key {key!r} (generation {kg}); "
                    f"generation-bumped coordination must never read keys "
                    f"from a previous generation. {trace_msg}")
        elif ev[0] == "complete":
            _, pid, name, vstr = ev
            for q, other in enumerate(procs):
                if q == pid:
                    continue
                ov = _latest_verdict(other, name)
                if ov is not None and ov != vstr:
                    violations.setdefault(
                        ("HVD201", f"{name}"),
                        f"split verdict on {name!r}: process {pid} "
                        f"committed {vstr} while process {q} holds {ov} — "
                        f"members disagree on the negotiated outcome. "
                        f"{trace_msg}")
        elif ev[0] == "agreed":
            _, pid, rid, agreed, sets = ev
            if agreed >= 0:
                for q, s in enumerate(sets):
                    if agreed not in set(s):
                        violations.setdefault(
                            ("HVD204", f"restore{rid}"),
                            f"restore {rid} elected epoch {agreed}, which "
                            f"is not in process {q}'s verified set "
                            f"{sorted(s)} — the agreed epoch must be "
                            f"loadable by every surviving rank (torn "
                            f"writes must never be elected). {trace_msg}")
                for q, other in enumerate(procs):
                    if other.status in ("crashed",):
                        continue
                    torn = {e for e, st in other.disk if st == "torn"}
                    if agreed in torn:
                        violations.setdefault(
                            ("HVD204", f"restore{rid}:torn"),
                            f"restore {rid} elected epoch {agreed}, which "
                            f"is a TORN write on process {q}. {trace_msg}")
        elif ev[0] == "jreplayed":
            _, pid, rid, used_torn = ev
            if used_torn:
                violations.setdefault(
                    ("HVD204", f"journal{rid}:torn"),
                    f"journal replay {rid} on process {pid} consumed a "
                    f"TORN record as committed tokens — a torn journal "
                    f"tail must be dropped and recomputed, never "
                    f"replayed (protocol.journal_committed). {trace_msg}")
        elif ev[0] == "round":
            _, pid, log, gen, group, k, value = ev
            what = ("decided" if log == "decided"
                    else "stands at index")
            for q, other in enumerate(procs):
                if q == pid:
                    continue
                theirs = [e[2] for e in getattr(other, log)
                          if e[0] == gen and e[1] == group]
                if k < len(theirs) and theirs[k] != value:
                    violations.setdefault(
                        ("HVD206", f"gen{gen}/grp{group}/{log}"),
                        f"group {group} fell out of lockstep at its round "
                        f"{k} of generation {gen}: process {pid} {what} "
                        f"{value!r} while process {q} {what} "
                        f"{theirs[k]!r} — every member must decide a "
                        f"round alike (replay or renegotiate) and stand at "
                        f"the same per-group index after it. {trace_msg}")
        elif ev[0] == "exhausted":
            (_, pid) = ev
            if _max_kv_burst(world.faults) <= world.retries:
                violations.setdefault(
                    ("HVD203", f"p{pid}:exhausted"),
                    f"process {pid} exhausted its retry budget "
                    f"({world.retries}) although every injected kv_timeout "
                    f"burst fits inside it — bounded transient faults must "
                    f"not fail the sweep. {trace_msg}")


def _check_terminal(world: World, state: State,
                    violations: dict[tuple[str, str], str],
                    trace_msg: str) -> None:
    procs, _ = state
    # HVD206: the members of a group that ran to completion stand at one
    # per-group index (per generation: a move resets every index).
    by_group: dict[tuple[int, int], set[int]] = {}
    for p in procs:
        if p.status != "done":
            continue
        for gen, group, _d in p.decided:
            if gen == p.gen:
                by_group.setdefault((gen, group), set()).add(
                    dict(p.seqs).get(group, 0))
    for (gen, group), seqs in sorted(by_group.items()):
        if len(seqs) > 1:
            violations.setdefault(
                ("HVD206", f"gen{gen}/grp{group}"),
                f"per-group negotiation indices diverged at generation "
                f"{gen}: the completed members of group {group} ended at "
                f"indices {sorted(seqs)} — a member fell out of the "
                f"group's lockstep. {trace_msg}")
    # Deadlock (HVD202 fault-free / HVD203 under injected faults): some
    # process still wants to run but nothing in the world can move.
    if any(p.status == "run" for p in procs):
        stuck = [pid for pid, p in enumerate(procs) if p.status == "run"]
        rule = "HVD203" if world.faults else "HVD202"
        detail = ("bounded transient faults wedged the sweep"
                  if world.faults else "the protocol deadlocked")
        violations.setdefault(
            (rule, f"deadlock:{tuple(stuck)}"),
            f"{detail}: processes {stuck} are blocked in a state with no "
            f"enabled transition (every peer transition they wait on can "
            f"never fire). {trace_msg}")


# ---------------------------------------------------------------------------
# The explorer
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Result:
    """One world's sweep: findings plus the exhaustiveness counters the
    CI pins (a silent search-space shrink fails the test suite)."""

    world: World
    findings: list[Finding]
    states: int
    transitions: int
    terminals: int

    @property
    def ok(self) -> bool:
        return not self.findings


def _trace_msg(path: Sequence[str]) -> str:
    if not path:
        return "Counterexample: <initial state>."
    arrow = " -> ".join(path)
    return f"Counterexample ({len(path)} steps): {arrow}."


def _sweep(world: World, max_states: int, order: str, por: bool = True
           ) -> tuple[dict[tuple[str, str], str], int, int, int]:
    """Explore the full interleaving graph. ``order`` is ``"dfs"`` (the
    sweep) or ``"bfs"`` (re-run for shortest counterexample traces —
    violations found breadth-first carry minimal-length traces).
    ``por=False`` disables the partial-order reduction — the full
    unreduced graph; tests assert both modes reach the same verdicts."""
    init = initial_state(world)
    visited: set[State] = {init}
    parents: dict[State, tuple[Optional[State], str]] = {init: (None, "")}
    frontier: deque[State] = deque([init])
    violations: dict[tuple[str, str], str] = {}
    transitions = 0
    terminals = 0

    def path_to(s: State) -> list[str]:
        labels: list[str] = []
        cur: Optional[State] = s
        while cur is not None:
            prev, label = parents[cur]
            if label:
                labels.append(label)
            cur = prev
        return list(reversed(labels))

    while frontier:
        state = frontier.pop() if order == "dfs" else frontier.popleft()
        succ = successors(world, state)
        transitions += len(succ)
        if not succ:
            terminals += 1
            _check_terminal(world, state, violations,
                            _trace_msg(path_to(state)))
            continue
        if por:
            safe = [t for t in succ if _safe_transition(world, t[0])]
            if safe:
                succ = safe[:1]  # ample set: one commuting local transition
        for label, nxt, events in succ:
            if events:
                _check_events(world, state, events, violations,
                              _trace_msg(path_to(state) + [label]))
            if nxt not in visited:
                visited.add(nxt)
                parents[nxt] = (state, label)
                if len(visited) > max_states:
                    raise ModelLimit(
                        f"world {world.label!r} exceeded max_states="
                        f"{max_states} (HOROVOD_MODEL_MAX_STATES); raise "
                        f"the cap or shrink the world.")
                frontier.append(nxt)
    return violations, len(visited), transitions, terminals


def check_world(world: World, max_states: int = DEFAULT_MAX_STATES,
                por: bool = True) -> Result:
    """DFS-sweep every interleaving of ``world``; on violations, re-sweep
    breadth-first so the reported counterexample traces are minimal."""
    violations, states, transitions, terminals = _sweep(
        world, max_states, "dfs", por)
    if violations:
        short, _s, _t, _e = _sweep(world, max_states, "bfs", por)
        # Prefer the BFS (minimal) trace for every violation both sweeps
        # found; keep DFS-only ones as-is.
        merged = dict(violations)
        merged.update(short)
        violations = merged
    findings = [
        Finding(rule, world.label, 1, msg)
        for (rule, _sig), msg in sorted(violations.items(),
                                        key=lambda kv: kv[0])
    ]
    return Result(world=world, findings=findings, states=states,
                  transitions=transitions, terminals=terminals)


# ---------------------------------------------------------------------------
# Standard worlds: the shipped protocol, swept by CI
# ---------------------------------------------------------------------------


def _all(n: int) -> tuple[int, ...]:
    return tuple(range(n))


def standard_worlds(nprocs: int,
                    faults: tuple[proto.Fault, ...] = ()
                    ) -> list[World]:
    """The sweep matrix for ``nprocs`` simulated processes: the
    reference's worlds — eager steady state with verdict replay, a subset
    group (whose non-member skips its rounds here), the non-cacheable
    allgather family, save/restore with epoch agreement and a generation
    bump, the serving journal, and the elastic shrink and regrow specs —
    and the port's own two: two overlapping subset groups negotiating
    interleaved (``hvd.init([[0, 1], [1, 2]])``, at three processes or
    more) and a batched round (a 3-request gradient plan) that replays.
    With ``faults``, the same worlds prove bounded-fault progress (HVD203)
    instead of clean-run safety."""
    n = nprocs
    ar = Collective("grad_sum", proto.OP_ALLREDUCE, _all(n))
    bc = Collective("weights_bcast", proto.OP_BROADCAST, _all(n))
    sub = Collective("subset_sum", proto.OP_ALLREDUCE, _all(n)[:-1])
    ag = Collective("gatherv_x", proto.OP_ALLGATHER, _all(n),
                    shapes=tuple((2 + i, 2) for i in range(n)))
    post = Collective("post_restore", proto.OP_ALLREDUCE, _all(n))
    tag = "+faults" if faults else ""
    plan = tuple(Collective(f"DistributedOptimizer.grads.{i}",
                            proto.OP_ALLREDUCE, _all(n),
                            shapes=((4 * (i + 1),),) * n)
                 for i in range(3))
    worlds = [
        World(label=f"<model:eager-{n}p{tag}>", nprocs=n,
              scripts=tuple(
                  (("negotiate", ar), ("negotiate", ar), ("negotiate", bc))
                  for _ in range(n)),
              faults=faults),
        World(label=f"<model:memberless-{n}p{tag}>", nprocs=n,
              scripts=tuple(
                  (("negotiate", sub), ("negotiate", sub),
                   ("negotiate", ar))
                  for _ in range(n)),
              faults=faults),
        World(label=f"<model:allgather-{n}p{tag}>", nprocs=n,
              scripts=tuple(
                  (("negotiate", ag), ("negotiate", ag)) for _ in range(n)),
              faults=faults),
        World(label=f"<model:checkpoint-{n}p{tag}>", nprocs=n,
              scripts=tuple(
                  (("save", 0), ("save", 1), ("restore", 0),
                   ("negotiate", post))
                  for _ in range(n)),
              faults=faults),
        # Serving-journal crash/replay: pid 0 journals an
        # admission and two token emissions then hard-crashes; every
        # other pid replays the survivors once liveness convicts the
        # writer. With faults, torn_write@epoch=1 tears the first emit
        # record — the shipped fold must drop it (and HVD201 holds on
        # what the replayers agree survived).
        World(label=f"<model:batch-{n}p{tag}>", nprocs=n,
              scripts=tuple(
                  (("batch", plan), ("batch", plan), ("negotiate", bc))
                  for _ in range(n)),
              faults=faults),
        World(label=f"<model:journal-{n}p{tag}>", nprocs=n,
              scripts=tuple(
                  ((("jadmit", 0), ("jemit", 0), ("jemit", 0), ("crash",))
                   if pid == 0 else (("jreplay", 0),))
                  for pid in range(n)),
              faults=faults),
    ]
    if n >= 3:
        # hvd.init([[0, 1], [1, 2]]): rank 1 in both groups, each group on
        # its own sequence and coordinator, the rounds interleaved on
        # rank 1; any further process takes no part.
        a = Collective("pair_a", proto.OP_ALLREDUCE, (0, 1))
        b = Collective("pair_b", proto.OP_ALLREDUCE, (1, 2))
        a2 = Collective("pair_a2", proto.OP_BROADCAST, (0, 1))
        b2 = Collective("pair_b2", proto.OP_ALLREDUCE, (1, 2))
        oscripts: list[tuple[Step, ...]] = [
            (("negotiate", a), ("negotiate", a2), ("negotiate", a)),
            (("negotiate", a), ("negotiate", b), ("negotiate", a2),
             ("negotiate", b2), ("negotiate", a)),
            (("negotiate", b), ("negotiate", b2)),
        ]
        oscripts += [()] * (n - 3)
        worlds.append(World(label=f"<model:overlap-{n}p{tag}>", nprocs=n,
                            scripts=tuple(oscripts), faults=faults))
    if not faults:
        # Shrink -> continue: the last process dies after the first
        # exchange; survivors renegotiate a smaller world and keep going.
        survivors = _all(n)[:-1]
        post_shrink = Collective("post_shrink", proto.OP_ALLREDUCE,
                                 survivors)
        scripts: list[tuple[Step, ...]] = []
        for pid in range(n):
            if pid == n - 1:
                scripts.append((("negotiate", ar), ("crash",)))
            else:
                scripts.append((("negotiate", ar), ("shrink", 0),
                                ("negotiate", post_shrink)))
        worlds.append(World(label=f"<model:shrink-{n}p>", nprocs=n,
                            scripts=tuple(scripts), liveness=True))
        # Regrow (the mirror path): the last pid starts OUTSIDE the
        # world, announces itself, and is admitted only at the members'
        # step boundary; everyone then renegotiates at the larger size
        # under a fresh generation (HVD201 on the plan, HVD205 on the
        # handshake keys).
        old = _all(n)[:-1]
        pre_regrow = Collective("pre_regrow", proto.OP_ALLREDUCE, old)
        post_regrow = Collective("post_regrow", proto.OP_ALLREDUCE,
                                 _all(n))
        rscripts: list[tuple[Step, ...]] = []
        for pid in range(n):
            if pid == n - 1:
                rscripts.append((("join", 0), ("negotiate", post_regrow)))
            else:
                rscripts.append((("negotiate", pre_regrow), ("regrow", 0),
                                 ("negotiate", post_regrow)))
        worlds.append(World(label=f"<model:regrow-{n}p>", nprocs=n,
                            scripts=tuple(rscripts), joiners=(n - 1,)))
    return worlds


def default_fault_specs(nprocs: int) -> list[str]:
    """The with-faults half of the CI sweep: a transient KV burst inside
    the retry budget, a torn checkpoint write, and a crash of the last
    process (survivors must fail with a liveness verdict, not wedge)."""
    return [
        "kv_timeout@seq=1,times=2",
        "torn_write@epoch=1",
        f"crash@rank={nprocs - 1},step=1",
    ]


# ---------------------------------------------------------------------------
# World files (tests/lint_corpus/*.world.json)
# ---------------------------------------------------------------------------


def _step_from_json(d: dict[str, Any], counters: dict[str, int]
                    ) -> Step:
    if not isinstance(d, dict) or "step" not in d:
        raise ValueError(f"each script step must be an object with a "
                         f"'step' field, got {d!r}")
    kind = d["step"]
    if kind == "negotiate":
        op_name = str(d.get("op", ""))
        if op_name not in proto.OP_BY_NAME:
            raise ValueError(
                f"unknown op {op_name!r} in negotiate step; valid ops: "
                f"{sorted(proto.OP_BY_NAME)}")
        members = tuple(int(m) for m in d["members"])
        shapes = tuple(tuple(int(x) for x in s)
                       for s in d.get("shapes", ()))
        return ("negotiate", Collective(
            name=str(d["name"]), op=proto.OP_BY_NAME[op_name],
            members=members, shapes=shapes,
            dtype=str(d.get("dtype", "f32")), root=int(d.get("root", 0))))
    if kind == "batch":
        reqs = d["requests"]
        if not isinstance(reqs, list) or not reqs:
            raise ValueError(f"a batch step needs a non-empty 'requests' "
                             f"list, got {reqs!r}")
        batch = tuple(_step_from_json(dict(r, step="negotiate"),
                                      counters)[1] for r in reqs)
        if len({c.members for c in batch}) != 1:
            raise ValueError("every request of a batch step must name the "
                             "same members")
        return ("batch", batch)
    if kind == "save":
        return ("save", int(d["epoch"]))
    if kind == "restore":
        counters["restore"] += 1
        return ("restore", counters["restore"] - 1)
    if kind == "crash":
        return ("crash",)
    if kind == "shrink":
        counters["shrink"] += 1
        return ("shrink", counters["shrink"] - 1)
    if kind == "join":
        counters["join"] += 1
        return ("join", counters["join"] - 1)
    if kind == "regrow":
        counters["regrow"] += 1
        return ("regrow", counters["regrow"] - 1)
    if kind in ("jadmit", "jemit", "jreplay"):
        return (kind, int(d.get("rid", 0)))
    raise ValueError(f"unknown step kind {kind!r} in world file")


def world_from_json(text: str, path: str = "<world>") -> World:
    """Parse a ``.world.json`` fixture into a :class:`World`. Restore and
    shrink steps are numbered per process in order of appearance, so
    lockstep scripts share ids. Every malformed-spec shape — wrong types,
    missing keys, unknown ops/steps, bad fault specs — raises
    ``ValueError`` naming the file, so the CLI reports exit 2 (usage
    error) and a schema crash can never masquerade as 'detected'."""
    try:
        data = json.loads(text)
        if not isinstance(data, dict) \
                or not isinstance(data.get("scripts"), list):
            raise ValueError("world file must be an object with a "
                             "'scripts' list (one script per process)")
        scripts: list[tuple[Step, ...]] = []
        for proc_steps in data["scripts"]:
            if not isinstance(proc_steps, list):
                raise ValueError(f"each entry of 'scripts' must be a list "
                                 f"of steps, got {proc_steps!r}")
            counters = {"restore": 0, "shrink": 0, "join": 0,
                        "regrow": 0}
            scripts.append(tuple(_step_from_json(s, counters)
                                 for s in proc_steps))
        nprocs = int(data.get("nprocs", len(scripts)))
        if nprocs != len(scripts):
            raise ValueError(
                f"nprocs={nprocs} but {len(scripts)} scripts given")
        joiners = tuple(int(q) for q in data.get("joiners", ()))
        for q in joiners:
            if not 0 <= q < nprocs:
                raise ValueError(
                    f"joiner pid {q} out of range for nprocs={nprocs}")
        return World(
            label=str(data.get("label", path)), nprocs=nprocs,
            scripts=tuple(scripts),
            cache_enabled=bool(data.get("cache", True)),
            liveness=bool(data.get("liveness", True)),
            retries=int(data.get("retries", 3)),
            faults=proto.parse_fault_spec(data.get("faults")),
            joiners=joiners,
            variant=data.get("variant"))
    except ValueError as e:
        # One context wrapper: json.JSONDecodeError is a ValueError too.
        raise ValueError(f"{path}: {e}") from None
    except (TypeError, KeyError) as e:
        raise ValueError(
            f"{path}: malformed world spec ({type(e).__name__}: {e})"
        ) from None


def check_world_file(path: str,
                     max_states: int = DEFAULT_MAX_STATES) -> list[Finding]:
    """Sweep one ``.world.json`` fixture; findings carry the file path
    (the ``path:line: RULE message`` convention)."""
    with open(path, "r", encoding="utf-8") as f:
        world = world_from_json(f.read(), path)
    result = check_world(world, max_states=max_states)
    return [Finding(f.rule, path, f.line, f.message)
            for f in result.findings]

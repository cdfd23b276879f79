"""Elastic data parallelism: shrink -> continue -> regrow under traffic.

Counterpart of ``horovod_tpu/core/elastic.py``. A dead worker costs the
job a world-size change, not a restart: the :class:`ElasticController`
executes the ``plan_shrink``/``plan_regrow`` contracts
(``analysis/protocol.py``) against the live runtime, and ``Trainer.fit``
(``training/loop.py``) drives it under ``HOROVOD_ELASTIC=1``.

The shrink:

1. a :class:`~horovod_tpu_torch.core.resilience.WorkerLost` names the dead
   rank(s): the survivors' observation of an injected ``crash@rank=R``
   (``resilience.maybe_crash``), or a liveness fatal during a negotiation
   wait or a collective that lost its peer;
2. the survivors compute ``plan_shrink(members, dead, generation)`` — drop
   the dead, elect the lowest survivor coordinator, generation + 1 — each
   on its own, from the same inputs;
3. :func:`horovod_tpu_torch.core.state.reconfigure` rebuilds group 0 over
   the survivors under the new generation (a new process group, built
   from the rendezvous store), so store keys roll to a fresh namespace and
   every ``spmd`` program is recorded anew;
4. parameters and optimizer state are broadcast from the elected root
   (group-local rank 0 of the new group), and the step re-plans its
   gradient exchange for the new world size.

The regrow is the mirror path. A process is a rank here, so a dropped
rank comes back as a new process (:func:`rejoin`): it announces itself
under the generation-free ``join`` key, the coordinator admits it at a
``regrow@step=S`` boundary (holding the boundary open at most
``HOROVOD_ELASTIC_JOIN_TIMEOUT``) by publishing the plan under the old
generation's ``regrow`` key and the joiner's ``admit`` key, everyone
rebuilds group 0 over the new membership, the state comes from a current
member (never the joiner), and :func:`agree_step` hands the joiner the
step to resume at.

Everything here defaults OFF (``HOROVOD_ELASTIC=0``): without the knob a
dead peer stays a loud, diagnosable fatal.
"""

from __future__ import annotations

import json
import os
import sys
import time

from horovod_tpu_torch.analysis import protocol as _proto
from horovod_tpu_torch.core import resilience as _res
from horovod_tpu_torch.core import state as _state
from horovod_tpu_torch.core.state import HorovodError
from horovod_tpu_torch.utils import env as _env

# Poll cadence for the join-window / admission waits.
JOIN_POLL_MS = 200

# Recovery metrics (None until a transition happens).
_metrics: dict[str, float | None] = {
    "elastic_shrink_recovery_ms": None,
    "elastic_regrow_admit_ms": None,
}

# The plan a joiner adopted (rejoin), until its trainer takes it.
_admitted: _proto.RegrowPlan | None = None


def last_metrics() -> dict:
    """Most recent transition timings: ``elastic_shrink_recovery_ms`` is
    WorkerLost-to-resumed-step-loop, ``elastic_regrow_admit_ms`` is
    boundary-admission-to-resumed-step-loop. None when no transition of
    that kind has happened in this process."""
    return dict(_metrics)


def _note_transition(activity: str) -> None:
    # SHRINK/REGROW are instant ticks on the same 'coordination' timeline
    # row the store RETRY activities use.
    from horovod_tpu_torch.core import timeline as _tl

    tl = _tl.session()
    if tl.active:
        tl.event("coordination", activity, "X")


def kv_store():
    """The store of the negotiation, the heartbeat and the handshake."""
    from horovod_tpu_torch.core import negotiate as _neg

    return _neg.negotiator().store


class ElasticController:
    """Executes the shrink/regrow contracts for one trainer group. The
    trainer owns the *state* choreography (re-broadcast from the elected
    root); the controller owns the *world* choreography (plan, refuse,
    reconfigure, artifact snapshots, metrics, timeline)."""

    def __init__(self, group: int = 0):
        self.group = group
        # Global ranks currently outside the world (dropped by shrinks,
        # removed again by regrows) — the candidates a ``regrow@step=S``
        # readmits.
        self.dropped: tuple[int, ...] = ()
        self.generation_history: list[int] = []
        # (tag, ExchangeSchedule) snapshots: "pre_shrink", "post_shrink",
        # "post_regrow"; save_artifacts writes them as .exchange.json.
        self.snapshots: list[tuple[str, object]] = []
        self.jid = 0  # the join round of the handshake keys

    # -- membership ----------------------------------------------------------

    def members(self) -> tuple[int, ...]:
        return _state.get_group(self.group).ranks

    def resolve_dead(self, err: _res.WorkerLost) -> tuple[int, ...]:
        """Global ranks of this group the loss names: ``err.ranks`` are
        group-local, ``err.pids`` global ranks of processes."""
        g = _state.get_group(self.group)
        dead: set[int] = set()
        for r in err.ranks:
            if 0 <= r < g.size:
                dead.add(g.ranks[r])
        for p in err.pids:
            dead.update(set(_res._ranks_of_process(p)) & set(g.ranks))
        return tuple(sorted(dead))

    # -- shrink --------------------------------------------------------------

    def plan_shrink(self, dead: tuple[int, ...]) -> _proto.ShrinkPlan:
        """The shrink contract for ``dead`` global ranks. Raises when
        nothing in ``dead`` is a member, when the survivor count would fall
        below ``HOROVOD_ELASTIC_MIN_WORLD`` (at a world of one, where no
        rank survives, too), or when this process's rank is not a
        survivor."""
        members = self.members()
        dead_members = tuple(sorted(set(dead) & set(members)))
        if not dead_members:
            raise HorovodError(
                f"Elastic shrink: none of the lost ranks {list(dead)} are "
                f"members of group {self.group} ({list(members)}).")
        # The floor first: with no survivor at all (a world of one) the
        # refusal is the min-world one, not plan_shrink's ValueError.
        survivors = [m for m in members if m not in dead_members]
        floor = _env.elastic_min_world()
        if len(survivors) < floor:
            raise HorovodError(
                f"Elastic shrink refused: {len(survivors)} "
                f"survivor(s) would fall below HOROVOD_ELASTIC_MIN_WORLD="
                f"{floor}. Restart the failed host(s) and resume from the "
                f"last complete checkpoint (Trainer.fit(resume=...)).")
        plan = _proto.plan_shrink(members, dead_members,
                                  _state.kv_generation())
        if _state.global_rank() not in plan.survivors:
            raise HorovodError(
                "Elastic shrink refused: this process's rank is not a "
                "survivor; it cannot participate in the shrunk world.")
        return plan

    def commit_shrink(self, plan: _proto.ShrinkPlan) -> None:
        """Apply a shrink plan: reconfigure group 0 over the survivors
        (generation bump inside), track the dropped ranks for a later
        regrow, stamp the timeline."""
        before = self.members()
        dropped = tuple(sorted(set(before) - set(plan.survivors)))
        _state.reconfigure(plan.survivors)
        self.dropped = tuple(sorted(set(self.dropped) | set(dropped)))
        self.generation_history.append(_state.kv_generation())
        _note_transition("SHRINK")

    def finish_shrink(self, t0: float) -> None:
        """Stamp the recovery metric once the trainer has re-broadcast
        state and is back in the step loop."""
        _metrics["elastic_shrink_recovery_ms"] = (
            (time.perf_counter() - t0) * 1000.0)

    # -- regrow --------------------------------------------------------------

    def poll_regrow(self, step: int, span: int = 1):
        """The regrow plan due at this step boundary, or None.

        At a ``regrow@step=S`` boundary with dropped ranks (``rank=R``
        narrows it to one), the coordinator — group-local rank 0 — waits
        at most ``HOROVOD_ELASTIC_JOIN_TIMEOUT`` for those ranks' joiners
        to announce, admits the ones that have (:func:`publish_admission`)
        and publishes the plan, or that nobody came, under the old
        generation's ``regrow`` key of this boundary; the other members
        read it there.
        Nothing dropped or nobody announced = None: training never stalls
        past the window on an absent joiner."""
        f = _res.injector().regrow_due(step, span)
        if f is None or not self.dropped:
            return None
        target = f.attrs.get("rank")
        candidates = (self.dropped if target is None
                      else (target,) if target in self.dropped else ())
        if not candidates:
            return None
        store = kv_store()
        gen = _state.kv_generation()
        key = _decision_key(gen, self.jid, step)
        g = _state.get_group(self.group)
        if _state.rank(self.group) == 0:
            window = _env.elastic_join_timeout_seconds()
            deadline = time.monotonic() + window
            while True:
                joiners = pending_joiners(store, self.jid, candidates)
                if (len(joiners) == len(candidates)
                        or time.monotonic() >= deadline):
                    break
                time.sleep(JOIN_POLL_MS / 1000.0)
            if not joiners:
                _res.kv_set(store, key, "null")
                return None
            plan = _proto.plan_regrow(self.members(), joiners, gen)
            for pid in joiners:  # consumed: never admitted twice
                _res.kv_call("delete", _proto.join_key(self.jid, pid),
                             lambda pid=pid: store.delete_key(
                                 _proto.join_key(self.jid, pid)))
            publish_admission(store, plan, self.jid, step)
            return plan
        try:
            raw = _res.wait_kv(
                store, key, _env.negotiation_timeout_ms(),
                pids=(g.ranks[0],),
                context=f"waiting for the coordinator's regrow plan at "
                        f"step {step}")
        except _res.KVTimeout as e:
            raise HorovodError(
                f"Elastic regrow: timed out waiting for the coordinator's "
                f"plan at step {step} (key {e.key}).") from e
        data = json.loads(raw)
        if data is None:
            return None
        members = tuple(int(r) for r in data["members"])
        return _proto.RegrowPlan(
            members=members,
            joined=tuple(sorted(set(members) - set(self.members()))),
            coordinator=int(data["coordinator"]),
            generation=int(data["generation"]))

    def commit_regrow(self, plan: _proto.RegrowPlan) -> None:
        """Apply a regrow plan: reconfigure group 0 over the admitted
        members, clear the rejoined ranks from the dropped set, stamp the
        timeline."""
        _state.reconfigure(plan.members)
        self.dropped = tuple(sorted(set(self.dropped) - set(plan.joined)))
        self.generation_history.append(_state.kv_generation())
        _note_transition("REGROW")

    def finish_regrow(self, t0: float) -> None:
        """Stamp the admission metric once the trainer has re-broadcast
        state and resumed the step loop."""
        _metrics["elastic_regrow_admit_ms"] = (
            (time.perf_counter() - t0) * 1000.0)

    # -- exchange-plan artifacts ---------------------------------------------

    def snapshot_live_plan(self, tag: str,
                           dropped: tuple[int, ...] = ()) -> None:
        """Record the current live exchange plan (``ops/exchange.py``
        ``last_plan``) stamped with elastic provenance — survivors = the
        group's current members at capture time. No live plan yet records
        nothing."""
        from horovod_tpu_torch.ops import exchange as _exchange

        plan = _exchange.last_plan()
        if plan is None:
            return
        stamped = plan.with_elastic(self.members(), dropped,
                                    _state.kv_generation())
        self.snapshots.append((tag, stamped))

    def save_artifacts(self, directory: str) -> list[str]:
        """Write every snapshot as ``<tag>.exchange.json``."""
        paths = []
        for tag, plan in self.snapshots:
            paths.append(plan.save(
                os.path.join(directory, f"{tag}.exchange.json")))
        return paths


# ---------------------------------------------------------------------------
# The store handshake of a regrow
# ---------------------------------------------------------------------------


def announce_join(store, jid: int, pid: int) -> None:
    """A (re)joining process announces itself. The join key is
    deliberately generation-free (``protocol.join_key``): the joiner
    cannot know the current generation — receiving it in the admission
    payload IS the handshake."""
    _res.kv_set(store, _proto.join_key(jid, pid),
                json.dumps({"pid": pid}, sort_keys=True))


def pending_joiners(store, jid: int, candidates) -> tuple[int, ...]:
    """Announced joiners among ``candidates`` (non-blocking reads — an
    absent key just means that worker has not announced)."""
    out = []
    for pid in sorted(set(int(p) for p in candidates)):
        try:
            if store.check([_proto.join_key(jid, pid)]):
                out.append(pid)
        except Exception:
            continue
    return tuple(out)


def _decision_key(generation: int, jid: int, step: int | None) -> str:
    # A boundary's own key: one generation may see several regrow
    # boundaries when nobody came to an earlier one.
    key = _proto.regrow_key(generation, jid)
    return key if step is None else f"{key}/s{step}"


def publish_admission(store, plan: _proto.RegrowPlan, jid: int = 0,
                      step: int | None = None) -> None:
    """Coordinator side of the admission: publish the plan under the OLD
    generation's regrow key (for the other members; ``step`` names the
    boundary's own key) and under each joiner's generation-free admit key
    (their handshake payload)."""
    payload = json.dumps({"members": list(plan.members),
                          "coordinator": plan.coordinator,
                          "generation": plan.generation}, sort_keys=True)
    _res.kv_set(store, _decision_key(plan.generation - 1, jid, step),
                payload)
    for pid in plan.joined:
        _res.kv_set(store, _proto.admit_key(jid, pid), payload)


def await_admission(store, jid: int, pid: int,
                    timeout_s: float | None = None) -> _proto.RegrowPlan:
    """Joiner side: block (bounded by the join window) until the
    coordinator's admission verdict lands, then adopt its plan."""
    if timeout_s is None:
        timeout_s = _env.elastic_join_timeout_seconds() or 30.0
    deadline = time.monotonic() + timeout_s
    key = _proto.admit_key(jid, pid)
    while True:
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            raise HorovodError(
                f"Elastic join timed out after {timeout_s:g}s waiting for "
                f"admission (key {key}); the coordinator admits joiners "
                f"only at step boundaries — raise "
                f"HOROVOD_ELASTIC_JOIN_TIMEOUT if boundaries are far "
                f"apart.")
        try:
            raw = _res.kv_get(store, key,
                              max(1, min(JOIN_POLL_MS,
                                         int(remaining * 1000))))
        except Exception as e:
            if _res.is_kv_timeout(e):
                continue
            raise
        data = json.loads(raw)
        return _proto.RegrowPlan(
            members=tuple(int(r) for r in data["members"]),
            joined=(pid,),
            coordinator=int(data["coordinator"]),
            generation=int(data["generation"]))


def _estep_key(generation: int, pid: int) -> str:
    return f"{_proto.KEY_PREFIX}/estep/g{generation}/p{pid}"


def agree_step(store, generation: int, pid: int, pids, step: int,
               timeout_s: float = 60.0) -> int:
    """The members agree on the last completed step after a transition:
    everyone publishes its local step under the NEW generation, reads
    every peer's, and adopts the minimum — the step every member has
    certainly completed. A joiner publishes ``sys.maxsize``: it has
    completed nothing of its own and constrains nothing."""
    _res.kv_set(store, _estep_key(generation, pid),
                json.dumps({"step": int(step)}))
    agreed = int(step)
    deadline = time.monotonic() + timeout_s
    for q in sorted(set(int(x) for x in pids)):
        if q == pid:
            continue
        remaining_ms = max(1, int((deadline - time.monotonic()) * 1000))
        try:
            raw = _res.kv_get(store, _estep_key(generation, q),
                              remaining_ms)
        except Exception as e:
            if _res.is_kv_timeout(e):
                raise HorovodError(
                    f"Elastic step agreement timed out waiting for "
                    f"process {q} (generation {generation}).") from e
            raise
        agreed = min(agreed, int(json.loads(raw)["step"]))
    return agreed


JOINER_STEP = sys.maxsize  # what a joiner publishes to agree_step


def rejoin(*, device=None, store=None,
           timeout_s: float | None = None) -> _proto.RegrowPlan:
    """A new process takes a dropped rank's place (``RANK`` in its
    environment): announce, wait for admission at a regrow boundary, and
    become a member of group 0 at the plan's generation — this process's
    ``hvd.init``. ``store`` is the world's rendezvous store (default: the
    one ``run.run`` recorded). ``Trainer.fit`` then takes the state from a
    current member and the step from :func:`agree_step`."""
    global _admitted
    base = store if store is not None else _state._rendezvous_store
    if base is None:
        raise HorovodError(
            "elastic.rejoin: no rendezvous store; pass the world's store "
            "(run.run records it for the processes it starts).")
    import torch.distributed as dist

    kv = dist.PrefixStore("horovod_tpu_torch", base)
    pid = int(os.environ["RANK"])
    announce_join(kv, 0, pid)
    plan = await_admission(kv, 0, pid, timeout_s)
    _res.kv_call("delete", _proto.admit_key(0, pid),
                 lambda: kv.delete_key(_proto.admit_key(0, pid)))
    _state.join(plan.members, plan.generation, base, device=device)
    _admitted = plan
    return plan


def take_admission() -> _proto.RegrowPlan | None:
    """The plan this joiner adopted, once (``Trainer.fit`` takes it)."""
    global _admitted
    plan, _admitted = _admitted, None
    return plan


def _reset_for_tests() -> None:
    global _admitted
    _metrics["elastic_shrink_recovery_ms"] = None
    _metrics["elastic_regrow_admit_ms"] = None
    _admitted = None

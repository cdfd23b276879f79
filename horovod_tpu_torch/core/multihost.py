"""Schedule validation: every rank must build the same program.

Counterpart of ``horovod_tpu/core/multihost.py::Negotiator.validate_schedule``
(the rest of that module — the per-tensor negotiation — is
``core/negotiate.py``). ``spmd`` records a program's ordered collective
schedule once (``core/context.py``) and calls :func:`validate_schedule`
before the program runs again; that one check covers every call the program
will serve, where eager collectives pay a store round each.

Over the world's store (``core/negotiate.py``), per group, with the group's
local rank 0 coordinating — the port's convention, where each group
negotiates on its own:

* every other member writes its schedule under ``protocol.sched_key(
  generation, "grp<group>/<tag>", epoch) + "/p<rank>"``;
* the coordinator reads each member's schedule, compares it with its own
  (``protocol.first_divergence``) and publishes the verdict under
  ``.../verdict``. While a member is missing it prints the reference's stall
  warning every ``HOROVOD_STALL_CHECK_TIME`` seconds; with
  ``HOROVOD_SCHEDULE_TIMEOUT`` set it gives up after that many seconds;
* every other member waits at most ``HOROVOD_NEGOTIATION_TIMEOUT`` for the
  verdict.

A divergence raises :class:`HorovodError` with the reference's text on every
member. The reference's verdict replay (``HOROVOD_EAGER_CACHE``) is not
ported.
"""

from __future__ import annotations

import json
import time

from horovod_tpu_torch.analysis import protocol as _proto
from horovod_tpu_torch.core import negotiate as _neg
from horovod_tpu_torch.core import state as _state
from horovod_tpu_torch.core.state import HorovodError
from horovod_tpu_torch.utils import env as _env


def _wait(neg: _neg.Negotiator, key: str, deadline: float | None,
          on_pause=None) -> bool:
    """Poll ``key`` until it exists (True) or ``deadline`` (monotonic
    seconds) passes (False); ``on_pause()`` runs between polls."""
    pause = _neg._POLL_MIN_S
    while not neg.has(key):
        if deadline is not None and time.monotonic() > deadline:
            return False
        if on_pause is not None:
            on_pause()
        time.sleep(pause)
        pause = min(2 * pause, _neg._POLL_MAX_S)
    return True


def _coordinate(neg: _neg.Negotiator, g: _state.Group, key: str, tag: str,
                schedule: list) -> str | None:
    """The coordinator's side: every member's schedule against its own;
    returns the first mismatch's message, or None."""
    cap_ms = _env.schedule_timeout_ms()
    error = None
    for p in range(1, g.size):
        t0 = last_warn = time.monotonic()

        def stall_or_give_up():
            nonlocal last_warn
            now = time.monotonic()
            if cap_ms and (now - t0) * 1000 > cap_ms:
                raise HorovodError(
                    f"Coordinator gave up waiting for process {p}'s "
                    f"collective schedule for program {tag} after "
                    f"{int(now - t0)} seconds (HOROVOD_SCHEDULE_TIMEOUT). "
                    f"The process has likely crashed or structurally "
                    f"diverged; restart the job once the failed host is "
                    f"back.")
            if (neg.stall_seconds > 0
                    and now - last_warn > neg.stall_seconds):
                last_warn = now
                print(f"WARNING: process {p} has not submitted its "
                      f"collective schedule for program {tag} after "
                      f"{int(now - t0)} seconds; it may still be "
                      f"tracing/compiling, or it may have diverged.",
                      flush=True)

        _wait(neg, f"{key}/p{p}", None, stall_or_give_up)
        other = json.loads(neg.get(f"{key}/p{p}"))
        neg.delete(f"{key}/p{p}")
        mismatch = _proto.first_divergence(schedule, other)
        if mismatch and not error:
            error = (
                f"Mismatched collective schedules across processes for "
                f"program {tag}: process 0 and process {p} diverge at "
                f"position {mismatch[0]}: {mismatch[1]} vs {mismatch[2]}. "
                f"All processes must build the same program; check for "
                f"process-dependent control flow or unnamed collectives "
                f"issued in different orders.")
    return error


def validate_schedule(tag: str, schedule: list, group: int = 0) -> None:
    """Cross-validate the ordered collective ``schedule`` of a freshly
    recorded program over ``group``: every member must have recorded the
    identical sequence (names, ops, dtypes, shapes, groups, roots).
    ``tag`` names the program (function and argument count). Collective
    over the group; a rank that is not a member returns at once."""
    g = _state.get_group(group)
    if g.pg is None or g.size == 1:
        return
    neg = _neg.negotiator()
    gen, epoch = neg.sched_index(group, tag)
    key = _proto.sched_key(gen, f"grp{group}/{tag}", epoch)
    me = g.group_rank_of(_state.global_rank())
    try:
        if me == 0:
            error = _coordinate(neg, g, key, tag, schedule)
            neg.set(f"{key}/verdict", json.dumps({"error": error}))
        else:
            neg.set(f"{key}/p{me}", json.dumps(schedule))
            deadline = time.monotonic() + _env.negotiation_timeout_ms() / 1e3
            if not _wait(neg, f"{key}/verdict", deadline):
                raise HorovodError(
                    f"Timed out waiting for the coordinator's schedule "
                    f"verdict for program {tag} "
                    f"(HOROVOD_NEGOTIATION_TIMEOUT). The coordinator may "
                    f"still be waiting on a slower process's trace, or "
                    f"this process's schedule diverged.")
            error = json.loads(neg.get(f"{key}/verdict")).get("error")
    except HorovodError:
        raise
    except RuntimeError as e:  # the store itself failed
        raise HorovodError(
            f"Coordination service failed while validating the schedule of "
            f"program {tag}: {e}") from e
    if error:
        raise HorovodError(error)

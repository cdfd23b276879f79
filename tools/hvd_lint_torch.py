"""hvd-lint for the PyTorch port: the static collective-schedule verifier
and the distributed-correctness lints, over ``horovod_tpu_torch`` programs.

The counterpart of ``tools/hvd_lint.py``, with its targets, flags, exit
codes and output:

* **Source lints** (``.py`` targets): AST rules HVD001-HVD007 —
  rank-conditional collectives, rank-dependent loops, auto-name drift,
  host syncs in hot paths, store calls in a program, unknown HOROVOD_*
  knobs, cross-group order divergence (``analysis/lints.py``, in the
  port's vocabulary).
* **Schedule checks** (``.hlo``/``.hlo.txt`` dumps, ``.sched.json``
  per-rank listings, ``.exchange.json`` exchange plans, ``.tuned.json``
  tuned configurations with their sibling plan, ``.journal.json`` serve
  journals): rules HVD101-HVD106.
* ``--schedule``: spawns a world of ``--ranks`` processes
  (``horovod_tpu_torch.run.run``; ``--device cuda``, the default, takes
  one card a rank over NCCL; ``--device cpu`` runs gloo) in which every
  rank records the wire calls of the LM training step and the members'
  listings are verified together: slices {1, 2, 4} (those that divide the
  world) x {flat, rs_ag, hierarchical} (hierarchical must refuse where a
  host holds one rank or the world is one host), ``exchange=priority`` and
  ``channels=2`` at each slice count, zero3 where a host holds two ranks
  or more (its fsdp axis is one host), and the sparse step under
  ``gather`` and ``dense``. Each arm's ``schedule_summary`` rows print.
  ``.world.json`` worlds belong to ``tools/hvd_model_torch.py``.

Usage:
    python tools/hvd_lint_torch.py horovod_tpu_torch tools/*_torch.py chip_smoke.py
    python tools/hvd_lint_torch.py plan.exchange.json dump.hlo
    python tools/hvd_lint_torch.py --schedule --device cpu --ranks 8
    python tools/hvd_lint_torch.py --schedule --ranks 4   # four GPUs
    python tools/hvd_lint_torch.py --list-rules

Exit status: 0 clean, 1 findings, 2 usage/internal error. Findings print
as ``path:line: RULE message``; suppress a deliberate pattern with a
``# hvd-lint: disable=HVD003`` comment on the flagged line. Imports no JAX;
without ``--schedule`` it does not import torch either.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

SOURCE_EXTS = (".py",)
HLO_EXTS = (".hlo", ".hlo.txt")
SCHED_EXTS = (".sched.json",)
EXCHANGE_EXTS = (".exchange.json",)
TUNED_EXTS = (".tuned.json",)
JOURNAL_EXTS = (".journal.json",)


def _import_analysis(full: bool = False):
    """The analysis layer. Unless ``full``, ``horovod_tpu_torch`` is loaded
    as a namespace so that its ``__init__`` (which imports torch) does not
    run: the analysis modules and the knob registry are stdlib-only."""
    if full:
        import horovod_tpu_torch  # noqa: F401
    elif "horovod_tpu_torch" not in sys.modules:
        import types

        stub = types.ModuleType("horovod_tpu_torch")
        stub.__path__ = [os.path.join(REPO, "horovod_tpu_torch")]
        sys.modules["horovod_tpu_torch"] = stub
    from horovod_tpu_torch.analysis import lints, report, schedule
    from horovod_tpu_torch.utils import env as env_mod
    return report, lints, schedule, env_mod


def _targets(paths: list[str]) -> list[str]:
    exts = (SOURCE_EXTS + HLO_EXTS + SCHED_EXTS + EXCHANGE_EXTS
            + TUNED_EXTS + JOURNAL_EXTS)
    out: list[str] = []
    for p in paths:
        if os.path.isdir(p):
            for root, dirs, files in os.walk(p):
                dirs[:] = sorted(d for d in dirs
                                 if d not in ("__pycache__", ".git"))
                for f in sorted(files):
                    full = os.path.join(root, f)
                    if full.endswith(exts):
                        out.append(full)
        elif os.path.exists(p):
            out.append(p)
        else:
            raise FileNotFoundError(f"no such target: {p}")
    return out


def check_file(path: str, lints, schedule, known_env) -> list:
    """The findings of one target, by its extension."""
    with open(path, "r", encoding="utf-8") as f:
        text = f.read()
    if path.endswith(JOURNAL_EXTS):
        return schedule.verify_journal_artifact(text, path)
    if path.endswith(TUNED_EXTS):
        return schedule.verify_tuned_config(text, path)
    if path.endswith(EXCHANGE_EXTS):
        return schedule.verify_exchange_artifact(text, path)
    if path.endswith(SCHED_EXTS):
        return schedule.verify_sched_listing(text, path)
    if path.endswith(HLO_EXTS):
        return schedule.verify_hlo_text(text, path)
    return lints.lint_source(text, path, known_env=known_env)


# -- the schedule gate (one world of ranks) -----------------------------------------


def _arm(lines, findings, label, call, summary=None):
    t0 = time.perf_counter()
    got = call()
    dt = time.perf_counter() - t0
    lines.append(f"  {label}: "
                 f"{'OK' if not got else f'{len(got)} finding(s)'} "
                 f"({dt:.2f} s)")
    if summary is not None:
        for row in summary:
            lines.append(f"    {row}")
    findings.extend(got)


def _gate_rank(device: str) -> dict:
    """One rank's part of the gate: every arm recorded and verified (each
    a collective over the world); returns the report lines and findings
    as tuples."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.analysis import report, schedule
    from horovod_tpu_torch.core.state import HorovodError
    from horovod_tpu_torch.ops import exchange as _exchange

    hvd.init(device=device)
    dev = None if device == "cuda" else device
    world = hvd.size()
    lines: list[str] = []
    findings: list = []

    def lm(slices, **kw):
        summary: list = []
        return (lambda: schedule.verify_lm_step(
            slices=slices, device=dev, summary=summary, **kw)), summary

    for slices in (1, 2, 4):
        if world % slices:
            continue
        for algo in ("flat", "rs_ag", "hierarchical"):
            label = f"lm-step algo={algo} slices={slices}"
            if algo == "hierarchical" and (slices == 1
                                           or world // slices < 2):
                try:
                    schedule.verify_lm_step(algo=algo, slices=slices,
                                            device=dev)
                except HorovodError:
                    lines.append(f"  {label}: infeasible (refused, as it "
                                 f"must)")
                    continue
                findings.append(report.Finding(
                    "HVD105", label, 1,
                    "hierarchical recorded on a topology with one rank a "
                    "host or one host instead of refusing."))
                continue
            call, summary = lm(slices, algo=algo)
            _arm(lines, findings, label, call, summary)
        for kw in ({"exchange": "priority"}, {"channels": 2},
                   {"sharding": "zero3"}):
            (k, v), = kw.items()
            if k == "sharding" and world // slices < 2:
                lines.append(f"  lm-step {k}={v} slices={slices}: skipped "
                             f"(an fsdp axis of one rank shards nothing)")
                continue
            call, summary = lm(slices, **kw)
            _arm(lines, findings,
                 f"lm-step {k}={v} slices={slices}", call, summary)
    for s_algo in ("gather", "dense"):
        label = f"sparse-step algo={s_algo}"

        def sparse(s_algo=s_algo, label=label):
            fn, args = schedule.sparse_step(algo=s_algo, device=dev)
            got = schedule.verify_step(fn, args, slices=1,
                                       path=f"<{label}>")
            plan = _exchange.last_plan()
            if plan is None or not plan.sparse_buckets:
                got.append(report.Finding(
                    "HVD103", f"<{label}>", 1,
                    "the recorded sparse step registered no sparse plan "
                    "rows — the gradient path bypassed the whole-step "
                    "scheduler."))
            else:
                got += schedule.verify_exchange_artifact(
                    plan.to_json(), f"<{label} plan={plan.plan_hash()}>")
            return got
        _arm(lines, findings, label, sparse)
    hvd.shutdown()
    return {"lines": lines,
            "findings": [(f.rule, f.path, f.line, f.message)
                         for f in findings]}


def schedule_gate(ranks: int = 8, device: str = "cuda") -> tuple:
    """Run the gate in a spawned world of ``ranks`` processes; returns
    ``(lines, findings)`` of rank 0, with a finding of its own where the
    ranks disagree. ``device="cuda"`` needs one card a rank."""
    import torch

    from horovod_tpu_torch.analysis.report import Finding
    from horovod_tpu_torch.run import run

    if device == "cuda" and torch.cuda.device_count() < ranks:
        raise RuntimeError(
            f"hvd-lint --schedule runs its world on the GPU, one card a "
            f"rank: {ranks} rank(s) need {ranks} card(s), "
            f"{torch.cuda.device_count()} visible. Pass --device cpu for "
            f"a gloo world on the CPU.")
    res = run(_gate_rank, ranks, device=device, args=(device,),
              timeout=1800.0)
    findings = [Finding(*f) for f in res[0]["findings"]]
    for r, other in enumerate(res[1:], start=1):
        if other["findings"] != res[0]["findings"]:
            findings.append(Finding(
                "HVD103", "<schedule-gate>", 1,
                f"rank {r} reported other findings than rank 0: the "
                f"verifier must give every member the same verdict."))
    return res[0]["lines"], findings


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="hvd-lint",
        description="Static collective-schedule verifier and "
                    "distributed-correctness lints (PyTorch port).")
    ap.add_argument("paths", nargs="*",
                    help=".py sources, .hlo/.hlo.txt dumps, .sched.json "
                         "per-rank listings, .exchange.json/.tuned.json/"
                         ".journal.json artifacts, or directories of them")
    ap.add_argument("--schedule", action="store_true",
                    help="also record and verify the LM training step in "
                         "a spawned world (see --ranks, --device)")
    ap.add_argument("--ranks", type=int, default=8,
                    help="world size of the --schedule gate (default 8)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the --schedule world runs (default cuda: "
                         "one card a rank; cpu: gloo)")
    ap.add_argument("--no-env-check", action="store_true",
                    help="skip flagging unknown HOROVOD_* variables "
                         "currently set in the environment")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalog and exit")
    args = ap.parse_args(argv)
    if args.ranks < 1:
        ap.error(f"--ranks must be >= 1, got {args.ranks}")

    report, lints, schedule, env_mod = _import_analysis(full=args.schedule)

    if args.list_rules:
        for rule in sorted(report.RULES):
            print(f"{rule}: {report.RULES[rule]}")
        return 0
    if not args.paths and not args.schedule and args.no_env_check:
        ap.error("nothing to do: pass targets, --schedule, or env check")
    try:
        targets = _targets(args.paths)
    except FileNotFoundError as e:
        ap.error(str(e))

    findings: list = []
    checked = 0
    for path in targets:
        findings.extend(check_file(path, lints, schedule,
                                   env_mod.KNOWN_ENV_VARS))
        checked += 1

    if not args.no_env_check:
        for name in env_mod.unknown_horovod_vars():
            findings.append(report.Finding(
                "HVD006", "<environment>", 1,
                f"unknown environment variable {name!r} is set: not a "
                f"horovod_tpu_torch knob (utils/env.py KNOWN_ENV_VARS) — "
                f"typo'd knob names are silently ignored."))

    if args.schedule:
        print(f"hvd-lint: schedule verification (LM training step, "
              f"{args.ranks} rank(s) on {args.device})")
        t0 = time.perf_counter()
        try:
            lines, got = schedule_gate(args.ranks, args.device)
        except RuntimeError as e:
            print(f"hvd-lint: {e}", file=sys.stderr)
            return 2
        print("\n".join(lines))
        print(f"hvd-lint: schedule gate took "
              f"{time.perf_counter() - t0:.1f} s")
        findings.extend(got)

    if findings:
        print(report.render(findings))
        print(f"hvd-lint: {len(findings)} finding(s) in {checked} "
              f"target(s).", file=sys.stderr)
        return 1
    print(f"hvd-lint: clean ({checked} target(s) checked"
          + (", schedule gate green" if args.schedule else "") + ").")
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except BrokenPipeError:  # e.g. `hvd_lint_torch.py --list-rules | head`
        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
        sys.exit(0)

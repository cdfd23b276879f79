"""hvd-model for the PyTorch port: the exhaustive-interleaving model
checker aimed at the port's per-group negotiation protocol
(horovod_tpu_torch/analysis/model.py).

The counterpart of ``tools/hvd_model.py``, with its targets, flags, exit
codes and output. The checker explores EVERY interleaving of N simulated
processes driving the protocol's transition functions
(horovod_tpu_torch/analysis/protocol.py — the same code core/negotiate.py,
core/resilience.py, core/elastic.py and training/checkpoint.py execute
live), checking HVD201-HVD206: verdict agreement, no deadlock, progress
under bounded transient faults, crash-safe restore, generation isolation
and per-group lockstep. Violations print a minimal counterexample trace.

Usage:
    python tools/hvd_model_torch.py                 # sweep the protocol
        # for N in {2,3} processes, with and without injected faults
        # (kv_timeout / torn_write / crash), the shrink and regrow specs,
        # the overlapping subset groups and the batched round
    python tools/hvd_model_torch.py world.world.json   # check worlds
    python tools/hvd_model_torch.py --faults 'kv_timeout@seq=2,times=3'
    python tools/hvd_model_torch.py --list-rules

Knobs: HOROVOD_MODEL_MAX_STATES caps the explored state count (exit 2 on
overflow — a sweep that did not finish must not pass as "clean");
HOROVOD_MODEL_FAULTS adds one fault spec to the sweep matrix (the
HOROVOD_FAULT_INJECT grammar). Both are validated at hvd.init.

Exit status: 0 clean, 1 findings, 2 usage/internal error (a crash cannot
pass as 'detected'). Findings print as ``path:line: RULE message``.
Imports neither JAX nor torch.
"""

from __future__ import annotations

import argparse
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

WORLD_EXTS = (".world.json",)


def _import_analysis():
    """Import the analysis layer with ``horovod_tpu_torch`` loaded as a
    namespace, so that its ``__init__`` (which imports torch) does not
    run: the checker and the knob registry are stdlib-only."""
    if "horovod_tpu_torch" not in sys.modules:
        import types

        stub = types.ModuleType("horovod_tpu_torch")
        stub.__path__ = [os.path.join(REPO, "horovod_tpu_torch")]
        sys.modules["horovod_tpu_torch"] = stub
    from horovod_tpu_torch.analysis import model, protocol, report
    from horovod_tpu_torch.utils import env as env_mod
    return report, protocol, model, env_mod


def run_sweep(model, protocol, *, max_states: int,
              extra_faults: str | None) -> list:
    """The standard-protocol sweep: N in {2,3}, fault-free + the default
    fault matrix + any extra spec from --faults/HOROVOD_MODEL_FAULTS."""
    findings: list = []
    for n in (2, 3):
        specs: list = [None] + model.default_fault_specs(n)
        if extra_faults:
            specs.append(extra_faults)
        for spec in specs:
            faults = protocol.parse_fault_spec(spec)
            for world in model.standard_worlds(n, faults):
                result = model.check_world(world, max_states=max_states)
                status = ("OK" if result.ok
                          else f"{len(result.findings)} finding(s)")
                print(f"  {world.label}: {result.states} states, "
                      f"{result.transitions} transitions, "
                      f"{result.terminals} terminal(s) — {status}")
                findings.extend(result.findings)
    return findings


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="hvd-model",
        description="Exhaustive-interleaving model checker for the "
                    "port's negotiation protocol (HVD201-HVD206).")
    ap.add_argument("paths", nargs="*",
                    help=".world.json fixture worlds (default: sweep the "
                         "shipped protocol for N in {2,3})")
    ap.add_argument("--sweep", action="store_true",
                    help="run the standard-protocol sweep in addition to "
                         "any fixture paths")
    ap.add_argument("--faults", default=None,
                    help="extra fault spec for the sweep "
                         "(HOROVOD_FAULT_INJECT grammar; default from "
                         "HOROVOD_MODEL_FAULTS)")
    ap.add_argument("--max-states", type=int, default=None,
                    help="state-count cap per world (default from "
                         "HOROVOD_MODEL_MAX_STATES, else "
                         "200000); exceeding it is an error, not a pass")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the HVD2xx rule catalog and exit")
    args = ap.parse_args(argv)

    report, protocol, model, env_mod = _import_analysis()

    if args.list_rules:
        for rule in sorted(report.RULES):
            if rule.startswith("HVD2"):
                print(f"{rule}: {report.RULES[rule]}")
        return 0

    try:
        max_states = (args.max_states if args.max_states is not None
                      else env_mod.model_max_states())
        extra_faults = (args.faults if args.faults is not None
                        else env_mod.model_faults())
        if args.faults is not None:
            protocol.parse_fault_spec(args.faults)
    except ValueError as e:
        ap.error(str(e))
    if max_states < 1:
        ap.error(f"--max-states must be >= 1, got {max_states}")

    findings: list = []
    checked = 0
    try:
        for path in args.paths:
            if not os.path.exists(path):
                ap.error(f"no such target: {path}")
            if not path.endswith(WORLD_EXTS):
                ap.error(f"{path} is not a .world.json world "
                         f"(hvd-lint owns the other fixture formats)")
            got = model.check_world_file(path, max_states=max_states)
            print(f"  {path}: "
                  f"{'OK' if not got else f'{len(got)} finding(s)'}")
            findings.extend(got)
            checked += 1
        if args.sweep or not args.paths:
            print("hvd-model: protocol sweep (N in {2,3}, with and "
                  "without injected faults)")
            findings.extend(run_sweep(model, protocol,
                                      max_states=max_states,
                                      extra_faults=extra_faults))
            checked += 1
    except model.ModelLimit as e:
        print(f"hvd-model: {e}", file=sys.stderr)
        return 2
    except ValueError as e:  # malformed world file / fault spec
        print(f"hvd-model: {e}", file=sys.stderr)
        return 2
    except Exception:  # pragma: no cover - checker bug
        # Internal error == exit 2, NEVER 1: the CI corpus gate requires
        # exit EXACTLY 1 per known-bad world precisely so a checker crash
        # cannot masquerade as 'detected'.
        import traceback

        traceback.print_exc()
        print("hvd-model: internal error (traceback above)",
              file=sys.stderr)
        return 2

    if findings:
        print(report.render(findings))
        print(f"hvd-model: {len(findings)} finding(s) in {checked} "
              f"target(s).", file=sys.stderr)
        return 1
    print(f"hvd-model: clean ({checked} target(s) checked).")
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except BrokenPipeError:  # e.g. `hvd_model_torch.py --list-rules | head`
        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
        sys.exit(0)

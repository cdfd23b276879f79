"""Finding model and rule catalog of the static verifier — a copy of
``horovod_tpu/analysis/report.py``.

One vocabulary for every check of the analysis layer, so each reports the
same ``path:line: RULE message`` shape. Stdlib-only: the port keeps its
own copy rather than importing the JAX package, whose ``__init__`` pulls
in jax. The catalog's texts are the reference's, byte for byte, so a
finding the port reports equals the JAX package's for the same input.
"""

from __future__ import annotations

import dataclasses

# Rule catalog. HVD0xx = source-level (layer 2, AST), HVD1xx = program-level
# (layer 1, collective schedule). Keep docs/analysis.md in sync.
RULES: dict[str, str] = {
    "HVD000": "unparsable source file: the linter could not build an AST "
              "(syntax/encoding error) — nothing in it was checked.",
    # -- layer 2: source lints ----------------------------------------------
    "HVD001": "rank-conditional collective: a collective is issued under a "
              "condition derived from hvd.rank()/local_rank()/global_rank() "
              "— ranks disagree on whether the collective runs, the classic "
              "Horovod deadlock (arXiv:1802.05799 §3).",
    "HVD002": "collective in a rank-dependent loop: the loop's trip count "
              "derives from the rank, so ranks issue different numbers of "
              "collectives and the extras block forever.",
    "HVD003": "auto-named collective under a conditional: the name comes "
              "from a per-process counter (_auto_name), so processes that "
              "take different branches permanently shift their name "
              "sequences and every later collective pairs with the wrong "
              "peer op. Pass an explicit name=.",
    "HVD004": "host sync inside a hot path: .item()/device_get/np.asarray "
              "on traced or per-step values blocks the host every step and "
              "defeats XLA dispatch-ahead pipelining.",
    "HVD005": "blocking KV/negotiation call inside a traced program: "
              "coordination-service I/O cannot run under jit/spmd — it "
              "either fails to trace or deadlocks the compiled step.",
    "HVD006": "unknown HOROVOD_* environment knob: not in the registry "
              "(horovod_tpu.utils.env.KNOWN_ENV_VARS) — a typo'd knob name "
              "is silently ignored, unlike typo'd values, which raise.",
    "HVD007": "group-order divergence: rank-conditional branches issue "
              "collectives on the same groups in different orders — the "
              "cross-group wait-for cycle that hangs overlapping groups.",
    # -- layer 1: collective-schedule checks --------------------------------
    "HVD101": "malformed replica_groups: rank out of range, rank repeated "
              "within one collective, non-uniform group sizes (the TPU "
              "backend rejects mixed sizes), or a partition matching no "
              "declared group/topology.",
    "HVD102": "wire-dtype mismatch: the collective moves a different "
              "element type than the bucket's declared wire dtype "
              "(Bucket.wire_dtype) — compression is not actually on the "
              "wire.",
    "HVD103": "per-rank schedule divergence: projecting the program onto "
              "each rank yields different collective sequences — the "
              "schedule is not identical across the world.",
    "HVD104": "cross-group wait-for cycle: the per-rank collective orders "
              "induce a cyclic wait between collectives — a guaranteed "
              "deadlock once every rank blocks.",
    "HVD105": "phase-shape mismatch: the extracted schedule does not match "
              "the declared decomposition (flat: one all-reduce; rs_ag: "
              "reduce-scatter then all-gather; hierarchical: intra RS -> "
              "cross AR -> intra AG).",
    "HVD106": "untrustworthy serve-journal artifact: per-record CRC or "
              "schema failure, a torn tail offered for audit, an "
              "inconsistent replay stream (duplicate admission, emit "
              "before admit or after close, non-monotone token run), or "
              "a post-deadline emission.",
    # -- protocol model checking (hvd-model, analysis/model.py) -------------
    "HVD201": "negotiation agreement violated: two members of one "
              "collective committed different verdicts (or different "
              "agreed epochs / shrink plans) for the same negotiation — "
              "a split-brain schedule.",
    "HVD202": "protocol deadlock: a reachable global state has running "
              "processes but no enabled transition — some process waits "
              "on a peer event that can never fire.",
    "HVD203": "progress violated under transient faults: injected "
              "kv_timeouts within the bounded retry budget wedged the "
              "sweep or failed a process.",
    "HVD204": "crash-unsafe restore: the agreed resume epoch is not "
              "loadable by every surviving rank, or a torn write was "
              "elected for restore.",
    "HVD205": "generation isolation violated: a process consumed a KV key "
              "from a previous generation after its bump — stale pre-"
              "crash coordination leaked into the resumed run.",
    "HVD206": "memberless lockstep violated: processes' negotiation-"
              "sequence counters diverged (a verdict-cache/memberless "
              "process replayed or negotiated out of step with the "
              "members).",
}


@dataclasses.dataclass(frozen=True)
class Finding:
    """One verifier/lint finding, printable as ``path:line: RULE message``."""

    rule: str
    path: str
    line: int
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: {self.rule} {self.message}"


def render(findings: list[Finding]) -> str:
    """Stable, sorted human output (path, then line, then rule)."""
    ordered = sorted(findings, key=lambda f: (f.path, f.line, f.rule))
    return "\n".join(str(f) for f in ordered)

"""Collective schedules: the counterpart of ``horovod_tpu/analysis/hlo.py``.

:class:`CollectiveInstr` is one collective of a schedule (opcode, element
type, shape, ``replica_groups`` partition, named scope, line), and
:func:`extract_schedule` parses HLO text into them with plain stdlib
regexes; :func:`parse_expectations` reads the ``hvd-lint-expect:`` header
of an ingested schedule file. Both are copied.

Where the reference lowers a JAX step to HLO and parses its collectives
(``step_hlo``), the port records them: :func:`step_wire` runs one rank's
step under a dry wire recorder (``ops/wire.py``), which sees every
``torch.distributed`` call of the data path and moves nothing, and returns
the rank's listing in the same vocabulary; :func:`merge_listings` makes one
program of every member's listing, so ``analysis/schedule.py``'s checks
(per-rank identity among them) run over the real per-rank listings. The
parser and the merge are stdlib-only; torch loads inside
:func:`step_wire` alone.
"""

from __future__ import annotations

import dataclasses
import re

# Collective opcodes that constitute the schedule. `-start` variants (async
# TPU lowering) count as the op; `-done` completions are skipped so an async
# pair is one schedule entry.
COLLECTIVE_OPCODES = (
    "all-reduce",
    "reduce-scatter",
    "all-gather",
    "all-to-all",
    "collective-permute",
)

# Named scopes the framework stamps around collective phases
# (ops/strategy.py `_phase`, ops/collectives.py `_compressed_psum`).
PHASE_SCOPES = (
    "REDUCE_SCATTER",
    "CROSS_SLICE",
    "ALL_GATHER",
    "QUANTIZE",
    "DEQUANTIZE",
)

_OP_RE = re.compile(
    r"^\s*(?:ROOT\s+)?%?(?P<iname>[\w.\-]+)\s*=\s*"
    r"(?P<shape>\([^)]*\)|[\w\[\],{}]+)\s+"
    r"(?P<opcode>" + "|".join(COLLECTIVE_OPCODES) + r")"
    r"(?P<async>-start|-done)?\(")
_SHAPE_RE = re.compile(r"(?P<etype>[a-z]+\d*)\[(?P<dims>[\d,]*)\]")
_GROUPS_RE = re.compile(r"replica_groups=\{(?P<body>[\d,{} ]*)\}")
_GROUPS_IOTA_RE = re.compile(
    r"replica_groups=\[(?P<g>\d+),(?P<s>\d+)\]<=\[(?P<w>\d+)\]"
    r"(?P<t>T\(1,0\))?")
_OPNAME_RE = re.compile(r'op_name="(?P<op_name>[^"]*)"')

# HLO element-type byte widths (pred is bit-packed conceptually but moves
# as a byte on the wire).
_ITEMSIZE = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8,
    "c64": 8, "c128": 16, "s4": 1, "u4": 1, "f8e4m3fn": 1, "f8e5m2": 1,
}


@dataclasses.dataclass(frozen=True)
class CollectiveInstr:
    """One collective in the extracted schedule.

    ``replica_groups`` is a tuple of rank tuples, or ``None`` when the op
    names no groups (XLA semantics: all replicas form one group).
    ``wire_bytes`` is the instruction result payload (elements x itemsize)
    — for an all-gather that is the gathered size, for a reduce-scatter the
    shard; the canonical schedule key uses it together with the opcode so
    phase structure, not absolute byte accounting, is what must match.
    ``scope`` is the innermost framework named scope (PHASE_SCOPES) when
    the text carries op metadata, else ``None``.
    """

    opcode: str
    element_type: str
    shape: tuple[int, ...]
    replica_groups: tuple[tuple[int, ...], ...] | None
    wire_bytes: int
    scope: str | None
    op_name: str | None
    instr_name: str
    line: int  # 1-indexed line in the source text

    @property
    def numel(self) -> int:
        n = 1
        for d in self.shape:
            n *= d
        return n

    def key(self, rank_group_size: int | None = None) -> tuple:
        """Canonical identity for schedule comparison: what must agree
        across ranks/topologies-of-equal-shape for the schedule to be
        'the same collective'."""
        gshape = (None if self.replica_groups is None
                  else (len(self.replica_groups),
                        len(self.replica_groups[0])
                        if self.replica_groups else 0))
        base = (self.opcode, self.element_type, self.numel, gshape,
                self.scope)
        return base if rank_group_size is None else base + (rank_group_size,)

    def describe(self) -> str:
        groups = ("all" if self.replica_groups is None
                  else "x".join(str(len(g)) for g in self.replica_groups[:1])
                       + f"*{len(self.replica_groups)}")
        scope = f" scope={self.scope}" if self.scope else ""
        return (f"{self.opcode} {self.element_type}{list(self.shape)} "
                f"groups={groups} {self.wire_bytes}B{scope}")


def _parse_shape(text: str) -> tuple[str, tuple[int, ...]]:
    """First (element_type, dims) in an HLO shape string; tuple shapes
    (variadic all-reduce) report their first element."""
    m = _SHAPE_RE.search(text)
    if not m:
        return "unknown", ()
    dims = tuple(int(d) for d in m.group("dims").split(",") if d != "")
    return m.group("etype"), dims


def _parse_groups(line: str):
    m = _GROUPS_RE.search(line)
    if m:
        body = m.group("body").strip()
        if not body:
            return None
        groups = []
        for grp in re.findall(r"\{([\d, ]*)\}", "{" + body + "}"
                              if "{" not in body else body):
            groups.append(tuple(int(r) for r in grp.replace(" ", "")
                                .split(",") if r != ""))
        return tuple(g for g in groups if g) or None
    m = _GROUPS_IOTA_RE.search(line)
    if m:  # iota form [g,s]<=[w] (optionally transposed): expand explicitly
        g, s, w = int(m.group("g")), int(m.group("s")), int(m.group("w"))
        ranks = list(range(w))
        if m.group("t"):  # T(1,0): column-major fill
            return tuple(tuple(ranks[j * g + i] for j in range(s))
                         for i in range(g))
        return tuple(tuple(ranks[i * s: (i + 1) * s]) for i in range(g))
    return None


def _parse_scope(line: str) -> tuple[str | None, str | None]:
    m = _OPNAME_RE.search(line)
    if not m:
        return None, None
    op_name = m.group("op_name")
    scope = None
    for part in reversed(op_name.split("/")):
        if part in PHASE_SCOPES:
            scope = part
            break
    return scope, op_name


def extract_schedule(hlo_text: str) -> list[CollectiveInstr]:
    """The ordered collective schedule of an HLO module's text form.

    Order is textual program order — HLO text prints each computation's
    instructions in (post-scheduling) execution order, which for the
    single-computation step programs this repo emits IS the collective
    issue order every replica follows.
    """
    out: list[CollectiveInstr] = []
    for lineno, line in enumerate(hlo_text.splitlines(), start=1):
        m = _OP_RE.match(line)
        if m is None or m.group("async") == "-done":
            continue
        etype, dims = _parse_shape(m.group("shape"))
        numel = 1
        for d in dims:
            numel *= d
        scope, op_name = _parse_scope(line)
        out.append(CollectiveInstr(
            opcode=m.group("opcode"),
            element_type=etype,
            shape=dims,
            replica_groups=_parse_groups(line),
            wire_bytes=numel * _ITEMSIZE.get(etype, 1),
            scope=scope,
            op_name=op_name,
            instr_name=m.group("iname"),
            line=lineno,
        ))
    return out


_EXPECT_RE = re.compile(r"hvd-lint-expect:\s*(?P<body>.*)")


def parse_expectations(text: str) -> dict[str, str]:
    """``hvd-lint-expect: key=value [key=value ...]`` headers in an ingested
    schedule file — the declared contract (world size, wire dtype, algo)
    the schedule is verified against."""
    out: dict[str, str] = {}
    for line in text.splitlines():
        m = _EXPECT_RE.search(line)
        if not m:
            continue
        for item in m.group("body").split():
            if "=" in item:
                k, v = item.split("=", 1)
                out[k.strip()] = v.strip()
    return out


# ---------------------------------------------------------------------------
# Recorded schedules (torch is imported inside step_wire only).
# ---------------------------------------------------------------------------


def step_wire(fn, args, group: int = 0) -> list[CollectiveInstr]:
    """This rank's collective listing of ``fn(*args)`` run as one step of
    a program over ``group`` (``core/context.py``: the collectives
    register and skip the per-call negotiation, as in the reference's
    trace). The recording is dry: nothing moves on the wire, so a step
    whose ranks diverge is recorded instead of hanging. The listing's
    ``replica_groups`` are positions in ``group``, the reference's mesh
    coordinates. The live auto-name counters are left where they were."""
    from horovod_tpu_torch.core import context as _ctx
    from horovod_tpu_torch.core import state as _state
    from horovod_tpu_torch.ops import collectives as _coll
    from horovod_tpu_torch.ops import wire as _wire

    g = _state.get_group(group)
    with _coll.preserve_auto_names(), _wire.recording(dry=True) as rec, \
            _ctx.enter(group):
        fn(*args)
    pos = {r: i for i, r in enumerate(g.ranks)}
    return [dataclasses.replace(ins, replica_groups=tuple(
                tuple(pos.get(r, r) for r in grp)
                for grp in ins.replica_groups))
            if ins.replica_groups is not None else ins
            for ins in rec.instrs]


def merge_listings(listings) -> list[CollectiveInstr]:
    """One program from every member's listing (``listings[r]``: group-
    local rank r's): position i of the program holds what the members
    issued i-th. Where every member issued the same collective on the same
    partition, that is one instruction; where they differ, each distinct
    (collective, partition) is an instruction of its own whose groups are
    cut to the members that issued it, so projecting the program onto a
    rank gives back that rank's own listing and a divergence surfaces as
    the reference's per-rank identity finding (HVD103)."""
    out: list[CollectiveInstr] = []
    depth = max((len(lst) for lst in listings), default=0)
    for i in range(depth):
        classes: dict[tuple, list] = {}
        for r, lst in enumerate(listings):
            if i >= len(lst):
                continue
            ins = lst[i]
            k = (ins.opcode, ins.element_type, ins.shape, ins.scope,
                 ins.replica_groups)
            classes.setdefault(k, [ins, []])[1].append(r)
        whole = len(classes) == 1 and all(len(lst) > i for lst in listings)
        for ins, ranks in classes.values():
            groups = ins.replica_groups
            if not whole:
                have = set(ranks)
                groups = tuple(cut for cut in (
                    tuple(x for x in grp if x in have)
                    for grp in (groups or (tuple(range(len(listings))),)))
                    if cut)
            out.append(dataclasses.replace(ins, replica_groups=groups,
                                           line=i + 1))
    return out

"""Layer 1 back-end: verify an extracted collective schedule statically.

The dynamic contract ``core/negotiate.py`` enforces at runtime — every
process executes the same collectives in the same order, on well-formed
groups — is checked here *ahead of time* on the schedule
``analysis/hlo.py`` extracts from a lowered step (or from ingested
HLO/schedule text). Checks, each mapping to a rule in
``analysis/report.RULES``:

* **HVD101** replica_groups well-formedness: ranks in range, no rank twice
  in one collective, uniform group sizes (the TPU backend rejects mixed
  sizes — ops/collectives.py ``_traced_groups_arg``), and, when the caller
  declares the legal partitions (full axis / intra-slice / cross-slice from
  the simulated topology), membership consistency with them.
* **HVD102** wire dtype: payload collectives move exactly the dtype the
  compression contract (``Bucket.wire_dtype``) declares.
* **HVD103** per-rank schedule identity: projecting the program onto every
  rank yields one identical collective sequence.
* **HVD104** cross-group wait-for acyclicity: the per-rank orders induce no
  cyclic wait between collectives (the overlapping-groups deadlock the
  fork's ``group=`` API makes possible).
* **HVD105** phase shape: the schedule matches the declared decomposition
  (``flat``/``rs_ag``/``hierarchical`` — ops/strategy.py) including the
  two-level intra/cross partition structure of ``hierarchical``.

Pure functions over :class:`~horovod_tpu_torch.analysis.hlo.CollectiveInstr`
records plus per-rank listings.

This is the verifier layer of ``horovod_tpu/analysis/schedule.py``, copied
(its findings' texts byte for byte): the checks above, the committed
artifacts' verifiers (:func:`verify_exchange_artifact`,
:func:`verify_journal_artifact`, :func:`verify_tuned_config`) and the
ingested-text entry points. The tuned-config verifier reads the port's
own artifact schema and knob registry (``tune/artifact.py``).

The end-to-end drivers at the end (:func:`lm_step`, :func:`gradient_step`,
:func:`fsdp_step`, :func:`sparse_step`, :func:`verify_step`,
:func:`verify_lm_step`) keep the reference's names and parameters. Where
the reference lowers a JAX step on one controller, each rank here records
the wire calls its step makes (``analysis/hlo.py::step_wire``); the
members' listings are gathered and merged into one program, so every
member returns the same findings. They run on the card unless the caller
passes ``device="cpu"``.
"""


from __future__ import annotations

import json
import os
import zlib

from horovod_tpu_torch.analysis import protocol as _proto
from horovod_tpu_torch.analysis.report import Finding

# compression name -> HLO element type its buckets move on the wire
# (ops/compression.py wire_dtype: bf16 for bf16, int8/int8_block for s8;
# int4 rides s8 carrier bytes, two elements nibble-packed per byte).
WIRE_ETYPE = {"none": None, "bf16": "bf16", "int8": "s8",
              "int8_block": "s8", "int4": "s8"}

# Compressors whose scale metadata is a VECTOR exchange (one fp32 scale
# per >=8-element block, ops/compression.py _BlockCompressor) rather than
# the scalar pmax the numel<=1 exemption already covers.
BLOCK_COMPRESSORS = ("int8_block", "int4")

# Compressors whose wire is never summed in the collective: reductions
# are gather-based (ops/strategy.py lower_gathered), so the phase shape
# differs from the psum lowerings.
GATHERED_COMPRESSORS = ("int4",)


def wire_contract(compression: str | None, algo: str | None,
                  world_size: int | None = None
                  ) -> tuple[str | None, str | None, bool]:
    """``(wire_etype, cross_etype, block_scales)`` — what HVD102 must
    hold a schedule to under ``compression``. Phase-asymmetric formats
    (int8_block/int4) on ``hierarchical`` declare NO single wire dtype:
    the cross-slice DCN hop must move ``cross_etype`` while the
    intra-slice ICI phases move full-precision/bf16 payloads (the
    ops/compression.py ``resolve_phase_formats`` policy). ``world_size``
    (the in-wire sum width on the flat/rs_ag paths) tracks int8_block's
    widened accumulator: past 127 summing ranks the runtime moves an
    int16 wire (``Int8BlockCompressor.sum_budget`` — the 127/32767
    thresholds are mirrored here because this layer must stay
    importable without jax). An explicit ``cross_compression`` override
    is outside this name-level contract — verify those via the exchange
    ARTIFACT, which carries per-bucket per-phase dtypes."""
    comp = compression or "none"
    block = comp in BLOCK_COMPRESSORS
    if block and algo == "hierarchical":
        return None, WIRE_ETYPE[comp], block
    if block and algo not in ("flat", "rs_ag"):
        # auto / undeclared: the cost model may pick hierarchical per
        # bucket, whose phase-asymmetric lowering legitimately moves
        # f32/bf16 ICI phases — no single-wire contract to enforce (the
        # check_phases auto escape, mirrored). bf16/int8 stay checked:
        # they move one wire dtype under every decomposition.
        return None, None, block
    wire = WIRE_ETYPE.get(comp, comp if comp != "none" else None)
    if comp == "int8_block" and world_size is not None and world_size > 127:
        wire = "s16"  # widened accumulator (<=32767; refused beyond)
    return wire, None, block


def _groups_as_partition(groups) -> frozenset:
    """Order-insensitive membership form of a replica_groups value."""
    return frozenset(tuple(sorted(g)) for g in groups)


def expected_partitions(world_size: int, num_slices: int = 1,
                        fsdp_size: int | None = None) -> list:
    """The partitions a step traced on a ``num_slices``-slice world of
    ``world_size`` ranks may legally use: the full axis, the intra-slice
    blocks, and the cross-slice (same-local-index) columns — exactly the
    ``axis_index_groups`` ops/strategy.py emits. ``fsdp_size`` (the
    ``data × fsdp`` mesh of ops/mesh.py, rank r = d*F + f) additionally
    admits the contiguous fsdp blocks and the strided data columns; at
    the default layout (fsdp == slice) these coincide with the two-level
    partitions and add nothing."""
    full = [tuple(range(world_size))]
    parts = [full]
    if num_slices > 1 and world_size % num_slices == 0:
        local = world_size // num_slices
        intra = [tuple(range(s * local, (s + 1) * local))
                 for s in range(num_slices)]
        cross = [tuple(s * local + j for s in range(num_slices))
                 for j in range(local)]
        parts += [intra, cross]
    if fsdp_size and 1 < fsdp_size < world_size \
            and world_size % fsdp_size == 0:
        dsize = world_size // fsdp_size
        fblocks = [tuple(range(d * fsdp_size, (d + 1) * fsdp_size))
                   for d in range(dsize)]
        dcols = [tuple(d * fsdp_size + f for d in range(dsize))
                 for f in range(fsdp_size)]
        seen = {_groups_as_partition(p) for p in parts}
        for p in (fblocks, dcols):
            if _groups_as_partition(p) not in seen:
                parts.append(p)
    return parts


def check_wellformed(instrs, world_size: int, path: str = "<schedule>",
                     partitions=None) -> list[Finding]:
    """HVD101: structural validity of every collective's replica_groups."""
    findings: list[Finding] = []
    allowed = (None if partitions is None
               else {_groups_as_partition(p) for p in partitions})
    for ins in instrs:
        groups = ins.replica_groups
        if groups is None:
            continue
        seen: dict[int, int] = {}
        for g in groups:
            for r in g:
                if not 0 <= r < world_size:
                    findings.append(Finding(
                        "HVD101", path, ins.line,
                        f"{ins.opcode} names rank {r}, outside the "
                        f"{world_size}-rank world."))
                if r in seen:
                    findings.append(Finding(
                        "HVD101", path, ins.line,
                        f"{ins.opcode} lists rank {r} in two replica "
                        f"groups — groups must be disjoint."))
                seen[r] = 1
        sizes = {len(g) for g in groups}
        if len(sizes) > 1:
            findings.append(Finding(
                "HVD101", path, ins.line,
                f"{ins.opcode} has non-uniform replica group sizes "
                f"{sorted(sizes)}; the TPU backend requires equal-sized "
                f"groups (axis_index_groups lowering)."))
        elif allowed is not None:
            part = _groups_as_partition(groups)
            if part not in allowed:
                findings.append(Finding(
                    "HVD101", path, ins.line,
                    f"{ins.opcode} replica_groups "
                    f"{[list(g) for g in groups]} match no declared "
                    f"group/topology partition of the "
                    f"{world_size}-rank world."))
    return findings


_INTRA_OK_ETYPES = ("f32", "f64", "bf16")  # full-precision/bf16 ICI phases


def _is_scale_exchange(ins, instrs, block_scales: bool) -> bool:
    """Scale-tensor collectives are exempt from HVD102: the scalar
    per-bucket pmax (numel <= 1, as today), and — for the block
    compressors — the per-block scale VECTOR exchange: one fp32 scale
    per >= 8-element block (``HOROVOD_COMPRESSION_BLOCK`` enforces the
    floor), so a scale tensor is always >= 8x smaller than the largest
    payload in the schedule. The size gate keeps HVD102's teeth: the
    payload collectives (the large ones) are always checked. The
    QUANTIZE named scope is also honored when the ingested text carries
    op metadata (lowered-by-default CPU HLO often does not)."""
    if ins.numel <= 1:
        return True
    if ins.scope == "QUANTIZE":
        return True
    if not block_scales:
        return False
    if ins.element_type not in ("f32", "f64"):
        return False
    max_numel = max((i.numel for i in instrs), default=0)
    return ins.numel * 8 <= max_numel


def check_wire_dtype(instrs, wire_etype: str | None,
                     path: str = "<schedule>",
                     cross_etype: str | None = None,
                     partitions=None,
                     block_scales: bool = False) -> list[Finding]:
    """HVD102: payload collectives move the declared wire dtype(s).

    Single-wire contract (``wire_etype``): every payload collective
    moves it — the pre-existing check. Per-PHASE contract
    (``cross_etype``, the phase-asymmetric hierarchical policy): payload
    on the cross-slice partition (``partitions[2]``) must move
    ``cross_etype``, payload on the intra-slice partition
    (``partitions[1]``) must stay full-precision/bf16 — quantized ICI
    phases mean the asymmetric policy silently collapsed to
    whole-collective compression. Scale-tensor exchanges are exempt
    (:func:`_is_scale_exchange`)."""
    if wire_etype is None and cross_etype is None:
        return []
    findings = []
    intra_part = cross_part = None
    if cross_etype is not None and partitions and len(partitions) >= 3:
        intra_part = _groups_as_partition(partitions[1])
        cross_part = _groups_as_partition(partitions[2])
    for ins in instrs:
        if _is_scale_exchange(ins, instrs, block_scales):
            continue
        if cross_etype is not None:
            if ins.replica_groups is None:
                continue  # full-axis: not a phase of this decomposition
            part = _groups_as_partition(ins.replica_groups)
            if part == cross_part:
                if ins.element_type != cross_etype:
                    findings.append(Finding(
                        "HVD102", path, ins.line,
                        f"cross-slice {ins.opcode} moves "
                        f"{ins.element_type} but the declared DCN wire "
                        f"dtype (Bucket.cross_wire_dtype) is "
                        f"{cross_etype} — the expensive hop is not "
                        f"compressed."))
            elif part == intra_part:
                if ins.element_type not in _INTRA_OK_ETYPES:
                    findings.append(Finding(
                        "HVD102", path, ins.line,
                        f"intra-slice {ins.opcode} moves "
                        f"{ins.element_type}: the phase-asymmetric "
                        f"policy keeps ICI phases at full-precision/"
                        f"bf16 payloads (quantize only the cross-slice "
                        f"hop)."))
            continue
        if ins.element_type != wire_etype:
            findings.append(Finding(
                "HVD102", path, ins.line,
                f"{ins.opcode} moves {ins.element_type} but the declared "
                f"wire dtype (Bucket.wire_dtype) is {wire_etype} — "
                f"compression is not on the wire."))
    return findings


def project_per_rank(instrs, world_size: int) -> dict[int, list]:
    """Rank r's schedule: the ordered sub-list of collectives r
    participates in, each keyed with r's group size (the value the rank
    observes on the wire)."""
    out: dict[int, list] = {r: [] for r in range(world_size)}
    for idx, ins in enumerate(instrs):
        if ins.replica_groups is None:
            for r in range(world_size):
                out[r].append((idx, ins.key(world_size)))
            continue
        for g in ins.replica_groups:
            for r in g:
                if 0 <= r < world_size:
                    out[r].append((idx, ins.key(len(g))))
    return out


def check_identity(instrs, world_size: int,
                   path: str = "<schedule>") -> list[Finding]:
    """HVD103: every rank's projected schedule is one identical sequence."""
    per_rank = project_per_rank(instrs, world_size)
    ref_rank = 0
    ref = per_rank.get(ref_rank, [])
    findings = []
    for r in range(1, world_size):
        mine = per_rank[r]
        if [k for _, k in mine] == [k for _, k in ref]:
            continue
        # Name the first diverging position for the report.
        pos = next((i for i, (a, b) in enumerate(zip(ref, mine))
                    if a[1] != b[1]), min(len(ref), len(mine)))
        at = (instrs[mine[pos][0]] if pos < len(mine)
              else instrs[ref[pos][0]] if pos < len(ref) else None)
        line = at.line if at is not None else 1
        findings.append(Finding(
            "HVD103", path, line,
            f"rank {r}'s schedule diverges from rank {ref_rank}'s at "
            f"position {pos} ({len(mine)} vs {len(ref)} collectives) — "
            f"per-rank schedules must be identical."))
    return findings


def check_wait_cycle(rank_orders: dict, path: str = "<schedule>",
                     lines: dict | None = None) -> list[Finding]:
    """HVD104: the union of per-rank issue orders is a DAG.

    ``rank_orders`` maps rank -> ordered list of hashable collective tags.
    A tag may legitimately repeat within one rank's order (the same named
    collective issued once per step); occurrences are matched up across
    ranks — the k-th issue of tag t on every rank is one event — so a
    repeated tag in an identical-everywhere order is NOT a cycle. Edges
    run between consecutive occurrence-events per rank (each rank's order
    is a path, so consecutive edges carry the full reachability); a cycle
    in the union means two ranks block on each other's unreached
    collective — the deadlock the coordinator exists to prevent
    (arXiv:1802.05799 §3)."""
    edges: dict = {}
    for order in rank_orders.values():
        seen_count: dict = {}
        prev = None
        for tag in order:
            k = seen_count.get(tag, 0)
            seen_count[tag] = k + 1
            node = (tag, k)
            if prev is not None and prev != node:
                edges.setdefault(prev, set()).add(node)
            prev = node
    # Iterative coloring DFS (schedules can be thousands of collectives
    # long — no recursion limit, no per-level stack copies).
    WHITE, GREY, BLACK = 0, 1, 2
    color: dict = {}
    cycle: list = []
    for root in list(edges):
        if color.get(root, WHITE) != WHITE:
            continue
        stack = [(root, iter(edges.get(root, ())))]
        color[root] = GREY
        while stack and not cycle:
            node, it = stack[-1]
            nxt = next(it, None)
            if nxt is None:
                color[node] = BLACK
                stack.pop()
                continue
            c = color.get(nxt, WHITE)
            if c == GREY:
                on_path = [n for n, _ in stack]
                cycle = on_path[on_path.index(nxt):]
            elif c == WHITE:
                color[nxt] = GREY
                stack.append((nxt, iter(edges.get(nxt, ()))))
        if cycle:
            break
    if not cycle:
        return []

    def show(node):
        tag, k = node
        return str(tag) if k == 0 else f"{tag}#{k}"

    loop = " -> ".join(show(n) for n in cycle + [cycle[0]])
    line = (lines or {}).get(cycle[0][0], 1)
    return [Finding(
        "HVD104", path, line,
        f"cross-group wait-for cycle: {loop} — ranks disagree on the "
        f"issue order of these collectives, which deadlocks once every "
        f"rank blocks on its first unmatched op.")]


def check_phases(instrs, algo: str, path: str = "<schedule>",
                 num_slices: int = 1,
                 world_size: int | None = None,
                 compression: str | None = None) -> list[Finding]:
    """HVD105: the payload schedule matches ``algo``'s declared shape.

    ``compression`` names the wire format when its lowering changes the
    phase shape: unsummable formats (int4) reduce via GATHERS
    (ops/strategy.py ``lower_gathered`` / the cross-slice gather of
    ``lower_hierarchical_asym``), so flat is an all-gather (not an
    all-reduce), rs_ag is all-to-all + all-gather, and hierarchical's
    cross hop is a cross-partition all-gather."""
    payload = [i for i in instrs if i.numel > 1]
    findings = []
    line = payload[0].line if payload else (instrs[0].line if instrs else 1)

    def ops(opcode):
        return [i for i in payload if i.opcode == opcode]

    if compression in GATHERED_COMPRESSORS:
        return _check_phases_gathered(payload, algo, path, line,
                                      num_slices, world_size, ops,
                                      findings)
    if algo == "flat":
        extra = [i for i in payload if i.opcode != "all-reduce"]
        if extra:
            findings.append(Finding(
                "HVD105", path, extra[0].line,
                f"algo=flat must lower to all-reduce only, found "
                f"{extra[0].opcode}."))
        elif not ops("all-reduce"):
            findings.append(Finding(
                "HVD105", path, line,
                "algo=flat produced no payload all-reduce."))
        return findings
    if algo == "rs_ag":
        rs, ag = ops("reduce-scatter"), ops("all-gather")
        if not rs or not ag:
            findings.append(Finding(
                "HVD105", path, line,
                f"algo=rs_ag needs reduce-scatter + all-gather phases, "
                f"found {[i.opcode for i in payload]}."))
        elif rs[0].line > ag[-1].line:
            findings.append(Finding(
                "HVD105", path, ag[-1].line,
                "algo=rs_ag phases out of order: all-gather precedes "
                "reduce-scatter."))
        if ops("all-reduce"):
            findings.append(Finding(
                "HVD105", path, ops("all-reduce")[0].line,
                "algo=rs_ag must not move payload through a flat "
                "all-reduce."))
        return findings
    if algo == "hierarchical":
        rs, ar, ag = (ops("reduce-scatter"), ops("all-reduce"),
                      ops("all-gather"))
        if not (rs and ar and ag):
            findings.append(Finding(
                "HVD105", path, line,
                f"algo=hierarchical needs reduce-scatter -> cross-slice "
                f"all-reduce -> all-gather, found "
                f"{[i.opcode for i in payload]}."))
            return findings
        if world_size and num_slices > 1:
            local = world_size // num_slices
            intra = _groups_as_partition(
                expected_partitions(world_size, num_slices)[1])
            cross = _groups_as_partition(
                expected_partitions(world_size, num_slices)[2])
            for i in rs + ag:
                if (i.replica_groups is not None
                        and _groups_as_partition(i.replica_groups) != intra):
                    findings.append(Finding(
                        "HVD105", path, i.line,
                        f"hierarchical {i.opcode} must run on the "
                        f"intra-slice partition ({num_slices} groups of "
                        f"{local})."))
            for i in ar:
                if (i.replica_groups is not None
                        and _groups_as_partition(i.replica_groups) != cross):
                    findings.append(Finding(
                        "HVD105", path, i.line,
                        f"hierarchical all-reduce must run on the "
                        f"cross-slice partition ({local} groups of "
                        f"{num_slices})."))
        return findings
    return findings  # auto / unknown: per-bucket choice, no fixed shape


def _check_phases_gathered(payload, algo, path, line, num_slices,
                           world_size, ops, findings) -> list[Finding]:
    """HVD105 shapes for unsummable (gather-reduced) wire formats."""
    if algo == "flat":
        extra = [i for i in payload if i.opcode != "all-gather"]
        if extra:
            findings.append(Finding(
                "HVD105", path, extra[0].line,
                f"algo=flat with an unsummable wire (int4) must lower to "
                f"a gather-based exchange (all-gather + local sum), "
                f"found {extra[0].opcode} — an integer-summing "
                f"collective would overflow the 4-bit budget."))
        elif not ops("all-gather"):
            findings.append(Finding(
                "HVD105", path, line,
                "algo=flat (int4) produced no payload all-gather."))
        return findings
    if algo == "rs_ag":
        a2a, ag = ops("all-to-all"), ops("all-gather")
        if not a2a or not ag:
            findings.append(Finding(
                "HVD105", path, line,
                f"algo=rs_ag with an unsummable wire (int4) needs the "
                f"all-to-all shard exchange + all-gather reassembly "
                f"phases, found {[i.opcode for i in payload]}."))
        for i in ops("all-reduce") + ops("reduce-scatter"):
            findings.append(Finding(
                "HVD105", path, i.line,
                f"algo=rs_ag (int4) must not move payload through a "
                f"summing {i.opcode}: 4-bit wire values cannot be "
                f"accumulated in the collective."))
        return findings
    if algo == "hierarchical":
        rs, ag = ops("reduce-scatter"), ops("all-gather")
        if not rs or not ag:
            findings.append(Finding(
                "HVD105", path, line,
                f"algo=hierarchical (int4) needs intra-slice "
                f"reduce-scatter -> cross-slice all-gather -> "
                f"intra-slice all-gather, found "
                f"{[i.opcode for i in payload]}."))
            return findings
        if world_size and num_slices > 1:
            intra = _groups_as_partition(
                expected_partitions(world_size, num_slices)[1])
            cross = _groups_as_partition(
                expected_partitions(world_size, num_slices)[2])
            for i in rs:
                if (i.replica_groups is not None
                        and _groups_as_partition(i.replica_groups)
                        != intra):
                    findings.append(Finding(
                        "HVD105", path, i.line,
                        f"hierarchical (int4) {i.opcode} must run on "
                        f"the intra-slice partition."))
            cross_ags = [i for i in ag if i.replica_groups is not None
                         and _groups_as_partition(i.replica_groups)
                         == cross]
            if not cross_ags:
                findings.append(Finding(
                    "HVD105", path, ag[0].line,
                    "hierarchical (int4) has no cross-partition payload "
                    "all-gather — the DCN hop's gather-based exchange "
                    "is missing."))
        return findings
    return findings  # auto / unknown


def check_fsdp_phases(instrs, sharding: str, path: str = "<schedule>",
                      num_slices: int = 1,
                      world_size: int | None = None,
                      fsdp_size: int | None = None) -> list[Finding]:
    """HVD105 shapes for the sharded (ZeRO-2/3) gradient exchange
    (ops/strategy.py ``lower_fsdp_grad_exchange`` / ``lower_fsdp_param_
    gather``): gradients REDUCE-SCATTER onto the fsdp axis (plus a
    cross-slice summing hop at >1 slice) and are never re-gathered —
    the trailing all-gather of rs_ag/hierarchical is exactly the wire
    traffic ZeRO removes. The all-gathers that DO appear move
    parameters: per-layer gather-on-use under zero3, the post-apply
    shard re-gather under zero2. Both modes therefore need at least one
    payload reduce-scatter AND at least one payload all-gather, with
    grouped phases on the fsdp / data partitions."""
    payload = [i for i in instrs if i.numel > 1]
    findings: list[Finding] = []
    line = payload[0].line if payload else (instrs[0].line if instrs else 1)
    rs = [i for i in payload if i.opcode == "reduce-scatter"]
    ag = [i for i in payload if i.opcode == "all-gather"]
    if not rs or not ag:
        findings.append(Finding(
            "HVD105", path, line,
            f"sharding={sharding} needs a gradient reduce-scatter AND a "
            f"parameter all-gather (gather-on-use / shard-side apply), "
            f"found {[i.opcode for i in payload]}."))
        return findings
    if not (world_size and fsdp_size):
        return findings
    fparts = None
    if 1 < fsdp_size < world_size and world_size % fsdp_size == 0:
        dsize = world_size // fsdp_size
        fparts = _groups_as_partition(
            [tuple(range(d * fsdp_size, (d + 1) * fsdp_size))
             for d in range(dsize)])
        dparts = _groups_as_partition(
            [tuple(d * fsdp_size + f for d in range(dsize))
             for f in range(fsdp_size)])
        for i in rs + ag:
            if (i.replica_groups is not None
                    and _groups_as_partition(i.replica_groups) != fparts):
                findings.append(Finding(
                    "HVD105", path, i.line,
                    f"sharded {i.opcode} must run on the fsdp partition "
                    f"({dsize} contiguous groups of {fsdp_size})."))
        for i in payload:
            if (i.opcode == "all-reduce" and i.replica_groups is not None
                    and _groups_as_partition(i.replica_groups)
                    not in (dparts, fparts)):
                findings.append(Finding(
                    "HVD105", path, i.line,
                    f"sharded cross-shard all-reduce must run on the "
                    f"data partition ({fsdp_size} strided groups of "
                    f"{dsize})."))
    return findings


def verify_schedule(instrs, world_size: int, path: str = "<schedule>",
                    algo: str | None = None, wire_etype: str | None = None,
                    partitions=None,
                    compression: str | None = None,
                    sharding: str | None = None,
                    fsdp_size: int | None = None) -> list[Finding]:
    """All program-level checks over one extracted schedule.

    ``compression`` (a wire-format name) derives the full HVD102/HVD105
    contract — single or per-phase wire dtypes, block-scale exemptions,
    gather-based phase shapes — via :func:`wire_contract`; the raw
    ``wire_etype`` parameter remains for callers that only know the HLO
    element type."""
    block_scales = False
    cross_etype = None
    if compression is not None:
        wire_etype, cross_etype, block_scales = wire_contract(
            compression, algo, world_size)
    if sharding not in (None, "off"):
        # Sharded steps move the gradient wire AND full-precision
        # parameter gathers through payload collectives — no single
        # wire dtype to hold the whole schedule to (the HVD102
        # phase-asymmetric escape, for the same reason). The block-scale
        # exemption keeps applying to whatever wire check remains.
        wire_etype, cross_etype = None, None
    findings = check_wellformed(instrs, world_size, path,
                                partitions=partitions)
    findings += check_identity(instrs, world_size, path)
    per_rank = project_per_rank(instrs, world_size)
    findings += check_wait_cycle(
        {r: [idx for idx, _ in seq] for r, seq in per_rank.items()},
        path, lines={idx: ins.line for idx, ins in enumerate(instrs)})
    findings += check_wire_dtype(instrs, wire_etype, path,
                                 cross_etype=cross_etype,
                                 partitions=partitions,
                                 block_scales=block_scales)
    if sharding not in (None, "off"):
        findings += check_fsdp_phases(instrs, sharding, path,
                                      num_slices=_slices_of(partitions),
                                      world_size=world_size,
                                      fsdp_size=fsdp_size)
    elif algo is not None:
        findings += check_phases(instrs, algo, path,
                                 num_slices=_slices_of(partitions),
                                 world_size=world_size,
                                 compression=compression)
    return findings


def _slices_of(partitions) -> int:
    if not partitions or len(partitions) < 2:
        return 1
    return len(partitions[1])  # intra-slice partition: one group per slice


# ---------------------------------------------------------------------------
# Ingestion: dumped HLO text files and per-rank schedule listings.
# ---------------------------------------------------------------------------


def verify_hlo_text(text: str, path: str = "<hlo>") -> list[Finding]:
    """Verify an ingested HLO/StableHLO text dump. The declared contract
    comes from ``hvd-lint-expect:`` headers (analysis/hlo.py):
    ``world_size=N`` (default: max rank named + 1), ``wire_dtype=<etype>``,
    ``algo=<flat|rs_ag|hierarchical>``, ``slices=N``."""
    from horovod_tpu_torch.analysis import hlo as _hlo

    instrs = _hlo.extract_schedule(text)
    expect = _hlo.parse_expectations(text)
    world = int(expect.get("world_size", 0))
    if world <= 0:
        world = 1 + max((r for i in instrs
                         for g in (i.replica_groups or ())
                         for r in g), default=0)
    slices = int(expect.get("slices", 1))
    fsdp = int(expect.get("fsdp_size", 0)) or None
    partitions = (expected_partitions(world, slices, fsdp_size=fsdp)
                  if "slices" in expect or fsdp else None)
    wire = expect.get("wire_dtype")
    wire = WIRE_ETYPE.get(wire, wire)  # accept compressor or HLO names
    return verify_schedule(instrs, world, path,
                           algo=expect.get("algo"), wire_etype=wire,
                           partitions=partitions,
                           compression=expect.get("compression"),
                           sharding=expect.get("sharding"),
                           fsdp_size=fsdp)


def verify_sched_listing(text: str, path: str = "<sched>") -> list[Finding]:
    """Verify a per-rank schedule listing (JSON): the ingestion form for
    eager/multi-process schedules, where per-rank divergence and wait
    cycles actually arise. Format::

        {"world_size": 4,
         "ranks": {"0": ["grad_w@g1", "grad_b@g2"],
                   "1": ["grad_b@g2", "grad_w@g1"]}}

    Entries are opaque collective tags (the repo convention:
    ``<tensor name>@<group>``). Checks: every rank lists the same sequence
    (HVD103) and the union order is acyclic (HVD104)."""
    try:
        data = json.loads(text)
    except ValueError as e:
        return [Finding("HVD103", path, 1,
                        f"unreadable schedule listing: {e}")]
    ranks = {int(r): list(seq)
             for r, seq in dict(data.get("ranks", {})).items()}
    lines = {}
    for lineno, raw in enumerate(text.splitlines(), start=1):
        for r in ranks:
            if f'"{r}"' in raw:
                lines.setdefault(r, lineno)
    findings = []
    if ranks:
        ref_rank = min(ranks)
        ref = ranks[ref_rank]
        for r in sorted(ranks):
            if ranks[r] != ref:
                findings.append(Finding(
                    "HVD103", path, lines.get(r, 1),
                    f"rank {r}'s schedule {ranks[r]} differs from rank "
                    f"{ref_rank}'s {ref} — per-rank schedules must be "
                    f"identical."))
    findings += check_wait_cycle(ranks, path,
                                 lines={t: 1 for seq in ranks.values()
                                        for t in seq})
    return findings


# ---------------------------------------------------------------------------
# ExchangeSchedule artifacts (.exchange.json) — the committed whole-step
# plan ops/exchange.py serializes. Verified here WITHOUT importing the
# exchange module (it needs jax; this layer runs in the jax-less CI lint
# job): the artifact is synthesized into per-bucket collective
# instructions on its declared (world_size, num_slices) partition shape,
# then run through the same HVD103 (per-rank identity) and HVD105 (phase
# shape) checks a lowered program gets.
# ---------------------------------------------------------------------------

EXCHANGE_ARTIFACT_SCHEMA = "horovod_tpu/exchange-schedule/v1"


def _hlo_itemsize(dtype_name) -> int:
    """Byte width of a serialized dtype name via the one existing HLO
    table (the _DTYPE_ETYPE note: no second map to drift)."""
    from horovod_tpu_torch.analysis import hlo as _hlo

    return _hlo._ITEMSIZE.get(_DTYPE_ETYPE.get(dtype_name, dtype_name), 4)

# dtype name (numpy/ml_dtypes) -> HLO element type, for synthesized rows.
# Byte widths come from the one existing table (analysis/hlo._ITEMSIZE);
# a second etype->bytes map here would drift out of sync.
_DTYPE_ETYPE = {
    "float64": "f64", "float32": "f32", "float16": "f16",
    "bfloat16": "bf16", "int64": "s64", "int32": "s32",
    "int16": "s16", "int8": "s8", "uint8": "u8", "bool": "pred",
}


def _channel_split(total: int, channels: int) -> list[int]:
    """Near-equal contiguous channel shard sizes — the ops/strategy.py
    ``_channel_sizes`` rule, mirrored here because this layer must stay
    importable without jax. A pure function of (total, channels), so
    every rank synthesizes the identical per-channel schedule."""
    channels = max(1, int(channels))
    base, rem = divmod(total, channels)
    return [base + (1 if c < rem else 0)
            for c in range(channels) if base or c < rem]


def _synthesize_bucket_instrs(bucket: dict, world: int, slices: int,
                              line: int) -> list:
    """The wire ops bucket's ``algo`` tag declares, as CollectiveInstr
    records (the exact expansion ops/strategy.py lowers — flat one
    all-reduce, rs_ag RS+AG, hierarchical intra-RS → cross-AR →
    intra-AG on the two-level partitions). A multi-channel bucket
    (``channels`` > 1) expands to one instance of that shape PER
    channel shard — the interleaved schedule the channelized lowering
    emits — each over the channel's share of the bucket's elements."""
    chans = int(bucket.get("channels", 1))
    if chans > 1:
        itemsize_l = _hlo_itemsize(bucket.get("dtype"))
        elems_l = max(1, int(bucket.get("total_bytes", 0)) // itemsize_l)
        rows = []
        for q in _channel_split(elems_l, chans):
            sub = dict(bucket)
            sub["channels"] = 1
            sub["total_bytes"] = q * itemsize_l
            rows += _synthesize_bucket_instrs(sub, world, slices, line)
        return rows
    from horovod_tpu_torch.analysis import hlo as _hlo

    etype = _DTYPE_ETYPE.get(bucket.get("wire_dtype")
                             or bucket.get("dtype"),
                             bucket.get("wire_dtype")
                             or bucket.get("dtype"))
    itemsize = _hlo._ITEMSIZE.get(
        _DTYPE_ETYPE.get(bucket.get("dtype"), bucket.get("dtype")), 4)
    elems = max(1, int(bucket.get("total_bytes", 0)) // itemsize)

    def instr(opcode, shape, groups, scope, et=None):
        et = et or etype
        numel = 1
        for d in shape:
            numel *= d
        return _hlo.CollectiveInstr(
            opcode=opcode, element_type=et, shape=tuple(shape),
            replica_groups=groups, wire_bytes=numel
            * _hlo._ITEMSIZE.get(et, itemsize),
            scope=scope, op_name=None,
            instr_name=f"bucket.{bucket.get('priority', 0)}", line=line)

    algo = bucket.get("algo", "flat")
    unsummable = int(bucket.get("wire_bits", 0)) == 4 \
        or int(bucket.get("cross_wire_bits", 0)) == 4
    if algo == "flat":
        if unsummable:  # gather-based reduction (ops/strategy.py)
            return [instr("all-gather", (world, max(1, elems // 2)),
                          None, "ALL_GATHER")]
        return [instr("all-reduce", (elems,), None, None)]
    if algo == "rs_ag":
        shard = max(1, -(-elems // world))
        if unsummable:
            return [instr("all-to-all", (max(1, elems // 2),), None,
                          "REDUCE_SCATTER"),
                    instr("all-gather", (world, max(1, shard // 2)),
                          None, "ALL_GATHER")]
        return [instr("reduce-scatter", (shard,), None, "REDUCE_SCATTER"),
                instr("all-gather", (elems,), None, "ALL_GATHER")]
    if algo == "hierarchical":
        parts = expected_partitions(world, slices)
        if len(parts) < 3:
            return []  # infeasible on the declared topology: caller flags
        intra = tuple(tuple(g) for g in parts[1])
        cross = tuple(tuple(g) for g in parts[2])
        local = world // slices
        shard = max(1, -(-elems // local))
        cross_dt = bucket.get("cross_wire_dtype")
        if cross_dt is not None:
            # Phase-asymmetric bucket: ICI phases in the intra dtype
            # (default: the logical full-precision dtype), DCN hop in
            # the cross wire — gather-shaped when the cross wire is
            # packed int4 (unsummable), a summing all-reduce otherwise.
            intra_dt = _DTYPE_ETYPE.get(
                bucket.get("intra_wire_dtype") or bucket.get("dtype"),
                bucket.get("dtype"))
            cross_et = _DTYPE_ETYPE.get(cross_dt, cross_dt)
            cross_op = (
                instr("all-gather", (slices, max(1, shard // 2)), cross,
                      "CROSS_SLICE", et=cross_et)
                if int(bucket.get("cross_wire_bits", 0)) == 4
                else instr("all-reduce", (shard,), cross, "CROSS_SLICE",
                           et=cross_et))
            return [
                instr("reduce-scatter", (shard,), intra,
                      "REDUCE_SCATTER", et=intra_dt),
                cross_op,
                instr("all-gather", (elems,), intra, "ALL_GATHER",
                      et=intra_dt),
            ]
        return [
            instr("reduce-scatter", (shard,), intra, "REDUCE_SCATTER"),
            instr("all-reduce", (shard,), cross, "CROSS_SLICE"),
            instr("all-gather", (elems,), intra, "ALL_GATHER"),
        ]
    return []  # auto / unknown tag: no fixed shape to pin


def _synthesize_sparse_instrs(row: dict, world: int, line: int) -> list:
    """The wire ops a SPARSE plan row declares (ops/sparse.py): ``gather``
    is the padded allgather family — value payload (in its wire format;
    int4 packs two elements per carrier byte) + index block, each a
    full-axis all-gather, nothing summed on the wire; ``dense`` is one
    full-table all-reduce (densify + allreduce). The per-rank scale
    vector of a quantized payload is a scale exchange (HVD102-exempt)
    and is not synthesized."""
    from horovod_tpu_torch.analysis import hlo as _hlo

    rows = max(1, int(row.get("rows", 1)))
    row_elems = max(1, int(row.get("row_elems", 1)))
    dense_rows = max(1, int(row.get("dense_rows", 1)))
    dtype = row.get("dtype", "float32")
    etype = _DTYPE_ETYPE.get(dtype, dtype)
    idx_etype = {8: "s64", 4: "s32", 2: "s16"}.get(
        int(row.get("index_itemsize", 4)), "s32")

    def instr(opcode, shape, scope, et):
        numel = 1
        for d in shape:
            numel *= d
        return _hlo.CollectiveInstr(
            opcode=opcode, element_type=et, shape=tuple(shape),
            replica_groups=None,
            wire_bytes=numel * _hlo._ITEMSIZE.get(et, 4),
            scope=scope, op_name=None,
            instr_name=f"sparse.{row.get('leaf', 0)}", line=line)

    if row.get("algo", "gather") == "dense":
        return [instr("all-reduce", (dense_rows * row_elems,), None,
                      etype)]
    wire_dt = row.get("wire_dtype")
    val_et = _DTYPE_ETYPE.get(wire_dt, wire_dt) if wire_dt else etype
    elems = rows * row_elems
    if int(row.get("wire_bits", 0)) == 4:
        elems = max(1, elems // 2)  # nibble-packed carrier bytes
    return [
        instr("all-gather", (world, elems), "ALL_GATHER", val_et),
        instr("all-gather", (world, rows), "ALL_GATHER", idx_etype),
    ]


def check_sparse_phases(instrs, algo: str, path: str = "<schedule>",
                        line: int = 1) -> list[Finding]:
    """HVD105 for the sparse exchange family: a ``gather`` row's payload
    moves through all-gathers ONLY (value + index blocks — a summing
    collective would overflow a gather-budgeted wire and re-materialize
    duplicate rows per occurrence instead of exchanging them for the
    dedup-and-merge), and needs both gathers; a ``dense`` row is exactly
    one full-table all-reduce."""
    payload = [i for i in instrs if i.numel > 1]
    findings: list[Finding] = []
    if algo == "gather":
        extra = [i for i in payload if i.opcode != "all-gather"]
        if extra:
            findings.append(Finding(
                "HVD105", path, extra[0].line,
                f"sparse gather exchange must move payload through "
                f"all-gathers only, found {extra[0].opcode} — the sparse "
                f"wire format is exchange-only (dedup-and-merge happens "
                f"in the receiver's accumulator, never in the "
                f"collective)."))
        elif len([i for i in payload if i.opcode == "all-gather"]) < 2:
            findings.append(Finding(
                "HVD105", path, line,
                "sparse gather exchange needs BOTH the value-block and "
                "index-block all-gathers; a value payload without its "
                "indices cannot be merged on arrival."))
        return findings
    if algo == "dense":
        extra = [i for i in payload if i.opcode != "all-reduce"]
        if extra:
            findings.append(Finding(
                "HVD105", path, extra[0].line,
                f"sparse dense fallback (densify + allreduce) must lower "
                f"to one full-table all-reduce, found "
                f"{extra[0].opcode}."))
        elif not [i for i in payload if i.opcode == "all-reduce"]:
            findings.append(Finding(
                "HVD105", path, line,
                "sparse dense fallback produced no payload all-reduce."))
        return findings
    return findings


def verify_exchange_artifact(text: str,
                             path: str = "<exchange>") -> list[Finding]:
    """Verify a serialized ExchangeSchedule: schema, per-rank identity of
    the synthesized wire schedule (HVD103), and per-bucket phase shape vs
    each bucket's algo tag incl. hierarchical feasibility on the declared
    topology (HVD105). The static gate behind
    ``tools/hvd_lint.py --schedule plan.exchange.json``."""
    try:
        data = json.loads(text)
    except ValueError as e:
        return [Finding("HVD103", path, 1,
                        f"unreadable ExchangeSchedule artifact: {e}")]
    if not isinstance(data, dict) \
            or data.get("schema") != EXCHANGE_ARTIFACT_SCHEMA:
        return [Finding(
            "HVD103", path, 1,
            f"ExchangeSchedule schema mismatch: expected "
            f"{EXCHANGE_ARTIFACT_SCHEMA!r}, got {data.get('schema')!r} — "
            f"a stale artifact layout is refused, never field-guessed.")]
    try:
        return _verify_exchange_data(data, path)
    except (TypeError, ValueError, KeyError, AttributeError) as e:
        # Type-corrupt fields in a schema-valid artifact (hand-edited or
        # truncated): report a finding, never crash the linter — a crash
        # would exit 2 ('internal error') and the CI corpus convention
        # says a crash must not pass as 'detected'.
        return [Finding(
            "HVD103", path, 1,
            f"corrupt ExchangeSchedule artifact field ({e.__class__.__name__}"
            f": {e}) — refused, never field-guessed.")]


def _verify_exchange_data(data: dict, path: str) -> list[Finding]:
    world = int(data.get("world_size", 1))
    slices = int(data.get("num_slices", 1))
    findings: list[Finding] = []
    buckets = sorted(data.get("buckets", []),
                     key=lambda b: int(b.get("priority", 0)))
    seen_prio: set[int] = set()
    seen_leaves: dict[int, int] = {}
    instrs = []
    for b in buckets:
        prio = int(b.get("priority", 0))
        line = prio + 1
        if prio in seen_prio:
            findings.append(Finding(
                "HVD103", path, line,
                f"two buckets claim issue priority {prio} — the issue "
                f"order is ambiguous, so ranks may disagree on it."))
        seen_prio.add(prio)
        for i in b.get("indices", []):
            if i in seen_leaves:
                findings.append(Finding(
                    "HVD103", path, line,
                    f"gradient leaf {i} appears in two buckets "
                    f"(priorities {seen_leaves[i]} and {prio}) — it "
                    f"would be summed twice."))
            seen_leaves[i] = prio
        if b.get("algo") == "hierarchical" \
                and (slices < 2 or world % slices != 0):
            findings.append(Finding(
                "HVD105", path, line,
                f"bucket at priority {prio} declares algo=hierarchical "
                f"on an infeasible topology ({world} ranks over "
                f"{slices} slice(s) — needs >=2 equal slices); the "
                f"two-level decomposition must refuse there."))
            continue
        # Channel-count sanity (HVD105's shard-shape contract): the
        # channel split must cut real shards — a non-positive count has
        # no lowering at all, and more channels than elements would
        # leave empty channel instances some ranks might skip.
        chans = int(b.get("channels", 1))
        b_elems = max(1, int(b.get("total_bytes", 0))
                      // _hlo_itemsize(b.get("dtype")))
        if chans < 1 or chans > b_elems:
            findings.append(Finding(
                "HVD105", path, line,
                f"bucket at priority {prio} declares channels={chans} "
                f"for {b_elems} element(s) — shard shapes are "
                f"inconsistent with the channel count (each channel "
                f"instance must carry at least one element; counts "
                f"must be >= 1)."))
            continue
        if chans > 1 and b.get("algo") not in ("flat", "rs_ag",
                                               "hierarchical"):
            findings.append(Finding(
                "HVD105", path, line,
                f"bucket at priority {prio} declares channels={chans} "
                f"with algo={b.get('algo')!r} — only the concrete "
                f"decompositions (flat/rs_ag/hierarchical) have a "
                f"channelized lowering to commit to."))
            continue
        rows = _synthesize_bucket_instrs(b, world, slices, line)
        algo = b.get("algo", "flat")
        # check_phases counts only numel>1 payload (scalar rows model
        # metadata exchanges); a legitimate single-scalar bucket would
        # synthesize an all-numel-1 schedule and falsely trip "no
        # payload" — its phase shape is trivially fine, skip it.
        unsummable = (int(b.get("wire_bits", 0)) == 4
                      or int(b.get("cross_wire_bits", 0)) == 4)
        if algo in ("flat", "rs_ag", "hierarchical") \
                and any(r.numel > 1 for r in rows):
            findings += check_phases(
                rows, algo, path, num_slices=slices, world_size=world,
                compression="int4" if unsummable else None)
        instrs += rows
    # Sparse (IndexedSlices) exchange rows — present only when the plan
    # carried sparse leaves (ops/exchange.py serializes the key only
    # then, keeping dense-only artifacts byte-identical).
    seen_sparse_leaves: set[int] = set()
    for pos, s in enumerate(data.get("sparse_buckets", [])):
        line = len(buckets) + pos + 1
        leaf = int(s.get("leaf", pos))
        if leaf in seen_sparse_leaves:
            findings.append(Finding(
                "HVD103", path, line,
                f"gradient leaf {leaf} appears in two sparse buckets — "
                f"its rows would be exchanged (and applied) twice."))
        seen_sparse_leaves.add(leaf)
        algo = s.get("algo", "gather")
        if algo not in ("gather", "dense"):
            findings.append(Finding(
                "HVD105", path, line,
                f"sparse bucket for leaf {leaf} declares unknown "
                f"exchange algo {algo!r} — only 'gather' and 'dense' "
                f"have a committed lowering ('auto' must resolve before "
                f"the plan is written)."))
            continue
        if (int(s.get("rows", 0)) < 1 or int(s.get("row_elems", 0)) < 1
                or int(s.get("dense_rows", 0)) < 1):
            findings.append(Finding(
                "HVD105", path, line,
                f"sparse bucket for leaf {leaf} declares an empty/"
                f"inconsistent wire shape (rows={s.get('rows')}, "
                f"row_elems={s.get('row_elems')}, "
                f"dense_rows={s.get('dense_rows')}) — the padded sparse "
                f"wire format needs at least one row per block."))
            continue
        srows = _synthesize_sparse_instrs(s, world, line)
        findings += check_sparse_phases(srows, algo, path, line)
        instrs += srows
    # Elastic provenance stamp (ops/exchange.py ElasticMeta) — present only
    # on plans captured around a shrink/regrow transition. The stamp and
    # the schedule it annotates must agree: a post-shrink plan that still
    # references a dropped rank means survivors are waiting on a peer that
    # will never issue (the HVD103 identity contract, violated across the
    # transition rather than across ranks).
    if "elastic" in data:
        findings += _check_elastic_meta(data["elastic"], world, path)
    # FSDP provenance stamp (ops/exchange.py FsdpMeta) — present only on
    # plans captured under sharding=zero2/zero3. The declared mesh must
    # tile the world and the zero3 gather order must name every leaf
    # exactly once: a duplicated or dropped leaf index means some rank
    # gathers a layer twice (or never materializes it) while its peers
    # block on the matched collective.
    fsdp_size = None
    if "fsdp" in data:
        findings += _check_fsdp_meta(data["fsdp"], world, path)
        fsdp_size = int(dict(data["fsdp"]).get("fsdp_size", 0)) or None
    findings += check_wellformed(
        instrs, world, path,
        partitions=expected_partitions(world, slices,
                                       fsdp_size=fsdp_size))
    findings += check_identity(instrs, world, path)
    return findings


def _check_fsdp_meta(meta: dict, world: int, path: str) -> list[Finding]:
    """Internal consistency of an FSDP stamp vs the plan it annotates."""
    findings: list[Finding] = []
    mode = meta.get("mode")
    if mode not in ("zero2", "zero3"):
        findings.append(Finding(
            "HVD105", path, 1,
            f"fsdp stamp declares unknown sharding mode {mode!r} — only "
            f"'zero2' and 'zero3' have a committed lowering ('off' plans "
            f"must omit the section entirely)."))
    fsdp = int(meta.get("fsdp_size", 0))
    dsize = int(meta.get("data_size", 0))
    if fsdp < 1 or dsize < 1 or (world and fsdp * dsize != world):
        findings.append(Finding(
            "HVD105", path, 1,
            f"fsdp stamp declares a data x fsdp mesh of "
            f"{dsize} x {fsdp} which does not tile the {world}-rank "
            f"world — no rank -> (data, fsdp) coordinate assignment "
            f"exists."))
    order = [int(i) for i in meta.get("gather_order", [])]
    dupes = sorted({i for i in order if order.count(i) > 1})
    if dupes:
        findings.append(Finding(
            "HVD103", path, 1,
            f"fsdp gather order lists leaf index(es) {dupes} more than "
            f"once — a rank would issue the same per-layer all-gather "
            f"twice while its peers issue it once, desynchronizing the "
            f"collective stream."))
    leaf_bytes = [int(b) for b in meta.get("leaf_bytes", [])]
    if mode == "zero3" and leaf_bytes \
            and sorted(set(order)) != list(range(len(leaf_bytes))):
        findings.append(Finding(
            "HVD103", path, 1,
            f"fsdp gather order {order} is not a permutation of the "
            f"{len(leaf_bytes)} declared parameter leaves — a leaf "
            f"missing from the order is never gathered, so its layer "
            f"runs on an unmaterialized parameter."))
    if any(b < 0 for b in leaf_bytes):
        findings.append(Finding(
            "HVD105", path, 1,
            f"fsdp stamp declares negative per-leaf gather bytes "
            f"{[b for b in leaf_bytes if b < 0]}."))
    for d in meta.get("wire_dtypes", []):
        if str(d) not in _DTYPE_ETYPE:
            findings.append(Finding(
                "HVD105", path, 1,
                f"fsdp stamp names unknown gather wire dtype {d!r} — "
                f"per-leaf wire dtypes must be serialized dtype names "
                f"(the _DTYPE_ETYPE table)."))
    return findings


# Mirrors serving/resilience.py JOURNAL_SCHEMA (analysis/ stays
# import-light: the verifier parses artifacts, it never runs engines).
JOURNAL_ARTIFACT_SCHEMA = "horovod_tpu/serve-journal/v1"


def verify_journal_artifact(text: str,
                            path: str = "<journal>") -> list[Finding]:
    """Verify a crash-safe serve-journal artifact
    (``*.journal.json``, serving/resilience.py): per-record CRC32
    sidecars, the schema header, replay-consistency of the record
    stream (the SAME ``protocol.journal_committed`` fold the live
    ``Engine.recover`` and the model checker's journal worlds run),
    monotone token runs, and no post-deadline emissions. A torn tail is
    CONVICTED here (HVD106, exit 1): the runtime loader tolerates it —
    recovery recomputes — but an artifact offered for audit must be
    truncated to its verified prefix first. The static gate behind
    ``tools/hvd_lint.py req.journal.json``."""
    try:
        return _verify_journal_data(text, path)
    except (TypeError, ValueError, KeyError, AttributeError) as e:
        # Type-corrupt fields in CRC-valid records (hand-edited with the
        # CRC recomputed): report a finding, never crash the linter — a
        # crash would exit 2 and must not pass as 'detected'.
        return [Finding(
            "HVD106", path, 1,
            f"corrupt serve-journal artifact field "
            f"({e.__class__.__name__}: {e}) — refused, never "
            f"field-guessed.")]


def _verify_journal_data(text: str, path: str) -> list[Finding]:
    findings: list[Finding] = []
    records: list[tuple[int, dict]] = []  # (lineno, verified record)
    bad_lines: list[int] = []
    for lineno, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        rec = None
        try:
            entry = json.loads(line)
            body = entry.get("rec")
            crc = entry.get("crc")
            if (isinstance(body, dict) and isinstance(crc, int)
                    and zlib.crc32(json.dumps(
                        body, sort_keys=True,
                        separators=(",", ":")).encode())
                    & 0xFFFFFFFF == crc):
                rec = body
        except (ValueError, AttributeError):
            rec = None
        if rec is None:
            bad_lines.append(lineno)
        elif bad_lines:
            return [Finding(
                "HVD106", path, bad_lines[0],
                f"corrupt journal record at line {bad_lines[0]} FOLLOWED "
                f"by verified records (e.g. line {lineno}) — not a torn "
                f"tail but mid-file corruption; nothing after the first "
                f"bad line is trustworthy.")]
        else:
            records.append((lineno, rec))
    if not records or records[0][1].get("kind") != "header":
        return [Finding(
            "HVD106", path, 1,
            "serve-journal artifact carries no verified header record — "
            "nothing trustworthy to audit.")]
    header = records[0][1]
    if header.get("schema") != JOURNAL_ARTIFACT_SCHEMA:
        return [Finding(
            "HVD106", path, records[0][0],
            f"serve-journal schema mismatch: expected "
            f"{JOURNAL_ARTIFACT_SCHEMA!r}, got {header.get('schema')!r} "
            f"— a stale artifact layout is refused, never "
            f"field-guessed.")]
    if bad_lines:
        findings.append(Finding(
            "HVD106", path, bad_lines[0],
            f"torn journal tail: {len(bad_lines)} unreplayable line(s) "
            f"from line {bad_lines[0]} (partial JSON or CRC mismatch — "
            f"the artifact a crash mid-append leaves). The runtime "
            f"drops and recomputes it; an AUDITED artifact must be "
            f"truncated to its verified prefix first."))
    # Replay consistency: the one shared fold. Duplicate admissions,
    # emits before admission / after close, and non-monotone token runs
    # all surface here with the offending record's index.
    try:
        _proto.journal_committed([r for _, r in records])
    except ValueError as e:
        msg = str(e)
        lineno = 1
        if msg.startswith("record "):
            idx = int(msg.split()[1].rstrip(":"))
            if 0 <= idx < len(records):
                lineno = records[idx][0]
        findings.append(Finding(
            "HVD106", path, lineno,
            f"inconsistent journal record stream — {msg}; a replay "
            f"would commit tokens the engine never emitted in that "
            f"order."))
        return findings
    # No post-deadline emissions: the engine evicts expired requests at
    # the step boundary BEFORE decoding, so an emit run stamped past
    # its request's deadline means the enforcement path was bypassed.
    deadlines: dict[int, float] = {}
    for lineno, rec in records:
        kind = rec.get("kind")
        if kind == "admit" and rec.get("deadline_ms") is not None:
            deadlines[int(rec.get("rid", -1))] = float(rec["deadline_ms"])
        elif (kind == "emit" and rec.get("t") is not None
                and _proto.deadline_expired(
                    float(rec["t"]),
                    deadlines.get(int(rec.get("rid", -1))))):
            findings.append(Finding(
                "HVD106", path, lineno,
                f"post-deadline emission: request {rec.get('rid')} "
                f"emitted tokens at t={rec['t']:.1f}ms, past its "
                f"deadline {deadlines[int(rec['rid'])]:.1f}ms — "
                f"deadline eviction must precede decode at every step "
                f"boundary."))
    return findings


def _check_elastic_meta(meta: dict, world: int, path: str) -> list[Finding]:
    """Internal consistency of an elastic transition stamp vs the plan it
    annotates: the schedule's world must be exactly the surviving members,
    and no dropped rank may remain referenced."""
    findings: list[Finding] = []
    survivors = [int(r) for r in meta.get("survivors", [])]
    dropped = [int(r) for r in meta.get("dropped", [])]
    stale = sorted(set(survivors) & set(dropped))
    if stale:
        findings.append(Finding(
            "HVD103", path, 1,
            f"elastic stamp still references dropped rank(s) {stale} as "
            f"survivors — the post-shrink schedule would wait on a peer "
            f"that was removed from the world and will never issue."))
    if len(set(survivors)) != len(survivors):
        dupes = sorted({r for r in survivors if survivors.count(r) > 1})
        findings.append(Finding(
            "HVD103", path, 1,
            f"elastic stamp lists survivor rank(s) {dupes} more than "
            f"once — the membership is ambiguous."))
    if survivors and len(set(survivors)) != world:
        findings.append(Finding(
            "HVD103", path, 1,
            f"elastic stamp declares {len(set(survivors))} surviving "
            f"member(s) {sorted(set(survivors))} but the schedule was "
            f"planned for a {world}-rank world — the plan was not "
            f"re-resolved after the transition."))
    if int(meta.get("generation", 1)) < 1:
        findings.append(Finding(
            "HVD105", path, 1,
            f"elastic stamp carries generation "
            f"{meta.get('generation')} — transitions always bump the "
            f"generation past the initial 1, so a lower value means the "
            f"KV namespace never rolled."))
    return findings


# ---------------------------------------------------------------------------
# TunedConfig artifacts (.tuned.json) — the committed profile-guided
# configuration horovod_tpu/tune serializes next to its fully resolved
# .exchange.json. Verified here WITHOUT jax: tune/artifact.py is itself
# jax-free, so (unlike ops/exchange.py, whose schema had to be duplicated
# above) the schema and knob registry are imported from the one source.
# ---------------------------------------------------------------------------

# Compressor names a tuned config may commit (ops/compression.py
# _REGISTRY keys, mirrored — that module needs jax, and this layer runs
# in the jax-less CI lint job).
TUNED_COMPRESSIONS = ("none", "bf16", "int8", "int8_block", "int4")


def _canonical_json_hash(text: str) -> str:
    """crc32 (8 hex digits) of the canonical re-serialization of a JSON
    document — formatting-independent, byte-stable across processes: the
    exact identity ``ExchangeSchedule.plan_hash()`` and
    ``TunedConfig.config_hash()`` compute over their own canonical
    forms, recomputed here from the committed (pretty-printed) bytes."""
    canonical = json.dumps(json.loads(text), sort_keys=True,
                           separators=(",", ":"))
    return f"{zlib.crc32(canonical.encode('utf-8')) & 0xFFFFFFFF:08x}"


def verify_tuned_config(text: str, path: str = "<tuned>",
                        exchange_text: str | None = None) -> list[Finding]:
    """Verify a committed ``.tuned.json`` + sibling ``.exchange.json``
    pair end-to-end: artifact schema and knob sanity, then — only if the
    recorded plan hash matches the sibling's recomputed canonical hash —
    the full exchange-artifact verification (HVD102/103/105) plus
    tuned-vs-plan consistency. A hash mismatch STOPS the pass with that
    single HVD103 finding: a sibling that isn't the plan the config was
    tuned against proves nothing either way, so findings from it would
    only mislead. ``exchange_text`` lets ``hvd.tune()`` verify a pair
    before it exists on disk; otherwise the sibling is read from next to
    ``path``. The static gate behind
    ``tools/hvd_lint.py plan.tuned.json``."""
    from horovod_tpu_torch.tune import artifact as _art

    try:
        data = json.loads(text)
    except ValueError as e:
        return [Finding("HVD103", path, 1,
                        f"unreadable TunedConfig artifact: {e}")]
    if not isinstance(data, dict) \
            or data.get("schema") != _art.TUNED_ARTIFACT_SCHEMA:
        return [Finding(
            "HVD103", path, 1,
            f"TunedConfig schema mismatch: expected "
            f"{_art.TUNED_ARTIFACT_SCHEMA!r}, got {data.get('schema')!r} "
            f"— a stale artifact layout is refused, never field-guessed.")]
    try:
        return _verify_tuned_data(data, path, exchange_text,
                                  set(_art.TUNABLE_KNOBS))
    except (TypeError, ValueError, KeyError, AttributeError) as e:
        return [Finding(
            "HVD103", path, 1,
            f"corrupt TunedConfig artifact field ({e.__class__.__name__}"
            f": {e}) — refused, never field-guessed.")]


def _verify_tuned_data(data: dict, path: str,
                       exchange_text: str | None,
                       tunable: set) -> list[Finding]:
    findings: list[Finding] = []
    world = int(data.get("world_size", 0))
    slices = int(data.get("num_slices", 1))
    if world < 1 or slices < 1 or world % slices != 0:
        findings.append(Finding(
            "HVD105", path, 1,
            f"TunedConfig declares an impossible world shape "
            f"({world} rank(s) over {slices} slice(s)) — no schedule "
            f"can be planned for it."))
    knobs = data.get("knobs")
    if not isinstance(knobs, dict):
        findings.append(Finding(
            "HVD103", path, 1,
            "TunedConfig carries no knobs object — there is nothing to "
            "apply, so the artifact is not a configuration."))
        knobs = {}
    unknown = sorted(set(knobs) - tunable)
    if unknown:
        findings.append(Finding(
            "HVD103", path, 1,
            f"TunedConfig resolves unknown knob(s) {unknown} — only the "
            f"registered tunable knobs (tune/artifact.py TUNABLE_KNOBS) "
            f"may be committed; a typo'd name would be silently "
            f"ignored at apply time."))
    findings += _check_tuned_knobs(knobs, world, slices, path)

    # -- the committed pair: sibling .exchange.json + recorded hash -----
    recorded = str(data.get("exchange_plan_hash", ""))
    sibling = str(data.get("exchange_artifact", ""))
    ex_path = sibling
    if exchange_text is None:
        ex_path = os.path.join(os.path.dirname(os.path.abspath(path)),
                               sibling)
        try:
            with open(ex_path, "r", encoding="utf-8") as f:
                exchange_text = f.read()
        except OSError as e:
            findings.append(Finding(
                "HVD103", path, 1,
                f"TunedConfig names sibling exchange artifact "
                f"{sibling!r} but it cannot be read ({e}) — the "
                f"committed pair is incomplete; nothing may apply a "
                f"tuned config whose plan is unverifiable."))
            return findings
    try:
        actual = _canonical_json_hash(exchange_text)
    except ValueError:
        findings.append(Finding(
            "HVD103", path, 1,
            f"sibling exchange artifact {sibling!r} is not valid JSON — "
            f"its plan hash cannot be recomputed, so the pair is "
            f"unverifiable."))
        return findings
    if actual != recorded:
        # STOP here (docstring): the sibling is not the plan this config
        # was tuned against, so verifying it further proves nothing.
        findings.append(Finding(
            "HVD103", path, 1,
            f"TunedConfig records exchange plan hash {recorded!r} but "
            f"the committed sibling {sibling!r} hashes to {actual!r} — "
            f"the pair disagrees, so ranks applying the config and ranks "
            f"reading the plan would run different schedules."))
        return findings

    findings += verify_exchange_artifact(exchange_text, ex_path)
    findings += _check_tuned_plan_consistency(
        data, json.loads(exchange_text), knobs, path)
    return findings


def _check_tuned_knobs(knobs: dict, world: int, slices: int,
                       path: str) -> list[Finding]:
    """Per-knob sanity (HVD105): a committed value must have a concrete
    lowering — 'auto' selectors, unknown names and impossible numbers
    must resolve BEFORE the artifact is written, not at apply time."""
    findings: list[Finding] = []
    algo = knobs.get("HOROVOD_ALLREDUCE_ALGO")
    if algo is not None:
        if algo not in ("flat", "rs_ag", "hierarchical"):
            findings.append(Finding(
                "HVD105", path, 1,
                f"tuned HOROVOD_ALLREDUCE_ALGO={algo!r} is not a "
                f"concrete decomposition (flat/rs_ag/hierarchical) — "
                f"'auto' and typos must resolve before commit."))
        elif algo == "hierarchical" and (slices < 2 or
                                         (world and world % slices != 0)):
            findings.append(Finding(
                "HVD105", path, 1,
                f"tuned HOROVOD_ALLREDUCE_ALGO=hierarchical on an "
                f"infeasible topology ({world} rank(s) over {slices} "
                f"slice(s) — needs >=2 equal slices)."))
    mode = knobs.get("HOROVOD_EXCHANGE_SCHEDULE")
    if mode is not None and mode not in ("enum", "priority"):
        findings.append(Finding(
            "HVD105", path, 1,
            f"tuned HOROVOD_EXCHANGE_SCHEDULE={mode!r} is not a known "
            f"exchange mode (enum/priority)."))
    comp = knobs.get("HOROVOD_COMPRESSION")
    if comp is not None and comp not in TUNED_COMPRESSIONS:
        findings.append(Finding(
            "HVD105", path, 1,
            f"tuned HOROVOD_COMPRESSION={comp!r} is not a registered "
            f"compressor {list(TUNED_COMPRESSIONS)}."))
    cross = knobs.get("HOROVOD_COMPRESSION_CROSS_SLICE")
    if cross is not None and cross not in TUNED_COMPRESSIONS:
        findings.append(Finding(
            "HVD105", path, 1,
            f"tuned HOROVOD_COMPRESSION_CROSS_SLICE={cross!r} is not a "
            f"registered compressor {list(TUNED_COMPRESSIONS)}."))
    threshold = knobs.get("HOROVOD_FUSION_THRESHOLD")
    if threshold is not None and (not isinstance(threshold, int)
                                  or isinstance(threshold, bool)
                                  or threshold < 1):
        findings.append(Finding(
            "HVD105", path, 1,
            f"tuned HOROVOD_FUSION_THRESHOLD={threshold!r} must be a "
            f"positive integer byte count."))
    chans = knobs.get("HOROVOD_MAX_CHANNELS")
    if chans is not None and (not isinstance(chans, int)
                              or isinstance(chans, bool) or chans < 1):
        findings.append(Finding(
            "HVD105", path, 1,
            f"tuned HOROVOD_MAX_CHANNELS={chans!r} must be an integer "
            f">= 1."))
    spec = knobs.get("HOROVOD_SERVE_SPECULATE")
    if spec is not None and (not isinstance(spec, int)
                             or isinstance(spec, bool) or spec < 0):
        findings.append(Finding(
            "HVD105", path, 1,
            f"tuned HOROVOD_SERVE_SPECULATE={spec!r} must be an integer "
            f"draft length >= 0 (0 disables speculation)."))
    mode = knobs.get("HOROVOD_SHARDING")
    if mode is not None and mode not in ("off", "zero2", "zero3"):
        findings.append(Finding(
            "HVD105", path, 1,
            f"tuned HOROVOD_SHARDING={mode!r} is not a known sharding "
            f"mode (off/zero2/zero3)."))
    fsdp = knobs.get("HOROVOD_FSDP_AXIS_SIZE")
    if fsdp is not None:
        if not isinstance(fsdp, int) or isinstance(fsdp, bool) or fsdp < 1:
            findings.append(Finding(
                "HVD105", path, 1,
                f"tuned HOROVOD_FSDP_AXIS_SIZE={fsdp!r} must be an "
                f"integer >= 1."))
        elif world and world % fsdp != 0:
            findings.append(Finding(
                "HVD105", path, 1,
                f"tuned HOROVOD_FSDP_AXIS_SIZE={fsdp} does not divide "
                f"the {world}-rank world — the data x fsdp mesh cannot "
                f"tile it."))
    density = knobs.get("HOROVOD_SPARSE_DENSITY_THRESHOLD")
    if density is not None and not (isinstance(density, (int, float))
                                    and not isinstance(density, bool)
                                    and 0.0 < float(density) <= 1.0):
        findings.append(Finding(
            "HVD105", path, 1,
            f"tuned HOROVOD_SPARSE_DENSITY_THRESHOLD={density!r} must "
            f"be a density in (0, 1]."))
    return findings


def _check_tuned_plan_consistency(data: dict, ex: dict, knobs: dict,
                                  path: str) -> list[Finding]:
    """The tuned config and the plan it commits must describe the SAME
    run (HVD103): same world shape, and the plan must actually use the
    schedule mode / fusion threshold the knobs claim — otherwise the
    knob a trainer applies and the plan hvd-lint verified diverge."""
    findings: list[Finding] = []
    if not isinstance(ex, dict):
        return findings
    for field in ("world_size", "num_slices"):
        if field in ex and int(ex[field]) != int(data.get(field, 0)):
            findings.append(Finding(
                "HVD103", path, 1,
                f"TunedConfig was tuned for {field}="
                f"{data.get(field)} but its committed plan declares "
                f"{field}={ex[field]} — the pair describes two "
                f"different worlds."))
    mode = knobs.get("HOROVOD_EXCHANGE_SCHEDULE")
    if mode is not None and ex.get("mode") is not None \
            and ex["mode"] != mode:
        findings.append(Finding(
            "HVD103", path, 1,
            f"tuned HOROVOD_EXCHANGE_SCHEDULE={mode!r} but the committed "
            f"plan was planned in mode={ex['mode']!r} — the verified "
            f"plan is not the one the knob reproduces."))
    threshold = knobs.get("HOROVOD_FUSION_THRESHOLD")
    if isinstance(threshold, int) and not isinstance(threshold, bool) \
            and ex.get("threshold_bytes") is not None \
            and int(ex["threshold_bytes"]) != threshold:
        findings.append(Finding(
            "HVD103", path, 1,
            f"tuned HOROVOD_FUSION_THRESHOLD={threshold} but the "
            f"committed plan was bucketed at threshold_bytes="
            f"{ex['threshold_bytes']} — the verified plan is not the "
            f"one the knob reproduces."))
    return findings


# ---------------------------------------------------------------------------
# End-to-end drivers (need torch and an initialized world).
# ---------------------------------------------------------------------------


def _with_slices(n: int):
    """Context manager pinning HOROVOD_TOPOLOGY_SLICES for one recording."""
    import contextlib

    @contextlib.contextmanager
    def scope():
        prev = os.environ.get("HOROVOD_TOPOLOGY_SLICES")
        try:
            if n and n > 1:
                os.environ["HOROVOD_TOPOLOGY_SLICES"] = str(n)
            else:
                os.environ.pop("HOROVOD_TOPOLOGY_SLICES", None)
            yield
        finally:
            if prev is None:
                os.environ.pop("HOROVOD_TOPOLOGY_SLICES", None)
            else:
                os.environ["HOROVOD_TOPOLOGY_SLICES"] = prev
    return scope()


def _device(device):
    """The drivers' device: ``device``, else the card (this rank's, once
    ``hvd.init`` has picked it); raises without CUDA."""
    import torch

    from horovod_tpu_torch.core import state as _state
    from horovod_tpu_torch.core.state import HorovodError

    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise HorovodError(
            "the schedule drivers run on the GPU, and CUDA is not "
            "available; pass device='cpu' to record on the CPU.")
    if _state.is_initialized() and _state.device().type == "cuda":
        return _state.device()
    return torch.device("cuda", torch.cuda.current_device())


def lm_step(algo: str | None = None, compression=None,
            exchange: str | None = None, channels: int | None = None,
            sharding: str | None = None, device=None):
    """A tiny-but-real LM training step (transformer loss -> grads ->
    fused allreduce -> SGD update), the workload the acceptance gate pins:
    returns ``(fn, args)`` for :func:`~horovod_tpu_torch.analysis.hlo.
    step_wire`. ``sharding`` (zero2/zero3) runs the step through the
    sharded ``DistributedOptimizer`` instead of ``allreduce_gradients``:
    zero3 gathers the parameter shards on use, zero2 applies the update
    shard-side and re-gathers the new parameters."""
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import transformer
    from horovod_tpu_torch.training import loop

    dev = _device(device)
    cfg = transformer.TransformerConfig(
        vocab_size=97, num_layers=1, num_heads=2, embed_dim=16,
        mlp_dim=32, max_seq_len=16, dtype=torch.float32)
    model = transformer.init_params(cfg, device=dev)
    loss_fn = transformer.make_loss_fn(cfg)
    tokens = transformer.synthetic_tokens(2, 16, cfg.vocab_size,
                                          device=dev)
    params = list(model.parameters())

    if sharding == "zero3":
        dopt = hvd.DistributedOptimizer(loop.SGD(params, 0.1),
                                        compression=compression,
                                        sharding="zero3")
        dopt.bind(model)
        shards = dopt.init_shards()
        dopt.init(shards)

        def fn3(tokens):
            full = dopt.gather_params(shards)
            with dopt.swapped(model, full):
                loss = loss_fn(model, tokens)
                loss.backward()
            new = dopt.apply_gradients([t.grad for t in full], shards)
            return loss.detach() + sum(s.sum() for s in new)

        return fn3, [tokens]
    if sharding == "zero2":
        dopt = hvd.DistributedOptimizer(loop.SGD(params, 0.1),
                                        compression=compression,
                                        sharding="zero2")

        def fn2(tokens):
            dopt.zero_grad()
            loss = loss_fn(model, tokens)
            loss.backward()
            dopt.step()
            return loss.detach() + sum(p.detach().sum() for p in params)

        return fn2, [tokens]

    opt = loop.SGD(params, 0.1)

    def fn(tokens):
        opt.zero_grad()
        loss = loss_fn(model, tokens)
        loss.backward()
        grads = hvd.allreduce_gradients([p.grad for p in params],
                                        algo=algo, compression=compression,
                                        schedule=exchange,
                                        channels=channels)
        for p, gr in zip(params, grads):
            p.grad = gr
        opt.step()
        return loss.detach() + sum(p.detach().sum() for p in params)

    return fn, [tokens]


def gradient_step(algo: str | None = None, compression=None,
                  nleaves: int = 3, elems: int = 64,
                  exchange: str | None = None, fusion_threshold: int = 0,
                  varied: bool = False, channels: int | None = None,
                  device=None):
    """An unfused ``nleaves``-bucket gradient exchange
    (``fusion_threshold=0``: one collective per leaf): ``(fn, args)`` for
    :func:`~horovod_tpu_torch.analysis.hlo.step_wire`. The cheap workload
    behind the golden-schedule snapshots."""
    import torch

    import horovod_tpu_torch as hvd

    dev = _device(device)

    def fn(x):
        # ``varied``: leaf i holds i+1 copies of x (distinct sizes), so a
        # schedule summary makes issue-order changes visible.
        grads = [(x.repeat(i + 1) if varied else x) * (i + 1)
                 for i in range(nleaves)]
        out = hvd.allreduce_gradients(grads,
                                      fusion_threshold=fusion_threshold,
                                      algo=algo, compression=compression,
                                      schedule=exchange,
                                      channels=channels)
        return sum(t.sum() for t in out)

    x = torch.arange(elems, dtype=torch.float32, device=dev) / elems
    return fn, [x]


def fsdp_step(sharding: str = "zero3", compression=None,
              nleaves: int = 3, elems: int = 64, device=None):
    """An unfused ``nleaves``-leaf sharded gradient exchange through the
    ZeRO-2/3 ``DistributedOptimizer`` (gather-on-use + gradient
    reduce-scatter, per leaf): ``(fn, args)`` for :func:`~horovod_tpu_
    torch.analysis.hlo.step_wire`, the workload behind the ``zero3``
    golden-schedule section. Leaves have distinct sizes
    (``elems * (i+1)``) so shard padding and gather order stay visible."""
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.training import loop

    dev = _device(device)
    params = [torch.nn.Parameter(torch.linspace(
        0.0, 1.0, elems * (i + 1), dtype=torch.float32, device=dev))
        for i in range(nleaves)]
    x = torch.arange(elems, dtype=torch.float32, device=dev) / elems

    def fake_grads(x):
        return [x.repeat(i + 1) * (i + 1) for i in range(nleaves)]

    if sharding == "zero3":
        dopt = hvd.DistributedOptimizer(loop.SGD(params, 0.1),
                                        compression=compression,
                                        sharding="zero3")
        dopt.bind(params)
        shards = dopt.init_shards()
        dopt.init(shards)

        def fn3(x):
            full = dopt.gather_params(shards)
            new = dopt.apply_gradients(fake_grads(x), shards)
            return (sum(t.sum() for t in full)
                    + sum(t.sum() for t in new))

        return fn3, [x]

    dopt = hvd.DistributedOptimizer(loop.SGD(params, 0.1),
                                    compression=compression,
                                    sharding="zero2")

    def fn2(x):
        for p, gr in zip(params, fake_grads(x)):
            p.grad = gr
        dopt.step()
        return sum(p.detach().sum() for p in params)

    return fn2, [x]


def sparse_step(algo: str | None = None, compression=None,
                rows: int = 8, dense_rows: int = 32, dim: int = 4,
                device=None):
    """A mixed sparse+dense gradient exchange (one IndexedSlices leaf
    next to a dense leaf through ``hvd.allreduce_gradients``), the
    workload behind the sparse golden-schedule snapshots and the
    ``--schedule`` gate's sparse arm: ``(fn, args)`` for
    :func:`~horovod_tpu_torch.analysis.hlo.step_wire`."""
    import torch

    import horovod_tpu_torch as hvd

    dev = _device(device)

    def fn(x):  # x: (rows, dim) f32, the sparse leaf's value block
        idx = (torch.arange(rows, dtype=torch.int32, device=x.device)
               * 3) % dense_rows
        grads = [hvd.IndexedSlices(x, idx, (dense_rows, dim)),
                 x.sum(0)]  # a dense leaf rides along
        emb, w = hvd.allreduce_gradients(grads, fusion_threshold=0,
                                         sparse_algo=algo,
                                         compression=compression)
        return (emb.values.sum() + emb.indices.float().sum() + w.sum())

    x = (torch.arange(rows * dim, dtype=torch.float32, device=dev)
         .reshape(rows, dim) / (rows * dim))
    return fn, [x]


def schedule_summary(instrs) -> list[list]:
    """JSON-able canonical schedule: one ``[opcode, element_type, numel,
    n_groups, group_size, scope]`` row per collective, in program order —
    the golden-snapshot form (tests/golden_schedules.json)."""
    rows = []
    for ins in instrs:
        if ins.replica_groups is None:
            ngroups, gsize = None, None
        else:
            ngroups = len(ins.replica_groups)
            gsize = len(ins.replica_groups[0]) if ins.replica_groups else 0
        rows.append([ins.opcode, ins.element_type, ins.numel,
                     ngroups, gsize, ins.scope])
    return rows


def gather_listings(mine, group: int = 0) -> list:
    """Every member's listing of ``group``, in group-rank order (a
    collective over the group: every member calls it)."""
    import torch.distributed as dist

    from horovod_tpu_torch.core import state as _state

    g = _state.get_group(group)
    if g.size <= 1:
        return [list(mine)]
    out: list = [None] * g.size
    dist.all_gather_object(out, list(mine), group=g.pg)
    return out


def verify_listings(listings, *, slices: int = 1, algo: str | None = None,
                    compression: str | None = None, path: str = "<step>",
                    sharding: str | None = None,
                    fsdp_size: int | None = None,
                    summary: list | None = None) -> list[Finding]:
    """Every program-level check over the members' listings, merged into
    one program (``analysis/hlo.py::merge_listings``); a one-rank world
    is held to well-formedness, identity and wire types only. ``summary``:
    a list that receives the merged program's :func:`schedule_summary`
    rows."""
    from horovod_tpu_torch.analysis import hlo as _hlo

    world = len(listings)
    if world == 1:
        # At one rank every decomposition is the identity and the port
        # moves nothing for it (ROADMAP §C): no phase shape to hold.
        algo, sharding, fsdp_size = None, None, None
    merged = _hlo.merge_listings(listings)
    if summary is not None:
        summary.extend(schedule_summary(merged))
    return verify_schedule(
        merged, world, path, algo=algo,
        compression=compression or "none",
        partitions=expected_partitions(world, slices, fsdp_size=fsdp_size),
        sharding=sharding, fsdp_size=fsdp_size)


def verify_step(fn, args, *, group: int = 0, slices: int = 1,
                algo: str | None = None, compression: str | None = None,
                path: str | None = None, sharding: str | None = None,
                fsdp_size: int | None = None, device=None,
                summary: list | None = None) -> list[Finding]:
    """Record one step on every member of ``group`` under a simulated
    ``slices``-host topology, gather the members' listings and run every
    program-level check on them. Collective: every member calls it, and
    every member returns the same findings. The building block behind
    :func:`verify_lm_step` and ``tools/fault_drill_torch.py --lint``.
    ``summary``: see :func:`verify_listings`."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.analysis import hlo as _hlo

    if not hvd.is_initialized():
        hvd.init(device=device)
    label = path or (f"<step algo={algo or 'default'} "
                     f"compression={compression or 'none'} "
                     f"slices={slices}>")
    with _with_slices(slices):
        mine = _hlo.step_wire(fn, args, group=group)
    return verify_listings(gather_listings(mine, group), slices=slices,
                           algo=algo, compression=compression, path=label,
                           sharding=sharding, fsdp_size=fsdp_size,
                           summary=summary)


def verify_lm_step(algo: str = "flat", compression: str | None = None,
                   slices: int = 1, group: int = 0,
                   exchange: str | None = None,
                   channels: int | None = None,
                   sharding: str | None = None,
                   device=None, summary: list | None = None
                   ) -> list[Finding]:
    """The acceptance-gate driver: schedule-verify the LM training step for
    one (algo, compression, topology, exchange-schedule) combination.
    Raises :class:`~horovod_tpu_torch.core.state.HorovodError` for
    infeasible combinations (hierarchical on a single host), as training
    would. With an exchange schedule, channels or sharding, the step's
    registered plan (``ops/exchange.py::last_plan``) is verified too
    (:func:`verify_exchange_artifact`). ``sharding`` (zero2/zero3) runs
    the step through the sharded optimizer instead of ``algo``, held to
    the FSDP phase shape. ``summary``: see :func:`verify_listings`."""
    import horovod_tpu_torch as hvd

    if not hvd.is_initialized():
        hvd.init(device=device)
    fsdp_size = None
    if sharding not in (None, "off"):
        # The default ops/mesh.py layout: the fsdp axis spans the host at
        # more than one host, the whole group at one.
        world = hvd.get_group(group).size
        fsdp_size = world // slices if slices > 1 else world
    with _with_slices(slices):
        fn, args = lm_step(algo=algo, compression=compression,
                           exchange=exchange, channels=channels,
                           sharding=sharding, device=device)
        findings = verify_step(fn, args, group=group, slices=slices,
                               algo=None if fsdp_size else algo,
                               compression=compression, sharding=sharding,
                               fsdp_size=fsdp_size, summary=summary)
    if exchange is not None or channels is not None or fsdp_size:
        from horovod_tpu_torch.ops import exchange as _exchange

        plan = _exchange.last_plan()
        if plan is None:
            findings.append(Finding(
                "HVD103", f"<lm-step exchange={exchange}>", 1,
                "the recorded step registered no ExchangeSchedule — the "
                "gradient path bypassed the whole-step scheduler."))
        else:
            findings += verify_exchange_artifact(
                plan.to_json(),
                f"<lm-step exchange={exchange} plan={plan.plan_hash()}>")
    return findings

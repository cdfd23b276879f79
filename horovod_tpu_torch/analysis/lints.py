"""Source-level distributed-correctness lints (AST walk) — the
counterpart of ``horovod_tpu/analysis/lints.py``, aimed at the port.

The schedule verifier (analysis/schedule.py) proves properties of one
*lowered program*; these lints catch the hazards that never make it into a
single program — they live in the Python control flow around the
collectives and only surface as a multi-process hang at step N:

* collectives under rank-dependent control flow (HVD001) or inside loops
  whose trip count depends on the rank (HVD002) — some ranks issue the
  collective, the rest never arrive;
* auto-named collectives under any conditional (HVD003) — the
  ``_auto_name`` counter (ops/collectives.py) is per process, so a branch
  taken on one process shifts its whole subsequent name sequence;
* host syncs in hot paths (HVD004) and blocking KV/negotiation calls
  under ``jit``/``hvd.spmd`` (HVD005);
* unknown ``HOROVOD_*`` knobs in ``os.environ`` accesses (HVD006) — a
  typo'd knob *name* is silently ignored where a typo'd *value* raises;
* rank-conditional branches issuing the same groups in different orders
  (HVD007) — the textbook cross-group deadlock.

Suppression: append ``# hvd-lint: disable=HVD003`` (comma-separate several
ids, or bare ``disable`` for all) to the flagged line when a pattern is
deliberate — e.g. an eager, explicitly-named collective a rank-0 branch
legitimately skips.

The rules, their texts and the suppression comment are the reference's.
The vocabulary is the port's (ROADMAP §C):

* the package is ``horovod_tpu_torch`` (any alias, or bare names imported
  from it);
* the traced wrappers are the reference's (``spmd``, ``jit``,
  ``shard_map``, ``pjit``) plus ``torch.compile`` (call or decorator) and
  the body of ``with torch.cuda.graph(...)``;
* the host syncs are the reference's plus ``.tolist()`` (in a traced
  function or a per-step loop, as ``.item()``) and ``.synchronize()``
  (``torch.cuda.synchronize()``, a stream's or an event's) inside a
  traced function;
* HVD006's registry is ``horovod_tpu_torch.utils.env.KNOWN_ENV_VARS``.

Stdlib-only (ast): ``tools/hvd_lint_torch.py`` runs this layer without
torch.
"""

from __future__ import annotations

import ast
import re

from horovod_tpu_torch.analysis.report import Finding

PACKAGE = "horovod_tpu_torch"

# Public collective entry points: calls spelled `hvd.<name>(...)` (any
# alias of the horovod_tpu_torch package) or bare `<name>(...)` when
# imported from it. The wire calls of the library's own lowerings
# (ops/wire.py) are deliberately NOT matched: they branch freely on
# values; the hazard is at the user-facing issue points.
COLLECTIVE_NAMES = frozenset({
    "allreduce", "allgather", "broadcast", "gather", "alltoall",
    "reducescatter", "allreduce_gradients", "allreduce_indexed_slices",
    "broadcast_variables", "broadcast_global_variables",
})
# Collectives whose names are always derived from their inputs (gradient
# pytree paths / the wrapped optimizer), so "no name= kwarg" is not the
# auto-name hazard for them.
_SELF_NAMED = frozenset({"allreduce_gradients", "broadcast_variables",
                         "broadcast_global_variables",
                         "allreduce_indexed_slices"})
RANK_FN_NAMES = frozenset({"rank", "local_rank", "global_rank"})
KV_CALL_NAMES = frozenset({
    "kv_get", "kv_set", "wait_kv", "blocking_key_value_get",
    "key_value_set", "key_value_delete", "negotiate", "validate_schedule",
})
HOST_SYNC_ATTRS = frozenset({"item", "tolist"})
TRACING_WRAPPERS = frozenset({"jit", "spmd", "shard_map", "pjit"})
# Wrappers named by their dotted path: torch.compile traces its function;
# the body of ``with torch.cuda.graph(...)`` is captured.
TRACING_DOTTED = frozenset({"torch.compile"})
CAPTURE_DOTTED = frozenset({"torch.cuda.graph"})

_DISABLE_RE = re.compile(
    r"#\s*hvd-lint:\s*disable(?:=(?P<ids>[A-Z0-9, ]+))?")
_ENV_KEY_RE = re.compile(r"^HOROVOD_[A-Z0-9_]+$")


def _call_name(node: ast.Call) -> str | None:
    """Trailing name of a call: f(...) -> 'f', a.b.f(...) -> 'f'."""
    fn = node.func
    if isinstance(fn, ast.Attribute):
        return fn.attr
    if isinstance(fn, ast.Name):
        return fn.id
    return None


def _dotted(node: ast.AST) -> str | None:
    """``a.b.c`` for a Name/Attribute chain, else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    parts.append(node.id)
    return ".".join(reversed(parts))


def _is_wrapper(node: ast.AST) -> bool:
    """Does the callee/decorator expression name a tracing wrapper?"""
    return (_call_name_of_expr(node) in TRACING_WRAPPERS
            or _dotted(node) in TRACING_DOTTED)


def _scope_nodes(scope):
    """All nodes of one lexical scope, NOT descending into nested
    function/lambda/class bodies (each is its own scope)."""
    stack = list(ast.iter_child_nodes(scope))
    while stack:
        node = stack.pop()
        yield node
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda, ast.ClassDef)):
            stack.extend(ast.iter_child_nodes(node))


class _Module:
    """Per-module name resolution: which aliases mean the package, which
    bare names are its collectives/rank functions, which function DEFS are
    traced (passed to / decorated with jit/spmd/shard_map). Traced
    resolution is per lexical scope by node identity, so an inner ``step``
    handed to ``hvd.spmd`` never taints a same-named method elsewhere."""

    def __init__(self, tree: ast.Module) -> None:
        self.pkg_aliases: set[str] = set()
        self.bare_collectives: set[str] = set()
        self.bare_rank_fns: set[str] = set()
        self.traced_defs: set[ast.AST] = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    if a.name.split(".")[0] == PACKAGE:
                        self.pkg_aliases.add(a.asname or PACKAGE)
            elif isinstance(node, ast.ImportFrom):
                if node.module and (node.module == PACKAGE
                                    or node.module.startswith(
                                        PACKAGE + ".")):
                    for a in node.names:
                        name = a.asname or a.name
                        if a.name in COLLECTIVE_NAMES:
                            self.bare_collectives.add(name)
                        if a.name in RANK_FN_NAMES:
                            self.bare_rank_fns.add(name)
        self._scan_scopes(tree)

    def _scan_scopes(self, scope) -> None:
        local_defs: dict[str, ast.AST] = {}
        wrapped_names: set[str] = set()
        nested: list[ast.AST] = []
        for node in _scope_nodes(scope):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda, ast.ClassDef)):
                nested.append(node)
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                local_defs[node.name] = node
                if self._traced_decorators(node):
                    self.traced_defs.add(node)
            elif isinstance(node, ast.Call):
                if _is_wrapper(node.func):
                    for arg in node.args[:1]:
                        if isinstance(arg, ast.Name):
                            wrapped_names.add(arg.id)
        for name in wrapped_names:
            if name in local_defs:
                self.traced_defs.add(local_defs[name])
        for sub in nested:
            self._scan_scopes(sub)

    @staticmethod
    def _traced_decorators(node) -> bool:
        for dec in node.decorator_list:
            if _is_wrapper(dec.func if isinstance(dec, ast.Call) else dec):
                return True
            if (isinstance(dec, ast.Call) and _call_name(dec) == "partial"
                    and any(_is_wrapper(a) for a in dec.args)):
                return True
        return False

    def is_collective_call(self, node: ast.Call) -> bool:
        fn = node.func
        if isinstance(fn, ast.Attribute):
            return (isinstance(fn.value, ast.Name)
                    and fn.value.id in self.pkg_aliases
                    and fn.attr in COLLECTIVE_NAMES)
        if isinstance(fn, ast.Name):
            return fn.id in self.bare_collectives
        return False

    def is_rank_expr(self, node: ast.AST) -> bool:
        """Does this expression call hvd.rank()/local_rank()/global_rank()
        (or a bare import of one) anywhere inside?"""
        for sub in ast.walk(node):
            if not isinstance(sub, ast.Call):
                continue
            fn = sub.func
            if (isinstance(fn, ast.Attribute)
                    and isinstance(fn.value, ast.Name)
                    and fn.value.id in self.pkg_aliases
                    and fn.attr in RANK_FN_NAMES):
                return True
            if isinstance(fn, ast.Name) and fn.id in self.bare_rank_fns:
                return True
        return False


def _call_name_of_expr(node: ast.AST) -> str | None:
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def _terminates(stmts: list[ast.stmt]) -> bool:
    """Does this suite unconditionally leave the enclosing scope/loop?"""
    for s in stmts:
        if isinstance(s, (ast.Return, ast.Raise, ast.Break, ast.Continue)):
            return True
        if (isinstance(s, ast.Expr) and isinstance(s.value, ast.Call)
                and _call_name(s.value) in ("exit", "_exit")):
            return True
    return False


def _collective_group(mod: _Module, call: ast.Call) -> str:
    """Textual group key of a collective call (default group 0)."""
    for kw in call.keywords:
        if kw.arg == "group":
            try:
                return ast.unparse(kw.value)
            except Exception:
                return "<group>"
    return "0"


class _Linter(ast.NodeVisitor):
    def __init__(self, mod: _Module, path: str, known_env) -> None:
        self.mod = mod
        self.path = path
        self.known_env = known_env
        self.findings: list[Finding] = []
        # Context stacks maintained by the visit methods.
        self.rank_conds: list[ast.AST] = []     # enclosing rank-dep branches
        self.any_conds: list[ast.AST] = []      # enclosing conditionals
        self.rank_loops: list[ast.AST] = []     # rank-dependent trip counts
        self.traced_depth = 0                   # inside jit/spmd-traced fn
        self.hot_loop_depth = 0                 # inside a per-step loop
        self.rank_guarded = 0                   # after a rank-gated return

    def add(self, rule: str, node: ast.AST, msg: str) -> None:
        self.findings.append(Finding(rule, self.path,
                                     getattr(node, "lineno", 1), msg))

    # -- function / tracing context -----------------------------------------

    def _visit_function(self, node) -> None:
        traced = node in self.mod.traced_defs or self.traced_depth
        self.traced_depth += 1 if traced else 0
        saved_guard, self.rank_guarded = self.rank_guarded, 0
        for dec in node.decorator_list:
            self.visit(dec)
        self.visit(node.args)
        self._walk_suite(node.body)  # track rank-gated early returns
        self.rank_guarded = saved_guard
        self.traced_depth -= 1 if traced else 0

    visit_FunctionDef = _visit_function
    visit_AsyncFunctionDef = _visit_function

    # -- conditionals --------------------------------------------------------

    def _walk_suite(self, stmts: list[ast.stmt]) -> None:
        """Visit a statement suite tracking rank-gated early exits: after
        ``if hvd.rank() != 0: return``, the rest of the suite is
        rank-conditional even though not lexically nested."""
        guard_added = 0
        for s in stmts:
            if (isinstance(s, ast.If) and self.mod.is_rank_expr(s.test)
                    and _terminates(s.body) and not s.orelse):
                self.visit(s)
                self.rank_guarded += 1
                guard_added += 1
                continue
            self.visit(s)
        self.rank_guarded -= guard_added

    def visit_If(self, node: ast.If) -> None:
        rank_dep = self.mod.is_rank_expr(node.test)
        self.visit(node.test)
        if rank_dep:
            self._check_group_order(node)
        for suite in (node.body, node.orelse):
            if rank_dep:
                self.rank_conds.append(node)
            self.any_conds.append(node)
            self._walk_suite(suite)
            self.any_conds.pop()
            if rank_dep:
                self.rank_conds.pop()

    def visit_IfExp(self, node: ast.IfExp) -> None:
        rank_dep = self.mod.is_rank_expr(node.test)
        self.visit(node.test)
        for branch in (node.body, node.orelse):
            if rank_dep:
                self.rank_conds.append(node)
            self.any_conds.append(node)
            self.visit(branch)
            self.any_conds.pop()
            if rank_dep:
                self.rank_conds.pop()

    def visit_While(self, node: ast.While) -> None:
        # Loops (while AND for) are deliberately NOT 'conditionals' for
        # HVD003: auto-names in a loop are safe iff every process runs the
        # same trip count, and the rank-dependent case is HVD002's job —
        # flagging every looped collective would drown real findings.
        rank_dep = self.mod.is_rank_expr(node.test)
        self.visit(node.test)
        if rank_dep:
            self.rank_loops.append(node)
        self._walk_suite(node.body)
        self._walk_suite(node.orelse)
        if rank_dep:
            self.rank_loops.pop()

    def visit_For(self, node: ast.For) -> None:
        rank_dep = self.mod.is_rank_expr(node.iter)
        self.visit(node.iter)
        hot = _suite_calls(node.body, {"train_step", "test_step"})
        if rank_dep:
            self.rank_loops.append(node)
        if hot:
            self.hot_loop_depth += 1
        self._walk_suite(node.body)
        self._walk_suite(node.orelse)
        if hot:
            self.hot_loop_depth -= 1
        if rank_dep:
            self.rank_loops.pop()

    def visit_Module(self, node: ast.Module) -> None:
        self._walk_suite(node.body)

    # try/with bodies are plain suites: walk them with guard tracking so a
    # rank-gated early return inside them still marks the rest of that
    # suite (timeline/with-context wrappers around training code are
    # common).
    def visit_Try(self, node) -> None:
        self._walk_suite(node.body)
        for handler in node.handlers:
            self._walk_suite(handler.body)
        self._walk_suite(node.orelse)
        self._walk_suite(node.finalbody)

    visit_TryStar = visit_Try  # py3.11+ except* blocks

    def _visit_with(self, node) -> None:
        for item in node.items:
            self.visit(item)
        captured = any(
            isinstance(item.context_expr, ast.Call)
            and _dotted(item.context_expr.func) in CAPTURE_DOTTED
            for item in node.items)
        self.traced_depth += 1 if captured else 0
        self._walk_suite(node.body)
        self.traced_depth -= 1 if captured else 0

    visit_With = _visit_with
    visit_AsyncWith = _visit_with

    # -- the rules -----------------------------------------------------------

    def visit_Call(self, node: ast.Call) -> None:
        name = _call_name(node)
        if self.mod.is_collective_call(node):
            self._check_collective(node, name)
        if self.traced_depth and name in KV_CALL_NAMES:
            self.add("HVD005", node,
                     f"blocking coordination call {name}() inside a "
                     f"jit/spmd-traced function: KV I/O cannot run in a "
                     f"compiled program.")
        if name in HOST_SYNC_ATTRS and isinstance(node.func, ast.Attribute):
            if self.traced_depth or self.hot_loop_depth:
                where = ("a traced step function" if self.traced_depth
                         else "a per-step training loop")
                self.add("HVD004", node,
                         f".{name}() inside {where}: blocks the host on the "
                         f"device every step (keep values on device; sync "
                         f"once per epoch).")
        if (name in ("device_get", "block_until_ready", "synchronize")
                and self.traced_depth):
            self.add("HVD004", node,
                     f"{name}() inside a traced step function is a host "
                     f"sync on a traced value.")
        if name in ("asarray", "array") and isinstance(node.func,
                                                      ast.Attribute):
            owner = node.func.value
            if (isinstance(owner, ast.Name) and owner.id in ("np", "numpy")
                    and self.traced_depth):
                self.add("HVD004", node,
                         f"np.{name}() on a traced value forces a transfer "
                         f"+ host sync inside the compiled step; use "
                         f"jnp.{name} or keep the value on device.")
        self._check_env_access(node)
        self.generic_visit(node)

    def _check_collective(self, node: ast.Call, name: str) -> None:
        if self.rank_conds or self.rank_guarded:
            self.add("HVD001", node,
                     f"{name}() under rank-dependent control flow: ranks "
                     f"disagree on whether this collective runs — the "
                     f"remaining ranks block forever. Run it on every "
                     f"rank (mask per-rank contributions instead).")
        if self.rank_loops:
            self.add("HVD002", node,
                     f"{name}() inside a loop whose trip count depends on "
                     f"the rank: ranks issue different numbers of "
                     f"collectives.")
        has_name = any(kw.arg == "name" for kw in node.keywords)
        if (not has_name and name not in _SELF_NAMED
                and self.any_conds):
            self.add("HVD003", node,
                     f"auto-named {name}() under a conditional: the "
                     f"auto-name counter is per process, so processes "
                     f"taking different branches shift every later "
                     f"collective's name. Pass an explicit name=.")

    def _check_group_order(self, node: ast.If) -> None:
        """HVD007: both branches of a rank conditional issue >= 2
        collectives on the same groups in different orders."""
        def branch_groups(suite) -> list[str]:
            out = []
            for s in suite:
                for sub in ast.walk(s):
                    if (isinstance(sub, ast.Call)
                            and self.mod.is_collective_call(sub)):
                        out.append(_collective_group(self.mod, sub))
            return out

        a, b = branch_groups(node.body), branch_groups(node.orelse)
        if (len(a) >= 2 and sorted(a) == sorted(b) and a != b
                and len(set(a)) >= 2):
            self.add("HVD007", node,
                     f"rank-dependent branches issue collectives on groups "
                     f"{a} vs {b}: the cross-group wait-for graph has a "
                     f"cycle — every rank must issue shared groups in one "
                     f"global order.")

    def _check_env_access(self, node: ast.Call) -> None:
        """HVD006 at source level: os.environ.get / os.getenv /
        environ.setdefault with an unknown HOROVOD_* literal key."""
        if self.known_env is None:
            return
        name = _call_name(node)
        if name not in ("get", "getenv", "setdefault", "pop", "delenv",
                        "setenv"):
            return
        for arg in node.args[:1] or []:
            key = arg.value if (isinstance(arg, ast.Constant)
                                and isinstance(arg.value, str)) else None
            if (key and _ENV_KEY_RE.match(key)
                    and key not in self.known_env):
                self.add("HVD006", node,
                         f"unknown environment knob {key!r}: not in "
                         f"horovod_tpu_torch.utils.env.KNOWN_ENV_VARS — a "
                         f"typo'd knob name is silently ignored (typo'd "
                         f"values raise).")

    def visit_Subscript(self, node: ast.Subscript) -> None:
        # Subscript reads/writes of os.environ with a HOROVOD_* key.
        if (self.known_env is not None
                and isinstance(node.value, ast.Attribute)
                and node.value.attr == "environ"
                and isinstance(node.slice, ast.Constant)
                and isinstance(node.slice.value, str)):
            key = node.slice.value
            if _ENV_KEY_RE.match(key) and key not in self.known_env:
                self.add("HVD006", node,
                         f"unknown environment knob {key!r}: not in "
                         f"horovod_tpu_torch.utils.env.KNOWN_ENV_VARS.")
        self.generic_visit(node)


def _suite_calls(stmts: list[ast.stmt], names: frozenset | set) -> bool:
    for s in stmts:
        for sub in ast.walk(s):
            if isinstance(sub, ast.Call) and _call_name(sub) in names:
                return True
    return False


def _suppressed(finding: Finding, source_lines: list[str]) -> bool:
    if not 1 <= finding.line <= len(source_lines):
        return False
    m = _DISABLE_RE.search(source_lines[finding.line - 1])
    if not m:
        return False
    ids = m.group("ids")
    if ids is None:
        return True
    return finding.rule in {i.strip() for i in ids.split(",")}


def lint_source(source: str, path: str = "<source>",
                known_env=None) -> list[Finding]:
    """Lint one Python source string; returns unsuppressed findings."""
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        return [Finding("HVD000", path, e.lineno or 1,
                        f"could not parse: {e.msg}")]
    mod = _Module(tree)
    linter = _Linter(mod, path, known_env)
    linter.visit(tree)
    lines = source.splitlines()
    return [f for f in linter.findings if not _suppressed(f, lines)]


def lint_file(path: str, known_env=None) -> list[Finding]:
    with open(path, "r", encoding="utf-8") as f:
        return lint_source(f.read(), path, known_env=known_env)

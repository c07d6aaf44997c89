"""``srjt-race`` layer 1: static guarded-by inference for the port's
concurrent substrate (stdlib ``ast`` only, like srjt-lint).

srjt-lint (SRJT001-007) checks conventions and lockdep proves the lock
GRAPH is acyclic — but nothing proved that shared fields are actually
*guarded*: a field read under ``self._lock`` in one method and bare in
another was invisible. This pass infers, per class in the governed
concurrent modules, which ``self._*`` attributes are accessed inside
``with self._lock:`` (or condition) blocks vs. bare, and enforces:

    SRJT008 mixed-guard        an attribute with at least one guarded
                               access, at least one bare access, and at
                               least one write outside ``__init__`` is
                               a data race waiting for a scheduler:
                               guard every access or annotate why not.
    SRJT009 check-then-act     a branch test reads a guarded attribute
                               WITHOUT its lock and the same function
                               writes that attribute: the classic
                               read->branch->write split across lock
                               boundaries (the check is stale by the
                               time the act runs).
    SRJT010 bare-global-mutate a mutable module global (dict/list/set
                               assigned at module scope) mutated from a
                               function body with no lock in scope.

Inference rules (documented limits, not bugs):

- A lock attribute is one assigned ``threading.Lock/RLock/Condition``
  in the class (``self._lock = threading.Lock()``). A Condition built
  OVER another lock attribute (``threading.Condition(self._lock)``)
  aliases it: holding either guards the same state.
- A method whose name ends in ``_locked`` is the repo's caller-holds-
  the-lock convention: its accesses count as guarded (by the caller).
- ``__init__``/``__new__`` accesses never count toward the mix — the
  constructor happens-before every reader by construction — but they
  do anchor suppression comments for the whole attribute.
- Accesses inside nested functions/lambdas count as BARE (they execute
  later, outside the lexical with-block).
- Attribute state reached through other names (``w.alive`` from pool
  methods, class attrs via the class name) is layer 2's job — the
  dynamic detector in lockdep.py tracks those objects at runtime.

Suppression syntax (on the flagged line, the line above it, or ANY
access line of the attribute — including its ``__init__`` assignment,
the canonical spot for attribute-wide annotations)::

    self._flag = False  # srjt-race: allow-unguarded(single machine-word poll; GIL-atomic)
    self._entries       # srjt-race: guarded-by(_lock)

``guarded-by(<lock>)`` documents a discipline the inference cannot see
(caller-held locks, cross-object conditions); ``allow-unguarded``
documents why no lock is needed. An empty reason/lock name is SRJT000,
and a suppression matching no violation is a stale SRJT000, exactly as
in srjt-lint (analysis/ is exempt from the stale audit only: these
docstrings carry the syntax examples).

Run ``python -m spark_rapids_jni_tpu_torch.analysis.races`` from the repo
root (exit 1 on any violation); ``--format=json`` / ``--format=sarif``
emit machine-readable findings with the same exit code.
"""

from __future__ import annotations

import argparse
import ast
import os
import re
import sys
from typing import Dict, List, Optional, Set, Tuple

from .lint import Violation, _discover, format_findings, write_findings

__all__ = ["run", "scan_source", "main", "RACE_GOVERNED"]

# the governed concurrent modules (package-relative path fragments):
# everything with a lock worth proving
RACE_GOVERNED = (
    # serve/journal.py (the QueryJournal _lock serializing append/replay
    # against scheduler worker threads) and memgov/persist.py (manifest
    # writes under the catalog lock, the startup re-attach scan) ride
    # these two prefixes
    "serve/",
    "sidecar_pool.py",
    "sidecar.py",
    "memgov/",
    # the cross-process exchange: TcpExchange's published epochs, breakers
    # and peer maps are crossed by the accept loop, the serving threads
    # and every fetching caller
    "parallel/shuffle.py",
    # the cluster membership layer: ClusterView's state map, generation,
    # and recovery-dedup set are written by the heartbeat thread and read
    # by every exchanging thread
    "parallel/cluster.py",
    "utils/metrics.py",
    "utils/deadline.py",
    # the span layer: TraceContext's span buffer and the sink's
    # recorder/log state are cross-thread (hedge legs, slot threads)
    "utils/tracing.py",
    "utils/trace_sink.py",
    # the plan compiler: CompiledPlan objects are submitted to the
    # concurrent serving runtime, so their state discipline (per-run
    # contexts, no shared mutable caches) is worth proving
    "plan/",
    # the serving-tier caches: the single-flight map, the plan-cache LRU,
    # and the subresult LRU are crossed by every serve slot racing on one
    # key
    "cache/",
)

_SUPPRESS_RE = re.compile(
    r"#\s*srjt-race:\s*(guarded-by|allow-unguarded)\s*\((.*?)\)\s*(#.*)?$"
)

# container methods that MUTATE their receiver: a call through a
# guarded attribute is a write to the guarded structure
_MUTATORS = frozenset({
    "append", "appendleft", "add", "update", "pop", "popleft", "popitem",
    "remove", "discard", "clear", "extend", "insert", "setdefault",
    "__setitem__", "__delitem__",
})

_MUTABLE_CALLS = frozenset({
    "dict", "list", "set", "deque", "defaultdict", "OrderedDict", "Counter",
})

# methods whose accesses count as guarded-by-the-caller (repo
# convention); matched by suffix
_LOCKED_SUFFIX = "_locked"
_CALLER_GUARD = "<caller>"


class _Access:
    __slots__ = ("attr", "line", "write", "guards", "func", "in_init",
                 "in_branch_test")

    def __init__(self, attr, line, write, guards, func, in_init,
                 in_branch_test=False):
        self.attr = attr
        self.line = line
        self.write = write
        self.guards = guards  # frozenset of canonical guard names held
        self.func = func
        self.in_init = in_init
        self.in_branch_test = in_branch_test


def _suppressions(src: str) -> Dict[int, Tuple[str, str, int]]:
    """line -> (kind, text, comment_line); a standalone comment also
    covers the next line (same contract as srjt-lint)."""
    out: Dict[int, Tuple[str, str, int]] = {}
    for i, text in enumerate(src.splitlines(), start=1):
        m = _SUPPRESS_RE.search(text)
        if not m:
            continue
        kind, arg = m.group(1), m.group(2).strip()
        out[i] = (kind, arg, i)
        if text.lstrip().startswith("#"):
            out[i + 1] = (kind, arg, i)
    return out


def _is_self_attr(node) -> Optional[str]:
    if (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"
            and node.attr.startswith("_")
            and not node.attr.startswith("__")):
        return node.attr
    return None


def _is_lock_ctor(node) -> Optional[str]:
    """'lock' | 'condition' when node is threading.Lock()/RLock()/
    Condition(...) (or the bare-name import spelling)."""
    if not isinstance(node, ast.Call):
        return None
    f = node.func
    name = None
    if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name) \
            and f.value.id == "threading":
        name = f.attr
    elif isinstance(f, ast.Name):
        name = f.id
    if name in ("Lock", "RLock"):
        return "lock"
    if name == "Condition":
        return "condition"
    return None


class _ClassScan:
    """One class's inferred guard map: lock attrs, condition aliases,
    and every self._* access with its held-guard context."""

    def __init__(self, name: str):
        self.name = name
        self.locks: Set[str] = set()
        self.alias: Dict[str, str] = {}  # condition attr -> canonical lock
        self.accesses: List[_Access] = []

    def canonical(self, attr: str) -> str:
        return self.alias.get(attr, attr)


class _FuncWalker(ast.NodeVisitor):
    """Walk one method body tracking the lexically-held self-locks."""

    def __init__(self, scan: _ClassScan, func_name: str):
        self.scan = scan
        self.func = func_name
        self.in_init = func_name in ("__init__", "__new__")
        base = {_CALLER_GUARD} if func_name.endswith(_LOCKED_SUFFIX) else set()
        self.held: Set[str] = base
        self._skip: Set[int] = set()  # Attribute nodes already classified
        self._test_depth = 0

    def _record(self, attr: str, line: int, write: bool) -> None:
        if attr in self.scan.locks or attr in self.scan.alias:
            return  # the locks themselves are not guarded state
        self.scan.accesses.append(_Access(
            attr, line, write, frozenset(self.held), self.func,
            self.in_init, in_branch_test=self._test_depth > 0,
        ))

    # -- guard context -------------------------------------------------------

    def _with_guards(self, node):
        added = []
        for item in node.items:
            attr = _is_self_attr(item.context_expr)
            if attr and (attr in self.scan.locks or attr in self.scan.alias):
                g = self.scan.canonical(attr)
                if g not in self.held:
                    self.held.add(g)
                    added.append(g)
        for item in node.items:
            if item.optional_vars is not None:
                self.visit(item.optional_vars)
        for stmt in node.body:
            self.visit(stmt)
        for g in added:
            self.held.discard(g)

    visit_With = _with_guards
    visit_AsyncWith = _with_guards

    def _nested_func(self, node):
        # a def-closure defined here EXECUTES later (thread targets,
        # callbacks), outside this lexical lock context: its accesses
        # count as bare
        saved, self.held = self.held, set()
        for stmt in node.body:
            self.visit(stmt)
        self.held = saved

    visit_FunctionDef = _nested_func
    visit_AsyncFunctionDef = _nested_func

    def visit_Lambda(self, node: ast.Lambda):
        # lambdas in this codebase are sort/min keys and default
        # factories that run IN PLACE — they keep the held context
        # (a lambda stashed for deferred execution is rare enough to
        # annotate by hand)
        self.visit(node.body)

    # -- branch tests (SRJT009 raw material) ---------------------------------

    def _branch(self, node):
        self._test_depth += 1
        self.visit(node.test)
        self._test_depth -= 1
        for stmt in node.body:
            self.visit(stmt)
        for stmt in node.orelse:
            self.visit(stmt)

    visit_If = _branch
    visit_While = _branch

    def visit_IfExp(self, node: ast.IfExp):
        self._test_depth += 1
        self.visit(node.test)
        self._test_depth -= 1
        self.visit(node.body)
        self.visit(node.orelse)

    # -- access classification -----------------------------------------------

    def visit_Subscript(self, node: ast.Subscript):
        attr = _is_self_attr(node.value)
        if attr is not None and isinstance(node.ctx, (ast.Store, ast.Del)):
            # self._x[k] = v / del self._x[k]: a write to the structure
            self._record(attr, node.value.lineno, True)
            self._skip.add(id(node.value))
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call):
        f = node.func
        if isinstance(f, ast.Attribute) and f.attr in _MUTATORS:
            attr = _is_self_attr(f.value)
            if attr is not None:
                self._record(attr, f.value.lineno, True)
                self._skip.add(id(f.value))
        self.generic_visit(node)

    def visit_Attribute(self, node: ast.Attribute):
        if id(node) not in self._skip:
            attr = _is_self_attr(node)
            if attr is not None:
                self._record(
                    attr, node.lineno,
                    isinstance(node.ctx, (ast.Store, ast.Del)),
                )
        self.generic_visit(node)


class _ModuleScan(ast.NodeVisitor):
    """Collect per-class access maps + module-global mutation sites."""

    def __init__(self):
        self.classes: List[_ClassScan] = []
        self.globals: Dict[str, int] = {}  # name -> declaration line
        self.global_mutations: List[Tuple[str, int, bool]] = []  # (name, line, locked)

    def visit_ClassDef(self, node: ast.ClassDef):
        scan = _ClassScan(node.name)
        # pass 1: find the lock attributes (any method, usually __init__)
        for sub in ast.walk(node):
            if isinstance(sub, ast.Assign) and len(sub.targets) == 1:
                attr = _is_self_attr(sub.targets[0])
                if attr is None:
                    continue
                kind = _is_lock_ctor(sub.value)
                if kind == "lock":
                    scan.locks.add(attr)
                elif kind == "condition":
                    over = (sub.value.args[0] if sub.value.args else None)
                    over_attr = _is_self_attr(over)
                    if over_attr:
                        scan.alias[attr] = over_attr
                        scan.locks.add(over_attr)
                    else:
                        scan.locks.add(attr)  # Condition() owns its lock
        # pass 2: walk each method with guard context
        for stmt in node.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                walker = _FuncWalker(scan, stmt.name)
                for s in stmt.body:
                    walker.visit(s)
        self.classes.append(scan)
        # nested classes are rare; don't recurse into them twice

    def visit_Module(self, node: ast.Module):
        for stmt in node.body:
            if isinstance(stmt, (ast.Assign, ast.AnnAssign)):
                targets = stmt.targets if isinstance(stmt, ast.Assign) \
                    else [stmt.target]
                value = stmt.value
                if value is None:
                    continue
                mutable = isinstance(value, (
                    ast.Dict, ast.List, ast.Set, ast.DictComp, ast.ListComp,
                    ast.SetComp,
                )) or (
                    isinstance(value, ast.Call)
                    and isinstance(value.func, ast.Name)
                    and value.func.id in _MUTABLE_CALLS
                )
                if mutable:
                    for t in targets:
                        if isinstance(t, ast.Name):
                            self.globals[t.id] = stmt.lineno
            self.visit(stmt)
        # find mutations of those names inside every function body
        if self.globals:
            for stmt in ast.walk(node):
                if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    self._scan_func_for_global_mutations(stmt)

    def _scan_func_for_global_mutations(self, fn) -> None:
        local = {a.arg for a in fn.args.args + fn.args.kwonlyargs}
        if fn.args.vararg:
            local.add(fn.args.vararg.arg)
        if fn.args.kwarg:
            local.add(fn.args.kwarg.arg)
        for sub in ast.walk(fn):
            if isinstance(sub, ast.Assign):
                for t in sub.targets:
                    if isinstance(t, ast.Name):
                        local.add(t.id)
        mutated: List[Tuple[str, ast.AST]] = []
        for sub in ast.walk(fn):
            if isinstance(sub, ast.Subscript) \
                    and isinstance(sub.ctx, (ast.Store, ast.Del)) \
                    and isinstance(sub.value, ast.Name):
                mutated.append((sub.value.id, sub))
            elif isinstance(sub, ast.Call) \
                    and isinstance(sub.func, ast.Attribute) \
                    and sub.func.attr in _MUTATORS \
                    and isinstance(sub.func.value, ast.Name):
                mutated.append((sub.func.value.id, sub))
        if not mutated:
            return
        locked_lines = self._locked_lines(fn)
        for name, node in mutated:
            if name in self.globals and name not in local:
                self.global_mutations.append(
                    (name, node.lineno, node.lineno in locked_lines)
                )

    @staticmethod
    def _locked_lines(fn) -> Set[int]:
        """Source lines inside any with-block whose context manager is
        a bare name/attribute (the lock-ish heuristic: ``with _lock:``,
        ``with self._cond:`` — never ``with open(...)``)."""
        lines: Set[int] = set()
        for sub in ast.walk(fn):
            if isinstance(sub, (ast.With, ast.AsyncWith)) and any(
                isinstance(i.context_expr, (ast.Name, ast.Attribute))
                for i in sub.items
            ):
                end = getattr(sub, "end_lineno", None) or sub.lineno
                lines.update(range(sub.lineno, end + 1))
        return lines


class _SourceRaceLinter:
    def __init__(self, path: str, rel: str, src: str):
        self.path = path
        self.rel = rel
        self.src = src
        self.suppress = _suppressions(src)
        self.used: Set[int] = set()
        self.violations: List[Violation] = []
        self.is_analysis = rel.startswith("analysis/")

    # -- suppression plumbing ------------------------------------------------

    def _suppression_for(self, lines) -> Optional[Tuple[str, str, int]]:
        """The first matching srjt-race suppression covering any of
        ``lines`` (each line is covered by a comment on it or directly
        above it — _suppressions already encodes that)."""
        for ln in lines:
            sup = self.suppress.get(ln)
            if sup is not None:
                return sup
        return None

    def _flag(self, line: int, rule: str, message: str,
              anchor_lines=None) -> None:
        sup = self._suppression_for([line] + list(anchor_lines or []))
        if sup is not None:
            kind, arg, comment_line = sup
            self.used.add(comment_line)
            if not arg:
                self.violations.append(Violation(
                    self.path, comment_line, "SRJT000",
                    f"suppression {kind}() needs a "
                    + ("lock name" if kind == "guarded-by" else "reason"),
                ))
            return
        self.violations.append(Violation(self.path, line, rule, message))

    def finish(self) -> None:
        for line, (kind, arg, comment_line) in self.suppress.items():
            if line != comment_line or comment_line in self.used:
                continue
            if not arg:
                self.violations.append(Violation(
                    self.path, comment_line, "SRJT000",
                    f"suppression {kind}() needs a "
                    + ("lock name" if kind == "guarded-by" else "reason"),
                ))
            elif not self.is_analysis:
                self.violations.append(Violation(
                    self.path, comment_line, "SRJT000",
                    f"stale suppression srjt-race: {kind}: no "
                    "suppressible violation anchors here (the access "
                    "pattern it excused is gone — delete the comment)",
                ))

    # -- the rules -----------------------------------------------------------

    def scan(self) -> List[Violation]:
        try:
            tree = ast.parse(self.src, filename=self.path)
        except SyntaxError as e:
            return [Violation(self.path, e.lineno or 1, "SRJT999",
                              f"syntax error: {e.msg}")]
        mod = _ModuleScan()
        mod.visit(tree)
        for scan in mod.classes:
            self._check_class(scan)
        self._check_globals(mod)
        self.finish()
        return self.violations

    def _check_class(self, scan: _ClassScan) -> None:
        by_attr: Dict[str, List[_Access]] = {}
        for a in scan.accesses:
            by_attr.setdefault(a.attr, []).append(a)
        for attr, accs in sorted(by_attr.items()):
            anchor = sorted({a.line for a in accs})
            live = [a for a in accs if not a.in_init]
            guarded = [a for a in live if a.guards]
            bare = [a for a in live if not a.guards]
            writes = [a for a in live if a.write]
            # SRJT008: mixed guarded/bare with a real (post-init) write
            if guarded and bare and writes:
                guards = sorted({g for a in guarded for g in a.guards})
                bare_lines = sorted({a.line for a in bare})
                shown = ", ".join(str(x) for x in bare_lines[:4])
                if len(bare_lines) > 4:
                    shown += ", ..."
                self._flag(
                    bare_lines[0], "SRJT008",
                    f"{scan.name}.{attr}: mixed guarded/unguarded access "
                    f"— {len(guarded)} access(es) under "
                    f"{'/'.join(guards)} but {len(bare_lines)} bare line(s) "
                    f"({shown}) and the attribute is written after "
                    "__init__: guard every access, or annotate "
                    "# srjt-race: guarded-by(<lock>) / "
                    "allow-unguarded(<reason>)",
                    anchor_lines=anchor,
                )
            # SRJT009: check-then-act — a branch test reads the guarded
            # attribute without its PROTECTING lock while the same
            # function writes it. The protecting set is inferred from
            # the locks held at WRITE sites (a read under some other
            # lock is still an unprotected check); caller-held guards
            # (<caller>, the _locked convention) cannot be named, so
            # any-locked reads pass there.
            if not guarded:
                continue
            write_guards = {g for a in guarded if a.write for g in a.guards}
            guard_set = write_guards or {g for a in guarded for g in a.guards}
            writer_funcs = {a.func for a in accs if a.write}
            for a in live:
                if not a.in_branch_test or a.write:
                    continue
                if a.guards and (a.guards & guard_set
                                 or _CALLER_GUARD in guard_set):
                    continue  # checked under (one of) its locks
                if a.func not in writer_funcs:
                    continue  # read-only function: no act to race the check
                self._flag(
                    a.line, "SRJT009",
                    f"{scan.name}.{attr}: check-then-act — branch test "
                    f"reads this {'/'.join(sorted(guard_set))}-guarded "
                    f"attribute without the lock while {a.func}() also "
                    "writes it; by the time the branch acts the check is "
                    "stale. Take the lock around the read-decide-write "
                    "sequence, or annotate "
                    "# srjt-race: allow-unguarded(<reason>)",
                    anchor_lines=anchor,
                )

    def _check_globals(self, mod: _ModuleScan) -> None:
        for name, line, locked in sorted(mod.global_mutations,
                                         key=lambda x: x[1]):
            if locked:
                continue
            decl = mod.globals[name]
            self._flag(
                line, "SRJT010",
                f"module global {name!r} (a mutable container declared at "
                f"line {decl}) is mutated here with no lock in scope: any "
                "two threads through this function race the container. "
                "Wrap the mutation in its lock, or annotate "
                "# srjt-race: guarded-by(<lock>) / "
                "allow-unguarded(<reason>)",
                anchor_lines=[decl],
            )


def scan_source(src: str, path: str, rel: Optional[str] = None
                ) -> List[Violation]:
    """Race-lint one source blob; ``rel`` scopes it (tests pass
    synthetic fixture paths)."""
    if rel is None:
        rel = os.path.basename(path)
    return _SourceRaceLinter(path, rel, src).scan()


def _governed(rel: str) -> bool:
    return any(rel.startswith(p) or rel == p for p in RACE_GOVERNED)


def run(pkg_root: Optional[str] = None) -> List[Violation]:
    if pkg_root is None:
        pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    violations: List[Violation] = []
    for path in _discover(pkg_root):
        rel = os.path.relpath(path, pkg_root).replace(os.sep, "/")
        if not _governed(rel):
            continue
        with open(path, encoding="utf-8") as f:
            src = f.read()
        violations.extend(scan_source(src, path, rel))
    violations.sort(key=lambda v: (v.path, v.line))
    return violations


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m spark_rapids_jni_tpu_torch.analysis.races",
        description="srjt-race layer 1: static guarded-by inference "
        "(SRJT008/009/010) over the governed concurrent modules")
    ap.add_argument("--root", default=None,
                    help="package root to scan (default: the installed "
                    "spark_rapids_jni_tpu_torch directory)")
    ap.add_argument("--format", default="text",
                    choices=("text", "json", "sarif"),
                    help="findings format (exit code is identical in "
                    "every mode)")
    ap.add_argument("--out", default=None,
                    help="also write the formatted findings to this path "
                    "(stdout then carries the one-line summary)")
    args = ap.parse_args(argv)
    violations = run(args.root)
    return write_findings(violations, args.format, args.out, "srjt-race")


if __name__ == "__main__":
    sys.exit(main())

"""``srjt-lint``: the invariant lint suite for the port's concurrent
substrate (stdlib ``ast`` only, no new dependencies).

The threaded subsystems' correctness rests on conventions a reviewer
would otherwise re-check by hand on every change. Each rule here
machine-checks one of them:

    SRJT001 undeclared-knob      every ``SRJTORCH_*`` string literal in the
                                 package must be declared in the
                                 utils/knobs.py registry (or be a knobs
                                 SENTINEL — a stdout handshake line).
    SRJT002 direct-environ-read  ``os.environ`` / ``os.getenv`` READS
                                 of SRJTORCH keys (or of dynamic keys
                                 that cannot be proven foreign) are only
                                 legal inside utils/knobs.py — the
                                 typed accessors are the one front
                                 door. Foreign literal keys
                                 (PYTHONPATH, CUDA_HOME) and
                                 environ WRITES are fine.
    SRJT003 banned-raise         no ``raise RuntimeError``/bare
                                 ``raise Exception`` inside the
                                 governed dirs (ops/, memgov/,
                                 parallel/, sidecar*.py): failures
                                 crossing those boundaries must speak
                                 the utils/errors.py taxonomy.
    SRJT004 broad-except         every ``except Exception`` /bare
                                 ``except:`` in the package must
                                 re-raise, wrap into the taxonomy
                                 (classify / raise_corruption / a
                                 taxonomy class), or carry an explicit
                                 suppression with a reason.
    SRJT005 stub-discipline      in the stub-pattern modules (metrics /
                                 tracing / integrity / faultinj /
                                 memgov gates) no string formatting or
                                 allocation-ish work may execute before
                                 the function's enabled-gate check —
                                 the disabled hot path stays one
                                 boolean read.
    SRJT006 blocking-call        ``time.sleep`` / ``socket.settimeout``
                                 / ``recv`` in the governed concurrent
                                 modules must live in functions that
                                 are deadline-aware (reference a
                                 deadline / remaining / budget /
                                 timeout) — a blocking call no deadline
                                 can interrupt is how queries hang
                                 forever.
    SRJT007 doc-drift            the knob registry and the
                                 README.md knob tables must
                                 agree both ways: every declared knob
                                 documented, every documented token
                                 declared.
    SRJT011 unverified-rewrite   every rewrite rule registered in
                                 plan/rewrites.py (plus prune_columns)
                                 must have a translation-validation
                                 discharger in plan/verifier.py's
                                 OBLIGATION_DISCHARGERS, or carry
                                 ``# srjt-plan: allow-unverified(<reason>)``
                                 inside its function body; a
                                 suppression on a rule that IS
                                 discharged is stale (SRJT000).
    SRJT000 bad-suppression      a suppression comment with an empty /
                                 missing reason is itself a violation.

Suppression syntax (reason REQUIRED), on the flagged line or alone on
the line directly above it::

    except Exception:  # srjt-lint: allow-broad-except(best-effort reap; spawn cleanup must never mask the startup error)
    time.sleep(d)      # srjt-lint: allow-blocking(detached respawn thread; owns no query budget)
    os.environ.get(k)  # srjt-lint: allow-environ(bootstrap read before utils can import)
    raise RuntimeError(m)  # srjt-lint: allow-raise(semantic wire error; breaker must record success)

Run ``python -m spark_rapids_jni_tpu_torch.analysis.lint`` from the repo
root (exit 1 on any violation); ``--knob-table`` renders the registry
as the markdown table the docs embed.
"""

from __future__ import annotations

import argparse
import ast
import json
import os
import re
import sys
from typing import Dict, List, Optional, Tuple

from ..utils.knobs import PREFIX

__all__ = [
    "Violation",
    "lint_source",
    "lint_file",
    "run",
    "main",
    "format_findings",
    "write_findings",
    "check_rewrite_obligations",
]

_KNOB_RE = re.compile(PREFIX + r"[A-Z0-9_]*[A-Z0-9]")
_KNOBS = PREFIX[:-1] + " knobs"  # the knob family's name in messages

# taxonomy names whose raise (or wrap) satisfies SRJT004; `classify`
# and `raise_corruption` are the two canonical wrap helpers
_TAXONOMY = {
    "DeviceError", "FatalDeviceError", "RetryableError", "DataCorruption",
    "DeadlineExceeded", "MemoryBudgetExceeded", "Overloaded", "classify",
    "raise_corruption",
}

# rule scopes, as path fragments relative to the package root
_RAISE_GOVERNED = ("ops/", "memgov/", "parallel/", "serve/", "plan/",
                   "sidecar.py", "sidecar_pool.py")
_BLOCKING_GOVERNED = ("sidecar.py", "sidecar_pool.py", "parallel/",
                      "memgov/", "serve/", "utils/retry.py",
                      "utils/faultinj.py", "utils/tracing.py",
                      "utils/trace_sink.py")
_STUB_MODULES = ("utils/metrics.py", "utils/tracing.py",
                 "utils/integrity.py", "utils/faultinj.py",
                 "memgov/__init__.py", "utils/trace_sink.py")

# identifiers marking the enabled-gate (SRJT005) ...
_GATE_NAMES = {"_enabled", "is_enabled", "enabled", "is_armed"}
# ... and, for SRJT006, the substrings marking a deadline-aware function
_DEADLINE_MARKS = ("deadline", "remaining", "budget", "timeout")

_SUPPRESS_RE = re.compile(r"#\s*srjt-lint:\s*allow-([a-z-]+)\s*\((.*)\)\s*$")
_RULE_SUPPRESSIONS = {
    "SRJT001": "knob",
    "SRJT002": "environ",
    "SRJT003": "raise",
    "SRJT004": "broad-except",
    "SRJT005": "stub",
    "SRJT006": "blocking",
}


class Violation:
    __slots__ = ("path", "line", "rule", "message")

    def __init__(self, path: str, line: int, rule: str, message: str):
        self.path = path
        self.line = line
        self.rule = rule
        self.message = message

    def __repr__(self):
        return f"{self.path}:{self.line}: {self.rule} {self.message}"


def _knob_names() -> Tuple[frozenset, frozenset]:
    from ..utils import knobs

    return knobs.names(), knobs.SENTINELS


def _suppressions(src: str) -> Dict[int, Tuple[str, str, int]]:
    """line -> (kind, reason, comment_line) for every line a suppression
    comment covers: its own line, and — for a standalone comment — the
    next line."""
    out: Dict[int, Tuple[str, str, int]] = {}
    for i, text in enumerate(src.splitlines(), start=1):
        m = _SUPPRESS_RE.search(text)
        if not m:
            continue
        kind, reason = m.group(1), m.group(2).strip()
        out[i] = (kind, reason, i)
        if text.lstrip().startswith("#"):  # standalone: covers the next line
            out[i + 1] = (kind, reason, i)
    return out


class _FileLinter(ast.NodeVisitor):
    def __init__(self, path: str, rel: str, src: str,
                 knob_names: frozenset, sentinels: frozenset,
                 knob_rules_only: bool = False):
        self.path = path
        self.rel = rel  # package-relative path ("utils/retry.py")
        self.src = src
        self.knob_names = knob_names
        self.sentinels = sentinels
        self.suppress = _suppressions(src)
        self.used_suppressions: set = set()
        self.violations: List[Violation] = []
        self.is_knobs = rel == "utils/knobs.py"
        self.is_analysis = rel.startswith("analysis/")
        # tests/ and benchmarks/ ride the KNOB rules only (SRJT001/002):
        # the package-convention rules (taxonomy raises, stub pattern,
        # broad excepts) deliberately do not govern test harness code,
        # and the stale-suppression audit is skipped there too (test
        # fixtures carry suppression syntax inside string literals,
        # which the line scanner cannot tell from live comments)
        self.knob_rules_only = knob_rules_only
        self._func_stack: List[ast.AST] = []

    # -- plumbing ------------------------------------------------------------

    def _flag(self, node, rule: str, message: str) -> None:
        if self.knob_rules_only and rule not in ("SRJT001", "SRJT002"):
            return
        line = getattr(node, "lineno", 1)
        kind = _RULE_SUPPRESSIONS.get(rule)
        sup = self.suppress.get(line)
        if sup is not None and kind is not None and sup[0] == kind:
            _, reason, comment_line = sup
            self.used_suppressions.add(comment_line)
            if not reason:
                self.violations.append(Violation(
                    self.path, comment_line, "SRJT000",
                    f"suppression allow-{kind}() needs a reason",
                ))
            return
        self.violations.append(Violation(self.path, line, rule, message))

    def finish(self) -> None:
        # a suppression nothing matched is stale — reasons rot fast.
        # analysis/ is exempt from the staleness audit only: its
        # docstrings carry the syntax examples.
        if self.knob_rules_only:
            return
        for line, (kind, reason, comment_line) in self.suppress.items():
            if line != comment_line:
                continue  # only audit each comment once
            if kind not in _RULE_SUPPRESSIONS.values():
                self.violations.append(Violation(
                    self.path, comment_line, "SRJT000",
                    f"unknown suppression kind allow-{kind}",
                ))
            elif comment_line in self.used_suppressions:
                continue
            elif not reason:
                self.violations.append(Violation(
                    self.path, comment_line, "SRJT000",
                    f"suppression allow-{kind}() needs a reason",
                ))
            elif not self.is_analysis:
                self.violations.append(Violation(
                    self.path, comment_line, "SRJT000",
                    f"stale suppression allow-{kind}: no suppressible "
                    "violation on this or the next line (the code it "
                    "excused is gone — delete the comment)",
                ))

    # -- SRJT001: undeclared knob literals -----------------------------------

    def _check_knob_literal(self, node, value: str) -> None:
        if self.is_knobs:
            return
        for m in _KNOB_RE.finditer(value):
            tok = m.group(0)
            if tok in self.knob_names or tok in self.sentinels:
                continue
            # "<PREFIX>RETRY_*" in prose is a family glob over declared
            # knobs, not an undeclared knob
            if (value[m.end():m.end() + 2] in ("_*",)
                    or value[m.end():m.end() + 1] == "*"):
                if any(k.startswith(tok) for k in self.knob_names):
                    continue
            self._flag(node, "SRJT001",
                       f"undeclared knob {tok}: declare it in "
                       "utils/knobs.py (name, type, default, doc)")

    def visit_Constant(self, node: ast.Constant):
        if isinstance(node.value, str) and PREFIX in node.value:
            self._check_knob_literal(node, node.value)
        self.generic_visit(node)

    # -- SRJT002: direct environ reads ---------------------------------------

    @staticmethod
    def _is_os_environ(node) -> bool:
        # "_os" covers the `import os as _os` bootstrap idiom — an
        # aliased read is still a direct read
        return (isinstance(node, ast.Attribute) and node.attr == "environ"
                and isinstance(node.value, ast.Name)
                and node.value.id in ("os", "_os")) or (
                    isinstance(node, ast.Name) and node.id == "environ")

    def _environ_read(self, node, key_node) -> None:
        if self.is_knobs:
            return
        if isinstance(key_node, ast.Constant) and isinstance(key_node.value, str):
            if not key_node.value.startswith(PREFIX):
                return  # PYTHONPATH / CUDA_HOME etc: not ours
            what = f"of {key_node.value}"
        else:
            what = "with a dynamic key"
        self._flag(node, "SRJT002",
                   f"direct os.environ read {what}: {_KNOBS} are read "
                   "through utils/knobs.py typed accessors only")

    def visit_Call(self, node: ast.Call):
        f = node.func
        # os.environ.get(...) / environ.get(...)
        if (isinstance(f, ast.Attribute) and f.attr == "get"
                and self._is_os_environ(f.value)):
            self._environ_read(node, node.args[0] if node.args else None)
        # os.getenv(...)
        elif (isinstance(f, ast.Attribute) and f.attr == "getenv"
                and isinstance(f.value, ast.Name) and f.value.id == "os"):
            self._environ_read(node, node.args[0] if node.args else None)
        elif isinstance(f, ast.Name) and f.id == "getenv":
            self._environ_read(node, node.args[0] if node.args else None)
        else:
            self._check_blocking_call(node)
        self.generic_visit(node)

    def visit_Subscript(self, node: ast.Subscript):
        if isinstance(node.ctx, ast.Load) and self._is_os_environ(node.value):
            self._environ_read(node, node.slice)
        self.generic_visit(node)

    # -- SRJT003: banned raises ----------------------------------------------

    def visit_Raise(self, node: ast.Raise):
        if any(self.rel.startswith(p) or self.rel == p
               for p in _RAISE_GOVERNED):
            exc = node.exc
            name = None
            if isinstance(exc, ast.Call) and isinstance(exc.func, ast.Name):
                name = exc.func.id
            elif isinstance(exc, ast.Name):
                name = exc.id
            if name in ("RuntimeError", "Exception"):
                self._flag(node, "SRJT003",
                           f"raise {name} in a governed module: use the "
                           "utils/errors.py taxonomy (FatalDeviceError / "
                           "RetryableError / DataCorruption / "
                           "DeadlineExceeded) so retry, breaker, and "
                           "failover classification stay correct")
        self.generic_visit(node)

    # -- SRJT004: broad excepts ----------------------------------------------

    @staticmethod
    def _catches_broad(handler: ast.ExceptHandler) -> bool:
        t = handler.type
        if t is None:
            return True  # bare except:
        names = []
        for n in (t.elts if isinstance(t, ast.Tuple) else [t]):
            if isinstance(n, ast.Name):
                names.append(n.id)
        return any(n in ("Exception", "BaseException") for n in names)

    @staticmethod
    def _handler_complies(handler: ast.ExceptHandler) -> bool:
        for sub in ast.walk(handler):
            if isinstance(sub, ast.Raise):
                if sub.exc is None:
                    return True  # bare re-raise
                f = sub.exc
                name = None
                if isinstance(f, ast.Call):
                    fn = f.func
                    if isinstance(fn, ast.Name):
                        name = fn.id
                    elif isinstance(fn, ast.Attribute):
                        name = fn.attr
                elif isinstance(f, ast.Name):
                    name = f.id
                if name in _TAXONOMY:
                    return True
        return False

    def visit_ExceptHandler(self, node: ast.ExceptHandler):
        if self._catches_broad(node) and not self._handler_complies(node):
            self._flag(node, "SRJT004",
                       "broad except must re-raise, wrap into the error "
                       "taxonomy, or carry "
                       "# srjt-lint: allow-broad-except(<reason>)")
        self.generic_visit(node)

    # -- SRJT005: stub discipline --------------------------------------------

    @staticmethod
    def _mentions_gate(stmt) -> bool:
        for sub in ast.walk(stmt):
            if isinstance(sub, ast.Name) and sub.id in _GATE_NAMES:
                return True
            if isinstance(sub, ast.Attribute) and sub.attr in _GATE_NAMES:
                return True
        return False

    @staticmethod
    def _alloc_nodes(stmt):
        for sub in ast.walk(stmt):
            if isinstance(sub, ast.JoinedStr):
                yield sub, "f-string"
            elif (isinstance(sub, ast.Call)
                    and isinstance(sub.func, ast.Attribute)
                    and sub.func.attr == "format"):
                yield sub, ".format() call"
            elif (isinstance(sub, ast.BinOp) and isinstance(sub.op, ast.Mod)
                    and isinstance(sub.left, ast.Constant)
                    and isinstance(sub.left.value, str)):
                yield sub, "%-format"
            elif (isinstance(sub, ast.Call) and isinstance(sub.func, ast.Name)
                    and sub.func.id == "open"):
                yield sub, "open() call"

    def _check_stub_function(self, node) -> None:
        gate_idx = None
        for i, stmt in enumerate(node.body):
            if self._mentions_gate(stmt):
                gate_idx = i
                break
        if gate_idx is None:
            return
        for stmt in node.body[:gate_idx]:
            for sub, what in self._alloc_nodes(stmt):
                self._flag(sub, "SRJT005",
                           f"{what} before the enabled-gate check: the "
                           "disabled hot path must stay one boolean "
                           "read (the metrics-stub pattern)")

    # -- SRJT006: blocking calls ---------------------------------------------

    def _check_blocking_call(self, node: ast.Call) -> None:
        if not any(self.rel.startswith(p) or self.rel == p
                   for p in _BLOCKING_GOVERNED):
            return
        f = node.func
        if not isinstance(f, ast.Attribute):
            return
        blocking = (
            (f.attr == "sleep" and isinstance(f.value, ast.Name)
             and f.value.id == "time")
            or f.attr in ("settimeout", "recv", "recvmsg")
        )
        if not blocking:
            return
        fn = self._func_stack[-1] if self._func_stack else None
        if fn is not None and self._deadline_aware(fn):
            return
        self._flag(node, "SRJT006",
                   f"blocking {f.attr}() outside a deadline-aware "
                   "function: route it through the deadline/timeout "
                   "wrappers (utils/deadline.py discipline) or carry "
                   "# srjt-lint: allow-blocking(<reason>)")

    @staticmethod
    def _deadline_aware(fn) -> bool:
        for sub in ast.walk(fn):
            ident = None
            if isinstance(sub, ast.Name):
                ident = sub.id
            elif isinstance(sub, ast.Attribute):
                # the blocking call itself ("settimeout") must not mark
                # its own function deadline-aware
                ident = None if sub.attr == "settimeout" else sub.attr
            elif isinstance(sub, ast.arg):
                ident = sub.arg
            if ident and any(m in ident.lower() for m in _DEADLINE_MARKS):
                return True
        return False

    # -- function scoping ----------------------------------------------------

    def _visit_func(self, node):
        if self.rel in _STUB_MODULES:
            self._check_stub_function(node)
        self._func_stack.append(node)
        self.generic_visit(node)
        self._func_stack.pop()

    visit_FunctionDef = _visit_func
    visit_AsyncFunctionDef = _visit_func


def lint_source(src: str, path: str, rel: Optional[str] = None,
                knob_names: Optional[frozenset] = None,
                sentinels: Optional[frozenset] = None,
                knob_rules_only: bool = False) -> List[Violation]:
    """Lint one source blob. ``rel`` is its package-relative path (rule
    scoping); tests pass fixture snippets with a synthetic ``rel``."""
    if knob_names is None or sentinels is None:
        knob_names, sentinels = _knob_names()
    if rel is None:
        rel = os.path.basename(path)
    try:
        tree = ast.parse(src, filename=path)
    except SyntaxError as e:
        return [Violation(path, e.lineno or 1, "SRJT999",
                          f"syntax error: {e.msg}")]
    linter = _FileLinter(path, rel, src, knob_names, sentinels,
                         knob_rules_only=knob_rules_only)
    linter.visit(tree)
    linter.finish()
    return linter.violations


def lint_file(path: str, pkg_root: str, knob_names, sentinels,
              knob_rules_only: bool = False):
    rel = os.path.relpath(path, pkg_root).replace(os.sep, "/")
    with open(path, encoding="utf-8") as f:
        src = f.read()
    return lint_source(src, path, rel, knob_names, sentinels,
                       knob_rules_only=knob_rules_only)


def _discover(pkg_root: str) -> List[str]:
    out = []
    for dirpath, dirnames, filenames in os.walk(pkg_root):
        # __pycache__ is scanner noise, never source
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                out.append(os.path.join(dirpath, fn))
    return out


# -- SRJT011: rewrite rules must emit verifiable obligations -----------------


_PLAN_SUPPRESS_RE = re.compile(r"#\s*srjt-plan:\s*allow-unverified\s*\((.*)\)")


def _registry_value(tree: ast.AST, name: str):
    """The value expression assigned to module-level ``name`` (plain or
    annotated assignment), or None."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == name
                for t in node.targets):
            return node.value
        if isinstance(node, ast.AnnAssign) \
                and isinstance(node.target, ast.Name) \
                and node.target.id == name:
            return node.value
    return None


def _parse_rules_registry(src: str) -> List[Tuple[str, str]]:
    """(rule name, function name) pairs off the RULES tuple literal."""
    try:
        tree = ast.parse(src)
    except SyntaxError:
        return []
    val = _registry_value(tree, "RULES")
    out: List[Tuple[str, str]] = []
    for elt in getattr(val, "elts", ()):
        if (isinstance(elt, (ast.Tuple, ast.List)) and len(elt.elts) == 2
                and isinstance(elt.elts[0], ast.Constant)
                and isinstance(elt.elts[1], ast.Name)):
            out.append((elt.elts[0].value, elt.elts[1].id))
    return out


def _parse_discharger_registry(src: str) -> frozenset:
    """String keys of the OBLIGATION_DISCHARGERS dict literal."""
    try:
        tree = ast.parse(src)
    except SyntaxError:
        return frozenset()
    val = _registry_value(tree, "OBLIGATION_DISCHARGERS")
    return frozenset(
        k.value for k in getattr(val, "keys", ())
        if isinstance(k, ast.Constant) and isinstance(k.value, str))


def check_rewrite_obligations(rules=None, dischargers=None,
                              src: Optional[str] = None,
                              path: Optional[str] = None) -> List[Violation]:
    """SRJT011: every rewrite function registered in
    ``plan/rewrites.py`` (``RULES`` plus ``prune_columns``) must be
    covered by a translation-validation discharger in
    ``plan/verifier.py`` — i.e. its firings emit obligations the
    verifier can actually discharge — or carry a reasoned
    ``# srjt-plan: allow-unverified(<reason>)`` inside its function
    body. An empty reason is SRJT000; a suppression on a rule that IS
    discharged is a stale SRJT000 (the stale-suppression audit).

    The default path is PURELY STATIC: both registries are read off the
    two files' ASTs (``RULES``' literal (name, fn) tuple and
    ``OBLIGATION_DISCHARGERS``' literal dict keys) — importing the plan
    package would drag torch into every lint run, and the analysis tier
    stays import-light by contract. A registry the parse cannot locate
    is itself a violation, so a refactor that breaks the static read
    fails loudly instead of silently passing. The parameters exist for
    fixture injection in tests (``rules`` entries may carry callables
    or function-name strings)."""
    if rules is None:
        pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        path = os.path.join(pkg, "plan", "rewrites.py")
        pv_path = os.path.join(pkg, "plan", "verifier.py")
        with open(path, encoding="utf-8") as f:
            src = f.read()
        rules = _parse_rules_registry(src)
        if not rules:
            return [Violation(
                path, 1, "SRJT011",
                "could not locate the RULES registry literal — the "
                "SRJT011 static parse needs RULES = ((name, fn), ...) "
                "at module scope")]
        rules = rules + [("prune_columns", "prune_columns")]
        with open(pv_path, encoding="utf-8") as f:
            pv_src = f.read()
        dischargers = _parse_discharger_registry(pv_src)
        if not dischargers:
            return [Violation(
                pv_path, 1, "SRJT011",
                "could not locate the OBLIGATION_DISCHARGERS dict "
                "literal — the SRJT011 static parse needs its string "
                "keys at module scope")]
    dischargers = frozenset(dischargers or ())
    try:
        tree = ast.parse(src, filename=path or "<rewrites>")
    except SyntaxError as e:
        return [Violation(path or "<rewrites>", e.lineno or 1, "SRJT999",
                          f"syntax error: {e.msg}")]
    lines = src.splitlines()
    funcs: Dict[str, Tuple[int, Optional[str], int]] = {}
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            reason, rline = None, node.lineno
            for ln in range(node.lineno, (node.end_lineno or node.lineno) + 1):
                m = _PLAN_SUPPRESS_RE.search(lines[ln - 1])
                if m:
                    reason, rline = m.group(1).strip(), ln
                    break
            funcs[node.name] = (node.lineno, reason, rline)
    out: List[Violation] = []
    where = path or "<rewrites>"
    for name, fn in rules:
        fname = fn if isinstance(fn, str) else getattr(fn, "__name__", str(fn))
        lineno, reason, rline = funcs.get(fname, (1, None, 1))
        if name in dischargers:
            if reason is not None:
                out.append(Violation(
                    where, rline, "SRJT000",
                    f"stale suppression allow-unverified on rule {name!r}: "
                    "a discharger IS registered in plan/verifier.py — "
                    "delete the comment"))
            continue
        if reason is None:
            out.append(Violation(
                where, lineno, "SRJT011",
                f"rewrite rule {name!r} has no translation-validation "
                "discharger in plan/verifier.py OBLIGATION_DISCHARGERS: "
                "its firings are unverifiable — register one or carry "
                "# srjt-plan: allow-unverified(<reason>)"))
        elif not reason:
            out.append(Violation(
                where, rline, "SRJT000",
                f"suppression allow-unverified() on rule {name!r} needs "
                "a reason"))
    return out


# -- SRJT007: registry <-> doc-table drift ----------------------------------


def check_docs(repo_root: str, knob_names: Optional[frozenset] = None,
               sentinels: Optional[frozenset] = None) -> List[Violation]:
    if knob_names is None or sentinels is None:
        knob_names, sentinels = _knob_names()
    docs = [p for p in ("README.md",)
            if os.path.exists(os.path.join(repo_root, p))]
    out: List[Violation] = []
    if not docs:
        return out
    tabled: set = set()  # knobs appearing in an actual table row
    for doc in docs:
        path = os.path.join(repo_root, doc)
        with open(path, encoding="utf-8") as f:
            for lineno, line in enumerate(f, start=1):
                is_row = line.lstrip().startswith("|")
                for tok in _KNOB_RE.findall(line):
                    if is_row:
                        tabled.add(tok)
                    if tok in knob_names or tok in sentinels:
                        continue
                    # prose/diagram allowance only: ASCII diagrams wrap
                    # long names, so a strict prefix of a declared knob
                    # is a wrapped reference there — inside a knob
                    # TABLE row the name must be exact (a truncated
                    # name in the table IS the drift this rule exists
                    # to catch)
                    if not is_row and any(k.startswith(tok)
                                          for k in knob_names):
                        continue
                    out.append(Violation(
                        path, lineno, "SRJT007",
                        f"documented knob {tok} is not declared in "
                        "utils/knobs.py (typo, or a knob that was "
                        "removed from the code?)"))
    for name in sorted(knob_names):
        # a prose mention is not documentation: the knob must sit in a
        # markdown table row (the operator-facing knob tables)
        if name not in tabled:
            out.append(Violation(
                os.path.join(repo_root, "README.md"), 1, "SRJT007",
                f"declared knob {name} appears in no README.md "
                "knob-table row (add it to a knob table; "
                "--knob-table renders the registry)"))
    return out


def run(pkg_root: Optional[str] = None,
        with_docs: bool = True,
        with_harness: bool = True,
        with_plan: bool = True) -> List[Violation]:
    real_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if pkg_root is None:
        pkg_root = real_root
    knob_names, sentinels = _knob_names()
    violations: List[Violation] = []
    if with_plan and os.path.abspath(pkg_root) == real_root:
        # SRJT011 is a cross-file check over the REAL plan modules; a
        # fixture pkg_root must not drag the live tree into its run
        violations.extend(check_rewrite_obligations())
    for path in _discover(pkg_root):
        violations.extend(lint_file(path, pkg_root, knob_names, sentinels))
    if with_harness:
        # tests/ and benchmarks/ honor the knob
        # registry too (SRJT001/002 only — see _FileLinter) so a test
        # reading an SRJT env var directly, or inventing an undeclared
        # knob name, fails the same gate the package does
        repo_root = os.path.dirname(pkg_root)
        for sub in ("tests", "benchmarks"):
            d = os.path.join(repo_root, sub)
            if not os.path.isdir(d):
                continue
            for path in _discover(d):
                rel = sub + "/" + os.path.relpath(path, d).replace(os.sep, "/")
                with open(path, encoding="utf-8") as f:
                    src = f.read()
                violations.extend(lint_source(
                    src, path, rel, knob_names, sentinels,
                    knob_rules_only=True,
                ))
    if with_docs:
        violations.extend(check_docs(os.path.dirname(pkg_root),
                                     knob_names, sentinels))
    violations.sort(key=lambda v: (v.path, v.line))
    return violations


# -- machine-readable findings ------------------------------------------------


def format_findings(violations: List[Violation], fmt: str,
                    tool: str = "srjt-lint") -> str:
    """Render findings as ``text`` / ``json`` / ``sarif``. Every format
    carries the same (path, line, rule, message) tuples."""
    if fmt == "text":
        return "\n".join(repr(v) for v in violations)
    if fmt == "json":
        return json.dumps({
            "tool": tool,
            "findings": [
                {"path": v.path, "line": v.line, "rule": v.rule,
                 "message": v.message}
                for v in violations
            ],
        }, indent=1)
    if fmt == "sarif":
        # SARIF consumers anchor results by RELATIVE uri: strip the
        # repo root off the absolute paths run() produces (paths from
        # elsewhere — tmpdirs, fixtures — pass through unchanged)
        repo_root = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__)))) + os.sep

        def _uri(path: str) -> str:
            if path.startswith(repo_root):
                path = path[len(repo_root):]
            return path.replace(os.sep, "/")

        rules = sorted({v.rule for v in violations})
        return json.dumps({
            "$schema": ("https://raw.githubusercontent.com/oasis-tcs/"
                        "sarif-spec/master/Schemata/sarif-schema-2.1.0.json"),
            "version": "2.1.0",
            "runs": [{
                "tool": {"driver": {
                    "name": tool,
                    "rules": [{"id": r} for r in rules],
                }},
                "results": [
                    {
                        "ruleId": v.rule,
                        "level": "error",
                        "message": {"text": v.message},
                        "locations": [{
                            "physicalLocation": {
                                "artifactLocation": {
                                    "uri": _uri(v.path),
                                },
                                "region": {"startLine": max(v.line, 1)},
                            },
                        }],
                    }
                    for v in violations
                ],
            }],
        }, indent=1)
    raise ValueError(f"unknown findings format {fmt!r}")


def write_findings(violations: List[Violation], fmt: str,
                   out: Optional[str], tool: str) -> int:
    """Emit findings and return the EXIT CODE — identical across every
    format (the text-mode contract: 1 on any violation, else 0). With
    ``--out`` the formatted findings land in the file and stdout gets
    the one-line summary; without it they go to stdout."""
    body = format_findings(violations, fmt, tool)
    if out:
        d = os.path.dirname(out)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(out, "w", encoding="utf-8") as f:
            f.write(body + "\n")
    elif body:
        print(body)
    if violations:
        print(f"{tool}: {len(violations)} violation(s)"
              + (f" -> {out}" if out else ""), file=sys.stderr)
        return 1
    print(f"{tool}: clean" + (f" -> {out}" if out else ""))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m spark_rapids_jni_tpu_torch.analysis.lint",
        description="srjt-lint: invariant lint suite over the port")
    ap.add_argument("--root", default=None,
                    help="package root to lint (default: the installed "
                    "spark_rapids_jni_tpu_torch directory)")
    ap.add_argument("--no-docs", action="store_true",
                    help="skip the README.md knob-table drift check")
    ap.add_argument("--no-harness", action="store_true",
                    help="skip the tests/ + benchmarks/ knob-rule scan")
    ap.add_argument("--no-plan", action="store_true",
                    help="skip the SRJT011 rewrite-obligation coverage "
                    "check over plan/rewrites.py")
    ap.add_argument("--knob-table", action="store_true",
                    help="print the registry as a markdown table and exit")
    ap.add_argument("--format", default="text",
                    choices=("text", "json", "sarif"),
                    help="findings format (exit code is identical in "
                    "every mode)")
    ap.add_argument("--out", default=None,
                    help="also write the formatted findings to this path "
                    "(stdout then carries the one-line summary)")
    args = ap.parse_args(argv)
    if args.knob_table:
        from ..utils import knobs

        print(knobs.markdown_table())
        return 0
    violations = run(args.root, with_docs=not args.no_docs,
                     with_harness=not args.no_harness,
                     with_plan=not args.no_plan)
    return write_findings(violations, args.format, args.out, "srjt-lint")


if __name__ == "__main__":
    sys.exit(main())

"""Port: the static checkers (``analysis/lint.py`` SRJT000-007 and
SRJT011, ``analysis/races.py`` SRJT008-010) held against the JAX
package's on the same source snippets. Every snippet is written once with
``{P}`` for the knob prefix and goes through both linters; the findings
must agree on (path, line, rule) and on the message, with only the knob
prefix differing. The port's checkers over the port's own tree report
nothing, and the shared emitters keep their formats and exit codes."""

import json

import pytest

from spark_rapids_jni_tpu.analysis import lint as rlint
from spark_rapids_jni_tpu.analysis import races as rraces
from spark_rapids_jni_tpu_torch.analysis import lint as plint
from spark_rapids_jni_tpu_torch.analysis import races as praces
from spark_rapids_jni_tpu_torch.utils import knobs as pknobs

REF_P, PORT_P = "SRJT" + "_", pknobs.PREFIX


def _sides(text: str):
    return text.replace("{P}", REF_P), text.replace("{P}", PORT_P)


def _norm(vs):
    """(path, line, rule, message) with the port's prefix mapped back."""
    return [(v.path, v.line, v.rule,
             v.message.replace(PORT_P[:-1], REF_P[:-1])) for v in vs]


# a hermetic registry view: rule scoping must not drift with real knobs
_KNOBS = "{P}RETRY_ENABLED", "{P}DEADLINE_SEC"
_SENTINELS = ("{P}SIDECAR_READY",)


def _registry(side):
    i = 0 if side == "ref" else 1
    return (frozenset(_sides(k)[i] for k in _KNOBS),
            frozenset(_sides(k)[i] for k in _SENTINELS))


def _lint_both(src, rel):
    r_src, p_src = _sides(src)
    path = f"<fixture:{rel}>"
    r = rlint.lint_source(r_src, path, rel, *_registry("ref"))
    p = plint.lint_source(p_src, path, rel, *_registry("port"))
    assert _norm(p) == _norm(r), (p, r)
    return p


def _rules(vs, rules=None):
    return [v.rule for v in vs if rules is None or v.rule in rules]


_BROAD = "def f():\n    try:\n        g()\n    {h}\n"

# (id, source, package-relative path, rules looked at, rules expected)
LINT_CASES = [
    ("undeclared_knob", 'x = os.environ\nk = "{P}BOGUS_KNOB"\n', "utils/x.py",
     {"SRJT001"}, ["SRJT001"]),
    ("declared_and_sentinel", 'a = "{P}RETRY_ENABLED"\nb = "{P}SIDECAR_READY"\n', "utils/x.py",
     {"SRJT001"}, []),
    ("family_glob", 'doc = "set {P}RETRY_* to tune"\n', "utils/x.py", {"SRJT001"}, []),
    ("knob_suppressed", 'k = "{P}BOGUS"  # srjt-lint: allow-knob(doc example)\n', "utils/x.py",
     {"SRJT001"}, []),
    ("knobs_module_exempt", 'declare("{P}NEW_ONE", "int", 1, "d")\n', "utils/knobs.py",
     {"SRJT001"}, []),
    ("environ_get", 'import os\nv = os.environ.get("{P}RETRY_ENABLED")\n', "memgov/x.py",
     {"SRJT002"}, ["SRJT002"]),
    ("environ_subscript", 'import os\nv = os.environ["{P}RETRY_ENABLED"]\n', "memgov/x.py",
     {"SRJT002"}, ["SRJT002"]),
    ("getenv", 'import os\nv = os.getenv("{P}RETRY_ENABLED")\n', "memgov/x.py",
     {"SRJT002"}, ["SRJT002"]),
    ("environ_dynamic", 'import os\nk = "{P}" + name\nv = os.environ.get(k)\n', "memgov/x.py",
     {"SRJT002"}, ["SRJT002"]),
    ("environ_foreign_and_write",
     'import os\nv = os.environ.get("CUDA_HOME")\nos.environ["{P}RETRY_ENABLED"] = "1"\n',
     "memgov/x.py", {"SRJT002"}, []),
    ("environ_suppressed",
     'import os\nv = os.environ.get("{P}RETRY_ENABLED")  # srjt-lint: allow-environ(bootstrap read)\n',
     "x.py", {"SRJT002"}, []),
    ("environ_aliased", 'import os as _os\nv = _os.environ.get("{P}RETRY_ENABLED")\n', "x.py",
     {"SRJT002"}, ["SRJT002"]),
] + [
    (f"raise_runtime_{rel}", 'def f():\n    raise RuntimeError("boom")\n', rel,
     {"SRJT003"}, ["SRJT003"])
    for rel in ("ops/x.py", "memgov/x.py", "parallel/x.py", "sidecar.py", "serve/x.py", "plan/x.py")
] + [
    ("raise_ungoverned", 'def f():\n    raise RuntimeError("boom")\n', "io/x.py", {"SRJT003"}, []),
    ("raise_taxonomy", 'def f():\n    raise RetryableError("transient")\n', "ops/x.py",
     {"SRJT003"}, []),
    ("raise_suppressed",
     'def f():\n    raise RuntimeError("wire")  # srjt-lint: allow-raise(semantic wire error)\n',
     "ops/x.py", {"SRJT003"}, []),
] + [
    (f"broad_swallow_{i}", _BROAD.format(h=h), "utils/x.py", {"SRJT004"}, ["SRJT004"])
    for i, h in enumerate(["except Exception:\n        pass", "except:\n        pass",
                           "except (ValueError, Exception):\n        pass",
                           "except BaseException:\n        pass"])
] + [
    (f"broad_compliant_{i}", _BROAD.format(h=h), "utils/x.py", {"SRJT004"}, [])
    for i, h in enumerate(["except Exception:\n        raise",
                           "except Exception as e:\n        raise classify(e)",
                           "except Exception as e:\n        raise DataCorruption(str(e))",
                           "except ValueError:\n        pass"])
] + [
    ("broad_suppressed_inline",
     "def f():\n    try:\n        g()\n    except Exception:  "
     "# srjt-lint: allow-broad-except(best effort)\n        pass\n", "utils/x.py", {"SRJT004"}, []),
    ("broad_suppressed_above",
     "def f():\n    try:\n        g()\n    # srjt-lint: allow-broad-except(best effort)\n"
     "    except Exception:\n        pass\n", "utils/x.py", {"SRJT004"}, []),
    ("suppression_without_reason",
     "def f():\n    try:\n        g()\n    except Exception:  # srjt-lint: allow-broad-except()\n"
     "        pass\n", "utils/x.py", None, ["SRJT000"]),
    ("unknown_suppression_kind", "x = 1  # srjt-lint: allow-wat(huh)\n", "utils/x.py", None,
     ["SRJT000"]),
    ("stale_suppression", "x = 1  # srjt-lint: allow-blocking(was a sleep once)\n", "sidecar.py",
     None, ["SRJT000"]),
    ("stub_work_before_gate",
     'def counter(name):\n    label = f"metric:{name}"\n    if not _enabled:\n'
     '        return _STUB\n    return _real(label)\n', "utils/metrics.py", {"SRJT005"},
     ["SRJT005"]),
    ("stub_work_after_gate",
     'def counter(name):\n    if not _enabled:\n        return _STUB\n'
     '    return _real(f"metric:{name}")\n', "utils/metrics.py", {"SRJT005"}, []),
    ("stub_ungoverned",
     'def f(name):\n    label = f"x:{name}"\n    if not _enabled:\n        return None\n'
     '    return label\n', "ops/x.py", {"SRJT005"}, []),
    ("blind_sleep", "import time\ndef f():\n    time.sleep(1)\n", "sidecar.py", {"SRJT006"},
     ["SRJT006"]),
    ("deadline_aware_sleep",
     "import time\ndef f(deadline):\n    time.sleep(min(1, deadline.remaining()))\n",
     "sidecar.py", {"SRJT006"}, []),
    ("sleep_ungoverned", "import time\ndef f():\n    time.sleep(1)\n", "models/x.py",
     {"SRJT006"}, []),
    ("sleep_suppressed",
     "import time\ndef f():\n    time.sleep(1)  # srjt-lint: allow-blocking(no budget)\n",
     "sidecar.py", {"SRJT006"}, []),
    ("settimeout_and_recv", "def f(sock):\n    sock.settimeout(5)\n    return sock.recv(4)\n",
     "parallel/x.py", {"SRJT006"}, ["SRJT006", "SRJT006"]),
    ("syntax_error", "def f(:\n", "utils/x.py", None, ["SRJT999"]),
]


@pytest.mark.parametrize("src,rel,rules,want", [c[1:] for c in LINT_CASES],
                         ids=[c[0] for c in LINT_CASES])
def test_lint_snippet_matches_reference(src, rel, rules, want):
    assert _rules(_lint_both(src, rel), rules) == want


@pytest.mark.parametrize("doc,n", [
    ("| `{P}RETRY_ENABLED` | arm retry |\n| `{P}GHOST_KNOB` | documented but gone |\n", 2),
    ("| `{P}RETRY_ENABLED` | arm retry |\nSet {P}DEADLINE_SEC for budgets.\n", 1),
    ("| `{P}RETRY` | truncated row |\n  diagram: {P}RETRY (wrapped)\n"
     "| `{P}RETRY_ENABLED` | ok |\n| `{P}DEADLINE_SEC` | ok |\n", 1),
], ids=["both_directions", "prose_is_not_documentation", "truncated_row"])
def test_doc_drift_matches_reference(tmp_path, doc, n):
    got = {}
    for side, text in zip(("ref", "port"), _sides(doc)):
        d = tmp_path / side
        d.mkdir()
        (d / "README.md").write_text(text)
        mod = rlint if side == "ref" else plint
        vs = mod.check_docs(str(d), *_registry(side))
        got[side] = [(v.path.replace(str(d), ""), v.line, v.rule, v.message) for v in vs]
    assert len(got["port"]) == n and all(r == "SRJT007" for _, _, r, _ in got["port"])
    # the port reads README.md only (no PACKAGING.md): the message names it alone
    ref = [(p, ln, r, m.replace("README.md/PACKAGING.md", "README.md"))
           for p, ln, r, m in got["ref"]]
    assert [(p, ln, r, m.replace(PORT_P[:-1], REF_P[:-1])) for p, ln, r, m in got["port"]] == ref


# -- SRJT011: rewrite rules must have dischargers -----------------------------

_SRJT011_SRC = """
def _rule_a(node, catalog, memo):
    return None

def _rule_b(node, catalog, memo):
    # srjt-plan: allow-unverified(cost-only hint; never changes rows)
    return None

def _rule_c(node, catalog, memo):
    # srjt-plan: allow-unverified()
    return None
"""


@pytest.mark.parametrize("rules,dischargers,want", [
    (["rule_a"], (), ["SRJT011"]),
    (["rule_b"], (), []),
    (["rule_c"], (), ["SRJT000"]),
    (["rule_b"], ("rule_b",), ["SRJT000"]),
    (["rule_a"], ("rule_a",), []),
], ids=["undischarged", "reasoned_suppression", "empty_reason", "stale", "discharged"])
def test_srjt011_matches_reference(rules, dischargers, want):
    fns = {}
    exec(_SRJT011_SRC, fns)
    pairs = [(name, fns[f"_rule_{name[-1]}"]) for name in rules]
    r, p = (m.check_rewrite_obligations(rules=pairs, dischargers=dischargers, src=_SRJT011_SRC,
                                        path="fixture_rewrites.py") for m in (rlint, plint))
    assert _norm(p) == _norm(r) and _rules(p) == want


def test_srjt011_real_tree_clean_and_total():
    from spark_rapids_jni_tpu_torch.plan import rewrites as rw
    from spark_rapids_jni_tpu_torch.plan import verifier as pv

    assert plint.check_rewrite_obligations() == []
    assert {n for n, _ in rw.RULES} | {"prune_columns"} <= set(pv.OBLIGATION_DISCHARGERS)


# -- srjt-race layer 1 --------------------------------------------------------

MIXED = """\
import threading

class C:
    def __init__(self):
        self._lock = threading.Lock()
        self._count = 0

    def bump(self):
        with self._lock:
            self._count += 1

    def peek(self):
        return self._count
"""

CHECK_THEN_ACT = """\
import threading

class C:
    def __init__(self):
        self._lock = threading.Lock()
        self._slab = None

    def get(self):
        if self._slab is None:
            with self._lock:
                self._slab = object()
        return self._slab
"""

GLOBAL_MUT = """\
import threading

_CACHE = {}
_CACHE_LOCK = threading.Lock()


def put(k, v):
    _CACHE[k] = v
"""

_CLASS = "import threading\n\nclass C:\n    def __init__(self):\n"

RACE_CASES = [
    ("mixed", MIXED, {"SRJT008"}, ["SRJT008"]),
    ("fully_guarded", MIXED.replace(
        "    def peek(self):\n        return self._count\n",
        "    def peek(self):\n        with self._lock:\n            return self._count\n"),
     None, []),
    ("locked_suffix", MIXED.replace("def peek(self):", "def peek_locked(self):"), None, []),
    ("init_only_writes", _CLASS + "        self._lock = threading.Lock()\n"
     "        self._workers = [1, 2, 3]\n\n    def pick(self):\n        with self._lock:\n"
     "            return self._workers[0]\n\n    def count(self):\n"
     "        return len(self._workers)\n", None, []),
    ("condition_alias", _CLASS + "        self._lock = threading.Lock()\n"
     "        self._health = threading.Condition(self._lock)\n        self._n = 0\n\n"
     "    def a(self):\n        with self._lock:\n            self._n += 1\n\n"
     "    def b(self):\n        with self._health:\n            self._n += 1\n", None, []),
    ("own_condition", _CLASS + "        self._cond = threading.Condition()\n"
     "        self._q = []\n\n    def put(self, x):\n        with self._cond:\n"
     "            self._q.append(x)\n\n    def depth(self):\n        return len(self._q)\n",
     {"SRJT008"}, ["SRJT008"]),
    ("nested_def_is_bare", _CLASS + "        self._lock = threading.Lock()\n"
     "        self._m = {}\n\n    def go(self):\n        with self._lock:\n"
     "            self._m[\"x\"] = 1\n            def later():\n"
     "                self._m[\"x\"] = 2\n            threading.Thread(target=later).start()\n",
     {"SRJT008"}, ["SRJT008"]),
    ("lambda_in_place", _CLASS + "        self._lock = threading.Lock()\n"
     "        self._m = {}\n\n    def evict(self):\n        with self._lock:\n"
     "            self._m.pop(min(self._m, key=lambda k: self._m[k]))\n", None, []),
    ("init_suppression", MIXED.replace(
        "        self._count = 0",
        "        self._count = 0  # srjt-race: allow-unguarded(GIL-atomic word)"), None, []),
    ("guarded_by_suppression", MIXED.replace(
        "        return self._count", "        return self._count  # srjt-race: guarded-by(_lock)"),
     None, []),
    ("empty_suppression", MIXED.replace(
        "        return self._count", "        return self._count  # srjt-race: allow-unguarded()"),
     None, ["SRJT000"]),
    ("stale_suppression", "x = 1  # srjt-race: guarded-by(_lock)\n", None, ["SRJT000"]),
    ("check_then_act", CHECK_THEN_ACT, {"SRJT009"}, ["SRJT009"]),
    ("check_under_other_lock", _CLASS + "        self._lock = threading.Lock()\n"
     "        self._aux = threading.Lock()\n        self._slab = None\n\n    def get(self):\n"
     "        with self._aux:\n            if self._slab is None:\n                pass\n"
     "        with self._lock:\n            self._slab = object()\n", {"SRJT009"}, ["SRJT009"]),
    ("check_under_own_lock", CHECK_THEN_ACT.replace(
        "        if self._slab is None:\n            with self._lock:\n"
        "                self._slab = object()\n        return self._slab\n",
        "        with self._lock:\n            if self._slab is None:\n"
        "                self._slab = object()\n            return self._slab\n"),
     {"SRJT009"}, []),
    ("read_only_check", CHECK_THEN_ACT.replace(
        "            with self._lock:\n                self._slab = object()\n",
        "            pass\n"), {"SRJT009"}, []),
    ("check_then_act_suppressed", CHECK_THEN_ACT.replace(
        "        if self._slab is None:",
        "        if self._slab is None:  "
        "# srjt-race: allow-unguarded(idempotent lazy init; double build is benign)"),
     {"SRJT009"}, []),
    ("bare_global", GLOBAL_MUT, {"SRJT010"}, ["SRJT010"]),
    ("global_under_lock", GLOBAL_MUT.replace(
        "    _CACHE[k] = v", "    with _CACHE_LOCK:\n        _CACHE[k] = v"), {"SRJT010"}, []),
    ("global_mutator", "_SEEN = set()\n\n\ndef note(x):\n    _SEEN.add(x)\n", {"SRJT010"},
     ["SRJT010"]),
    ("global_shadowed", "_CACHE = {}\n\n\ndef f():\n    _CACHE = {}\n    _CACHE['x'] = 1\n",
     {"SRJT010"}, []),
    ("global_suppressed", GLOBAL_MUT.replace(
        "    _CACHE[k] = v",
        "    _CACHE[k] = v  "
        "# srjt-race: allow-unguarded(import-time only; single-threaded by construction)"),
     {"SRJT010"}, []),
]


@pytest.mark.parametrize("src,rules,want", [c[1:] for c in RACE_CASES],
                         ids=[c[0] for c in RACE_CASES])
def test_race_snippet_matches_reference(src, rules, want):
    rel = "serve/x.py"
    r = rraces.scan_source(src, f"<fixture:{rel}>", rel)
    p = praces.scan_source(src, f"<fixture:{rel}>", rel)
    assert _norm(p) == _norm(r)
    assert _rules(p, rules) == want


def test_race_governed_scope_is_the_references():
    assert praces.RACE_GOVERNED == rraces.RACE_GOVERNED
    for rel in ("serve/scheduler.py", "sidecar_pool.py", "utils/metrics.py",
                "parallel/shuffle.py", "parallel/cluster.py", "cache/flight.py"):
        assert praces._governed(rel)
    assert not praces._governed("ops/join.py") and not praces._governed("models/tpcds.py")


# -- the port's tree, the emitters, the CLIs ----------------------------------


def test_port_tree_lints_clean():
    vs = plint.run()
    assert vs == [], "\n".join(repr(v) for v in vs)


def test_port_tree_races_clean():
    vs = praces.run()
    assert vs == [], "\n".join(repr(v) for v in vs)


def test_port_carries_the_references_suppressions_with_reasons():
    # every site the port suppresses names its reason, as the reference's do
    import re
    from pathlib import Path

    root = Path(praces.__file__).resolve().parent.parent
    pat = re.compile(r"#\s*srjt-(lint|race):\s*([a-z-]+)\s*\((.*?)\)")
    found = []
    for path in sorted(root.rglob("*.py")):
        if "analysis" in path.parts:
            continue
        for line in path.read_text().splitlines():
            m = pat.search(line)
            if m:
                found.append((path.name, m.group(2), m.group(3).strip()))
    assert len(found) >= 38 and all(reason for _, _, reason in found)


@pytest.mark.parametrize("fmt", ["text", "json", "sarif"])
def test_emitters_match_reference(fmt, tmp_path, capsys):
    vs = [plint.Violation("a.py", 3, "SRJT008", "msg one"),
          plint.Violation("b.py", 7, "SRJT010", "msg two")]
    rvs = [rlint.Violation(v.path, v.line, v.rule, v.message) for v in vs]
    assert plint.format_findings(vs, fmt, tool="t") == rlint.format_findings(rvs, fmt, tool="t")
    rc_dirty = plint.write_findings(vs, fmt, str(tmp_path / f"d.{fmt}"), "t")
    rc_clean = plint.write_findings([], fmt, str(tmp_path / f"c.{fmt}"), "t")
    capsys.readouterr()
    assert (rc_dirty, rc_clean) == (1, 0)


def test_clis_exit_clean_on_the_port(tmp_path, capsys):
    assert praces.main([]) == 0
    out = tmp_path / "r.sarif"
    assert praces.main(["--format=sarif", f"--out={out}"]) == 0
    assert json.loads(out.read_text())["version"] == "2.1.0"
    out = tmp_path / "lint.sarif"
    assert plint.main(["--format=sarif", f"--out={out}", "--no-docs", "--no-harness"]) == 0
    assert json.loads(out.read_text())["runs"][0]["tool"]["driver"]["name"] == "srjt-lint"
    assert plint.main(["--knob-table"]) == 0
    table = capsys.readouterr().out
    assert "SRJTORCH_LOCKDEP_DIR" in table and "SRJTORCH_RACE" in table

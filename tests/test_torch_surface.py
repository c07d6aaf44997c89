"""Port: its public surface held to the JAX package's.

Both trees are read as source with ``ast``; neither package is imported,
so the check needs neither jax nor torch and runs in well under a second.
For every module of the reference, the port's module of the same relative
path must bind every public top-level function and class and every
``__all__`` name; for every class that both modules define, the port's
class must bind every public method of the reference's. ``EXCLUDED``
lists what is left out on purpose, one reason an entry. An entry the
reference no longer defines, or the port now defines, fails as well, so
the list cannot go stale.

Run alone: ``python -m pytest tests/test_torch_surface.py -q -p no:xdist``.
"""

import ast
import functools
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
REF = ROOT / "spark_rapids_jni_tpu"
PORT = ROOT / "spark_rapids_jni_tpu_torch"

_NO_FLOAT64 = ("double-f32 arithmetic for backends without float64; the CPU "
               "and the card have float64 (ops/f64acc.py:604-963)")
_PYTREE = ("the JAX pytree protocol; torch tensors need no flattening to "
           "cross a traced call")

# "module" for a whole module, "module::name" for a top-level name,
# "module::Class.method" for a method: reason (ROADMAP.md §1, "Not ported,
# on purpose").
EXCLUDED = {
    "ops/pallas_kernels.py": ("the TPU kernels and their tier dispatch; each "
                              "kernel has a hand-written CUDA counterpart in "
                              "csrc/, bound in ops/hopper_kernels.py"),
    "parallel/_smcache.py": ("memoizes jitted shard_map callables; eager "
                             "PyTorch compiles no per-callable program"),
    "ops/ragged_bytes.py::ragged_compact_tiered": (
        "a Pallas tier with a silent fallback; the port's B5 wrapper "
        "launches its kernel or raises"),
    "ops/f64acc.py::DD": _NO_FLOAT64,
    "ops/f64acc.py::dd_from_any": _NO_FLOAT64,
    "ops/f64acc.py::dd_from_f64bits": _NO_FLOAT64,
    "ops/f64acc.py::dd_to_f64bits": _NO_FLOAT64,
    "ops/f64acc.py::add2_f64bits": _NO_FLOAT64,
    "columnar/column.py::Column.tree_flatten": _PYTREE,
    "columnar/column.py::Column.tree_unflatten": _PYTREE,
    "columnar/table.py::Table.tree_flatten": _PYTREE,
    "columnar/table.py::Table.tree_unflatten": _PYTREE,
    "columnar/dtype.py::DType.jnp_dtype": ("the jax.numpy type; its "
                                           "counterpart is DType.torch_dtype"),
}


def _bound(body):
    """Every name a block binds: defs, classes, assignments, imports."""
    out = set()
    for s in body:
        if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            out.add(s.name)
        elif isinstance(s, (ast.Import, ast.ImportFrom)):
            out.update((a.asname or a.name).split(".")[0] for a in s.names)
        elif isinstance(s, (ast.Assign, ast.AnnAssign)):
            targets = s.targets if isinstance(s, ast.Assign) else [s.target]
            out.update(n.id for t in targets for n in ast.walk(t)
                       if isinstance(n, ast.Name))
    return out


class _Module:
    def __init__(self, path):
        tree = ast.parse(path.read_text(), filename=str(path))
        self.bound = _bound(tree.body)
        self.defs = set()
        self.classes = {}
        self.all = []
        for s in tree.body:
            if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                self.defs.add(s.name)
            if isinstance(s, ast.ClassDef):
                self.classes[s.name] = s
            if (isinstance(s, ast.Assign)
                    and any(isinstance(t, ast.Name) and t.id == "__all__" for t in s.targets)):
                self.all = list(ast.literal_eval(s.value))

    def methods(self, name):
        """Public methods defined in the class's own body."""
        return {s.name for s in self.classes[name].body
                if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef))
                and not s.name.startswith("_")}

    def members(self, name):
        """Names the class's own body binds."""
        return _bound(self.classes[name].body)


@functools.lru_cache(maxsize=None)
def _module(path):
    return _Module(path)


def _ref_modules():
    return sorted(p.relative_to(REF).as_posix() for p in REF.rglob("*.py"))


def _required(rel):
    """The reference module's surface: names, then ``Class.method``s of
    the classes the port's module defines as well."""
    ref = _module(REF / rel)
    names = {n for n in ref.defs if not n.startswith("_")} | set(ref.all)
    port_path = PORT / rel
    shared = set(ref.classes) & set(_module(port_path).classes) if port_path.exists() else set()
    methods = {f"{c}.{m}" for c in shared for m in ref.methods(c)}
    return names, methods


def _missing():
    """Every reference surface entry the port does not bind."""
    out = []
    for rel in _ref_modules():
        port_path = PORT / rel
        if not port_path.exists():
            out.append(rel)
            continue
        port = _module(port_path)
        names, methods = _required(rel)
        out += [f"{rel}::{n}" for n in sorted(names - port.bound)]
        for cm in sorted(methods):
            cls, meth = cm.split(".")
            if meth not in port.members(cls):
                out.append(f"{rel}::{cm}")
    return out


def test_port_binds_reference_surface():
    missing = [m for m in _missing() if m not in EXCLUDED]
    assert missing == [], f"the port lacks {len(missing)} public names: {missing}"


@pytest.mark.parametrize("entry", sorted(EXCLUDED))
def test_exclusion_is_live(entry):
    assert EXCLUDED[entry].strip(), f"{entry} names no reason"
    rel, _, name = entry.partition("::")
    assert (REF / rel).exists(), f"{entry}: the reference has no {rel}"
    if not name:
        assert not (PORT / rel).exists(), f"{entry}: the port now has {rel}"
        return
    ref, port = _module(REF / rel), _module(PORT / rel)
    if "." in name:
        cls, meth = name.split(".")
        assert cls in ref.classes and meth in ref.methods(cls), \
            f"{entry}: the reference no longer defines it"
        assert meth not in port.members(cls), f"{entry}: the port now defines it"
    else:
        assert name in ref.defs | set(ref.all), f"{entry}: the reference no longer defines it"
        assert name not in port.bound, f"{entry}: the port now defines it"


def test_scanner_reads_both_trees():
    """The scan is not vacuous: it sees a known surface on both sides."""
    assert "columnar/column.py" in _ref_modules()
    names, methods = _required("columnar/column.py")
    assert {"Column"} <= names
    assert {"Column.to_pylist", "Column.from_numpy", "Column.null_count"} <= methods
    port = _module(PORT / "columnar" / "column.py")
    assert {"to_pylist", "from_numpy", "null_count"} <= port.members("Column")
    assert "string_to_decimal" in _module(REF / "ops" / "cast_decimal.py").all
    assert len(_ref_modules()) > 90

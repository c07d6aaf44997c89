"""Port: models/tpcds against the JAX package. The same (rows, seed) gives
the same star-schema table bits in both packages (gen_store,
gen_store_wide, gen_web, 0 and 1 rows included), and every single-chip
query (q3, q7, q19, q42, q52, q55, q94, q95, q98) gives the JAX package's
result bits, at default and other parameters, including ones that select
nothing. q98's ratio is a float64 multiply and divide of bit-identical
inputs, so it is held bit for bit too. Each distributed variant (q7, q19,
q52, q55, q94, q95) on an 8-shard CPU mesh gives the port's single-chip
result bit for bit, and q95_distributed the JAX package's
q95_distributed."""

import numpy as np
import pytest
import torch

import spark_rapids_jni_tpu  # noqa: F401
from spark_rapids_jni_tpu.models import tpcds as jtpcds

from spark_rapids_jni_tpu_torch.models import tpcds as ptpcds
from test_torch_tpch import _assert_tables_equal

STORE_ROWS = 20_000
WEB_ROWS = 8_000
GENS = {"gen_store": STORE_ROWS, "gen_store_wide": STORE_ROWS, "gen_web": WEB_ROWS}

_TABLES = {}


def _tables(gen, seed, n=None):
    """(JAX tables, port tables on the CPU), cached per (gen, seed, n)."""
    n = GENS[gen] if n is None else n
    if (gen, seed, n) not in _TABLES:
        _TABLES[(gen, seed, n)] = (getattr(jtpcds, gen)(n, seed=seed),
                                   getattr(ptpcds, gen)(n, seed=seed, device="cpu"))
    return _TABLES[(gen, seed, n)]


# -- generators -------------------------------------------------------------------


@pytest.mark.parametrize("gen", sorted(GENS))
@pytest.mark.parametrize("n,seed", [(0, 1), (1, 2), (3001, 5), (8000, 42)])
def test_generator_bit_identical(gen, n, seed):
    jt, pt = _tables(gen, seed, n)
    assert sorted(pt) == sorted(jt)
    for name in jt:
        _assert_tables_equal(pt[name], jt[name])


# -- the queries --------------------------------------------------------------------


def _query(gen, name, seed, params):
    jt, pt = _tables(gen, seed)
    return getattr(ptpcds, name)(pt, **params), getattr(jtpcds, name)(jt, **params)


@pytest.mark.parametrize("seed,params", [
    (11, {}),
    (12, {}),
    (11, {"manufact_id": 116, "month": 6}),
])
def test_q3_bit_identical(seed, params):
    got, want = _query("gen_store", "q3", seed, params)
    _assert_tables_equal(got, want)


@pytest.mark.parametrize("name", ["q42", "q52", "q55"])
@pytest.mark.parametrize("seed,params", [
    (11, {}),
    (12, {}),
    (11, {"manager_id": 29, "month": 3, "year": 2001}),
    (11, {"year": 1990}),  # a year outside date_dim: nothing selected
])
def test_reporting_family_bit_identical(name, seed, params):
    got, want = _query("gen_store", name, seed, params)
    _assert_tables_equal(got, want)


@pytest.mark.parametrize("seed,params", [
    (11, {}),
    (12, {}),
    (12, {"gender": 0, "marital": 1, "education": 2, "year": 1999}),
])
def test_q7_bit_identical(seed, params):
    got, want = _query("gen_store_wide", "q7", seed, params)
    _assert_tables_equal(got, want)


@pytest.mark.parametrize("seed,params", [
    (11, {}),
    (12, {}),
    (11, {"manager_id": 0}),  # no item has manager 0: nothing selected
])
def test_q19_bit_identical(seed, params):
    got, want = _query("gen_store_wide", "q19", seed, params)
    _assert_tables_equal(got, want)


@pytest.mark.parametrize("seed,params", [
    (11, {}),
    (12, {}),
    (11, {"year": 1990}),  # nothing selected: the window runs over an empty table
])
def test_q98_bit_identical(seed, params):
    got, want = _query("gen_store", "q98", seed, params)
    _assert_tables_equal(got, want)


@pytest.mark.parametrize("name", ["q94", "q95"])
@pytest.mark.parametrize("seed,params", [
    (13, {}),
    (14, {}),
    (13, {"ship_lo": 2000, "ship_hi": 2100}),  # past every ship date: nothing selected
])
def test_q95_family_identical(name, seed, params):
    got, want = _query("gen_web", name, seed, params)
    assert got.keys() == want.keys()
    assert got["order_count"] == want["order_count"]
    for k in ("total_shipping_cost", "total_net_profit"):
        assert np.float64(got[k]).view(np.uint64) == np.float64(want[k]).view(np.uint64), k


def test_selective_cases_select_rows():
    """The parameter sets above other than the stated empty ones select
    rows (so the bit-identity is not over empty results only)."""
    def port(gen, name, seed, **params):
        return getattr(ptpcds, name)(_tables(gen, seed)[1], **params)

    assert port("gen_store", "q3", 11).num_rows > 0
    assert port("gen_store", "q3", 11, manufact_id=116, month=6).num_rows > 0
    assert port("gen_store", "q55", 11, manager_id=29, month=3, year=2001).num_rows > 0
    assert port("gen_store", "q42", 12).num_rows > 0
    assert port("gen_store_wide", "q7", 12, gender=0, marital=1, education=2,
                year=1999).num_rows > 0
    assert port("gen_store_wide", "q19", 12).num_rows > 0
    assert port("gen_store", "q98", 12).num_rows > 0
    assert port("gen_web", "q94", 14)["order_count"] > 0
    assert port("gen_web", "q95", 13)["order_count"] > 0


# -- the distributed variants -------------------------------------------------------

DISTRIBUTED = {  # query: (generator, seed, parameters), each selecting rows
    "q7": ("gen_store_wide", 11, {}),
    "q19": ("gen_store_wide", 12, {}),
    "q52": ("gen_store", 12, {}),
    "q55": ("gen_store", 11, {"manager_id": 29, "month": 3, "year": 2001}),
    "q94": ("gen_web", 14, {}),
    "q95": ("gen_web", 13, {}),
}


def _mesh8():
    from spark_rapids_jni_tpu_torch.parallel.mesh import make_mesh

    return make_mesh({"data": 8}, devices=[torch.device("cpu")] * 8)


def _assert_same_result(got, want):
    """Port against port, bit for bit: a table's names, types, data bits
    and null masks (the distributed group-by leaves out a validity the
    single-chip pipeline carries all true, in both packages), or a
    q94/q95 dict's count and float bits."""
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        assert got["order_count"] == want["order_count"]
        for k in ("total_shipping_cost", "total_net_profit"):
            assert np.float64(got[k]).view(np.uint64) == np.float64(want[k]).view(np.uint64), k
        return
    assert got.names == want.names and got.num_rows == want.num_rows
    for name, g, w in zip(want.names, got.columns, want.columns):
        assert g.dtype == w.dtype, name
        assert torch.equal(g.data, w.data), name
        assert torch.equal(g.valid_mask(), w.valid_mask()), name


@pytest.mark.parametrize("name", sorted(DISTRIBUTED))
def test_distributed_variant_matches_single_chip(name):
    gen, seed, params = DISTRIBUTED[name]
    pt = _tables(gen, seed)[1]
    want = getattr(ptpcds, name)(pt, **params)
    got = getattr(ptpcds, f"{name}_distributed")(pt, _mesh8(), **params)
    _assert_same_result(got, want)
    assert (want["order_count"] if isinstance(want, dict) else want.num_rows) > 0


@pytest.mark.slow  # ~25 s: the JAX side compiles its four shard_map programs
def test_q95_distributed_matches_reference():
    """The port's q95_distributed against the JAX package's on conftest's
    8 host devices, the same tables: count and float bits identical."""
    from spark_rapids_jni_tpu.parallel.mesh import make_mesh as jmake_mesh

    jt, pt = _tables("gen_web", 13)
    got = ptpcds.q95_distributed(pt, _mesh8())
    want = jtpcds.q95_distributed(jt, jmake_mesh({"data": 8}))
    _assert_same_result(got, want)


@pytest.mark.parametrize("gen", sorted(GENS))
def test_generators_default_to_the_card(gen, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        getattr(ptpcds, gen)(10)

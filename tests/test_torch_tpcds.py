"""Port: models/tpcds against the JAX package. The same (rows, seed) gives
the same star-schema table bits in both packages (gen_store,
gen_store_wide, gen_web, 0 and 1 rows included), and every single-chip
query over gen_store (q3, q42, q52, q55, q98) gives the JAX package's
result bits, at default and other parameters, including ones that select
nothing. q98's ratio is a float64 multiply and divide of bit-identical
inputs, so it is held bit for bit too. The queries over gen_store_wide
(q7, q19) and the distributed variants are in
``test_torch_tpcds_wide.py``, those over gen_web (q94, q95) in
``test_torch_tpcds_web.py``."""

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


_PORT_TABLES = {}


def _port_tables(gen, seed):
    """The port's tables on the CPU alone (no JAX generator), for the
    checks of the port against itself; the pair's if it is made."""
    if (gen, seed, GENS[gen]) in _TABLES:
        return _TABLES[(gen, seed, GENS[gen])][1]
    if (gen, seed) not in _PORT_TABLES:
        _PORT_TABLES[(gen, seed)] = getattr(ptpcds, gen)(GENS[gen], seed=seed, device="cpu")
    return _PORT_TABLES[(gen, seed)]


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
    (11, {"year": 1990}),  # nothing selected: the window runs over an empty table
])
def test_q98_bit_identical(seed, params):
    got, want = _query("gen_store", "q98", seed, params)
    _assert_tables_equal(got, want)


def test_selective_cases_select_rows():
    """The parameter sets above other than the stated empty ones select
    rows (so the bit-identity is not over empty results only)."""
    def port(gen, name, seed, **params):
        return getattr(ptpcds, name)(_port_tables(gen, seed), **params)

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


@pytest.mark.parametrize("gen", sorted(GENS))
def test_generators_default_to_the_card(gen, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        getattr(ptpcds, gen)(10)

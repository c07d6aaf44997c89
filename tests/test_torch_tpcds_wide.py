"""Port: models/tpcds's queries over gen_store_wide (q7, q19) against the
JAX package, bit for bit, at default and other parameters, including one
that selects nothing; and each distributed variant (q7, q19, q52, q55,
q94, q95) on an 8-shard CPU mesh against the port's single-chip result,
bit for bit. The tables are ``test_torch_tpcds.py``'s."""

import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu_torch.models import tpcds as ptpcds
from test_torch_tpcds import _port_tables, _query
from test_torch_tpch import _assert_tables_equal


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
    pt = _port_tables(gen, seed)
    want = getattr(ptpcds, name)(pt, **params)
    got = getattr(ptpcds, f"{name}_distributed")(pt, _mesh8(), **params)
    _assert_same_result(got, want)
    assert (want["order_count"] if isinstance(want, dict) else want.num_rows) > 0

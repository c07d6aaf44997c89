"""Port: TPC-H q6 on the operator tier and through the compiled pipeline
against the JAX package on the same generated lineitem (a few thousand
rows, and 50), bit for bit; the port's q6 against a rational oracle
(``fractions``); and q6 over no rows."""

from fractions import Fraction

import numpy as np
import pytest

from spark_rapids_jni_tpu.models import compiled as jcomp
from spark_rapids_jni_tpu.models import tpch as jtpch

from spark_rapids_jni_tpu_torch.models import compiled as pcomp
from spark_rapids_jni_tpu_torch.models import tpch as ptpch
from test_torch_tpch import _lineitem


@pytest.mark.parametrize("n,seed", [(3000, 5), (20_000, 6), (50, 1)])
def test_q6_bit_identical(n, seed):
    jl, pl = _lineitem(n, seed)
    got = ptpch.q6(pl)
    assert got == jtpch.q6(jl)
    assert pcomp.q6_fused(pl) == got == jcomp.q6_fused(jl)


def test_q6_against_a_rational_oracle():
    _, pl = _lineitem(20_000, 6)
    h = {n: c.to_numpy() for n, c in zip(pl.names, pl.columns)}
    f = {n: h[n].view(np.float64) for n in ("l_quantity", "l_extendedprice", "l_discount")}
    ship = h["l_shipdate"]
    m = ((ship >= 731) & (ship < 1096) & (f["l_discount"] >= 0.05) & (f["l_discount"] <= 0.07)
         & (f["l_quantity"] < 24.0))
    rev = f["l_extendedprice"][m] * f["l_discount"][m]
    assert ptpch.q6(pl) == float(sum(Fraction(float(v)) for v in rev))


def test_q6_with_no_matching_rows_is_zero():
    _, pl = _lineitem(50, 1)
    from spark_rapids_jni_tpu_torch.ops.copying import slice_table

    empty = slice_table(pl, 0, 0)
    assert ptpch.q6(empty) == 0.0

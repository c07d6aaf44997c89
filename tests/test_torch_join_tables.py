"""Port: the equi-join tier's joined tables (inner, left, full, semi and
anti on INT32 and STRING keys; against an empty side) against the JAX
package on the same seeded inputs, exactly. The JAX join runs its Pallas
probe in interpret mode (``SRJT_PALLAS_INTERPRET=1``, set through
``monkeypatch.setenv``). The slice as a whole is in
``test_torch_join_slice.py``."""

import numpy as np
import pytest

from spark_rapids_jni_tpu.ops import join as jjoin

from spark_rapids_jni_tpu_torch.ops import join as pjoin
from test_torch_join import _assert_tables_equal, _strings, _tables


# -- joined tables ------------------------------------------------------------------------


def _fact_dim(rng, key_type, nl=400, nr=120):
    """A fact side and a dimension side sharing the key column "k"."""
    if key_type == "STRING":
        lkv = rng.random(nl) < 0.9
        lkey = _strings(rng, nl, lkv, pool=80)
        rkey = _strings(rng, nr, None, pool=80)
        rkv = None
    else:
        pool = rng.integers(-500, 500, 80).astype(np.int32)
        lkey, rkey = pool[rng.integers(0, 80, nl)], pool[rng.integers(0, 80, nr)]
        lkv, rkv = rng.random(nl) < 0.9, rng.random(nr) < 0.95
    left = [("k", key_type, lkey, lkv),
            ("qty", "INT32", rng.integers(0, 100, nl).astype(np.int32), rng.random(nl) < 0.9),
            ("price", "FLOAT32", rng.standard_normal(nl).astype(np.float32), None),
            ("amt", "DECIMAL128", rng.integers(0, 2**32, (nl, 4), dtype=np.uint32), None)]
    rv = rng.random(nr) < 0.85
    right = [("brand", "INT32", rng.integers(0, 50, nr).astype(np.int32), None),
             ("k", key_type, rkey, rkv),
             ("name", "STRING", _strings(rng, nr, rv), rv),
             ("f", "FLOAT64", rng.standard_normal(nr).view(np.uint64), None)]
    return _tables(left, nl), _tables(right, nr)


@pytest.mark.parametrize("key_type", ["INT32", "STRING"])
@pytest.mark.parametrize("how", ["inner", "left", "full", "semi", "anti"])
def test_joined_tables(rng, key_type, how, monkeypatch):
    monkeypatch.setenv("SRJT_PALLAS_INTERPRET", "1")
    (jl, pl), (jr, pr) = _fact_dim(rng, key_type)
    fn = {"inner": "inner_join", "left": "left_join", "full": "full_join",
          "semi": "left_semi_join", "anti": "left_anti_join"}[how]
    _assert_tables_equal(getattr(pjoin, fn)(pl, pr, ["k"]), getattr(jjoin, fn)(jl, jr, ["k"]))


@pytest.mark.parametrize("how", ["inner_join", "left_join", "full_join"])
def test_joined_tables_against_an_empty_side(rng, how):
    (jl, pl), (jr, pr) = _fact_dim(rng, "INT32", nl=50, nr=20)
    empty = np.zeros(0, np.int32)
    je, pe = _tables([("k", "INT32", empty, None), ("x", "INT64", empty.astype(np.int64), None)], 0)
    _assert_tables_equal(getattr(pjoin, how)(pl, pe, ["k"]), getattr(jjoin, how)(jl, je, ["k"]))
    _assert_tables_equal(getattr(pjoin, how)(pe, pr, ["k"]), getattr(jjoin, how)(je, jr, ["k"]))

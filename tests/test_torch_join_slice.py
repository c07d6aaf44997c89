"""Port: the join slice as a whole (hash_partition -> inner_join ->
groupby_sum_bounded) against the JAX package on the same seeded inputs:
partitions, join and counts exact, the float32 sums held to rtol 2e-6 /
atol 1e-3 (the reference's bound for its group-by kernel,
tests/test_pallas_kernels.py), since the port adds in another order."""

import numpy as np
import pytest

from spark_rapids_jni_tpu.ops import aggregate as jagg
from spark_rapids_jni_tpu.ops import join as jjoin
from spark_rapids_jni_tpu.parallel import shuffle as jshuffle

from spark_rapids_jni_tpu_torch.ops import aggregate as pagg
from spark_rapids_jni_tpu_torch.ops import join as pjoin
from spark_rapids_jni_tpu_torch.parallel import shuffle as pshuffle
from test_torch_join import _assert_tables_equal, _strings, _tables

RTOL, ATOL = 2e-6, 1e-3


# -- the slice as a whole ------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_shuffle_join_aggregate_slice(seed):
    """hash_partition -> inner_join -> groupby_sum_bounded at ~20K fact
    rows x 2K build rows, the chip path's shape cut to size."""
    rng = np.random.default_rng(seed)
    nf, nd, brands = 20_000, 2_048, 256
    item = rng.integers(0, 4_096, nf).astype(np.int32)
    fv = rng.random(nf) < 0.9
    fact = [("item_sk", "INT32", item, fv),
            ("qty", "INT32", rng.integers(1, 100, nf).astype(np.int32), rng.random(nf) < 0.9),
            ("ext_sales_price", "FLOAT32", (rng.random(nf) * 100).astype(np.float32), None),
            ("store_sk", "INT64", rng.integers(0, 500, nf), None)]
    dv = rng.random(nd) < 0.9
    dim = [("item_sk", "INT32", rng.choice(4_096, nd, replace=False).astype(np.int32), None),
           ("brand_id", "INT32", rng.integers(0, brands, nd).astype(np.int32), None),
           ("brand", "STRING", _strings(rng, nd, dv), dv)]
    jf, pf = _tables(fact, nf)
    jd, pd = _tables(dim, nd)

    jpart, joffs = jshuffle.hash_partition(jf, 200, ["item_sk"])
    ppart, poffs = pshuffle.hash_partition(pf, 200, ["item_sk"])
    assert poffs == [int(x) for x in joffs]
    _assert_tables_equal(ppart, jpart)

    jj = jjoin.inner_join(jpart, jd, ["item_sk"])
    pjn = pjoin.inner_join(ppart, pd, ["item_sk"])
    _assert_tables_equal(pjn, jj)
    assert pjn.num_rows > 1000

    js, jc = jagg.groupby_sum_bounded(jj.column("brand_id").data,
                                      jj.column("ext_sales_price").data, brands)
    ps, pc = pagg.groupby_sum_bounded(pjn.column("brand_id").data,
                                      pjn.column("ext_sales_price").data, brands)
    np.testing.assert_array_equal(pc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(ps.numpy(), np.asarray(js), rtol=RTOL, atol=ATOL)

"""Port: each hand-written CUDA kernel against its plain PyTorch version on
the card. These tests need a CUDA device and skip without one (the
condition is evaluated when each test is set up, not at import). They
import neither jax nor the JAX package, so on a machine with a card they
run without the repository's conftest:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

B6/B7 and the row transcode are exact; B3 counts are exact and its
float32 sums are held to rtol 2e-6 / atol 1e-3, the reference's bound,
because the kernel's atomics add in an order that changes from run to
run."""

import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu_torch.columnar import Table
from spark_rapids_jni_tpu_torch.columnar import dtype as pdt
from spark_rapids_jni_tpu_torch.ops import aggregate
from spark_rapids_jni_tpu_torch.ops import hopper_kernels as hk
from spark_rapids_jni_tpu_torch.ops import ragged_bytes as rb
from spark_rapids_jni_tpu_torch.ops import row_conversion as rc

pytestmark = pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA device")

RTOL, ATOL = 2e-6, 1e-3


@pytest.fixture
def rng():
    return np.random.default_rng(12345)


def _cuda32(rng, shape):
    return torch.from_numpy(rng.integers(0, 2**32, shape, dtype=np.uint32).view(np.int32)).cuda()


@pytest.mark.parametrize("p,n", [(3, 16), (196, 40), (1, 8), (7, 515), (49, 600), (198, 100_003)])
def test_expand_u32_planes_kernel_matches_plain(rng, p, n):
    x = _cuda32(rng, (p, n))
    before = rb.expand_u32_planes.launches
    got = rb.expand_u32_planes(x)
    torch.cuda.synchronize()
    assert rb.expand_u32_planes.launches == before + 1
    assert torch.equal(got, rb.expand_u32_planes_plain(x))


@pytest.mark.parametrize("p,n", [(3, 16), (196, 40), (1, 8), (7, 515), (49, 600), (198, 100_003)])
def test_pack_u8_planes_kernel_matches_plain(rng, p, n):
    x8 = torch.from_numpy(rng.integers(0, 256, (4 * p, n), dtype=np.uint8)).cuda()
    before = rb.pack_u8_planes.launches
    got = rb.pack_u8_planes(x8)
    torch.cuda.synchronize()
    assert rb.pack_u8_planes.launches == before + 1
    assert torch.equal(got, rb.pack_u8_planes_plain(x8))


def test_plane_kernels_take_unaligned_views(rng):
    # contiguous views that start 4 bytes past an allocation's 16-byte
    # boundary: the kernels must take their scalar path there
    flat = _cuda32(rng, (5 * 1024 + 1,))
    x = flat[1:].view(5, 1024)
    assert x.data_ptr() % 16 != 0
    got = rb.expand_u32_planes(x)
    assert torch.equal(got, rb.expand_u32_planes_plain(x))
    flat8 = torch.from_numpy(rng.integers(0, 256, 20 * 1024 + 1, dtype=np.uint8)).cuda()
    y8 = flat8[1:].view(20, 1024)
    assert torch.equal(rb.pack_u8_planes(y8), rb.pack_u8_planes_plain(y8))


def test_plane_kernels_reject_wrong_types():
    with pytest.raises(ValueError):
        rb.expand_u32_planes(torch.zeros((2, 8), dtype=torch.int64, device="cuda"))
    with pytest.raises(ValueError):
        rb.pack_u8_planes(torch.zeros((6, 8), dtype=torch.uint8, device="cuda"))


@pytest.mark.parametrize("n,num_keys", [(5000, 4096), (300, 7), (40000, 130), (2048, 16384),
                                        (3000, 65536), (200_000, 8192), (200_000, 8193)])
def test_groupby_sum_outer_kernel_matches_plain(rng, n, num_keys):
    keys = torch.from_numpy(rng.integers(-5, num_keys + 5, n)).cuda()
    vals = torch.from_numpy((rng.standard_normal(n) * 100).astype(np.float32)).cuda()
    before = hk.groupby_sum_outer.launches
    gs, gc = hk.groupby_sum_outer(keys, vals, num_keys)
    torch.cuda.synchronize()
    assert hk.groupby_sum_outer.launches == before + 1
    ws, wc = hk.groupby_sum_outer_plain(keys, vals, num_keys)
    assert gs.dtype == torch.float32 and gc.dtype == torch.int64
    assert torch.equal(gc, wc)
    torch.testing.assert_close(gs, ws, rtol=RTOL, atol=ATOL)


def test_groupby_keys_past_2_32_drop_on_the_card():
    keys = torch.tensor([0, 1, 2**32, -3, 2**32 + 1, 2**40], dtype=torch.int64, device="cuda")
    vals = torch.tensor([1.0, 2.0, 100.0, 200.0, 300.0, 400.0], device="cuda")
    s, c = hk.groupby_sum_outer(keys, vals, 4)
    assert c.tolist() == [1, 1, 0, 0] and s.tolist() == [1.0, 2.0, 0.0, 0.0]


def test_groupby_empty_input_launches_nothing():
    before = hk.groupby_sum_outer.launches
    s, c = hk.groupby_sum_outer(torch.zeros(0, dtype=torch.int64, device="cuda"),
                                torch.zeros(0, device="cuda"), 16)
    assert hk.groupby_sum_outer.launches == before
    assert int(c.sum()) == 0 and float(s.abs().sum()) == 0.0


def test_slice_on_the_card_matches_the_cpu(rng):
    nine = [pdt.INT8, pdt.INT16, pdt.INT32, pdt.INT64, pdt.UINT8, pdt.UINT16, pdt.UINT32,
            pdt.UINT64, pdt.BOOL8]
    dtypes = [pdt.INT64, pdt.FLOAT32] + nine + [pdt.FLOAT64, pdt.decimal128(-2)]
    n = 3001
    arrays = [rng.integers(0, 512, n), rng.standard_normal(n).astype(np.float32)]
    for d in nine:
        info = np.iinfo(d.np_dtype)
        hi = 1 if d.id == pdt.TypeId.BOOL8 else info.max
        arrays.append(rng.integers(info.min, hi, n, dtype=d.np_dtype, endpoint=True))
    arrays += [rng.standard_normal(n), rng.integers(0, 2**32, (n, 4), dtype=np.uint32)]
    valids = [rng.random(n) < 0.8 if i % 3 == 2 else None for i in range(len(dtypes))]
    out = {}
    for dev in ("cpu", "cuda"):
        t = Table.from_numpy(arrays, dtypes, valids, device=dev)
        rows = rc.convert_to_rows(t)
        dec = rc.convert_from_rows(rows[0], dtypes)
        s, c = aggregate.groupby_sum_bounded(dec.columns[0].data, dec.columns[1].data, 512)
        out[dev] = (rows[0].child.data.cpu(), [x.to_numpy() for x in dec.columns],
                    [x.valid_mask().cpu() for x in dec.columns], s.cpu(), c.cpu())
    (b0, d0, v0, s0, c0), (b1, d1, v1, s1, c1) = out["cpu"], out["cuda"]
    assert torch.equal(b0, b1)
    for x, y in zip(d0, d1):
        np.testing.assert_array_equal(x.view(np.uint8), y.view(np.uint8))
    for x, y in zip(v0, v1):
        assert torch.equal(x, y)
    assert torch.equal(c0, c1)
    torch.testing.assert_close(s0, s1, rtol=RTOL, atol=ATOL)

"""Port: JCUDF row transcode with STRING columns against the JAX package
on the same seeded tables, in batches (a small batch ceiling in both
packages splits the rows as the 2 GiB one would) and through the grouped
decode (``convert_from_rows_grouped``, its groups and string columns,
and its table): row blobs, offsets and decoded columns bit-identical.
The port runs on CPU tensors, so B5 and B6-B10 run as their plain
versions."""

import numpy as np
import pytest

from spark_rapids_jni_tpu.ops import row_conversion as jrc

from spark_rapids_jni_tpu_torch.ops import row_conversion as prc
from test_torch_row_conversion_strings import MIXED, _assert_tables_equal, _make, _round


@pytest.mark.parametrize("ceiling,batches", [(5000, 3), (9000, 2)])
def test_batch_split_with_strings(rng, monkeypatch, ceiling, batches):
    # a small batch ceiling in both packages: the 2 GiB split runs at toy
    # size (rows of about 72 bytes, 200 of them)
    monkeypatch.setattr(jrc, "MAX_BATCH_BYTES", ceiling)
    monkeypatch.setattr(prc, "MAX_BATCH_BYTES", ceiling)
    jt, pt, jd, pd = _make(rng, ["INT64", "STRING", "INT32", "STRING"], 200, lo=0, hi=40)
    _, prows = _round(jt, pt, jd, pd)
    assert len(prows) == batches


def test_grouped_decode_string_column(rng):
    jt, pt, jd, pd = _make(rng, MIXED[:12], 150)
    jg = jrc.convert_from_rows_grouped(jrc.convert_to_rows(jt)[0], jd)
    pg = prc.convert_from_rows_grouped(prc.convert_to_rows(pt)[0], pd)
    assert list(pg.groups) == list(jg.groups)
    for key in jg.groups:
        np.testing.assert_array_equal(pg.groups[key].numpy().view(np.uint8),
                                      np.asarray(jg.groups[key]).view(np.uint8), err_msg=key)
    for i in (0, 10):
        a, b = jg.column(i), pg.column(i)
        np.testing.assert_array_equal(b.offsets.numpy(), np.asarray(a.offsets))
        np.testing.assert_array_equal(b.chars.numpy(), np.asarray(a.chars))
        np.testing.assert_array_equal(b.valid_mask().numpy(), np.asarray(a.valid_mask()))


def test_grouped_to_table_with_strings(rng):
    jt, pt, jd, pd = _make(rng, ["STRING", "INT32", "STRING"], 77, lo=0)
    jg = jrc.convert_from_rows_grouped(jrc.convert_to_rows(jt)[0], jd)
    pg = prc.convert_from_rows_grouped(prc.convert_to_rows(pt)[0], pd)
    _assert_tables_equal(jg.to_table(), pg.to_table())

"""Port: ops/strings' case maps (upper and lower over ASCII samples,
Unicode and malformed UTF-8) against the JAX package's on the CPU, bit
for bit, and two of the reference's behaviours the port keeps: the byte
path's uint8 wrap and the 1:1 mapping over the BMP."""

import pytest

from test_torch_string_ops import MALFORMED, SAMPLES, UNICODE, _both
from torch_string_parity import rows_of


@pytest.mark.parametrize("fn", ["upper", "lower"])
@pytest.mark.parametrize("corpus", ["samples", "unicode", "malformed"])
def test_case_maps_match_jax(fn, corpus):
    values = {"samples": SAMPLES, "unicode": UNICODE, "malformed": MALFORMED}[corpus]
    got = _both(fn, values)
    if corpus != "malformed":  # Python's 1:1 BMP mapping, as the reference builds it
        want = [None if s is None else "".join(
            m if len(m) == 1 else c for c, m in ((c, getattr(c, fn)()) for c in s))
            for s in values]
        assert [None if r is None else r.decode() for r in rows_of(got)] == want


def test_ascii_upper_wraps_in_uint8():
    # the byte path adds 224 (-32 mod 256) in uint8, as the reference does
    got = _both("upper", ["az{`AZ", "~"])
    assert rows_of(got) == [b"AZ{`AZ", b"~"]


def test_case_map_is_one_to_one_like_the_reference():
    # a fault of the reference against Spark (ROADMAP section 3): the case
    # maps are 1:1 over the BMP, so 'ß' stays 'ß' (Spark: 'SS') and a
    # final capital sigma lowers to 'σ' (Spark: 'ς')
    assert rows_of(_both("upper", ["straße"])) == ["STRAßE".encode()]
    assert rows_of(_both("lower", ["ΟΔΟΣ"])) == ["οδοσ".encode()]

"""Shared helpers of the string-tier parity tests (``test_torch_utf8``,
``test_torch_string_ops``, ``test_torch_regex``, ``test_torch_regex_spans``):
the same host values as a JAX column and a port column on the CPU, and
bit-for-bit comparisons of what the two packages return."""

import numpy as np
import torch

import spark_rapids_jni_tpu  # noqa: F401  (enables x64)
import jax.numpy as jnp
from spark_rapids_jni_tpu.columnar import Column as JColumn
from spark_rapids_jni_tpu.columnar import dtype as jdt

from spark_rapids_jni_tpu_torch.columnar import Column
from spark_rapids_jni_tpu_torch.columnar import dtype as pdt


def columns(values, validity=None):
    """(JAX column, port column) of ``values`` (str, bytes or None);
    ``validity`` overrides the null mask (the rows keep their bytes)."""
    jc = JColumn.from_pylist(values, jdt.STRING)
    pc = Column.from_pylist(values, pdt.STRING, device="cpu")
    if validity is not None:
        v = np.asarray(validity, bool)
        jc = JColumn(jdt.STRING, validity=jnp.asarray(v), offsets=jc.offsets, chars=jc.chars)
        pc = Column(pdt.STRING, validity=torch.from_numpy(v), offsets=pc.offsets, chars=pc.chars)
    return jc, pc


def same_array(got: torch.Tensor, want, what: str = "") -> None:
    w = np.asarray(want)
    g = got.cpu().numpy()
    assert g.shape == w.shape, (what, g.shape, w.shape)
    assert g.dtype.itemsize == w.dtype.itemsize, (what, g.dtype, w.dtype)
    np.testing.assert_array_equal(g, w, err_msg=what)


def _validity(got, want, what):
    if want.validity is None or got.validity is None:
        assert got.validity is None and want.validity is None, what
    else:
        same_array(got.validity, want.validity, what + " validity")


def same_column(got: Column, want: JColumn, what: str = "") -> None:
    """Type, validity, and data (fixed width) or offsets and chars
    (STRING) identical bit for bit."""
    assert int(got.dtype.id) == int(want.dtype.id), (what, got.dtype, want.dtype)
    _validity(got, want, what)
    if want.dtype.id == jdt.STRING.id:
        same_array(got.offsets, want.offsets, what + " offsets")
        same_array(got.chars, want.chars, what + " chars")
    else:
        same_array(got.data, want.data, what + " data")


def same_result(got, want, what: str = "") -> None:
    """A column, or a list of columns (split), identical to the JAX one."""
    if isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), (what, len(got), len(want))
        for t, (g, w) in enumerate(zip(got, want)):
            same_column(g, w, f"{what} token {t}")
    else:
        same_column(got, want, what)


def rows_of(col: Column):
    """Host bytes of each row, None for a null row."""
    offs = col.offsets.numpy()
    chars = col.chars.numpy().tobytes()
    valid = col.valid_mask().numpy()
    return [chars[offs[i]:offs[i + 1]] if valid[i] else None for i in range(len(col))]


# One corpus for every regex battery: the strings of ``test_regex.py``'s
# CORPUS and of its split, extract and replace cases, malformed UTF-8 and
# edge rows (empty, null), so that each JAX regex call runs once a pattern.
REGEX_CORPUS = [
    "hello world", "", "abc123def", "2024-01-31", "not a date", "aaa", "ab", "xyz  tail   ",
    "foo@bar.com", "line\nbreak", "ça için naïve Ünïcode", "ΑΒΓ αβγ", "123", "a1b2c3", "....",
    "a-b-c-d", None,
    "<a><b><c>", "x12 y34", "ça va", "naïve", "ascii only", "xa", "abc",
    "a,b,c", "a,b,", ",a", ",,", "a,,b", "a,b,,", "x", "a1b22c333d", "no digits",
    "a b  c   d", " lead", "trail ", "a-b_c-d", "日本語x語 12", "emoji 🎉 7",
    b"\x80\xff ab1", None, "",
]


def regex_columns():
    return columns(REGEX_CORPUS)


def corpus_text():
    """(row index, str) of the corpus rows that are valid UTF-8."""
    out = []
    for i, v in enumerate(REGEX_CORPUS):
        if isinstance(v, str):
            out.append((i, v))
    return out

"""Port: ops/regex's capture-group and replace runtimes (extract_re,
replace_re) against the JAX package's. Each case of ``test_regex.py``'s
EXTRACT_CASES (here) and REPLACE_CASES (``test_torch_regex_replace.py``,
on this module's corpus) runs ONCE through each package on one
shared corpus (every battery string, malformed UTF-8, empty and null
rows); offsets, chars and validity must be equal bit for bit, and the
valid-UTF-8 rows must agree with Python's ``re`` under ``re.ASCII``. The
anchors and the error cases are pinned as in ``test_regex.py``. Split is
in ``test_torch_regex.py``."""

import re

import pytest

import spark_rapids_jni_tpu  # noqa: F401  (enables x64)
from spark_rapids_jni_tpu.ops import regex as J

from spark_rapids_jni_tpu_torch.ops import regex as P

from test_regex import EXTRACT_CASES
from torch_string_parity import columns, corpus_text, regex_columns, rows_of, same_result

# the card path's extract pattern: groups 0, 1 and 2
CHIP_EXTRACT = [(r"([\w.]+)@(\w+)", g) for g in (0, 1, 2)]


@pytest.fixture(scope="module")
def corpus():
    return regex_columns()


@pytest.mark.parametrize("pattern,group", EXTRACT_CASES + CHIP_EXTRACT + [(r"<(.*)>", 1),
                                                                         (r"<(.*?)>", 1)])
def test_extract_re_matches_jax(corpus, pattern, group):
    jc, pc = corpus
    got = P.extract_re(pc, pattern, group)
    same_result(got, J.extract_re(jc, pattern, group), f"{pattern} group {group}")
    rows = rows_of(got)
    for i, s in corpus_text():
        m = re.search(pattern, s, re.ASCII)
        assert rows[i].decode() == (m.group(group) if m else ""), (pattern, group, s)


def test_zero_rows_and_all_null_match_jax():
    for values in ([], [None, None]):
        jc, pc = columns(values)
        same_result(P.extract_re(pc, r"(\d+)", 1), J.extract_re(jc, r"(\d+)", 1), "extract")
        same_result(P.replace_re(pc, r"\d", b"#"), J.replace_re(jc, r"\d", b"#"), "replace")


@pytest.mark.parametrize("call", [
    lambda m, c: m.extract_re(c, r"((a)b)", 2),  # nested group
    lambda m, c: m.extract_re(c, r"(ab)+", 1),  # quantified group
    lambda m, c: m.extract_re(c, r"(a)", 2),  # group out of range
    lambda m, c: m.extract_re(c, r"(a)", -1),
    lambda m, c: m.extract_re(c, r"x(a|(b))", 0),  # a group inside a member
    lambda m, c: m.replace_re(c, r"x*", b"-"),  # matches the empty string
    lambda m, c: m.split_re(c, r"(?=a)"),
])
def test_errors_raise_like_jax(call):
    jc, pc = columns(["ab", "abab"])
    with pytest.raises((ValueError, IndexError)) as want:
        call(J, jc)
    with pytest.raises((ValueError, IndexError)) as got:
        call(P, pc)
    assert type(got.value) is type(want.value) and str(got.value) == str(want.value)

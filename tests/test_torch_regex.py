"""Port: ops/regex's matchers and host compiler against the JAX
package's. Each pattern of ``test_regex.py``'s CONTAINS_PATTERNS and
MATCH_PATTERNS runs ONCE through each package on one shared corpus (every
battery string, malformed UTF-8, empty and null rows); the BOOL8 data and
validity must be equal bit for bit, and the valid-UTF-8 rows must agree
with Python's ``re`` under ``re.ASCII`` (the reference's \\d \\w \\s are
ASCII). The compiled DFA tables (``trans``, ``accept``, ``class_of``) of
every pattern of every battery must equal the JAX package's, and the
unsupported constructs must raise as they do there. split_re runs each
SPLIT_CASES pattern at limits -1, 0, 2 and 3 the same way: every token
column bit for bit, and Java's String.split on the valid rows (a
zero-width match at 0 skipped, trailing empties dropped at limit 0).
Capture groups and replace are in ``test_torch_regex_spans.py``."""

import re

import pytest
import torch

import spark_rapids_jni_tpu  # noqa: F401  (enables x64)
from spark_rapids_jni_tpu.columnar import Column as JColumn
from spark_rapids_jni_tpu.columnar import dtype as jdt
from spark_rapids_jni_tpu.ops import regex as J

from spark_rapids_jni_tpu_torch.columnar import Column
from spark_rapids_jni_tpu_torch.columnar import dtype as pdt
from spark_rapids_jni_tpu_torch.ops import regex as P

from test_regex import CONTAINS_PATTERNS, EXTRACT_CASES, MATCH_PATTERNS, REPLACE_CASES, SPLIT_CASES
from torch_string_parity import (columns, corpus_text, regex_columns, rows_of, same_array, same_column,
                                 same_result)

# the card path's patterns (chip_smoke.py's string_ops path)
CHIP_PATTERNS = [r"\d{2,}", r"[\w.]+@\w+\.(?:com|org|net|edu)", r"([\w.]+)@(\w+)", ",", r"\d+"]


@pytest.fixture(scope="module")
def corpus():
    return regex_columns()


@pytest.mark.parametrize("pattern", CONTAINS_PATTERNS)
def test_contains_re_matches_jax(corpus, pattern):
    jc, pc = corpus
    got = P.contains_re(pc, pattern)
    same_column(got, J.contains_re(jc, pattern), pattern)
    data = got.data.tolist()
    for i, s in corpus_text():
        assert bool(data[i]) == bool(re.search(pattern, s, re.ASCII)), (pattern, s)


@pytest.mark.parametrize("pattern", MATCH_PATTERNS + [CHIP_PATTERNS[1]])
def test_matches_re_matches_jax(corpus, pattern):
    jc, pc = corpus
    got = P.matches_re(pc, pattern)
    same_column(got, J.matches_re(jc, pattern), pattern)
    data = got.data.tolist()
    for i, s in corpus_text():
        assert bool(data[i]) == bool(re.fullmatch(pattern, s, re.ASCII)), (pattern, s)


def test_contains_re_on_the_card_path_pattern_matches_jax(corpus):
    jc, pc = corpus
    same_column(P.contains_re(pc, CHIP_PATTERNS[0]), J.contains_re(jc, CHIP_PATTERNS[0]), "chip")


def _battery():
    pats = set(CONTAINS_PATTERNS) | set(MATCH_PATTERNS) | set(CHIP_PATTERNS)
    pats |= {p for p, _ in EXTRACT_CASES} | {p for _, p, _ in SPLIT_CASES}
    pats |= {p for p, _ in REPLACE_CASES} | {r"<(.*)>", r"<(.*?)>", r"^a", "x*", r"^.{2}$", r"[çï]"}
    return sorted(pats)


@pytest.mark.parametrize("pattern", _battery())
def test_compiled_tables_equal_jax(pattern):
    for pc, jc in ((P.compile_pattern(pattern), J.compile_pattern(pattern)),
                   (P._search_pattern(pattern), J._search_pattern(pattern))):
        same_array(torch.from_numpy(pc.trans), jc.trans, "trans")
        assert (pc.accept == jc.accept).all() and pc.accept.dtype == jc.accept.dtype
        assert (pc.class_of == jc.class_of).all() and pc.class_of.dtype == jc.class_of.dtype
        assert (pc.anchor_start, pc.anchor_end, pc.ngroups, pc.ast) == (
            jc.anchor_start, jc.anchor_end, jc.ngroups, jc.ast)


def test_compiled_patterns_and_device_tables_are_cached():
    prog = P.compile_pattern(r"\d+x")
    assert P.compile_pattern(r"\d+x") is prog
    tables = prog.device_tables("cpu")
    assert prog.device_tables("cpu") is tables
    assert tables[2].shape == (0x110000,)


UNSUPPORTED = [r"(?=x)a", r"\1", r"\bword", r"a{1000}", r"(?i)a", r"*a", r"[a", r"a{2,1}", r"(a",
               r"a$b", r"b^a", r"^a|b", "\\", r"a{x}", r"[b-a]", r")"]


@pytest.mark.parametrize("pattern", UNSUPPORTED)
def test_unsupported_constructs_raise_like_jax(pattern):
    with pytest.raises((ValueError, IndexError)) as want:
        J.compile_pattern(pattern)
    with pytest.raises((ValueError, IndexError)) as got:
        P.compile_pattern(pattern)
    assert type(got.value) is type(want.value) and str(got.value) == str(want.value)


def test_zero_rows_and_all_null_match_jax():
    for values in ([], [None, None]):
        jc, pc = columns(values)
        same_column(P.contains_re(pc, r"a\d"), J.contains_re(jc, r"a\d"), f"{values} contains")
        same_column(P.matches_re(pc, "a*"), J.matches_re(jc, "a*"), f"{values} matches")


def test_non_string_column_raises_like_jax():
    jcol = JColumn.from_pylist([1], jdt.INT32)
    pcol = Column.from_pylist([1], pdt.INT32, device="cpu")
    for fn in ("contains_re", "matches_re"):
        with pytest.raises(ValueError) as want:
            getattr(J, fn)(jcol, "a")
        with pytest.raises(ValueError) as got:
            getattr(P, fn)(pcol, "a")
        assert str(got.value) == str(want.value)


def _java_split(s: str, pattern: str, limit: int):
    """Java String.split for separators that cannot match the empty string."""
    toks = re.split(pattern, s, maxsplit=limit - 1 if limit > 0 else 0, flags=re.ASCII)
    if limit == 0 and s:
        while toks and toks[-1] == "":
            toks.pop()
    return toks


def _tokens(cols, i):
    return [r[i].decode() for r in map(rows_of, cols) if r[i] is not None]


SPLITS = sorted({(p, lim) for _, p, _ in SPLIT_CASES for lim in (-1, 0, 2, 3)})


@pytest.mark.parametrize("pattern,limit", SPLITS)
def test_split_re_matches_jax(corpus, pattern, limit):
    jc, pc = corpus
    got = P.split_re(pc, pattern, limit)
    same_result(got, J.split_re(jc, pattern, limit), f"{pattern} limit {limit}")
    for i, s in corpus_text():
        assert _tokens(got, i) == _java_split(s, pattern, limit), (pattern, limit, s)


@pytest.mark.parametrize("pattern,limit", [("x*", -1), (r"^a", -1), ("", 0), (r"\d*", 2)])
def test_split_zero_width_and_anchors_match_jax(corpus, pattern, limit):
    jc, pc = corpus
    same_result(P.split_re(pc, pattern, limit), J.split_re(jc, pattern, limit), pattern)


def test_split_java_corner_cases():
    _, pc = columns(["a,b,,", "x", "", "abc", "xa"])
    toks = P.split_re(pc, ",", 0)
    assert [_tokens(toks, i) for i in range(3)] == [["a", "b"], ["x"], [""]]
    toks = P.split_re(pc, "x*", -1)
    assert _tokens(toks, 3)[0] == "a"  # no empty leading token (Java 8)
    assert _tokens(P.split_re(pc, r"^a"), 4) == ["xa"]  # '^' only at the start


def test_split_zero_rows_and_all_null_match_jax():
    for values in ([], [None, None]):
        jc, pc = columns(values)
        same_result(P.split_re(pc, ",", -1), J.split_re(jc, ",", -1), "split")

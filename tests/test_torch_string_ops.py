"""Port: ops/strings against the JAX package's. The batteries of
``test_strings.py`` and ``test_utf8.py`` (byte and Unicode case maps,
SUBSTRING windows, concat / concat_ws null policies, literal searches,
trim, instr) and the edge inputs (no rows, every row null, every row
empty, malformed UTF-8) run through both packages on the CPU, where
``to_padded`` and ``from_padded`` run the plain versions of B8 and B5;
INT32 / BOOL8 data, validity, offsets and chars must be equal bit for
bit. The error cases raise where the JAX package raises."""

import numpy as np
import pytest
import torch

import spark_rapids_jni_tpu  # noqa: F401  (enables x64)
from spark_rapids_jni_tpu.columnar import Column as JColumn
from spark_rapids_jni_tpu.columnar import dtype as jdt
from spark_rapids_jni_tpu.ops import strings as J

from spark_rapids_jni_tpu_torch.columnar import Column
from spark_rapids_jni_tpu_torch.columnar import dtype as pdt
from spark_rapids_jni_tpu_torch.ops import hopper_kernels as hk
from spark_rapids_jni_tpu_torch.ops import ragged_bytes as rb
from spark_rapids_jni_tpu_torch.ops import strings as P

from torch_string_parity import columns, rows_of, same_array, same_column

SAMPLES = ["hello", "", "World", "MiXeD Case 123", "  padded  ", "a", "xyzzy plugh", None, "Zz"]
UNICODE = ["plain ascii", "", "ça için naïve", "ΑΒΓ αβγδ", "Привет мир", "日本語テキスト",
           "emoji 🎉 supplementary", "mixed: aΩя中🎈z", "Ⱥ and ⱥ", "ı stanbul", "İ", "ß straße", None]
MALFORMED = [b"\x80abc", b"x\xe6\x97y", b"\xf8\xff", b"AbC\xc3", b"ok"]
EDGES = {"no rows": [], "all null": [None, None, None], "all empty": ["", "", ""]}


def _both(fn_name, values, *args, validity=None):
    jc, pc = columns(values, validity)
    got = getattr(P, fn_name)(pc, *args)
    want = getattr(J, fn_name)(jc, *args)
    same_column(got, want, fn_name)
    return got


def test_length_matches_jax():
    _both("length", SAMPLES)
    _both("length", UNICODE)


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


@pytest.mark.parametrize(
    "start,slen",
    [(1, 3), (2, None), (0, 2), (-3, 2), (-100, None), (5, 100), (100, 5), (-10, 3), (-6, 3)],
)
def test_substring_matches_jax(start, slen):
    _both("substring", SAMPLES, start, slen)


def test_substring_counts_bytes_like_the_reference():
    # a fault of the reference against Spark (ROADMAP section 3): SUBSTRING
    # and length count bytes, so a multi-byte character is cut in half and
    # length('ça') is 3, where Spark gives 'ç' and 2
    assert rows_of(_both("substring", ["ça va"], 1, 1)) == [b"\xc3"]
    assert _both("length", ["ça"]).data.tolist() == [3]


def test_case_map_is_one_to_one_like_the_reference():
    # a fault of the reference against Spark (ROADMAP section 3): the case
    # maps are 1:1 over the BMP, so 'ß' stays 'ß' (Spark: 'SS') and a
    # final capital sigma lowers to 'σ' (Spark: 'ς')
    assert rows_of(_both("upper", ["straße"])) == ["STRAßE".encode()]
    assert rows_of(_both("lower", ["ΟΔΟΣ"])) == ["οδοσ".encode()]


def test_concat_with_separator_matches_jax():
    ja, pa = columns(["x", "hello", "", None])
    jb, pb = columns(["y", "world", "z", "q"])
    got = P.concat([pa, pb], b"--")
    same_column(got, J.concat([ja, jb], b"--"), "concat")
    assert rows_of(got) == [b"x--y", b"hello--world", b"--z", None]


def test_concat_no_separator_matches_jax():
    ja, pa = columns(["ab", ""])
    jb, pb = columns(["cd", "ef"])
    same_column(P.concat([pa, pb]), J.concat([ja, jb]), "concat")


@pytest.mark.parametrize("policy", ["propagate", "skip"])
@pytest.mark.parametrize("sep", [b"-", b"", "→".encode()])
def test_concat_null_policies_match_jax(policy, sep):
    ja, pa = columns(["x", None, "", None, "ça"])
    jb, pb = columns(["y", "mid", None, None, "日本"])
    jc, pc = columns(["z", "end", "tail", None, ""])
    same_column(P.concat([pa, pb, pc], sep, policy), J.concat([ja, jb, jc], sep, policy), policy)
    if policy == "skip":
        same_column(P.concat_ws([pa, pb, pc], sep), J.concat_ws([ja, jb, jc], sep), "concat_ws")


def test_concat_runs_one_padding_call_for_all_columns(monkeypatch):
    calls = []
    real = rb.extract_strings_many

    def record(*args):
        calls.append(len(args[0]))
        return real(*args)

    monkeypatch.setattr(rb, "extract_strings_many", record)
    _, pa = columns(["a", "bb"])
    _, pb = columns(["", ""])  # no characters: padded without a gather
    _, pc = columns(["ccc", None])
    P.concat([pa, pb, pc], b",")
    assert calls == [2]


@pytest.mark.parametrize("pat", [b"l", b"Case", b"", b"zz", b"notthere", b"xyzzy plugh!"])
def test_contains_matches_jax(pat):
    _both("contains", SAMPLES, pat)


@pytest.mark.parametrize("pat", [b"he", b"", b"World", b"  ", b"Zz"])
def test_startswith_endswith_match_jax(pat):
    _both("startswith", SAMPLES, pat)
    _both("endswith", SAMPLES, pat)


@pytest.mark.parametrize("values", [["  hi  ", "nospace", "   ", "", " x", "y ", None],
                                    [" ça ", "\tx ", "  日本  "]])
def test_strip_matches_jax(values):
    got = _both("strip", values)
    assert rows_of(got) == [None if v is None else v.strip(" ").encode() for v in values]


@pytest.mark.parametrize("pat", ["X", "o", "", "語", "a", "ça"])
def test_instr_matches_jax(pat):
    got = _both("instr", ["hello world", "", None, "aXbXc", "ça", "日本語x語", "ça ça"],
                pat.encode())
    want = [s.find(pat) + 1 if s is not None else None
            for s in ["hello world", "", None, "aXbXc", "ça", "日本語x語", "ça ça"]]
    assert [w if w is None else g for g, w in zip(got.data.tolist(), want)] == want


CALLS = {
    "length": (), "upper": (), "lower": (), "substring": (2, 3), "strip": (),
    "contains": (b"a",), "startswith": (b"a",), "endswith": (b"a",), "instr": (b"a",),
}


@pytest.mark.parametrize("fn", sorted(CALLS))
@pytest.mark.parametrize("edge", sorted(EDGES))
def test_edge_inputs_match_jax(fn, edge):
    _both(fn, EDGES[edge], *CALLS[fn])


def test_to_padded_matches_jax():
    from spark_rapids_jni_tpu.ops.strings import to_padded as jto

    for values in (SAMPLES, UNICODE, ["", "", ""], [], ["abcde", None, "x" * 9]):
        jc, pc = columns(values)
        got, glens = P.to_padded(pc)
        want, wlens = jto(jc)
        same_array(got, want, "padded")
        same_array(glens, wlens, "lengths")


def test_from_padded_matches_jax(rng):
    from spark_rapids_jni_tpu.ops.strings import from_padded as jfrom

    import jax.numpy as jnp

    mat = rng.integers(1, 256, (9, 7), dtype=np.uint8)
    lens = np.array([0, 7, 3, 1, 0, 5, 7, 2, 6], np.int32)
    valid = np.array([1, 1, 0, 1, 1, 1, 0, 1, 1], bool)
    got = P.from_padded(torch.from_numpy(mat), torch.from_numpy(lens), torch.from_numpy(valid))
    same_column(got, jfrom(jnp.asarray(mat), jnp.asarray(lens), jnp.asarray(valid)), "from_padded")
    zero = P.from_padded(torch.from_numpy(mat), torch.zeros(9, dtype=torch.int32))
    same_column(zero, jfrom(jnp.asarray(mat), jnp.zeros(9, jnp.int32)), "from_padded empty")


def test_from_padded_runs_b5_through_ragged_compact_many(monkeypatch):
    seen = []
    real = hk.ragged_compact_many

    def record(pool, columns_, row_starts=None):
        seen.append(len(columns_))
        return real(pool, columns_, row_starts=row_starts)

    monkeypatch.setattr(hk, "ragged_compact_many", record)
    _, pc = columns(["ab", "", "cde"])
    P.upper(pc)
    P.from_padded(torch.zeros((2, 4), dtype=torch.uint8), torch.zeros(2, dtype=torch.int32))
    assert seen == [1]  # the all-empty result compacts nothing


@pytest.mark.parametrize("fn,args", [("length", ()), ("upper", ()), ("substring", (1, 2)),
                                     ("contains", (b"a",)), ("strip", ()), ("instr", (b"a",))])
def test_non_string_column_raises_like_jax(fn, args):
    jcol = JColumn.from_pylist([1, 2], jdt.INT32)
    pcol = Column.from_pylist([1, 2], pdt.INT32, device="cpu")
    with pytest.raises(ValueError) as want:
        getattr(J, fn)(jcol, *args)
    with pytest.raises(ValueError) as got:
        getattr(P, fn)(pcol, *args)
    assert str(got.value) == str(want.value)


def test_concat_argument_errors_match_jax():
    jc, pc = columns(["a"])
    for args in (([jc], b"", "bogus"), ([],)):
        with pytest.raises(ValueError) as want:
            J.concat(*args)
        pargs = ([pc] if args[0] else [],) + args[1:]
        with pytest.raises(ValueError) as got:
            P.concat(*pargs)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("seed", [7, 2026])
def test_chip_smoke_oracles_agree_with_the_port(monkeypatch, seed):
    # the per-row oracles chip_smoke.py holds the card's string_ops path to,
    # on a small table of its columns, against the port on the CPU
    import chip_smoke

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    h, t = chip_smoke._string_ops_inputs(seed, 1500, device="cpu")
    (out, _), seen8, seen5, _, predicted = chip_smoke._capture_string_ops(
        lambda: chip_smoke._spark_exact_path(chip_smoke._string_ops(t)))
    assert predicted == {"extract_strings_many": len(seen8), "ragged_compact_many": len(seen5)}
    summary = chip_smoke._check_string_ops(h, out)
    # the multilingual column reaches every class of the reference's
    # differences from Spark (ROADMAP section 3)
    for k in ("length_multi_spark_differs", "substring_multi_spark_differs",
              "upper_multi_spark_differs", "lower_multi_spark_differs"):
        assert summary[k] > 0, k

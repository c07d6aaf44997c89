"""Port: the equi-join tier's gather maps (inner, left, full, semi and
anti; one and two keys; empty sides, an all-null build and a build over
the paged table's capacity) against the JAX package on the same seeded
inputs, exactly, through the JAX package's Pallas tier (in interpret
mode, ``SRJT_PALLAS_INTERPRET=1``) and through its sort-probe
formulation (``SRJT_PALLAS_JOIN=0``). Both knobs are set through
``monkeypatch.setenv`` and read live by the JAX package."""

import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu.ops import join as jjoin

from spark_rapids_jni_tpu_torch.columnar import Table
from spark_rapids_jni_tpu_torch.ops import join as pjoin
from test_torch_join import _assert_maps_equal, _key_tables, _strings, _tables


# -- gather maps ------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["INT32", "INT64", "UINT16"])
@pytest.mark.parametrize("how", ["inner", "left"])
def test_join_maps_match_the_pallas_tier(rng, name, how, monkeypatch):
    monkeypatch.setenv("SRJT_PALLAS_INTERPRET", "1")
    jl, pl, jr, pr = _key_tables(rng, name, 600, 300, lnull=0.2, rnull=0.2)
    _assert_maps_equal(pjoin.join_gather_maps(pl, pr, how), jjoin.join_gather_maps(jl, jr, how))


@pytest.mark.parametrize("name", ["INT8", "INT64", "UINT64"])
@pytest.mark.parametrize("how", ["inner", "left", "full"])
@pytest.mark.parametrize("nulls", [0.0, 0.4])
def test_join_maps_match_the_sort_probe(rng, name, how, nulls, monkeypatch):
    monkeypatch.setenv("SRJT_PALLAS_JOIN", "0")
    jl, pl, jr, pr = _key_tables(rng, name, 500, 400, lnull=nulls, rnull=nulls)
    _assert_maps_equal(pjoin.join_gather_maps(pl, pr, how), jjoin.join_gather_maps(jl, jr, how))


def test_inner_and_left_take_the_paged_table(rng, monkeypatch):
    calls = []
    real = pjoin.probe_paged
    monkeypatch.setattr(pjoin, "probe_paged", lambda *a: calls.append(1) or real(*a))
    _, pl, _, pr = _key_tables(rng, "INT32", 50, 30)
    for how in ("inner", "left", "full"):
        pjoin.join_gather_maps(pl, pr, how)
    assert len(calls) == 2  # not the full join
    _, sl, _, sr = _key_tables(rng, "INT64", 50, 30)
    pjoin.join_gather_maps(pl, sr, "inner")  # mismatched key types
    pjoin.join_gather_maps(Table(pl.columns * 2, ["a", "b"]), Table(pr.columns * 2, ["a", "b"]))
    assert len(calls) == 2


@pytest.mark.parametrize("how", ["inner", "left", "full"])
@pytest.mark.parametrize("case", ["empty_left", "empty_right", "both_empty", "all_null_build",
                                  "over_cap"])
def test_join_maps_edge_cases(rng, how, case, monkeypatch):
    monkeypatch.setenv("SRJT_PALLAS_INTERPRET", "1")
    nl, nr = {"empty_left": (0, 50), "empty_right": (60, 0), "both_empty": (0, 0),
              "all_null_build": (70, 40), "over_cap": (300, 65537)}[case]
    lk = rng.integers(0, 100, nl).astype(np.int64)
    rk = rng.integers(0, 100, nr).astype(np.int64)
    rv = np.zeros(nr, bool) if case == "all_null_build" else None
    jl, pl = _tables([("k", "INT64", lk, None)], nl)
    jr, pr = _tables([("k", "INT64", rk, rv)], nr)
    _assert_maps_equal(pjoin.join_gather_maps(pl, pr, how), jjoin.join_gather_maps(jl, jr, how))


@pytest.mark.parametrize("how", ["inner", "left", "full"])
def test_join_maps_multi_key(rng, how):
    n = 400
    specs = lambda k0, k1, v: [("a", "INT32", k0, v), ("s", "STRING", k1, None)]  # noqa: E731
    a0 = rng.integers(0, 6, n).astype(np.int32)
    b0 = rng.integers(0, 6, n).astype(np.int32)
    s = _strings(rng, 2 * n, None, pool=5)
    sl = (s[0][: n + 1], s[1][: s[0][n]])
    sr = ((s[0][n:] - s[0][n]).astype(np.int32), s[1][s[0][n]:])
    jl, pl = _tables(specs(a0, sl, rng.random(n) < 0.9), n)
    jr, pr = _tables(specs(b0, sr, None), n)
    _assert_maps_equal(pjoin.join_gather_maps(pl, pr, how), jjoin.join_gather_maps(jl, jr, how))


def test_long_string_keys_follow_the_reference():
    # a fault of the reference, recorded and kept for parity: the key
    # factorization compares STRING keys by length and 16-byte prefix
    # only, so two keys that differ past byte 16 match
    strs = [b"abcdefghijklmnopX", b"abcdefghijklmnopY"]
    offs = np.array([0, 17], np.int32)
    jl, pl = _tables([("k", "STRING", (offs, np.frombuffer(strs[0], np.uint8).copy()), None)], 1)
    jr, pr = _tables([("k", "STRING", (offs, np.frombuffer(strs[1], np.uint8).copy()), None)], 1)
    want = jjoin.join_gather_maps(jl, jr, "inner")
    _assert_maps_equal(pjoin.join_gather_maps(pl, pr, "inner"), want)
    assert np.asarray(want[0]).tolist() == [0]


@pytest.mark.parametrize("how", ["semi", "anti"])
@pytest.mark.parametrize("name", ["INT32", "STRING"])
def test_semi_anti_gather_map(rng, how, name):
    if name == "STRING":
        lv = rng.random(300) < 0.8
        jl, pl = _tables([("k", "STRING", _strings(rng, 300, lv, pool=30), lv)], 300)
        jr, pr = _tables([("k", "STRING", _strings(rng, 100, None, pool=30), None)], 100)
    else:
        jl, pl, jr, pr = _key_tables(rng, name, 300, 100, lnull=0.2, rnull=0.2, pool=60)
    got = pjoin.semi_anti_gather_map(pl, pr, how)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jjoin.semi_anti_gather_map(jl, jr, how)))

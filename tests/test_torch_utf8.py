"""Port: ops/utf8 against the JAX package's. The codec runs on the texts
of ``test_utf8.py``, on malformed UTF-8 (continuation bytes without a
lead, truncated sequences, bytes 0xF8-0xFF, surrogate encodings) and on
the edge shapes (no rows, no columns, widths that are not a multiple of
4); codepoints, counts, byte offsets, bytes and lengths must be equal
bit for bit, and so must the Unicode case tables of both packages."""

import numpy as np
import pytest
import torch

import spark_rapids_jni_tpu  # noqa: F401  (enables x64)
import jax.numpy as jnp
from spark_rapids_jni_tpu.ops import utf8 as J

from spark_rapids_jni_tpu_torch.ops import utf8 as P

from torch_string_parity import same_array

TEXTS = [
    "plain ascii",
    "",
    "ça için naïve",
    "ΑΒΓ αβγδ",
    "Привет мир",
    "日本語テキスト",
    "emoji 🎉 supplementary",
    "mixed: aΩя中🎈z",
    "Ⱥⱥ length-changing pair",
]

MALFORMED = [
    b"\x80abc",  # continuation byte with no lead
    b"ab\xbf\xbf",  # trailing stray continuations
    b"\xe6\x97",  # truncated 3-byte sequence at the end
    b"x\xe6\x97y",  # truncated 3-byte sequence mid-string
    b"a\xf0\x9f",  # truncated 4-byte sequence
    b"\xf8\xff\xfe\xfa",  # bytes 0xF8-0xFF
    b"\xc3",  # lone 2-byte lead
    b"\xed\xa0\x80z",  # an encoded surrogate
    b"\xf4\x90\x80\x80",  # above U+10FFFF
    b"\xc0\x80",  # overlong NUL
]


def _pad(rows, extra: int = 0):
    bs = [r.encode() if isinstance(r, str) else r for r in rows]
    L = max(max((len(b) for b in bs), default=1), 1) + extra
    mat = np.zeros((len(bs), L), np.uint8)
    for i, b in enumerate(bs):
        mat[i, : len(b)] = np.frombuffer(b, np.uint8)
    return mat, np.asarray([len(b) for b in bs], np.int32)


def _decode_both(mat, lens):
    got = P.decode_padded(torch.from_numpy(mat), torch.from_numpy(lens))
    want = J.decode_padded(jnp.asarray(mat), jnp.asarray(lens))
    for g, w, what in zip(got, want, ("cp", "cp_lens", "byte_off")):
        same_array(g, w, what)
    return got


CORPORA = {"texts": TEXTS, "malformed": MALFORMED, "mixed": TEXTS[:4] + MALFORMED[:5]}


@pytest.mark.parametrize("extra", [0, 3])
@pytest.mark.parametrize("corpus", sorted(CORPORA))
def test_decode_matches_jax(corpus, extra):
    mat, lens = _pad(CORPORA[corpus], extra)
    _decode_both(mat, lens)


@pytest.mark.parametrize("corpus", sorted(CORPORA))
def test_encode_of_decode_matches_jax(corpus):
    mat, lens = _pad(CORPORA[corpus])
    cp, cp_lens, _ = _decode_both(mat, lens)
    got = P.encode_padded(cp, cp_lens)
    want = J.encode_padded(jnp.asarray(cp.numpy()), jnp.asarray(cp_lens.numpy()))
    same_array(got[0], want[0], "bytes")
    same_array(got[1], want[1], "lengths")
    if corpus == "texts":  # valid UTF-8 round-trips to its own bytes
        for i, t in enumerate(TEXTS):
            b = t.encode()
            assert got[0][i, : len(b)].numpy().tobytes() == b and int(got[1][i]) == len(b)


def test_decode_agrees_with_python():
    mat, lens = _pad(TEXTS)
    cp, cp_lens, byte_off = P.decode_padded(torch.from_numpy(mat), torch.from_numpy(lens))
    for i, t in enumerate(TEXTS):
        n = int(cp_lens[i])
        assert n == len(t) and cp[i, :n].tolist() == [ord(c) for c in t]
        assert byte_off[i, : n + 1].tolist() == [len(t[:k].encode()) for k in range(n + 1)]


def test_encode_random_codepoints_matches_jax(rng):
    # every encoded length, surrogates and the top of the range included
    cp = rng.choice(np.array([0, 0x41, 0x7F, 0x80, 0x7FF, 0x800, 0xD800, 0xFFFF, 0x10000,
                              0x10FFFF, 0x1F600, 0x4E2D], np.int32), size=(7, 5))
    cp_lens = np.array([0, 1, 2, 3, 4, 5, 5], np.int32)
    got = P.encode_padded(torch.from_numpy(cp), torch.from_numpy(cp_lens))
    want = J.encode_padded(jnp.asarray(cp), jnp.asarray(cp_lens))
    same_array(got[0], want[0], "bytes")
    same_array(got[1], want[1], "lengths")


@pytest.mark.parametrize("n,L", [(0, 5), (3, 0), (0, 0)])
def test_decode_edge_shapes_match_jax(n, L):
    mat = np.zeros((n, L), np.uint8)
    _decode_both(mat, np.zeros((n,), np.int32))


@pytest.mark.parametrize("n,lc", [(0, 3), (4, 2)])
def test_encode_edge_shapes_match_jax(n, lc):
    cp = np.full((n, lc), 0x41, np.int32)
    cp_lens = np.zeros((n,), np.int32)  # no codepoint in any row
    got = P.encode_padded(torch.from_numpy(cp), torch.from_numpy(cp_lens))
    want = J.encode_padded(jnp.asarray(cp), jnp.asarray(cp_lens))
    same_array(got[0], want[0], "bytes")
    same_array(got[1], want[1], "lengths")


@pytest.mark.parametrize("upper", [True, False])
def test_case_table_matches_jax(upper):
    tab = P.case_table(upper, device="cpu")
    same_array(tab, J.case_table(upper), "case table")
    assert P.case_table(upper, device="cpu") is tab  # built once per process and device


def test_case_table_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P.case_table(True)


def test_utf8_nbytes_matches_jax():
    cp = np.array([0, 0x7F, 0x80, 0x7FF, 0x800, 0xFFFF, 0x10000, 0x10FFFF], np.int32)
    same_array(P.utf8_nbytes(torch.from_numpy(cp)), J.utf8_nbytes(jnp.asarray(cp)), "nbytes")

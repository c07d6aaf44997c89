"""Port: ops/limbs against the JAX package's. Every function runs on the
same [N, 4] and [N, 8] limbs (0, 1, 2^32 - 1, 10^38, 2^127, 2^128 - 1,
2^256 - 1, powers of ten and their neighbours, and seeded values of every
bit length) through both packages; the outputs must be equal exactly
(limbs, carries, flags and counts are integers: tolerance 0). The
arithmetic is also held against Python's integers."""

import numpy as np
import pytest
import torch

import spark_rapids_jni_tpu  # noqa: F401  (enables x64)
import jax.numpy as jnp
from spark_rapids_jni_tpu.ops import limbs as JL

from spark_rapids_jni_tpu_torch.ops import limbs as PL


def _values(K: int, seed: int = 11) -> list:
    top = 2 ** (32 * K) - 1
    base = [0, 1, 2, 9, 10, 99, 2**32 - 1, 2**32, 2**63, 2**64 - 1, 10**18, 10**19 - 1,
            10**38 - 1, 10**38, 10**38 + 1, 2**127 - 1, 2**127, 2**128 - 1]
    if K == 8:
        base += [2**128, 10**76 - 1, 10**76, 2**255, 2**256 - 2, 2**256 - 1]
    rng = np.random.default_rng(seed + K)
    rand = [int(rng.integers(0, 2**62)) << int(rng.integers(0, 32 * K - 61)) for _ in range(14)]
    return [v & top for v in base + rand]


def _pair(K: int):
    a = _values(K)
    b = a[7:] + a[:7]
    return a, b


def _j(vals, K):
    return jnp.asarray(JL.from_ints(vals, K))


def _p(vals, K):
    return torch.from_numpy(PL.from_ints(vals, K))


def _same(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.astype(np.int64), want.astype(np.int64))


KS = [4, 8]


@pytest.mark.parametrize("K", KS)
def test_from_ints_matches(K):
    a = _values(K)
    np.testing.assert_array_equal(PL.from_ints(a, K), JL.from_ints(a, K).astype(np.int64))
    assert PL.to_ints(_p(a, K)) == JL.to_ints(JL.from_ints(a, K)) == a


@pytest.mark.parametrize("K", KS)
@pytest.mark.parametrize("op", ["add", "sub"])
def test_add_sub(K, op):
    a, b = _pair(K)
    jo, jc = getattr(JL, op)(_j(a, K), _j(b, K))
    po, pc = getattr(PL, op)(_p(a, K), _p(b, K))
    _same(po, jo)
    _same(pc, jc)
    m = 2 ** (32 * K)
    want = [(x + y) % m if op == "add" else (x - y) % m for x, y in zip(a, b)]
    assert PL.to_ints(po) == want


@pytest.mark.parametrize("K", KS)
def test_add_small_and_mul10_add(K):
    a = _values(K)
    x = np.array([(i * 7919) % 2**32 for i in range(len(a))], dtype=np.int64)
    x[:3] = [0, 2**32 - 1, 1]
    jo, jc = JL.add_small(_j(a, K), jnp.asarray(x.astype(np.uint32)))
    po, pc = PL.add_small(_p(a, K), torch.from_numpy(x))
    _same(po, jo)
    _same(pc, jc)
    d = x % 10
    _same(PL.mul10_add(_p(a, K), torch.from_numpy(d)), JL.mul10_add(_j(a, K), jnp.asarray(d)))


@pytest.mark.parametrize("K", KS)
def test_negate_and_twos_complement(K):
    a = _values(K)
    _same(PL.negate(_p(a, K)), JL.negate(_j(a, K)))
    neg = np.arange(len(a)) % 3 == 1
    _same(PL.to_twos_complement(_p(a, K), torch.from_numpy(neg)),
          JL.to_twos_complement(_j(a, K), jnp.asarray(neg)))
    pm, pn = PL.from_twos_complement(_p(a, K))
    jm, jn = JL.from_twos_complement(_j(a, K))
    _same(pm, jm)
    _same(pn, jn)


@pytest.mark.parametrize("K", KS)
def test_mul_small(K):
    a = _values(K)
    m = np.array([0, 1, 10, 2**32 - 1, 2**31, 65535, 65536] * 10, dtype=np.int64)[:len(a)]
    jo, jc = JL.mul_small(_j(a, K), jnp.asarray(m.astype(np.uint64)))
    po, pc = PL.mul_small(_p(a, K), torch.from_numpy(m))
    _same(po, jo)
    _same(pc, jc)
    for v, mm, o, c in zip(a, m, PL.to_ints(po), pc.tolist()):
        assert o + (c << (32 * K)) == v * int(mm)


@pytest.mark.parametrize("K,out", [(4, 4), (4, 8), (8, 8)])
def test_mul(K, out):
    a, b = _pair(K)
    got = PL.mul(_p(a, K), _p(b, K), out)
    _same(got, JL.mul(_j(a, K), _j(b, K), out))
    assert PL.to_ints(got) == [(x * y) % 2 ** (32 * out) for x, y in zip(a, b)]


@pytest.mark.parametrize("K", KS)
@pytest.mark.parametrize("op", ["gt", "ge", "eq"])
def test_compares(K, op):
    a, b = _pair(K)
    b[:4] = a[:4]  # equal rows
    _same(getattr(PL, op)(_p(a, K), _p(b, K)), getattr(JL, op)(_j(a, K), _j(b, K)))


@pytest.mark.parametrize("K", KS)
@pytest.mark.parametrize("op", ["is_zero", "count_digits", "precision10", "is_all_nines"])
def test_digit_predicates(K, op):
    a = _values(K) + [10**k + d for k in range(0, 39) for d in (-1, 0, 1)]
    if K == 8:
        a += [10**k + d for k in range(39, 77) for d in (-1, 0)]
    a = [max(v, 0) for v in a]
    _same(getattr(PL, op)(_p(a, K)), getattr(JL, op)(_j(a, K)))


@pytest.mark.parametrize("K", KS)
def test_pow10(K):
    k = np.array([-3, 0, 1, 17, 38, 39, 76, 90], dtype=np.int64)
    _same(PL.pow10(torch.from_numpy(k), K), JL.pow10(jnp.asarray(k.astype(np.int32)), K))


@pytest.mark.parametrize("K", KS)
def test_shift_left(K):
    a = _values(K)
    n = np.array([(i * 37) % (32 * K) for i in range(len(a))], dtype=np.int64)
    n[:4] = [0, 31, 32, 32 * K - 1]
    _same(PL.shift_left_bits(_p(a, K), torch.from_numpy(n)),
          JL.shift_left_bits(_j(a, K), jnp.asarray(n.astype(np.int32))))
    _same(PL.shift_left_one(_p(a, K)), JL.shift_left_one(_j(a, K)))


def _divisors(K: int, n: int) -> list:
    top = 2 ** (32 * K) - 1
    d = [1, 0, 10, 10**9, 10**18, 10**19, 10**38, 2**32 - 1, 2**127, 2**128 - 1, 7, 3]
    if K == 8:
        d += [10**76, 2**255 + 1, top]
    vals = _values(K, seed=29)
    d += [v >> (5 * i % (32 * K)) or 1 for i, v in enumerate(vals)]
    return [v & top for v in (d * 3)[:n]]


@pytest.mark.parametrize("K", KS)
def test_divmod_bits(K):
    a = _values(K)
    d = _divisors(K, len(a))
    pq, pr = PL.divmod_bits(_p(a, K), _p(d, K))
    jq, jr = JL.divmod_bits(_j(a, K), _j(d, K))
    _same(pq, jq)
    _same(pr, jr)
    for x, y, q, r in zip(a, d, PL.to_ints(pq), PL.to_ints(pr)):
        if y == 0:
            assert (q, r) == (0, x)
        elif y < 2 ** (32 * K - 1):  # below the top bit the shift never drops one
            assert (q, r) == divmod(x, y)


def test_divmod_bits_by_a_broadcast_power_of_ten():
    a = _values(8)
    got = PL.divmod_bits(_p(a, 8), PL.pow10(torch.tensor(19), 8))
    assert PL.to_ints(got[0]) == [v // 10**19 for v in a]
    assert PL.to_ints(got[1]) == [v % 10**19 for v in a]

"""NTT correctness: roundtrip, linearity, and negacyclic convolution vs an
exact big-int numpy oracle (mirrors the reference's reliance on PALISADE's
NTT — SURVEY.md C11 — but tested explicitly)."""

import numpy as np
import jax.numpy as jnp
import pytest

from fhe_fed_tpu.rns import primes
from fhe_fed_tpu.ntt import tables, ntt as ntt_mod

fwd = ntt_mod.ntt_jit
inv = ntt_mod.intt_jit


def _negacyclic_mul_oracle(a, b, q):
    """Exact poly mult mod (x^n + 1, q) with Python ints."""
    n = len(a)
    out = [0] * n
    for i in range(n):
        ai = int(a[i])
        if ai == 0:
            continue
        for j in range(n):
            k = i + j
            v = ai * int(b[j])
            if k < n:
                out[k] = (out[k] + v) % q
            else:
                out[k - n] = (out[k - n] - v) % q
    return np.array(out, dtype=np.uint32)


@pytest.mark.parametrize("n", [64, 256, 1024, 8192])
def test_ntt_roundtrip(n):
    qs = primes.ntt_primes(n, 3)
    tb = tables.make_tables(n, qs)
    rng = np.random.default_rng(n)
    x = np.stack([rng.integers(0, q, size=n, dtype=np.uint64).astype(np.uint32)
                  for q in qs])
    got = np.asarray(inv(fwd(jnp.asarray(x), tb), tb))
    np.testing.assert_array_equal(got, x)


@pytest.mark.parametrize("n", [64, 256])
def test_ntt_negacyclic_convolution(n):
    qs = primes.ntt_primes(n, 2)
    tb = tables.make_tables(n, qs)
    rng = np.random.default_rng(7)
    a = np.stack([rng.integers(0, q, size=n, dtype=np.uint64).astype(np.uint32)
                  for q in qs])
    b = np.stack([rng.integers(0, q, size=n, dtype=np.uint64).astype(np.uint32)
                  for q in qs])
    fa = fwd(jnp.asarray(a), tb)
    fb = fwd(jnp.asarray(b), tb)
    # Pointwise product via Barrett.
    from fhe_fed_tpu.rns import modops
    mu = jnp.asarray(np.array([modops.barrett_precompute(q) for q in qs],
                              dtype=np.uint32)).reshape(-1, 1)
    prod = modops.mul_mod(fa, fb, tb.q.reshape(-1, 1), mu)
    got = np.asarray(inv(prod, tb))
    for l, q in enumerate(qs):
        want = _negacyclic_mul_oracle(a[l], b[l], q)
        np.testing.assert_array_equal(got[l], want)


def test_ntt_batched_shapes():
    n = 256
    qs = primes.ntt_primes(n, 2)
    tb = tables.make_tables(n, qs)
    rng = np.random.default_rng(9)
    x = np.stack([
        np.stack([rng.integers(0, q, size=n, dtype=np.uint64).astype(np.uint32)
                  for q in qs])
        for _ in range(6)]).reshape(3, 2, 2, n)
    got = np.asarray(inv(fwd(jnp.asarray(x), tb), tb))
    np.testing.assert_array_equal(got, x)


def test_ntt_known_linear_property():
    # NTT(a + b) == NTT(a) + NTT(b) pointwise mod q.
    n = 1024
    qs = primes.ntt_primes(n, 2)
    tb = tables.make_tables(n, qs)
    rng = np.random.default_rng(11)
    a = np.stack([rng.integers(0, q, size=n, dtype=np.uint64).astype(np.uint32)
                  for q in qs])
    b = np.stack([rng.integers(0, q, size=n, dtype=np.uint64).astype(np.uint32)
                  for q in qs])
    from fhe_fed_tpu.rns import modops
    qb = tb.q.reshape(-1, 1)
    lhs = fwd(modops.add_mod(jnp.asarray(a), jnp.asarray(b), qb), tb)
    rhs = modops.add_mod(fwd(jnp.asarray(a), tb),
                         fwd(jnp.asarray(b), tb), qb)
    np.testing.assert_array_equal(np.asarray(lhs), np.asarray(rhs))


def _pow_table(base: int, q: int, n: int) -> np.ndarray:
    """base**k mod q for k in [0, n) as uint64 (exact: base, q < 2**31)."""
    pw = np.ones(1, dtype=np.uint64)
    b = np.uint64(base % q)
    while pw.size < n:
        pw = np.concatenate([pw, (pw * b) % np.uint64(q)])
        b = (b * b) % np.uint64(q)
    return pw[:n]


def _brv(i: int, bits: int) -> int:
    return int(bin(i)[2:].zfill(bits)[::-1], 2)


@pytest.mark.parametrize("direction", ["forward", "inverse"])
def test_production_ring_matches_oracle_and_four_step(direction):
    """ntt()/intt() at (N=8192, L=4), the production ring, against the
    exact evaluation map (sampled points, integer arithmetic) and, in
    full, against the four-step digit-plane transform (ntt/mxu.py):
    forward out[i] = sum_k c_k psi^((2 brv(i) + 1) k), inverse its
    N^-1-scaled transpose."""
    from fhe_fed_tpu.ntt import mxu
    n, L = 8192, 4
    bits = n.bit_length() - 1
    qs = primes.ntt_primes(n, L)
    tb = tables.make_tables(n, qs)
    mt = mxu.make_mxu_tables(n, tuple(qs))
    rng = np.random.default_rng(21)
    x = np.stack([rng.integers(0, q, size=n, dtype=np.uint64).astype(np.uint32)
                  for q in qs])[None]
    if direction == "forward":
        got = np.asarray(fwd(jnp.asarray(x), tb))
        other = np.asarray(mxu.ntt_mxu(jnp.asarray(x), mt))
    else:
        got = np.asarray(inv(jnp.asarray(x), tb))
        other = np.asarray(mxu.intt_mxu(jnp.asarray(x), mt))
    np.testing.assert_array_equal(got, other)
    brv = np.array([_brv(i, bits) for i in range(n)], dtype=np.uint64)
    for l, q in enumerate(qs):
        psi = primes.primitive_root_2n(q, n)
        qq = np.uint64(q)
        c = x[0, l].astype(np.uint64)
        for i in rng.integers(0, n, size=16):
            if direction == "forward":
                e = pow(psi, 2 * _brv(int(i), bits) + 1, q)
                want = int(np.sum((c * _pow_table(e, q, n)) % qq)) % q
            else:
                # coefficient i = N^-1 sum_k y_k psi^(-(2 brv(k) + 1) i)
                ipsi = _pow_table(pow(psi, q - 2, q), q, 2 * n)
                idx = ((2 * brv + 1) * np.uint64(i)) % np.uint64(2 * n)
                s = int(np.sum((c * ipsi[idx.astype(np.int64)]) % qq)) % q
                want = s * pow(n, q - 2, q) % q
            assert int(got[0, l, i]) == want, (direction, l, int(i))

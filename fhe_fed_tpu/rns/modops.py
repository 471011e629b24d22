"""uint32 modular arithmetic primitives.

All wide arithmetic is built from 32x32 -> (hi, lo) products assembled out
of 16-bit half-words, in uint32 lanes only (no 64-bit integer types).
Primes are constrained to (2**30, 2**31) which keeps every intermediate in
range and leaves one slack bit for lazy add/sub.

Three multiplication flavors:
  * mul_mod         — generic Barrett (variable x variable), used on the
                      ct x ct path only.
  * mul_mod_shoup   — constant multiplication with a precomputed Shoup
                      companion word; used for NTT twiddles, public keys,
                      secret keys, and plaintext scalars (the hot 99%).
  * wide multiply helpers — building blocks, exposed for tests.

This module replaces the 64-bit native modular arithmetic PALISADE uses on
CPU (reference: fhe-fed's L0 layer, SURVEY.md C10).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

U32 = jnp.uint32
# numpy scalar (not a jnp array) so functions using it stay capture-free
# inside Pallas kernels.
_MASK16 = np.uint32(0xFFFF)


def to_u32(x) -> jnp.ndarray:
    return jnp.asarray(x, dtype=U32)


def add_mod(a, b, q):
    """(a + b) mod q for a, b < q < 2**31. Sum < 2**32: no overflow."""
    s = a + b
    return jnp.where(s >= q, s - q, s)


def sub_mod(a, b, q):
    """(a - b) mod q for a, b < q."""
    d = a - b
    return jnp.where(a >= b, d, d + q)


def neg_mod(a, q):
    return jnp.where(a == 0, a, q - a)


def mul_wide(a, b):
    """Full 32x32 -> 64 product of uint32 arrays as (hi, lo) uint32 pair."""
    a = a.astype(U32)
    b = b.astype(U32)
    a_lo = a & _MASK16
    a_hi = a >> 16
    b_lo = b & _MASK16
    b_hi = b >> 16
    ll = a_lo * b_lo                       # < 2**32, exact
    lh = a_lo * b_hi                       # < 2**32, exact
    hl = a_hi * b_lo                       # < 2**32, exact
    hh = a_hi * b_hi                       # < 2**32, exact
    # mid = lh + hl can overflow 32 bits by one carry bit.
    mid = lh + hl
    mid_carry = (mid < lh).astype(U32)     # 1 if wrapped
    lo = ll + (mid << 16)
    lo_carry = (lo < ll).astype(U32)
    hi = hh + (mid >> 16) + (mid_carry << 16) + lo_carry
    return hi, lo


def mul_hi(a, b):
    """High 32 bits of the 64-bit product."""
    return mul_wide(a, b)[0]


def shoup_precompute(w, q):
    """Host-side: w_shoup = floor(w * 2**32 / q) for constant w < q.

    Accepts Python ints / numpy arrays; returns numpy uint32.
    """
    w = np.asarray(w, dtype=np.uint64)
    q = np.asarray(q, dtype=np.uint64)
    return ((w << np.uint64(32)) // q).astype(np.uint32)


def mul_mod_shoup(x, w, w_shoup, q):
    """x * w mod q where w is a constant with Shoup companion word.

    q' = hi(x * w_shoup);  r = x*w - q'*q  (both as low-32 products, exact
    mod 2**32);  r in [0, 2q) -> one conditional subtraction.
    """
    qhat = mul_hi(x, w_shoup)
    r = x * w - qhat * q                   # low 32 bits; result < 2q fits
    return jnp.where(r >= q, r - q, r)


def barrett_precompute(q: int) -> int:
    """Host-side Barrett constant for q in (2**30, 2**31):
    mu = floor(2**62 / q) < 2**32."""
    assert 2 ** 30 < q < 2 ** 31
    return int((1 << 62) // q)


def mul_mod(x, y, q, mu):
    """Generic (x * y) mod q via Barrett with mu = floor(2**62/q).

    x, y < q < 2**31 so t = x*y < 2**62.
    Estimate k ~= t / q as hi64( (t >> 30) * mu ) >> 2? We use:
      a  = t >> 30            (fits 32 bits)
      k  = hi32(a * mu)       ~ floor(t / 2**30 * mu / 2**32) = t/q * (1-eps)
      r  = t - k*q            in [0, 3q) -> two conditional subtractions.
    """
    hi, lo = mul_wide(x, y)
    a = (hi << 2) | (lo >> 30)             # t >> 30, fits in u32 (t < 2**62)
    k = mul_hi(a, mu)
    # floor(t/q) - 3 <= k <= floor(t/q)  =>  r = t - k*q in [0, 4q) < 2**33.
    kq_hi, kq_lo = mul_wide(k, q)
    borrow = (lo < kq_lo).astype(U32)
    r_lo = lo - kq_lo
    r_hi = hi - kq_hi - borrow             # in {0, 1}
    # If r_hi == 1 the true r = r_lo + 2**32 lies in [2**32, 4q); subtracting
    # 2q (< 2**32) lands it in [2**32 - 2q, 2q) which fits u32, and the
    # wrapped computation r_lo - 2q is exact mod 2**32.
    r = jnp.where(r_hi > 0, r_lo - (q << 1), r_lo)
    r = jnp.where(r >= q, r - q, r)
    r = jnp.where(r >= q, r - q, r)
    r = jnp.where(r >= q, r - q, r)
    return r


def mul_div(x, y, q, mu):
    """Exact floor(x * y / q) for x, y < q < 2**31, on device.

    Runs mul_mod's Barrett estimate but returns the exact QUOTIENT instead
    of the remainder, tracking every correction: the 2q subtraction of the
    r_hi branch adds 2 to the quotient, each conditional q subtraction
    adds 1. Building block for shoup_device."""
    hi, lo = mul_wide(x, y)
    a = (hi << 2) | (lo >> 30)
    k = mul_hi(a, mu)
    kq_hi, kq_lo = mul_wide(k, q)
    borrow = (lo < kq_lo).astype(U32)
    r = lo - kq_lo
    r_hi = hi - kq_hi - borrow
    k = jnp.where(r_hi > 0, k + 2, k)
    r = jnp.where(r_hi > 0, r - (q << 1), r)
    for _ in range(3):
        ge = r >= q
        k = jnp.where(ge, k + 1, k)
        r = jnp.where(ge, r - q, r)
    return k


def shoup_device(w, q, mu, k32, pow32):
    """Device-side Shoup companion: floor(w * 2**32 / q) for w < q.

    Decompose 2**32 = k32*q + pow32 (k32 = floor(2**32/q) in {2, 3} for
    31-bit q, pow32 = 2**32 mod q — both already in CkksContext-style
    constants), so

        floor(w * 2**32 / q) = w*k32 + floor(w*pow32 / q)

    computed mod 2**32 (the true value fits u32 since w < q). Removes the
    host round-trip of shoup_precompute from jitted key ceremonies
    (threshold CKKS multiparty keygen / joint relin)."""
    return (w * k32 + mul_div(w, pow32, q, mu)).astype(U32)


def pow_mod_host(base: int, exp: int, q: int) -> int:
    return pow(base, exp, q)


def inv_mod_host(a: int, q: int) -> int:
    return pow(a, q - 2, q)

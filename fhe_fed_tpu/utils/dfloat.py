"""Double-float (two-float) arithmetic in f32 pairs.

The device path uses no f64; a (hi, lo) pair of f32 with |lo| <= ulp(hi)/2 gives
~48 bits of effective mantissa. Used for the exact-CRT decode tail and the
canonical-embedding FFT (slot packing), where single f32 precision would cap
CKKS message precision at ~24 bits.

Branch-free Knuth/Dekker algorithms; no FMA required.
"""

from __future__ import annotations

import numpy as np

# numpy scalar, NOT a jnp array: a module-level device constant would
# initialize the XLA backend at import time, which breaks
# jax.distributed.initialize() in multi-process runs (it must run before
# any backend contact) — and would capture a device buffer into Pallas
# kernels.
_SPLITTER = np.float32(4097.0)  # 2**12 + 1 for f32 Veltkamp split


def two_sum(a, b):
    """Exact sum: a + b = s + e with s = fl(a+b)."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def fast_two_sum(a, b):
    """Exact sum assuming |a| >= |b|."""
    s = a + b
    e = b - (s - a)
    return s, e


def _split(a):
    c = _SPLITTER * a
    hi = c - (c - a)
    lo = a - hi
    return hi, lo


def two_prod(a, b):
    """Exact product: a * b = p + e (Dekker, no FMA)."""
    p = a * b
    a_hi, a_lo = _split(a)
    b_hi, b_lo = _split(b)
    e = ((a_hi * b_hi - p) + a_hi * b_lo + a_lo * b_hi) + a_lo * b_lo
    return p, e


def df_add(x_hi, x_lo, y_hi, y_lo):
    s, e = two_sum(x_hi, y_hi)
    e = e + (x_lo + y_lo)
    return fast_two_sum(s, e)


def df_add_f32(x_hi, x_lo, y):
    s, e = two_sum(x_hi, y)
    e = e + x_lo
    return fast_two_sum(s, e)


def df_mul(x_hi, x_lo, y_hi, y_lo):
    p, e = two_prod(x_hi, y_hi)
    e = e + (x_hi * y_lo + x_lo * y_hi)
    return fast_two_sum(p, e)


def df_mul_f32(x_hi, x_lo, y):
    p, e = two_prod(x_hi, y)
    e = e + x_lo * y
    return fast_two_sum(p, e)


def df_neg(x_hi, x_lo):
    return -x_hi, -x_lo


def df_from_f64(v) -> tuple[float, float]:
    """Host-side: split a python/numpy float64 into an f32 (hi, lo) pair."""
    import numpy as np
    hi = np.float32(v)
    lo = np.float32(np.float64(v) - np.float64(hi))
    return float(hi), float(lo)

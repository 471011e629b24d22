"""CKKS plaintext encoding — exact integer paths.

Coefficient packing (the FedAvg workhorse): values go straight into
polynomial coefficients. Addition and scalar multiplication — the only
homomorphic ops the reference's secure-FedAvg uses (ckks.cpp:286-298) — act
coefficient-wise, so no canonical-embedding FFT is needed and encode/decode
are *exact* at any scale up to 2**80:

  encode:  round(m * 2**scale_bits) is exact in f32 (power-of-two scaling of
           a 24-bit mantissa), split into 16-bit digits by exact f32 float
           ops, then reduced mod each q_l with Shoup multiplications.

  decode:  exact CRT reconstruction. y_l = x_l * (Q/q_l)^{-1} mod q_l, then
           v = sum_l y_l * (Q/q_l) - k*Q accumulated in 16-bit digit planes
           (uint32 accumulators never overflow), k recovered from a float
           estimate of sum(y_l / q_l) — provably exact because |v| << Q.
           The centered value is divided by the scale in two-float
           arithmetic (~48-bit precision).

Slot packing (canonical embedding) for ct x ct workloads lives in
slots.py.

No float64 anywhere: every step is u32/i32/f32 arithmetic.
Reference parity: MakeCKKSPackedPlaintext / GetRealPackedValue
(ckks.cpp:80,198-204), with better precision than f64-based decode at
scale 2**52.
"""

from __future__ import annotations

import math

import numpy as np
import jax.numpy as jnp

from ..rns import modops
from ..utils import dfloat
from .params import CkksContext, DecodeConsts, ENCODE_DIGITS, DIGIT_BITS

_U32 = jnp.uint32
_I32 = jnp.int32
_F32 = jnp.float32


def encode_coeff(ctx: CkksContext, values: jnp.ndarray,
                 scale: float, num_limbs: int | None = None) -> jnp.ndarray:
    """Encode f32 values (..., N) -> residues (..., L, N), coefficient order.

    `scale` must be a power of two (message encode path); scalars with
    arbitrary scales are encoded host-side via encode_scalar().
    """
    sb = math.log2(scale)
    assert sb == int(sb), "vector encode requires a power-of-two scale"
    x = values.astype(_F32) * _F32(scale)
    t = jnp.round(x)
    sign = t < 0
    a = jnp.abs(t)
    # Exact 16-bit digit split, high to low. Every subtraction is exact in
    # f32 because any suffix of a 24-bit-mantissa integer is representable.
    digs = []
    r = a
    for j in reversed(range(ENCODE_DIGITS)):
        p = _F32(2.0 ** (DIGIT_BITS * j))
        d = jnp.floor(r / p)
        r = r - d * p
        digs.append((j, d))
    L = num_limbs if num_limbs is not None else ctx.params.chain_len
    qb = ctx.q[:L, None]
    acc = jnp.zeros(values.shape[:-1] + (L, values.shape[-1]), dtype=_U32)
    for j, d in digs:
        du = d.astype(_I32).astype(_U32)[..., None, :]
        term = modops.mul_mod_shoup(
            du, ctx.enc_pow[j, :L][:, None], ctx.enc_pow_shoup[j, :L][:, None],
            qb)
        acc = modops.add_mod(acc, term, qb)
    return jnp.where(sign[..., None, :], modops.neg_mod(acc, qb), acc)


def encode_scalar(moduli: tuple[int, ...], w: float, scale: float):
    """Host-side exact scalar encode: round(w * scale) mod q_l, with Shoup
    companions. Returns (res (L,), shoup (L,)) numpy uint32.

    Mirrors EvalMult(ct, double) plaintext handling (ckks.cpp:288)."""
    t = int(round(float(w) * scale))
    res = np.array([t % q for q in moduli], dtype=np.uint32)
    shoup = modops.shoup_precompute(res, np.array(moduli, dtype=np.uint32))
    return res, shoup


def decode_coeff(ctx: CkksContext, residues: jnp.ndarray,
                 scale: float) -> jnp.ndarray:
    """Decode residues (..., live, N) in coefficient order -> f32 (..., N).

    Exact CRT + two-float division by `scale` (any positive float)."""
    live = residues.shape[-2]
    dc: DecodeConsts = ctx.dec_consts[live - 1]
    return decode_core(dc, ctx.q[:live], residues, scale)


def decode_core(dc: DecodeConsts, qs, residues: jnp.ndarray,
                scale: float) -> jnp.ndarray:
    """The decode arithmetic on plain arrays."""
    live = residues.shape[-2]
    nd = dc.ndig

    y = modops.mul_mod_shoup(
        residues, dc.punc_inv[:, None], dc.punc_inv_shoup[:, None],
        qs[:, None])                                    # (..., live, N)

    # k = round(sum y_l / q_l): exact because |v| << Q (see module doc).
    # u32 -> i32 -> f32: exact (y < q < 2**31).
    fsum = jnp.sum(y.astype(_I32).astype(_F32) * dc.inv_q_f32[:, None],
                   axis=-2)
    k = jnp.round(fsum).astype(_I32)                    # (..., N), 0..live

    # Digit-plane accumulation of sum_l y_l * M_l; every partial is < 2**16
    # and there are < 4*live + live + 3 of them per plane: fits uint32.
    y_lo = y & _U32(0xFFFF)
    y_hi = y >> 16
    planes = [jnp.zeros(residues.shape[:-2] + residues.shape[-1:], dtype=_U32)
              for _ in range(nd)]
    for l in range(live):
        for d in range(nd):
            m = dc.m_digits[l, d]
            p1 = y_lo[..., l, :] * m
            planes[d] = planes[d] + (p1 & _U32(0xFFFF))
            if d + 1 < nd:
                planes[d + 1] = planes[d + 1] + (p1 >> 16)
                p2 = y_hi[..., l, :] * m
                planes[d + 1] = planes[d + 1] + (p2 & _U32(0xFFFF))
            if d + 2 < nd:
                planes[d + 2] = planes[d + 2] + (p2 >> 16)

    return _planes_to_f32(dc, [p.astype(_I32) for p in planes], k, scale)


def _planes_to_f32(dc: DecodeConsts, planes: list, k: jnp.ndarray,
                   scale: float) -> jnp.ndarray:
    """Decode tail: digit planes (i32, each < 2**30, representing
    sum_l y_l * M_l in base 2**16) + k -> centered value / scale as f32."""
    nd = dc.ndig

    # w = acc + Q - k*Q  (>= 0, exact). k*Q's digit d is k * q_digits[d]
    # NON-normalized (< 2**21: k <= live+1, digit < 2**16) — the carry
    # propagation below renormalizes, since
    # sum_d (k * q_digits[d]) * 2**(16d) = k*Q exactly. This replaces the
    # former (live+1) x nd where-select of precomputed k*Q digit tables
    # with nd multiplies.
    out_digits = []
    carry = jnp.zeros_like(k)
    for d in range(nd):
        kq_d = k * dc.q_digits[d].astype(_I32)
        r = planes[d] + dc.q_digits[d].astype(_I32) - kq_d + carry
        out_digits.append(r & _I32(0xFFFF))
        carry = r >> 16
    # carry must be 0 here: w in [0, 2Q) fits the nd digit planes.

    # v = w - Q, digit-wise with borrow; final borrow = sign of v.
    vdigs = []
    borrow = jnp.zeros_like(k)
    for d in range(nd):
        r = out_digits[d] - dc.q_digits[d].astype(_I32) + borrow
        vdigs.append(r & _I32(0xFFFF))
        borrow = r >> 16                               # 0 or -1
    # v = sum vdigs[d] * 2**(16d) + borrow * 2**(16*nd)

    # Fold the sign into the digits (two's complement -> magnitude) so the
    # high planes of negative values are zeros, not all-ones: otherwise
    # their float terms overflow f32 (inf - inf = NaN) whenever
    # log2(Q) - log2(scale) exceeds ~112 bits.
    neg = borrow < 0
    mag = []
    carry = jnp.where(neg, _I32(1), _I32(0))
    for d in range(nd):
        t = jnp.where(neg, _I32(0xFFFF) - vdigs[d], vdigs[d]) + carry
        mag.append(t & _I32(0xFFFF))
        carry = t >> 16

    # Two-float sum of exact terms digit * 2**(16d) / 2**floor_log2(scale).
    # Planes whose weight 2**(16d - e) exceeds the f32 exponent range can
    # only be nonzero when |v|/scale is not f32-representable (decryption
    # noise blow-up): their weight constant would be inf and 0 * inf = NaN
    # would poison every healthy coefficient (XLA re-associates split
    # factors back together, so two-factor tricks don't survive jit).
    # Skip them and surface +/-inf when they are in fact nonzero.
    e = math.floor(math.log2(scale))
    hi = jnp.zeros(k.shape, dtype=_F32)
    lo = jnp.zeros(k.shape, dtype=_F32)
    overflow = jnp.zeros(k.shape, dtype=bool)
    for d in range(nd):
        ex = DIGIT_BITS * d - e
        if ex > 127:
            overflow = overflow | (mag[d] > 0)
            continue
        term = mag[d].astype(_F32) * _F32(2.0 ** ex)
        hi, lo = dfloat.df_add_f32(hi, lo, term)
    hi = jnp.where(overflow, _F32(jnp.inf), hi)
    # Residual division by scale / 2**e in two-float.
    c_hi, c_lo = dfloat.df_from_f64((2.0 ** e) / scale)
    hi, lo = dfloat.df_mul(hi, lo, _F32(c_hi), _F32(c_lo))
    return (hi + lo) * jnp.where(neg, _F32(-1.0), _F32(1.0))

"""Key generation and key containers for the CKKS backend.

All key polynomials live in the NTT (evaluation) domain with precomputed
Shoup companion words, so every key multiplication on the hot path is a
single Shoup modmul — no generic wide multiplication.

Sampling: ternary secrets and centered-binomial errors (sigma = sqrt(10) ~
3.16, matching the ~3.19 discrete gaussian PALISADE uses) from the JAX
threefry PRNG. Uniform polynomials are sampled directly in the evaluation
domain (a uniform ring element is uniform in either domain).

Shoup companions are computed host-side (numpy uint64) — keygen is a
one-time init op (reference "Init Time" ~0.17s, nvidia_results.txt).

Reference parity: cc->KeyGen() (ckks.cpp:46) + key serialization
(ckks.cpp:48-56) — see serial.py for the wire format.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp

from ..rns import modops
from ..ntt import ntt as ntt_mod
from .params import CkksContext

_U32 = jnp.uint32
_I32 = jnp.int32

_CBD_BITS = 20  # centered binomial with variance _CBD_BITS/2


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SecretKey:
    s: jnp.ndarray          # (L, N) eval domain
    s_shoup: jnp.ndarray    # (L, N)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class PublicKey:
    p0: jnp.ndarray         # (L, N) eval domain: -a*s + e
    p0_shoup: jnp.ndarray
    p1: jnp.ndarray         # (L, N) eval domain: a
    p1_shoup: jnp.ndarray


def _reduce_bits_mod_q(hi, lo, shape, ctx: CkksContext):
    """(hi * 2**32 + lo) mod q_l for uniform 32-bit words — bias < 2**-33."""
    L = shape[-2]
    q = ctx.q[:L].reshape((1,) * (len(shape) - 2) + (L, 1))
    p32 = ctx.pow32[:L].reshape(q.shape)
    p32_sh = ctx.pow32_shoup[:L].reshape(q.shape)
    # lo mod q: 2**32/q < 4 for q > 2**30, so at most 3 subtractions.
    lo = jnp.where(lo >= (q << 1), lo - (q << 1), lo)
    lo = jnp.where(lo >= q, lo - q, lo)
    hi_red = modops.mul_mod_shoup(hi, p32, p32_sh, q)
    return modops.add_mod(hi_red, lo, q)


def uniform_mod_q(key, shape, ctx: CkksContext):
    """Uniform residues in [0, q_l): shape must be (..., L_live, n).

    Draws 64 bits per element: r = (hi * 2**32 + lo) mod q — bias < 2**-33.
    """
    k1, k2 = jax.random.split(key)
    hi = jax.random.bits(k1, shape, dtype=_U32)
    lo = jax.random.bits(k2, shape, dtype=_U32)
    return _reduce_bits_mod_q(hi, lo, shape, ctx)


def uniform_mod_q_xor2(key_a, key_b, shape, ctx: CkksContext):
    """uniform_mod_q from the XOR of TWO independent threefry streams.

    threefry2x32 has a 64-bit keyspace; a wire format whose security rests
    on seed non-collision needs more (Kyber uses 256-bit seeds). XORing two
    independently-keyed streams is uniform whenever either stream is, and
    an (a, b) pair collides only when BOTH keys collide — a 128-bit seed
    space. Used by the seed-compressed ciphertext path (ops.py)."""
    k1a, k2a = jax.random.split(key_a)
    k1b, k2b = jax.random.split(key_b)
    hi = jax.random.bits(k1a, shape, dtype=_U32) ^ \
        jax.random.bits(k1b, shape, dtype=_U32)
    lo = jax.random.bits(k2a, shape, dtype=_U32) ^ \
        jax.random.bits(k2b, shape, dtype=_U32)
    return _reduce_bits_mod_q(hi, lo, shape, ctx)


def ternary_coeffs(key, shape):
    """Ternary {-1, 0, 1} int32 coefficients (uniform, negligible mod-3 bias)."""
    bits = jax.random.bits(key, shape, dtype=_U32)
    return (bits % 3).astype(_I32) - 1


def cbd_coeffs(key, shape):
    """Centered binomial error: popcount(a) - popcount(b) over 20-bit masks."""
    k1, k2 = jax.random.split(key)
    a = jax.random.bits(k1, shape, dtype=_U32) & _U32((1 << _CBD_BITS) - 1)
    b = jax.random.bits(k2, shape, dtype=_U32) & _U32((1 << _CBD_BITS) - 1)
    pa = jax.lax.population_count(a).astype(_I32)
    pb = jax.lax.population_count(b).astype(_I32)
    return pa - pb


def lift_signed(coeffs: jnp.ndarray, q: jnp.ndarray) -> jnp.ndarray:
    """Small signed int coefficients (..., N) -> residues (..., L, N)."""
    c = coeffs[..., None, :]
    qi = q.astype(_I32)[:, None]
    return jnp.where(c < 0, c + qi, c).astype(_U32)


def _shoup_host(w: jnp.ndarray, q_np: np.ndarray) -> jnp.ndarray:
    """Host-side Shoup companion for a device residue array (L, N)."""
    w_np = np.asarray(w)
    return jnp.asarray(modops.shoup_precompute(w_np, q_np[:, None]))


def keygen(ctx: CkksContext, seed: int = 0) -> tuple[SecretKey, PublicKey]:
    """Generate (sk, pk) — mirrors cc->KeyGen() (reference ckks.cpp:46)."""
    n = ctx.ring_dim
    L = ctx.num_limbs
    key = jax.random.key(seed)
    k_s, k_a, k_e = jax.random.split(key, 3)
    q = ctx.q

    s_hat = ntt_mod.ntt_jit(lift_signed(ternary_coeffs(k_s, (n,)), q),
                            ctx.tables)
    a = uniform_mod_q(k_a, (L, n), ctx)
    e_hat = ntt_mod.ntt_jit(lift_signed(cbd_coeffs(k_e, (n,)), q), ctx.tables)

    qb = q[:, None]
    a_s = modops.mul_mod(a, s_hat, qb, ctx.mu[:, None])
    p0 = modops.add_mod(modops.neg_mod(a_s, qb), e_hat, qb)

    q_np = np.asarray(ctx.q)
    sk = SecretKey(s=s_hat, s_shoup=_shoup_host(s_hat, q_np))
    pk = PublicKey(
        p0=p0, p0_shoup=_shoup_host(p0, q_np),
        p1=a, p1_shoup=_shoup_host(a, q_np))
    return sk, pk

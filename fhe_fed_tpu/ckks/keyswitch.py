"""RNS key switching: relinearization and Galois rotations.

Implements the BV-style RNS key switch with one special prime P (the
"hybrid, dnum = L" point of the design space — what PALISADE's BV mode with
a wide first modulus provides the reference at mkhe.cpp:122-124 /
EvalMultKeyGen, EvalAtIndexKeyGen).

Math. For switching a polynomial d from key t to key s, the switching key
has one row per ciphertext limb j:

    evk_j = (b_j, a_j),   b_j = -a_j * s + e_j + delta_j * [P]_{q_j} * t

over the extended basis {q_0..q_{chain-1}, P}, where delta_j puts the
payload only on limb j. Because the gadget identity

    sum_j [d]_{q_j} * (Q/q_j) * [(Q/q_j)^{-1}]_{q_j}  ==  d  (mod Q)

collapses per-limb ([P * g_j]_{q_i} = delta_ij * [P]_{q_j}), the SAME key
works at every level: a ciphertext with `live` limbs just uses digits
j < live and basis {q_0..q_{live-1}, P}. Key switch is then

    ks(d) = ModDown_P( sum_j NTT(lift([d]_{q_j})) * evk_j )

with flooring ModDown (subtract [u]_P, multiply by P^{-1} mod q_i) adding
<= 1 units of noise per coefficient.

Shape: every step is a batched elementwise op or an NTT over the limb
axis; digit lifting is a single conditional subtraction because all primes
are 31-bit (x < q_j < 2**31 < 2*q_i). The digit fan-out/accumulate is one
fused reduction over the digit axis (modsum, 16-bit split accumulators).

Reference parity: PALISADE Relinearize / EvalAtIndex internals (consumed at
mkhe.cpp:363-371); the reference's FedAvg path itself never key-switches —
this enables the mult-depth>=1 and rotation surface (SURVEY.md C15).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp

from ..rns import modops
from ..ntt import ntt as ntt_mod
from ..ntt.tables import NttTables
from .params import CkksContext, CkksParams
from .keys import SecretKey, uniform_mod_q, cbd_coeffs, lift_signed
from . import ops as ckks_ops

_U32 = jnp.uint32


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class KSwitchKey:
    """Switching key: digit-indexed RLWE rows in the evaluation domain.

    Arrays are (dnum, L_full, N): row j covers the full modulus list; only
    limbs {0..live-1, special} are ever read at runtime.
    """
    b: jnp.ndarray
    b_shoup: jnp.ndarray
    a: jnp.ndarray
    a_shoup: jnp.ndarray


@functools.lru_cache(maxsize=None)
def _ks_consts(params: CkksParams):
    """Host-side per-params constants: [P]_{q_j} and P^{-1} mod q_j."""
    P = params.special_prime
    qs = params.moduli[:params.chain_len]
    p_mod = np.array([P % q for q in qs], dtype=np.uint32)
    pinv = np.array([pow(P % q, q - 2, q) for q in qs], dtype=np.uint32)
    qs_np = np.array(qs, dtype=np.uint32)
    return (p_mod, modops.shoup_precompute(p_mod, qs_np),
            pinv, modops.shoup_precompute(pinv, qs_np))


def _ext_indices(ctx: CkksContext, live: int) -> np.ndarray:
    """Limb indices of the extended basis {q_0..q_{live-1}, P}."""
    return np.array(list(range(live)) + [ctx.num_limbs - 1])


def _take_tables(tb: NttTables, idx: np.ndarray) -> NttTables:
    return NttTables(
        ring_dim=tb.ring_dim, q=tb.q[idx],
        tab=tb.tab[idx], tab_shoup=tb.tab_shoup[idx],
        itab=tb.itab[idx], itab_shoup=tb.itab_shoup[idx],
        ninv=tb.ninv[idx], ninv_shoup=tb.ninv_shoup[idx])


def make_kswitch_key(ctx: CkksContext, sk: SecretKey, target_hat: jnp.ndarray,
                     rng_key) -> KSwitchKey:
    """Key switching FROM key `target` TO sk. target_hat: (L_full, N) eval
    domain (e.g. s**2 for relinearization, sigma_g(s) for rotation)."""
    n = ctx.ring_dim
    L = ctx.num_limbs
    chain = ctx.params.chain_len
    q = ctx.q
    qb = q[:, None]
    p_mod, p_mod_shoup, _, _ = _ks_consts(ctx.params)

    k_a, k_e = jax.random.split(rng_key)
    a = uniform_mod_q(k_a, (chain, L, n), ctx)              # (dnum, L, N)
    e_hat = ntt_mod.ntt_jit(
        lift_signed(cbd_coeffs(k_e, (chain, n)), q), ctx.tables)

    a_s = modops.mul_mod_shoup(a, sk.s[None], sk.s_shoup[None], qb)
    b = modops.add_mod(modops.neg_mod(a_s, qb), e_hat, qb)
    # payload: limb j of row j gets [P]_{q_j} * target.
    pt = modops.mul_mod_shoup(
        target_hat[:chain],
        jnp.asarray(p_mod)[:, None], jnp.asarray(p_mod_shoup)[:, None],
        qb[:chain])                                         # (dnum, N)
    eye = jnp.eye(chain, L, dtype=_U32)[:, :, None]         # (dnum, L, 1)
    b = modops.add_mod(b, pt[:, None, :] * eye, qb)

    q_np = np.asarray(q)[None, :, None]
    return KSwitchKey(
        b=b, b_shoup=jnp.asarray(modops.shoup_precompute(np.asarray(b), q_np)),
        a=a, a_shoup=jnp.asarray(modops.shoup_precompute(np.asarray(a), q_np)))


def make_relin_key(ctx: CkksContext, sk: SecretKey, rng_key) -> KSwitchKey:
    """EvalMultKeyGen (reference mkhe.cpp:122): key for s**2 -> s."""
    qb = ctx.q[:, None]
    s2 = modops.mul_mod_shoup(sk.s, sk.s, sk.s_shoup, qb)
    return make_kswitch_key(ctx, sk, s2, rng_key)


def key_switch(ctx: CkksContext, d: jnp.ndarray, ksk: KSwitchKey):
    """Switch polynomial batch d (chunks, live, N) [eval domain] to sk.

    Returns (ks0, ks1): each (chunks, live, N) — ModDown already applied.
    """
    chunks, live, n = d.shape
    idx = _ext_indices(ctx, live)
    ext = live + 1
    tb_live = ctx.tables.slice_limbs(0, live)
    tb_ext = _take_tables(ctx.tables, idx)
    q_ext = ctx.q[idx]                                     # (ext,)
    qb_ext = q_ext[:, None]

    # 1. to coefficient domain, per-limb digits.
    c = ntt_mod.intt(d, tb_live)                           # (chunks, live, N)
    # 2. lift each digit to the extended basis: one conditional subtraction.
    x = c[:, :, None, :]                                   # (chunks, dig, 1, N)
    x = jnp.where(x >= qb_ext, x - qb_ext, x)              # (chunks, dig, ext, N)
    x = jnp.broadcast_to(x, (chunks, live, ext, n))
    # 3. forward NTT over the extended basis.
    x_hat = ntt_mod.ntt(x, tb_ext)
    # 4. multiply by evk rows and reduce over the digit axis.
    b_sel = ksk.b[:live][:, idx]                           # (dig, ext, N)
    a_sel = ksk.a[:live][:, idx]
    pow32 = ctx.pow32[idx][:, None]
    pow32_sh = ctx.pow32_shoup[idx][:, None]

    def digit_reduce(rows, rows_shoup):
        terms = modops.mul_mod_shoup(
            x_hat, rows[None], rows_shoup[None], qb_ext)
        # digit axis -> axis 0 for the fused modular sum.
        terms = jnp.moveaxis(terms, 1, 0)                  # (dig, chunks, ext, N)
        return ckks_ops.modsum_clients(terms, qb_ext, pow32, pow32_sh)

    u0 = digit_reduce(b_sel, ksk.b_shoup[:live][:, idx])   # (chunks, ext, N)
    u1 = digit_reduce(a_sel, ksk.a_shoup[:live][:, idx])
    # 5. ModDown by P.
    return _mod_down(ctx, u0, live), _mod_down(ctx, u1, live)


def _mod_down(ctx: CkksContext, u: jnp.ndarray, live: int) -> jnp.ndarray:
    """Floor-divide by the special prime: (u - [u]_P) * P^{-1} mod q_i."""
    L = ctx.num_limbs
    _, _, pinv, pinv_shoup = _ks_consts(ctx.params)
    tb_p = ctx.tables.slice_limbs(L - 1, L)
    up = ntt_mod.intt(u[..., -1:, :], tb_p)                # (chunks, 1, N) < P
    qb = ctx.q[:live, None]
    delta = jnp.where(up >= qb, up - qb, up)               # (chunks, live, N)
    delta_hat = ntt_mod.ntt(delta, ctx.tables.slice_limbs(0, live))
    diff = modops.sub_mod(u[..., :live, :], delta_hat, qb)
    return modops.mul_mod_shoup(
        diff, jnp.asarray(pinv[:live])[:, None],
        jnp.asarray(pinv_shoup[:live])[:, None], qb)


# ---------------------------------------------------------------------------
# ct x ct multiplication + relinearization
# ---------------------------------------------------------------------------

@jax.jit
def _mul_relin_impl(ctx: CkksContext, a: jnp.ndarray, b: jnp.ndarray,
                    rlk: KSwitchKey) -> jnp.ndarray:
    live = a.shape[2]
    qb = ctx.q[:live, None]
    mu = ctx.mu[:live, None]
    a0, a1 = a[:, 0], a[:, 1]
    b0, b1 = b[:, 0], b[:, 1]
    d0 = modops.mul_mod(a0, b0, qb, mu)
    d1 = modops.add_mod(modops.mul_mod(a0, b1, qb, mu),
                        modops.mul_mod(a1, b0, qb, mu), qb)
    d2 = modops.mul_mod(a1, b1, qb, mu)
    ks0, ks1 = key_switch(ctx, d2, rlk)
    return jnp.stack([modops.add_mod(d0, ks0, qb),
                      modops.add_mod(d1, ks1, qb)], axis=1)


def mul_ct(ctx: CkksContext, a: ckks_ops.Ciphertext, b: ckks_ops.Ciphertext,
           rlk: KSwitchKey) -> ckks_ops.Ciphertext:
    """EvalMult(ct, ct) + Relinearize (reference mkhe.cpp:363-366).
    Caller typically rescales afterwards."""
    assert a.level == b.level and a.live_limbs == b.live_limbs
    data = _mul_relin_impl(ctx, a.data, b.data, rlk)
    return ckks_ops.Ciphertext(data=data, scale=a.scale * b.scale,
                               level=a.level)


# ---------------------------------------------------------------------------
# Galois automorphisms / rotations
# ---------------------------------------------------------------------------

def _bitrev(x: int, bits: int) -> int:
    r = 0
    for _ in range(bits):
        r = (r << 1) | (x & 1)
        x >>= 1
    return r


@functools.lru_cache(maxsize=None)
def _auto_perm(n: int, g: int) -> np.ndarray:
    """Eval-domain permutation of the automorphism X -> X**g.

    Eval slot k (bit-reversed order) holds m(psi**(2*brv(k)+1)); the
    automorphism sends it to the slot holding exponent (2*brv(k)+1)*g.
    out[k] = in[perm[k]].
    """
    bits = n.bit_length() - 1
    two_n = 2 * n
    perm = np.empty(n, dtype=np.int32)
    for k in range(n):
        e = (2 * _bitrev(k, bits) + 1) * g % two_n
        perm[k] = _bitrev((e - 1) // 2, bits)
    return perm


def galois_element(r: int, n: int) -> int:
    """Galois element for a rotation by r slots (conjugate: r='conj')."""
    return pow(5, r, 2 * n)


def conj_element(n: int) -> int:
    return 2 * n - 1


def automorphism(data: jnp.ndarray, n: int, g: int) -> jnp.ndarray:
    """Apply X -> X**g to eval-domain data (..., N): a slot gather."""
    perm = _auto_perm(n, g)
    return data[..., perm]


def make_galois_key(ctx: CkksContext, sk: SecretKey, g: int,
                    rng_key) -> KSwitchKey:
    """EvalAtIndexKeyGen analogue (mkhe.cpp:123-124) for one element g."""
    s_g = automorphism(sk.s, ctx.ring_dim, g)
    return make_kswitch_key(ctx, sk, s_g, rng_key)


@functools.partial(jax.jit, static_argnames=("g",))
def _rotate_impl(ctx: CkksContext, data: jnp.ndarray, gk: KSwitchKey,
                 g: int) -> jnp.ndarray:
    live = data.shape[2]
    qb = ctx.q[:live, None]
    n = ctx.ring_dim
    c0 = automorphism(data[:, 0], n, g)
    c1 = automorphism(data[:, 1], n, g)
    ks0, ks1 = key_switch(ctx, c1, gk)
    return jnp.stack([modops.add_mod(c0, ks0, qb), ks1], axis=1)


def rotate(ctx: CkksContext, ct: ckks_ops.Ciphertext, r: int,
           gk: KSwitchKey) -> ckks_ops.Ciphertext:
    """Rotate packed slots by r positions (EvalAtIndex)."""
    g = galois_element(r, ctx.ring_dim)
    data = _rotate_impl(ctx, ct.data, gk, g)
    return ckks_ops.Ciphertext(data=data, scale=ct.scale, level=ct.level)


def eval_sum(ctx: CkksContext, ct: ckks_ops.Ciphertext,
             gks: dict[int, KSwitchKey], width: int) -> ckks_ops.Ciphertext:
    """Sum over `width` packed slots via log2(width) rotations (EvalSum).
    gks: {r: galois key for rotation by r} for r = 1, 2, 4, ... width/2."""
    assert width & (width - 1) == 0
    out = ct
    r = 1
    while r < width:
        out = ckks_ops.add(ctx, out, rotate(ctx, out, r, gks[r]))
        r <<= 1
    return out

"""End-to-end CKKS FedAvg round under ('limb', 'coeff') mesh sharding.

Round 2 proved the sharded four-step NTT as a building block (ntt/dist.py);
this module runs the WHOLE encrypted round in that layout — encrypt ->
fused weighted sum -> rescale -> decrypt — so rings larger than one
device's memory budget can span devices *inside the FedAvg pipeline*
(SURVEY.md §7 step 8, §5.8; the capability PALISADE's single-node OpenMP cannot express,
reference ckks.cpp:70).

Layout: a distributed ciphertext is uint32 (..., 2, L, N1, N2) where
(N1, N2) is the four-step matrix view of the ring.
  * coefficient domain: n = N2*n1 + n2, with n2 sharded over 'coeff';
  * evaluation domain: the dist-eval order of ntt/dist.py (position (r, c)
    holds the evaluation at psi^(2k+1), k = rev(r) + N1*rev(c)), with the
    r axis sharded over 'coeff';
  * the RNS limb axis may additionally be sharded over 'limb' — every op
    here except the final CRT decode is limb-local.

Cross-device traffic per round: ONE all-to-all per NTT/iNTT (stage
exchange), the psum of the client fan-in if clients are mesh-sharded, and
one all-gather of the limb axis feeding the CRT decode. Keys are carried in
the same layout (sk_to_dist permutes the eval-domain secret key host-side).

Equivalence contract (tested): a distributed ciphertext converted to the
on-chip layout (ntt/dist.py eval_perm) is a VALID on-chip ciphertext —
weighted-sum + rescale + decrypt commute with the conversion bit-exactly.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp

from ..rns import modops
from ..ntt import dist as D
from . import encoding
from .params import CkksContext
from .keys import SecretKey, cbd_coeffs

_U32 = jnp.uint32


# ---------------------------------------------------------------------------
# Key / layout conversion (host-side)
# ---------------------------------------------------------------------------

def sk_to_dist(sk: SecretKey, n1: int) -> SecretKey:
    """Secret key (eval domain, on-chip order) -> dist-eval layout
    (L, N1, N2). The Shoup companions are per-element, so they permute."""
    return SecretKey(
        s=jnp.asarray(D.eval_to_dist(np.asarray(sk.s), n1)),
        s_shoup=jnp.asarray(D.eval_to_dist(np.asarray(sk.s_shoup), n1)))


def ct_dist_to_onchip(data_dist: np.ndarray) -> np.ndarray:
    """Distributed ct (..., 2, L, N1, N2) -> on-chip ct (..., 2, L, N)."""
    return D.dist_to_eval(np.asarray(data_dist))


# ---------------------------------------------------------------------------
# Sharded primitives
# ---------------------------------------------------------------------------

def _uniform_mod_q_dist(key, shape, q, pow32, pow32_shoup):
    """Uniform residues in [0, q_l) at shape (..., L, N1, N2)."""
    qb = q[:, None, None]
    p32 = pow32[:, None, None]
    p32_sh = pow32_shoup[:, None, None]
    k1, k2 = jax.random.split(key)
    hi = jax.random.bits(k1, shape, dtype=_U32)
    lo = jax.random.bits(k2, shape, dtype=_U32)
    lo = jnp.where(lo >= (qb << 1), lo - (qb << 1), lo)
    lo = jnp.where(lo >= qb, lo - qb, lo)
    return modops.add_mod(modops.mul_mod_shoup(hi, p32, p32_sh, qb), lo, qb)


def encrypt_symmetric_dist(ctx: CkksContext, dt: D.DistNttTables,
                           ds: D.DistSpec, sk_d: SecretKey,
                           values: jnp.ndarray, rng_key,
                           scale: float) -> jnp.ndarray:
    """Secret-key encrypt (chunks, N) f32 -> dist ct (chunks, 2, L, N1, N2).

    Same construction as ops._encrypt_sym_impl (ct = (a*s + [m+e]^, -a),
    ONE forward transform), with `a` sampled directly in the dist-eval
    layout and the transform sharded (one all-to-all)."""
    chunks, n = values.shape
    n1, n2 = dt.n1, dt.n2
    L = ctx.params.chain_len
    q = ctx.q[:L]
    q3 = q[:, None, None]

    v3 = values.reshape(chunks, n1, n2)
    v3 = jax.lax.with_sharding_constraint(
        v3, ds.col_sharding(v3.ndim))
    # encode_coeff / lift_signed insert the limb axis at -2 of a (..., n2)
    # trailing layout; move it to the dist position.
    pt = jnp.moveaxis(encoding.encode_coeff(ctx, v3, scale), -2, -3)
    k_a, k_e = jax.random.split(rng_key)
    e = cbd_coeffs(k_e, (chunks, n1, n2))[..., None, :]   # (chunks,n1,1,n2)
    e = jnp.where(e < 0, e + q.astype(jnp.int32)[:, None], e).astype(_U32)
    e = jnp.moveaxis(e, -2, -3)                           # (chunks,L,n1,n2)
    w_hat = D.dist_ntt(modops.add_mod(pt, e, q3), dt, ds)
    a_hat = _uniform_mod_q_dist(k_a, (chunks, L, n1, n2), q,
                                ctx.pow32[:L], ctx.pow32_shoup[:L])
    a_hat = jax.lax.with_sharding_constraint(
        a_hat, ds.row_sharding(a_hat.ndim))
    c0 = modops.add_mod(
        modops.mul_mod_shoup(a_hat, sk_d.s[:L], sk_d.s_shoup[:L], q3),
        w_hat, q3)
    c1 = modops.neg_mod(a_hat, q3)
    return jnp.stack([c0, c1], axis=1)          # (chunks, 2, L, N1, N2)


def weighted_sum_dist(ctx: CkksContext, stacked: jnp.ndarray,
                      w_res: jnp.ndarray, w_shoup: jnp.ndarray):
    """stacked (K, chunks, 2, live, N1, N2); w_* (K, live). The fused
    FedAvg fan-in (ckks.cpp:273-298 replacement) in the dist layout."""
    K = stacked.shape[0]
    live = stacked.shape[3]
    qb = ctx.q[:live, None, None]
    acc = None
    for i in range(K):
        t = modops.mul_mod_shoup(stacked[i],
                                 w_res[i, :, None, None],
                                 w_shoup[i, :, None, None], qb)
        acc = t if acc is None else modops.add_mod(acc, t, qb)
    return acc


def rescale_dist(ctx: CkksContext, dt: D.DistNttTables, ds: D.DistSpec,
                 data: jnp.ndarray) -> jnp.ndarray:
    """RNS rescale in the dist layout: iNTT the top limb (sharded), reduce
    mod the remaining primes, NTT back (sharded), subtract, multiply by
    q_t^-1. Mirrors ops._rescale_impl exactly."""
    live = data.shape[-3]
    t = live - 1
    lvl = ctx.params.chain_len - live
    # Sliced-limb transforms (1 limb / t limbs) are not generally divisible
    # by the limb axis: run them with the limb dim under GSPMD propagation
    # (coeff stays explicitly sharded — the all-to-all is unaffected).
    ds_nl = dataclasses.replace(ds, limb_axis=None)
    qt_poly = D.dist_intt(data[..., t:t + 1, :, :], dt.slice_limbs(t, t + 1),
                          ds_nl)
    qj = ctx.q[:t, None, None]
    delta = jnp.where(qt_poly >= qj, qt_poly - qj, qt_poly)
    delta_hat = D.dist_ntt(delta, dt.slice_limbs(0, t), ds_nl)
    inv, inv_shoup = ctx.rescale_inv[lvl]
    num = modops.sub_mod(data[..., :t, :, :], delta_hat, qj)
    return modops.mul_mod_shoup(num, inv[:, None, None],
                                inv_shoup[:, None, None], qj)


def decrypt_dist(ctx: CkksContext, dt: D.DistNttTables, ds: D.DistSpec,
                 sk_d: SecretKey, data: jnp.ndarray,
                 scale: float) -> jnp.ndarray:
    """Dist ct (chunks, 2, live, N1, N2) -> f32 (chunks, N).

    Phase + inverse transform stay fully sharded; the CRT decode needs all
    limbs of a coefficient together, so the limb axis is gathered
    (all-gather over 'limb' — the one intrinsically cross-limb step of the
    whole round), while the coefficient axis stays sharded."""
    live = data.shape[-3]
    q3 = ctx.q[:live, None, None]
    phase = modops.add_mod(
        data[:, 0],
        modops.mul_mod_shoup(data[:, 1], sk_d.s[:live], sk_d.s_shoup[:live],
                             q3), q3)
    ds_l = ds if live % np.prod(
        [ds.mesh.shape[ds.limb_axis]] if ds.limb_axis else [1]) == 0 \
        else dataclasses.replace(ds, limb_axis=None)
    coeffs = D.dist_intt(phase, dt.slice_limbs(0, live), ds_l)
    # (chunks, live, N1, N2): gather limbs, keep n2 sharded.
    from jax.sharding import NamedSharding, PartitionSpec as P
    coeffs = jax.lax.with_sharding_constraint(
        coeffs, NamedSharding(ds.mesh, P(None, None, None, ds.coeff_axis)))
    # decode expects the limb axis at -2 of a (..., n2) trailing layout.
    out = encoding.decode_coeff(ctx, jnp.moveaxis(coeffs, -3, -2), scale)
    return out.reshape(out.shape[0], -1)         # (chunks, N)


# ---------------------------------------------------------------------------
# Galois automorphism (rotation data movement) under coefficient sharding
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _dist_auto_perms(n: int, n1: int, g: int):
    """Index maps of X -> X^g in the dist-eval layout (r, c).

    Position (r, c) holds the evaluation at psi^(2k+1), k = rev1(r) +
    N1*rev2(c). The automorphism pulls from source slot k_src = g*k +
    (g-1)/2 mod N, which SEPARATES over the layout:

        k1_src = (g*k1 + t) mod N1            -- depends on the ROW only
        k2_src = (g*k2 + carry(k1)) mod N2    -- column map, row-dependent

    so the whole data movement is ONE permutation of the (sharded) row axis
    plus a LOCAL row-dependent column gather. Returns (row_perm (N1,),
    col_perm (N1, N2)) with out[r, c] = in[row_perm[r], col_perm[r, c]].
    """
    from .keyswitch import _bitrev
    n2 = n // n1
    b1 = n1.bit_length() - 1
    b2 = n2.bit_length() - 1
    t = (g - 1) // 2 % n
    row_perm = np.empty(n1, dtype=np.int32)
    col_perm = np.empty((n1, n2), dtype=np.int32)
    for r in range(n1):
        k1 = _bitrev(r, b1)
        for c in range(n2):
            k2 = _bitrev(c, b2)
            k = k1 + n1 * k2
            k_src = (g * k + t) % n
            r_src = _bitrev(k_src % n1, b1)
            c_src = _bitrev(k_src // n1, b2)
            row_perm[r] = r_src          # invariant in c (checked below)
            col_perm[r, c] = c_src
    # sanity: the row map really is column-independent
    for r in range(n1):
        k1 = _bitrev(r, b1)
        assert _bitrev((g * k1 + t) % n1, b1) == row_perm[r]
    return row_perm, col_perm


def dist_automorphism(x: jnp.ndarray, g: int, dt: D.DistNttTables,
                      ds: D.DistSpec) -> jnp.ndarray:
    """Apply X -> X^g to dist-eval-layout data (..., L, N1, N2).

    The column gather is local to each shard; the row permutation crosses
    the sharded axis and lowers to one collective (GSPMD chooses
    collective-permute / all-gather for the static row gather — the
    rotation's ONLY cross-device data movement). The expensive half of a
    rotation — the key switch — is coefficient-wise per limb in the eval
    domain (digit decomposition across limbs x key multiplication), so it
    needs NO cross-coefficient communication at all beyond the NTTs this
    module already shards; only this permutation moves data between
    devices. Parity: keyswitch.automorphism / EvalAtIndex data movement
    (mkhe.cpp:122-124 rotations).
    """
    row_perm, col_perm = _dist_auto_perms(dt.ring_dim, dt.n1, int(g))
    x = jax.lax.with_sharding_constraint(x, ds.row_sharding(x.ndim))
    y = jnp.take(x, jnp.asarray(row_perm), axis=-2)       # cross-shard
    y = jnp.take_along_axis(
        y, jnp.asarray(col_perm)[(None,) * (y.ndim - 2)].astype(jnp.int32),
        axis=-1)                                          # local
    return jax.lax.with_sharding_constraint(y, ds.row_sharding(x.ndim))


# ---------------------------------------------------------------------------
# The full round
# ---------------------------------------------------------------------------

def make_dist_fed_step(ctx: CkksContext, dt: D.DistNttTables,
                       ds: D.DistSpec, weights: list[float]):
    """Build a jitted sharded secure-FedAvg round:

        step(sk_d, values (K, chunks, N) f32, rng_key) -> (chunks, N) f32

    encrypt (all K clients in one sharded computation) -> fused weighted
    sum -> rescale -> decrypt, everything in the ('limb', 'coeff') layout.
    """
    K = len(weights)
    chain = ctx.params.chain_len
    dscale = float(ctx.params.moduli[chain - 1])
    res_l, shoup_l = zip(*(encoding.encode_scalar(
        ctx.params.moduli[:chain], float(w), dscale) for w in weights))
    w_res = jnp.asarray(np.stack(res_l))
    w_shoup = jnp.asarray(np.stack(shoup_l))
    enc_scale = float(ctx.params.scale)
    qt = float(ctx.params.moduli[chain - 1])
    out_scale = enc_scale * dscale / qt

    @jax.jit
    def step(sk_d: SecretKey, values: jnp.ndarray, rng_key):
        Kv, chunks, n = values.shape
        assert Kv == K
        # All clients encrypted in one sharded computation: fold K into the
        # chunk axis (every chunk is independent).
        flat = values.reshape(K * chunks, n)
        cts = encrypt_symmetric_dist(ctx, dt, ds, sk_d, flat, rng_key,
                                     enc_scale)
        stacked = cts.reshape(K, chunks, *cts.shape[1:])
        agg = weighted_sum_dist(ctx, stacked, w_res, w_shoup)
        agg = rescale_dist(ctx, dt, ds, agg)
        return decrypt_dist(ctx, dt, ds, sk_d, agg, out_scale)

    return step

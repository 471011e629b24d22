"""Core CKKS homomorphic operations, batched over ciphertext chunks.

A ciphertext is a uint32 array (chunks, 2, L_live, N) in the NTT/evaluation
domain (bit-reversed order). One `encrypt` / `weighted_sum` / `decrypt` call
processes an entire model's worth of chunks in a single XLA computation —
this replaces the reference's per-chunk OpenMP loops (ckks.cpp:70-104) and
its serial per-learner aggregation loop (ckks.cpp:273-298) with whole-batch
vectorization plus (on a mesh) psum over the client axis.

Scale bookkeeping follows the reference's EvalMult(ct, double) semantics
(ckks.cpp:288): scalar multiplication raises the scale by ~31 bits (the
scalar is encoded at the top rescale prime), and decode divides by the
tracked exact scale, so decrypt is correct whether or not rescale() was
called — matching PALISADE's depth-1 FedAvg usage where the result is
decrypted right after the weighted average.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp

from ..rns import modops
from ..ntt import ntt as ntt_mod
from . import encoding
from .params import CkksContext
from .keys import (SecretKey, PublicKey, uniform_mod_q, uniform_mod_q_xor2,
                   ternary_coeffs, cbd_coeffs, lift_signed)

_U32 = jnp.uint32


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Ciphertext:
    """RLWE ciphertext batch in the evaluation domain."""
    data: jnp.ndarray                                    # (chunks, 2, live, N)
    scale: float = dataclasses.field(metadata=dict(static=True))
    level: int = dataclasses.field(metadata=dict(static=True))

    @property
    def num_chunks(self) -> int:
        return int(self.data.shape[0])

    @property
    def live_limbs(self) -> int:
        return int(self.data.shape[2])


def _live_tables(ctx: CkksContext, live: int):
    return ctx.tables.slice_limbs(0, live)


@jax.jit
def _encrypt_pt_impl(ctx: CkksContext, pk: PublicKey, pt: jnp.ndarray,
                     rng_key) -> jnp.ndarray:
    """pt: (chunks, chain, N) coefficient-order residues -> ct data
    (chunks, 2, chain, N). RLWE: (b*u + e0 + m, a*u + e1)."""
    chunks, L, n = pt.shape
    assert L == ctx.params.chain_len
    q = ctx.q[:L]
    qb = q[:, None]
    tb = ctx.tables.slice_limbs(0, L)
    m_hat = ntt_mod.ntt(pt, tb)

    k_u, k_e0, k_e1 = jax.random.split(rng_key, 3)
    u_hat = ntt_mod.ntt(lift_signed(ternary_coeffs(k_u, (chunks, n)), q), tb)
    e_hat = ntt_mod.ntt(
        lift_signed(
            jnp.stack([cbd_coeffs(k_e0, (chunks, n)),
                       cbd_coeffs(k_e1, (chunks, n))], axis=1), q),
        tb)                                              # (chunks, 2, L, N)

    c0 = modops.add_mod(
        modops.add_mod(
            modops.mul_mod_shoup(u_hat, pk.p0[:L], pk.p0_shoup[:L], qb),
            e_hat[:, 0], qb),
        m_hat, qb)
    c1 = modops.add_mod(
        modops.mul_mod_shoup(u_hat, pk.p1[:L], pk.p1_shoup[:L], qb),
        e_hat[:, 1], qb)
    return jnp.stack([c0, c1], axis=1)


@functools.partial(jax.jit, static_argnames=("scale",))
def _encrypt_impl(ctx: CkksContext, pk: PublicKey, values: jnp.ndarray,
                  rng_key, scale: float) -> jnp.ndarray:
    """values: (chunks, N) f32 -> ct data (chunks, 2, chain, N)."""
    pt = encoding.encode_coeff(ctx, values, scale)       # (chunks, chain, N)
    return _encrypt_pt_impl(ctx, pk, pt, rng_key)


def encrypt(ctx: CkksContext, pk: PublicKey, values: jnp.ndarray,
            rng_key, scale: float | None = None) -> Ciphertext:
    """Encrypt (chunks, N) f32 values. Mirrors cc->Encrypt (ckks.cpp:81)."""
    scale = float(ctx.params.scale if scale is None else scale)
    data = _encrypt_impl(ctx, pk, values, rng_key, scale)
    return Ciphertext(data=data, scale=scale, level=0)


def encrypt_encoded(ctx: CkksContext, pk: PublicKey, pt: jnp.ndarray,
                    rng_key, scale: float) -> Ciphertext:
    """Encrypt already-encoded residues (chunks, chain, N), e.g. slot-packed
    plaintexts from slots.encode_slots."""
    data = _encrypt_pt_impl(ctx, pk, pt, rng_key)
    return Ciphertext(data=data, scale=float(scale), level=0)


@functools.partial(jax.jit, static_argnames=("scale",))
def _encrypt_sym_impl(ctx: CkksContext, sk: SecretKey, values: jnp.ndarray,
                      rng_key, scale: float) -> jnp.ndarray:
    """Secret-key RLWE encryption: ct = (a*s + [m + e]^, -a) with `a` sampled
    uniformly *in the evaluation domain* — one NTT batch total instead of the
    four the public-key path needs (m, u, e0, e1).

    Valid whenever the encryptor holds sk — which is the reference's own
    trust model: every learner loads the secret key and decrypts
    (ckks.cpp:11-23 loads key-private for all parties; decrypt at
    ckks.cpp:189). PALISADE likewise exposes Encrypt(privateKey, pt).
    Decryption, aggregation, and noise behavior are identical to the
    public-key path: c0 + c1*s = m + e."""
    chunks, n = values.shape
    L = ctx.params.chain_len
    q = ctx.q[:L]
    qb = q[:, None]
    tb = ctx.tables.slice_limbs(0, L)

    pt = encoding.encode_coeff(ctx, values, scale)       # (chunks, L, N)
    k_a, k_e = jax.random.split(rng_key)
    e = lift_signed(cbd_coeffs(k_e, (chunks, n)), q)
    w_hat = ntt_mod.ntt(modops.add_mod(pt, e, qb), tb)   # the ONE transform
    a_hat = uniform_mod_q(k_a, (chunks, L, n), ctx)
    c0 = modops.add_mod(
        modops.mul_mod_shoup(a_hat, sk.s[:L], sk.s_shoup[:L], qb),
        w_hat, qb)
    c1 = modops.neg_mod(a_hat, qb)
    return jnp.stack([c0, c1], axis=1)


def encrypt_symmetric(ctx: CkksContext, sk: SecretKey, values: jnp.ndarray,
                      rng_key, scale: float | None = None) -> Ciphertext:
    """Secret-key encrypt of (chunks, N) f32 values (see _encrypt_sym_impl)."""
    scale = float(ctx.params.scale if scale is None else scale)
    data = _encrypt_sym_impl(ctx, sk, values, rng_key, scale)
    return Ciphertext(data=data, scale=scale, level=0)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SeededCiphertext:
    """A FRESH secret-key ciphertext with c1 elided: c1 = -a where a is
    expanded from the 128-bit seed carried alongside c0. Halves the
    client->server upload (the RLWE seed-compression standard trick,
    e.g. Kyber's seed-expanded public matrix) — a capability the
    reference's PALISADE wire format does not offer. Only fresh
    encryptions compress this way: homomorphic results have non-seedable
    c1, so the server expands on arrival and aggregates as usual.

    The seed keys TWO independent threefry2x32 streams whose XOR is the
    a-stream (keys.uniform_mod_q_xor2): one threefry key is only 64 bits,
    too small for a collision-free wire guarantee, while a key PAIR
    collides only when both halves do (~2**128 space). JAX's threefry
    stream is platform-deterministic, so a ciphertext sealed on a CPU
    client expands bit-identically on a GPU server (the 'rbg' PRNG is not
    platform-deterministic, so it is NOT used here)."""
    c0: jnp.ndarray                                      # (chunks, live, N)
    seed: jnp.ndarray                                    # (4,) uint32
    scale: float = dataclasses.field(metadata=dict(static=True))
    level: int = dataclasses.field(metadata=dict(static=True))


def _seed_keys(seed: jnp.ndarray):
    return (jax.random.wrap_key_data(seed[:2], impl="threefry2x32"),
            jax.random.wrap_key_data(seed[2:], impl="threefry2x32"))


@functools.partial(jax.jit, static_argnames=("scale",))
def _encrypt_sym_seeded_impl(ctx: CkksContext, sk: SecretKey,
                             values: jnp.ndarray, seed, e_key,
                             scale: float) -> jnp.ndarray:
    """c0 of the secret-key ciphertext, with `a` expanded from the wire
    seed: the SAME construction as _encrypt_sym_impl, split so the
    a-stream is reproducible from wire-carried key data."""
    chunks, n = values.shape
    L = ctx.params.chain_len
    q = ctx.q[:L]
    qb = q[:, None]
    tb = ctx.tables.slice_limbs(0, L)
    pt = encoding.encode_coeff(ctx, values, scale)
    e = lift_signed(cbd_coeffs(e_key, (chunks, n)), q)
    w_hat = ntt_mod.ntt(modops.add_mod(pt, e, qb), tb)
    ka, kb = _seed_keys(seed)
    a_hat = uniform_mod_q_xor2(ka, kb, (chunks, L, n), ctx)
    return modops.add_mod(
        modops.mul_mod_shoup(a_hat, sk.s[:L], sk.s_shoup[:L], qb),
        w_hat, qb)


def encrypt_symmetric_seeded(ctx: CkksContext, sk: SecretKey,
                             values: jnp.ndarray, rng_key,
                             scale: float | None = None) -> SeededCiphertext:
    """Secret-key encrypt of (chunks, N) f32 with c1 elided (half-size
    wire blobs; see SeededCiphertext). rng_key may be any PRNG impl; the
    wire seed is always a threefry key pair."""
    scale = float(ctx.params.scale if scale is None else scale)
    seed = jax.random.bits(rng_key, (4,), jnp.uint32)
    e_key = jax.random.fold_in(rng_key, 0x5eed)
    c0 = _encrypt_sym_seeded_impl(ctx, sk, values, seed, e_key, scale)
    return SeededCiphertext(c0=c0, seed=seed, scale=scale, level=0)


@jax.jit
def _expand_seeded_impl(ctx: CkksContext, c0: jnp.ndarray,
                        seed: jnp.ndarray) -> jnp.ndarray:
    chunks, L, n = c0.shape
    qb = ctx.q[:L][:, None]
    ka, kb = _seed_keys(seed)
    a_hat = uniform_mod_q_xor2(ka, kb, (chunks, L, n), ctx)
    return jnp.stack([c0, modops.neg_mod(a_hat, qb)], axis=1)


def expand_seeded(ctx: CkksContext, sct: SeededCiphertext) -> Ciphertext:
    """Server-side: rebuild the full (c0, c1) ciphertext from (c0, seed).
    One uniform expansion per ciphertext — the same cost the encryptor
    paid, so aggregation throughput is unchanged."""
    data = _expand_seeded_impl(ctx, sct.c0, sct.seed)
    return Ciphertext(data=data, scale=sct.scale, level=sct.level)


@functools.partial(jax.jit, static_argnames=("scale",))
def _encrypt_sym_stacked_impl(ctx: CkksContext, sk: SecretKey,
                              values: jnp.ndarray, rng_key,
                              scale: float) -> jnp.ndarray:
    """values: (K, chunks, N) -> ct data (K, chunks, 2, L, N); all K clients
    encrypted in ONE XLA computation (per-client keys split inside)."""
    keys = jax.random.split(rng_key, values.shape[0])
    return jax.vmap(
        lambda v, k: _encrypt_sym_impl(ctx, sk, v, k, scale))(values, keys)


def encrypt_symmetric_stacked(ctx: CkksContext, sk: SecretKey,
                              values: jnp.ndarray, rng_key,
                              scale: float | None = None) -> Ciphertext:
    """Encrypt a whole cohort at once: values (K, chunks, N) -> batched
    Ciphertext with data (K, chunks, 2, L, N). One device dispatch for all K
    clients — the batched analogue of the reference's per-learner encrypt
    loop (benchmark_crypto.py:183-186). Feed the result to weighted_sum."""
    scale = float(ctx.params.scale if scale is None else scale)
    data = _encrypt_sym_stacked_impl(ctx, sk, values, rng_key, scale)
    return Ciphertext(data=data, scale=scale, level=0)


@functools.partial(jax.jit, static_argnames=("scale",))
def _encrypt_stacked_impl(ctx: CkksContext, pk: PublicKey,
                          values: jnp.ndarray, rng_key,
                          scale: float) -> jnp.ndarray:
    keys = jax.random.split(rng_key, values.shape[0])
    return jax.vmap(
        lambda v, k: _encrypt_impl(ctx, pk, v, k, scale))(values, keys)


def encrypt_stacked(ctx: CkksContext, pk: PublicKey, values: jnp.ndarray,
                    rng_key, scale: float | None = None) -> Ciphertext:
    """Public-key analogue of encrypt_symmetric_stacked."""
    scale = float(ctx.params.scale if scale is None else scale)
    data = _encrypt_stacked_impl(ctx, pk, values, rng_key, scale)
    return Ciphertext(data=data, scale=scale, level=0)


@functools.partial(jax.jit, static_argnames=("scale",))
def _decrypt_impl(ctx: CkksContext, sk: SecretKey, data: jnp.ndarray,
                  scale: float) -> jnp.ndarray:
    live = data.shape[2]
    qb = ctx.q[:live, None]
    phase = modops.add_mod(
        data[:, 0],
        modops.mul_mod_shoup(data[:, 1], sk.s[:live], sk.s_shoup[:live], qb),
        qb)
    coeffs = ntt_mod.intt(phase, _live_tables(ctx, live))
    return encoding.decode_coeff(ctx, coeffs, scale)


def log2_precision(actual, expected) -> float:
    """Bits of precision of a decrypted result: -log2(max |actual -
    expected|). PALISADE parity: plaintext->GetLogPrecision(), printed
    after every decrypt in the reference's threshold experiment
    (mkhe.cpp:182-183, 406-407) as its numeric-quality check."""
    err = float(np.max(np.abs(np.asarray(actual, dtype=np.float64)
                              - np.asarray(expected, dtype=np.float64))))
    return float("inf") if err == 0.0 else -float(np.log2(err))


def decrypt(ctx: CkksContext, sk: SecretKey, ct: Ciphertext) -> jnp.ndarray:
    """Decrypt to (chunks, N) f32. Mirrors cc->Decrypt + GetRealPackedValue
    (ckks.cpp:189-204)."""
    return _decrypt_impl(ctx, sk, ct.data, ct.scale)


@jax.jit
def _phase_coeffs_impl(ctx: CkksContext, sk: SecretKey,
                       data: jnp.ndarray) -> jnp.ndarray:
    live = data.shape[2]
    qb = ctx.q[:live, None]
    phase = modops.add_mod(
        data[:, 0],
        modops.mul_mod_shoup(data[:, 1], sk.s[:live], sk.s_shoup[:live], qb),
        qb)
    return ntt_mod.intt(phase, _live_tables(ctx, live))


def decrypt_residues(ctx: CkksContext, sk: SecretKey,
                     ct: Ciphertext) -> jnp.ndarray:
    """Decrypt to raw coefficient-order residues (chunks, live, N) — for
    alternative decoders (slots.decode_slots)."""
    return _phase_coeffs_impl(ctx, sk, ct.data)


def add(ctx: CkksContext, a: Ciphertext, b: Ciphertext) -> Ciphertext:
    """EvalAdd (ckks.cpp:296)."""
    assert a.scale == b.scale and a.level == b.level
    qb = ctx.q[:a.live_limbs, None]
    return Ciphertext(data=modops.add_mod(a.data, b.data, qb),
                      scale=a.scale, level=a.level)


def _scalar_scale(ctx: CkksContext, level: int) -> float:
    """Scalars are encoded at the current top rescale prime so a following
    rescale() restores the original scale exactly."""
    top = ctx.params.chain_len - 1 - level
    return float(ctx.params.moduli[top])


def mul_scalar(ctx: CkksContext, ct: Ciphertext, w: float) -> Ciphertext:
    """EvalMult(ct, double) (ckks.cpp:288): scale grows by the top prime."""
    live = ct.live_limbs
    ds = _scalar_scale(ctx, ct.level)
    res, shoup = encoding.encode_scalar(ctx.params.moduli[:live], w, ds)
    qb = ctx.q[:live, None]
    data = modops.mul_mod_shoup(
        ct.data, jnp.asarray(res)[:, None], jnp.asarray(shoup)[:, None], qb)
    return Ciphertext(data=data, scale=ct.scale * ds, level=ct.level)


def _mod_u32(x: jnp.ndarray, qb: jnp.ndarray) -> jnp.ndarray:
    """Reduce an arbitrary uint32 mod q for q > 2**30 (<= 3 subtractions)."""
    x = jnp.where(x >= (qb << 1), x - (qb << 1), x)
    x = jnp.where(x >= qb, x - qb, x)
    return jnp.where(x >= qb, x - qb, x)


def modsum_clients(terms: jnp.ndarray, qb: jnp.ndarray,
                   pow32b: jnp.ndarray, pow32b_shoup: jnp.ndarray):
    """Modular sum over axis 0 (the client axis) via 16-bit split
    accumulation: the lo/hi half sums never overflow uint32 for up to 65536
    clients, and jnp.sum lowers to a native XLA reduction — which becomes a
    psum when the client axis is mesh-sharded.

    value = lo + hi * 2**16 with hi = a * 2**16 + b:
      value mod q = [lo]_q + [b << 16]_q + a * [2**32]_q.
    """
    assert terms.shape[0] <= 65536
    lo = jnp.sum(terms & _U32(0xFFFF), axis=0)     # < K * 2**16 <= 2**32
    hi = jnp.sum(terms >> 16, axis=0)              # < K * 2**16
    a = hi >> 16
    b = hi & _U32(0xFFFF)
    r = _mod_u32(lo, qb)
    r = modops.add_mod(r, _mod_u32(b << 16, qb), qb)
    a32 = modops.mul_mod_shoup(a, pow32b, pow32b_shoup, qb)
    return modops.add_mod(r, a32, qb)


@jax.jit
def _weighted_sum_impl(ctx: CkksContext, stacked: jnp.ndarray,
                       w_res: jnp.ndarray, w_shoup: jnp.ndarray):
    """stacked: (K, chunks, 2, live, N); w_*: (K, live).

    THE FedAvg hot op — replaces the reference's serial per-learner
    EvalMult+EvalAdd loop (ckks.cpp:273-298) with one fused reduction.

    Two equivalent lowerings:
      * small K (unrolled chain) — scalar-mult + add_mod per client, all
        fused by XLA into a single pass over the K inputs;
      * large K — 16-bit split accumulation (modsum_clients), whose
        jnp.sum lowers to a native XLA reduction and becomes a psum when
        the client axis is mesh-sharded (parallel/mesh.py uses it directly).
    """
    K = stacked.shape[0]
    live = stacked.shape[3]
    qb = ctx.q[:live, None]
    if K <= 8:
        acc = None
        for i in range(K):
            t = modops.mul_mod_shoup(stacked[i], w_res[i, None, :, None],
                                     w_shoup[i, None, :, None], qb)
            acc = t if acc is None else modops.add_mod(acc, t, qb)
        return acc
    terms = modops.mul_mod_shoup(
        stacked, w_res[:, None, None, :, None],
        w_shoup[:, None, None, :, None], qb)
    return modsum_clients(terms, qb, ctx.pow32[:live, None],
                          ctx.pow32_shoup[:live, None])


def weighted_sum(ctx: CkksContext, cts, weights: list[float]) -> Ciphertext:
    """computeWeightedAverage core (ckks.cpp:264-320), fused.

    `cts` is either a list of (chunks, 2, live, N) Ciphertexts or ONE batched
    Ciphertext with data (K, chunks, 2, live, N) from encrypt_*_stacked —
    the latter avoids the eager stack (one fewer device dispatch)."""
    if isinstance(cts, Ciphertext):
        assert cts.data.ndim == 5 and cts.data.shape[0] == len(weights)
        scale0, level0 = cts.scale, cts.level
        live = int(cts.data.shape[3])
        stacked = cts.data
    else:
        assert len(cts) == len(weights)
        scale0, level0 = cts[0].scale, cts[0].level
        live = cts[0].live_limbs
        stacked = None
    ds = _scalar_scale(ctx, level0)
    res_l, shoup_l = [], []
    for w in weights:
        r, s = encoding.encode_scalar(ctx.params.moduli[:live], float(w), ds)
        res_l.append(r)
        shoup_l.append(s)
    if stacked is None:
        stacked = jnp.stack([c.data for c in cts])
    w_res = jnp.asarray(np.stack(res_l))
    w_shoup = jnp.asarray(np.stack(shoup_l))
    data = _weighted_sum_impl(ctx, stacked, w_res, w_shoup)
    return Ciphertext(data=data, scale=scale0 * ds, level=level0)


@functools.partial(jax.jit, static_argnames=("scale", "dec_scale"))
def _fedavg_round_fused_impl(ctx: CkksContext, sk: SecretKey,
                             values: jnp.ndarray, rng_key,
                             w_res: jnp.ndarray, w_shoup: jnp.ndarray,
                             scale: float, dec_scale: float) -> jnp.ndarray:
    data = _encrypt_sym_stacked_impl(ctx, sk, values, rng_key, scale)
    agg = _weighted_sum_impl(ctx, data, w_res, w_shoup)
    return _decrypt_impl(ctx, sk, agg, dec_scale)


def fedavg_round_fused(ctx: CkksContext, sk: SecretKey, values: jnp.ndarray,
                       rng_key, weights: list[float],
                       scale: float | None = None) -> jnp.ndarray:
    """One full secure-FedAvg round — encrypt all K clients, fused weighted
    sum, decrypt — as ONE XLA computation: values (K, chunks, N) f32 ->
    averaged (chunks, N) f32, still on device.

    The phased path (encrypt_symmetric_stacked / weighted_sum / decrypt)
    mirrors the reference's accounting, where each phase is a separately
    timed call (benchmark_crypto.py:183-239); this one is the deployment
    shape — the server round-trip is a single dispatch, so XLA fuses
    across phase boundaries (the aggregation reads ciphertexts straight
    out of the encrypt fusion) and per-dispatch latency is paid once per
    round instead of once per phase. Identical arithmetic to the staged
    path (test_fed_api.py::test_fused_round_matches_staged)."""
    scale = float(ctx.params.scale if scale is None else scale)
    L = ctx.params.chain_len
    ds = _scalar_scale(ctx, 0)
    res_l, shoup_l = zip(*(encoding.encode_scalar(
        ctx.params.moduli[:L], float(w), ds) for w in weights))
    return _fedavg_round_fused_impl(
        ctx, sk, values, rng_key,
        jnp.asarray(np.stack(res_l)), jnp.asarray(np.stack(shoup_l)),
        scale, scale * ds)


@jax.jit
def _rescale_impl(ctx: CkksContext, data: jnp.ndarray, level: int = 0):
    # level is re-derived from shapes; kept only in the wrapper.
    live = data.shape[2]
    t = live - 1
    lvl = ctx.params.chain_len - live     # current level before rescale
    q = ctx.q
    qt_poly = ntt_mod.intt(data[:, :, t:t + 1, :],
                           ctx.tables.slice_limbs(t, t + 1))  # (chunks,2,1,N)
    # Reduce the (coefficient-domain) top-limb poly mod each remaining q_j:
    # values < q_t < 2*q_j, one conditional subtraction.
    qj = q[:t, None]
    delta = jnp.where(qt_poly >= qj, qt_poly - qj, qt_poly)   # (chunks,2,t,N)
    delta_hat = ntt_mod.ntt(delta, ctx.tables.slice_limbs(0, t))
    inv, inv_shoup = ctx.rescale_inv[lvl]
    num = modops.sub_mod(data[:, :, :t, :], delta_hat, qj)
    return modops.mul_mod_shoup(num, inv[:, None], inv_shoup[:, None], qj)


def rescale(ctx: CkksContext, ct: Ciphertext) -> Ciphertext:
    """Drop the top limb and divide scale by its prime (RNS rescale)."""
    assert ct.level < ctx.params.mult_depth, "no rescale levels left"
    t_idx = ct.live_limbs - 1
    qt = ctx.params.moduli[t_idx]
    data = _rescale_impl(ctx, ct.data)
    return Ciphertext(data=data, scale=ct.scale / qt, level=ct.level + 1)

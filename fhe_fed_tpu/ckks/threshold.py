"""Threshold (N-of-N multiparty) CKKS.

Reference parity: the mkhe experiment (code/mkhe/mkhe.cpp:188-465) —
chained MultipartyKeyGen (mkhe.cpp:281-304), joint eval-sum keys
(305-317), encrypt under the joint key (348-349), scalar EvalMult /
EvalAdd on the joint ciphertext (363-368), and per-party
MultipartyDecryptLead/Main + MultipartyDecryptFusion (392-402).

Scheme: the joint secret is additive, s = sum_i s_i, with a COMMON
uniform polynomial `a` across the chain, so the joint public key is

    pk = (b, a),   b = -a * s + sum_i e_i = sum_i (-a * s_i + e_i).

Party i extends the chain with one Shoup multiply: b_i = b_{i-1}
- a*s_i + e_i (extend_public_key). Decryption is one round: the lead
party publishes c0 + s_0*c1 + e_sm, every other party publishes
s_i*c1 + e_sm, and fusion is a plain modular sum — on a device mesh the
party axis sums with a psum, like the client axis of FedAvg.

`e_sm` is smudging/flooding noise, deliberately much wider than the
encryption noise so a partial decryption leaks nothing about s_i beyond
the plaintext (standard threshold-FHE practice; the reference relies on
PALISADE's internal flooding).

Joint Galois/eval-sum keys (mkhe.cpp:305-317): each party derives the
common `a_j` rows from a shared public seed and publishes its additive
share of every row; summing shares yields the joint key
(combine_switch_key_shares).

Joint relinearization (MultiKeySwitchGen + MultiMultEvalKey +
MultiAddEvalMultKeys, mkhe.cpp:281-317) is the TWO-round ceremony:

  round 1  party i publishes a switch-key share for its own s_i over the
           COMMON rows a_j with payload P*s_i (partial_relin_round1);
           summing shares gives D = (d0, d1) with
           d0 = -a*s + e + P*gadget(s), d1 = a — a valid s -> s key
           under the JOINT secret (combine_switch_key_shares).
  round 2  party i publishes (d0*s_i + e0_i, d1*s_i + e1_i)
           (partial_relin_round2); summing over parties
           (combine_relin_shares) gives

             b = d0*s + e0 = -a*s**2 + P*gadget(s**2) + (e*s + e0)
             a'= d1*s + e1 =  a*s + e1

           so b + a'*s = P*gadget(s**2) + (e*s + e0 + e1*s): a relin key
           for the joint s**2 -> s, with the protocol's extra |s|-factor
           noise (flooded away by rescale + decode precision).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp

from ..rns import modops
from ..ntt import ntt as ntt_mod
from .params import CkksContext
from .keys import (SecretKey, PublicKey, uniform_mod_q, ternary_coeffs,
                   cbd_coeffs, lift_signed, _shoup_host)
from . import ops as ckks_ops
from . import keyswitch as ks_mod

_U32 = jnp.uint32

# Smudging noise: centered binomial of variance 2**_SMUDGE_BITS/2 per
# coefficient (~2**20 >> encryption noise sigma~3.2).
_SMUDGE_BITS = 40

# Domain tags for per-party PRNG stream derivation. Every ceremony stream
# is fold_in(fold_in(root_key, tag), party): full 128-bit key entropy and
# structurally disjoint families (no arithmetic seed collisions — the
# earlier seed*1000+i / seed*7+1+i scheme collided at seed=0).
_TAG_SECRET, _TAG_PK_A, _TAG_PK_NOISE = 0, 1, 2
_TAG_RELIN_R1, _TAG_RELIN_R2 = 3, 4


def _root_key(seed):
    """Accept either an int seed (tests/benchmarks) or a full PRNG key.

    Passing a key preserves all 128 bits of entropy — production keygen
    (fed/threshold_api.py) does this; int seeds are for reproducible
    tests. Single-process keygen is SIMULATION-ONLY either way: a real
    deployment runs the per-party protocol functions on separate machines
    so no process ever holds more than one share."""
    if isinstance(seed, (int, np.integer)):
        return jax.random.key(seed)
    return seed


def _stream(root, tag: int, i: int):
    return jax.random.fold_in(jax.random.fold_in(root, tag), i)


def party_secret(ctx: CkksContext, rng_key) -> SecretKey:
    """One party's additive share s_i (ternary, full limb set)."""
    s_hat = ntt_mod.ntt_jit(
        lift_signed(ternary_coeffs(rng_key, (ctx.ring_dim,)), ctx.q),
        ctx.tables)
    return SecretKey(s=s_hat, s_shoup=_shoup_host(s_hat, np.asarray(ctx.q)))


def init_public_key(ctx: CkksContext, sk: SecretKey, rng_key) -> PublicKey:
    """Party 0: pk_0 = (-a*s_0 + e_0, a) (mkhe.cpp:268 KeyGen)."""
    L, n = ctx.num_limbs, ctx.ring_dim
    k_a, k_e = jax.random.split(rng_key)
    a = uniform_mod_q(k_a, (L, n), ctx)
    return _extend(ctx, a, None, sk, k_e)


def extend_public_key(ctx: CkksContext, pk_prev: PublicKey, sk: SecretKey,
                      rng_key) -> PublicKey:
    """Party i: pk_i = (b_{i-1} - a*s_i + e_i, a) (MultipartyKeyGen,
    mkhe.cpp:281-304 chain)."""
    return _extend(ctx, pk_prev.p1, pk_prev.p0, sk, rng_key)


def _extend(ctx, a, b_prev, sk, k_e):
    qb = ctx.q[:, None]
    e_hat = ntt_mod.ntt_jit(
        lift_signed(cbd_coeffs(k_e, (ctx.ring_dim,)), ctx.q), ctx.tables)
    a_s = modops.mul_mod(a, sk.s, qb, ctx.mu[:, None])
    b = modops.add_mod(modops.neg_mod(a_s, qb), e_hat, qb)
    if b_prev is not None:
        b = modops.add_mod(b, b_prev, qb)
    q_np = np.asarray(ctx.q)
    return PublicKey(p0=b, p0_shoup=_shoup_host(b, q_np),
                     p1=a, p1_shoup=_shoup_host(a, q_np))


def multiparty_keygen(ctx: CkksContext, n_parties: int, seed=0
                      ) -> tuple[list[SecretKey], PublicKey]:
    """Full ceremony: returns per-party shares and the joint public key.

    `seed` may be an int (reproducible tests) or a full PRNG key
    (production — all 128 bits reach the shares). Simulation-only: one
    process holds every share; see _root_key."""
    root = _root_key(seed)
    sks = [party_secret(ctx, _stream(root, _TAG_SECRET, i))
           for i in range(n_parties)]
    L, n = ctx.num_limbs, ctx.ring_dim
    a = uniform_mod_q(_stream(root, _TAG_PK_A, 0), (L, n), ctx)
    pk = _extend(ctx, a, None, sks[0], _stream(root, _TAG_PK_NOISE, 0))
    for i in range(1, n_parties):
        pk = extend_public_key(ctx, pk, sks[i],
                               _stream(root, _TAG_PK_NOISE, i))
    return sks, pk


# ---------------------------------------------------------------------------
# Threshold decryption
# ---------------------------------------------------------------------------

def _smudge(ctx, rng_key, shape_chunks, live):
    """Wide flooding noise in the eval domain: (chunks, live, N)."""
    n = ctx.ring_dim
    k1, k2 = jax.random.split(rng_key)
    # sum of scaled CBDs approximates a wide discrete gaussian;
    # |e| <= ~21 * 2**20 < 2**31, fits int32
    e = (cbd_coeffs(k1, (shape_chunks, n))
         * jnp.int32(1 << (_SMUDGE_BITS // 2))
         + cbd_coeffs(k2, (shape_chunks, n)))
    qi = ctx.q[:live].astype(jnp.int32)[:, None]
    r = e[..., None, :] % qi
    coeffs = r.astype(_U32)
    return ntt_mod.ntt(coeffs, ctx.tables.slice_limbs(0, live))


def partial_decrypt_lead(ctx: CkksContext, sk: SecretKey,
                         ct: ckks_ops.Ciphertext, rng_key) -> jnp.ndarray:
    """Lead party share: c0 + s_0*c1 + e_sm (MultipartyDecryptLead)."""
    live = ct.live_limbs
    qb = ctx.q[:live, None]
    t = modops.mul_mod_shoup(ct.data[:, 1], sk.s[:live], sk.s_shoup[:live],
                             qb)
    t = modops.add_mod(ct.data[:, 0], t, qb)
    e = _smudge(ctx, rng_key, ct.data.shape[0], live)
    return modops.add_mod(t, e, qb)


def partial_decrypt_main(ctx: CkksContext, sk: SecretKey,
                         ct: ckks_ops.Ciphertext, rng_key) -> jnp.ndarray:
    """Non-lead party share: s_i*c1 + e_sm (MultipartyDecryptMain)."""
    live = ct.live_limbs
    qb = ctx.q[:live, None]
    t = modops.mul_mod_shoup(ct.data[:, 1], sk.s[:live], sk.s_shoup[:live],
                             qb)
    e = _smudge(ctx, rng_key, ct.data.shape[0], live)
    return modops.add_mod(t, e, qb)


def fuse_decrypt(ctx: CkksContext, partials: list[jnp.ndarray],
                 scale: float) -> jnp.ndarray:
    """MultipartyDecryptFusion (mkhe.cpp:402): sum shares, decode.
    The party-axis sum is psum-shardable on a mesh."""
    live = partials[0].shape[-2]
    qb = ctx.q[:live, None]
    acc = partials[0]
    for p in partials[1:]:
        acc = modops.add_mod(acc, p, qb)
    coeffs = ntt_mod.intt(acc, ctx.tables.slice_limbs(0, live))
    from . import encoding
    return encoding.decode_coeff(ctx, coeffs, scale)


# ---------------------------------------------------------------------------
# Joint Galois / eval-sum keys (single-round additive ceremony)
# ---------------------------------------------------------------------------

def partial_galois_key(ctx: CkksContext, sk: SecretKey, g: int,
                       common_seed: int, rng_key) -> ks_mod.KSwitchKey:
    """Party share of the joint rotation key for element g: rows use the
    COMMON a_j (from common_seed); payload carries P*sigma_g(s_i)
    (MultiEvalSumKeyGen semantics, mkhe.cpp:305-317).

    NB: switching FROM sigma_g(s) TO s requires ks0 + ks1*s =
    d*sigma_g(s); the additive share construction yields keys valid for
    the JOINT s because both the payload and the -a*s_i terms sum."""
    n = ctx.ring_dim
    L = ctx.num_limbs
    chain = ctx.params.chain_len
    q = ctx.q
    qb = q[:, None]
    p_mod, p_mod_shoup, _, _ = ks_mod._ks_consts(ctx.params)

    a = uniform_mod_q(jax.random.key(common_seed), (chain, L, n), ctx)
    k_e = rng_key
    e_hat = ntt_mod.ntt_jit(
        lift_signed(cbd_coeffs(k_e, (chain, n)), q), ctx.tables)

    a_s = modops.mul_mod_shoup(a, sk.s[None], sk.s_shoup[None], qb)
    b = modops.add_mod(modops.neg_mod(a_s, qb), e_hat, qb)
    s_g = ks_mod.automorphism(sk.s, n, g)
    pt = modops.mul_mod_shoup(
        s_g[:chain], jnp.asarray(p_mod)[:, None],
        jnp.asarray(p_mod_shoup)[:, None], qb[:chain])
    eye = jnp.eye(chain, L, dtype=_U32)[:, :, None]
    b = modops.add_mod(b, pt[:, None, :] * eye, qb)
    # shares carry no Shoup tables; computed after combining
    return ks_mod.KSwitchKey(b=b, b_shoup=None, a=a, a_shoup=None)


def partial_relin_round1(ctx: CkksContext, sk: SecretKey, common_seed: int,
                         rng_key) -> ks_mod.KSwitchKey:
    """Round-1 share (MultiKeySwitchGen, mkhe.cpp:281-304): payload P*s_i
    on the common rows — the identity automorphism (g=1) of the galois
    share construction."""
    return partial_galois_key(ctx, sk, 1, common_seed, rng_key)


def partial_relin_round2(ctx: CkksContext, sk: SecretKey,
                         d_joint: ks_mod.KSwitchKey,
                         rng_key) -> ks_mod.KSwitchKey:
    """Round-2 share (MultiMultEvalKey): party i multiplies BOTH rows of
    the combined round-1 key by its s_i and re-randomizes with fresh CBD
    noise. Shares sum componentwise (combine_relin_shares)."""
    chain = ctx.params.chain_len
    qb = ctx.q[:, None]
    k0, k1 = jax.random.split(rng_key)
    e0 = ntt_mod.ntt_jit(
        lift_signed(cbd_coeffs(k0, (chain, ctx.ring_dim)), ctx.q),
        ctx.tables)
    e1 = ntt_mod.ntt_jit(
        lift_signed(cbd_coeffs(k1, (chain, ctx.ring_dim)), ctx.q),
        ctx.tables)
    b = modops.add_mod(
        modops.mul_mod_shoup(d_joint.b, sk.s[None], sk.s_shoup[None], qb),
        e0, qb)
    a = modops.add_mod(
        modops.mul_mod_shoup(d_joint.a, sk.s[None], sk.s_shoup[None], qb),
        e1, qb)
    return ks_mod.KSwitchKey(b=b, b_shoup=None, a=a, a_shoup=None)


def combine_relin_shares(ctx: CkksContext,
                         shares: list[ks_mod.KSwitchKey]
                         ) -> ks_mod.KSwitchKey:
    """Sum round-2 shares componentwise -> joint relinearization key
    (MultiAddEvalMultKeys, mkhe.cpp:305-317)."""
    qb = ctx.q[:, None]
    b, a = shares[0].b, shares[0].a
    for sh in shares[1:]:
        b = modops.add_mod(b, sh.b, qb)
        a = modops.add_mod(a, sh.a, qb)
    q_np = np.asarray(ctx.q)[None, :, None]
    return ks_mod.KSwitchKey(
        b=b, b_shoup=jnp.asarray(modops.shoup_precompute(np.asarray(b),
                                                         q_np)),
        a=a, a_shoup=jnp.asarray(modops.shoup_precompute(np.asarray(a),
                                                         q_np)))


def multiparty_relin_key(ctx: CkksContext, sks: list[SecretKey],
                         common_seed: int = 0,
                         seed=0) -> ks_mod.KSwitchKey:
    """Full two-round joint relin ceremony over all parties. common_seed
    is the PUBLIC shared seed for the common rows (published by the
    protocol); `seed` roots the parties' private noise streams."""
    root = _root_key(seed)
    r1 = [partial_relin_round1(ctx, sk, common_seed,
                               _stream(root, _TAG_RELIN_R1, i))
          for i, sk in enumerate(sks)]
    d = combine_switch_key_shares(ctx, r1)
    r2 = [partial_relin_round2(ctx, sk, d,
                               _stream(root, _TAG_RELIN_R2, i))
          for i, sk in enumerate(sks)]
    return combine_relin_shares(ctx, r2)


def combine_switch_key_shares(ctx: CkksContext,
                              shares: list[ks_mod.KSwitchKey]
                              ) -> ks_mod.KSwitchKey:
    """Sum party shares of b (common a) -> joint key (MultiAddEvalKeys)."""
    qb = ctx.q[:, None]
    b = shares[0].b
    for sh in shares[1:]:
        b = modops.add_mod(b, sh.b, qb)
    a = shares[0].a
    q_np = np.asarray(ctx.q)[None, :, None]
    return ks_mod.KSwitchKey(
        b=b, b_shoup=jnp.asarray(modops.shoup_precompute(np.asarray(b),
                                                         q_np)),
        a=a, a_shoup=jnp.asarray(modops.shoup_precompute(np.asarray(a),
                                                         q_np)))


# ---------------------------------------------------------------------------
# Batched / jitted ceremonies — the device fast path
# ---------------------------------------------------------------------------
#
# The per-party functions above document the PROTOCOL (who publishes what,
# round by round — mkhe.cpp:281-317, 392-402) and are what a real
# multi-machine deployment would run. Executed eagerly per party they issue
# dozens of device dispatches each. The batched variants below compute the SAME arithmetic (bit-
# identical residues, same per-party PRNG streams) with the party axis
# stacked and the whole ceremony jitted: ONE dispatch per ceremony. Shoup
# companions are computed on device (modops.shoup_device), so no host
# round-trip interrupts the jit.

@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class PartySecrets:
    """All parties' additive shares stacked on a leading party axis."""
    s: jnp.ndarray          # (P, L, N) eval domain
    s_shoup: jnp.ndarray    # (P, L, N)

    @property
    def n_parties(self) -> int:
        return self.s.shape[0]

    def party(self, i: int) -> SecretKey:
        return SecretKey(s=self.s[i], s_shoup=self.s_shoup[i])


def stack_keys(keys) -> jnp.ndarray:
    """Stack a list of PRNG keys into a (P,)-shaped key array."""
    return jax.random.wrap_key_data(
        jnp.stack([jax.random.key_data(k) for k in keys]))


def _shoup_dev(ctx: CkksContext, w: jnp.ndarray) -> jnp.ndarray:
    """Device-side Shoup companions for residues (..., L_live, N)."""
    L = w.shape[-2]
    q = ctx.q[:L, None]
    mu = ctx.mu[:L, None]
    k32 = jnp.asarray(np.array([(1 << 32) // m
                                for m in ctx.params.moduli[:L]],
                               dtype=np.uint32))[:, None]
    return modops.shoup_device(w, q, mu, k32, ctx.pow32[:L, None])


@functools.partial(jax.jit, static_argnames=("n_parties",))
def _multiparty_keygen_impl(ctx: CkksContext, n_parties: int, root):
    n, L = ctx.ring_dim, ctx.num_limbs
    q = ctx.q
    qb = q[:, None]
    # Same per-party PRNG streams as party_secret / the pk chain.
    s_coef = jnp.stack([
        lift_signed(ternary_coeffs(_stream(root, _TAG_SECRET, i), (n,)), q)
        for i in range(n_parties)])                     # (P, L, N)
    s_hat = ntt_mod.ntt(s_coef, ctx.tables)

    a = uniform_mod_q(_stream(root, _TAG_PK_A, 0), (L, n), ctx)
    e_keys = [_stream(root, _TAG_PK_NOISE, i) for i in range(n_parties)]
    e_coef = jnp.stack([lift_signed(cbd_coeffs(k, (n,)), q)
                        for k in e_keys])               # (P, L, N)
    e_hat = ntt_mod.ntt(e_coef, ctx.tables)

    a_s = modops.mul_mod(a[None], s_hat, qb, ctx.mu[:, None])
    terms = modops.add_mod(modops.neg_mod(a_s, qb), e_hat, qb)
    b = terms[0]
    for i in range(1, n_parties):
        b = modops.add_mod(b, terms[i], qb)             # chain order

    return (PartySecrets(s=s_hat, s_shoup=_shoup_dev(ctx, s_hat)),
            PublicKey(p0=b, p0_shoup=_shoup_dev(ctx, b),
                      p1=a, p1_shoup=_shoup_dev(ctx, a)))


def multiparty_keygen_batched(ctx: CkksContext, n_parties: int,
                              seed=0
                              ) -> tuple[PartySecrets, PublicKey]:
    """The full chained-keygen ceremony (mkhe.cpp:268-304) as ONE jitted
    dispatch. Produces residues identical to multiparty_keygen(ctx,
    n_parties, seed) — the chain order of additions and every party's PRNG
    stream are preserved. `seed`: int or full PRNG key (see _root_key)."""
    return _multiparty_keygen_impl(ctx, n_parties, _root_key(seed))


def _partials_impl(ctx: CkksContext, secrets: PartySecrets,
                   data: jnp.ndarray, rng_keys) -> jnp.ndarray:
    """(P, chunks, live, N) partial decryptions; party 0 is the lead."""
    live = data.shape[-2]
    qb = ctx.q[:live, None]
    c0, c1 = data[:, 0], data[:, 1]
    s = secrets.s[:, None, :live]                       # (P, 1, live, N)
    s_sh = secrets.s_shoup[:, None, :live]
    t = modops.mul_mod_shoup(c1[None], s, s_sh, qb)     # (P, chunks, live, N)
    e = jax.vmap(lambda k: _smudge(ctx, k, data.shape[0], live))(rng_keys)
    parts = modops.add_mod(t, e, qb)
    lead = modops.add_mod(parts[0], c0, qb)
    return jnp.concatenate([lead[None], parts[1:]], axis=0)


@functools.partial(jax.jit, static_argnames=("scale",))
def _threshold_decrypt_impl(ctx: CkksContext, secrets: PartySecrets,
                            data: jnp.ndarray, rng_keys, scale: float):
    live = data.shape[-2]
    qb = ctx.q[:live, None]
    parts = _partials_impl(ctx, secrets, data, rng_keys)
    acc = parts[0]
    for i in range(1, parts.shape[0]):
        acc = modops.add_mod(acc, parts[i], qb)
    coeffs = ntt_mod.intt(acc, ctx.tables.slice_limbs(0, live))
    from . import encoding
    return encoding.decode_coeff(ctx, coeffs, scale)


def threshold_decrypt(ctx: CkksContext, secrets: PartySecrets,
                      ct: ckks_ops.Ciphertext, rng_keys) -> jnp.ndarray:
    """All parties' MultipartyDecryptLead/Main + MultipartyDecryptFusion
    (mkhe.cpp:392-402) as ONE jitted dispatch: the party axis is stacked
    (one Shoup modmul batch), the fusion sum and decode fuse in. rng_keys
    is a (P,)-shaped key array (stack_keys); party 0 takes the lead role.
    Residue-identical to the per-party partial_decrypt_* + fuse_decrypt
    path under the same keys."""
    return _threshold_decrypt_impl(ctx, secrets, ct.data, rng_keys,
                                   float(ct.scale))


_partials_jit = jax.jit(_partials_impl)


def partial_decrypt_stacked(ctx: CkksContext, secrets: PartySecrets,
                            ct: ckks_ops.Ciphertext, rng_keys
                            ) -> jnp.ndarray:
    """The (P, chunks, live, N) stack of partial decryptions (unfused) —
    what each party would publish; exposed for protocol tests."""
    return _partials_jit(ctx, secrets, ct.data, rng_keys)


@functools.partial(jax.jit, static_argnames=("common_seed",))
def _multiparty_relin_impl(ctx: CkksContext, secrets: PartySecrets,
                           common_seed: int, root):
    n = ctx.ring_dim
    L = ctx.num_limbs
    chain = ctx.params.chain_len
    P = secrets.s.shape[0]
    q = ctx.q
    qb = q[:, None]
    p_mod, p_mod_shoup, _, _ = ks_mod._ks_consts(ctx.params)

    # Round 1 (MultiKeySwitchGen): common rows from the shared seed,
    # per-party payload P*s_i on the gadget diagonal.
    a = uniform_mod_q(jax.random.key(common_seed), (chain, L, n), ctx)
    e1_coef = jnp.stack([
        lift_signed(cbd_coeffs(_stream(root, _TAG_RELIN_R1, i),
                               (chain, n)), q)
        for i in range(P)])                             # (P, chain, L, N)
    e1_hat = ntt_mod.ntt(e1_coef, ctx.tables)
    s = secrets.s[:, None]                              # (P, 1, L, N)
    s_sh = secrets.s_shoup[:, None]
    a_s = modops.mul_mod_shoup(a[None], s, s_sh, qb)
    b = modops.add_mod(modops.neg_mod(a_s, qb), e1_hat, qb)
    pt = modops.mul_mod_shoup(
        secrets.s[:, :chain], jnp.asarray(p_mod)[:, None],
        jnp.asarray(p_mod_shoup)[:, None], qb[:chain])  # (P, chain, N)
    eye = jnp.eye(chain, L, dtype=_U32)[:, :, None]
    b = modops.add_mod(b, pt[:, :, None, :] * eye[None], qb)
    d_b = b[0]
    for i in range(1, P):
        d_b = modops.add_mod(d_b, b[i], qb)             # MultiAddEvalKeys

    # Round 2 (MultiMultEvalKey): each party multiplies both rows of the
    # combined round-1 key by its s_i and re-randomizes.
    def noise(key):
        return ntt_mod.ntt(
            lift_signed(cbd_coeffs(key, (chain, n)), q), ctx.tables)

    r2_keys = [jax.random.split(_stream(root, _TAG_RELIN_R2, i))
               for i in range(P)]
    b2 = modops.add_mod(
        modops.mul_mod_shoup(d_b[None], s, s_sh, qb),
        jnp.stack([noise(k0) for k0, _ in r2_keys]), qb)
    a2 = modops.add_mod(
        modops.mul_mod_shoup(a[None], s, s_sh, qb),
        jnp.stack([noise(k1) for _, k1 in r2_keys]), qb)
    rb, ra = b2[0], a2[0]
    for i in range(1, P):
        rb = modops.add_mod(rb, b2[i], qb)
        ra = modops.add_mod(ra, a2[i], qb)
    return ks_mod.KSwitchKey(b=rb, b_shoup=_shoup_dev(ctx, rb),
                             a=ra, a_shoup=_shoup_dev(ctx, ra))


def multiparty_relin_key_batched(ctx: CkksContext, secrets: PartySecrets,
                                 common_seed: int = 0,
                                 seed=0) -> ks_mod.KSwitchKey:
    """The two-round joint relinearization ceremony (MultiKeySwitchGen +
    MultiMultEvalKey + MultiAddEvalMultKeys, mkhe.cpp:281-317) as ONE
    jitted dispatch. Residue-identical to multiparty_relin_key under the
    same seeds. `seed`: int or full PRNG key (see _root_key)."""
    return _multiparty_relin_impl(ctx, secrets, common_seed,
                                  _root_key(seed))


@functools.partial(jax.jit, static_argnames=("g", "common_seed"))
def _multiparty_galois_impl(ctx: CkksContext, secrets: PartySecrets,
                            g: int, common_seed: int, rng_keys):
    n = ctx.ring_dim
    L = ctx.num_limbs
    chain = ctx.params.chain_len
    P = secrets.s.shape[0]
    q = ctx.q
    qb = q[:, None]
    p_mod, p_mod_shoup, _, _ = ks_mod._ks_consts(ctx.params)

    a = uniform_mod_q(jax.random.key(common_seed), (chain, L, n), ctx)
    e_hat = ntt_mod.ntt(
        jax.vmap(lambda k: lift_signed(cbd_coeffs(k, (chain, n)), q))(
            rng_keys), ctx.tables)
    s = secrets.s[:, None]
    s_sh = secrets.s_shoup[:, None]
    a_s = modops.mul_mod_shoup(a[None], s, s_sh, qb)
    b = modops.add_mod(modops.neg_mod(a_s, qb), e_hat, qb)
    s_g = jax.vmap(lambda si: ks_mod.automorphism(si, n, g))(secrets.s)
    pt = modops.mul_mod_shoup(
        s_g[:, :chain], jnp.asarray(p_mod)[:, None],
        jnp.asarray(p_mod_shoup)[:, None], qb[:chain])
    eye = jnp.eye(chain, L, dtype=_U32)[:, :, None]
    b = modops.add_mod(b, pt[:, :, None, :] * eye[None], qb)
    jb = b[0]
    for i in range(1, P):
        jb = modops.add_mod(jb, b[i], qb)
    return ks_mod.KSwitchKey(b=jb, b_shoup=_shoup_dev(ctx, jb),
                             a=a, a_shoup=_shoup_dev(ctx, a))


def multiparty_galois_key_batched(ctx: CkksContext, secrets: PartySecrets,
                                  g: int, common_seed: int,
                                  rng_keys) -> ks_mod.KSwitchKey:
    """Joint Galois/eval-sum key ceremony (MultiEvalSumKeyGen +
    MultiAddEvalKeys, mkhe.cpp:305-317) as ONE jitted dispatch. rng_keys
    is a (P,)-shaped key array. Residue-identical to per-party
    partial_galois_key + combine_switch_key_shares under the same keys."""
    return _multiparty_galois_impl(ctx, secrets, g, common_seed, rng_keys)


@functools.partial(jax.jit, static_argnames=("scale", "dec_scale"))
def _threshold_round_impl(ctx: CkksContext, secrets: PartySecrets,
                          pk: PublicKey, values: jnp.ndarray, enc_key,
                          w_res: jnp.ndarray, w_shoup: jnp.ndarray,
                          dec_keys, scale: float, dec_scale: float):
    data = ckks_ops._encrypt_stacked_impl(ctx, pk, values, enc_key, scale)
    agg = ckks_ops._weighted_sum_impl(ctx, data, w_res, w_shoup)
    return _threshold_decrypt_impl(ctx, secrets, agg, dec_keys, dec_scale)


def threshold_round_fused(ctx: CkksContext, secrets: PartySecrets,
                          pk: PublicKey, values: jnp.ndarray, enc_key,
                          dec_keys, weights: list[float],
                          scale: float | None = None) -> jnp.ndarray:
    """One full THRESHOLD secure-FedAvg round as ONE XLA computation:
    joint-pk encrypt of all K clients -> fused weighted sum -> all-party
    partial decrypt + fusion + decode. values (K, chunks, N) f32 ->
    averaged (chunks, N) f32 on device. The threshold analogue of
    ops.fedavg_round_fused — no single secret key exists anywhere in the
    computation; dec_keys is a (P,)-shaped key array of fresh smudging
    streams."""
    import numpy as _np
    from . import encoding as _enc
    scale = float(ctx.params.scale if scale is None else scale)
    L = ctx.params.chain_len
    ds = ckks_ops._scalar_scale(ctx, 0)
    res_l, shoup_l = zip(*(_enc.encode_scalar(
        ctx.params.moduli[:L], float(w), ds) for w in weights))
    return _threshold_round_impl(
        ctx, secrets, pk, values, enc_key,
        jnp.asarray(_np.stack(res_l)), jnp.asarray(_np.stack(shoup_l)),
        dec_keys, scale, scale * ds)

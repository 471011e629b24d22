"""CKKS parameter selection for the uint32 RNS backend.

Behavioral parity with the reference context
(palisade_pybind/SHELFI_FHE/src/ckks.cpp:25-33: multDepth=1,
scaleFactorBits=52, batchSize=4096, 128-bit security):

  * `batch` values are packed per ciphertext chunk.
  * message scale Delta = 2**scale_bits (up to 52 and beyond).
  * ring dimension = max(2*batch, HE-standard minimum for the chosen chain).

Every RNS prime is 31 bits (uint32 limbs), so a 52-bit scale is
carried across a *product* of base primes rather than PALISADE's single
60-bit first modulus. The chain is

    [b_0 .. b_{B-1} | r_1 .. r_D]

with base primes b_i (31-bit) whose product covers scale + headroom, and one
31-bit rescale prime r_j per multiplicative level. Plaintext scalars are
encoded at a scale tracked exactly, so decode stays exact regardless of the
rescale history.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import jax
import jax.numpy as jnp

from ..rns import primes as primes_mod
from ..rns import modops
from ..ntt import tables as ntt_tables

# Headroom above the message scale so |value| * Delta + noise stays well
# below the base modulus at decryption (values up to ~2**20, noise margin).
_HEADROOM_BITS = 34

ENCODE_DIGITS = 6          # 6 x 16-bit digits = 96 bits of |round(m * Delta)|
DIGIT_BITS = 16
_DIGIT_MASK = (1 << DIGIT_BITS) - 1


@dataclasses.dataclass(frozen=True)
class CkksParams:
    """Static CKKS context parameters (hashable; safe as a jit static arg)."""
    ring_dim: int
    batch: int
    scale_bits: int
    mult_depth: int
    moduli: tuple[int, ...]   # base primes | rescale primes | special primes
    num_base: int             # how many leading primes are base primes
    num_special: int = 0      # trailing key-switch primes (never in cts)

    @property
    def num_limbs(self) -> int:
        return len(self.moduli)

    @property
    def chain_len(self) -> int:
        """Limbs available to ciphertexts (excludes special primes)."""
        return len(self.moduli) - self.num_special

    @property
    def special_prime(self) -> int:
        assert self.num_special == 1
        return self.moduli[-1]

    @property
    def scale(self) -> float:
        return float(2.0 ** self.scale_bits)

    @property
    def rescale_primes(self) -> tuple[int, ...]:
        return self.moduli[self.num_base:]

    @property
    def log_q(self) -> float:
        return sum(math.log2(q) for q in self.moduli)

    def limbs_at_level(self, level: int) -> int:
        """Number of live limbs for a ciphertext at `level` (0 = fresh)."""
        assert 0 <= level <= self.mult_depth
        return self.chain_len - level


def make_params(batch: int = 4096, scale_bits: int = 52,
                mult_depth: int = 1, ring_dim: int | None = None,
                num_special: int = 1) -> CkksParams:
    """Mirror of genCryptoContextCKKS(multDepth, scaleFactorBits, batchSize)
    (reference ckks.cpp:26-28) for the uint32-limb backend.

    num_special: trailing primes reserved for hybrid key-switching
    (relinearization / rotations). They never appear in ciphertexts."""
    num_base = max(2, math.ceil((scale_bits + _HEADROOM_BITS) / 31))
    total = num_base + mult_depth + num_special
    log_q = 31 * total
    n_sec = primes_mod.min_ring_dim_128(log_q)
    n = max(2 * batch, n_sec)
    if ring_dim is not None:
        assert ring_dim >= 2 * batch
        n = ring_dim
    moduli = primes_mod.ntt_primes(n, total)
    return CkksParams(
        ring_dim=n, batch=batch, scale_bits=scale_bits,
        mult_depth=mult_depth, moduli=moduli, num_base=num_base,
        num_special=num_special)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class DecodeConsts:
    """Exact-CRT decode constants for `live` limbs (see encoding.py)."""
    live: int = dataclasses.field(metadata=dict(static=True))
    ndig: int = dataclasses.field(metadata=dict(static=True))   # digit planes
    punc_inv: jnp.ndarray          # (live,)   (Q/q_l)^{-1} mod q_l
    punc_inv_shoup: jnp.ndarray    # (live,)
    m_digits: jnp.ndarray          # (live, ndig) 16-bit digits of Q/q_l
    q_digits: jnp.ndarray          # (ndig,) digits of Q
    inv_q_f32: jnp.ndarray         # (live,) 1/q_l as f32


def _make_decode_consts(moduli: tuple[int, ...], live: int) -> DecodeConsts:
    qs = moduli[:live]
    Q = 1
    for q in qs:
        Q *= q
    # Two extra digit planes absorb the live-fold accumulation overflow and
    # the k*Q subtraction slack.
    ndig = (Q.bit_length() + DIGIT_BITS - 1) // DIGIT_BITS + 2

    def digits(v: int) -> np.ndarray:
        return np.array([(v >> (DIGIT_BITS * d)) & _DIGIT_MASK
                         for d in range(ndig)], dtype=np.uint32)

    punc_inv = []
    m_digits = np.zeros((live, ndig), dtype=np.uint32)
    for l, q in enumerate(qs):
        M = Q // q
        punc_inv.append(pow(M % q, q - 2, q))
        m_digits[l] = digits(M)
    punc_inv = np.array(punc_inv, dtype=np.uint32)
    # (k*Q digit tables used to live here; decode now forms k*q_digits[d]
    # non-normalized and lets the carry chain renormalize — encoding.py.)
    # Host (numpy) leaves; make_context batches the whole context to the
    # device in one transfer (utils/devput.py).
    return DecodeConsts(
        live=live,
        ndig=ndig,
        punc_inv=punc_inv,
        punc_inv_shoup=modops.shoup_precompute(
            punc_inv, np.array(qs, dtype=np.uint32)),
        m_digits=m_digits,
        q_digits=digits(Q),
        inv_q_f32=np.array([1.0 / q for q in qs], dtype=np.float32),
    )


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class CkksContext:
    """Device-resident precomputed context derived from CkksParams."""
    params: CkksParams = dataclasses.field(metadata=dict(static=True))
    tables: ntt_tables.NttTables
    q: jnp.ndarray                 # (L,) uint32
    mu: jnp.ndarray                # (L,) Barrett constants
    pow32: jnp.ndarray             # (L,) 2**32 mod q (uniform sampling)
    pow32_shoup: jnp.ndarray
    enc_pow: jnp.ndarray           # (ENCODE_DIGITS, L) 2**(16j) mod q
    enc_pow_shoup: jnp.ndarray
    dec_consts: tuple              # tuple[DecodeConsts], index = live-1
    rescale_inv: tuple             # per level: (inv q_top mod q_j, shoup)

    @property
    def ring_dim(self) -> int:
        return self.params.ring_dim

    @property
    def num_limbs(self) -> int:
        return self.params.num_limbs


def make_context(params: CkksParams, materialize: bool = True) -> CkksContext:
    """Build the device-resident context. All constants are generated as
    numpy and shipped to the device in ONE batched transfer
    (utils/devput.py) instead of ~40 small ones."""
    n = params.ring_dim
    moduli = params.moduli
    L = len(moduli)
    qs = np.array(moduli, dtype=np.uint32)
    tb = ntt_tables.make_tables(n, moduli, materialize=False)
    mu = np.array([modops.barrett_precompute(q) for q in moduli],
                  dtype=np.uint32)
    pow32 = np.array([(1 << 32) % q for q in moduli], dtype=np.uint32)
    enc_pow = np.zeros((ENCODE_DIGITS, L), dtype=np.uint32)
    for j in range(ENCODE_DIGITS):
        for l, q in enumerate(moduli):
            enc_pow[j, l] = pow(2, DIGIT_BITS * j, q)
    chain = params.chain_len
    dec_consts = tuple(_make_decode_consts(moduli, live)
                       for live in range(1, chain + 1))
    rescale = []
    for level in range(params.mult_depth):
        t = chain - 1 - level          # index of limb being dropped
        qt = moduli[t]
        inv = np.array([pow(qt % q, q - 2, q) for q in moduli[:t]],
                       dtype=np.uint32)
        rescale.append((inv, modops.shoup_precompute(inv, qs[:t])))
    ctx = CkksContext(
        params=params,
        tables=tb,
        q=qs,
        mu=mu,
        pow32=pow32,
        pow32_shoup=modops.shoup_precompute(pow32, qs),
        enc_pow=enc_pow,
        enc_pow_shoup=modops.shoup_precompute(enc_pow, qs[None, :]),
        dec_consts=dec_consts,
        rescale_inv=tuple(rescale),
    )
    if materialize:
        from ..utils.devput import device_materialize
        ctx = device_materialize(ctx)
    return ctx

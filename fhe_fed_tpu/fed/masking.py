"""Masking-based secure aggregation (the reference's Paillier scheme).

Protocol parity with reference src/paillier.cpp:16-127 +
src/PaillierUtils.cpp:

  offline (per round, per learner):
    genPaillierRandOffline(n_params, iteration) — draw one-time-pad
        randomness r in [0, 2^num_bits), persist it, bit-pack many values
        per Paillier plaintext and encrypt (PaillierUtils.cpp:705-760)
    addPaillierRandOffline([blobs]) — homomorphic sum of everyone's
        encrypted randomness (765-769)
    decryptRandomnessSum(blob, n_params, iteration) — decrypt + persist
        the mask sum (772-808)

  online:
    encrypt(x, iteration)       = (fix(x) - r) mod 2^b   (499-551)
    computeWeightedAverage(...) = sum of masked ints mod 2^b (555-616);
        scaling factors are accepted but — like the reference — the
        protocol only supports the uniform average: unmask divides by
        the learner count (696)
    decrypt(blob, dims, iteration) = +mask-sum, two's-complement decode,
        / 2^precision / learners   (621-701)

Design: the online phase is pure uint32 ring arithmetic —
fixed-point encode, mask, and the server-side sum are jnp ops, and the
client-axis sum is psum-shardable (a jnp.sum over a mesh axis); only the
offline Paillier runs on host, in the native C++ kernel
(native/paillier.cpp). Wire format is raw little-endian uint32 arrays
rather than the reference's ASCII ';'-joined decimal strings (behavioral
parity only; ~10x smaller and zero-parse).

Caveats mirrored from the reference (documented, not silently fixed):
the ring wraps at 2^num_bits, so correctness needs
|sum_i fix(x_i)| < 2^(num_bits-1). The reference's dropout hole
(unmasking assumes ALL learners participated, PaillierUtils.cpp:692;
SURVEY §5.3) IS fixed here, beyond-reference: recoverRandomnessSubset +
decrypt(subset=...) re-derive the survivor-subset mask sum from the
retained encrypted offline blobs.
"""

from __future__ import annotations

import math
import os

import numpy as np
import jax
import jax.numpy as jnp

from ..native import paillier as paillier_mod
from .scheme import Scheme, register_scheme

_U32 = jnp.uint32


# ---------------------------------------------------------------------------
# Fixed-point ring codec (PaillierUtils.cpp:135-184) — jnp, on device
# ---------------------------------------------------------------------------

def fixed_point_encode(x: jnp.ndarray, num_bits: int,
                       precision_bits: int) -> jnp.ndarray:
    """f32 -> uint32 in the 2^num_bits two's-complement ring."""
    threshold = 1 << (num_bits - 1)
    scaled = jnp.round(x * (1 << precision_bits)).astype(jnp.int32)
    scaled = jnp.clip(scaled, -(threshold - 1), threshold - 1)
    return scaled.astype(_U32) & _U32((1 << num_bits) - 1)


def fixed_point_decode(v: jnp.ndarray, num_bits: int, precision_bits: int,
                       divide_by: int = 1) -> jnp.ndarray:
    """uint32 ring value -> f32 (two's complement, PaillierUtils 674-689)."""
    threshold = 1 << (num_bits - 1)
    ring = 1 << num_bits
    signed = jnp.where(v >= threshold, v.astype(jnp.int32) - ring,
                       v.astype(jnp.int32))
    return signed.astype(jnp.float32) / (1 << precision_bits) / divide_by


@jax.jit
def _mask_impl(fixed: jnp.ndarray, r: jnp.ndarray, mask: int):
    return (fixed - r) & _U32(mask)


@jax.jit
def _sum_masked_impl(stacked: jnp.ndarray, mask: int):
    """(K, n) uint32 -> (n,) sum mod 2^b. The client axis reduction — on a
    mesh this lowers to a psum (parallel/mesh.py pattern)."""
    return jnp.sum(stacked, axis=0, dtype=jnp.uint32) & _U32(mask)


# ---------------------------------------------------------------------------
# Paillier bit-packing (PaillierUtils.cpp:188-328 layout arithmetic)
# ---------------------------------------------------------------------------

def _packing_geometry(learners: int, num_bits: int, modulus_bits: int):
    bytes_per_num = (num_bits + 7) // 8
    extra_bits = (learners - 1) - (bytes_per_num * 8 - num_bits)
    extra_bytes = (extra_bits + 7) // 8 if extra_bits > 0 else 0
    total_bytes = bytes_per_num + extra_bytes
    nums_per_pt = (modulus_bits // 8) // total_bytes
    return total_bytes, nums_per_pt


def pack_values(vals: np.ndarray, learners: int, num_bits: int,
                modulus_bits: int) -> list[int]:
    """uint32 values -> big-int plaintexts, `nums_per_pt` per plaintext,
    each value in a total_bytes-wide big-endian slot (overflow padding
    sized for `learners` additions)."""
    total_bytes, nums_per_pt = _packing_geometry(learners, num_bits,
                                                 modulus_bits)
    n = len(vals)
    n_blocks = math.ceil(n / nums_per_pt)
    padded = np.zeros(n_blocks * nums_per_pt, dtype=np.uint64)
    padded[:n] = vals.astype(np.uint64)
    slots = padded.reshape(n_blocks, nums_per_pt)
    out = []
    shift = 8 * total_bytes
    for row in slots:
        acc = 0
        for v in row:
            acc = (acc << shift) | int(v)
        out.append(acc)
    return out


def unpack_values(blocks: list[int], n: int, learners: int, num_bits: int,
                  modulus_bits: int) -> np.ndarray:
    total_bytes, nums_per_pt = _packing_geometry(learners, num_bits,
                                                 modulus_bits)
    shift = 8 * total_bytes
    mask = (1 << shift) - 1
    vals = np.zeros(len(blocks) * nums_per_pt, dtype=np.uint64)
    i = 0
    for acc in blocks:
        row = []
        for _ in range(nums_per_pt):
            row.append(acc & mask)
            acc >>= shift
        vals[i:i + nums_per_pt] = row[::-1]
        i += nums_per_pt
    return vals[:n]


# ---------------------------------------------------------------------------
# Scheme
# ---------------------------------------------------------------------------

class Masking(Scheme):
    """Drop-in surface of the reference `Paillier : Scheme`
    (src/paillier.cpp:31-36 constructor signature)."""

    def __init__(self, scheme: str = "paillier", learners: int = 4,
                 modulus_bits: int = 2048, num_bits: int = 17,
                 precision_bits: int = 13,
                 cryptodir: str = "../resources/cryptoparams/",
                 randomnessdir: str = "../resources/random_params/"):
        super().__init__(scheme)
        self.learners = learners
        self.modulus_bits = modulus_bits
        self.num_bits = num_bits
        self.precision_bits = precision_bits
        self.cryptodir = cryptodir
        self.randomnessdir = randomnessdir
        self._ring_mask = (1 << num_bits) - 1
        self._ctx: paillier_mod.PaillierContext | None = None

    # -- keys (PaillierUtils hex persistence parity, cpp:86-129) ----------

    def _key_paths(self):
        return (os.path.join(self.cryptodir, "paillier-key-public.txt"),
                os.path.join(self.cryptodir, "paillier-key-private.txt"))

    def genCryptoContextAndKeyGen(self) -> int:
        os.makedirs(self.cryptodir, exist_ok=True)
        pk, sk = paillier_mod.keygen(self.modulus_bits)
        pub_p, prv_p = self._key_paths()
        with open(pub_p, "w") as f:
            f.write(pk.to_hex())
        with open(prv_p, "w") as f:
            f.write(sk.to_hex())
        self._ctx = paillier_mod.PaillierContext(pk, sk)
        return 1

    def loadCryptoParams(self) -> None:
        pub_p, prv_p = self._key_paths()
        with open(pub_p) as f:
            pk = paillier_mod.PaillierPublicKey.from_hex(
                f.read().strip(), bits=self.modulus_bits)
        sk = None
        if os.path.exists(prv_p):
            with open(prv_p) as f:
                sk = paillier_mod.PaillierSecretKey.from_hex(f.read().strip())
        self._ctx = paillier_mod.PaillierContext(pk, sk)

    # -- offline phase ----------------------------------------------------

    def _rand_path(self, iteration: int, name: str) -> str:
        d = os.path.join(self.randomnessdir, str(iteration))
        os.makedirs(d, exist_ok=True)
        return os.path.join(d, name)

    def genPaillierRandOffline(self, params: int, iteration: int) -> bytes:
        """Draw + persist one-time-pad randomness; return it packed and
        Paillier-encrypted (getEncryptedRandomness, cpp:705-760)."""
        assert self._ctx is not None, "loadCryptoParams first"
        raw = np.frombuffer(os.urandom(4 * params), dtype="<u4")
        r = (raw & self._ring_mask).astype(np.uint32)
        np.save(self._rand_path(iteration, "learner_rand.npy"), r)
        blocks = pack_values(r, self.learners, self.num_bits,
                             self.modulus_bits)
        cts = self._ctx.encrypt(blocks)
        return self._ctx.ct_to_bytes(cts)

    def addPaillierRandOffline(self, blobs: list[bytes]) -> bytes:
        """Aggregator: homomorphic sum of encrypted randomness."""
        assert self._ctx is not None
        acc = self._ctx.ct_from_bytes(blobs[0])
        for b in blobs[1:]:
            acc = self._ctx.add(acc, self._ctx.ct_from_bytes(b))
        return self._ctx.ct_to_bytes(acc)

    def decryptRandomnessSum(self, blob: bytes, params: int,
                             iteration: int,
                             subset: list[int] | None = None) -> None:
        """Key-holder: decrypt mask sum, persist for unmasking.

        `subset` names the participating learner indices when the sum was
        re-computed over a survivor subset (dropout recovery, see
        recover below); the file is suffixed so the full-cohort sum is
        kept alongside."""
        assert self._ctx is not None and self._ctx.sk is not None
        blocks = self._ctx.decrypt(self._ctx.ct_from_bytes(blob))
        vals = unpack_values(blocks, params, self.learners, self.num_bits,
                             self.modulus_bits)
        r_sum = (vals & self._ring_mask).astype(np.uint32)
        np.save(self._rand_path(iteration, self._sum_name(subset)), r_sum)

    @staticmethod
    def _sum_name(subset: list[int] | None) -> str:
        if subset is None:
            return "learner_rand_sum.npy"
        tag = "_".join(str(i) for i in sorted(subset))
        return f"learner_rand_sum_s{tag}.npy"

    def recoverRandomnessSubset(self, blobs: list[bytes], params: int,
                                iteration: int, subset: list[int]) -> None:
        """Client-dropout recovery — a capability the reference's protocol
        lacks (unmaskParams assumes ALL learners present,
        PaillierUtils.cpp:692; SURVEY §5.3 calls this out as a real gap of
        mask-based aggregation). The aggregator retains each learner's
        Paillier-ENCRYPTED offline randomness blob, so when only `subset`
        participates online it re-sums exactly those blobs homomorphically
        and the key-holder decrypts that subset sum; unmasking then uses
        it via decrypt(..., subset=...). No learner interaction is needed
        at recovery time — dropout costs one extra Paillier add/decrypt
        round on the host, nothing on the device online path."""
        sub_blob = self.addPaillierRandOffline([blobs[i] for i in subset])
        self.decryptRandomnessSum(sub_blob, params, iteration, subset=subset)

    # -- online phase ------------------------------------------------------

    def encrypt(self, data: np.ndarray, iteration: int = 0) -> bytes:
        """Mask: (fix(x) - r) mod 2^b (maskParams, cpp:499-551)."""
        r = np.load(self._rand_path(iteration, "learner_rand.npy"))
        x = jnp.asarray(np.asarray(data, dtype=np.float32).reshape(-1))
        fixed = fixed_point_encode(x, self.num_bits, self.precision_bits)
        masked = _mask_impl(fixed, jnp.asarray(r[:x.size]), self._ring_mask)
        return np.asarray(masked).astype("<u4").tobytes()

    def computeWeightedAverage(self, learner_data: list[bytes],
                               scaling_factors: list[float] | None = None,
                               params: int | None = None) -> bytes:
        """Sum masked ints mod 2^b (sumMaskedParams, cpp:555-616). Uniform
        average only — scaling_factors are validated for count parity but
        the protocol averages by learner count, like the reference."""
        if scaling_factors is not None and \
                len(scaling_factors) != len(learner_data):
            raise ValueError(
                "Error: learner_data and scaling_factors size mismatch")
        stacked = jnp.asarray(np.stack(
            [np.frombuffer(b, dtype="<u4") for b in learner_data]))
        out = _sum_masked_impl(stacked, self._ring_mask)
        return np.asarray(out).astype("<u4").tobytes()

    def decrypt(self, data: bytes, data_dimensions: int,
                iteration: int = 0,
                subset: list[int] | None = None) -> np.ndarray:
        """Unmask + decode (unmaskParams, cpp:621-701). With `subset`,
        unmasks a survivor-subset round using the sum persisted by
        recoverRandomnessSubset and averages over the survivors."""
        r_sum = np.load(self._rand_path(iteration, self._sum_name(subset)))
        v = np.frombuffer(data, dtype="<u4")[:data_dimensions]
        unmasked = (v + r_sum[:data_dimensions]) & self._ring_mask
        out = fixed_point_decode(jnp.asarray(unmasked), self.num_bits,
                                 self.precision_bits,
                                 divide_by=(self.learners if subset is None
                                            else len(subset)))
        return np.asarray(out, dtype=np.float64)


register_scheme("paillier")(Masking)
register_scheme("masking")(Masking)

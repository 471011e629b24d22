"""User-facing CKKS scheme — drop-in API surface of the reference binding.

    from fhe_fed_tpu import CKKS
    helper = CKKS()                        # "ckks", 4096, 52, cryptodir
    helper.genCryptoContextAndKeyGen()
    helper.loadCryptoParams()
    ct = helper.encrypt(flat_np_array)
    agg = helper.computeWeightedAverage([ct1, ct2, ct3], [0.5, 0.2, 0.3])
    out = helper.decrypt(agg, dims)

Defaults and method names mirror PYBIND11_MODULE(SHELFI_FHE)
(binding.cpp:19-31): CKKS("ckks", batchSize=4096, scaleFactorBits=52,
cryptodir="../resources/cryptoparams/"). Key material persists to
cryptodir/{cryptocontext.txt, key-public.txt, key-private.txt}, matching
genCryptoContextAndKeyGen / loadCryptoParams file behavior
(ckks.cpp:25-59, 11-23) — contents are this framework's own wire format
(PALISADE blobs are not interoperable; parity is behavioral).

Chunking follows ckks.cpp:65 (cipherSize = ceil(size / batchSize)) and the
decrypt tail rule (ckks.cpp:192-196). `dense_pack=True` additionally packs
the full ring (2x batch) per chunk — which the reference does not offer
(halves ciphertext count and bytes).

`packing` selects the plaintext encoding:
  * "coeff" (default) — exact-integer coefficient packing
    (ckks/encoding.py). Correct and exact for everything the FedAvg
    protocol computes (EvalAdd + scalar EvalMult, ckks.cpp:286-298).
  * "slots" — canonical-embedding slot packing (ckks/slots.py), the
    reference's MakeCKKSPackedPlaintext semantics (ckks.cpp:80): N/2
    slots per ciphertext on which EvalMult(ct, ct) acts elementwise and
    Galois rotations act as cyclic shifts. Same wire format, same
    aggregation kernels; encode/decode run host-side f64.
"""

from __future__ import annotations

import json
import os
import secrets

import numpy as np
import jax
import jax.numpy as jnp

from ..ckks import params as ckks_params
from ..ckks import keys as ckks_keys
from ..ckks import ops as ckks_ops
from ..ckks import serial as ckks_serial
from .scheme import Scheme, register_scheme

_CTX_FILE = "cryptocontext.txt"
_PK_FILE = "key-public.txt"
_SK_FILE = "key-private.txt"


@register_scheme("ckks")
class CKKS(Scheme):
    def __init__(self, scheme: str = "ckks", batchSize: int = 4096,
                 scaleFactorBits: int = 52,
                 cryptodir: str = "../resources/cryptoparams/",
                 mult_depth: int = 1, dense_pack: bool = False,
                 symmetric: bool = False, seeded_fresh: bool = False,
                 seed: int | None = None, packing: str = "coeff"):
        super().__init__(scheme)
        self.batchSize = int(batchSize)
        self.scaleFactorBits = int(scaleFactorBits)
        self.cryptodir = cryptodir
        self.mult_depth = int(mult_depth)
        self.dense_pack = bool(dense_pack)
        if packing not in ("coeff", "slots"):
            raise ValueError(f"unknown packing {packing!r}")
        if packing == "slots" and dense_pack:
            raise ValueError("dense_pack packs coefficients; a slot-packed "
                             "ciphertext has exactly N/2 slots")
        if packing == "slots" and (symmetric or seeded_fresh):
            raise ValueError(
                "symmetric/seeded_fresh are coefficient-mode encrypt "
                "optimizations; slot packing always takes the "
                "reference-shaped public-key path")
        self.packing = packing
        # symmetric=True: secret-key RLWE encryption (1 NTT batch instead of
        # 4). Identical ciphertexts/noise; valid because every learner holds
        # sk in this protocol (they decrypt — ckks.cpp:11-23,189).
        self.symmetric = bool(symmetric)
        # seeded_fresh=True (implies symmetric): client uploads carry
        # (c0, 128-bit seed) instead of (c0, c1) — HALF the wire bytes; the
        # server expands c1 = -PRG(seed) on arrival (ops.SeededCiphertext).
        # computeWeightedAverage accepts both formats regardless.
        self.seeded_fresh = bool(seeded_fresh)
        if self.seeded_fresh:
            self.symmetric = True
        self._params = ckks_params.make_params(
            batch=self.batchSize, scale_bits=self.scaleFactorBits,
            mult_depth=self.mult_depth)
        self._ctx = None
        self._sk = None
        self._pk = None
        # Encrypt-side sampling PRNG, the same on every backend (threefry
        # measured no slower than rbg on the GPU, PERF.md).
        self._rng = jax.random.key(
            secrets.randbits(63) if seed is None else seed,
            impl="threefry2x32")

    # -- context / key lifecycle ------------------------------------------

    @property
    def ctx(self) -> ckks_params.CkksContext:
        if self._ctx is None:
            self._ctx = ckks_params.make_context(self._params)
        return self._ctx

    @property
    def capacity(self) -> int:
        """Values packed per ciphertext chunk."""
        if self.packing == "slots":
            return self._params.ring_dim // 2
        return self._params.ring_dim if self.dense_pack else self.batchSize

    def genCryptoContextAndKeyGen(self) -> int:
        """Generate context + keys and persist them (ckks.cpp:25-59)."""
        ctx = self.ctx
        sk, pk = ckks_keys.keygen(
            ctx, seed=int(jax.random.bits(self._next_key(), (), jnp.uint32)))
        self._sk, self._pk = sk, pk
        os.makedirs(self.cryptodir, exist_ok=True)
        meta = dict(scheme="ckks", batchSize=self.batchSize,
                    scaleFactorBits=self.scaleFactorBits,
                    mult_depth=self.mult_depth,
                    ring_dim=self._params.ring_dim,
                    moduli=list(self._params.moduli),
                    num_base=self._params.num_base)
        with open(os.path.join(self.cryptodir, _CTX_FILE), "w") as f:
            json.dump(meta, f)
        with open(os.path.join(self.cryptodir, _PK_FILE), "wb") as f:
            f.write(ckks_serial.serialize_public_key(ctx, pk))
        with open(os.path.join(self.cryptodir, _SK_FILE), "wb") as f:
            f.write(ckks_serial.serialize_secret_key(ctx, sk))
        return 1

    def loadCryptoParams(self) -> None:
        """Load persisted context + keys (ckks.cpp:11-23)."""
        with open(os.path.join(self.cryptodir, _CTX_FILE)) as f:
            meta = json.load(f)
        if (meta["batchSize"] != self.batchSize
                or meta["scaleFactorBits"] != self.scaleFactorBits):
            raise ValueError("persisted crypto context does not match "
                             "constructor parameters")
        with open(os.path.join(self.cryptodir, _PK_FILE), "rb") as f:
            self._pk = ckks_serial.deserialize_public_key(f.read())
        with open(os.path.join(self.cryptodir, _SK_FILE), "rb") as f:
            self._sk = ckks_serial.deserialize_secret_key(f.read())

    def load_or_gen(self) -> None:
        try:
            self.loadCryptoParams()
        except (FileNotFoundError, ValueError):
            self.genCryptoContextAndKeyGen()

    def _next_key(self):
        self._rng, k = jax.random.split(self._rng)
        return k

    # -- data path ---------------------------------------------------------

    def _pack(self, flat: np.ndarray) -> jnp.ndarray:
        """flat (size,) -> (chunks, N) f32 with zeros in unused positions.
        In slot mode: (chunks, N/2) f64 host slots (encoded at encrypt)."""
        cap = self.capacity
        size = flat.size
        chunks = max(1, -(-size // cap))
        if self.packing == "slots":
            buf = np.zeros((chunks, cap), dtype=np.float64)
            buf.reshape(-1)[:size] = flat.astype(np.float64, copy=False)
            return buf
        n = self._params.ring_dim
        buf = np.zeros((chunks, n), dtype=np.float32)
        payload = buf[:, :cap].reshape(-1)
        payload[:size] = flat.astype(np.float32, copy=False)
        buf[:, :cap] = payload.reshape(chunks, cap)
        return jnp.asarray(buf)

    def _unpack(self, vals: np.ndarray, dims: int) -> np.ndarray:
        cap = self.capacity
        return vals[:, :cap].reshape(-1)[:dims].astype(np.float64)

    def encrypt(self, data_array) -> bytes:
        """Encrypt a flat float vector -> ciphertext bytes (ckks.cpp:61-104)."""
        if self._pk is None:
            raise RuntimeError("call loadCryptoParams() or "
                               "genCryptoContextAndKeyGen() first")
        flat = np.asarray(data_array).reshape(-1)
        if self.packing == "slots":
            # MakeCKKSPackedPlaintext semantics (ckks.cpp:80): host-side
            # canonical-embedding encode, then the standard pk encrypt.
            # (The symmetric/seeded fast paths are coefficient-mode
            # optimizations; slot mode always takes the reference-shaped
            # pk path.)
            from ..ckks import slots as ckks_slots
            pt = ckks_slots.encode_slots(self.ctx, self._pack(flat))
            ct = ckks_ops.encrypt_encoded(self.ctx, self._pk, pt,
                                          self._next_key(),
                                          self._params.scale)
            return ckks_serial.serialize_ct(self.ctx, ct, packing="slots")
        if self.seeded_fresh and self._sk is not None:
            sct = ckks_ops.encrypt_symmetric_seeded(
                self.ctx, self._sk, self._pack(flat), self._next_key())
            return ckks_serial.serialize_seeded_ct(self.ctx, sct)
        if self.symmetric and self._sk is not None:
            ct = ckks_ops.encrypt_symmetric(self.ctx, self._sk,
                                            self._pack(flat), self._next_key())
        else:
            ct = ckks_ops.encrypt(self.ctx, self._pk, self._pack(flat),
                                  self._next_key())
        return ckks_serial.serialize_ct(self.ctx, ct)

    def computeWeightedAverage(self, learner_data: list[bytes],
                               scaling_factors: list[float]) -> bytes:
        """Fused encrypted weighted average (ckks.cpp:264-320)."""
        if len(learner_data) != len(scaling_factors):
            raise ValueError(
                "Error: learner_data and scaling_factors size mismatch")
        cts = [ckks_serial.deserialize_any_ct(self.ctx, b,
                                              packing=self.packing)
               for b in learner_data]
        agg = ckks_ops.weighted_sum(self.ctx, cts,
                                    [float(s) for s in scaling_factors])
        return ckks_serial.serialize_ct(self.ctx, agg,
                                        packing=self.packing)

    def decrypt(self, learner_data: bytes, data_dimensions: int) -> np.ndarray:
        """Decrypt ciphertext bytes -> float64 vector of `data_dimensions`
        (ckks.cpp:170-213 incl. tail-length rule)."""
        if self._sk is None:
            raise RuntimeError("call loadCryptoParams() first")
        ct = ckks_serial.deserialize_ct(self.ctx, learner_data,
                                        packing=self.packing)
        if self.packing == "slots":
            from ..ckks import slots as ckks_slots
            res = ckks_ops.decrypt_residues(self.ctx, self._sk, ct)
            z = ckks_slots.decode_slots(self.ctx, np.asarray(res), ct.scale)
            return z.real.reshape(-1)[:int(data_dimensions)]
        vals = np.asarray(ckks_ops.decrypt(self.ctx, self._sk, ct))
        return self._unpack(vals, int(data_dimensions))

    # -- cohort fast path ----------------------------------------------------
    #
    # The bytes methods above are the wire-parity surface (one blob per
    # client, matching ckks.cpp:61-104/264-320 semantics). In a co-located
    # aggregation pod, the per-client dispatch + host serialize/deserialize
    # round-trip is pure overhead (SURVEY.md §7: "the reference's per-key
    # Python loop is exactly what we must not replicate"). The cohort path
    # keeps the whole round device-resident: ONE dispatch encrypts all K
    # clients, ONE fused kernel aggregates, ONE dispatch decrypts.

    def _pack_cohort(self, client_vectors) -> jnp.ndarray:
        """K flat vectors (same size) -> (K, chunks, N) f32."""
        n = self._params.ring_dim
        cap = self.capacity
        flats = [np.asarray(v).reshape(-1) for v in client_vectors]
        size = flats[0].size
        assert all(f.size == size for f in flats), "cohort sizes differ"
        chunks = max(1, -(-size // cap))
        buf = np.zeros((len(flats), chunks, n), dtype=np.float32)
        pay = buf[:, :, :cap].reshape(len(flats), -1)
        for i, f in enumerate(flats):
            pay[i, :size] = f.astype(np.float32, copy=False)
        buf[:, :, :cap] = pay.reshape(len(flats), chunks, cap)
        return jnp.asarray(buf)

    def pack_cohort(self, client_vectors) -> jnp.ndarray:
        """Stage K clients' flat vectors on-device as (K, chunks, N) f32 —
        the host-side prep the reference does outside its encrypt timer too
        (tensor_to_numpy_arr flatten, benchmark_crypto.py:159 vs :183)."""
        return self._pack_cohort(client_vectors)

    def encrypt_cohort(self, client_vectors) -> ckks_ops.Ciphertext:
        """Encrypt all K clients' flat vectors in ONE device dispatch.
        Accepts a list of host vectors or a pre-staged pack_cohort() array.
        Returns a device-resident batched Ciphertext (K, chunks, 2, L, N)."""
        if self._pk is None and self._sk is None:
            raise RuntimeError("call loadCryptoParams() or "
                               "genCryptoContextAndKeyGen() first")
        if self.packing == "slots":
            raise ValueError(
                "the cohort fast path is coefficient-packed; slot packing "
                "serves the reference-parity bytes surface "
                "(encrypt/computeWeightedAverage/decrypt)")
        if isinstance(client_vectors, jnp.ndarray) and \
                client_vectors.ndim == 3:
            stacked = client_vectors
        else:
            stacked = self._pack_cohort(client_vectors)
        if self.symmetric and self._sk is not None:
            return ckks_ops.encrypt_symmetric_stacked(
                self.ctx, self._sk, stacked, self._next_key())
        return ckks_ops.encrypt_stacked(self.ctx, self._pk, stacked,
                                        self._next_key())

    def aggregate_cohort(self, cohort_ct: ckks_ops.Ciphertext,
                         scaling_factors: list[float]) -> ckks_ops.Ciphertext:
        """Fused encrypted weighted average of a batched cohort ciphertext
        (ckks.cpp:264-320 semantics, no bytes round-trip)."""
        return ckks_ops.weighted_sum(self.ctx, cohort_ct,
                                     [float(s) for s in scaling_factors])

    def decrypt_cohort(self, ct: ckks_ops.Ciphertext,
                       data_dimensions: int | None = None, *,
                       raw: bool = False):
        """Decrypt a device-resident ciphertext. raw=True returns the
        decoded (chunks, N) f32 array still on device (no host transfer);
        otherwise returns the unpacked flat np.ndarray of length
        data_dimensions."""
        if self._sk is None:
            raise RuntimeError("call loadCryptoParams() first")
        dev = ckks_ops.decrypt(self.ctx, self._sk, ct)
        if raw:
            return dev
        return self._unpack(np.asarray(dev), int(data_dimensions))

    def unpack_values(self, dev_values, data_dimensions: int) -> np.ndarray:
        """Host fetch + payload unpack of a raw decrypt_cohort result."""
        return self._unpack(np.asarray(dev_values), int(data_dimensions))

    def ct_wire_bytes(self, ct: ckks_ops.Ciphertext,
                      per_client: bool = False) -> int:
        """Serialized size of `ct` without materializing the bytes. For a
        batched cohort ct, per_client=True reports one client's upload."""
        data = ct.data
        if data.ndim == 5:
            k = data.shape[0]
            one = data.nbytes // k + ckks_serial.CT_HEADER_BYTES
            return one if per_client else k * one
        return data.nbytes + ckks_serial.CT_HEADER_BYTES

    def _round_slice(self, packed: jnp.ndarray, scaling_factors,
                     fused: bool):
        """encrypt -> aggregate -> decrypt of one (K, chunks, N) slice.
        fused=True runs all three as ONE XLA computation
        (ckks_ops.fedavg_round_fused) — the deployment shape, paying
        dispatch latency once per round instead of once per phase."""
        if fused and self.symmetric and self._sk is not None:
            return ckks_ops.fedavg_round_fused(
                self.ctx, self._sk, packed, self._next_key(),
                [float(s) for s in scaling_factors])
        ct = self.encrypt_cohort(packed)
        agg = self.aggregate_cohort(ct, scaling_factors)
        return self.decrypt_cohort(agg, raw=True)

    def fedavg_round(self, client_vectors, scaling_factors,
                     data_dimensions: int | None = None,
                     max_chunks: int | None = 1024,
                     fused: bool = True) -> np.ndarray:
        """One full secure-FedAvg round, device-resident end to end.

        By default each slice runs as ONE fused XLA computation (see
        _round_slice; fused=False restores the three-dispatch staged path,
        and the pk-encryption mode always stages).

        max_chunks bounds device memory for BERT-scale models (SURVEY.md
        §7 host<->device feed: 26k chunks would need >12 GB of ciphertext
        plus encrypt intermediates in one dispatch): the chunk axis is
        padded to a multiple of max_chunks and streamed slice by slice
        through encrypt -> aggregate -> decrypt, so exactly ONE program
        shape is compiled and peak memory is ~5x one slice's ciphertext.
        The default (1024) keeps any model size within a few GB of device
        memory; pass None to force a single dispatch."""
        if self.packing == "slots":
            raise ValueError(
                "fedavg_round is coefficient-packed; slot packing serves "
                "the reference-parity bytes surface")
        dims = (int(data_dimensions) if data_dimensions is not None
                else int(np.asarray(client_vectors[0]).size))
        packed = client_vectors if (
            isinstance(client_vectors, jnp.ndarray)
            and client_vectors.ndim == 3) else self._pack_cohort(
                client_vectors)
        chunks = packed.shape[1]
        if max_chunks is None or chunks <= max_chunks:
            dev = self._round_slice(packed, scaling_factors, fused)
            return self._unpack(np.asarray(dev), dims)
        pad = (-chunks) % max_chunks
        if pad:
            packed = jnp.pad(packed, ((0, 0), (0, pad), (0, 0)))
        outs = []
        for s in range(0, chunks + pad, max_chunks):
            dev = self._round_slice(packed[:, s:s + max_chunks],
                                    scaling_factors, fused)
            outs.append(np.asarray(dev))
        return self._unpack(np.concatenate(outs, axis=0), dims)

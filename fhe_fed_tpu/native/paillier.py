"""Paillier cryptosystem over the native C++ kernel (see paillier.cpp).

Key generation and all division-requiring precomputation run here in
Python integers (one-time, not hot); batch encrypt / homomorphic-sum /
decrypt dispatch to the OpenMP C++ kernels through ctypes.

Reference parity: libpaillier keygen/enc/dec/mul
(reference palisade_pybind/SHELFI_FHE/src/paillier.c:58-195) and the hex
key import/export (PaillierUtils.cpp:86-129).
"""

from __future__ import annotations

import ctypes
import dataclasses
import os
import secrets
import subprocess

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "paillier.cpp")
_LIB = os.path.join(_DIR, "libpaillier.so")

_lib = None


def _build_lib():
    cmd = ["g++", "-O2", "-fopenmp", "-shared", "-fPIC", _SRC, "-o", _LIB]
    subprocess.run(cmd, check=True, capture_output=True)


def load_lib() -> ctypes.CDLL:
    """Build (if needed) and load the native kernel library."""
    global _lib
    if _lib is not None:
        return _lib
    if (not os.path.exists(_LIB)
            or os.path.getmtime(_LIB) < os.path.getmtime(_SRC)):
        _build_lib()
    lib = ctypes.CDLL(_LIB)
    U64P = ctypes.POINTER(ctypes.c_uint64)
    lib.paillier_encrypt_batch.argtypes = [
        U64P, U64P, U64P, U64P, ctypes.c_uint64, ctypes.c_int,
        U64P, U64P, ctypes.c_int, U64P]
    lib.paillier_mul_batch.argtypes = [
        U64P, U64P, ctypes.c_uint64, ctypes.c_int,
        U64P, U64P, ctypes.c_int, U64P]
    lib.paillier_decrypt_batch.argtypes = [
        U64P, U64P, U64P, ctypes.c_uint64,
        U64P, U64P, U64P, ctypes.c_uint64,
        U64P, U64P, U64P, ctypes.c_int, U64P, ctypes.c_int, U64P]
    lib.paillier_num_threads.restype = ctypes.c_int
    lib.paillier_set_threads.argtypes = [ctypes.c_int]
    lib.paillier_set_threads.restype = None
    _lib = lib
    return lib


def num_threads() -> int:
    """OpenMP thread count the native kernels will use."""
    return int(load_lib().paillier_num_threads())


def set_threads(n: int) -> None:
    """Pin the native kernels' OpenMP thread count (scaling benches)."""
    load_lib().paillier_set_threads(int(n))


# ---------------------------------------------------------------------------
# Limb conversion helpers
# ---------------------------------------------------------------------------

def _to_limbs(x: int, k: int) -> np.ndarray:
    out = np.zeros(k, dtype=np.uint64)
    for i in range(k):
        out[i] = x & 0xFFFFFFFFFFFFFFFF
        x >>= 64
    assert x == 0, "value too large for limb width"
    return out


def _from_limbs(a: np.ndarray) -> int:
    x = 0
    for i in range(len(a) - 1, -1, -1):
        x = (x << 64) | int(a[i])
    return x


def _batch_to_limbs(xs: list[int], k: int) -> np.ndarray:
    out = np.zeros((len(xs), k), dtype=np.uint64)
    for j, x in enumerate(xs):
        for i in range(k):
            out[j, i] = x & 0xFFFFFFFFFFFFFFFF
            x >>= 64
        assert x == 0
    return out


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))


# ---------------------------------------------------------------------------
# Key generation (Python ints; one-time)
# ---------------------------------------------------------------------------

_SMALL_PRIMES = [3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43, 47, 53,
                 59, 61, 67, 71, 73, 79, 83, 89, 97]


def _is_probable_prime(n: int, rounds: int = 40) -> bool:
    if n < 2:
        return False
    for p in _SMALL_PRIMES:
        if n % p == 0:
            return n == p
    d, r = n - 1, 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for _ in range(rounds):
        a = secrets.randbelow(n - 3) + 2
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(r - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


def _random_prime(bits: int) -> int:
    while True:
        c = secrets.randbits(bits) | (1 << (bits - 1)) | 1
        if _is_probable_prime(c):
            return c


@dataclasses.dataclass
class PaillierPublicKey:
    n: int
    bits: int

    @property
    def n_sq(self) -> int:
        return self.n * self.n

    def to_hex(self) -> str:
        return format(self.n, "x")

    @classmethod
    def from_hex(cls, h: str, bits: int | None = None):
        n = int(h, 16)
        return cls(n=n, bits=bits or n.bit_length())


@dataclasses.dataclass
class PaillierSecretKey:
    lam: int       # lcm(p-1, q-1)
    mu: int        # (L(g^lam mod n^2))^-1 mod n; with g = n+1 this is
                   # lam^-1 mod n

    def to_hex(self) -> str:
        return format(self.lam, "x") + ":" + format(self.mu, "x")

    @classmethod
    def from_hex(cls, h: str):
        a, b = h.split(":")
        return cls(lam=int(a, 16), mu=int(b, 16))

    @classmethod
    def from_reference_hex(cls, h: str, n: int):
        """Import libpaillier's hex format: lambda ONLY
        (paillier_prvkey_to_hex, reference paillier.c:304-306). With
        g = n + 1 (paillier.c:45), L(g^lam mod n^2) = lam mod n, so
        mu = lam^-1 mod n is derived rather than stored."""
        lam = int(h.strip(), 16)
        return cls(lam=lam, mu=pow(lam, -1, n))


def keygen(bits: int = 2048) -> tuple[PaillierPublicKey, PaillierSecretKey]:
    """Textbook Paillier keygen with g = n + 1 (paillier.c:58-114)."""
    while True:
        p = _random_prime(bits // 2)
        q = _random_prime(bits // 2)
        if p != q:
            n = p * q
            if n.bit_length() == bits:
                break
    lam = (p - 1) * (q - 1) // __import__("math").gcd(p - 1, q - 1)
    mu = pow(lam, -1, n)
    return PaillierPublicKey(n=n, bits=bits), PaillierSecretKey(lam=lam,
                                                                mu=mu)


# ---------------------------------------------------------------------------
# Context: precomputed constants for the native kernels
# ---------------------------------------------------------------------------

class PaillierContext:
    """Precomputes every modular constant the C++ kernels need."""

    def __init__(self, pk: PaillierPublicKey,
                 sk: PaillierSecretKey | None = None):
        self.pk = pk
        self.sk = sk
        n = pk.n
        self.k = (pk.bits + 63) // 64
        k, k2 = self.k, 2 * self.k
        n2 = n * n
        R2 = 1 << (64 * k2)
        Rn = 1 << (64 * k)
        self._n = _to_limbs(n, k)
        self._n2 = _to_limbs(n2, k2)
        self._n2_rr = _to_limbs(R2 * R2 % n2, k2)
        self._n2_one = _to_limbs(R2 % n2, k2)
        self._n2_m0inv = ctypes.c_uint64((-pow(n2, -1, 1 << 64)) % (1 << 64))
        self._n_rr = _to_limbs(Rn * Rn % n, k)
        self._n_one = _to_limbs(Rn % n, k)
        self._n_m0inv = ctypes.c_uint64((-pow(n, -1, 1 << 64)) % (1 << 64))
        self._n_hensel = _to_limbs(pow(n, -1, Rn), k)
        if sk is not None:
            self._lambda = _to_limbs(sk.lam, k)
            self._mu = _to_limbs(sk.mu, k)
        self.lib = load_lib()

    # -- batch ops ---------------------------------------------------------

    def encrypt(self, msgs: list[int], rng=secrets) -> np.ndarray:
        """Returns (count, 2k) uint64 ciphertext limb array."""
        k, k2 = self.k, 2 * self.k
        n = self.pk.n
        rands = [rng.randbelow(n - 1) + 1 if hasattr(rng, "randbelow")
                 else int(rng.integers(1, n)) for _ in msgs]
        m = _batch_to_limbs(msgs, k)
        r = _batch_to_limbs(rands, k)
        out = np.zeros((len(msgs), k2), dtype=np.uint64)
        self.lib.paillier_encrypt_batch(
            _ptr(self._n), _ptr(self._n2), _ptr(self._n2_rr),
            _ptr(self._n2_one), self._n2_m0inv, self.k,
            _ptr(m), _ptr(r), len(msgs), _ptr(out))
        return out

    def add(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        """Homomorphic addition: ciphertext product mod n^2."""
        assert a.shape == b.shape
        out = np.zeros_like(a)
        self.lib.paillier_mul_batch(
            _ptr(self._n2), _ptr(self._n2_rr), self._n2_m0inv, self.k,
            _ptr(np.ascontiguousarray(a)), _ptr(np.ascontiguousarray(b)),
            a.shape[0], _ptr(out))
        return out

    def decrypt(self, cts: np.ndarray) -> list[int]:
        assert self.sk is not None, "secret key required"
        out = np.zeros((cts.shape[0], self.k), dtype=np.uint64)
        self.lib.paillier_decrypt_batch(
            _ptr(self._n), _ptr(self._n_rr), _ptr(self._n_one),
            self._n_m0inv,
            _ptr(self._n2), _ptr(self._n2_rr), _ptr(self._n2_one),
            self._n2_m0inv,
            _ptr(self._n_hensel), _ptr(self._lambda), _ptr(self._mu),
            self.k, _ptr(np.ascontiguousarray(cts)), cts.shape[0],
            _ptr(out))
        return [_from_limbs(row) for row in out]

    # -- int <-> bytes wire helpers ---------------------------------------

    def ct_to_bytes(self, cts: np.ndarray) -> bytes:
        return cts.astype("<u8").tobytes()

    def ct_from_bytes(self, raw: bytes) -> np.ndarray:
        k2 = 2 * self.k
        a = np.frombuffer(raw, dtype="<u8")
        return a.reshape(-1, k2).copy()

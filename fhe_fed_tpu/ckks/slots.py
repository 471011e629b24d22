"""Canonical-embedding ("slot") packing for ct x ct / rotation workloads.

The FedAvg hot path uses exact coefficient packing (encoding.py) because its
only ops are addition and scalar multiplication. Slot packing makes
EvalMult(ct, ct) act as elementwise multiplication over N/2 complex slots
and Galois rotations act as cyclic slot shifts — the full
MakeCKKSPackedPlaintext semantics (reference ckks.cpp:80, mkhe.cpp:341-366).

Encode/decode run HOST-SIDE in numpy float64: packing happens at the
client boundary next to data loading (exactly where the reference's CPU
encode runs), so this is not on the device hot path; the device only sees
integer residues. f64 FFT precision (~2**-52 relative) is below CKKS noise
at every parameter point the reference uses.

Layout. Slot j holds m(zeta**e_j) with zeta = exp(i*pi/N), e_j = 5**j mod
2N, j = 0..N/2-1; the conjugate slots at -e_j carry conj(z_j) so the
polynomial is real. Rotation by r (galois element g = 5**r) maps slot j ->
z_{j+r} (left rotation); g = 2N-1 conjugates every slot.
"""

from __future__ import annotations

import functools

import numpy as np
import jax.numpy as jnp

from .params import CkksContext

__all__ = ["num_slots", "encode_slots", "decode_slots", "slot_rotation_map"]


def num_slots(ctx: CkksContext) -> int:
    return ctx.ring_dim // 2


@functools.lru_cache(maxsize=None)
def _slot_exponents(n: int) -> np.ndarray:
    """e_j = 5**j mod 2N for j = 0..N/2-1."""
    two_n = 2 * n
    e = np.empty(n // 2, dtype=np.int64)
    cur = 1
    for j in range(n // 2):
        e[j] = cur
        cur = cur * 5 % two_n
    return e


def _embed_inverse(z: np.ndarray, n: int) -> np.ndarray:
    """Complex slots (..., N/2) -> real coefficients (..., N) with
    m(zeta**e_j) = z_j (f64)."""
    two_n = 2 * n
    e = _slot_exponents(n)
    V = np.zeros(z.shape[:-1] + (two_n,), dtype=np.complex128)
    V[..., e] = z
    V[..., (two_n - e) % two_n] = np.conj(z)
    c_pad = np.fft.fft(V, axis=-1) / two_n
    # Odd-frequency support implies c_pad[k+N] == -c_pad[k]: fold exactly.
    return 2.0 * np.real(c_pad[..., :n])


def _embed_forward(c: np.ndarray, n: int) -> np.ndarray:
    """Real coefficients (..., N) -> complex slots (..., N/2) (f64)."""
    two_n = 2 * n
    e = _slot_exponents(n)
    c_pad = np.zeros(c.shape[:-1] + (two_n,), dtype=np.float64)
    c_pad[..., :n] = c
    spec = np.fft.ifft(c_pad, axis=-1) * two_n
    return spec[..., e]


def encode_slots(ctx: CkksContext, z: np.ndarray,
                 scale: float | None = None) -> jnp.ndarray:
    """Slots (..., N/2) real/complex -> residues (..., chain, N) uint32,
    coefficient order (device-ready; feed to the same encrypt path)."""
    n = ctx.ring_dim
    scale = float(ctx.params.scale if scale is None else scale)
    z = np.asarray(z)
    assert z.shape[-1] == n // 2, (z.shape, n // 2)
    c = _embed_inverse(z.astype(np.complex128), n)
    c_int = np.rint(c * scale).astype(np.int64)
    chain = ctx.params.chain_len
    qs = np.array(ctx.params.moduli[:chain], dtype=np.int64)
    res = c_int[..., None, :] % qs[:, None]                # negatives wrap
    return jnp.asarray(res.astype(np.uint32))


def decode_slots(ctx: CkksContext, residues, scale: float) -> np.ndarray:
    """Residues (..., live, N) uint32 (coefficient order) -> complex slots
    (..., N/2) f64. Exact CRT on host ints, then the forward embedding."""
    n = ctx.ring_dim
    x = np.asarray(residues).astype(np.uint64)
    live = x.shape[-2]
    qs = ctx.params.moduli[:live]
    Q = 1
    for q in qs:
        Q *= q
    half = Q // 2
    # Exact CRT with numpy object ints (host boundary, one-shot).
    v = np.zeros(x.shape[:-2] + (n,), dtype=object)
    for l, q in enumerate(qs):
        M = Q // q
        inv = pow(M % q, q - 2, q)
        y = (x[..., l, :] * np.uint64(inv)) % np.uint64(q)  # < 2**62, exact
        v = v + y.astype(object) * M
    v %= Q
    v = np.where(v > half, v - Q, v)
    c = (v / np.float64(scale)).astype(np.float64)
    return _embed_forward(c, n)


def slot_rotation_map(n: int, r: int) -> np.ndarray:
    """Sanity helper: after rotate(ct, r), slot j holds old slot (j+r) mod
    N/2 — returns the index map for oracle checks."""
    half = n // 2
    return (np.arange(half) + r) % half

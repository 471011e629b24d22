"""Negacyclic NTT as digit-plane integer matmuls (four-step form).

The tensor-core candidate for the transform: it computes exactly the map
of ntt()/intt() (ntt/ntt.py) with the multiplies moved into 8-bit matmuls,
which on a GPU can run on the tensor cores. It is not on the main path:
measured against the butterfly network on an H100 at the production shape
it lost end to end (PERF.md). How it works:

  * Four-step (Bailey) decomposition N = N1 * N2 (same math as ntt/dist.py)
    turns the transform into TWO dense matmuls (size-N1 column DFTs, then
    size-N2 row DFTs) around one elementwise twiddle pass.
  * Each matmul runs in SIGNED BASE-256 DIGIT PLANES: operands x are
    centered mod q (|x'| < 2^30) and split into 4 int8 digits; the DFT
    matrix is premultiplied by 2^(8i) mod q for each input plane i and each
    product re-split into 4 int8 output planes j, so ONE (4S x 4S) int8
    matmul with int32 accumulation computes all 16 plane products:

        x @ M = sum_i d_i(x) @ [(2^(8i) M) mod q]
              = sum_j 2^(8j) * P_j,   P_j = sum_i d_i(x) @ m_{i,j}

    |P_j| <= 4 * S * 128 * 128 <= 2^23 for S <= 128 — exact in int32 and
    in f32/bf16 accumulation.
  * Reassembly of the 4 output planes is ~30 elementwise ops per element:
    offset to unsigned, build an exact (hi, lo) u32 pair, one Shoup
    multiply by (2^32 mod q), conditional subtractions.
  * The negacyclic pre-twist psi^n, the post-twist psi^-n, and N^-1 are
    all FOLDED INTO the DFT matrices and the mid-twiddle table, and the
    row/column bit-reversals are folded in as well, so the output order is
    EXACTLY ntt()'s bit-reversed order: these transforms are drop-in
    replacements for ntt()/intt() at the same (.., L, N) layout.

Matmul operand dtype is an argument: int8 (s8 x s8 -> s32) or bf16/f32
(exact for these magnitudes, f32 accumulation).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp

from ..rns import primes as primes_mod
from ..rns import modops
from .tables import _bitrev

_U32 = jnp.uint32
_I32 = jnp.int32
_OFF_BITS = 24                     # plane offset: |P_j| <= 2^23 < 2^24
_OFF = 1 << _OFF_BITS
# Matmul operand type: "int8" (s8 x s8 -> s32), "bf16" or "f32" (f32
# accumulation). All three are exact: digits are in [-128, 128) and every
# plane sum is below 2^23.
MATMUL_DTYPE = "int8"


# ---------------------------------------------------------------------------
# Host-side table construction (exact integer arithmetic, vectorized)
# ---------------------------------------------------------------------------

def _pow_table_np(base: int, q: int, n: int) -> np.ndarray:
    """base**k mod q for k in [0, n) as uint64, via log-doubling."""
    pw = np.ones(1, dtype=np.uint64)
    b = np.uint64(base % q)
    qq = np.uint64(q)
    k = 1
    while k < n:
        pw = np.concatenate([pw, (pw * b) % qq])
        b = (b * b) % qq
        k *= 2
    return pw[:n]


def _digit_planes_rhs(M: np.ndarray, q: int) -> np.ndarray:
    """M: (Sout, S) uint64 residues mod q -> int8 rhs (4, S, 4*Sout):
    rhs[i, s, j*Sout + t] = digit_j( center( (2^(8i) * M[t, s]) mod q ) ).
    """
    s_out, s_in = M.shape
    out = np.empty((4, s_in, 4 * s_out), dtype=np.int8)
    for i in range(4):
        mi = (M.astype(object) * (1 << (8 * i))) % q   # exact
        mi = np.array(mi, dtype=np.int64)
        mi = np.where(mi > q // 2, mi - q, mi)         # |mi| < 2^30
        for j in range(4):
            d = ((mi + 128) & 255) - 128
            out[i, :, j * s_out:(j + 1) * s_out] = d.T.astype(np.int8)
            mi = (mi - d) >> 8
        assert np.all(mi == 0)
    return out


@functools.lru_cache(maxsize=None)
def _host_build(ring_dim: int, moduli: tuple, n1: int):
    n = ring_dim
    n2 = n // n1
    assert n1 * n2 == n and n1 >= 2 and n2 >= 2
    assert max(n1, n2) <= 128, (
        "digit-plane bounds sized for contraction <= 128; pick a different "
        "n1 split for this ring")
    b1 = n1.bit_length() - 1
    b2 = n2.bit_length() - 1
    L = len(moduli)
    rev1 = np.array([_bitrev(r, b1) for r in range(n1)], dtype=np.int64)
    rev2 = np.array([_bitrev(c, b2) for c in range(n2)], dtype=np.int64)
    i1 = np.arange(n1, dtype=np.int64)
    i2 = np.arange(n2, dtype=np.int64)

    r1f = np.empty((L, 4, n1, 4 * n1), dtype=np.int8)
    r2f = np.empty((L, 4, n2, 4 * n2), dtype=np.int8)
    r1i = np.empty((L, 4, n1, 4 * n1), dtype=np.int8)
    r2i = np.empty((L, 4, n2, 4 * n2), dtype=np.int8)
    midf = np.empty((L, n1, n2), dtype=np.uint32)
    midi = np.empty((L, n1, n2), dtype=np.uint32)
    c32 = np.empty(L, dtype=np.uint32)
    offm = np.empty(L, dtype=np.uint32)
    for l, q in enumerate(moduli):
        psi = primes_mod.primitive_root_2n(q, n)
        ipsi = pow(psi, q - 2, q)
        om = psi * psi % q
        iom = pow(om, q - 2, q)
        ninv = pow(n, q - 2, q)
        pw_psi = _pow_table_np(psi, q, 2 * n)
        pw_ipsi = _pow_table_np(ipsi, q, 2 * n)
        pw_om = _pow_table_np(om, q, n)
        pw_iom = _pow_table_np(iom, q, n)
        w1 = pow(om, n2, q)
        w2 = pow(om, n1, q)
        pw_w1 = _pow_table_np(w1, q, n1)
        pw_w2 = _pow_table_np(w2, q, n2)
        pw_iw1 = _pow_table_np(pow(w1, q - 2, q), q, n1)
        pw_iw2 = _pow_table_np(pow(w2, q - 2, q), q, n2)
        qq = np.uint64(q)

        # Forward: M1f[r, n1] = W1^(rev1(r)*n1) * psi^(N2*n1)
        m1f = (pw_w1[(rev1[:, None] * i1[None, :]) % n1]
               * pw_psi[(n2 * i1[None, :]) % (2 * n)]) % qq
        # midf[r, c] = om^(rev1(r)*c) * psi^c
        midf[l] = ((pw_om[(rev1[:, None] * i2[None, :]) % n]
                    * pw_psi[i2[None, :]]) % qq).astype(np.uint32)
        # M2f[c, n2] = W2^(rev2(c)*n2)
        m2f = pw_w2[(rev2[:, None] * i2[None, :]) % n2]

        # Inverse: M2i[n2, c] = W2^(-rev2(c)*n2)
        m2i = pw_iw2[(rev2[None, :] * i2[:, None]) % n2]
        # midi[r, c] = om^(-rev1(r)*c) * psi^-c
        midi[l] = ((pw_iom[(rev1[:, None] * i2[None, :]) % n]
                    * pw_ipsi[i2[None, :]]) % qq).astype(np.uint32)
        # M1i[n1, r] = W1^(-rev1(r)*n1) * psi^(-N2*n1) * N^-1
        m1i = (pw_iw1[(rev1[None, :] * i1[:, None]) % n1]
               * pw_ipsi[(n2 * i1[:, None]) % (2 * n)]) % qq
        m1i = (m1i * np.uint64(ninv)) % qq

        r1f[l] = _digit_planes_rhs(m1f, q)
        r2f[l] = _digit_planes_rhs(m2f, q)
        r2i[l] = _digit_planes_rhs(m2i, q)
        r1i[l] = _digit_planes_rhs(m1i, q)
        c32[l] = (1 << 32) % q
        offm[l] = (_OFF * (1 + (1 << 8) + (1 << 16) + (1 << 24))) % q

    qs = np.asarray(moduli, dtype=np.uint32)
    return dict(r1f=r1f, r2f=r2f, r1i=r1i, r2i=r2i, midf=midf, midi=midi,
                c32=c32, offm=offm, q=qs)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class MxuNttTables:
    """Digit-plane matrices + twiddles for the four-step NTT."""
    ring_dim: int = dataclasses.field(metadata=dict(static=True))
    n1: int = dataclasses.field(metadata=dict(static=True))
    n2: int = dataclasses.field(metadata=dict(static=True))
    q: jnp.ndarray                  # (L,)
    r1f: jnp.ndarray                # (L, 4, N1, 4*N1) int8
    r2f: jnp.ndarray                # (L, 4, N2, 4*N2) int8
    r1i: jnp.ndarray
    r2i: jnp.ndarray
    midf: jnp.ndarray               # (L, N1, N2)
    midf_shoup: jnp.ndarray
    midi: jnp.ndarray
    midi_shoup: jnp.ndarray
    c32: jnp.ndarray                # (L,) 2^32 mod q
    c32_shoup: jnp.ndarray
    offm: jnp.ndarray               # (L,) reassembly offset mod q

    def slice_limbs(self, lo: int, hi: int) -> "MxuNttTables":
        return MxuNttTables(
            ring_dim=self.ring_dim, n1=self.n1, n2=self.n2,
            q=self.q[lo:hi],
            r1f=self.r1f[lo:hi], r2f=self.r2f[lo:hi],
            r1i=self.r1i[lo:hi], r2i=self.r2i[lo:hi],
            midf=self.midf[lo:hi], midf_shoup=self.midf_shoup[lo:hi],
            midi=self.midi[lo:hi], midi_shoup=self.midi_shoup[lo:hi],
            c32=self.c32[lo:hi], c32_shoup=self.c32_shoup[lo:hi],
            offm=self.offm[lo:hi])


def make_mxu_tables(ring_dim: int, moduli: tuple[int, ...],
                    n1: int | None = None,
                    materialize: bool = True) -> MxuNttTables:
    """Default split keeps BOTH local DFT sizes <= 128 (plane-sum bound):
    near-square, N2 >= N1.

    materialize=False returns host (numpy) leaves so a caller building a
    larger context (ckks.params.make_context) can batch everything into one
    device transfer."""
    if n1 is None:
        half_bits = (ring_dim.bit_length() - 1) // 2
        n1 = 1 << half_bits
    h = _host_build(ring_dim, tuple(int(m) for m in moduli), n1)
    qs = h["q"]
    sh = modops.shoup_precompute
    out = MxuNttTables(
        ring_dim=ring_dim, n1=n1, n2=ring_dim // n1,
        q=qs,
        r1f=h["r1f"], r2f=h["r2f"], r1i=h["r1i"], r2i=h["r2i"],
        midf=h["midf"], midf_shoup=sh(h["midf"], qs[:, None, None]),
        midi=h["midi"], midi_shoup=sh(h["midi"], qs[:, None, None]),
        c32=h["c32"], c32_shoup=sh(h["c32"], qs),
        offm=h["offm"])
    if materialize:
        from ..utils.devput import device_materialize
        out = device_materialize(out)
    return out


def mxu_viable(ring_dim: int, n1: int | None = None) -> bool:
    """True when the four-step digit-plane decomposition's bounds hold for
    this ring (both local DFT sizes <= 128)."""
    if n1 is None:
        half_bits = (ring_dim.bit_length() - 1) // 2
        n1 = 1 << half_bits
    n2 = ring_dim // n1
    return (n1 * n2 == ring_dim and n1 >= 2 and n2 >= 2
            and max(n1, n2) <= 128)


# ---------------------------------------------------------------------------
# Device-side transform
# ---------------------------------------------------------------------------

def _digits4(x: jnp.ndarray, q: jnp.ndarray) -> jnp.ndarray:
    """u32 residues (..., S) mod q -> signed base-256 digits
    (..., 4, S) int8 of the CENTERED value x' = x - q*(x > q/2)."""
    xs = x.astype(_I32) - jnp.where(x > (q >> 1), q, _U32(0)).astype(_I32)
    ds = []
    for _ in range(4):
        d = ((xs + 128) & 255) - 128
        ds.append(d.astype(jnp.int8))
        xs = (xs - d) >> 8
    return jnp.stack(ds, axis=-2)


def _reassemble(planes: jnp.ndarray, q, c32, c32_sh, offm) -> jnp.ndarray:
    """planes: (..., 4, Sout) int32 plane sums P_j (|P_j| <= 2^23) ->
    (..., Sout) u32 = (sum_j 2^(8j) P_j) mod q.

    Exact u32-pair build with a per-plane offset of 2^24 (subtracted mod q
    at the end), then hi*2^32 + lo reduced with one Shoup mult."""
    u = (planes + _OFF).astype(_U32)                  # (..., 4, S) < 2^25
    u0 = u[..., 0, :]
    u1 = u[..., 1, :]
    u2 = u[..., 2, :]
    u3 = u[..., 3, :]
    lo = u0 + (u1 << 8)
    c = (lo < u0).astype(_U32)
    lo2 = lo + (u2 << 16)
    c = c + (lo2 < lo).astype(_U32)
    lo3 = lo2 + (u3 << 24)
    c = c + (lo3 < lo2).astype(_U32)
    hi = (u1 >> 24) + (u2 >> 16) + (u3 >> 8) + c      # < 2^18
    r1 = modops.mul_mod_shoup(hi, c32, c32_sh, q)
    # lo3 < 2^32 < 4q (q > 2^30): three conditional subtractions.
    r2 = jnp.where(lo3 >= (q << 1), lo3 - (q << 1), lo3)
    r2 = jnp.where(r2 >= q, r2 - q, r2)
    r2 = jnp.where(r2 >= q, r2 - q, r2)
    r = modops.add_mod(r1, r2, q)
    return modops.sub_mod(r, offm, q)


def _stage(x: jnp.ndarray, rhs: jnp.ndarray, q, c32, c32_sh, offm,
           dtype: str):
    """One DFT stage as a digit-plane matmul along the LAST axis.

    x: (L, B, F, S) u32, contract S. rhs: (L, 4, S, 4*Sout) int8.
    Returns (L, B, F, Sout) u32."""
    s_out4 = rhs.shape[-1]
    s_out = s_out4 // 4
    d = _digits4(x, q[:, None, None, None])           # (L, B, F, 4, S)
    dt = dtype
    if dt == "int8":
        lhs, r, pet = d, rhs, _I32
    elif dt == "bf16":
        lhs, r, pet = (d.astype(jnp.bfloat16), rhs.astype(jnp.bfloat16),
                       jnp.float32)
    else:                                             # f32
        lhs, r, pet = d.astype(jnp.float32), rhs.astype(jnp.float32), \
            jnp.float32
    out = jax.lax.dot_general(
        lhs, r,
        dimension_numbers=(((3, 4), (1, 2)), ((0,), (0,))),
        preferred_element_type=pet)                   # (L, B, F, 4*Sout)
    if pet != _I32:
        out = out.astype(_I32)
    planes = out.reshape(*out.shape[:-1], 4, s_out)
    qb = q[:, None, None, None]
    return _reassemble(planes, qb, c32[:, None, None, None],
                       c32_sh[:, None, None, None], offm[:, None, None, None])


def _to_lbrc(x: jnp.ndarray, n1: int, n2: int):
    """(..., L, N) -> ((L, B, n1, n2), lead_shape) with batch flattened."""
    lead = x.shape[:-2]
    L = x.shape[-2]
    xb = x.reshape(-1, L, n1, n2)
    return jnp.moveaxis(xb, 1, 0), lead, L


def _from_lbrc(x: jnp.ndarray, lead, L, n: int):
    xb = jnp.moveaxis(x, 0, 1)                        # (B, L, n1, n2)
    return xb.reshape(*lead, L, n)


def ntt_mxu(x: jnp.ndarray, mt: MxuNttTables,
            dtype: str = MATMUL_DTYPE) -> jnp.ndarray:
    """Forward negacyclic NTT, coefficient order -> the on-chip ntt()'s
    bit-reversed eval order. Drop-in for ntt.ntt at (..., L, N)."""
    n1, n2, n = mt.n1, mt.n2, mt.ring_dim
    assert x.shape[-1] == n and x.shape[-2] == mt.q.shape[0]
    xm, lead, L = _to_lbrc(x, n1, n2)                 # (L, B, n1, n2)
    # Column DFTs (contract n1): transpose so n1 is last.
    xt = jnp.swapaxes(xm, -1, -2)                     # (L, B, n2, n1)
    y = _stage(xt, mt.r1f, mt.q, mt.c32, mt.c32_shoup, mt.offm, dtype)
    y = jnp.swapaxes(y, -1, -2)                       # (L, B, r, n2)
    # Mid twiddle (psi^c folded in).
    y = modops.mul_mod_shoup(y, mt.midf[:, None], mt.midf_shoup[:, None],
                             mt.q[:, None, None, None])
    # Row DFTs (contract n2, already last).
    z = _stage(y, mt.r2f, mt.q, mt.c32, mt.c32_shoup, mt.offm, dtype)
    return _from_lbrc(z, lead, L, n)                  # (.., L, N) bit-rev


def intt_mxu(x: jnp.ndarray, mt: MxuNttTables,
             dtype: str = MATMUL_DTYPE) -> jnp.ndarray:
    """Inverse: on-chip bit-reversed eval order -> coefficient order,
    exactly scaled (N^-1 folded into the final matrices)."""
    n1, n2, n = mt.n1, mt.n2, mt.ring_dim
    assert x.shape[-1] == n and x.shape[-2] == mt.q.shape[0]
    xm, lead, L = _to_lbrc(x, n1, n2)                 # (L, B, r, c)
    u = _stage(xm, mt.r2i, mt.q, mt.c32, mt.c32_shoup, mt.offm, dtype)
    # u: (L, B, r, n2); mid twiddle (psi^-c folded in).
    u = modops.mul_mod_shoup(u, mt.midi[:, None], mt.midi_shoup[:, None],
                             mt.q[:, None, None, None])
    ut = jnp.swapaxes(u, -1, -2)                      # (L, B, n2, r)
    v = _stage(ut, mt.r1i, mt.q, mt.c32, mt.c32_shoup, mt.offm, dtype)
    v = jnp.swapaxes(v, -1, -2)                       # (L, B, n1, n2)
    return _from_lbrc(v, lead, L, n)


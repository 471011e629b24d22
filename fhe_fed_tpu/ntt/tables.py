"""Twiddle-factor tables for the negacyclic NTT.

Tables are generated host-side with exact Python integers once per crypto
context, then shipped to the device as uint32 arrays of shape (L, N):

  tab[l, k]  = psi_l ** bitrev(k)        (mod q_l)   forward (CT/DIT)
  itab[l, k] = psi_l ** -bitrev(k)       (mod q_l)   inverse (GS/DIF)

following the merged-psi formulation (Longa & Naehrig 2016), so no separate
bit-reversal pass is ever needed: forward output / eval-domain data lives in
bit-reversed order, which is fine because every eval-domain op is
coefficient-wise.

Replaces PALISADE's NTT precomputations (reference SURVEY.md C11).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp

from ..rns import primes as primes_mod
from ..rns import modops


def _bitrev(x: int, bits: int) -> int:
    r = 0
    for _ in range(bits):
        r = (r << 1) | (x & 1)
        x >>= 1
    return r


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class NttTables:
    """Device-resident twiddle tables for a modulus chain (L primes)."""
    ring_dim: int = dataclasses.field(metadata=dict(static=True))
    q: jnp.ndarray            # (L,) uint32 moduli
    tab: jnp.ndarray          # (L, N) forward twiddles, tree order
    tab_shoup: jnp.ndarray    # (L, N)
    itab: jnp.ndarray         # (L, N) inverse twiddles, tree order
    itab_shoup: jnp.ndarray   # (L, N)
    ninv: jnp.ndarray         # (L,) N^{-1} mod q
    ninv_shoup: jnp.ndarray   # (L,)

    @property
    def num_limbs(self) -> int:
        return int(self.q.shape[0])

    def slice_limbs(self, lo: int, hi: int) -> "NttTables":
        """Tables restricted to limbs [lo, hi) — used after rescale."""
        return NttTables(
            ring_dim=self.ring_dim,
            q=self.q[lo:hi],
            tab=self.tab[lo:hi],
            tab_shoup=self.tab_shoup[lo:hi],
            itab=self.itab[lo:hi],
            itab_shoup=self.itab_shoup[lo:hi],
            ninv=self.ninv[lo:hi],
            ninv_shoup=self.ninv_shoup[lo:hi],
        )


def _pow_table(base: int, q: int, n: int) -> np.ndarray:
    """base**k mod q for k in [0, n), by numpy log-doubling.

    base, q < 2**31 so every product fits uint64 exactly; log2(n) vectorized
    steps replace the n-iteration Python big-int loop.
    """
    pw = np.ones(1, dtype=np.uint64)
    b = np.uint64(base % q)
    qq = np.uint64(q)
    while pw.size < n:
        pw = np.concatenate([pw, (pw * b) % qq])
        b = (b * b) % qq
    return pw[:n]


def make_tables(ring_dim: int, moduli: tuple[int, ...],
                materialize: bool = True) -> NttTables:
    """materialize=False returns host (numpy) leaves so a caller building a
    larger context can batch everything into one device transfer."""
    n = ring_dim
    bits = n.bit_length() - 1
    assert 1 << bits == n, "ring_dim must be a power of two"
    L = len(moduli)
    tab = np.zeros((L, n), dtype=np.uint32)
    itab = np.zeros((L, n), dtype=np.uint32)
    ninv = np.zeros((L,), dtype=np.uint32)
    # Vectorized bit-reversal permutation.
    brv = np.zeros(n, dtype=np.int64)
    x = np.arange(n, dtype=np.int64)
    for _ in range(bits):
        brv = (brv << 1) | (x & 1)
        x >>= 1
    for l, q in enumerate(moduli):
        psi = primes_mod.primitive_root_2n(q, n)
        ipsi = pow(psi, q - 2, q)
        tab[l] = _pow_table(psi, q, n)[brv].astype(np.uint32)
        itab[l] = _pow_table(ipsi, q, n)[brv].astype(np.uint32)
        ninv[l] = pow(n, q - 2, q)
    qs = np.asarray(moduli, dtype=np.uint32)
    out = NttTables(
        ring_dim=n,
        q=qs,
        tab=tab,
        tab_shoup=modops.shoup_precompute(tab, qs[:, None]),
        itab=itab,
        itab_shoup=modops.shoup_precompute(itab, qs[:, None]),
        ninv=ninv,
        ninv_shoup=modops.shoup_precompute(ninv, qs),
    )
    if materialize:
        from ..utils.devput import device_materialize
        out = device_materialize(out)
    return out

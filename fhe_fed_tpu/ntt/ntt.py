"""Negacyclic NTT / inverse NTT over RNS limbs, as a radix-2 butterfly
network over the whole batch.

Layout: polynomials are uint32 arrays of shape (..., L, N) — leading batch
dims (ciphertext chunks, ct components), then RNS limb, then coefficient.
Forward output is in bit-reversed order; all eval-domain ops are
coefficient-wise so the order never matters until the inverse transform.

The stages run in two phases so the innermost axis always holds >= 128
contiguous elements:

  * Phase A — early stages (butterfly span t >= 128): ops vectorize over the
    contiguous span directly.
  * Phase B — late stages (span t <= 64): the (N/128, 128) view is
    transposed once to (128, N/128), so butterflies run along the
    second-to-last axis while the last axis carries the N/128 independent
    128-blocks.

This network is the one transform behind ntt()/intt(). The four-step
digit-plane matmul in ntt/mxu.py computes the same map bit for bit; it
was measured against this network at the production shape and lost end
to end (PERF.md), and stays as the tensor-core candidate.

This replaces the per-chunk OpenMP NTT parallelism of the reference's
PALISADE backend (SURVEY.md C11, ckks.cpp:70) with whole-batch vectorization.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..rns.modops import add_mod, sub_mod, mul_mod_shoup
from .tables import NttTables

_LANE = 128
_MAX_B_SPAN = 64  # butterfly spans <= this run in transposed layout


def _fwd_stage(x, tab, tab_shoup, q, m, t):
    """One CT butterfly stage on x of shape (..., L, N), span t, m blocks."""
    batch = x.shape[:-2]
    L = x.shape[-2]
    xs = x.reshape(*batch, L, m, 2, t)
    s = tab[:, m:2 * m].reshape(L, m, 1)
    s_sh = tab_shoup[:, m:2 * m].reshape(L, m, 1)
    qb = q.reshape(L, 1, 1)
    u = xs[..., 0, :]
    v = mul_mod_shoup(xs[..., 1, :], s, s_sh, qb)
    out = jnp.stack([add_mod(u, v, qb), sub_mod(u, v, qb)], axis=-2)
    return out.reshape(*batch, L, m * 2 * t)


def _fwd_stage_t(xt, tab, tab_shoup, q, m, t, nblk):
    """CT stage in transposed layout xt: (..., L, 128, nblk), span t <= 64."""
    batch = xt.shape[:-3]
    L = xt.shape[-3]
    m_in = _LANE // (2 * t)
    xs = xt.reshape(*batch, L, m_in, 2, t, nblk)
    # Global block i = c*m_in + i_in  ->  slice (L, nblk, m_in) -> (L, m_in, nblk)
    s = tab[:, m:2 * m].reshape(L, nblk, m_in).swapaxes(-1, -2)
    s_sh = tab_shoup[:, m:2 * m].reshape(L, nblk, m_in).swapaxes(-1, -2)
    s = s.reshape(L, m_in, 1, nblk)
    s_sh = s_sh.reshape(L, m_in, 1, nblk)
    qb = q.reshape(L, 1, 1, 1)
    u = xs[..., 0, :, :]
    v = mul_mod_shoup(xs[..., 1, :, :], s, s_sh, qb)
    out = jnp.stack([add_mod(u, v, qb), sub_mod(u, v, qb)], axis=-3)
    return out.reshape(*batch, L, _LANE, nblk)


def ntt(x: jnp.ndarray, tb: NttTables) -> jnp.ndarray:
    """Forward negacyclic NTT: coefficient order -> bit-reversed eval order."""
    n = tb.ring_dim
    L = tb.q.shape[0]
    assert x.shape[-1] == n and x.shape[-2] == L, (x.shape, L, n)
    batch = x.shape[:-2]

    # Phase A: spans t = n/2 down to 128.
    m = 1
    t = n // 2
    while t >= _LANE:
        x = _fwd_stage(x, tb.tab, tb.tab_shoup, tb.q, m, t)
        m *= 2
        t //= 2
    if t == 0 or m >= n:
        return x
    # Phase B: transpose (nblk, 128) -> (128, nblk).
    nblk = n // min(n, _LANE)
    lane = min(n, _LANE)
    if nblk > 1:
        xt = x.reshape(*batch, L, nblk, lane).swapaxes(-1, -2)
        while m < n:
            xt = _fwd_stage_t(xt, tb.tab, tb.tab_shoup, tb.q, m, t, nblk)
            m *= 2
            t //= 2
        x = xt.swapaxes(-1, -2).reshape(*batch, L, n)
    else:
        while m < n:
            x = _fwd_stage(x, tb.tab, tb.tab_shoup, tb.q, m, t)
            m *= 2
            t //= 2
    return x


def _inv_stage(x, itab, itab_shoup, q, h, t):
    """One GS butterfly stage, h blocks of span t."""
    batch = x.shape[:-2]
    L = x.shape[-2]
    xs = x.reshape(*batch, L, h, 2, t)
    s = itab[:, h:2 * h].reshape(L, h, 1)
    s_sh = itab_shoup[:, h:2 * h].reshape(L, h, 1)
    qb = q.reshape(L, 1, 1)
    x0 = xs[..., 0, :]
    x1 = xs[..., 1, :]
    u = add_mod(x0, x1, qb)
    v = mul_mod_shoup(sub_mod(x0, x1, qb), s, s_sh, qb)
    out = jnp.stack([u, v], axis=-2)
    return out.reshape(*batch, L, h * 2 * t)


def _inv_stage_t(xt, itab, itab_shoup, q, h, t, nblk):
    batch = xt.shape[:-3]
    L = xt.shape[-3]
    h_in = _LANE // (2 * t)
    xs = xt.reshape(*batch, L, h_in, 2, t, nblk)
    s = itab[:, h:2 * h].reshape(L, nblk, h_in).swapaxes(-1, -2)
    s_sh = itab_shoup[:, h:2 * h].reshape(L, nblk, h_in).swapaxes(-1, -2)
    s = s.reshape(L, h_in, 1, nblk)
    s_sh = s_sh.reshape(L, h_in, 1, nblk)
    qb = q.reshape(L, 1, 1, 1)
    x0 = xs[..., 0, :, :]
    x1 = xs[..., 1, :, :]
    u = add_mod(x0, x1, qb)
    v = mul_mod_shoup(sub_mod(x0, x1, qb), s, s_sh, qb)
    out = jnp.stack([u, v], axis=-3)
    return out.reshape(*batch, L, _LANE, nblk)


def intt(x: jnp.ndarray, tb: NttTables) -> jnp.ndarray:
    """Inverse negacyclic NTT: bit-reversed eval order -> coefficient order."""
    n = tb.ring_dim
    L = tb.q.shape[0]
    assert x.shape[-1] == n and x.shape[-2] == L, (x.shape, L, n)
    batch = x.shape[:-2]

    nblk = n // min(n, _LANE)
    lane = min(n, _LANE)
    t = 1
    h = n // 2
    if nblk > 1:
        # Phase B first (spans t = 1 .. 64), transposed.
        xt = x.reshape(*batch, L, nblk, lane).swapaxes(-1, -2)
        while t <= _MAX_B_SPAN:
            xt = _inv_stage_t(xt, tb.itab, tb.itab_shoup, tb.q, h, t, nblk)
            t *= 2
            h //= 2
        x = xt.swapaxes(-1, -2).reshape(*batch, L, n)
    else:
        while t <= _MAX_B_SPAN and h >= 1:
            x = _inv_stage(x, tb.itab, tb.itab_shoup, tb.q, h, t)
            t *= 2
            h //= 2
    # Phase A: spans t = 128 .. n/2.
    while h >= 1:
        x = _inv_stage(x, tb.itab, tb.itab_shoup, tb.q, h, t)
        t *= 2
        h //= 2
    # Final scaling by N^{-1}.
    qb = tb.q.reshape(L, 1)
    return mul_mod_shoup(x, tb.ninv.reshape(L, 1), tb.ninv_shoup.reshape(L, 1), qb)


# Jitted entry points (NttTables is a registered pytree; ring_dim is static).
ntt_jit = jax.jit(ntt)
intt_jit = jax.jit(intt)

"""Coefficient- and limb-sharded negacyclic NTT over a device mesh.

The on-chip transform (ntt/ntt.py) keeps a whole ring on one device. This
module removes that ceiling: RNS limbs and polynomial coefficients become
real mesh axes ('limb', 'coeff'), and the NTT butterfly network is split so
the single cross-device exchange is one all-to-all — the sharded
replacement for the reference's on-node OpenMP chunk loop
(reference ckks.cpp:70; blueprint SURVEY.md §5.7-5.8, C11).

Four-step (Bailey) decomposition, N = N1 * N2, coefficient n = N2*n1 + n2:

    X[k1 + N1*k2] = F_{N2}[n2 -> k2]( W_N^{n2*k1} * F_{N1}[n1 -> k1](x) )

so the polynomial lives as a (..., L, N1, N2) matrix:

  1. negacyclic pre-twist  x[n] *= psi^n                 (local)
  2. column DFTs: size-N1 cyclic DFT along n1            (local, n2 sharded)
  3. mid twiddle           *= W_N^{rev(r) * n2}          (local)
  4. RESHARD n2-sharded -> k1-sharded                    (ONE all-to-all)
  5. row DFTs: size-N2 cyclic DFT along n2               (local, k1 sharded)

The inverse runs the mirror image (one all-to-all back) and folds N^{-1}
into the post-twist. Local DFTs are Gentleman-Sande (decimation in
frequency, natural -> bit-reversed) forward and Cooley-Tukey (bit-reversed
-> natural) inverse, built on the same Shoup modmul as the on-chip kernels.

Eval-domain order: position (r, c) of the output matrix holds the
evaluation at psi^(2k+1) with k = rev_{N1}(r) + N1 * rev_{N2}(c). Like the
on-chip transform's bit-reversed order, this is a fixed permutation — all
eval-domain ops are coefficient-wise, so it only matters when converting
to/from the on-chip layout (`eval_perm` / `ct_to_dist`).

Sharding is expressed with `jax.lax.with_sharding_constraint` inside jit:
GSPMD inserts the all-to-all for the n2->k1 reshard. This composes freely
with a 'limb' mesh axis (the L dim sharded; every op here is limb-local)
and with leading batch axes (chunks / ct components / clients).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..rns import primes as primes_mod
from ..rns import modops
from .tables import _bitrev


# ---------------------------------------------------------------------------
# Tables (host-built, exact integer arithmetic)
# ---------------------------------------------------------------------------

@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class DistNttTables:
    """Twiddle tables for the four-step sharded NTT (L limbs, N = N1*N2)."""
    ring_dim: int = dataclasses.field(metadata=dict(static=True))
    n1: int = dataclasses.field(metadata=dict(static=True))
    n2: int = dataclasses.field(metadata=dict(static=True))
    q: jnp.ndarray                  # (L,)
    twist: jnp.ndarray              # (L, N1, N2)  psi^n
    twist_shoup: jnp.ndarray
    untwist: jnp.ndarray            # (L, N1, N2)  psi^-n * N^-1
    untwist_shoup: jnp.ndarray
    mid: jnp.ndarray                # (L, N1, N2)  W_N^(rev1(r) * n2)
    mid_shoup: jnp.ndarray
    imid: jnp.ndarray               # (L, N1, N2)  W_N^(-rev1(r) * n2)
    imid_shoup: jnp.ndarray
    # Per-stage cyclic DFT twiddles. Forward (GS) spans t = S/2 .. 1,
    # inverse (CT) spans t = 1 .. S/2; stage s has a (L, t) table.
    f1: tuple                       # tuple[(L, t)] for size N1, + shoup
    f1_shoup: tuple
    i1: tuple
    i1_shoup: tuple
    f2: tuple                       # same for size N2
    f2_shoup: tuple
    i2: tuple
    i2_shoup: tuple

    def slice_limbs(self, lo: int, hi: int) -> "DistNttTables":
        """Tables restricted to limbs [lo, hi) — every table leads with L."""
        def s(x):
            return x[lo:hi]

        def st(t):
            return tuple(x[lo:hi] for x in t)
        return DistNttTables(
            ring_dim=self.ring_dim, n1=self.n1, n2=self.n2,
            q=s(self.q),
            twist=s(self.twist), twist_shoup=s(self.twist_shoup),
            untwist=s(self.untwist), untwist_shoup=s(self.untwist_shoup),
            mid=s(self.mid), mid_shoup=s(self.mid_shoup),
            imid=s(self.imid), imid_shoup=s(self.imid_shoup),
            f1=st(self.f1), f1_shoup=st(self.f1_shoup),
            i1=st(self.i1), i1_shoup=st(self.i1_shoup),
            f2=st(self.f2), f2_shoup=st(self.f2_shoup),
            i2=st(self.i2), i2_shoup=st(self.i2_shoup))


def _cyclic_stage_tables(size: int, omega: int, q: int):
    """GS-forward and CT-inverse stage twiddles for a size-`size` cyclic DFT.

    Forward stage with span t uses w_{2t}^i = omega^((size/2t) * i), i<t;
    inverse uses w_{2t}^{-i}. Returns (fwd, inv) lists of np.uint32 arrays.
    """
    iomega = pow(omega, q - 2, q)
    fwd, inv = [], []
    t = size // 2
    while t >= 1:
        stride = size // (2 * t)
        fwd.append(np.array([pow(omega, stride * i, q) for i in range(t)],
                            dtype=np.uint32))
        t //= 2
    t = 1
    while t <= size // 2:
        stride = size // (2 * t)
        inv.append(np.array([pow(iomega, stride * i, q) for i in range(t)],
                            dtype=np.uint32))
        t *= 2
    return fwd, inv


@functools.lru_cache(maxsize=None)
def _host_tables(ring_dim: int, moduli: tuple, n1: int):
    n = ring_dim
    n2 = n // n1
    assert n1 * n2 == n and n1 >= 2 and n2 >= 2
    bits1 = n1.bit_length() - 1
    L = len(moduli)

    twist = np.zeros((L, n1, n2), dtype=np.uint32)
    untwist = np.zeros((L, n1, n2), dtype=np.uint32)
    mid = np.zeros((L, n1, n2), dtype=np.uint32)
    imid = np.zeros((L, n1, n2), dtype=np.uint32)
    f1s, i1s, f2s, i2s = [], [], [], []
    for l, q in enumerate(moduli):
        psi = primes_mod.primitive_root_2n(q, n)
        ipsi = pow(psi, q - 2, q)
        w = psi * psi % q                     # omega_N, order N
        iw = pow(w, q - 2, q)
        ninv = pow(n, q - 2, q)
        # psi powers, row-major n = N2*n1 + n2.
        pw = np.empty(n, dtype=np.uint64)
        ipw = np.empty(n, dtype=np.uint64)
        x = 1
        y = ninv
        for k in range(n):
            pw[k] = x
            ipw[k] = y
            x = x * psi % q
            y = y * ipsi % q
        twist[l] = pw.reshape(n1, n2).astype(np.uint32)
        untwist[l] = ipw.reshape(n1, n2).astype(np.uint32)
        # mid[r, c] = w^(rev1(r) * c): rows are in the bit-reversed order the
        # size-N1 GS stage leaves them in.
        for r in range(n1):
            k1 = _bitrev(r, bits1)
            wrow = np.empty(n2, dtype=np.uint64)
            v = 1
            wk = pow(w, k1, q)
            ik = pow(iw, k1, q)
            u = 1
            for c in range(n2):
                wrow[c] = v
                v = v * wk % q
            mid[l, r] = wrow.astype(np.uint32)
            irow = np.empty(n2, dtype=np.uint64)
            for c in range(n2):
                irow[c] = u
                u = u * ik % q
            imid[l, r] = irow.astype(np.uint32)
        w1 = pow(w, n2, q)                    # omega_{N1}
        w2 = pow(w, n1, q)                    # omega_{N2}
        f1, i1 = _cyclic_stage_tables(n1, w1, q)
        f2, i2 = _cyclic_stage_tables(n2, w2, q)
        f1s.append(f1)
        i1s.append(i1)
        f2s.append(f2)
        i2s.append(i2)

    def stack(per_limb):
        # per_limb: [limb][stage] -> (t,)  =>  [stage] -> (L, t)
        return tuple(np.stack([per_limb[l][s] for l in range(L)])
                     for s in range(len(per_limb[0])))

    qs = np.asarray(moduli, dtype=np.uint32)
    return dict(twist=twist, untwist=untwist, mid=mid, imid=imid,
                f1=stack(f1s), i1=stack(i1s), f2=stack(f2s), i2=stack(i2s),
                q=qs)


def make_dist_tables(ring_dim: int, moduli: tuple[int, ...],
                     n1: int | None = None) -> DistNttTables:
    """Build tables for N = ring_dim split as (n1, N/n1). Default n1 is the
    near-square split rounded to keep N2 >= N1 (larger local row DFTs)."""
    if n1 is None:
        half_bits = (ring_dim.bit_length() - 1) // 2
        n1 = 1 << half_bits
    h = _host_tables(ring_dim, tuple(moduli), n1)
    qs = h["q"]

    def sh(w, qb):
        return jnp.asarray(modops.shoup_precompute(w, qb))

    def sh_stages(stages):
        return tuple(sh(s, qs[:, None]) for s in stages)

    return DistNttTables(
        ring_dim=ring_dim, n1=n1, n2=ring_dim // n1,
        q=jnp.asarray(qs),
        twist=jnp.asarray(h["twist"]),
        twist_shoup=sh(h["twist"], qs[:, None, None]),
        untwist=jnp.asarray(h["untwist"]),
        untwist_shoup=sh(h["untwist"], qs[:, None, None]),
        mid=jnp.asarray(h["mid"]),
        mid_shoup=sh(h["mid"], qs[:, None, None]),
        imid=jnp.asarray(h["imid"]),
        imid_shoup=sh(h["imid"], qs[:, None, None]),
        f1=tuple(jnp.asarray(s) for s in h["f1"]),
        f1_shoup=sh_stages(h["f1"]),
        i1=tuple(jnp.asarray(s) for s in h["i1"]),
        i1_shoup=sh_stages(h["i1"]),
        f2=tuple(jnp.asarray(s) for s in h["f2"]),
        f2_shoup=sh_stages(h["f2"]),
        i2=tuple(jnp.asarray(s) for s in h["i2"]),
        i2_shoup=sh_stages(h["i2"]),
    )


# ---------------------------------------------------------------------------
# Local cyclic DFT networks
# ---------------------------------------------------------------------------

def _gs_last(x, tws, tws_sh, q):
    """Forward GS DFT along the LAST axis (size S = prod of stage spans*2).
    x: (..., L, R, S); tables tws[s]: (L, t). Natural in, bit-reversed out."""
    S = x.shape[-1]
    t = S // 2
    for s, (tw, tw_sh) in enumerate(zip(tws, tws_sh)):
        nb = S // (2 * t)
        shp = x.shape[:-1] + (nb, 2, t)
        xs = x.reshape(shp)
        u = xs[..., 0, :]
        v = xs[..., 1, :]
        w = tw.reshape(tw.shape[0], 1, 1, t)      # (L, R=1, nb=1, t)
        w_sh = tw_sh.reshape(tw.shape[0], 1, 1, t)
        qb = q.reshape(-1, 1, 1, 1)
        a = modops.add_mod(u, v, qb)
        b = modops.mul_mod_shoup(modops.sub_mod(u, v, qb), w, w_sh, qb)
        x = jnp.stack([a, b], axis=-2).reshape(x.shape)
        t //= 2
    return x


def _ct_last(x, tws, tws_sh, q):
    """Inverse CT DFT along the LAST axis: bit-reversed in, natural out.
    Leaves the result scaled by S (folded into untwist)."""
    S = x.shape[-1]
    t = 1
    for tw, tw_sh in zip(tws, tws_sh):
        nb = S // (2 * t)
        shp = x.shape[:-1] + (nb, 2, t)
        xs = x.reshape(shp)
        u = xs[..., 0, :]
        v = xs[..., 1, :]
        w = tw.reshape(tw.shape[0], 1, 1, t)
        w_sh = tw_sh.reshape(tw.shape[0], 1, 1, t)
        qb = q.reshape(-1, 1, 1, 1)
        wv = modops.mul_mod_shoup(v, w, w_sh, qb)
        x = jnp.stack([modops.add_mod(u, wv, qb),
                       modops.sub_mod(u, wv, qb)], axis=-2).reshape(x.shape)
        t *= 2
    return x


def _swap_last_two(x):
    return jnp.swapaxes(x, -1, -2)


# ---------------------------------------------------------------------------
# Sharded transforms
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DistSpec:
    """Mesh axis names for the distributed layout. `limb_axis` may be None
    (limbs replicated or handled by an outer sharding)."""
    mesh: Mesh
    coeff_axis: str = "coeff"
    limb_axis: str | None = None

    def col_sharding(self, ndim: int) -> NamedSharding:
        """(..., L, N1, N2) with n2 (last axis) sharded — coefficient layout."""
        spec = [None] * ndim
        spec[-1] = self.coeff_axis
        if self.limb_axis is not None:
            spec[-3] = self.limb_axis
        return NamedSharding(self.mesh, P(*spec))

    def row_sharding(self, ndim: int) -> NamedSharding:
        """(..., L, N1, N2) with k1 (second-to-last) sharded — eval layout."""
        spec = [None] * ndim
        spec[-2] = self.coeff_axis
        if self.limb_axis is not None:
            spec[-3] = self.limb_axis
        return NamedSharding(self.mesh, P(*spec))


def _reshard(x, ds: DistSpec, to_row: bool):
    """Explicit one-collective reshard between the n2-sharded (col) and
    k1-sharded (row) layouts via lax.all_to_all inside a minimal shard_map.

    A bare with_sharding_constraint also works, but GSPMD propagates the
    target sharding back into the butterfly-stage reshapes and falls into
    'involuntary full rematerialization' (replicate-then-slice). Pinning the
    exchange keeps it a single tiled all-to-all."""
    axis = ds.coeff_axis
    nd = x.ndim
    split = nd - 2 if to_row else nd - 1     # global axis being sharded next
    concat = nd - 1 if to_row else nd - 2    # global axis being gathered

    def body(xl):
        return jax.lax.all_to_all(xl, axis, split_axis=split,
                                  concat_axis=concat, tiled=True)

    in_spec = [None] * nd
    in_spec[concat] = axis                   # currently sharded axis
    out_spec = [None] * nd
    out_spec[split] = axis
    # Partial-manual shard_map: only 'coeff' is manual; any 'limb' / batch
    # axis sharding stays under GSPMD (auto) and flows through untouched.
    return jax.shard_map(
        body, mesh=ds.mesh, axis_names=frozenset({axis}),
        in_specs=P(*in_spec), out_specs=P(*out_spec))(x)


def dist_ntt(x: jnp.ndarray, dt: DistNttTables, ds: DistSpec) -> jnp.ndarray:
    """Forward negacyclic NTT of (..., L, N1, N2) coefficient-layout input
    (n2-sharded). Output is eval-layout (k1-sharded). ONE all-to-all."""
    q3 = dt.q.reshape(-1, 1, 1)
    x = jax.lax.with_sharding_constraint(x, ds.col_sharding(x.ndim))
    x = modops.mul_mod_shoup(x, dt.twist, dt.twist_shoup, q3)
    # Size-N1 DFT along n1: transpose locally so the transform axis is last.
    xt = _swap_last_two(x)                               # (..., L, N2, N1)
    xt = _gs_last(xt, dt.f1, dt.f1_shoup, dt.q)
    x = _swap_last_two(xt)                               # (..., L, N1, N2)
    x = modops.mul_mod_shoup(x, dt.mid, dt.mid_shoup, q3)
    # Reshard n2-sharded -> k1-sharded: one tiled all-to-all.
    x = _reshard(x, ds, to_row=True)
    # Size-N2 DFT along n2 (now fully local per k1-row).
    return _gs_last(x, dt.f2, dt.f2_shoup, dt.q)


def dist_intt(x: jnp.ndarray, dt: DistNttTables, ds: DistSpec) -> jnp.ndarray:
    """Inverse of dist_ntt: eval layout (k1-sharded) -> coefficient layout
    (n2-sharded), scaled exactly (N^-1 folded into the post-twist)."""
    q3 = dt.q.reshape(-1, 1, 1)
    x = jax.lax.with_sharding_constraint(x, ds.row_sharding(x.ndim))
    x = _ct_last(x, dt.i2, dt.i2_shoup, dt.q)
    x = _reshard(x, ds, to_row=False)
    x = modops.mul_mod_shoup(x, dt.imid, dt.imid_shoup, q3)
    xt = _swap_last_two(x)
    xt = _ct_last(xt, dt.i1, dt.i1_shoup, dt.q)
    x = _swap_last_two(xt)
    return modops.mul_mod_shoup(x, dt.untwist, dt.untwist_shoup, q3)


# ---------------------------------------------------------------------------
# Layout conversion (host-side / test helpers)
# ---------------------------------------------------------------------------

def eval_perm(ring_dim: int, n1: int) -> np.ndarray:
    """perm[p] = j such that flat dist-eval position p = r*N2 + c holds the
    same evaluation the ON-CHIP ntt() places at position j.

    Dist position (r, c) holds X(psi^(2k+1)), k = rev1(r) + N1*rev2(c);
    on-chip position j holds X(psi^(2*rev_N(j)+1)) — so j = rev_N(k)."""
    n2 = ring_dim // n1
    bits, bits1, bits2 = (ring_dim.bit_length() - 1, n1.bit_length() - 1,
                          n2.bit_length() - 1)
    perm = np.empty(ring_dim, dtype=np.int64)
    for r in range(n1):
        k1 = _bitrev(r, bits1)
        for c in range(n2):
            k = k1 + n1 * _bitrev(c, bits2)
            perm[r * n2 + c] = _bitrev(k, bits)
    return perm


def to_dist_coeff(x: np.ndarray | jnp.ndarray, n1: int):
    """Coefficient-order (..., L, N) -> dist coefficient layout
    (..., L, N1, N2) (a plain row-major reshape)."""
    n = x.shape[-1]
    return x.reshape(*x.shape[:-1], n1, n // n1)


def from_dist_coeff(x):
    return x.reshape(*x.shape[:-2], x.shape[-2] * x.shape[-1])


def eval_to_dist(x_eval: np.ndarray, n1: int) -> np.ndarray:
    """On-chip eval-order (..., L, N) -> dist eval layout (..., L, N1, N2).
    Use for converting ciphertexts / NTT-domain keys (host-side)."""
    n = x_eval.shape[-1]
    perm = eval_perm(n, n1)
    return x_eval[..., perm].reshape(*x_eval.shape[:-1], n1, n // n1)


def dist_to_eval(x_dist: np.ndarray) -> np.ndarray:
    """Inverse of eval_to_dist."""
    n1, n2 = x_dist.shape[-2:]
    n = n1 * n2
    perm = eval_perm(n, n1)
    flat = x_dist.reshape(*x_dist.shape[:-2], n)
    out = np.empty_like(flat)
    out[..., perm] = flat
    return out


# ---------------------------------------------------------------------------
# Demo composite: sharded negacyclic polynomial multiply
# ---------------------------------------------------------------------------

def dist_poly_mul(a, b, dt: DistNttTables, ds: DistSpec):
    """Negacyclic product of two coefficient-layout polys, fully sharded:
    2 forward transforms + pointwise mul + 1 inverse = 3 all-to-alls."""
    ah = dist_ntt(a, dt, ds)
    bh = dist_ntt(b, dt, ds)
    q3 = dt.q.reshape(-1, 1, 1)
    # Eval-domain values are variable x variable -> generic Barrett mul_mod.
    from ..rns.modops import barrett_precompute, mul_mod
    mu = jnp.asarray(
        np.array([barrett_precompute(int(q)) for q in np.asarray(dt.q)],
                 dtype=np.uint32)).reshape(-1, 1, 1)
    ph = mul_mod(ah, bh, q3, mu)
    return dist_intt(ph, dt, ds)

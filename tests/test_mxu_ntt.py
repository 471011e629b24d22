"""Four-step digit-plane NTT: bit-exact equivalence with the butterfly.

The four-step NTT (ntt/mxu.py) must be a DROP-IN for ntt/ntt.py — same
input layout, same bit-reversed eval order — so these tests require exact
uint32 equality against the butterfly transform at several rings, in every
matmul dtype, plus a round-trip and an end-to-end pointwise-product check.
"""

import numpy as np
import pytest
import jax.numpy as jnp

from fhe_fed_tpu.rns import primes, modops
from fhe_fed_tpu.ntt import tables as tables_mod
from fhe_fed_tpu.ntt import ntt as ntt_mod
from fhe_fed_tpu.ntt import mxu


def _setup(n, L, seed=0):
    mod = primes.ntt_primes(n, L)
    tb = tables_mod.make_tables(n, mod)
    mt = mxu.make_mxu_tables(n, tuple(mod))
    rng = np.random.default_rng(seed)
    x = jnp.asarray(rng.integers(0, np.array(mod)[:, None],
                                 size=(3, L, n)).astype(np.uint32))
    return mod, tb, mt, x


@pytest.mark.parametrize("n,L", [(256, 3), (8192, 5)])
def test_forward_matches_butterfly(n, L):
    mod, tb, mt, x = _setup(n, L)
    want = np.asarray(ntt_mod.ntt(x, tb))
    got = np.asarray(mxu.ntt_mxu(x, mt))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,L", [(256, 3), (8192, 5)])
def test_inverse_matches_butterfly(n, L):
    mod, tb, mt, x = _setup(n, L, seed=1)
    xe = ntt_mod.ntt(x, tb)                 # eval-domain input
    want = np.asarray(ntt_mod.intt(xe, tb))
    got = np.asarray(mxu.intt_mxu(xe, mt))
    np.testing.assert_array_equal(got, want)
    # and a pure MXU round-trip
    rt = np.asarray(mxu.intt_mxu(mxu.ntt_mxu(x, mt), mt))
    np.testing.assert_array_equal(rt, np.asarray(x))


@pytest.mark.parametrize("dtype", ["int8", "bf16", "f32"])
def test_matmul_dtypes_bit_exact(dtype):
    mod, tb, mt, x = _setup(2048, 4, seed=2)
    np.testing.assert_array_equal(np.asarray(mxu.ntt_mxu(x, mt, dtype)),
                                  np.asarray(ntt_mod.ntt(x, tb)))
    xe = ntt_mod.ntt(x, tb)
    np.testing.assert_array_equal(np.asarray(mxu.intt_mxu(xe, mt, dtype)),
                                  np.asarray(ntt_mod.intt(xe, tb)))


def test_negacyclic_product_via_mxu():
    """NTT -> pointwise mul -> iNTT through the four-step path must equal the
    schoolbook negacyclic product (the ntt.py convention contract)."""
    n, L = 256, 2
    mod = primes.ntt_primes(n, L)
    mt = mxu.make_mxu_tables(n, tuple(mod))
    rng = np.random.default_rng(3)
    a = rng.integers(0, np.array(mod)[:, None], size=(1, L, n)).astype(np.uint64)
    b = rng.integers(0, np.array(mod)[:, None], size=(1, L, n)).astype(np.uint64)

    ah = mxu.ntt_mxu(jnp.asarray(a.astype(np.uint32)), mt)
    bh = mxu.ntt_mxu(jnp.asarray(b.astype(np.uint32)), mt)
    mu = jnp.asarray(np.array([modops.barrett_precompute(int(q))
                               for q in mod], dtype=np.uint32))[:, None]
    ph = modops.mul_mod(ah, bh, mt.q[:, None], mu)
    got = np.asarray(mxu.intt_mxu(ph, mt)).astype(np.uint64)

    for l, q in enumerate(mod):
        ref = np.zeros(n, dtype=object)
        for i in range(n):
            for j in range(n):
                k = i + j
                s = 1 if k < n else -1
                ref[k % n] += s * int(a[0, l, i]) * int(b[0, l, j])
        ref = np.array([int(v) % q for v in ref], dtype=np.uint64)
        np.testing.assert_array_equal(got[0, l], ref)


def test_slice_limbs():
    mod, tb, mt, x = _setup(256, 4, seed=4)
    sub = mt.slice_limbs(1, 3)
    want = np.asarray(ntt_mod.ntt(x[:, 1:3], tb.slice_limbs(1, 3)))
    got = np.asarray(mxu.ntt_mxu(x[:, 1:3], sub))
    np.testing.assert_array_equal(got, want)

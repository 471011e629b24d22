"""CKKS end-to-end correctness.

Mirrors the reference's acceptance example pythonApi/ckks_example.py
(3 learners, weights 0.5/0.2/0.3, element-wise compare of homomorphic vs
plaintext weighted sum) plus encrypt/decrypt roundtrips, rescale, and scale
bookkeeping, at a reduced ring for test speed and at the production
batch=4096/scale=52 point.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from fhe_fed_tpu.ckks import params as P
from fhe_fed_tpu.ckks import keys as K
from fhe_fed_tpu.ckks import ops as O


def _small_ctx(scale_bits=40, mult_depth=1):
    p = P.make_params(batch=128, scale_bits=scale_bits,
                      mult_depth=mult_depth, ring_dim=256)
    return P.make_context(p)


def test_encrypt_decrypt_roundtrip_small():
    ctx = _small_ctx()
    sk, pk = K.keygen(ctx, seed=1)
    rng = np.random.default_rng(0)
    vals = rng.uniform(-1, 1, size=(4, 256)).astype(np.float32)
    ct = O.encrypt(ctx, pk, jnp.asarray(vals), jax.random.key(42))
    out = np.asarray(O.decrypt(ctx, sk, ct))
    # Fresh-encryption noise ~ CBD(20) -> error ~ 2**-34 at scale 2**40.
    np.testing.assert_allclose(out, vals, atol=2e-6)


def test_homomorphic_add():
    ctx = _small_ctx()
    sk, pk = K.keygen(ctx, seed=2)
    rng = np.random.default_rng(1)
    a = rng.uniform(-1, 1, size=(2, 256)).astype(np.float32)
    b = rng.uniform(-1, 1, size=(2, 256)).astype(np.float32)
    ca = O.encrypt(ctx, pk, jnp.asarray(a), jax.random.key(1))
    cb = O.encrypt(ctx, pk, jnp.asarray(b), jax.random.key(2))
    out = np.asarray(O.decrypt(ctx, sk, O.add(ctx, ca, cb)))
    np.testing.assert_allclose(out, a + b, atol=4e-6)


def test_scalar_mult_and_rescale():
    ctx = _small_ctx()
    sk, pk = K.keygen(ctx, seed=3)
    rng = np.random.default_rng(2)
    a = rng.uniform(-1, 1, size=(2, 256)).astype(np.float32)
    ca = O.encrypt(ctx, pk, jnp.asarray(a), jax.random.key(3))
    cw = O.mul_scalar(ctx, ca, 0.37)
    # Decrypt without rescale (scale tracked exactly).
    out = np.asarray(O.decrypt(ctx, sk, cw))
    np.testing.assert_allclose(out, 0.37 * a, atol=4e-6)
    # And with rescale.
    cr = O.rescale(ctx, cw)
    assert cr.level == 1 and cr.live_limbs == ca.live_limbs - 1
    assert abs(cr.scale - ctx.params.scale) < 1e-6 * ctx.params.scale
    out2 = np.asarray(O.decrypt(ctx, sk, cr))
    np.testing.assert_allclose(out2, 0.37 * a, atol=4e-6)


def test_weighted_average_3learners_small():
    """The reference acceptance test shape (pythonApi/ckks_example.py:91-111)."""
    ctx = _small_ctx()
    sk, pk = K.keygen(ctx, seed=4)
    rng = np.random.default_rng(3)
    weights = [0.5, 0.2, 0.3]
    data = [rng.random(size=(3, 256)).astype(np.float32) for _ in range(3)]
    cts = [O.encrypt(ctx, pk, jnp.asarray(d), jax.random.key(10 + i))
           for i, d in enumerate(data)]
    agg = O.weighted_sum(ctx, cts, weights)
    out = np.asarray(O.decrypt(ctx, sk, agg))
    want = sum(w * d for w, d in zip(weights, data))
    np.testing.assert_allclose(out, want, atol=1e-5)


@pytest.mark.slow
def test_weighted_average_production_params():
    """batch=4096, scale=52 — the reference's default config
    (binding.cpp:19-23), ring_dim 8192, full precision check."""
    p = P.make_params(batch=4096, scale_bits=52, mult_depth=1)
    assert p.ring_dim == 8192
    ctx = P.make_context(p)
    sk, pk = K.keygen(ctx, seed=5)
    rng = np.random.default_rng(4)
    weights = [0.5, 0.2, 0.3]
    data = [rng.random(size=(2, 8192)).astype(np.float32) for _ in range(3)]
    cts = [O.encrypt(ctx, pk, jnp.asarray(d), jax.random.key(20 + i))
           for i, d in enumerate(data)]
    agg = O.weighted_sum(ctx, cts, weights)
    out = np.asarray(O.decrypt(ctx, sk, agg))
    want = sum(w * d.astype(np.float64) for w, d in zip(weights, data))
    err = np.max(np.abs(out - want))
    # Internal CKKS precision is ~2**-30 or better; the f32 output dtype
    # quantizes values of magnitude ~1 at 2**-24, so that is the bound.
    assert err < 2 ** -22, f"max err {err:.3e}"


def test_encode_decode_exact_crt():
    """Encode/decode roundtrip is exact up to scale quantization."""
    from fhe_fed_tpu.ckks import encoding as E
    ctx = _small_ctx(scale_bits=52)
    rng = np.random.default_rng(5)
    vals = rng.uniform(-100, 100, size=(3, 256)).astype(np.float32)
    pt = E.encode_coeff(ctx, jnp.asarray(vals), 2.0 ** 52)
    out = np.asarray(E.decode_coeff(ctx, pt, 2.0 ** 52))
    np.testing.assert_allclose(out, vals, rtol=2e-7, atol=1e-11)


def test_symmetric_encrypt_roundtrip():
    ctx = _small_ctx()
    sk, pk = K.keygen(ctx, seed=7)
    rng = np.random.default_rng(5)
    vals = rng.uniform(-1, 1, size=(4, 256)).astype(np.float32)
    ct = O.encrypt_symmetric(ctx, sk, jnp.asarray(vals), jax.random.key(9))
    out = np.asarray(O.decrypt(ctx, sk, ct))
    np.testing.assert_allclose(out, vals, atol=2e-6)


def test_symmetric_mixes_with_public_in_weighted_sum():
    """Symmetric and public-key ciphertexts are the same RLWE object: the
    fused weighted average over a mix must decrypt to the weighted sum."""
    ctx = _small_ctx()
    sk, pk = K.keygen(ctx, seed=8)
    rng = np.random.default_rng(6)
    a = rng.uniform(-1, 1, size=(2, 256)).astype(np.float32)
    b = rng.uniform(-1, 1, size=(2, 256)).astype(np.float32)
    c = rng.uniform(-1, 1, size=(2, 256)).astype(np.float32)
    cts = [O.encrypt_symmetric(ctx, sk, jnp.asarray(a), jax.random.key(11)),
           O.encrypt(ctx, pk, jnp.asarray(b), jax.random.key(12)),
           O.encrypt_symmetric(ctx, sk, jnp.asarray(c), jax.random.key(13))]
    agg = O.weighted_sum(ctx, cts, [0.5, 0.2, 0.3])
    out = np.asarray(O.decrypt(ctx, sk, agg))
    np.testing.assert_allclose(out, 0.5 * a + 0.2 * b + 0.3 * c, atol=6e-6)

"""End-to-end sharded encrypted round (VERDICT r2 item 3).

encrypt -> fused weighted sum -> rescale -> decrypt entirely under
('limb', 'coeff') sharding at N = 32768 (a ring exceeding the 2*batch
minimum), verified BIT-EXACTLY against the single-chip path: the
distributed ciphertexts are converted to the on-chip layout and pushed
through ops.weighted_sum/_rescale/_decrypt; every intermediate residue
must match the sharded computation exactly.

Runs on the virtual 8-device CPU mesh (conftest forces cpu +
xla_force_host_platform_device_count=8).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from fhe_fed_tpu.ckks import params as P, keys as K, ops as O
from fhe_fed_tpu.ckks import dist_ckks as DC
from fhe_fed_tpu.ckks import encoding as E
from fhe_fed_tpu.ntt import dist as D


def _mesh(limb, coeff):
    devs = jax.devices()
    assert len(devs) >= limb * coeff
    return Mesh(np.array(devs[:limb * coeff]).reshape(limb, coeff),
                ("limb", "coeff"))


@pytest.fixture(scope="module")
def setup():
    # N = 32768: the "genuinely larger than one chip" ring of the VERDICT
    # item; small chunk count keeps the CPU-mesh test fast.
    params = P.make_params(batch=4096, scale_bits=40, mult_depth=1,
                           ring_dim=32768)
    ctx = P.make_context(params)
    sk, pk = K.keygen(ctx, seed=0)
    dt = D.make_dist_tables(params.ring_dim,
                            params.moduli[:params.chain_len])
    mesh = _mesh(2, 4)
    ds = D.DistSpec(mesh=mesh, limb_axis="limb")
    sk_d = DC.sk_to_dist(sk, dt.n1)
    return params, ctx, sk, sk_d, dt, ds


@pytest.mark.slow
def test_sharded_round_bit_exact_vs_onchip(setup):
    params, ctx, sk, sk_d, dt, ds = setup
    n = params.ring_dim
    chain = params.chain_len
    Kc, chunks = 3, 2
    weights = [0.5, 0.2, 0.3]
    rng = np.random.default_rng(0)
    values = jnp.asarray(rng.standard_normal((Kc, chunks, n))
                         .astype(np.float32) * 0.1)

    # --- sharded path: encrypt all clients in the dist layout ---
    with ds.mesh:
        flat = values.reshape(Kc * chunks, n)
        cts_d = DC.encrypt_symmetric_dist(ctx, dt, ds, sk_d, flat,
                                          jax.random.key(7),
                                          float(params.scale))
        cts_d = jax.block_until_ready(cts_d)
    stacked_d = cts_d.reshape(Kc, chunks, *cts_d.shape[1:])

    dscale = float(params.moduli[chain - 1])
    res_l, shoup_l = zip(*(E.encode_scalar(params.moduli[:chain], w, dscale)
                           for w in weights))
    w_res = jnp.asarray(np.stack(res_l))
    w_shoup = jnp.asarray(np.stack(shoup_l))

    with ds.mesh:
        agg_d = weighted_sum_d = DC.weighted_sum_dist(ctx, stacked_d, w_res,
                                                      w_shoup)
        res_d = DC.rescale_dist(ctx, dt, ds, agg_d)
        out_scale = float(params.scale) * dscale / dscale
        dec_d = DC.decrypt_dist(ctx, dt, ds, sk_d, res_d, out_scale)
        dec_d = np.asarray(jax.block_until_ready(dec_d))

    # --- on-chip path on the SAME ciphertexts (layout-converted) ---
    stacked_oc = DC.ct_dist_to_onchip(np.asarray(stacked_d))
    ct_oc = O.Ciphertext(data=jnp.asarray(stacked_oc),
                         scale=float(params.scale), level=0)
    agg_oc = O.weighted_sum(ctx, ct_oc, weights)
    res_oc = O.rescale(ctx, agg_oc)

    # 1. weighted-sum residues bit-exact (eval domain, layout-converted).
    np.testing.assert_array_equal(
        DC.ct_dist_to_onchip(np.asarray(weighted_sum_d)),
        np.asarray(agg_oc.data))
    # 2. rescale residues bit-exact.
    np.testing.assert_array_equal(
        DC.ct_dist_to_onchip(np.asarray(res_d)),
        np.asarray(res_oc.data))
    # 3. decrypt: decoded floats bit-exact between paths.
    dec_oc = np.asarray(O.decrypt(ctx, sk, res_oc))
    np.testing.assert_array_equal(dec_d, dec_oc)

    # 4. end-to-end correctness vs the plaintext average.
    want = np.tensordot(np.asarray(weights),
                        np.asarray(values, dtype=np.float64), axes=1)
    err = np.max(np.abs(dec_d - want))
    assert err < 1e-3, err


def test_dist_automorphism_matches_onchip(setup):
    """Rotation data movement under coefficient sharding: the dist-layout
    automorphism (one sharded row permutation + a local column gather) must
    match the on-chip eval-domain automorphism bit-exactly for rotation and
    conjugation elements."""
    from fhe_fed_tpu.ckks import keyswitch as KS
    params, ctx, sk, sk_d, dt, ds = setup
    n = params.ring_dim
    chain = params.chain_len
    rng = np.random.default_rng(2)
    x = rng.integers(0, min(params.moduli[:chain]),
                     size=(2, chain, n)).astype(np.uint32)
    x_dist = jnp.asarray(D.eval_to_dist(x, dt.n1))
    for g in (KS.galois_element(1, n), KS.galois_element(5, n),
              KS.conj_element(n)):
        want = np.asarray(KS.automorphism(jnp.asarray(x), n, g))
        with ds.mesh:
            got_d = jax.jit(
                lambda v, gg=g: DC.dist_automorphism(v, gg, dt, ds))(x_dist)
            got_d = np.asarray(jax.block_until_ready(got_d))
        np.testing.assert_array_equal(D.dist_to_eval(got_d), want)


def test_full_step_and_collectives(setup):
    """make_dist_fed_step end-to-end + the all-to-all is actually in the
    compiled HLO (the NTT stage exchange rides one collective)."""
    params, ctx, sk, sk_d, dt, ds = setup
    n = params.ring_dim
    Kc, chunks = 4, 1
    weights = [0.25] * Kc
    rng = np.random.default_rng(1)
    values = jnp.asarray(rng.standard_normal((Kc, chunks, n))
                         .astype(np.float32) * 0.05)
    step = DC.make_dist_fed_step(ctx, dt, ds, weights)
    with ds.mesh:
        out = np.asarray(jax.block_until_ready(
            step(sk_d, values, jax.random.key(3))))
        want = np.asarray(values, dtype=np.float64).mean(axis=0)
        assert np.max(np.abs(out - want)) < 1e-3
        hlo = step.lower(sk_d, values, jax.random.key(3)) \
                  .compile().as_text()
    assert "all-to-all" in hlo, "NTT stage exchange must be an all-to-all"


@pytest.mark.slow
def test_sharded_round_n65536():
    """The ring that genuinely exceeds one chip: at N=65536 the working set
    of one NTT batch at production limb counts (~chunks x L x 256 KiB
    x several plane temporaries) outgrows a single device's fast memory, so
    the ('limb','coeff') layout is the deployment layout, not an option.
    Same bit-exactness contract as the N=32768 round above, one chunk to
    keep the CPU-mesh run fast."""
    params = P.make_params(batch=4096, scale_bits=40, mult_depth=1,
                           ring_dim=65536)
    ctx = P.make_context(params)
    sk, _pk = K.keygen(ctx, seed=3)
    dt = D.make_dist_tables(params.ring_dim,
                            params.moduli[:params.chain_len])
    mesh = _mesh(2, 4)
    ds = D.DistSpec(mesh=mesh, limb_axis="limb")
    sk_d = DC.sk_to_dist(sk, dt.n1)

    n = params.ring_dim
    chain = params.chain_len
    Kc, chunks = 2, 1
    weights = [0.75, 0.25]
    rng = np.random.default_rng(65536)
    values = jnp.asarray(rng.standard_normal((Kc, chunks, n))
                         .astype(np.float32) * 0.1)

    with ds.mesh:
        flat = values.reshape(Kc * chunks, n)
        cts_d = jax.block_until_ready(DC.encrypt_symmetric_dist(
            ctx, dt, ds, sk_d, flat, jax.random.key(11),
            float(params.scale)))
    stacked_d = cts_d.reshape(Kc, chunks, *cts_d.shape[1:])

    dscale = float(params.moduli[chain - 1])
    res_l, shoup_l = zip(*(E.encode_scalar(params.moduli[:chain], w, dscale)
                           for w in weights))
    w_res = jnp.asarray(np.stack(res_l))
    w_shoup = jnp.asarray(np.stack(shoup_l))

    with ds.mesh:
        agg_d = DC.weighted_sum_dist(ctx, stacked_d, w_res, w_shoup)
        res_d = DC.rescale_dist(ctx, dt, ds, agg_d)
        dec_d = np.asarray(jax.block_until_ready(
            DC.decrypt_dist(ctx, dt, ds, sk_d, res_d, float(params.scale))))

    stacked_oc = DC.ct_dist_to_onchip(np.asarray(stacked_d))
    ct_oc = O.Ciphertext(data=jnp.asarray(stacked_oc),
                         scale=float(params.scale), level=0)
    res_oc = O.rescale(ctx, O.weighted_sum(ctx, ct_oc, weights))
    np.testing.assert_array_equal(
        DC.ct_dist_to_onchip(np.asarray(res_d)), np.asarray(res_oc.data))
    np.testing.assert_array_equal(dec_d, np.asarray(O.decrypt(ctx, sk,
                                                              res_oc)))
    want = np.tensordot(np.asarray(weights),
                        np.asarray(values, dtype=np.float64), axes=1)
    assert np.max(np.abs(dec_d - want)) < 1e-3

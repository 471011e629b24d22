"""One implementation per op on every backend: neither the retired
environment switches nor the reported backend change which NTT, decode or
sampling PRNG runs."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from fhe_fed_tpu import CKKS
from fhe_fed_tpu.ckks import params as P, encoding as E, ops as O
from fhe_fed_tpu.ntt import ntt as NTT

RETIRED = {"FHE_FED_TPU_PALLAS": "1", "FHE_FED_TPU_NO_MXU": "1",
           "FHE_FED_TPU_MXU_DTYPE": "bf16", "FHE_FED_TPU_FUSED_DECODE": "1",
           "FHE_FED_TPU_MXU_DECODE": "1", "FHE_FED_TPU_PRNG": "rbg"}


def _programs():
    """Jaxprs of the main path's ops on a freshly built context, plus the
    sampling PRNG a new CKKS helper gets."""
    params = P.make_params(batch=128, scale_bits=52, mult_depth=1,
                           ring_dim=256)
    ctx = P.make_context(params)
    x = jnp.zeros((2, params.chain_len, 256), jnp.uint32)
    stacked = jnp.zeros((3, 2, 2, params.chain_len, 256), jnp.uint32)
    w = jnp.zeros((3, params.chain_len), jnp.uint32)
    progs = {
        "ntt": jax.make_jaxpr(NTT.ntt)(x, ctx.tables.slice_limbs(0, 4)),
        "intt": jax.make_jaxpr(NTT.intt)(x, ctx.tables.slice_limbs(0, 4)),
        "decode": jax.make_jaxpr(
            lambda c, r: E.decode_coeff(c, r, 2.0 ** 52))(ctx, x),
        "weighted_sum": jax.make_jaxpr(O._weighted_sum_impl)(
            ctx, stacked, w, w),
    }
    helper = CKKS("ckks", 128, 52, cryptodir="unused", seed=1)
    return ({k: str(v) for k, v in progs.items()},
            str(jax.random.key_impl(helper._rng)))


@pytest.fixture(scope="module")
def baseline():
    return _programs()


def test_retired_env_switches_change_nothing(baseline, monkeypatch):
    for k, v in RETIRED.items():
        monkeypatch.setenv(k, v)
    progs, impl = _programs()
    assert progs == baseline[0]
    assert impl == baseline[1] and "threefry" in impl


@pytest.mark.parametrize("backend", ["gpu", "tpu"])
def test_reported_backend_changes_nothing(baseline, monkeypatch, backend):
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    progs, impl = _programs()
    assert progs == baseline[0]
    assert impl == baseline[1] and "threefry" in impl


@pytest.mark.parametrize("k", [3, 16])
def test_weighted_sum_matches_uint64_reference(k):
    """Both lowerings of the weighted sum (unrolled K <= 8, modsum
    K > 8) equal sum_i w_i * c_i mod q computed in numpy uint64."""
    params = P.make_params(batch=128, scale_bits=52, mult_depth=1,
                           ring_dim=256)
    ctx = P.make_context(params)
    L = params.chain_len
    q = np.asarray(params.moduli[:L], dtype=np.uint64)
    rng = np.random.default_rng(k)
    stacked = rng.integers(0, q[:, None], size=(k, 3, 2, L, 256),
                           dtype=np.uint64)
    ws = rng.random(k)
    res, sh = zip(*(E.encode_scalar(params.moduli[:L], float(wi),
                                    O._scalar_scale(ctx, 0)) for wi in ws))
    w = np.stack(res).astype(np.uint64)                 # (k, L)
    want = np.zeros(stacked.shape[1:], dtype=np.uint64)
    for i in range(k):
        want = (want + stacked[i] * w[i][:, None] % q[:, None]) % q[:, None]
    got = O._weighted_sum_impl(ctx, jnp.asarray(stacked.astype(np.uint32)),
                               jnp.asarray(np.stack(res)),
                               jnp.asarray(np.stack(sh)))
    np.testing.assert_array_equal(np.asarray(got), want.astype(np.uint32))

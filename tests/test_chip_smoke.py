"""chip_smoke.py: refuses to run without a GPU, and its kernel phase
passes on agreeing devices and raises on one flipped residue. The phase
runs here on two CPU devices at ring 256; on the card, the `gpu` test
below runs it against the CPU backend at the production ring."""

import os
import subprocess
import sys

import pytest
import jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke as CS  # noqa: E402


def test_exits_nonzero_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


@pytest.fixture(scope="module")
def small():
    from fhe_fed_tpu.ckks import params as P, keys as K
    params = P.make_params(batch=128, scale_bits=52, mult_depth=1,
                           ring_dim=256)
    ctx = P.make_context(params)
    sk, _ = K.keygen(ctx, seed=0)
    return ctx, sk, CS.kernel_cases(ctx, sk, chunks=2)


def test_kernel_phase_passes_on_agreeing_devices(small):
    ctx, sk, cases = small
    devs = jax.devices("cpu")
    assert [c[0].split(" ")[0] for c in cases] == [
        "ntt", "intt", "ntt", "intt", "weighted_sum", "weighted_sum",
        "encrypt_symmetric_stacked", "decode_coeff"]
    CS.compare_cases(cases, devs[1], devs[0])


@pytest.mark.parametrize("which", [0, 5, 7])   # ntt, K=16 sum, decode
def test_kernel_phase_raises_on_one_flipped_residue(small, which):
    ctx, sk, cases = small
    devs = jax.devices("cpu")
    name, fn, args = cases[which]

    def flipped(*a):
        out = fn(*a)
        if out.devices() != {devs[1]}:
            return out
        first = (0,) * out.ndim
        bump = 1 if out.dtype.kind == "u" else 2.0 ** -20
        return out.at[first].set(out[first] + bump)

    bad = list(cases)
    bad[which] = (name, flipped, args)
    with pytest.raises(CS.SmokeFailure, match=name.split(" ")[0]):
        CS.compare_cases(bad, devs[1], devs[0])


@pytest.fixture
def gpu():
    devs = [d for d in jax.devices() if d.platform == "gpu"]
    if not devs:
        pytest.skip("needs a GPU: run with `-m gpu` on the card")
    return devs[0]


@pytest.mark.gpu
def test_kernels_match_cpu_on_card(gpu):
    from fhe_fed_tpu.ckks import params as P, keys as K
    params = P.make_params(batch=4096, scale_bits=52, mult_depth=1)
    ctx = P.make_context(params)
    sk, _ = K.keygen(ctx, seed=0)
    CS.compare_cases(CS.kernel_cases(ctx, sk, chunks=8), gpu,
                     jax.devices("cpu")[0])

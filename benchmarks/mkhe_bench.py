"""Single-key vs threshold CKKS timing — `mk-test` CLI parity
(reference code/mkhe/mkhe.cpp:52-94: `mk-test <model_size> <client_size>`
times RunSingleKeyCKKS then RunCKKS with N-party threshold keys).

Usage: python -m benchmarks.mkhe_bench <model_size> <client_size>
"""

from __future__ import annotations

import sys
import time

import numpy as np
import jax
import jax.numpy as jnp

from fhe_fed_tpu.ckks import params as P
from fhe_fed_tpu.ckks import keys as K
from fhe_fed_tpu.ckks import keyswitch as KS
from fhe_fed_tpu.ckks import ops as O
from fhe_fed_tpu.ckks import threshold as T
from fhe_fed_tpu.utils.compile_cache import enable_compile_cache
from .common import append_jsonl

enable_compile_cache()


def _chunk(vals: np.ndarray, cap: int, n: int) -> jnp.ndarray:
    chunks = -(-vals.size // cap)
    buf = np.zeros((chunks, n), dtype=np.float32)
    pay = buf[:, :cap].reshape(-1)
    pay[:vals.size] = vals
    buf[:, :cap] = pay.reshape(chunks, cap)
    return jnp.asarray(buf)


def run_single_key(model_size: int, ctx, batch: int) -> dict:
    """RunSingleKeyCKKS (mkhe.cpp:96-185): keygen, encrypt, x0.5, +, dec."""
    t0 = time.time()
    sk, pk = K.keygen(ctx, seed=0)
    t_keygen = time.time() - t0
    rng = np.random.default_rng(0)
    v = rng.standard_normal(model_size).astype(np.float32)
    vals = _chunk(v, batch, ctx.ring_dim)

    t0 = time.time()
    ct = O.encrypt(ctx, pk, vals, jax.random.key(1))
    jax.block_until_ready(ct.data)
    t_enc = time.time() - t0

    t0 = time.time()
    h = O.mul_scalar(ctx, ct, 0.5)
    h = O.add(ctx, h, h)
    jax.block_until_ready(h.data)
    t_eval = time.time() - t0

    t0 = time.time()
    out = np.asarray(O.decrypt(ctx, sk, h))
    t_dec = time.time() - t0
    err = np.abs(out[:, :batch].reshape(-1)[:model_size] - v).max()
    return {"mode": "single", "keygen": t_keygen, "encrypt": t_enc,
            "eval": t_eval, "decrypt": t_dec, "max_err": float(err),
            "log2_precision": round(O.log2_precision(
                out[:, :batch].reshape(-1)[:model_size], v), 2)}


def run_threshold(model_size: int, client_size: int, ctx,
                  batch: int) -> dict:
    """RunCKKS (mkhe.cpp:188-465): chained keygen, joint encrypt, eval,
    per-party partial decrypt + fusion — all via the batched/jitted
    ceremonies (threshold.py), one dispatch each; the per-party protocol
    functions are residue-identical (tests/test_threshold.py) but eager:
    one device dispatch per op."""
    t0 = time.time()
    sec, pk = T.multiparty_keygen_batched(ctx, client_size, seed=1)
    jax.block_until_ready(pk.p0)
    t_keygen = time.time() - t0

    # joint eval-mult key: the two-round MultiKeySwitchGen /
    # MultiMultEvalKey / MultiAddEvalMultKeys ceremony (mkhe.cpp:281-317)
    t0 = time.time()
    rlk = T.multiparty_relin_key_batched(ctx, sec, common_seed=2, seed=1)
    jax.block_until_ready(rlk.b)
    t_evalkey = time.time() - t0

    rng = np.random.default_rng(1)
    v = rng.standard_normal(model_size).astype(np.float32)
    vals = _chunk(v, batch, ctx.ring_dim)

    t0 = time.time()
    ct = O.encrypt(ctx, pk, vals, jax.random.key(2))
    jax.block_until_ready(ct.data)
    t_enc = time.time() - t0

    t0 = time.time()
    h = O.mul_scalar(ctx, ct, 0.5)
    h = O.add(ctx, h, h)
    jax.block_until_ready(h.data)
    t_eval = time.time() - t0

    # ct x ct + relinearize under the JOINT key (exceeds the reference's
    # scalar-only circuit; proves the joint relin key at these params)
    t0 = time.time()
    sq = O.rescale(ctx, KS.mul_ct(ctx, ct, ct, rlk))
    jax.block_until_ready(sq.data)
    t_mul_relin = time.time() - t0

    # MultipartyDecryptLead/Main + Fusion (mkhe.cpp:392-402): all parties'
    # partials + fusion + decode as ONE dispatch (same keys as the
    # per-party path: lead key 10, mains 11+i).
    dec_keys = T.stack_keys(
        [jax.random.key(10)] + [jax.random.key(11 + i)
                                for i in range(client_size - 1)])
    t0 = time.time()
    out = np.asarray(T.threshold_decrypt(ctx, sec, h, dec_keys))
    t_dec = time.time() - t0
    err = np.abs(out[:, :batch].reshape(-1)[:model_size] - v).max()
    return {"mode": "threshold", "parties": client_size,
            "keygen": t_keygen, "joint_evalkey": t_evalkey,
            "encrypt": t_enc, "eval": t_eval,
            "mul_relin_joint": t_mul_relin,
            "decrypt": t_dec, "max_err": float(err),
            "log2_precision": round(O.log2_precision(
                out[:, :batch].reshape(-1)[:model_size], v), 2)}


def main(argv=None):
    """mk-test parity: `mkhe_bench <model_size> <client_size>...` — one
    single-key pass plus a threshold pass per requested party count."""
    argv = argv if argv is not None else sys.argv[1:]
    model_size = int(argv[0]) if argv else 100_000
    client_sizes = [int(a) for a in argv[1:]] or [3]
    batch = 4096
    # depth 2 / ~51-bit scale mirror of genCryptoContextCKKS at
    # mkhe.cpp:204-215
    params = P.make_params(batch=batch, scale_bits=51, mult_depth=2)
    ctx = P.make_context(params)

    # Warmup pass compiles everything (untimed — the reference's mkhe is AOT
    # C++, mkhe.cpp:64-90 chrono around already-compiled calls), then the
    # measured pass runs with warm executables. Only measured rows are
    # written: the committed jsonl is REWRITTEN, never appended, so stale
    # or warm-up rows cannot sit next to the quoted numbers.
    run_single_key(model_size, ctx, batch)
    single = run_single_key(model_size, ctx, batch)
    rows = [single]
    for client_size in client_sizes:
        run_threshold(model_size, client_size, ctx, batch)
        rows.append(run_threshold(model_size, client_size, ctx, batch))
    for r in rows:
        r.update(model_size=model_size, ring_dim=params.ring_dim,
                 pass_="measured", backend=jax.default_backend())
        print(r)
    from .common import rewrite_jsonl
    rewrite_jsonl("mkhe_bench.jsonl", rows)
    return rows


if __name__ == "__main__":
    main()

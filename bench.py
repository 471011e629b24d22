"""Headline benchmark: encrypted FedAvg of the reference's CNN-scale model
(1,663,370 params — CNN_OriginalFedAvg, benchmark.py:152-219) across 3
clients at the production crypto point (batchSize=4096, scaleFactorBits=52,
binding.cpp:19-23).

Reference baseline: 2.456 s total secure-agg wall-clock on CPU
(figs/processing.py:37-48, BASELINE.md). Methodology mirrors the reference's
own accounting (benchmark_crypto.py):
  * encryption time is divided by N — clients encrypt in parallel in
    deployment (benchmark_crypto.py:192 `time_enc = (...)/N`);
  * phases are averaged over n_times rounds (benchmark_crypto.py:151,235-239
    `for i_try in range(n_times): ... t_enc/n_times`), which amortizes
    per-dispatch latency exactly as the reference amortizes its per-call
    overheads. A warmup round excludes XLA compile time (PALISADE is
    AOT-compiled C++).

Each phase is measured REPS times (a block of N_TIMES pipelined rounds per
repetition) and the MEDIAN across repetitions is reported. Keys are
committed fixtures (results/bench_keys_headline/) mirroring the reference's
committed key files (resources/cryptoparams/key-*.txt, ckks.cpp:41-56), so
the timed Init is loadCryptoParams from files, as the reference's is
(ckks.cpp:11-23). If the fixtures are missing, keygen runs in this process
before anything is timed; the whole run uses one process, so one card.

Prints ONE JSON line.
"""

import json
import os
import statistics
import time

import numpy as np
import jax
import jax.numpy as jnp

from fhe_fed_tpu.utils.compile_cache import enable_compile_cache

enable_compile_cache()

CNN_PARAMS = 1_663_370
N_CLIENTS = 3
N_TIMES = 16         # rounds per measurement block (benchmark_crypto.py n_times)
REPS = 5             # measurement blocks; median across blocks is reported
BASELINE_S = 2.456
# Coefficient packing has no N/2 slot limit (no canonical embedding needed
# for the add/scalar-mult-only FedAvg pipeline): the full ring carries
# payload, halving ciphertext count and bytes vs PALISADE's batch=N/2.
# Ring dim, scale, and security level are unchanged; values_per_ct is
# disclosed in the emitted config. FHE_FED_BENCH_DENSE=0 runs the
# like-for-like 4096-values-per-ct variant (407 chunks).
DENSE_PACK = os.environ.get("FHE_FED_BENCH_DENSE", "1") != "0"

# Anchored to this file, not the CWD.
KEY_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "results", "bench_keys_headline")
SK_PATH = os.path.join(KEY_DIR, "key-private.txt")
PK_PATH = os.path.join(KEY_DIR, "key-public.txt")


def keygen_fixtures():
    """Cold path: generate + persist the key fixtures (before any timing)."""
    from fhe_fed_tpu.ckks import params as P, keys as K
    from fhe_fed_tpu.ckks import serial as S

    params = P.make_params(batch=4096, scale_bits=52, mult_depth=1)
    ctx = P.make_context(params)
    sk, pk = K.keygen(ctx, seed=0)
    jax.block_until_ready((sk.s, pk.p0))
    os.makedirs(KEY_DIR, exist_ok=True)
    with open(SK_PATH, "wb") as f:
        f.write(S.serialize_secret_key(ctx, sk))
    with open(PK_PATH, "wb") as f:
        f.write(S.serialize_public_key(ctx, pk))


def main():
    from fhe_fed_tpu.ckks import params as P, keys as K, ops as O
    from fhe_fed_tpu.ckks import serial as S

    keygen_s = None
    if not (os.path.exists(SK_PATH) and os.path.exists(PK_PATH)):
        t0 = time.time()
        keygen_fixtures()
        keygen_s = time.time() - t0

    # Backend warmup: first device contact is process startup, the analogue
    # of loading the PALISADE shared library — not timed by the reference
    # either (its Init timer starts at genCryptoContext,
    # benchmark_crypto.py:170).
    jax.block_until_ready(jnp.zeros((), jnp.uint32) + 1)

    # Init: context build + key load (the reference's measured Init is
    # loadCryptoParams — deserialize context/keys from files, ckks.cpp:11-23,
    # 0.16-0.20 s in nvidia_results.txt). Measured twice and reported
    # split: the FIRST pass on a cold persistent cache also compiles the
    # batched-transfer unpack programs (devput.py) — that is
    # first-compile, the reference's analogue being its AOT C++ build, not
    # its Init. The second pass (warm executables, same file reads + host
    # work + transfers) is the number comparable to loadCryptoParams.
    def run_init():
        t0 = time.time()
        params = P.make_params(batch=4096, scale_bits=52, mult_depth=1)
        ctx = P.make_context(params)
        with open(SK_PATH, "rb") as f:
            sk = S.deserialize_secret_key(f.read())
        with open(PK_PATH, "rb") as f:
            pk = S.deserialize_public_key(f.read())
        jax.block_until_ready((ctx.tables.tab, sk.s, pk.p0))
        return time.time() - t0, params, ctx, sk, pk

    init_first_s, *_ = run_init()
    init_s, params, ctx, sk, pk = run_init()

    cap = params.ring_dim if DENSE_PACK else params.batch
    chunks = -(-CNN_PARAMS // cap)
    n = params.ring_dim
    rng = np.random.default_rng(0)
    weights = [1.0 / N_CLIENTS] * N_CLIENTS

    def make_client(i):
        buf = np.zeros((chunks, n), dtype=np.float32)
        flat = rng.standard_normal(CNN_PARAMS).astype(np.float32) * 0.1
        pay = buf[:, :cap].reshape(-1)
        pay[:CNN_PARAMS] = flat
        buf[:, :cap] = pay.reshape(chunks, cap)
        return jnp.asarray(buf), flat

    clients = [make_client(i) for i in range(N_CLIENTS)]
    # All clients' payloads as one (K, chunks, N) array — the cohort is
    # encrypted in ONE dispatch per round.
    stacked_vals = jnp.stack([v for v, _ in clients])

    def run_block(tag, rounds, symmetric=True):
        """One measurement block: `rounds` pipelined rounds per phase, one
        device sync per phase. Returns per-round phase means + a decrypt."""
        # Per-round PRNG keys, materialized before the timer (seeding is not
        # a timed phase in the reference either — benchmark_crypto.py:167).
        round_keys = list(jax.random.split(jax.random.key(tag), rounds))
        jax.block_until_ready(round_keys)

        # Encrypt: ONE dispatch per round covering all N clients, one device
        # sync per block — averaged per round and divided by N (clients run
        # in parallel in deployment, benchmark_crypto.py:192).
        # Secret-key encryption by default: every learner holds sk in the
        # reference protocol (ckks.cpp:11-23 loads key-private everywhere),
        # and sk-encryption needs one NTT batch instead of four.
        enc_t = time.time()
        cts_per_round = []
        for r in range(rounds):
            if symmetric:
                ct = O.encrypt_symmetric_stacked(ctx, sk, stacked_vals,
                                                 round_keys[r])
            else:
                ct = O.encrypt_stacked(ctx, pk, stacked_vals, round_keys[r])
            cts_per_round.append(ct)
        jax.block_until_ready([c.data for c in cts_per_round])
        enc_s = (time.time() - enc_t) / rounds / N_CLIENTS

        agg_t = time.time()
        aggs = [O.weighted_sum(ctx, ct, weights) for ct in cts_per_round]
        jax.block_until_ready([a.data for a in aggs])
        agg_s = (time.time() - agg_t) / rounds

        dec_t = time.time()
        outs = [O.decrypt(ctx, sk, a) for a in aggs]
        outs = jax.block_until_ready(outs)
        dec_s = (time.time() - dec_t) / rounds
        return enc_s, agg_s, dec_s, np.asarray(outs[0])

    # Warmup (compile + post-compile steady state), then REPS measured
    # blocks; report the per-phase MEDIAN across blocks.
    run_block(1, 2)
    run_block(100, 2)
    blocks = [run_block(2 + i, N_TIMES) for i in range(REPS)]
    enc_s = statistics.median(b[0] for b in blocks)
    agg_s = statistics.median(b[1] for b in blocks)
    dec_s = statistics.median(b[2] for b in blocks)
    out = blocks[0][3]

    run_block(3, 1, symmetric=False)    # warmup pk path
    pk_blocks = [run_block(4 + i, N_TIMES, symmetric=False) for i in range(3)]
    enc_pk_s = statistics.median(b[0] for b in pk_blocks)

    # Fused one-dispatch round (the deployment shape): encrypt of all N
    # clients -> fused weighted sum -> decrypt as ONE XLA computation, so
    # per-dispatch latency is paid once per round instead of once per
    # phase. Reported alongside (not in) the headline, whose phase split
    # mirrors the reference's accounting (benchmark_crypto.py:183-239).
    def run_fused_block(tag, rounds):
        keys = list(jax.random.split(jax.random.key(tag), rounds))
        jax.block_until_ready(keys)
        t0 = time.time()
        outs = [O.fedavg_round_fused(ctx, sk, stacked_vals, k, weights)
                for k in keys]
        outs = jax.block_until_ready(outs)
        return (time.time() - t0) / rounds, np.asarray(outs[0])

    run_fused_block(200, 2)
    fused_blocks = [run_fused_block(201 + i, N_TIMES) for i in range(3)]
    fused_s = statistics.median(b[0] for b in fused_blocks)
    fused_out = fused_blocks[0][1]

    # Correctness guard: decrypted average matches plaintext average —
    # for the staged path AND the fused one-dispatch round.
    want = sum(w * f for w, (_, f) in zip(weights, clients))
    flat_out = out[:, :cap].reshape(-1)[:CNN_PARAMS]
    err = float(np.max(np.abs(flat_out - want)))
    err_fused = float(np.max(np.abs(
        fused_out[:, :cap].reshape(-1)[:CNN_PARAMS] - want)))
    err = max(err, err_fused)
    total = enc_s + agg_s + dec_s

    print(json.dumps({
        "metric": "fedavg_cnn1.66M_3clients_enc_agg_dec",
        "value": round(total, 4),
        "unit": "s",
        "vs_baseline": round(BASELINE_S / total, 2),
        "phases": {"init": round(init_s, 4),
                   "init_warm_load": round(init_s, 4),
                   "init_first_incl_compile": round(init_first_s, 4),
                   "encrypt": round(enc_s, 4),
                   "aggregate": round(agg_s, 4), "decrypt": round(dec_s, 4),
                   "encrypt_publickey": round(enc_pk_s, 4),
                   "round_fused_1dispatch": round(fused_s, 4),
                   **({"keygen_cold": round(keygen_s, 4)}
                      if keygen_s is not None else {})},
        "max_err": err,
        "config": {"batch": 4096, "scale_bits": 52, "ring_dim": params.ring_dim,
                   "limbs": params.num_limbs, "chunks": chunks,
                   "values_per_ct": cap, "n_times": N_TIMES, "reps": REPS,
                   "stat": "median_of_blocks", "enc_divided_by_n": True,
                   "backend": jax.default_backend(),
                   "device_kind": jax.devices()[0].device_kind,
                   "device_count": len(jax.devices())},
    }))


if __name__ == "__main__":
    main()

"""Selective-encryption sweep at device speed (reference
benchmark_selection.py / benchmark_selection_rate.py): encrypt only the
first `rate` fraction of each tensor (benchmark_selection_rate.py:134-139),
aggregate the remainder in plaintext (benchmark_selection.py:152-158), and
measure per-rate round time and upload bytes.

Methodology matches model_bench's cohort accounting: client payloads are
staged on device before the timers (the reference's flatten prep is outside
its encrypt timer too, benchmark_crypto.py:159 vs :183), the encrypted
slice runs the fused one-dispatch round (ops.fedavg_round_fused, streamed
over max_chunks slices for BERT-scale models), and the plaintext remainder
is a jitted weighted sum. The per-client bytes wire path is measured as
ONE explicitly labeled `path: "bytes_wire"` row.

Writes results/selective.jsonl (REWRITTEN each run — measured rows only;
consumed by benchmarks.figures).

Usage: python -m benchmarks.selective_bench [--models cnn_fedavg resnet50]
       [--rates 0.1 0.5 1.0] [--clients 3] [--reps 3] [--bytes-row]
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import jax
import jax.numpy as jnp

from fhe_fed_tpu import CKKS, flatten_params, SelectivePolicy
from fhe_fed_tpu.fed.fedavg import split_by_policy, merge_by_policy
from fhe_fed_tpu import models
from fhe_fed_tpu.utils.compile_cache import enable_compile_cache
from .common import append_jsonl, rewrite_jsonl, results_dir

enable_compile_cache()


@jax.jit
def _plain_weighted_sum(w, stacked):
    # elementwise multiply-add (no matmul: f32 matmuls may default to
    # reduced precision, bf16 or TF32, which would cost precision for free)
    return jnp.sum(w[:, None] * stacked, axis=0)


def bench_rate(helper: CKKS, model: str, rate: float, clients_flat,
               spec, weights, max_chunks: int, reps: int) -> dict:
    n = clients_flat[0].size
    policy = SelectivePolicy(rate=rate)
    encs, plains, plan = [], [], None
    for f in clients_flat:
        e, pl, plan = split_by_policy(f, spec, policy)
        encs.append(e)
        plains.append(pl)
    enc_n, plain_n = encs[0].size, plains[0].size
    w_dev = jnp.asarray(np.asarray(weights, np.float32))

    # stage on device (host prep, untimed — see module docstring)
    packed = helper.pack_cohort(encs) if enc_n else None
    plains_dev = (jnp.asarray(np.stack(plains)) if plain_n else None)
    jax.block_until_ready([x for x in (packed, plains_dev)
                           if x is not None])

    chunks = packed.shape[1] if enc_n else 0
    mc = min(max_chunks, chunks) if chunks else 0
    if chunks:
        pad = (-chunks) % mc
        if pad:
            packed = jnp.pad(packed, ((0, 0), (0, pad), (0, 0)))

    def one_round():
        outs = []
        if chunks:
            for s in range(0, chunks + (-chunks) % mc, mc):
                outs.append(helper._round_slice(
                    packed[:, s:s + mc], weights, fused=True))
        plain = (_plain_weighted_sum(w_dev, plains_dev)
                 if plain_n else None)
        return outs, plain

    one_round()                       # warmup: exclude XLA compile
    t0 = time.time()
    for _ in range(reps):
        res = one_round()
    jax.block_until_ready(res)
    round_s = (time.time() - t0) / reps

    # host fetch + merge (the server->client comm leg, reported separately)
    t0 = time.time()
    outs, plain = res
    enc_out = (helper._unpack(
        np.concatenate([np.asarray(d) for d in outs], axis=0), enc_n)
        .astype(np.float32) if chunks else np.zeros(0, np.float32))
    plain_out = (np.asarray(plain) if plain_n
                 else np.zeros(0, np.float32))
    fetch_s = time.time() - t0
    got = merge_by_policy(enc_out, plain_out, plan)
    want = np.mean(np.stack(clients_flat), axis=0)
    err = float(np.max(np.abs(got - want)))

    p = helper.ctx.params
    k = len(clients_flat)
    # All byte fields are PER-CLIENT-UPLOAD, matching the reference's
    # selective-comm accounting (processing_comm.py:81-107 plots one
    # client's upload) and the model_bench per-client convention.
    ct_bytes = chunks * 2 * p.chain_len * p.ring_dim * 4 + 64
    # seeded uploads (ops.encrypt_symmetric_seeded): header | 16-byte seed
    # | c0 only — the c1 half is expanded server-side from the seed
    ct_bytes_seeded = chunks * p.chain_len * p.ring_dim * 4 + 64 + 16
    return {"model": model, "rate": rate, "params": n, "clients": k,
            "enc_params": enc_n, "chunks": chunks,
            "ct_bytes": ct_bytes, "ct_bytes_seeded": ct_bytes_seeded,
            "plain_bytes": plain_n * 4,
            "round_s": round_s, "fetch_s": fetch_s, "reps": reps,
            "path": "fused_cohort", "max_err": err,
            "backend": jax.default_backend()}


def bench_bytes_row(helper: CKKS, model: str, rate: float, clients_flat,
                    spec, weights) -> dict:
    """The reference's client<->server wire path, one blob per client
    (ckks.cpp:98-101) — it includes serialization and host<->device
    transfers, hence the explicit label."""
    policy = SelectivePolicy(rate=rate)
    encs = [split_by_policy(f, spec, policy)[0] for f in clients_flat]
    helper.encrypt(encs[0])          # warmup
    t0 = time.time()
    blobs = [helper.encrypt(e) for e in encs]
    enc_s = time.time() - t0
    t0 = time.time()
    agg = helper.computeWeightedAverage(blobs, list(weights))
    out = helper.decrypt(agg, encs[0].size)
    rest_s = time.time() - t0
    err = float(np.max(np.abs(
        out - np.mean(np.stack(encs), axis=0))))
    return {"model": model, "rate": rate, "params": clients_flat[0].size,
            "clients": len(clients_flat),
            "enc_params": encs[0].size,
            "ct_bytes": sum(map(len, blobs)) // len(blobs),
            "encrypt_s": enc_s, "agg_dec_s": rest_s,
            "path": "bytes_wire",
            "note": "serialized per-client blobs; includes host<->device "
                    "transfers",
            "max_err": err, "backend": jax.default_backend()}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--models", nargs="*",
                    default=["cnn_fedavg", "resnet50", "bert"])
    ap.add_argument("--rates", nargs="*", type=float,
                    default=[0.1, 0.5, 1.0])
    ap.add_argument("--clients", type=int, default=3)
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--bits", type=int, default=52)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--max-chunks", type=int, default=512)
    ap.add_argument("--bytes-row", action="store_true",
                    help="add one labeled bytes-wire row (first model, "
                         "first rate)")
    ap.add_argument("--wire-rates", nargs="*", type=float, default=None,
                    help="emit ONLY labeled bytes-wire rows at these "
                         "rates for the first model (no fused rows); "
                         "use with --append to extend the wire column")
    ap.add_argument("--append", action="store_true",
                    help="append to selective.jsonl instead of rewriting")
    args = ap.parse_args(argv)

    keydir = os.path.join(results_dir(), "bench_keys")
    os.makedirs(keydir, exist_ok=True)
    helper = CKKS("ckks", args.batch, args.bits, cryptodir=keydir,
                  symmetric=True)
    helper.load_or_gen()

    weights = [1.0 / args.clients] * args.clients
    out = []
    if args.wire_rates is not None:
        model = args.models[0]
        spec_m = models.build(model)
        flat, spec = flatten_params(spec_m.params)
        rng = np.random.default_rng(0)
        clients_flat = [
            (flat + rng.standard_normal(flat.size).astype(np.float32)
             * 0.01) for _ in range(args.clients)]
        for rate in args.wire_rates:
            r = bench_bytes_row(helper, model, rate, clients_flat, spec,
                                weights)
            out.append(r)
            print(f"{model} rate={rate} [bytes wire]: ct "
                  f"{r['ct_bytes']:,} B, enc {r['encrypt_s']:.2f}s, "
                  f"agg+dec {r['agg_dec_s']:.2f}s")
        if args.append:
            for r in out:
                append_jsonl("selective.jsonl", r)
        else:
            rewrite_jsonl("selective.jsonl", out)
        return out
    for model in args.models:
        spec_m = models.build(model)
        flat, spec = flatten_params(spec_m.params)
        rng = np.random.default_rng(0)
        clients_flat = [
            (flat + rng.standard_normal(flat.size).astype(np.float32)
             * 0.01) for _ in range(args.clients)]
        for rate in args.rates:
            big = flat.size * args.clients > 200_000_000
            reps = 1 if big else args.reps
            r = bench_rate(helper, model, rate, clients_flat, spec,
                           weights, args.max_chunks, reps)
            out.append(r)
            print(f"{model} rate={rate}: enc {r['enc_params']:,}/"
                  f"{r['params']:,} params, ct {r['ct_bytes']:,} B "
                  f"(seeded {r['ct_bytes_seeded']:,} B, "
                  f"+{r['plain_bytes']:,} plain B), "
                  f"round {r['round_s'] * 1e3:.1f} ms, "
                  f"err {r['max_err']:.1e}")
        if args.bytes_row and model == args.models[0]:
            r = bench_bytes_row(helper, model, args.rates[0],
                                clients_flat, spec, weights)
            out.append(r)
            print(f"{model} rate={args.rates[0]} [bytes wire]: "
                  f"enc {r['encrypt_s']:.2f}s agg+dec {r['agg_dec_s']:.2f}s")
    if args.append:
        for r in out:
            append_jsonl("selective.jsonl", r)
    else:
        rewrite_jsonl("selective.jsonl", out)

    for model in args.models:
        rows = [r for r in out if r["model"] == model
                and r["path"] == "fused_cohort"]
        full = next((r for r in rows if r["rate"] == 1.0), None)
        if full:
            for r in rows:
                if r["rate"] < 1.0:
                    up = r["ct_bytes"] + r["plain_bytes"]
                    up_seed = r["ct_bytes_seeded"] + r["plain_bytes"]
                    print(f"  {model} rate {r['rate']}: x"
                          f"{full['ct_bytes'] / up:.1f} smaller "
                          f"upload than full encryption "
                          f"(x{full['ct_bytes'] / up_seed:.1f}"
                          f" with seeded uploads)")
    return out


if __name__ == "__main__":
    main()

"""Masking-scheme (Paillier one-time-pad) benchmark — offline + online
phases at model scale.

The reference never publishes numbers for its Paillier path (mask.py
times a 161-dim toy); this driver measures both phases of our
implementation at real model sizes, end to end:

  offline (host, one-time per round schedule): per-learner randomness
      draw + bit-pack + Paillier encrypt (native OpenMP kernel,
      native/paillier.cpp), homomorphic sum across learners, key-holder
      decrypt of the mask sum (PaillierUtils.cpp:705-808 parity).
  online (per round): mask = (fix(x) - r) mod 2^b per learner, server
      sum mod 2^b, unmask + fixed-point decode
      (PaillierUtils.cpp:499-701 parity).

Each learner is a separate Masking instance with its own randomness
directory (shared Paillier keys), so the measured flow is the real
multi-party protocol, not a single-pad shortcut.

Also reports the defining trade vs CKKS: masked uploads are ~plaintext
size (x1.0 comm expansion vs x16 ciphertext) and the online compute is a
trivial integer sum; the price is the offline protocol round and
fixed-point precision (num_bits=17/precision=13, the cpp defaults).

Usage: python -m benchmarks.masking_bench [--params 100000 1663370]
       [--learners 4] [--thread-sweep]
--thread-sweep measures the offline phase at 1 vs all OpenMP threads so
"scales with cores" is a measurement, not a claim (reference analogue:
the OMP-parallel offline kernels, PaillierUtils.cpp:705-760).
Writes results/masking_bench.jsonl (rewritten, measured rows only).
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np
import jax

from fhe_fed_tpu.fed.masking import Masking
from fhe_fed_tpu.utils.compile_cache import enable_compile_cache
from .common import append_jsonl, rewrite_jsonl

enable_compile_cache()


def bench(params: int, learners: int) -> dict:
    d = tempfile.mkdtemp()
    keydir = os.path.join(d, "keys")

    # key-holder / server instance (learner 0 doubles as key-holder, as in
    # the reference's simulation)
    ms = [Masking("paillier", learners=learners, cryptodir=keydir,
                  randomnessdir=os.path.join(d, f"rand_l{i}"))
          for i in range(learners)]
    t0 = time.time()
    ms[0].genCryptoContextAndKeyGen()
    keygen_s = time.time() - t0
    for m in ms[1:]:
        m.loadCryptoParams()

    # offline phase: each learner generates + encrypts its pad
    t0 = time.time()
    blob0 = ms[0].genPaillierRandOffline(params, iteration=0)
    gen_one_s = time.time() - t0
    blobs = [blob0] + [m.genPaillierRandOffline(params, iteration=0)
                       for m in ms[1:]]
    t0 = time.time()
    agg_blob = ms[0].addPaillierRandOffline(blobs)
    add_s = time.time() - t0
    t0 = time.time()
    ms[0].decryptRandomnessSum(agg_blob, params, iteration=0)
    dec_sum_s = time.time() - t0
    offline_s = gen_one_s + add_s + dec_sum_s

    # online phase
    rng = np.random.default_rng(0)
    data = [rng.standard_normal(params).astype(np.float32) * 0.1
            for _ in range(learners)]
    # warmup: one full untimed online round (XLA compiles of the mask /
    # sum / decode programs — the reference's PaillierUtils is AOT C++)
    warm = [m.encrypt(x, iteration=0) for m, x in zip(ms, data)]
    ms[0].decrypt(ms[0].computeWeightedAverage(
        warm, [1.0 / learners] * learners), params, iteration=0)
    t0 = time.time()
    uploads = [m.encrypt(x, iteration=0) for m, x in zip(ms, data)]
    mask_s = (time.time() - t0) / learners
    t0 = time.time()
    summed = ms[0].computeWeightedAverage(
        uploads, [1.0 / learners] * learners)
    sum_s = time.time() - t0
    t0 = time.time()
    out = ms[0].decrypt(summed, params, iteration=0)
    unmask_s = time.time() - t0
    want = np.mean(np.stack(data), axis=0)
    err = float(np.max(np.abs(out - want)))

    from fhe_fed_tpu.native import paillier as native
    return {"params": params, "learners": learners,
            "threads": native.num_threads(),
            "keygen_s": keygen_s,
            "offline_gen_per_learner_s": gen_one_s,
            "offline_add_s": add_s, "offline_decrypt_sum_s": dec_sum_s,
            "offline_total_s": offline_s,
            "online_mask_per_learner_s": mask_s,
            "online_sum_s": sum_s, "online_unmask_s": unmask_s,
            "online_total_s": mask_s + sum_s + unmask_s,
            "upload_bytes": len(uploads[0]),
            "plain_bytes": params * 4,
            "comm_expansion": len(uploads[0]) / (params * 4),
            "max_err": err, "backend": jax.default_backend()}


def _report(r):
    print(f"{r['params']:,} params x {r['learners']} learners "
          f"[{r['threads']} thr]: offline {r['offline_total_s']:.2f}s "
          f"(gen {r['offline_gen_per_learner_s']:.2f} + add "
          f"{r['offline_add_s']:.2f} + dec "
          f"{r['offline_decrypt_sum_s']:.2f}), online "
          f"{r['online_total_s'] * 1e3:.1f} ms, comm "
          f"x{r['comm_expansion']:.2f}, err {r['max_err']:.1e}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--params", nargs="*", type=int,
                    default=[100_000, 1_663_370])
    ap.add_argument("--learners", type=int, default=4)
    ap.add_argument("--thread-sweep", action="store_true",
                    help="rerun the first size at 1 thread vs all "
                         "threads (offline-phase core scaling)")
    ap.add_argument("--append", action="store_true",
                    help="append rows instead of rewriting the jsonl")
    args = ap.parse_args(argv)
    rows = []
    for p in args.params:
        r = bench(p, args.learners)
        rows.append(r)
        _report(r)
    if args.thread_sweep:
        from fhe_fed_tpu.native import paillier as native
        full = native.num_threads()
        for t in sorted({1, full}):
            native.set_threads(t)
            r = bench(args.params[0], args.learners)
            r["sweep"] = "threads"
            rows.append(r)
            _report(r)
        native.set_threads(full)
    if args.append:
        for r in rows:
            append_jsonl("masking_bench.jsonl", r)
    else:
        rewrite_jsonl("masking_bench.jsonl", rows)
    return rows


if __name__ == "__main__":
    main()

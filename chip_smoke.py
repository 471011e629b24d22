"""Smoke run of the secure-FedAvg main path on one GPU, phase by phase.

    python chip_smoke.py           # one card: kernels, then three rounds
    python chip_smoke.py --four    # the three sharded paths on four cards

Phases on one card (production point CKKS("ckks", 4096, 52): ring 8192,
4 ciphertext limbs plus 1 special prime):

  1. kernels at real widths -- forward/inverse NTT, the weighted sum
     (unrolled K=3 and modsum K=16), symmetric encrypt with a fixed
     threefry key, and the CRT decode -- each run on the card and on the
     CPU backend of this process and compared bit for bit; then the card
     times of the NTT candidates;
  2. the reference-parity bytes round (encrypt -> computeWeightedAverage
     -> decrypt) at CNN scale, 3 clients;
  3. the same data through the fused fedavg_round;
  4. a streamed fedavg_round at BERT scale, 3 clients, 1024 chunks per
     slice, with the slice program's memory analysis.

Rounds are checked against the f64 weighted average. Any mismatch raises;
the last line, a JSON object with "ok": true, is printed only when every
phase passed. Without a GPU the script exits non-zero and prints no
result.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

CNN_PARAMS = 1_663_370          # CNN_OriginalFedAvg (models/zoo.py)
BERT_PARAMS = 109_482_240       # BERT-base (models/zoo.py)
ROUND_BOUND = 1e-6              # max |out - f64 weighted average|
DECODE_REL_BOUND = 1e-12        # card vs CPU decode, relative to max |x|
WEIGHTS3 = (0.5, 0.3, 0.2)


class SmokeFailure(AssertionError):
    """A phase's result disagreed with its reference."""


def log(msg: str) -> None:
    print(msg, flush=True)


def card_lines() -> str:
    """`nvidia-smi` name and power limit of every card, one per line."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def time_call(fn, *args, reps: int = 5, batch: int = 10) -> float:
    """Seconds per fn(*args): the median over `reps` samples of `batch`
    calls queued back to back, after one warm-up call."""
    import jax
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready([fn(*args) for _ in range(batch)])
        ts.append((time.perf_counter() - t0) / batch)
    return statistics.median(ts)


def check_exact(name: str, got, want) -> None:
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape:
        raise SmokeFailure(f"{name}: shape {got.shape} != {want.shape}")
    bad = int(np.count_nonzero(got != want))
    if bad:
        raise SmokeFailure(f"{name}: {bad} of {got.size} entries differ")


def check_rel(name: str, got, want, bound: float) -> float:
    """Max |got - want| over max |want|; raises above `bound`."""
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    if got.shape != want.shape or not np.all(np.isfinite(got)):
        raise SmokeFailure(f"{name}: shape {got.shape} or non-finite values")
    rel = float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30))
    if rel > bound:
        raise SmokeFailure(f"{name}: relative difference {rel:.3e} > {bound}")
    return rel


def check_round(name: str, got, want) -> float:
    got = np.asarray(got, dtype=np.float64)
    if got.shape != want.shape or not np.all(np.isfinite(got)):
        raise SmokeFailure(f"{name}: shape {got.shape} or non-finite values")
    err = float(np.max(np.abs(got - want)))
    if err > ROUND_BOUND:
        raise SmokeFailure(f"{name}: max error {err:.3e} > {ROUND_BOUND}")
    return err


# ---------------------------------------------------------------------------
# Phase 1: kernels, card against the CPU backend
# ---------------------------------------------------------------------------

def kernel_cases(ctx, sk, chunks: int, seed: int = 0):
    """(name, fn, args) for each kernel of the main path at `chunks`
    ciphertexts of the context's ring. fn is jitted; args are host arrays
    or pytrees, placed on a device by the caller."""
    import jax
    import jax.numpy as jnp
    from fhe_fed_tpu.ckks import encoding as E, ops as O
    from fhe_fed_tpu.ntt import ntt as NTT

    p = ctx.params
    n, chain, full = p.ring_dim, p.chain_len, p.num_limbs
    q = np.asarray(p.moduli, dtype=np.uint64)
    rng = np.random.default_rng(seed)

    def residues(shape):
        return rng.integers(0, q[:shape[-2], None], size=shape,
                            dtype=np.uint64).astype(np.uint32)

    cases = []
    ntt_f = jax.jit(NTT.ntt)
    intt_f = jax.jit(NTT.intt)
    for L in (chain, full):
        tb = ctx.tables.slice_limbs(0, L)
        x = residues((chunks, L, n))
        cases.append((f"ntt ({chunks}, {L}, {n})", ntt_f, (x, tb)))
        cases.append((f"intt ({chunks}, {L}, {n})", intt_f, (x, tb)))

    ds = O._scalar_scale(ctx, 0)
    for k in (3, 16):
        w = rng.random(k)
        w = w / w.sum()
        res, sh = zip(*(E.encode_scalar(p.moduli[:chain], float(wi), ds)
                        for wi in w))
        stacked = residues((k, chunks, 2, chain, n))
        cases.append((f"weighted_sum K={k} ({chunks}, 2, {chain}, {n})",
                      O._weighted_sum_impl,
                      (ctx, stacked, np.stack(res), np.stack(sh))))

    vals = (rng.standard_normal((3, chunks, n)) * 0.1).astype(np.float32)
    scale = float(p.scale)
    cases.append((
        f"encrypt_symmetric_stacked (3, {chunks}, {n})",
        jax.jit(lambda c, s, v, k: O._encrypt_sym_stacked_impl(
            c, s, v, jax.random.wrap_key_data(k, impl="threefry2x32"),
            scale)),
        (ctx, sk, vals,
         np.asarray(jax.random.key_data(jax.random.key(1234)))),
    ))

    # Decode input: encoded values at the post-aggregation scale, as
    # decrypt sees them.
    dec_scale = scale * ds
    pt = jax.jit(lambda c, v: E.encode_coeff(c, v, 2.0 ** 83))(
        ctx, jnp.asarray(vals[0]))
    cases.append((f"decode_coeff ({chunks}, {chain}, {n})",
                  jax.jit(lambda c, r: E.decode_coeff(c, r, dec_scale)),
                  (ctx, np.asarray(pt))))
    return cases


def run_on(dev, fn, args):
    import jax
    return np.asarray(jax.block_until_ready(fn(*jax.device_put(args, dev))))


def compare_cases(cases, dev, ref, time_it: bool = False) -> None:
    """Run every case on `dev` and on `ref`; integer results must match bit
    for bit, f32 decode results within DECODE_REL_BOUND."""
    import jax
    for name, fn, args in cases:
        got = run_on(dev, fn, args)
        want = run_on(ref, fn, args)
        if got.dtype.kind == "f":
            if np.array_equal(got, want):
                how = "bit-exact"
            else:
                diff = np.abs(got.astype(np.float64) - want)
                rel = check_rel(name, got, want, DECODE_REL_BOUND)
                how = (f"max diff {diff.max():.3e} ({rel:.3e} relative, "
                       f"bound {DECODE_REL_BOUND}); {np.count_nonzero(diff)}"
                       " entries differ, likely float contraction in the "
                       "two-float tail (utils/dfloat.py)")
        else:
            check_exact(name, got, want)
            how = "bit-exact"
        extra = ""
        if time_it:
            dargs = jax.device_put(args, dev)
            extra = f"  {time_call(fn, *dargs) * 1e3:.3f} ms"
        log(f"  {name}: {how} vs {ref.platform}{extra}")


def ntt_candidates(ctx, chunks: int, dev, seed: int = 1) -> None:
    """Card times of the NTT candidates at (chunks, chain, N): the
    butterfly network behind ntt()/intt() and the four-step digit-plane
    matmul (ntt/mxu.py) with int8 and bf16 operands. Each candidate must
    agree with ntt()/intt() bit for bit."""
    import jax
    from fhe_fed_tpu.ntt import mxu, ntt as NTT

    p = ctx.params
    L = p.chain_len
    tb = ctx.tables.slice_limbs(0, L)
    mt = mxu.make_mxu_tables(p.ring_dim, tuple(p.moduli[:L]))
    rng = np.random.default_rng(seed)
    x = rng.integers(0, np.asarray(p.moduli[:L], np.uint64)[:, None],
                     size=(chunks, L, p.ring_dim),
                     dtype=np.uint64).astype(np.uint32)
    x, tb, mt = jax.device_put((x, tb, mt), dev)
    want_f = NTT.ntt_jit(x, tb)
    want_i = NTT.intt_jit(want_f, tb)
    fns = {
        "butterfly": (NTT.ntt_jit, NTT.intt_jit, tb),
        "four-step int8": (jax.jit(lambda a, t: mxu.ntt_mxu(a, t, "int8")),
                           jax.jit(lambda a, t: mxu.intt_mxu(a, t, "int8")),
                           mt),
        "four-step bf16": (jax.jit(lambda a, t: mxu.ntt_mxu(a, t, "bf16")),
                           jax.jit(lambda a, t: mxu.intt_mxu(a, t, "bf16")),
                           mt),
    }
    for name, (f, i, t) in fns.items():
        check_exact(f"ntt {name}", f(x, t), want_f)
        check_exact(f"intt {name}", i(want_f, t), want_i)
        log(f"  NTT candidate {name} ({chunks}, {L}, {p.ring_dim}): "
            f"fwd {time_call(f, x, t) * 1e3:.3f} ms, "
            f"inv {time_call(i, want_f, t) * 1e3:.3f} ms")


def phase_kernels(chunks: int = 204) -> None:
    import jax
    from fhe_fed_tpu.ckks import params as P, keys as K
    dev, ref = jax.devices()[0], jax.devices("cpu")[0]
    params = P.make_params(batch=4096, scale_bits=52, mult_depth=1)
    ctx = P.make_context(params)
    sk, _ = K.keygen(ctx, seed=0)
    log(f"phase 1: kernels at ring {params.ring_dim}, {chunks} chunks, "
        f"card vs CPU")
    compare_cases(kernel_cases(ctx, sk, chunks), dev, ref, time_it=True)
    ntt_candidates(ctx, chunks, dev)


# ---------------------------------------------------------------------------
# Phases 2-4: rounds through the user entry points
# ---------------------------------------------------------------------------

def client_vectors(n_params: int, n_clients: int, seed: int):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(n_params) * 0.1).astype(np.float32)
            for _ in range(n_clients)]


def f64_average(vecs, weights) -> np.ndarray:
    out = np.zeros(vecs[0].size, dtype=np.float64)
    for w, v in zip(weights, vecs):
        out += w * v.astype(np.float64)
    return out


def bytes_round(helper, vecs, weights):
    blobs = [helper.encrypt(v) for v in vecs]
    agg = helper.computeWeightedAverage(blobs, list(weights))
    return helper.decrypt(agg, vecs[0].size)


def timed(fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    return out, time.perf_counter() - t0


def phase_rounds(tmpdir: str, cnn_params: int = CNN_PARAMS,
                 bert_params: int = BERT_PARAMS,
                 slice_chunks: int = 1024) -> None:
    import jax
    import jax.numpy as jnp
    from fhe_fed_tpu import CKKS
    from fhe_fed_tpu.ckks import encoding as E, ops as O

    helper = CKKS("ckks", 4096, 52, cryptodir=tmpdir, symmetric=True,
                  seed=0)
    helper.genCryptoContextAndKeyGen()
    n = helper.ctx.ring_dim

    vecs = client_vectors(cnn_params, 3, seed=1)
    want = f64_average(vecs, WEIGHTS3)
    chunks = -(-cnn_params // helper.capacity)
    shape = f"{cnn_params} params x 3 clients, ({chunks}, 2, 4, {n}) per ct"

    bytes_round(helper, vecs, WEIGHTS3)
    out, t = timed(bytes_round, helper, vecs, WEIGHTS3)
    err = check_round("bytes round", out, want)
    log(f"phase 2: bytes round {shape}: {t * 1e3:.1f} ms, "
        f"max err {err:.3e} (bound {ROUND_BOUND})")

    helper.fedavg_round(vecs, list(WEIGHTS3))
    out, t = timed(helper.fedavg_round, vecs, list(WEIGHTS3))
    err = check_round("fused round", out, want)
    log(f"phase 3: fused fedavg_round {shape}: {t * 1e3:.1f} ms, "
        f"max err {err:.3e} (bound {ROUND_BOUND})")

    vecs = client_vectors(bert_params, 3, seed=2)
    want = f64_average(vecs, WEIGHTS3)
    chunks = -(-bert_params // helper.capacity)
    p = helper.ctx.params
    ds = O._scalar_scale(helper.ctx, 0)
    res, sh = zip(*(E.encode_scalar(p.moduli[:p.chain_len], w, ds)
                    for w in WEIGHTS3))
    compiled = O._fedavg_round_fused_impl.lower(
        helper.ctx, helper._sk,
        jax.ShapeDtypeStruct((3, slice_chunks, n), jnp.float32),
        jax.random.key(0), jnp.asarray(np.stack(res)),
        jnp.asarray(np.stack(sh)), scale=p.scale,
        dec_scale=p.scale * ds).compile()
    log(f"phase 4: slice program (3, {slice_chunks}, {n}) memory: "
        f"{compiled.memory_analysis()}")
    run = lambda: helper.fedavg_round(vecs, list(WEIGHTS3),  # noqa: E731
                                      max_chunks=slice_chunks)
    out, t_first = timed(run)
    out, t = timed(run)
    err = check_round("streamed BERT round", out, want)
    peak = (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")
    log(f"phase 4: streamed fedavg_round {bert_params} params x 3 clients, "
        f"{chunks} chunks in slices of {slice_chunks}: {t:.3f} s "
        f"(first call {t_first:.3f} s), max err {err:.3e} "
        f"(bound {ROUND_BOUND}), device peak {peak} bytes")


# ---------------------------------------------------------------------------
# Four cards: the sharded paths, each against one device
# ---------------------------------------------------------------------------

def _spread(name: str, arr) -> None:
    """Fail if a sharded result does not span all four devices."""
    devs = {s.device for s in arr.addressable_shards}
    if len(devs) < 4:
        raise SmokeFailure(f"{name}: result lives on {len(devs)} device(s)")


def phase_four(n_params: int = CNN_PARAMS, dist_chunks: int = 64) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as PS
    from fhe_fed_tpu.ckks import (params as P, keys as K, ops as O,
                                  encoding as E, dist_ckks as DC,
                                  threshold as TH)
    from fhe_fed_tpu.ntt import dist as D
    from fhe_fed_tpu.parallel import mesh as M

    devs = jax.devices()
    if len(devs) < 4:
        raise SmokeFailure(f"--four needs 4 devices, found {len(devs)}")
    devs = devs[:4]
    params = P.make_params(batch=4096, scale_bits=52, mult_depth=1)
    ctx = P.make_context(params)
    sk, pk = K.keygen(ctx, seed=0)
    n, chain = params.ring_dim, params.chain_len

    # (a) ('clients', 'chunks') sharded round, 4 clients, (2, 2) mesh.
    kc = 4
    chunks = -(-n_params // params.batch)
    chunks += chunks % 2
    vecs = client_vectors(n_params, kc, seed=3)
    vals = np.zeros((kc, chunks, n), np.float32)
    for i, v in enumerate(vecs):
        pad = np.zeros(chunks * params.batch, np.float32)
        pad[:n_params] = v
        vals[i, :, :params.batch] = pad.reshape(chunks, params.batch)
    weights = [0.4, 0.3, 0.2, 0.1]
    ds = float(params.moduli[chain - 1])
    res, sh = zip(*(E.encode_scalar(params.moduli[:chain], w, ds)
                    for w in weights))
    keys = jax.random.split(jax.random.key(7), kc)
    args = (pk, jnp.asarray(vals), keys, jnp.asarray(np.stack(res)),
            jnp.asarray(np.stack(sh)), sk)
    one = M.full_fed_step(ctx, M.make_fed_mesh(1, 1, devices=devs[:1]))
    four = M.full_fed_step(ctx, M.make_fed_mesh(2, 2, devices=devs))
    want1 = np.asarray(one(*args))
    got_d = jax.block_until_ready(four(*args))
    _spread("full_fed_step", got_d)
    check_exact("full_fed_step 4 devices vs 1", got_d, want1)
    flat = np.asarray(got_d)[:, :params.batch].reshape(-1)[:n_params]
    err = check_round("full_fed_step", flat, f64_average(vecs, weights))
    t = time_call(four, *args, reps=5)
    log(f"four (a): full_fed_step {n_params} params x {kc} clients, "
        f"({chunks} chunks) on a (clients 2, chunks 2) mesh: bit-exact vs "
        f"one device, max err {err:.3e}, {t * 1e3:.1f} ms")

    # (b) dist_ckks round on a (limb 2, coeff 2) mesh.
    dt = D.make_dist_tables(n, params.moduli[:chain])
    sk_d = DC.sk_to_dist(sk, dt.n1)
    kd, cd = 3, dist_chunks
    vals_b = jnp.asarray(
        (np.random.default_rng(4).standard_normal((kd, cd, n)) * 0.1)
        .astype(np.float32))

    def dist_step(mesh):
        spec = D.DistSpec(mesh=mesh, limb_axis="limb")
        return DC.make_dist_fed_step(ctx, dt, spec, list(WEIGHTS3)), mesh

    step1, m1 = dist_step(Mesh(np.array(devs[:1]).reshape(1, 1),
                               ("limb", "coeff")))
    step4, m4 = dist_step(Mesh(np.array(devs).reshape(2, 2),
                               ("limb", "coeff")))
    with m1:
        want_b = np.asarray(step1(sk_d, vals_b, jax.random.key(9)))
    with m4:
        got_b = jax.block_until_ready(step4(sk_d, vals_b, jax.random.key(9)))
        t = time_call(step4, sk_d, vals_b, jax.random.key(9), reps=5)
    check_exact("dist_ckks round 4 devices vs 1", got_b, want_b)
    err = check_round("dist_ckks round", np.asarray(got_b).reshape(-1),
                      f64_average([np.asarray(v).reshape(-1)
                                   for v in vals_b], WEIGHTS3))
    log(f"four (b): dist_ckks round {kd} clients x {cd} chunks at N={n} on "
        f"a (limb 2, coeff 2) mesh: bit-exact vs one device, max err "
        f"{err:.3e}, {t * 1e3:.1f} ms")

    # (c) 4-party threshold decrypt, party axis sharded.
    parties = 4
    sec, pkj = TH.multiparty_keygen_batched(ctx, parties, seed=5)
    v = jnp.asarray(vals[0])
    ct = O.encrypt(ctx, pkj, v, jax.random.key(11))
    dkeys = TH.stack_keys([jax.random.key(40 + i) for i in range(parties)])
    want_c = np.asarray(TH.threshold_decrypt(
        ctx, jax.device_put(sec, devs[0]), ct, jax.device_put(dkeys, devs[0])))
    pm = Mesh(np.array(devs), ("party",))
    sec_d = jax.device_put(sec, NamedSharding(pm, PS("party", None, None)))
    keys_d = jax.device_put(dkeys, NamedSharding(pm, PS("party")))
    _spread("party-sharded secrets", sec_d.s)
    got_c = jax.block_until_ready(TH.threshold_decrypt(ctx, sec_d, ct,
                                                       keys_d))
    check_exact("threshold decrypt 4 devices vs 1", got_c, want_c)
    err = check_round("threshold decrypt", np.asarray(got_c),
                      np.asarray(v, dtype=np.float64))
    t = time_call(lambda: TH.threshold_decrypt(ctx, sec_d, ct, keys_d),
                  reps=5)
    log(f"four (c): {parties}-party threshold decrypt of {ct.data.shape}, "
        f"party axis sharded: bit-exact vs one device, "
        f"max err {err:.3e}, {t * 1e3:.1f} ms")
    for d in devs:
        log(f"  {d}: peak "
            f"{(d.memory_stats() or {}).get('peak_bytes_in_use')} bytes")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the sharded paths, on four cards")
    args = ap.parse_args(argv)

    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {dev.platform}",
              file=sys.stderr)
        return 1
    from fhe_fed_tpu.utils.compile_cache import enable_compile_cache
    log(f"compile cache: {enable_compile_cache()}")
    log(f"card: {card_lines()}")
    log(f"device_kind: {dev.device_kind}, count {len(jax.devices())}")

    t0 = time.perf_counter()
    if args.four:
        phase_four()
    else:
        phase_kernels()
        with tempfile.TemporaryDirectory() as tmp:
            phase_rounds(tmp)
    log(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

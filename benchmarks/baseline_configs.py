"""The five driver-set benchmark configs from BASELINE.json, one JSON line
each.

  1. ckks_example      — CKKS encrypt + 2-client weighted-average + decrypt
                         of a 4096-slot vector (ckks_example.py params;
                         reference pythonApi/ckks_example.py:91-111).
  2. ct_mult           — single-ciphertext mult + relinearize + rescale
                         microbench at N=8192, L=4 live limbs. Reports THE
                         BASELINE.json metric: ciphertext mults/s/chip.
  3. fedavg_cnn100k    — encrypted FedAvg of a ~100K-param CNN across 8
                         clients (reference ckks_example scale,
                         benchmark.py:418-461 client loop).
  4. largering         — N=32768, L=8 chain with Galois rotations:
                         per-rotation latency + EvalSum intra-ciphertext
                         reduction (reference mkhe.cpp:122-124 features).
  5. pod_fedavg        — 1M-param model x 64 clients, clients+chunks sharded
                         over the device mesh (parallel/mesh.full_fed_step);
                         reports params/s and scaling efficiency vs a
                         1-device mesh.

Run: python -m benchmarks.baseline_configs [--cpu] [--configs 1,2,5]
On CPU the shapes are thinned (fewer reps / smaller widths) so the whole
suite stays under a couple of minutes; the JSON notes the backend.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np


def _timeit(fn, *args, reps=5):
    import jax
    out = fn(*args)
    jax.block_until_ready(out)
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn(*args)
        jax.block_until_ready(out)
        ts.append(time.perf_counter() - t0)
    return min(ts)


def _emit(name, value, unit, **extra):
    import jax
    line = {"metric": name, "value": round(float(value), 6), "unit": unit,
            "backend": jax.default_backend()}
    line.update(extra)
    print(json.dumps(line), flush=True)
    # Always persist (round-3 fix: the r2 file only existed because stdout
    # happened to be redirected; an unredirected run silently lost results).
    from .common import results_dir
    path = os.path.join(results_dir(),
                        f"baseline_configs_{jax.default_backend()}.jsonl")
    with open(path, "a") as f:
        f.write(json.dumps(line) + "\n")


def cfg1_ckks_example():
    """Encrypt + 2-client weighted average + decrypt, 4096 values."""
    import jax
    import jax.numpy as jnp
    from fhe_fed_tpu.ckks import params as P, keys as K, ops as O

    params = P.make_params(batch=4096, scale_bits=52, mult_depth=1)
    ctx = P.make_context(params)
    sk, pk = K.keygen(ctx, seed=0)
    n = params.ring_dim
    rng = np.random.default_rng(0)
    vals = rng.standard_normal((2, 1, n)).astype(np.float32)
    vals[:, :, params.batch:] = 0.0          # 4096 payload slots
    stacked = jnp.asarray(vals)
    weights = [0.5, 0.5]

    def round_fn(v, key):
        ct = O.encrypt_symmetric_stacked(ctx, sk, v, key)
        agg = O.weighted_sum(ctx, ct, weights)
        return O.decrypt(ctx, sk, agg)

    key = jax.random.key(1)
    out = np.asarray(jax.block_until_ready(round_fn(stacked, key)))
    want = (0.5 * vals[0] + 0.5 * vals[1])[0, :params.batch]
    err = float(np.max(np.abs(out[0, :params.batch] - want)))
    t = _timeit(round_fn, stacked, key, reps=8)
    _emit("ckks_example_2client_4096slots", t, "s",
          max_err=err, config={"ring_dim": n, "scale_bits": 52})


def cfg2_ct_mult(cpu: bool):
    """Ciphertext mult + relin + rescale at N=8192, L=4: ct mults/s/chip."""
    import jax
    import jax.numpy as jnp
    from fhe_fed_tpu.ckks import params as P, keys as K, ops as O
    from fhe_fed_tpu.ckks import keyswitch as KS

    params = P.make_params(batch=4096, scale_bits=52, mult_depth=1)
    ctx = P.make_context(params)
    sk, pk = K.keygen(ctx, seed=0)
    rlk = KS.make_relin_key(ctx, sk, jax.random.key(17))
    n = params.ring_dim
    live = params.chain_len
    if (n, live) != (8192, 4):
        print(f"# note: params resolve to N={n}, L={live} "
              "(BASELINE.json metric point is N=8192, L=4)", flush=True)

    # cts per dispatch (chunk axis): large enough that kernel time, not
    # dispatch, dominates (~1 GB operands + ~3 GB transform
    # intermediates).
    B = 8 if cpu else 2048
    rng = np.random.default_rng(1)
    vals = jnp.asarray(rng.standard_normal((B, n)).astype(np.float32) * 0.1)
    ct_a = O.encrypt_symmetric(ctx, sk, vals, jax.random.key(2))
    ct_b = O.encrypt_symmetric(ctx, sk, vals, jax.random.key(3))

    # Public wrappers so scale/level bookkeeping is representative.
    def mult_relin_rescale(a, b):
        return O.rescale(ctx, KS.mul_ct(ctx, a, b, rlk))

    t = _timeit(mult_relin_rescale, ct_a, ct_b, reps=5)
    _emit("ct_mults_per_s_chip_N8192_L4", B / t, "ct mults/s",
          batch_cts=B, latency_s=round(t, 6),
          config={"ring_dim": n, "live_limbs": live,
                  "includes": "mult+relin+rescale"})


def cfg3_fedavg_cnn100k():
    """Encrypted FedAvg of a ~100K-param model across 8 clients."""
    import jax
    import jax.numpy as jnp
    from fhe_fed_tpu.ckks import params as P, keys as K, ops as O

    n_params, n_clients = 100_000, 8
    params = P.make_params(batch=4096, scale_bits=52, mult_depth=1)
    ctx = P.make_context(params)
    sk, pk = K.keygen(ctx, seed=0)
    n = params.ring_dim
    chunks = -(-n_params // n)
    rng = np.random.default_rng(2)
    buf = np.zeros((n_clients, chunks, n), dtype=np.float32)
    flat = rng.standard_normal((n_clients, n_params)).astype(np.float32) * 0.1
    buf.reshape(n_clients, -1)[:, :n_params] = flat
    stacked = jnp.asarray(buf)
    weights = [1.0 / n_clients] * n_clients

    def round_fn(v, key):
        ct = O.encrypt_symmetric_stacked(ctx, sk, v, key)
        agg = O.weighted_sum(ctx, ct, weights)
        return O.decrypt(ctx, sk, agg)

    key = jax.random.key(4)
    out = np.asarray(jax.block_until_ready(round_fn(stacked, key)))
    want = flat.mean(axis=0)
    err = float(np.max(np.abs(out.reshape(-1)[:n_params] - want)))
    t = _timeit(round_fn, stacked, key, reps=5)
    _emit("fedavg_100k_8clients", t, "s", max_err=err,
          params_per_s=round(n_params / t, 1),
          config={"chunks": chunks, "ring_dim": n})


def cfg4_largering(cpu: bool):
    """N=32768, L=8: rotation latency + EvalSum slot reduction."""
    import jax
    import jax.numpy as jnp
    from fhe_fed_tpu.ckks import params as P, keys as K, ops as O
    from fhe_fed_tpu.ckks import keyswitch as KS
    from fhe_fed_tpu.ckks import slots as SL

    params = P.make_params(batch=16384, scale_bits=52, mult_depth=5,
                           ring_dim=32768)
    ctx = P.make_context(params)
    assert ctx.ring_dim == 32768 and params.chain_len == 8
    sk, pk = K.keygen(ctx, seed=0)

    width = 16 if cpu else 256               # slots reduced by EvalSum
    rng = np.random.default_rng(3)
    z = rng.standard_normal(SL.num_slots(ctx)).astype(np.float64) * 0.1
    pt = SL.encode_slots(ctx, z[None, :], params.scale)
    ct = O.encrypt_encoded(ctx, pk, pt, jax.random.key(5), params.scale)

    gks = {}
    r = 1
    while r < width:
        g = KS.galois_element(r, ctx.ring_dim)
        gks[r] = KS.make_galois_key(ctx, sk, g, jax.random.key(100 + r))
        r <<= 1

    g1 = KS.galois_element(1, ctx.ring_dim)
    f_rot = jax.jit(lambda d: KS._rotate_impl(ctx, d, gks[1], g1))
    t_rot = _timeit(f_rot, ct.data, reps=3 if cpu else 8)

    def run_eval_sum():
        s = KS.eval_sum(ctx, ct, gks, width)
        jax.block_until_ready(s.data)
        return s

    run_eval_sum()                           # warm every rotation kernel
    t0 = time.perf_counter()
    summed = run_eval_sum()
    t_sum = time.perf_counter() - t0

    res = O.decrypt_residues(ctx, sk, summed)
    got = SL.decode_slots(ctx, np.asarray(res), summed.scale)[0]
    # eval_sum composes global cyclic rotations: slot j holds the sliding
    # cyclic sum of z[j .. j+width-1] (mod num_slots).
    want = sum(np.roll(z, -r) for r in range(width))
    err = float(np.max(np.abs(got.real - want)))
    _emit("rotation_latency_N32768_L8", t_rot, "s",
          evalsum_width=width, evalsum_s=round(t_sum, 4), max_err=err,
          config={"ring_dim": 32768, "chain_len": 8})


def cfg5_pod_fedavg(cpu: bool = False):
    """1M params x 64 clients over the ('clients','chunks') mesh.

    On the virtual CPU mesh the shapes are thinned (200K x 16): the full
    config is ~2.6 GB of ciphertext through a vmapped 64-client encrypt and
    does not finish in reasonable wall-clock on emulated devices. The JSON
    records the actual config used."""
    import jax
    import jax.numpy as jnp
    from fhe_fed_tpu.ckks import params as P, keys as K
    from fhe_fed_tpu.ckks import encoding as E
    from fhe_fed_tpu.parallel import mesh as M

    n_params, n_clients = (200_000, 16) if cpu else (1_000_000, 64)
    params = P.make_params(batch=4096, scale_bits=52, mult_depth=1)
    ctx = P.make_context(params)
    sk, pk = K.keygen(ctx, seed=0)
    n = params.ring_dim
    ndev = len(jax.devices())
    ca = 1
    for f in (2, 4):
        if ndev % f == 0:
            ca = f
    cha = ndev // ca
    chunks = -(-n_params // n)
    chunks += (-chunks) % max(cha, 1)        # pad to the chunk-axis shards
    rng = np.random.default_rng(4)
    buf = np.zeros((n_clients, chunks, n), dtype=np.float32)
    flat = rng.standard_normal((n_clients, n_params)).astype(np.float32) * 0.1
    buf.reshape(n_clients, -1)[:, :n_params] = flat

    weights = [1.0 / n_clients] * n_clients
    chain = params.chain_len
    ds = float(params.moduli[chain - 1])
    res_l, shoup_l = zip(*(E.encode_scalar(params.moduli[:chain], w, ds)
                           for w in weights))
    w_res = jnp.asarray(np.stack(res_l))
    w_shoup = jnp.asarray(np.stack(shoup_l))
    rng_keys = jax.random.split(jax.random.key(7), n_clients)

    reps = 1 if cpu else 3

    def run_on(n_devices, ca_, cha_):
        mesh = M.make_fed_mesh(ca_, cha_, devices=jax.devices()[:n_devices])
        step = M.full_fed_step(ctx, mesh)
        vals = jax.device_put(jnp.asarray(buf),
                              jax.sharding.NamedSharding(
                                  mesh, jax.sharding.PartitionSpec(
                                      "clients", "chunks", None)))
        out = jax.block_until_ready(
            step(pk, vals, rng_keys, w_res, w_shoup, sk))
        t = _timeit(lambda v: step(pk, v, rng_keys, w_res, w_shoup, sk),
                    vals, reps=reps)
        return t, np.asarray(out)

    t_n, out = run_on(ndev, ca, cha)
    err = float(np.max(np.abs(
        out.reshape(-1)[:n_params] - flat.mean(axis=0))))
    extra = {}
    if ndev > 1:
        t_1, _ = run_on(1, 1, 1)
        eff = t_1 / (t_n * ndev)
        extra = {"t_1dev_s": round(t_1, 4), "n_devices": ndev,
                 "scaling_efficiency": round(eff, 3)}
    if ndev == 1:
        # One device: no scaling efficiency to report.
        extra = {"note": "single-device datum, not a multi-device "
                         "measurement; see results/scaling_virtual.jsonl "
                         "for the weak-scaling methodology stub"}
    _emit("pod_fedavg_1M_64clients", t_n, "s", max_err=err,
          params_per_s=round(n_params / t_n, 1),
          config={"n_params": n_params, "n_clients": n_clients},
          mesh={"clients": ca, "chunks": cha}, **extra)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true",
                    help="force CPU backend (virtual 8-device mesh)")
    ap.add_argument("--configs", default="1,2,3,4,5")
    args = ap.parse_args()

    import os
    if args.cpu:
        flags = os.environ.get("XLA_FLAGS", "")
        if "host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + " --xla_force_host_platform_device_count=8").strip()
        import jax
        jax.config.update("jax_platforms", "cpu")
    else:
        from fhe_fed_tpu.utils.compile_cache import enable_compile_cache
        enable_compile_cache()

    todo = {int(x) for x in args.configs.split(",")}
    if 1 in todo:
        cfg1_ckks_example()
    if 2 in todo:
        cfg2_ct_mult(args.cpu)
    if 3 in todo:
        cfg3_fedavg_cnn100k()
    if 4 in todo:
        cfg4_largering(args.cpu)
    if 5 in todo:
        cfg5_pod_fedavg(args.cpu)


if __name__ == "__main__":
    main()

"""Weak-scaling methodology on a virtual device mesh — with the
oversubscription confound separated out.

This measures what a virtual CPU mesh CAN measure; multi-card numbers
come from the cards themselves. Round-3's version reported raw fixed-per-device weak scaling and
got 23% "efficiency" at 8 devices — an artifact, not a finding: the N
virtual devices of --xla_force_host_platform_device_count share ONE
physical socket (and one XLA intra-op thread pool), so doubling the
device count doubles the total work without adding any compute. Fixed
per-device load on a shared socket measures compute oversubscription, by
construction, not the collective.

What actually transfers to real hardware is the PARTITION + COLLECTIVE
OVERHEAD: the same total work, run (a) on one device as a single fused
kernel vs (b) sharded over nd devices with the psum-shaped client/chunk
reduction. On real chips each device brings its own ALUs, so round time
= serial_time/nd * overhead; overhead ~= 1.0 here is the evidence that
the sharded aggregation adds no collective/partition cost, which is what
the >= 80% multi-host target (BASELINE.json) needs from the software.
The fabric bandwidth term remains hardware-blocked, correctly so.

Both measurements per device count:
  wall_mesh    — nd devices, chunks sharded, fused weighted sum (psum
                 pattern of parallel/mesh.py; replaces the reference's
                 serial learner loop, ckks.cpp:273-298)
  wall_serial  — SAME total chunks on ONE device, same kernel
  overhead     — wall_mesh / wall_serial  (the transferable number)
  weak_scaling_efficiency_raw — round-3's metric, kept for continuity,
                 with the oversubscription explanation attached

Run: XLA_FLAGS=--xla_force_host_platform_device_count=8 \
     JAX_PLATFORMS=cpu python -m benchmarks.scaling_virtual

Writes results/scaling_virtual.jsonl (rewritten: measured rows only).
"""

from __future__ import annotations

import argparse
import os
import time

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np                                         # noqa: E402
import jax.numpy as jnp                                    # noqa: E402
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P  # noqa: E402

from fhe_fed_tpu.ckks import params as Pm, ops as O        # noqa: E402
from fhe_fed_tpu.ckks import encoding as E                 # noqa: E402
from .common import rewrite_jsonl                          # noqa: E402


def _time(fn, x, reps):
    jax.block_until_ready(fn(x))                # compile
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(x))
        ts.append(time.perf_counter() - t0)
    return min(ts)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--chunks-per-device", type=int, default=16)
    ap.add_argument("--clients", type=int, default=16)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)

    params = Pm.make_params(batch=4096, scale_bits=52, mult_depth=1)
    ctx = Pm.make_context(params)
    chain = params.chain_len
    n = params.ring_dim
    K = args.clients
    ds = float(params.moduli[chain - 1])
    res_l, shoup_l = zip(*(E.encode_scalar(params.moduli[:chain], 1.0 / K,
                                           ds) for _ in range(K)))
    w_res = jnp.asarray(np.stack(res_l))
    w_shoup = jnp.asarray(np.stack(shoup_l))

    devs = jax.devices()
    ncpu = os.cpu_count()
    sizes = [d for d in (1, 2, 4, 8) if d <= len(devs)]
    rng = np.random.default_rng(0)
    fn = jax.jit(lambda s: O._weighted_sum_impl(ctx, s, w_res, w_shoup))

    rows = []
    base = None
    for nd in sizes:
        chunks = args.chunks_per_device * nd     # weak scaling: fixed /dev
        x = rng.integers(0, params.moduli[0],
                         size=(K, chunks, 2, chain, n)).astype(np.uint32)

        mesh = Mesh(np.array(devs[:nd]).reshape(nd), ("chunks",))
        xs = jax.device_put(x, NamedSharding(mesh, P(None, "chunks")))
        t_mesh = _time(fn, xs, args.reps)

        x1 = jax.device_put(x, devs[0])          # same total work, 1 device
        t_serial = _time(fn, x1, args.reps)

        if base is None:
            base = t_mesh
        eff_raw = base / t_mesh
        overhead = t_mesh / t_serial
        r = {"devices": nd, "chunks": chunks,
             "chunks_per_device": args.chunks_per_device,
             "clients": K,
             "wall_mesh_s": round(t_mesh, 5),
             "wall_serial_same_work_s": round(t_serial, 5),
             "partition_collective_overhead": round(overhead, 3),
             "weak_scaling_efficiency_raw": round(eff_raw, 3),
             "host_physical_cpus": ncpu,
             "backend": jax.default_backend(),
             "note": ("virtual CPU mesh: all devices share one socket, so "
                      "raw weak scaling measures compute oversubscription "
                      "(total work grows, compute does not). The "
                      "transferable number is partition_collective_overhead"
                      " = sharded-run / one-device-same-total-work; ~1.0 "
                      "means the psum-shaped aggregation adds no "
                      "partition/collective cost. Fabric bandwidth remains "
                      "hardware-blocked.")}
        rows.append(r)
        print(f"{nd} devices: mesh {t_mesh*1e3:8.2f} ms vs serial "
              f"{t_serial*1e3:8.2f} ms for {chunks} chunks -> "
              f"overhead x{overhead:.2f} (raw weak-eff {eff_raw:.2f}, "
              f"{ncpu} physical cpus)")
    rewrite_jsonl("scaling_virtual.jsonl", rows)
    return rows


if __name__ == "__main__":
    main()

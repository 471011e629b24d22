"""Mesh-sharded encrypted aggregation.

The reference has no distributed backend at all — N clients are a Python
loop in one process and the server aggregates serially over learners
(ckks.cpp:273-298; SURVEY.md §2 C30). Here the logical parallel axes
are first-class mesh axes:

  * clients — the FedAvg fan-in. Sharding the stacked client ciphertexts
    over this axis turns the weighted reduction into a psum.
  * chunks  — ciphertext chunks of the model (a BERT is ~13-27k chunks,
    figs/processing.py:22). Pure data parallelism; rescale NTTs stay local
    because each chunk's coefficient axis is unsharded.

The mesh follows the algorithm alone: the cards of one host reach each
other all to all at one rate (NVLink), so no axis order is preferred for
the interconnect. The coefficient axis stays on one device (a single
N=8192 x L=4 chunk is ~256 KB); ntt/dist.py shards it where a ring
outgrows one device.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P, NamedSharding

from ..rns import modops
from ..ckks import ops as ckks_ops
from ..ckks.params import CkksContext


def make_fed_mesh(n_clients_axis: int, n_chunks_axis: int,
                  devices=None) -> Mesh:
    devices = np.asarray(devices if devices is not None else jax.devices())
    need = n_clients_axis * n_chunks_axis
    assert devices.size >= need, (devices.size, need)
    grid = devices[:need].reshape(n_clients_axis, n_chunks_axis)
    return Mesh(grid, axis_names=("clients", "chunks"))


def ct_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding for stacked client ciphertexts (K, chunks, 2, L, N)."""
    return NamedSharding(mesh, P("clients", "chunks", None, None, None))


def result_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding for the aggregated ciphertext (chunks, 2, L, N)."""
    return NamedSharding(mesh, P("chunks", None, None, None))


def sharded_weighted_sum(ctx: CkksContext, mesh: Mesh):
    """Build a jitted (stacked, w_res, w_shoup) -> aggregated ct-data fn with
    the client reduction riding psum over the 'clients' mesh axis.

    stacked: (K, chunks, 2, live, N) uint32; w_*: (K, live) uint32.
    """
    @functools.partial(
        jax.jit,
        in_shardings=(ct_sharding(mesh),
                      NamedSharding(mesh, P("clients", None)),
                      NamedSharding(mesh, P("clients", None))),
        out_shardings=result_sharding(mesh))
    def agg(stacked, w_res, w_shoup):
        live = stacked.shape[3]
        qb = ctx.q[:live, None]
        terms = modops.mul_mod_shoup(
            stacked, w_res[:, None, None, :, None],
            w_shoup[:, None, None, :, None], qb)
        return ckks_ops.modsum_clients(terms, qb, ctx.pow32[:live, None],
                                       ctx.pow32_shoup[:live, None])

    return agg


def full_fed_step(ctx: CkksContext, mesh: Mesh):
    """One complete secure-FedAvg round as a single jitted, mesh-sharded
    computation: per-client encrypt -> fused weighted sum (psum over the
    'clients' axis) -> rescale -> decrypt -> decode.

    Simulates all parties in one computation, exactly like the reference's
    single-process benchmark loop (benchmark.py:459-461), but with the
    client and chunk axes laid out over the device mesh.

    Returns a function (values (K, C, N) f32, rng_keys (K,), w_res (K, L),
    w_shoup (K, L), sk_s, sk_shoup, pk...) — bound below via closure over
    ctx; key material is passed as arrays so the step stays re-usable.
    """
    from ..ckks import encoding
    from ..ntt import ntt as ntt_mod
    from ..ckks.keys import ternary_coeffs, cbd_coeffs, lift_signed
    import jax.random as jrandom

    scale = float(ctx.params.scale)
    L = ctx.params.chain_len

    def encrypt_one(pk, values, key):
        n = values.shape[-1]
        chunks = values.shape[0]
        q = ctx.q[:L]
        qb = q[:, None]
        tb = ctx.tables.slice_limbs(0, L)
        pt = encoding.encode_coeff(ctx, values, scale)
        m_hat = ntt_mod.ntt(pt, tb)
        k_u, k_e0, k_e1 = jrandom.split(key, 3)
        u_hat = ntt_mod.ntt(
            lift_signed(ternary_coeffs(k_u, (chunks, n)), q), tb)
        e_hat = ntt_mod.ntt(
            lift_signed(
                jnp.stack([cbd_coeffs(k_e0, (chunks, n)),
                           cbd_coeffs(k_e1, (chunks, n))], axis=1), q),
            tb)
        c0 = modops.add_mod(
            modops.add_mod(
                modops.mul_mod_shoup(u_hat, pk.p0[:L], pk.p0_shoup[:L], qb),
                e_hat[:, 0], qb),
            m_hat, qb)
        c1 = modops.add_mod(
            modops.mul_mod_shoup(u_hat, pk.p1[:L], pk.p1_shoup[:L], qb),
            e_hat[:, 1], qb)
        return jnp.stack([c0, c1], axis=1)

    @functools.partial(
        jax.jit,
        in_shardings=(None,
                      NamedSharding(mesh, P("clients", "chunks", None)),
                      NamedSharding(mesh, P("clients")),
                      NamedSharding(mesh, P("clients", None)),
                      NamedSharding(mesh, P("clients", None)),
                      None),
        out_shardings=NamedSharding(mesh, P("chunks", None)))
    def step(pk, values, rng_keys, w_res, w_shoup, sk):
        stacked = jax.vmap(lambda v, k: encrypt_one(pk, v, k))(
            values, rng_keys)                      # (K, C, 2, L, N)
        qb = ctx.q[:L, None]
        terms = modops.mul_mod_shoup(
            stacked, w_res[:, None, None, :, None],
            w_shoup[:, None, None, :, None], qb)
        agg = ckks_ops.modsum_clients(terms, qb, ctx.pow32[:L, None],
                                      ctx.pow32_shoup[:L, None])
        agg = ckks_ops._rescale_impl(ctx, agg)     # (C, 2, L-1, N)
        live = L - 1
        qb2 = ctx.q[:live, None]
        phase = modops.add_mod(
            agg[:, 0],
            modops.mul_mod_shoup(agg[:, 1], sk.s[:live], sk.s_shoup[:live],
                                 qb2),
            qb2)
        coeffs = ntt_mod.intt(phase, ctx.tables.slice_limbs(0, live))
        # After rescale by the top prime, scale is back to Delta exactly
        # (scalars are encoded at that prime — ops._scalar_scale).
        return encoding.decode_coeff(ctx, coeffs, scale)

    return step

"""Multi-host runtime: jax.distributed init + pod meshes + host feeds.

The reference simulates every party in one process (benchmark.py:459-461)
and has no distributed backend (SURVEY.md §2 C30, §5.8). Across hosts the
runtime is jax.distributed: one Python process per host, all devices in
one global device list, GSPMD partitioning across them. This module is the
thin layer that makes the framework's meshes multi-host:

  * init_distributed()  — bring up (or no-op) the multi-process runtime
    from explicit arguments or standard env vars;
  * pod_mesh(...)       — a named mesh over ALL global devices. Within a
    host every device reaches every other at one rate, so the axis order
    matters only across hosts: jax's global device list is host-major, so
    the OUTERMOST axis ('clients' by default — each host holds whole
    client ciphertexts) is the one that crosses hosts, and the fan-in
    psum crosses the host network exactly once;
  * host_client_array() — build the global stacked-ciphertext array from
    per-host client payloads without gathering everything to one host
    (the host->device feed SURVEY.md §7 flags for 26k-chunk models).

Single-process (tests, one VM) everything degrades to the local device
list, so the same code runs on the 8-device virtual CPU mesh.
"""

from __future__ import annotations

import os

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> bool:
    """Initialize jax.distributed from args or standard env vars
    (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID).
    Pass the coordinator address (e.g. localhost:<port> on one machine),
    the process count and this process's id. Returns True if the
    multi-process runtime came up, False for the single-process no-op."""
    addr = coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS")
    nproc = num_processes if num_processes is not None else int(
        os.environ.get("JAX_NUM_PROCESSES", "0") or 0)
    if addr is None and nproc <= 1:
        return False                        # single process: nothing to do
    jax.distributed.initialize(coordinator_address=addr,
                               num_processes=nproc or None,
                               process_id=process_id)
    return True


def pod_mesh(axis_sizes: dict[str, int], devices=None) -> Mesh:
    """Named mesh over all (global) devices.

    axis_sizes maps axis name -> size, in MAJOR-to-minor order; one axis
    may be -1 (inferred). The first axis varies slowest across the device
    list — with jax's host-major global device order, that places the
    first axis across hosts and later axes within a host.
    FedAvg convention: ('clients', 'chunks') or ('clients', 'limb',
    'coeff') with clients first.
    """
    devices = np.asarray(devices if devices is not None
                         else jax.devices())
    names = tuple(axis_sizes)
    sizes = [axis_sizes[n] for n in names]
    n_dev = devices.size
    unknown = [i for i, s in enumerate(sizes) if s == -1]
    assert len(unknown) <= 1
    if unknown:
        known = int(np.prod([s for s in sizes if s != -1]))
        assert n_dev % known == 0, (n_dev, known)
        sizes[unknown[0]] = n_dev // known
    need = int(np.prod(sizes))
    assert need <= n_dev, (need, n_dev)
    grid = devices[:need].reshape(sizes)
    return Mesh(grid, axis_names=names)


def host_client_array(mesh: Mesh, global_shape: tuple[int, ...],
                      spec: P, local_data: np.ndarray) -> jax.Array:
    """Assemble a global array from THIS process's shard of the data.

    local_data must be this host's slice of the global array under
    NamedSharding(mesh, spec) (for the FedAvg feed: this host's clients'
    packed payloads, shape (K_local, chunks, N)). Single-process, this is
    just device_put with the sharding. No host ever materializes the
    global array.
    """
    sharding = NamedSharding(mesh, spec)
    if jax.process_count() == 1:
        return jax.device_put(np.asarray(local_data), sharding)
    return jax.make_array_from_process_local_data(
        sharding, np.asarray(local_data), global_shape)

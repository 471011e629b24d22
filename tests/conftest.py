"""Test configuration: run the suite on a virtual 8-device CPU mesh.

Mirrors the reference's single-process multi-party simulation
(benchmark.py:459-461 simulates N clients in one process); here N virtual
XLA CPU devices also let the sharded/pjit paths execute for real.
Must set env vars before jax is imported anywhere.
"""

import os

# Tests run on the CPU backend unless JAX_PLATFORMS says otherwise: the
# `-m gpu` tests run on the card with JAX_PLATFORMS=cuda,cpu (README). The
# config API is set too, in case jax was imported before this file ran.
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])

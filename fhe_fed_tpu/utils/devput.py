"""Single-transfer host->device materialization of constant pytrees.

A CKKS context holds ~40 small constant arrays (twiddle tables, Shoup
companions, decode digit planes, ...). `device_materialize` flattens every
array leaf into ONE uint32 buffer, ships it in a single transfer, and
slices it back apart inside one jitted unpack computation (cached by the
persistent compilation cache across processes), instead of one transfer
per leaf.

All framework constants are 4-byte lanes (uint32 residues / float32
reciprocals) or 1-byte lanes, so a uint32 wire buffer with a bitcast for
other leaf types is lossless.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp


def device_materialize(tree, device=None):
    """Return `tree` with every array leaf resident on `device`, shipped in
    one host->device transfer + one jitted unpack.

    Leaves must be numpy / JAX arrays with 4-byte element types (uint32,
    int32, float32). Non-array static fields of registered dataclasses are
    preserved by the treedef.
    """
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    if not leaves:
        return tree
    specs = []
    host = []
    for leaf in leaves:
        a = np.asarray(leaf)
        if a.dtype.itemsize == 4:
            specs.append((a.dtype, a.shape, int(a.size), int(a.size)))
            host.append(np.ascontiguousarray(a).view(np.uint32).ravel())
        elif a.dtype.itemsize == 1:
            # 1-byte leaves (int8 digit-plane matrices): pad to a 4-byte
            # boundary on the wire, bitcast back apart on device.
            raw = np.ascontiguousarray(a).view(np.uint8).ravel()
            pad = (-raw.size) % 4
            if pad:
                raw = np.concatenate([raw, np.zeros(pad, np.uint8)])
            specs.append((a.dtype, a.shape, int(a.size), raw.size // 4))
            host.append(raw.view(np.uint32))
        else:
            raise TypeError(
                f"device_materialize: {a.dtype} leaf (need 1- or 4-byte "
                "lanes)")
    flat = np.concatenate(host) if len(host) > 1 else host[0]

    unpack = _unpack_for(tuple((dt.str, sh, sz, words)
                               for dt, sh, sz, words in specs))
    buf = jnp.asarray(flat)
    if device is not None:
        buf = jax.device_put(buf, device)
    return jax.tree_util.tree_unflatten(treedef, unpack(buf))


# The unpack computation is cached PER LAYOUT (the full spec tuple — dtype/
# shape/size of every leaf — not just the buffer shape, so two different
# layouts can never alias): a process materializing several same-layout
# trees (context, then keys on every loadCryptoParams) traces and compiles
# the unpack once instead of per call. The persistent compilation cache
# additionally dedupes across processes.
_UNPACK_CACHE: dict = {}


def _unpack_for(spec_key):
    fn = _UNPACK_CACHE.get(spec_key)
    if fn is not None:
        return fn

    specs = [(np.dtype(dt), sh, sz, words)
             for dt, sh, sz, words in spec_key]

    @jax.jit
    def unpack(buf):
        out = []
        off = 0
        for dt, sh, sz, words in specs:
            seg = jax.lax.slice(buf, (off,), (off + words,))
            off += words
            if dt.itemsize == 1:
                seg = jax.lax.bitcast_convert_type(seg, dt).reshape(-1)[:sz]
            elif dt != np.uint32:
                seg = jax.lax.bitcast_convert_type(seg, dt)
            out.append(seg.reshape(sh))
        return tuple(out)

    _UNPACK_CACHE[spec_key] = unpack
    return unpack

"""GCN (Cora-style) and TabNet, pure JAX.

Reference parity:
  gcn     2-layer GCNConv 1433-16-7 over a normalized adjacency
          (reference code/benchmark_gcn.py:50-72; the reference's
          `GCN(1433, 16, 0.5, 2)` call drops NumLayers — we pin the
          2-layer Cora config it intends).
  tabnet  pytorch-tabnet architecture: shared+independent GLU feature
          transformers, sparsemax attentive transformer, n_d=n_a=8,
          n_steps=3 (reference model_helper.py:494-597, 599-788).

BatchNorms run in inference mode off running stats kept in `state`
(param_count parity with torch .parameters()).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from . import layers as L


# ---------------------------------------------------------------------------
# GCN
# ---------------------------------------------------------------------------

def gcn_init(key, nfeat: int = 1433, nhid: int = 16, nclass: int = 7):
    k1, k2 = jax.random.split(key)
    return {"conv1": L.dense_init(k1, nfeat, nhid),
            "conv2": L.dense_init(k2, nhid, nclass)}


def gcn_apply(p, x, adj):
    """x: (N, F) node features, adj: (N, N) normalized adjacency
    D^-1/2 (A+I) D^-1/2 (dense; Cora is 2708 nodes)."""
    h = jax.nn.relu(adj @ L.dense(p["conv1"], x))
    return jax.nn.log_softmax(adj @ L.dense(p["conv2"], h), axis=-1)


def normalize_adjacency(a: jnp.ndarray) -> jnp.ndarray:
    a = a + jnp.eye(a.shape[0], dtype=a.dtype)
    d = jnp.sum(a, axis=1)
    d_inv_sqrt = jax.lax.rsqrt(jnp.maximum(d, 1e-12))
    return a * d_inv_sqrt[:, None] * d_inv_sqrt[None, :]


# ---------------------------------------------------------------------------
# TabNet
# ---------------------------------------------------------------------------

def sparsemax(z: jnp.ndarray, axis: int = -1) -> jnp.ndarray:
    """Sparsemax (Martins & Astudillo 2016): Euclidean projection onto the
    simplex. Branch-free sort-based form — static shapes."""
    z_sorted = -jnp.sort(-z, axis=axis)
    k = jnp.arange(1, z.shape[axis] + 1, dtype=z.dtype)
    shape = [1] * z.ndim
    shape[axis] = -1
    k = k.reshape(shape)
    z_cum = jnp.cumsum(z_sorted, axis=axis) - 1.0
    support = k * z_sorted > z_cum
    k_max = jnp.sum(support.astype(z.dtype), axis=axis, keepdims=True)
    tau = (jnp.take_along_axis(
        z_cum, (k_max - 1).astype(jnp.int32), axis=axis)) / k_max
    return jnp.maximum(z - tau, 0.0)


def _glu_layer_init(key, in_dim, out_dim):
    p = {"fc": {"w": jax.random.normal(key, (in_dim, 2 * out_dim),
                                       jnp.float32)
                * jnp.sqrt(4 * (2 * out_dim) / (in_dim + 2 * out_dim))
                / jnp.sqrt(jnp.asarray(in_dim, jnp.float32))}}
    bn_p, bn_s = L.batchnorm_init(2 * out_dim)
    p["bn"] = bn_p
    return p, {"bn": bn_s}


def _glu_layer_apply(p, s, x):
    h = x @ p["fc"]["w"]
    h = L.batchnorm(p["bn"], s["bn"], h)
    out_dim = h.shape[-1] // 2
    return h[..., :out_dim] * jax.nn.sigmoid(h[..., out_dim:])


_SQRT_HALF = 0.7071067811865476


def _feat_transformer_init(key, in_dim, out_dim, n_shared=2, n_independent=2):
    ks = jax.random.split(key, n_shared + n_independent)
    shared, shared_s = [], []
    d = in_dim
    for i in range(n_shared):
        p, s = _glu_layer_init(ks[i], d, out_dim)
        shared.append(p)
        shared_s.append(s)
        d = out_dim
    indep, indep_s = [], []
    for i in range(n_independent):
        p, s = _glu_layer_init(ks[n_shared + i], d, out_dim)
        indep.append(p)
        indep_s.append(s)
        d = out_dim
    return {"shared": shared, "indep": indep}, {"shared": shared_s,
                                                "indep": indep_s}


def _feat_transformer_apply(p, s, x, shared_params=None, shared_state=None):
    sh = shared_params if shared_params is not None else p["shared"]
    sh_s = shared_state if shared_state is not None else s["shared"]
    h = None
    for i, (lp, ls) in enumerate(zip(sh, sh_s)):
        g = _glu_layer_apply(lp, ls, x if h is None else h)
        h = g if h is None else (h + g) * _SQRT_HALF
    for lp, ls in zip(p["indep"], s["indep"]):
        h = (h + _glu_layer_apply(lp, ls, h)) * _SQRT_HALF
    return h


def tabnet_init(key, input_dim: int = 54, output_dim: int = 7,
                n_d: int = 8, n_a: int = 8, n_steps: int = 3):
    """Forest-cover-type defaults (54 features, 7 classes) — the dataset
    the reference's TabNet section targets."""
    ks = jax.random.split(key, 3 + 2 * n_steps)
    bn0_p, bn0_s = L.batchnorm_init(input_dim)
    shared_p, shared_s = _feat_transformer_init(
        ks[0], input_dim, n_d + n_a, n_shared=2, n_independent=0)
    init_p, init_s = _feat_transformer_init(
        ks[1], n_d + n_a, n_d + n_a, n_shared=0, n_independent=2)
    params = {"bn0": bn0_p, "shared": shared_p["shared"],
              "initial": init_p, "steps": [], "final": None}
    state = {"bn0": bn0_s, "shared": shared_s["shared"],
             "initial": init_s, "steps": []}
    for i in range(n_steps):
        ft_p, ft_s = _feat_transformer_init(
            ks[2 + 2 * i], n_d + n_a, n_d + n_a, n_shared=0, n_independent=2)
        att_fc = L.dense_init(ks[3 + 2 * i], n_a, input_dim)
        att_bn_p, att_bn_s = L.batchnorm_init(input_dim)
        params["steps"].append({"ft": ft_p, "att_fc": att_fc,
                                "att_bn": att_bn_p})
        state["steps"].append({"ft": ft_s, "att_bn": att_bn_s})
    params["final"] = L.dense_init(ks[-1], n_d, output_dim)
    return params, state


def tabnet_apply(params, state, x, n_d: int = 8, gamma: float = 1.3):
    """x: (B, input_dim) -> logits (B, output_dim)."""
    x = L.batchnorm(params["bn0"], state["bn0"], x)
    prior = jnp.ones_like(x)
    shared_p, shared_s = params["shared"], state["shared"]
    h = _feat_transformer_apply(params["initial"], state["initial"], x,
                                shared_params=shared_p,
                                shared_state=shared_s)
    a = h[..., n_d:]
    out_agg = 0.0
    for sp, ss in zip(params["steps"], state["steps"]):
        logits = L.dense(sp["att_fc"], a)
        logits = L.batchnorm(sp["att_bn"], ss["att_bn"], logits)
        mask = sparsemax(logits * prior)
        prior = prior * (gamma - mask)
        masked = mask * x
        h = _feat_transformer_apply(sp["ft"], ss["ft"], masked,
                                    shared_params=shared_p,
                                    shared_state=shared_s)
        out_agg = out_agg + jax.nn.relu(h[..., :n_d])
        a = h[..., n_d:]
    return L.dense(params["final"], out_agg)

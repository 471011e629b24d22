"""Shared pure-JAX layer primitives for the model zoo.

Models are (init, apply) pairs over plain dict pytrees — no flax/haiku.
Trainable parameters live in `params`; non-trainable running statistics
(BatchNorm) live in a separate `state` tree so `param_count` matches the
reference's `sum(p.numel() for p in model.parameters())`
(reference code/benchmark.py:430-431), while FedAvg aggregation can still
average the full state_dict equivalent (params | state) like
`plain_aggregate` does (code/benchmark.py:37-45).

Conventions: NHWC conv layouts, `lax.conv_general_dilated` for
convolutions, `lax.scan` for recurrence, einsum attention, f32 params with
optional bf16 compute.
"""

from __future__ import annotations

import math
from typing import Any

import jax
import jax.numpy as jnp
from jax import lax

Params = Any  # nested dict pytree of jnp arrays


# ---------------------------------------------------------------------------
# Initializers (torch-default parity: U(-1/sqrt(fan_in), 1/sqrt(fan_in)))
# ---------------------------------------------------------------------------

def _uniform(key, shape, bound):
    return jax.random.uniform(key, shape, jnp.float32, -bound, bound)


def dense_init(key, in_dim: int, out_dim: int) -> Params:
    k1, k2 = jax.random.split(key)
    bound = 1.0 / math.sqrt(in_dim)
    return {"w": _uniform(k1, (in_dim, out_dim), bound),
            "b": _uniform(k2, (out_dim,), bound)}


def dense(p: Params, x: jnp.ndarray) -> jnp.ndarray:
    return x @ p["w"] + p["b"]


def conv_init(key, kh: int, kw: int, cin: int, cout: int,
              bias: bool = True) -> Params:
    k1, k2 = jax.random.split(key)
    fan_in = kh * kw * cin
    bound = 1.0 / math.sqrt(fan_in)
    p = {"w": _uniform(k1, (kh, kw, cin, cout), bound)}   # HWIO
    if bias:
        p["b"] = _uniform(k2, (cout,), bound)
    return p


def conv2d(p: Params, x: jnp.ndarray, stride: int = 1, padding="SAME",
           groups: int = 1) -> jnp.ndarray:
    """x: NHWC. Weight HWIO."""
    out = lax.conv_general_dilated(
        x, p["w"], window_strides=(stride, stride), padding=padding,
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        feature_group_count=groups)
    if "b" in p:
        out = out + p["b"]
    return out


def depthwise_conv_init(key, kh: int, kw: int, ch: int,
                        bias: bool = True) -> Params:
    k1, k2 = jax.random.split(key)
    fan_in = kh * kw
    bound = 1.0 / math.sqrt(fan_in)
    p = {"w": _uniform(k1, (kh, kw, 1, ch), bound)}       # HWIO, I=1
    if bias:
        p["b"] = _uniform(k2, (ch,), bound)
    return p


def depthwise_conv2d(p: Params, x: jnp.ndarray, stride: int = 1,
                     padding="SAME") -> jnp.ndarray:
    ch = x.shape[-1]
    out = lax.conv_general_dilated(
        x, p["w"], window_strides=(stride, stride), padding=padding,
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        feature_group_count=ch)
    if "b" in p:
        out = out + p["b"]
    return out


def batchnorm_init(ch: int) -> tuple[Params, Params]:
    """Returns (params {scale, bias}, state {mean, var})."""
    return ({"scale": jnp.ones((ch,), jnp.float32),
             "bias": jnp.zeros((ch,), jnp.float32)},
            {"mean": jnp.zeros((ch,), jnp.float32),
             "var": jnp.ones((ch,), jnp.float32)})


def batchnorm(p: Params, s: Params, x: jnp.ndarray,
              eps: float = 1e-5) -> jnp.ndarray:
    """Inference-mode BN using running stats (the FedAvg pipeline never
    trains server-side; training updates happen client-side)."""
    inv = lax.rsqrt(s["var"] + eps)
    return (x - s["mean"]) * inv * p["scale"] + p["bias"]


def layernorm_init(dim: int) -> Params:
    return {"scale": jnp.ones((dim,), jnp.float32),
            "bias": jnp.zeros((dim,), jnp.float32)}


def layernorm(p: Params, x: jnp.ndarray, eps: float = 1e-12) -> jnp.ndarray:
    mu = jnp.mean(x, axis=-1, keepdims=True)
    var = jnp.var(x, axis=-1, keepdims=True)
    return (x - mu) * lax.rsqrt(var + eps) * p["scale"] + p["bias"]


def embedding_init(key, vocab: int, dim: int) -> Params:
    return {"w": jax.random.normal(key, (vocab, dim), jnp.float32)}


def embedding(p: Params, ids: jnp.ndarray) -> jnp.ndarray:
    return jnp.take(p["w"], ids, axis=0)


def max_pool(x: jnp.ndarray, window: int, stride: int) -> jnp.ndarray:
    return lax.reduce_window(
        x, -jnp.inf, lax.max, (1, window, window, 1),
        (1, stride, stride, 1), "VALID")


def avg_pool_global(x: jnp.ndarray) -> jnp.ndarray:
    return jnp.mean(x, axis=(1, 2))


# ---------------------------------------------------------------------------
# LSTM (torch nn.LSTM parity: separate ih/hh weights and both biases)
# ---------------------------------------------------------------------------

def lstm_layer_init(key, in_dim: int, hidden: int) -> Params:
    k = jax.random.split(key, 4)
    bound = 1.0 / math.sqrt(hidden)
    return {"w_ih": _uniform(k[0], (in_dim, 4 * hidden), bound),
            "w_hh": _uniform(k[1], (hidden, 4 * hidden), bound),
            "b_ih": _uniform(k[2], (4 * hidden,), bound),
            "b_hh": _uniform(k[3], (4 * hidden,), bound)}


def lstm_layer(p: Params, xs: jnp.ndarray) -> jnp.ndarray:
    """xs: (B, T, in) -> (B, T, hidden). lax.scan over time (sequential
    recurrence — XLA compiles the body once)."""
    hidden = p["w_hh"].shape[0]
    B = xs.shape[0]

    def step(carry, x_t):
        h, c = carry
        gates = x_t @ p["w_ih"] + h @ p["w_hh"] + p["b_ih"] + p["b_hh"]
        i, f, g, o = jnp.split(gates, 4, axis=-1)
        i, f, o = jax.nn.sigmoid(i), jax.nn.sigmoid(f), jax.nn.sigmoid(o)
        g = jnp.tanh(g)
        c = f * c + i * g
        h = o * jnp.tanh(c)
        return (h, c), h

    h0 = jnp.zeros((B, hidden), xs.dtype)
    (_, _), hs = lax.scan(step, (h0, h0), jnp.swapaxes(xs, 0, 1))
    return jnp.swapaxes(hs, 0, 1)


# ---------------------------------------------------------------------------
# Multi-head attention (einsum)
# ---------------------------------------------------------------------------

def mha_init(key, dim: int, out_dim: int | None = None) -> Params:
    out_dim = out_dim or dim
    k = jax.random.split(key, 4)
    return {"q": dense_init(k[0], dim, dim),
            "k": dense_init(k[1], dim, dim),
            "v": dense_init(k[2], dim, dim),
            "o": dense_init(k[3], dim, out_dim)}


def mha(p: Params, x: jnp.ndarray, num_heads: int,
        kv: jnp.ndarray | None = None,
        mask: jnp.ndarray | None = None) -> jnp.ndarray:
    """x: (B, T, D). Self-attention unless kv (B, S, D) is given."""
    kv = x if kv is None else kv
    B, T, D = x.shape
    hd = D // num_heads

    def split(h):
        return h.reshape(h.shape[0], h.shape[1], num_heads, hd)

    q = split(dense(p["q"], x))
    k = split(dense(p["k"], kv))
    v = split(dense(p["v"], kv))
    logits = jnp.einsum("bthd,bshd->bhts", q, k) / math.sqrt(hd)
    if mask is not None:
        logits = jnp.where(mask, logits, -1e9)
    w = jax.nn.softmax(logits, axis=-1)
    out = jnp.einsum("bhts,bshd->bthd", w, v).reshape(B, T, D)
    return dense(p["o"], out)


def param_count(params: Params) -> int:
    return sum(int(x.size) for x in jax.tree_util.tree_leaves(params))

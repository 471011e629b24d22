"""ViT-base, BERT-base and GroupViT, pure JAX (einsum attention).

Reference parity (code/benchmark.py:400-415: ViTModel(ViTConfig()),
BertModel(BertConfig()), GroupViTModel(GroupViTConfig())) — trainable
param counts match the torch models exactly:

  vit       86,389,248
  bert     109,482,240
  groupvit  55,726,609  (logit_scale + text 22,145,792 + vision 28,837,136
                         + visual_projection 2,633,984 + text_projection
                         2,109,696)

Only the parameter *structure* is mirrored (the FedAvg pipeline consumes
flat state; reference benchmarks never run forwards on these models) —
but real forward passes are provided for all three, with GroupViT's
grouping blocks implemented as soft-assignment cross-attention.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp

from . import layers as L


def _ln(dim):
    return L.layernorm_init(dim)


def _gelu(x):
    return jax.nn.gelu(x, approximate=False)


# ---------------------------------------------------------------------------
# Transformer encoder block (pre/post-LN switchable)
# ---------------------------------------------------------------------------

def _block_init(key, d, ffn):
    k = jax.random.split(key, 3)
    return {"attn": L.mha_init(k[0], d),
            "ln1": _ln(d), "ln2": _ln(d),
            "fc1": L.dense_init(k[1], d, ffn),
            "fc2": L.dense_init(k[2], ffn, d)}


def _block_apply_preln(p, x, heads, mask=None):
    x = x + L.mha(p["attn"], L.layernorm(p["ln1"], x), heads, mask=mask)
    h = L.layernorm(p["ln2"], x)
    return x + L.dense(p["fc2"], _gelu(L.dense(p["fc1"], h)))


def _block_apply_postln(p, x, heads, mask=None):
    x = L.layernorm(p["ln1"], x + L.mha(p["attn"], x, heads, mask=mask))
    h = L.dense(p["fc2"], _gelu(L.dense(p["fc1"], x)))
    return L.layernorm(p["ln2"], x + h)


# ---------------------------------------------------------------------------
# ViT-base (image 224, patch 16, d=768, 12 layers, heads 12, ffn 3072)
# ---------------------------------------------------------------------------

_VIT_D, _VIT_LAYERS, _VIT_HEADS, _VIT_FFN = 768, 12, 12, 3072
_VIT_PATCH, _VIT_IMG = 16, 224
_VIT_TOKENS = (_VIT_IMG // _VIT_PATCH) ** 2 + 1          # 197


def vit_init(key):
    k = jax.random.split(key, 3 + _VIT_LAYERS)
    return {
        "cls": jnp.zeros((1, 1, _VIT_D), jnp.float32),
        "pos": jnp.zeros((1, _VIT_TOKENS, _VIT_D), jnp.float32),
        "patch": L.conv_init(k[0], _VIT_PATCH, _VIT_PATCH, 3, _VIT_D),
        "blocks": [_block_init(k[2 + i], _VIT_D, _VIT_FFN)
                   for i in range(_VIT_LAYERS)],
        "ln": _ln(_VIT_D),
        "pooler": L.dense_init(k[1], _VIT_D, _VIT_D),
    }


def vit_apply(p, x):
    """x: (B, 224, 224, 3) -> (sequence (B,197,768), pooled (B,768))."""
    B = x.shape[0]
    h = L.conv2d(p["patch"], x, stride=_VIT_PATCH, padding="VALID")
    h = h.reshape(B, -1, _VIT_D)
    h = jnp.concatenate([jnp.broadcast_to(p["cls"], (B, 1, _VIT_D)), h], 1)
    h = h + p["pos"]
    for blk in p["blocks"]:
        h = _block_apply_preln(blk, h, _VIT_HEADS)
    h = L.layernorm(p["ln"], h)
    pooled = jnp.tanh(L.dense(p["pooler"], h[:, 0]))
    return h, pooled


# ---------------------------------------------------------------------------
# BERT-base (vocab 30522, d=768, 12 layers, heads 12, ffn 3072)
# ---------------------------------------------------------------------------

_BERT_D, _BERT_LAYERS, _BERT_HEADS, _BERT_FFN = 768, 12, 12, 3072
_BERT_VOCAB, _BERT_POS, _BERT_TYPES = 30522, 512, 2


def bert_init(key):
    k = jax.random.split(key, 5 + _BERT_LAYERS)
    return {
        "word_emb": L.embedding_init(k[0], _BERT_VOCAB, _BERT_D),
        "pos_emb": L.embedding_init(k[1], _BERT_POS, _BERT_D),
        "type_emb": L.embedding_init(k[2], _BERT_TYPES, _BERT_D),
        "emb_ln": _ln(_BERT_D),
        "blocks": [_block_init(k[4 + i], _BERT_D, _BERT_FFN)
                   for i in range(_BERT_LAYERS)],
        "pooler": L.dense_init(k[3], _BERT_D, _BERT_D),
    }


def bert_apply(p, ids, type_ids=None):
    """ids: (B, T) int32 -> (sequence (B,T,768), pooled (B,768))."""
    B, T = ids.shape
    if type_ids is None:
        type_ids = jnp.zeros_like(ids)
    pos = jnp.arange(T)[None, :]
    h = (L.embedding(p["word_emb"], ids)
         + L.embedding(p["pos_emb"], pos)
         + L.embedding(p["type_emb"], type_ids))
    h = L.layernorm(p["emb_ln"], h)
    for blk in p["blocks"]:
        h = _block_apply_postln(blk, h, _BERT_HEADS)
    pooled = jnp.tanh(L.dense(p["pooler"], h[:, 0]))
    return h, pooled


# ---------------------------------------------------------------------------
# GroupViT (HF GroupViTModel(GroupViTConfig()) structure)
# ---------------------------------------------------------------------------

_GV_VD, _GV_VHEADS, _GV_VFFN = 384, 6, 1536     # vision
_GV_TD, _GV_THEADS, _GV_TFFN = 256, 4, 1024     # text
_GV_TVOCAB, _GV_TPOS, _GV_TLAYERS = 49408, 77, 12
_GV_DEPTHS = (6, 3, 3)
_GV_GROUP_TOKENS = (64, 8, 0)
_GV_OUT_GROUPS = (64, 8, 8)
_GV_PROJ_INTER, _GV_PROJ = 4096, 256


def _gv_cross_attn_init(key, d, ffn):
    """GroupViTCrossAttentionLayer: attn + norm2 + mlp + norm_post."""
    k = jax.random.split(key, 3)
    return {"attn": L.mha_init(k[0], d), "norm2": _ln(d),
            "fc1": L.dense_init(k[1], d, ffn),
            "fc2": L.dense_init(k[2], ffn, d),
            "norm_post": _ln(d)}


def _gv_cross_attn_apply(p, q, kv, heads):
    x = q + L.mha(p["attn"], q, heads, kv=kv)
    x = x + L.dense(p["fc2"], _gelu(L.dense(p["fc1"],
                                            L.layernorm(p["norm2"], x))))
    return L.layernorm(p["norm_post"], x)


def _gv_downsample_init(key, d, ffn, n_in_tokens, n_out, mixer_hidden):
    """GroupViTTokenAssign (grouping block)."""
    k = jax.random.split(key, 4)
    return {
        "norm_tokens": _ln(d),
        "mlp_inter": {"fc1": L.dense_init(k[0], n_in_tokens, mixer_hidden),
                      "fc2": L.dense_init(k[1], mixer_hidden, n_out)},
        "norm_post_tokens": _ln(d),
        "norm_x": _ln(d),
        "pre_assign_attn": _gv_cross_attn_init(k[2], d, ffn),
        "assign": L.mha_init(jax.random.fold_in(k[3], 0), d),
        "norm_new_x": _ln(d),
        "mlp_channels": {"fc1": L.dense_init(jax.random.fold_in(k[3], 1),
                                             d, ffn),
                         "fc2": L.dense_init(jax.random.fold_in(k[3], 2),
                                             ffn, d)},
    }


def _gv_assign_attn(p, q, kv, heads):
    """Assignment attention: returns (attended values, assignment probs
    over queries per kv token). Soft (inference) assignment — the hard
    gumbel path is train-time only in the reference implementation."""
    B, S, D = kv.shape
    hd = D // heads
    qq = L.dense(p["q"], q).reshape(B, -1, heads, hd)
    kk = L.dense(p["k"], kv).reshape(B, S, heads, hd)
    vv = L.dense(p["v"], kv).reshape(B, S, heads, hd)
    logits = jnp.einsum("bthd,bshd->bhts", qq, kk) / math.sqrt(hd)
    # softmax over GROUPS (query axis) — each image token picks a group.
    attn = jax.nn.softmax(logits, axis=-2)
    attn = attn / (attn.sum(axis=-1, keepdims=True) + 1.0)   # assign_eps
    out = jnp.einsum("bhts,bshd->bthd", attn, vv)
    out = out.reshape(B, -1, D)
    return L.dense(p["o"], out)


def _gv_downsample_apply(p, x, group_tokens):
    """x: (B, S, D) image tokens; group_tokens: (B, G_in, D).
    Returns new_x: (B, G_out, D)."""
    gt = L.layernorm(p["norm_tokens"], group_tokens)
    # token-mixing projection G_in -> G_out
    t = jnp.swapaxes(gt, 1, 2)                               # (B, D, G_in)
    t = L.dense(p["mlp_inter"]["fc2"],
                _gelu(L.dense(p["mlp_inter"]["fc1"], t)))
    proj_gt = L.layernorm(p["norm_post_tokens"], jnp.swapaxes(t, 1, 2))
    xn = L.layernorm(p["norm_x"], x)
    proj_gt = _gv_cross_attn_apply(p["pre_assign_attn"], proj_gt, xn,
                                   _GV_VHEADS)
    new_x = proj_gt + _gv_assign_attn(p["assign"], proj_gt, xn, _GV_VHEADS)
    new_x = new_x + L.dense(
        p["mlp_channels"]["fc2"],
        _gelu(L.dense(p["mlp_channels"]["fc1"],
                      L.layernorm(p["norm_new_x"], new_x))))
    return new_x


def groupvit_init(key):
    ks = iter(jax.random.split(key, 64))
    vision = {
        "pos": jnp.zeros((1, 196, _GV_VD), jnp.float32),
        "patch": L.conv_init(next(ks), 16, 16, 3, _GV_VD),
        "emb_ln": _ln(_GV_VD),
        "stages": [],
        "ln": _ln(_GV_VD),
    }
    for si, depth in enumerate(_GV_DEPTHS):
        stage = {"layers": [_block_init(next(ks), _GV_VD, _GV_VFFN)
                            for _ in range(depth)]}
        if _GV_GROUP_TOKENS[si]:
            stage["group_token"] = jnp.zeros(
                (1, _GV_GROUP_TOKENS[si], _GV_VD), jnp.float32)
            n_in = _GV_GROUP_TOKENS[si]
            stage["downsample"] = _gv_downsample_init(
                next(ks), _GV_VD, _GV_VFFN, n_in, _GV_OUT_GROUPS[si],
                mixer_hidden=_GV_VD // 2)
        if si == 1:
            # projects previous stage's 64 groups into this stage's 8
            # group-token inits: LN + token-mixing MLP 64 -> 192 -> 8.
            stage["group_projector"] = {
                "norm": _ln(_GV_VD),
                "fc1": L.dense_init(next(ks), _GV_OUT_GROUPS[0],
                                    _GV_VD // 2),
                "fc2": L.dense_init(next(ks), _GV_VD // 2,
                                    _GV_GROUP_TOKENS[1]),
            }
        vision["stages"].append(stage)

    text = {
        "tok_emb": L.embedding_init(next(ks), _GV_TVOCAB, _GV_TD),
        "pos_emb": L.embedding_init(next(ks), _GV_TPOS, _GV_TD),
        "blocks": [_block_init(next(ks), _GV_TD, _GV_TFFN)
                   for _ in range(_GV_TLAYERS)],
        "ln": _ln(_GV_TD),
    }

    def proj_init(in_d):
        k1, k2 = jax.random.split(next(ks))
        return {"fc1": L.dense_init(k1, in_d, _GV_PROJ_INTER),
                "bn": {"scale": jnp.ones((_GV_PROJ_INTER,), jnp.float32),
                       "bias": jnp.zeros((_GV_PROJ_INTER,), jnp.float32)},
                "fc2": L.dense_init(k2, _GV_PROJ_INTER, _GV_PROJ)}

    return {"logit_scale": jnp.asarray(math.log(1 / 0.07), jnp.float32),
            "vision": vision, "text": text,
            "visual_projection": proj_init(_GV_VD),
            "text_projection": proj_init(_GV_TD)}


def _gv_project(p, x, state_mean=0.0, state_var=1.0):
    h = L.dense(p["fc1"], x)
    h = (h - state_mean) / jnp.sqrt(state_var + 1e-5)        # BN (inference)
    h = h * p["bn"]["scale"] + p["bn"]["bias"]
    return L.dense(p["fc2"], jax.nn.relu(h))


def groupvit_apply(p, images, ids):
    """images: (B,224,224,3), ids: (B,T<=77) -> (image_embeds, text_embeds)
    both (B, 256), plus logit scale."""
    v = p["vision"]
    B = images.shape[0]
    x = L.conv2d(v["patch"], images, stride=16, padding="VALID")
    x = x.reshape(B, -1, _GV_VD) + v["pos"]
    x = L.layernorm(v["emb_ln"], x)
    prev_groups = None
    for si, stage in enumerate(v["stages"]):
        if "group_token" in stage:
            gt = jnp.broadcast_to(stage["group_token"],
                                  (B,) + stage["group_token"].shape[1:])
            if "group_projector" in stage and prev_groups is not None:
                t = L.layernorm(stage["group_projector"]["norm"],
                                prev_groups)
                t = jnp.swapaxes(t, 1, 2)
                t = L.dense(stage["group_projector"]["fc2"],
                            _gelu(L.dense(stage["group_projector"]["fc1"],
                                          t)))
                gt = gt + jnp.swapaxes(t, 1, 2)
            h = jnp.concatenate([x, gt], axis=1)
        else:
            h = x
        for blk in stage["layers"]:
            h = _block_apply_preln(blk, h, _GV_VHEADS)
        if "group_token" in stage:
            n_img = x.shape[1]
            img_tok, grp_tok = h[:, :n_img], h[:, n_img:]
            x = _gv_downsample_apply(stage["downsample"], img_tok, grp_tok)
            prev_groups = x
        else:
            x = h
    x = L.layernorm(v["ln"], x)
    image_embeds = _gv_project(p["visual_projection"], jnp.mean(x, axis=1))

    t = p["text"]
    T = ids.shape[1]
    h = L.embedding(t["tok_emb"], ids) + t["pos_emb"]["w"][None, :T]
    causal = jnp.tril(jnp.ones((T, T), bool))[None, None]
    for blk in t["blocks"]:
        h = _block_apply_preln(blk, h, _GV_THEADS, mask=causal)
    h = L.layernorm(t["ln"], h)
    eot = h[jnp.arange(h.shape[0]), ids.argmax(axis=-1)]
    text_embeds = _gv_project(p["text_projection"], eot)
    return image_embeds, text_embeds, jnp.exp(p["logit_scale"])

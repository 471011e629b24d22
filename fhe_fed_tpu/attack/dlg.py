"""DLG gradient-inversion attack (Deep Leakage from Gradients), pure JAX.

Reference parity: code/attack/code.py:446-543 and exp1.py — reconstruct a
client's training input from its shared gradients by optimizing dummy
(data, label) so the dummy gradients match; layers listed in
`protected_layers` have their gradients zeroed on BOTH sides
(code.py:466-477), modeling selective encryption of those layers. The
attack's success/failure under partial protection is what justifies the
framework's selective-encryption mode (SURVEY.md C20/C23).

The whole attack step — forward, backward, gradient-matching loss, and
its second-order gradient — is one jitted function; the optimizer is optax
(adam by default; the reference's LBFGS converges faster per step but each
step is many closures).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np
import jax
import jax.numpy as jnp
import optax


def cross_entropy_onehot(logits: jnp.ndarray,
                         onehot: jnp.ndarray) -> jnp.ndarray:
    """mean(sum(-onehot * log_softmax(logits))) (code.py cross_entropy)."""
    return jnp.mean(jnp.sum(-onehot * jax.nn.log_softmax(logits, -1), -1))


def _zero_protected(grads_flat: list, protected: Sequence[int]):
    return [jnp.zeros_like(g) if i in set(protected) else g
            for i, g in enumerate(grads_flat)]


def _apply_element_mask(grads_flat: list, keep_flat: jnp.ndarray) -> list:
    """Multiply a flat leaf-grad list by a flat (n_params,) keep mask —
    element-level protection (reference masking.py:141-145 semantics:
    shared grads * (1 - top_k_mask))."""
    out = []
    off = 0
    for g in grads_flat:
        m = keep_flat[off:off + g.size].reshape(g.shape)
        out.append(g * m)
        off += g.size
    return out


def model_gradients(apply: Callable, params, x: jnp.ndarray,
                    onehot: jnp.ndarray,
                    protected_layers: Sequence[int] = ()) -> list:
    """The client's shared gradient, with protected layers zeroed
    (code.py:466-477). Returns a flat list of leaf gradients.

    Runs at full f32 matmul precision: a privacy evaluation must mount
    the strongest attack, and reduced-precision matmul defaults (bf16 or
    TF32, depending on the platform) silently break gradient matching —
    measured: LBFGS stalls at loss ~1e-5 / corr 0.12 under bf16 defaults
    vs 3e-10 / corr 0.98 at full precision on the same seeds."""
    with jax.default_matmul_precision("highest"):
        def loss_fn(p):
            return cross_entropy_onehot(apply(p, x), onehot)
        grads = jax.grad(loss_fn)(params)
    leaves, _ = jax.tree_util.tree_flatten(grads)
    return _zero_protected(leaves, protected_layers)


@dataclasses.dataclass
class DLGResult:
    data: np.ndarray          # recovered input
    label: np.ndarray         # recovered label distribution
    losses: np.ndarray        # grad-matching loss per recorded step
    history: list             # snapshots of the recovered input


def dlg_attack(apply: Callable, params, target_grads: list,
               data_shape, n_classes: int,
               protected_layers: Sequence[int] = (),
               element_mask=None,
               steps: int = 300, lr: float = 0.1, seed: int = 0,
               record_every: int = 50,
               optimizer: str = "adam") -> DLGResult:
    """Run the attack: optimize (dummy_data, dummy_label) so that
    grad(model; dummy) matches `target_grads` (code.py:482-531).

    element_mask: optional flat (n_params,) 0/1 array — 1 marks elements
    protected by sensitivity-based selective encryption (masking.py
    top_k_mask); the attacker knows the mask and matches only the
    unprotected elements (the element-level analogue of
    protected_layers)."""
    treedef = jax.tree_util.tree_structure(params)
    protected = tuple(protected_layers)
    keep = (None if element_mask is None
            else 1.0 - jnp.asarray(element_mask, jnp.float32))

    key = jax.random.key(seed)
    k1, k2 = jax.random.split(key)
    dummy = {
        "data": jax.random.normal(k1, data_shape, jnp.float32),
        "label": jax.random.normal(k2, (data_shape[0], n_classes),
                                   jnp.float32),
    }

    target = [jnp.asarray(g) for g in target_grads]

    def match_loss(d):
        onehot = jax.nn.softmax(d["label"], axis=-1)

        def loss_fn(p):
            return cross_entropy_onehot(apply(p, d["data"]), onehot)
        grads = jax.grad(loss_fn)(params)
        leaves, _ = jax.tree_util.tree_flatten(grads)
        leaves = _zero_protected(leaves, protected)
        if keep is not None:
            leaves = _apply_element_mask(leaves, keep)
        return sum(jnp.sum((gx - gy) ** 2)
                   for gx, gy in zip(leaves, target))

    if optimizer == "lbfgs":
        # the reference's own optimizer (code.py uses torch.optim.LBFGS);
        # linesearch-driven, much better conditioned for grad matching.
        opt = optax.lbfgs()
        value_and_grad = optax.value_and_grad_from_state(match_loss)

        @jax.jit
        def step(d, s):
            loss, g = value_and_grad(d, state=s)
            updates, s = opt.update(g, s, d, value=loss, grad=g,
                                    value_fn=match_loss)
            return optax.apply_updates(d, updates), s, loss
    else:
        opt = optax.adam(lr)

        @jax.jit
        def step(d, s):
            loss, g = jax.value_and_grad(match_loss)(d)
            updates, s = opt.update(g, s, d)
            return optax.apply_updates(d, updates), s, loss
    opt_state = opt.init(dummy)

    losses, history = [], []
    # full f32 matmul precision at trace time — see model_gradients
    with jax.default_matmul_precision("highest"):
        for i in range(steps):
            dummy, opt_state, loss = step(dummy, opt_state)
            if i % record_every == 0 or i == steps - 1:
                losses.append(float(loss))
                history.append(np.asarray(dummy["data"]))
    return DLGResult(data=np.asarray(dummy["data"]),
                     label=np.asarray(jax.nn.softmax(dummy["label"], -1)),
                     losses=np.asarray(losses), history=history)

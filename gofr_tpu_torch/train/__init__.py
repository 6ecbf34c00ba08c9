"""Training step: causal-LM loss + AdamW, on one device.

Ports ``gofr_tpu/train/__init__.py``: ``cross_entropy_loss`` (optax's
``softmax_cross_entropy_with_integer_labels``, in f32, masked as the
reference masks it) and ``make_train_step`` (the same signature, the same
``(init_opt_state, train_step)`` pair and the same metrics: ``loss``,
``aux_loss``, ``total_loss``, ``grad_norm``). Beside them ``adamw``, a copy of
``optax.adamw`` (the reference's default optimizer; the card's machine has
no optax): an ``init`` / ``update`` pair on trees of tensors, its moments in
the parameter dtype (optax's ``mu_dtype=None``), bias correction by the
step count, eps outside the square root, the decoupled decay ``+ wd * p``
on every leaf, then ``* -lr``, each scalar rounded to the leaf's dtype
before it multiplies or adds, as JAX rounds a Python scalar, so a bf16 leaf
rounds where optax's does. ``AdamWState`` carries optax's
``ScaleByAdamState`` (``models.weights.adam_state_from_numpy`` brings one
across). ``grad_norm`` is ``optax.global_norm``, accumulated in f32.

The reference's ``jax.checkpoint(forward_fn)`` is
``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)`` over the
whole forward: the backward recomputes it, so a flash forward
(``ops/flash_attention.FlashAttention``) runs twice per attention sublayer
per step. The step writes the updated values into the parameter tensors in
place (the counterpart of donating them), returns the same tree, and reads
nothing back to the host: its metrics are 0-d tensors on the device.
Sharding (the reference's dp / tp / pp / ep placement) waits in ROADMAP A14b.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from .. import tree as tree_util


def cross_entropy_loss(logits, targets, mask=None):
    """logits: [B, T, V] (taken in f32); targets: [B, T] int; mask: [B, T]
    (1 = count). The mean per-position loss over the counted positions."""
    logits = logits.float()
    # optax's order: shift by the (gradient-free) max, take the label's
    # logit, subtract it from the log of the shifted exponentials' sum
    shifted = logits - logits.amax(dim=-1, keepdim=True).detach()
    label_logits = shifted.gather(-1, targets.long()[..., None])[..., 0]
    losses = torch.log(torch.exp(shifted).sum(dim=-1)) - label_logits
    if mask is None:
        return losses.mean()
    mask = mask.to(losses.dtype)
    return (losses * mask).sum() / torch.clamp(mask.sum(), min=1.0)


class AdamWState(NamedTuple):
    """optax's ScaleByAdamState: the int32 step count and the two moment
    trees."""
    count: torch.Tensor
    mu: Any
    nu: Any


def _scalar(x: float, dtype: torch.dtype) -> float:
    """`x` rounded to `dtype`, as JAX turns a Python scalar into an array of
    the dtype it meets."""
    return float(torch.tensor(x, dtype=torch.float64).to(dtype))


class adamw:
    """``optax.adamw(learning_rate, b1, b2, eps, eps_root, weight_decay)``
    with optax's defaults: scale_by_adam, then add_decayed_weights, then
    scale_by_learning_rate. ``init(params)`` -> AdamWState;
    ``update(grads, state, params)`` -> (updates, state), both functional
    (apply with ``p + u``, as ``optax.apply_updates``)."""

    def __init__(self, learning_rate: float, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8, eps_root: float = 0.0,
                 weight_decay: float = 1e-4):
        self.learning_rate = learning_rate
        self.b1, self.b2 = b1, b2
        self.eps, self.eps_root = eps, eps_root
        self.weight_decay = weight_decay

    def init(self, params) -> AdamWState:
        first = tree_util.leaves(params)[0]
        return AdamWState(
            count=torch.zeros((), dtype=torch.int32, device=first.device),
            mu=tree_util.tree_map(torch.zeros_like, params),
            nu=tree_util.tree_map(torch.zeros_like, params))

    def update(self, grads, state: AdamWState, params):
        b1, b2 = self.b1, self.b2
        count = state.count
        count = torch.where(count < torch.iinfo(torch.int32).max, count + 1,
                            count)
        # 1 - decay**count in f32, cast to each moment's dtype below
        steps = count.float()
        bc1 = 1 - torch.full((), b1, dtype=torch.float32,
                             device=count.device).pow(steps)
        bc2 = 1 - torch.full((), b2, dtype=torch.float32,
                             device=count.device).pow(steps)

        def leaf(g, m, v, p):
            dt = g.dtype
            m = _scalar(1 - b1, dt) * g + _scalar(b1, dt) * m
            v = _scalar(1 - b2, dt) * (g * g) + _scalar(b2, dt) * v
            m_hat = m / bc1.to(dt)
            v_hat = v / bc2.to(dt)
            u = m_hat / (torch.sqrt(v_hat + _scalar(self.eps_root, dt))
                         + _scalar(self.eps, dt))
            u = u + _scalar(self.weight_decay, dt) * p
            return _scalar(-self.learning_rate, dt) * u, m, v

        flat = [leaf(*xs) for xs in zip(*(tree_util.leaves(t) for t in (
            grads, state.mu, state.nu, params)))]
        updates, mu, nu = (tree_util.unflatten(params, [f[i] for f in flat])
                           for i in range(3))
        return updates, AdamWState(count=count, mu=mu, nu=nu)


def global_norm(tree) -> torch.Tensor:
    """optax.global_norm, with every square summed in f32."""
    return torch.sqrt(sum(torch.sum(g.float() * g.float())
                          for g in tree_util.leaves(tree)))


def make_train_step(forward_fn: Callable, optimizer=None,
                    has_aux_loss: bool = False, aux_weight: float = 0.01,
                    remat: bool = True):
    """Build (init_opt_state, train_step).

    forward_fn(params, tokens) -> logits, or (logits, aux_loss) when
    has_aux_loss (MoE). optimizer: an object with optax's ``init`` /
    ``update`` pair (default: adamw(3e-4, weight_decay=0.01, b1=0.9,
    b2=0.95), the reference's). train_step(params, opt_state, tokens,
    targets, mask=None) -> (params, opt_state, metrics dict), the params
    tree the one passed in, its tensors updated in place."""
    if optimizer is None:
        optimizer = adamw(3e-4, weight_decay=0.01, b1=0.9, b2=0.95)

    def fwd(params, tokens):
        if remat:
            return checkpoint(forward_fn, params, tokens, use_reentrant=False)
        return forward_fn(params, tokens)

    def init_opt_state(params):
        return optimizer.init(params)

    def train_step(params, opt_state, tokens, targets, mask=None):
        leaves = tree_util.leaves(params)
        # autograd leaves over the parameters' own storage
        live = [p.detach().requires_grad_() for p in leaves]
        with torch.enable_grad():
            out = fwd(tree_util.unflatten(params, live), tokens)
            if has_aux_loss:
                logits, aux = out
            else:
                logits = out
                aux = torch.zeros((), dtype=torch.float32,
                                  device=logits.device)
            loss = cross_entropy_loss(logits, targets, mask)
            total = loss + aux_weight * aux if has_aux_loss else loss
            grads = torch.autograd.grad(total, live, allow_unused=True)
        grads = tree_util.unflatten(params, [
            torch.zeros_like(p) if g is None else g
            for p, g in zip(leaves, grads)])
        del live, out, logits
        grad_norm = global_norm(grads)
        with torch.no_grad():
            updates, opt_state = optimizer.update(grads, opt_state, params)
            for p, u in zip(leaves, tree_util.leaves(updates)):
                p.add_(u)
        return params, opt_state, {
            "loss": loss.detach(), "aux_loss": aux.detach(),
            "total_loss": total.detach(), "grad_norm": grad_norm}

    return init_opt_state, train_step

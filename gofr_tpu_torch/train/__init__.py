"""Training step: causal-LM loss + AdamW, on one device or sharded.

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

Sharded (ROADMAP A14b): ``make_train_step(..., mesh=mesh)``. The reference
shards by placement and lets XLA partition one jitted step; here every rank
runs the step on its own blocks (``parallel/sharding.shard_params``), and
the step is the reference's step over the global batch:

- ``train_step`` takes the GLOBAL batch, the same on every rank, as the
  reference's global arrays. ``forward_fn(params, tokens)`` gets it too and
  returns this rank's logits block [B/dp, T/sp, V] (the forwards of
  ``parallel/``: ``sharding.make_mesh_forward``,
  ``longcontext.make_sp_forward``, ``pipeline.pipelined_llama_forward``);
  the step cuts targets and mask to the same block (``batch_spec``).
- The loss is the global mean: each rank's sum of its positions' losses
  (masked) is summed over the data axes (dp, sp) by ``reduce_from``, over
  the global count (the mask's sum over the same axes, at least 1): with a
  mask, sum over sum across ranks, not the mean of the ranks' means. Every
  rank holds the global loss; its gradient is this rank's share.
- ``reduce_gradients`` sums every leaf's gradient over dp and sp (no leaf
  is split over them), one all-reduce a leaf, so every rank then holds
  the full gradient of its blocks (tp, pp and ep gradients come out of the
  conjugate collectives of the forward).
- ``grad_norm`` is ``optax.global_norm`` of the whole tree: each leaf's
  squares weighted by its blocks over the world size (the product of the
  sizes of the axes its spec in ``llama_param_specs(moe=has_aux_loss)``
  splits it over), summed over the world in one all-reduce, so a split
  leaf counts each block once and a replicated leaf once.
- AdamW runs on each rank's blocks in place, as on one device.
- Remat checkpoints the whole forward as on one device; its recompute
  issues the forward's collectives again, in the same order on every rank.

On a mesh whose axes are all 1 the step is the unsharded one, bit for bit.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from .. import tree as tree_util


def _position_losses(logits, targets):
    """optax.softmax_cross_entropy_with_integer_labels, [B, T] f32."""
    logits = logits.float()
    # optax's order: shift by the (gradient-free) max, take the label's
    # logit, subtract it from the log of the shifted exponentials' sum
    shifted = logits - logits.amax(dim=-1, keepdim=True).detach()
    label_logits = shifted.gather(-1, targets.long()[..., None])[..., 0]
    return torch.log(torch.exp(shifted).sum(dim=-1)) - label_logits


def cross_entropy_loss(logits, targets, mask=None):
    """logits: [B, T, V] (taken in f32); targets: [B, T] int; mask: [B, T]
    (1 = count). The mean per-position loss over the counted positions."""
    losses = _position_losses(logits, targets)
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


def reduce_gradients(grads: list, axes) -> None:
    """Sum each gradient of the list over each axis of `axes`, in place
    (a non-contiguous one replaced by its contiguous copy first)."""
    from ..parallel.collectives import all_reduce

    for i, g in enumerate(grads):
        grads[i] = g.contiguous()
        for axis in axes:
            all_reduce(grads[i], axis)


def _spec_leaves(specs, params) -> list:
    """The spec of every leaf of `params`, in flattening order."""
    if isinstance(params, dict):
        return [spec for k in sorted(params)
                for spec in _spec_leaves(specs[k], params[k])]
    return [specs]


class _MeshPlan:
    """What the sharded step needs of the mesh: the data axes (dp, sp) of
    size > 1, the world size, and each leaf's number of blocks under its
    spec."""

    def __init__(self, mesh, specs, params):
        from ..parallel.mesh import AXES, axis_of, axis_size

        self.mesh = mesh
        self.data = [axis_of(mesh, a) for a in ("dp", "sp")
                     if axis_size(mesh, a) > 1]
        self.world = 1
        for a in AXES:
            self.world *= axis_size(mesh, a)
        self.blocks = []
        for spec in _spec_leaves(specs, params):
            n = 1
            for a in spec:
                n *= 1 if a is None else axis_size(mesh, a)
            self.blocks.append(n)

    def local(self, x):
        """This rank's block of a global [B, T] batch tensor."""
        from ..parallel.sharding import batch_spec, local_block

        return local_block(x, self.mesh, batch_spec())

    def loss(self, logits, targets, mask):
        """The global mean loss over the data axes (the module
        docstring), from this rank's block of the batch."""
        if not self.data:
            return cross_entropy_loss(logits, targets, mask)
        from ..parallel.collectives import all_reduce, reduce_from

        losses = _position_losses(logits, targets)
        if mask is None:
            num = losses.sum()
            den = torch.full((), float(losses.numel()),
                             device=losses.device)
        else:
            mask = mask.to(losses.dtype)
            num = (losses * mask).sum()
            den = mask.sum()
        for axis in self.data:
            num = reduce_from(num, axis)
            den = all_reduce(den.detach().clone(), axis)
        return num / torch.clamp(den, min=1.0)

    def global_norm(self, grads) -> torch.Tensor:
        """optax.global_norm of the whole (global) tree from this rank's
        blocks (the module docstring)."""
        if self.world == 1:
            return global_norm(grads)
        import torch.distributed as dist

        from ..parallel.collectives import COUNTS

        sq = sum(torch.sum(g.float() * g.float()) * (n / self.world)
                 for g, n in zip(tree_util.leaves(grads), self.blocks))
        COUNTS["all_reduce"] += 1
        dist.all_reduce(sq)
        return torch.sqrt(sq)


def make_train_step(forward_fn: Callable, optimizer=None,
                    has_aux_loss: bool = False, aux_weight: float = 0.01,
                    remat: bool = True, mesh=None):
    """Build (init_opt_state, train_step).

    forward_fn(params, tokens) -> logits, or (logits, aux_loss) when
    has_aux_loss (MoE). optimizer: an object with optax's ``init`` /
    ``update`` pair (default: adamw(3e-4, weight_decay=0.01, b1=0.9,
    b2=0.95), the reference's). train_step(params, opt_state, tokens,
    targets, mask=None) -> (params, opt_state, metrics dict), the params
    tree the one passed in, its tensors updated in place.

    mesh: a parallel.make_mesh mesh: the sharded step of the module
    docstring; params are this rank's blocks under
    llama_param_specs(moe=has_aux_loss) (parallel.shard_params); tokens,
    targets and mask the global batch.

    ``train_step.loss_and_grads(params, tokens, targets, mask=None)``
    gives (loss, aux_loss, total_loss, grads) as the step computes them
    (on a mesh after the dp / sp reduction), without the update."""
    if optimizer is None:
        optimizer = adamw(3e-4, weight_decay=0.01, b1=0.9, b2=0.95)
    plans = {}

    def plan_of(params):
        if mesh is None:
            return None
        if "plan" not in plans:
            from ..parallel.sharding import llama_param_specs

            plans["plan"] = _MeshPlan(
                mesh, llama_param_specs(moe=has_aux_loss), params)
        return plans["plan"]

    def fwd(params, tokens):
        if remat:
            return checkpoint(forward_fn, params, tokens, use_reentrant=False)
        return forward_fn(params, tokens)

    def init_opt_state(params):
        return optimizer.init(params)

    def loss_and_grads(params, tokens, targets, mask=None):
        plan = plan_of(params)
        if plan is not None:
            targets = plan.local(targets)
            mask = None if mask is None else plan.local(mask)
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
            loss = (cross_entropy_loss(logits, targets, mask) if plan is None
                    else plan.loss(logits, targets, mask))
            total = loss + aux_weight * aux if has_aux_loss else loss
            grads = torch.autograd.grad(total, live, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        del live, out, logits
        if plan is not None and plan.data:
            reduce_gradients(grads, plan.data)
        return (loss.detach(), aux.detach(), total.detach(),
                tree_util.unflatten(params, grads))

    def train_step(params, opt_state, tokens, targets, mask=None):
        loss, aux, total, grads = loss_and_grads(params, tokens, targets,
                                                 mask)
        plan = plan_of(params)
        grad_norm = (global_norm(grads) if plan is None
                     else plan.global_norm(grads))
        with torch.no_grad():
            updates, opt_state = optimizer.update(grads, opt_state, params)
            for p, u in zip(tree_util.leaves(params),
                            tree_util.leaves(updates)):
                p.add_(u)
        return params, opt_state, {
            "loss": loss, "aux_loss": aux, "total_loss": total,
            "grad_norm": grad_norm}

    train_step.loss_and_grads = loss_and_grads
    return init_opt_state, train_step

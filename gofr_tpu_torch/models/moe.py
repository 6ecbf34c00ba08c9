"""Mixture-of-Experts Llama variant: a top-k routed SwiGLU FFN.

Ports ``gofr_tpu/models/moe.py``: ``MoELlamaConfig`` (the Llama fields plus
``n_experts`` and ``experts_per_token``, the same ``debug`` preset),
``moe_llama_init`` (the same shapes and recipe, normal * 1/sqrt(fan_in)
matrices and ones for the norms, drawn from a ``torch.Generator``; it never
tries to replay ``jax.random``), ``moe_ffn`` and
``moe_llama_forward_nocache``.

The router is the reference's: the router logits in f32, their softmax,
the top-K probabilities renormalized to sum to 1, gates scattered from a
one-hot of the chosen experts, and dense dispatch (every expert computes
every token, the gates zero the experts not chosen), with the Switch-style
load-balancing loss ``E * sum_e mean(gates_e > 0) * mean(probs_e)``.
``torch.topk`` breaks ties at the K-th place in another order than
``jax.lax.top_k``; the gates depend only on the chosen set, so the two
agree wherever no two probabilities tie there. The products are plain
torch einsums, as the reference's are XLA einsums: no Pallas call. The
attention sublayer is the Llama one (``llama._attention_block_nocache``),
flash under ``attn_impl="flash"``.

Expert parallelism (ROADMAP A14b): under ``MoEShardConfig`` (made by
parallel/sharding.shard_config from a MoELlamaConfig) each rank holds the
blocks ``llama_param_specs(moe=True)`` gives it: the expert weights
``[L, E/ep, D, F/tp]`` / ``[L, E/ep, F/tp, D]``, the router replicated,
the attention and embedding as the Llama ones under tp. Each rank computes
its experts' share of the dense combine (experts ``ep.rank * E/ep`` on), and
the combine is summed over tp and ep, as XLA partitions the reference's
einsums over the expert axis. The experts' input and the gates go through
``copy_to`` over ep (and the input over tp), so their gradients are summed
over ep, and the combine through ``reduce_from`` (under ``no_grad`` the
forward-only collectives, parallel/collectives.py). The
aux loss is the reference's over the GLOBAL batch: the routed fractions
and router masses are summed over the config's data axes (dp, sp) before
``E * sum_e f_e * p_e`` (``reduce_from``, so each rank's gradient is its
own tokens' share, which the train step sums over dp and sp).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from ..tpu.device import resolve_device
from ..parallel.collectives import copy_to, reduce_from
from .llama import (DTYPES, LlamaConfig, ShardConfig, _attention_block_nocache,
                    _embed, _head, _layer, _tp, nocache_positions,
                    rms_norm, scaled_normal)


@dataclasses.dataclass(frozen=True)
class MoELlamaConfig(LlamaConfig):
    n_experts: int = 8
    experts_per_token: int = 2

    @classmethod
    def debug(cls) -> "MoELlamaConfig":
        return cls(vocab_size=512, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
                   ffn_dim=128, max_seq_len=256, dtype="float32",
                   n_experts=4, experts_per_token=2)


@dataclasses.dataclass(frozen=True)
class MoEShardConfig(ShardConfig, MoELlamaConfig):
    """One rank's view of a MoELlamaConfig under a mesh: ShardConfig's
    heads and tp / sp axes, `ep` the expert axis (n_experts stays the
    model's), and `data` the mesh's data axes of size > 1 (dp, sp), over
    which the aux loss's batch means are taken."""
    ep: Any = None
    data: Tuple[Any, ...] = ()


def moe_llama_init(cfg: MoELlamaConfig, seed: int = 0,
                   device=None) -> Dict[str, Any]:
    """Random-init params dict with stacked [L, ...] layer weights and
    [L, E, ...] expert weights, drawn on `device` (None = the CUDA card)
    from a torch.Generator seeded with `seed`."""
    dev = resolve_device(device)
    dtype = DTYPES[cfg.dtype]
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    init = scaled_normal(gen, dtype, dev)
    L, D, H, Hkv, dh, F_, V, E = (cfg.n_layers, cfg.dim, cfg.n_heads,
                                  cfg.n_kv_heads, cfg.head_dim, cfg.ffn_dim,
                                  cfg.vocab_size, cfg.n_experts)

    def ones(shape):
        return torch.ones(shape, dtype=dtype, device=dev)

    return {
        "tok_emb": init((V, D), D),
        "layers": {
            "wq": init((L, D, H * dh), D),
            "wk": init((L, D, Hkv * dh), D),
            "wv": init((L, D, Hkv * dh), D),
            "wo": init((L, H * dh, D), H * dh),
            "w_router": init((L, D, E), D),
            "w_gate": init((L, E, D, F_), D),
            "w_up": init((L, E, D, F_), D),
            "w_down": init((L, E, F_, D), F_),
            "attn_norm": ones((L, D)),
            "ffn_norm": ones((L, D)),
        },
        "final_norm": ones((D,)),
        "lm_head": init((D, V), D),
    }


def _over(x, axes):
    """x summed over each axis of `axes` (reduce_from)."""
    for axis in axes:
        x = reduce_from(x, axis)
    return x


def _balance(gates, probs, cfg):
    """(routed fraction, router mass) per expert, [E] f32 each: their means
    over the batch, the global batch under the config's data axes."""
    data = getattr(cfg, "data", ())
    if not data:
        return (gates > 0).float().mean(dim=(0, 1)), probs.mean(dim=(0, 1))
    n = gates.shape[0] * gates.shape[1]
    for axis in data:
        n *= axis.size
    sums = torch.stack([(gates > 0).float().sum(dim=(0, 1)),
                        probs.sum(dim=(0, 1))])
    sums = _over(sums, data)
    return sums[0] / n, sums[1] / n


def moe_ffn(x, layer, cfg: MoELlamaConfig):
    """Top-k routed SwiGLU experts, dense dispatch. x: [B, T, D] ->
    ([B, T, D] in x.dtype, the router's load-balancing loss, f32). Under
    an ep / tp axis, this rank's experts and FFN columns, summed over both
    (the module docstring)."""
    E, K = cfg.n_experts, cfg.experts_per_token
    tp, ep = _tp(cfg), getattr(cfg, "ep", None)
    normed = rms_norm(x, layer["ffn_norm"], cfg.rms_eps)

    router_logits = (normed @ layer["w_router"]).float()            # [B,T,E]
    probs = torch.softmax(router_logits, dim=-1)
    top_vals, top_idx = torch.topk(probs, K, dim=-1)                # [B,T,K]
    top_vals = top_vals / top_vals.sum(dim=-1, keepdim=True)
    gates = (F.one_hot(top_idx, E).to(probs.dtype)
             * top_vals[..., None]).sum(dim=-2)                     # [B,T,E]

    # dense dispatch: every expert processes every token, the gates select;
    # this rank's experts [first, first + n) of the E
    xin, gin = normed, gates
    for axis in (tp, ep):
        if axis is not None:
            xin = copy_to(xin, axis)
    if ep is not None:
        gin = copy_to(gin, ep)
    n = layer["w_gate"].shape[0]
    first = ep.rank * n if ep is not None else 0
    gate_proj = torch.einsum("btd,edf->betf", xin, layer["w_gate"])
    up_proj = torch.einsum("btd,edf->betf", xin, layer["w_up"])
    expert_out = torch.einsum("betf,efd->betd", F.silu(gate_proj) * up_proj,
                              layer["w_down"])
    out = torch.einsum("betd,bte->btd", expert_out,
                       gin[..., first:first + n].to(expert_out.dtype))
    out = _over(out, [a for a in (tp, ep) if a is not None])

    # load balancing: the fraction of tokens routed vs the router's mass
    me, ce = _balance(gates, probs, cfg)
    aux_loss = E * (me * ce).sum()
    return out.to(x.dtype), aux_loss


def moe_llama_forward_nocache(params, cfg: MoELlamaConfig, tokens):
    """Training forward: causal attention + MoE FFN over positions [0, T).
    Returns (logits [B, T, V] f32, the layers' mean aux loss, f32). Under a
    MoEShardConfig `tokens` is this rank's block of the batch (the
    embedding, attention and head as llama_forward_nocache's under a
    ShardConfig)."""
    positions, attn_fn = nocache_positions(cfg, tokens)
    x = _embed(params, cfg, tokens)
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    for l in range(cfg.n_layers):
        layer = _layer(params, l)
        x = x + _attention_block_nocache(x, layer, positions, cfg, attn_fn)
        ffn_out, layer_aux = moe_ffn(x, layer, cfg)
        x = x + ffn_out
        aux = aux + layer_aux
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    return _head(x, params, cfg), aux / cfg.n_layers

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
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch
import torch.nn.functional as F

from ..tpu.device import resolve_device
from .llama import (DTYPES, LlamaConfig, _attention_block_nocache, _layer,
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


def moe_ffn(x, layer, cfg: MoELlamaConfig):
    """Top-k routed SwiGLU experts, dense dispatch. x: [B, T, D] ->
    ([B, T, D] in x.dtype, the router's load-balancing loss, f32)."""
    E, K = cfg.n_experts, cfg.experts_per_token
    normed = rms_norm(x, layer["ffn_norm"], cfg.rms_eps)

    router_logits = (normed @ layer["w_router"]).float()            # [B,T,E]
    probs = torch.softmax(router_logits, dim=-1)
    top_vals, top_idx = torch.topk(probs, K, dim=-1)                # [B,T,K]
    top_vals = top_vals / top_vals.sum(dim=-1, keepdim=True)
    gates = (F.one_hot(top_idx, E).to(probs.dtype)
             * top_vals[..., None]).sum(dim=-2)                     # [B,T,E]

    # dense dispatch: every expert processes every token, the gates select
    gate_proj = torch.einsum("btd,edf->betf", normed, layer["w_gate"])
    up_proj = torch.einsum("btd,edf->betf", normed, layer["w_up"])
    expert_out = torch.einsum("betf,efd->betd", F.silu(gate_proj) * up_proj,
                              layer["w_down"])
    out = torch.einsum("betd,bte->btd", expert_out,
                       gates.to(expert_out.dtype))

    # load balancing: the fraction of tokens routed vs the router's mass
    me = (gates > 0).float().mean(dim=(0, 1))
    ce = probs.mean(dim=(0, 1))
    aux_loss = E * (me * ce).sum()
    return out.to(x.dtype), aux_loss


def moe_llama_forward_nocache(params, cfg: MoELlamaConfig, tokens):
    """Training forward: causal attention + MoE FFN over positions [0, T).
    Returns (logits [B, T, V] f32, the layers' mean aux loss, f32)."""
    B, T = tokens.shape
    positions = torch.arange(T, device=tokens.device).expand(B, T)
    x = params["tok_emb"][tokens]
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    for l in range(cfg.n_layers):
        layer = _layer(params, l)
        x = x + _attention_block_nocache(x, layer, positions, cfg)
        ffn_out, layer_aux = moe_ffn(x, layer, cfg)
        x = x + ffn_out
        aux = aux + layer_aux
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    logits = (x @ params["lm_head"]).float()
    return logits, aux / cfg.n_layers

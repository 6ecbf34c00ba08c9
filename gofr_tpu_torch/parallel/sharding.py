"""Sharding rules: partition specs for the params and batches, and each
rank's block of them.

Ports from ``gofr_tpu/parallel/sharding.py``: the spec trees, verbatim
(``llama_param_specs(moe)``, ``serving_param_specs(quantized)`` with the
``*_s`` scales, ``kv_cache_spec``, ``kv_cache_layer_spec``,
``kv_scale_layer_spec``, ``kv_scale_pool_spec``, ``batch_spec``,
``unsharded_like``), each spec a tuple of one axis name or None per
dimension (what ``jax.sharding.PartitionSpec`` holds), and
``shard_params``.

Where the reference's ``shard_params`` commits each leaf to the mesh as
one global array and lets XLA insert the collectives, the port's returns
each leaf's LOCAL block for this rank: a dimension split over an axis of
size n keeps its contiguous block number ``mesh.get_local_rank(axis)``,
so the flattened H*dh (Hkv*dh) projection axis splits into whole heads,
matching the KV cache's KV-head split, and a vocab axis into contiguous id
ranges. The blocks are plain tensors, not DTensors: the engines' captured
CUDA graphs read fixed addresses and the hand-written kernels take raw
pointers, so the port keeps ordinary tensors and issues the collectives
itself (parallel/collectives.py, models/llama.py). ``shard_config`` gives
the matching rank-local config (models/llama.ShardConfig: this rank's head
counts, and the tp / sp axes the model functions reduce over).

``mesh_llama_forward`` (``make_mesh_forward`` binds it for a training step)
is the forward the reference's jitted step partitions from those
placements: the global batch in, this rank's block of it run under
``shard_config`` (the Megatron collectives and their conjugates in
models/llama.py, the expert split in models/moe.py), this block's logits
out.

``gofr_tpu/parallel/compat.py`` (a shim over JAX releases' ``shard_map``
spellings) has no counterpart: nothing here depends on a JAX version.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch


def _P(*names):
    return tuple(names)


def llama_param_specs(moe: bool = False) -> Dict[str, Any]:
    """The partition specs matching llama_init's params structure."""
    layers = {
        # [L, D, H*dh]: heads are column-parallel over tp; L pipelines over pp
        "wq": _P("pp", None, "tp"),
        "wk": _P("pp", None, "tp"),
        "wv": _P("pp", None, "tp"),
        # [L, H*dh, D]: row-parallel (contraction dim sharded)
        "wo": _P("pp", "tp", None),
        "w_gate": _P("pp", None, "tp"),
        "w_up": _P("pp", None, "tp"),
        "w_down": _P("pp", "tp", None),
        "attn_norm": _P("pp", None),
        "ffn_norm": _P("pp", None),
    }
    if moe:
        layers.update({
            # router [L, D, E] replicated over tp (tiny); experts over ep
            "w_router": _P("pp", None, None),
            # [L, E, D, F]
            "w_gate": _P("pp", "ep", None, "tp"),
            "w_up": _P("pp", "ep", None, "tp"),
            "w_down": _P("pp", "ep", "tp", None),
        })
    return {
        "tok_emb": _P("tp", None),   # vocab-sharded embedding
        "layers": layers,
        "final_norm": _P(None),
        "lm_head": _P(None, "tp"),   # column-parallel output projection
    }


def serving_param_specs(quantized: bool = False) -> Dict[str, Any]:
    """The partition specs for the SERVING engine: tp only.

    No pp axis: the stacked [L, ...] layer axis stays whole, every layer
    runs on every tp rank (Megatron-style, an all-reduce per row-parallel
    product). Contiguous-block head sharding means splitting the flattened
    H*dh / Hkv*dh projection axis over tp yields whole heads per rank,
    matching the KV cache's Hkv split (kv_cache_spec). tok_emb is
    replicated (a token-id gather at arbitrary ids beats a vocab-sharded
    gather + all-reduce for decode's tiny T); lm_head stays
    column-parallel.

    quantized=True matches an int8 tree (models.llama.quantize_weights):
    each per-output-channel scale vector shards exactly like its weight's
    OUTPUT axis: column-parallel weights get tp-sharded scales, row-
    parallel weights (wo/w_down, contraction sharded) keep whole scales.
    """
    layers = {
        "wq": _P(None, None, "tp"),
        "wk": _P(None, None, "tp"),
        "wv": _P(None, None, "tp"),
        "wo": _P(None, "tp", None),
        "w_gate": _P(None, None, "tp"),
        "w_up": _P(None, None, "tp"),
        "w_down": _P(None, "tp", None),
        "attn_norm": _P(None, None),
        "ffn_norm": _P(None, None),
    }
    if quantized:
        layers.update({
            "wq_s": _P(None, "tp"), "wk_s": _P(None, "tp"),
            "wv_s": _P(None, "tp"), "wo_s": _P(None, None),
            "w_gate_s": _P(None, "tp"), "w_up_s": _P(None, "tp"),
            "w_down_s": _P(None, None),
        })
    out = {
        "tok_emb": _P(None, None),
        "layers": layers,
        "final_norm": _P(None),
        "lm_head": _P(None, "tp"),
    }
    if quantized:
        out["tok_emb_s"] = _P(None)      # per-row scales ride the gather
        out["lm_head_s"] = _P("tp")      # column scales follow the vocab split
    return out


def kv_cache_spec():
    """Stacked KV cache/pool [L, B|P, Hkv, dh, S]: KV heads shard over tp,
    matching the column split of wk/wv so each rank writes and reads only
    its heads."""
    return _P(None, None, "tp", None, None)


def kv_cache_layer_spec():
    """One per-layer cache buffer [B, Hkv, dh, S] (the dense engine's
    representation, init_kv_cache_layers): KV heads over tp."""
    return _P(None, "tp", None, None)


def kv_scale_layer_spec():
    """Per-layer int8 dequant scales [B, Hkv, S]: KV heads over tp,
    row-aligned with kv_cache_layer_spec."""
    return _P(None, "tp", None)


def kv_scale_pool_spec():
    """Stacked paged scale pool [L, P, Hkv, ps]: KV heads over tp,
    row-aligned with kv_cache_spec."""
    return _P(None, None, "tp", None)


def batch_spec():
    """Token batches [B, T]: batch over dp, sequence over sp."""
    return _P("dp", "sp")


def _column_major(t: torch.Tensor) -> bool:
    return t.dim() >= 2 and t.stride(-2) == 1 and t.stride(-1) != 1


def local_block(t: torch.Tensor, mesh, spec) -> torch.Tensor:
    """This rank's block of `t` under `spec`: each dimension named by an
    axis of size n > 1 narrowed to its contiguous block number
    mesh.get_local_rank(axis). A leaf no axis splits is returned as it is;
    a split leaf is copied, keeping a column-major leaf column-major (the
    int8 weights' layout, models/llama.py)."""
    from .mesh import axis_size

    block = t
    for dim, axis in enumerate(spec):
        n = axis_size(mesh, axis) if axis is not None else 1
        if n == 1:
            continue
        size = t.shape[dim]
        if size % n:
            raise ValueError(f"dim {dim} of {tuple(t.shape)} does not "
                             f"divide by |{axis}|={n}")
        step = size // n
        block = block.narrow(dim, mesh.get_local_rank(axis) * step, step)
    if block is t:
        return t
    if _column_major(t):
        return block.transpose(-1, -2).contiguous().transpose(-1, -2)
    return block.contiguous()


def shard_params(params, mesh, specs=None):
    """Each leaf of `params` replaced by this rank's block under `specs`
    (default llama_param_specs()): a new tree, the input left as it is."""
    if specs is None:
        specs = llama_param_specs()

    def place(tree, spec):
        if isinstance(tree, dict):
            return {k: place(v, spec[k]) for k, v in tree.items()}
        return local_block(tree, mesh, spec)

    return place(params, specs)


def unsharded_like(tree):
    """Fully-replicated specs with the same structure (for small states)."""
    if isinstance(tree, dict):
        return {k: unsharded_like(v) for k, v in tree.items()}
    return _P()


def shard_config(cfg, mesh, sp: bool = False):
    """The rank-local config of `cfg` under `mesh`
    (models/llama.ShardConfig): n_heads and n_kv_heads divided by |tp|
    (whole heads per rank; ValueError unless tp divides both), the tp axis,
    and with sp=True the sp axis (the mesh forward's K/V all-gather). A
    MoELlamaConfig gives a models/moe.MoEShardConfig, with the ep axis
    (ValueError unless ep divides n_experts) and the data axes (dp, sp) of
    size > 1, over which its aux loss takes the batch means."""
    from ..models.llama import ShardConfig
    from ..models.moe import MoELlamaConfig, MoEShardConfig
    from .mesh import axis_of, axis_size

    tp = axis_size(mesh, "tp")
    if cfg.n_kv_heads % tp or cfg.n_heads % tp:
        raise ValueError(
            f"tp={tp} must divide n_kv_heads={cfg.n_kv_heads} and "
            f"n_heads={cfg.n_heads} (whole heads per shard)")
    base = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
            if f.name not in ("tp", "sp", "ep", "data")}
    base.update(n_heads=cfg.n_heads // tp, n_kv_heads=cfg.n_kv_heads // tp)
    axes = dict(tp=axis_of(mesh, "tp"),
                sp=axis_of(mesh, "sp") if sp else None)
    if not isinstance(cfg, MoELlamaConfig):
        return ShardConfig(**base, **axes)
    ep = axis_size(mesh, "ep")
    if cfg.n_experts % ep:
        raise ValueError(f"ep={ep} must divide n_experts={cfg.n_experts}")
    data = tuple(axis_of(mesh, a) for a in ("dp", "sp")
                 if axis_size(mesh, a) > 1)
    return MoEShardConfig(**base, **axes, ep=axis_of(mesh, "ep"), data=data)


def mesh_llama_forward(params, cfg, tokens, mesh):
    """The reference's annotation-sharded training forward on this rank:
    llama_forward_nocache (or moe_llama_forward_nocache for a
    MoELlamaConfig) over params placed by shard_params (llama_param_specs)
    and a batch placed by batch_spec, which XLA partitions for the
    reference. tokens: the GLOBAL [B, T] batch, the same on every rank;
    this rank runs its [B/dp, T/sp] block under shard_config(cfg, mesh)
    (the K/V gathered over sp when |sp| > 1) and returns that block's
    logits [B/dp, T/sp, V] f32 (and the aux loss for a MoE)."""
    from ..models.llama import llama_forward_nocache
    from ..models.moe import MoELlamaConfig, moe_llama_forward_nocache
    from .mesh import axis_size

    local = local_block(tokens, mesh, batch_spec())
    lcfg = shard_config(cfg, mesh, sp=axis_size(mesh, "sp") > 1)
    if isinstance(cfg, MoELlamaConfig):
        return moe_llama_forward_nocache(params, lcfg, local)
    return llama_forward_nocache(params, lcfg, local)


def make_mesh_forward(cfg, mesh):
    """Bind (cfg, mesh) into a forward_fn(params, tokens) for the sharded
    training step (train.make_train_step with mesh=)."""
    def forward(params, tokens):
        return mesh_llama_forward(params, cfg, tokens, mesh)

    return forward

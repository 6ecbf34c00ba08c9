"""Llama-family decoder in PyTorch: GQA + RoPE + RMSNorm + SwiGLU.

Ports from ``gofr_tpu/models/llama.py``: ``LlamaConfig`` (same fields and
presets), ``llama_init`` (same recipe, drawn from a ``torch.Generator`` —
it never tries to replay ``jax.random``), ``rms_norm``, ``rope``, ``_mm``,
``_embed``, ``_head``, ``_attention_block`` (the T == S window, the T=1
``decode_attn="kernel"`` read through ops/decode_attention, and the plain
masked read), ``_ffn_block``, ``llama_forward_hidden``,
``llama_prefill_last``, the dense engine's ``init_kv_cache_layers``,
``init_kv_scale_layers``, ``llama_decode_step_unrolled`` and
``llama_decode_step_unrolled_q8``, and the paged
``llama_decode_step_paged`` and ``llama_decode_step_paged_q8``.

The params tree keeps the JAX layout — a dict with stacked [L, in, out]
layer weights and ``x @ W`` — so the weight bridge (models/weights.py) is
one copy per leaf. JAX's casts are kept: norms and rope in f32 cast back to
``x.dtype``, logits in f32. Caches and pools are updated in place where JAX
returns updated arrays (its engine donates them).

Not ported yet: int8 weights (``_q_matmul``, ``quantize_weights``) — ROADMAP
A13; the chunked, prefix and verify programs — ROADMAP A7, A10.

A cache write past a dense cache's last column (a finished row that keeps
advancing in lock-step decode) lands on that last column instead of being
dropped as JAX's scatter drops it: torch indexing would raise. The row's
emitted tokens never read that column (the engine caps a row's context at
max_seq_len - 1), so the result is the same.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from ..tpu.device import resolve_device

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128256
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    ffn_dim: int = 14336
    max_seq_len: int = 8192
    rope_theta: float = 500000.0
    rms_eps: float = 1e-5
    dtype: str = "bfloat16"
    # "xla" | "flash": the serving prefill's attention over its full window
    # (T == S in _attention_block). "xla" is plain masked attention, the
    # counterpart of the JAX einsum; "flash" is ops/flash_attention
    attn_impl: str = "xla"
    # "xla" | "kernel": the dense engine's T=1 read ("kernel" is
    # ops/decode_attention); the paged engine reads through its paged
    # kernel whatever this says
    decode_attn: str = "xla"
    # None (= dtype) | "int8": the KV cache's storage dtype. int8 stores
    # per-token-per-head scales beside it; the dense engine then needs
    # decode_attn == "kernel"
    kv_dtype: Optional[str] = None

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // self.n_kv_heads

    @classmethod
    def debug(cls) -> "LlamaConfig":
        """CI-sized model: runs in seconds on CPU."""
        return cls(vocab_size=512, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
                   ffn_dim=128, max_seq_len=256, dtype="float32")

    @classmethod
    def llama1b(cls) -> "LlamaConfig":
        """Llama-3.2-1B shape."""
        return cls(vocab_size=128256, dim=2048, n_layers=16, n_heads=32,
                   n_kv_heads=8, ffn_dim=8192, max_seq_len=8192)

    @classmethod
    def llama3_8b(cls) -> "LlamaConfig":
        return cls(vocab_size=128256, dim=4096, n_layers=32, n_heads=32,
                   n_kv_heads=8, ffn_dim=14336, max_seq_len=8192)

    @classmethod
    def llama3_70b(cls) -> "LlamaConfig":
        return cls(vocab_size=128256, dim=8192, n_layers=80, n_heads=64,
                   n_kv_heads=8, ffn_dim=28672, max_seq_len=8192)

    def param_count(self) -> int:
        embed = self.vocab_size * self.dim
        per_layer = (self.dim * self.n_heads * self.head_dim          # wq
                     + 2 * self.dim * self.n_kv_heads * self.head_dim  # wk, wv
                     + self.n_heads * self.head_dim * self.dim         # wo
                     + 3 * self.dim * self.ffn_dim                     # gate/up/down
                     + 2 * self.dim)                                   # norms
        return 2 * embed + self.n_layers * per_layer + self.dim


def llama_init(cfg: LlamaConfig, seed: int = 0,
               device=None) -> Dict[str, Any]:
    """Random-init params dict with stacked [L, ...] layer weights: normal
    * 1/sqrt(fan_in) matrices, ones for the norms (the JAX recipe), drawn
    from a torch.Generator on `device` seeded with `seed`. Each leaf is
    drawn one [in, out] slice at a time so an 8B model never holds a full
    f32 copy of its largest leaf."""
    dev = resolve_device(device)
    dtype = DTYPES[cfg.dtype]
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    L, D, H, Hkv, dh, F_, V = (cfg.n_layers, cfg.dim, cfg.n_heads,
                               cfg.n_kv_heads, cfg.head_dim, cfg.ffn_dim,
                               cfg.vocab_size)

    def init(shape, fan_in):
        out = torch.empty(shape, dtype=dtype, device=dev)
        slices = out.view(-1, *shape[-2:])
        for i in range(slices.shape[0]):
            draw = torch.randn(shape[-2:], generator=gen, device=dev,
                               dtype=torch.float32)
            slices[i].copy_(draw.mul_(1.0 / math.sqrt(fan_in)))
        return out

    return {
        "tok_emb": init((V, D), D),
        "layers": {
            "wq": init((L, D, H * dh), D),
            "wk": init((L, D, Hkv * dh), D),
            "wv": init((L, D, Hkv * dh), D),
            "wo": init((L, H * dh, D), H * dh),
            "w_gate": init((L, D, F_), D),
            "w_up": init((L, D, F_), D),
            "w_down": init((L, F_, D), F_),
            "attn_norm": torch.ones((L, D), dtype=dtype, device=dev),
            "ffn_norm": torch.ones((L, D), dtype=dtype, device=dev),
        },
        "final_norm": torch.ones((D,), dtype=dtype, device=dev),
        "lm_head": init((D, V), D),
    }


def rms_norm(x, weight, eps: float):
    x32 = x.float()
    normed = x32 * torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True)
                               + eps)
    return (normed * weight.float()).to(x.dtype)


def rope(x, positions, theta: float):
    """Rotate-half RoPE. x: [B, T, H, dh]; positions: [B, T]."""
    dh = x.shape[-1]
    half = dh // 2
    inv_freq = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                             device=x.device) / half))
    angles = positions.float()[..., None] * inv_freq       # [B, T, half]
    cos = torch.cos(angles)[:, :, None, :]                 # [B, T, 1, half]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    rotated = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return rotated.to(x.dtype)


def _mm(x, tree, name):
    """x @ tree[name] (float weights; the int8 path is ROADMAP A13)."""
    return x @ tree[name]


def _embed(params, cfg: LlamaConfig, tokens):
    """Token embedding gather."""
    return params["tok_emb"][tokens]


def _head(x, params):
    """lm_head projection to float32 logits."""
    return (x @ params["lm_head"]).float()


def _layer(params, l: int) -> Dict[str, Any]:
    return {name: w[l] for name, w in params["layers"].items()}


def _attention_block(x, layer, k_cache_l, v_cache_l, positions,
                     cfg: LlamaConfig):
    """One attention sublayer with cache write + masked read.

    x: [B, T, D]; k/v_cache_l: [B, Hkv, dh, S] (S-minor, the JAX layout);
    positions: [B, T]. Writes this chunk's k/v into the caches IN PLACE at
    its absolute positions (clamped to S - 1, see the module docstring) and
    returns (out [B, T, D], k_cache_l, v_cache_l). When T == S (the serving
    prefill's full window) and cfg.attn_impl == "flash", attention runs
    through ops/flash_attention on the fresh k/v; when T == 1 and
    cfg.decode_attn == "kernel", through ops/decode_attention over the
    cache; otherwise it is plain masked attention over the cache (the JAX
    einsum path: cache-dtype operands, f32 scores)."""
    B, T, _ = x.shape
    S = k_cache_l.shape[-1]
    H, Hkv, dh, G = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.q_per_kv

    normed = rms_norm(x, layer["attn_norm"], cfg.rms_eps)
    q = _mm(normed, layer, "wq").reshape(B, T, H, dh)
    k = _mm(normed, layer, "wk").reshape(B, T, Hkv, dh)
    v = _mm(normed, layer, "wv").reshape(B, T, Hkv, dh)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)

    # advanced indices on dims 0 and 3 -> value shape [B, T, Hkv, dh]
    batch_idx = torch.arange(B, device=x.device)[:, None]
    pos = positions.long()
    write_pos = pos.clamp(max=S - 1)
    k_cache_l[batch_idx, :, :, write_pos] = k
    v_cache_l[batch_idx, :, :, write_pos] = v

    if T == S and cfg.attn_impl == "flash":
        from ..ops.flash_attention import flash_attention

        # q, k, v go in as they are and the output comes back contiguous
        # [B, T, H, dh]: the kernel reads and writes strided, so neither side
        # is copied and the view below is free
        attn = flash_attention(q, k, v, True)
        return (_mm(attn.view(B, T, H * dh), layer, "wo"), k_cache_l,
                v_cache_l)

    if T == 1 and cfg.decode_attn == "kernel":
        from ..ops.decode_attention import decode_attention

        # the write above put this step's k/v at `positions`, so the live
        # window is [0, positions] inclusive
        attn = decode_attention(q[:, 0].contiguous(), k_cache_l, v_cache_l,
                                (pos[:, 0] + 1).to(torch.int32))
        return (_mm(attn.reshape(B, 1, H * dh), layer, "wo"), k_cache_l,
                v_cache_l)

    qg = q.reshape(B, T, Hkv, G, dh)
    scores = torch.einsum("bthgd,bhds->bhgts", qg.float(),
                          k_cache_l.float()) / math.sqrt(dh)
    # query at absolute pos p sees cache slot j iff j <= p
    cache_pos = torch.arange(S, device=x.device)[None, None, :]
    visible = cache_pos <= pos[:, :, None]                    # [B, T, S]
    scores = torch.where(visible[:, None, None, :, :], scores, -1e30)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgts,bhds->bthgd",
                       probs.to(v_cache_l.dtype).float(),
                       v_cache_l.float()).to(x.dtype)
    return (_mm(out.reshape(B, T, H * dh), layer, "wo"), k_cache_l,
            v_cache_l)


def _ffn_block(x, layer, cfg: LlamaConfig):
    normed = rms_norm(x, layer["ffn_norm"], cfg.rms_eps)
    gate = F.silu(_mm(normed, layer, "w_gate"))
    up = _mm(normed, layer, "w_up")
    return _mm(gate * up, layer, "w_down")


def llama_forward_hidden(params, cfg: LlamaConfig, tokens, positions,
                         k_cache, v_cache):
    """Cache-writing forward returning final-norm hidden states, not logits.

    tokens: [B, T]; positions: [B, T] absolute positions (row-wise
    monotonic); k/v_cache: [L, B, Hkv, dh, S] (S-minor), written in place.
    Returns (hidden [B, T, D], k_cache, v_cache)."""
    x = _embed(params, cfg, tokens)
    for l in range(cfg.n_layers):
        layer = _layer(params, l)
        attn_out, _, _ = _attention_block(x, layer, k_cache[l], v_cache[l],
                                          positions, cfg)
        x = x + attn_out
        x = x + _ffn_block(x, layer, cfg)
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    return x, k_cache, v_cache


def llama_prefill_last(params, cfg: LlamaConfig, tokens, positions, lengths,
                       k_cache, v_cache):
    """Prefill forward that projects ONLY each row's last prompt position.

    tokens: [B, T]; positions: [B, T]; lengths: [B] true prompt lengths.
    Returns (last_logits [B, V] float32, k_cache, v_cache)."""
    hidden, k_cache, v_cache = llama_forward_hidden(
        params, cfg, tokens, positions, k_cache, v_cache)
    B = hidden.shape[0]
    last = hidden[torch.arange(B, device=hidden.device), lengths.long() - 1]
    return _head(last, params), k_cache, v_cache


def init_kv_cache_layers(cfg: LlamaConfig, batch: int,
                         seq_len: Optional[int] = None,
                         dtype: Optional[str] = None, device=None):
    """Per-layer zeroed (k, v) caches: lists of L tensors [B, Hkv, dh, S] in
    `dtype` (default cfg.dtype; "int8" for the quantized cache). The dense
    engine's representation: one buffer per layer, so growth can replace
    them one at a time."""
    dev = resolve_device(device)
    S = seq_len or cfg.max_seq_len
    shape = (batch, cfg.n_kv_heads, cfg.head_dim, S)
    dt = torch.int8 if dtype == "int8" else DTYPES[dtype or cfg.dtype]
    k = [torch.zeros(shape, dtype=dt, device=dev) for _ in range(cfg.n_layers)]
    v = [torch.zeros(shape, dtype=dt, device=dev) for _ in range(cfg.n_layers)]
    return k, v


def init_kv_scale_layers(cfg: LlamaConfig, batch: int,
                         seq_len: Optional[int] = None, device=None):
    """Per-layer (k_scale, v_scale) buffers of the int8 cache: lists of L
    float32 tensors [B, Hkv, S] (dequant value = int8 * scale)."""
    dev = resolve_device(device)
    S = seq_len or cfg.max_seq_len
    shape = (batch, cfg.n_kv_heads, S)
    k = [torch.zeros(shape, dtype=torch.float32, device=dev)
         for _ in range(cfg.n_layers)]
    v = [torch.zeros(shape, dtype=torch.float32, device=dev)
         for _ in range(cfg.n_layers)]
    return k, v


def llama_decode_step_unrolled(params, cfg: LlamaConfig, tokens, positions,
                               k_layers, v_layers):
    """One decode step over per-layer cache buffers.

    tokens: [B]; positions: [B]; k/v_layers: lists of L [B, Hkv, dh, S]
    tensors (init_kv_cache_layers), written in place. The T=1 read is
    cfg.decode_attn's ("kernel": ops/decode_attention). Returns (logits
    [B, V] float32, k_layers, v_layers)."""
    x = _embed(params, cfg, tokens)[:, None]               # [B, 1, D]
    pos_grid = positions[:, None]
    for l in range(cfg.n_layers):
        layer = _layer(params, l)
        attn, _, _ = _attention_block(x, layer, k_layers[l], v_layers[l],
                                      pos_grid, cfg)
        x = x + attn
        x = x + _ffn_block(x, layer, cfg)
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    return _head(x[:, 0], params), k_layers, v_layers


def _qkv_decode(x, layer, pos_grid, cfg: LlamaConfig):
    """The T=1 projections: (q [B, H, dh], k [B, Hkv, dh], v [B, Hkv, dh])
    with rope on q and k."""
    B = x.shape[0]
    H, Hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    normed = rms_norm(x, layer["attn_norm"], cfg.rms_eps)
    q = rope(_mm(normed, layer, "wq").reshape(B, 1, H, dh), pos_grid,
             cfg.rope_theta)
    k = rope(_mm(normed, layer, "wk").reshape(B, 1, Hkv, dh), pos_grid,
             cfg.rope_theta)
    v = _mm(normed, layer, "wv").reshape(B, 1, Hkv, dh)
    return q[:, 0].contiguous(), k[:, 0], v[:, 0]


def llama_decode_step_unrolled_q8(params, cfg: LlamaConfig, tokens, positions,
                                  k_layers, v_layers, ks_layers, vs_layers):
    """One decode step over int8 per-layer caches with per-token scales.

    tokens/positions: [B]; k/v_layers: lists of [B, Hkv, dh, S] int8;
    ks/vs_layers: lists of [B, Hkv, S] float32; all written in place. The
    new token's K/V quantize on write (ops/decode_attention.quantize_kv,
    per token and head); the read is ops/decode_attention with the
    dequantization folded into it (cfg.decode_attn must be "kernel", as in
    JAX). Returns (logits [B, V] f32, k_layers, v_layers, ks_layers,
    vs_layers)."""
    from ..ops.decode_attention import decode_attention, quantize_kv

    B = tokens.shape[0]
    H, dh = cfg.n_heads, cfg.head_dim
    x = _embed(params, cfg, tokens)[:, None]               # [B, 1, D]
    pos_grid = positions[:, None]
    rows = torch.arange(B, device=tokens.device)
    S = k_layers[0].shape[-1]
    write_pos = positions.long().clamp(max=S - 1)
    lengths = (positions + 1).to(torch.int32)
    for l in range(cfg.n_layers):
        layer = _layer(params, l)
        q, k, v = _qkv_decode(x, layer, pos_grid, cfg)
        k8, ks = quantize_kv(k, axis=-1)                   # [B,Hkv,dh], [B,Hkv]
        v8, vs = quantize_kv(v, axis=-1)
        k_layers[l][rows, :, :, write_pos] = k8
        v_layers[l][rows, :, :, write_pos] = v8
        ks_layers[l][rows, :, write_pos] = ks
        vs_layers[l][rows, :, write_pos] = vs
        attn = decode_attention(q, k_layers[l], v_layers[l], lengths,
                                ks_layers[l], vs_layers[l])
        x = x + _mm(attn.reshape(B, 1, H * dh), layer, "wo")
        x = x + _ffn_block(x, layer, cfg)
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    return _head(x[:, 0], params), k_layers, v_layers, ks_layers, vs_layers


def llama_decode_step_paged(params, cfg: LlamaConfig, tokens, positions,
                            k_pool, v_pool, table):
    """One decode step against a PAGED KV cache.

    tokens: [B]; positions: [B] absolute write positions; k/v_pool:
    [L, P, Hkv, dh, page_size], updated in place; table: [B, NP] int32 page
    ids per slot (entries past a slot's reservation must hold a valid id,
    e.g. 0). Per layer: write this token's K/V into its page, then read
    attention through the block table with ops/paged_attention. Returns
    (logits [B, V] float32, k_pool, v_pool)."""
    from ..ops.paged_attention import paged_attention, paged_write_decode

    B = tokens.shape[0]
    H, dh = cfg.n_heads, cfg.head_dim
    x = _embed(params, cfg, tokens)[:, None]               # [B, 1, D]
    pos_grid = positions[:, None]                          # [B, 1]
    lengths = (positions + 1).to(torch.int32)
    for l in range(cfg.n_layers):
        layer = _layer(params, l)
        q, k, v = _qkv_decode(x, layer, pos_grid, cfg)
        paged_write_decode(k_pool[l], v_pool[l], k, v, table, positions)
        attn = paged_attention(q, k_pool[l], v_pool[l], table, lengths)
        x = x + _mm(attn.reshape(B, 1, H * dh), layer, "wo")
        x = x + _ffn_block(x, layer, cfg)
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    return _head(x[:, 0], params), k_pool, v_pool


def llama_decode_step_paged_q8(params, cfg: LlamaConfig, tokens, positions,
                               k_pool, v_pool, ks_pool, vs_pool, table):
    """One decode step against an int8 paged KV pool.

    As llama_decode_step_paged, with k/v_pool [L, P, Hkv, dh, ps] int8 and
    ks/vs_pool [L, P, Hkv, ps] float32, all updated in place. The new
    token's K/V quantize on write; its scales go to the same (page, offset)
    as its values (the value writer's index rule); the paged read folds
    the dequantization in. Returns (logits [B, V] f32, k_pool, v_pool,
    ks_pool, vs_pool)."""
    from ..ops.decode_attention import quantize_kv
    from ..ops.paged_attention import (paged_attention, paged_write_decode,
                                       paged_write_decode_scales)

    B = tokens.shape[0]
    H, dh = cfg.n_heads, cfg.head_dim
    x = _embed(params, cfg, tokens)[:, None]               # [B, 1, D]
    pos_grid = positions[:, None]
    lengths = (positions + 1).to(torch.int32)
    for l in range(cfg.n_layers):
        layer = _layer(params, l)
        q, k, v = _qkv_decode(x, layer, pos_grid, cfg)
        k8, ks = quantize_kv(k, axis=-1)                   # [B,Hkv,dh], [B,Hkv]
        v8, vs = quantize_kv(v, axis=-1)
        paged_write_decode(k_pool[l], v_pool[l], k8, v8, table, positions)
        paged_write_decode_scales(ks_pool[l], vs_pool[l], ks, vs, table,
                                  positions)
        attn = paged_attention(q, k_pool[l], v_pool[l], table, lengths,
                               ks_pool[l], vs_pool[l])
        x = x + _mm(attn.reshape(B, 1, H * dh), layer, "wo")
        x = x + _ffn_block(x, layer, cfg)
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    return (_head(x[:, 0], params), k_pool, v_pool, ks_pool, vs_pool)

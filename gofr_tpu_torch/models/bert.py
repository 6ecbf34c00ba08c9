"""BERT-family encoder: a bidirectional transformer for embeddings.

Ports ``gofr_tpu/models/bert.py``: ``BertConfig`` (the same fields and the
``debug``, ``base`` and ``large`` presets, ``param_count``), ``bert_init``
(the same shapes and recipe, normal * 1/sqrt(fan_in) matrices, zero biases,
unit LayerNorm scales, drawn from a ``torch.Generator``), ``layer_norm``
(in f32, cast back), the post-LN ``_encoder_layer``, ``bert_encode``,
``bert_embed`` (masked mean pooling, L2-normalised) and ``bert_pool_cls``.
Stacked [L, ...] layer weights and ``x @ W``, as the reference's, so
``models.weights.params_from_numpy`` carries a JAX tree across as it is.

Two details keep the reference's numbers: a pad key's attention bias is
-1e30, not -inf, so a row of pads alone stays finite; and GELU is the tanh
approximation (``jax.nn.gelu(approximate=True)``). Attention is plain f32
einsums, as the reference's is (no Pallas call there), so padding to a
longer bucket leaves a row's embedding as it was: pad keys get weight
exp(-1e30 - max) = 0 and pooling skips pad positions.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import torch
import torch.nn.functional as F

from ..tpu.device import resolve_device
from .llama import DTYPES, scaled_normal


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    dim: int = 768
    n_layers: int = 12
    n_heads: int = 12
    ffn_dim: int = 3072
    max_seq_len: int = 512
    n_segments: int = 2
    layer_norm_eps: float = 1e-12
    pad_id: int = 0
    dtype: str = "bfloat16"

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @classmethod
    def debug(cls) -> "BertConfig":
        """CI-sized model: runs in seconds on the CPU."""
        return cls(vocab_size=512, dim=64, n_layers=2, n_heads=4, ffn_dim=128,
                   max_seq_len=128, dtype="float32")

    @classmethod
    def base(cls) -> "BertConfig":
        return cls()

    @classmethod
    def large(cls) -> "BertConfig":
        return cls(dim=1024, n_layers=24, n_heads=16, ffn_dim=4096)

    def param_count(self) -> int:
        embed = (self.vocab_size + self.max_seq_len + self.n_segments) * self.dim
        per_layer = (4 * self.dim * self.dim          # wq wk wv wo
                     + 2 * self.dim * self.ffn_dim    # ffn in/out
                     + 4 * self.dim                   # 2 LayerNorms (scale+bias)
                     + 4 * self.dim + self.ffn_dim + self.dim)  # biases
        pooler = self.dim * self.dim + self.dim
        return embed + 2 * self.dim + self.n_layers * per_layer + pooler


def bert_init(cfg: BertConfig, seed: int = 0, device=None) -> Dict[str, Any]:
    """Random-init params with stacked [L, ...] layer weights on `device`
    (None = the CUDA card)."""
    dev = resolve_device(device)
    dtype = DTYPES[cfg.dtype]
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    init = scaled_normal(gen, dtype, dev)
    L, D, F_ = cfg.n_layers, cfg.dim, cfg.ffn_dim

    def zeros(shape):
        return torch.zeros(shape, dtype=dtype, device=dev)

    def ones(shape):
        return torch.ones(shape, dtype=dtype, device=dev)

    return {
        "tok_emb": init((cfg.vocab_size, D), D),
        "pos_emb": init((cfg.max_seq_len, D), D),
        "seg_emb": init((cfg.n_segments, D), D),
        "emb_norm_scale": ones((D,)),
        "emb_norm_bias": zeros((D,)),
        "layers": {
            "wq": init((L, D, D), D), "bq": zeros((L, D)),
            "wk": init((L, D, D), D), "bk": zeros((L, D)),
            "wv": init((L, D, D), D), "bv": zeros((L, D)),
            "wo": init((L, D, D), D), "bo": zeros((L, D)),
            "attn_norm_scale": ones((L, D)), "attn_norm_bias": zeros((L, D)),
            "w_in": init((L, D, F_), D), "b_in": zeros((L, F_)),
            "w_out": init((L, F_, D), F_), "b_out": zeros((L, D)),
            "ffn_norm_scale": ones((L, D)), "ffn_norm_bias": zeros((L, D)),
        },
        "pooler_w": init((D, D), D),
        "pooler_b": zeros((D,)),
    }


def layer_norm(x, scale, bias, eps: float):
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = ((x32 - mean) ** 2).mean(dim=-1, keepdim=True)
    normed = (x32 - mean) * torch.rsqrt(var + eps)
    return (normed * scale.float() + bias.float()).to(x.dtype)


def _encoder_layer(x, layer, attn_bias, cfg: BertConfig):
    """Post-LN encoder layer. x: [B, T, D]; attn_bias: [B, 1, 1, T] f32."""
    B, T, D = x.shape
    H, dh = cfg.n_heads, cfg.head_dim

    q = (x @ layer["wq"] + layer["bq"]).reshape(B, T, H, dh)
    k = (x @ layer["wk"] + layer["bk"]).reshape(B, T, H, dh)
    v = (x @ layer["wv"] + layer["bv"]).reshape(B, T, H, dh)
    scores = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) / math.sqrt(dh)
    probs = torch.softmax(scores + attn_bias, dim=-1)
    attn = torch.einsum("bhts,bshd->bthd", probs, v.float()).to(x.dtype)
    attn = attn.reshape(B, T, D) @ layer["wo"] + layer["bo"]
    x = layer_norm(x + attn, layer["attn_norm_scale"], layer["attn_norm_bias"],
                   cfg.layer_norm_eps)

    h = F.gelu(x @ layer["w_in"] + layer["b_in"], approximate="tanh")
    h = h @ layer["w_out"] + layer["b_out"]
    return layer_norm(x + h, layer["ffn_norm_scale"], layer["ffn_norm_bias"],
                      cfg.layer_norm_eps)


def bert_encode(params, cfg: BertConfig, tokens, segments=None):
    """Full encoder stack. tokens: [B, T] int (pad_id marks padding).
    Returns hidden states [B, T, D] in cfg.dtype; padded positions carry
    garbage activations but are masked out of attention reads and pooling."""
    B, T = tokens.shape
    mask = tokens != cfg.pad_id                                  # [B, T]
    attn_bias = torch.where(mask, 0.0, -1e30).float()[:, None, None, :]
    positions = torch.arange(T, device=tokens.device)
    seg = segments if segments is not None else torch.zeros_like(tokens)
    x = (params["tok_emb"][tokens]
         + params["pos_emb"][positions][None, :, :]
         + params["seg_emb"][seg])
    x = layer_norm(x, params["emb_norm_scale"], params["emb_norm_bias"],
                   cfg.layer_norm_eps)
    for l in range(cfg.n_layers):
        layer = {name: w[l] for name, w in params["layers"].items()}
        x = _encoder_layer(x, layer, attn_bias, cfg)
    return x


def bert_embed(params, cfg: BertConfig, tokens):
    """Masked mean-pooled sentence embedding, L2-normalised: [B, T] int ->
    [B, D] f32 (the /embed endpoint's model function)."""
    hidden = bert_encode(params, cfg, tokens).float()            # [B, T, D]
    mask = (tokens != cfg.pad_id).float()[:, :, None]            # [B, T, 1]
    summed = (hidden * mask).sum(dim=1)
    counts = torch.clamp(mask.sum(dim=1), min=1.0)
    pooled = summed / counts
    return pooled / torch.clamp(
        torch.linalg.vector_norm(pooled, dim=-1, keepdim=True), min=1e-12)


def bert_pool_cls(params, cfg: BertConfig, tokens):
    """Classic BERT pooler: tanh(W @ h[CLS]). [B, T] -> [B, D] f32."""
    hidden = bert_encode(params, cfg, tokens)
    cls = hidden[:, 0, :]
    return torch.tanh((cls @ params["pooler_w"] + params["pooler_b"]).float())

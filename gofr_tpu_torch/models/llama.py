"""Llama-family decoder in PyTorch: GQA + RoPE + RMSNorm + SwiGLU.

Ports from ``gofr_tpu/models/llama.py``: ``LlamaConfig`` (same fields and
presets), ``llama_init`` (same recipe, drawn from a ``torch.Generator`` —
it never tries to replay ``jax.random``), ``rms_norm``, ``rope``, ``_mm``,
``_embed``, ``_head``, ``_attention_block`` (the T == S window, the T=1
``decode_attn="kernel"`` read through ops/decode_attention, and the plain
masked read), ``_ffn_block``, ``llama_forward_hidden``, ``llama_forward``,
``llama_prefill``, ``llama_decode_step``, ``llama_prefill_last``, the
stacked ``init_kv_cache`` (the post-hoc scoring passes' cache) and
``llama_decode_step_inplace`` over it, the dense engine's
``init_kv_cache_layers``, ``init_kv_scale_layers``,
``llama_decode_step_unrolled`` and ``llama_decode_step_unrolled_q8``, the
paged ``llama_decode_step_paged`` and ``llama_decode_step_paged_q8``, the
prefix-cache tail prefill ``llama_prefill_paged_prefix`` and
``llama_prefill_paged_prefix_q8``, and the cache-free
``_attention_block_nocache``, ``forward_nocache_at`` and
``llama_forward_nocache`` (flash or the f32 oracle, or the ``attn_fn``
hook through which parallel/longcontext.py swaps in ring or Ulysses
attention, as the reference's does). The
cache-free forward is the training forward (``gofr_tpu_torch/train``): it
runs under autograd on both devices, writes into no tensor in place, and
its flash attention carries the reference's gradient
(``ops/flash_attention.FlashAttention``).

The params tree keeps the JAX layout — a dict with stacked [L, in, out]
layer weights and ``x @ W`` — so the weight bridge (models/weights.py) is
one copy per leaf. JAX's casts are kept: norms and rope in f32 cast back to
``x.dtype``, logits in f32. Caches and pools are updated in place where JAX
returns updated arrays (its engine donates them).

The int8 weights (ROADMAP A13): ``_q_matmul`` and the int8 branches of
``_mm``, ``_embed`` and ``_head`` (the weights' dtype is the switch, as in
the reference, so it reaches every program: paged and dense, int8 KV, the
tail prefill, ``-sc`` and scoring), ``_quantize_leaf``, ``_QUANT_AXES``,
``quantize_weights`` (consumes its input tree), ``llama_init_quantized``
and ``params_nbytes``. ``_q_matmul`` is XLA's int8 x int8 -> int32
``dot_general`` in the reference, not a Pallas kernel; here it is
``torch._int_mm`` (a library product on the card and the CPU), with the
reference's per-row activation quantization and f32 epilogue around it. On
the card ``_int_mm`` needs more than 16 rows, so fewer (decode's B rows)
are zero-padded to ``_INT_MM_ROWS`` (the int32 result is exact, the pad
rows dropped), and it is 4-10x slower with a row-major second operand than
with a column-major one (H100, torch 2.11). So the port's int8 producers
(``quantize_weights``, ``llama_init_quantized``, the checkpoint loader)
store every matrix the product reads (the layer weights and ``lm_head``)
column-major: the leaf keeps the JAX shape [.., in, out], as a transposed
view of [.., out, in] storage, instead of the row-major layout, never beside
it. ``tok_emb`` (gathered by rows) stays row-major.

Tensor parallelism (ROADMAP A14a): where XLA inserts the collectives of
the reference from its sharding annotations, the port issues them itself
(parallel/collectives.py), from the config. A ``ShardConfig`` is one
rank's view of a LlamaConfig: ``n_heads`` and ``n_kv_heads`` are the heads
this rank holds (head_dim stays the model's), ``tp`` the tensor-parallel
axis and ``sp`` the sequence axis of the mesh forward
(parallel/sharding.shard_config). Under a tp axis every function here runs
the rank's block of the program over the rank's block of the params
(parallel/sharding.shard_params) and adds the Megatron collectives:

- an all-reduce over tp after each row-parallel product (``wo`` and
  ``w_down``, ``_mm_rows``); in int8 (``_q_matmul``) an all-reduce MAX of
  the row absmax before the activations quantize, since the reference's
  absmax is over the whole contraction row (a local one gives other int8
  activations), then an all-reduce of the exact int32 products before the
  f32 epilogue, which is what XLA partitions the reference's int32
  ``dot_general`` into;
- an all-gather over the vocab after the column-parallel ``lm_head``
  (``_head``), so every rank samples from the same whole row;
- under llama_param_specs' vocab-sharded ``tok_emb``, a masked local
  gather then an all-reduce (``_embed``); the serving specs replicate it.

With no tp axis (a LlamaConfig) nothing changes.

The same places issue the conjugate pairs of parallel/collectives.py, so
a loss through a sharded forward (the sharded training step, ROADMAP A14b)
gets the reference's gradients: a
``copy_to`` over tp ahead of the column-parallel products (``wq``/``wk``/
``wv`` on the attention norm's output, ``w_gate``/``w_up`` on the FFN
norm's, ``lm_head`` on the final norm's: ``_tp_in``), ``reduce_from``
after ``wo`` / ``w_down`` and after the vocab-sharded embedding gather
(only this rank's rows get a gradient), and ``gather_from`` for the
``lm_head`` all-gather (backward: this rank's vocab slice). Under
``no_grad`` (serving, and every graph it captures) each falls back to the
forward-only collective above; the int8 path has no backward and calls
the forward-only ones itself.

Speculative verify and chunked prefill (ROADMAP A10): ``llama_verify_step``
and ``llama_verify_step_paged`` (the window [tokens | drafts] in one
forward, the plain masked read over the cache or the gathered pages, the
window's lm_head in one product, ``_verify_head``), ``llama_prefill_chunk``
and ``llama_prefill_chunk_q8`` (one chunk of a long prompt at its absolute
positions against the rows it has written so far). None reaches a Pallas
call in the reference: a T = d+1 or T = chunk < S window takes
``_attention_block``'s plain branch there as here.

A cache write past a dense cache's last column (a finished row that keeps
advancing in lock-step decode) lands on that last column instead of being
dropped as JAX's scatter drops it: torch indexing would raise. The row's
emitted tokens never read that column (the engine caps a row's context at
max_seq_len - 1), so the result is the same.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from ..parallel.collectives import (all_reduce, copy_to, gather_from,
                                    reduce_from)
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


@dataclasses.dataclass(frozen=True)
class ShardConfig(LlamaConfig):
    """One rank's view of a LlamaConfig under a mesh (the module
    docstring): n_heads / n_kv_heads are this rank's heads, `tp` the
    tensor-parallel axis (parallel/collectives.Axis) and `sp` the sequence
    axis of the mesh forward, either None. parallel/sharding.shard_config
    makes one."""
    tp: Any = None
    sp: Any = None

    @property
    def tp_size(self) -> int:
        return 1 if self.tp is None else self.tp.size

    @property
    def head_dim(self) -> int:
        return self.dim // (self.n_heads * self.tp_size)

    def param_count(self) -> int:
        """This rank's parameters under the serving specs: its heads and
        FFN columns, the replicated tok_emb and norms, its lm_head block."""
        n = self.tp_size
        per_layer = (self.dim * self.n_heads * self.head_dim
                     + 2 * self.dim * self.n_kv_heads * self.head_dim
                     + self.n_heads * self.head_dim * self.dim
                     + 3 * self.dim * self.ffn_dim // n
                     + 2 * self.dim)
        return (self.vocab_size * self.dim * (n + 1) // n
                + self.n_layers * per_layer + self.dim)


def scaled_normal(gen: torch.Generator, dtype, dev):
    """init(shape, fan_in): a `dtype` tensor on `dev` of normal draws from
    `gen` times 1/sqrt(fan_in) (the JAX recipe), drawn one [in, out] slice
    at a time, so no full f32 copy of a large stacked leaf is ever held.
    The other models' inits (moe, bert, mlp) share it."""

    def init(shape, fan_in):
        out = torch.empty(shape, dtype=dtype, device=dev)
        slices = out.view(-1, *shape[-2:])
        for i in range(slices.shape[0]):
            draw = torch.randn(shape[-2:], generator=gen, device=dev,
                               dtype=torch.float32)
            slices[i].copy_(draw.mul_(1.0 / math.sqrt(fan_in)))
        return out
    return init


def _drawn_leaves(cfg: LlamaConfig, seed: int, dev: torch.device):
    """The random matrices of llama_init, in its draw order: (name, leaf)
    with name a top-level key or a layer leaf's (scaled_normal: an 8B
    model never holds a full f32 copy of its largest leaf); no leaf is kept
    here once yielded."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    init = scaled_normal(gen, DTYPES[cfg.dtype], dev)
    L, D, H, Hkv, dh, F_, V = (cfg.n_layers, cfg.dim, cfg.n_heads,
                               cfg.n_kv_heads, cfg.head_dim, cfg.ffn_dim,
                               cfg.vocab_size)

    yield "tok_emb", init((V, D), D)
    yield "wq", init((L, D, H * dh), D)
    yield "wk", init((L, D, Hkv * dh), D)
    yield "wv", init((L, D, Hkv * dh), D)
    yield "wo", init((L, H * dh, D), H * dh)
    yield "w_gate", init((L, D, F_), D)
    yield "w_up", init((L, D, F_), D)
    yield "w_down", init((L, F_, D), F_)
    yield "lm_head", init((D, V), D)


def _tree(cfg: LlamaConfig, leaves: Dict[str, Any], dev) -> Dict[str, Any]:
    """The params dict from its matrices (and scales): layer leaves under
    "layers", the norms as ones, as llama_init makes them."""
    dtype = DTYPES[cfg.dtype]
    L, D = cfg.n_layers, cfg.dim
    top = ("tok_emb", "tok_emb_s", "lm_head", "lm_head_s")
    layers = {k: v for k, v in leaves.items() if k not in top}
    layers["attn_norm"] = torch.ones((L, D), dtype=dtype, device=dev)
    layers["ffn_norm"] = torch.ones((L, D), dtype=dtype, device=dev)
    tree = {k: leaves[k] for k in top[:2] if k in leaves}
    tree["layers"] = layers
    tree["final_norm"] = torch.ones((D,), dtype=dtype, device=dev)
    tree.update({k: leaves[k] for k in top[2:] if k in leaves})
    return tree


def llama_init(cfg: LlamaConfig, seed: int = 0,
               device=None) -> Dict[str, Any]:
    """Random-init params dict with stacked [L, ...] layer weights: normal
    * 1/sqrt(fan_in) matrices, ones for the norms (the JAX recipe), drawn
    from a torch.Generator on `device` seeded with `seed`."""
    dev = resolve_device(device)
    return _tree(cfg, dict(_drawn_leaves(cfg, seed, dev)), dev)


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


# the reference divides by 127.0; XLA compiles that, in every jitted
# program, into a product with the f32 reciprocal, which this repeats
_INV127 = 1.0 / 127.0
_F127 = torch.tensor(127.0)
# torch._int_mm on the card takes more than 16 rows; fewer are padded to
# this many (the module docstring)
_INT_MM_MIN_ROWS = 17
_INT_MM_ROWS = 32


def _q_matmul(x, w8, s, out_dtype=None, axis=None):
    """Weight-only int8 matmul with dynamic per-row activation quantization.

    x: [..., Din] float; w8: [Din, Dout] int8 (column-major from the port's
    producers); s: [Dout] f32 per-output-channel weight scales. Returns
    [..., Dout] in out_dtype (default x.dtype): the reference's
    round(x * 127 / absmax) int8 rows, the exact int32 product, then
    acc * (absmax / 127) * s in f32 before the cast, in its order (the
    division as XLA compiles it, see _INV127). axis: the tp axis when Din
    is this rank's block of a sharded contraction: the absmax is the MAX
    over the axis and the int32 products are summed over it (the module
    docstring)."""
    x8, ax = _quantize_rows(x, axis)
    acc = _int_matmul(x8, w8)
    if axis is not None:
        all_reduce(acc, axis)
    # int32 * f32 promotes as acc.float() does, in one kernel
    out = (acc * (ax * _INV127)).mul_(s)
    return out.to(out_dtype or x.dtype)


def _quantize_rows(x, axis=None):
    """(x8, absmax): x's rows as int8, round(x * 127 / absmax), and their
    [..., 1] f32 absmax, as the reference quantizes activations (in as few
    kernels as give its bits: the inf-norm is the abs-max). axis: the row
    is sharded over it, and the absmax is its MAX over the axis."""
    xf = x.float()
    ax = torch.linalg.vector_norm(xf, ord=math.inf, dim=-1, keepdim=True)
    if axis is not None:
        all_reduce(ax, axis, op="max")
    ax = ax.clamp_min_(1e-12)
    # a true division: torch computes `127.0 / ax` as 127 * (1 / ax), which
    # rounds twice; a CPU scalar tensor is a kernel argument, also in a
    # captured graph
    inv = torch.div(_F127, ax)
    return xf.mul(inv).round_().to(torch.int8), ax


def _int_matmul(x8, w8):
    """The exact int32 product x8 @ w8 of [..., Din] by [Din, Dout] int8,
    through torch._int_mm (rows padded to its minimum on the card)."""
    rows = x8.reshape(-1, x8.shape[-1])
    n = rows.shape[0]
    if n < _INT_MM_MIN_ROWS:
        rows = F.pad(rows, (0, 0, 0, _INT_MM_ROWS - n))
    return torch._int_mm(rows, w8)[:n].reshape(*x8.shape[:-1], w8.shape[-1])


def _mm(x, tree, name):
    """x @ tree[name], through the int8 path when the weight is quantized."""
    w = tree[name]
    if w.dtype == torch.int8:
        return _q_matmul(x, w, tree[name + "_s"])
    return x @ w


def _tp(cfg):
    """The config's tensor-parallel axis, or None (a LlamaConfig)."""
    return getattr(cfg, "tp", None)


def _tp_in(x, cfg):
    """x as the input of column-parallel products: under a tp axis,
    copy_to over tp (the gradient of x is partial on each rank)."""
    tp = _tp(cfg)
    return x if tp is None else copy_to(x, tp)


def _mm_rows(x, tree, name, cfg):
    """x @ tree[name] for a row-parallel weight (wo, w_down): under a tp
    axis the contraction is this rank's block, and the partial products are
    summed over tp (int8: inside _q_matmul)."""
    w, tp = tree[name], _tp(cfg)
    if w.dtype == torch.int8:
        return _q_matmul(x, w, tree[name + "_s"], axis=tp)
    out = x @ w
    return out if tp is None else reduce_from(out, tp)


def _embed(params, cfg: LlamaConfig, tokens):
    """Token embedding gather; dequantizes per row when tok_emb is int8. A
    vocab-sharded tok_emb (llama_param_specs under a tp axis: this rank
    holds ids [rank * n, (rank + 1) * n)) gathers its own ids, zeros the
    rest, and sums over tp."""
    table, tp = params["tok_emb"], _tp(cfg)
    sharded = tp is not None and table.shape[0] != cfg.vocab_size
    if sharded:
        n = table.shape[0]
        local = tokens - tp.rank * n
        inside = (local >= 0) & (local < n)
        tokens = local.clamp(0, n - 1)
    e = table[tokens]
    if e.dtype == torch.int8:
        scale = params["tok_emb_s"][tokens]
        e = (e.float() * scale[..., None]).to(DTYPES[cfg.dtype])
    if sharded:
        e = reduce_from(torch.where(inside[..., None], e, 0).to(e.dtype),
                        tp)
    return e


def _head(x, params, cfg=None):
    """lm_head projection to float32 logits (int8-aware); under a tp axis
    this rank's vocab block, all-gathered into the whole row."""
    w = params["lm_head"]
    if w.dtype == torch.int8:
        out = _q_matmul(x, w, params["lm_head_s"], out_dtype=torch.float32)
    else:
        out = (_tp_in(x, cfg) @ w).float()
    tp = _tp(cfg)
    return out if tp is None else gather_from(out, tp)


def _quantize_leaf(w, axis: int):
    """Symmetric per-channel int8: (w8, scale) with scale shaped as w minus
    `axis` (the contraction dim)."""
    wf = w.float()
    s = wf.abs().amax(dim=axis).clamp_min(1e-12) * _INV127
    w8 = torch.clamp(torch.round(wf / s.unsqueeze(axis)), -127, 127
                     ).to(torch.int8)
    return w8, s


# weight name -> contraction axis reduced away by its scale. Layer weights
# are stacked [L, in, out]; tok_emb [V, D] scales per row (gather dim);
# lm_head [D, V] per output channel. Norm vectors stay float.
_QUANT_AXES = {"wq": -2, "wk": -2, "wv": -2, "wo": -2,
               "w_gate": -2, "w_up": -2, "w_down": -2}
# columns (or rows) quantized at a time: bounds the f32 temporaries
_QUANT_CHUNK = 1 << 14


def _quantized(w, axis: int):
    """_quantize_leaf(w, axis) of a whole leaf, one [in, out] matrix and a
    chunk of the dim the scale keeps at a time (exact: every scale still
    reduces over the whole contraction dim), so the f32 temporaries stay a
    chunk's. axis -2 (a matrix the product reads) gives w8 column-major,
    -1 (tok_emb's rows) row-major."""
    *lead, a, b = w.shape
    dev = w.device
    if axis == -2:
        w8 = torch.empty((*lead, b, a), dtype=torch.int8,
                         device=dev).transpose(-1, -2)
        s = torch.empty((*lead, b), dtype=torch.float32, device=dev)
    else:
        w8 = torch.empty(w.shape, dtype=torch.int8, device=dev)
        s = torch.empty((*lead, a), dtype=torch.float32, device=dev)
    # the dim the scales keep, within one matrix: its columns (axis -2)
    # or its rows (-1)
    keep = 1 if axis == -2 else 0
    for idx in itertools.product(*map(range, lead)):
        for i in range(0, w.shape[keep - 2], _QUANT_CHUNK):
            n = min(_QUANT_CHUNK, w.shape[keep - 2] - i)
            q, sc = _quantize_leaf(w[idx].narrow(keep, i, n), axis)
            w8[idx].narrow(keep, i, n).copy_(q)
            s[idx][i:i + n].copy_(sc)
    return w8, s


def quantize_weights(params: Dict[str, Any]) -> Dict[str, Any]:
    """Quantize a float params tree to int8 storage, leaf by leaf.

    CONSUMES the input tree: each float leaf is popped out of the nested
    dicts as its int8 twin is built, so (given the caller holds no other
    references to the leaves) the peak is the float tree plus one int8
    leaf, not two trees."""
    layers = params["layers"]
    leaves: Dict[str, Any] = {}
    for name, axis in _QUANT_AXES.items():
        leaves[name], leaves[name + "_s"] = _quantized(layers.pop(name),
                                                       axis)
    out = {"layers": {**leaves, "attn_norm": layers["attn_norm"],
                      "ffn_norm": layers["ffn_norm"]}}
    tok8, tok_s = _quantized(params.pop("tok_emb"), -1)
    head8, head_s = _quantized(params.pop("lm_head"), -2)
    return {"tok_emb": tok8, "tok_emb_s": tok_s, **out,
            "final_norm": params["final_norm"],
            "lm_head": head8, "lm_head_s": head_s}


def llama_init_quantized(cfg: LlamaConfig, seed: int = 0,
                         device=None) -> Dict[str, Any]:
    """Random-init DIRECTLY to int8 storage, one leaf at a time: each float
    leaf is drawn on `device` by llama_init's recipe (the same generator
    draws, in its order) and quantized before the next is drawn, so the
    peak is the int8 tree plus one float leaf. Bit for bit
    quantize_weights(llama_init(cfg, seed, device))."""
    dev = resolve_device(device)
    axes = {**_QUANT_AXES, "tok_emb": -1, "lm_head": -2}
    leaves: Dict[str, Any] = {}
    for name, w in _drawn_leaves(cfg, seed, dev):
        leaves[name], leaves[name + "_s"] = _quantized(w, axes[name])
        del w
    return _tree(cfg, leaves, dev)


def params_nbytes(params) -> int:
    """Bytes of a params tree's leaves (int8-aware, unlike the analytic
    cfg-based estimate in tpu/capacity.params_bytes)."""
    if isinstance(params, dict):
        return sum(params_nbytes(v) for v in params.values())
    return params.numel() * params.element_size()


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
    H, Hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

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
        return (_mm_rows(attn.view(B, T, H * dh), layer, "wo", cfg), k_cache_l,
                v_cache_l)

    if T == 1 and cfg.decode_attn == "kernel":
        from ..ops.decode_attention import decode_attention

        # the write above put this step's k/v at `positions`, so the live
        # window is [0, positions] inclusive
        attn = decode_attention(q[:, 0].contiguous(), k_cache_l, v_cache_l,
                                (pos[:, 0] + 1).to(torch.int32))
        return (_mm_rows(attn.reshape(B, 1, H * dh), layer, "wo", cfg),
                k_cache_l, v_cache_l)

    return (_mm_rows(_masked_read(q, k_cache_l, v_cache_l, pos, cfg),
                     layer, "wo", cfg), k_cache_l, v_cache_l)


def _ffn_block(x, layer, cfg: LlamaConfig):
    normed = _tp_in(rms_norm(x, layer["ffn_norm"], cfg.rms_eps), cfg)
    gate = F.silu(_mm(normed, layer, "w_gate"))
    up = _mm(normed, layer, "w_up")
    return _mm_rows(gate * up, layer, "w_down", cfg)


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
    return _head(last, params, cfg), k_cache, v_cache


def llama_forward(params, cfg: LlamaConfig, tokens, positions, k_cache,
                  v_cache):
    """Cache-writing forward over a token chunk. tokens/positions: [B, T];
    k/v_cache: [L, B, Hkv, dh, S], written in place. Returns (logits
    [B, T, V] float32, k_cache, v_cache)."""
    hidden, k_cache, v_cache = llama_forward_hidden(
        params, cfg, tokens, positions, k_cache, v_cache)
    return _head(hidden, params, cfg), k_cache, v_cache


def llama_prefill(params, cfg: LlamaConfig, tokens, k_cache, v_cache):
    """Prefill from an empty cache: positions [0, T) on every row."""
    B, T = tokens.shape
    positions = torch.arange(T, device=tokens.device).expand(B, T)
    return llama_forward(params, cfg, tokens, positions, k_cache, v_cache)


def llama_decode_step(params, cfg: LlamaConfig, tokens, positions, k_cache,
                      v_cache):
    """One decode step for every row. tokens/positions: [B]. Returns
    (logits [B, V], k_cache, v_cache)."""
    logits, k_cache, v_cache = llama_forward(
        params, cfg, tokens[:, None], positions[:, None], k_cache, v_cache)
    return logits[:, 0], k_cache, v_cache


def init_kv_cache(cfg: LlamaConfig, batch: int, seq_len: Optional[int] = None,
                  dtype: Optional[str] = None, device=None):
    """Zeroed stacked (k, v) caches [L, B, Hkv, dh, S] (S-minor, the JAX
    layout) in `dtype` (default cfg.dtype), on `device` (default the
    card)."""
    dev = resolve_device(device)
    S = seq_len or cfg.max_seq_len
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, cfg.head_dim, S)
    dt = torch.int8 if dtype == "int8" else DTYPES[dtype or cfg.dtype]
    return (torch.zeros(shape, dtype=dt, device=dev),
            torch.zeros(shape, dtype=dt, device=dev))


def llama_decode_step_inplace(params, cfg: LlamaConfig, tokens, positions,
                              k_cache, v_cache):
    """One decode step over the stacked [L, B, Hkv, dh, S] caches, each
    layer's slice written in place: the same math as llama_decode_step.
    (JAX needs this form to keep XLA from double-buffering the stacked
    caches; here every forward already writes in place.) tokens /
    positions: [B]. Returns (logits [B, V] float32, k_cache, v_cache)."""
    return llama_decode_step_unrolled(params, cfg, tokens, positions,
                                      k_cache, v_cache)


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

    tokens: [B]; positions: [B]; k/v_layers: L [B, Hkv, dh, S] tensors
    (lists from init_kv_cache_layers, or a stacked cache), written in
    place. The T=1 read is cfg.decode_attn's ("kernel":
    ops/decode_attention). Returns (logits [B, V] float32, k_layers,
    v_layers)."""
    x = _embed(params, cfg, tokens)[:, None]               # [B, 1, D]
    pos_grid = positions[:, None]
    for l in range(cfg.n_layers):
        layer = _layer(params, l)
        attn, _, _ = _attention_block(x, layer, k_layers[l], v_layers[l],
                                      pos_grid, cfg)
        x = x + attn
        x = x + _ffn_block(x, layer, cfg)
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    return _head(x[:, 0], params, cfg), k_layers, v_layers


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
        x = x + _mm_rows(attn.reshape(B, 1, H * dh), layer, "wo", cfg)
        x = x + _ffn_block(x, layer, cfg)
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    return (_head(x[:, 0], params, cfg), k_layers, v_layers, ks_layers,
            vs_layers)


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
        x = x + _mm_rows(attn.reshape(B, 1, H * dh), layer, "wo", cfg)
        x = x + _ffn_block(x, layer, cfg)
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    return _head(x[:, 0], params, cfg), k_pool, v_pool


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
        x = x + _mm_rows(attn.reshape(B, 1, H * dh), layer, "wo", cfg)
        x = x + _ffn_block(x, layer, cfg)
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    return (_head(x[:, 0], params, cfg), k_pool, v_pool, ks_pool, vs_pool)


def _gather_rows(pool_l, table):
    """A layer's pages through a block table as contiguous rows:
    [P, Hkv, dh, ps] -> [K, Hkv, dh, NP * ps] (scales: [P, Hkv, ps] ->
    [K, Hkv, NP * ps])."""
    rows = pool_l[table]                       # [K, NP, Hkv, (dh,) ps]
    rows = rows.movedim(1, -2)                 # [K, Hkv, (dh,) NP, ps]
    return rows.reshape(*rows.shape[:-2], -1)


def _masked_read(q, k_rows, v_rows, positions, cfg: LlamaConfig):
    """The plain masked GQA read of a window over cache rows (the JAX
    einsums): q [K, T, H, dh] in the model dtype, k/v_rows [K, Hkv, dh, S]
    in the model dtype, positions [K, T]; f32 scores, a query at absolute
    position p sees cache slot j iff j <= p, p rounded to the value dtype
    before p . v. Returns [K, T, H * dh] in q's dtype."""
    K, T, H, dh = q.shape
    S = k_rows.shape[-1]
    qg = q.reshape(K, T, cfg.n_kv_heads, cfg.q_per_kv, dh)
    scores = torch.einsum("bthgd,bhds->bhgts", qg.float(),
                          k_rows.float()) / math.sqrt(dh)
    visible = (torch.arange(S, device=q.device)[None, None, :]
               <= positions.long()[:, :, None])                   # [K, T, S]
    probs = torch.softmax(torch.where(visible[:, None, None], scores, -1e30),
                          dim=-1)
    del scores
    out = torch.einsum("bhgts,bhds->bthgd", probs.to(v_rows.dtype).float(),
                       v_rows.float()).to(q.dtype)
    return out.reshape(K, T, H * dh)


def _project_last(x, params, cfg: LlamaConfig, project_last):
    """Final norm, then the lm_head of row k's hidden state at window index
    project_last[k]: [K, V] f32."""
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    rows = torch.arange(x.shape[0], device=x.device)
    return _head(x[rows, project_last.long()], params, cfg)


def llama_prefill_chunk(params, cfg: LlamaConfig, tokens, positions,
                        k_layers, v_layers, slots, project_last=None):
    """One CHUNK of a cached prefill over per-layer cache buffers.

    tokens: [K, C] the chunk's token ids; positions: [K, C] their absolute
    positions (a later chunk attends the earlier chunks' K/V already in the
    cache rows: the mask `j <= q_pos` needs nothing more); k/v_layers: L
    [B, Hkv, dh, S] buffers, written in place; slots: [K] row ids, whose
    rows are gathered, run through the cache-aware attention for the chunk
    (``_attention_block``: the plain masked read, as C < S) and scattered
    back; None when the buffers hold exactly the K rows (the paged engine's
    per-job temps), which are then written in place with no gather.

    project_last: [K] within-chunk index of the hidden row to project (the
    engine passes one for EVERY chunk: a short row's last prompt token may
    fall in any chunk); None skips the final norm and the lm_head.
    Returns (logits [K, V] f32 or None, k_layers, v_layers)."""
    x = _embed(params, cfg, tokens)                        # [K, C, D]
    for l in range(cfg.n_layers):
        layer = _layer(params, l)
        if slots is None:
            k_rows, v_rows = k_layers[l], v_layers[l]
        else:
            k_rows, v_rows = k_layers[l][slots], v_layers[l][slots]
        attn, _, _ = _attention_block(x, layer, k_rows, v_rows, positions,
                                      cfg)
        x = x + attn
        x = x + _ffn_block(x, layer, cfg)
        if slots is not None:
            k_layers[l][slots] = k_rows
            v_layers[l][slots] = v_rows
    if project_last is None:
        return None, k_layers, v_layers
    return _project_last(x, params, cfg, project_last), k_layers, v_layers


def llama_prefill_chunk_q8(params, cfg: LlamaConfig, tokens, positions,
                           k_layers, v_layers, ks_layers, vs_layers, slots,
                           project_last=None):
    """One CHUNK of a cached prefill over int8 per-layer caches.

    As llama_prefill_chunk over int8 [B, Hkv, dh, S] buffers with their f32
    [B, Hkv, S] scales, all written in place: the K rows' int8 values and
    scales are gathered, this chunk's fresh K/V quantize into them per
    token and head (ops/decode_attention.quantize_kv; earlier tokens keep
    their quantization), and the chunk's queries read ALL the gathered rows
    dequantized to the model dtype, its own positions included, so later
    chunks and decode see what this chunk saw. Dequantization materializes
    the K gathered rows only. Returns (logits [K, V] f32 or None,
    k_layers, v_layers, ks_layers, vs_layers)."""
    from ..ops.decode_attention import quantize_kv

    K, C = tokens.shape
    H, Hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = DTYPES[cfg.dtype]
    batch_idx = torch.arange(K, device=tokens.device)[:, None]
    pos = positions.long()
    x = _embed(params, cfg, tokens)                        # [K, C, D]
    for l in range(cfg.n_layers):
        layer = _layer(params, l)
        k_rows8, v_rows8 = k_layers[l][slots], v_layers[l][slots]
        ks_rows, vs_rows = ks_layers[l][slots], vs_layers[l][slots]
        normed = rms_norm(x, layer["attn_norm"], cfg.rms_eps)
        q = rope(_mm(normed, layer, "wq").reshape(K, C, H, dh), positions,
                 cfg.rope_theta)
        k = rope(_mm(normed, layer, "wk").reshape(K, C, Hkv, dh), positions,
                 cfg.rope_theta)
        v = _mm(normed, layer, "wv").reshape(K, C, Hkv, dh)
        k8, ks = quantize_kv(k, axis=-1)          # [K, C, Hkv, dh], [K, C, Hkv]
        v8, vs = quantize_kv(v, axis=-1)
        # advanced indices on dims 0 and 3 (2 for the scales)
        k_rows8[batch_idx, :, :, pos] = k8
        v_rows8[batch_idx, :, :, pos] = v8
        ks_rows[batch_idx, :, pos] = ks
        vs_rows[batch_idx, :, pos] = vs
        k_deq = (k_rows8.float() * ks_rows[:, :, None, :]).to(dt)
        v_deq = (v_rows8.float() * vs_rows[:, :, None, :]).to(dt)
        attn = _masked_read(q, k_deq, v_deq, positions, cfg)
        x = x + _mm_rows(attn, layer, "wo", cfg)
        x = x + _ffn_block(x, layer, cfg)
        k_layers[l][slots] = k_rows8
        v_layers[l][slots] = v_rows8
        ks_layers[l][slots] = ks_rows
        vs_layers[l][slots] = vs_rows
    logits = (None if project_last is None
              else _project_last(x, params, cfg, project_last))
    return logits, k_layers, v_layers, ks_layers, vs_layers


def _verify_head(x, params, cfg=None):
    """The verify window's lm_head: x [B, W, D] final-norm hidden states ->
    (greedy [B, W] int64, the position-0 logits [B, V] f32). One [B * W, D]
    @ [D, V] product, which reads the head once; the reference projects
    one window position at a time so that no [B, W, V] buffer exists (at
    B=8, W=5 and Llama-3's vocabulary it is 20.5 MB of f32). Both compute
    the same function; the single product is the faster: 0.4029 ms against
    1.9026 for one per position at that shape (Llama-3-8B's head, CUDA
    events, NVIDIA H100 80GB HBM3 at 700 W; chip_smoke.py --spec, PERF.md
    §5)."""
    B, W, D = x.shape
    logits = _head(x.reshape(B * W, D), params, cfg).view(B, W, -1)
    return logits.argmax(dim=-1), logits[:, 0]


def _window(tokens, drafts, positions):
    """The verify window [tokens | drafts] [B, d+1] and its absolute
    positions positions + arange(d+1)."""
    window = torch.cat([tokens[:, None], drafts.to(tokens.dtype)], dim=1)
    pos_grid = (positions.long()[:, None]
                + torch.arange(window.shape[1], device=tokens.device))
    return window, pos_grid


def llama_verify_step(params, cfg: LlamaConfig, tokens, drafts, positions,
                      k_layers, v_layers):
    """Speculative decoding's VERIFY over per-layer dense caches: score
    every row's current token and its d drafted tokens in ONE forward.

    tokens: [B] the current (already sampled) tokens; drafts: [B, d]
    proposed continuations (junk rows allowed: acceptance is the caller's);
    positions: [B] the current tokens' absolute positions; k/v_layers: L
    [B, Hkv, dh, S] buffers. The window [tokens | drafts] runs at
    positions + arange(d+1) and its K/V are written IN PLACE (clamped to
    S - 1, see the module docstring): for an accepted prefix they are what
    decode would have written, and a rejected position holds junk its real
    occupant overwrites before any query reads it. The window's attention
    is the plain masked read over the whole cache (``_attention_block``:
    T = d+1 takes neither the flash nor the T=1 kernel branch).

    Returns (greedy [B, d+1] int64, the argmax after each window position;
    logits0 [B, V] f32, position 0's logits for temperature sampling;
    k_layers, v_layers)."""
    window, pos_grid = _window(tokens, drafts, positions)
    x = _embed(params, cfg, window)
    for l in range(cfg.n_layers):
        layer = _layer(params, l)
        attn, _, _ = _attention_block(x, layer, k_layers[l], v_layers[l],
                                      pos_grid, cfg)
        x = x + attn
        x = x + _ffn_block(x, layer, cfg)
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    greedy, logits0 = _verify_head(x, params, cfg)
    return greedy, logits0, k_layers, v_layers


def llama_verify_step_paged(params, cfg: LlamaConfig, tokens, drafts,
                            positions, k_pool, v_pool, table):
    """Speculative decoding's VERIFY against the paged pool: the contract
    of llama_verify_step over k/v_pool [L, P, Hkv, dh, ps] (written in
    place) through table [B, NP].

    Per layer, the window's K/V are written one position at a time with
    ops/paged_attention.paged_write_decode, so a position past a row's
    reservation maps to a zero table entry, the garbage page 0; then each
    row's pages are gathered into contiguous [B, Hkv, dh, NP * ps] rows
    (one pool read per layer: the paged kernel is a T=1 read, d+1 of them
    would stream the pages d+1 times) and the plain masked read runs over
    them. Page j of a row covers positions [j * ps, (j+1) * ps), so a
    gathered offset is an absolute position and the `j <= q_pos` mask
    carries over. Returns (greedy [B, d+1] int64, logits0 [B, V] f32,
    k_pool, v_pool)."""
    from ..ops.paged_attention import paged_write_decode

    B, d = drafts.shape
    H, Hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    window, pos_grid = _window(tokens, drafts, positions)
    table_l = table.long()
    x = _embed(params, cfg, window)
    for l in range(cfg.n_layers):
        layer = _layer(params, l)
        normed = rms_norm(x, layer["attn_norm"], cfg.rms_eps)
        q = rope(_mm(normed, layer, "wq").reshape(B, d + 1, H, dh), pos_grid,
                 cfg.rope_theta)
        k = rope(_mm(normed, layer, "wk").reshape(B, d + 1, Hkv, dh),
                 pos_grid, cfg.rope_theta)
        v = _mm(normed, layer, "wv").reshape(B, d + 1, Hkv, dh)
        for i in range(d + 1):
            paged_write_decode(k_pool[l], v_pool[l], k[:, i], v[:, i], table,
                               pos_grid[:, i])
        attn = _masked_read(q, _gather_rows(k_pool[l], table_l),
                            _gather_rows(v_pool[l], table_l), pos_grid, cfg)
        x = x + _mm_rows(attn, layer, "wo", cfg)
        x = x + _ffn_block(x, layer, cfg)
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    greedy, logits0 = _verify_head(x, params, cfg)
    return greedy, logits0, k_pool, v_pool


def _prefill_paged_prefix(params, cfg: LlamaConfig, tokens, prefix_lens,
                          lengths, k_pool, v_pool, table, project_last,
                          ks_pool=None, vs_pool=None):
    """The body of llama_prefill_paged_prefix[_q8]: int8 pools when
    ks_pool/vs_pool are given. Returns the last logits [K, V] float32."""
    from ..ops.decode_attention import quantize_kv

    K, T = tokens.shape
    H, Hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    ps = k_pool.shape[-1]
    NP = table.shape[1]
    dev = tokens.device
    table = table.long()
    pos_grid = prefix_lens.long()[:, None] + torch.arange(T, device=dev)
    in_prompt = pos_grid < lengths.long()[:, None]              # [K, T]
    # token at absolute pos -> (table[k, pos // ps], pos % ps); pads -> 0
    page_slot = (pos_grid // ps).clamp(0, NP - 1)
    page_ids = torch.where(in_prompt, table.gather(1, page_slot), 0)
    offsets = pos_grid % ps
    x = _embed(params, cfg, tokens)
    for l in range(cfg.n_layers):
        layer = _layer(params, l)
        normed = rms_norm(x, layer["attn_norm"], cfg.rms_eps)
        q = rope(_mm(normed, layer, "wq").reshape(K, T, H, dh), pos_grid,
                 cfg.rope_theta)
        k = rope(_mm(normed, layer, "wk").reshape(K, T, Hkv, dh), pos_grid,
                 cfg.rope_theta)
        v = _mm(normed, layer, "wv").reshape(K, T, Hkv, dh)
        if ks_pool is None:
            # advanced indices on pool dims 0 and 3 -> value [K, T, Hkv, dh]
            k_pool[l][page_ids, :, :, offsets] = k
            v_pool[l][page_ids, :, :, offsets] = v
            k_rows = _gather_rows(k_pool[l], table)             # [K,Hkv,dh,S]
            v_rows = _gather_rows(v_pool[l], table)
        else:
            # the tail quantizes on write; the prefix pages keep the donor's
            # quantization, and the gathered rows dequantize to the model
            # dtype
            k8, ks = quantize_kv(k, axis=-1)     # [K, T, Hkv, dh], [K, T, Hkv]
            v8, vs = quantize_kv(v, axis=-1)
            k_pool[l][page_ids, :, :, offsets] = k8
            v_pool[l][page_ids, :, :, offsets] = v8
            ks_pool[l][page_ids, :, offsets] = ks
            vs_pool[l][page_ids, :, offsets] = vs
            k_rows = (_gather_rows(k_pool[l], table).float()
                      * _gather_rows(ks_pool[l], table)[:, :, None]
                      ).to(x.dtype)
            v_rows = (_gather_rows(v_pool[l], table).float()
                      * _gather_rows(vs_pool[l], table)[:, :, None]
                      ).to(x.dtype)
        attn = _masked_read(q, k_rows, v_rows, pos_grid, cfg)
        x = x + _mm_rows(attn, layer, "wo", cfg)
        x = x + _ffn_block(x, layer, cfg)
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    last = x[torch.arange(K, device=dev), project_last.long()]     # [K, D]
    return _head(last, params, cfg)


def llama_prefill_paged_prefix(params, cfg: LlamaConfig, tokens, prefix_lens,
                               lengths, k_pool, v_pool, table, project_last):
    """Prefill ONLY a prompt's un-cached tail against the paged pool.

    The prefix-cache hit path: row k's first prefix_lens[k] tokens (whole
    pages) are already in shared pages its block table references, so this
    forward computes K/V for the tail window alone.

    tokens: [K, T] tail token ids (row k's tail starts at absolute position
    prefix_lens[k]); prefix_lens: [K] multiples of the page size; lengths:
    [K] FULL prompt lengths; k/v_pool: [L, P, Hkv, dh, ps], written in
    place; table: [K, NP] page ids (shared prefix pages first, then the
    row's fresh pages); project_last: [K] within-window index of each row's
    last prompt token.

    Per layer: the tail's K/V scatter into their pages (pad positions past
    lengths[k] go to the garbage page 0), then the tail's queries attend
    the gathered pages [K, Hkv, dh, NP * ps] under the `j <= q_pos` mask,
    which covers the shared prefix and the tail's own causal window in one
    rule. This is plain PyTorch, as the reference's is XLA einsums: it is
    not a Pallas call, and flash (T == S under causal) does not fit it.

    Returns (last_logits [K, V] float32, k_pool, v_pool)."""
    logits = _prefill_paged_prefix(params, cfg, tokens, prefix_lens, lengths,
                                   k_pool, v_pool, table, project_last)
    return logits, k_pool, v_pool


def llama_prefill_paged_prefix_q8(params, cfg: LlamaConfig, tokens,
                                  prefix_lens, lengths, k_pool, v_pool,
                                  ks_pool, vs_pool, table, project_last):
    """llama_prefill_paged_prefix over int8 pools with per-token scales:
    k/v_pool [L, P, Hkv, dh, ps] int8 and ks/vs_pool [L, P, Hkv, ps] f32,
    all written in place. The tail's K/V quantize on write
    (ops/decode_attention.quantize_kv per token and head), so the pages
    hold what later decode reads; the gathered rows dequantize to the model
    dtype for the tail's attention, and the prefix pages keep the donor's
    quantization. Returns (last_logits [K, V] f32, k_pool, v_pool, ks_pool,
    vs_pool)."""
    logits = _prefill_paged_prefix(params, cfg, tokens, prefix_lens, lengths,
                                   k_pool, v_pool, table, project_last,
                                   ks_pool, vs_pool)
    return logits, k_pool, v_pool, ks_pool, vs_pool


def _attention_block_nocache(x, layer, positions, cfg: LlamaConfig,
                             attn_fn=None):
    """Plain causal attention sublayer without a cache: x [B, T, D] ->
    [B, T, D]. attn_fn overrides the attention primitive (q, k, v) ->
    [B, T, H, dh]: how the sequence-parallel forward swaps in ring or
    Ulysses attention while sharing every projection with the dense path.
    Else flash (ops/flash_attention) under attn_impl="flash", or the f32
    oracle attention_reference."""
    from ..ops.flash_attention import attention_reference, flash_attention

    B, T, _ = x.shape
    H, Hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    normed = _tp_in(rms_norm(x, layer["attn_norm"], cfg.rms_eps), cfg)
    q = rope(_mm(normed, layer, "wq").reshape(B, T, H, dh), positions,
             cfg.rope_theta)
    k = rope(_mm(normed, layer, "wk").reshape(B, T, Hkv, dh), positions,
             cfg.rope_theta)
    v = _mm(normed, layer, "wv").reshape(B, T, Hkv, dh)
    if attn_fn is not None:
        attn = attn_fn(q, k, v)
    elif cfg.attn_impl == "flash":
        attn = flash_attention(q, k, v, True)
    else:
        attn = attention_reference(q, k, v, causal=True)
    return _mm_rows(attn.reshape(B, T, H * dh), layer, "wo", cfg)


def forward_nocache_at(params, cfg: LlamaConfig, tokens, positions,
                       attn_fn=None):
    """Cache-free forward over a token chunk at explicit absolute positions
    [B, T]: the shared body of llama_forward_nocache and the
    sequence-parallel forward (parallel/longcontext.py), which calls it per
    rank with its chunk's position offset and a collective attention
    primitive as attn_fn. Returns logits [B, T, V] float32."""
    x = _embed(params, cfg, tokens)
    for l in range(cfg.n_layers):
        layer = _layer(params, l)
        x = x + _attention_block_nocache(x, layer, positions, cfg, attn_fn)
        x = x + _ffn_block(x, layer, cfg)
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    return _head(x, params, cfg)


def llama_forward_nocache(params, cfg: LlamaConfig, tokens):
    """Training/eval forward without a cache: plain causal attention over
    positions [0, T). Returns logits [B, T, V] float32.

    Under a ShardConfig with an sp axis (the mesh forward, whose batch is
    split by parallel/sharding.batch_spec) `tokens` is this rank's
    sequence chunk: its positions start at sp index * T, and attention
    reads the K/V of every chunk, all-gathered over sp
    (parallel/longcontext.gathered_attention)."""
    positions, attn_fn = nocache_positions(cfg, tokens)
    return forward_nocache_at(params, cfg, tokens, positions, attn_fn)


def nocache_positions(cfg: LlamaConfig, tokens):
    """(positions [B, T], attn_fn) of a cache-free forward over `tokens`:
    [0, T) and the default attention, or under a ShardConfig with an sp
    axis this rank's chunk's absolute positions and the K/V gathered over
    sp (llama_forward_nocache's docstring). Shared with the MoE forward."""
    B, T = tokens.shape
    sp = getattr(cfg, "sp", None)
    start, attn_fn = 0, None
    if sp is not None:
        from ..parallel.longcontext import gathered_attention

        start = sp.rank * T
        attn_fn = lambda q, k, v: gathered_attention(q, k, v, sp)  # noqa: E731
    positions = (start + torch.arange(T, device=tokens.device)).expand(B, T)
    return positions, attn_fn

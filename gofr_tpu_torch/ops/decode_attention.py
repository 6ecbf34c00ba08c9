"""Dense decode attention, int8 KV quantization, and the shared plain read.

Ports ``gofr_tpu/ops/decode_attention.py``:

- ``decode_attention_reference`` (the XLA oracle: dequantize, softmax, zeros
  at length 0) and ``quantize_kv`` (symmetric per-token int8, bit-identical
  to JAX on the same f32 input);
- ``decode_attention``: the T=1 GQA read over a dense ``[B, Hkv, dh, S]``
  cache, in bf16 or int8 with per-token scales. On a CUDA tensor it runs the
  hand-written kernel (``csrc/decode_attention.cu``, replacing the Pallas
  ``_decode_kernel``); on a CPU tensor, ``decode_attention_plain``.

``decode_attention_plain`` is the Pallas kernels' arithmetic in PyTorch —
``_decode_kernel`` and ``_paged_kernel`` are one online softmax under two
addressing schemes — so ``ops/paged_attention`` reads through it too. The
Pallas ``block_s`` tiling knob is not taken: the CUDA kernels pick their own
tiles whatever S is, and the plain version walks the Pallas blocks.

The kernels (``csrc/decode_split.cuh``, paged and dense, bf16 and int8)
split each row's context over several blocks and combine them in the same
launch:
``plan_split`` chooses the blocks and their units on the host,
``split_scratch`` hands the kernel its partials buffer and its zeroed
per-(row, kv head) counters, and ``decode_read_split_plain`` is the
split-and-combine in plain PyTorch, for the tests only.
"""

from __future__ import annotations

import math

import torch

from . import _build

DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
# the Pallas kernel's default block, which the plain version walks
PALLAS_BLOCK_S = 512
# the split kernels' tiles, bf16 and int8, and blocks per row
# (csrc/decode_split.cuh KvBf16::TK, KvInt8::TK, MAX_SPLIT): a tile's d row
# is one 128-byte line, and a unit is a whole number of tiles (and of pages)
SPLIT_TILE = 64
SPLIT_TILE_Q8 = 128
SPLIT_MAX = 64
# blocks the planner aims for, in waves of one block per SM
SPLIT_WAVES = 2
H100_SMS = 132


def quantize_kv(x, axis: int = -2):
    """Symmetric int8 quantization along `axis` (the dh axis of a
    [..., dh, S] cache entry): returns (int8 values, f32 scale) with dequant
    = int8 * scale and scale shaped like x minus `axis`. Divides by the
    scale (no reciprocal) and rounds half to even, as JAX does."""
    x32 = x.float()
    amax = x32.abs().amax(dim=axis, keepdim=True)
    scale = torch.clamp(amax, min=1e-8) / 127.0
    q8 = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q8, scale.squeeze(axis)


def decode_attention_reference(q, k_cache, v_cache, lengths, k_scale=None,
                               v_scale=None):
    """The oracle. q: [B, H, dh]; k/v_cache: [B, Hkv, dh, S]; lengths: [B]
    live positions; k/v_scale: optional [B, Hkv, S] dequant scales for int8
    caches. Dequantizes, then one softmax over the masked row. A row of
    length 0 returns zeros. Returns [B, H, dh] in q.dtype."""
    B, H, dh = q.shape
    Hkv, S = k_cache.shape[1], k_cache.shape[-1]
    G = H // Hkv
    k = k_cache.float()
    v = v_cache.float()
    if k_scale is not None:
        k = k * k_scale[:, :, None, :].float()
    if v_scale is not None:
        v = v * v_scale[:, :, None, :].float()
    qg = q.reshape(B, Hkv, G, dh).float()
    s = torch.einsum("bhgd,bhds->bhgs", qg, k) / math.sqrt(dh)
    lengths = lengths.long()
    pos = torch.arange(S, device=q.device)[None, :]
    s = torch.where((pos < lengths[:, None])[:, None, None, :], s,
                    DEFAULT_MASK_VALUE)
    out = torch.einsum("bhgs,bhds->bhgd", torch.softmax(s, dim=-1), v)
    out = torch.where((lengths > 0)[:, None, None, None], out, 0.0)
    return out.reshape(B, H, dh).to(q.dtype)


def decode_attention_plain(q, k, v, lengths, k_scale=None, v_scale=None,
                           block: int = PALLAS_BLOCK_S):
    """The Pallas kernels' arithmetic in plain PyTorch, on q [B, H, dh] and
    k/v [B, Hkv, dh, S] (bf16/f32, or int8 with [B, Hkv, S] scales).

    Walks S in `block`-token blocks folding each into a running (max, sum,
    acc) in f32; a row skips every block at or past its length (so length
    0 gives zeros, and lengths past S count as S). Per block: s = (q . k) *
    1/sqrt(dh) [* k_scale], masked; l sums p = exp(s - m); then [p *=
    v_scale and] p is cast to the value dtype (bf16 for int8 values, as
    the TPU kernel upcasts them) before p . v. Returns [B, H, dh] in
    q.dtype."""
    B, H, dh = q.shape
    Hkv, S = k.shape[1], k.shape[-1]
    G = H // Hkv
    quantized = k_scale is not None
    if quantized != (v_scale is not None):
        raise ValueError("pass both k_scale and v_scale or neither")
    p_dtype = torch.bfloat16 if quantized else v.dtype
    scale = 1.0 / math.sqrt(dh)
    lengths = lengths.long().clamp(0, S)
    qg = q.reshape(B, Hkv, G, dh).float()
    m = torch.full((B, Hkv, G, 1), DEFAULT_MASK_VALUE, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, Hkv, G, dh), dtype=torch.float32, device=q.device)
    n_blocks = -(-int(lengths.max()) // block) if B else 0
    for j0 in range(0, n_blocks * block, block):
        kb = k[..., j0:j0 + block].float()                 # [B, Hkv, dh, bs]
        vb = v[..., j0:j0 + block].float()
        s = (qg @ kb) * scale                              # [B, Hkv, G, bs]
        if quantized:
            s = s * k_scale[:, :, None, j0:j0 + block].float()
        kv_pos = torch.arange(j0, j0 + kb.shape[-1], device=q.device)
        s = torch.where((kv_pos[None, :] < lengths[:, None])[:, None, None],
                        s, DEFAULT_MASK_VALUE)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l_new = l * alpha + p.sum(dim=-1, keepdim=True)
        if quantized:
            p = p * v_scale[:, :, None, j0:j0 + block].float()
        pv = p.to(p_dtype).float() @ vb.transpose(-1, -2)  # [B, Hkv, G, dh]
        # a row whose length ends before this block keeps its state (the
        # Pallas kernel skips its compute)
        live = (lengths > j0)[:, None, None, None]
        m = torch.where(live, m_new, m)
        l = torch.where(live, l_new, l)
        acc = torch.where(live, acc * alpha + pv, acc)
    out = acc / torch.clamp(l, min=1e-30)
    return out.reshape(B, H, dh).to(q.dtype)


def decode_read_split_plain(q, k, v, lengths, nsplit: int, unit: int,
                            tile: int = SPLIT_TILE, k_scale=None,
                            v_scale=None):
    """The split kernels' arithmetic in plain PyTorch, for the tests: q
    [B, H, dh], k/v [B, Hkv, dh, S] (a paged read passes its gathered
    pages), lengths [B] clamped to [0, S]; int8 k/v with k/v_scale
    [B, Hkv, S] (a paged read gathers the scale pages too).

    S is cut into units of `unit` tokens and block s takes units s,
    s + nsplit, s + 2 nsplit, ... It folds its units' `tile`-token tiles,
    in order, into its own f32 (m, l, acc) with p = exp(s - m) in f32
    (masked tokens give p = 0) and reports them unnormalised. With scales,
    in the Pallas order: s = (q . k8) * 1/sqrt(dh) * k_scale, l sums p,
    then p *= v_scale before p . v8 (p stays f32). Blocks whose first unit
    starts at or past a row's length are dropped (block 0 is always kept),
    the rest merge with weights exp(m_s - max m), and o = acc / max(l,
    1e-30), so a row of length 0 gives zeros. Returns [B, H, dh] in
    q.dtype."""
    B, H, dh = q.shape
    Hkv, S = k.shape[1], k.shape[-1]
    G = H // Hkv
    quantized = k_scale is not None
    if quantized != (v_scale is not None):
        raise ValueError("pass both k_scale and v_scale or neither")
    per = -(-S // (unit * nsplit))                 # units per block
    span = per * unit                              # tokens per block
    pad = per * nsplit * unit - S

    def deal(x):
        """[..., S] -> [..., nsplit, span]: block s's units in order."""
        lead = x.shape[:-1]
        x = torch.nn.functional.pad(x.float(), (0, pad))
        x = x.reshape(*lead, per, nsplit, unit).transpose(-3, -2)
        return x.reshape(*lead, nsplit, span)

    kf, vf = deal(k), deal(v)                      # [B, Hkv, dh, nsplit, span]
    if quantized:
        ksf, vsf = deal(k_scale), deal(v_scale)    # [B, Hkv, nsplit, span]
    lengths = lengths.long().clamp(0, S)
    qg = q.reshape(B, Hkv, G, dh).float()
    scale = 1.0 / math.sqrt(dh)
    blocks = torch.arange(nsplit, device=q.device)
    within = torch.arange(span, device=q.device)
    pos = ((within // unit)[None, :] * nsplit + blocks[:, None]) * unit \
        + (within % unit)[None, :]                 # [nsplit, span] tokens
    m = torch.full((B, Hkv, nsplit, G, 1), DEFAULT_MASK_VALUE,
                   dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, Hkv, nsplit, G, dh), dtype=torch.float32,
                      device=q.device)
    for t0 in range(0, span, tile):
        kb, vb = kf[..., t0:t0 + tile], vf[..., t0:t0 + tile]
        s = torch.einsum("bhgd,bhdnt->bhngt", qg, kb) * scale
        if quantized:
            s = s * ksf[:, :, :, None, t0:t0 + tile]
        live = (pos[None, :, t0:t0 + tile] < lengths[:, None, None])[
            :, None, :, None, :]
        s = torch.where(live, s, DEFAULT_MASK_VALUE)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.where(live, torch.exp(s - m_new), 0.0)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        if quantized:
            p = p * vsf[:, :, :, None, t0:t0 + tile]
        acc = acc * alpha + torch.einsum("bhngt,bhdnt->bhngd", p, vb)
        m = m_new
    first = blocks * unit
    keep = ((first[None] < lengths[:, None]) | (first[None] == 0))[
        :, None, :, None, None]
    m = torch.where(keep, m, DEFAULT_MASK_VALUE)
    weight = torch.where(keep, torch.exp(m - m.amax(dim=2, keepdim=True)),
                         0.0)
    out = (weight * acc).sum(dim=2) / torch.clamp((weight * l).sum(dim=2),
                                                  min=1e-30)
    return out.reshape(B, H, dh).to(q.dtype)


def plan_split(B: int, Hkv: int, capacity: int, page_size=None,
               sms: int = H100_SMS, tile: int = SPLIT_TILE):
    """(nsplit, unit) for the split kernels, from what the host knows
    without a sync: units of `unit` tokens, a whole number of `tile`-token
    tiles (SPLIT_TILE bf16, SPLIT_TILE_Q8 int8) and (paged) of pages, dealt
    round-robin to nsplit blocks per (row, kv head), as many blocks as it
    takes for B * Hkv * nsplit to reach SPLIT_WAVES waves of `sms` blocks,
    at most SPLIT_MAX and at most one per unit of `capacity` (NP * ps
    paged, S dense)."""
    unit = tile if page_size is None else math.lcm(tile, page_size)
    units = -(-capacity // unit)
    want = -(-SPLIT_WAVES * sms // (B * Hkv))
    return max(1, min(want, units, SPLIT_MAX)), unit


_counters: dict = {}


def split_scratch(q, Hkv: int, capacity: int, page_size=None,
                  tile: int = SPLIT_TILE):
    """(nsplit, unit, partials, counters) of one split read of q [B, H, dh]
    with `tile`-token tiles on q's device and current stream (see
    ``plan_split``). The partials are a fresh [B, Hkv,
    nsplit, H / Hkv, dh + 2] float32 buffer (empty at nsplit 1); the
    counters are the per-(row, kv head) tickets the last live block
    resets to 0, one zeroed int32 buffer per (device, stream), grown (one
    fill) when B * Hkv grows and never cleared per call. Two reads in
    flight at once share counters only on one stream, where they cannot
    overlap; the engines read on one stream."""
    B, H, dh = q.shape
    dev = q.device
    nsplit, unit = plan_split(
        B, Hkv, capacity, page_size,
        torch.cuda.get_device_properties(dev).multi_processor_count, tile)
    part = torch.empty((B, Hkv, nsplit, H // Hkv, dh + 2) if nsplit > 1
                       else (0,), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    counters = _counters.get((dev.index, stream))
    if counters is None or counters.numel() < B * Hkv:
        counters = torch.zeros(B * Hkv, dtype=torch.int32, device=dev)
        _counters[(dev.index, stream)] = counters
    return nsplit, unit, part, counters


def check_kernel_inputs(who: str, q, kv, scales, ints) -> bool:
    """Raise unless q and every tensor of `kv`, `scales` and `ints` lie on
    one CUDA device and are contiguous, q is bf16, k/v are bf16 without
    scales or int8 with f32 scales, `ints` are int32, and dh / the GQA group
    are ones the kernels instantiate (dh in {64, 128}, H / Hkv in {1, 2, 4,
    8}). q: [B, H, dh]; kv: (k, v) of equal shape [.., Hkv, dh, tokens].
    Returns whether the read is quantized."""
    quantized = scales[0] is not None
    if quantized != (scales[1] is not None):
        raise ValueError("pass both k_scale and v_scale or neither")
    named = [("q", q), ("k", kv[0]), ("v", kv[1])] + [
        (f"int{i}", t) for i, t in enumerate(ints)]
    if quantized:
        named += [("k_scale", scales[0]), ("v_scale", scales[1])]
    dev = q.device
    if not q.is_cuda or any(t.device != dev for _, t in named):
        raise ValueError(f"{who} needs every input on one CUDA device")
    elem = torch.int8 if quantized else torch.bfloat16
    if q.dtype != torch.bfloat16 or kv[0].dtype != elem or kv[1].dtype != elem:
        raise TypeError(f"{who} takes bfloat16 q and {elem} k/v, got "
                        f"{q.dtype}/{kv[0].dtype}/{kv[1].dtype}")
    if quantized and not (scales[0].dtype == scales[1].dtype == torch.float32):
        raise TypeError(f"{who} takes float32 scales")
    if any(t.dtype != torch.int32 for t in ints):
        raise TypeError(f"{who}: table and lengths must be int32")
    for name, t in named:
        if not t.is_contiguous():
            raise ValueError(f"{who}: {name} must be contiguous")
    if q.dim() != 3 or kv[0].shape != kv[1].shape or kv[0].dim() < 3:
        raise ValueError(f"{who}: bad shapes q{tuple(q.shape)} "
                         f"k{tuple(kv[0].shape)} v{tuple(kv[1].shape)}")
    H, dh = q.shape[1], q.shape[2]
    Hkv, kdh = kv[0].shape[-3], kv[0].shape[-2]
    if kdh != dh or H % Hkv:
        raise ValueError(f"{who}: bad shapes q{tuple(q.shape)} "
                         f"k{tuple(kv[0].shape)}")
    if dh not in (64, 128) or H // Hkv not in (1, 2, 4, 8):
        raise ValueError(f"{who}: head_dim {dh} / group {H // Hkv} not "
                         f"supported")
    return quantized


def launch(entry: str, who: str, q, pointers, ints, scale: float):
    """Call C entry point `entry` on q's current stream with the data
    pointers of `pointers` (output last), the ints and the softmax scale;
    raise when the launch is refused."""
    fn = _build.function(entry)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(*(t.data_ptr() for t in pointers), *ints, scale, stream)
    if rc != 0:
        raise RuntimeError(f"{who} kernel launch failed: CUDA error {rc}")


def _decode_cuda(q, k_cache, v_cache, lengths, k_scale, v_scale):
    who = "decode_attention_cuda"
    quantized = check_kernel_inputs(who, q, (k_cache, v_cache),
                                    (k_scale, v_scale), (lengths,))
    B, H, dh = q.shape
    Bc, Hkv, _, S = (k_cache.shape if k_cache.dim() == 4
                     else (-1, 0, 0, 0))
    if Bc != B or tuple(lengths.shape) != (B,) or S < 1:
        raise ValueError(f"{who}: bad shapes q{tuple(q.shape)} "
                         f"cache{tuple(k_cache.shape)} "
                         f"lengths{tuple(lengths.shape)}")
    if quantized and not (tuple(k_scale.shape) == tuple(v_scale.shape)
                          == (B, Hkv, S)):
        raise ValueError(f"{who}: scales must be [B, Hkv, S] = "
                         f"{(B, Hkv, S)}, got {tuple(k_scale.shape)}")
    o = torch.empty_like(q)
    nsplit, unit, part, counters = split_scratch(
        q, Hkv, S, tile=SPLIT_TILE_Q8 if quantized else SPLIT_TILE)
    if quantized:
        entry, kv = "decode_attention_q8", [k_cache, v_cache, k_scale, v_scale]
    else:
        entry, kv = "decode_attention", [k_cache, v_cache]
    launch(entry, who, q, [q, *kv, lengths, o, part, counters],
           (B, H, Hkv, dh, S, unit, nsplit), 1.0 / math.sqrt(dh))
    return o


def decode_attention_cuda(q, k_cache, v_cache, lengths):
    """Launch ``csrc/decode_attention.cu`` (bf16 caches; the split read of
    ``csrc/decode_split.cuh``, one launch). q: [B, H, dh] and caches
    [B, Hkv, dh, S] contiguous bf16, lengths [B] int32 (clamped to [0, S]
    in the kernel), on one CUDA device; dh in {64, 128}, H / Hkv in
    {1, 2, 4, 8}. Returns a new [B, H, dh] tensor. Raises on any other
    input, or when the launch is refused; never falls back. Reads on one
    stream (see ``split_scratch``)."""
    o = _decode_cuda(q, k_cache, v_cache, lengths, None, None)
    decode_attention_cuda.launches += 1
    return o


def decode_attention_q8_cuda(q, k_cache, v_cache, k_scale, v_scale, lengths):
    """Launch ``csrc/decode_attention.cu``'s int8 entry point: as
    ``decode_attention_cuda`` (the same split read, one launch) with int8
    caches and [B, Hkv, S] float32 scales, dequantization folded into the
    read."""
    o = _decode_cuda(q, k_cache, v_cache, lengths, k_scale, v_scale)
    decode_attention_q8_cuda.launches += 1
    return o


decode_attention_cuda.launches = 0
decode_attention_q8_cuda.launches = 0


def decode_attention(q, k_cache, v_cache, lengths, k_scale=None,
                     v_scale=None):
    """Dense decode attention. q: [B, H, dh]; k/v_cache: [B, Hkv, dh, S];
    lengths: [B] int32; k/v_scale: optional [B, Hkv, S] float32 scales —
    pass both to read int8 caches. Returns [B, H, dh]. The CUDA kernel on a
    CUDA tensor, the plain version on a CPU tensor."""
    if q.is_cuda:
        if k_scale is None and v_scale is None:
            return decode_attention_cuda(q, k_cache, v_cache, lengths)
        return decode_attention_q8_cuda(q, k_cache, v_cache, k_scale,
                                        v_scale, lengths)
    if q.device.type != "cpu":
        raise ValueError(f"unsupported device {q.device}")
    return decode_attention_plain(q, k_cache, v_cache, lengths, k_scale,
                                  v_scale)

"""Paged KV cache: decode attention through a block table, and page writes.

Ports ``gofr_tpu/ops/paged_attention.py``:

- ``paged_attention_reference`` (the gather-based oracle, with optional
  int8 scales) and ``paged_attention``: on a CUDA tensor the hand-written
  kernel (``csrc/paged_attention.cu``, replacing the Pallas
  ``_paged_kernel``: ``paged_attention_cuda`` for bf16 pools,
  ``paged_attention_q8_cuda`` for int8 pools with per-token scales, both
  the context split over blocks); on a CPU tensor
  ``paged_attention_plain``, the Pallas page walk in PyTorch
  (``ops/decode_attention.decode_attention_plain`` over the gathered
  pages);
- ``paged_write_decode``, ``_prefill_scatter_indices``,
  ``paged_write_prefill_stacked`` and ``paged_write_prefill_scales``, plus
  ``paged_write_decode_scales`` (inline in JAX's
  ``llama_decode_step_paged_q8``). Values and scales share one index rule
  per writer. JAX returns updated pools; the port updates the pools IN
  PLACE (the JAX engine donates them) and returns them.

Pools keep the JAX layout [P, Hkv, dh, page_size] (stacked [L, ...] for the
prefill writer), token index minor, and scale pools [P, Hkv, page_size], so
tests compare them one to one. Page 0 is the garbage page
(tpu/paging.PageAllocator): pad positions of a prefill window and writes of
inactive decode rows land there by construction.

A row of length 0 differs between the versions exactly as in JAX: the
kernel and the plain version return zeros, the reference the mean of the
masked v. The engine always passes positions + 1 >= 1.
"""

from __future__ import annotations

import math

import torch

from .decode_attention import (DEFAULT_MASK_VALUE, SPLIT_TILE, SPLIT_TILE_Q8,
                               check_kernel_inputs, decode_attention_plain,
                               launch, split_scratch)


def _gather_pages(pool, table):
    """[P, Hkv, X.., ps] pages of `table` [B, NP] -> [B, Hkv, X.., NP * ps]
    in token order."""
    g = pool[table.long()]                       # [B, NP, Hkv, X.., ps]
    g = g.movedim(1, -2)                         # [B, Hkv, X.., NP, ps]
    return g.reshape(*g.shape[:-2], -1)


def paged_attention_reference(q, k_pool, v_pool, table, lengths,
                              k_scale=None, v_scale=None):
    """Gather-based oracle. q: [B, H, dh]; pools: [P, Hkv, dh, ps]; table:
    [B, NP] page ids; lengths: [B] live tokens per row (including the
    current token); k/v_scale: optional [P, Hkv, ps] dequant scales for
    int8 pools. Returns [B, H, dh] in q.dtype."""
    B, H, dh = q.shape
    Hkv = k_pool.shape[1]
    G = H // Hkv
    k = _gather_pages(k_pool, table).float()     # [B, Hkv, dh, NP * ps]
    v = _gather_pages(v_pool, table).float()
    if k_scale is not None:
        k = k * _gather_pages(k_scale, table)[:, :, None, :].float()
    if v_scale is not None:
        v = v * _gather_pages(v_scale, table)[:, :, None, :].float()
    qg = q.reshape(B, Hkv, G, dh).float()
    s = torch.einsum("bhgd,bhds->bhgs", qg, k) / math.sqrt(dh)
    pos = torch.arange(k.shape[-1], device=q.device)[None, :]
    s = torch.where((pos < lengths.long()[:, None])[:, None, None, :], s,
                    DEFAULT_MASK_VALUE)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgs,bhds->bhgd", p, v)
    return out.reshape(B, H, dh).to(q.dtype)


def paged_attention_plain(q, k_pool, v_pool, table, lengths, k_scale=None,
                          v_scale=None):
    """The Pallas ``_paged_kernel``'s arithmetic: the table's pages walked
    one page per block, rows skipping pages past their length, int8 scales
    folded in (see ``decode_attention_plain``). Lengths clamp to the
    table's NP * ps tokens; length 0 gives zeros."""
    scales = [None if s is None else _gather_pages(s, table)
              for s in (k_scale, v_scale)]
    return decode_attention_plain(
        q, _gather_pages(k_pool, table), _gather_pages(v_pool, table),
        lengths, *scales, block=k_pool.shape[-1])


def _paged_cuda(q, k_pool, v_pool, table, lengths, k_scale, v_scale):
    who = "paged_attention_cuda"
    quantized = check_kernel_inputs(who, q, (k_pool, v_pool),
                                    (k_scale, v_scale), (table, lengths))
    B, H, dh = q.shape
    P, Hkv, _, ps = (k_pool.shape if k_pool.dim() == 4 else (0, 0, 0, 0))
    NP = table.shape[1] if table.dim() == 2 else -1
    if (P < 1 or table.shape[0] != B or tuple(lengths.shape) != (B,)
            or NP < 1):
        raise ValueError(f"{who}: bad shapes q{tuple(q.shape)} "
                         f"pool{tuple(k_pool.shape)} table{tuple(table.shape)}"
                         f" lengths{tuple(lengths.shape)}")
    if quantized and not (tuple(k_scale.shape) == tuple(v_scale.shape)
                          == (P, Hkv, ps)):
        raise ValueError(f"{who}: scale pools must be [P, Hkv, ps] = "
                         f"{(P, Hkv, ps)}, got {tuple(k_scale.shape)}")
    o = torch.empty_like(q)
    nsplit, unit, part, counters = split_scratch(
        q, Hkv, NP * ps, ps, SPLIT_TILE_Q8 if quantized else SPLIT_TILE)
    if quantized:
        entry, kv = "paged_attention_q8", [k_pool, v_pool, k_scale, v_scale]
    else:
        entry, kv = "paged_attention", [k_pool, v_pool]
    launch(entry, who, q, [q, *kv, table, lengths, o, part, counters],
           (B, H, Hkv, dh, P, ps, NP, unit, nsplit), 1.0 / math.sqrt(dh))
    return o


def paged_attention_cuda(q, k_pool, v_pool, table, lengths):
    """Launch ``csrc/paged_attention.cu`` (bf16 pools; the split read of
    ``csrc/decode_split.cuh``, one launch, on one stream: see
    ``ops/decode_attention.split_scratch``). q: [B, H, dh] and
    pools [P, Hkv, dh, ps] contiguous bf16, table [B, NP] and lengths [B]
    contiguous int32, all on one CUDA device; dh in {64, 128}, H / Hkv in
    {1, 2, 4, 8}. Entries of `table` past a row's live pages must hold a
    valid page id (0 is the garbage page); they are never read. Returns a
    new [B, H, dh] tensor. Raises on any other input, or when the launch is
    refused; never falls back."""
    return _paged_cuda(q, k_pool, v_pool, table, lengths, None, None)


def paged_attention_q8_cuda(q, k_pool, v_pool, k_scale, v_scale, table,
                            lengths):
    """Launch ``csrc/paged_attention.cu``'s int8 entry point: as
    ``paged_attention_cuda`` (the same split read, one launch) with int8
    pools and [P, Hkv, ps] float32 scale pools, dequantization folded into
    the read."""
    return _paged_cuda(q, k_pool, v_pool, table, lengths, k_scale, v_scale)


def paged_attention(q, k_pool, v_pool, table, lengths, k_scale=None,
                    v_scale=None):
    """Paged decode attention. q: [B, H, dh]; pools: [P, Hkv, dh, ps];
    table: [B, NP] int32; lengths: [B] int32; k/v_scale: optional
    [P, Hkv, ps] float32 scales — pass both to read int8 pools. Returns
    [B, H, dh]. The CUDA kernel on a CUDA tensor, the plain version on a
    CPU tensor."""
    if q.is_cuda:
        if k_scale is None and v_scale is None:
            return paged_attention_cuda(q, k_pool, v_pool, table, lengths)
        return paged_attention_q8_cuda(q, k_pool, v_pool, k_scale, v_scale,
                                       table, lengths)
    if q.device.type != "cpu":
        raise ValueError(f"unsupported device {q.device}")
    return paged_attention_plain(q, k_pool, v_pool, table, lengths, k_scale,
                                 v_scale)


def _decode_write_indices(table, positions, ps: int):
    """(page_ids [B], offsets [B]) of one decode step's writes: position p
    of row b goes to (table[b, p // ps], p % ps). A position past the
    table's width writes through its LAST column, as JAX's clamped gather
    does — the engine keeps that column the garbage page."""
    positions = positions.long()
    rows = torch.arange(table.shape[0], device=table.device)
    cols = torch.clamp(positions // ps, max=table.shape[1] - 1)
    return table[rows, cols].long(), positions % ps


def paged_write_decode(k_pool, v_pool, k, v, table, positions):
    """Scatter one decode step's K/V into the pool, in place.

    k/v: [B, Hkv, dh] new entries; table: [B, NP]; positions: [B] absolute
    write positions (see ``_decode_write_indices``). Returns (k_pool,
    v_pool)."""
    page_ids, offsets = _decode_write_indices(table, positions,
                                              k_pool.shape[-1])
    # advanced indices on dims 0 and 3 -> value shape [B, Hkv, dh]
    k_pool[page_ids, :, :, offsets] = k
    v_pool[page_ids, :, :, offsets] = v
    return k_pool, v_pool


def paged_write_decode_scales(ks_pool, vs_pool, ks, vs, table, positions):
    """Scatter one decode step's per-token dequant scales into the scale
    pools [P, Hkv, ps], in place, by the value writer's index rule. ks/vs:
    [B, Hkv]. Returns (ks_pool, vs_pool)."""
    page_ids, offsets = _decode_write_indices(table, positions,
                                              ks_pool.shape[-1])
    # advanced indices on dims 0 and 2 -> value shape [B, Hkv]
    ks_pool[page_ids, :, offsets] = ks
    vs_pool[page_ids, :, offsets] = vs
    return ks_pool, vs_pool


def _prefill_scatter_indices(table, lengths, T: int, ps: int):
    """(page_ids [K, T], offsets [K, T]) for scattering a prefill window
    into pages: token t of row k goes to (table[k, t // ps], t % ps), and
    positions >= lengths[k] divert to the GARBAGE page 0 so pad junk never
    lands in a live page."""
    K = table.shape[0]
    pos = torch.arange(T, device=table.device)[None, :]          # [1, T]
    page_slot = (pos // ps).expand(K, T)
    page_ids = torch.gather(table.long(), 1, page_slot)          # [K, T]
    page_ids = torch.where(pos < lengths.long()[:, None], page_ids,
                           torch.zeros_like(page_ids))
    offsets = (pos % ps).expand(K, T)
    return page_ids, offsets


def paged_write_prefill_stacked(k_pool, v_pool, tmp_k, tmp_v, table, lengths):
    """Scatter a prefill window's K/V into the stacked page pool, in place.

    k/v_pool: [L, P, Hkv, dh, ps]; tmp_k/v: [L, K, Hkv, dh, T] fresh window
    entries at positions [0..T); table: [K, NP]; lengths: [K] true prompt
    lengths (pad junk diverts to the garbage page). Returns (k_pool,
    v_pool)."""
    ps = k_pool.shape[-1]
    page_ids, offsets = _prefill_scatter_indices(table, lengths,
                                                 tmp_k.shape[-1], ps)
    # advanced indices on pool dims 1 and 4 (non-adjacent -> result dims
    # lead) -> value shape [K, T, L, Hkv, dh]
    k_pool[:, page_ids, :, :, offsets] = tmp_k.permute(1, 4, 0, 2, 3)
    v_pool[:, page_ids, :, :, offsets] = tmp_v.permute(1, 4, 0, 2, 3)
    return k_pool, v_pool


def paged_write_prefill_scales(s_pool, tmp_s, table, lengths):
    """Scatter a prefill window's per-token dequant scales into the stacked
    scale pool, in place. s_pool: [L, P, Hkv, ps]; tmp_s: [L, K, Hkv, T];
    table: [K, NP]; lengths: [K]. Shares the value writer's index rule
    (``_prefill_scatter_indices``). Returns s_pool."""
    page_ids, offsets = _prefill_scatter_indices(table, lengths,
                                                 tmp_s.shape[-1],
                                                 s_pool.shape[-1])
    # advanced indices on pool dims 1 and 3 -> value shape [K, T, L, Hkv]
    s_pool[:, page_ids, :, offsets] = tmp_s.permute(1, 3, 0, 2)
    return s_pool

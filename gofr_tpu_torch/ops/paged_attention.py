"""Paged KV cache: decode attention through a block table, and page writes.

Ports ``gofr_tpu/ops/paged_attention.py``:

- ``paged_attention_reference`` (the gather-based oracle) is the plain
  version; ``paged_attention`` runs the hand-written CUDA kernel
  (``csrc/paged_attention.cu``, replacing the Pallas ``_paged_kernel`` with
  ``quantized=False``) on a CUDA tensor and the plain version on a CPU one;
- ``paged_write_decode``, ``_prefill_scatter_indices`` and
  ``paged_write_prefill_stacked``. JAX returns updated pools; the port
  updates the pools IN PLACE (the JAX engine donates them) and returns them.

Pools keep the JAX layout [P, Hkv, dh, page_size] (stacked [L, ...] for the
prefill writer), token index minor, so tests compare them one to one. Page 0
is the garbage page (tpu/paging.PageAllocator): pad positions of a prefill
window and writes of inactive decode rows land there by construction.

Not ported yet: the int8 pools with per-token scales (``k_scale``/``v_scale``,
``paged_write_prefill_scales``) — ROADMAP A8.

A row of length 0 differs between the two versions exactly as in JAX: the
kernel returns zeros, the reference the mean of the masked v. The engine
always passes positions + 1 >= 1.
"""

from __future__ import annotations

import math

import torch

from . import _build

DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)


def paged_attention_reference(q, k_pool, v_pool, table, lengths):
    """Gather-based oracle. q: [B, H, dh]; pools: [P, Hkv, dh, ps]; table:
    [B, NP] page ids; lengths: [B] live tokens per row (including the
    current token). Returns [B, H, dh] in q.dtype."""
    B, H, dh = q.shape
    _, Hkv, _, ps = k_pool.shape
    NP = table.shape[1]
    G = H // Hkv
    idx = table.long()
    # [B, NP, Hkv, dh, ps] -> [B, Hkv, dh, NP * ps]
    k = k_pool[idx].float().permute(0, 2, 3, 1, 4).reshape(B, Hkv, dh, NP * ps)
    v = v_pool[idx].float().permute(0, 2, 3, 1, 4).reshape(B, Hkv, dh, NP * ps)
    qg = q.reshape(B, Hkv, G, dh).float()
    s = torch.einsum("bhgd,bhds->bhgs", qg, k) / math.sqrt(dh)
    pos = torch.arange(NP * ps, device=q.device)[None, :]
    s = torch.where((pos < lengths.long()[:, None])[:, None, None, :], s,
                    DEFAULT_MASK_VALUE)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgs,bhds->bhgd", p, v)
    return out.reshape(B, H, dh).to(q.dtype)


def paged_attention_cuda(q, k_pool, v_pool, table, lengths):
    """Launch ``csrc/paged_attention.cu``. q: [B, H, dh] and pools
    [P, Hkv, dh, ps] contiguous bf16, table [B, NP] and lengths [B]
    contiguous int32, all on one CUDA device; dh in {64, 128}, H / Hkv in
    {1, 2, 4, 8}. Entries of `table` past a row's live pages must hold a
    valid page id (0 is the garbage page); they are never read. Returns a
    new [B, H, dh] tensor. Raises on any other input, or when the launch is
    refused; never falls back."""
    dev = q.device
    if not q.is_cuda or any(t.device != dev
                            for t in (k_pool, v_pool, table, lengths)):
        raise ValueError("paged_attention_cuda needs every input on one "
                         "CUDA device")
    if not (q.dtype == k_pool.dtype == v_pool.dtype == torch.bfloat16):
        raise TypeError(f"paged_attention_cuda takes bfloat16 q/pools, got "
                        f"{q.dtype}/{k_pool.dtype}/{v_pool.dtype}")
    if table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("table and lengths must be int32")
    if q.dim() != 3 or k_pool.dim() != 4 or k_pool.shape != v_pool.shape:
        raise ValueError(f"bad shapes q{tuple(q.shape)} "
                         f"pool{tuple(k_pool.shape)}")
    B, H, dh = q.shape
    P, Hkv, pdh, ps = k_pool.shape
    NP = table.shape[1] if table.dim() == 2 else -1
    if (pdh != dh or H % Hkv or table.shape[0] != B
            or tuple(lengths.shape) != (B,) or NP < 1):
        raise ValueError(f"bad shapes q{tuple(q.shape)} "
                         f"pool{tuple(k_pool.shape)} table{tuple(table.shape)}"
                         f" lengths{tuple(lengths.shape)}")
    if dh not in (64, 128) or H // Hkv not in (1, 2, 4, 8):
        raise ValueError(f"head_dim {dh} / group {H // Hkv} not supported")
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
                    ("table", table), ("lengths", lengths)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    fn = _build.function("paged_attention")
    o = torch.empty_like(q)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                table.data_ptr(), lengths.data_ptr(), o.data_ptr(), B, H, Hkv,
                dh, P, ps, NP, 1.0 / math.sqrt(dh), stream)
    if rc != 0:
        raise RuntimeError(f"paged attention kernel launch failed: CUDA error "
                           f"{rc}")
    paged_attention_cuda.launches += 1
    return o


paged_attention_cuda.launches = 0


def paged_attention(q, k_pool, v_pool, table, lengths):
    """Paged decode attention. q: [B, H, dh]; pools: [P, Hkv, dh, ps];
    table: [B, NP] int32; lengths: [B] int32. Returns [B, H, dh]. The CUDA
    kernel on a CUDA tensor, the plain version on a CPU tensor."""
    if q.is_cuda:
        return paged_attention_cuda(q, k_pool, v_pool, table, lengths)
    if q.device.type != "cpu":
        raise ValueError(f"unsupported device {q.device}")
    return paged_attention_reference(q, k_pool, v_pool, table, lengths)


def paged_write_decode(k_pool, v_pool, k, v, table, positions):
    """Scatter one decode step's K/V into the pool, in place.

    k/v: [B, Hkv, dh] new entries; table: [B, NP]; positions: [B] absolute
    write positions. A position past the table's width writes through its
    LAST column, as JAX's clamped gather does — the engine keeps that column
    the garbage page. Returns (k_pool, v_pool)."""
    B = k.shape[0]
    ps = k_pool.shape[-1]
    NP = table.shape[1]
    positions = positions.long()
    rows = torch.arange(B, device=k.device)
    page_ids = table[rows, torch.clamp(positions // ps, max=NP - 1)].long()
    offsets = positions % ps
    # advanced indices on dims 0 and 3 -> value shape [B, Hkv, dh]
    k_pool[page_ids, :, :, offsets] = k
    v_pool[page_ids, :, :, offsets] = v
    return k_pool, v_pool


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

"""Causal ring attention over the "sp" mesh axis.

Ports ``gofr_tpu/ops/ring_attention.py`` (``_block_attend``,
``ring_attention``). The sequence is sharded [B, T/sp, ...] per rank; K/V
blocks rotate around the ring (parallel/collectives.ppermute,
``batch_isend_irecv`` on the sp group) while each rank keeps its Q block,
merging partial attention with the online-softmax (flash) recurrence.
Communication is sp-1 point-to-point hops instead of an all-gather of the
full K/V, so memory stays O(T/sp) per card.

Causality across blocks: with every rank holding sequence chunk index
c = its sp index, a KV block with chunk index c_kv contributes
  - fully        if c_kv < c_q
  - causal-mask  if c_kv == c_q
  - nothing      if c_kv > c_q   (still computed, but masked)

``_block_attend`` is plain PyTorch, as the reference's is plain JAX: no
Pallas kernel is on this path. Differentiable: autograd traces the loop,
and ppermute's backward is the inverse permutation. The reference rotates
after every step, the last included (the rotated block is dropped); here
the last rotation is not made, which changes no value.

With grad enabled each block's attention is checkpointed
(``torch.utils.checkpoint``, non-reentrant): autograd keeps the block's
inputs and its (numerator, max, sum) and recomputes the f32 scores and
probabilities in the backward, where eager PyTorch would keep ~2 GB of
them a block and a layer at 2048 queries and keys a rank (Llama-3-8B's 32
heads); XLA fuses them away in the reference. The block holds no
collective, so the recompute adds none.
"""

from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from ..parallel.collectives import Axis, ppermute


def _block_attend(q, k, v, scale, mask):
    """q: [B,Tq,H,dh]; k/v: [B,Tk,Hkv,dh]; mask: [Tq,Tk] bool.
    Returns (numerator [B,Tq,H,dh] f32, row_max [B,Hkv,G,Tq] f32 with
    fully-masked rows at 0, row_sum, which rows saw any key)."""
    B, Tq, H, dh = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    qg = q.reshape(B, Tq, Hkv, G, dh)
    scores = torch.einsum("bthgd,bshd->bhgts", qg.float(), k.float()) * scale
    scores = torch.where(mask[None, None, None], scores, -math.inf)
    m = scores.amax(dim=-1)                                # [B,Hkv,G,Tq]
    finite = torch.isfinite(m)
    # guard fully-masked rows (m = -inf -> exp(nan)); they contribute zero
    m_safe = torch.where(finite, m, 0.0)
    p = torch.exp(scores - m_safe[..., None])
    p = torch.where(torch.isfinite(scores), p, 0.0)
    l = p.sum(dim=-1)                                      # [B,Hkv,G,Tq]
    num = torch.einsum("bhgts,bshd->bthgd", p, v.float())
    return num.reshape(B, Tq, H, dh), m_safe, l, finite


def ring_attention(q, k, v, axis: Axis):
    """Causal attention with K/V rotating over `axis` (the sp axis).

    q, k, v: this rank's sequence chunk, [B, T_local, H(kv), dh]. Returns
    [B, T_local, H, dh] in q.dtype."""
    B, T, H, dh = q.shape
    sp, my_chunk = axis.size, axis.rank
    scale = 1.0 / math.sqrt(dh)
    dev = q.device
    local_mask = torch.tril(torch.ones((T, T), dtype=torch.bool, device=dev))
    full_mask = torch.ones((T, T), dtype=torch.bool, device=dev)
    none_mask = torch.zeros((T, T), dtype=torch.bool, device=dev)
    Hkv = k.shape[2]
    G = H // Hkv

    def bc(x):  # [B,Hkv,G,Tq] -> [B,Tq,H,1]
        return x.permute(0, 3, 1, 2).reshape(B, T, H)[..., None]

    acc = torch.zeros((B, T, H, dh), dtype=torch.float32, device=dev)
    m_run = torch.full((B, Hkv, G, T), -math.inf, dtype=torch.float32,
                       device=dev)
    l_run = torch.zeros((B, Hkv, G, T), dtype=torch.float32, device=dev)
    k_blk, v_blk = k, v
    for s in range(sp):
        # the block arriving at step s originated at chunk (my_chunk - s) % sp
        kv_chunk = (my_chunk - s) % sp
        mask = (full_mask if kv_chunk < my_chunk else
                local_mask if kv_chunk == my_chunk else none_mask)
        if torch.is_grad_enabled():
            num, m_blk, l_blk, valid = checkpoint(
                _block_attend, q, k_blk, v_blk, scale, mask,
                use_reentrant=False)
        else:
            num, m_blk, l_blk, valid = _block_attend(q, k_blk, v_blk, scale,
                                                     mask)
        # online-softmax merge (flash recurrence) in [B,Hkv,G,Tq] space
        m_new = torch.maximum(m_run, torch.where(valid, m_blk, -math.inf))
        m_new_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        run_ok = torch.isfinite(m_run)
        scale_run = torch.where(
            run_ok, torch.exp(torch.where(run_ok, m_run, 0.0) - m_new_safe),
            0.0)
        scale_blk = torch.where(
            valid, torch.exp(torch.where(valid, m_blk, 0.0) - m_new_safe),
            0.0)
        acc = acc * bc(scale_run) + num * bc(scale_blk)
        l_run = l_run * scale_run + l_blk * scale_blk
        m_run = m_new
        if s < sp - 1:
            # rotate K/V to the next rank on the ring
            k_blk = ppermute(k_blk, axis)
            v_blk = ppermute(v_blk, axis)
    denom = l_run.permute(0, 3, 1, 2).reshape(B, T, H)[..., None]
    out = acc / denom.clamp_min(1e-20)
    return out.to(q.dtype)

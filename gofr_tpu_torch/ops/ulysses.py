"""Ulysses (DeepSpeed-style) sequence parallelism: all-to-all head exchange.

Ports ``gofr_tpu/ops/ulysses.py`` (``ulysses_attention``). One all-to-all
re-shards activations from sequence-sharded [B, T/sp, H, dh] to
head-sharded [B, T, H/sp, dh], each rank runs FULL-sequence causal
attention over its head slice, and a second all-to-all restores sequence
sharding. The exchanges are parallel/collectives.all_to_all
(``all_to_all_single`` on the sp group, tiled as ``jax.lax.all_to_all``
with tiled=True); between them runs ops/flash_attention.FlashAttention,
the hand-written kernel on the card (at H/sp query heads over the whole
sequence) and its plain version on the CPU.

GQA: K/V heads are repeated up to the query head count before the
exchange when sp does not divide Hkv (correctness first; the all-to-all
then moves H/sp query heads and H/sp repeated KV heads per rank, and flash
runs at G = 1). Query heads that sp does not divide raise ValueError, as
the reference's do.

Differentiable: the all-to-all's backward is the all-to-all with the two
axes swapped, and FlashAttention carries the reference's gradient.
"""

from __future__ import annotations

import torch

from ..parallel.collectives import Axis, all_to_all
from .flash_attention import FlashAttention


def ulysses_attention(q, k, v, axis: Axis):
    """Causal attention with all-to-all sequence<->head re-sharding over
    `axis` (the sp axis).

    q: [B, T_local, H, dh], k/v: [B, T_local, Hkv, dh], this rank's
    sequence chunk; H divisible by the axis size. Returns
    [B, T_local, H, dh] in q.dtype."""
    H = q.shape[2]
    Hkv = k.shape[2]
    sp = axis.size
    if H % sp != 0:
        raise ValueError(f"query heads ({H}) must divide by |{axis.name}|"
                         f"={sp}")
    if Hkv % sp != 0:  # GQA with fewer KV heads than ranks: replicate up
        rep = H // Hkv
        k = torch.repeat_interleave(k, rep, dim=2)
        v = torch.repeat_interleave(v, rep, dim=2)

    def seq_to_head(x):  # [B, T/sp, h, dh] -> [B, T, h/sp, dh]
        return all_to_all(x, axis, split_dim=2, concat_dim=1)

    q, k, v = seq_to_head(q), seq_to_head(k), seq_to_head(v)
    out = FlashAttention.apply(q, k, v, True)
    # [B, T, H/sp, dh] -> [B, T/sp, H, dh]
    return all_to_all(out, axis, split_dim=1, concat_dim=2)

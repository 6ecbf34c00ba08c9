"""Sequence-parallel Llama forward: activations stay sharded [B, T/sp, ...].

Ports from ``gofr_tpu/parallel/longcontext.py``: ``sp_llama_forward`` and
``make_sp_forward``. Each rank runs the WHOLE layer stack over its
[B/dp, T/sp] chunk of the batch (parallel/sharding.batch_spec), so every
projection, norm and FFN touches only the chunk, and the one
position-dependent op, attention, goes through a collective primitive:

  - "ring":    ops/ring_attention: K/V blocks rotate over the sp group,
               O(T/sp) memory per card, sp-1 hops
  - "ulysses": ops/ulysses: two all-to-alls re-shard to head-parallel and
               back, the flash kernel between them

RoPE stays correct because each rank computes its chunk's ABSOLUTE
positions from its sp index. Params are replicated (sp shards activations,
the memory term that grows with T, not weights). The body is
models/llama.forward_nocache_at with its ``attn_fn`` hook, as the
reference's shard_map body is; it is differentiable end to end, so the
same function serves a long-context training step.

``gathered_attention`` is the attention of the annotation-sharded mesh
forward (models/llama.llama_forward_nocache under a ShardConfig with an sp
axis): the K/V of every chunk all-gathered over sp, then causal attention
of this chunk's queries, what XLA inserts for the reference under
``batch_spec()`` annotations (gofr_tpu/parallel/sharding.py). The
gather's backward is a sum reduce-scatter over sp
(collectives.gather_from), XLA's transpose of that all-gather.

Under the sharded training step (train.make_train_step with ``mesh=``)
``make_sp_forward``'s forward gets the global batch and returns this
rank's logits block; the step sums the replicated parameters' gradients
over dp and sp.
"""

from __future__ import annotations

import torch

from .collectives import gather_from
from .mesh import axis_of, axis_size


def gathered_attention(q, k, v, axis):
    """Causal attention of this rank's query chunk over the K/V of every
    chunk, gathered over `axis` (the sp axis): q [B, Tl, H, dh], k/v
    [B, Tl, Hkv, dh] -> [B, Tl, H, dh]. Chunk c's queries see keys up to
    their own absolute positions, so only the first (c + 1) chunks are
    read."""
    from ..ops.flash_attention import attention_reference

    # every rank's queries read this chunk's K/V: the gradient of the
    # gathered K/V is summed over sp, then split (a reduce-scatter)
    k_all = gather_from(k, axis, dim=1, grad="sum")
    v_all = gather_from(v, axis, dim=1, grad="sum")
    S = (axis.rank + 1) * q.shape[1]
    return attention_reference(q, k_all[:, :S], v_all[:, :S], causal=True)


def _chunk(tokens, mesh, dp_axis: str, sp_axis: str):
    dp, sp = axis_size(mesh, dp_axis), axis_size(mesh, sp_axis)
    B, T = tokens.shape
    if T % sp != 0:
        raise ValueError(f"sequence length {T} must divide by "
                         f"|{sp_axis}|={sp}")
    if B % dp != 0:
        raise ValueError(f"batch {B} must divide by |{dp_axis}|={dp}")
    b, t = B // dp, T // sp
    i = mesh.get_local_rank(dp_axis) if dp > 1 else 0
    j = mesh.get_local_rank(sp_axis) if sp > 1 else 0
    return tokens[i * b:(i + 1) * b, j * t:(j + 1) * t], j * t


def sp_llama_forward(params, cfg, tokens, mesh, attn: str = "ring",
                     dp_axis: str = "dp", sp_axis: str = "sp"):
    """Causal LM forward with sequence parallelism over `sp_axis`.

    tokens: the GLOBAL [B, T] batch, the same on every rank, with T
    divisible by the sp axis size (pad to the sequence bucket first) and B
    by the dp axis size. Each rank computes its [B/dp, T/sp] chunk and
    returns that chunk's logits [B/dp, T/sp, V] f32 (the blocks of every
    rank tile the reference's ("dp", "sp", None)-sharded output). Params
    are replicated: the full tree on every rank."""
    from ..models.llama import forward_nocache_at
    from ..ops.ring_attention import ring_attention
    from ..ops.ulysses import ulysses_attention

    if attn == "ring":
        attn_impl = ring_attention
    elif attn == "ulysses":
        attn_impl = ulysses_attention
    else:
        raise ValueError(f"unknown sequence-parallel attention {attn!r} "
                         "(supported: ring, ulysses)")
    local, start = _chunk(tokens, mesh, dp_axis, sp_axis)
    axis = axis_of(mesh, sp_axis)
    B, T_local = local.shape
    positions = (start + torch.arange(T_local, device=local.device)
                 ).expand(B, T_local)
    return forward_nocache_at(
        params, cfg, local, positions,
        attn_fn=lambda q, k, v: attn_impl(q, k, v, axis))


def make_sp_forward(cfg, mesh, attn: str = "ring"):
    """Bind (cfg, mesh, attn) into a forward_fn(params, tokens) for a
    training step."""
    def forward(params, tokens):
        return sp_llama_forward(params, cfg, tokens, mesh, attn=attn)

    return forward

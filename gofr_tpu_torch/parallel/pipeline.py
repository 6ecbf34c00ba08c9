"""Pipeline parallelism: the GPipe microbatch schedule over the "pp" axis.

Ports ``gofr_tpu/parallel/pipeline.py``: ``gpipe`` and
``pipelined_llama_forward``. The layers are stacked [L, ...] and split over
pp (``llama_param_specs``: each pp rank holds L/pp contiguous layers, its
block from ``shard_params``) and run as one stage. Microbatches flow
through the wavefront: at step s, rank r runs microbatch s - r (when
0 <= s - r < n_micro), and its activations hop to the next rank by
``collectives.ppermute`` after every step. The reference's schedule is one
``lax.scan`` inside ``shard_map``; here it is a Python loop of the same
static shape on every rank, so every rank makes the same collectives in the
same order, forward and backward: ranks outside their valid window run the
stage on junk (zeros, or the last microbatch again on rank 0), never
reaching the outputs, exactly as the reference's do. The stage's input is
chosen by ``torch.where`` on the rank, not by a branch, so the autograd
graph has the same shape on every rank and each backward exchange (the
inverse permutation, ppermute's backward) is made by all of them. The
hop after the last step, whose result the reference's scan drops, is not
made.

The last rank's outputs are replicated over pp by
``collectives.replicate_from`` (the reference's ``psum(where(rank ==
last, outputs, 0))``). Embedding, final norm and head run outside the
pipeline, replicated over pp as in the reference; the embedding's output
enters through ``copy_to`` over pp, so its gradient, which only rank 0's
stage produces, is summed over pp and every pp rank's ``tok_emb`` gets the
same gradient. Under a tp axis the stage and the head run Megatron's tp
within each pp rank (models/llama.py under ``shard_config``). The bubble
is the usual (pp - 1) / (n_micro + pp - 1).
"""

from __future__ import annotations

from typing import Callable

import torch

from .collectives import Axis, copy_to, ppermute, replicate_from


def gpipe(stage_fn: Callable, local_params, x_micro, axis: Axis):
    """Run the pipeline schedule over `axis` (the pp axis).

    stage_fn(local_params, x) -> x' applies this rank's layer stack.
    x_micro: [n_micro, mb, ...] microbatched input (read on rank 0; the
    other ranks receive activations over the ring). Returns
    [n_micro, mb, ...] outputs, the last rank's, on every rank of the
    axis. Differentiable: the backward pipelines in reverse."""
    pp, rank = axis.size, axis.rank
    n_micro = x_micro.shape[0]
    n_steps = n_micro + pp - 1
    first = torch.tensor(rank == 0, device=x_micro.device)
    inbuf = torch.zeros_like(x_micro[0])
    outputs = []
    for step in range(n_steps):
        x_in = torch.where(first, x_micro[min(step, n_micro - 1)], inbuf)
        h = stage_fn(local_params, x_in)
        if step >= pp - 1:
            # microbatch step - (pp - 1) leaves the last rank at this step
            outputs.append(h)
        if step < n_steps - 1:
            inbuf = ppermute(h, axis, 1)
    return replicate_from(torch.stack(outputs), axis, pp - 1)


def pipelined_llama_forward(params, cfg, tokens, mesh,
                            n_microbatches: int = 4):
    """Llama forward with the layer stack pipelined over "pp".

    params: this rank's blocks under llama_param_specs (its L/pp layers,
    tp-split where the mesh has tp). tokens: the GLOBAL [B, T] batch, the
    same on every rank; each dp rank runs its B/dp rows (the mesh's sp
    must be 1). Returns this rank's logits block [B/dp, T, V] f32,
    replicated over pp. Differentiable: usable directly in a training step
    (train.make_train_step with mesh=)."""
    from ..models.llama import (_attention_block_nocache, _embed, _ffn_block,
                                _head, rms_norm)
    from .mesh import axis_of, axis_size
    from .sharding import batch_spec, local_block, shard_config

    B, T = tokens.shape
    if B % n_microbatches != 0:
        raise ValueError(f"batch {B} not divisible by {n_microbatches} "
                         f"microbatches")
    if axis_size(mesh, "sp") != 1:
        raise ValueError("pipelined_llama_forward runs the whole sequence "
                         "on every rank: the mesh's sp must be 1")
    local = local_block(tokens, mesh, batch_spec())
    b = local.shape[0]
    if b % n_microbatches != 0:
        raise ValueError(f"batch {b} a dp rank not divisible by "
                         f"{n_microbatches} microbatches")
    lcfg = shard_config(cfg, mesh)
    pp = axis_of(mesh, "pp")
    x = copy_to(_embed(params, lcfg, local), pp)           # [b, T, D]
    mb = b // n_microbatches
    positions = torch.arange(T, device=local.device).expand(mb, T)

    def stage_fn(layers, h):
        for l in range(next(iter(layers.values())).shape[0]):
            layer = {name: w[l] for name, w in layers.items()}
            h = h + _attention_block_nocache(h, layer, positions, lcfg)
            h = h + _ffn_block(h, layer, lcfg)
        return h

    out = gpipe(stage_fn, params["layers"],
                x.reshape(n_microbatches, mb, T, x.shape[-1]), pp)
    x = out.reshape(b, T, -1).to(x.dtype)
    x = rms_norm(x, params["final_norm"], lcfg.rms_eps)
    return _head(x, params, lcfg)

"""The collectives the port issues itself, over one mesh axis.

JAX inserts the tensor-parallel collectives from sharding annotations
(XLA's SPMD partitioner) and runs the sequence-parallel ones inside
``shard_map`` (``jax.lax.psum``, ``ppermute``, ``all_to_all``). The port
has no partitioner: each rank is a process that runs its own block of the
program, so every collective is written out, here, on a
``torch.distributed`` process group.

- ``Axis``: one mesh axis as the model functions take it (name, group,
  size, this rank's index). It rides on a config (models/llama.ShardConfig)
  and copies as itself, so ``dataclasses.asdict``/``replace`` of a config
  keep it.
- ``all_reduce`` (sum or max, in place) and ``all_gather`` (the pieces
  concatenated on one dim, the last by default): the Megatron collectives
  of the forward, issued on the current stream, so that they are captured
  into a CUDA graph with the program around them (tpu/executor.py). They
  are
  forward only: the sharded training step and its conjugate backward
  collectives wait in ROADMAP A14b.
- ``ppermute`` and ``all_to_all``: the sequence-parallel exchanges, each an
  ``autograd.Function`` whose backward is the inverse exchange
  (``jax.lax.ppermute``'s transpose is the inverse permutation, and a tiled
  ``all_to_all``'s is the all-to-all with the two axes swapped), so ring
  and Ulysses attention are differentiable as the reference's are.

``COUNTS`` counts the host calls of each collective. A captured graph
replays what its capture issued, so the calls made while one program runs
eagerly are the collectives of each of its replays (``counting``).
"""

from __future__ import annotations

import collections
import contextlib

import torch
import torch.distributed as dist

# host calls per collective kind, since the last counting() or reset
COUNTS: collections.Counter = collections.Counter()


class Axis:
    """One mesh axis: `group` (a process group), its `size` and this
    rank's `rank` in it."""

    __slots__ = ("name", "group", "size", "rank")

    def __init__(self, name: str, group, size: int, rank: int):
        self.name = name
        self.group = group
        self.size = int(size)
        self.rank = int(rank)

    def __deepcopy__(self, memo):
        return self

    def __repr__(self) -> str:
        return f"Axis({self.name!r}, size={self.size}, rank={self.rank})"


@contextlib.contextmanager
def counting():
    """COUNTS zeroed on entry; read it inside or after the block."""
    COUNTS.clear()
    yield COUNTS


def all_reduce(x: torch.Tensor, axis: Axis, op: str = "sum") -> torch.Tensor:
    """x summed (or its max taken) over `axis`, in place; returns x."""
    COUNTS["all_reduce"] += 1
    dist.all_reduce(x, op=dist.ReduceOp.MAX if op == "max"
                    else dist.ReduceOp.SUM, group=axis.group)
    return x


def all_gather(x: torch.Tensor, axis: Axis, dim: int = -1) -> torch.Tensor:
    """The ranks' x concatenated on `dim` in rank order."""
    COUNTS["all_gather"] += 1
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(axis.size)]
    dist.all_gather(parts, x, group=axis.group)
    return torch.cat(parts, dim=dim)


def _global(axis: Axis, index: int) -> int:
    return dist.get_global_rank(axis.group, index)


def _shift(x: torch.Tensor, axis: Axis, shift: int) -> torch.Tensor:
    """x sent to index (rank + shift) % size; the block of index
    (rank - shift) % size received."""
    COUNTS["ppermute"] += 1
    x = x.contiguous()
    out = torch.empty_like(x)
    n, r = axis.size, axis.rank
    if n == 1:
        return out.copy_(x)
    ops = [dist.P2POp(dist.isend, x, _global(axis, (r + shift) % n),
                      group=axis.group),
           dist.P2POp(dist.irecv, out, _global(axis, (r - shift) % n),
                      group=axis.group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return out


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, shift):
        ctx.axis, ctx.shift = axis, shift
        return _shift(x, axis, shift)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.axis, -ctx.shift), None, None


def ppermute(x: torch.Tensor, axis: Axis, shift: int = 1) -> torch.Tensor:
    """jax.lax.ppermute with perm [(i, (i + shift) % size)]: every rank's x
    moves `shift` places around the ring. Differentiable."""
    return _PPermute.apply(x, axis, shift)


def _a2a(x: torch.Tensor, axis: Axis, split_dim: int,
         concat_dim: int) -> torch.Tensor:
    COUNTS["all_to_all"] += 1
    inp = torch.stack(torch.tensor_split(x, axis.size, dim=split_dim))
    out = torch.empty_like(inp)
    dist.all_to_all_single(out, inp.contiguous(), group=axis.group)
    return torch.cat(out.unbind(0), dim=concat_dim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, split_dim, concat_dim):
        ctx.args = (axis, split_dim, concat_dim)
        return _a2a(x, axis, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        axis, split_dim, concat_dim = ctx.args
        return _a2a(g, axis, concat_dim, split_dim), None, None, None


def all_to_all(x: torch.Tensor, axis: Axis, split_dim: int,
               concat_dim: int) -> torch.Tensor:
    """jax.lax.all_to_all(tiled=True): x split into size blocks on
    split_dim, block j sent to index j, the blocks received concatenated on
    concat_dim in index order. Differentiable."""
    return _AllToAll.apply(x, axis, split_dim, concat_dim)

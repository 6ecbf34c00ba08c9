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
  are forward only: serving runs under ``no_grad`` and captures them.
- The conjugate pairs of the training step (Megatron's f and g), each an
  ``autograd.Function`` whose collectives are issued on the current stream
  too. The reference gets them from XLA's partitioner, which transposes
  every collective it inserts; models/llama.py, models/moe.py,
  parallel/longcontext.py and parallel/pipeline.py call them at every
  site. With grad disabled (serving, and every graph it captures) each
  falls back to the forward-only collective above (``copy_to`` to x
  itself), so the serving forward issues, and counts, exactly the
  all-reduces and all-gathers it issued before:

  - ``copy_to``: identity forward, sum all-reduce backward (the input of a
    column-parallel product, replicated over the axis, whose gradient is
    partial on each rank);
  - ``reduce_from``: sum all-reduce forward, identity backward (a
    row-parallel product's partial sums, or a sum over the data axes whose
    gradient each rank takes for its own share);
  - ``gather_from``: all-gather on a dim forward; backward this rank's
    slice (``grad="slice"``: the column-parallel ``lm_head``, whose
    consumer is replicated over the axis) or a sum reduce-scatter
    (``grad="sum"``: the sequence-parallel K/V gather, where every rank's
    queries read every rank's keys);
  - ``replicate_from``: the reference's ``psum(where(rank == src, x, 0))``
    that ends ``gpipe``: the forward broadcasts src's x (the same sum: the
    other ranks add zeros), the backward keeps the gradient on src alone
    (the consumer is replicated over the axis, so its gradient is the
    same on every rank and src's x is the one that reached it).
- ``ppermute`` and ``all_to_all``: the sequence-parallel exchanges, each an
  ``autograd.Function`` whose backward is the inverse exchange
  (``jax.lax.ppermute``'s transpose is the inverse permutation, and a tiled
  ``all_to_all``'s is the all-to-all with the two axes swapped), so ring
  and Ulysses attention are differentiable as the reference's are.

``COUNTS`` counts the host calls of each collective, and the applies of
each conjugate with grad enabled (``copy_to``, ``reduce_from``,
``gather_from``, ``replicate_from``); a conjugate's collective counts under
its own name
(``all_reduce``, ``all_gather``, ``reduce_scatter``, ``broadcast``) when it
is issued, in the forward or the backward. A captured graph
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


# -- the conjugate pairs of the training step (the module docstring) ---------

def _summed(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """A new tensor: x summed over `axis`."""
    return all_reduce(x.clone(memory_format=torch.contiguous_format), axis)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _summed(g, ctx.axis), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return _summed(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


def _reduce_scatter(g: torch.Tensor, axis: Axis, dim: int) -> torch.Tensor:
    """g summed over `axis`, then this rank's block of `dim`."""
    COUNTS["reduce_scatter"] += 1
    g = g.movedim(dim, 0).contiguous()
    out = torch.empty((g.shape[0] // axis.size, *g.shape[1:]),
                      dtype=g.dtype, device=g.device)
    dist.reduce_scatter_tensor(out, g, group=axis.group)
    return out.movedim(0, dim)


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim, grad):
        ctx.args = (axis, dim % x.dim(), x.shape[dim % x.dim()], grad)
        return all_gather(x, axis, dim=dim)

    @staticmethod
    def backward(ctx, g):
        axis, dim, n, grad = ctx.args
        if grad == "slice":
            return g.narrow(dim, axis.rank * n, n), None, None, None
        return _reduce_scatter(g, axis, dim), None, None, None


class _ReplicateFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, src):
        ctx.keep = axis.rank == src
        COUNTS["broadcast"] += 1
        out = (x.clone(memory_format=torch.contiguous_format) if ctx.keep
               else torch.empty_like(x, memory_format=torch.contiguous_format))
        dist.broadcast(out, _global(axis, src), group=axis.group)
        return out

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.keep else torch.zeros_like(g)), None, None


def copy_to(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Identity forward; the gradient summed over `axis` (Megatron's f).
    With grad disabled, x itself."""
    if not torch.is_grad_enabled():
        return x
    COUNTS["copy_to"] += 1
    return _CopyTo.apply(x, axis)


def reduce_from(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """x summed over `axis` (a new tensor); the gradient passed through
    as it is (Megatron's g). With grad disabled, all_reduce: x summed in
    place."""
    if not torch.is_grad_enabled():
        return all_reduce(x, axis)
    COUNTS["reduce_from"] += 1
    return _ReduceFrom.apply(x, axis)


def gather_from(x: torch.Tensor, axis: Axis, dim: int = -1,
                grad: str = "slice") -> torch.Tensor:
    """The ranks' x concatenated on `dim` in rank order; the gradient is
    this rank's slice of the output's (grad="slice") or the output's
    summed over `axis`, then sliced (grad="sum", a reduce-scatter). With
    grad disabled, all_gather."""
    if grad not in ("slice", "sum"):
        raise ValueError(f"grad must be slice or sum, got {grad!r}")
    if not torch.is_grad_enabled():
        return all_gather(x, axis, dim=dim)
    COUNTS["gather_from"] += 1
    return _GatherFrom.apply(x, axis, dim, grad)


def replicate_from(x: torch.Tensor, axis: Axis, src: int) -> torch.Tensor:
    """The reference's psum(where(rank == src, x, 0)) over `axis`: src's x
    on every rank; the gradient kept on src, zero elsewhere (the module
    docstring)."""
    if torch.is_grad_enabled():
        COUNTS["replicate_from"] += 1
    return _ReplicateFrom.apply(x, axis, src)

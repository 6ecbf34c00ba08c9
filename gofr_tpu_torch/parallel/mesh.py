"""Mesh construction: named axes over the job's processes.

Ports from ``gofr_tpu/parallel/mesh.py``: ``AXES`` (the reference's order:
"tp" innermost, then "sp", "pp", "dp" outermost; "ep" last), ``MeshPlan``
with ``factorize`` (copied), and ``make_mesh``, which here builds a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the process
group instead of a ``jax.sharding.Mesh`` over devices. JAX has one
controller for the whole mesh; PyTorch runs one process per card, so the
mesh's "devices" are the job's ranks, rank r on its own card (``cuda:r``
of its host) or, on the CPU, a process of a gloo job. All five axes are
always present (size-1 axes too), so the sharding rules can name any axis
whatever the deployed topology; each axis's process group is
``mesh.get_group(axis)``, and ``axis_of`` wraps one for the model
functions (parallel/collectives.py).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

AXES = ("dp", "pp", "sp", "tp", "ep")


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    dp: int = 1
    pp: int = 1
    sp: int = 1
    tp: int = 1
    ep: int = 1

    @property
    def n_devices(self) -> int:
        return self.dp * self.pp * self.sp * self.tp * self.ep

    def axis_sizes(self) -> Dict[str, int]:
        return {"dp": self.dp, "pp": self.pp, "sp": self.sp, "tp": self.tp,
                "ep": self.ep}

    @classmethod
    def factorize(cls, n: int, prefer=("tp", "sp", "dp")) -> "MeshPlan":
        """Split n devices over the preferred axes, powers of two first.

        Default preference matches single-model serving/training: fill tp
        (fastest links, per-layer collectives), then sp (long context), then
        dp. E.g. 8 -> tp=2, sp=2, dp=2; 4 -> tp=2, sp=2; 2 -> tp=2.
        """
        sizes = {axis: 1 for axis in AXES}
        remaining = n
        idx = 0
        while remaining > 1:
            axis = prefer[idx % len(prefer)]
            if remaining % 2 == 0:
                sizes[axis] *= 2
                remaining //= 2
            else:
                sizes[axis] *= remaining  # odd leftover goes to current axis
                remaining = 1
            idx += 1
        return cls(**sizes)


def make_mesh(plan: Optional[MeshPlan] = None, device=None,
              **axis_sizes: int):
    """A DeviceMesh for `plan` (or explicit axis sizes) over every rank of
    the initialized process group (parallel/multihost.py joins it), in
    AXES order. device: the ranks' device type, None = the card ("cuda",
    the job's NCCL group); "cpu" for a gloo job. Raises ValueError when
    the plan does not cover exactly the world."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from ..tpu.device import resolve_device

    if plan is None:
        plan = MeshPlan(**{k: int(v) for k, v in axis_sizes.items()})
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("no process group: join the job first "
                           "(parallel.multihost.initialize_from_config)")
    world = dist.get_world_size()
    if plan.n_devices != world:
        raise ValueError(f"plan {plan} needs {plan.n_devices} devices, "
                         f"have {world}")
    dev = resolve_device(device)
    shape = tuple(plan.axis_sizes()[a] for a in AXES)
    return init_device_mesh(dev.type, shape, mesh_dim_names=AXES)


def axis_size(mesh, axis: str) -> int:
    """The size of `axis` in `mesh` (1 when mesh is None)."""
    if mesh is None:
        return 1
    return mesh.size(AXES.index(axis))


def axis_of(mesh, axis: str):
    """`axis` of `mesh` as the model functions take it
    (collectives.Axis: its group, its size and this rank's index)."""
    from .collectives import Axis

    return Axis(axis, mesh.get_group(axis), axis_size(mesh, axis),
                mesh.get_local_rank(axis))

"""Multi-process launch: one process per card, joined through a TCPStore.

Ports from ``gofr_tpu/parallel/multihost.py``: ``MultiHostSpec`` (reading
the same keys, so one env file configures both packages),
``initialize_from_config``, ``global_mesh`` and ``process_local_batch``.

Config keys (configs/.env):
  JAX_COORDINATOR_ADDR       host:port of process 0 (required to enable):
                             rank 0 serves the job's TCPStore there
  JAX_NUM_PROCESSES          world size
  JAX_PROCESS_ID             this process's rank
  JAX_LOCAL_DEVICE_IDS       optional comma list: this process's card is
                             the first id (default: rank modulo the cards
                             visible)
  JAX_COORDINATOR_TIMEOUT_S  optional bound on the rendezvous (default
                             300 s): a bad coordinator address fails boot
                             LOUDLY after this many seconds instead of
                             hanging

Where JAX joins one controller per host to a coordination service and then
sees every device of the job, PyTorch joins one process per card to a
process group: ``initialize_from_config`` starts (rank 0) or reaches the
``TCPStore`` at the coordinator, then ``init_process_group`` over it, NCCL
on the card (``cuda:<local id>`` made current before the first CUDA call,
and bound to the group, which creates the communicator at once) or gloo
when the caller asks for ``device="cpu"``. The store stays open for the
admission plane's waves (tpu/admission.StoreKV, ``job_store()``), as the
reference's plane rides its coordination service.

Single-process use needs none of these: ``initialize_from_config`` is a
no-op without JAX_COORDINATOR_ADDR.
"""

from __future__ import annotations

import dataclasses
import datetime
from typing import List, Optional

_DEFAULT_TIMEOUT_S = 300.0
# the job's TCPStore once joined (job_store)
_JOB = {"store": None}


@dataclasses.dataclass(frozen=True)
class MultiHostSpec:
    coordinator: str
    num_processes: int
    process_id: int
    local_device_ids: Optional[List[int]] = None
    timeout_s: Optional[float] = None

    @classmethod
    def from_config(cls, config) -> Optional["MultiHostSpec"]:
        """Parse the JAX_* keys; None when multi-host is not configured."""
        coordinator = config.get_or_default("JAX_COORDINATOR_ADDR", "")
        if not coordinator:
            return None
        num = int(config.get_or_default("JAX_NUM_PROCESSES", "1"))
        pid = int(config.get_or_default("JAX_PROCESS_ID", "0"))
        if not 0 <= pid < num:
            raise ValueError(f"JAX_PROCESS_ID {pid} out of range for "
                             f"JAX_NUM_PROCESSES {num}")
        raw_ids = config.get_or_default("JAX_LOCAL_DEVICE_IDS", "")
        ids = [int(x) for x in raw_ids.split(",") if x.strip()] or None
        raw_timeout = config.get_or_default("JAX_COORDINATOR_TIMEOUT_S", "")
        timeout = float(raw_timeout) if raw_timeout else None
        return cls(coordinator=coordinator, num_processes=num,
                   process_id=pid, local_device_ids=ids, timeout_s=timeout)

    def host_port(self):
        host, _, port = self.coordinator.rpartition(":")
        if not host or not port.isdigit():
            raise ValueError(f"JAX_COORDINATOR_ADDR {self.coordinator!r} "
                             f"is not host:port")
        return host, int(port)


def join(spec: MultiHostSpec, device=None, logger=None,
         backend: Optional[str] = None):
    """Join the job `spec` describes: the TCPStore (served by rank 0),
    then the default process group over it. device None = the card
    (NCCL; raises without one), "cpu" = gloo. backend "gloo" on the card:
    a job that runs no collective on its cards (the batcher servers'),
    whose ranks may then share one card (NCCL refuses two ranks on one).
    Returns the card (torch.device) this rank uses, or cpu."""
    import torch
    import torch.distributed as dist

    host, port = spec.host_port()
    timeout = datetime.timedelta(seconds=spec.timeout_s
                                 or _DEFAULT_TIMEOUT_S)
    cpu = device is not None and torch.device(device).type == "cpu"
    if cpu:
        dev = torch.device("cpu")
    else:
        from ..tpu.device import resolve_device

        resolve_device(None)   # raises without a card
        local = (spec.local_device_ids[0] if spec.local_device_ids
                 else spec.process_id % torch.cuda.device_count())
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
    store = dist.TCPStore(host, port, spec.num_processes,
                          is_master=spec.process_id == 0, timeout=timeout,
                          wait_for_workers=False)
    backend = backend or ("gloo" if cpu else "nccl")
    kw = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, store=store,
                            rank=spec.process_id,
                            world_size=spec.num_processes, timeout=timeout,
                            **kw)
    _JOB["store"] = store
    if logger is not None:
        logger.infof("joined multi-process job: rank %d/%d via %s (%s)",
                     spec.process_id, spec.num_processes, spec.coordinator,
                     f"{backend} on {dev}")
    return dev


def initialize_from_config(config, logger=None,
                           device=None) -> Optional[MultiHostSpec]:
    """Join the job if configured; otherwise no-op.

    Must run before the first CUDA call (the container calls it when the
    config names a coordinator). Returns the spec when the job was joined.
    device: None = the card (NCCL), "cpu" = gloo."""
    spec = MultiHostSpec.from_config(config)
    if spec is None:
        return None
    join(spec, device=device, logger=logger)
    return spec


def leave() -> None:
    """Leave the job joined here: the default process group destroyed and
    the store dropped (a later join starts a new job)."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
    _JOB["store"] = None


def job_store():
    """The TCPStore of the job joined here, or None."""
    return _JOB["store"]


def global_mesh(plan=None, device=None, **axis_sizes):
    """A mesh over ALL processes of the job (every rank is one device).
    Axis order puts dp outermost, as the reference's, so the data-parallel
    gradient all-reduce is the collective that crosses hosts; tp and sp
    stay inside a host's NVLink domain when the factorization allows."""
    from .mesh import MeshPlan, make_mesh

    if plan is None and not axis_sizes:  # everything else is make_mesh's job
        import torch.distributed as dist

        plan = MeshPlan.factorize(dist.get_world_size())
    return make_mesh(plan, device=device, **axis_sizes)


def process_local_batch(global_batch, mesh, spec=None):
    """This rank's own rows of `global_batch` (a numpy array or tensor):
    its block under `spec` (default batch_spec(): batch over dp, sequence
    over sp), as a tensor. The reference stitches every host's rows into
    one global array; here each process keeps only what it computes on,
    and the ranks' blocks together tile the global batch."""
    import numpy as np
    import torch

    from .sharding import batch_spec, local_block

    t = (torch.from_numpy(np.ascontiguousarray(global_batch))
         if isinstance(global_batch, np.ndarray) else global_batch)
    return local_block(t, mesh, spec if spec is not None else batch_spec())

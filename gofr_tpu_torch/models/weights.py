"""Weight bridge: numpy params trees into the port's tensors.

Counterpart of ``gofr_tpu/models/weights.py`` for the one path the port
needs now: carrying the JAX package's params across. ``jax.device_get`` of
a ``llama_init`` tree gives numpy leaves (bf16 as ml_dtypes' ``bfloat16``),
and ``params_from_numpy`` turns them into torch tensors, one copy per leaf —
the two trees share their layout by construction. Every parity test uses
it. Loading HF safetensors checkpoints is ROADMAP A13.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..tpu.device import resolve_device


def _leaf(a, device: torch.device, dtype) -> torch.Tensor:
    # torch wraps numpy memory without copying and needs it writable;
    # jax.device_get hands out read-only views
    a = np.require(a, requirements=["C", "W"])
    if a.dtype.name == "bfloat16":
        # numpy has no native bf16: reinterpret the 16-bit payload
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    if dtype is not None:
        t = t.to(dtype)
    return t.to(device)


def params_from_numpy(tree: Any, device=None, dtype=None) -> Any:
    """The same nested dict with every numpy leaf as a torch tensor on
    `device` (None = the CUDA card, as every entry point), cast to `dtype`
    when given."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, dev, dtype) for k, v in tree.items()}
    return _leaf(tree, dev, dtype)

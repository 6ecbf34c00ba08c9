"""MNIST-class MLP: the minimum end-to-end model.

Ports ``gofr_tpu/models/mlp.py``: ``MLPConfig`` (784 -> 512 -> 256 -> 10,
f32), ``mlp_init`` (the same recipe, normal * 1/sqrt(fan_in) weights and
zero biases, drawn from a ``torch.Generator``; it never tries to replay
``jax.random``) and ``mlp_forward``. The params tree keeps the reference's
layout, ``{"layers": [{"w": [in, out], "b": [out]}, ...]}``, so
``models.weights.params_from_numpy`` carries a JAX tree across as it is.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from ..tpu.device import resolve_device
from .llama import DTYPES, scaled_normal


@dataclasses.dataclass(frozen=True)
class MLPConfig:
    in_dim: int = 784
    hidden_dims: Tuple[int, ...] = (512, 256)
    out_dim: int = 10
    dtype: str = "float32"


def mlp_init(cfg: MLPConfig, seed: int = 0, device=None) -> Dict[str, Any]:
    """Random-init params on `device` (None = the CUDA card)."""
    dev = resolve_device(device)
    dtype = DTYPES[cfg.dtype]
    dims = (cfg.in_dim,) + tuple(cfg.hidden_dims) + (cfg.out_dim,)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    init = scaled_normal(gen, dtype, dev)
    return {"layers": [
        {"w": init((dims[i], dims[i + 1]), dims[i]),
         "b": torch.zeros((dims[i + 1],), dtype=dtype, device=dev)}
        for i in range(len(dims) - 1)]}


def mlp_forward(params, x):
    """x: [B, in_dim] -> logits [B, out_dim] f32."""
    layers = params["layers"]
    for layer in layers[:-1]:
        x = torch.relu(x @ layer["w"] + layer["b"])
    last = layers[-1]
    return (x @ last["w"] + last["b"]).float()

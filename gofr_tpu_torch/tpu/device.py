"""Device resolution for the port: CUDA unless the caller asks for the CPU.

Counterpart of ``gofr_tpu/tpu/device.py`` (``TPUClient``, which enumerates
the JAX devices). The port has no device client yet; its entry points
resolve their device here, and there is no silent fallback to the CPU: with
no card and no explicit ``"cpu"``, resolution raises.
"""

from __future__ import annotations

import shutil
import subprocess
from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on.

    None means the CUDA card; ``"cpu"`` (the tests) must be asked for
    explicitly. Raises RuntimeError when CUDA is requested (or implied) and
    no card is visible — serving never drops to the CPU by itself."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible; pass device='cpu' to run the plain "
            "PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def card_info() -> str:
    """The card's name and power limit exactly as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them (one
    line per card). Raises RuntimeError when nvidia-smi is missing or
    fails: a measurement must name the card it ran on."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        raise RuntimeError("nvidia-smi not found")
    out = subprocess.run(
        [exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0 or not out.stdout.strip():
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip()

"""Device resolution for the port: CUDA unless the caller asks for the CPU.

Counterpart of ``gofr_tpu/tpu/device.py`` (``TPUClient``, which enumerates
the JAX devices). The port has no device client; its entry points resolve
their device here, and there is no silent fallback to the CPU: with no card
and no explicit ``"cpu"``, resolution raises.

``register_metrics`` is the part of ``TPUClient.register_metrics`` that the
serving engines record (tpu/engine.py), with the reference's names,
descriptions and buckets (``TTFT_BUCKETS``, ``TPOT_BUCKETS``,
``BATCH_BUCKETS``). The rest of the reference's list belongs to the planes
of ROADMAP A11 (step ledger, SLO, utilization, HBM, breaker) and registers
with them.
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


TTFT_BUCKETS = (0.01, 0.025, 0.05, 0.1, 0.15, 0.25, 0.5, 1, 2.5, 5, 10)
TPOT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 1)
BATCH_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256)

COUNTERS = (
    ("app_tpu_tokens_generated_total", "output tokens generated"),
    ("app_tpu_requests_total", "inference requests admitted"),
    ("app_tpu_spec_drafted_total", "speculative draft tokens proposed"),
    ("app_tpu_spec_accepted_total", "speculative draft tokens accepted"),
    ("app_obs_dropped_metrics_total",
     "metric recordings swallowed by best-effort hooks, by metric "
     "name (a non-zero series is a wiring bug)"),
)
GAUGES = (
    ("app_tpu_queue_depth", "requests waiting for batch assembly"),
    ("app_tpu_active_slots", "occupied continuous-batching slots"),
)
HISTOGRAMS = (
    ("app_tpu_ttft_seconds", "time to first token", TTFT_BUCKETS),
    ("app_tpu_queue_wait_seconds", "submit-to-admission wait", TTFT_BUCKETS),
    ("app_tpu_tpot_seconds", "time per output token", TPOT_BUCKETS),
    ("app_tpu_batch_size", "assembled batch sizes", BATCH_BUCKETS),
    ("app_tpu_execute_seconds", "device execution wall time", TPOT_BUCKETS),
)


def register_metrics(manager) -> None:
    """Register the serving engines' metric set on `manager` (a
    metrics.Manager). Names already registered are left as they are, so
    every engine built on one manager can call it."""
    for name, desc in COUNTERS:
        if manager.get(name) is None:
            manager.new_counter(name, desc)
    for name, desc in GAUGES:
        if manager.get(name) is None:
            manager.new_gauge(name, desc)
    for name, desc, buckets in HISTOGRAMS:
        if manager.get(name) is None:
            manager.new_histogram(name, desc, buckets)


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

"""Device resolution for the port: CUDA unless the caller asks for the CPU.

Counterpart of ``gofr_tpu/tpu/device.py`` (``TPUClient``, which enumerates
the JAX devices). The port has no device client; its entry points resolve
their device here, and there is no silent fallback to the CPU: with no card
and no explicit ``"cpu"``, resolution raises.

``register_metrics`` is the part of ``TPUClient.register_metrics`` that the
port records, with the reference's names, descriptions and buckets
(``TTFT_BUCKETS``, ``TPOT_BUCKETS``, ``BATCH_BUCKETS`` and the step
ledger's ``STEP_SECONDS_BUCKETS``): the engines' series, the executor's
capture counters, the page pool's, the step ledger's, the card memory's,
the stall gauge, the SLO goodput and the utilization gauges, the reset,
replay, quarantine and breaker series of crash-only serving, and the
incident, burn-rate and alert series of the incident plane.
``app_tpu_compile_disk_hits`` is registered and stays 0: a CUDA graph is
captured per process and has no disk cache.

``device_memory_stats`` / ``refresh_memory_metrics`` are the reference's
``TPUClient.memory_stats`` / ``refresh_memory_metrics`` for one card:
``torch.cuda.memory_reserved`` (what the caching allocator holds, the CUDA
graph pools included) as in use and ``torch.cuda.mem_get_info``'s total as
the limit; nothing on the CPU.
"""

from __future__ import annotations

import shutil
import subprocess
from typing import Any, Dict, List, Optional, Union

import torch

from .stepledger import STEP_SECONDS_BUCKETS


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
    ("app_tpu_compile_total", "XLA compilations performed"),
    ("app_tpu_compile_cache_hits", "executor compile-cache hits"),
    # stays 0: a CUDA graph is captured per process, never loaded from disk
    ("app_tpu_compile_disk_hits", "programs loaded from the disk cache"),
    ("app_tpu_execute_total", "device executions dispatched"),
    ("app_tpu_tokens_generated_total", "output tokens generated"),
    ("app_tpu_requests_total", "inference requests admitted"),
    ("app_tpu_spec_drafted_total", "speculative draft tokens proposed"),
    ("app_tpu_spec_accepted_total", "speculative draft tokens accepted"),
    ("app_tpu_page_waits_total", "admissions deferred on page-pool exhaustion"),
    # crash-only recovery (tpu/faults.py and the engine's replay)
    ("app_tpu_device_resets_total",
     "device-state resets after a failed donated-cache program"),
    ("app_tpu_request_replays_total",
     "interrupted requests requeued for replay after a device reset"),
    ("app_tpu_replayed_tokens_total",
     "already-delivered tokens re-prefilled by replay admissions"),
    ("app_tpu_requests_quarantined_total",
     "poison requests failed after repeatedly reset-looping the engine"),
    ("app_tpu_step_stragglers_total",
     "engine steps flagged slower than the rolling per-phase "
     "baseline, by dominant-segment cause"),
    # the incident plane (tpu/incidents.py)
    ("app_tpu_incidents_total",
     "incident evidence bundles captured, by trigger"),
    ("app_tpu_incidents_suppressed_total",
     "incident triggers suppressed by the capture rate limit "
     "(cooldown / max-per-hour), by trigger"),
    ("app_obs_dropped_metrics_total",
     "metric recordings swallowed by best-effort hooks, by metric "
     "name (a non-zero series is a wiring bug)"),
)
GAUGES = (
    ("app_tpu_queue_depth", "requests waiting for batch assembly"),
    ("app_tpu_active_slots", "occupied continuous-batching slots"),
    ("app_tpu_hbm_bytes_used", "HBM bytes in use per device"),
    ("app_tpu_hbm_bytes_limit", "HBM bytes available per device"),
    ("app_tpu_tokens_per_second", "rolling decode throughput"),
    ("app_tpu_pages_used", "KV pool pages currently owned by slots"),
    ("app_tpu_engine_stall_seconds",
     "seconds the engine loop has been stuck inside one device "
     "call (0 = healthy); scrape-time, set by a container scrape "
     "hook because a wedged loop cannot push its own metric"),
    ("app_tpu_slo_ttft_goodput",
     "fraction of recent requests meeting the TTFT target "
     "(flight recorder rolling window)"),
    ("app_tpu_slo_tpot_goodput",
     "fraction of recent requests meeting the TPOT target "
     "(flight recorder rolling window)"),
    ("app_tpu_slo_burn_rate",
     "SLO error-budget burn rate (error rate / budget) by slo "
     "and window (fast/slow)"),
    ("app_tpu_slo_alert_state",
     "SLO alert state by slo: 0 ok, 1 warn, 2 page "
     "(both-windows burn rule)"),
    ("app_tpu_device_duty_cycle",
     "fraction of the rolling window the device spent executing "
     "dispatched programs"),
    ("app_tpu_host_overhead_seconds",
     "host/scheduler seconds (admission, prep, demux) in the rolling "
     "utilization window"),
    ("app_tpu_mfu",
     "model FLOPs utilization vs the platform peak, by phase"),
    ("app_tpu_mbu",
     "HBM bandwidth utilization vs the platform peak, by phase"),
    ("app_tpu_hbm_bytes", "HBM bytes per device (kind=in_use|limit)"),
    ("app_tpu_kv_pool_pages", "KV page-pool occupancy (kind=used|free)"),
    ("app_tpu_breaker_state",
     "reset-storm breaker state (0=closed, 1=half_open, 2=open)"),
)
HISTOGRAMS = (
    ("app_tpu_ttft_seconds", "time to first token", TTFT_BUCKETS),
    ("app_tpu_queue_wait_seconds", "submit-to-admission wait", TTFT_BUCKETS),
    ("app_tpu_tpot_seconds", "time per output token", TPOT_BUCKETS),
    ("app_tpu_batch_size", "assembled batch sizes", BATCH_BUCKETS),
    ("app_tpu_execute_seconds", "device execution wall time", TPOT_BUCKETS),
    ("app_tpu_step_seconds",
     "engine step time by phase and attributed segment",
     STEP_SECONDS_BUCKETS),
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


def device_memory_stats(device=None) -> List[Dict[str, Any]]:
    """[{"id", "kind", "bytes_in_use", "bytes_limit"}] for a CUDA `device`
    (the reference's ``TPUClient.memory_stats``, one card): in use is
    ``torch.cuda.memory_reserved``, the caching allocator's hold, CUDA
    graph pools included; the limit is the card's total memory. Empty for
    the CPU or None. Host-side reads only: no device round-trip."""
    if device is None:
        return []
    dev = torch.device(device)
    if dev.type != "cuda":
        return []
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    _free, total = torch.cuda.mem_get_info(index)
    return [{"id": index, "kind": torch.cuda.get_device_name(index),
             "bytes_in_use": torch.cuda.memory_reserved(index),
             "bytes_limit": total}]


def refresh_memory_metrics(metrics, device=None) -> None:
    """Set ``app_tpu_hbm_bytes_used`` / ``_limit`` and the kind-labelled
    ``app_tpu_hbm_bytes`` for `device` (the reference's scrape-time
    ``TPUClient.refresh_memory_metrics``)."""
    if metrics is None:
        return
    for s in device_memory_stats(device):
        dev = str(s["id"])
        metrics.set_gauge("app_tpu_hbm_bytes_used", s["bytes_in_use"],
                          device=dev)
        metrics.set_gauge("app_tpu_hbm_bytes_limit", s["bytes_limit"],
                          device=dev)
        metrics.set_gauge("app_tpu_hbm_bytes", s["bytes_in_use"],
                          device=dev, kind="in_use")
        metrics.set_gauge("app_tpu_hbm_bytes", s["bytes_limit"],
                          device=dev, kind="limit")


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

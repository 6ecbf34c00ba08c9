"""The port's device client and device resolution: CUDA unless the caller
asks for the CPU.

Counterpart of ``gofr_tpu/tpu/device.py``. ``CUDAClient`` is the twin of
``TPUClient``, the container's device datasource (the reference's injected
provider pattern: ``use_logger`` / ``use_metrics`` / ``connect``, or
``from_config``; ``App.add_tpu`` injects one, and the container builds one
under TPU_ENABLED or MODEL_NAME, as ``container.tpu`` and ``ctx.tpu``).
Where ``TPUClient`` holds the JAX devices of the whole slice, the port runs
one process per card, so a client holds this process's card: the joined
rank's under a multi-process job, else the current one (``cuda:0`` by
default), or the CPU when the caller asks for it (a ``device="cpu"``
argument, or ``TPU_PLATFORM=cpu`` in the config; with neither and no card,
``connect`` raises). It gives ``devices``, ``device_count``, ``platform``
("gpu" or "cpu", as JAX names them), ``mesh(axes)`` (a DeviceMesh over the
job's ranks, parallel/mesh.py, in place of the reference's
``jax.sharding.Mesh``), ``memory_stats`` / ``refresh_memory_metrics`` (the
app_tpu_hbm_* series), ``health_check`` (the reference's single-flight
probe with its timeout: a wedged device pins one probe thread, and health
answers DEGRADED meanwhile) and ``close``. Its probe is one one-element
launch and a synchronize of the probe's own stream, after the fault site
``device.health_probe``: it never synchronizes the device and takes no
lock of the executor's, so a probe during a CUDA graph capture (captures
run ``thread_local``, tpu/executor.py) spoils neither.

The engines still resolve their card themselves (``resolve_device``), and
there is no silent fallback to the CPU: with no card and no explicit
``"cpu"``, resolution raises.

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
import threading
import time
from typing import Any, Dict, List, Optional, Union

import torch

from ..datasource import Health, STATUS_DEGRADED, STATUS_DOWN, STATUS_UP
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


def requested_device(platform: str = "", device=None):
    """The device a caller asks for: `device` when given, else by
    `platform` (TPU_PLATFORM): "cpu" asks for the CPU; "", "gpu" or "cuda"
    for the card, None here. Raises ValueError on another platform."""
    if device is not None:
        return device
    name = (platform or "").strip().lower()
    if name == "cpu":
        return "cpu"
    if name in ("", "gpu", "cuda"):
        return None
    raise ValueError(f"TPU_PLATFORM must be cpu, gpu or cuda, got {name!r}")


class CUDAClient:
    """The container's device datasource: the twin of the reference's
    ``TPUClient`` for one card (the module docstring)."""

    # the device round-trip gets this long before the probe is declared
    # stuck; /health must answer even when the card does not (a class
    # attribute, so a deployment or a test tunes it per instance)
    HEALTH_PROBE_TIMEOUT_S = 3.0

    def __init__(self, config=None, device=None):
        self.config = config
        self.platform_override = (config.get_or_default("TPU_PLATFORM", "")
                                  if config is not None else "")
        self._device_arg = device
        self.logger = None
        self.metrics = None
        self._devices: List[torch.device] = []
        self._connected_at: Optional[float] = None
        # the single-flight probe (health_check); the lock guards its start
        # and its result, so two concurrent polls neither start two probes
        # nor reset a result another poll is about to read
        self._probe_lock = threading.Lock()
        self._probe_thread: Optional[threading.Thread] = None
        self._probe_result = None
        # (stream, one, out, pinned host) of the probe, made at its first run
        self._probe_state = None
        # the fault plane (tpu/faults.py): None unless chaos is armed
        self.faults = None

    # -- the provider pattern -------------------------------------------------
    def use_logger(self, logger) -> None:
        self.logger = logger

    def use_metrics(self, metrics) -> None:
        self.metrics = metrics

    def connect(self) -> None:
        """Resolve the card (or the CPU, when asked), register the app_tpu_*
        series on the metrics manager and log what was found. Raises
        without a card unless the CPU was asked for."""
        dev = resolve_device(requested_device(self.platform_override,
                                              self._device_arg))
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self._devices = [dev]
        self._connected_at = time.monotonic()
        if self.metrics is not None:
            register_metrics(self.metrics)
        if self.logger is not None:
            self.logger.infof("connected to %d %s device(s): %s",
                              len(self._devices), self.platform,
                              ", ".join(self._kinds()))

    @classmethod
    def from_config(cls, config, logger, metrics, device=None
                    ) -> "CUDAClient":
        client = cls(config, device=device)
        client.use_logger(logger)
        client.use_metrics(metrics)
        client.connect()
        return client

    # -- the device surface -----------------------------------------------------
    @property
    def devices(self) -> List[torch.device]:
        return self._devices

    @property
    def device(self) -> Optional[torch.device]:
        """This process's device (None before connect or after close)."""
        return self._devices[0] if self._devices else None

    @property
    def device_count(self) -> int:
        return len(self._devices)

    @property
    def platform(self) -> str:
        if not self._devices:
            return "none"
        return "gpu" if self._devices[0].type == "cuda" else "cpu"

    def _kinds(self) -> List[str]:
        return sorted({torch.cuda.get_device_name(d) if d.type == "cuda"
                       else "cpu" for d in self._devices})

    def mesh(self, axes: Dict[str, int]):
        """A DeviceMesh over the job's ranks (parallel/mesh.make_mesh, one
        rank per card) in place of the reference's jax.sharding.Mesh over
        devices. axes: {axis: size} over parallel.mesh.AXES; -1 for one
        axis infers it from the job's world. Raises ValueError when the
        sizes do not cover the world, RuntimeError before a job is joined
        (Container.join_job)."""
        import torch.distributed as dist

        from ..parallel.mesh import AXES, MeshPlan, make_mesh

        unknown = sorted(set(axes) - set(AXES))
        if unknown:
            raise ValueError(f"mesh axes {unknown} are not among {AXES}")
        world = dist.get_world_size() if dist.is_initialized() else 1
        sizes = dict(axes)
        if -1 in sizes.values():
            known = 1
            for size in sizes.values():
                if size != -1:
                    known *= size
            sizes[next(a for a, s in sizes.items() if s == -1)] = \
                world // known
        total = 1
        for size in sizes.values():
            total *= size
        if total != world:
            raise ValueError(f"mesh axes {sizes} need {total} ranks, the "
                             f"job has {world}")
        return make_mesh(MeshPlan(**sizes), device=self.device)

    def memory_stats(self) -> List[Dict[str, Any]]:
        """[{"id", "kind", "bytes_in_use", "bytes_limit"}] per device: the
        card's (device_memory_stats), or zeros for the CPU, as the
        reference reports a backend without stats."""
        out = []
        for d in self._devices:
            if d.type == "cuda":
                out.extend(device_memory_stats(d))
            else:
                out.append({"id": 0, "kind": "cpu", "bytes_in_use": 0,
                            "bytes_limit": 0})
        return out

    def refresh_memory_metrics(self) -> None:
        if self.metrics is None:
            return
        for s in self.memory_stats():
            dev = str(s["id"])
            self.metrics.set_gauge("app_tpu_hbm_bytes_used",
                                   s["bytes_in_use"], device=dev)
            self.metrics.set_gauge("app_tpu_hbm_bytes_limit",
                                   s["bytes_limit"], device=dev)
            self.metrics.set_gauge("app_tpu_hbm_bytes", s["bytes_in_use"],
                                   device=dev, kind="in_use")
            self.metrics.set_gauge("app_tpu_hbm_bytes", s["bytes_limit"],
                                   device=dev, kind="limit")

    # -- health (feeds /.well-known/health) -------------------------------------
    def _round_trip(self) -> bool:
        """One one-element launch and its result read back. On the card the
        launch, the copy and the synchronize are all on the probe's own
        stream (made, with its buffers, at the first probe): the device is
        never synchronized, and a capture on another stream goes on."""
        dev = self.device
        if dev.type != "cuda":
            return float(torch.ones(1) + 1.0) == 2.0
        with torch.cuda.device(dev):
            if self._probe_state is None:
                stream = torch.cuda.Stream(device=dev)
                with torch.cuda.stream(stream):
                    one = torch.ones(1, device=dev)
                    out = torch.empty(1, device=dev)
                host = torch.empty(1, pin_memory=True)
                self._probe_state = (stream, one, out, host)
            stream, one, out, host = self._probe_state
            with torch.cuda.stream(stream):
                torch.add(one, 1.0, out=out)
                host.copy_(out, non_blocking=True)
            stream.synchronize()
        return float(host[0]) == 2.0

    def _probe_device(self) -> None:
        """The device round-trip, on the single-flight probe thread: a
        card that stops answering pins this one daemon thread, not every
        health handler."""
        try:
            if self.faults is not None:  # chaos drills: wedge/fail the probe
                self.faults.hit("device.health_probe")
            ok = self._round_trip()
            self._probe_result = (STATUS_UP if ok else STATUS_DEGRADED, None)
        except Exception as exc:  # noqa: BLE001
            self._probe_result = (STATUS_DOWN, str(exc))

    def health_check(self) -> Health:
        if not self._devices:
            return Health(status=STATUS_DOWN, details={"error": "no devices"})
        # single-flight: while one probe is still blocked inside the
        # device, polls wait on it (and answer DEGRADED) instead of piling
        # up a stuck thread per poll
        with self._probe_lock:
            probe = self._probe_thread
            if probe is None or not probe.is_alive():
                self._probe_result = None
                probe = threading.Thread(target=self._probe_device,
                                         name="cuda-health-probe",
                                         daemon=True)
                self._probe_thread = probe
                probe.start()
        probe.join(timeout=self.HEALTH_PROBE_TIMEOUT_S)
        with self._probe_lock:
            result = self._probe_result
        if probe.is_alive() or result is None:
            return Health(status=STATUS_DEGRADED, details={
                "platform": self.platform,
                "error": f"device probe stuck for "
                         f">{self.HEALTH_PROBE_TIMEOUT_S:.0f}s "
                         f"(runtime not answering)",
            })
        status, err = result
        if status == STATUS_DOWN:
            return Health(status=STATUS_DOWN, details={"error": err})
        self.refresh_memory_metrics()
        return Health(status=status, details={
            "platform": self.platform,
            "devices": len(self._devices),
            "memory": self.memory_stats(),
            "uptime_s": round(time.monotonic() - (self._connected_at
                                                  or time.monotonic()), 1),
        })

    def close(self) -> None:
        self._devices = []
        self._probe_state = None

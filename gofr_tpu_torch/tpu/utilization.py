"""Utilization ledger: roofline telemetry for the serving engine.

A copy of ``gofr_tpu/tpu/utilization.py``, whole: ``prefill_flops``,
``decode_flops``, ``prefill_bytes``, ``decode_bytes`` (the analytic model,
equal to the reference's on the same config and counts),
``UtilizationLedger``, ``register_utilization_metrics``, ``MemorySampler``,
``engine_snapshot`` and ``install_routes`` (``GET /debug/engine``). What
changes is where the device facts come from:

  * **Peaks.** The engine names its card (platform ``"gpu"``, kind
    ``torch.cuda.get_device_name()``) and ``UtilizationLedger.peaks()``
    matches it against ``PEAK_TABLE``, which holds the one card the port
    is measured on (the H100 SXM part, ``NVIDIA H100 80GB HBM3``: 989e12
    dense bf16 FLOP/s, 3.35e12 B/s). Any other card, and the CPU, gets the reference's nominal
    placeholder with ``peak_source`` ``"default"``: no row is guessed. The
    reference's overrides ``TPU_PEAK_FLOPS`` / ``TPU_PEAK_HBM_BW`` are read
    from the process environment, as there.
  * **Memory.** ``MemorySampler`` reads ``torch.cuda.memory_reserved`` (what
    the caching allocator holds, the CUDA graph pools included) as in use
    and ``torch.cuda.mem_get_info``'s total as the limit
    (``tpu/device.device_memory_stats``), into
    ``app_tpu_hbm_bytes{device,kind=in_use|limit}``, plus the page pool's
    ``app_tpu_kv_pool_pages{kind=used|free}``.
  * **Programs.** ``engine_snapshot``'s ``compile`` table is the executor's
    (``Executor.compile_table``): per program its calls and capture seconds.

``engine_snapshot`` carries the reference's ``breaker`` (the reset-storm
breaker's snapshot), ``recovery`` (resets, replays, replayed tokens,
quarantines, retry budget) and, with a fault plane armed, ``faults``
sections, and the KV tier's stats under ``page_pool.kv_tier`` (with the
spilled and restored page counts); the memory sampler adds
``app_tpu_kv_tier_bytes{kind=used|capacity}`` and
``app_tpu_kv_tier_pages``, and a ledger of one pool of a disaggregated
pair (``pool``) ``app_tpu_disagg_pool_duty_cycle{pool}``.

Accounting conventions (host-side, O(1) per dispatch):

  * FLOPs count useful work only: 2·P per active row per decode step, so
    junk rows of a half-empty lock-step batch show as lost MFU. Prefill
    counts the admitted prompt tokens (a prefix-cache hit counts its whole
    prompt, a small overcount bounded by the shared pages).
  * A dispatch's device-busy interval runs from the dispatch stamp its
    in-flight entry carries to the host sync, unioned under a watermark so
    pipelined dispatches are never counted twice. The real card idles
    inside that interval wherever the host is late to enqueue, so the duty
    cycle is an upper bound on the card's busy share. Chunked prefills
    account at the final chunk's sync.
  * int8 KV scale reads and writes are left out of the byte model (<2% of
    the traffic at serving page sizes).
"""

from __future__ import annotations

import collections
import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from .capacity import kv_token_bytes, params_bytes
from .device import device_memory_stats
from .obs import MetricsHook

# per-card peak dense bf16 FLOP/s and memory bandwidth (bytes/s), matched
# against the card's name by lowercase substring. Public spec-sheet numbers
# of the one card the port is measured on; override per deployment with
# TPU_PEAK_FLOPS / TPU_PEAK_HBM_BW
PEAK_TABLE: Tuple[Tuple[str, Tuple[float, float]], ...] = (
    ("nvidia h100 80gb hbm3", (989e12, 3.35e12)),
)
# the CPU and unknown cards: a nominal placeholder so the plumbing (gauges,
# snapshot, tests) works everywhere; the absolute MFU is only meaningful on
# a card the table (or the env override) knows
DEFAULT_PEAKS = (1e12, 1e11)

PEAK_FLOPS_ENV = "TPU_PEAK_FLOPS"
PEAK_HBM_BW_ENV = "TPU_PEAK_HBM_BW"


def resolve_peaks(platform: Optional[str] = None,
                  device_kind: Optional[str] = None) -> Tuple[float, float, str]:
    """(peak_flops, peak_hbm_bw, source) per device. Env overrides win;
    then the card table; then the nominal placeholder."""
    env_flops = os.environ.get(PEAK_FLOPS_ENV)
    env_bw = os.environ.get(PEAK_HBM_BW_ENV)
    if env_flops or env_bw:
        table = _lookup_peaks(device_kind)
        return (float(env_flops) if env_flops else table[0],
                float(env_bw) if env_bw else table[1], "env")
    if platform and platform.lower() not in ("gpu",) and not device_kind:
        return (*DEFAULT_PEAKS, "default")
    flops, bw = _lookup_peaks(device_kind)
    if (flops, bw) == DEFAULT_PEAKS:
        return flops, bw, "default"
    return flops, bw, "table"


def _lookup_peaks(device_kind: Optional[str]) -> Tuple[float, float]:
    kind = (device_kind or "").lower()
    for needle, peaks in PEAK_TABLE:
        if needle in kind:
            return peaks
    return DEFAULT_PEAKS


# -- analytic roofline model (pure functions, hand-checkable) -----------------
def prefill_flops(cfg, tokens: int) -> float:
    """Forward-pass FLOPs for `tokens` prompt tokens: 2·P·T (the PaLM MFU
    convention: matmul MACs only, attention quadratic term excluded)."""
    return 2.0 * cfg.param_count() * tokens


def decode_flops(cfg, rows: int, steps: int) -> float:
    """A decode (or verify) dispatch computing `steps` positions for each
    of `rows` active sequences: 2·P per position."""
    return 2.0 * cfg.param_count() * rows * steps


def prefill_bytes(cfg, tokens: int,
                  params_nbytes: Optional[int] = None) -> float:
    """HBM traffic of one prefill dispatch: one weight read (prefill is
    compute-bound; weights stream once per dispatch) + the KV written for
    every prompt token."""
    weights = params_nbytes if params_nbytes else params_bytes(cfg)
    return float(weights) + float(tokens) * kv_token_bytes(cfg)


def decode_bytes(cfg, rows: int, steps: int, kv_tokens: int,
                 params_nbytes: Optional[int] = None) -> float:
    """HBM traffic of one decode dispatch: per step, the whole weight tree
    is read once (shared across the batch: THE reason batching wins) plus
    the live KV context (`kv_tokens` tokens across all rows) and one KV
    write per row."""
    weights = params_nbytes if params_nbytes else params_bytes(cfg)
    per_step = (float(weights)
                + float(kv_tokens) * kv_token_bytes(cfg)
                + float(rows) * kv_token_bytes(cfg))
    return float(steps) * per_step


class UtilizationLedger:
    """Rolling per-dispatch accounting window (see module docstring).

    All ``record_*`` / ``note_host`` calls are hot-path safe: one short
    lock, O(1) amortized work, failures swallowed at the metrics sink.
    platform / device_kind: ``"gpu"`` and the card's name as
    ``torch.cuda.get_device_name`` gives it, or ``"cpu"``."""

    def __init__(self, cfg=None, metrics=None, n_devices: int = 1,
                 params_nbytes: Optional[int] = None,
                 window_s: float = 60.0,
                 platform: Optional[str] = None,
                 device_kind: Optional[str] = None,
                 created_at: Optional[float] = None):
        self.cfg = cfg
        self.n_devices = max(1, int(n_devices))
        self.params_nbytes = params_nbytes
        self.window_s = float(window_s)
        self._platform = platform
        self._device_kind = device_kind
        self._peaks: Optional[Tuple[float, float, str]] = None
        self._lock = threading.Lock()
        # (synced_at, phase, flops, bytes, busy_s, sync_wait_s, tokens)
        self._entries: "collections.deque" = collections.deque()
        # (t, host_s): scheduler/prep/demux time noted by the engine loop
        self._host: "collections.deque" = collections.deque()
        self._busy_until = 0.0          # device-busy union watermark
        # MONOTONIC clock domain: the engine stamps dispatch/sync times
        # with time.monotonic() (an NTP step must not warp the busy
        # window), so the window's own "now" must come from the same clock
        self._created_at = (created_at if created_at is not None
                            else time.monotonic())
        self._obs = MetricsHook(metrics)
        self.dispatches_total = 0
        # one pool of a disaggregated pair (tpu/disagg.py): tags a per-pool
        # duty-cycle gauge so both halves show side by side
        self.pool = ""

    # -- wiring ---------------------------------------------------------------
    def use_metrics(self, metrics) -> None:
        if metrics is not None:
            self._obs = MetricsHook(metrics)

    def peaks(self) -> Tuple[float, float, str]:
        """Per-device (peak_flops, peak_hbm_bw, source), resolved once from
        the platform and card name the ledger was built with."""
        if self._peaks is None:
            self._peaks = resolve_peaks(self._platform, self._device_kind)
        return self._peaks

    # -- recording (engine sync path) -----------------------------------------
    def record_prefill(self, tokens: int, dispatched_at: float,
                       synced_at: float, sync_wait_s: float = 0.0) -> None:
        if self.cfg is None:
            return
        self._record("prefill", prefill_flops(self.cfg, tokens),
                     prefill_bytes(self.cfg, tokens, self.params_nbytes),
                     tokens, dispatched_at, synced_at, sync_wait_s)

    def record_decode(self, rows: int, steps: int, kv_tokens: int,
                      dispatched_at: float, synced_at: float,
                      sync_wait_s: float = 0.0) -> None:
        if self.cfg is None:
            return
        self._record("decode", decode_flops(self.cfg, rows, steps),
                     decode_bytes(self.cfg, rows, steps, kv_tokens,
                                  self.params_nbytes),
                     rows * steps, dispatched_at, synced_at, sync_wait_s)

    def _record(self, phase: str, flops: float, nbytes: float, tokens: int,
                dispatched_at: float, synced_at: float,
                sync_wait_s: float) -> None:
        with self._lock:
            busy = max(0.0, synced_at - max(dispatched_at, self._busy_until))
            self._busy_until = max(self._busy_until, synced_at)
            self._entries.append((synced_at, phase, flops, nbytes, busy,
                                  max(0.0, sync_wait_s), tokens))
            self.dispatches_total += 1
            self._prune(synced_at)
        self.publish(now=synced_at)

    def note_host(self, seconds: float, now: Optional[float] = None) -> None:
        """Host/scheduler overhead: time the engine loop spent in admission,
        host prep, and dispatch enqueues (never inside a device sync)."""
        if seconds <= 0.0:
            return
        with self._lock:
            t = now if now is not None else time.monotonic()
            self._host.append((t, seconds))
            self._prune(t)

    def _prune(self, now: float) -> None:
        cutoff = now - self.window_s
        while self._entries and self._entries[0][0] < cutoff:
            self._entries.popleft()
        while self._host and self._host[0][0] < cutoff:
            self._host.popleft()

    def device_slices(self) -> List[Dict[str, Any]]:
        """The window's dispatch→sync busy intervals as drawable slices,
        oldest first, for the timeline exporter's async device track
        (tpu/timeline.py). The busy-union watermark already made the
        intervals non-overlapping: each entry's busy time starts where
        the previous sync (or its own dispatch) ended."""
        with self._lock:
            entries = list(self._entries)
        return [{"start": synced - busy, "end": synced, "phase": phase,
                 "tokens": toks, "busy_s": busy, "sync_wait_s": wait}
                for synced, phase, _flops, _nbytes, busy, wait, toks
                in entries if busy > 0.0]

    # -- rolling window read-out ----------------------------------------------
    def window_stats(self, now: Optional[float] = None) -> Dict[str, Any]:
        now = now if now is not None else time.monotonic()
        peak_flops, peak_bw, peak_source = self.peaks()
        agg_flops = {"prefill": 0.0, "decode": 0.0}
        agg_bytes = {"prefill": 0.0, "decode": 0.0}
        tokens = {"prefill": 0, "decode": 0}
        with self._lock:
            self._prune(now)
            busy = sync_wait = 0.0
            for _, phase, flops, nbytes, busy_s, wait_s, toks in self._entries:
                agg_flops[phase] += flops
                agg_bytes[phase] += nbytes
                tokens[phase] += toks
                busy += busy_s
                sync_wait += wait_s
            host = sum(h for _, h in self._host)
            dispatches = len(self._entries)
        span = max(1e-9, min(self.window_s, now - self._created_at))
        flops_cap = peak_flops * self.n_devices * span
        bytes_cap = peak_bw * self.n_devices * span
        total_flops = sum(agg_flops.values())
        total_bytes = sum(agg_bytes.values())
        return {
            "window_s": round(span, 3),
            "dispatches": dispatches,
            "device_busy_s": round(busy, 6),
            "duty_cycle": round(min(1.0, busy / span), 6),
            "host_overhead_s": round(host, 6),
            "sync_wait_s": round(sync_wait, 6),
            "tokens": dict(tokens),
            "mfu": {
                "prefill": agg_flops["prefill"] / flops_cap,
                "decode": agg_flops["decode"] / flops_cap,
                "total": total_flops / flops_cap,
            },
            "mbu": {
                "prefill": agg_bytes["prefill"] / bytes_cap,
                "decode": agg_bytes["decode"] / bytes_cap,
                "total": total_bytes / bytes_cap,
            },
            "peak_flops": peak_flops,
            "peak_hbm_bw": peak_bw,
            "peak_source": peak_source,
            "n_devices": self.n_devices,
        }

    def publish(self, now: Optional[float] = None) -> None:
        """Recompute the window and push the gauges. Called after every
        recorded dispatch and from the container's metrics-scrape hook (so
        an idle engine decays toward zero instead of freezing stale)."""
        stats = self.window_stats(now=now)
        self._obs.gauge("app_tpu_device_duty_cycle", stats["duty_cycle"])
        if self.pool:
            self._obs.gauge("app_tpu_disagg_pool_duty_cycle",
                            stats["duty_cycle"], pool=self.pool)
        self._obs.gauge("app_tpu_host_overhead_seconds",
                        stats["host_overhead_s"])
        for phase in ("prefill", "decode"):
            self._obs.gauge("app_tpu_mfu", stats["mfu"][phase], phase=phase)
            self._obs.gauge("app_tpu_mbu", stats["mbu"][phase], phase=phase)


def register_utilization_metrics(metrics) -> None:
    """Register the ledger/sampler gauges on a metrics Manager (idempotent:
    tpu/device.register_metrics also registers them)."""
    for name, desc in (
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
        ("app_tpu_hbm_bytes",
         "HBM bytes per device (kind=in_use|limit)"),
        ("app_tpu_kv_pool_pages",
         "KV page-pool occupancy (kind=used|free)"),
        ("app_tpu_kv_tier_bytes",
         "host KV tier occupancy in bytes (kind=used|capacity)"),
        ("app_tpu_kv_tier_pages",
         "page blobs resident in the host KV tier"),
    ):
        try:
            if metrics.get(name) is None:
                metrics.new_gauge(name, desc)
        except Exception:  # noqa: BLE001 - already registered
            pass
    for name, desc in (
        ("app_tpu_kv_tier_spilled_total",
         "KV pages spilled from the pool to the host tier on eviction"),
        ("app_tpu_kv_tier_restored_total",
         "KV pages restored into the pool from the tiers by H2D copy"),
        ("app_tpu_kv_tier_hits_total",
         "tier lookups during the admission prefix walk that found a "
         "verified page blob"),
        ("app_tpu_kv_tier_misses_total",
         "prefix pages past the pool's hit the tiers could not supply "
         "(re-prefilled instead)"),
        ("app_tpu_kv_tier_corrupt_total",
         "tier blobs dropped on checksum/content verification failure "
         "(degraded to a miss)"),
        ("app_tpu_kv_tier_pinned_total",
         "conversation-trunk chain keys pinned in the host tier"),
    ):
        try:
            if metrics.get(name) is None:
                metrics.new_counter(name, desc)
        except Exception:  # noqa: BLE001 - already registered
            pass


class MemorySampler:
    """Background card-memory / page-pool gauge refresher.

    Polls the device client's ``memory_stats`` (`tpu`, the container's
    tpu/device.CUDAClient, as the reference reads its TPUClient), else
    ``tpu/device.device_memory_stats`` for `device` (default the engine's),
    every ``interval_s`` into ``app_tpu_hbm_bytes{device,kind}``, plus the
    engine's page-pool occupancy when it serves from a paged pool. On the
    CPU the stats are zeros (a client) or none, and the pool gauges move."""

    def __init__(self, metrics, engine=None, interval_s: float = 10.0,
                 logger=None, device=None, tpu=None):
        self._obs = MetricsHook(metrics)
        self.tpu = tpu
        self.engine = engine
        self.device = (device if device is not None
                       else getattr(engine, "device", None))
        self.interval_s = max(0.5, float(interval_s))
        self.logger = logger
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _device_stats(self) -> List[Dict[str, Any]]:
        if self.tpu is not None:
            return self.tpu.memory_stats()
        return device_memory_stats(self.device)

    def sample_once(self) -> None:
        for s in self._device_stats():
            dev = str(s["id"])
            self._obs.gauge("app_tpu_hbm_bytes", s["bytes_in_use"],
                            device=dev, kind="in_use")
            self._obs.gauge("app_tpu_hbm_bytes", s["bytes_limit"],
                            device=dev, kind="limit")
        allocator = getattr(self.engine, "allocator", None)
        if allocator is not None:
            self._obs.gauge("app_tpu_kv_pool_pages", allocator.used_pages,
                            kind="used")
            self._obs.gauge("app_tpu_kv_pool_pages", allocator.free_pages,
                            kind="free")
        kv_tier = getattr(self.engine, "kv_tier", None)
        if kv_tier is not None:
            tier_stats = kv_tier.stats()
            self._obs.gauge("app_tpu_kv_tier_bytes",
                            tier_stats["used_bytes"], kind="used")
            self._obs.gauge("app_tpu_kv_tier_bytes",
                            tier_stats["capacity_bytes"], kind="capacity")
            self._obs.gauge("app_tpu_kv_tier_pages", tier_stats["pages"])

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.sample_once()
            except Exception as exc:  # noqa: BLE001 - sampling must not die
                if self.logger is not None:
                    self.logger.debugf("memory sample failed: %s", exc)
            self._stop.wait(self.interval_s)

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(target=self._loop,
                                        name="hbm-sampler", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None


# -- /debug/engine ------------------------------------------------------------
def engine_snapshot(engine) -> Dict[str, Any]:
    """One JSON snapshot of the whole engine: slots, buckets, page pool,
    utilization window, program table, card memory. Read-only and
    best-effort: slot fields are read without the engine's state lock (a
    torn read of a transitioning slot is acceptable for an operator
    surface; taking the lock would let a stalled loop block the debug
    endpoint)."""
    out: Dict[str, Any] = {
        "engine": {
            "class": type(engine).__name__,
            "n_slots": engine.n_slots,
            "max_seq_len": engine.max_seq_len,
            "prefill_buckets": list(engine.prefill_buckets),
            "decode_block_size": engine.decode_block_size,
            "pipeline_depth": engine.pipeline_depth,
            "chunk_prefill_tokens": engine.chunk_prefill_tokens,
            "speculative_tokens": engine.speculative_tokens,
            "cache_len": getattr(engine, "_cache_len", None),
            "queue_depth": engine._pending.qsize(),
            "inflight_dispatches": len(engine._inflight),
            "draining": engine._draining,
            "stall_seconds": round(engine.stall_seconds, 1),
        },
    }
    slots = []
    active = 0
    for i, slot in enumerate(engine.slots):
        request = slot.request
        entry: Dict[str, Any] = {"slot": i, "active": slot.active}
        if request is not None:
            active += 1
            entry.update(request_id=request.id, length=slot.length,
                         remaining=slot.remaining,
                         generated=request.generated)
        chunking = slot.chunking
        if chunking is not None:
            entry["chunking_request_id"] = chunking.id
        if slot.pages is not None:
            entry["pages"] = len(slot.pages)
        slots.append(entry)
    out["engine"]["active_slots"] = active
    out["slots"] = slots

    allocator = getattr(engine, "allocator", None)
    if allocator is not None:
        out["page_pool"] = {
            "n_pages": allocator.n_pages,
            "page_size": allocator.page_size,
            "used": allocator.used_pages,
            "free": allocator.free_pages,
        }
        prefix = getattr(engine, "prefix", None)
        if prefix is not None:
            try:
                out["page_pool"]["prefix_cache"] = prefix.stats()
                # bounded hot-chain-key digest so fleet routers polling
                # this surface never pay O(pool) serialization
                out["page_pool"]["prefix_digest"] = prefix.digest()
            except Exception:  # noqa: BLE001
                pass
        kv_tier = getattr(engine, "kv_tier", None)
        if kv_tier is not None:
            tier = kv_tier.stats()
            tier["spilled_pages"] = getattr(engine, "_kv_spilled", 0)
            tier["restored_pages"] = getattr(engine, "_kv_restored", 0)
            out["page_pool"]["kv_tier"] = tier

    breaker = getattr(engine, "breaker", None)
    if breaker is not None:
        out["breaker"] = breaker.snapshot()
    # crash-only recovery evidence (plain engine counters, metrics-free)
    if hasattr(engine, "resets_total"):
        out["recovery"] = {
            "resets_total": engine.resets_total,
            "replays_total": engine.replays_total,
            "replayed_tokens_total": engine.replayed_tokens_total,
            "quarantined_total": engine.quarantined_total,
            "retry_budget": getattr(engine, "retry_budget", None),
        }
    faults = getattr(engine, "faults", None)
    if faults is not None:
        out["faults"] = faults.snapshot()

    util = getattr(engine, "util", None)
    if util is not None:
        out["utilization"] = util.window_stats()
    executor = getattr(engine, "executor", None)
    if executor is not None and hasattr(executor, "compile_table"):
        out["compile"] = executor.compile_table()

    hbm = device_memory_stats(getattr(engine, "device", None))
    if hbm:
        out["hbm"] = hbm
    return out


def install_routes(app, engine, path: str = "/debug/engine") -> None:
    """Register GET /debug/engine on an App."""

    @app.get(path)
    def debug_engine(ctx):  # noqa: ANN001
        return engine_snapshot(engine)

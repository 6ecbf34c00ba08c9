"""Step anatomy ledger: per-engine-step wall-clock attribution.

A copy of ``gofr_tpu/tpu/stepledger.py``, whole: ``SEGMENTS``, ``PHASES``,
``STEP_SECONDS_BUCKETS``, ``StepRecord``, the straggler sentinel
(``_PhaseBaseline``), ``StepLedger``, ``register_step_metrics`` and
``install_routes`` (``GET /debug/steps``). The paged engine opens
``kv_restore`` around a tier restore inside ``page_alloc``, and
``kv_handoff`` around a prefill pool's export, a decode pool's landing and
a migration round, at the reference's sites.

Every engine loop iteration that does work becomes one ``StepRecord`` in a
bounded ring, its measured wall-clock split into named, mutually exclusive
segments that SUM to the step's wall (an explicit ``other`` residual means
nothing can hide):

  ``idle_gap``     time since the previous step ended (the loop parked on
                   its wake event); kept out of the segment sum
  ``admission``    ``_admit``: queue drain, heap ordering, wave grouping
  ``page_alloc``   paged engines: page reservation, prefix-cache match and
                   eviction inside admission (an exhausted pool shows here)
  ``kv_restore``   a KV tier restore (paged, inside page_alloc)
  ``kv_handoff``   a hand-off's export or landing, a migration round
  ``host_prep``    batch array prep: padding, lengths, sampling controls,
                   block tables, draft proposals
  ``compile``      program captures after boot, re-attributed out of
                   whichever segment they happened under
                   (``Executor.on_compile``)
  ``cache_grow``   dense KV growth
  ``dispatch``     program enqueue calls (prefill / decode / verify /
                   chunk), the static inputs' host-to-device copy included
  ``device_sync``  the wait for the oldest in-flight dispatch. With async
                   D2H (the engine default) the tokens' copy to pinned host
                   memory was started at dispatch, so this is the wait on
                   that copy's CUDA event: a completion check, not the
                   transfer itself
  ``demux``        the vectorized stop / budget / context pass over the
                   synced ``[B, block]`` token matrix
  ``emit``         delivery after the sync: per-request queue puts,
                   recorder and metric callbacks, slot bookkeeping
  ``other``        everything not wrapped above (the residual)

On top of the ring: a straggler sentinel (a per-phase EWMA and a rolling
p95 band; a step slower than ``straggler_k`` times the larger is flagged
with its dominant segment as the cause, counted in
``app_tpu_step_stragglers_total{cause}`` and, through the engine, recorded
as a ``step_straggler`` flight-recorder event), the
``app_tpu_step_seconds{phase,segment}`` histograms with request-id
exemplars, and ``GET /debug/steps``.

Threading: accumulation (``step_start`` / ``seg`` / ``note_*``) belongs to
the engine loop thread. The ledger records the owning thread at
``step_start`` and ignores calls from any other (captures at warm-up, the
scoring passes of tpu/score.py), so no lock sits on the hot path; only the
ring and snapshot boundary takes one. Every clock is ``time.monotonic()``.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Any, Dict, List, Optional

from .obs import MetricsHook
from .ownership import loop_only

SEGMENTS = ("admission", "page_alloc", "kv_restore", "kv_handoff",
            "host_prep", "compile", "cache_grow", "dispatch", "device_sync",
            "demux", "emit", "other")

# step phases, by what the iteration synced (one sync per iteration) or,
# sync-less, what it dispatched
PHASES = ("prefill", "decode", "verify", "chunk", "dispatch", "admit")

STEP_SECONDS_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                        0.25, 0.5, 1.0, 2.5, 5.0, 15.0)


class StepRecord:
    """One engine loop iteration's anatomy (see module docstring)."""

    __slots__ = ("seq", "started_at", "wall_s", "idle_gap_s", "phase",
                 "segments", "active_slots", "inflight", "queue_depth",
                 "tokens", "dispatches", "slowest_request_id", "straggler",
                 "cause", "baseline_s")

    def __init__(self, seq: int, started_at: float, wall_s: float,
                 idle_gap_s: float, phase: str,
                 segments: Dict[str, float]):
        self.seq = seq
        self.started_at = started_at          # monotonic; display-only
        self.wall_s = wall_s                  # loop-body time == sum(segments)
        self.idle_gap_s = idle_gap_s
        self.phase = phase
        self.segments = segments
        self.active_slots = 0
        self.inflight = 0
        self.queue_depth = 0
        self.tokens = 0
        self.dispatches: Dict[str, int] = {}
        self.slowest_request_id: Optional[int] = None
        self.straggler = False
        self.cause: Optional[str] = None
        self.baseline_s: Optional[float] = None

    def dominant_segment(self) -> str:
        if not self.segments:
            return "other"
        return max(self.segments.items(), key=lambda kv: kv[1])[0]

    def summary(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "step": self.seq,
            "phase": self.phase,
            "wall_s": round(self.wall_s, 6),
            "idle_gap_s": round(self.idle_gap_s, 6),
            "segments": {k: round(v, 6) for k, v in self.segments.items()
                         if v > 0.0},
            "active_slots": self.active_slots,
            "inflight": self.inflight,
            "queue_depth": self.queue_depth,
            "tokens": self.tokens,
        }
        if self.dispatches:
            out["dispatches"] = dict(self.dispatches)
        if self.slowest_request_id is not None:
            out["slowest_request_id"] = self.slowest_request_id
        if self.straggler:
            out["straggler"] = True
            out["cause"] = self.cause
            if self.baseline_s is not None:
                out["baseline_s"] = round(self.baseline_s, 6)
        return out


class _PhaseBaseline:
    """Per-phase rolling step-time model: EWMA mean + a recent-window
    percentile band. A step is a straggler when it exceeds
    k × max(ewma, p95) after `min_samples` observations. A flagged value
    updates the EWMA CLAMPED to the threshold and never enters the
    percentile window — one outlier must not inflate the band so the next
    straggler escapes, while a genuine regime change still converges (each
    flagged step drags the EWMA up toward the threshold)."""

    __slots__ = ("ewma", "samples", "window")

    WINDOW = 128

    def __init__(self):
        self.ewma: Optional[float] = None
        self.samples = 0
        self.window: "collections.deque" = collections.deque(
            maxlen=self.WINDOW)

    def p95(self) -> Optional[float]:
        if not self.window:
            return None
        ordered = sorted(self.window)
        return ordered[min(len(ordered) - 1, int(0.95 * len(ordered)))]

    def threshold(self, k: float) -> Optional[float]:
        if self.ewma is None:
            return None
        band = self.p95()
        return k * max(self.ewma, band if band is not None else 0.0)

    def update(self, wall_s: float, alpha: float) -> None:
        self.ewma = (wall_s if self.ewma is None
                     else (1.0 - alpha) * self.ewma + alpha * wall_s)
        self.samples += 1
        self.window.append(wall_s)

    def describe(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"samples": self.samples}
        if self.ewma is not None:
            out["ewma_s"] = round(self.ewma, 6)
        band = self.p95()
        if band is not None:
            out["p95_s"] = round(band, 6)
        return out


class StepLedger:
    """Bounded ring of StepRecords + straggler sentinel (module doc)."""

    def __init__(self, capacity: int = 512, metrics=None, logger=None,
                 straggler_k: float = 3.0, baseline_alpha: float = 0.1,
                 min_samples: int = 16, clock=time.monotonic):
        self.capacity = max(16, int(capacity))
        self.straggler_k = float(straggler_k)
        self.baseline_alpha = float(baseline_alpha)
        self.min_samples = max(1, int(min_samples))
        self._clock = clock
        self._obs = MetricsHook(metrics, logger=logger)
        self.logger = logger
        # ring + aggregates, guarded by one short lock (snapshot boundary)
        self._lock = threading.Lock()
        self._ring: "collections.deque[StepRecord]" = collections.deque(
            maxlen=self.capacity)
        self._baselines: Dict[str, _PhaseBaseline] = {}
        self._stragglers: "collections.deque" = collections.deque(maxlen=32)
        self.steps_total = 0
        self.stragglers_total = 0
        # loop-thread-only accumulation state (no lock: see module doc)
        self._owner: Optional[int] = None
        self._seq = 0
        self._t0: Optional[float] = None
        self._last_end: float = clock()
        self._frames: List[list] = []      # [name, started, child_s]
        self._segments: Dict[str, float] = {}
        self._dispatches: Dict[str, int] = {}
        self._sync_kind: Optional[str] = None
        self._tokens = 0
        self._slowest: Optional[int] = None

    # -- wiring ---------------------------------------------------------------
    def use_metrics(self, metrics) -> None:
        if metrics is not None:
            self._obs = MetricsHook(metrics, logger=self.logger)

    def configure(self, capacity: Optional[int] = None,
                  straggler_k: Optional[float] = None,
                  baseline_alpha: Optional[float] = None,
                  min_samples: Optional[int] = None) -> None:
        """Apply operator config (App.enable_step_ledger). Resizing the
        ring keeps the newest records."""
        with self._lock:
            if capacity is not None and int(capacity) != self.capacity:
                self.capacity = max(16, int(capacity))
                self._ring = collections.deque(self._ring,
                                               maxlen=self.capacity)
            if straggler_k is not None:
                self.straggler_k = float(straggler_k)
            if baseline_alpha is not None:
                self.baseline_alpha = float(baseline_alpha)
            if min_samples is not None:
                self.min_samples = max(1, int(min_samples))

    # -- accumulation (engine loop thread only) -------------------------------
    def _mine(self) -> bool:
        return (self._t0 is not None
                and self._owner == threading.get_ident())

    @loop_only(fields=("_owner", "_seq", "_t0", "_last_end", "_frames",
                       "_segments", "_dispatches", "_sync_kind",
                       "_tokens", "_slowest"))
    def step_start(self) -> None:
        """Open a step. The gap since the previous step's end (wake waits,
        anything outside the instrumented body) becomes idle_gap."""
        if self._t0 is not None:       # already open (reset path re-entry)
            return
        self._owner = threading.get_ident()
        now = self._clock()
        self._t0 = now
        self._frames = [["other", now, 0.0]]
        self._segments = {}
        self._dispatches = {}
        self._sync_kind = None
        self._tokens = 0
        self._slowest = None

    class _Seg:
        __slots__ = ("ledger", "name", "active")

        def __init__(self, ledger: "StepLedger", name: str):
            self.ledger = ledger
            self.name = name
            self.active = False

        def __enter__(self):
            if self.ledger._mine():
                self.active = True
                self.ledger._frames.append(
                    [self.name, self.ledger._clock(), 0.0])
            return self

        def __exit__(self, *exc):
            if self.active and self.ledger._mine():
                self.ledger._pop_frame()
            return False

    def seg(self, name: str) -> "StepLedger._Seg":
        """Context manager attributing the wrapped block's EXCLUSIVE time
        (minus nested segments and re-attributions) to `name`. No-op when
        no step is open or on a foreign thread."""
        return self._Seg(self, name)

    @loop_only
    def _pop_frame(self) -> None:
        name, started, child_s = self._frames.pop()
        dur = self._clock() - started
        own = max(0.0, dur - child_s)
        self._segments[name] = self._segments.get(name, 0.0) + own
        if self._frames:
            self._frames[-1][2] += dur

    @loop_only
    def note_stolen(self, name: str, seconds: float) -> None:
        """Re-attribute `seconds` already elapsing inside the current
        segment to `name` (the executor's compile callback: a cache-miss
        compile under `dispatch` must read as compile, not dispatch)."""
        if seconds <= 0.0 or not self._mine():
            return
        self._segments[name] = self._segments.get(name, 0.0) + seconds
        if self._frames:
            self._frames[-1][2] += seconds

    @loop_only
    def note_dispatch(self, kind: str) -> None:
        if self._mine():
            self._dispatches[kind] = self._dispatches.get(kind, 0) + 1

    @loop_only
    def note_sync(self, kind: str, tokens: int = 0,
                  slowest_request_id: Optional[int] = None) -> None:
        if self._mine():
            self._sync_kind = kind
            self._tokens += int(tokens)
            if slowest_request_id is not None:
                self._slowest = slowest_request_id

    @loop_only
    def step_abort(self) -> None:
        """Discard the open step (device-reset path): a step that died in
        an exception must not feed the baselines, but its time still
        counts toward the next step's idle_gap."""
        if self._t0 is None:
            return
        self._last_end = self._clock()
        self._t0 = None
        self._frames = []

    @loop_only
    def step_end(self, active_slots: int = 0, inflight: int = 0,
                 queue_depth: int = 0) -> Optional[StepRecord]:
        """Close the step. Pure-bookkeeping iterations (no dispatch, no
        sync, no tokens) are dropped — their time accumulates into the
        next real step's idle_gap, so an idle engine never floods the
        ring. Returns the record (for the engine's straggler event hook)
        or None when dropped."""
        if not self._mine():
            return None
        while self._frames:
            self._pop_frame()
        now = self._clock()
        t0 = self._t0
        self._t0 = None
        if not self._dispatches and self._sync_kind is None \
                and self._tokens == 0:
            # idle iteration: don't record, don't advance _last_end — the
            # whole quiet stretch becomes the next real step's idle_gap
            return None
        idle_gap = max(0.0, t0 - self._last_end)
        self._last_end = now
        wall = max(1e-9, now - t0)
        # the sum identity: segments tile the loop body exactly; clamp the
        # residual into "other" against float drift
        tracked = sum(self._segments.values())
        if tracked < wall:
            self._segments["other"] = (self._segments.get("other", 0.0)
                                       + (wall - tracked))
        if self._sync_kind is not None:
            phase = self._sync_kind
        elif "chunk" in self._dispatches:
            phase = "chunk"
        elif self._dispatches:
            phase = "dispatch"
        else:
            phase = "admit"
        self._seq += 1
        rec = StepRecord(self._seq, t0, wall, idle_gap, phase,
                         dict(self._segments))
        rec.active_slots = int(active_slots)
        rec.inflight = int(inflight)
        rec.queue_depth = int(queue_depth)
        rec.tokens = self._tokens
        rec.dispatches = dict(self._dispatches)
        rec.slowest_request_id = self._slowest
        self._finish(rec)
        return rec

    # -- sentinel + publication -----------------------------------------------
    def _finish(self, rec: StepRecord) -> None:
        with self._lock:
            baseline = self._baselines.get(rec.phase)
            if baseline is None:
                baseline = self._baselines[rec.phase] = _PhaseBaseline()
            limit = None
            if baseline.samples >= self.min_samples:
                limit = baseline.threshold(self.straggler_k)
                if limit is not None and rec.wall_s > limit:
                    rec.straggler = True
                    rec.cause = rec.dominant_segment()
                    rec.baseline_s = baseline.ewma
                    self.stragglers_total += 1
                    self._stragglers.append(rec.summary())
            if rec.straggler:
                # bounded influence: clamp to the threshold, skip the band
                baseline.ewma = ((1.0 - self.baseline_alpha) * baseline.ewma
                                 + self.baseline_alpha * limit)
                baseline.samples += 1
            else:
                baseline.update(rec.wall_s, self.baseline_alpha)
            self._ring.append(rec)
            self.steps_total += 1
        # metrics outside the lock: one histogram sample per non-zero
        # segment, exemplar'd with the step's cost-driver request so a bad
        # Grafana bucket deep-links into /debug/requests/{id}
        exemplar = ({"request_id": str(rec.slowest_request_id)}
                    if rec.slowest_request_id is not None else None)
        for segment, seconds in rec.segments.items():
            if seconds > 0.0:
                self._obs.hist("app_tpu_step_seconds", seconds,
                               exemplar=exemplar, phase=rec.phase,
                               segment=segment)
        if rec.straggler:
            self._obs.counter("app_tpu_step_stragglers_total",
                              cause=rec.cause or "other")
            if self.logger is not None:
                try:
                    self.logger.warnf(
                        "step straggler: step %d (%s) took %.1f ms vs "
                        "%.1f ms baseline; dominant segment %s",
                        rec.seq, rec.phase, rec.wall_s * 1e3,
                        (rec.baseline_s or 0.0) * 1e3, rec.cause)
                except Exception:  # noqa: BLE001
                    pass

    # -- operator surface -----------------------------------------------------
    def records(self, recent: int = 64) -> List[StepRecord]:
        """The newest `recent` StepRecords, oldest first. Records are
        immutable after _finish, so handing out the refs is safe — the
        timeline exporter (tpu/timeline.py) needs `started_at`, which
        summary() omits (it is a monotonic stamp, meaningless to a
        human reading /debug/steps)."""
        with self._lock:
            return list(self._ring)[-max(1, int(recent)):]

    def snapshot(self, recent: int = 64) -> Dict[str, Any]:
        """The /debug/steps payload: recent ring (newest first), per-phase
        segment totals over the whole ring, live baselines, stragglers."""
        with self._lock:
            ring = list(self._ring)
            baselines = {phase: b.describe()
                         for phase, b in self._baselines.items()}
            stragglers = list(self._stragglers)
            steps_total = self.steps_total
            stragglers_total = self.stragglers_total
        summary: Dict[str, Dict[str, Any]] = {}
        for rec in ring:
            agg = summary.setdefault(rec.phase, {
                "steps": 0, "wall_s": 0.0, "tokens": 0, "idle_gap_s": 0.0,
                "segments": {}})
            agg["steps"] += 1
            agg["wall_s"] += rec.wall_s
            agg["tokens"] += rec.tokens
            agg["idle_gap_s"] += rec.idle_gap_s
            for segment, seconds in rec.segments.items():
                agg["segments"][segment] = (agg["segments"].get(segment, 0.0)
                                            + seconds)
        for agg in summary.values():
            agg["mean_wall_s"] = round(agg["wall_s"] / agg["steps"], 6)
            agg["wall_s"] = round(agg["wall_s"], 6)
            agg["idle_gap_s"] = round(agg["idle_gap_s"], 6)
            agg["segments"] = {k: round(v, 6)
                               for k, v in sorted(agg["segments"].items(),
                                                  key=lambda kv: -kv[1])}
        return {
            "steps_total": steps_total,
            "stragglers_total": stragglers_total,
            "capacity": self.capacity,
            "sentinel": {
                "straggler_k": self.straggler_k,
                "baseline_alpha": self.baseline_alpha,
                "min_samples": self.min_samples,
            },
            "baselines": baselines,
            "summary": summary,
            "stragglers": stragglers,
            "recent": [rec.summary() for rec in
                       reversed(ring[-max(1, int(recent)):])],
        }


def register_step_metrics(metrics) -> None:
    """Register the step-anatomy instruments on a metrics Manager
    (idempotent: tpu/device.register_metrics also registers them)."""
    try:
        if metrics.get("app_tpu_step_seconds") is None:
            metrics.new_histogram(
                "app_tpu_step_seconds",
                "engine step time by phase and attributed segment",
                STEP_SECONDS_BUCKETS)
    except Exception:  # noqa: BLE001 - already registered
        pass
    try:
        if metrics.get("app_tpu_step_stragglers_total") is None:
            metrics.new_counter(
                "app_tpu_step_stragglers_total",
                "engine steps flagged slower than the rolling per-phase "
                "baseline, by dominant-segment cause")
    except Exception:  # noqa: BLE001
        pass


def install_routes(app, ledger: StepLedger,
                   path: str = "/debug/steps") -> None:
    """Register GET /debug/steps on an App (the flight-recorder /
    engine-snapshot install_routes idiom)."""

    @app.get(path)
    def debug_steps(ctx):  # noqa: ANN001
        try:
            recent = int(ctx.request.param("recent") or 64)
        except (TypeError, ValueError):
            recent = 64
        return ledger.snapshot(recent=recent)

"""Incident autopsy plane: SLO burn-rate alerting and evidence bundles.

A copy of ``gofr_tpu/tpu/incidents.py``, whole, stdlib only:

  * **SLOBurnEngine** — rolling error-budget accounting over the TTFT and
    TPOT targets plus an availability SLO (errored or shed vs. completed),
    over PAIRED fast/slow windows (default 5 m / 1 h). The burn rate is
    ``observed error rate / error budget``, the budget ``1 - objective``.
    A state is ``page`` only when BOTH windows burn past the page threshold
    (the multi-window multi-burn-rate rule), ``warn`` past the warn one;
    recovery is automatic as the fast window drains. Fed by the flight
    recorder (``FlightRecorder.use_burn_engine``: every completion, and
    every ``stall_shed`` / ``breaker_shed``), published as
    ``app_tpu_slo_burn_rate{slo,window}`` and
    ``app_tpu_slo_alert_state{slo}`` (0 ok / 1 warn / 2 page), served at
    ``GET /debug/slo``.
  * **IncidentManager** — anomaly triggers (``slo_page`` transitions,
    ``straggler_streak`` from the step ledger's sentinel, ``breaker_open``
    and ``quarantine`` from the engine's reset path) capture a
    rate-limited **evidence bundle** on a daemon thread: the step ring,
    the ``/debug/engine`` payload, the K slowest in-flight and recent
    requests, the recorder's engine events, the host profiler's top loop
    stacks, a config fingerprint and, with ``INCIDENT_PROFILE_S`` > 0 and
    the profiler idle, a torch.profiler capture (tpu/profiler.py). Bundles
    are written to ``INCIDENT_DIR/incident-<id>.json``, kept in a bounded
    ring, served at ``GET /debug/incidents[/{id}[/trace]]`` and counted in
    ``app_tpu_incidents_total{trigger}`` /
    ``app_tpu_incidents_suppressed_total{trigger}``.

Hot-path contract: every engine hook is one None-guarded attribute check;
``trigger()`` does O(1) bookkeeping under one short lock and hands the
capture to a daemon thread, so the engine loop never snapshots, serializes
or touches the filesystem.
"""

from __future__ import annotations

import collections
import hashlib
import itertools
import json
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from .obs import MetricsHook

SLO_NAMES = ("ttft", "tpot", "availability")

# alert states (gauge values); the standard both-windows rule decides
STATE_OK, STATE_WARN, STATE_PAGE = 0, 1, 2
STATE_LABELS = {STATE_OK: "ok", STATE_WARN: "warn", STATE_PAGE: "page"}

# paired windows + thresholds: the SRE-workbook 5m/1h "fast burn" pair;
# 14.4x burn spends a 30-day budget in ~2 days, 6x in ~5 days
DEFAULT_FAST_WINDOW_S = 300.0
DEFAULT_SLOW_WINDOW_S = 3600.0
DEFAULT_PAGE_BURN = 14.4
DEFAULT_WARN_BURN = 6.0

DEFAULT_OBJECTIVES = {"ttft": 0.99, "tpot": 0.99, "availability": 0.999}

# per-window event cap: at the north-star ~50 req/s a 1 h window holds
# 180k completions; beyond the cap the oldest events age out early and
# the window simply covers a shorter span — accounting degrades, never
# grows without bound
_WINDOW_MAXLEN = 65536


class _Window:
    """One rolling (t, bad) event window with O(1) running totals."""

    __slots__ = ("window_s", "events", "n", "bad", "peak_burn")

    def __init__(self, window_s: float):
        self.window_s = float(window_s)
        self.events: "collections.deque" = collections.deque(
            maxlen=_WINDOW_MAXLEN)
        self.n = 0
        self.bad = 0
        self.peak_burn = 0.0

    def add(self, t: float, bad: bool) -> None:
        if len(self.events) == self.events.maxlen:
            # maxlen eviction drops the OLDEST event: keep totals honest
            t0, b0 = self.events[0]
            self.n -= 1
            self.bad -= b0
        self.events.append((t, 1 if bad else 0))
        self.n += 1
        self.bad += 1 if bad else 0

    def prune(self, now: float) -> None:
        cutoff = now - self.window_s
        while self.events and self.events[0][0] < cutoff:
            _, b = self.events.popleft()
            self.n -= 1
            self.bad -= b

    def error_rate(self) -> Optional[float]:
        if self.n <= 0:
            return None
        return self.bad / self.n

    def burn(self, budget: float, min_events: int) -> Optional[float]:
        """Burn rate = error rate / budget; None until the window holds
        `min_events` observations (a near-empty window must not page)."""
        if self.n < min_events:
            return None
        rate = self.error_rate()
        if rate is None:
            return None
        value = rate / max(budget, 1e-9)
        if value > self.peak_burn:
            self.peak_burn = value
        return value


class _SLOTrack:
    __slots__ = ("name", "objective", "budget", "fast", "slow", "state")

    def __init__(self, name: str, objective: float,
                 fast_window_s: float, slow_window_s: float):
        self.name = name
        self.objective = float(objective)
        self.budget = max(1e-9, 1.0 - self.objective)
        self.fast = _Window(fast_window_s)
        self.slow = _Window(slow_window_s)
        self.state = STATE_OK


class SLOBurnEngine:
    """Error-budget burn accounting over paired windows (module doc).

    Fed by the flight recorder (``use_burn_engine``): each completed
    request contributes one event per SLO it can score (ttft/tpot need
    the respective measurement; availability scores every completion,
    bad when it errored), and every stall/breaker shed contributes an
    availability failure — the requests the SLO *lost* without serving.
    All public methods take one short lock; ``on_page`` fires outside
    it (the IncidentManager takes its own lock)."""

    def __init__(self, slo_ttft_s: float = 0.150, slo_tpot_s: float = 0.050,
                 objectives: Optional[Dict[str, float]] = None,
                 fast_window_s: float = DEFAULT_FAST_WINDOW_S,
                 slow_window_s: float = DEFAULT_SLOW_WINDOW_S,
                 page_burn: float = DEFAULT_PAGE_BURN,
                 warn_burn: float = DEFAULT_WARN_BURN,
                 min_events: int = 12, metrics=None, logger=None,
                 clock=time.monotonic,
                 on_page: Optional[Callable[..., Any]] = None):
        self.slo_ttft_s = float(slo_ttft_s)
        self.slo_tpot_s = float(slo_tpot_s)
        self.fast_window_s = float(fast_window_s)
        self.slow_window_s = max(float(slow_window_s), self.fast_window_s)
        self.page_burn = float(page_burn)
        self.warn_burn = float(warn_burn)
        self.min_events = max(1, int(min_events))
        self._clock = clock
        self._obs = MetricsHook(metrics, logger=logger)
        self.logger = logger
        self.on_page = on_page
        objectives = dict(DEFAULT_OBJECTIVES, **(objectives or {}))
        self._lock = threading.Lock()
        self._tracks = {
            name: _SLOTrack(name, objectives[name],
                            self.fast_window_s, self.slow_window_s)
            for name in SLO_NAMES}
        # recent alert transitions, for /debug/slo (the paging history an
        # operator reads back after the fact)
        self._transitions: "collections.deque" = collections.deque(maxlen=32)

    def use_metrics(self, metrics) -> None:
        if metrics is not None:
            self._obs = MetricsHook(metrics, logger=self.logger)

    # -- event intake (flight-recorder thread, best-effort) -------------------
    def observe_request(self, ttft_s: Optional[float],
                        tpot_s: Optional[float], error: bool = False) -> None:
        """One completed request: scores ttft/tpot when measured, and
        availability always (bad on an errored outcome)."""
        try:
            events = [("availability", bool(error))]
            if ttft_s is not None:
                events.append(("ttft", ttft_s > self.slo_ttft_s))
            if tpot_s is not None:
                events.append(("tpot", tpot_s > self.slo_tpot_s))
            self._record(events)
        except Exception:  # noqa: BLE001 - accounting is best-effort
            pass

    def observe_shed(self) -> None:
        """A request the server refused (stall/breaker shed): budget
        spent without serving — an availability failure."""
        try:
            self._record([("availability", True)])
        except Exception:  # noqa: BLE001
            pass

    def _record(self, events: List[tuple]) -> None:
        now = self._clock()
        paged: List[tuple] = []
        with self._lock:
            for name, bad in events:
                track = self._tracks[name]
                track.fast.add(now, bad)
                track.slow.add(now, bad)
            paged = self._recompute_locked(now)
        self._fire(paged)

    # -- state machine --------------------------------------------------------
    def _burns_locked(self, track: _SLOTrack, now: float):
        track.fast.prune(now)
        track.slow.prune(now)
        return (track.fast.burn(track.budget, self.min_events),
                track.slow.burn(track.budget, self.min_events))

    def _recompute_locked(self, now: float) -> List[tuple]:
        """Re-evaluate every track; publish gauges; return page
        transitions to fire outside the lock."""
        paged = []
        for track in self._tracks.values():
            fast, slow = self._burns_locked(track, now)

            def both_over(threshold: float) -> bool:
                return (fast is not None and slow is not None
                        and fast >= threshold and slow >= threshold)

            state = STATE_OK
            if both_over(self.page_burn):
                state = STATE_PAGE
            elif both_over(self.warn_burn):
                state = STATE_WARN
            if state != track.state:
                info = {"slo": track.name,
                        "from": STATE_LABELS[track.state],
                        "to": STATE_LABELS[state],
                        "burn_fast": round(fast, 3) if fast is not None
                        else None,
                        "burn_slow": round(slow, 3) if slow is not None
                        else None,
                        # lint: clock-ok operator-facing transition timestamp (burn math itself uses the monotonic window clock)
                        "t": time.time()}
                self._transitions.append(info)
                if state == STATE_PAGE:
                    paged.append((track.name, info))
                track.state = state
            self._publish_track(track, fast, slow)
        return paged

    def _publish_track(self, track: _SLOTrack, fast, slow) -> None:
        if fast is not None:
            self._obs.gauge("app_tpu_slo_burn_rate", round(fast, 4),
                            slo=track.name, window="fast")
        if slow is not None:
            self._obs.gauge("app_tpu_slo_burn_rate", round(slow, 4),
                            slo=track.name, window="slow")
        self._obs.gauge("app_tpu_slo_alert_state", track.state,
                        slo=track.name)

    def _fire(self, paged: List[tuple]) -> None:
        for name, info in paged:
            if self.logger is not None:
                try:
                    self.logger.errorf(
                        "SLO %s burning: fast %.1fx / slow %.1fx over "
                        "budget — PAGE", name, info.get("burn_fast") or 0.0,
                        info.get("burn_slow") or 0.0)
                except Exception:  # noqa: BLE001
                    pass
            if self.on_page is not None:
                try:
                    self.on_page(slo=name, **{k: v for k, v in info.items()
                                              if k != "slo"})
                except Exception:  # noqa: BLE001 - alerting is best-effort
                    pass

    # -- operator surface -----------------------------------------------------
    def publish(self) -> None:
        """Scrape hook: re-evaluate so burn DECAYS while the server is
        idle (no completions means no _record calls to age the windows)."""
        with self._lock:
            paged = self._recompute_locked(self._clock())
        self._fire(paged)

    def states(self) -> Dict[str, str]:
        """Current alert state per SLO track ("ok"/"warn"/"page"), fresh:
        re-evaluates first so burn decays toward ok even when nothing
        completes and nothing scrapes. This is the probe the QoS shed
        ladder (tpu/qos.py) actuates on — the point where the burn
        engine stops being a read-only pager."""
        with self._lock:
            paged = self._recompute_locked(self._clock())
            out = {name: STATE_LABELS[track.state]
                   for name, track in self._tracks.items()}
        self._fire(paged)
        return out

    def peaks(self) -> Dict[str, Dict[str, float]]:
        """Max burn rate observed per SLO/window (soak artifacts)."""
        with self._lock:
            return {name: {"fast": round(t.fast.peak_burn, 3),
                           "slow": round(t.slow.peak_burn, 3)}
                    for name, t in self._tracks.items()}

    def snapshot(self) -> Dict[str, Any]:
        """The /debug/slo payload."""
        now = self._clock()
        with self._lock:
            slos: Dict[str, Any] = {}
            for name, track in self._tracks.items():
                fast, slow = self._burns_locked(track, now)
                slos[name] = {
                    "objective": track.objective,
                    "error_budget": round(track.budget, 6),
                    "state": STATE_LABELS[track.state],
                    "windows": {
                        "fast": {
                            "window_s": track.fast.window_s,
                            "events": track.fast.n,
                            "bad": track.fast.bad,
                            "error_rate": track.fast.error_rate(),
                            "burn_rate": (round(fast, 3)
                                          if fast is not None else None),
                            "peak_burn": round(track.fast.peak_burn, 3),
                        },
                        "slow": {
                            "window_s": track.slow.window_s,
                            "events": track.slow.n,
                            "bad": track.slow.bad,
                            "error_rate": track.slow.error_rate(),
                            "burn_rate": (round(slow, 3)
                                          if slow is not None else None),
                            "peak_burn": round(track.slow.peak_burn, 3),
                        },
                    },
                }
            return {
                "targets": {"ttft_s": self.slo_ttft_s,
                            "tpot_s": self.slo_tpot_s},
                "thresholds": {"page_burn": self.page_burn,
                               "warn_burn": self.warn_burn,
                               "min_events": self.min_events},
                "slos": slos,
                "transitions": list(self._transitions),
            }


class IncidentManager:
    """Anomaly-triggered evidence bundles (module doc).

    ``trigger()`` is the hot-path entry: one short lock for the
    rate-limit decision (cooldown + max-per-hour), then a daemon thread
    does the capture — snapshotting the step ring / engine / recorder,
    fingerprinting the config, optionally kicking an async profiler
    capture, and writing ``INCIDENT_DIR/incident-<id>.json``. Bundles
    live in a bounded ring for ``GET /debug/incidents``; files persist
    past eviction for after-the-fact forensics."""

    def __init__(self, engine=None, recorder=None, dir: str = "./incidents",
                 capacity: int = 32, cooldown_s: float = 300.0,
                 max_per_hour: int = 6, slowest_k: int = 5,
                 profile_seconds: float = 0.0,
                 profile_dir: Optional[str] = None,
                 straggler_streak: int = 3, straggler_window: int = 32,
                 fingerprint: Optional[Dict[str, Any]] = None,
                 metrics=None, logger=None, clock=time.monotonic):
        self.engine = engine
        self.recorder = recorder
        self.dir = dir
        self.capacity = max(1, int(capacity))
        self.cooldown_s = float(cooldown_s)
        self.max_per_hour = max(1, int(max_per_hour))
        self.slowest_k = max(1, int(slowest_k))
        self.profile_seconds = float(profile_seconds)
        # None -> autopsy captures land beside the bundles (dir/profiles);
        # App.enable_incident_autopsy overrides with PROFILE_DIR when set
        self.profile_dir = profile_dir or os.path.join(dir, "profiles")
        self.straggler_streak = max(1, int(straggler_streak))
        self.straggler_window = max(self.straggler_streak,
                                    int(straggler_window))
        self._fingerprint_extra = dict(fingerprint or {})
        self._obs = MetricsHook(metrics, logger=logger)
        self.logger = logger
        self._clock = clock
        self._lock = threading.Lock()
        self._seq = itertools.count(1)
        self._ring: "collections.deque" = collections.deque(
            maxlen=self.capacity)
        self._capture_times: "collections.deque" = collections.deque()
        self._last_capture_at: Optional[float] = None
        self.captured_total = 0
        self.suppressed: Dict[str, int] = {}
        self.triggers: Dict[str, int] = {}
        # flagged-step seq numbers; `streak` of them inside a span of
        # `straggler_window` steps escalates to a trigger
        self._straggler_seqs: "collections.deque" = collections.deque(
            maxlen=self.straggler_streak)
        self._threads: List[threading.Thread] = []

    # -- trigger intake (engine loop thread: O(1), never blocks) --------------
    def trigger(self, kind: str, **ctx) -> Optional[int]:
        """Record an anomaly; returns the incident id when a capture was
        admitted, None when rate-limited. The capture itself runs on a
        daemon thread — this call only takes the bookkeeping lock."""
        now = self._clock()
        with self._lock:
            self.triggers[kind] = self.triggers.get(kind, 0) + 1
            while (self._capture_times
                   and now - self._capture_times[0] > 3600.0):
                self._capture_times.popleft()
            limited = (
                (self._last_capture_at is not None
                 and now - self._last_capture_at < self.cooldown_s)
                or len(self._capture_times) >= self.max_per_hour)
            if limited:
                self.suppressed[kind] = self.suppressed.get(kind, 0) + 1
            else:
                incident_id = next(self._seq)
                self._last_capture_at = now
                self._capture_times.append(now)
        if limited:
            self._obs.counter("app_tpu_incidents_suppressed_total",
                              trigger=kind)
            return None
        self._obs.counter("app_tpu_incidents_total", trigger=kind)
        thread = threading.Thread(
            target=self._capture, args=(incident_id, kind, ctx),
            name=f"incident-{incident_id}", daemon=True)
        with self._lock:
            self._threads = [t for t in self._threads if t.is_alive()]
            self._threads.append(thread)
        thread.start()
        return incident_id

    def note_straggler(self, step: int, **ctx) -> None:
        """Straggler-sentinel feed: escalate to a trigger only when
        `straggler_streak` flagged steps land within `straggler_window`
        steps of each other — one slow iteration is the sentinel's
        (already-counted) business, a STREAK is an incident."""
        try:
            with self._lock:
                self._straggler_seqs.append(int(step))
                full = len(self._straggler_seqs) == self.straggler_streak
                spread = (self._straggler_seqs[-1] - self._straggler_seqs[0]
                          if full else None)
                streak = full and spread < self.straggler_window
                if streak:
                    self._straggler_seqs.clear()
            if streak:
                self.trigger("straggler_streak",
                             flagged_steps=self.straggler_streak,
                             within_steps=self.straggler_window, **ctx)
        except Exception:  # noqa: BLE001 - never disturb the loop
            pass

    def on_slo_page(self, slo: str, **info) -> None:
        """SLOBurnEngine.on_page adapter."""
        self.trigger("slo_page", slo=slo, **info)

    # -- capture (daemon thread) ----------------------------------------------
    def config_fingerprint(self) -> Dict[str, Any]:
        facts: Dict[str, Any] = dict(self._fingerprint_extra)
        engine = self.engine
        if engine is not None:
            try:
                facts.update({
                    "engine": type(engine).__name__,
                    "n_slots": getattr(engine, "n_slots", None),
                    "max_seq_len": getattr(engine, "max_seq_len", None),
                    "prefill_buckets": list(
                        getattr(engine, "prefill_buckets", ()) or ()),
                    "decode_block_size": getattr(engine, "decode_block_size",
                                                 None),
                    "speculative_tokens": getattr(engine,
                                                  "speculative_tokens", None),
                    "chunk_prefill_tokens": getattr(
                        engine, "chunk_prefill_tokens", None),
                    "retry_budget": getattr(engine, "retry_budget", None),
                })
                cfg = getattr(engine, "cfg", None)
                if cfg is not None:
                    import dataclasses

                    facts["model"] = {
                        k: v for k, v in dataclasses.asdict(cfg).items()
                        if isinstance(v, (int, float, str, bool, type(None)))}
            except Exception:  # noqa: BLE001
                pass
        digest = hashlib.sha256(
            json.dumps(facts, sort_keys=True, default=str).encode()
        ).hexdigest()[:16]
        return {"sha256_16": digest, "facts": facts}

    def _capture(self, incident_id: int, kind: str,
                 ctx: Dict[str, Any]) -> None:
        bundle: Dict[str, Any] = {
            "id": incident_id,
            "trigger": kind,
            "context": ctx,
            "captured_at": time.time(),  # lint: clock-ok incident bundles are correlated with external logs by wall time
        }
        engine = self.engine
        recorder = self.recorder or getattr(engine, "recorder", None)
        try:
            steps = getattr(engine, "steps", None)
            if steps is not None:
                bundle["steps"] = steps.snapshot(recent=32)
        except Exception as exc:  # noqa: BLE001 - partial bundles > no bundle
            bundle["steps_error"] = str(exc)
        try:
            if engine is not None:
                from .utilization import engine_snapshot

                bundle["engine"] = engine_snapshot(engine)
        except Exception as exc:  # noqa: BLE001
            bundle["engine_error"] = str(exc)
        try:
            if recorder is not None:
                snap = recorder.snapshot()
                bundle["slo_goodput"] = snap.get("slo")
                bundle["engine_events"] = snap.get("engine_events", [])
                slowest = self._slowest(snap)
                bundle["slowest_requests"] = slowest
                if slowest:
                    # the deep link: the single request most likely to
                    # explain the anomaly, resolvable at
                    # /debug/requests/{id} while it is still in the ring
                    bundle["slowest_request_id"] = slowest[0].get("id")
        except Exception as exc:  # noqa: BLE001
            bundle["recorder_error"] = str(exc)
        try:
            # what WAS the engine loop doing: the host sampling
            # profiler's top loop-thread stacks (tpu/hostprof.py), read
            # at capture time so enable order doesn't matter
            prof = getattr(engine, "hostprof", None)
            if prof is not None:
                bundle["loop_stacks"] = prof.top_loop_stacks()
        except Exception as exc:  # noqa: BLE001
            bundle["hostprof_error"] = str(exc)
        bundle["config_fingerprint"] = self.config_fingerprint()
        bundle["profile"] = self._maybe_profile(incident_id)
        path = None
        try:
            os.makedirs(self.dir, exist_ok=True)
            path = os.path.join(self.dir, f"incident-{incident_id}.json")
            with open(path, "w", encoding="utf-8") as fp:
                json.dump(bundle, fp, indent=1, default=str)
            bundle["path"] = path
        except Exception as exc:  # noqa: BLE001 - keep the in-memory bundle
            bundle["write_error"] = str(exc)
        with self._lock:
            self._ring.append(bundle)
            self.captured_total += 1
        if recorder is not None:
            try:
                recorder.record_engine_event("incident", id=incident_id,
                                             trigger=kind, path=path)
            except Exception:  # noqa: BLE001
                pass
        if self.logger is not None:
            try:
                self.logger.errorf(
                    "incident %d captured (trigger=%s): %s", incident_id,
                    kind, path or "in-memory only")
            except Exception:  # noqa: BLE001
                pass

    def _slowest(self, snap: Dict[str, Any]) -> List[Dict[str, Any]]:
        """K slowest requests: completed ones by TTFT (the blown-budget
        evidence), then the oldest in-flight ones (the still-stuck
        evidence), each tagged with where it was found."""
        done = sorted(
            (r for r in snap.get("recent", []) if "ttft_s" in r),
            key=lambda r: -r["ttft_s"])
        live = snap.get("in_flight", [])  # already oldest-first
        out = []
        for rec in itertools.chain(live, done):
            entry = dict(rec)
            entry["where"] = "in_flight" if rec in live else "recent"
            out.append(entry)
            if len(out) >= self.slowest_k:
                break
        # oldest in-flight first, then slowest completions — the head of
        # the list is the best single suspect either way
        return out

    def _maybe_profile(self, incident_id: int) -> Dict[str, Any]:
        """Kick an async device-trace capture when enabled AND the
        profiler is idle. Busy (a manual capture, an earlier incident) is
        SKIPPED — an incident capture must never wait on the device."""
        if self.profile_seconds <= 0:
            return {"skipped": "disabled"}
        try:
            from . import profiler

            trace_dir, seconds = profiler.start_capture(
                self.profile_seconds, self.profile_dir,
                trigger="incident")
            return {"trace_dir": trace_dir, "seconds": seconds,
                    "status": "capturing"}
        except RuntimeError:
            return {"skipped": "busy"}
        except Exception as exc:  # noqa: BLE001
            return {"skipped": f"error: {exc}"}

    # -- operator surface -----------------------------------------------------
    def wait_idle(self, timeout_s: float = 10.0) -> bool:
        """Block until outstanding captures finish (tests, soak drains)."""
        deadline = time.monotonic() + timeout_s
        with self._lock:
            threads = list(self._threads)
        for thread in threads:
            thread.join(timeout=max(0.0, deadline - time.monotonic()))
        return all(not t.is_alive() for t in threads)

    def index(self) -> Dict[str, Any]:
        """The /debug/incidents payload: newest-first bundle metadata."""
        with self._lock:
            ring = list(self._ring)
            out = {
                "captured_total": self.captured_total,
                "capacity": self.capacity,
                "dir": self.dir,
                "rate_limit": {"cooldown_s": self.cooldown_s,
                               "max_per_hour": self.max_per_hour},
                "triggers": dict(self.triggers),
                "suppressed": dict(self.suppressed),
            }
        out["incidents"] = [
            {"id": b["id"], "trigger": b["trigger"],
             "captured_at": b["captured_at"],
             "slowest_request_id": b.get("slowest_request_id"),
             "path": b.get("path"),
             "profile": (b.get("profile") or {}).get("trace_dir")
             or (b.get("profile") or {}).get("skipped")}
            for b in reversed(ring)]
        return out

    def lookup(self, incident_id: int) -> Optional[Dict[str, Any]]:
        with self._lock:
            for bundle in self._ring:
                if bundle["id"] == incident_id:
                    return bundle
        return None

    def export_trace(self, incident_id: int) -> Optional[Dict[str, Any]]:
        """One bundle's ``slowest_requests`` as a replayable loadgen
        trace document (header fields + ``events``) — the traffic shape
        that blew the SLO, replayable by a load generator. None
        when the id is not in the ring."""
        bundle = self.lookup(incident_id)
        if bundle is None:
            return None
        # local import: loadgen is the traffic plane; the autopsy plane
        # must not hard-depend on it at module import
        from ..loadgen.trace import TRACE_VERSION, events_from_incident

        events = events_from_incident(bundle)
        return {"trace_version": TRACE_VERSION,
                "source": f"incident:{incident_id}",
                "trigger": bundle.get("trigger"),
                "captured_at": bundle.get("captured_at"),
                "events": events}


def register_incident_metrics(metrics) -> None:
    """Register the autopsy-plane instruments on a metrics Manager
    (idempotent — tpu/device.register_metrics also registers them)."""
    for name, desc in (
        ("app_tpu_incidents_total",
         "incident evidence bundles captured, by trigger"),
        ("app_tpu_incidents_suppressed_total",
         "incident triggers suppressed by the capture rate limit "
         "(cooldown / max-per-hour), by trigger"),
    ):
        try:
            if metrics.get(name) is None:
                metrics.new_counter(name, desc)
        except Exception:  # noqa: BLE001 - already registered
            pass
    for name, desc in (
        ("app_tpu_slo_burn_rate",
         "SLO error-budget burn rate (error rate / budget) by slo and "
         "window (fast/slow)"),
        ("app_tpu_slo_alert_state",
         "SLO alert state by slo: 0 ok, 1 warn, 2 page (both-windows "
         "burn rule)"),
    ):
        try:
            if metrics.get(name) is None:
                metrics.new_gauge(name, desc)
        except Exception:  # noqa: BLE001
            pass


def install_routes(app, burn: SLOBurnEngine, incidents: IncidentManager,
                   slo_path: str = "/debug/slo",
                   incidents_path: str = "/debug/incidents") -> None:
    """Register the autopsy-plane endpoints on a App (the
    flight-recorder install_routes idiom)."""
    from ..http.errors import HTTPError

    @app.get(slo_path)
    def debug_slo(ctx):  # noqa: ANN001
        return burn.snapshot()

    @app.get(incidents_path)
    def debug_incidents(ctx):  # noqa: ANN001
        return incidents.index()

    @app.get(incidents_path + "/{id}")
    def debug_incident_detail(ctx):  # noqa: ANN001
        raw = ctx.request.path_param("id")
        try:
            incident_id = int(raw)
        except (TypeError, ValueError) as exc:
            raise HTTPError(f"invalid incident id {raw!r}",
                            status_code=400) from exc
        bundle = incidents.lookup(incident_id)
        if bundle is None:
            raise HTTPError(
                f"incident {incident_id} not in the ring (the last "
                f"{incidents.capacity} bundles; older files persist "
                f"under {incidents.dir})", status_code=404)
        return bundle

    @app.get(incidents_path + "/{id}/trace")
    def debug_incident_trace(ctx):  # noqa: ANN001
        raw = ctx.request.path_param("id")
        try:
            incident_id = int(raw)
        except (TypeError, ValueError) as exc:
            raise HTTPError(f"invalid incident id {raw!r}",
                            status_code=400) from exc
        trace = incidents.export_trace(incident_id)
        if trace is None:
            raise HTTPError(f"incident {incident_id} not in the ring",
                            status_code=404)
        return trace

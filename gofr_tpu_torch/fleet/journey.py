"""Router-side journey recorder and the cross-hop waterfall.

Ports ``gofr_tpu/fleet/journey.py`` whole: ``JourneyRecord``,
``JourneyRecorder``, ``register_journey_metrics`` and ``install_routes``
(``GET /debug/journey`` and ``GET /debug/journey/{id}`` on the router).

The router alone sees a request's whole story: which replicas were tried
and why, where it committed, when the first byte came back, whether the
stream broke. ``JourneyRecorder`` keeps it in a bounded live / done ring
of per-forward records (route decisions, retries with their reasons, the
upstream status, TTFB, stream duration, the terminal outcome), keyed by a
router journey id and by the W3C trace id the tracer middleware threads
end to end.

``assemble`` turns one record into the cross-hop waterfall: the router's
hops (a ``route`` hop per attempt with its outcome, the ``stream`` window,
a terminal ``finish`` or ``stream_break``) merged with each committed
replica's ``/debug/journey/{trace_id}`` (its queue, prefill, decode and
finish hops), fetched over the registry's short-timeout probe clients and
causally ordered by ``tpu/journey.order_hops``. A replica that cannot
answer degrades to a journey whose ``missing`` names it; assembly never
fails the read. Every recording hook is O(1) under one short lock and
swallows its own failures: journey accounting never breaks serving.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Any, Dict, List, Optional

from ..tpu.journey import is_trace_id, order_hops
from ..tpu.obs import MetricsHook

DEFAULT_CAPACITY = 256

# terminal outcomes a journey can reach
OUTCOME_OK = "ok"
OUTCOME_STREAM_BREAK = "stream_break"
OUTCOME_NO_REPLICA = "no_replica"
OUTCOME_UPSTREAM_ERROR = "upstream_error"


class JourneyRecord:
    """One forwarded request, as the router saw it."""

    __slots__ = ("id", "trace_id", "qos_class", "tenant", "prompt_chars",
                 "wall0", "mono0", "attempts", "replica", "status",
                 "first_chunk_at", "finished_at", "chunks", "outcome",
                 "error")

    def __init__(self, journey_id: int, trace_id: Optional[str],
                 qos_class: Optional[str], tenant: Optional[str],
                 prompt_chars: int) -> None:
        self.id = journey_id
        self.trace_id = trace_id
        self.qos_class = qos_class
        self.tenant = tenant
        self.prompt_chars = prompt_chars
        # wall/mono anchor pair (the flight-recorder idiom): stamps are
        # monotonic, rendered as epochs only at the display boundary
        self.wall0 = time.time()  # lint: clock-ok the designated wall/mono anchor pair
        self.mono0 = time.monotonic()
        self.attempts: List[Dict[str, Any]] = []
        self.replica: Optional[str] = None  # committed replica
        self.status: Optional[int] = None   # upstream HTTP status
        self.first_chunk_at: Optional[float] = None
        self.finished_at: Optional[float] = None
        self.chunks = 0
        self.outcome: Optional[str] = None
        self.error: Optional[str] = None

    def wall(self, t_mono: float) -> float:
        return self.wall0 + (t_mono - self.mono0)

    def ttfb_s(self) -> Optional[float]:
        if self.first_chunk_at is None:
            return None
        return max(0.0, self.first_chunk_at - self.mono0)

    def stream_s(self) -> Optional[float]:
        if self.finished_at is None or self.first_chunk_at is None:
            return None
        return max(0.0, self.finished_at - self.first_chunk_at)

    def summary(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "id": self.id,
            "started_at": round(self.wall0, 6),
            "attempts": list(self.attempts),
            "chunks": self.chunks,
        }
        for key in ("trace_id", "qos_class", "tenant", "replica", "status",
                    "outcome", "error"):
            value = getattr(self, key)
            if value is not None:
                out[key] = value
        ttfb = self.ttfb_s()
        if ttfb is not None:
            out["ttfb_s"] = round(ttfb, 6)
        stream = self.stream_s()
        if stream is not None:
            out["stream_s"] = round(stream, 6)
        if self.finished_at is not None:
            out["total_s"] = round(
                max(0.0, self.finished_at - self.mono0), 6)
        return out

    def router_hops(self) -> List[Dict[str, Any]]:
        """The router's contribution to the waterfall: one route hop per
        attempt + the terminal hop (stream_break keeps its own name so a
        broken journey is explicit at a glance)."""
        hops: List[Dict[str, Any]] = []
        for attempt in self.attempts:
            t = attempt.get("t", 0.0)
            hops.append({
                "hop": "route", "actor": "router",
                "t_start": round(self.wall(t), 6),
                "t_end": round(self.wall(t), 6), "duration_s": 0.0,
                "request_id": self.id,
                "replica": attempt.get("replica"),
                "reason": attempt.get("reason"),
                "outcome": attempt.get("outcome")})
        if self.first_chunk_at is not None:
            end = (self.finished_at if self.finished_at is not None
                   else self.first_chunk_at)
            hops.append({
                "hop": "stream", "actor": "router",
                "t_start": round(self.wall(self.first_chunk_at), 6),
                "t_end": round(self.wall(end), 6),
                "duration_s": round(max(0.0, end - self.first_chunk_at), 6),
                "request_id": self.id, "replica": self.replica,
                "chunks": self.chunks})
        if self.outcome is not None:
            t_fin = (self.finished_at if self.finished_at is not None
                     else time.monotonic())
            name = ("stream_break" if self.outcome == OUTCOME_STREAM_BREAK
                    else "finish")
            hop: Dict[str, Any] = {
                "hop": name, "actor": "router",
                "t_start": round(self.wall(t_fin), 6),
                "t_end": round(self.wall(t_fin), 6), "duration_s": 0.0,
                "request_id": self.id, "outcome": self.outcome}
            if self.error is not None:
                hop["error"] = self.error
            hops.append(hop)
        return hops


class JourneyRecorder:
    """Bounded live/done journey store + the assembly fan-out."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY, metrics=None,
                 slo=None) -> None:
        self.capacity = max(1, int(capacity))
        self._lock = threading.Lock()
        self._seq = 0
        self._live: Dict[int, JourneyRecord] = {}
        self._done: "collections.deque[JourneyRecord]" = collections.deque(
            maxlen=self.capacity)
        self._obs = MetricsHook(metrics)
        # fleet SLO tap (fleet/slo.py): every terminal journey feeds the
        # router-observed burn windows — completions, breaks, sheds
        self.slo = slo
        self.finished_total = 0

    def use_slo(self, slo) -> None:
        if slo is not None:
            self.slo = slo

    # -- recording (forwarding path, best-effort) -----------------------------
    def begin(self, trace_id: Optional[str], qos_class: Optional[str],
              tenant: Optional[str], prompt_chars: int = 0):
        try:
            with self._lock:
                self._seq += 1
                rec = JourneyRecord(self._seq, trace_id, qos_class,
                                    tenant, prompt_chars)
                self._live[rec.id] = rec
            return rec
        except Exception:  # noqa: BLE001 - recording is best-effort
            return None

    def attempt(self, rec, replica: str, reason: str,
                outcome: str = "committed") -> None:
        if rec is None:
            return
        try:
            with self._lock:
                rec.attempts.append({"t": time.monotonic(),
                                     "replica": replica, "reason": reason,
                                     "outcome": outcome})
        except Exception:  # noqa: BLE001
            pass

    def attempt_outcome(self, rec, outcome: str) -> None:
        """Re-label the latest attempt after its fate is known (shed /
        connect_error / breaker_open / committed)."""
        if rec is None:
            return
        try:
            with self._lock:
                if rec.attempts:
                    rec.attempts[-1]["outcome"] = outcome
        except Exception:  # noqa: BLE001
            pass

    def committed(self, rec, replica: str, status: int) -> None:
        if rec is None:
            return
        try:
            with self._lock:
                rec.replica = replica
                rec.status = status
                if rec.attempts:
                    rec.attempts[-1]["outcome"] = "committed"
        except Exception:  # noqa: BLE001
            pass

    def first_chunk(self, rec) -> None:
        if rec is None:
            return
        try:
            with self._lock:
                if rec.first_chunk_at is None:
                    rec.first_chunk_at = time.monotonic()
        except Exception:  # noqa: BLE001
            pass

    def chunk(self, rec) -> None:
        if rec is None:
            return
        rec.chunks += 1  # single writer (the pass-through generator)

    def finish(self, rec, outcome: str, error: Optional[str] = None) -> None:
        if rec is None:
            return
        try:
            with self._lock:
                live = self._live.pop(rec.id, None)
                if live is None:
                    return  # already terminal
                rec.finished_at = time.monotonic()
                rec.outcome = outcome
                if error is not None:
                    rec.error = str(error)
                self._done.append(rec)
                self.finished_total += 1
            self._obs.counter("app_tpu_journey_total", outcome=outcome)
            ttfb = rec.ttfb_s()
            if ttfb is not None:
                self._obs.hist("app_tpu_journey_ttfb_seconds", ttfb)
            if self.slo is not None:
                self.slo.observe_journey(rec)
        except Exception:  # noqa: BLE001
            pass

    # -- lookup ---------------------------------------------------------------
    def lookup(self, raw_id: str):
        """Journey record by router journey id or 32-hex trace id (the
        newest journey wins a trace shared across client retries)."""
        with self._lock:
            records = list(self._live.values()) + list(self._done)
            if is_trace_id(raw_id):
                trace_id = raw_id.strip().lower()
                matches = [r for r in records if r.trace_id == trace_id]
                return matches[-1] if matches else None
            try:
                journey_id = int(raw_id)
            except (TypeError, ValueError):
                return None
            for rec in records:
                if rec.id == journey_id:
                    return rec
            return None

    def snapshot(self, limit: int = 32) -> Dict[str, Any]:
        with self._lock:
            live = sorted(self._live.values(), key=lambda r: r.mono0)
            done = list(self._done)
        return {
            "capacity": self.capacity,
            "finished_total": self.finished_total,
            "in_flight": [r.summary() for r in live],
            "recent": [r.summary() for r in reversed(done)][:limit],
        }

    # -- cross-hop assembly ---------------------------------------------------
    def assemble(self, rec: JourneyRecord, registry) -> Dict[str, Any]:
        """One record -> the full waterfall: router hops + the committed
        replica's local journey, fetched over its probe client."""
        hops = rec.router_hops()
        replica_payloads: Dict[str, Any] = {}
        missing: List[str] = []
        names = {a.get("replica") for a in rec.attempts
                 if a.get("outcome") == "committed"}
        names.discard(None)
        if rec.replica:
            names.add(rec.replica)
        for name in sorted(names):
            replica = registry.replica(name)
            payload = None
            if replica is not None and rec.trace_id:
                try:
                    resp = replica.probe.get(
                        None, f"/debug/journey/{rec.trace_id}")
                    if resp.status_code == 200:
                        body = resp.json() or {}
                        payload = body.get("data") or body
                except Exception:  # noqa: BLE001 - degrade, never fail the read
                    payload = None
            if payload and payload.get("hops"):
                for hop in payload["hops"]:
                    hop = dict(hop)
                    hop["actor"] = f"{name}:{hop.get('actor', 'engine')}"
                    hops.append(hop)
                replica_payloads[name] = {
                    "requests": payload.get("requests", [])}
            else:
                missing.append(name)
        self._obs.counter("app_tpu_journey_assembled_total",
                          complete=str(not missing).lower())
        return {
            "journey_id": rec.id,
            "trace_id": rec.trace_id,
            "source": "router",
            "journey": rec.summary(),
            "hops": order_hops(hops),
            "replicas": replica_payloads,
            "missing": missing,
            "complete": not missing,
        }


def register_journey_metrics(metrics) -> None:
    """Idempotent registration (the register_fleet_metrics idiom)."""
    try:
        if metrics.get("app_tpu_journey_total") is None:
            metrics.new_counter(
                "app_tpu_journey_total",
                "Forwarded requests gone terminal, by journey outcome")
    except Exception:  # noqa: BLE001 - re-registration is benign
        pass
    try:
        if metrics.get("app_tpu_journey_assembled_total") is None:
            metrics.new_counter(
                "app_tpu_journey_assembled_total",
                "Cross-hop journey assemblies served, by completeness")
    except Exception:  # noqa: BLE001
        pass
    try:
        if metrics.get("app_tpu_journey_ttfb_seconds") is None:
            metrics.new_histogram(
                "app_tpu_journey_ttfb_seconds",
                "Router-observed time to first upstream byte",
                buckets=[0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0])
    except Exception:  # noqa: BLE001
        pass


def install_routes(app, router, path: str = "/debug/journey") -> None:
    """The router's journey surface: GET /debug/journey (live + recent
    index) and GET /debug/journey/{id} (assembled cross-hop waterfall,
    id = router journey id or trace id)."""
    from ..http.errors import HTTPError

    @app.get(path)
    def journey_list(ctx):  # noqa: ANN001, ARG001
        return router.journeys.snapshot()

    @app.get(path + "/{id}")
    def journey_detail(ctx):  # noqa: ANN001
        raw = ctx.request.path_param("id")
        rec = router.journeys.lookup(raw)
        if rec is None:
            raise HTTPError(
                f"no journey for {raw!r} (router journey id or 32-hex "
                f"trace id; the ring keeps the last "
                f"{router.journeys.capacity} journeys)", status_code=404)
        return router.journeys.assemble(rec, router.registry)

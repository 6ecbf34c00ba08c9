"""Per-request flight recorder: engine lifecycle timelines for operators.

A copy of ``gofr_tpu/tpu/flightrecorder.py``, whole: ``RequestRecord``,
``FlightRecorder``, ``register_slo_gauges`` and ``install_routes``
(``GET /debug/requests``, ``/debug/requests/{id}``). It keeps a bounded,
thread-safe ring of per-request event timelines covering what the HTTP
trace cannot see (enqueued, admitted, prefill, first token, decode
blocks, finished), and at each completion:

  * synthesizes the engine child spans (``engine.queue`` /
    ``engine.prefill`` / ``engine.decode``) through the tracer, parented
    under the request's ``tpu.generate`` span (or its inbound
    traceparent), so the spans share the HTTP request's trace id. The
    engine's per-dispatch spans (``tpu.prefill`` / ``tpu.decode`` /
    ``tpu.verify``) stay the engine's; nothing here repeats them;
  * folds the request into a rolling SLO window and publishes the goodput
    gauges (``app_tpu_slo_ttft_goodput`` / ``app_tpu_slo_tpot_goodput``):
    the fraction of recent requests meeting the TTFT and TPOT targets.

Every public call is best-effort: one short lock, O(1) work, failures
swallowed. Decode events are batched per dispatch sync, never per token;
memory is capped by ``capacity`` records of ``max_events`` events. A
record of a request admitted through ``submit_handoff`` (a disaggregated
decode half, or a migration's landing) carries ``handoff``, and its
engine spans start with one ``engine.handoff`` span over the hop.
``use_burn_engine`` taps the SLO
burn engine (tpu/incidents.py): every completion is observed at
``record_finished``, and every ``stall_shed`` / ``breaker_shed`` engine
event counts as an availability failure.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Any, Dict, List, Optional

from .obs import MetricsHook

# north-star defaults (ROADMAP.md): p50 TTFT < 150 ms; TPOT sized for
# ~20 tok/s/stream — deployments tune both via enable_flight_recorder
DEFAULT_TTFT_TARGET_S = 0.150
DEFAULT_TPOT_TARGET_S = 0.050


class RequestRecord:
    """One request's lifecycle: identity, phase stamps, bounded events.

    Clock discipline: every stamp is ``time.monotonic()`` (the engine's
    clock domain — NTP can never corrupt the interval math), plus ONE
    wall/monotonic anchor pair captured at enqueue. Epoch timestamps are
    derived through the anchor only where they leave the process: the
    summary/detail display and synthesized spans."""

    __slots__ = ("id", "prompt_tokens", "max_new_tokens", "priority",
                 "trace_id", "parent_span_id", "enqueued_at", "admitted_at",
                 "first_token_at", "finished_at", "generated", "outcome",
                 "error", "slot", "bucket", "batch_id", "chunked", "handoff",
                 "events", "events_dropped", "wall0", "mono0")

    def __init__(self, request) -> None:
        self.id = request.id
        self.prompt_tokens = len(request.prompt_tokens)
        self.max_new_tokens = request.max_new_tokens
        self.priority = request.priority
        self.trace_id: Optional[str] = None
        self.parent_span_id: Optional[str] = None
        self.enqueued_at = request.enqueued_at
        # wall/monotonic anchor: the ONE place both clocks are read
        # together; every displayed epoch is enqueue-wall + monotonic delta
        self.wall0 = time.time()  # the wall/mono anchor pair
        self.mono0 = time.monotonic()
        self.admitted_at: Optional[float] = None
        self.first_token_at: Optional[float] = None
        self.finished_at: Optional[float] = None
        self.generated = 0
        self.outcome: Optional[str] = None
        self.error: Optional[str] = None
        self.slot: Optional[int] = None
        self.bucket: Optional[int] = None
        self.batch_id: Optional[int] = None
        self.chunked = False
        # disaggregated hand-off (tpu/disagg.py): this record covers the
        # DECODE half of a request whose prefill (and first token) ran on
        # another engine — the first-token stamp carried over anchors the
        # decode-side TPOT at hand-off receipt, and span synthesis swaps
        # queue/prefill for a single engine.handoff span on the same trace
        self.handoff = bool(getattr(request, "disagg_handoff", False))
        if self.handoff and getattr(request, "first_token_at", None):
            self.first_token_at = request.first_token_at
        self.events: List[tuple] = [(self.enqueued_at, "enqueued", None)]
        self.events_dropped = 0

    def wall(self, t_mono: float) -> float:
        """Epoch rendering of a monotonic stamp through the anchor."""
        return self.wall0 + (t_mono - self.mono0)

    def add_event(self, name: str, data: Optional[Dict[str, Any]],
                  cap: int, t: Optional[float] = None) -> None:
        if len(self.events) >= cap:
            self.events_dropped += 1
            return
        self.events.append((t if t is not None else time.monotonic(),
                            name, data))

    def has_event(self, name: str) -> bool:
        return any(e[1] == name for e in self.events)

    def phases(self) -> Dict[str, float]:
        """Monotonic, non-overlapping phase durations: queue is
        enqueued→admitted, prefill is admitted→first token, decode is
        first token→finish. A phase a request never reached is absent."""
        out: Dict[str, float] = {}
        if self.admitted_at is not None:
            out["queue_s"] = max(0.0, self.admitted_at - self.enqueued_at)
            if self.first_token_at is not None:
                out["prefill_s"] = max(
                    0.0, self.first_token_at - self.admitted_at)
                if self.finished_at is not None:
                    out["decode_s"] = max(
                        0.0, self.finished_at - self.first_token_at)
        if self.finished_at is not None:
            out["total_s"] = max(0.0, self.finished_at - self.enqueued_at)
        return out

    def ttft_s(self) -> Optional[float]:
        if self.first_token_at is None:
            return None
        return max(0.0, self.first_token_at - self.enqueued_at)

    def tpot_s(self) -> Optional[float]:
        """Mean decode-phase seconds per token past the first; None until
        a request has finished with at least two tokens."""
        if (self.finished_at is None or self.first_token_at is None
                or self.generated < 2):
            return None
        return max(0.0, (self.finished_at - self.first_token_at)
                   / (self.generated - 1))

    def summary(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "id": self.id,
            "prompt_tokens": self.prompt_tokens,
            "max_new_tokens": self.max_new_tokens,
            "generated": self.generated,
            # displayed as epoch via the anchor (stored stamp is monotonic)
            "enqueued_at": round(self.wall(self.enqueued_at), 6),
            "phases": self.phases(),
        }
        for key in ("outcome", "error", "slot", "bucket", "batch_id",
                    "trace_id"):
            value = getattr(self, key)
            if value is not None:
                out[key] = value
        if self.priority:
            out["priority"] = self.priority
        if self.chunked:
            out["chunked"] = True
        if self.handoff:
            out["handoff"] = True
        ttft = self.ttft_s()
        if ttft is not None:
            out["ttft_s"] = round(ttft, 6)
        tpot = self.tpot_s()
        if tpot is not None:
            out["tpot_s"] = round(tpot, 6)
        return out

    def detail(self) -> Dict[str, Any]:
        out = self.summary()
        out["events"] = [
            {"t": round(self.wall(t), 6), "event": name, **(data or {})}
            for t, name, data in self.events
        ]
        if self.events_dropped:
            out["events_dropped"] = self.events_dropped
        return out


class FlightRecorder:
    """Bounded, thread-safe per-request timeline store (see module doc).

    One instance per engine, shared with the /debug/requests routes. All
    ``record_*`` methods are hot-path safe: O(1) under one lock and
    best-effort (a recording failure is swallowed, like MetricsHook)."""

    def __init__(self, capacity: int = 256, max_events: int = 512,
                 slo_ttft_s: float = DEFAULT_TTFT_TARGET_S,
                 slo_tpot_s: float = DEFAULT_TPOT_TARGET_S,
                 slo_window: int = 256, metrics=None, tracer=None):
        self.capacity = max(1, int(capacity))
        self.max_events = max(8, int(max_events))
        self.slo_ttft_s = float(slo_ttft_s)
        self.slo_tpot_s = float(slo_tpot_s)
        self._lock = threading.Lock()
        self._live: Dict[int, RequestRecord] = {}
        self._done: "collections.deque[RequestRecord]" = collections.deque(
            maxlen=self.capacity)
        # (ttft_s|None, tpot_s|None) of recent completions: the goodput
        # window; sized independently of the ring so a small ring can
        # still back a stable gauge
        self._slo: "collections.deque" = collections.deque(
            maxlen=max(1, int(slo_window)))
        # engine-level happenings not owned by one request (cache growth,
        # stragglers, stall sheds): small and recent-only
        self._engine_events: "collections.deque" = collections.deque(
            maxlen=64)
        self._obs = MetricsHook(metrics)
        self.tracer = tracer
        # the SLO burn-rate engine (tpu/incidents.py): None until wired
        self.burn = None
        # terminal events ever recorded: ring eviction never decrements
        # it, so tests (and operators) can assert none were lost
        self.finished_total = 0

    # -- wiring (late binding for injected engines) ---------------------------
    def use_metrics(self, metrics) -> None:
        if metrics is not None:
            self._obs = MetricsHook(metrics)

    def use_tracer(self, tracer) -> None:
        if tracer is not None:
            self.tracer = tracer

    def use_burn_engine(self, burn) -> None:
        if burn is not None:
            self.burn = burn

    # -- recording (engine-facing, best-effort) -------------------------------
    def record_enqueued(self, request) -> None:
        try:
            rec = RequestRecord(request)
            # inbound trace context, most specific first: the engine's own
            # tpu.generate span (child of the HTTP span, so it carries the
            # inbound trace id), the HTTP span itself, or a raw W3C
            # traceparent header propagated through GenerationRequest
            span = getattr(request, "gen_span", None) or request.span
            if span is not None:
                rec.trace_id = span.trace_id
                rec.parent_span_id = span.span_id
            else:
                header = getattr(request, "traceparent", None)
                if header:
                    from ..tracing import parse_traceparent

                    parsed = parse_traceparent(header)
                    if parsed:
                        rec.trace_id, rec.parent_span_id = parsed
            with self._lock:
                self._live[request.id] = rec
        except Exception:  # noqa: BLE001 - recording is best-effort
            pass

    def record_admitted(self, request, slot: int, bucket: int,
                        batch_id: Optional[int] = None,
                        chunked: bool = False) -> None:
        try:
            with self._lock:
                rec = self._live.get(request.id)
                if rec is None:
                    return
                if batch_id is not None:
                    rec.batch_id = batch_id
                if rec.admitted_at is not None:
                    return  # chunk path: admitted at chunk 1, bound later
                rec.admitted_at = request.admitted_at or time.monotonic()
                rec.slot = slot
                rec.bucket = bucket
                rec.chunked = chunked
                rec.add_event("admitted", {"slot": slot, "bucket": bucket},
                              self.max_events, t=rec.admitted_at)
        except Exception:  # noqa: BLE001
            pass

    def record_event(self, request_id: int, name: str, once: bool = False,
                     **data) -> None:
        try:
            with self._lock:
                rec = self._live.get(request_id)
                if rec is None or (once and rec.has_event(name)):
                    return
                rec.add_event(name, data or None, self.max_events)
        except Exception:  # noqa: BLE001
            pass

    def record_first_token(self, request) -> None:
        try:
            with self._lock:
                rec = self._live.get(request.id)
                if rec is None or rec.first_token_at is not None:
                    return
                rec.first_token_at = (request.first_token_at
                                      or time.monotonic())
                rec.add_event("first_token", None, self.max_events,
                              t=rec.first_token_at)
        except Exception:  # noqa: BLE001
            pass

    def record_decode_block(self, request_id: int, tokens: int,
                            step_s: float) -> None:
        """One event per request per dispatch SYNC (a whole executed block
        of decode steps), never per token — the hot-path batching rule."""
        try:
            with self._lock:
                rec = self._live.get(request_id)
                if rec is None:
                    return
                rec.add_event("decode_block",
                              {"tokens": int(tokens),
                               "step_s": round(float(step_s), 6)},
                              self.max_events)
        except Exception:  # noqa: BLE001
            pass

    def record_finished(self, request, reason: str) -> None:
        try:
            with self._lock:
                rec = self._live.pop(request.id, None)
                if rec is None:
                    return
                rec.finished_at = request.finished_at or time.monotonic()
                rec.generated = request.generated
                rec.outcome = reason
                if request.error is not None:
                    rec.error = str(request.error)
                rec.add_event("finished", {"reason": reason},
                              self.max_events, t=rec.finished_at)
                self.finished_total += 1
                self._done.append(rec)
                self._slo.append((rec.ttft_s(), rec.tpot_s()))
                stats = self._slo_stats_locked()
            if stats["ttft_goodput"] is not None:
                self._obs.gauge("app_tpu_slo_ttft_goodput",
                                stats["ttft_goodput"])
            if stats["tpot_goodput"] is not None:
                self._obs.gauge("app_tpu_slo_tpot_goodput",
                                stats["tpot_goodput"])
            if self.burn is not None:
                # outcome "error"/"aborted" spends availability budget; a
                # cancel is the client's choice, not a served failure
                self.burn.observe_request(
                    rec.ttft_s(), rec.tpot_s(),
                    error=(rec.error is not None
                           or reason in ("error", "aborted")))
            self._emit_spans(rec)
        except Exception:  # noqa: BLE001
            pass

    def record_engine_event(self, name: str, **data) -> None:
        try:
            with self._lock:
                # operator-facing wall stamp, correlated with external logs
                self._engine_events.append(
                    {"t": time.time(), "event": name, **data})
            if self.burn is not None and name in ("stall_shed",
                                                  "breaker_shed"):
                # a shed request never reaches record_finished: count the
                # refusal against the availability budget here
                self.burn.observe_shed()
        except Exception:  # noqa: BLE001
            pass

    # -- span synthesis -------------------------------------------------------
    def _emit_spans(self, rec: RequestRecord) -> None:
        """Child spans for the phases the request actually reached, in
        phase order, sharing the inbound trace id. Runs once, after the
        record went terminal (outside the recorder lock)."""
        tracer = self.tracer
        if tracer is None or rec.trace_id is None:
            return
        # spans leave the process: render the monotonic stamps as epochs
        # through the record's anchor (one linear shift, so phase
        # boundaries stay exactly contiguous)
        end = rec.wall(rec.finished_at if rec.finished_at is not None
                       else time.monotonic())
        attrs = {"request.id": rec.id}
        if rec.batch_id is not None:
            attrs["batch.id"] = rec.batch_id
        if rec.slot is not None:
            attrs["tpu.slot"] = rec.slot
        queue_end = (rec.wall(rec.admitted_at)
                     if rec.admitted_at is not None else end)
        if rec.handoff:
            # disaggregated decode pool: prefill (and the queue the client
            # saw) ran on the OTHER engine, whose recorder already emitted
            # those spans on this same trace id. This record's pre-admit
            # window is the hop itself — receipt, blob validation, the
            # H2D landing — so synthesize it as engine.handoff, then the
            # decode span; an engine.queue/engine.prefill pair here would
            # double-count phases the request never spent on this pool
            tracer.span_at("engine.handoff", rec.wall(rec.enqueued_at),
                           queue_end, trace_id=rec.trace_id,
                           parent_id=rec.parent_span_id,
                           attributes=dict(attrs,
                                           outcome=rec.outcome or ""))
            if rec.admitted_at is None:
                return
            tracer.span_at("engine.decode", rec.wall(rec.admitted_at), end,
                           trace_id=rec.trace_id,
                           parent_id=rec.parent_span_id,
                           attributes=dict(attrs, **{
                               "tpu.tokens": rec.generated,
                               "outcome": rec.outcome or ""}))
            return
        tracer.span_at("engine.queue", rec.wall(rec.enqueued_at), queue_end,
                       trace_id=rec.trace_id, parent_id=rec.parent_span_id,
                       attributes=dict(attrs, outcome=rec.outcome or ""))
        if rec.admitted_at is None:
            return
        prefill_end = (rec.wall(rec.first_token_at)
                       if rec.first_token_at is not None else end)
        pattrs = dict(attrs)
        if rec.bucket is not None:
            pattrs["tpu.prefill_bucket"] = rec.bucket
        if rec.chunked:
            pattrs["tpu.chunked"] = True
        tracer.span_at("engine.prefill", rec.wall(rec.admitted_at),
                       prefill_end,
                       trace_id=rec.trace_id, parent_id=rec.parent_span_id,
                       attributes=pattrs)
        if rec.first_token_at is None:
            return
        tracer.span_at("engine.decode", rec.wall(rec.first_token_at), end,
                       trace_id=rec.trace_id, parent_id=rec.parent_span_id,
                       attributes=dict(attrs, **{
                           "tpu.tokens": rec.generated,
                           "outcome": rec.outcome or ""}))

    # -- operator surface -----------------------------------------------------
    def _slo_stats_locked(self) -> Dict[str, Any]:
        ttfts = [t for t, _ in self._slo if t is not None]
        tpots = [t for _, t in self._slo if t is not None]
        return {
            "window": len(self._slo),
            "ttft_target_s": self.slo_ttft_s,
            "tpot_target_s": self.slo_tpot_s,
            "ttft_goodput": (round(sum(
                1 for t in ttfts if t <= self.slo_ttft_s) / len(ttfts), 4)
                if ttfts else None),
            "tpot_goodput": (round(sum(
                1 for t in tpots if t <= self.slo_tpot_s) / len(tpots), 4)
                if tpots else None),
        }

    def slo_stats(self) -> Dict[str, Any]:
        with self._lock:
            return self._slo_stats_locked()

    def snapshot(self) -> Dict[str, Any]:
        """The /debug/requests payload: in-flight + recent completions
        (newest first) with phase timings, SLO goodput, engine events."""
        with self._lock:
            live = sorted(self._live.values(), key=lambda r: r.enqueued_at)
            return {
                "in_flight": [r.summary() for r in live],
                "recent": [r.summary() for r in reversed(self._done)],
                "slo": self._slo_stats_locked(),
                "engine_events": list(self._engine_events),
                "capacity": self.capacity,
                "finished_total": self.finished_total,
            }

    def timeline_records(self) -> List[Dict[str, Any]]:
        """Request milestones in the RAW monotonic domain (no wall
        rendering), completed then live, for the timeline exporter's flow
        events (tpu/timeline.py). detail()/summary() render epochs for
        humans; trace-event ``ts`` stays monotonic so one payload-level
        anchor aligns everything at the stitching boundary."""
        with self._lock:
            recs = list(self._done) + sorted(self._live.values(),
                                             key=lambda r: r.enqueued_at)
            return [{
                "id": r.id,
                "trace_id": r.trace_id,
                "enqueued_at": r.enqueued_at,
                "admitted_at": r.admitted_at,
                "first_token_at": r.first_token_at,
                "finished_at": r.finished_at,
                "generated": r.generated,
                "outcome": r.outcome,
                "handoff": r.handoff,
            } for r in recs]

    def lookup(self, request_id: int) -> Optional[Dict[str, Any]]:
        with self._lock:
            rec = self._live.get(request_id)
            if rec is None:
                for done in self._done:
                    if done.id == request_id:
                        rec = done
                        break
            return rec.detail() if rec is not None else None

    def lookup_trace(self, trace_id: str) -> List[Dict[str, Any]]:
        """Every record (live + done) sharing a W3C trace id, oldest
        first. A trace can own several records on one recorder (retried
        requests) and across recorders (the disagg prefill/decode halves
        each record the same inbound trace) — the journey assembler
        (tpu/journey.py, fleet/journey.py) stitches them by this key."""
        if not trace_id:
            return []
        with self._lock:
            records = [r for r in self._done if r.trace_id == trace_id]
            records.extend(r for r in self._live.values()
                           if r.trace_id == trace_id)
            records.sort(key=lambda r: r.wall(r.enqueued_at))
            return [r.detail() for r in records]

    def __len__(self) -> int:
        with self._lock:
            return len(self._live) + len(self._done)


def register_slo_gauges(metrics) -> None:
    """Register the goodput gauges on a metrics Manager (idempotent)."""
    for name, desc in (
        ("app_tpu_slo_ttft_goodput",
         "fraction of recent requests meeting the TTFT target"),
        ("app_tpu_slo_tpot_goodput",
         "fraction of recent requests meeting the TPOT target"),
    ):
        try:
            if metrics.get(name) is None:  # TPUClient may have registered
                metrics.new_gauge(name, desc)
        except Exception:  # noqa: BLE001 - already registered
            pass


def install_routes(app, recorder: FlightRecorder,
                   path: str = "/debug/requests") -> None:
    """Register the flight-recorder endpoints on an App."""
    from ..http.errors import HTTPError

    @app.get(path)
    def flight_requests(ctx):  # noqa: ANN001
        return recorder.snapshot()

    @app.get(path + "/{id}")
    def flight_request_detail(ctx):  # noqa: ANN001
        raw = ctx.request.path_param("id")
        try:
            request_id = int(raw)
        except (TypeError, ValueError) as exc:
            raise HTTPError(f"invalid request id {raw!r}",
                            status_code=400) from exc
        detail = recorder.lookup(request_id)
        if detail is None:
            raise HTTPError(
                f"request {request_id} not in the flight recorder "
                f"(ring keeps the last {recorder.capacity} completions)",
                status_code=404)
        return detail

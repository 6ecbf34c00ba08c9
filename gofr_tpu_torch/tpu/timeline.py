"""Performance timeline export: the engine's rings as one Perfetto trace.

A copy of ``gofr_tpu/tpu/timeline.py``, whole: ``TimelineExporter``,
``register_timeline_metrics`` and ``install_routes``
(``GET /debug/timeline[?steps=N]``). It renders the flight recorder, the
step ledger and the utilization ledger into ONE Chrome trace-event JSON
payload (what Perfetto and chrome://tracing load):

  * one track per real thread: the engine loop (``llm-engine``), the
    finisher (``llm-finisher``, the engine's off-loop teardown), the HTTP
    server; the loop track carries the
    ``LOOP_ONLY_REGISTRY`` (tpu/ownership.py) in its metadata;
  * every step-ledger record as a ``B``/``E`` slice on the loop track, its
    segments tiled inside in the ledger's canonical order, so the
    durations reproduce the sum identity (segments == step wall);
  * a ``device`` track where each dispatch-to-sync busy interval of the
    utilization ledger is one slice (the busy-union watermark keeps them
    disjoint);
  * the executor's program captures after boot as complete (``X``) events
    on their own track (``graph-capture``; the reference's
    ``xla-compile``), taken live by chaining ``Executor.on_compile``;
  * per-request FLOW events (``s``/``t``/``f``) from enqueued through
    admitted and first token to finished, keyed by the W3C trace id when
    the request carried one, plus one async ``request`` slice each;
  * the recorder's engine events (cache growth, stragglers, sheds) as
    instant events on the loop track.

Every ``ts`` is the monotonic clock in microseconds; the payload carries
one wall/monotonic anchor pair so another process can map it onto the
wall clock with one shift. A disaggregated pair's prefill engine (DISAGG_MODE=both) joins with its
own tid block at ``PREFILL_BASE``.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from .obs import MetricsHook
from .ownership import LOOP_ONLY_REGISTRY
from .stepledger import SEGMENTS

# stable track ids (tids) inside the exported pid; a disaggregated pair's
# prefill engine gets the same layout at base + PREFILL_BASE
LOOP_TID = 1
FINISHER_TID = 2
HTTP_TID = 3
DEVICE_TID = 4
COMPILE_TID = 5
REQUEST_TID = 6
PREFILL_BASE = 10

DEFAULT_STEPS = 128
MAX_COMPILE_EVENTS = 256


def _us(t_mono: float) -> float:
    """Monotonic seconds -> trace-event microseconds."""
    return round(t_mono * 1e6, 1)


class TimelineExporter:
    """Renders one engine's observability rings as trace-event JSON.

    Construction is cheap and side-effect free except for one thing: each
    rendered engine's executor ``on_compile`` callback is chained so
    capture completions are recorded with their stamps (the program table
    keeps durations, not stamps). The chained hook keeps the engine's own
    re-attribution callback."""

    def __init__(self, engine, process_name: str = "llm-server",
                 pid: int = 1, max_steps: int = DEFAULT_STEPS,
                 metrics=None):
        self.engine = engine
        self.process_name = str(process_name)
        self.pid = int(pid)
        self.max_steps = max(1, int(max_steps))
        self._obs = MetricsHook(metrics)
        self.exports_total = 0
        # per-tid-base (t_mono_end, name, seconds) compile completions
        self._compiles: Dict[int, "collections.deque"] = {}
        self._compile_lock = threading.Lock()
        for eng, base, _label in self._engines():
            self._compiles[base] = collections.deque(
                maxlen=MAX_COMPILE_EVENTS)
            self._chain_compile_hook(eng, base)

    def use_metrics(self, metrics) -> None:
        if metrics is not None:
            self._obs = MetricsHook(metrics)

    def _engines(self) -> List[Tuple[Any, int, str]]:
        """(engine, tid_base, track label prefix) for every engine this
        process runs: the serving engine (and a disaggregated pair's
        prefill engine, where one is wired)."""
        out: List[Tuple[Any, int, str]] = [(self.engine, 0, "")]
        disagg = getattr(self.engine, "disagg_router", None)
        prefill = (getattr(disagg, "prefill_engine", None)
                   if disagg is not None else None)
        if prefill is not None and prefill is not self.engine:
            out.append((prefill, PREFILL_BASE, "prefill:"))
        return out

    # -- compile capture ------------------------------------------------------
    def _chain_compile_hook(self, engine, base: int) -> None:
        executor = getattr(engine, "executor", None)
        if executor is None:
            return
        prev = getattr(executor, "on_compile", None)

        def _on_compile(name: str, seconds: float, _prev=prev) -> None:
            self.note_compile(name, seconds, base=base)
            if _prev is not None:
                _prev(name, seconds)

        executor.on_compile = _on_compile

    def note_compile(self, name: str, seconds: float,
                     base: int = 0) -> None:
        """Record a finished compile (called from whichever thread
        compiled — the deque append is locked and O(1))."""
        try:
            with self._compile_lock:
                self._compiles[base].append(
                    (time.monotonic(), str(name), float(seconds)))
        except Exception:  # noqa: BLE001 - capture is best-effort
            pass

    # -- track metadata -------------------------------------------------------
    def _thread_names(self, engine, base: int,
                      label: str) -> Dict[int, str]:
        loop_thread = getattr(engine, "_thread", None)
        finisher = getattr(engine, "_finisher", None)
        finisher_thread = getattr(finisher, "_thread", None)
        names = {
            base + LOOP_TID: label + (getattr(loop_thread, "name", None)
                                      or "llm-engine"),
            base + FINISHER_TID: label + (
                getattr(finisher_thread, "name", None) or "llm-finisher"),
            base + HTTP_TID: label + "http-server",
            base + DEVICE_TID: label + "device",
            base + COMPILE_TID: label + "graph-capture",
            base + REQUEST_TID: label + "requests",
        }
        if base == 0:
            for t in threading.enumerate():
                if t.name.startswith("http-server"):
                    names[HTTP_TID] = t.name
                    break
        return names

    def _metadata(self) -> List[Dict[str, Any]]:
        events: List[Dict[str, Any]] = [{
            "ph": "M", "name": "process_name", "pid": self.pid, "tid": 0,
            "ts": 0, "args": {"name": self.process_name}}]
        for engine, base, label in self._engines():
            for tid, name in sorted(
                    self._thread_names(engine, base, label).items()):
                args: Dict[str, Any] = {"name": name}
                if tid == base + LOOP_TID:
                    # the ownership contract, attached to the track it
                    # guards: the functions pinned to this thread
                    args["loop_only"] = sorted(LOOP_ONLY_REGISTRY)
                events.append({"ph": "M", "name": "thread_name",
                               "pid": self.pid, "tid": tid, "ts": 0,
                               "args": args})
        return events

    # -- sections -------------------------------------------------------------
    def _step_events(self, engine, base: int,
                     steps: int) -> List[Dict[str, Any]]:
        ledger = getattr(engine, "steps", None)
        if ledger is None or not hasattr(ledger, "records"):
            return []
        tid = base + LOOP_TID
        events: List[Dict[str, Any]] = []
        for rec in ledger.records(recent=steps):
            t0 = rec.started_at
            if rec.idle_gap_s > 0.0:
                events.append({
                    "ph": "X", "name": "idle", "cat": "idle",
                    "pid": self.pid, "tid": tid,
                    "ts": _us(t0 - rec.idle_gap_s),
                    "dur": round(rec.idle_gap_s * 1e6, 1),
                    "args": {"idle_gap_s": round(rec.idle_gap_s, 6)}})
            args: Dict[str, Any] = {
                "step": rec.seq, "wall_s": round(rec.wall_s, 6),
                "tokens": rec.tokens, "active_slots": rec.active_slots,
                "queue_depth": rec.queue_depth}
            if rec.straggler:
                args["straggler"] = True
                args["cause"] = rec.cause
            if rec.slowest_request_id is not None:
                args["slowest_request_id"] = rec.slowest_request_id
            events.append({"ph": "B", "name": f"step:{rec.phase}",
                           "cat": "step", "pid": self.pid, "tid": tid,
                           "ts": _us(t0), "args": args})
            # segments tiled sequentially in canonical order: durations
            # reproduce the ledger's sum identity (they fill the parent
            # slice exactly, `other` residual included)
            cursor = t0
            ordered = [s for s in SEGMENTS if s in rec.segments]
            ordered += sorted(s for s in rec.segments if s not in SEGMENTS)
            for seg in ordered:
                dur = rec.segments[seg]
                if dur <= 0.0:
                    continue
                events.append({"ph": "B", "name": seg, "cat": "segment",
                               "pid": self.pid, "tid": tid,
                               "ts": _us(cursor),
                               "args": {"seconds": round(dur, 6)}})
                cursor += dur
                events.append({"ph": "E", "pid": self.pid,
                               "tid": tid, "ts": _us(cursor)})
            events.append({"ph": "E", "pid": self.pid, "tid": tid,
                           "ts": _us(t0 + rec.wall_s)})
        return events

    def _device_events(self, engine, base: int,
                       label: str) -> List[Dict[str, Any]]:
        util = getattr(engine, "util", None)
        if util is None or not hasattr(util, "device_slices"):
            return []
        tid = base + DEVICE_TID
        events: List[Dict[str, Any]] = []
        for i, sl in enumerate(util.device_slices()):
            ident = f"{label}dev-{i}"
            args = {"tokens": sl["tokens"],
                    "busy_s": round(sl["busy_s"], 6),
                    "sync_wait_s": round(sl["sync_wait_s"], 6)}
            events.append({"ph": "b", "cat": "device", "id": ident,
                           "name": sl["phase"], "pid": self.pid,
                           "tid": tid, "ts": _us(sl["start"]),
                           "args": args})
            events.append({"ph": "e", "cat": "device", "id": ident,
                           "name": sl["phase"], "pid": self.pid,
                           "tid": tid, "ts": _us(sl["end"])})
        return events

    def _compile_events(self, base: int) -> List[Dict[str, Any]]:
        with self._compile_lock:
            compiles = list(self._compiles.get(base, ()))
        return [{
            "ph": "X", "name": f"compile:{name}", "cat": "compile",
            "pid": self.pid, "tid": base + COMPILE_TID,
            "ts": _us(end - seconds), "dur": round(seconds * 1e6, 1),
            "args": {"seconds": round(seconds, 6)}}
            for end, name, seconds in compiles]

    def _request_events(self, engine, base: int,
                        label: str) -> List[Dict[str, Any]]:
        recorder = getattr(engine, "recorder", None)
        if recorder is None or not hasattr(recorder, "timeline_records"):
            return []
        events: List[Dict[str, Any]] = []
        for rec in recorder.timeline_records():
            fid = rec["trace_id"] or f"req-{rec['id']}"
            args = {"request_id": rec["id"]}
            if rec["trace_id"]:
                args["trace_id"] = rec["trace_id"]
            if rec["handoff"]:
                args["handoff"] = True
            rid = f"{label}req-{rec['id']}"
            # async lifetime slice on the requests track
            events.append({"ph": "b", "cat": "request", "id": rid,
                           "name": "request", "pid": self.pid,
                           "tid": base + REQUEST_TID,
                           "ts": _us(rec["enqueued_at"]), "args": args})
            # flow origin: enqueued on the HTTP track (where submit ran);
            # _normalize_flows later rewrites s/t/f per flow id
            events.append({"ph": "s", "cat": "flow", "id": fid,
                           "name": "request", "pid": self.pid,
                           "tid": base + HTTP_TID,
                           "ts": _us(rec["enqueued_at"]),
                           "args": dict(args, milestone="enqueued")})
            for milestone, stamp in (("admitted", rec["admitted_at"]),
                                     ("first_token",
                                      rec["first_token_at"])):
                if stamp is None:
                    continue
                if milestone == "first_token" and rec["handoff"]:
                    # carried over from the prefill half; that engine's
                    # own flow step already marks it at the true site
                    continue
                events.append({"ph": "n", "cat": "request", "id": rid,
                               "name": milestone, "pid": self.pid,
                               "tid": base + REQUEST_TID,
                               "ts": _us(stamp)})
                events.append({"ph": "t", "cat": "flow", "id": fid,
                               "name": "request", "pid": self.pid,
                               "tid": base + LOOP_TID, "ts": _us(stamp),
                               "args": dict(args, milestone=milestone)})
            if rec["finished_at"] is not None:
                end_args = dict(args, milestone="finished",
                                outcome=rec["outcome"],
                                generated=rec["generated"])
                # terminal flow step on the finisher track: completion
                # callbacks are delivered out-of-band there
                events.append({"ph": "f", "bp": "e", "cat": "flow",
                               "id": fid, "name": "request",
                               "pid": self.pid,
                               "tid": base + FINISHER_TID,
                               "ts": _us(rec["finished_at"]),
                               "args": end_args})
                events.append({"ph": "e", "cat": "request", "id": rid,
                               "name": "request", "pid": self.pid,
                               "tid": base + REQUEST_TID,
                               "ts": _us(rec["finished_at"]),
                               "args": end_args})
        return events

    def _engine_events(self, engine, base: int, anchor_wall0: float,
                       anchor_mono0: float) -> List[Dict[str, Any]]:
        recorder = getattr(engine, "recorder", None)
        if recorder is None:
            return []
        try:
            snap_events = recorder.snapshot().get("engine_events", [])
        except Exception:  # noqa: BLE001 - export degrades, never fails
            return []
        events: List[Dict[str, Any]] = []
        for ev in snap_events:
            ev = dict(ev)
            t_wall = ev.pop("t", None)
            name = ev.pop("event", None)
            if t_wall is None or name is None:
                continue
            # engine events are stamped wall-side (operator-log
            # correlation); pull them into the mono domain via the anchor
            t_mono = t_wall - anchor_wall0 + anchor_mono0
            events.append({"ph": "i", "s": "t", "name": name,
                           "cat": "engine_event", "pid": self.pid,
                           "tid": base + LOOP_TID, "ts": _us(t_mono),
                           "args": ev})
        return events

    @staticmethod
    def _normalize_flows(events: List[Dict[str, Any]]) -> None:
        """Rewrite each flow id's events into a well-formed chain: the
        earliest becomes the single ``s``, a terminal ``finished``
        milestone at the end becomes the single ``f``, everything between
        is a ``t``. Needed because a hand-off pair (or router-level
        retries) contributes several raw ``s``/``f`` under one trace
        id."""
        flows: Dict[Any, List[int]] = {}
        for idx, ev in enumerate(events):
            if ev.get("cat") == "flow":
                flows.setdefault(ev.get("id"), []).append(idx)
        for idxs in flows.values():
            idxs.sort(key=lambda i: events[i]["ts"])
            last = len(idxs) - 1
            for j, i in enumerate(idxs):
                ev = events[i]
                ev.pop("bp", None)
                if j == 0:
                    ev["ph"] = "s"
                elif (j == last and ev.get("args", {}).get("milestone")
                        == "finished"):
                    ev["ph"] = "f"
                    ev["bp"] = "e"
                else:
                    ev["ph"] = "t"

    # -- the export -----------------------------------------------------------
    def export(self, steps: Optional[int] = None) -> Dict[str, Any]:
        """One trace-event JSON payload over the last `steps` ledger
        records (default `max_steps`) plus everything else currently in
        the rings. Read-only over every source; safe from any thread."""
        steps = self.max_steps if not steps else max(1, int(steps))
        # the ONE wall/mono anchor pair: a stitcher aligns replicas
        # by mapping each payload's monotonic ts through its own anchor
        wall0 = time.time()
        mono0 = time.monotonic()
        events = self._metadata()
        for engine, base, label in self._engines():
            events += self._step_events(engine, base, steps)
            events += self._device_events(engine, base, label)
            events += self._compile_events(base)
            events += self._request_events(engine, base, label)
            events += self._engine_events(engine, base, wall0, mono0)
        self._normalize_flows(events)
        self.exports_total += 1
        self._obs.counter("app_tpu_timeline_exports_total")
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "clock_domain": "monotonic_us",
            "anchor": {"wall0": round(wall0, 6), "mono0": round(mono0, 6)},
            "pid": self.pid,
            "process": self.process_name,
            "steps_window": steps,
            "events_total": len(events),
        }


def register_timeline_metrics(metrics) -> None:
    """Idempotent registration (the register_step_metrics idiom)."""
    try:
        if metrics.get("app_tpu_timeline_exports_total") is None:
            metrics.new_counter(
                "app_tpu_timeline_exports_total",
                "trace-event timeline exports served by /debug/timeline")
    except Exception:  # noqa: BLE001 - already registered
        pass


def install_routes(app, exporter: TimelineExporter,
                   path: str = "/debug/timeline") -> None:
    """Register GET /debug/timeline on an App."""

    @app.get(path)
    def debug_timeline(ctx):  # noqa: ANN001
        try:
            steps = int(ctx.request.param("steps") or 0)
        except (TypeError, ValueError):
            steps = 0
        return exporter.export(steps=steps or None)

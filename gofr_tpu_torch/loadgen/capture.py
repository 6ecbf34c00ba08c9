"""Trace capture: bounded, best-effort hooks that record what a live
process actually saw as a replayable trace.

Ports ``gofr_tpu/loadgen/capture.py`` whole: ``TraceCapture``,
``install_routes`` and ``install_recorder_trace_route``.

Two sources feed the same exporter:

  * the fleet router — ``FleetRouter.forward`` calls
    ``capture.note(...)`` (None-guarded, the journeys/slo/capacity
    idiom) once per forwarded request, so a router run exports the
    fleet's OBSERVED arrival process;
  * any flight recorder — ``events_from_requests`` over its snapshot
    turns a replica's request ring into the same format
    (``install_recorder_trace_route``).

Privacy is the trace contract's (loadgen/trace.py): ``note``
reduces the prompt to a token-count estimate, a CRC seed, and a CRC of
the leading affinity block as the session key — two requests that
would route to the same replica under prefix affinity capture the same
session id, and no prompt byte survives the call.

Recording discipline is MetricsHook's: one short lock, O(1), failures
swallowed — the forwarding path can never be taken down by its own
observability. ``GET /debug/trace`` serves the export.
"""

from __future__ import annotations

import collections
import threading
import time
import zlib
from typing import Any, Dict, List, Optional, Tuple

from .trace import TRACE_VERSION, events_from_requests, make_event

DEFAULT_CAPACITY = 4096
DEFAULT_BLOCK = 256


class TraceCapture:
    """Bounded ring of arrival observations, exportable as a trace."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 block: int = DEFAULT_BLOCK):
        self.capacity = max(1, int(capacity))
        self.block = max(1, int(block))
        self._lock = threading.Lock()
        self._ring: "collections.deque" = collections.deque(
            maxlen=self.capacity)
        # wall/monotonic anchor pair (the flight-recorder idiom): stamps
        # are monotonic, epochs derived through the anchor at export
        self.wall0 = time.time()
        self.mono0 = time.monotonic()
        self.noted_total = 0
        # session turn counters: conversation linkage without the text
        self._turns: Dict[int, int] = {}

    def note(self, prompt: str, qos_class: Optional[str] = None,
             tenant: Optional[str] = None,
             max_new: Optional[int] = None) -> None:
        """Record one arrival. Hot-path safe: O(len(prompt)) CRC work
        outside the lock, O(1) inside, every failure swallowed."""
        try:
            raw = prompt.encode("utf-8", "replace") if prompt else b""
            session = zlib.crc32(raw[:self.block])
            seed = zlib.crc32(raw)
            tokens = max(1, len(prompt.split())) if prompt else 1
            t = time.monotonic()
            with self._lock:
                self.noted_total += 1
                turn = self._turns.get(session, 0)
                # the turn table is bounded with the ring: a session
                # evicted from the table just restarts at turn 0
                if len(self._turns) >= self.capacity:
                    self._turns.clear()
                self._turns[session] = turn + 1
                self._ring.append((t, qos_class, tenant, session, turn,
                                   tokens, seed, max_new or 1))
        except Exception:  # noqa: BLE001 - capture is best-effort
            pass

    def export(self) -> Tuple[Dict[str, Any], List[Dict[str, Any]]]:
        """(header, events) with arrival times rebased to the first
        captured event."""
        with self._lock:
            rows = list(self._ring)
            noted = self.noted_total
        events: List[Dict[str, Any]] = []
        t0 = rows[0][0] if rows else 0.0
        for (t, cls, tenant, session, turn, tokens, seed, max_new) in rows:
            events.append(make_event(
                t=t - t0, prompt_tokens=tokens, seed=seed, max_new=max_new,
                cls=cls, tenant=tenant, session=session, turn=turn))
        header = {
            "trace_version": TRACE_VERSION,
            "source": "capture",
            "events": len(events),
            "captured_total": noted,
            "capacity": self.capacity,
            # epoch of the first exported arrival, through the anchor
            "t0_epoch": round(self.wall0 + (t0 - self.mono0), 3),
        }
        return header, events

    def reset(self) -> None:
        """Drop everything captured so far (harnesses call this between
        a warm-up phase and the measured run so the export holds only
        the traffic under test); the noted_total odometer keeps
        counting."""
        with self._lock:
            self._ring.clear()
            self._turns.clear()

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {"captured_total": self.noted_total,
                    "ring": len(self._ring), "capacity": self.capacity,
                    "sessions_tracked": len(self._turns)}

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)


def install_routes(app, capture: TraceCapture,
                   path: str = "/debug/trace") -> None:
    """GET /debug/trace -> the captured arrival process as one JSON
    document (header fields + ``events``), ready to save and replay
    (``python -m gofr_tpu_torch.loadgen capture`` writes it back out as JSONL)."""

    @app.get(path)
    def debug_trace(ctx):  # noqa: ANN001
        header, events = capture.export()
        header["events"] = events
        return header


def install_recorder_trace_route(app, recorder,
                                 path: str = "/debug/trace") -> None:
    """Same surface for a replica: derive the trace from the flight
    recorder's ring (in-flight + recent completions) on demand — the
    recorder already owns arrival stamps and prompt shapes, so no new
    recording path is needed."""

    @app.get(path)
    def debug_trace(ctx):  # noqa: ANN001
        snap = recorder.snapshot()
        rows = list(snap.get("in_flight") or []) + \
            list(snap.get("recent") or [])
        events = events_from_requests(rows)
        return {"trace_version": TRACE_VERSION,
                "source": "flight_recorder",
                "captured_total": snap.get("finished_total"),
                "events": events}

"""The replica's ``GET /debug/trace``: the flight recorder's ring as a
replayable trace.

Ports ``install_recorder_trace_route`` of ``gofr_tpu/loadgen/capture.py``.
The recorder already owns the arrival stamps and prompt shapes, so the
trace is derived from its snapshot on demand, with no recording path of
its own. ``TraceCapture`` (the router's arrival capture) and its route
wait in ROADMAP A18b.
"""

from __future__ import annotations

from .trace import TRACE_VERSION, events_from_requests


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

"""Fleet timeline stitching: one Perfetto trace across router and replicas.

Ports ``gofr_tpu/fleet/timeline.py`` whole: ``router_events``,
``align_replica``, ``stitch_payloads``, ``assemble``,
``register_fleet_timeline_metrics`` and ``install_routes``
(``GET /debug/fleet/timeline/{id}[?steps=N]``, id a router journey id or a
32-hex trace id).

A replica's exporter (``tpu/timeline.py``) shows one process; a request's
story spans the router's forwarding decisions and one or more replicas
(retries, or the prefill and decode halves of a disaggregated pair). This
module merges them into one multi-process trace-event payload:

  * the router is pid 1: each journey hop (route attempts, the stream
    window, the terminal) becomes a slice on a "router" track, already in
    the wall-epoch domain;
  * each hop replica's ``/debug/timeline`` window, fetched over the
    registry's short-timeout probe clients, becomes its own pid, its
    monotonic-microsecond events aligned into the shared wall epoch
    through the payload's wall / mono anchor pair (one linear shift per
    replica);
  * flow events are normalized across the merged set
    (``TimelineExporter._normalize_flows``): the flow keyed by the
    request's trace id gets one ``s`` (the earliest event, the router's
    route attempt), one ``f`` (the terminal ``finished``) and ``t`` steps
    between, one arrow chain across the process boundaries.

A replica that cannot answer (restarted, its ring rolled over, no anchor)
degrades to a ``missing`` entry; stitching never fails the read.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Tuple

from ..tpu.obs import MetricsHook
from ..tpu.timeline import TimelineExporter

ROUTER_PID = 1
ROUTER_TID = 1
DEFAULT_REPLICA_STEPS = 64


def _wall_us(t_wall: float) -> float:
    return round(t_wall * 1e6, 1)


def router_events(journey: Dict[str, Any],
                  hops: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """The router's contribution: journey hops as slices + flow events on
    pid 1. `journey` is JourneyRecord.summary(), `hops` its
    router_hops() — both already wall-epoch."""
    trace_id = journey.get("trace_id")
    fid = trace_id or f"journey-{journey.get('id')}"
    events: List[Dict[str, Any]] = [
        {"ph": "M", "name": "process_name", "pid": ROUTER_PID, "tid": 0,
         "ts": 0, "args": {"name": "router"}},
        {"ph": "M", "name": "thread_name", "pid": ROUTER_PID,
         "tid": ROUTER_TID, "ts": 0, "args": {"name": "router"}},
    ]
    for hop in hops:
        t0, t1 = hop.get("t_start", 0.0), hop.get("t_end", 0.0)
        args = {k: v for k, v in hop.items()
                if k not in ("t_start", "t_end", "hop", "actor")}
        events.append({"ph": "X", "name": hop.get("hop", "hop"),
                       "cat": "journey", "pid": ROUTER_PID,
                       "tid": ROUTER_TID, "ts": _wall_us(t0),
                       "dur": round(max(0.0, t1 - t0) * 1e6, 1),
                       "args": args})
        milestone = hop.get("hop")
        if milestone in ("route", "finish", "stream_break"):
            ev = {"ph": "t", "cat": "flow", "id": fid, "name": "request",
                  "pid": ROUTER_PID, "tid": ROUTER_TID,
                  "ts": _wall_us(t0),
                  "args": {"milestone": milestone,
                           "outcome": hop.get("outcome")}}
            if milestone != "route":
                ev["args"]["milestone"] = "finished"
            events.append(ev)
    return events


def align_replica(payload: Dict[str, Any], pid: int,
                  name: str) -> Tuple[List[Dict[str, Any]], bool]:
    """One replica /debug/timeline payload -> wall-epoch events under
    `pid`. Returns (events, aligned): without the anchor pair the events
    are unusable on a shared axis, so the replica degrades to missing."""
    anchor = payload.get("anchor") or {}
    wall0, mono0 = anchor.get("wall0"), anchor.get("mono0")
    if wall0 is None or mono0 is None:
        return [], False
    # monotonic-µs -> wall-µs: one linear shift through the anchor
    shift_us = (wall0 - mono0) * 1e6
    events: List[Dict[str, Any]] = []
    for ev in payload.get("traceEvents", []):
        ev = dict(ev)
        ev["pid"] = pid
        if ev.get("ph") == "M":
            if ev.get("name") == "process_name":
                ev["args"] = {"name": name}
        else:
            ev["ts"] = round(ev.get("ts", 0.0) + shift_us, 1)
        events.append(ev)
    return events, True


def stitch_payloads(replica_payloads: Dict[str, Dict[str, Any]],
                    journey: Optional[Dict[str, Any]] = None,
                    hops: Optional[List[Dict[str, Any]]] = None,
                    trace_id: Optional[str] = None) -> Dict[str, Any]:
    """The pure core (no I/O — harnesses and tests feed it fetched
    payloads directly): merge router hops + replica timelines into one
    multi-pid trace with normalized cross-process flows."""
    events: List[Dict[str, Any]] = []
    if journey is not None:
        events += router_events(journey, hops or [])
    pids: Dict[str, int] = {}
    missing: List[str] = []
    for i, name in enumerate(sorted(replica_payloads)):
        pid = ROUTER_PID + 1 + i
        aligned, ok = align_replica(replica_payloads[name], pid, name)
        if not ok:
            missing.append(name)
            continue
        pids[name] = pid
        events += aligned
    TimelineExporter._normalize_flows(events)
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "clock_domain": "wall_us",
        "trace_id": trace_id,
        "pids": pids,
        "missing": missing,
        "complete": not missing,
        "events_total": len(events),
        "stitched_at": round(time.time(), 6),  # lint: clock-ok operator-facing stitch timestamp, already in the wall domain
    }


def assemble(router, rec, steps: int = DEFAULT_REPLICA_STEPS,
             metrics=None) -> Dict[str, Any]:
    """One journey record -> the stitched fleet trace: fetch each
    committed replica's /debug/timeline over its probe client, align,
    merge with the router's hops. Degrades per-replica, never fails."""
    obs = MetricsHook(metrics)
    names = {a.get("replica") for a in rec.attempts
             if a.get("outcome") == "committed"}
    names.discard(None)
    if rec.replica:
        names.add(rec.replica)
    payloads: Dict[str, Dict[str, Any]] = {}
    unreachable: List[str] = []
    for name in sorted(names):
        replica = router.registry.replica(name)
        payload = None
        if replica is not None:
            try:
                resp = replica.probe.get(
                    None, f"/debug/timeline?steps={int(steps)}")
                if resp.status_code == 200:
                    body = resp.json() or {}
                    payload = body.get("data") or body
            except Exception:  # noqa: BLE001 - degrade, never fail the read
                payload = None
        if payload and payload.get("traceEvents") is not None:
            payloads[name] = payload
        else:
            unreachable.append(name)
    stitched = stitch_payloads(payloads, journey=rec.summary(),
                               hops=rec.router_hops(),
                               trace_id=rec.trace_id)
    stitched["missing"] = sorted(set(stitched["missing"]) | set(unreachable))
    stitched["complete"] = not stitched["missing"]
    stitched["journey_id"] = rec.id
    obs.counter("app_tpu_timeline_stitched_total",
                complete=str(stitched["complete"]).lower())
    return stitched


def register_fleet_timeline_metrics(metrics) -> None:
    """Idempotent registration (the register_journey_metrics idiom)."""
    try:
        if metrics.get("app_tpu_timeline_stitched_total") is None:
            metrics.new_counter(
                "app_tpu_timeline_stitched_total",
                "fleet timeline stitches served, by completeness")
    except Exception:  # noqa: BLE001 - re-registration is benign
        pass


def install_routes(app, router,
                   path: str = "/debug/fleet/timeline",
                   steps: int = DEFAULT_REPLICA_STEPS) -> None:
    """The router's stitched-timeline surface: GET
    /debug/fleet/timeline/{id}, id = router journey id or trace id (the
    journey-detail idiom, fleet/journey.py). Requires the journey plane
    (router.journeys) — the journey record names the hop replicas."""
    from ..http.errors import HTTPError

    metrics = app.container.metrics_manager

    @app.get(path + "/{id}")
    def fleet_timeline(ctx):  # noqa: ANN001
        journeys = getattr(router, "journeys", None)
        if journeys is None:
            raise HTTPError("fleet timeline needs the journey plane "
                            "(FLEET_JOURNEY=true)", status_code=404)
        raw = ctx.request.path_param("id")
        rec = journeys.lookup(raw)
        if rec is None:
            raise HTTPError(
                f"no journey for {raw!r} (router journey id or 32-hex "
                f"trace id; the ring keeps the last {journeys.capacity} "
                f"journeys)", status_code=404)
        try:
            n = int(ctx.request.param("steps") or 0)
        except (TypeError, ValueError):
            n = 0
        return assemble(router, rec, steps=n or steps, metrics=metrics)

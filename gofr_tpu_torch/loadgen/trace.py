"""The versioned trace format, as far as ``GET /debug/trace`` needs it.

Ports of ``gofr_tpu/loadgen/trace.py``: ``TRACE_VERSION``, ``make_event``,
``events_from_requests`` and ``events_from_incident`` (the incident
bundles' ``/debug/incidents/{id}/trace``). A trace event describes one arrival with
what a replay needs and nothing it must not carry: the prompt is a spec (a
token count plus a deterministic seed), never the text. The rest of the
format (``prompt_text``, ``dump_trace`` / ``load_trace``) and the load
generator wait in ROADMAP A18b.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional

TRACE_VERSION = 1


def make_event(t: float, prompt_tokens: int, seed: int, max_new: int,
               cls: Optional[str] = None, tenant: Optional[str] = None,
               session: Optional[int] = None,
               turn: Optional[int] = None) -> Dict[str, Any]:
    event: Dict[str, Any] = {
        "t": round(max(0.0, float(t)), 6),
        "prompt_tokens": max(1, int(prompt_tokens)),
        "seed": int(seed),
        "max_new": max(1, int(max_new)),
    }
    if cls is not None:
        event["class"] = str(cls)
    if tenant is not None:
        event["tenant"] = str(tenant)
    if session is not None:
        event["session"] = int(session)
    if turn is not None:
        event["turn"] = int(turn)
    return event


def events_from_requests(rows: Iterable[Dict[str, Any]]
                         ) -> List[Dict[str, Any]]:
    """Flight-recorder request summaries (``/debug/requests`` ``recent``
    / ``in_flight`` rows) -> trace events. The recorder never stored the prompt text, so the
    spec comes straight from what it did keep: ``prompt_tokens`` and
    ``max_new_tokens``; the request id seeds the regenerated tail and
    doubles as the session key (the recorder has no conversation
    linkage — each request replays as its own session)."""
    out: List[Dict[str, Any]] = []
    for row in rows:
        if not isinstance(row, dict):
            continue
        enq = row.get("enqueued_at")
        if not isinstance(enq, (int, float)):
            continue
        rid = int(row.get("id") or 0)
        cls = row.get("class")
        if cls is None and row.get("priority"):
            # QoS requests ride the priority band; the class name is not
            # in the summary, so the band number tags the event instead
            cls = None
        out.append(make_event(
            t=float(enq),
            prompt_tokens=int(row.get("prompt_tokens") or 1),
            seed=rid,
            max_new=int(row.get("max_new_tokens") or 1),
            cls=cls,
            tenant=row.get("tenant"),
            session=rid))
    out.sort(key=lambda e: e["t"])
    if out:
        t0 = out[0]["t"]
        for event in out:
            event["t"] = round(event["t"] - t0, 6)
    return out


def events_from_incident(bundle: Dict[str, Any]) -> List[Dict[str, Any]]:
    """An ``/debug/incidents/{id}`` bundle -> trace events: its
    ``slowest_requests`` become the replayable arrival process."""
    return events_from_requests(bundle.get("slowest_requests") or [])

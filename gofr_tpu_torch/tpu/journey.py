"""Replica-local journey assembly: one request's causally ordered hops.

A copy of ``gofr_tpu/tpu/journey.py``, whole: ``is_trace_id``,
``hops_from_detail``, ``order_hops``, ``assemble_local``,
``journey_index`` and ``install_routes`` (``GET /debug/journey``,
``/debug/journey/{id}``). It folds the flight-recorder records a trace left
on this replica into the uniform hop schema

    {"hop": "queue"|"prefill"|"kv_handoff"|"decode"|"finish",
     "actor": "<replica role>", "t_start": epoch, "t_end": epoch,
     "duration_s": ..., "request_id": ..., ...detail}

where the id is an engine request id or a 32-hex trace id. A port replica
has the serving engine's recorder and, under DISAGG_MODE=both, the prefill
pool's (App.enable_flight_recorder gives it one): the prefill half gives
queue and prefill, the decode half kv_handoff and decode, and the
hand-off's finish is ``handoff``. The router's cross-replica assembly
(``fleet/journey.py``) merges these hops with its own.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Optional

_TRACE_ID_RE = re.compile(r"^[0-9a-f]{32}$")

# causal rank per hop kind: ties in t_start (coarse clocks, zero-length
# phases) still render in pipeline order
_HOP_RANK = {"route": 0, "queue": 1, "prefill": 2, "kv_handoff": 3,
             "decode": 4, "stream": 5, "finish": 6, "stream_break": 6}


def is_trace_id(raw: str) -> bool:
    return bool(_TRACE_ID_RE.match((raw or "").strip().lower()))


def _event_t(detail: Dict[str, Any], name: str) -> Optional[float]:
    for event in detail.get("events", ()):
        if event.get("event") == name:
            return event.get("t")
    return None


def hops_from_detail(detail: Dict[str, Any], actor: str,
                     role: str = "") -> List[Dict[str, Any]]:
    """One flight-recorder detail -> hop list.

    `role` is the owning engine's disagg role: a "prefill" engine's
    record contributes queue+prefill only (its post-first-token tail is
    the hand-off export, not client-visible decode); a hand-off record
    (detail["handoff"]) contributes kv_handoff+decode — its pre-admit
    window IS the hop (receipt, blob validation, H2D landing)."""
    hops: List[Dict[str, Any]] = []
    t_enq = detail.get("enqueued_at")
    t_adm = _event_t(detail, "admitted")
    t_ft = _event_t(detail, "first_token")
    t_fin = _event_t(detail, "finished")

    def hop(name: str, start: Optional[float], end: Optional[float],
            **extra: Any) -> None:
        if start is None:
            return
        stop = end if end is not None else start
        hops.append({
            "hop": name, "actor": actor,
            "t_start": round(start, 6), "t_end": round(stop, 6),
            "duration_s": round(max(0.0, stop - start), 6),
            "request_id": detail.get("id"),
            **{k: v for k, v in extra.items() if v is not None}})

    if detail.get("handoff"):
        hop("kv_handoff", t_enq, t_adm)
        hop("decode", t_adm, t_fin, tokens=detail.get("generated"),
            tpot_s=detail.get("tpot_s"))
    else:
        hop("queue", t_enq, t_adm)
        hop("prefill", t_adm, t_ft,
            prompt_tokens=detail.get("prompt_tokens"),
            bucket=detail.get("bucket"))
        if role != "prefill":
            hop("decode", t_ft, t_fin, tokens=detail.get("generated"),
                tpot_s=detail.get("tpot_s"))
    if t_fin is not None and role != "prefill":
        hop("finish", t_fin, t_fin, outcome=detail.get("outcome"),
            error=detail.get("error"))
    return hops


def order_hops(hops: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    return sorted(hops, key=lambda h: (h.get("t_start") or 0.0,
                                       _HOP_RANK.get(h.get("hop"), 9)))


def _recorders(engine) -> List[tuple]:
    """(recorder, actor, role) pairs this replica owns: the front
    engine's, plus a disaggregated pair's prefill pool's where one is
    wired (DISAGG_MODE=both)."""
    out = []
    recorder = getattr(engine, "recorder", None)
    role = getattr(engine, "disagg_role", "") or ""
    if recorder is not None:
        out.append((recorder, f"engine:{role or 'serve'}", role))
    disagg = getattr(engine, "disagg_router", None)
    if disagg is not None:
        pre = getattr(disagg, "prefill_engine", None)
        pre_rec = getattr(pre, "recorder", None)
        if pre_rec is not None:
            out.append((pre_rec, "engine:prefill", "prefill"))
    return out


def assemble_local(engine, raw_id: str) -> Optional[Dict[str, Any]]:
    """The replica-local /debug/journey/{id} payload: every record this
    replica holds for the trace, folded into one ordered hop list.
    `raw_id` is an engine request id (int) or a 32-hex trace id; an int
    id resolves to its trace first so disagg twins ride along."""
    recorders = _recorders(engine)
    trace_id = None
    if is_trace_id(raw_id):
        trace_id = raw_id.strip().lower()
    else:
        try:
            request_id = int(raw_id)
        except (TypeError, ValueError):
            return None
        for recorder, _, _ in recorders:
            detail = recorder.lookup(request_id)
            if detail is not None:
                trace_id = detail.get("trace_id")
                break
        else:
            return None
        if trace_id is None:
            # traceless record (no inbound span): single-record journey
            actor = recorders[0][1] if recorders else "engine"
            role = recorders[0][2] if recorders else ""
            return {"trace_id": None, "source": "replica",
                    "hops": order_hops(hops_from_detail(
                        detail, actor, role)),
                    "requests": [detail]}
    details: List[Dict[str, Any]] = []
    hops: List[Dict[str, Any]] = []
    for recorder, actor, role in recorders:
        for detail in recorder.lookup_trace(trace_id):
            details.append(detail)
            hops.extend(hops_from_detail(detail, actor, role))
    if not details:
        return None
    return {"trace_id": trace_id, "source": "replica",
            "hops": order_hops(hops), "requests": details}


def journey_index(engine, limit: int = 32) -> Dict[str, Any]:
    """Recent completions as journey stubs (newest first): the index an
    operator lists before drilling into one trace."""
    rows: List[Dict[str, Any]] = []
    for recorder, actor, role in _recorders(engine):
        if role == "prefill":
            continue  # the front engine's view is the client's view
        snap = recorder.snapshot()
        for rec in snap.get("recent", []):
            rows.append({"id": rec.get("id"),
                         "trace_id": rec.get("trace_id"),
                         "actor": actor,
                         "outcome": rec.get("outcome"),
                         "ttft_s": rec.get("ttft_s"),
                         "phases": rec.get("phases")})
    return {"source": "replica", "recent": rows[:limit]}


def install_routes(app, engine, path: str = "/debug/journey") -> None:
    """GET /debug/journey (recent index) + GET /debug/journey/{id} (one
    assembled waterfall), on both servers."""
    from ..http.errors import HTTPError

    @app.get(path)
    def journey_list(ctx):  # noqa: ANN001, ARG001
        return journey_index(engine)

    @app.get(path + "/{id}")
    def journey_detail(ctx):  # noqa: ANN001
        raw = ctx.request.path_param("id")
        journey = assemble_local(engine, raw)
        if journey is None:
            raise HTTPError(
                f"no journey for {raw!r} on this replica (request id or "
                "32-hex trace id; the recorder ring is bounded)",
                status_code=404)
        return journey

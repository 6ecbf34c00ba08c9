"""The versioned trace format: arrival processes as replayable JSONL.

Ports ``gofr_tpu/loadgen/trace.py`` whole: ``TRACE_VERSION``,
``TraceError``, ``make_event``, ``prompt_text``, ``dump_trace`` /
``dumps_trace``, ``load_trace`` / ``loads_trace`` (with the version-skew
rules below), ``events_from_requests`` and ``events_from_incident``.

A trace is one header line followed by one event per line. The header
pins the format version and carries provenance; every event describes
ONE arrival with everything a replay needs and nothing it must not
carry:

    {"trace_version": 1, "source": "router:capture", "events": 3}
    {"t": 0.0,   "class": "interactive", "tenant": "acme",
     "session": 91231, "turn": 0, "prompt_tokens": 12, "seed": 77,
     "max_new": 8}
    {"t": 0.031, ...}

Privacy is structural, not a policy: the prompt is a *spec* — a token
count plus a deterministic seed — never the text. ``prompt_text()``
regenerates a synthetic prompt of the same shape: same length, and the
same leading trunk for every event sharing a ``session`` id (the trunk
grows with ``turn``), so replays exercise the prefix-affinity and
KV-reuse paths the original traffic did without a byte of the original
text leaving the process.

Version skew: a reader accepts traces up to its own ``TRACE_VERSION``
and rejects newer ones loudly (the writer knows fields the reader
cannot interpret); unknown event fields from same-major writers are
preserved but ignored. Events are normalized on load — sorted by
``t``, rebased so the first arrival is t=0.
"""

from __future__ import annotations

import io
import json
import random
from typing import Any, Dict, Iterable, List, Optional, Tuple

TRACE_VERSION = 1

# event fields a replay interprets; anything else rides along ignored
_KNOWN = ("t", "class", "tenant", "session", "turn", "prompt_tokens",
          "seed", "max_new")


class TraceError(ValueError):
    """A trace the reader cannot (or must not) interpret."""


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


def prompt_text(event: Dict[str, Any]) -> str:
    """Deterministic synthetic prompt for one event: ``prompt_tokens``
    space-separated words. Events sharing a ``session`` share a leading
    trunk (derived from the session id alone) that grows with ``turn``
    — a turn-N prompt is a strict prefix-extension of turn N-1, which
    is exactly the shape prefix affinity and the paged prefix cache
    reward. The tail words come from ``seed`` so distinct requests stay
    distinct."""
    n = max(1, int(event.get("prompt_tokens") or 1))
    words: List[str] = []
    session = event.get("session")
    if session is not None:
        trunk_rng = random.Random(f"trace-session-{int(session)}")
        turn = max(0, int(event.get("turn") or 0))
        trunk = min(max(0, n - 1), 4 + 2 * turn)
        words.extend(f"s{trunk_rng.randrange(10 ** 6):06d}"
                     for _ in range(trunk))
    tail_rng = random.Random(int(event.get("seed") or 0))
    while len(words) < n:
        words.append(f"u{tail_rng.randrange(10 ** 6):06d}")
    return " ".join(words)


def _open(fp_or_path, mode: str):
    if isinstance(fp_or_path, (str, bytes)):
        return open(fp_or_path, mode, encoding="utf-8"), True
    return fp_or_path, False


def dump_trace(events: Iterable[Dict[str, Any]], fp_or_path,
               source: str = "synthetic",
               meta: Optional[Dict[str, Any]] = None) -> int:
    """Write header + events as JSONL; returns the event count."""
    rows = sorted((dict(e) for e in events), key=lambda e: e.get("t", 0.0))
    fp, owned = _open(fp_or_path, "w")
    try:
        header: Dict[str, Any] = {"trace_version": TRACE_VERSION,
                                  "source": source, "events": len(rows)}
        if meta:
            header.update(meta)
        fp.write(json.dumps(header) + "\n")
        for row in rows:
            fp.write(json.dumps(row) + "\n")
    finally:
        if owned:
            fp.close()
    return len(rows)


def dumps_trace(events: Iterable[Dict[str, Any]],
                source: str = "synthetic",
                meta: Optional[Dict[str, Any]] = None) -> str:
    buf = io.StringIO()
    dump_trace(events, buf, source=source, meta=meta)
    return buf.getvalue()


def load_trace(fp_or_path) -> Tuple[Dict[str, Any], List[Dict[str, Any]]]:
    """Read (header, events). Raises TraceError on a missing/invalid
    header or a trace written by a NEWER format version; unknown event
    fields are preserved but ignored (same-major forward compat)."""
    fp, owned = _open(fp_or_path, "r")
    try:
        first = fp.readline()
        if not first.strip():
            raise TraceError("empty trace: no header line")
        try:
            header = json.loads(first)
        except ValueError as exc:
            raise TraceError(f"trace header is not JSON: {exc}") from exc
        version = header.get("trace_version") if isinstance(header, dict) \
            else None
        if not isinstance(version, int):
            raise TraceError("trace header lacks an integer trace_version")
        if version > TRACE_VERSION:
            raise TraceError(
                f"trace_version {version} is newer than this reader "
                f"(v{TRACE_VERSION}); upgrade before replaying")
        events: List[Dict[str, Any]] = []
        for lineno, line in enumerate(fp, start=2):
            line = line.strip()
            if not line:
                continue
            try:
                row = json.loads(line)
            except ValueError as exc:
                raise TraceError(
                    f"trace line {lineno} is not JSON: {exc}") from exc
            if not isinstance(row, dict) or "t" not in row:
                raise TraceError(f"trace line {lineno} is not an event "
                                 "(missing 't')")
            events.append(row)
    finally:
        if owned:
            fp.close()
    events.sort(key=lambda e: float(e.get("t") or 0.0))
    if events:
        t0 = float(events[0].get("t") or 0.0)
        for row in events:
            row["t"] = round(max(0.0, float(row.get("t") or 0.0) - t0), 6)
    return header, events


def loads_trace(text: str) -> Tuple[Dict[str, Any], List[Dict[str, Any]]]:
    return load_trace(io.StringIO(text))


# -- exporters: existing evidence surfaces -> replayable traces --------------
def events_from_requests(rows: Iterable[Dict[str, Any]]
                         ) -> List[Dict[str, Any]]:
    """Flight-recorder request summaries (``/debug/requests`` ``recent``
    / ``in_flight`` rows, or an incident bundle's ``slowest_requests``)
    -> trace events. The recorder never stored the prompt text, so the
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
    """An `/debug/incidents/{id}` bundle -> trace events: the bundle's
    ``slowest_requests`` (oldest in-flight + slowest completions at
    capture time) become the replayable arrival process, so the exact
    traffic shape that blew the SLO re-runs on demand."""
    return events_from_requests(bundle.get("slowest_requests") or [])

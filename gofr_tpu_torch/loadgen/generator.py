"""The open-loop driver: arrivals fire on schedule, completions be
damned.

Ports ``gofr_tpu/loadgen/generator.py`` whole: ``OpenLoopRunner``.

This is the one property every closed-loop worker harness in the repo
(tools/soak.py's thread pools, bench.py's phases) structurally cannot
express: a closed-loop worker that is stuck waiting on a slow stream
stops *offering* load, so the measured system never sees λ > μ for
long and queueing collapse is invisible. Here a dispatcher thread
walks the trace on a monotonic clock and spawns one worker per
arrival AT its scheduled time — a stalled server changes nothing
about the arrival process (the schedule-fidelity test in
tests/test_loadgen.py pins exactly that).

Transport is stdlib ``http.client`` over real sockets against the
fleet router's POST /generate: QoS class and tenant ride the
``X-QoS-Class`` / ``X-Tenant`` headers the front door already
validates, prompts are regenerated from the trace's prompt spec
(never stored text), and the SSE stream is read line-by-line so TTFT
is the first data event, not a buffered read.

Every request lands one row in the run artifact: scheduled vs fired
time (dispatch lag — the generator auditing itself), class, tenant,
session, status (ok / shed / error), TTFT, TPOT, token count.
``status()`` is the live view grafttop's loadgen panel and
obs_dump's offered-vs-served timeline poll.
"""

from __future__ import annotations

import collections
import http.client
import json
import threading
import time
from typing import Any, Callable, Dict, List, Optional
from urllib.parse import urlsplit

from .trace import prompt_text

DEFAULT_TIMEOUT_S = 120.0
# backstop against a pathological trace, not a throttle: arrivals past
# the cap are still *recorded* on schedule (the open-loop contract) but
# not sent, and the drop is counted loudly in the artifact
DEFAULT_MAX_INFLIGHT = 2048
_RATE_WINDOW_S = 5.0


class OpenLoopRunner:
    """Replay one trace open-loop against a /generate endpoint."""

    def __init__(self, base_url: str, events: List[Dict[str, Any]],
                 timeout_s: float = DEFAULT_TIMEOUT_S,
                 max_inflight: int = DEFAULT_MAX_INFLIGHT,
                 prompt_fn: Optional[Callable[[Dict[str, Any]], str]] = None,
                 path: str = "/generate", label: str = "loadgen"):
        split = urlsplit(base_url if "//" in base_url
                         else "http://" + base_url)
        self.host = split.hostname or "127.0.0.1"
        self.port = split.port or 80
        self.path = path
        self.label = label
        self.events = sorted((dict(e) for e in events),
                             key=lambda e: float(e.get("t") or 0.0))
        self.timeout_s = float(timeout_s)
        self.max_inflight = max(1, int(max_inflight))
        self.prompt_fn = prompt_fn or prompt_text
        self._lock = threading.Lock()
        self._rows: List[Dict[str, Any]] = []
        self._arrivals: List[Dict[str, Any]] = []
        self._inflight: Dict[str, int] = {}
        self._inflight_total = 0
        self._arrival_stamps: "collections.deque" = collections.deque(
            maxlen=4096)
        self._done_stamps: "collections.deque" = collections.deque(
            maxlen=4096)
        self._sent_tokens = 0
        self.dropped = 0
        self.verdict: Optional[str] = None
        self._abort = threading.Event()
        self._dispatcher: Optional[threading.Thread] = None
        self._workers: List[threading.Thread] = []
        # wall/monotonic anchor: internals run on the monotonic clock,
        # epochs leave through the anchor only
        self.wall0 = time.time()
        self.t0: Optional[float] = None
        self.finished_dispatch = threading.Event()

    # -- lifecycle ------------------------------------------------------------
    def start(self) -> "OpenLoopRunner":
        if self._dispatcher is not None:
            raise RuntimeError("runner already started")
        self._dispatcher = threading.Thread(
            target=self._dispatch, name=f"{self.label}-dispatch",
            daemon=True)
        self._dispatcher.start()
        return self

    def run(self, drain_timeout_s: Optional[float] = None) -> List[dict]:
        """start() + join(); returns the completed rows."""
        self.start()
        self.join(drain_timeout_s)
        return self.rows()

    def wait_dispatch(self, timeout_s: Optional[float] = None) -> bool:
        """Block until every arrival has FIRED (not finished) — the
        open-loop half of the run. True when the schedule completed."""
        return self.finished_dispatch.wait(timeout_s)

    def join(self, timeout_s: Optional[float] = None) -> bool:
        """Wait for the dispatcher and every in-flight worker; True when
        everything drained inside the budget."""
        deadline = (time.monotonic() + timeout_s) if timeout_s else None
        if self._dispatcher is not None:
            self._dispatcher.join(
                None if deadline is None
                else max(0.0, deadline - time.monotonic()))
        for worker in list(self._workers):
            worker.join(None if deadline is None
                        else max(0.0, deadline - time.monotonic()))
        return not any(w.is_alive() for w in self._workers) and (
            self._dispatcher is None or not self._dispatcher.is_alive())

    def abort(self) -> None:
        self._abort.set()

    # -- the open loop --------------------------------------------------------
    def _dispatch(self) -> None:
        self.t0 = time.monotonic()
        self.wall0 = time.time()
        for idx, event in enumerate(self.events):
            if self._abort.is_set():
                break
            due = self.t0 + float(event.get("t") or 0.0)
            while True:
                now = time.monotonic()
                if now >= due:
                    break
                if self._abort.wait(min(0.05, due - now)):
                    break
            if self._abort.is_set():
                break
            fired = time.monotonic()
            arrival = {"i": idx, "t": float(event.get("t") or 0.0),
                       "lag_s": round(fired - due, 6)}
            with self._lock:
                self._arrivals.append(arrival)
                self._arrival_stamps.append(fired)
                self._sent_tokens += (int(event.get("prompt_tokens") or 1)
                                      + int(event.get("max_new") or 1))
                over_cap = self._inflight_total >= self.max_inflight
                if over_cap:
                    self.dropped += 1
            if over_cap:
                with self._lock:
                    self._rows.append(self._row(event, arrival,
                                                status="dropped"))
                continue
            worker = threading.Thread(
                target=self._one, args=(event, arrival, fired),
                name=f"{self.label}-{idx}", daemon=True)
            self._begin(event)
            worker.start()
            self._workers.append(worker)
        self.finished_dispatch.set()

    def _begin(self, event: Dict[str, Any]) -> None:
        cls = event.get("class") or "unclassified"
        with self._lock:
            self._inflight[cls] = self._inflight.get(cls, 0) + 1
            self._inflight_total += 1

    def _end(self, event: Dict[str, Any]) -> None:
        cls = event.get("class") or "unclassified"
        with self._lock:
            self._inflight[cls] = max(0, self._inflight.get(cls, 1) - 1)
            self._inflight_total = max(0, self._inflight_total - 1)
            self._done_stamps.append(time.monotonic())

    @staticmethod
    def _row(event: Dict[str, Any], arrival: Dict[str, Any],
             status: str) -> Dict[str, Any]:
        return {"i": arrival["i"], "t": arrival["t"],
                "lag_s": arrival["lag_s"],
                "class": event.get("class"), "tenant": event.get("tenant"),
                "session": event.get("session"), "status": status}

    def _one(self, event: Dict[str, Any], arrival: Dict[str, Any],
             fired: float) -> None:
        row = self._row(event, arrival, status="error")
        conn = None
        try:
            prompt = self.prompt_fn(event)
            body = json.dumps({
                "prompt": prompt, "stream": True,
                "max_tokens": int(event.get("max_new") or 1)}).encode()
            headers = {"Content-Type": "application/json"}
            if event.get("class"):
                headers["X-QoS-Class"] = str(event["class"])
            if event.get("tenant"):
                headers["X-Tenant"] = str(event["tenant"])
            conn = http.client.HTTPConnection(self.host, self.port,
                                              timeout=self.timeout_s)
            conn.request("POST", self.path, body=body, headers=headers)
            resp = conn.getresponse()
            if resp.status == 503:
                resp.read()
                row["status"] = "shed"
                return
            if resp.status >= 400:
                resp.read()
                row["status"] = f"http_{resp.status}"
                row["error"] = f"HTTP {resp.status}"
                return
            first_at = None
            last_at = None
            tokens = 0
            saw_done = False
            while True:
                line = resp.readline()
                if not line:
                    break
                line = line.strip()
                if not line.startswith(b"data: "):
                    continue
                now = time.monotonic()
                if first_at is None:
                    first_at = now
                last_at = now
                try:
                    payload = json.loads(line[6:])
                except ValueError:
                    continue
                if payload.get("done"):
                    saw_done = True
                    tokens = int(payload.get("tokens") or tokens)
                    break
                if "error" in payload:
                    row["status"] = "stream_break"
                    row["error"] = str(payload["error"])[:160]
                    return
                tokens += 1
            if first_at is None or not saw_done:
                row["status"] = "stream_break"
                row["error"] = "stream ended before done event"
                return
            row["status"] = "ok"
            row["ttft_s"] = round(first_at - fired, 6)
            row["tokens"] = tokens
            if tokens >= 2 and last_at is not None and last_at > first_at:
                row["tpot_s"] = round((last_at - first_at) / (tokens - 1), 6)
        except Exception as exc:  # noqa: BLE001 - every failure is evidence
            row["status"] = "error"
            row["error"] = repr(exc)[:160]
        finally:
            if conn is not None:
                try:
                    conn.close()
                except Exception:  # noqa: BLE001
                    pass
            row["done_t"] = (round(time.monotonic() - (self.t0 or fired), 6)
                             if self.t0 is not None else None)
            with self._lock:
                self._rows.append(row)
            self._end(event)

    # -- readouts -------------------------------------------------------------
    def rows(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [dict(r) for r in self._rows]

    def arrivals(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [dict(a) for a in self._arrivals]

    @staticmethod
    def _window_rate(stamps, now: float) -> float:
        recent = [s for s in stamps if now - s <= _RATE_WINDOW_S]
        if not recent:
            return 0.0
        span = max(now - min(recent), 1e-6)
        return round(len(recent) / min(span, _RATE_WINDOW_S + 1e-6), 3)

    def status(self) -> Dict[str, Any]:
        """Live snapshot for the status server / grafttop panel:
        offered vs served rates, per-class inflight, outcome counts."""
        now = time.monotonic()
        with self._lock:
            counts: Dict[str, int] = {}
            for r in self._rows:
                counts[r["status"]] = counts.get(r["status"], 0) + 1
            done = len(self._rows)
            fired = len(self._arrivals)
            worst_lag = max((a["lag_s"] for a in self._arrivals),
                            default=0.0)
            out = {
                "label": self.label,
                "target": f"{self.host}:{self.port}",
                "events_total": len(self.events),
                "arrivals_fired": fired,
                "completions": done,
                "inflight": dict(self._inflight),
                "inflight_total": self._inflight_total,
                "offered_rps": self._window_rate(self._arrival_stamps, now),
                "served_rps": self._window_rate(self._done_stamps, now),
                "offered_tokens_total": self._sent_tokens,
                "outcomes": counts,
                "dropped": self.dropped,
                "worst_dispatch_lag_s": round(worst_lag, 6),
                "done": bool(self.finished_dispatch.is_set()
                             and self._inflight_total == 0),
                "elapsed_s": (round(now - self.t0, 3)
                              if self.t0 is not None else 0.0),
            }
            if self.verdict is not None:
                out["verdict"] = self.verdict
        return out

    def artifact(self, extra: Optional[Dict[str, Any]] = None
                 ) -> Dict[str, Any]:
        """The run artifact: status summary + every per-request row.
        ``python -m gofr_tpu_torch.loadgen run`` writes it out."""
        out = {
            "loadgen_version": 1,
            "t0_epoch": round(self.wall0, 3),
            "status": self.status(),
            "rows": self.rows(),
        }
        if extra:
            out.update(extra)
        return out

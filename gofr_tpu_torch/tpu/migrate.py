"""Replica-side elasticity: the lifecycle, drain with migration, and the
warm boot's pre-warm.

Ports ``gofr_tpu/tpu/migrate.py`` whole: ``Lifecycle`` and
``LIFECYCLE_STATES``, ``admit_migration``, ``MigrationCoordinator`` with
its outcome ledger, ``_iter_sse``, ``prewarm_from_peers``,
``register_migration_metrics`` and ``install_migration_routes`` (``POST
/migrate``, ``POST|GET /debug/drain``, ``GET /debug/kvtier``). The default
peer client is the port's stdlib ``service.HTTPService``.

A replica boots ``warming`` (the warm boot's captures and KV pre-warm: a
router sends it no cold traffic), serves as ``serving`` and leaves through
``draining``: no new sessions, and the live ones *migrate* to a peer
instead of holding the replica for their whole generation. Migration
reuses two contracts:

- the hand-off envelope (tpu/disagg.py): the engine exports each live
  slot's KV as page blobs at a quiesced step boundary
  (``engine.request_migration``), the coordinator sends it to a peer's
  ``POST /migrate``, and the peer lands it through ``submit_handoff``, the
  landing a decode pool runs;
- the replay ladder: every failure degrades, never drops. A peer that
  rejects the blobs recomputes prompt + emitted; an unreachable peer means
  the next one, then a resume on this engine (migration runs BEFORE
  ``engine.drain``, so it still admits); a peer that dies mid-relay leaves
  its relayed tokens in ``request.emitted``, and a blob-less local resume
  continues exactly where it broke.

The client's stream never changes hands: relayed tokens land on the
original request's out_queue, as a hand-off's do.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

from ..service import HTTPService
from .disagg import decode_handoff, encode_handoff
from .kvtier import decode_blob
from .obs import MetricsHook

LIFECYCLE_STATES = ("warming", "serving", "draining")

MIGRATIONS_TOTAL = "app_tpu_elastic_migrations_total"


class Lifecycle:
    """Thread-safe replica lifecycle state, advertised in the /stats
    fleet digest so routers gate routing on it:
    ``warming`` and ``draining`` replicas receive no new sessions."""

    def __init__(self, state: str = "serving", clock=time.monotonic):
        if state not in LIFECYCLE_STATES:
            raise ValueError(f"lifecycle state must be one of "
                             f"{LIFECYCLE_STATES}, got {state!r}")
        self._clock = clock
        self._lock = threading.Lock()
        self._state = state
        self._since = clock()
        self._trail: List[Dict[str, Any]] = []

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def to(self, state: str) -> bool:
        """Transition; False when already there. draining is terminal —
        a draining replica never un-drains (restart it instead: the
        generation bump tells routers it is a fresh boot)."""
        if state not in LIFECYCLE_STATES:
            raise ValueError(f"unknown lifecycle state {state!r}")
        with self._lock:
            if self._state == state or self._state == "draining":
                return False
            self._trail.append({"from": self._state, "to": state,
                                "t": self._clock()})
            self._state = state
            self._since = self._clock()
            return True

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {"state": self._state,
                    "since_s": round(self._clock() - self._since, 1),
                    "trail": list(self._trail)}


def admit_migration(engine, envelope: Dict[str, Any]):
    """Land one shipped migration on THIS engine — the peer half of
    drain-with-migration, sharing the disagg decode pool's trust model:
    any page that fails decode_blob's crc poisons the whole hand-off
    down to a blob-less recompute; submit_handoff's admission then
    content-verifies surviving blobs against the resume window. Returns
    the GenerationRequest whose stream() carries the continuation.
    Raises ValueError on a structurally-bad spec (transport 400s) and
    lets shed errors (503-shaped) propagate."""
    spec = envelope.get("spec")
    if not isinstance(spec, dict):
        raise ValueError("envelope has no spec")
    blobs = None
    raw_blobs = envelope.get("blobs")
    if raw_blobs is not None and getattr(engine, "_lands_handoffs", False):
        decoded = [decode_blob(raw) for raw in raw_blobs]
        if all(b is not None for b in decoded):
            blobs = decoded
        # else: corrupt in flight — recompute is cheaper than wrong KV
    try:
        # the spec is the network's: every number is coerced here, and
        # submit_handoff range-checks the ids against the vocabulary
        return engine.submit_handoff(
            spec["prompt"], spec["emitted"],
            max_new_tokens=int(spec["max_new"]),
            temperature=float(spec["temp"]),
            stop_tokens=set(spec["stop"]),
            priority=int(spec["prio"]),
            min_tokens=int(spec["min"]),
            top_p=float(spec["top_p"]), top_k=int(spec["top_k"]),
            traceparent=envelope.get("traceparent"),
            blobs=blobs,
            qos_class=spec.get("qos"),
            tenant=str(spec.get("tenant", "")))
    except (KeyError, TypeError, OverflowError) as exc:
        raise ValueError(f"malformed migration spec: {exc}") from exc


class MigrationCoordinator:
    """Owns one replica's drain: flip the lifecycle, export live sessions
    from the engine, ship each to a peer's /migrate and relay the
    continuation into the original client stream, then drain the engine
    for whatever chose to finish locally.

    begin_drain() is idempotent (the double-drain operator fat-finger is
    a no-op returning current status) and returns immediately; the drain
    runs on its own thread and status() reports progress — the shape the
    router-side DrainOrchestrator polls before terminating the process."""

    def __init__(self, engine, lifecycle: Optional[Lifecycle] = None, *,
                 metrics=None, logger=None,
                 client_factory: Optional[Callable[[str], Any]] = None,
                 ship_timeout_s: float = 60.0):
        self.engine = engine
        self.lifecycle = lifecycle or Lifecycle()
        self.logger = logger
        self._obs = MetricsHook(metrics, logger)
        self.ship_timeout_s = float(ship_timeout_s)
        self._client_factory = client_factory or self._default_client
        self._lock = threading.Lock()
        self._drain_started = False
        self._drain_thread: Optional[threading.Thread] = None
        self._engine_drained: Optional[bool] = None
        self._relays_live = 0
        # outcome ledger (plain dict under _lock): exported sessions by
        # how their stream continued
        self.outcomes: Dict[str, int] = {
            "shipped": 0,        # peer restored (blobs or recompute)
            "local_resume": 0,   # every peer refused; resumed here
            "relay_break": 0,    # peer died mid-relay; resumed here
            "cancelled": 0,      # client cancelled during the hop
            "failed": 0,         # nothing could continue the stream
        }
        self.sessions: List[Dict[str, Any]] = []

    def _default_client(self, address: str):
        return HTTPService(address, logger=self.logger,
                           timeout_s=self.ship_timeout_s)

    # -- operator surface -----------------------------------------------------

    def begin_drain(self, peers: Sequence[str] = (), *,
                    timeout_s: float = 30.0,
                    migrate: bool = True) -> Dict[str, Any]:
        """Start (or observe, when already started) this replica's drain.
        peers: base URLs eligible to receive live sessions, tried in
        order per session. migrate=False skips the export round — pure
        connection-drain, in-flight streams finish locally."""
        with self._lock:
            already = self._drain_started
            self._drain_started = True
        if already:
            return self.status()
        self.lifecycle.to("draining")
        peers = [str(p).rstrip("/") for p in peers if p]
        thread = threading.Thread(
            target=self._run_drain, args=(peers, float(timeout_s), migrate),
            name="elastic-drain", daemon=True)
        self._drain_thread = thread
        thread.start()
        return self.status()

    def status(self) -> Dict[str, Any]:
        lifecycle = self.lifecycle.snapshot()  # before _lock: no nesting
        migrations = getattr(self.engine, "migrations_total", 0)
        with self._lock:
            out = {
                "lifecycle": lifecycle,
                "drain_started": self._drain_started,
                "engine_drained": self._engine_drained,
                "relays_live": self._relays_live,
                "outcomes": dict(self.outcomes),
                "sessions": list(self.sessions),
                "migrations_total": migrations,
            }
        out["drained"] = (out["engine_drained"] is True
                          and out["relays_live"] == 0)
        return out

    # -- drain machinery (its own thread) -------------------------------------

    def _run_drain(self, peers: List[str], timeout_s: float,
                   migrate: bool) -> None:
        exported: List[tuple] = []
        if migrate and peers and getattr(self.engine, "_plane", None) is None:
            def sink(request, blobs, n_ctx) -> bool:
                exported.append((request, blobs, n_ctx))
                return True  # ownership taken: the ship ladder below
                # guarantees the stream continues somewhere

            try:
                self.engine.request_migration(sink)
            except RuntimeError:
                pass  # multi-controller engine: plain drain below
            else:
                deadline = time.monotonic() + min(timeout_s, 15.0)
                while (self.engine.migration_pending
                       and time.monotonic() < deadline):
                    time.sleep(0.01)
        relays = []
        for request, blobs, n_ctx in exported:
            t = threading.Thread(
                target=self._ship_session,
                args=(request, blobs, n_ctx, peers),
                name=f"elastic-relay-{request.id}", daemon=True)
            with self._lock:
                self._relays_live += 1
            t.start()
            relays.append(t)
        # relays must settle BEFORE engine.drain(): a failed ship
        # local-resumes via submit_handoff, which a draining engine
        # would shed — the resume floor only holds while admission is
        # open.  (A resumed session then decodes as an ACTIVE slot,
        # which drain below waits out.)
        for t in relays:
            t.join(timeout=self.ship_timeout_s)
        # whatever stayed (sink refused / admitted after the round /
        # local resume / the engine could not export) finishes locally
        # under the drain
        drained = False
        try:
            drained = bool(self.engine.drain(timeout_s))
        except Exception:  # noqa: BLE001 - a broken drain still reports
            drained = False
        with self._lock:
            self._engine_drained = drained

    def _note(self, outcome: str, request, peer: Optional[str],
              gap_s: Optional[float]) -> None:
        with self._lock:
            self.outcomes[outcome] = self.outcomes.get(outcome, 0) + 1
            self.sessions.append({
                "rid": request.id, "outcome": outcome, "peer": peer,
                "emitted": len(request.emitted),
                # TTFT evidence for the migrated stream: seconds between
                # the export (last local token possible) and the first
                # token the peer produced
                "gap_s": None if gap_s is None else round(gap_s, 3),
            })
        self._obs.counter(MIGRATIONS_TOTAL, phase=outcome)
        if gap_s is not None:
            self._obs.hist("app_tpu_elastic_migration_gap_seconds", gap_s)

    def _ship_session(self, request, blobs, n_ctx: int,
                      peers: List[str]) -> None:
        try:
            payload = encode_handoff(request, blobs, n_ctx)
            for peer in peers:
                if request.cancelled.is_set():
                    request.out_queue.put(None)
                    self._note("cancelled", request, peer, None)
                    return
                outcome, gap_s = self._relay_via_peer(request, payload,
                                                      peer)
                if outcome == "shipped":
                    self._note("shipped", request, peer, gap_s)
                    return
                if outcome == "cancelled":
                    self._note("cancelled", request, peer, gap_s)
                    return
                if outcome == "broken":
                    # tokens already relayed live in request.emitted, so
                    # a blob-less local resume continues exactly past the
                    # break — the blobs only cover the exported n_ctx and
                    # are stale now
                    self._local_resume(request, None, "relay_break")
                    return
                # "unstarted": nothing reached the client; next peer
            self._local_resume(request, blobs, "local_resume")
        except Exception as exc:  # noqa: BLE001 - the relay thread must
            # never die with the stream still open
            self._fail_stream(request, exc)
        finally:
            with self._lock:
                self._relays_live -= 1

    def _relay_via_peer(self, request, payload: str, peer: str):
        """One attempt: POST the envelope, relay the SSE token stream
        into the client's queue. Returns (outcome, first_token_gap_s):
        'shipped' (terminal done relayed), 'cancelled', 'broken' (died
        AFTER tokens flowed), 'unstarted' (safe to retry elsewhere)."""
        try:
            client = self._client_factory(peer)
            resp = client.request(
                None, "POST", "/migrate", body=payload,
                headers={"Content-Type": "application/json"},
                stream=True, timeout_s=self.ship_timeout_s)
        except Exception:  # noqa: BLE001 - connect refusal == unstarted
            return "unstarted", None
        if resp.status_code != 200:
            resp.close()
            return "unstarted", None
        started = False
        gap_s = None
        exported_at = request.finished_at  # stamped by the export round
        try:
            for event in _iter_sse(resp):
                if request.cancelled.is_set():
                    request.out_queue.put(None)
                    return "cancelled", gap_s
                if "t" in event:
                    token = int(event["t"])
                    if not started:
                        started = True
                        if exported_at is not None:
                            gap_s = max(0.0,
                                        time.monotonic() - exported_at)
                    # the replay ledger grows with the relay so a
                    # mid-relay break resumes past every delivered token
                    request.emitted.append(token)
                    request.generated = len(request.emitted)
                    request.out_queue.put(token)
                elif event.get("done"):
                    request.out_queue.put(None)
                    return "shipped", gap_s
                elif "error" in event:
                    break  # peer engine failed the continuation
        except Exception:  # noqa: BLE001 - transport death mid-stream
            pass
        finally:
            resp.close()
        return ("broken" if started else "unstarted"), gap_s

    def _local_resume(self, request, blobs, outcome: str) -> None:
        """Continue the stream on THIS engine. Always legal during the
        migration window: engine.drain() runs after the export round, so
        the engine is not draining yet; a hand-off outranks everything
        in admission, so the resume lands ahead of any stragglers."""
        if request.max_new_tokens - len(request.emitted) <= 0:
            request.out_queue.put(None)  # budget fully delivered
            self._note(outcome, request, None, None)
            return
        try:
            resumed = self.engine.submit_handoff(
                request.prompt_tokens, list(request.emitted),
                max_new_tokens=request.max_new_tokens,
                temperature=request.temperature,
                stop_tokens=set(request.stop_tokens),
                priority=request.priority,
                min_tokens=request.min_tokens,
                top_p=request.top_p, top_k=request.top_k,
                traceparent=request.traceparent,
                out_queue=request.out_queue,
                cancelled=request.cancelled,
                blobs=blobs if getattr(self.engine, "_lands_handoffs",
                                       False) else None,
                qos_class=getattr(request, "qos_class", None),
                tenant=getattr(request, "tenant", ""))
            # submit_handoff only QUEUES the resume; admission runs on
            # the loop thread.  engine.drain() (which _run_drain calls
            # once every relay settles) fails queued work fast, so hold
            # this relay open until the resume binds a slot — or
            # terminates on its own — before letting the drain proceed.
            deadline = time.monotonic() + min(10.0, self.ship_timeout_s)
            while time.monotonic() < deadline:
                if (resumed.error is not None
                        or resumed.finished_at is not None
                        or any(s.request is resumed for s in
                               getattr(self.engine, "slots", ()))):
                    break
                time.sleep(0.01)
            self._note(outcome, request, None, None)
        except Exception as exc:  # noqa: BLE001 - the floor gave way
            self._fail_stream(request, exc)

    def _fail_stream(self, request, exc: BaseException) -> None:
        if self.logger is not None:
            try:
                self.logger.errorf("migration of %s failed terminally: %s",
                                   request.id, exc)
            except Exception:  # noqa: BLE001
                pass
        request.error = exc
        request.out_queue.put(None)
        self._note("failed", request, None, None)


def _iter_sse(resp):
    """Incremental SSE parse over a streamed ServiceResponse: yields each
    ``data: {...}`` JSON payload as it arrives."""
    buf = b""
    for chunk in resp.iter_chunks():
        if not chunk:
            continue
        buf += chunk
        while b"\n" in buf:
            line, buf = buf.split(b"\n", 1)
            line = line.strip()
            if line.startswith(b"data:"):
                try:
                    yield json.loads(line[5:].strip())
                except Exception:  # noqa: BLE001 - torn frame, skip
                    continue


def prewarm_from_peers(engine, peers: Sequence[str], *,
                       limit: int = 64, logger=None,
                       client_factory: Optional[Callable] = None) -> int:
    """Warm-boot pre-warm: pull peer /debug/kvtier inventories (the
    ``pages`` of the App's ``data`` envelope) and warm
    this engine's host tier through tier.get() (shared Redis cold-tier
    hits promote into host RAM, content-verified). Best-effort by
    design — a missing peer or absent tier warms nothing and the boot
    continues; pages the shared tier no longer holds are simply misses."""
    warm = getattr(engine, "prewarm_from_tier", None)
    if warm is None or getattr(engine, "kv_tier", None) is None:
        return 0
    factory = client_factory
    if factory is None:
        factory = lambda addr: HTTPService(addr, logger=logger,  # noqa: E731
                                           timeout_s=5.0)
    warmed = 0
    for peer in peers:
        if warmed >= limit:
            break
        try:
            resp = factory(str(peer).rstrip("/")).request(
                None, "GET", "/debug/kvtier")
            if resp.status_code != 200:
                continue
            body = resp.json() or {}
            # the App answers in its {"data": ...} envelope, which the
            # reference's reader misses (it reads "pages" at the top)
            rows = body.get("data", body).get("pages", [])
        except Exception:  # noqa: BLE001 - peer gone == nothing to warm
            continue
        warmed += warm(rows, limit=limit - warmed)
    if logger is not None and warmed:
        try:
            logger.infof("pre-warmed %d KV pages from %d peer(s)",
                         warmed, len(list(peers)))
        except Exception:  # noqa: BLE001
            pass
    return warmed


def register_migration_metrics(metrics) -> None:
    """Idempotent registration of the replica-side app_tpu_elastic_*
    series (the fleet side registers its own in fleet/elastic.py)."""
    for name, desc in (
        (MIGRATIONS_TOTAL,
         "drain-with-migration sessions by phase: export (engine "
         "evacuated the slot), then one stream outcome — shipped, "
         "local_resume, relay_break, cancelled, failed"),
        ("app_tpu_elastic_prewarm_pages_total",
         "KV pages promoted into host RAM by warm-boot pre-warm"),
    ):
        try:
            if metrics.get(name) is None:
                metrics.new_counter(name, desc)
        except Exception:  # noqa: BLE001 - already registered
            pass
    try:
        if metrics.get("app_tpu_elastic_migration_gap_seconds") is None:
            metrics.new_histogram(
                "app_tpu_elastic_migration_gap_seconds",
                "stream gap a migrated session observed: export to first "
                "peer-produced token (the migrated-TTFT evidence)")
    except Exception:  # noqa: BLE001
        pass


def install_migration_routes(app, engine,
                             coordinator: MigrationCoordinator) -> None:
    """Replica-side elastic surface:

    - ``POST /migrate`` — land a peer's exported session (SSE stream of
      raw token ids ``{"t": id}`` then ``{"done": true}``; raw ids, not
      decoded text, so the relay is token-exact across the hop).
    - ``POST /debug/drain`` — begin drain-with-migration
      (body: ``{"peers": [...], "timeout_s": 30, "migrate": true}``).
    - ``GET /debug/drain`` — drain/migration status.
    - ``GET /debug/kvtier`` — bounded host-tier page inventory for
      peers' warm-boot pre-warm.
    """
    from ..http.errors import InvalidParam, ServiceUnavailable
    from ..http.responder import Stream

    @app.post("/migrate")
    def _migrate(ctx):
        # the body parsed once, as the envelope: the reference binds it
        # (under the 32 MB body limit, which a session of two Llama-3-8B
        # pages in base64 JSON exceeds) and encodes it again to parse it
        envelope = decode_handoff(ctx.request.body)
        if envelope is None:
            raise InvalidParam(["envelope"])
        try:
            request = admit_migration(engine, envelope)
        except ValueError as exc:
            raise InvalidParam([str(exc)]) from exc
        except Exception as exc:  # noqa: BLE001 - sheds → 503 + Retry-After
            if getattr(exc, "status_code", None) == 503:
                raise ServiceUnavailable(
                    str(exc),
                    retry_after_s=getattr(exc, "retry_after_s", None)
                    or 1.0) from exc
            raise

        def chunks():
            count = 0
            for token in request.stream():
                count += 1
                yield {"t": int(token)}
            yield {"done": True, "tokens": count}

        return Stream(chunks(), sse=True, on_close=request.cancel)

    @app.post("/debug/drain")
    def _drain(ctx):
        body = ctx.bind() or {}
        peers = body.get("peers") or []
        if not isinstance(peers, list):
            raise InvalidParam(["peers"])
        return coordinator.begin_drain(
            [str(p) for p in peers],
            timeout_s=float(body.get("timeout_s", 30.0)),
            migrate=bool(body.get("migrate", True)))

    @app.get("/debug/drain")
    def _drain_status(ctx):  # noqa: ARG001 - handler shape
        return coordinator.status()

    @app.get("/debug/kvtier")
    def _kvtier(ctx):
        limit = 64
        try:
            limit = int(ctx.request.param("limit") or 64)
        except (TypeError, ValueError):
            pass
        inv = getattr(engine, "tier_inventory", None)
        return {"pages": inv(limit) if inv is not None else []}

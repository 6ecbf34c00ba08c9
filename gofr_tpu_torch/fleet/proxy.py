"""FleetRouter: the forwarding core and its HTTP surface.

Ports ``gofr_tpu/fleet/proxy.py`` whole: ``FleetRouter`` (``from_config``
over the FLEET_* keys, ``forward``, ``health_check``, ``snapshot``) and
``install_routes`` (``POST /generate`` and ``GET /debug/fleet``).

Retry discipline: a request is retryable only while it is unstarted, when
the upstream connection failed (``CircuitOpenError`` or a transport error
before the headers) or the replica shed it with 503 + Retry-After, within
FLEET_RETRY_BUDGET re-attempts. Once an upstream response with a good
status arrives the request is committed to that replica: the body passes
through byte for byte, chunk by chunk as it arrives (``iter_chunks``
yields what the socket has), and an upstream death mid-stream reaches the
client as an SSE error event, never as a silent re-send (the prompt may
have sampled tokens already). Non-2xx, non-503 answers pass through as
they are. The inbound ``traceparent`` goes on through the serving client,
so one trace spans router -> replica. Affinity is learned from each
committed response; with no replica left the answer is 503 with
Retry-After. The router carries the ``journeys``, ``slo``, ``capacity``
and ``capture`` hooks of the router app (``serve_router.py``); each is
None-guarded, so forwarding never depends on them.
"""

import json
import time

from ..http.errors import InvalidParam, MissingParam, ServiceUnavailable
from ..http.responder import Response, Stream
from ..tpu.qos import normalize_class
from ..service import CircuitOpenError
from .affinity import (AffinityMap, DEFAULT_BLOCK, DEFAULT_MAX_BLOCKS,
                       affinity_keys)
from .policy import DEFAULT_SPILL_DEPTH, make_policy
from .registry import FleetRegistry

DEFAULT_RETRY_BUDGET = 2
_DEFAULT_SHED_RETRY_AFTER_S = 1.0


class FleetRouter:
    """Routes /generate across the registry's replicas."""

    def __init__(self, registry, policy, affinity_map=None, metrics=None,
                 logger=None, retry_budget=DEFAULT_RETRY_BUDGET,
                 affinity_block=DEFAULT_BLOCK,
                 affinity_max_blocks=DEFAULT_MAX_BLOCKS):
        self.registry = registry
        self.policy = policy
        self.affinity_map = (affinity_map if affinity_map is not None
                             else registry.affinity_map)
        self.metrics = metrics
        self.logger = logger
        self.retry_budget = max(0, retry_budget)
        self.affinity_block = affinity_block
        self.affinity_max_blocks = affinity_max_blocks
        # plain counters so /debug/fleet works even without a metrics manager
        self.routes = {}
        self.retries = {}
        self.affinity_hits = 0
        self.affinity_misses = 0
        self.stream_breaks = 0
        self.no_replica = 0
        # lifecycle exclusions observed per forward: replicas the elastic
        # plane held out of the candidate set (warming boot, draining
        # exit).  Deliberately NOT routed through _count_route — a
        # held-out replica is not an affinity miss, and it never feeds
        # the breaker
        self.route_skips = {}
        # per-QoS-class accounting ("unclassified" for legacy traffic):
        # routed = committed to a replica, shed = 503 replies consumed
        # by the retry loop — the fleet-level view of replica shedding
        self.class_routes = {}
        self.class_sheds = {}
        # observability plane, attached by the router app (None-guarded
        # on every touch so the forwarding path never depends on it):
        # journeys = fleet/journey.py recorder, slo = fleet/slo.py
        # rollup, capacity = fleet/capacity.py rollup, capture =
        # loadgen/capture.py arrival-trace ring
        self.journeys = None
        self.slo = None
        self.capacity = None
        self.capture = None

    @classmethod
    def from_config(cls, config, logger=None, metrics=None):
        """Build registry + policy + router from FLEET_* config keys."""
        affinity_map = AffinityMap()
        registry = FleetRegistry.from_config(config, logger=logger,
                                             metrics=metrics,
                                             affinity_map=affinity_map)
        policy = make_policy(
            config.get_or_default("FLEET_POLICY", "affinity"),
            spill_depth=config.get_int("FLEET_SPILL_DEPTH",
                                       DEFAULT_SPILL_DEPTH))
        return cls(
            registry, policy, affinity_map=affinity_map, metrics=metrics,
            logger=logger,
            retry_budget=config.get_int("FLEET_RETRY_BUDGET",
                                        DEFAULT_RETRY_BUDGET),
            affinity_block=config.get_int("FLEET_AFFINITY_BLOCK",
                                          DEFAULT_BLOCK),
            affinity_max_blocks=config.get_int("FLEET_AFFINITY_MAX_BLOCKS",
                                               DEFAULT_MAX_BLOCKS))

    def start(self):
        self.registry.start()

    def stop(self):
        self.registry.stop()

    # -- health (feeds the router app's own /.well-known/health) -------------
    def health_check(self):
        from ..datasource import (Health, STATUS_DEGRADED, STATUS_DOWN,
                                  STATUS_UP)

        up = len(self.registry.candidates())
        total = len(self.registry.replicas)
        details = {"replicas_available": up, "replicas_total": total}
        if up == 0:
            return Health(status=STATUS_DOWN, details=details)
        if up < total:
            return Health(status=STATUS_DEGRADED, details=details)
        return Health(status=STATUS_UP, details=details)

    # -- counters -------------------------------------------------------------
    def _count_route(self, reason):
        self.routes[reason] = self.routes.get(reason, 0) + 1
        if self.policy.name == "affinity":
            if reason == "affinity":
                self.affinity_hits += 1
            else:
                self.affinity_misses += 1
        if self.metrics is not None:
            self.metrics.increment_counter("app_tpu_fleet_route_total",
                                           policy=self.policy.name,
                                           reason=reason)
            if self.policy.name == "affinity":
                if reason == "affinity":
                    self.metrics.increment_counter(
                        "app_tpu_fleet_affinity_hits_total")
                else:
                    self.metrics.increment_counter(
                        "app_tpu_fleet_affinity_misses_total")

    def _count_route_skips(self):
        """Once per forward: record replicas excluded by lifecycle, under
        the same route_total metric so dashboards see WHY the candidate
        set shrank (reason=warming|draining)."""
        for replica in list(self.registry.replicas):
            lifecycle = replica.effective_lifecycle
            if lifecycle == "serving":
                continue
            self.route_skips[lifecycle] = self.route_skips.get(lifecycle, 0) + 1
            if self.metrics is not None:
                self.metrics.increment_counter("app_tpu_fleet_route_total",
                                               policy=self.policy.name,
                                               reason=lifecycle)

    def _count_retry(self, reason):
        self.retries[reason] = self.retries.get(reason, 0) + 1
        if self.metrics is not None:
            self.metrics.increment_counter("app_tpu_fleet_retries_total",
                                           reason=reason)

    def _count_class(self, table, metric, qos_class):
        cls = qos_class or "unclassified"
        table[cls] = table.get(cls, 0) + 1
        if self.metrics is not None:
            self.metrics.increment_counter(metric, **{"class": cls})

    def _count_stream_break(self, replica):
        self.stream_breaks += 1
        replica.stream_breaks += 1
        if self.metrics is not None:
            self.metrics.increment_counter("app_tpu_fleet_stream_breaks_total",
                                           replica=replica.name)

    # -- forwarding -----------------------------------------------------------
    def forward(self, ctx, body, qos_class=None):
        """Route one /generate body; returns a Stream (SSE pass-through)
        or a Response (buffered pass-through), or raises
        ServiceUnavailable when every attempt found no usable replica.
        qos_class (already normalized by the route handler) is counted
        per class so fleet shedding/spillover is QoS-attributable; the
        class itself rides inside `body`, which is forwarded verbatim."""
        prompt = body.get("prompt", "")
        keys = affinity_keys(prompt, self.affinity_block,
                             self.affinity_max_blocks)
        if self.capture is not None:
            self.capture.note(prompt, qos_class=qos_class,
                              tenant=body.get("tenant"),
                              max_new=body.get("max_tokens"))
        journeys = self.journeys
        journey = None
        if journeys is not None:
            span = getattr(ctx, "span", None)
            journey = journeys.begin(
                trace_id=getattr(span, "trace_id", None),
                qos_class=qos_class, tenant=body.get("tenant"),
                prompt_chars=len(prompt))
        tried = set()
        attempts = 1 + self.retry_budget
        shortest_shed = None
        self._count_route_skips()
        for attempt in range(attempts):
            candidates = self.registry.candidates(exclude=tried)
            if not candidates:
                break
            replica, reason = self.policy.choose(candidates, keys,
                                                 self.affinity_map)
            self._count_route(reason)
            if journeys is not None:
                journeys.attempt(journey, replica.name, reason)
            replica.begin()
            try:
                resp = replica.client.request(ctx, "POST", "/generate",
                                              body=body, stream=True)
            except Exception as exc:  # noqa: BLE001 - unstarted: safe to retry
                replica.end()
                tried.add(replica.name)
                kind = ("breaker_open" if isinstance(exc, CircuitOpenError)
                        else "connect_error")
                if replica.effective_lifecycle == "draining":
                    # the replica went draining between candidate
                    # selection and connect — still UNSTARTED, still
                    # retryable, but labeled so drains don't read as
                    # transport faults
                    kind = "draining"
                self._count_retry(kind)
                if journeys is not None:
                    journeys.attempt_outcome(journey, kind)
                if self.logger is not None:
                    self.logger.warnf("fleet: %s to %s (attempt %d): %s",
                                      kind, replica.name, attempt + 1, exc)
                continue
            if resp.status_code == 503:
                if replica.effective_lifecycle == "draining":
                    # mid-drain refusal: the replica is LEAVING, not
                    # overloaded — retry elsewhere without charging the
                    # shed window (note_shed would outlive the replica)
                    resp.close()
                    replica.end()
                    tried.add(replica.name)
                    self._count_retry("draining")
                    if journeys is not None:
                        journeys.attempt_outcome(journey, "draining")
                    continue
                retry_after = _parse_retry_after(resp.header("Retry-After"))
                replica.note_shed(retry_after)
                shortest_shed = (retry_after if shortest_shed is None
                                 else min(shortest_shed, retry_after))
                resp.close()
                replica.end()
                tried.add(replica.name)
                self._count_retry("shed")
                if journeys is not None:
                    journeys.attempt_outcome(journey, "shed")
                self._count_class(self.class_sheds,
                                  "app_tpu_fleet_class_sheds_total",
                                  qos_class)
                continue
            # committed to this replica from here on — no more retries
            self._count_class(self.class_routes,
                              "app_tpu_fleet_class_routes_total", qos_class)
            if journeys is not None:
                journeys.committed(journey, replica.name, resp.status_code)
            if resp.status_code >= 400:
                content = resp.read()
                replica.end()
                if journeys is not None:
                    journeys.finish(journey, "upstream_error",
                                    error=f"upstream {resp.status_code}")
                return Response(
                    status=resp.status_code,
                    headers={"Content-Type": resp.header("Content-Type")
                             or "application/json"},
                    body=content)
            self.affinity_map.learn(keys, replica.name)
            content_type = (resp.header("Content-Type") or "").lower()
            if ("text/event-stream" in content_type
                    or resp.header("Transfer-Encoding") == "chunked"):
                return self._passthrough_stream(resp, replica,
                                                content_type
                                                or "text/event-stream",
                                                journey)
            content = resp.read()
            replica.end()
            if journeys is not None:
                journeys.finish(journey, "ok")
            return Response(
                status=resp.status_code,
                headers={"Content-Type": content_type or "application/json"},
                body=content)
        self.no_replica += 1
        if journeys is not None:
            journeys.finish(journey, "no_replica")
        retry_after = shortest_shed or self.registry.probe_s or 1.0
        raise ServiceUnavailable(
            f"no replica available after {attempts} attempt(s) "
            f"({len(self.registry.replicas)} configured, "
            f"{len(self.registry.candidates())} healthy)",
            retry_after_s=retry_after)

    def _passthrough_stream(self, resp, replica, content_type, journey=None):
        """Byte-for-byte pass-through tied to the client connection: the
        Stream's on_close closes the upstream socket (propagating client
        disconnect as upstream cancel) and releases in-flight. The
        journey record observes the stream from here: first chunk stamps
        TTFB, an upstream death goes terminal as stream_break, on_close
        finishes the journey ok (a no-op when it already broke)."""
        router = self
        journeys = self.journeys

        def chunks():
            first = True
            try:
                for chunk in resp.iter_chunks():
                    if chunk:
                        if journeys is not None:
                            if first:
                                journeys.first_chunk(journey)
                                first = False
                            journeys.chunk(journey)
                        yield chunk
            except Exception as exc:  # noqa: BLE001 - upstream died mid-stream
                router._count_stream_break(replica)
                if journeys is not None:
                    journeys.finish(journey, "stream_break", error=str(exc))
                if router.logger is not None:
                    router.logger.errorf("fleet: stream from %s broke: %s",
                                         replica.name, exc)
                event = {"error": {"message":
                                   f"upstream replica {replica.name} lost "
                                   "mid-stream", "recoverable": False}}
                yield f"data: {json.dumps(event)}\n\n".encode()

        def on_close():
            resp.close()
            replica.end()
            if journeys is not None:
                journeys.finish(journey, "ok")

        return Stream(chunks(), content_type=content_type, sse=False,
                      on_close=on_close)

    # -- debug surface --------------------------------------------------------
    def snapshot(self):
        total_routes = sum(self.routes.values())
        hits = self.affinity_hits
        misses = self.affinity_misses
        hit_rate = hits / (hits + misses) if (hits + misses) else None
        snap = self.registry.snapshot()
        for row in snap["replicas"]:
            row["affinity_entries"] = self.affinity_map.entries_for(row["name"])
        if self.journeys is not None:
            snap["journeys"] = {"finished_total": self.journeys.finished_total,
                                "capacity": self.journeys.capacity}
        return {
            "policy": self.policy.name,
            "retry_budget": self.retry_budget,
            "routes": dict(self.routes),
            "routes_total": total_routes,
            "route_skips": dict(self.route_skips),
            "retries": dict(self.retries),
            "classes": {"routes": dict(self.class_routes),
                        "sheds": dict(self.class_sheds)},
            "no_replica": self.no_replica,
            "stream_breaks": self.stream_breaks,
            "affinity": {
                "block": self.affinity_block,
                "max_blocks": self.affinity_max_blocks,
                "map_size": len(self.affinity_map),
                "hits": hits,
                "misses": misses,
                "hit_rate": round(hit_rate, 4) if hit_rate is not None else None,
            },
            **snap,
        }


def _parse_retry_after(value):
    try:
        parsed = float(value)
        return parsed if parsed > 0 else _DEFAULT_SHED_RETRY_AFTER_S
    except (TypeError, ValueError):
        return _DEFAULT_SHED_RETRY_AFTER_S


def install_routes(app, router):
    """Register the serving surface on an App: POST /generate
    (the transparent front door) plus GET /debug/fleet."""

    @app.post("/generate")
    def generate(ctx):
        body = ctx.bind()
        if not isinstance(body, dict):
            raise InvalidParam(["body"])
        prompt = body.get("prompt")
        if prompt is None:
            raise MissingParam(["prompt"])
        if not isinstance(prompt, str) or not prompt:
            raise InvalidParam(["prompt"])
        # QoS class from header or body, validated AT THE FRONT DOOR
        # (typed 400 for unknown strings — tpu/qos.py contract) and
        # injected into the forwarded body so every replica sees the
        # same classification the router counted
        qos_class = normalize_class(
            ctx.request.header("X-QoS-Class") or body.get("class") or None)
        if qos_class is not None:
            body["class"] = qos_class
        tenant = ctx.request.header("X-Tenant") or body.get("tenant")
        if tenant:
            body["tenant"] = str(tenant)
        return router.forward(ctx, body, qos_class=qos_class)

    from .debug import install_routes as install_debug_routes
    install_debug_routes(app, router)
    return app

"""App facade: the HTTP server and the metrics server around one container.

Counterpart of ``gofr_tpu/app.py`` (``App``), cut to what the port's servers
use: ``App(config, container)`` (a Config or a plain mapping; with neither,
``EnvFile`` over ``GOFR_CONFIGS_DIR``, default ``./configs``; a container
passed in is used as it is, and the App reads its own keys from `config`
when one is given, else from the container's), the route
verbs ``get``/``post``/``add_route``, the default middleware chain in the
reference's order, Tracer -> Logging -> CORS -> Metrics (http/middleware.py),
``MAX_CONCURRENT_REQUESTS`` handler slots (default 256,
<= 0 for none; a request that finds them full for 0.5 s gets a 503, a
streamed response holds its slot until its body ends, ``/.well-known/*``
bypasses them), ``GET /.well-known/health`` (the container's aggregate) and
``GET /.well-known/alive`` (in the ``{data}`` envelope, as the reference's
handlers answer), the metrics server on ``METRICS_PORT`` (default 2121, 0
picks a free port; ``GET /metrics`` in Prometheus text, or OpenMetrics
with exemplars when the scrape accepts it, plus the two well-known routes,
unwrapped), ``start``/``run``/``shutdown`` with ``on_shutdown``
hooks (run first, LIFO) and ``add_health_contributor``.

A handler runs on its connection's server thread; ``REQUEST_TIMEOUT``
(seconds, default 5, <= 0 for none) sets the deadline it reads through
``ctx.remaining()``. The metrics server runs the container's scrape hooks
at every scrape.

The observability planes, with the reference's config keys and defaults
(``gofr_tpu/app.py``): ``enable_flight_recorder`` (``/debug/requests``),
``enable_journey`` (``/debug/journey``), ``enable_engine_snapshot``
(``/debug/engine``, the utilization gauges and the memory sampler),
``enable_step_ledger`` (``/debug/steps``), ``enable_timeline``
(``/debug/timeline``) and ``enable_hostprof`` (``/debug/hostprof``); each
returns what the reference's returns and stops its thread on shutdown.
Waiting: the incident autopsy, SLO burn, capacity and profiler planes
(ROADMAP A11d), fault injection and QoS (A11e), drain with migration
(A11f). Waiting in ROADMAP A18b: the auth middlewares, gRPC, cron, pub/sub
subscriptions, static files and the OpenAPI routes.
"""

from __future__ import annotations

import json
import os
import threading
import time
import traceback
from typing import Any, Callable, Mapping, Optional, Union

from .config import Config, EnvFile, as_config
from .container import Container
from .context import Context
from .http import middleware as mw
from .http.errors import HTTPError, ServiceUnavailable
from .http.request import Request
from .http.responder import Responder, Response, Stream
from .http.router import Router
from .http.server import HTTPServer

__all__ = ["App", "Context", "Stream"]

DEFAULT_HTTP_PORT = 8000
DEFAULT_METRICS_PORT = 2121
DEFAULT_REQUEST_TIMEOUT_S = 5.0
DEFAULT_MAX_CONCURRENT_REQUESTS = 256

Handler = Callable[[Context], Any]


def _stream_with_slot(stream: Stream, release: Callable[[], None]) -> Stream:
    """Tie a handler slot to a streamed response's lifetime: released once,
    when the body ends or the client goes away, after any user on_close."""
    prev = stream.on_close
    released = threading.Event()

    def close() -> None:
        try:
            if prev is not None:
                prev()
        finally:
            if not released.is_set():
                released.set()
                release()

    stream.on_close = close
    return stream


class App:
    def __init__(self, config: Union[Config, Mapping[str, str], None] = None,
                 container: Optional[Container] = None):
        if container is not None:
            # an engine's container (serve.app_for): its metrics, tracer and
            # logger; the App's own keys come from `config` when given
            self.container = container
            self.config = (container.config if config is None
                           else as_config(config))
        else:
            if config is None:
                config = EnvFile(os.environ.get("GOFR_CONFIGS_DIR",
                                                "./configs"))
            self.config = as_config(config)
            self.container = Container.create(self.config)
        self.logger = self.container.logger
        self.router = Router()
        self.request_timeout_s = self.config.get_float(
            "REQUEST_TIMEOUT", DEFAULT_REQUEST_TIMEOUT_S)
        # a cap on concurrently running handlers, live streams included
        self.max_concurrent_requests = self.config.get_int(
            "MAX_CONCURRENT_REQUESTS", DEFAULT_MAX_CONCURRENT_REQUESTS)
        self._handler_slots = (
            threading.BoundedSemaphore(self.max_concurrent_requests)
            if self.max_concurrent_requests > 0 else None)
        self.http_port = self.config.get_int("HTTP_PORT", DEFAULT_HTTP_PORT)
        self.metrics_port = self.config.get_int("METRICS_PORT",
                                                DEFAULT_METRICS_PORT)
        self._http_server: Optional[HTTPServer] = None
        self._metrics_server: Optional[HTTPServer] = None
        self._shutdown_hooks: list = []
        # the default chain, in the reference's order
        self.router.use_middleware(
            mw.tracer_middleware(self.container.tracer),
            mw.logging_middleware(self.logger),
            mw.cors_middleware(),
            mw.metrics_middleware(self.container.metrics_manager),
        )
        # the reference's well-known handlers, in the {data} envelope
        self.router.add("GET", "/.well-known/health",
                        self._wire(lambda ctx: self.health()))
        self.router.add("GET", "/.well-known/alive",
                        self._wire(lambda ctx: {"status": "UP"}))

    # -- routes ---------------------------------------------------------------
    def add_route(self, method: str, pattern: str,
                  handler: Optional[Handler] = None):
        if handler is None:  # decorator form: @app.get("/path")
            def decorator(fn: Handler) -> Handler:
                self.add_route(method, pattern, fn)
                return fn
            return decorator
        self.router.add(method, pattern, self._wire(handler))
        return handler

    def get(self, pattern: str, handler: Optional[Handler] = None):
        return self.add_route("GET", pattern, handler)

    def post(self, pattern: str, handler: Optional[Handler] = None):
        return self.add_route("POST", pattern, handler)

    def _wire(self, handler: Handler):
        def wire_handler(request: Request) -> Response:
            responder = Responder(request.method)
            # /.well-known/* bypasses the cap: "is the process up" must
            # answer precisely when the app sheds everything else
            shed = (self._handler_slots is not None
                    and not request.path.startswith("/.well-known/"))
            if shed and not self._handler_slots.acquire(timeout=0.5):
                return responder.respond(None, ServiceUnavailable(
                    "server overloaded; try again later"))
            transferred = False
            try:
                deadline = (time.monotonic() + self.request_timeout_s
                            if self.request_timeout_s > 0 else None)
                try:
                    data = handler(Context(request, self.container,
                                           responder, deadline))
                except HTTPError as exc:
                    return responder.respond(None, exc)
                except Exception as exc:  # noqa: BLE001 - keep serving
                    self.logger.errorf("handler %s %s failed: %s",
                                       request.method, request.path,
                                       traceback.format_exc())
                    return responder.respond(None, exc)
                if shed and isinstance(data, Stream):
                    # a streamed body is generated after the handler
                    # returns: the slot follows the stream
                    data = _stream_with_slot(data,
                                             self._handler_slots.release)
                    transferred = True
                return responder.respond(data, None)
            finally:
                if shed and not transferred:
                    self._handler_slots.release()

        return wire_handler

    # -- the observability planes ---------------------------------------------
    def enable_flight_recorder(self, engine, path: str = "/debug/requests"):
        """Attach a per-request flight recorder to `engine` and serve GET
        /debug/requests and /debug/requests/{id} (tpu/flightrecorder.py),
        with the app_tpu_slo_*_goodput gauges. Config:
        FLIGHT_RECORDER_CAPACITY (completed-request ring, 256),
        FLIGHT_RECORDER_MAX_EVENTS (per request, 512), SLO_TTFT_TARGET_S /
        SLO_TPOT_TARGET_S (goodput targets, 0.15 / 0.05). An engine that
        already has a recorder keeps it; only the app's metrics and tracer
        are wired then. Returns the recorder."""
        from .tpu.flightrecorder import (FlightRecorder, install_routes,
                                         register_slo_gauges)

        recorder = getattr(engine, "recorder", None)
        if recorder is None:
            recorder = FlightRecorder(
                capacity=self.config.get_int("FLIGHT_RECORDER_CAPACITY", 256),
                max_events=self.config.get_int(
                    "FLIGHT_RECORDER_MAX_EVENTS", 512),
                slo_ttft_s=self.config.get_float("SLO_TTFT_TARGET_S", 0.150),
                slo_tpot_s=self.config.get_float("SLO_TPOT_TARGET_S", 0.050),
                metrics=self.container.metrics_manager,
                tracer=self.container.tracer)
            engine.recorder = recorder
        else:
            recorder.use_metrics(self.container.metrics_manager)
            recorder.use_tracer(self.container.tracer)
        if self.container.metrics_manager is not None:
            register_slo_gauges(self.container.metrics_manager)
        install_routes(self, recorder, path)
        return recorder

    def enable_journey(self, engine, path: str = "/debug/journey"):
        """Serve GET /debug/journey (recent index) and /debug/journey/{id}
        (one hop waterfall; id = engine request id or 32-hex trace id),
        from the engine's flight recorder (tpu/journey.py). Returns the
        recorder, or None without one (enable_flight_recorder first)."""
        if getattr(engine, "recorder", None) is None:
            return None
        from .tpu.journey import install_routes

        install_routes(self, engine, path)
        return engine.recorder

    def enable_engine_snapshot(self, engine, path: str = "/debug/engine"):
        """Serve GET /debug/engine (slots, buckets, page pool, utilization
        window, program table, card memory; tpu/utilization.py), publish
        the utilization gauges (app_tpu_mfu / app_tpu_mbu /
        app_tpu_device_duty_cycle / app_tpu_host_overhead_seconds) at every
        dispatch sync and every scrape, refresh the card-memory gauges at
        every scrape, and start the background memory / page-pool sampler.
        Config: ENGINE_HBM_SAMPLE_S (sampler cadence, 10 s; <= 0: no thread,
        the scrape still refreshes). TPU_PEAK_FLOPS / TPU_PEAK_HBM_BW in the
        process environment override the peaks MFU and MBU divide by.
        Returns the engine's UtilizationLedger (None without one)."""
        from .tpu.device import refresh_memory_metrics
        from .tpu.utilization import (MemorySampler, install_routes,
                                      register_utilization_metrics)

        metrics = self.container.metrics_manager
        if metrics is not None:
            register_utilization_metrics(metrics)
        util = getattr(engine, "util", None)
        if util is not None:
            util.use_metrics(metrics)
            # scrape-time republish: an idle engine's duty cycle decays to
            # zero instead of freezing at the last dispatch's value
            self.container.add_scrape_hook("engine_util", util.publish)
        device = getattr(engine, "device", None)
        if metrics is not None:
            self.container.add_scrape_hook(
                "engine_hbm", lambda: refresh_memory_metrics(metrics, device))
        install_routes(self, engine, path)
        interval = self.config.get_float("ENGINE_HBM_SAMPLE_S", 10.0)
        if interval > 0:
            sampler = MemorySampler(metrics, engine=engine,
                                    interval_s=interval, logger=self.logger)
            sampler.start()
            self.on_shutdown(sampler.stop)
        return util

    def enable_step_ledger(self, engine, path: str = "/debug/steps"):
        """Serve GET /debug/steps (tpu/stepledger.py) and record the
        app_tpu_step_seconds{phase,segment} histograms and
        app_tpu_step_stragglers_total{cause}. Config: STEP_LEDGER_CAPACITY
        (ring, 512), STEP_STRAGGLER_K (3.0), STEP_BASELINE_ALPHA (0.1),
        STEP_BASELINE_MIN_SAMPLES (16). Returns the ledger (None for an
        engine without one)."""
        from .tpu.stepledger import install_routes, register_step_metrics

        ledger = getattr(engine, "steps", None)
        if ledger is None:
            return None
        metrics = self.container.metrics_manager
        if metrics is not None:
            register_step_metrics(metrics)
            ledger.use_metrics(metrics)
        ledger.configure(
            capacity=self.config.get_int("STEP_LEDGER_CAPACITY", 512),
            straggler_k=self.config.get_float("STEP_STRAGGLER_K", 3.0),
            baseline_alpha=self.config.get_float("STEP_BASELINE_ALPHA", 0.1),
            min_samples=self.config.get_int("STEP_BASELINE_MIN_SAMPLES", 16))
        install_routes(self, ledger, path)
        return ledger

    def enable_timeline(self, engine, path: str = "/debug/timeline"):
        """Serve GET /debug/timeline[?steps=N]: the step ledger, flight
        recorder, utilization ledger and program captures as one Perfetto
        trace (tpu/timeline.py). Config: TIMELINE_STEPS (the default step
        window, 128). Returns the TimelineExporter, also on
        engine.timeline."""
        from .tpu.timeline import (TimelineExporter, install_routes,
                                   register_timeline_metrics)

        metrics = self.container.metrics_manager
        if metrics is not None:
            register_timeline_metrics(metrics)
        exporter = TimelineExporter(
            engine, process_name=self.container.app_name,
            max_steps=self.config.get_int("TIMELINE_STEPS", 128),
            metrics=metrics)
        engine.timeline = exporter
        install_routes(self, exporter, path)
        return exporter

    def enable_hostprof(self, engine=None, path: str = "/debug/hostprof"):
        """Start the host sampling profiler and serve GET /debug/hostprof
        (tpu/hostprof.py); its thread stops on shutdown. Config:
        HOSTPROF_HZ (50; <= 0: nothing starts, None is returned),
        HOSTPROF_MAX_STACKS (256 per class), HOSTPROF_TOP_K (5). Returns the
        HostProfiler, also on engine.hostprof."""
        from .tpu.hostprof import (HostProfiler, install_routes,
                                   register_hostprof_metrics)

        hz = self.config.get_float("HOSTPROF_HZ", 50.0)
        if hz <= 0:
            return None
        metrics = self.container.metrics_manager
        if metrics is not None:
            register_hostprof_metrics(metrics)
        prof = HostProfiler(
            hz=hz,
            max_stacks=self.config.get_int("HOSTPROF_MAX_STACKS", 256),
            top_k=self.config.get_int("HOSTPROF_TOP_K", 5),
            metrics=metrics, logger=self.logger)
        prof.start()
        self.on_shutdown(prof.stop)
        if engine is not None:
            engine.hostprof = prof
        install_routes(self, prof, path)
        return prof

    # -- health ---------------------------------------------------------------
    def add_health_contributor(self, name: str,
                               check: Callable[[], Any]) -> None:
        """check() returns a dict with a "status" of UP, DOWN or DEGRADED."""
        self.container.add_health_contributor(name, check)

    def health(self):
        return self.container.health()

    # -- the metrics server ---------------------------------------------------
    def _metrics_router(self) -> Router:
        router = Router()

        def metrics_handler(request: Request) -> Response:
            self.container.refresh_runtime_metrics()
            # a scrape that accepts the OpenMetrics dialect gets exemplars;
            # classic Prometheus text stays byte-identical without them
            openmetrics = ("application/openmetrics-text"
                           in request.header("accept"))
            ctype = ("application/openmetrics-text; version=1.0.0; "
                     "charset=utf-8" if openmetrics
                     else "text/plain; version=0.0.4")
            return Response(
                status=200, headers={"Content-Type": ctype},
                body=self.container.metrics_manager.expose(
                    openmetrics=openmetrics).encode())

        router.add("GET", "/metrics", metrics_handler)
        router.add("GET", "/.well-known/health", lambda request: Response(
            status=200, headers={"Content-Type": "application/json"},
            body=json.dumps(self.health()).encode()))
        router.add("GET", "/.well-known/alive", lambda request: Response(
            status=200, headers={"Content-Type": "application/json"},
            body=b'{"status":"UP"}'))
        return router

    # -- lifecycle ------------------------------------------------------------
    def start(self) -> None:
        """Start the metrics and HTTP servers without blocking (port 0 picks
        a free port; the bound ones are in metrics_port and http_port
        afterwards). A metrics server that cannot bind is logged and
        skipped, as in the reference."""
        if self._http_server is not None:
            return
        self._metrics_server = HTTPServer(self._metrics_router(),
                                          self.metrics_port, self.logger)
        try:
            self._metrics_server.start()
            self.metrics_port = self._metrics_server.port
        except OSError as exc:
            self.logger.errorf("metrics server failed to start: %s", exc)
            self._metrics_server = None
        self._http_server = HTTPServer(self.router, self.http_port,
                                       self.logger)
        self._http_server.start()
        self.http_port = self._http_server.port
        self.logger.infof("app %s started: http=:%d metrics=:%d",
                          self.container.app_name, self.http_port,
                          self.metrics_port)

    def run(self) -> None:
        """Start and block until interrupted."""
        self.start()
        try:
            while True:
                time.sleep(3600)
        except KeyboardInterrupt:
            self.shutdown()

    def on_shutdown(self, fn: Callable[[], Any]) -> None:
        """Register a hook run first (LIFO) during shutdown, before the
        servers stop: the place for a graceful drain."""
        self._shutdown_hooks.append(fn)

    def shutdown(self) -> None:
        for hook in reversed(self._shutdown_hooks):
            try:
                hook()
            except Exception as exc:  # noqa: BLE001 - shutdown must proceed
                self.logger.errorf("shutdown hook failed: %s", exc)
        for server in (self._http_server, self._metrics_server):
            if server is not None:
                server.shutdown()
        self._http_server = self._metrics_server = None
        self.container.close()

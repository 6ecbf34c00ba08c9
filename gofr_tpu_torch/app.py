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
(``/debug/timeline``), ``enable_hostprof`` (``/debug/hostprof``),
``enable_profiler`` (``/debug/profile``, torch.profiler under
``PROFILE_DIR``), ``enable_fault_injection`` (``/debug/faults``, only under
``FAULT_INJECTION=true``), ``enable_incident_autopsy`` (``/debug/slo``,
``/debug/incidents``), ``enable_capacity`` (``/debug/capacity``) and
``enable_qos`` (``/debug/qos``, the QoS plane, with its batch lane when
the container has a broker); each returns what the reference's returns and stops its thread
on shutdown; ``enable_drain_migration`` (``POST /migrate``, ``POST|GET
/debug/drain``, ``GET /debug/kvtier``, gated on ``DRAIN_MIGRATE``), and
under ``DISAGG_MODE=both`` ``enable_flight_recorder`` gives the prefill
pool its own recorder.

Pub/sub, cron and the document store, as in the reference
(``gofr_tpu/app.py:733-782``, ``:884-885``, ``:912-913``): ``subscribe``
(one consumer loop per topic, subscriber.py; a handler that returns
commits its message, one that raises leaves it for redelivery; without
a broker it logs and registers nothing), ``add_cron_job`` (a 5-field
spec, cron.py) and ``add_document_store`` (the injected-provider
pattern). ``start`` starts the subscriptions and the crontab and
``shutdown`` stops them after the hooks.

The serving surfaces and the device client, as in the reference
(``gofr_tpu/app.py:210-241``, ``:765-773``, ``:874-881``, ``:917-918``):
``use_middleware`` (appended to the chain), ``enable_basic_auth``,
``enable_api_key_auth``, ``enable_oauth`` (HS256) and
``enable_oauth_jwks`` (RS256 against a refreshed JWKS; without the
``cryptography`` package it logs and is skipped; its refresher stops at
shutdown), every one passing ``/.well-known/*`` through
(http/middleware.py); ``register_grpc_service`` (grpcx/): with a service
registered, ``start`` serves gRPC on GRPC_PORT (default 9000, 0 picks a
free port, in ``grpc_port`` afterwards) after the HTTP server, and
``shutdown`` stops it after the HTTP server; ``grpc`` is imported only
then, and without it a set GRPC_PORT fails the start while an unset one
is logged and serves no gRPC; ``add_tpu`` (the device client,
tpu/device.CUDAClient: ``use_logger`` / ``use_metrics`` / ``connect``,
then ``container.tpu``), which ``enable_fault_injection`` arms with the
plane and ``enable_engine_snapshot``'s memory sampler reads. Waiting in
ROADMAP A18b part 7: static files and the OpenAPI routes.
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
from .subscriber import SubscriptionManager

__all__ = ["App", "Context", "Stream"]

DEFAULT_HTTP_PORT = 8000
DEFAULT_GRPC_PORT = 9000
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
                 container: Optional[Container] = None, device=None,
                 device_client: bool = True):
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
            # device: the entry point's, for the container's device client
            # (device_client False: none, for a process holding no tensor)
            self.container = Container.create(self.config, device=device,
                                              device_client=device_client)
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
        self.grpc_port = self.config.get_int("GRPC_PORT", DEFAULT_GRPC_PORT)
        self.metrics_port = self.config.get_int("METRICS_PORT",
                                                DEFAULT_METRICS_PORT)
        self._http_server: Optional[HTTPServer] = None
        self._metrics_server: Optional[HTTPServer] = None
        self._grpc_server = None
        self._grpc_services: list = []
        self._shutdown_hooks: list = []
        self._subscriptions = SubscriptionManager(self.container)
        self._cron = None
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

    # -- middleware and auth --------------------------------------------------
    def use_middleware(self, *mws) -> None:
        """Append middleware to the chain, after the default four."""
        self.router.use_middleware(*mws)

    def enable_basic_auth(self, *creds: str, users=None,
                          validate_func=None) -> None:
        """Basic auth: users as (name, password) pairs, a dict, or
        validate_func(name, password)."""
        userdict = dict(users or {})
        for i in range(0, len(creds) - 1, 2):
            userdict[creds[i]] = creds[i + 1]
        self.router.use_middleware(
            mw.basic_auth_middleware(userdict, validate_func))

    def enable_api_key_auth(self, *keys: str, validate_func=None) -> None:
        """X-API-Key auth against `keys`, or validate_func(key)."""
        self.router.use_middleware(
            mw.api_key_auth_middleware(keys, validate_func))

    def enable_oauth(self, secret: str) -> None:
        """Bearer JWTs signed HS256 with `secret`."""
        self.router.use_middleware(mw.oauth_middleware(secret))

    def enable_oauth_jwks(self, jwks_url: str,
                          refresh_interval_s: float = 300.0,
                          keyset=None) -> None:
        """Bearer JWTs signed RS256, against the kid-indexed keys of
        `jwks_url` refreshed every `refresh_interval_s` on a background
        thread (stopped at shutdown). Without the `cryptography` package
        this logs and is skipped, as the reference's."""
        try:
            keyset = keyset or mw.JWKSKeySet(
                jwks_url, refresh_interval_s=refresh_interval_s,
                logger=self.logger)
        except RuntimeError as exc:
            self.logger.errorf("OAuth JWKS disabled: %s", exc)
            return
        self.on_shutdown(keyset.close)
        self.router.use_middleware(mw.oauth_jwks_middleware(keyset))

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
        # DISAGG_MODE=both: the prefill pool gets its own recorder, so the
        # prefill half of every hand-off is seen by the journey and emits
        # engine spans on the shared trace; no metrics (the goodput gauges
        # are the serving engine's alone)
        disagg = getattr(engine, "disagg_router", None)
        prefill = (getattr(disagg, "prefill_engine", None)
                   if disagg is not None else None)
        if prefill is not None and getattr(prefill, "recorder", None) is None:
            prefill.recorder = FlightRecorder(
                capacity=self.config.get_int("FLIGHT_RECORDER_CAPACITY", 256),
                max_events=self.config.get_int(
                    "FLIGHT_RECORDER_MAX_EVENTS", 512),
                tracer=self.container.tracer)
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
            sampler = MemorySampler(metrics, tpu=self.container.tpu,
                                    engine=engine, interval_s=interval,
                                    logger=self.logger)
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

    def enable_profiler(self, path: str = "/debug/profile") -> None:
        """Serve on-demand torch.profiler captures (tpu/profiler.py): POST
        /debug/profile (202, the capture on a daemon thread, 409 while one
        runs) and GET /debug/profile (status). Config: PROFILE_DIR (the
        capture root for POSTs without "dir" and for incident captures,
        ./profiles); status reports paths relative to it."""
        from .tpu.profiler import configure, install_routes

        configure(self.config.get_or_default("PROFILE_DIR", "./profiles"))
        install_routes(self, path)

    def enable_fault_injection(self, engine, path: str = "/debug/faults"):
        """Arm the chaos plane (tpu/faults.py) on an engine, its executor and
        the container's device client (the ``device.health_probe`` site)
        and serve POST/GET /debug/faults, HARD-gated on FAULT_INJECTION=true:
        otherwise this returns None, registers no route (404) and leaves
        the engine's ``faults=None``. Config: FAULT_INJECTION,
        FAULT_INJECTION_PLAN (inline JSON or ``@/path/to/plan.json``),
        FAULT_INJECTION_SEED. Returns the FaultPlane when enabled."""
        from .tpu.faults import install_routes, plane_from_config

        plane = plane_from_config(self.config, logger=self.logger)
        if plane is None:
            return None
        engine.faults = plane
        executor = getattr(engine, "executor", None)
        if executor is not None:
            executor.faults = plane
        if self.container.tpu is not None:
            self.container.tpu.faults = plane
        install_routes(self, plane, path)
        self.logger.warnf(
            "FAULT INJECTION ENABLED: chaos plane armed on the engine, "
            "executor, and device; POST %s drives drills", path)
        return plane

    def enable_incident_autopsy(self, engine, slo_path: str = "/debug/slo",
                                incidents_path: str = "/debug/incidents"):
        """Wire the incident plane (tpu/incidents.py) onto an engine: the
        SLO burn engine (fed by the flight recorder, app_tpu_slo_burn_rate /
        app_tpu_slo_alert_state, GET /debug/slo, republished at every
        scrape so burn decays when idle) and the IncidentManager (bundles on
        burn pages, straggler streaks, breaker opens and quarantines, GET
        /debug/incidents[/{id}[/trace]]). Config: SLO_BURN_FAST_WINDOW_S /
        SLO_BURN_SLOW_WINDOW_S (300 / 3600), SLO_BURN_PAGE / SLO_BURN_WARN
        (14.4 / 6.0), SLO_BURN_OBJECTIVE_{TTFT,TPOT,AVAILABILITY} (0.99 /
        0.99 / 0.999), SLO_BURN_MIN_EVENTS (12), SLO_TTFT_TARGET_S /
        SLO_TPOT_TARGET_S; INCIDENT_DIR (./incidents), INCIDENT_RING (32),
        INCIDENT_COOLDOWN_S / INCIDENT_MAX_PER_HOUR (300 / 6),
        INCIDENT_SLOWEST_K (5), INCIDENT_PROFILE_S (a torch.profiler capture
        per bundle; 0 = off), INCIDENT_STRAGGLER_STREAK /
        INCIDENT_STRAGGLER_WINDOW (3 / 32), PROFILE_DIR (where those
        captures go; default INCIDENT_DIR/profiles). Returns
        (burn_engine, incident_manager)."""
        from .tpu.incidents import (IncidentManager, SLOBurnEngine,
                                    install_routes,
                                    register_incident_metrics)

        cfg = self.config
        metrics = self.container.metrics_manager
        if metrics is not None:
            register_incident_metrics(metrics)
        recorder = getattr(engine, "recorder", None)
        burn = SLOBurnEngine(
            slo_ttft_s=cfg.get_float("SLO_TTFT_TARGET_S", 0.150),
            slo_tpot_s=cfg.get_float("SLO_TPOT_TARGET_S", 0.050),
            objectives={
                "ttft": cfg.get_float("SLO_BURN_OBJECTIVE_TTFT", 0.99),
                "tpot": cfg.get_float("SLO_BURN_OBJECTIVE_TPOT", 0.99),
                "availability": cfg.get_float(
                    "SLO_BURN_OBJECTIVE_AVAILABILITY", 0.999)},
            fast_window_s=cfg.get_float("SLO_BURN_FAST_WINDOW_S", 300.0),
            slow_window_s=cfg.get_float("SLO_BURN_SLOW_WINDOW_S", 3600.0),
            page_burn=cfg.get_float("SLO_BURN_PAGE", 14.4),
            warn_burn=cfg.get_float("SLO_BURN_WARN", 6.0),
            min_events=cfg.get_int("SLO_BURN_MIN_EVENTS", 12),
            metrics=metrics, logger=self.logger)
        incident_dir = cfg.get_or_default("INCIDENT_DIR", "./incidents")
        incidents = IncidentManager(
            engine=engine, recorder=recorder, dir=incident_dir,
            capacity=cfg.get_int("INCIDENT_RING", 32),
            cooldown_s=cfg.get_float("INCIDENT_COOLDOWN_S", 300.0),
            max_per_hour=cfg.get_int("INCIDENT_MAX_PER_HOUR", 6),
            slowest_k=cfg.get_int("INCIDENT_SLOWEST_K", 5),
            profile_seconds=cfg.get_float("INCIDENT_PROFILE_S", 0.0),
            profile_dir=(cfg.get("PROFILE_DIR")
                         or os.path.join(incident_dir, "profiles")),
            straggler_streak=cfg.get_int("INCIDENT_STRAGGLER_STREAK", 3),
            straggler_window=cfg.get_int("INCIDENT_STRAGGLER_WINDOW", 32),
            fingerprint={"app": self.container.app_name,
                         "version": self.container.app_version},
            metrics=metrics, logger=self.logger)
        burn.on_page = incidents.on_slo_page
        if recorder is not None:
            recorder.use_burn_engine(burn)
        engine.incidents = incidents
        # scrape-time re-evaluation: burn must DECAY while the server idles
        self.container.add_scrape_hook("slo_burn", burn.publish)
        install_routes(self, burn, incidents, slo_path, incidents_path)
        return burn, incidents

    def enable_qos(self, engine, burn=None, path: str = "/debug/qos"):
        """Wire the QoS plane (tpu/qos.py) onto an engine: request classes
        on priority bands, per-class deadlines, the interactive slot
        reservation and the batch page share, and the shed ladder (park
        batch, preempt batch through the replay contract, ask for a
        replica, 503 standard) driven by the SLO burn engine: `burn`, else
        the one enable_incident_autopsy gave the engine's recorder (call
        that first; without one the ladder never moves by itself, and the
        classes, quotas and deadlines still apply). Its eval thread stops
        at shutdown; the metrics scrape re-evaluates the ladder, so it
        recovers while the server idles. Config: QOS_INTERACTIVE_RESERVED_
        SLOTS (1), QOS_BATCH_PAGE_FRACTION (0.5), QOS_DEADLINE_{INTERACTIVE,
        STANDARD,BATCH}_S (0 = none), QOS_SHED_TRACKS ("ttft,tpot"),
        QOS_ESCALATE_HOLD_S / QOS_RECOVER_HOLD_S (5 / 10), QOS_EVAL_S (1.0),
        QOS_SHED_RETRY_AFTER_S (2.0). With a pub/sub broker on the container
        and QOS_LANE (true), the batch lane (tpu/qos.BatchLane) feeds the
        batch band from QOS_BATCH_TOPIC ("qos.batch.jobs"), publishes to
        QOS_BATCH_RESULT_TOPIC ("qos.batch.results") with up to
        QOS_LANE_MAX_INFLIGHT (4) jobs in the engine, and a cron job on
        QOS_LANE_CRON ("* * * * *") kicks its drain; it rides on
        ``controller.lane`` and stops at shutdown. Returns the
        QoSController."""
        from .tpu.qos import (BatchLane, QoSController, install_routes,
                              register_qos_metrics)

        cfg = self.config
        metrics = self.container.metrics_manager
        if metrics is not None:
            register_qos_metrics(metrics)
        tracks = [t.strip() for t in cfg.get_or_default(
            "QOS_SHED_TRACKS", "ttft,tpot").split(",") if t.strip()]
        controller = QoSController(
            interactive_reserved_slots=cfg.get_int(
                "QOS_INTERACTIVE_RESERVED_SLOTS", 1),
            batch_page_fraction=cfg.get_float("QOS_BATCH_PAGE_FRACTION",
                                              0.5),
            deadlines={
                "interactive": cfg.get_float("QOS_DEADLINE_INTERACTIVE_S",
                                             0.0),
                "standard": cfg.get_float("QOS_DEADLINE_STANDARD_S", 0.0),
                "batch": cfg.get_float("QOS_DEADLINE_BATCH_S", 0.0)},
            shed_tracks=tuple(tracks),
            escalate_hold_s=cfg.get_float("QOS_ESCALATE_HOLD_S", 5.0),
            recover_hold_s=cfg.get_float("QOS_RECOVER_HOLD_S", 10.0),
            retry_after_s=cfg.get_float("QOS_SHED_RETRY_AFTER_S", 2.0),
            metrics=metrics, logger=self.logger,
            recorder=getattr(engine, "recorder", None))
        if burn is None:
            burn = getattr(getattr(engine, "recorder", None), "burn", None)
        controller.use_burn_engine(burn)
        controller.engine = engine
        engine.qos = controller
        controller.start_eval_loop(cfg.get_float("QOS_EVAL_S", 1.0))
        self.on_shutdown(controller.stop)
        self.container.add_scrape_hook("qos", controller.publish)
        broker = self.container.pubsub
        if cfg.get_bool("QOS_LANE", True) and broker is not None:
            lane = BatchLane(
                engine, broker,
                topic=cfg.get_or_default("QOS_BATCH_TOPIC", "qos.batch.jobs"),
                result_topic=cfg.get_or_default("QOS_BATCH_RESULT_TOPIC",
                                                "qos.batch.results"),
                tokenizer=getattr(engine, "tokenizer", None),
                max_inflight=cfg.get_int("QOS_LANE_MAX_INFLIGHT", 4),
                metrics=metrics, logger=self.logger, controller=controller)
            controller.lane = lane
            lane.start()
            self.on_shutdown(lane.stop)
            self.add_cron_job(cfg.get_or_default("QOS_LANE_CRON", "* * * * *"),
                              "qos-batch-lane-drain", lane.cron_drain)
        install_routes(self, controller, path)
        return controller

    def enable_capacity(self, engine, path: str = "/debug/capacity"):
        """Wire the capacity observatory (tpu/meter.py) onto an engine: the
        TPUMeter (per-tenant / per-class / per-phase device seconds, FLOPs,
        KV page-seconds and queue wait, the app_tpu_meter_*_total counters)
        and the HeadroomForecaster (λ, μ, ρ, headroom, fluid TTFT, the
        app_tpu_capacity_* gauges, re-evaluated at every scrape), served at
        GET /debug/capacity. Config: METER_PAGE_TOKENS (the dense engine's
        KV page granularity, 16; a paged engine bills its own page size),
        METER_WINDOW_S (300), METER_REQUESTS (512), METER_TOP_K (10),
        CAPACITY_WINDOW_S (60), CAPACITY_RHO_WARN (0.85),
        CAPACITY_COLLAPSE_EVALS (3). Returns the TPUMeter (the forecaster
        on meter.forecaster)."""
        from .tpu.meter import (HeadroomForecaster, TPUMeter,
                                install_routes, register_meter_metrics)

        cfg = self.config
        metrics = self.container.metrics_manager
        if metrics is not None:
            register_meter_metrics(metrics)
        page_tokens = getattr(getattr(engine, "allocator", None),
                              "page_size", None) \
            or cfg.get_int("METER_PAGE_TOKENS", 16)
        meter = TPUMeter(
            cfg=getattr(engine, "cfg", None), page_tokens=page_tokens,
            window_s=cfg.get_float("METER_WINDOW_S", 300.0),
            done_capacity=cfg.get_int("METER_REQUESTS", 512),
            top_k=cfg.get_int("METER_TOP_K", 10),
            metrics=metrics, logger=self.logger)
        meter.forecaster = HeadroomForecaster(
            engine=engine,
            window_s=cfg.get_float("CAPACITY_WINDOW_S", 60.0),
            rho_warn=cfg.get_float("CAPACITY_RHO_WARN", 0.85),
            collapse_evals=cfg.get_int("CAPACITY_COLLAPSE_EVALS", 3),
            metrics=metrics, logger=self.logger)
        engine.meter = meter
        # an idle replica's λ window drains at the scrape
        self.container.add_scrape_hook("capacity", meter.forecaster.publish)
        install_routes(self, meter, path)
        return meter

    def enable_drain_migration(self, engine):
        """Wire the elastic replica surface (tpu/migrate.py) onto an engine:
        its lifecycle (warming / serving / draining, in /stats), the
        MigrationCoordinator behind POST /debug/drain (live sessions export
        as hand-off envelopes and continue on a peer, the replay ladder
        under any failure), POST /migrate (a peer's session landing here)
        and GET /debug/kvtier (the host tier's inventory for warm-booting
        peers). Gated on DRAIN_MIGRATE (default true); DRAIN_SHIP_TIMEOUT_S
        (60) bounds each session's ship and relay. Returns the coordinator
        (None when gated off), also on ``app.drain_coordinator``."""
        from .tpu.migrate import (Lifecycle, MigrationCoordinator,
                                  install_migration_routes,
                                  register_migration_metrics)

        lifecycle = getattr(engine, "lifecycle", None)
        if lifecycle is None:
            lifecycle = Lifecycle("serving")
            engine.lifecycle = lifecycle
        if not self.config.get_bool("DRAIN_MIGRATE", True):
            return None
        metrics = self.container.metrics_manager
        if metrics is not None:
            register_migration_metrics(metrics)
        coordinator = MigrationCoordinator(
            engine, lifecycle, metrics=metrics, logger=self.logger,
            ship_timeout_s=self.config.get_float("DRAIN_SHIP_TIMEOUT_S",
                                                 60.0))
        self.drain_coordinator = coordinator
        install_migration_routes(self, engine, coordinator)
        return coordinator

    # -- pub/sub, cron and the document store ----------------------------------
    def subscribe(self, topic: str, handler: Optional[Handler] = None):
        """Consume `topic` with handler(ctx) from start() on (ctx.bind()
        reads the message's JSON). Also a decorator."""
        if handler is None:
            def decorator(fn: Handler) -> Handler:
                self.subscribe(topic, fn)
                return fn
            return decorator
        if self.container.get_subscriber() is None:
            self.logger.error("pub/sub not configured; set PUBSUB_BACKEND")
            return handler
        self._subscriptions.register(topic, handler)
        return handler

    def add_cron_job(self, spec: str, name: str, fn: Handler) -> None:
        """Run fn(ctx) each minute `spec` matches (cron.Schedule; raises
        cron.CronParseError on a bad spec)."""
        if self._cron is None:
            from .cron import Crontab

            self._cron = Crontab(self.container)
        self._cron.add_job(spec, name, fn)

    def add_document_store(self, store) -> None:
        """Inject a document store: use_logger / use_metrics / connect,
        then ``container.docstore``, in the aggregate health."""
        store.use_logger(self.logger)
        store.use_metrics(self.container.metrics_manager)
        store.connect()
        self.container.docstore = store

    # -- gRPC and the device client ---------------------------------------------
    def register_grpc_service(self, service) -> None:
        """A grpcx.GenericService (or any object with its
        ``__grpc_service_name__`` / ``__grpc_methods__``), served on
        GRPC_PORT from start() on."""
        self._grpc_services.append(service)

    def add_tpu(self, tpu_client) -> None:
        """Inject a device client (tpu/device.CUDAClient): use_logger,
        use_metrics, connect, then ``container.tpu``."""
        tpu_client.use_logger(self.logger)
        tpu_client.use_metrics(self.container.metrics_manager)
        tpu_client.connect()
        self.container.tpu = tpu_client

    def _grpc_server_or_none(self):
        """The gRPC server for the registered services (None without one).
        Without the grpc package a set GRPC_PORT raises, an unset one is
        logged: a port asked for is never silently left unserved."""
        if not self._grpc_services:
            return None
        try:
            from .grpcx import GRPCServer

            server = GRPCServer(self.container, self.grpc_port, self.logger)
        except ImportError as exc:
            if self.config.get("GRPC_PORT"):
                raise RuntimeError(
                    f"GRPC_PORT={self.config.get('GRPC_PORT')} with "
                    f"{len(self._grpc_services)} gRPC service(s) "
                    f"registered, but grpc is not importable: {exc}") from exc
            self.logger.errorf(
                "grpc is not importable (%s): %d gRPC service(s) not served; "
                "set GRPC_PORT to make this fail the start", exc,
                len(self._grpc_services))
            return None
        for service in self._grpc_services:
            server.register(service)
        return server

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
        """Start the metrics and HTTP servers, then gRPC when a service is
        registered, without blocking (port 0 picks a free port; the bound
        ones are in metrics_port, http_port and grpc_port afterwards). A
        metrics server that cannot bind is logged and skipped, as in the
        reference."""
        if self._http_server is not None:
            return
        # before any server starts: a GRPC_PORT that cannot be served
        # fails the start with nothing left listening
        grpc_server = self._grpc_server_or_none()
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
        if grpc_server is not None:
            grpc_server.start()
            self._grpc_server = grpc_server
            self.grpc_port = grpc_server.port
        self._subscriptions.start()
        if self._cron is not None:
            self._cron.start()
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
        self._subscriptions.stop()
        if self._cron is not None:
            self._cron.stop()
        for server in (self._http_server, self._metrics_server):
            if server is not None:
                server.shutdown()
        if self._grpc_server is not None:
            self._grpc_server.stop()
        self._http_server = self._metrics_server = self._grpc_server = None
        self.container.close()

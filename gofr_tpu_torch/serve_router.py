"""The fleet router: a prefix- and health-aware front door over N replicas of
the port's server.

Counterpart of ``examples/router/main.py``: ``build_app(env)`` wires the
same planes under the same opt-out keys, and ``main()`` serves it. Run N
replicas (``python -m gofr_tpu_torch.serve``, one a card, or
``serve.build_app(..., device="cpu")`` in tests), then point the router at
them:

    FLEET_REPLICAS=r0=http://host0:8000,r1=http://host1:8000 \\
    HTTP_PORT=9000 REQUEST_TIMEOUT=120 python -m gofr_tpu_torch.serve_router

Clients POST /generate here as they would to one replica: SSE token
streams pass through byte for byte and one trace spans router -> replica.
``GET /debug/fleet`` shows the replica table (health, breaker, queue
depth, in-flight, affinity hit rate); the ``app_tpu_fleet_*`` series are
on METRICS_PORT. Raise REQUEST_TIMEOUT on the router: a non-streaming
/generate holds its handler until the replica has finished.

Planes, each on unless its key is false, as in the reference:
FLEET_JOURNEY (``GET /debug/journey[/{id}]``, the cross-hop waterfall,
FLEET_JOURNEY_CAPACITY records) and under it FLEET_TIMELINE (``GET
/debug/fleet/timeline/{id}``, the stitched multi-process Perfetto trace);
FLEET_SLO (``GET /debug/fleet/slo``, the router's own burn engine at
``/debug/slo`` and its ``IncidentManager`` at ``/debug/incidents``, which
captures ``fleet_burn_hidden``; INCIDENT_DIR, INCIDENT_COOLDOWN_S,
INCIDENT_MAX_PER_HOUR, the FLEET_SLO_* targets and windows); FLEET_CAPACITY
(``GET /debug/fleet/capacity``, ``replicas_needed`` at CAPACITY_TARGET_RHO);
FLEET_TRACE_CAPTURE (``GET /debug/trace``, the observed arrivals with
their class and tenant, FLEET_TRACE_CAPACITY of them); ELASTIC (``GET
/debug/fleet/elastic``, ``POST /debug/fleet/drain/{replica}`` and the
autoscaler over the ELASTIC_* keys; ELASTIC_LAUNCHER=subprocess needs
ELASTIC_LAUNCH_CMD, e.g. ``python -m gofr_tpu_torch.serve``). The burn
and capacity gauges are recomputed at every scrape, the ``fleet`` health
contributor reads DOWN with no replica routable and DEGRADED while one is
ejected, and the App's shutdown stops the autoscaler (with the replicas it
launched) and the probe loop.

Every key the reference router reads (its ``main.py``, ``gofr_tpu/fleet``'s
``from_config``s, its App's constructor, container and tracer, and the
device client its container may build) is served (PORTED), refused at boot
naming the ROADMAP item that waits (NOT_PORTED), or inert with its reason
(INERT); REMOTE_LOG_URL and REMOTE_LOG_FETCH_INTERVAL start the
container's level poller (logging/remote.py). The router holds no tensor,
imports no torch and resolves no device: its container builds no device
client (``App(..., device_client=False)``), so TPU_ENABLED
and its keys are inert here; the replicas it fronts keep the port's device
rule.
"""

from __future__ import annotations

from typing import Mapping, Union

from .app import App
from .config import Config
from .fleet import (FleetAutoscaler, FleetCapacity, FleetRouter, FleetSLO,
                    JourneyRecorder, install_elastic_routes, install_routes,
                    register_elastic_metrics,
                    register_fleet_capacity_metrics, register_fleet_metrics,
                    register_fleet_slo_metrics, register_journey_metrics)
from .fleet.capacity import install_routes as install_fleet_capacity_routes
from .fleet.journey import install_routes as install_journey_routes
from .fleet.slo import install_routes as install_fleet_slo_routes
from .fleet.timeline import install_routes as install_fleet_timeline_routes
from .fleet.timeline import register_fleet_timeline_metrics
from .loadgen import TraceCapture
from .loadgen.capture import install_routes as install_trace_routes
from .tpu.incidents import IncidentManager
from .tpu.incidents import install_routes as install_incident_routes
from .tpu.incidents import register_incident_metrics

EnvLike = Union[Config, Mapping[str, str], None]

# the keys build_app and the fleet modules read and serve
PORTED = (
    # the registry, the policy and the router (fleet/*.from_config)
    "FLEET_REPLICAS", "FLEET_TIMEOUT_S", "FLEET_BREAKER_THRESHOLD",
    "FLEET_BREAKER_INTERVAL_S", "FLEET_PROBE_S", "FLEET_POLICY",
    "FLEET_SPILL_DEPTH", "FLEET_RETRY_BUDGET", "FLEET_AFFINITY_BLOCK",
    "FLEET_AFFINITY_MAX_BLOCKS",
    # the planes and their tuning
    "FLEET_JOURNEY", "FLEET_JOURNEY_CAPACITY", "FLEET_TIMELINE",
    "FLEET_SLO", "FLEET_SLO_TTFB_TARGET_S", "FLEET_SLO_TPOT_TARGET_S",
    "FLEET_SLO_OBJECTIVE_AVAILABILITY", "FLEET_SLO_FAST_WINDOW_S",
    "FLEET_SLO_SLOW_WINDOW_S", "FLEET_SLO_PAGE_BURN", "FLEET_SLO_WARN_BURN",
    "FLEET_SLO_MIN_EVENTS", "FLEET_SLO_GOODPUT_WINDOW", "INCIDENT_DIR",
    "INCIDENT_COOLDOWN_S", "INCIDENT_MAX_PER_HOUR", "FLEET_CAPACITY",
    "CAPACITY_TARGET_RHO", "FLEET_TRACE_CAPTURE", "FLEET_TRACE_CAPACITY",
    # the elastic control plane
    "ELASTIC", "ELASTIC_LAUNCHER", "ELASTIC_LAUNCH_CMD", "ELASTIC_PORT_BASE",
    "ELASTIC_MIN_REPLICAS", "ELASTIC_MAX_REPLICAS", "ELASTIC_INTERVAL_S",
    "ELASTIC_UP_HOLD_S", "ELASTIC_DOWN_HOLD_S", "ELASTIC_COOLDOWN_S",
    "DRAIN_TIMEOUT_S",
    # the App's and its container's (app.py, container/, tracing/)
    "HTTP_PORT", "METRICS_PORT", "REQUEST_TIMEOUT", "MAX_CONCURRENT_REQUESTS",
    "LOG_LEVEL", "APP_NAME", "APP_VERSION", "TRACE_EXPORTER", "TRACER_URL",
    "GOFR_CONFIGS_DIR", "DB_DIALECT", "DB_PATH", "KV_STORE", "KV_ENABLED",
    "PUBSUB_BACKEND", "REMOTE_LOG_URL", "REMOTE_LOG_FETCH_INTERVAL",
)

# (key, predicate on the config that asks for the feature, what waits and
# where): checked at boot. Every key of the reference router is served or
# inert now.
NOT_PORTED = ()

# keys the reference reads that change nothing the router serves
INERT = (
    ("GRPC_PORT", "the router registers no gRPC service, here as in the "
     "reference, so nothing binds it"),
    ("TPU_ENABLED", "builds the reference container's device client; the "
     "router holds no tensor, and its container builds no device client"),
    ("MODEL_NAME", "builds the reference container's device client; the "
     "router holds no tensor, and its container builds no device client"),
    ("TPU_PLATFORM", "picks the platform of the reference's device client; "
     "the router's container builds none"),
    ("JAX_COORDINATOR_ADDR", "joins the reference container's device "
     "client to a multi-process job; the router has no device client and "
     "no model to shard, and the replicas behind it join their own jobs"),
)


def build_app(env: EnvLike = None) -> App:
    """The App with the fleet router on ``app.fleet``: POST /generate,
    GET /debug/fleet and the planes of the module docstring.
    env: a Config, a mapping, or None (.env files under GOFR_CONFIGS_DIR
    and the process environment). The router starts probing here; the
    App's shutdown stops it."""
    app = App(config=env, device_client=False)
    for key, asks, where in NOT_PORTED:
        if asks(app.config):
            raise ValueError(f"{key}={app.config.get(key)!r} is not "
                             f"supported by gofr_tpu_torch yet: {where}")
    metrics = app.container.metrics_manager
    register_fleet_metrics(metrics)
    router = FleetRouter.from_config(app.config, logger=app.logger,
                                     metrics=metrics)
    app.fleet = router
    # DOWN with no replica routable, DEGRADED while one is ejected
    app.add_health_contributor("fleet", router.health_check)
    install_routes(app, router)
    if app.config.get_bool("FLEET_JOURNEY", True):
        if metrics is not None:
            register_journey_metrics(metrics)
        router.journeys = JourneyRecorder(
            capacity=app.config.get_int("FLEET_JOURNEY_CAPACITY", 256),
            metrics=metrics)
        install_journey_routes(app, router)
        # the stitched timeline rides on the journey plane: the journey
        # names the hop replicas
        if app.config.get_bool("FLEET_TIMELINE", True):
            if metrics is not None:
                register_fleet_timeline_metrics(metrics)
            install_fleet_timeline_routes(app, router)
    app.fleet_incidents = None
    if app.config.get_bool("FLEET_SLO", True):
        if metrics is not None:
            register_fleet_slo_metrics(metrics)
            register_incident_metrics(metrics)
        incidents = IncidentManager(
            engine=None, recorder=None,
            dir=app.config.get_or_default("INCIDENT_DIR", "./incidents"),
            cooldown_s=app.config.get_float("INCIDENT_COOLDOWN_S", 300.0),
            max_per_hour=app.config.get_int("INCIDENT_MAX_PER_HOUR", 6),
            metrics=metrics, logger=app.logger)
        router.slo = FleetSLO.from_config(
            app.config, registry=router.registry, incidents=incidents,
            metrics=metrics, logger=app.logger)
        app.fleet_incidents = incidents
        if router.journeys is not None:
            router.journeys.use_slo(router.slo)
        install_fleet_slo_routes(app, router)
        # the router answers /debug/slo and /debug/incidents as a replica
        # does, from its own burn engine
        install_incident_routes(app, router.slo.burn, incidents)
        # burn decays while the router idles: re-evaluated at every scrape
        app.container.add_scrape_hook("fleet_slo_burn",
                                      router.slo.burn.publish)
    if app.config.get_bool("FLEET_CAPACITY", True):
        if metrics is not None:
            register_fleet_capacity_metrics(metrics)
        router.capacity = FleetCapacity.from_config(
            app.config, registry=router.registry, metrics=metrics,
            logger=app.logger)
        install_fleet_capacity_routes(app, router)
        app.container.add_scrape_hook("fleet_capacity",
                                      router.capacity.publish)
    if app.config.get_bool("FLEET_TRACE_CAPTURE", True):
        # the observed arrivals as a replayable trace (token counts and
        # CRC seeds, never text), with class and tenant
        router.capture = TraceCapture(
            capacity=app.config.get_int("FLEET_TRACE_CAPACITY", 4096),
            block=app.config.get_int("FLEET_AFFINITY_BLOCK", 256))
        install_trace_routes(app, router.capture)
    # the autoscaler: ELASTIC_LAUNCHER=none (the default) observes and
    # drains but never launches; harnesses set app.autoscaler.launcher
    app.autoscaler = None
    if app.config.get_bool("ELASTIC", True):
        if metrics is not None:
            register_elastic_metrics(metrics)
        autoscaler = FleetAutoscaler.from_config(
            app.config, router, capacity=router.capacity, metrics=metrics,
            logger=app.logger)
        app.autoscaler = autoscaler
        install_elastic_routes(app, autoscaler)
        autoscaler.start()
        app.on_shutdown(autoscaler.stop)
    router.start()
    app.on_shutdown(router.stop)
    return app


def main() -> None:
    build_app().run()


if __name__ == "__main__":
    main()

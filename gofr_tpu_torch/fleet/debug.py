"""Fleet observability: ``GET /debug/fleet`` and the ``app_tpu_fleet_*``
metric family.

Ports ``gofr_tpu/fleet/debug.py`` whole, with the reference's names, help
texts and labels.

Counters
  app_tpu_fleet_route_total{policy,reason}   every routing decision
  app_tpu_fleet_affinity_hits_total          affinity policy stuck to the map
  app_tpu_fleet_affinity_misses_total        cold / spilled / failed-over
  app_tpu_fleet_retries_total{reason}        unstarted re-attempts
                                             (shed | connect_error | breaker_open)
  app_tpu_fleet_stream_breaks_total{replica} committed streams that died upstream
  app_tpu_fleet_class_routes_total{class}    committed routes by QoS class
  app_tpu_fleet_class_sheds_total{class}     replica 503 sheds by QoS class

Gauges (published by the registry probe loop)
  app_tpu_fleet_replica_state{replica}       2=UP 1=DEGRADED/shedding 0=DOWN/open
  app_tpu_fleet_inflight{replica}            this router's in-flight per replica
  app_tpu_fleet_replicas_available           routable candidate count
"""

def register_fleet_metrics(metrics):
    """Idempotent registration (same idiom as register_disagg_metrics)."""
    counters = [
        ("app_tpu_fleet_route_total",
         "Routing decisions by policy and reason"),
        ("app_tpu_fleet_affinity_hits_total",
         "Requests routed to the replica already holding the prefix"),
        ("app_tpu_fleet_affinity_misses_total",
         "Affinity-policy requests routed cold (miss/spill/failover)"),
        ("app_tpu_fleet_retries_total",
         "Unstarted requests re-attempted on another replica, by reason"),
        ("app_tpu_fleet_stream_breaks_total",
         "Committed streams that died upstream (surfaced, never retried)"),
        ("app_tpu_fleet_class_routes_total",
         "Requests committed to a replica, by QoS class"),
        ("app_tpu_fleet_class_sheds_total",
         "Replica 503 sheds consumed by the retry loop, by QoS class"),
    ]
    gauges = [
        ("app_tpu_fleet_replica_state",
         "Per-replica routability: 2=UP 1=DEGRADED/shedding 0=DOWN/breaker-open"),
        ("app_tpu_fleet_inflight",
         "Requests this router currently has in flight per replica"),
        ("app_tpu_fleet_replicas_available",
         "Replicas currently routable (not DOWN/open/shedding)"),
    ]
    for name, desc in counters:
        try:
            if metrics.get(name) is None:
                metrics.new_counter(name, desc)
        except Exception:  # noqa: BLE001 - re-registration is benign
            pass
    for name, desc in gauges:
        try:
            if metrics.get(name) is None:
                metrics.new_gauge(name, desc)
        except Exception:  # noqa: BLE001
            pass


def install_routes(app, router, path="/debug/fleet"):
    """GET /debug/fleet — the replica table an operator
    reads first: health, breaker state, shedding, queue depth, in-flight,
    affinity hit rate, route/retry counters."""

    @app.get(path)
    def fleet_debug(ctx):  # noqa: ARG001 - gofr handler signature
        return router.snapshot()

    return app

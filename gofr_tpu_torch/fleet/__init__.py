"""The fleet tier: a prefix- and health-aware router over N replicas of the
port's server.

Ports ``gofr_tpu/fleet/`` whole, with the reference's ``__all__``:

  - ``registry``: the replica set, each backend behind the ``service``
    client's ``CircuitBreaker`` (a dead replica is ejected and probed back
    in), the probe loop over ``/.well-known/health`` and ``/stats`` (queue
    depth, duty cycle, lifecycle, the affinity and QoS digests), the shed
    window and the load accounting;
  - ``affinity`` and ``policy``: prefix affinity (stable hashes of the
    prompt's leading character blocks, learned from routed responses and
    re-warmed from the replicas' digests) with load spillover, and
    power-of-two-choices or round-robin;
  - ``proxy``: ``POST /generate`` passed through byte for byte, SSE
    included, with the ``traceparent`` carried on and only unstarted
    requests (connect failure, 503 shed) retried; ``debug``: ``GET
    /debug/fleet`` and the ``app_tpu_fleet_*`` series;
  - ``journey``, ``timeline``, ``slo`` and ``capacity``: the cross-hop
    waterfall, the stitched multi-process Perfetto trace, the fleet burn
    with its ``fleet_burn_hidden`` incident, and the fleet capacity rollup
    with ``replicas_needed``;
  - ``elastic``: the autoscaler (launch on sustained demand, drain with
    live-session migration on sustained calm) and the operator's drain.

``gofr_tpu_torch/serve_router.py`` is the runnable router
(``python -m gofr_tpu_torch.serve_router``). The router holds no tensor
and resolves no device; the replicas it fronts keep the port's device
rule.
"""

from .affinity import AffinityMap, AffinityRecorder, affinity_keys
from .capacity import FleetCapacity, register_fleet_capacity_metrics
from .debug import register_fleet_metrics
from .elastic import (FleetAutoscaler, InProcessLauncher, ReplicaLauncher,
                      SubprocessLauncher, launcher_from_config,
                      register_elastic_metrics)
from .elastic import install_routes as install_elastic_routes
from .journey import JourneyRecorder, register_journey_metrics
from .policy import (AffinityPolicy, P2CPolicy, RoundRobinPolicy,
                     RoutingPolicy, make_policy)
from .proxy import FleetRouter, install_routes
from .registry import FleetRegistry, Replica
from .slo import FleetBurnEngine, FleetSLO, register_fleet_slo_metrics

__all__ = [
    "AffinityMap", "AffinityRecorder", "affinity_keys",
    "AffinityPolicy", "P2CPolicy", "RoundRobinPolicy", "RoutingPolicy",
    "make_policy", "FleetRouter", "install_routes", "FleetRegistry",
    "Replica", "register_fleet_metrics",
    "JourneyRecorder", "register_journey_metrics",
    "FleetBurnEngine", "FleetSLO", "register_fleet_slo_metrics",
    "FleetCapacity", "register_fleet_capacity_metrics",
    "FleetAutoscaler", "ReplicaLauncher", "InProcessLauncher",
    "SubprocessLauncher", "launcher_from_config",
    "register_elastic_metrics", "install_elastic_routes",
]

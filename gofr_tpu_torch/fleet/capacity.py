"""Capacity observatory, fleet half: every replica's ``/debug/capacity``
merged into one rollup with a scaling recommendation.

Ports ``gofr_tpu/fleet/capacity.py`` whole: ``FleetCapacity``,
``register_fleet_capacity_metrics`` and ``install_routes``
(``GET /debug/fleet/capacity``).

A replica's ``TPUMeter`` and ``HeadroomForecaster`` (``tpu/meter.py``)
answer who consumes this card and how much load this replica takes before
it falls over; the fleet tier answers the fleet's questions.
``FleetCapacity.rollup()`` polls every registered replica's
``/debug/capacity`` over the registry's short-timeout probe clients
(breaker-bypassing: an ejected replica still reports its meter), degrades
per replica to an ``error`` row, and merges:

  * fleet λ (token arrival rate) = Σ replica λ; fleet μ (token service
    capacity) = Σ replica μ; fleet ρ = λ/μ; headroom = max(0, μ−λ);
  * per-tenant fleet-wide spend: device seconds, FLOPs, page seconds and
    queue seconds summed over the replicas per tenant;
  * the replicas whose forecaster warns of collapse;
  * ``replicas_needed`` = ceil(fleet λ / (target ρ × mean per-replica μ)),
    at least 1 (target ρ from CAPACITY_TARGET_RHO, default 0.75, so the
    fleet is sized to run below the queueing knee); with no μ evidence yet
    it is the count of replicas reporting. ``fleet/elastic.py``'s
    autoscaler actuates on it.

The headline numbers are also the ``app_tpu_fleet_capacity_rho``,
``app_tpu_fleet_capacity_headroom_tok_s`` and
``app_tpu_fleet_replicas_needed`` gauges, recomputed at every scrape.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

DEFAULT_TARGET_RHO = 0.75


class FleetCapacity:
    """Router-owned fleet capacity rollup (module docstring)."""

    def __init__(self, registry=None, target_rho: float = DEFAULT_TARGET_RHO,
                 metrics=None, logger=None, replica_capacity_fn=None) -> None:
        self.registry = registry
        self.target_rho = min(0.99, max(0.05, float(target_rho)))
        self.metrics = metrics
        self.logger = logger
        # test seam: injectable "what do the replicas say" probe, the
        # FleetSLO idiom — the default asks the registry probe clients
        self._replica_capacity_fn = replica_capacity_fn

    @classmethod
    def from_config(cls, config, registry=None, metrics=None, logger=None):
        """Build from the CAPACITY_* keys."""
        return cls(registry=registry,
                   target_rho=config.get_float("CAPACITY_TARGET_RHO",
                                               DEFAULT_TARGET_RHO),
                   metrics=metrics, logger=logger)

    def _replica_capacities(self) -> Dict[str, Any]:
        """{replica: /debug/capacity payload (or {"error": ...})}."""
        if self._replica_capacity_fn is not None:
            return self._replica_capacity_fn()
        out: Dict[str, Any] = {}
        if self.registry is None:
            return out
        for replica in self.registry.replicas:
            try:
                resp = replica.probe.get(None, "/debug/capacity")
                body = resp.json() or {}
                out[replica.name] = body.get("data") or body
            except Exception as exc:  # noqa: BLE001 - degrade per replica
                out[replica.name] = {"error": str(exc)}
        return out

    def rollup(self) -> Dict[str, Any]:
        """The GET /debug/fleet/capacity payload."""
        snapshots = self._replica_capacities()
        replicas: Dict[str, Any] = {}
        tenants: Dict[str, Dict[str, float]] = {}
        lam_tok = 0.0
        mu_values: List[float] = []
        predicted: List[float] = []
        collapse: List[str] = []
        reporting = 0
        for name, snap in snapshots.items():
            if "error" in snap:
                replicas[name] = {"error": snap["error"]}
                continue
            forecast = snap.get("forecast") or {}
            row = {k: forecast.get(k) for k in (
                "lambda_rps", "lambda_tok_s", "mu_tok_s", "rho",
                "headroom_tok_s", "predicted_ttft_ms", "queue_depth",
                "collapse_warning")}
            row["device_s"] = (snap.get("totals") or {}).get("device_s")
            replicas[name] = row
            reporting += 1
            lam_tok += forecast.get("lambda_tok_s") or 0.0
            mu = forecast.get("mu_tok_s")
            if isinstance(mu, (int, float)) and mu > 0:
                mu_values.append(float(mu))
            ttft = forecast.get("predicted_ttft_ms")
            if isinstance(ttft, (int, float)):
                predicted.append(float(ttft))
            if forecast.get("collapse_warning"):
                collapse.append(name)
            for trow in snap.get("tenants") or []:
                tname = trow.get("tenant") or "-"
                agg = tenants.setdefault(tname, {
                    "device_s": 0.0, "flops": 0.0, "page_s": 0.0,
                    "queue_s": 0.0, "requests": 0})
                for field in agg:
                    value = trow.get(field)
                    if isinstance(value, (int, float)):
                        agg[field] = round(agg[field] + value, 6)
        mu_fleet = sum(mu_values)
        mu_per_replica = (mu_fleet / len(mu_values)) if mu_values else None
        rho = (lam_tok / mu_fleet) if mu_fleet else 0.0
        headroom = max(0.0, mu_fleet - lam_tok) if mu_fleet else 0.0
        # the autoscaler hand-off: replicas sized so the fleet runs at
        # target_rho under the CURRENT offered load. With no μ evidence
        # yet (cold fleet) the honest recommendation is "what you have".
        if mu_per_replica:
            replicas_needed = max(1, math.ceil(
                lam_tok / (self.target_rho * mu_per_replica)))
        else:
            replicas_needed = max(1, reporting or len(snapshots))
        top = sorted(tenants.items(), key=lambda kv: kv[1]["device_s"],
                     reverse=True)
        out = {
            "fleet": {
                "lambda_tok_s": round(lam_tok, 3),
                "mu_tok_s": round(mu_fleet, 3) if mu_fleet else None,
                "mu_per_replica_tok_s": (round(mu_per_replica, 3)
                                         if mu_per_replica else None),
                "rho": round(rho, 4),
                "headroom_tok_s": round(headroom, 3),
                "predicted_ttft_ms_max": (round(max(predicted), 3)
                                          if predicted else None),
                "target_rho": self.target_rho,
                "replicas_needed": replicas_needed,
                "replicas_reporting": reporting,
                "replicas_total": len(snapshots),
                "collapse_warnings": collapse,
            },
            "tenants": [{"tenant": name, **row} for name, row in top],
            "replicas": replicas,
        }
        self._publish(rho, replicas_needed, headroom)
        return out

    def _publish(self, rho: float, replicas_needed: int,
                 headroom: float) -> None:
        if self.metrics is None:
            return
        try:
            self.metrics.set_gauge("app_tpu_fleet_capacity_rho",
                                   round(rho, 4))
            self.metrics.set_gauge("app_tpu_fleet_capacity_headroom_tok_s",
                                   round(headroom, 3))
            self.metrics.set_gauge("app_tpu_fleet_replicas_needed",
                                   replicas_needed)
        except Exception:  # noqa: BLE001 - publishing is best-effort
            pass

    def publish(self) -> None:
        """Scrape-hook re-eval (the fleet burn idiom): recompute the
        rollup at scrape time so the gauges track probe reality and
        decay with the replicas' own idle decay."""
        try:
            self.rollup()
        except Exception:  # noqa: BLE001 - a scrape must never fail
            pass


def register_fleet_capacity_metrics(metrics) -> None:
    """Idempotent registration (the register_fleet_metrics idiom)."""
    for name, desc in (
        ("app_tpu_fleet_capacity_rho",
         "Fleet utilization: total token arrival rate over total token "
         "service capacity across reporting replicas"),
        ("app_tpu_fleet_capacity_headroom_tok_s",
         "Fleet token throughput headroom before saturation"),
        ("app_tpu_fleet_replicas_needed",
         "Replicas needed to serve the current offered load at the "
         "target utilization (the autoscaler hand-off number)"),
    ):
        try:
            if metrics.get(name) is None:
                metrics.new_gauge(name, desc)
        except Exception:  # noqa: BLE001 - re-registration is benign
            pass


def install_routes(app, router, path: str = "/debug/fleet/capacity") -> None:
    """GET /debug/fleet/capacity — the fleet capacity rollup."""

    @app.get(path)
    def fleet_capacity(ctx):  # noqa: ARG001 - gofr handler signature
        return router.capacity.rollup()

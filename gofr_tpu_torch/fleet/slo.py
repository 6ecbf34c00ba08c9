"""Fleet SLO rollup: router-observed burn and the per-replica merge.

Ports ``gofr_tpu/fleet/slo.py`` whole: ``FleetBurnEngine``, ``FleetSLO``,
``register_fleet_slo_metrics`` and ``install_routes``
(``GET /debug/fleet/slo``).

A replica's ``SLOBurnEngine`` (``tpu/incidents.py``) misses the failures
the fleet tier absorbs or makes: a request retried onto a healthy replica
never errors anywhere, a shed consumed by the retry loop is invisible to
the replica that refused it, and a stream break is an upstream death the
replica may record as a plain cancel. Two halves close that gap:

  * ``FleetBurnEngine``: the same paired-window burn machine, fed by
    router-observed journey outcomes (``fleet/journey.py``): a terminal
    journey scores availability (bad on ``stream_break`` /
    ``upstream_error``), its TTFB the fleet "ttft" track and its stream
    cadence (chunks over stream seconds) "tpot"; retry exhaustion
    (``no_replica``) burns availability as a shed. Published as
    ``app_tpu_fleet_slo_burn_rate{slo,window}`` and
    ``app_tpu_fleet_slo_alert_state{slo}``.
  * ``FleetSLO.rollup()``: every replica's ``/debug/slo`` (over the probe
    clients) merged with the fleet burn view, with per-class fleet
    goodput windows.

When the fleet availability burn pages while no replica's own engine
pages, the failure lives in the routing tier (or retries launder it):
``FleetSLO`` triggers ``fleet_burn_hidden`` on the router's own
``IncidentManager``.
"""

from __future__ import annotations

import collections
import threading
from typing import Any, Dict, List, Optional

from ..tpu.incidents import SLOBurnEngine

DEFAULT_TTFB_TARGET_S = 0.5
DEFAULT_TPOT_TARGET_S = 0.1
DEFAULT_GOODPUT_WINDOW = 256


class FleetBurnEngine(SLOBurnEngine):
    """SLOBurnEngine publishing under the fleet metric names."""

    def _publish_track(self, track, fast, slow) -> None:
        if fast is not None:
            self._obs.gauge("app_tpu_fleet_slo_burn_rate", round(fast, 4),
                            slo=track.name, window="fast")
        if slow is not None:
            self._obs.gauge("app_tpu_fleet_slo_burn_rate", round(slow, 4),
                            slo=track.name, window="slow")
        self._obs.gauge("app_tpu_fleet_slo_alert_state", track.state,
                        slo=track.name)


class FleetSLO:
    """Router-owned fleet burn + per-class goodput + replica rollup."""

    # journey outcomes that spend availability budget as ERRORS (the
    # client got a bad answer) vs as SHEDS (the client got no answer)
    _ERROR_OUTCOMES = ("stream_break", "upstream_error")
    _SHED_OUTCOMES = ("no_replica",)

    def __init__(self, burn: FleetBurnEngine, registry=None,
                 incidents=None, metrics=None, logger=None,
                 goodput_window: int = DEFAULT_GOODPUT_WINDOW,
                 replica_states_fn=None) -> None:
        self.burn = burn
        self.registry = registry
        self.incidents = incidents
        self.metrics = metrics
        self.logger = logger
        self._lock = threading.Lock()
        # per-QoS-class rolling (ok?) windows -> fleet goodput per class
        self._class_windows: Dict[str, "collections.deque"] = {}
        self._goodput_window = max(1, int(goodput_window))
        # test seam: injectable "what do the replicas say" probe; the
        # default asks the registry over the probe clients
        self._replica_states_fn = replica_states_fn
        self.hidden_pages = 0
        burn.on_page = self._on_page

    @classmethod
    def from_config(cls, config, registry=None, incidents=None,
                    metrics=None, logger=None, clock=None):
        """Build from the FLEET_SLO_* keys."""
        kw: Dict[str, Any] = {}
        if clock is not None:
            kw["clock"] = clock
        burn = FleetBurnEngine(
            slo_ttft_s=config.get_float("FLEET_SLO_TTFB_TARGET_S",
                                        DEFAULT_TTFB_TARGET_S),
            slo_tpot_s=config.get_float("FLEET_SLO_TPOT_TARGET_S",
                                        DEFAULT_TPOT_TARGET_S),
            objectives={"availability": config.get_float(
                "FLEET_SLO_OBJECTIVE_AVAILABILITY", 0.999)},
            fast_window_s=config.get_float("FLEET_SLO_FAST_WINDOW_S", 300.0),
            slow_window_s=config.get_float("FLEET_SLO_SLOW_WINDOW_S", 3600.0),
            page_burn=config.get_float("FLEET_SLO_PAGE_BURN", 14.4),
            warn_burn=config.get_float("FLEET_SLO_WARN_BURN", 6.0),
            min_events=config.get_int("FLEET_SLO_MIN_EVENTS", 12),
            metrics=metrics, logger=logger, **kw)
        return cls(burn, registry=registry, incidents=incidents,
                   metrics=metrics, logger=logger,
                   goodput_window=config.get_int(
                       "FLEET_SLO_GOODPUT_WINDOW", DEFAULT_GOODPUT_WINDOW))

    # -- journey intake (fleet/journey.py finish hook) ------------------------
    def observe_journey(self, rec) -> None:
        """One terminal journey -> burn events + class goodput."""
        try:
            outcome = rec.outcome or "ok"
            if outcome in self._SHED_OUTCOMES:
                self.burn.observe_shed()
                ok = False
            else:
                error = outcome in self._ERROR_OUTCOMES
                ttfb = rec.ttfb_s()
                tpot = None
                stream_s = rec.stream_s()
                if stream_s is not None and rec.chunks > 1:
                    tpot = stream_s / (rec.chunks - 1)
                self.burn.observe_request(ttfb, tpot, error=error)
                ok = not error
            cls = rec.qos_class or "unclassified"
            with self._lock:
                window = self._class_windows.get(cls)
                if window is None:
                    window = collections.deque(maxlen=self._goodput_window)
                    self._class_windows[cls] = window
                window.append(1 if ok else 0)
                goodput = sum(window) / len(window)
            if self.metrics is not None:
                self.metrics.set_gauge("app_tpu_fleet_slo_goodput",
                                       round(goodput, 4), **{"class": cls})
        except Exception:  # noqa: BLE001 - accounting is best-effort
            pass

    # -- the hidden-burn incident ---------------------------------------------
    def _replica_slo_states(self) -> Dict[str, Any]:
        """{replica: {slo: state}} (or {"error": ...}) via /debug/slo."""
        if self._replica_states_fn is not None:
            return self._replica_states_fn()
        out: Dict[str, Any] = {}
        if self.registry is None:
            return out
        for replica in self.registry.replicas:
            try:
                resp = replica.probe.get(None, "/debug/slo")
                body = resp.json() or {}
                data = body.get("data") or body
                out[replica.name] = {
                    name: slo.get("state")
                    for name, slo in (data.get("slos") or {}).items()}
            except Exception as exc:  # noqa: BLE001 - unreachable replica
                out[replica.name] = {"error": str(exc)}
        return out

    def _on_page(self, slo: str, **info) -> None:
        """Fleet burn paged: if no replica pages too, the failure is
        fleet-tier-only — the incident per-replica pagers cannot raise."""
        try:
            states = self._replica_slo_states()
            replica_paging = [
                name for name, slos in states.items()
                if any(state == "page" for state in slos.values()
                       if isinstance(state, str))]
            if replica_paging:
                return  # a replica is already paging; not hidden
            self.hidden_pages += 1
            if self.logger is not None:
                self.logger.errorf(
                    "fleet SLO %s pages while every replica is quiet — "
                    "the burn lives in the routing tier", slo)
            if self.incidents is not None:
                self.incidents.trigger("fleet_burn_hidden", slo=slo,
                                       replica_states=states, **info)
        except Exception:  # noqa: BLE001 - alerting is best-effort
            pass

    # -- operator surface -----------------------------------------------------
    def class_goodput(self) -> Dict[str, Any]:
        with self._lock:
            return {cls: {"window": len(window),
                          "goodput": round(sum(window) / len(window), 4)}
                    for cls, window in self._class_windows.items() if window}

    def rollup(self) -> Dict[str, Any]:
        """The GET /debug/fleet/slo payload: fleet burn + class goodput
        + every replica's own /debug/slo snapshot, merged."""
        replicas: Dict[str, Any] = {}
        paging: List[str] = []
        if self.registry is not None:
            for replica in self.registry.replicas:
                try:
                    resp = replica.probe.get(None, "/debug/slo")
                    body = resp.json() or {}
                    data = body.get("data") or body
                    slos = data.get("slos") or {}
                    row = {
                        name: {"state": slo.get("state"),
                               "burn_fast": ((slo.get("windows") or {})
                                             .get("fast") or {})
                               .get("burn_rate"),
                               "burn_slow": ((slo.get("windows") or {})
                                             .get("slow") or {})
                               .get("burn_rate")}
                        for name, slo in slos.items()}
                    replicas[replica.name] = row
                    if any(col.get("state") == "page"
                           for col in row.values()):
                        paging.append(replica.name)
                except Exception as exc:  # noqa: BLE001 - degrade per replica
                    replicas[replica.name] = {"error": str(exc)}
        fleet = self.burn.snapshot()
        return {
            "fleet": fleet,
            "fleet_states": {name: slo.get("state")
                             for name, slo in fleet["slos"].items()},
            "classes": self.class_goodput(),
            "replicas": replicas,
            "replicas_paging": paging,
            "hidden_pages": self.hidden_pages,
        }


def register_fleet_slo_metrics(metrics) -> None:
    """Idempotent registration (the register_fleet_metrics idiom)."""
    for name, desc in (
        ("app_tpu_fleet_slo_burn_rate",
         "Fleet error-budget burn rate from router-observed outcomes, "
         "by slo and window (fast/slow)"),
        ("app_tpu_fleet_slo_alert_state",
         "Fleet SLO alert state: 0 ok, 1 warn, 2 page (both-windows "
         "burn rule over router-observed outcomes)"),
        ("app_tpu_fleet_slo_goodput",
         "Fleet goodput fraction over recent journeys, by QoS class"),
    ):
        try:
            if metrics.get(name) is None:
                metrics.new_gauge(name, desc)
        except Exception:  # noqa: BLE001 - re-registration is benign
            pass


def install_routes(app, router, path: str = "/debug/fleet/slo") -> None:
    """GET /debug/fleet/slo — the fleet burn/goodput rollup."""

    @app.get(path)
    def fleet_slo(ctx):  # noqa: ANN001, ARG001
        return router.slo.rollup()

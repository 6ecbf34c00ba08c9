"""Replica registry: per-backend clients, health, load and probing.

Ports ``gofr_tpu/fleet/registry.py`` whole: ``Replica`` and
``FleetRegistry``, on the port's ``service`` client (stdlib ``http.client``).

Each replica carries two outbound clients:

  - ``client``: the serving path, wrapped in a ``CircuitBreaker`` so
    repeated transport failures eject the replica (``CircuitOpenError``
    routes around it) and the breaker's own prober closes the circuit when
    the replica answers health again;
  - ``probe``: a short-timeout plain ``HTTPService`` the probe loop uses.
    It bypasses the breaker: a recovered replica must be reachable through
    a client that does not refuse to talk to it.

The probe loop reads each replica's own surfaces every FLEET_PROBE_S:
``/.well-known/health`` (the aggregate; an engine contributor DOWN, as a
breaker-held engine reports, counts as DOWN for routing) for state, and
``/stats`` for queue depth, duty cycle, the lifecycle, the QoS digest's
``scaleout_wanted`` and the affinity digest (merged into the router's
``AffinityMap``; a changed ``generation`` means the replica restarted, so
its learned entries are dropped before the cold digest is merged).

Shedding is apart from breaking: a 503 + Retry-After from a live replica
sets ``shed_until`` (honoured by ``available``) without touching the
breaker's failure count; a shedding replica is overloaded, not dead.
``stop`` ends the probe loop and every breaker's prober.
"""

import threading
import time

from ..datasource import STATUS_DEGRADED, STATUS_DOWN, STATUS_UP
from ..service import CircuitBreaker, HTTPService
from .affinity import AffinityMap

DEFAULT_PROBE_S = 2.0
DEFAULT_TIMEOUT_S = 30.0
DEFAULT_BREAKER_THRESHOLD = 3
DEFAULT_BREAKER_INTERVAL_S = 2.0

_STATE_GAUGE = {STATUS_UP: 2, STATUS_DEGRADED: 1, STATUS_DOWN: 0}


class Replica:
    """One backend: breaker-wrapped client + last-probed load/health."""

    def __init__(self, name, address, logger=None, metrics=None,
                 timeout_s=DEFAULT_TIMEOUT_S,
                 breaker_threshold=DEFAULT_BREAKER_THRESHOLD,
                 breaker_interval_s=DEFAULT_BREAKER_INTERVAL_S):
        self.name = name
        self.address = address.rstrip("/")
        svc = HTTPService(self.address, logger, metrics, timeout_s=timeout_s)
        svc.health_endpoint = ".well-known/health"
        self.client = CircuitBreaker(svc, breaker_threshold, breaker_interval_s)
        self.probe = HTTPService(self.address, logger, None,
                                 timeout_s=min(5.0, timeout_s))
        # last probe observations
        self.state = "UNKNOWN"
        self.state_detail = ""
        self.queue_depth = 0
        self.active_slots = 0
        self.duty_cycle = 0.0
        self.generation = None
        self.last_probe_at = 0.0
        self.probe_error = None
        # router-side serving state
        self.shed_until = 0.0  # monotonic deadline from 503 Retry-After
        self.stream_breaks = 0
        self._inflight = 0
        self._lock = threading.Lock()
        # elastic lifecycle (fleet/elastic.py): what the replica itself
        # advertises via /stats fleet.lifecycle, plus a router-side
        # override pinned while THIS router launches (warming) or drains
        # (draining) it.  The override outranks the advertisement — a
        # freshly launched replica must not take traffic on the strength
        # of a probe that raced its boot, and a drain the router ordered
        # holds even if the replica's advertisement lags a probe cycle.
        self.lifecycle = "serving"
        self.lifecycle_override = None
        self.scaleout_wanted = False

    # -- in-flight accounting -------------------------------------------------
    def begin(self):
        with self._lock:
            self._inflight += 1

    def end(self):
        with self._lock:
            self._inflight = max(0, self._inflight - 1)

    @property
    def inflight(self):
        with self._lock:
            return self._inflight

    def load(self):
        """Routing load: last-probed queue depth plus what THIS router
        has in flight (covers requests newer than the last probe)."""
        return max(0, self.queue_depth) + self.inflight

    # -- availability ---------------------------------------------------------
    def note_shed(self, retry_after_s):
        self.shed_until = max(self.shed_until,
                              time.monotonic() + max(0.1, retry_after_s))

    def shedding(self, now=None):
        return (now if now is not None else time.monotonic()) < self.shed_until

    @property
    def breaker_open(self):
        return self.client.open

    @property
    def effective_lifecycle(self):
        return self.lifecycle_override or self.lifecycle

    def available(self, now=None):
        return (self.state != STATUS_DOWN and not self.breaker_open
                and not self.shedding(now)
                and self.effective_lifecycle == "serving")

    def snapshot(self):
        return {
            "name": self.name,
            "address": self.address,
            "state": self.state,
            "state_detail": self.state_detail,
            "available": self.available(),
            "breaker_open": self.breaker_open,
            "breaker_failures": self.client.failure_count,
            "shedding": self.shedding(),
            "queue_depth": self.queue_depth,
            "active_slots": self.active_slots,
            "duty_cycle": self.duty_cycle,
            "inflight": self.inflight,
            "load": self.load(),
            "stream_breaks": self.stream_breaks,
            "lifecycle": self.effective_lifecycle,
            "scaleout_wanted": self.scaleout_wanted,
            "generation": self.generation,
            "probe_age_s": (round(time.monotonic() - self.last_probe_at, 3)
                            if self.last_probe_at else None),
            "probe_error": self.probe_error,
        }


class FleetRegistry:
    """Holds the replica set, runs the probe loop, publishes gauges."""

    def __init__(self, replicas, affinity_map=None, probe_s=DEFAULT_PROBE_S,
                 metrics=None, logger=None):
        self.replicas = list(replicas)
        self.affinity_map = affinity_map if affinity_map is not None else AffinityMap()
        self.probe_s = probe_s
        self.metrics = metrics
        self.logger = logger
        self._stop = threading.Event()
        self._thread = None
        # construction defaults for replicas added at runtime
        # (FleetAutoscaler scale-up); from_config overrides with its
        # FLEET_* values so launched replicas match the seeded ones
        self.replica_timeout_s = DEFAULT_TIMEOUT_S
        self.breaker_threshold = DEFAULT_BREAKER_THRESHOLD
        self.breaker_interval_s = DEFAULT_BREAKER_INTERVAL_S
        self._members_lock = threading.Lock()

    @classmethod
    def from_config(cls, config, logger=None, metrics=None, affinity_map=None):
        """Parse FLEET_REPLICAS: comma-separated `name=url` pairs, or bare
        URLs auto-named r0, r1, ..."""
        raw = config.get_or_default("FLEET_REPLICAS", "")
        entries = [e.strip() for e in raw.split(",") if e.strip()]
        if not entries:
            raise ValueError(
                "FLEET_REPLICAS is required (comma-separated name=url or url)")
        timeout_s = config.get_float("FLEET_TIMEOUT_S", DEFAULT_TIMEOUT_S)
        threshold = config.get_int("FLEET_BREAKER_THRESHOLD",
                                   DEFAULT_BREAKER_THRESHOLD)
        interval_s = config.get_float("FLEET_BREAKER_INTERVAL_S",
                                      DEFAULT_BREAKER_INTERVAL_S)
        replicas = []
        for i, entry in enumerate(entries):
            if "=" in entry and not entry.split("=", 1)[0].startswith("http"):
                name, address = entry.split("=", 1)
            else:
                name, address = f"r{i}", entry
            replicas.append(Replica(name.strip(), address.strip(),
                                    logger=logger, metrics=metrics,
                                    timeout_s=timeout_s,
                                    breaker_threshold=threshold,
                                    breaker_interval_s=interval_s))
        probe_s = config.get_float("FLEET_PROBE_S", DEFAULT_PROBE_S)
        registry = cls(replicas, affinity_map=affinity_map, probe_s=probe_s,
                       metrics=metrics, logger=logger)
        registry.replica_timeout_s = timeout_s
        registry.breaker_threshold = threshold
        registry.breaker_interval_s = interval_s
        return registry

    def replica(self, name):
        for r in self.replicas:
            if r.name == name:
                return r
        return None

    def candidates(self, exclude=()):
        now = time.monotonic()
        return [r for r in self.replicas
                if r.available(now) and r.name not in exclude]

    # -- elastic membership ---------------------------------------------------
    def add_replica(self, name, address, lifecycle_override="warming"):
        """Register a freshly launched replica (autoscaler scale-up).
        It joins under a ``warming`` override — a brand-new Replica's
        UNKNOWN state would otherwise pass ``available()`` before the
        first probe, routing traffic at a cold, still-compiling engine.
        The override clears when the replica's own advertisement says
        serving.  Idempotent on name."""
        existing = self.replica(name)
        if existing is not None:
            return existing
        replica = Replica(name, address, logger=self.logger,
                          metrics=self.metrics,
                          timeout_s=self.replica_timeout_s,
                          breaker_threshold=self.breaker_threshold,
                          breaker_interval_s=self.breaker_interval_s)
        replica.lifecycle_override = lifecycle_override
        with self._members_lock:
            self.replicas = self.replicas + [replica]
        if self.logger is not None:
            self.logger.infof("fleet: replica %s joined (%s) at %s",
                              name, lifecycle_override or "serving", address)
        return replica

    def remove_replica(self, name):
        """Forget a replica entirely (post-drain scale-down)."""
        with self._members_lock:
            kept = [r for r in self.replicas if r.name != name]
            gone = [r for r in self.replicas if r.name == name]
            self.replicas = kept
        for replica in gone:
            replica.client.close()
        removed = bool(gone)
        if removed:
            self.affinity_map.forget(name)
            if self.logger is not None:
                self.logger.infof("fleet: replica %s removed", name)
        return removed

    def announce_drain(self, name):
        """Mark a replica draining ON THE ANNOUNCEMENT: new sessions stop
        routing to it and its learned affinity entries drop NOW — waiting
        for the eventual DOWN would keep steering sticky sessions into a
        replica that refuses them.  Returns dropped affinity count, or
        None for an unknown replica."""
        replica = self.replica(name)
        if replica is None:
            return None
        replica.lifecycle_override = "draining"
        return self.affinity_map.forget(name)

    # -- probing --------------------------------------------------------------
    def start(self):
        if self._thread is not None:
            return
        self.probe_once()
        self._thread = threading.Thread(target=self._probe_loop,
                                        name="fleet-probe", daemon=True)
        self._thread.start()

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.probe_s + 2.0)
            self._thread = None
        for replica in list(self.replicas):
            replica.client.close()

    def _probe_loop(self):
        while not self._stop.wait(self.probe_s):
            try:
                self.probe_once()
            except Exception as exc:  # noqa: BLE001 - probe loop must survive
                if self.logger is not None:
                    self.logger.errorf("fleet probe loop: %s", exc)

    def probe_once(self):
        for replica in list(self.replicas):  # membership can change mid-walk
            self._probe(replica)
        self._publish_gauges()

    def _probe(self, replica):
        prev_state = replica.state
        try:
            resp = replica.probe.get(None, "/.well-known/health")
            payload = resp.json() or {}
            data = payload.get("data") or payload
            status = str(data.get("status") or STATUS_DOWN).upper()
            detail = ""
            # the aggregate de-flaps to DEGRADED even when a contributor
            # is hard DOWN (a breaker-held engine) — dig into the
            # details: an engine-DOWN replica sheds every request, so for
            # ROUTING purposes it is down.  Only engine contributors
            # count; a DOWN spill tier (kv) degrades, it doesn't unserve.
            if status != STATUS_DOWN:
                for name, contrib in (data.get("details") or {}).items():
                    if ("engine" in name and isinstance(contrib, dict)
                            and str(contrib.get("status", "")).upper()
                            == STATUS_DOWN):
                        status = STATUS_DOWN
                        detail = f"{name} DOWN"
                        break
            replica.state = status if status in _STATE_GAUGE else STATUS_DOWN
            replica.state_detail = detail
            replica.probe_error = None
        except Exception as exc:  # noqa: BLE001 - unreachable replica is DOWN
            replica.state = STATUS_DOWN
            replica.state_detail = "unreachable"
            replica.probe_error = str(exc)
            replica.last_probe_at = time.monotonic()
            return
        try:
            stats = (replica.probe.get(None, "/stats").json() or {})
            stats = stats.get("data") or stats
            replica.queue_depth = int(stats.get("queue_depth", 0) or 0)
            replica.active_slots = int(stats.get("active_slots", 0) or 0)
            fleet = stats.get("fleet") or {}
            replica.duty_cycle = float(fleet.get("duty_cycle", 0.0) or 0.0)
            was_draining = replica.effective_lifecycle == "draining"
            advertised = str(fleet.get("lifecycle") or "serving")
            if advertised in ("warming", "serving", "draining"):
                replica.lifecycle = advertised
            if (advertised == "serving"
                    and replica.lifecycle_override == "warming"):
                # boot confirmed by the replica itself; release traffic
                replica.lifecycle_override = None
            qos = fleet.get("qos") or {}
            replica.scaleout_wanted = bool(qos.get("scaleout_wanted"))
            if replica.effective_lifecycle == "draining" and not was_draining:
                # replica announced its own drain (operator hit it
                # directly): drop learned affinity on the announcement
                dropped = self.affinity_map.forget(replica.name)
                if self.logger is not None and dropped:
                    self.logger.infof(
                        "fleet: replica %s draining; dropped %d affinity entries",
                        replica.name, dropped)
            digest = fleet.get("affinity") or {}
            generation = digest.get("generation")
            if generation is not None:
                if replica.generation is not None and generation != replica.generation:
                    # replica restarted: its KV is cold, learned entries lie
                    dropped = self.affinity_map.forget(replica.name)
                    if self.logger is not None and dropped:
                        self.logger.infof(
                            "fleet: replica %s restarted; dropped %d affinity entries",
                            replica.name, dropped)
                    # a restart is a fresh boot: stale router-side drain or
                    # warming pins no longer describe this process
                    replica.lifecycle_override = None
                    replica.lifecycle = advertised if advertised in (
                        "warming", "serving", "draining") else "serving"
                replica.generation = generation
            keys = digest.get("keys") or []
            if keys:
                self.affinity_map.merge_digest(replica.name, keys)
        except Exception:  # noqa: BLE001 - /stats is best-effort enrichment
            pass
        replica.last_probe_at = time.monotonic()
        if (prev_state != replica.state and self.logger is not None
                and prev_state != "UNKNOWN"):
            self.logger.infof("fleet: replica %s %s -> %s", replica.name,
                              prev_state, replica.state)

    def _publish_gauges(self):
        if self.metrics is None:
            return
        now = time.monotonic()
        available = 0
        for r in list(self.replicas):
            value = _STATE_GAUGE.get(r.state, 0)
            if r.breaker_open:
                value = 0
            elif r.shedding(now) and value > 1:
                value = 1
            self.metrics.set_gauge("app_tpu_fleet_replica_state", value,
                                   replica=r.name)
            self.metrics.set_gauge("app_tpu_fleet_inflight", r.inflight,
                                   replica=r.name)
            if r.available(now):
                available += 1
        self.metrics.set_gauge("app_tpu_fleet_replicas_available", available)

    def snapshot(self):
        return {
            "probe_s": self.probe_s,
            "replicas": [r.snapshot() for r in self.replicas],
            "available": len(self.candidates()),
        }

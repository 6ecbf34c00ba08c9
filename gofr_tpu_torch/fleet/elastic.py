"""Elastic control plane: the autoscaler reconciler and the drain.

Ports ``gofr_tpu/fleet/elastic.py`` whole: ``ReplicaLauncher``,
``InProcessLauncher``, ``SubprocessLauncher``, ``launcher_from_config``,
``FleetAutoscaler``, ``register_elastic_metrics`` and ``install_routes``
(``GET /debug/fleet/elastic``, ``POST /debug/fleet/drain/{replica}``).

``FleetCapacity.rollup()`` publishes ``replicas_needed`` and the
replicas' ``collapse_warnings``, and the QoS ladder's ``request_replica``
rung advertises ``scaleout_wanted`` through ``/stats``. The
``FleetAutoscaler`` turns them into actuation:

    desired = clamp(max(replicas_needed,
                        current+1 if anybody screams), min, max)

with dwell gating in both directions (a spike holds ``up_hold_s`` before a
launch, calm holds ``down_hold_s`` before a drain) and a cooldown after
each actuation, so a flapping λ never oscillates the fleet.

Actuation goes through a ``ReplicaLauncher``: ``InProcessLauncher`` boots
replicas inside the router's process (a factory callable; tests and
harnesses), ``SubprocessLauncher`` spawns server processes
(ELASTIC_LAUNCHER=subprocess runs ELASTIC_LAUNCH_CMD, which it requires;
on the port ``python -m gofr_tpu_torch.serve``, with ``python`` replaced by
this interpreter, HTTP_PORT from ELASTIC_PORT_BASE upward and the
launcher's ``env`` over the parent's environment). A launched replica
joins the registry under the ``warming`` override: the router never
routes to a cold engine, and the override clears when the replica's own
``/stats`` says ``serving``.

Scale-down drains with migration, never kills: the victim is marked
``draining`` (new sessions stop, its learned affinity drops on the
announcement), ordered to ``POST /debug/drain`` its live sessions to the
surviving peers, polled until drained, then terminated and removed. The
operator's ``POST /debug/fleet/drain/{replica}`` runs the same machinery.
``stop`` ends the reconciler and terminates every replica this
autoscaler launched and still holds.
"""

from __future__ import annotations

import os
import subprocess
import sys
import threading
import time

DEFAULT_MIN_REPLICAS = 1
DEFAULT_MAX_REPLICAS = 4
DEFAULT_INTERVAL_S = 5.0
DEFAULT_UP_HOLD_S = 10.0
DEFAULT_DOWN_HOLD_S = 60.0
DEFAULT_COOLDOWN_S = 30.0
DEFAULT_DRAIN_TIMEOUT_S = 30.0
_DECISION_RING = 64


class ReplicaLauncher:
    """Actuation seam: how the autoscaler turns "add a replica" into a
    process.  launch() returns the new replica's base URL; terminate()
    reclaims whatever launch() created (no-op for unknown names)."""

    def launch(self, name):  # pragma: no cover - interface
        raise NotImplementedError

    def terminate(self, name):  # pragma: no cover - interface
        raise NotImplementedError


class InProcessLauncher(ReplicaLauncher):
    """Boots replicas inside this process via a factory callable —
    ``factory(name) -> address`` or ``(address, stop_fn)``.  Harnesses
    and tests inject ``serve.build_app`` closures here."""

    def __init__(self, factory):
        self._factory = factory
        self._stops = {}
        self._lock = threading.Lock()

    def launch(self, name):
        out = self._factory(name)
        address, stop = (out if isinstance(out, tuple) else (out, None))
        with self._lock:
            self._stops[name] = stop
        return address

    def terminate(self, name):
        with self._lock:
            stop = self._stops.pop(name, None)
        if stop is not None:
            try:
                stop()
            except Exception:  # noqa: BLE001 - teardown is best-effort
                pass


class SubprocessLauncher(ReplicaLauncher):
    """Spawns real replica processes: ``argv`` (default: this
    interpreter + ELASTIC_LAUNCH_CMD) with HTTP_PORT assigned from
    ``port_base`` upward and ``env`` overlaid on the parent's. The port's
    ``log_dir`` (default None: the output is dropped, as the reference's)
    keeps each child's output in ``<log_dir>/<name>.log``."""

    def __init__(self, argv, env=None, host="127.0.0.1", port_base=9800,
                 log_dir=None):
        self.argv = list(argv)
        self.env = dict(env or {})
        self.host = host
        self.log_dir = log_dir
        self._next_port = int(port_base)
        self._procs = {}
        self._lock = threading.Lock()

    def launch(self, name):
        with self._lock:
            port = self._next_port
            self._next_port += 1
        env = {**os.environ, **self.env,
               "HTTP_PORT": str(port), "METRICS_PORT": "0"}
        out = subprocess.DEVNULL
        if self.log_dir is not None:
            os.makedirs(self.log_dir, exist_ok=True)
            out = open(os.path.join(self.log_dir, f"{name}.log"), "ab")
        try:
            proc = subprocess.Popen(self.argv, env=env,  # noqa: S603
                                    stdout=out, stderr=subprocess.STDOUT)
        finally:
            if out is not subprocess.DEVNULL:
                out.close()   # the child holds its own descriptor
        with self._lock:
            self._procs[name] = proc
        return f"http://{self.host}:{port}"

    def terminate(self, name):
        with self._lock:
            proc = self._procs.pop(name, None)
        if proc is None:
            return
        try:
            proc.terminate()
            proc.wait(timeout=10.0)
        except Exception:  # noqa: BLE001 - escalate a stuck process
            try:
                proc.kill()
            except Exception:  # noqa: BLE001
                pass


def launcher_from_config(config, logger=None):
    """ELASTIC_LAUNCHER: ``none`` (observe-only reconciler, the default),
    or ``subprocess`` (ELASTIC_LAUNCH_CMD argv, split on spaces).  The
    in-process launcher is constructor-injection only — it needs a
    factory no config string can express."""
    kind = (config.get_or_default("ELASTIC_LAUNCHER", "none") or "none").lower()
    if kind in ("", "none"):
        return None
    if kind == "subprocess":
        cmd = config.get_or_default("ELASTIC_LAUNCH_CMD", "")
        if not cmd.strip():
            raise ValueError("ELASTIC_LAUNCHER=subprocess needs "
                             "ELASTIC_LAUNCH_CMD")
        argv = cmd.split()
        if argv[0] == "python":
            argv[0] = sys.executable
        return SubprocessLauncher(
            argv, port_base=config.get_int("ELASTIC_PORT_BASE", 9800))
    raise ValueError(f"unknown ELASTIC_LAUNCHER {kind!r}")


class FleetAutoscaler:
    """Cron-style reconciler: every ``interval_s`` compare what the
    capacity plane says the fleet needs against what the registry holds,
    and actuate through the launcher (module docstring has the law)."""

    def __init__(self, router, launcher=None, *, capacity=None,
                 min_replicas=DEFAULT_MIN_REPLICAS,
                 max_replicas=DEFAULT_MAX_REPLICAS,
                 interval_s=DEFAULT_INTERVAL_S,
                 up_hold_s=DEFAULT_UP_HOLD_S,
                 down_hold_s=DEFAULT_DOWN_HOLD_S,
                 cooldown_s=DEFAULT_COOLDOWN_S,
                 drain_timeout_s=DEFAULT_DRAIN_TIMEOUT_S,
                 metrics=None, logger=None, clock=time.monotonic,
                 capacity_fn=None):
        self.router = router
        self.registry = router.registry
        self.launcher = launcher
        self.capacity = capacity
        self.min_replicas = max(1, int(min_replicas))
        self.max_replicas = max(self.min_replicas, int(max_replicas))
        self.interval_s = max(0.05, float(interval_s))
        self.up_hold_s = max(0.0, float(up_hold_s))
        self.down_hold_s = max(0.0, float(down_hold_s))
        self.cooldown_s = max(0.0, float(cooldown_s))
        self.drain_timeout_s = max(1.0, float(drain_timeout_s))
        self.metrics = metrics
        self.logger = logger
        self._clock = clock
        # test seam: () -> capacity "fleet" dict, bypassing the rollup
        self._capacity_fn = capacity_fn
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = None
        self._launch_seq = 0
        self._launched = set()  # names this autoscaler created
        self._pending_dir = None  # "up" | "down" while a desire dwells
        self._pending_since = 0.0
        self._cooldown_until = 0.0
        self._draining = set()
        self.decisions = []  # ring of the last _DECISION_RING evaluations
        self.scale_events = {"up": 0, "down": 0}
        self.evaluations = 0

    @classmethod
    def from_config(cls, config, router, capacity=None, metrics=None,
                    logger=None, launcher=None):
        """Build from the ELASTIC_* and DRAIN_* keys."""
        if launcher is None:
            launcher = launcher_from_config(config, logger=logger)
        return cls(
            router, launcher, capacity=capacity,
            min_replicas=config.get_int("ELASTIC_MIN_REPLICAS",
                                        DEFAULT_MIN_REPLICAS),
            max_replicas=config.get_int("ELASTIC_MAX_REPLICAS",
                                        DEFAULT_MAX_REPLICAS),
            interval_s=config.get_float("ELASTIC_INTERVAL_S",
                                        DEFAULT_INTERVAL_S),
            up_hold_s=config.get_float("ELASTIC_UP_HOLD_S",
                                       DEFAULT_UP_HOLD_S),
            down_hold_s=config.get_float("ELASTIC_DOWN_HOLD_S",
                                         DEFAULT_DOWN_HOLD_S),
            cooldown_s=config.get_float("ELASTIC_COOLDOWN_S",
                                        DEFAULT_COOLDOWN_S),
            drain_timeout_s=config.get_float("DRAIN_TIMEOUT_S",
                                             DEFAULT_DRAIN_TIMEOUT_S),
            metrics=metrics, logger=logger)

    # -- reconcile loop -------------------------------------------------------
    def start(self):
        if self._thread is not None:
            return
        self._thread = threading.Thread(target=self._loop,
                                        name="fleet-autoscaler", daemon=True)
        self._thread.start()

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.interval_s + 2.0)
            self._thread = None
        # the replicas this autoscaler launched end with it (a subprocess
        # child would otherwise outlive the router)
        with self._lock:
            launched = sorted(self._launched)
            self._launched.clear()
        if self.launcher is not None:
            for name in launched:
                self.launcher.terminate(name)

    def _loop(self):
        while not self._stop.wait(self.interval_s):
            try:
                self.evaluate()
            except Exception as exc:  # noqa: BLE001 - reconciler survives
                if self.logger is not None:
                    self.logger.errorf("autoscaler evaluate: %s", exc)

    def _capacity_fleet(self):
        if self._capacity_fn is not None:
            return self._capacity_fn() or {}
        if self.capacity is None:
            return {}
        try:
            return (self.capacity.rollup() or {}).get("fleet") or {}
        except Exception:  # noqa: BLE001 - capacity plane down != crash
            return {}

    def evaluate(self):
        """One reconcile step; returns the decision record it appended.
        Safe to call directly (tests drive it with a fake clock)."""
        now = self._clock()
        fleet = self._capacity_fleet()
        current = len(self.registry.replicas)
        needed = int(fleet.get("replicas_needed") or current or 1)
        collapse = list(fleet.get("collapse_warnings") or [])
        screaming = [r.name for r in list(self.registry.replicas)
                     if r.scaleout_wanted]
        desired = needed
        if collapse or screaming:
            # the shed ladder's request_replica rung (or a collapse
            # forecast) outranks the steady-state sizing: somebody is
            # about to shed standard traffic, add capacity FIRST
            desired = max(desired, current + 1)
        desired = max(self.min_replicas, min(self.max_replicas, desired))
        action = "none"
        reason = ""
        direction = ("up" if desired > current
                     else "down" if desired < current else None)
        with self._lock:
            self.evaluations += 1
            if direction is None:
                self._pending_dir = None
            elif direction != self._pending_dir:
                # desire changed direction: restart the dwell clock — this
                # is the hysteresis that keeps a flapping λ from
                # oscillating the fleet
                self._pending_dir = direction
                self._pending_since = now
                reason = "dwell"
            hold = (self.up_hold_s if direction == "up"
                    else self.down_hold_s)
            ready = (direction is not None
                     and now - self._pending_since >= hold
                     and now >= self._cooldown_until)
            if direction is not None and not ready:
                reason = reason or ("cooldown" if now < self._cooldown_until
                                    else "dwell")
        if ready:
            if direction == "up":
                action, reason = self._scale_up()
            else:
                action, reason = self._scale_down()
            if action != "none":
                with self._lock:
                    self._pending_dir = None
                    self._cooldown_until = now + self.cooldown_s
                    self.scale_events[direction] += 1
                if self.metrics is not None:
                    self.metrics.increment_counter(
                        "app_tpu_elastic_scale_events_total",
                        direction=direction)
        record = {
            "t": round(now, 3), "current": current, "needed": needed,
            "desired": desired, "collapse": collapse,
            "scaleout_wanted": screaming, "action": action,
            "reason": reason,
        }
        with self._lock:
            self.decisions.append(record)
            del self.decisions[:-_DECISION_RING]
        if self.metrics is not None:
            self.metrics.set_gauge("app_tpu_elastic_replicas_target",
                                   desired)
        if action != "none" and self.logger is not None:
            self.logger.infof("autoscaler: %s (current=%d desired=%d %s)",
                              action, current, desired, reason)
        return record

    def _scale_up(self):
        if self.launcher is None:
            return "none", "no_launcher"
        with self._lock:
            name = f"auto{self._launch_seq}"
            self._launch_seq += 1
        try:
            address = self.launcher.launch(name)
        except Exception as exc:  # noqa: BLE001 - failed launch, try later
            if self.logger is not None:
                self.logger.errorf("autoscaler: launch %s failed: %s",
                                   name, exc)
            return "none", f"launch_failed: {exc}"
        with self._lock:
            self._launched.add(name)
        # joins warming: the probe flips it serving once the replica's
        # warm boot finishes (tpu/migrate.py Lifecycle advertisement)
        self.registry.add_replica(name, address)
        return f"launched {name}", "scale_up"

    def _scale_down(self):
        victim = self._pick_victim()
        if victim is None:
            return "none", "no_victim"
        threading.Thread(target=self.drain, args=(victim.name,),
                         kwargs={"remove": True},
                         name=f"fleet-drain-{victim.name}",
                         daemon=True).start()
        return f"draining {victim.name}", "scale_down"

    def _pick_victim(self):
        """Least-loaded serving replica, autoscaler-launched first (drain
        in LIFO launch order so the configured floor survives)."""
        with self._lock:
            launched = set(self._launched)
            draining = set(self._draining)
        pool = [r for r in self.registry.candidates()
                if r.name not in draining]
        if len(pool) <= self.min_replicas:
            return None
        ours = [r for r in pool if r.name in launched]
        pick_from = ours or pool
        return min(pick_from, key=lambda r: (r.load(), r.name))

    # -- drain orchestration (scale-down AND operator path) -------------------
    def drain(self, name, migrate=True, remove=None):
        """Drain one replica with session migration; returns an outcome
        dict.  remove=None removes only replicas this autoscaler
        launched; operators pass remove=True/False explicitly."""
        replica = self.registry.replica(name)
        if replica is None:
            return {"error": f"unknown replica {name!r}"}
        with self._lock:
            if name in self._draining:
                return {"replica": name, "phase": "already_draining"}
            self._draining.add(name)
        try:
            return self._drain_inner(replica, migrate, remove)
        finally:
            with self._lock:
                self._draining.discard(name)

    def _drain_inner(self, replica, migrate, remove):
        name = replica.name
        # 1. announcement: no new sessions, affinity forgets NOW
        dropped = self.registry.announce_drain(name)
        self._count_drain("announced")
        peers = [r.address for r in self.registry.candidates()
                 if r.name != name]
        # 2. order the replica to migrate its live sessions to the peers
        status = None
        try:
            resp = replica.probe.request(
                None, "POST", "/debug/drain",
                body={"peers": peers, "timeout_s": self.drain_timeout_s,
                      "migrate": bool(migrate)},
                timeout_s=min(10.0, self.drain_timeout_s))
            payload = resp.json() or {}
            status = payload.get("data") or payload
        except Exception as exc:  # noqa: BLE001 - dead replica: drain is moot
            if self.logger is not None:
                self.logger.warnf("drain %s: order failed (%s); removing",
                                  name, exc)
        # 3. poll until its sessions migrated/finished (or deadline)
        deadline = time.monotonic() + self.drain_timeout_s + 10.0
        drained = False
        while status is not None and time.monotonic() < deadline:
            if status.get("drained"):
                drained = True
                break
            time.sleep(0.25)
            try:
                resp = replica.probe.request(None, "GET", "/debug/drain",
                                             timeout_s=5.0)
                payload = resp.json() or {}
                status = payload.get("data") or payload
            except Exception:  # noqa: BLE001 - process already gone
                break
        self._count_drain("drained" if drained else "timeout")
        # 4. reclaim
        with self._lock:
            ours = name in self._launched
            if ours and remove is not False:
                self._launched.discard(name)
        should_remove = ours if remove is None else bool(remove)
        if should_remove:
            if self.launcher is not None and ours:
                self.launcher.terminate(name)
            self.registry.remove_replica(name)
            self._count_drain("removed")
        out = {"replica": name, "drained": drained,
               "affinity_dropped": dropped, "peers": peers,
               "removed": should_remove, "status": status}
        if self.logger is not None:
            self.logger.infof("drain %s: drained=%s removed=%s", name,
                              drained, should_remove)
        return out

    def _count_drain(self, phase):
        if self.metrics is not None:
            self.metrics.increment_counter("app_tpu_elastic_drains_total",
                                           phase=phase)

    # -- debug surface --------------------------------------------------------
    def snapshot(self):
        with self._lock:
            pending = {"direction": self._pending_dir,
                       "since": round(self._pending_since, 3),
                       "cooldown_until": round(self._cooldown_until, 3)}
            decisions = list(self.decisions)
            draining = sorted(self._draining)
            launched = sorted(self._launched)
            events = dict(self.scale_events)
            evaluations = self.evaluations
        return {
            "min_replicas": self.min_replicas,
            "max_replicas": self.max_replicas,
            "interval_s": self.interval_s,
            "up_hold_s": self.up_hold_s,
            "down_hold_s": self.down_hold_s,
            "cooldown_s": self.cooldown_s,
            "launcher": (type(self.launcher).__name__
                         if self.launcher is not None else None),
            "evaluations": evaluations,
            "scale_events": events,
            "pending": pending,
            "draining": draining,
            "launched": launched,
            "decisions": decisions[-16:],
            "replicas": [
                {"name": r.name, "lifecycle": r.effective_lifecycle,
                 "scaleout_wanted": r.scaleout_wanted,
                 "available": r.available()}
                for r in list(self.registry.replicas)],
        }


def register_elastic_metrics(metrics):
    """Idempotent registration of the router-side elastic series."""
    specs = (
        ("counter", "app_tpu_elastic_scale_events_total",
         "autoscaler actuations by direction (up=launch, down=drain)"),
        ("counter", "app_tpu_elastic_drains_total",
         "drain orchestration phases: announced, drained, timeout, removed"),
        ("gauge", "app_tpu_elastic_replicas_target",
         "replica count the autoscaler currently wants"),
    )
    for kind, name, desc in specs:
        try:
            if metrics.get(name) is not None:
                continue
            if kind == "counter":
                metrics.new_counter(name, desc)
            else:
                metrics.new_gauge(name, desc)
        except Exception:  # noqa: BLE001 - already registered
            pass


def install_routes(app, autoscaler):
    """GET /debug/fleet/elastic (reconciler state) and
    POST /debug/fleet/drain/{replica} (operator drain-with-migration;
    body: ``{"migrate": true, "remove": false}``)."""

    @app.get("/debug/fleet/elastic")
    def _elastic(ctx):  # noqa: ARG001 - gofr handler shape
        return autoscaler.snapshot()

    @app.post("/debug/fleet/drain/{replica}")
    def _drain(ctx):
        from ..http.errors import EntityNotFound

        name = ctx.request.path_param("replica")
        body = ctx.bind() or {}
        out = autoscaler.drain(
            name, migrate=bool(body.get("migrate", True)),
            remove=body.get("remove"))
        if "error" in out:
            raise EntityNotFound("replica", name)
        return out

    return app


__all__ = [
    "FleetAutoscaler", "ReplicaLauncher", "InProcessLauncher",
    "SubprocessLauncher", "launcher_from_config",
    "register_elastic_metrics", "install_routes",
]

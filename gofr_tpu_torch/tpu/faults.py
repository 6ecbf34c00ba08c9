"""Crash-only serving primitives: the fault-injection plane and the
reset-storm breaker.

A copy of ``gofr_tpu/tpu/faults.py``, whole: ``InjectedFault``, ``KNOWN_SITES``,
``FaultRule``, ``FaultPlane``, ``plane_from_config``, ``install_routes``
(``GET``/``POST /debug/faults``) and ``ResetStormBreaker``, stdlib only.

  * **FaultPlane** — a seeded, deterministic fault schedule ("fail the 3rd
    decode dispatch", "add 50 ms to every sync") hooked into the engine's
    dispatch sites and the executor's compile-or-hit lookup. An armed
    ``raise`` becomes, at the dispatch site, the same ``CacheLostError`` a
    failed launch or sync produces, so everything downstream (reset,
    replay, quarantine, breaker) is the production path.
  * **ResetStormBreaker** — M device resets inside a T-second window open
    the breaker: ``submit()`` sheds with a typed 503 (``DeviceLostError``),
    health reports DOWN, and after a cooldown the engine loop runs ONE
    half-open probe (on the card: one tiny launch and a device
    synchronize) that closes the breaker or re-opens it.

The site ``device.health_probe`` is the device client's health probe
(tpu/device.CUDAClient, the twin of the reference's ``TPUClient``): a
``wedge`` there holds the single-flight probe, and ``/.well-known/health``
answers DEGRADED within the probe's timeout; a ``raise`` is a DOWN probe.
``App.enable_fault_injection`` arms the plane on the container's client
too.

Zero-overhead contract: every hooked component holds ``faults = None`` by
default and guards each site with ONE attribute check. A FaultPlane exists
only when chaos is armed through config (``FAULT_INJECTION=true``) or a
test. The routes are registered ONLY under ``FAULT_INJECTION=true``, so on
a production server ``/debug/faults`` answers 404.
"""

from __future__ import annotations

import collections
import json
import random
import threading
import time
from typing import Any, Dict, List, Optional, Sequence


class InjectedFault(RuntimeError):
    """Raised by an armed "raise"-action fault rule at its hook site; the
    surrounding dispatch wrapper turns it into the same CacheLostError a
    real device failure produces, so the whole recovery path downstream
    of the raise is the production path."""


# hook sites wired in this PR; FaultRule accepts any site string so new
# hooks never need a lockstep edit here (an unknown site simply never hits)
KNOWN_SITES = (
    "engine.prefill",       # fused/paged/prefix prefill dispatch
    "engine.decode",        # block-decode dispatch
    "engine.verify",        # speculative verify dispatch
    "engine.chunk",         # chunked-prefill dispatch
    "engine.sync",          # host sync of the oldest in-flight dispatch
    "engine.cache_grow",    # dense KV growth copy
    "engine.probe",         # the breaker's half-open probe dispatch
    "executor.compile",     # program compile-or-hit lookups
    "device.health_probe",  # the device client's health probe
)

_ACTIONS = ("raise", "delay", "wedge")


class FaultRule:
    """One schedule entry. Trigger (exactly one, else unconditional):
    ``nth`` — fire on the Nth hit at the site (1-based, deterministic);
    ``every`` — fire on every Kth hit; ``prob`` — fire with probability p
    from the plane's seeded RNG. ``times`` bounds total firings (default
    1; 0 = unlimited). Action: ``raise`` (InjectedFault), ``delay``
    (sleep ``delay_s``), ``wedge`` (sleep ``delay_s`` or 300 s — long
    enough that probe timeouts and stall detection trip)."""

    __slots__ = ("site", "action", "nth", "every", "prob", "times",
                 "delay_s", "error", "fired")

    def __init__(self, site: str, action: str = "raise", nth: int = 0,
                 every: int = 0, prob: float = 0.0, times: int = 1,
                 delay_s: float = 0.0, error: str = ""):
        if not site or not isinstance(site, str):
            raise ValueError(f"fault rule needs a site string, got {site!r}")
        if action not in _ACTIONS:
            raise ValueError(f"fault action must be one of {_ACTIONS}, "
                             f"got {action!r}")
        if sum(1 for trig in (nth, every, prob) if trig) > 1:
            raise ValueError("fault rule takes at most ONE of nth/every/prob")
        self.site = site
        self.action = action
        self.nth = int(nth)
        self.every = int(every)
        self.prob = float(prob)
        self.times = int(times)
        self.delay_s = float(delay_s)
        self.error = error
        self.fired = 0

    def matches(self, count: int, rng: random.Random) -> bool:
        if self.times and self.fired >= self.times:
            return False
        if self.nth:
            return count == self.nth
        if self.every:
            return count % self.every == 0
        if self.prob:
            return rng.random() < self.prob
        return True

    def describe(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"site": self.site, "action": self.action,
                               "times": self.times, "fired": self.fired}
        for key in ("nth", "every", "prob", "delay_s"):
            value = getattr(self, key)
            if value:
                out[key] = value
        if self.error:
            out["error"] = self.error
        return out


class FaultPlane:
    """Deterministic fault schedule shared by every hooked component.

    Thread-safe: ``hit`` takes one short lock to advance the site counter
    and pick a matching rule, then sleeps/raises OUTSIDE the lock so a
    wedge rule can never block other sites' bookkeeping. Determinism:
    triggers are counted per site and probabilistic rules draw from one
    seeded RNG, so the same (plan, seed, traffic) produces the same
    injections — the property the chaos CI suite asserts against."""

    def __init__(self, plan: Optional[Sequence[Dict[str, Any]]] = None,
                 seed: int = 0, logger=None):
        self._lock = threading.Lock()
        self.seed = int(seed)
        self._rng = random.Random(self.seed)
        self._rules: List[FaultRule] = []
        self._counts: Dict[str, int] = {}
        # bounded firing log: the evidence trail an operator (or the soak
        # artifact) reads back after a drill
        self._fired: "collections.deque" = collections.deque(maxlen=128)
        self.logger = logger
        if plan:
            self.arm(plan, seed=seed)

    def arm(self, plan: Sequence[Dict[str, Any]],
            seed: Optional[int] = None) -> None:
        """Replace the schedule (and reset hit counts) atomically. Raises
        ValueError on a malformed plan without touching the armed state."""
        rules = [FaultRule(**dict(spec)) for spec in plan]
        with self._lock:
            if seed is not None:
                self.seed = int(seed)
                self._rng = random.Random(self.seed)
            self._rules = rules
            self._counts = {}
        if self.logger is not None:
            self.logger.warnf("fault plane armed: %d rule(s), seed=%d",
                              len(rules), self.seed)

    def disarm(self) -> None:
        with self._lock:
            self._rules = []
        if self.logger is not None:
            self.logger.warnf("fault plane disarmed")

    def hit(self, site: str, **ctx) -> None:
        """Hook-site entry point. O(1) + O(rules) under the lock; returns
        instantly when no rule matches (the armed-but-quiet cost)."""
        with self._lock:
            count = self._counts.get(site, 0) + 1
            self._counts[site] = count
            rule = None
            for candidate in self._rules:
                if candidate.site == site and candidate.matches(count,
                                                                self._rng):
                    candidate.fired += 1
                    rule = candidate
                    break
            if rule is not None:
                # lint: clock-ok operator-facing fired-trail timestamp, correlated with external logs
                self._fired.append({"t": time.time(), "site": site,
                                    "hit": count, "action": rule.action,
                                    **ctx})
        if rule is None:
            return
        if self.logger is not None:
            self.logger.warnf("fault injected: %s at %s hit #%d",
                              rule.action, site, count)
        if rule.action == "delay":
            time.sleep(rule.delay_s)
            return
        if rule.action == "wedge":
            time.sleep(rule.delay_s or 300.0)
            return
        raise InjectedFault(rule.error
                            or f"injected fault at {site} (hit #{count})")

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "seed": self.seed,
                "rules": [rule.describe() for rule in self._rules],
                "hits": dict(self._counts),
                "fired": list(self._fired),
            }


def plane_from_config(config, logger=None) -> Optional[FaultPlane]:
    """A FaultPlane when FAULT_INJECTION is enabled in config, else None
    (the zero-overhead default). FAULT_INJECTION_PLAN is inline JSON or
    ``@/path/to/plan.json``; FAULT_INJECTION_SEED seeds the RNG."""
    if not config.get_bool("FAULT_INJECTION", False):
        return None
    raw = config.get_or_default("FAULT_INJECTION_PLAN", "")
    plan: List[Dict[str, Any]] = []
    if raw:
        if raw.startswith("@"):
            with open(raw[1:], "r", encoding="utf-8") as fp:
                raw = fp.read()
        plan = json.loads(raw)
    return FaultPlane(plan=plan,
                      seed=config.get_int("FAULT_INJECTION_SEED", 0),
                      logger=logger)


def install_routes(app, plane: FaultPlane,
                   path: str = "/debug/faults") -> None:
    """Register the chaos-drill endpoints on a gofr_tpu App. Callers MUST
    gate this on FAULT_INJECTION (App.enable_fault_injection does): an
    unregistered route 404s, which is the production posture."""
    from ..http.errors import HTTPError

    @app.get(path)
    def fault_snapshot(ctx):  # noqa: ANN001
        return plane.snapshot()

    @app.post(path)
    def fault_arm(ctx):  # noqa: ANN001
        body = ctx.bind()
        if not isinstance(body, dict):
            raise HTTPError("body must be a JSON object", status_code=400)
        if body.get("disarm"):
            plane.disarm()
            return plane.snapshot()
        plan = body.get("plan")
        if not isinstance(plan, list):
            raise HTTPError("body needs a 'plan' list (or 'disarm': true)",
                            status_code=400)
        try:
            plane.arm(plan, seed=body.get("seed"))
        except (TypeError, ValueError) as exc:
            raise HTTPError(f"invalid fault plan: {exc}",
                            status_code=400) from exc
        return plane.snapshot()


class ResetStormBreaker:
    """Trips when device resets cluster: ``max_resets`` within ``window_s``
    seconds opens it; ``cooldown_s`` later the engine loop's next
    iteration gets ONE half-open probe; the probe's outcome closes or
    re-opens. ``max_resets <= 0`` disables the breaker entirely.

    State is read lock-free on the submit path (one str attribute
    compare); transitions take the lock. A reset recorded while half-open
    re-opens immediately — the in-flight probe's eventual verdict is then
    ignored by probe_ok (state must be HALF_OPEN to close)."""

    CLOSED, HALF_OPEN, OPEN = "closed", "half_open", "open"
    STATE_CODES = {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}

    def __init__(self, max_resets: int = 3, window_s: float = 60.0,
                 cooldown_s: float = 5.0, clock=time.monotonic):
        self.max_resets = int(max_resets)
        self.window_s = float(window_s)
        self.cooldown_s = float(cooldown_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._resets: "collections.deque" = collections.deque()
        self._opened_at: Optional[float] = None
        self.state = self.CLOSED
        self.opened_total = 0

    @property
    def state_code(self) -> int:
        return self.STATE_CODES[self.state]

    def blocked(self) -> bool:
        """True while no new work should be admitted (open OR half-open:
        the probe, not queued traffic, decides recovery)."""
        return self.state != self.CLOSED

    def record_reset(self) -> bool:
        """Count one device reset; True exactly when THIS reset tripped
        the breaker closed -> open."""
        if self.max_resets <= 0:
            return False
        now = self._clock()
        with self._lock:
            self._resets.append(now)
            cutoff = now - self.window_s
            while self._resets and self._resets[0] < cutoff:
                self._resets.popleft()
            if self.state == self.HALF_OPEN:
                # the device died again while probing: straight back open
                self.state = self.OPEN
                self._opened_at = now
                return False
            if (self.state == self.CLOSED
                    and len(self._resets) >= self.max_resets):
                self.state = self.OPEN
                self._opened_at = now
                self.opened_total += 1
                return True
            return False

    def reject_for(self) -> Optional[float]:
        """None when submits may proceed; otherwise the Retry-After hint
        (seconds) a shed client should wait."""
        with self._lock:
            if self.state == self.CLOSED:
                return None
            if self.state == self.OPEN and self._opened_at is not None:
                remaining = self._opened_at + self.cooldown_s - self._clock()
                return max(0.5, remaining)
            return max(0.5, self.cooldown_s)  # half-open: probe pending

    def probe_due(self) -> bool:
        """True ONCE per cooldown expiry, transitioning open -> half_open;
        the caller owes the breaker one probe verdict."""
        with self._lock:
            if self.state != self.OPEN or self._opened_at is None:
                return False
            if self._clock() - self._opened_at < self.cooldown_s:
                return False
            self.state = self.HALF_OPEN
            return True

    def probe_ok(self) -> bool:
        """Close after a successful half-open probe; True when the state
        actually transitioned (a reset racing the probe keeps it open)."""
        with self._lock:
            if self.state != self.HALF_OPEN:
                return False
            self.state = self.CLOSED
            self._resets.clear()
            self._opened_at = None
            return True

    def probe_failed(self) -> None:
        with self._lock:
            if self.state != self.CLOSED:
                self.state = self.OPEN
                self._opened_at = self._clock()

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            out: Dict[str, Any] = {
                "state": self.state,
                "max_resets": self.max_resets,
                "window_s": self.window_s,
                "cooldown_s": self.cooldown_s,
                "recent_resets": len(self._resets),
                "opened_total": self.opened_total,
            }
            if self._opened_at is not None:
                out["open_for_s"] = round(self._clock() - self._opened_at, 2)
            return out

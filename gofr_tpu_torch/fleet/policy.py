"""Routing policies: affinity (the default), power-of-two-choices and
round-robin.

Ports ``gofr_tpu/fleet/policy.py`` whole: ``RoutingPolicy``,
``RoundRobinPolicy``, ``P2CPolicy``, ``AffinityPolicy``, ``make_policy``
and ``DEFAULT_SPILL_DEPTH``. ``P2CPolicy`` samples with a
``random.Random(seed)``, so one seed over the same candidates in the same
states gives the reference's picks.

A policy picks a replica from the available candidates (the registry
already left out DOWN, breaker-open, shedding and non-serving ones) and
labels the decision with a reason, which feeds
``app_tpu_fleet_route_total{policy,reason}``:

  - ``affinity``: the prompt's prefix matched the map and the preferred
    replica had headroom;
  - ``spill``: the prefix matched but the preferred replica is saturated
    (load >= spill_depth and another candidate is lighter);
  - ``failover``: the prefix matched a replica that is unavailable now;
  - ``miss``: no prefix match, a cold session;
  - ``p2c`` / ``round_robin``: the other policies' only reason.

Load is ``Replica.load()``, the last-probed queue depth plus this
router's in-flight count, so spillover reacts between probes too.
"""

import itertools
import random
import threading

from .affinity import affinity_keys

DEFAULT_SPILL_DEPTH = 8


class RoutingPolicy:
    """Interface: choose(candidates, keys, affinity_map) -> (replica, reason)."""

    name = "base"

    def choose(self, candidates, keys, affinity_map):  # pragma: no cover - interface
        raise NotImplementedError


class RoundRobinPolicy(RoutingPolicy):
    name = "round_robin"

    def __init__(self):
        self._counter = itertools.count()
        self._lock = threading.Lock()

    def choose(self, candidates, keys, affinity_map):
        with self._lock:
            i = next(self._counter)
        return candidates[i % len(candidates)], "round_robin"


class P2CPolicy(RoutingPolicy):
    """Power of two choices: sample two candidates, take the lighter."""

    name = "p2c"

    def __init__(self, seed=None):
        self._rng = random.Random(seed)
        self._lock = threading.Lock()

    def choose(self, candidates, keys, affinity_map):
        if len(candidates) == 1:
            return candidates[0], "p2c"
        with self._lock:
            a, b = self._rng.sample(candidates, 2)
        return (a if a.load() <= b.load() else b), "p2c"


class AffinityPolicy(RoutingPolicy):
    """Prefix affinity with load spillover.

    Sticks to the replica whose KV already holds the prompt's prefix
    unless that replica is saturated (load >= spill_depth) AND some
    other candidate is strictly lighter — a hot replica that is still
    the lightest keeps its sessions.  Misses and failovers fall back to
    the spill policy (p2c by default).
    """

    name = "affinity"

    def __init__(self, spill_depth=DEFAULT_SPILL_DEPTH, fallback=None):
        self.spill_depth = spill_depth
        self.fallback = fallback if fallback is not None else P2CPolicy()

    def choose(self, candidates, keys, affinity_map):
        preferred_name, _ = affinity_map.lookup(keys)
        if preferred_name is None:
            replica, _ = self.fallback.choose(candidates, keys, affinity_map)
            return replica, "miss"
        preferred = next((c for c in candidates if c.name == preferred_name),
                         None)
        if preferred is None:
            replica, _ = self.fallback.choose(candidates, keys, affinity_map)
            return replica, "failover"
        if preferred.load() >= self.spill_depth:
            others = [c for c in candidates if c is not preferred]
            if others:
                lightest = min(others, key=lambda c: c.load())
                if lightest.load() < preferred.load():
                    return lightest, "spill"
        return preferred, "affinity"


def make_policy(name, spill_depth=DEFAULT_SPILL_DEPTH, seed=None):
    name = (name or "affinity").strip().lower()
    if name == "affinity":
        return AffinityPolicy(spill_depth=spill_depth, fallback=P2CPolicy(seed))
    if name == "p2c":
        return P2CPolicy(seed)
    if name == "round_robin":
        return RoundRobinPolicy()
    raise ValueError(f"unknown FLEET_POLICY {name!r} "
                     "(expected affinity | p2c | round_robin)")


__all__ = ["RoutingPolicy", "RoundRobinPolicy", "P2CPolicy", "AffinityPolicy",
           "make_policy", "affinity_keys", "DEFAULT_SPILL_DEPTH"]

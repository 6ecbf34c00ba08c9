"""Arrival-process synthesis: Poisson/ramp schedules, zipf tenants,
per-class mixes, session reuse.

Ports ``gofr_tpu/loadgen/synth.py`` whole: ``poisson_arrivals``,
``ramp_arrivals``, ``zipf_weights`` and ``synthesize``, drawn from
``random.Random`` in the same order, so a seed gives the reference's
events byte for byte.

Everything is deterministic from the seed so a synthesized trace IS a
trace — two runs of the same spec produce byte-identical arrival
processes, which is what makes a scorecard comparison between them a
measurement of the SYSTEM, not of the generator's dice.
"""

from __future__ import annotations

import math
import random
from typing import Any, Dict, List, Optional, Sequence

from .trace import make_event

DEFAULT_CLASS_MIX = {"interactive": 0.5, "standard": 0.35, "batch": 0.15}


def poisson_arrivals(rate_rps: float, seconds: float,
                     rng: random.Random) -> List[float]:
    """Homogeneous Poisson process: exponential inter-arrivals at
    ``rate_rps``, truncated at ``seconds``."""
    out: List[float] = []
    if rate_rps <= 0 or seconds <= 0:
        return out
    t = 0.0
    while True:
        t += rng.expovariate(rate_rps)
        if t >= seconds:
            return out
        out.append(round(t, 6))


def ramp_arrivals(rate0_rps: float, rate1_rps: float, seconds: float,
                  rng: random.Random) -> List[float]:
    """Inhomogeneous Poisson with linearly interpolated rate, by
    thinning against the peak rate — the open-loop λ-ramp knee mode
    walks."""
    peak = max(rate0_rps, rate1_rps, 1e-9)
    out: List[float] = []
    if seconds <= 0 or peak <= 0:
        return out
    t = 0.0
    while True:
        t += rng.expovariate(peak)
        if t >= seconds:
            return out
        rate_t = rate0_rps + (rate1_rps - rate0_rps) * (t / seconds)
        if rng.random() < rate_t / peak:
            out.append(round(t, 6))


def zipf_weights(n: int, s: float = 1.1) -> List[float]:
    """Normalized zipf(s) weights over ranks 1..n (rank 1 hottest)."""
    if n <= 0:
        return []
    raw = [1.0 / math.pow(k, s) for k in range(1, n + 1)]
    total = sum(raw)
    return [w / total for w in raw]


def synthesize(arrivals: Sequence[float],
               tenants: int = 4,
               zipf_s: float = 1.1,
               class_mix: Optional[Dict[str, float]] = None,
               sessions: int = 8,
               session_reuse: float = 0.6,
               prompt_tokens: Sequence[int] = (4, 24),
               max_new: Sequence[int] = (4, 16),
               seed: int = 0) -> List[Dict[str, Any]]:
    """One trace event per arrival time.

    Tenants are zipf(s)-weighted (tenant0 hottest — the multi-tenant
    skew the capacity meter attributes); classes draw from
    ``class_mix``; with probability ``session_reuse`` an arrival
    continues an existing session (next turn, longer prompt — the
    prefix-affinity hit path), otherwise it opens a fresh one. Prompt
    length and max_new draw uniformly from their (lo, hi) ranges.
    """
    rng = random.Random(seed)
    mix = dict(class_mix or DEFAULT_CLASS_MIX)
    classes = sorted(mix)
    class_weights = [max(0.0, float(mix[c])) for c in classes]
    tenant_weights = zipf_weights(max(1, tenants), zipf_s)
    plo, phi = int(prompt_tokens[0]), int(prompt_tokens[-1])
    nlo, nhi = int(max_new[0]), int(max_new[-1])
    live: List[Dict[str, Any]] = []   # open sessions: {"id", "turn", ...}
    next_session = seed * 100003 + 1
    out: List[Dict[str, Any]] = []
    for t in arrivals:
        tenant_idx = rng.choices(range(len(tenant_weights)),
                                 weights=tenant_weights)[0]
        cls = rng.choices(classes, weights=class_weights)[0] \
            if classes else None
        if live and sessions > 0 and rng.random() < session_reuse:
            sess = rng.choice(live)
            sess["turn"] += 1
        else:
            sess = {"id": next_session, "turn": 0}
            next_session += 1
            live.append(sess)
            if len(live) > max(1, sessions):
                live.pop(0)
        out.append(make_event(
            t=t,
            prompt_tokens=rng.randint(min(plo, phi), max(plo, phi)),
            seed=rng.randrange(2 ** 31),
            max_new=rng.randint(min(nlo, nhi), max(nlo, nhi)),
            cls=cls,
            tenant=f"tenant{tenant_idx}",
            session=sess["id"],
            turn=sess["turn"]))
    return out

"""Knee mode: ramp λ open-loop until the system folds, and check the
capacity observatory saw it coming.

Ports ``gofr_tpu/loadgen/knee.py`` whole: ``run_knee`` and
``_normalize_forecast``. The forecast is a replica's ``GET
/debug/capacity`` (``replicas_needed`` None) or the port's router's ``GET
/debug/fleet/capacity`` (``fleet/capacity.py``, with ``replicas_needed``).

The drill is the capacity forecaster's field exam. A linear λ-ramp
(inhomogeneous Poisson, real sockets) walks offered load from well
under capacity to well past it while a sampler polls the capacity
forecast (``rho``, ``predicted_ttft_ms``, ``collapse_warning``,
``replicas_needed``). Afterwards the measured story is reconstructed
from the generator's own rows: the quiet-baseline TTFT from the early
low-λ stretch, and the first arrival whose TTFT blew past
``blowout_factor`` × baseline. The contract under test — the same one
tools/soak.py's capacity profile gates on — is that the *forecast*
warning fires at an arrival time no later than the first measured
blowout: an early-warning system that alarms after the users already
felt it is a postmortem, not a forecast.

``forecast_fn`` is any zero-arg callable returning a forecast dict —
an in-process ``fc.evaluate()``, or an HTTP poll of a replica's
``/debug/capacity`` / the router's ``/debug/fleet/capacity`` (both
shapes are normalized here), which is how the soak profile runs it
over sockets.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional

from .generator import OpenLoopRunner
from .scorecard import percentile
from .synth import ramp_arrivals, synthesize

import random

DEFAULT_BLOWOUT_FACTOR = 8.0
DEFAULT_BLOWOUT_FLOOR_MS = 600.0


def _normalize_forecast(raw: Any) -> Optional[Dict[str, Any]]:
    """Reduce any capacity surface payload to the fields the drill
    compares: replica ``forecast`` blocks, bare ``evaluate()`` dicts,
    and fleet rollups (where the warning is a list of replica names)
    all flatten to the same row."""
    if not isinstance(raw, dict):
        return None
    if isinstance(raw.get("fleet"), dict):
        fleet = raw["fleet"]
        return {
            "rho": fleet.get("rho"),
            "predicted_ttft_ms": fleet.get("predicted_ttft_ms_max"),
            "lambda_tok_s": fleet.get("lambda_tok_s"),
            "mu_tok_s": fleet.get("mu_tok_s"),
            "replicas_needed": fleet.get("replicas_needed"),
            "collapse_warning": bool(fleet.get("collapse_warnings")),
        }
    if isinstance(raw.get("forecast"), dict):
        raw = raw["forecast"]
    return {
        "rho": raw.get("rho"),
        "predicted_ttft_ms": raw.get("predicted_ttft_ms"),
        "lambda_tok_s": raw.get("lambda_tok_s"),
        "mu_tok_s": raw.get("mu_tok_s"),
        "replicas_needed": raw.get("replicas_needed"),
        "collapse_warning": bool(raw.get("collapse_warning")),
    }


def run_knee(base_url: str,
             forecast_fn: Callable[[], Optional[Dict[str, Any]]],
             rate0_rps: float = 2.0, rate1_rps: float = 30.0,
             seconds: float = 30.0, seed: int = 0,
             poll_s: float = 0.5, quiet_frac: float = 0.25,
             blowout_factor: float = DEFAULT_BLOWOUT_FACTOR,
             blowout_floor_ms: float = DEFAULT_BLOWOUT_FLOOR_MS,
             drain_timeout_s: float = 60.0,
             synth_kw: Optional[Dict[str, Any]] = None,
             request_timeout_s: float = 30.0,
             baseline_ttft_ms: Optional[float] = None) -> Dict[str, Any]:
    """Run the ramp, poll the forecaster, return the cross-check.

    The result's ``agrees`` is the gate: True when the forecaster's
    collapse warning fired at (or before) the arrival time of the
    first measured TTFT blowout — or when neither side saw a collapse
    (a ramp that never folds is a clean run, not a miss).
    """
    arrivals = ramp_arrivals(rate0_rps, rate1_rps, seconds,
                             random.Random(seed))
    events = synthesize(arrivals, seed=seed, **(synth_kw or {}))
    runner = OpenLoopRunner(base_url, events, timeout_s=request_timeout_s,
                            label="knee")
    samples: List[Dict[str, Any]] = []
    runner.start()
    # sampler runs on the dispatcher's clock so sample t and arrival t
    # share one axis
    while not runner.wait_dispatch(timeout_s=poll_s):
        row = _normalize_forecast(forecast_fn())
        if row is not None and runner.t0 is not None:
            row["t"] = round(time.monotonic() - runner.t0, 3)
            samples.append(row)
    # keep sampling through the drain — the warning often fires while
    # the tail of the backlog is still being served
    drain_deadline = time.monotonic() + max(0.0, drain_timeout_s)
    while time.monotonic() < drain_deadline:
        row = _normalize_forecast(forecast_fn())
        if row is not None and runner.t0 is not None:
            row["t"] = round(time.monotonic() - runner.t0, 3)
            samples.append(row)
        if runner.join(timeout_s=poll_s):
            break
    else:
        runner.abort()
        runner.join(timeout_s=5.0)

    rows = runner.rows()
    ok = [r for r in rows if r.get("status") == "ok"
          and isinstance(r.get("ttft_s"), (int, float))]
    if baseline_ttft_ms is not None:
        # caller measured the quiet baseline itself (soak's ramp stage)
        baseline_ms: Optional[float] = float(baseline_ttft_ms)
    else:
        quiet_cut = seconds * max(0.0, min(1.0, quiet_frac))
        quiet = [r["ttft_s"] * 1000.0 for r in ok if r["t"] <= quiet_cut]
        baseline_ms = percentile(quiet, 50)
    blowout_ms = (max(blowout_factor * baseline_ms, blowout_floor_ms)
                  if baseline_ms is not None else None)
    first_blowout_at: Optional[float] = None
    if blowout_ms is not None:
        blown = [r["t"] for r in ok if r["ttft_s"] * 1000.0 > blowout_ms]
        first_blowout_at = min(blown) if blown else None
    warned = [s for s in samples if s.get("collapse_warning")]
    warned_at = warned[0]["t"] if warned else None
    peak_rho = max((s["rho"] for s in samples
                    if isinstance(s.get("rho"), (int, float))),
                   default=None)
    # agreement: a warning that precedes the measured blowout — or a
    # quiet run on both instruments
    if first_blowout_at is None:
        agrees = True
        detail = ("no measured blowout"
                  + ("" if warned_at is None
                     else f"; warning at t={warned_at}s (early alarm)"))
    elif warned_at is None:
        agrees = False
        detail = (f"measured blowout at t={first_blowout_at}s but the "
                  "forecaster never warned")
    else:
        agrees = warned_at <= first_blowout_at
        detail = (f"warning at t={warned_at}s, first blowout arrival at "
                  f"t={first_blowout_at}s")
    return {
        "knee_version": 1,
        "ramp": {"rate0_rps": rate0_rps, "rate1_rps": rate1_rps,
                 "seconds": seconds, "seed": seed,
                 "arrivals": len(events)},
        "baseline_ttft_ms": (round(baseline_ms, 3)
                             if baseline_ms is not None else None),
        "blowout_ttft_ms": (round(blowout_ms, 3)
                            if blowout_ms is not None else None),
        "first_blowout_at_s": first_blowout_at,
        "collapse_warning_at_s": warned_at,
        "peak_rho": peak_rho,
        "replicas_needed_final": (samples[-1].get("replicas_needed")
                                  if samples else None),
        "agrees": agrees,
        "detail": detail,
        "samples": samples,
        "status": runner.status(),
        "rows": rows,
    }

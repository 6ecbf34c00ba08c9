"""SLO scorecards: per-(class, tenant) rollups scored against declared
objectives and a checked-in baseline with noise bands.

Ports ``gofr_tpu/loadgen/scorecard.py`` whole: ``percentile``,
``build_scorecard``, ``baseline_from_scorecard``, ``compare`` and the
default objectives.

The scorecard answers two different questions and keeps them separate:

  * **objectives** — did this run meet the SLOs the fleet *declares*
    (per-class TTFT/TPOT percentile ceilings and a goodput floor)?
    Absolute, run-independent, the operator contract.
  * **baseline comparison** — did this run move relative to the last
    blessed run of the same workload? Every latency number on a shared
    CI box is noisy, so the baseline carries an explicit noise band per
    metric and `compare()` only speaks up when a delta clears the band:
    ``pass`` (inside the band), ``regress`` (worse, outside it),
    ``improve`` (better, outside it). CI gates on ``regress`` alone —
    an improve verdict is a prompt to re-bless the baseline, not a
    failure.

Goodput is the honest throughput number: the fraction of *offered*
requests (including shed/dropped/error — the open-loop generator
records every arrival) that completed AND met their class's latency
objective. A server that sheds 40% of arrivals to keep its p95 flat
does not get to report a perfect scorecard.

All math is stdlib; a scorecard is a plain JSON-able dict so it lands
in the run artifact verbatim and `baseline_from_scorecard()` can turn
any blessed run into the next baseline file.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Iterable, List, Optional

SCORECARD_VERSION = 1

# Declared per-class objectives for the debug fleet the harness tests
# against. Callers with real SLOs pass their own; these defaults are
# deliberately loose — they gate CI smoke runs on shared runners, not
# production latency.
DEFAULT_OBJECTIVES: Dict[str, Dict[str, float]] = {
    "interactive": {"ttft_p95_ms": 2000.0, "goodput_min": 0.80},
    "standard": {"ttft_p95_ms": 4000.0, "goodput_min": 0.70},
    "batch": {"ttft_p95_ms": 15000.0, "goodput_min": 0.50},
}
_FALLBACK_OBJECTIVE = {"ttft_p95_ms": 8000.0, "goodput_min": 0.50}

# Baseline noise bands: a delta must clear max(relative, absolute) of
# the baseline value before compare() calls it real. Wide on purpose —
# shared CI boxes jitter; the knee drill, not the scorecard, is the
# sensitive instrument.
DEFAULT_REL_BAND = 0.35
DEFAULT_ABS_BAND_MS = 150.0
DEFAULT_ABS_BAND_RATIO = 0.10   # for goodput / rate metrics


def percentile(values: Iterable[float], p: float) -> Optional[float]:
    """Linear-interpolated percentile (p in [0, 100]); None when
    empty. Matches statistics.quantiles' inclusive method closely
    enough for scorecard math without the n>=2 restriction."""
    data = sorted(float(v) for v in values)
    if not data:
        return None
    if len(data) == 1:
        return data[0]
    rank = (max(0.0, min(100.0, float(p))) / 100.0) * (len(data) - 1)
    lo = int(math.floor(rank))
    hi = min(lo + 1, len(data) - 1)
    frac = rank - lo
    return data[lo] * (1.0 - frac) + data[hi] * frac


def _cell(rows: List[Dict[str, Any]],
          objective: Dict[str, float]) -> Dict[str, Any]:
    """Roll one (class, tenant) bucket of generator rows up into
    counts, latency percentiles, and goodput vs the class objective."""
    offered = len(rows)
    ok = [r for r in rows if r.get("status") == "ok"]
    shed = sum(1 for r in rows if r.get("status") == "shed")
    dropped = sum(1 for r in rows if r.get("status") == "dropped")
    errors = offered - len(ok) - shed - dropped
    ttft_ms = [float(r["ttft_s"]) * 1000.0 for r in ok
               if isinstance(r.get("ttft_s"), (int, float))]
    tpot_ms = [float(r["tpot_s"]) * 1000.0 for r in ok
               if isinstance(r.get("tpot_s"), (int, float))]
    ceiling = float(objective.get("ttft_p95_ms") or float("inf"))
    good = sum(1 for r in ok
               if not isinstance(r.get("ttft_s"), (int, float))
               or float(r["ttft_s"]) * 1000.0 <= ceiling)
    out: Dict[str, Any] = {
        "offered": offered,
        "ok": len(ok),
        "shed": shed,
        "dropped": dropped,
        "errors": errors,
        "goodput": round(good / offered, 4) if offered else None,
        "tokens": sum(int(r.get("tokens") or 0) for r in ok),
    }
    for name, series in (("ttft_ms", ttft_ms), ("tpot_ms", tpot_ms)):
        for p in (50, 95, 99):
            value = percentile(series, p)
            out[f"{name}_p{p}"] = round(value, 3) if value is not None \
                else None
    return out


def _objective_checks(cell: Dict[str, Any],
                      objective: Dict[str, float]) -> List[Dict[str, Any]]:
    checks: List[Dict[str, Any]] = []
    ceiling = objective.get("ttft_p95_ms")
    if ceiling is not None and cell.get("ttft_ms_p95") is not None:
        checks.append({
            "metric": "ttft_ms_p95", "limit": float(ceiling),
            "value": cell["ttft_ms_p95"],
            "met": cell["ttft_ms_p95"] <= float(ceiling)})
    floor = objective.get("goodput_min")
    if floor is not None and cell.get("goodput") is not None:
        checks.append({
            "metric": "goodput", "limit": float(floor),
            "value": cell["goodput"],
            "met": cell["goodput"] >= float(floor)})
    return checks


def build_scorecard(rows: Iterable[Dict[str, Any]],
                    objectives: Optional[Dict[str, Dict[str, float]]] = None,
                    meta: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Generator rows -> the scorecard dict.

    ``classes`` holds the per-class rollup (the unit objectives are
    declared against); ``cells`` the finer per-(class, tenant) grid the
    capacity meter's attribution can be checked against. ``slo_met`` is
    the AND of every objective check — the absolute half of the CI
    gate.
    """
    rows = [r for r in rows if isinstance(r, dict)]
    objs = dict(objectives or DEFAULT_OBJECTIVES)
    by_class: Dict[str, List[Dict[str, Any]]] = {}
    by_cell: Dict[str, List[Dict[str, Any]]] = {}
    for row in rows:
        cls = str(row.get("class") or "unclassified")
        tenant = str(row.get("tenant") or "-")
        by_class.setdefault(cls, []).append(row)
        by_cell.setdefault(f"{cls}|{tenant}", []).append(row)
    classes: Dict[str, Any] = {}
    all_met = True
    for cls, bucket in sorted(by_class.items()):
        objective = objs.get(cls, _FALLBACK_OBJECTIVE)
        cell = _cell(bucket, objective)
        cell["objective_checks"] = _objective_checks(cell, objective)
        cell["slo_met"] = all(c["met"] for c in cell["objective_checks"])
        all_met = all_met and cell["slo_met"]
        classes[cls] = cell
    cells = {}
    for key, bucket in sorted(by_cell.items()):
        cls = key.split("|", 1)[0]
        cells[key] = _cell(bucket, objs.get(cls, _FALLBACK_OBJECTIVE))
    out: Dict[str, Any] = {
        "scorecard_version": SCORECARD_VERSION,
        "offered": len(rows),
        "classes": classes,
        "cells": cells,
        "objectives": objs,
        "slo_met": all_met,
    }
    if meta:
        out.update(meta)
    return out


# -- baseline + comparison ----------------------------------------------------
# metrics compared against the baseline, with (kind) deciding the band
# floor and the direction in which "worse" lies
_COMPARED = (
    ("ttft_ms_p50", "latency"), ("ttft_ms_p95", "latency"),
    ("tpot_ms_p50", "latency"), ("goodput", "ratio"),
)


def baseline_from_scorecard(scorecard: Dict[str, Any],
                            rel_band: float = DEFAULT_REL_BAND,
                            abs_band_ms: float = DEFAULT_ABS_BAND_MS,
                            abs_band_ratio: float = DEFAULT_ABS_BAND_RATIO,
                            ) -> Dict[str, Any]:
    """Bless one run as the comparison baseline: per-class expected
    values plus the noise band each future delta must clear."""
    classes: Dict[str, Any] = {}
    for cls, cell in (scorecard.get("classes") or {}).items():
        entry: Dict[str, Any] = {}
        for metric, kind in _COMPARED:
            value = cell.get(metric)
            if not isinstance(value, (int, float)):
                continue
            band = max(abs(value) * rel_band,
                       abs_band_ms if kind == "latency"
                       else abs_band_ratio)
            entry[metric] = {"value": round(float(value), 4),
                             "band": round(band, 4)}
        if entry:
            entry["offered"] = cell.get("offered")
            classes[cls] = entry
    return {"baseline_version": SCORECARD_VERSION,
            "rel_band": rel_band, "classes": classes}


def compare(scorecard: Dict[str, Any],
            baseline: Dict[str, Any]) -> Dict[str, Any]:
    """Score a run against a blessed baseline.

    Per metric: inside the band -> ``pass``; outside it, ``regress``
    when worse (latency up / goodput down) else ``improve``. The
    overall verdict is the worst per-metric verdict, and ``regress``
    also fires when the run misses its absolute objectives — a run
    that matches a baseline which itself blew the SLO is still a
    failure.
    """
    checks: List[Dict[str, Any]] = []
    verdict = "pass"
    base_classes = baseline.get("classes") or {}
    for cls, expected in sorted(base_classes.items()):
        cell = (scorecard.get("classes") or {}).get(cls)
        if cell is None:
            checks.append({"class": cls, "metric": "presence",
                           "verdict": "regress",
                           "detail": "class absent from run"})
            verdict = "regress"
            continue
        for metric, kind in _COMPARED:
            spec = expected.get(metric)
            value = cell.get(metric)
            if not isinstance(spec, dict) \
                    or not isinstance(value, (int, float)):
                continue
            base, band = float(spec["value"]), float(spec["band"])
            delta = float(value) - base
            worse_is_up = (kind == "latency")
            if abs(delta) <= band:
                mark = "pass"
            elif (delta > 0) == worse_is_up:
                mark = "regress"
            else:
                mark = "improve"
            checks.append({"class": cls, "metric": metric,
                           "baseline": base, "band": band,
                           "value": round(float(value), 4),
                           "delta": round(delta, 4), "verdict": mark})
            if mark == "regress":
                verdict = "regress"
            elif mark == "improve" and verdict == "pass":
                verdict = "improve"
    if not scorecard.get("slo_met", True):
        verdict = "regress"
        checks.append({"metric": "slo_met", "verdict": "regress",
                       "detail": "absolute objectives missed"})
    return {"verdict": verdict, "checks": checks,
            "slo_met": bool(scorecard.get("slo_met", True))}

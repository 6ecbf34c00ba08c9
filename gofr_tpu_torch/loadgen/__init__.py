"""Traffic observatory: trace capture, open-loop replay, SLO scorecards.

Ports ``gofr_tpu/loadgen/`` whole, with the reference's ``__all__``; its
CLI, ``tools/loadgen.py``, is ``python -m gofr_tpu_torch.loadgen`` here
(``__main__.py``). The modules are stdlib only.

Every load tool the repo had before this package was closed-loop: a
worker sends a request, waits for the stream to finish, then sends the
next one. Under overload that harness *slows itself down* — the arrival
rate collapses to the service rate, the queue never grows without
bound, and queueing collapse (the failure mode that kills open-loop
production systems) is structurally invisible. This package is the
traffic side of the observability plane:

  * **trace** — a versioned JSONL trace format for arrival processes:
    relative arrival time, tenant, QoS class, session id, and a prompt
    *spec* (token count + seed — never raw text) with conversation
    linkage, so any captured workload replays deterministically;
  * **capture** — bounded, best-effort capture hooks for the fleet
    router (and any flight recorder) that export what a live run
    actually saw as a replayable trace at ``GET /debug/trace``;
  * **synth** — Poisson/ramp arrival schedules with zipf tenant mixes,
    per-class mixes, and session reuse that hits the prefix-affinity
    path;
  * **generator** — the open-loop driver: real sockets
    (``http.client`` + threads, stdlib-only), arrivals fire on
    schedule regardless of completions, per-request
    TTFT/TPOT/status/class recorded into a run artifact;
  * **scorecard** — per-(class, tenant) percentile rollups + goodput
    scored against declared objectives and a checked-in baseline with
    noise bands, emitting a machine-readable pass/regress/improve
    verdict;
  * **knee** — a λ-ramp drill that locates the queueing collapse point
    and cross-checks the capacity observatory's forecast (predicted ρ,
    ``collapse_warning``, ``replicas_needed``) against measured
    reality over sockets.

``python -m gofr_tpu_torch.loadgen`` is the CLI.
"""

from .capture import TraceCapture, install_routes
from .generator import OpenLoopRunner
from .knee import run_knee
from .scorecard import (baseline_from_scorecard, build_scorecard, compare,
                        percentile)
from .status import StatusServer
from .synth import (poisson_arrivals, ramp_arrivals, synthesize,
                    zipf_weights)
from .trace import (TRACE_VERSION, TraceError, dump_trace,
                    events_from_incident, events_from_requests, load_trace,
                    make_event, prompt_text)

__all__ = [
    "TRACE_VERSION", "TraceError", "make_event", "prompt_text",
    "dump_trace", "load_trace", "events_from_requests",
    "events_from_incident",
    "TraceCapture", "install_routes",
    "poisson_arrivals", "ramp_arrivals", "zipf_weights", "synthesize",
    "OpenLoopRunner", "StatusServer",
    "build_scorecard", "compare", "baseline_from_scorecard", "percentile",
    "run_knee",
]

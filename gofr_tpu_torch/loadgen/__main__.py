"""loadgen: capture, synthesize, replay, and score fleet traffic.

Ports the reference's CLI, ``tools/loadgen.py``, whole, with the same
subcommands and flags: ``python -m gofr_tpu_torch.loadgen <command>``.
Five subcommands, all stdlib, all against live HTTP surfaces:

    capture   pull GET /debug/trace (router capture ring, replica
              flight recorder, or /debug/incidents/{id}/trace) and
              write it as a JSONL trace file
    synth     synthesize a trace: poisson|ramp arrivals, zipf tenant
              mix, per-class mix, session reuse
    replay    replay a trace open-loop against a router's /generate,
              write the run artifact (status + per-request rows +
              scorecard), optionally serving the live status at
              --status-port
    score     score a run artifact against objectives and a baseline
              file; exit 1 on a regress verdict (the CI gate);
              --bless writes the run back out as the new baseline
    knee      ramp λ until the system folds, cross-checking the
              capacity observatory's collapse warning against the
              measured TTFT blowout; exit 1 when the forecast missed

Artifacts are JSON files at the paths the flags name.
"""

from __future__ import annotations

import argparse
import json
import random
import sys
import time
import urllib.request

from . import (OpenLoopRunner, StatusServer, baseline_from_scorecard,
               build_scorecard, compare, dump_trace, load_trace,
               poisson_arrivals, ramp_arrivals, run_knee, synthesize)
from .trace import TRACE_VERSION


def _get_json(url: str, timeout: float = 10.0) -> dict:
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        body = json.loads(resp.read().decode())
    return body.get("data", body) if isinstance(body, dict) else body


def cmd_capture(args) -> int:
    doc = _get_json(args.url.rstrip("/") + args.path)
    events = doc.pop("events", [])
    if isinstance(events, int):  # header counted events; ring was empty
        events = []
    meta = {k: v for k, v in doc.items()
            if k not in ("trace_version",) and not isinstance(v, (dict,
                                                                  list))}
    n = dump_trace(events, args.out,
                   source=str(doc.get("source") or "capture"), meta=meta)
    print(f"captured {n} events -> {args.out} "
          f"(trace_version {TRACE_VERSION})")
    return 0 if n or args.allow_empty else 1


def cmd_synth(args) -> int:
    rng = random.Random(args.seed)
    if args.shape == "ramp":
        arrivals = ramp_arrivals(args.rate0, args.rate1, args.seconds, rng)
    else:
        arrivals = poisson_arrivals(args.rate, args.seconds, rng)
    events = synthesize(
        arrivals, tenants=args.tenants, zipf_s=args.zipf,
        sessions=args.sessions, session_reuse=args.session_reuse,
        prompt_tokens=(args.prompt_min, args.prompt_max),
        max_new=(args.max_new_min, args.max_new_max), seed=args.seed)
    n = dump_trace(events, args.out, source=f"synth:{args.shape}",
                   meta={"seed": args.seed, "seconds": args.seconds})
    print(f"synthesized {n} events -> {args.out}")
    return 0


def _write_artifact(path: str, artifact: dict) -> None:
    with open(path, "w", encoding="utf-8") as fp:
        json.dump(artifact, fp, indent=1)
    print(f"artifact -> {path}")


def cmd_replay(args) -> int:
    header, events = load_trace(args.trace)
    runner = OpenLoopRunner(args.url, events, timeout_s=args.timeout,
                            label=args.label)
    status = None
    if args.status_port is not None:
        status = StatusServer(
            runner, port=args.status_port,
            scorecard_fn=lambda: build_scorecard(runner.rows())).start()
        print(f"status at {status.url}/debug/loadgen")
    try:
        runner.start()
        runner.wait_dispatch()
        if not runner.join(timeout_s=args.drain):
            runner.abort()
            runner.join(timeout_s=5)
    finally:
        if status is not None:
            status.stop()
    card = build_scorecard(runner.rows(), meta={"trace": args.trace,
                                                "source": header.get(
                                                    "source")})
    verdict = "pass" if card["slo_met"] else "regress"
    if args.baseline:
        with open(args.baseline, encoding="utf-8") as fp:
            verdict = compare(card, json.load(fp))["verdict"]
    runner.verdict = verdict
    _write_artifact(args.out, runner.artifact({"scorecard": card,
                                               "verdict": verdict}))
    print(f"verdict: {verdict}")
    return 1 if verdict == "regress" and args.gate else 0


def cmd_score(args) -> int:
    with open(args.artifact, encoding="utf-8") as fp:
        artifact = json.load(fp)
    card = artifact.get("scorecard") or build_scorecard(
        artifact.get("rows") or [])
    if args.bless:
        with open(args.bless, "w", encoding="utf-8") as fp:
            json.dump(baseline_from_scorecard(card), fp, indent=1)
        print(f"baseline blessed -> {args.bless}")
        return 0
    with open(args.baseline, encoding="utf-8") as fp:
        result = compare(card, json.load(fp))
    print(json.dumps(result, indent=1))
    return 1 if result["verdict"] == "regress" else 0


def cmd_knee(args) -> int:
    forecast_url = (args.forecast
                    or args.url.rstrip("/") + "/debug/fleet/capacity")

    def forecast_fn():
        try:
            return _get_json(forecast_url, timeout=5.0)
        except Exception:  # noqa: BLE001 - sampler degrades per poll
            return None

    result = run_knee(args.url, forecast_fn, rate0_rps=args.rate0,
                      rate1_rps=args.rate1, seconds=args.seconds,
                      seed=args.seed, request_timeout_s=args.timeout)
    result["scorecard"] = build_scorecard(result.pop("rows"))
    _write_artifact(args.out, result)
    print(f"knee: {result['detail']}  "
          f"(baseline={result['baseline_ttft_ms']}ms, "
          f"peak_rho={result['peak_rho']}, agrees={result['agrees']})")
    return 0 if result["agrees"] else 1


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("capture", help="save a /debug/trace export")
    p.add_argument("--url", default="http://127.0.0.1:9000")
    p.add_argument("--path", default="/debug/trace",
                   help="e.g. /debug/incidents/3/trace for an incident")
    p.add_argument("--out", default="trace.jsonl")
    p.add_argument("--allow-empty", action="store_true")
    p.set_defaults(fn=cmd_capture)

    p = sub.add_parser("synth", help="synthesize a trace")
    p.add_argument("--shape", choices=("poisson", "ramp"),
                   default="poisson")
    p.add_argument("--rate", type=float, default=5.0)
    p.add_argument("--rate0", type=float, default=2.0)
    p.add_argument("--rate1", type=float, default=30.0)
    p.add_argument("--seconds", type=float, default=30.0)
    p.add_argument("--tenants", type=int, default=4)
    p.add_argument("--zipf", type=float, default=1.1)
    p.add_argument("--sessions", type=int, default=8)
    p.add_argument("--session-reuse", type=float, default=0.6)
    p.add_argument("--prompt-min", type=int, default=4)
    p.add_argument("--prompt-max", type=int, default=24)
    p.add_argument("--max-new-min", type=int, default=4)
    p.add_argument("--max-new-max", type=int, default=16)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default="trace.jsonl")
    p.set_defaults(fn=cmd_synth)

    p = sub.add_parser("replay", help="replay a trace open-loop")
    p.add_argument("--url", default="http://127.0.0.1:9000")
    p.add_argument("--trace", required=True)
    p.add_argument("--timeout", type=float, default=60.0)
    p.add_argument("--drain", type=float, default=120.0)
    p.add_argument("--label", default="loadgen")
    p.add_argument("--baseline", default="",
                   help="baseline JSON to compare against")
    p.add_argument("--gate", action="store_true",
                   help="exit 1 on a regress verdict")
    p.add_argument("--status-port", type=int, default=None,
                   help="serve live /debug/loadgen on this port (0=any)")
    p.add_argument("--out", default="LOADGEN_run.json")
    p.set_defaults(fn=cmd_replay)

    p = sub.add_parser("score", help="score an artifact vs a baseline")
    p.add_argument("--artifact", required=True)
    p.add_argument("--baseline", default="loadgen_baseline.json")
    p.add_argument("--bless", default="",
                   help="write the artifact's scorecard out as the new "
                        "baseline instead of comparing")
    p.set_defaults(fn=cmd_score)

    p = sub.add_parser("knee", help="λ-ramp collapse drill")
    p.add_argument("--url", default="http://127.0.0.1:9000")
    p.add_argument("--forecast", default="",
                   help="capacity surface to poll (default "
                        "<url>/debug/fleet/capacity)")
    p.add_argument("--rate0", type=float, default=2.0)
    p.add_argument("--rate1", type=float, default=30.0)
    p.add_argument("--seconds", type=float, default=30.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--timeout", type=float, default=30.0)
    p.add_argument("--out", default="LOADGEN_knee.json")
    p.set_defaults(fn=cmd_knee)

    args = ap.parse_args()
    t0 = time.time()
    rc = args.fn(args)
    print(f"done in {time.time() - t0:.1f}s (rc={rc})")
    return rc


if __name__ == "__main__":
    sys.exit(main())

"""LLM serving over the port: continuous batching + SSE streaming.

Counterpart of ``examples/llm-server/main.py``: ``build_engine`` reads the
same config keys the slice supports, and ``POST /generate`` takes the same
body and sends the same events.

    POST /generate {"prompt": "...", "max_tokens": 64, "temperature": 0.7,
    "stream": true} -> server-sent events, one {"text": ...} per token, then
    {"done": true, "tokens": N, "tok_per_s": x}. stream=false returns one
    JSON response {"text", "tokens", "seconds"}. "top_p" / "top_k" truncate
    the sampled distribution per request under SAMPLING_CONTROLS=true. The
    reference's 400 answers them without it or out of range (the engine
    refuses them), non-numeric values, and a QoS class (the X-QoS-Class
    header, else the body's "class") that is not one of tpu/qos.py's
    CLASSES. The class and the tenant (the X-Tenant header, else the body's
    "tenant") go into submit, QoS on or off: the capacity meter bills each
    (tenant, class), and under QOS=true the class bands the admission and
    the ladder acts on it. A ladder shed or a queued request past its
    class's deadline is a 503 with Retry-After, as a draining, stalled or
    breaker-open engine's is. max_tokens below 1 serves one token, as the
    reference's does. While the engine's lifecycle is ``draining`` it
    answers 503.

    GET /stats -> the reference's fleet probe: active_slots, queue_depth,
    compiled_programs, stall_seconds, spec (under SPECULATIVE_TOKENS),
    pages, prefix_cache and kv_tier (paged), slo (with the flight
    recorder) and fleet {affinity digest, lifecycle, warm_boot_s (after a
    warm boot), qos {scaleout_wanted} (under QOS), duty_cycle}.

    gRPC ``llm.Generator/Generate`` on GRPC_PORT (default 9000; 0 picks a
    free port), server-streaming, JSON messages (grpcx/): the same body
    keys as /generate (prompt, max_tokens, temperature, min_tokens,
    priority, top_p, top_k) through the same submitter (the engine, with
    its QoS plane and its admission plane, or the pair's router), one
    {"text"} per decoded chunk that has text, then {"done": true, "tokens",
    "tok_per_s"}; the request is cancelled when the stream ends or the
    client goes away. An empty prompt or a refused parameter answers
    INVALID_ARGUMENT, a shed UNAVAILABLE (``build_generate_service``).
    Under a TP job only rank 0 binds it, as only rank 0 serves HTTP.

Run: ``python -m gofr_tpu_torch.serve`` (config from .env files under
GOFR_CONFIGS_DIR, the process environment over them). Every key the
reference's llm-server and OpenAI server read, and every App-level key of
the reference's App and container, is accounted for here: served (PORTED,
read by build_engine or the App), refused at boot where it asks for a
feature not ported yet (NOT_PORTED, naming its ROADMAP item), or inert,
each for its stated reason (INERT). Keys: MODEL_PRESET (debug | llama1b | llama3-8b | llama3-70b, default
debug), ATTN_IMPL (flash | xla, default flash), PAGED (true: the paged
engine; false: the dense-cache engine), DECODE_ATTN (xla | kernel, the
dense engine's T=1 read), KV_DTYPE (unset | int8; the dense engine needs
DECODE_ATTN=kernel for int8), PAGE_SIZE (128), N_PAGES (0 = every slot can
reach MAX_SEQ_LEN), PREFIX_CACHE (true: the paged engine shares whole
prompt-prefix pages between requests and prefills only the un-cached tail,
as the reference does by default; the dense engine ignores it), MAX_BATCH
(8), MAX_SEQ_LEN (1024), PREFILL_BUCKETS ("16,32,64,128,256"), HTTP_PORT
(8000), REQUEST_TIMEOUT (5 s, for stream=false), ENGINE_ASYNC_D2H (true:
each dispatch's tokens start their copy to the host when it is enqueued;
false: at sync), WARMUP (true: capture at boot, before the engine starts,
every decode program serving can reach and the reference's warm admission
set, K=1 for every bucket and the prefix cache's tail programs at the
smallest bucket; wide: also every power-of-two K <= MAX_BATCH for every
bucket, as the reference's, and every tail program the buckets can reach;
false: capture each program at its first use). WEIGHTS_PATH (an HF-layout
safetensors checkpoint: a file, a directory or a sharded index, checked
against MODEL_PRESET's shapes before any bytes are read; unset: random
weights from seed 0), WEIGHT_DTYPE (unset | int8: per-output-channel int8
weights, quantized on the card as they load, or drawn straight to int8
without WEIGHTS_PATH), VOCAB_PATH (an HF tokenizer.json, a tiktoken
.model/.tiktoken file, or a {vocab, merges} JSON; unset: the byte
tokenizer, or the debug vocabulary's), HBM_BUDGET_BYTES (0: plan from the
card's memory, nothing on the CPU; > 0: that budget; -1: no plan; the plan
clamps MAX_BATCH, MAX_SEQ_LEN and the buckets so the weights, cache,
prefill transients and graph pools fit, tpu/capacity.py), DRAIN_TIMEOUT
(30 s: at shutdown the engine stops admitting, answers 503 to new and
queued requests and lets the active streams finish for up to this long,
then stops). SAMPLING_CONTROLS
(false: per-request top_p / top_k are refused; true: served, through the
[B, 3] row controls, each decode block captured with and without the
per-row filters), WARMUP_SCORE (false; true: also capture at boot, after
WARMUP, the logprobs / embeddings window programs, one per bucket and
family, tpu/score.py), CHUNK_PREFILL_TOKENS (0; > 0: a prompt whose bucket
is larger is admitted in chunks of this many tokens, decode blocks running
between them; it must divide every larger bucket), SPECULATIVE_TOKENS (0;
> 0: prompt-lookup speculation, up to this many drafts verified per
dispatch, greedy output unchanged; it refuses KV_DTYPE=int8 and
CHUNK_PREFILL_TOKENS, as the reference does). ENGINE_RETRY_BUDGET (2:
replays a request may take after device resets), RESET_STORM_MAX (3) and
RESET_STORM_WINDOW_S (60: that many resets inside the window open the
breaker: 503 with Retry-After and health DOWN) and BREAKER_COOLDOWN_S (5:
then the loop's half-open probe closes or re-opens it),
ENGINE_FINISHER_QUEUE (256: terminal teardown on the bounded llm-finisher
thread; 0 keeps it on the loop).

Tensor parallelism (ROADMAP A14a): TP_SHARDS (1; n > 1 serves the model
tensor-parallel over n cards, one process per card, each holding its block
of the weights (parallel/sharding.serving_param_specs) and its heads of the
KV cache, with the Megatron collectives in the model, models/llama.py).
PyTorch runs one controller per card, so every TP group is a
multi-controller job: rank 0 is the only HTTP ingress and the other ranks
replay its admission waves (tpu/admission.py) so that every rank dispatches
the same programs in the same order. Without JAX_COORDINATOR_ADDR this
process is rank 0 of a job on one host: it starts n-1 follower processes
(``spawn``, ``serve_follower``), rank r on ``cuda:r``, over a TCPStore on a
free localhost port, and the App's shutdown stops them (``end_job``).
Fewer visible cards than TP_SHARDS raise at boot: two ranks never share a
card and no smaller TP is served in their place. JAX_COORDINATOR_ADDR (with
the reference's JAX_NUM_PROCESSES, JAX_PROCESS_ID, JAX_LOCAL_DEVICE_IDS and
JAX_COORDINATOR_TIMEOUT_S, parallel/multihost.py) instead names a job the
operator launches, one ``python -m gofr_tpu_torch.serve`` per rank:
TP_SHARDS must equal JAX_NUM_PROCESSES, rank 0 serves HTTP and the other
ranks follow (``main``). The container joins the job before the first CUDA
call (``Container.join_job``). Under TP the post-hoc scoring passes, the
disaggregated pair, migration and the warm boot are refused (single-
controller only), and QoS and the breaker are off, as under the
reference's admission plane.

The App's keys (app.py, container/): HTTP_PORT (8000), METRICS_PORT (2121:
GET /metrics with the engine's app_tpu_* series and app_http_response;
0 picks a free port), REQUEST_TIMEOUT, MAX_CONCURRENT_REQUESTS (256 handler
slots, a 503 when they are full), LOG_LEVEL (INFO; JSON lines, one per
request), APP_NAME and APP_VERSION (app_info, the tracer's service name),
TRACE_EXPORTER and TRACER_URL (zipkin | otlp | jaeger | otlp-grpc | http |
gofr need the URL; log, memory; unset: none), GOFR_CONFIGS_DIR (where
``main`` reads .env files when no config is passed; the process environment
wins), GRPC_PORT (above), REMOTE_LOG_URL and REMOTE_LOG_FETCH_INTERVAL
(15 s: the container polls the URL for a new LOG_LEVEL, logging/remote.py),
TPU_ENABLED or MODEL_NAME (the container builds the device client,
tpu/device.CUDAClient, on the server's device: ``tpu`` in
/.well-known/health with the card's memory, a single-flight probe that
answers DEGRADED within its timeout when the card does not answer, the
``device.health_probe`` fault site under FAULT_INJECTION, the
app_tpu_hbm_* series at every scrape). The engine gets the container's
metrics manager, tracer and logger:
POST /generate threads its server span and the inbound traceparent into
submit, so each request's tpu.generate span joins the caller's trace.

The observability planes, on by default as in the reference (``app_for``,
both servers; each key set to false removes its routes): FLIGHT_RECORDER
(GET /debug/requests[/{id}], the engine's child spans, the SLO goodput
gauges; with it GET /debug/journey[/{id}] and, unless FLIGHT_TRACE_EXPORT
is false, GET /debug/trace), ENGINE_SNAPSHOT (GET /debug/engine, the
utilization gauges and the memory sampler), STEP_LEDGER (GET /debug/steps
and the step histograms), TIMELINE (GET /debug/timeline) and HOSTPROF (GET
/debug/hostprof; HOSTPROF_HZ <= 0 also turns it off), tuned by
FLIGHT_RECORDER_CAPACITY, FLIGHT_RECORDER_MAX_EVENTS, SLO_TTFT_TARGET_S,
SLO_TPOT_TARGET_S, ENGINE_HBM_SAMPLE_S, STEP_LEDGER_CAPACITY,
STEP_STRAGGLER_K, STEP_BASELINE_ALPHA, STEP_BASELINE_MIN_SAMPLES,
TIMELINE_STEPS, HOSTPROF_HZ, HOSTPROF_MAX_STACKS and HOSTPROF_TOP_K (app.py).
The engine's stall gauge (app_tpu_engine_stall_seconds) is refreshed at
every scrape, and a stalled engine answers 503 (EngineStalledError).
INCIDENT_AUTOPSY (GET /debug/slo and /debug/incidents[/{id}[/trace]]: the
SLO burn engine over the recorder's completions and sheds, incident
bundles on burn pages, straggler streaks, breaker opens and quarantines;
tuned by SLO_BURN_FAST_WINDOW_S, SLO_BURN_SLOW_WINDOW_S, SLO_BURN_PAGE,
SLO_BURN_WARN, SLO_BURN_OBJECTIVE_TTFT, SLO_BURN_OBJECTIVE_TPOT,
SLO_BURN_OBJECTIVE_AVAILABILITY, SLO_BURN_MIN_EVENTS, INCIDENT_DIR,
INCIDENT_RING, INCIDENT_COOLDOWN_S, INCIDENT_MAX_PER_HOUR,
INCIDENT_SLOWEST_K, INCIDENT_PROFILE_S (with PROFILE_DIR, where a bundle's
torch.profiler capture goes), INCIDENT_STRAGGLER_STREAK and
INCIDENT_STRAGGLER_WINDOW) and CAPACITY (GET /debug/capacity: the
attribution meter and the headroom forecast, tuned by METER_PAGE_TOKENS,
METER_WINDOW_S, METER_REQUESTS, METER_TOP_K, CAPACITY_WINDOW_S,
CAPACITY_RHO_WARN and CAPACITY_COLLAPSE_EVALS), on by default as in the
reference; only under FAULT_INJECTION=true, POST/GET /debug/faults
(FAULT_INJECTION_PLAN, FAULT_INJECTION_SEED) with the plane armed on the
engine and its executor; and, only under QOS=true, as in the reference,
the QoS plane (tpu/qos.py: class bands, the interactive slot reservation,
the batch page share, per-class deadlines and the shed ladder on the SLO
burn engine, with preemption of batch rows; GET /debug/qos and the
app_tpu_qos_* series), tuned by QOS_INTERACTIVE_RESERVED_SLOTS,
QOS_BATCH_PAGE_FRACTION, QOS_DEADLINE_INTERACTIVE_S,
QOS_DEADLINE_STANDARD_S, QOS_DEADLINE_BATCH_S, QOS_SHED_TRACKS,
QOS_ESCALATE_HOLD_S, QOS_RECOVER_HOLD_S, QOS_EVAL_S and
QOS_SHED_RETRY_AFTER_S (app.py); with a pub/sub broker (PUBSUB_BACKEND)
and QOS_LANE (true), the batch lane (tpu/qos.BatchLane) feeds the batch
band from QOS_BATCH_TOPIC and publishes each result to
QOS_BATCH_RESULT_TOPIC before it commits the job, up to
QOS_LANE_MAX_INFLIGHT jobs at once, with a cron kick on QOS_LANE_CRON. As in the reference's servers, neither
serves /debug/profile: ``App.enable_profiler`` is there for a harness that
wants it.
The KV tier, the disaggregated pair, the warm boot and drain with migration
(ROADMAP A11f): KV_HOST_TIER_BYTES (0; > 0: a host-RAM tier of that many
bytes under the prefix cache, tpu/kvtier.py: evicted prefix pages spill
there and a re-sent prefix is restored by one copy; /stats gains
``kv_tier``), CONVERSATION_PIN_S (600: how long the OpenAI server's
``conversation_id`` pins a trunk's tier pages), DISAGG_MODE (off | prefill
| decode | both, PAGED only: both builds a prefill twin over the same
params tree and a tpu/disagg.DisaggRouter in front of the pair, the
submitter of both servers, with GET /debug/disagg; prefill or decode build
one engine in that role), DISAGG_PREFILL_SLOTS (0: the twin gets
MAX_BATCH), DISAGG_QUEUE_DEPTH (64) and DISAGG_HANDOFF_TIMEOUT_S (10, the
stale reaper's), DISAGG_TRANSPORT (queue, the in-process hand-off queue;
pubsub: over the container's broker, tpu/disagg.PubSubTransport, or the
queue when PUBSUB_BACKEND gives none), ELASTIC_WARM_BOOT (false; true: the server comes
up ``warming``, a thread captures, then the engine starts and /stats
shows ``serving`` and ``warm_boot_s``), DRAIN_MIGRATE (true: POST /migrate, POST|GET
/debug/drain and GET /debug/kvtier, tpu/migrate.py) and
DRAIN_SHIP_TIMEOUT_S (60). KV_REDIS_TIER=true (under a host tier) chains
a write-behind Redis cold tier (datasource/kvredis.py, REDIS_HOST /
REDIS_PORT / REDIS_DB; entries expire after KV_REDIS_TTL_S, 0: never)
below host RAM, and the warm boot pre-warms through it from
ELASTIC_PREWARM_PEERS' /debug/kvtier, up to ELASTIC_PREWARM_PAGES (64)
pages. The container's datasources, as in the reference: DB_DIALECT /
DB_PATH (SQL), KV_STORE / KV_ENABLED (KV) and PUBSUB_BACKEND (inproc |
file | kafka | mqtt | google), reached from a handler through ``ctx.sql``,
``ctx.kv`` and ``ctx.pubsub`` and listed in /.well-known/health.
FLEET_AFFINITY_BLOCK sizes the affinity digest of /stats. The peak
overrides TPU_PEAK_FLOPS / TPU_PEAK_HBM_BW are read from the process
environment, as the reference reads them (tpu/utilization.py).
"""

from __future__ import annotations

import dataclasses
import json
import socket
import threading
import time
from typing import Mapping, Optional, Union

from .app import App, Stream
from .config import Config, as_config
from .container import Container
from .fleet.affinity import AffinityRecorder
from .http.errors import InvalidParam, RequestTimeout, ServiceUnavailable
from .models.llama import LlamaConfig, llama_init, llama_init_quantized
from .models.tokenizer import (BPETokenizer, ByteLevelBPETokenizer,
                               ByteTokenizer, DebugTokenizer,
                               StreamingDecoder)
from .tpu.capacity import device_budget_bytes
from .tpu.device import register_metrics, resolve_device
from .tpu.engine import LLMEngine
from .tpu.migrate import Lifecycle
from .tpu.paging import PagedLLMEngine

PRESETS = {
    "debug": LlamaConfig.debug,
    "llama1b": LlamaConfig.llama1b,
    "llama3-8b": LlamaConfig.llama3_8b,
    "llama3-70b": LlamaConfig.llama3_70b,
}

_FALSE = ("0", "false", "no", "off", "")


EnvLike = Union[Config, Mapping[str, str], None]


def _flag(env: Config, key: str, default: bool) -> bool:
    value = env.get(key)
    if value is None:
        return default
    return value.strip().lower() not in _FALSE


def _int(env: Config, key: str, default: int) -> int:
    value = env.get(key)
    return default if value in (None, "") else int(value)


def _float(env: Config, key: str, default: float) -> float:
    value = env.get(key)
    return default if value in (None, "") else float(value)


# the keys build_engine reads and serves, as the reference's llm-server
# does (the module docstring)
PORTED = (
    "MODEL_PRESET", "ATTN_IMPL", "DECODE_ATTN", "KV_DTYPE", "PAGED",
    "PAGE_SIZE", "N_PAGES", "PREFIX_CACHE", "MAX_BATCH", "MAX_SEQ_LEN",
    "PREFILL_BUCKETS", "ENGINE_ASYNC_D2H", "SAMPLING_CONTROLS", "WARMUP",
    "WARMUP_SCORE", "WEIGHTS_PATH", "WEIGHT_DTYPE", "VOCAB_PATH",
    "HBM_BUDGET_BYTES", "DRAIN_TIMEOUT", "CHUNK_PREFILL_TOKENS",
    "SPECULATIVE_TOKENS", "FLEET_AFFINITY_BLOCK",
    # tensor-parallel serving and the multi-process job (build_engine,
    # Container.join_job)
    "TP_SHARDS", "JAX_COORDINATOR_ADDR",
    # the observability planes (app_for) and their App tuning keys
    "FLIGHT_RECORDER", "FLIGHT_TRACE_EXPORT", "ENGINE_SNAPSHOT",
    "STEP_LEDGER", "TIMELINE", "HOSTPROF", "FLIGHT_RECORDER_CAPACITY",
    "FLIGHT_RECORDER_MAX_EVENTS", "SLO_TTFT_TARGET_S", "SLO_TPOT_TARGET_S",
    "ENGINE_HBM_SAMPLE_S", "STEP_LEDGER_CAPACITY", "STEP_STRAGGLER_K",
    "STEP_BASELINE_ALPHA", "STEP_BASELINE_MIN_SAMPLES", "TIMELINE_STEPS",
    "HOSTPROF_HZ", "HOSTPROF_MAX_STACKS", "HOSTPROF_TOP_K",
    # crash-only serving (build_engine) and the planes over it (app_for)
    "ENGINE_RETRY_BUDGET", "RESET_STORM_MAX", "RESET_STORM_WINDOW_S",
    "BREAKER_COOLDOWN_S", "ENGINE_FINISHER_QUEUE", "INCIDENT_AUTOPSY",
    "CAPACITY", "PROFILE_DIR", "FAULT_INJECTION", "FAULT_INJECTION_PLAN",
    "FAULT_INJECTION_SEED", "SLO_BURN_FAST_WINDOW_S",
    "SLO_BURN_SLOW_WINDOW_S", "SLO_BURN_PAGE", "SLO_BURN_WARN",
    "SLO_BURN_OBJECTIVE_TTFT", "SLO_BURN_OBJECTIVE_TPOT",
    "SLO_BURN_OBJECTIVE_AVAILABILITY", "SLO_BURN_MIN_EVENTS", "INCIDENT_DIR",
    "INCIDENT_RING", "INCIDENT_COOLDOWN_S", "INCIDENT_MAX_PER_HOUR",
    "INCIDENT_SLOWEST_K", "INCIDENT_PROFILE_S", "INCIDENT_STRAGGLER_STREAK",
    "INCIDENT_STRAGGLER_WINDOW", "METER_PAGE_TOKENS", "METER_WINDOW_S",
    "METER_REQUESTS", "METER_TOP_K", "CAPACITY_WINDOW_S",
    "CAPACITY_RHO_WARN", "CAPACITY_COLLAPSE_EVALS",
    # the KV tier, the disaggregated pair, the warm boot and drain with
    # migration (build_engine, app_for)
    "KV_HOST_TIER_BYTES", "CONVERSATION_PIN_S", "DISAGG_MODE",
    "DISAGG_PREFILL_SLOTS", "DISAGG_QUEUE_DEPTH", "DISAGG_HANDOFF_TIMEOUT_S",
    "ELASTIC_WARM_BOOT", "DRAIN_MIGRATE", "DRAIN_SHIP_TIMEOUT_S",
    # the Redis cold tier under the KV tier, the pair's pub/sub transport
    # and the warm boot's pre-warm through the cold tier (build_engine)
    "KV_REDIS_TIER", "KV_REDIS_TTL_S", "DISAGG_TRANSPORT",
    "ELASTIC_PREWARM_PEERS", "ELASTIC_PREWARM_PAGES",
    # the QoS plane and its batch lane (app_for, App.enable_qos)
    "QOS", "QOS_INTERACTIVE_RESERVED_SLOTS", "QOS_BATCH_PAGE_FRACTION",
    "QOS_DEADLINE_INTERACTIVE_S", "QOS_DEADLINE_STANDARD_S",
    "QOS_DEADLINE_BATCH_S", "QOS_SHED_TRACKS", "QOS_ESCALATE_HOLD_S",
    "QOS_RECOVER_HOLD_S", "QOS_EVAL_S", "QOS_SHED_RETRY_AFTER_S",
    "QOS_LANE", "QOS_LANE_CRON", "QOS_LANE_MAX_INFLIGHT", "QOS_BATCH_TOPIC",
    "QOS_BATCH_RESULT_TOPIC",
    # the container's datasources (Container.create)
    "DB_DIALECT", "DB_PATH", "KV_STORE", "KV_ENABLED", "PUBSUB_BACKEND",
    # the App's and its container's (app.py, container/, tracing/): the
    # gRPC server, the remote log level and the device client among them
    "HTTP_PORT", "METRICS_PORT", "REQUEST_TIMEOUT", "MAX_CONCURRENT_REQUESTS",
    "LOG_LEVEL", "APP_NAME", "APP_VERSION", "TRACE_EXPORTER", "TRACER_URL",
    "GOFR_CONFIGS_DIR", "GRPC_PORT", "REMOTE_LOG_URL",
    "REMOTE_LOG_FETCH_INTERVAL", "TPU_ENABLED", "MODEL_NAME",
)


# (key, predicate on the config that asks for the feature, what waits and
# where). Checked at boot: a key that asks for an unported feature fails
# loudly instead of being served without it. Every key of the reference's
# llm-server is served now.
NOT_PORTED = ()

# keys the reference reads that change nothing the port serves: (key, why)
INERT = (
    # no analogue
    ("PROGRAM_CACHE_DIR", "a persistent cache of XLA compiles; CUDA graphs "
     "are captured per process and cannot be stored"),
)


def load_tokenizer(path: str):
    """VOCAB_PATH format sniffing, as the reference's ``_load_tokenizer``:
    an HF tokenizer.json (byte-level BPE, what real Llama-3 checkpoints
    ship), a tiktoken .model/.tiktoken file (Meta's distribution), or the
    {vocab, merges} JSON of BPETokenizer."""
    if path.endswith((".model", ".tiktoken")):
        return ByteLevelBPETokenizer.from_tiktoken(path)
    with open(path, "r", encoding="utf-8") as fp:
        head = json.load(fp)
    if "model" in head and "vocab" in head.get("model", {}):
        return ByteLevelBPETokenizer.from_tokenizer_json(path, data=head)
    return BPETokenizer.from_file(path)


def shed_to_503(exc: Exception) -> ServiceUnavailable:
    """The reference's ``_raise_for_shed``: a shed error (a draining,
    stalled or breaker-open engine's EngineDrainingError,
    EngineStalledError or DeviceLostError, a QoS ladder's QoSShedError, a
    queued request's QoSDeadlineError: each carries status_code 503 and
    its retry_after_s) as a 503 with a Retry-After hint; a stopped engine's
    RuntimeError too (the reference answers it with a 500)."""
    return ServiceUnavailable(
        str(exc), retry_after_s=getattr(exc, "retry_after_s", None) or 1.0)


def is_shed(exc: BaseException) -> bool:
    """Whether shed_to_503 answers `exc`: a duck-typed 503, or a stopped
    engine's RuntimeError."""
    return (getattr(exc, "status_code", None) == 503
            or isinstance(exc, RuntimeError))


def _warmup_mode(env: Config) -> str:
    """WARMUP as the reference reads it: "wide", a false value (no warm-up)
    or a true one; raises ValueError on anything else."""
    value = env.get_or_default("WARMUP", "true").strip().lower()
    if value == "wide":
        return "wide"
    if value in _FALSE:
        return "false"
    if value in ("1", "true", "yes", "on"):
        return "true"
    raise ValueError(f"WARMUP must be true, wide or false, got "
                     f"{env.get('WARMUP')!r}")


def check_config(env: EnvLike, not_ported=None) -> None:
    """Raise ValueError naming the ROADMAP item of the first config key that
    asks for a feature the port does not have yet (`not_ported`: a server's
    table of them, default this server's NOT_PORTED)."""
    env = as_config(env)
    for key, asks, where in NOT_PORTED if not_ported is None else not_ported:
        if asks(env):
            raise ValueError(f"{key}={env.get(key)!r} is not supported by "
                             f"gofr_tpu_torch yet: {where}")


class _Over(Config):
    """A config with some keys set over another's."""

    def __init__(self, base: Config, values: Mapping[str, str]):
        self.base = base
        self.values = dict(values)

    def get(self, key: str) -> Optional[str]:
        if key in self.values:
            return self.values[key]
        return self.base.get(key)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _local_tp_job(env: Config, dev, tp: int):
    """TP_SHARDS=tp > 1 without a coordinator: this process becomes rank 0
    of a job on this host. Starts the tp-1 followers (``serve_follower``,
    spawned, rank r on cuda:r or on the CPU) and returns (this process's
    config over the job's JAX_* keys, the follower processes)."""
    import multiprocessing as mp

    import torch

    if dev.type == "cuda" and torch.cuda.device_count() < tp:
        raise ValueError(
            f"TP_SHARDS={tp} needs {tp} cards, {torch.cuda.device_count()} "
            f"visible: a rank never shares a card, and no smaller TP is "
            f"served in its place")
    job = {"JAX_COORDINATOR_ADDR": f"127.0.0.1:{_free_port()}",
           "JAX_NUM_PROCESSES": str(tp)}
    ctx = mp.get_context("spawn")
    procs = []
    for rank in range(1, tp):
        proc = ctx.Process(
            target=serve_follower, name=f"tp-follower-{rank}", daemon=True,
            args=(_Over(env, {**job, "JAX_PROCESS_ID": str(rank)}),
                  "cpu" if dev.type == "cpu" else None))
        proc.start()
        procs.append(proc)
    return _Over(env, {**job, "JAX_PROCESS_ID": "0"}), procs


def _tp_setup(env: Config, container: Container, dev, tp: int):
    """(device, mesh, admission plane, followers) of this process: all
    None but the device without TP_SHARDS > 1 or a coordinator; else this
    rank's card (or the CPU), the job's tp mesh and the plane over the
    job's store, rank 0 leading."""
    followers = []
    if tp > 1 and not env.get("JAX_COORDINATOR_ADDR"):
        env, followers = _local_tp_job(env, dev, tp)
    try:
        joined = container.join_job(dev, config=env)
    except BaseException:
        stop_followers(followers)
        raise
    if joined is None:
        return dev, None, None, followers
    from .parallel import MeshPlan, make_mesh
    from .tpu.admission import AdmissionPlane, StoreKV

    spec, dev = joined
    if spec.num_processes != tp:
        stop_followers(followers)
        raise ValueError(
            f"TP_SHARDS={tp} but the job has {spec.num_processes} "
            f"processes: the port's job is one tensor-parallel group")
    mesh = make_mesh(MeshPlan(tp=tp), device=dev)
    plane = AdmissionPlane(process_id=spec.process_id, kv=StoreKV())
    return dev, mesh, plane, followers


def _left_key(plane, rank: int) -> str:
    return f"{plane.prefix}/left/{rank}"


def _drop_graphs(engine) -> None:
    """Forget the engine's captured programs, and sync the card, before the
    job's communicators are torn down: a CUDA graph that captured a NCCL
    collective holds that communicator, which must outlive the graph."""
    import gc

    from .tpu.executor import synchronize

    engine.executor.drop(lambda name: True)
    gc.collect()
    if engine.device.type == "cuda":
        synchronize(engine.device)


def end_job(engine, followers=(), timeout_s: float = 60.0) -> None:
    """Rank 0's end of a TP job, after its engine's stop (whose stop
    sentinel the followers exit on): wait until every follower has said it
    is leaving, then leave the job with them (parallel/multihost.leave:
    NCCL's teardown may wait for every rank, so no rank leaves alone), then
    join the follower processes this process started, killing what
    outlives `timeout_s`. A follower that never says so is not waited for
    in the teardown (this rank keeps its group until it exits)."""
    import torch.distributed as dist

    from .parallel.multihost import leave

    plane = engine._plane
    deadline = time.monotonic() + timeout_s
    world = dist.get_world_size() if dist.is_initialized() else 1
    left = True
    for rank in range(1, world):
        try:
            plane.kv.get_blocking(_left_key(plane, rank), max(
                0.1, deadline - time.monotonic()))
        except (TimeoutError, ConnectionError):
            left = False
    if left:
        _drop_graphs(engine)
        leave()
    else:
        engine.logger.errorf("a follower never left the job; rank 0 keeps "
                             "its process group")
    for proc in followers:
        proc.join(timeout=max(0.1, deadline - time.monotonic()))
    for proc in followers:
        if proc.is_alive():
            proc.kill()
            proc.join(timeout=10)


def stop_followers(followers, timeout_s: float = 5.0) -> None:
    """Kill the follower processes of a boot that failed."""
    for proc in followers:
        proc.join(timeout=timeout_s)
        if proc.is_alive():
            proc.kill()
            proc.join(timeout=10)


def follow(engine, poll_s: float = 0.1) -> None:
    """A follower rank's life after boot: its engine replays the leader's
    waves until the leader stops (the plane's stop sentinel), then stops,
    says so in the store, and leaves the job with the other ranks."""
    from .parallel.multihost import leave

    plane = engine._plane
    while (not plane.closed and engine._thread is not None
           and engine._thread.is_alive()):
        time.sleep(poll_s)
    engine.stop()
    _drop_graphs(engine)
    try:
        plane.kv.set(_left_key(plane, plane.process_id), "1")
    except Exception:  # noqa: BLE001 - the leader's store may be gone
        return
    leave()


def serve_follower(env, device=None) -> None:
    """The body of a follower process (rank r > 0 of a TP job): its engine,
    then ``follow``."""
    follow(build_engine(env, device=device))


def build_engine(env: EnvLike = None, device=None, params=None,
                 default_sampling_controls: bool = False,
                 container: Optional[Container] = None,
                 kv_cold_store=None) -> LLMEngine:
    """Engine from config keys (a Config or a plain mapping; see the module
    docstring), warmed up and started. device: None = the CUDA card
    (raises without one); "cpu" for tests. params: an already-built params
    dict for the preset (default: llama_init, seed 0).
    default_sampling_controls: SAMPLING_CONTROLS when the key is unset (the
    OpenAI server's is on). container: the App's (default: one made from
    the config); the engine records into its metrics manager (the
    app_tpu_* names registered here) and tracer and logs to its logger, as
    the reference's build_engine hands them over, and rides on
    ``engine.container`` for build_app. A `params` tree of fewer layers
    than MODEL_PRESET's (its first layers, say) is served at its own depth,
    at the preset's width. On the card the kernels are built
    here, at boot, and then WARMUP captures the programs serving is
    expected to reach (every one under wide) and WARMUP_SCORE the scoring
    family, so no request pays the compiler or a capture. The engine's
    `warmup_seconds` and `score_warmup_seconds` hold their times (0.0 when
    off). kv_cold_store: a store with the Redis datasource's set / get /
    delete surface under the KV tier, for a harness that shares one between
    replicas (else KV_REDIS_TIER builds one from config). DISAGG_MODE=both also builds the prefill twin and the router,
    on ``engine.disagg_router`` (``_build_pair``); ELASTIC_WARM_BOOT=true
    returns at once with the engine ``warming`` (``_warm_boot``).
    TP_SHARDS > 1 or JAX_COORDINATOR_ADDR: this rank's engine of the TP
    job (the module docstring), on ``engine.followers`` the follower
    processes this leader started (empty elsewhere)."""
    env = as_config(env)
    check_config(env)
    warm = _warmup_mode(env)
    dev = resolve_device(device)
    if container is None:
        container = Container.create(env, device=dev)
    tp = _int(env, "TP_SHARDS", 1)
    if tp > 1 and _flag(env, "ELASTIC_WARM_BOOT", False):
        raise ValueError("ELASTIC_WARM_BOOT with TP_SHARDS > 1: the warm "
                         "boot is single-controller only")
    # before the first CUDA call: join the job (and start the followers)
    dev, mesh, plane, followers = _tp_setup(env, container, dev, tp)
    try:
        preset = env.get_or_default("MODEL_PRESET", "debug")
        if preset not in PRESETS:
            raise ValueError(f"MODEL_PRESET must be one of {sorted(PRESETS)}, "
                             f"got {preset!r}")
        attn_impl = env.get_or_default("ATTN_IMPL", "flash")
        decode_attn = env.get_or_default("DECODE_ATTN", "xla")
        kv_dtype = env.get("KV_DTYPE") or None
        if attn_impl not in ("xla", "flash"):
            raise ValueError(f"ATTN_IMPL must be xla|flash, got {attn_impl!r}")
        if decode_attn not in ("xla", "kernel"):
            raise ValueError(f"DECODE_ATTN must be xla|kernel, got "
                             f"{decode_attn!r}")
        if kv_dtype not in (None, "int8"):
            raise ValueError(f"KV_DTYPE must be int8 or unset, got "
                             f"{kv_dtype!r}")
        disagg_mode = env.get_or_default("DISAGG_MODE", "off").lower()
        if disagg_mode not in ("off", "prefill", "decode", "both"):
            raise ValueError(f"DISAGG_MODE must be off|prefill|decode|both, "
                             f"got {disagg_mode!r}")
        paged = _flag(env, "PAGED", True)
        if disagg_mode != "off" and not paged:
            raise ValueError("DISAGG_MODE requires PAGED=true")
        cfg = dataclasses.replace(PRESETS[preset](), attn_impl=attn_impl,
                                  decode_attn=decode_attn, kv_dtype=kv_dtype)
        if params is not None:
            # the depth of the tree given: every layer leaf is stacked [L, ...]
            depth = next(iter(params["layers"].values())).shape[0]
            cfg = dataclasses.replace(cfg, n_layers=depth)
        weight_dtype = env.get("WEIGHT_DTYPE") or None
        if weight_dtype not in (None, "int8"):
            raise ValueError(f"WEIGHT_DTYPE must be int8 or unset, got "
                             f"{weight_dtype!r}")
        log = container.logger
        vocab_path = env.get("VOCAB_PATH") or ""
        if vocab_path:
            tokenizer = load_tokenizer(vocab_path)
            log.infof("loaded vocab from %s (%s, %d tokens)", vocab_path,
                      type(tokenizer).__name__, tokenizer.vocab_size)
        elif cfg.vocab_size > ByteTokenizer.vocab_size:
            # synthetic vocabularies sample ids the byte tokenizer cannot
            # round-trip; DebugTokenizer decodes every id to one char
            tokenizer = DebugTokenizer(cfg.vocab_size)
        else:
            tokenizer = ByteTokenizer()
        if cfg.vocab_size < tokenizer.vocab_size:
            raise ValueError(f"model vocab ({cfg.vocab_size}) too small for "
                             f"tokenizer ({tokenizer.vocab_size})")
        if dev.type == "cuda":
            from .ops import _build

            _build.build(*_build.KERNELS)
        weights_path = env.get("WEIGHTS_PATH") or ""
        if params is None and weights_path:
            from .models.weights import load_llama_safetensors

            t0 = time.monotonic()
            params = load_llama_safetensors(cfg, weights_path,
                                            weight_dtype=weight_dtype,
                                            logger=log, device=dev)
            log.infof("loaded weights from %s in %.1fs (%s)", weights_path,
                      time.monotonic() - t0, weight_dtype or cfg.dtype)
        elif params is None and weight_dtype == "int8":
            params = llama_init_quantized(cfg, seed=0, device=dev)
        elif params is None:
            params = llama_init(cfg, seed=0, device=dev)
        budget_cfg = _int(env, "HBM_BUDGET_BYTES", 0)
        budget = (0 if budget_cfg < 0
                  else budget_cfg or device_budget_bytes(dev))
        metrics = container.metrics_manager
        register_metrics(metrics)
        kw = dict(device=dev, n_slots=_int(env, "MAX_BATCH", 8),
                  budget_bytes=budget or None,
                  metrics=metrics, tracer=container.tracer, logger=log,
                  async_d2h=_flag(env, "ENGINE_ASYNC_D2H", True),
                  sampling_controls=_flag(env, "SAMPLING_CONTROLS",
                                          default_sampling_controls),
                  max_seq_len=_int(env, "MAX_SEQ_LEN", 1024),
                  # >0 splits long prompts into bounded chunk dispatches (must
                  # divide the buckets it splits); >0 verifies up to N
                  # prompt-lookup drafts per dispatch (greedy output unchanged)
                  chunk_prefill_tokens=_int(env, "CHUNK_PREFILL_TOKENS", 0),
                  speculative_tokens=_int(env, "SPECULATIVE_TOKENS", 0),
                  # crash-only recovery: replay after a reset (bounded per
                  # request) and the reset-storm breaker (503 + health DOWN)
                  retry_budget=_int(env, "ENGINE_RETRY_BUDGET", 2),
                  reset_storm_max=_int(env, "RESET_STORM_MAX", 3),
                  reset_storm_window_s=_float(env, "RESET_STORM_WINDOW_S",
                                              60.0),
                  breaker_cooldown_s=_float(env, "BREAKER_COOLDOWN_S", 5.0),
                  # terminal teardown off the loop (0: inline)
                  finisher_queue=_int(env, "ENGINE_FINISHER_QUEUE", 256),
                  mesh=mesh, admission_plane=plane,
                  prefill_buckets=tuple(int(b) for b in env.get_or_default(
                      "PREFILL_BUCKETS", "16,32,64,128,256").split(",")))
        if paged:
            kw.update(page_size=_int(env, "PAGE_SIZE", 128),
                      n_pages=_int(env, "N_PAGES", 0) or None,
                      prefix_cache=_flag(env, "PREFIX_CACHE", True))
            # a host-RAM tier under the prefix cache: evicted pages spill to
            # host blobs and a re-sent prefix is restored by one copy instead
            # of a prefill (tpu/kvtier.py)
            tier_bytes = _int(env, "KV_HOST_TIER_BYTES", 0)
            if tier_bytes > 0:
                if kv_cold_store is None and _flag(env, "KV_REDIS_TIER",
                                                   False):
                    # a write-behind Redis cold tier below host RAM; a
                    # store that cannot connect is counted in the tier's
                    # errors and serving goes on
                    from .datasource.kvredis import RedisKVStore

                    kv_cold_store = RedisKVStore(env, log, metrics)
                ttl = _float(env, "KV_REDIS_TTL_S", 0.0)
                kw.update(kv_host_tier_bytes=tier_bytes,
                          kv_redis=kv_cold_store,
                          kv_redis_ttl_s=ttl if ttl > 0 else None,
                          conversation_pin_s=_float(env, "CONVERSATION_PIN_S",
                                                    600.0))
            if disagg_mode != "off":
                kw["disagg_role"] = ("decode" if disagg_mode == "both"
                                     else disagg_mode)
            engine = PagedLLMEngine(params, cfg, **kw)
        else:
            engine = LLMEngine(params, cfg, **kw)
        engine.tokenizer = tokenizer
        engine.container = container
        engine.warmup_seconds = engine.score_warmup_seconds = 0.0
        engine.warm_boot_s = None
        engine.disagg_router = None
        score = _flag(env, "WARMUP_SCORE", False)
        if _flag(env, "ELASTIC_WARM_BOOT", False):
            engine.lifecycle = Lifecycle("warming")
        else:
            _warm(engine, warm, score, log)
        if disagg_mode == "both":
            transport = None
            if env.get_or_default("DISAGG_TRANSPORT",
                                  "queue").lower() == "pubsub":
                # hand-offs over the container's broker (commit to
                # advance); without one, the in-process queue, as in the
                # reference
                from .tpu.disagg import PubSubTransport

                if container.pubsub is not None:
                    transport = PubSubTransport(container.pubsub)
            _build_pair(engine, warm, kw, params, budget_cfg, log,
                        transport=transport,
                        n_slots=_int(env, "DISAGG_PREFILL_SLOTS", 0),
                        queue_depth=_int(env, "DISAGG_QUEUE_DEPTH", 64),
                        handoff_timeout_s=_float(
                            env, "DISAGG_HANDOFF_TIMEOUT_S", 10.0))
        if engine.lifecycle.state == "warming":
            # the pre-warm loads pages through the tier's shared cold store:
            # KV_REDIS_TIER's, or a harness's kv_cold_store
            peers = [p.strip() for p in env.get_or_default(
                "ELASTIC_PREWARM_PEERS", "").split(",") if p.strip()]
            _warm_boot(engine, warm, score, log, peers=peers,
                       prewarm_pages=_int(env, "ELASTIC_PREWARM_PAGES", 64))
        else:
            engine.start()
    except BaseException:
        stop_followers(followers)
        raise
    engine.followers = followers
    return engine


def _warm(engine, warm: str, score: bool, log) -> None:
    """WARMUP's captures, then WARMUP_SCORE's, before the engine starts."""
    if warm != "false":
        t0 = time.monotonic()
        engine.warmup(k_variants=warm == "wide")
        engine.warmup_seconds = time.monotonic() - t0
        log.infof("engine warmed up in %.1fs%s", engine.warmup_seconds,
                  " (wide)" if warm == "wide" else "")
    if score:
        t0 = time.monotonic()
        n = engine.warmup_scoring()
        engine.score_warmup_seconds = time.monotonic() - t0
        log.infof("scoring warmed up in %.1fs (%d passes)",
                  engine.score_warmup_seconds, n)


def _warm_boot(engine, warm: str, score: bool, log, peers,
               prewarm_pages: int) -> None:
    """ELASTIC_WARM_BOOT=true: the HTTP surface comes up at once with the
    lifecycle ``warming`` (in /stats; routers hold traffic), and a thread
    runs the warm-up and the KV pre-warm from ELASTIC_PREWARM_PEERS'
    /debug/kvtier inventories (up to ELASTIC_PREWARM_PAGES pages; `peers`
    is empty unless a kv_cold_store was given), then starts the engine and moves to ``serving`` with ``warm_boot_s``. Where
    the reference warms a running engine, the port's captures run before
    the loop starts (a capture must not share the stream with dispatches);
    a request submitted meanwhile waits in the queue."""

    def boot() -> None:
        from .tpu.migrate import prewarm_from_peers

        t0 = time.monotonic()
        warmed = 0
        try:
            _warm(engine, warm, score, log)
            if peers:
                warmed = prewarm_from_peers(engine, peers,
                                            limit=prewarm_pages, logger=log)
        except Exception as exc:  # noqa: BLE001 - serving cold beats never
            log.errorf("warm boot: %s", exc)
        engine.prewarmed_pages = warmed
        if engine.lifecycle.state == "draining":
            return   # shut down while warming: nothing to serve
        engine.start()
        engine.warm_boot_s = round(time.monotonic() - t0, 3)
        engine.lifecycle.to("serving")
        log.infof("warm boot: serving after %.1fs (%d pages pre-warmed)",
                  engine.warm_boot_s, warmed)

    engine.prewarmed_pages = 0
    engine.warm_boot_thread = threading.Thread(target=boot, name="warm-boot",
                                               daemon=True)
    engine.warm_boot_thread.start()


def _build_pair(engine, warm: str, kw: dict, params, budget_cfg: int, log,
                n_slots: int, queue_depth: int,
                handoff_timeout_s: float, transport=None) -> None:
    """DISAGG_MODE=both on one card: a prefill twin over the SAME params
    tensors (no second copy of the weights) and the router in front of the
    pair, on ``engine.disagg_router``. Each engine has its own stream,
    program cache, graph pool and generator. The twin's capacity plan is
    sized from what the card has free once the decode engine is built
    (capacity.twin_budget_bytes, less the decode engine's graph pools when
    its captures are still to come); an explicit HBM_BUDGET_BYTES goes to
    both, as in the reference. n_slots (DISAGG_PREFILL_SLOTS, 0: the
    decode engine's) sizes its slots. transport: DISAGG_TRANSPORT=pubsub's
    (None: the in-process queue)."""
    from .models.llama import params_nbytes
    from .tpu.capacity import twin_budget_bytes
    from .tpu.disagg import DisaggRouter, register_disagg_metrics

    prefill_kw = dict(kw, disagg_role="prefill")
    if n_slots:
        prefill_kw["n_slots"] = n_slots
    if budget_cfg == 0:
        budget = twin_budget_bytes(engine.device, params_nbytes(params))
        if budget and not engine.graph_pool_bytes and engine.plan is not None:
            budget -= engine.plan.graph_pool_bytes
        prefill_kw["budget_bytes"] = budget or None
    prefill = PagedLLMEngine(params, engine.cfg, **prefill_kw)
    prefill.tokenizer = engine.tokenizer
    prefill.container = engine.container
    prefill.warmup_seconds = prefill.score_warmup_seconds = 0.0
    if warm != "false":
        t0 = time.monotonic()
        prefill.warmup(k_variants=warm == "wide")
        prefill.warmup_seconds = time.monotonic() - t0
        log.infof("prefill pool warmed up in %.1fs", prefill.warmup_seconds)
    prefill.start()
    metrics = engine.container.metrics_manager
    router = DisaggRouter(prefill, engine, metrics=metrics,
                          transport=transport, queue_depth=queue_depth,
                          handoff_timeout_s=handoff_timeout_s)
    if metrics is not None:
        register_disagg_metrics(metrics)
    router.start()
    engine.disagg_router = router


def app_for(env: EnvLike, engine=None, device=None,
            default_sampling_controls: bool = False) -> App:
    """The App of a server and its engine, on ``app.engine``: a built
    engine shares its container with the App (its metrics, tracer and
    logger); else the engine is built on the App's container. The engine's
    health joins the App's aggregate, and the App's shutdown drains it
    (DRAIN_TIMEOUT: the active streams finish, queued and new requests get
    503), then stops it. env: a Config, a mapping, or None (the App reads
    .env files under GOFR_CONFIGS_DIR, the process environment over
    them). The observability planes are enabled here, for both servers, as
    the reference's build_app does, and the QoS plane under QOS=true (the
    module docstring); the stall gauge is refreshed at every scrape."""
    if engine is not None and getattr(engine, "container", None) is not None:
        app = App(config=env, container=engine.container)
    else:
        app = App(config=env, device=device)
    if engine is None:
        engine = build_engine(
            app.config, device=device, container=app.container,
            default_sampling_controls=default_sampling_controls)
    app.engine = engine
    app.add_health_contributor("engine", engine.health_check)
    metrics = app.container.metrics_manager
    if metrics is not None:
        register_metrics(metrics)
        # a wedged loop cannot push its own gauge: the scrape pulls it
        app.container.add_scrape_hook("engine_stall", lambda: metrics.set_gauge(
            "app_tpu_engine_stall_seconds", round(engine.stall_seconds, 1)))
    drain_s = _float(app.config, "DRAIN_TIMEOUT", 30.0)
    plane = getattr(engine, "_plane", None)
    if plane is not None and plane.is_leader:
        # the hooks run last in, first out: this one after the engine's
        # stop, whose stop sentinel the followers exit on
        app.on_shutdown(lambda: end_job(
            engine, getattr(engine, "followers", ())))
    app.on_shutdown(lambda: (engine.drain(drain_s), engine.stop()))
    config = app.config
    if _flag(config, "FLIGHT_RECORDER", True):
        recorder = app.enable_flight_recorder(engine)
        app.enable_journey(engine)
        if _flag(config, "FLIGHT_TRACE_EXPORT", True):
            from .loadgen.capture import install_recorder_trace_route

            install_recorder_trace_route(app, recorder)
    if _flag(config, "ENGINE_SNAPSHOT", True):
        app.enable_engine_snapshot(engine)
    if _flag(config, "STEP_LEDGER", True):
        app.enable_step_ledger(engine)
    if _flag(config, "TIMELINE", True):
        app.enable_timeline(engine)
    if _flag(config, "HOSTPROF", True):
        app.enable_hostprof(engine)
    if _flag(config, "INCIDENT_AUTOPSY", True):
        burn, _ = app.enable_incident_autopsy(engine)
        # harnesses re-target the SLOs through it, as the reference's
        app.slo_burn = burn
    # 404 unless FAULT_INJECTION=true
    app.enable_fault_injection(engine)
    # opt-in, as in the reference: the ladder acts on the burn engine above
    if _flag(config, "QOS", False):
        app.enable_qos(engine)
    if _flag(config, "CAPACITY", True):
        app.enable_capacity(engine)
    # the disaggregated pair (DISAGG_MODE=both): the router is the front
    # door (app.submitter) and reports at GET /debug/disagg; the prefill
    # pool's health joins the aggregate and the shutdown stops it first
    router = getattr(engine, "disagg_router", None)
    app.submitter = router if router is not None else engine
    if router is not None:
        from .tpu.disagg import install_routes as install_disagg_routes

        install_disagg_routes(app, router)
        prefill = router.prefill_engine
        app.add_health_contributor("prefill_engine", prefill.health_check)
        app.on_shutdown(lambda: (router.stop(), prefill.drain(drain_s),
                                 prefill.stop()))
    # the lifecycle in /stats and, unless DRAIN_MIGRATE=false, POST
    # /migrate, POST|GET /debug/drain and GET /debug/kvtier
    app.enable_drain_migration(engine)
    return app


def build_generate_service(submitter, tokenizer):
    """gRPC ``llm.Generator/Generate``, the server-streaming twin of SSE
    /generate (the reference's ``build_generate_service``): the same
    parameters through `submitter` (the engine or the pair's router), one
    {"text"} message per decoded chunk that has text, then the {"done":
    true, "tokens", "tok_per_s"} summary, the payloads the SSE stream
    sends; the request is cancelled when the stream ends, a client's
    cancel included, so its slot and pages come back."""
    from .grpcx import GenericService

    def grpc_generate(ctx):
        body = ctx.request.payload or {}
        if not isinstance(body, dict):
            raise ValueError("the request must be a JSON object")
        prompt = body.get("prompt")
        if not isinstance(prompt, str) or not prompt:
            raise ValueError("prompt must be a non-empty string")
        request = submitter.submit(
            tokenizer.encode(prompt),
            max_new_tokens=int(body.get("max_tokens", 64)),
            temperature=float(body.get("temperature", 0.0)),
            stop_tokens={tokenizer.EOS},
            min_tokens=max(0, int(body.get("min_tokens", 0) or 0)),
            priority=max(0, min(9, int(body.get("priority", 0) or 0))),
            top_p=float(body.get("top_p", 0.0) or 0.0),
            top_k=int(body.get("top_k", 0) or 0))

        def stream():
            decoder = StreamingDecoder(tokenizer)
            count = 0
            start = time.monotonic()
            try:
                for token in request.stream():
                    count += 1
                    text = decoder.push(token)
                    if text:
                        yield {"text": text}
                tail = decoder.flush()
                if tail:
                    yield {"text": tail}
                yield {"done": True, "tokens": count,
                       "tok_per_s": round(
                           count / max(time.monotonic() - start, 1e-6), 1)}
            finally:
                request.cancel()   # a client's cancel frees the slot

        return stream()

    return GenericService("llm.Generator", {},
                          stream_methods={"Generate": grpc_generate})


def build_app(env: EnvLike = None, engine=None, device=None) -> App:
    """App + engine + routes; the engine rides on ``app.engine``. Pass a
    built engine to wrap it in the serving surface."""
    app = app_for(env, engine, device)
    engine = app.engine
    submitter = app.submitter   # the engine, or the pair's router
    tokenizer = engine.tokenizer
    # token streaming over gRPC rides the same submitter (GRPC_PORT)
    app.register_grpc_service(build_generate_service(submitter, tokenizer))
    # the /stats fleet digest of the prefixes this replica served, with a
    # per-boot generation id
    affinity = AffinityRecorder(
        block=_int(app.config, "FLEET_AFFINITY_BLOCK", 256))
    app.fleet_affinity = affinity

    @app.post("/generate")
    def generate(ctx):
        if engine.lifecycle.state == "draining":
            # new sessions belong on a peer; streams in flight go on
            raise ServiceUnavailable("replica is draining",
                                     retry_after_s=1.0)
        body = ctx.bind()
        if not isinstance(body, dict):
            raise InvalidParam(["body"])
        prompt = body.get("prompt")
        if not isinstance(prompt, str) or not prompt:
            raise InvalidParam(["prompt"])
        try:
            max_tokens = int(body.get("max_tokens", 64))
            temperature = float(body.get("temperature", 0.0))
            # lower admits first; clamp so no client can outrank the range
            priority = max(0, min(9, int(body.get("priority", 0))))
            # EOS is ignored until this floor is reached
            min_tokens = max(0, int(body.get("min_tokens", 0) or 0))
            # per-request truncation (needs SAMPLING_CONTROLS=true; the
            # engine refuses it otherwise, a 400 below)
            top_p = float(body.get("top_p", 0.0) or 0.0)
            top_k = int(body.get("top_k", 0) or 0)
        except (TypeError, ValueError) as exc:
            raise InvalidParam(["max_tokens", "temperature", "priority",
                                "min_tokens", "top_p", "top_k"]) from exc
        # the class and the tenant: the header wins over the body; an
        # unknown class is submit's 400, never a silent default
        qos_class = (ctx.request.header("X-QoS-Class")
                     or body.get("class") or None)
        tenant = str(ctx.request.header("X-Tenant")
                     or body.get("tenant") or "")
        stream = bool(body.get("stream", True))
        try:
            request = submitter.submit(
                tokenizer.encode(prompt), max_new_tokens=max_tokens,
                temperature=temperature, stop_tokens={tokenizer.EOS},
                priority=priority, min_tokens=min_tokens, top_p=top_p,
                top_k=top_k, span=ctx.span,
                traceparent=ctx.request.traceparent, qos_class=qos_class,
                tenant=tenant)
        except InvalidParam:
            raise
        except ValueError as exc:
            raise InvalidParam([str(exc)]) from exc
        except Exception as exc:  # noqa: BLE001 - sheds: 503 + Retry-After
            if not is_shed(exc):
                raise
            raise shed_to_503(exc) from exc
        affinity.record(prompt)   # admitted: its prefix now lives here

        if not stream:
            start = time.monotonic()
            try:
                tokens = request.result(timeout_s=ctx.remaining())
            except TimeoutError as exc:   # slot already freed by result()
                raise RequestTimeout() from exc
            except Exception as exc:  # noqa: BLE001 - failed in the queue
                if not is_shed(exc):   # by a drain or its deadline
                    raise
                raise shed_to_503(exc) from exc
            return {"text": tokenizer.decode(tokens), "tokens": len(tokens),
                    "seconds": round(time.monotonic() - start, 3)}

        def chunks():
            decoder = StreamingDecoder(tokenizer)
            count = 0
            start = time.monotonic()
            for token in request.stream():
                count += 1
                # one SSE event per TOKEN, even when the decoder buffers:
                # the client's first event marks the first token
                yield {"text": decoder.push(token)}
            tail = decoder.flush()
            if tail:
                yield {"text": tail}
            yield {"done": True, "tokens": count,
                   "tok_per_s": round(count / max(time.monotonic() - start,
                                                  1e-6), 1)}

        return Stream(chunks(), sse=True, on_close=request.cancel)

    @app.get("/stats")
    def stats(ctx):
        out = {
            "active_slots": sum(1 for s in engine.slots if s.active),
            "queue_depth": engine._pending.qsize(),
            "compiled_programs": engine.executor.cache_size(),
            "stall_seconds": round(engine.stall_seconds, 1),
        }
        if engine.speculative_tokens:
            out["spec"] = {
                "accept_ema": round(engine._spec_accept_ema, 3),
                "cooloff_dispatches": engine._spec_cooloff,
            }
        allocator = getattr(engine, "allocator", None)
        if allocator is not None:
            out["pages"] = {"used": allocator.used_pages,
                            "free": allocator.free_pages,
                            "page_size": allocator.page_size}
        prefix = getattr(engine, "prefix", None)
        if prefix is not None:
            out["prefix_cache"] = prefix.stats()
        kv_tier = getattr(engine, "kv_tier", None)
        if kv_tier is not None:
            tier = kv_tier.stats()
            tier["spilled_pages"] = engine._kv_spilled
            tier["restored_pages"] = engine._kv_restored
            out["kv_tier"] = tier
        recorder = getattr(engine, "recorder", None)
        if recorder is not None:
            out["slo"] = recorder.slo_stats()
        # the cheap fleet probe: an O(k) affinity digest and the duty
        # cycle, not the page-pool dump of /debug/engine
        fleet = {"affinity": affinity.digest(),
                 "lifecycle": engine.lifecycle.state}
        warm_boot_s = getattr(engine, "warm_boot_s", None)
        if warm_boot_s is not None:
            fleet["warm_boot_s"] = warm_boot_s
        qos_ctl = getattr(engine, "qos", None)
        if qos_ctl is not None:
            # the ladder's request_replica rung, for the fleet's autoscaler
            fleet["qos"] = {"scaleout_wanted": qos_ctl.scaleout_wanted}
        util = getattr(engine, "util", None)
        if util is not None:
            fleet["duty_cycle"] = util.window_stats()["duty_cycle"]
        out["fleet"] = fleet
        return out

    return app


def main() -> None:
    """Serve; a follower rank of an operator-launched TP job (JAX_PROCESS_ID
    > 0) serves no HTTP and follows rank 0's waves instead."""
    app = build_app()
    plane = app.engine._plane
    if plane is not None and not plane.is_leader:
        follow(app.engine)
        return
    app.run()


if __name__ == "__main__":
    main()

"""LLM serving over the port: continuous batching + SSE streaming.

Counterpart of ``examples/llm-server/main.py``: ``build_engine`` reads the
same config keys the slice supports, and ``POST /generate`` takes the same
body and sends the same events.

    POST /generate {"prompt": "...", "max_tokens": 64, "temperature": 0.7,
    "stream": true} -> server-sent events, one {"text": ...} per token, then
    {"done": true, "tokens": N, "tok_per_s": x}. stream=false returns one
    JSON response {"text", "tokens", "seconds"}. The fields this port does
    not serve yet are refused with 400 where the reference refuses them with
    sampling controls and QoS off: top_p / top_k > 0 (ROADMAP A9), top_p
    outside [0, 1], top_k < 0, non-numeric values, and a QoS class (the
    X-QoS-Class header, else the body's "class") that is not one of
    QOS_CLASSES; a known class changes nothing.

Run: ``python -m gofr_tpu_torch.serve`` (config from the environment).
Keys: MODEL_PRESET (debug | llama1b | llama3-8b | llama3-70b, default
debug), ATTN_IMPL (flash | xla, default flash), PAGED (true: the paged
engine; false: the dense-cache engine), DECODE_ATTN (xla | kernel, the
dense engine's T=1 read), KV_DTYPE (unset | int8; the dense engine needs
DECODE_ATTN=kernel for int8), PAGE_SIZE (128), N_PAGES (0 = every slot can
reach MAX_SEQ_LEN), MAX_BATCH (8), MAX_SEQ_LEN (1024), PREFILL_BUCKETS
("16,32,64,128,256"), HTTP_PORT (8000), REQUEST_TIMEOUT (5 s, for
stream=false). Weights are random, from seed 0. Keys whose feature is not
ported yet refuse to boot (NOT_PORTED below) rather than being ignored.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Mapping, Optional

from .app import App, Stream
from .http.errors import InvalidParam, RequestTimeout, ServiceUnavailable
from .models.llama import LlamaConfig, llama_init
from .models.tokenizer import ByteTokenizer, DebugTokenizer, StreamingDecoder
from .tpu.device import resolve_device
from .tpu.engine import LLMEngine
from .tpu.paging import PagedLLMEngine

PRESETS = {
    "debug": LlamaConfig.debug,
    "llama1b": LlamaConfig.llama1b,
    "llama3-8b": LlamaConfig.llama3_8b,
    "llama3-70b": LlamaConfig.llama3_70b,
}

_FALSE = ("0", "false", "no", "off", "")


def _flag(env: Mapping[str, str], key: str, default: bool) -> bool:
    value = env.get(key)
    if value is None:
        return default
    return value.strip().lower() not in _FALSE


def _int(env: Mapping[str, str], key: str, default: int) -> int:
    value = env.get(key)
    return default if value in (None, "") else int(value)


# (key, predicate on the config that asks for the feature, what waits and
# where). Checked at boot: a key that asks for an unported feature fails
# loudly instead of being served without it.
NOT_PORTED = (
    ("PREFIX_CACHE", lambda e: _flag(e, "PREFIX_CACHE", False),
     "the prefix cache waits in ROADMAP A7"),
    ("SAMPLING_CONTROLS", lambda e: _flag(e, "SAMPLING_CONTROLS", False),
     "per-request top_p/top_k controls wait in ROADMAP A9"),
    ("CHUNK_PREFILL_TOKENS", lambda e: _int(e, "CHUNK_PREFILL_TOKENS", 0) > 0,
     "chunked prefill waits in ROADMAP A10"),
    ("SPECULATIVE_TOKENS", lambda e: _int(e, "SPECULATIVE_TOKENS", 0) > 0,
     "speculative decoding waits in ROADMAP A10"),
    ("DISAGG_MODE", lambda e: e.get("DISAGG_MODE", "off").lower() != "off",
     "disaggregated prefill/decode waits in ROADMAP A11"),
    ("KV_HOST_TIER_BYTES", lambda e: _int(e, "KV_HOST_TIER_BYTES", 0) > 0,
     "the host KV tier waits in ROADMAP A11"),
    ("QOS", lambda e: _flag(e, "QOS", False),
     "the QoS serving plane waits in ROADMAP A11"),
    ("WEIGHTS_PATH", lambda e: bool(e.get("WEIGHTS_PATH")),
     "checkpoint loading waits in ROADMAP A13"),
    ("WEIGHT_DTYPE", lambda e: bool(e.get("WEIGHT_DTYPE")),
     "int8 weights wait in ROADMAP A13"),
    ("VOCAB_PATH", lambda e: bool(e.get("VOCAB_PATH")),
     "the BPE tokenizers wait in ROADMAP A13"),
    ("TP_SHARDS", lambda e: _int(e, "TP_SHARDS", 1) > 1,
     "tensor-parallel serving waits in ROADMAP A14"),
)


# the reference's request classes (gofr_tpu/tpu/qos.py CLASSES); with QoS
# off a known class is accepted and changes nothing
QOS_CLASSES = ("interactive", "standard", "batch")


def check_qos_class(value) -> None:
    """Raise InvalidParam unless `value` (header, else body) is empty or
    names one of QOS_CLASSES, case and surrounding blanks aside."""
    if value is None or (isinstance(value, str)
                         and value.strip().lower() in ("", *QOS_CLASSES)):
        return
    raise InvalidParam([f"class must be one of {', '.join(QOS_CLASSES)} "
                        f"(got {value!r})"])


def check_sampling_controls(top_p: float, top_k: int) -> None:
    """Raise InvalidParam for per-request top_p / top_k: out of range, or
    set at all (the port has no sampling controls yet)."""
    if not 0.0 <= top_p <= 1.0:
        raise InvalidParam([f"top_p must be in [0, 1], got {top_p}"])
    if top_k < 0:
        raise InvalidParam([f"top_k must be >= 0, got {top_k}"])
    if top_p or top_k:
        raise InvalidParam(["per-request top_p/top_k are not served by "
                            "gofr_tpu_torch yet: sampling controls wait in "
                            "ROADMAP A9"])


def check_config(env: Mapping[str, str]) -> None:
    """Raise ValueError naming the ROADMAP item of the first config key that
    asks for a feature the port does not have yet."""
    for key, asks, where in NOT_PORTED:
        if asks(env):
            raise ValueError(f"{key}={env.get(key)!r} is not supported by "
                             f"gofr_tpu_torch yet: {where}")


def build_engine(env: Optional[Mapping[str, str]] = None, device=None,
                 params=None) -> LLMEngine:
    """Engine from config keys (see the module docstring), started. device:
    None = the CUDA card (raises without one); "cpu" for tests. params: an
    already-built params dict for the preset (default: llama_init, seed 0).
    On the card the kernels are built here, at boot, so no request pays the
    compiler."""
    env = dict(env or {})
    check_config(env)
    dev = resolve_device(device)
    preset = env.get("MODEL_PRESET", "debug")
    if preset not in PRESETS:
        raise ValueError(f"MODEL_PRESET must be one of {sorted(PRESETS)}, "
                         f"got {preset!r}")
    attn_impl = env.get("ATTN_IMPL", "flash")
    decode_attn = env.get("DECODE_ATTN", "xla")
    kv_dtype = env.get("KV_DTYPE", "") or None
    if attn_impl not in ("xla", "flash"):
        raise ValueError(f"ATTN_IMPL must be xla|flash, got {attn_impl!r}")
    if decode_attn not in ("xla", "kernel"):
        raise ValueError(f"DECODE_ATTN must be xla|kernel, got "
                         f"{decode_attn!r}")
    if kv_dtype not in (None, "int8"):
        raise ValueError(f"KV_DTYPE must be int8 or unset, got {kv_dtype!r}")
    cfg = dataclasses.replace(PRESETS[preset](), attn_impl=attn_impl,
                              decode_attn=decode_attn, kv_dtype=kv_dtype)
    if dev.type == "cuda":
        from .ops import _build

        _build.build(*_build.KERNELS)
    if params is None:
        params = llama_init(cfg, seed=0, device=dev)
    kw = dict(device=dev, n_slots=_int(env, "MAX_BATCH", 8),
              max_seq_len=_int(env, "MAX_SEQ_LEN", 1024),
              prefill_buckets=tuple(int(b) for b in env.get(
                  "PREFILL_BUCKETS", "16,32,64,128,256").split(",")))
    if _flag(env, "PAGED", True):
        engine = PagedLLMEngine(params, cfg,
                                page_size=_int(env, "PAGE_SIZE", 128),
                                n_pages=_int(env, "N_PAGES", 0) or None, **kw)
    else:
        engine = LLMEngine(params, cfg, **kw)
    # synthetic vocabularies sample ids the byte tokenizer cannot
    # round-trip; DebugTokenizer decodes every id to one char
    engine.tokenizer = (DebugTokenizer(cfg.vocab_size)
                        if cfg.vocab_size > ByteTokenizer.vocab_size
                        else ByteTokenizer())
    engine.start()
    return engine


def build_app(env: Optional[Mapping[str, str]] = None, engine=None,
              device=None) -> App:
    """App + engine + routes; the engine rides on ``app.engine``. Pass a
    built engine to wrap it in the serving surface."""
    env = dict(env or {})
    app = App(config=env)
    if engine is None:
        engine = build_engine(env, device=device)
    app.engine = engine
    tokenizer = engine.tokenizer
    app.add_health_contributor("engine", engine.health_check)
    app.on_shutdown(engine.stop)

    @app.post("/generate")
    def generate(ctx):
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
            top_p = float(body.get("top_p", 0.0) or 0.0)
            top_k = int(body.get("top_k", 0) or 0)
        except (TypeError, ValueError) as exc:
            raise InvalidParam(["max_tokens", "temperature", "priority",
                                "min_tokens", "top_p", "top_k"]) from exc
        check_sampling_controls(top_p, top_k)
        check_qos_class(ctx.request.headers.get("x-qos-class")
                        or body.get("class") or None)
        stream = bool(body.get("stream", True))
        try:
            request = engine.submit(
                tokenizer.encode(prompt), max_new_tokens=max_tokens,
                temperature=temperature, stop_tokens={tokenizer.EOS},
                priority=priority, min_tokens=min_tokens)
        except ValueError as exc:
            raise InvalidParam([str(exc)]) from exc
        except RuntimeError as exc:   # engine stopped
            raise ServiceUnavailable(str(exc), retry_after_s=1.0) from exc

        if not stream:
            start = time.monotonic()
            try:
                tokens = request.result(timeout_s=ctx.remaining())
            except TimeoutError as exc:   # slot already freed by result()
                raise RequestTimeout() from exc
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

    return app


def main() -> None:
    build_app(os.environ).run()


if __name__ == "__main__":
    main()

"""OpenAI-compatible serving surface over the port's continuous-batching engine.

Counterpart of ``examples/openai-server/main.py``: the same routes, bodies,
answers and status codes.

  GET  /v1/models             -> the model listing (MODEL_PRESET's id)
  POST /v1/completions        -> text completion (+SSE streaming)
  POST /v1/chat/completions   -> chat completion (+SSE streaming)
  POST /v1/embeddings         -> L2-normalized sequence embeddings

Streaming responses emit ``data: {json}`` SSE chunks and end with
``data: [DONE]``, so an OpenAI SDK can point its base_url here. The engine
is the llm-server's (``serve.build_engine``, every key of serve.PORTED,
NOT_PORTED and INERT read the same way), with SAMPLING_CONTROLS on unless
the config turns it off: an OpenAI client's top_p is served, never dropped.
GRPC_PORT binds nothing here: the OpenAI server registers no gRPC service,
as the reference's does not (the llm-server's ``llm.Generator`` is
serve.py's).

Ported from the reference's ``build_app``: ``_render_chat``; ``_params``
with its refusals of non-default unsupported parameters
(``_UNSUPPORTED_NONDEFAULT``: penalties, logit_bias, best_of > 1, suffix)
and its checks of max_tokens, temperature, top_p (0, 1], top_k >= 0,
min_tokens 0..max_tokens and stop; ``_encode_checked`` (a prompt past the
engine's admission_limit is a 400, never a truncation); stop strings
(matched at or past the text of the first min_tokens tokens, and, when a
stream ends before min_tokens arrive, not at all), and the streaming
hold-back of len(longest stop) - 1 characters; n > 1 fanned out as n
requests of one prompt (any failure cancels every sibling; refused with
stream and with temperature 0); logprobs through ``engine.score`` (0..5
on completions, top_logprobs 0..20 on chat, refused with stream, refused
at admission past the largest scoring bucket by ``_check_scoreable``,
clipped to the returned text by ``_tokens_for_text``, with the
reference's ``text_offset`` accounting); ``conversation_id`` checked for
its type and pinning the conversation's trunk in the host KV tier for
CONVERSATION_PIN_S (a no-op without KV_HOST_TIER_BYTES, as in the
reference); a draining engine answers
503 with Retry-After (a stopped one too, as on /generate, where the
reference answers 500). Each request's span and traceparent reach
``engine.submit``, so its ``tpu.generate`` span joins the caller's trace.

The QoS class and tenant come from the X-QoS-Class and X-Tenant headers
(the OpenAI bodies have no field for them) and go into submit, QoS on or
off, as the reference's do: an unknown class is a 400, a ladder shed or a
deadline's expiry a 503 with Retry-After. ``GET /stats`` is the
reference's: active_slots, queue_depth, stall_seconds and fleet
{lifecycle, qos {scaleout_wanted} (under QOS), duty_cycle}. The
observability planes (flight recorder, journey, /debug/trace, engine
snapshot, step ledger, timeline, host profiler, the incident plane's
/debug/slo and /debug/incidents, /debug/capacity and, under
FAULT_INJECTION=true, /debug/faults), the QoS plane under QOS=true
(/debug/qos) and crash-only serving (replay after a reset, the reset-storm
breaker: a 503 with Retry-After while it is open) are ``serve.app_for``'s
and ``serve.build_engine``'s, under the same keys, and so are the KV
tier, the disaggregated pair (DISAGG_MODE=both: requests go through the
router, GET /debug/disagg) and the elastic surface (POST /migrate, POST|GET
/debug/drain, GET /debug/kvtier, the warm boot).

Run: ``python -m gofr_tpu_torch.serve_openai`` (config from .env files
under GOFR_CONFIGS_DIR and the process environment; ``device="cpu"`` only
through ``build_app``).
"""

from __future__ import annotations

import base64
import time
import uuid

from .app import App, Stream
from .http.errors import InvalidParam, RequestTimeout
from .http.responder import Raw
from .models.tokenizer import StreamingDecoder
from .serve import EnvLike, app_for, is_shed, shed_to_503


def _render_chat(messages) -> str:
    """Minimal chat template: role-tagged turns + assistant cue. A real
    deployment swaps this for the model family's template."""
    lines = [f"{m.get('role', 'user')}: {m.get('content', '')}"
             for m in messages]
    lines.append("assistant:")
    return "\n".join(lines)


# parameters this surface cannot honor are refused (400), never silently
# ignored; their no-op defaults (0 penalties, empty logit_bias, best_of=1)
# pass, since SDKs send them unprompted
_UNSUPPORTED_NONDEFAULT = (
    ("presence_penalty", lambda v: float(v) != 0.0),
    ("frequency_penalty", lambda v: float(v) != 0.0),
    ("logit_bias", lambda v: bool(v)),
    ("best_of", lambda v: int(v) > 1),
    ("suffix", lambda v: bool(v)),
)


def build_app(env: EnvLike = None, engine=None, device=None) -> App:
    """The App with the OpenAI routes, on ``app.engine``. env: a Config, a
    mapping, or None (.env files under GOFR_CONFIGS_DIR and the process
    environment). engine: a built engine to serve (its container becomes
    the App's), else one is built with SAMPLING_CONTROLS on by default.
    device: None = the CUDA card (raises without one); "cpu" for tests."""
    app = app_for(env, engine, device, default_sampling_controls=True)
    engine = app.engine
    submitter = app.submitter   # the engine, or the pair's router
    tokenizer = engine.tokenizer
    model_id = app.config.get_or_default("MODEL_PRESET", "debug")

    def _params(body: dict):
        """Parse and check the shared generation params (a bad type is a
        400, not a 500)."""
        for name, is_nondefault in _UNSUPPORTED_NONDEFAULT:
            if name in body:
                try:
                    nondefault = is_nondefault(body[name])
                except (TypeError, ValueError) as exc:
                    raise InvalidParam([name]) from exc
                if nondefault:
                    raise InvalidParam(
                        [f"{name} is not supported by this server"])
        try:
            max_tokens = int(body.get("max_tokens", 16))
            temperature = float(body.get("temperature", 1.0))
            # top_p=1.0 is the OpenAI default (no truncation); top_k is the
            # common extension (0 disables)
            top_p = float(body.get("top_p", 1.0))
            top_k = int(body.get("top_k", 0))
            # stop conditions are suppressed until this many tokens
            min_tokens = int(body.get("min_tokens", 0))
        except (TypeError, ValueError) as exc:
            raise InvalidParam(["max_tokens", "temperature", "top_p",
                                "top_k", "min_tokens"]) from exc
        if max_tokens < 1:
            raise InvalidParam(["max_tokens"])
        if not 0.0 < top_p <= 1.0:
            raise InvalidParam(["top_p must be in (0, 1]"])
        if top_k < 0:
            raise InvalidParam(["top_k must be >= 0"])
        if top_p >= 1.0:
            top_p = 0.0                       # 1.0 == keep everything
        if (top_p or top_k) and not engine.sampling_controls:
            raise InvalidParam(
                ["top_p/top_k need SAMPLING_CONTROLS=true on this server"])
        if not 0 <= min_tokens <= max_tokens:
            raise InvalidParam(["min_tokens must be 0..max_tokens"])
        stop = body.get("stop") or []
        if isinstance(stop, str):
            stop = [stop]
        if not all(isinstance(s, str) for s in stop):
            raise InvalidParam(["stop"])
        return max_tokens, temperature, stop, min_tokens, top_p, top_k

    def _encode_checked(prompt: str):
        prompt_tokens = tokenizer.encode(prompt)
        if len(prompt_tokens) > engine.admission_limit:
            # context_length_exceeded is a 400, never a silent truncation
            raise InvalidParam(
                [f"prompt: {len(prompt_tokens)} tokens exceeds the model "
                 f"context limit ({engine.admission_limit})"])
        return prompt_tokens

    def _submit_tokens(prompt_tokens, max_tokens: int, temperature: float,
                       min_tokens: int = 0, top_p: float = 0.0,
                       top_k: int = 0, ctx=None):
        # ctx threads the caller's trace context to the engine: the
        # request's tpu.generate span shares the inbound trace id. The QoS
        # class and tenant come from the headers; an unknown class is
        # submit's 400
        qos_class = (ctx.request.header("X-QoS-Class") or None
                     if ctx is not None else None)
        tenant = (str(ctx.request.header("X-Tenant") or "")
                  if ctx is not None else "")
        try:
            return submitter.submit(
                prompt_tokens, max_new_tokens=max_tokens,
                temperature=temperature, stop_tokens={tokenizer.EOS},
                span=ctx.span if ctx is not None else None,
                traceparent=(ctx.request.traceparent
                             if ctx is not None else None),
                min_tokens=min_tokens, top_p=top_p, top_k=top_k,
                qos_class=qos_class, tenant=tenant)
        except Exception as exc:  # noqa: BLE001 - sheds: 503 + Retry-After
            if not is_shed(exc):
                raise
            raise shed_to_503(exc) from exc

    def _finish_reason(n_emitted: int, max_tokens: int) -> str:
        return "length" if n_emitted >= max_tokens else "stop"

    def _apply_stops(text: str, n_tokens: int, max_tokens: int, stop_strs,
                     floor_chars: int = 0):
        """Stop strings match only at offsets >= floor_chars: the text of
        the first min_tokens tokens is immune, as the engine's min_tokens
        rule is for stop token ids."""
        finish = _finish_reason(n_tokens, max_tokens)
        for s in stop_strs:
            idx = text.find(s, floor_chars)
            if idx >= 0:
                text = text[:idx]
                finish = "stop"
        return text, finish

    def _floor_chars(tokens, min_tokens: int) -> int:
        if min_tokens <= 0 or not tokens:
            return 0
        return len(tokenizer.decode(tokens[:min_tokens]))

    def _parse_logprobs(body: dict, chat: bool):
        """None (off) or the number of top alternatives to attach (0 = the
        chosen token only). completions: `logprobs: 0..5`; chat:
        `logprobs: true` + `top_logprobs: 0..20`. Served by the
        teacher-forced scoring pass (engine.score) after generation."""
        if chat:
            flag = body.get("logprobs")
            if flag in (None, False):
                if body.get("top_logprobs"):
                    raise InvalidParam(["top_logprobs requires logprobs=true"])
                return None
            if flag is not True:
                raise InvalidParam(["logprobs"])
            try:
                n = int(body.get("top_logprobs", 0) or 0)
            except (TypeError, ValueError) as exc:
                raise InvalidParam(["top_logprobs"]) from exc
            if not 0 <= n <= 20:
                raise InvalidParam(["top_logprobs must be 0..20"])
            return n
        if body.get("top_logprobs"):
            raise InvalidParam(["top_logprobs is a chat parameter; "
                                "completions take logprobs=0..5"])
        v = body.get("logprobs")
        if v is None:
            return None
        if isinstance(v, bool):
            # chat-style true/false on the completions surface: a 400, not
            # a coercion to 0/1
            raise InvalidParam(["logprobs must be an integer 0..5"])
        try:
            n = int(v)
        except (TypeError, ValueError) as exc:
            raise InvalidParam(["logprobs"]) from exc
        if not 0 <= n <= 5:
            raise InvalidParam(["logprobs must be 0..5"])
        return n

    def _check_scoreable(prompt_len: int, max_tokens: int) -> None:
        """Refuse an unscoreable logprobs request at admission: generation
        can run past the largest scoring bucket, and finding that after
        the whole generation would be a 500 instead of this 400."""
        cap = engine.prefill_buckets[-1]
        if prompt_len + max_tokens > cap:
            raise InvalidParam(
                [f"logprobs supports prompt+max_tokens up to {cap} "
                 f"tokens on this server"])

    def _token_bytes(token_id: int) -> bytes:
        tb = getattr(tokenizer, "decode_token_bytes", None)
        if tb is not None:
            return tb(token_id)
        return tokenizer.decode_token(token_id).encode("utf-8", "ignore")

    def _tokens_for_text(tokens, text: str):
        """The largest token prefix whose decoded pieces fit the (possibly
        stop-truncated) returned text: logprobs describe the text the
        client received. Counted in characters of the pieces, as the
        reference does (a multibyte character split across tokens can
        misalign it)."""
        out, acc = [], 0
        for t in tokens:
            piece = tokenizer.decode_token(int(t))
            if acc + len(piece) > len(text):
                break
            acc += len(piece)
            out.append(t)
        return out

    def _logprobs_payload(chat: bool, prompt_toks, tokens, n_top: int,
                          text=None):
        """engine.score's output in the surface's shape; `text` (when
        given) clips the scored tokens to the returned text."""
        if text is not None:
            tokens = _tokens_for_text(tokens, text)
        if not tokens:
            return {"content": []} if chat else {
                "tokens": [], "token_logprobs": [], "top_logprobs": None,
                "text_offset": []}
        chosen, top_ids, top_lps = engine.score(prompt_toks, tokens,
                                                top=max(n_top, 1))
        if chat:
            content = []
            for t, c, irow, lrow in zip(tokens, chosen, top_ids, top_lps):
                entry = {"token": tokenizer.decode_token(int(t)),
                         "logprob": round(float(c), 6),
                         "bytes": list(_token_bytes(int(t)))}
                if n_top:
                    entry["top_logprobs"] = [
                        {"token": tokenizer.decode_token(int(i)),
                         "logprob": round(float(lp), 6),
                         "bytes": list(_token_bytes(int(i)))}
                        for i, lp in zip(irow[:n_top], lrow[:n_top])]
                content.append(entry)
            return {"content": content}
        token_strs = [tokenizer.decode_token(int(t)) for t in tokens]
        offsets, off = [], 0
        for s in token_strs:
            offsets.append(off)
            off += len(s)
        top = None
        if n_top:
            # keyed by decoded string (the completions shape): two ids may
            # decode alike; the first (the most probable) is kept
            top = []
            for irow, lrow in zip(top_ids, top_lps):
                d = {}
                for i, lp in zip(irow[:n_top], lrow[:n_top]):
                    d.setdefault(tokenizer.decode_token(int(i)),
                                 round(float(lp), 6))
                top.append(d)
        return {"tokens": token_strs,
                "token_logprobs": [round(float(c), 6) for c in chosen],
                "top_logprobs": top, "text_offset": offsets}

    def _multi_completion(ctx, chat, prompt, n_choices, max_tokens,
                          temperature, stop_strs, min_tokens, top_p, top_k,
                          lp_n=None):
        """n > 1: the prompt fanned out as n engine requests (they batch in
        the same slots), n choices collected. Encoded once; any failure
        cancels every sibling, so none keeps a slot."""
        prompt_toks = _encode_checked(prompt)
        if lp_n is not None:
            _check_scoreable(len(prompt_toks), max_tokens)
        requests = []
        choices, total_out = [], 0
        try:
            for _ in range(n_choices):
                requests.append(_submit_tokens(prompt_toks, max_tokens,
                                               temperature, min_tokens,
                                               top_p, top_k, ctx=ctx))
            for idx, req in enumerate(requests):
                try:
                    tokens = req.result(timeout_s=ctx.remaining())
                except TimeoutError as exc:
                    raise RequestTimeout() from exc
                total_out += len(tokens)
                text, finish = _apply_stops(tokenizer.decode(tokens),
                                            len(tokens), max_tokens,
                                            stop_strs,
                                            _floor_chars(tokens, min_tokens))
                body = ({"message": {"role": "assistant", "content": text}}
                        if chat else {"text": text})
                lp = (_logprobs_payload(chat, prompt_toks, tokens, lp_n,
                                        text=text)
                      if lp_n is not None else None)
                choices.append(dict(index=idx, finish_reason=finish,
                                    logprobs=lp, **body))
        except BaseException:
            for req in requests:
                req.cancel()
            raise
        rid = (f"chatcmpl-{uuid.uuid4().hex[:24]}" if chat
               else f"cmpl-{uuid.uuid4().hex[:24]}")
        return Raw({
            "id": rid,
            "object": "chat.completion" if chat else "text_completion",
            "created": int(time.time()),
            "model": model_id, "choices": choices,
            "usage": {"prompt_tokens": len(prompt_toks),
                      "completion_tokens": total_out,
                      "total_tokens": len(prompt_toks) + total_out},
        })

    @app.get("/stats")
    def stats(ctx):
        fleet = {"lifecycle": engine.lifecycle.state}
        qos_ctl = getattr(engine, "qos", None)
        if qos_ctl is not None:
            fleet["qos"] = {"scaleout_wanted": qos_ctl.scaleout_wanted}
        util = getattr(engine, "util", None)
        if util is not None:
            fleet["duty_cycle"] = util.window_stats()["duty_cycle"]
        return {
            "active_slots": sum(1 for s in engine.slots if s.active),
            "queue_depth": engine._pending.qsize(),
            "stall_seconds": round(engine.stall_seconds, 1),
            "fleet": fleet,
        }

    @app.get("/v1/models")
    def models(ctx):
        return Raw({"object": "list",
                    "data": [{"id": model_id, "object": "model",
                              "owned_by": "gofr_tpu"}]})

    def _pin_conversation(conversation_id, prompt_toks, out_tokens):
        """Pin a conversation's trunk pages in the host KV tier; a no-op
        without one, and it never fails the response."""
        pin = getattr(engine, "pin_conversation", None)
        if not conversation_id or pin is None:
            return
        try:
            pin(conversation_id, list(prompt_toks) + list(out_tokens))
        except Exception:  # noqa: BLE001 - never fails the response
            pass

    def _completion(ctx, chat: bool):
        body = ctx.bind()
        if not isinstance(body, dict):
            raise InvalidParam(["body"])
        if chat:
            messages = body.get("messages")
            if not isinstance(messages, list) or not messages:
                raise InvalidParam(["messages"])
            prompt = _render_chat(messages)
        else:
            prompt = body.get("prompt")
            if not isinstance(prompt, str) or not prompt:
                raise InvalidParam(["prompt"])
        (max_tokens, temperature, stop_strs, min_tokens, top_p,
         top_k) = _params(body)
        conversation_id = body.get("conversation_id")
        if conversation_id is not None and not isinstance(conversation_id,
                                                          str):
            raise InvalidParam(["conversation_id"])
        lp_n = _parse_logprobs(body, chat)
        if lp_n is not None and body.get("stream"):
            # scoring runs after generation: a stream would have to hold
            # back every chunk
            raise InvalidParam(["logprobs are not supported with "
                                "stream=true on this server"])
        try:
            n_choices = int(body.get("n", 1))
        except (TypeError, ValueError) as exc:
            raise InvalidParam(["n"]) from exc
        if not 1 <= n_choices <= max(1, engine.n_slots):
            raise InvalidParam([f"n must be 1..{engine.n_slots}"])
        if n_choices > 1:
            if body.get("stream"):
                raise InvalidParam(["n: streaming supports n=1"])
            if temperature <= 0.0:
                # greedy is deterministic: n identical choices
                raise InvalidParam(["n > 1 requires temperature > 0"])
            return _multi_completion(ctx, chat, prompt, n_choices,
                                     max_tokens, temperature, stop_strs,
                                     min_tokens, top_p, top_k, lp_n=lp_n)
        prompt_toks = _encode_checked(prompt)
        if lp_n is not None:
            _check_scoreable(len(prompt_toks), max_tokens)
        request = _submit_tokens(prompt_toks, max_tokens, temperature,
                                 min_tokens, top_p, top_k, ctx=ctx)
        created = int(time.time())
        rid = (f"chatcmpl-{uuid.uuid4().hex[:24]}" if chat
               else f"cmpl-{uuid.uuid4().hex[:24]}")
        obj = "chat.completion" if chat else "text_completion"
        chunk_obj = "chat.completion.chunk" if chat else "text_completion"

        def _chunk(text=None, finish=None, role=None):
            if chat:
                delta = {}
                if role:
                    delta["role"] = role
                if text:
                    delta["content"] = text
                choice = {"index": 0, "delta": delta, "finish_reason": finish}
            else:
                choice = {"index": 0, "text": text or "",
                          "finish_reason": finish}
            return {"id": rid, "object": chunk_obj, "created": created,
                    "model": model_id, "choices": [choice]}

        if body.get("stream"):
            def _first_stop(acc: str, start: int) -> int:
                return min((idx for idx in (acc.find(s, start)
                                            for s in stop_strs)
                            if idx >= 0), default=-1)

            def chunks():
                decoder = StreamingDecoder(tokenizer)
                count = 0
                if chat:  # the role announcement chunk of the protocol
                    yield _chunk(role="assistant")
                # a stop string can span tokens: hold back the last
                # len(longest stop) - 1 characters until more text lands
                hold = max((len(s) for s in stop_strs), default=0) - 1
                acc, sent, stopped = "", 0, False
                out_toks = []
                floor_chars = None if min_tokens else 0
                for token in request.stream():
                    count += 1
                    out_toks.append(token)
                    acc += decoder.push(token)
                    if floor_chars is None:
                        if count < min_tokens:
                            continue_scan = False
                        else:
                            floor_chars = len(acc)  # first min_tokens' text
                            continue_scan = True
                    else:
                        continue_scan = True
                    cut = (_first_stop(acc, max(floor_chars or 0,
                                                sent - hold))
                           if continue_scan else -1)
                    if cut >= 0:
                        if cut > sent:
                            yield _chunk(text=acc[sent:cut])
                        request.cancel()
                        stopped = True
                        break
                    safe = len(acc) - max(hold, 0)
                    if safe > sent:
                        yield _chunk(text=acc[sent:safe])
                        sent = safe
                if not stopped:
                    acc += decoder.flush()
                    if floor_chars is None:
                        # the stream ended (cancel, engine failure) before
                        # min_tokens arrived: all of it is inside the floor,
                        # no stop string may cut it
                        floor_chars = len(acc)
                    cut = _first_stop(acc, max(floor_chars or 0,
                                               sent - hold))
                    end = cut if cut >= 0 else len(acc)
                    stopped = cut >= 0
                    if end > sent:
                        yield _chunk(text=acc[sent:end])
                _pin_conversation(conversation_id, prompt_toks, out_toks)
                finish = ("stop" if stopped
                          else _finish_reason(count, max_tokens))
                yield _chunk(finish=finish)
                yield "[DONE]"

            return Stream(chunks(), sse=True, on_close=request.cancel)

        try:
            tokens = request.result(timeout_s=ctx.remaining())
        except TimeoutError as exc:
            raise RequestTimeout() from exc
        _pin_conversation(conversation_id, prompt_toks, tokens)
        text, finish = _apply_stops(tokenizer.decode(tokens), len(tokens),
                                    max_tokens, stop_strs,
                                    _floor_chars(tokens, min_tokens))
        message_or_text = ({"message": {"role": "assistant", "content": text}}
                           if chat else {"text": text})
        lp = (_logprobs_payload(chat, prompt_toks, tokens, lp_n, text=text)
              if lp_n is not None else None)
        return Raw({
            "id": rid, "object": obj, "created": created, "model": model_id,
            "choices": [dict(index=0, finish_reason=finish,
                             logprobs=lp, **message_or_text)],
            "usage": {"prompt_tokens": len(prompt_toks),
                      "completion_tokens": len(tokens),
                      "total_tokens": len(prompt_toks) + len(tokens)},
        })

    @app.post("/v1/completions")
    def completions(ctx):
        return _completion(ctx, chat=False)

    @app.post("/v1/chat/completions")
    def chat_completions(ctx):
        return _completion(ctx, chat=True)

    @app.post("/v1/embeddings")
    def embeddings(ctx):
        """The OpenAI embeddings shape over the served model: the last
        position's final-norm hidden state (engine.embed), L2-normalized.
        `input` is a string or a list of strings; encoding_format float
        (default) or base64 (little-endian float32)."""
        body = ctx.bind()
        if not isinstance(body, dict):
            raise InvalidParam(["body"])
        raw = body.get("input")
        inputs = [raw] if isinstance(raw, str) else raw
        if (not isinstance(inputs, list) or not inputs
                or not all(isinstance(s, str) and s for s in inputs)):
            raise InvalidParam(["input must be a non-empty string or list "
                                "of non-empty strings"])
        if len(inputs) > 256:
            # one forward per item runs on this handler: the batch is bound
            raise InvalidParam(["input supports up to 256 items per "
                                "request on this server"])
        fmt = body.get("encoding_format", "float")
        if fmt not in ("float", "base64"):
            raise InvalidParam(["encoding_format must be float or base64"])
        cap = engine.prefill_buckets[-1]
        # every item is checked before any forward pass runs
        token_lists = []
        for idx, text in enumerate(inputs):
            toks = tokenizer.encode(text)
            if len(toks) > cap:
                raise InvalidParam(
                    [f"input[{idx}]: {len(toks)} tokens exceeds the "
                     f"embedding limit ({cap})"])
            token_lists.append(toks)
        data, total_tokens = [], 0
        for idx, toks in enumerate(token_lists):
            total_tokens += len(toks)
            vec = engine.embed(toks)
            if fmt == "base64":
                emb = base64.b64encode(
                    vec.astype("<f4").tobytes()).decode("ascii")
            else:
                # full float32 precision, as the base64 form carries
                emb = [float(x) for x in vec]
            data.append({"object": "embedding", "index": idx,
                         "embedding": emb})
        return Raw({"object": "list", "data": data, "model": model_id,
                    "usage": {"prompt_tokens": total_tokens,
                              "total_tokens": total_tokens}})

    return app


def main() -> None:
    build_app().run()


if __name__ == "__main__":
    main()

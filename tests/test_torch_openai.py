"""The port's OpenAI server against the reference's.

One module-scoped pair of servers on the CPU, debug preset: the reference
``examples/openai-server/main.py`` (``TPU_PLATFORM=cpu``, ``WARMUP=false``)
and ``gofr_tpu_torch.serve_openai.build_app`` on the reference engine's own
weights, bridged (``params_from_numpy``), with the same engine keys
(4 slots, max_seq_len 64, buckets 16/32, page size 8; sampling controls
on by default in both). The port answers every body of STATUSES with the
reference's status; its greedy completions and chat completions, JSON and
SSE, with and without a stop string and a min_tokens floor, carry the
reference's text, finish_reason and usage; its logprobs carry the same
tokens, their values within 1e-4 (tests/test_torch_score.py's tolerance);
its embeddings, float and base64, are within 1e-4; an n > 1 completion
returns n choices whose engine tokens sum to its usage; a draining engine
answers 503 with Retry-After.
"""

import base64
import http.client
import importlib.util
import json
import pathlib

import jax
import numpy as np
import pytest

from gofr_tpu.config import MockConfig
from gofr_tpu_torch import serve_openai
from gofr_tpu_torch.models.weights import params_from_numpy
from gofr_tpu_torch.serve import build_engine

from _torch_env import INCIDENT_DIR

ROOT = pathlib.Path(__file__).resolve().parents[1]
ENV = {"MODEL_PRESET": "debug", "HTTP_PORT": "0", "METRICS_PORT": "0",
       "GRPC_PORT": "0",
       "MAX_BATCH": "4", "MAX_SEQ_LEN": "64", "PREFILL_BUCKETS": "16,32",
       "PAGE_SIZE": "8", "WARMUP": "false", "REQUEST_TIMEOUT": "120",
       "LOG_LEVEL": "WARN", "INCIDENT_DIR": INCIDENT_DIR}
LP_TOL = 1e-4


@pytest.fixture(scope="module")
def servers():
    """(reference app, port app), both started."""
    spec = importlib.util.spec_from_file_location(
        "example_openai_server_torch_pair",
        ROOT / "examples" / "openai-server" / "main.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    ref = module.build_app(config=MockConfig({**ENV, "TPU_PLATFORM": "cpu"}))
    params = params_from_numpy(jax.device_get(ref.engine.params),
                               device="cpu")
    port = serve_openai.build_app(ENV, engine=build_engine(
        ENV, device="cpu", params=params, default_sampling_controls=True))
    ref.start()
    try:
        port.start()
        try:
            yield ref, port
        finally:
            port.shutdown()
    finally:
        ref.shutdown()


def _call(app, path, body=None, raw=None):
    """(status, headers, body text) of one request; `raw` is sent as the
    body as is."""
    conn = http.client.HTTPConnection("127.0.0.1", app.http_port,
                                      timeout=120)
    if body is None and raw is None:
        conn.request("GET", path)
    else:
        conn.request("POST", path, body=raw if raw is not None
                     else json.dumps(body),
                     headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    text = resp.read().decode()
    conn.close()
    return resp.status, dict(resp.getheaders()), text


def _json(text):
    return json.loads(text)


def _events(text):
    """The SSE data payloads, [DONE] last."""
    return [line[len("data: "):] for line in text.splitlines()
            if line.startswith("data: ")]


C, H, E = "/v1/completions", "/v1/chat/completions", "/v1/embeddings"
MSG = [{"role": "user", "content": "hi there"}]
LONG = "x" * 40   # 41 tokens with BOS: past the admission limit of 32

# name -> (path, body): every _UNSUPPORTED_NONDEFAULT key and its no-op
# default, the logprobs forms on both surfaces, n with and without stream
# and greedy, the top_p / top_k ranges, min_tokens, stop types, empty
# prompts, conversation_id types, the admission limit, the embeddings
# input forms and encoding_format
STATUSES = {
    "presence_penalty-set": (C, {"presence_penalty": 0.5}),
    "presence_penalty-default": (C, {"presence_penalty": 0}),
    "presence_penalty-not-a-number": (C, {"presence_penalty": "abc"}),
    "frequency_penalty-set": (C, {"frequency_penalty": 0.3}),
    "frequency_penalty-default": (C, {"frequency_penalty": 0.0}),
    "logit_bias-set": (C, {"logit_bias": {"5": 1}}),
    "logit_bias-default": (C, {"logit_bias": {}}),
    "best_of-2": (C, {"best_of": 2}),
    "best_of-1": (C, {"best_of": 1}),
    "suffix-set": (C, {"suffix": "x"}),
    "suffix-default": (C, {"suffix": ""}),
    "logprobs-2": (C, {"logprobs": 2}),
    "logprobs-6": (C, {"logprobs": 6}),
    "logprobs-true-on-completions": (C, {"logprobs": True}),
    "logprobs-not-a-number": (C, {"logprobs": "x"}),
    "top_logprobs-on-completions": (C, {"top_logprobs": 2}),
    "logprobs-with-stream": (C, {"logprobs": 1, "stream": True}),
    "logprobs-past-the-scoring-bucket": (C, {"logprobs": 1,
                                             "max_tokens": 30}),
    "chat-logprobs": (H, {"logprobs": True, "top_logprobs": 3}),
    "chat-top_logprobs-21": (H, {"logprobs": True, "top_logprobs": 21}),
    "chat-top_logprobs-without-logprobs": (H, {"top_logprobs": 2}),
    "chat-logprobs-not-a-bool": (H, {"logprobs": "yes"}),
    "chat-logprobs-with-stream": (H, {"logprobs": True, "stream": True}),
    "n-2-sampled": (C, {"n": 2, "temperature": 0.8}),
    "n-2-greedy": (C, {"n": 2, "temperature": 0}),
    "n-2-stream": (C, {"n": 2, "temperature": 0.8, "stream": True}),
    "n-past-the-slots": (C, {"n": 9, "temperature": 0.8}),
    "n-not-a-number": (C, {"n": "x"}),
    "chat-n-2-sampled": (H, {"n": 2, "temperature": 0.8}),
    "top_p-0": (C, {"top_p": 0}),
    "top_p-1.5": (C, {"top_p": 1.5}),
    "top_p-0.9": (C, {"top_p": 0.9, "temperature": 0.8}),
    "top_k-negative": (C, {"top_k": -1}),
    "top_k-5": (C, {"top_k": 5, "temperature": 0.8}),
    "min_tokens-in-range": (C, {"min_tokens": 2, "max_tokens": 3}),
    "min_tokens-past-max_tokens": (C, {"min_tokens": 5, "max_tokens": 4}),
    "max_tokens-0": (C, {"max_tokens": 0}),
    "max_tokens-not-a-number": (C, {"max_tokens": "abc"}),
    "stop-string": (C, {"stop": "ab"}),
    "stop-list": (C, {"stop": ["ab", "cd"]}),
    "stop-list-with-an-int": (C, {"stop": ["ab", 1]}),
    "stop-an-int": (C, {"stop": 5}),
    "prompt-empty": (C, {"prompt": ""}),
    "prompt-missing": (C, {"prompt": None}),
    "prompt-past-the-admission-limit": (C, {"prompt": LONG}),
    "chat-messages-empty": (H, {"messages": []}),
    "chat-messages-not-a-list": (H, {"messages": "hi"}),
    "chat-prompt-past-the-admission-limit": (
        H, {"messages": [{"role": "user", "content": LONG}]}),
    "conversation_id-an-int": (C, {"conversation_id": 5}),
    "conversation_id-a-string": (C, {"conversation_id": "c1"}),
    "body-a-list": (C, ["hello"]),
    "embeddings-string": (E, {"input": "abc"}),
    "embeddings-list": (E, {"input": ["a", "bb"]}),
    "embeddings-empty-list": (E, {"input": []}),
    "embeddings-empty-item": (E, {"input": ["a", ""]}),
    "embeddings-an-int": (E, {"input": 5}),
    "embeddings-base64": (E, {"input": "abc", "encoding_format": "base64"}),
    "embeddings-format-hex": (E, {"input": "abc", "encoding_format": "hex"}),
    "embeddings-past-the-bucket": (E, {"input": LONG}),
    "models": ("/v1/models", None),
}


def _body(path, fields):
    if fields is None or not isinstance(fields, dict):
        return fields
    if path == E:
        return fields
    base = ({"messages": MSG} if path == H else {"prompt": "hello"})
    out = {**base, "max_tokens": 2, "temperature": 0, **fields}
    return {k: v for k, v in out.items() if v is not None}


@pytest.mark.parametrize("case", sorted(STATUSES))
def test_statuses_match_the_reference(servers, case):
    path, fields = STATUSES[case]
    body = _body(path, fields)
    want, _, wtext = _call(servers[0], path, body)
    got, _, gtext = _call(servers[1], path, body)
    assert got == want, (wtext, gtext)
    if want >= 400:
        assert "error" in _json(gtext)


def _full_greedy(app, chat, max_tokens=12):
    body = ({"messages": MSG} if chat else {"prompt": "sss"})
    _, _, text = _call(app, H if chat else C,
                       {**body, "max_tokens": max_tokens, "temperature": 0})
    choice = _json(text)["choices"][0]
    return choice["message"]["content"] if chat else choice["text"]


def _summary(text, chat, stream):
    """(text, finish_reason, usage or None) of a completion response."""
    if not stream:
        data = _json(text)
        choice = data["choices"][0]
        return ((choice["message"]["content"] if chat else choice["text"]),
                choice["finish_reason"], data["usage"])
    events = _events(text)
    assert events[-1] == "[DONE]"
    parsed = [_json(e) for e in events[:-1]]
    pieces = [(c["choices"][0]["delta"].get("content", "") if chat
               else c["choices"][0]["text"]) for c in parsed]
    return "".join(pieces), parsed[-1]["choices"][0]["finish_reason"], None


@pytest.mark.parametrize("stream", [False, True], ids=["json", "sse"])
@pytest.mark.parametrize("chat", [False, True], ids=["completions", "chat"])
@pytest.mark.parametrize("rule", ["none", "stop", "stop-min_tokens"])
def test_greedy_output_matches_the_reference(servers, chat, stream, rule):
    full = _full_greedy(servers[0], chat)
    assert full == _full_greedy(servers[1], chat)
    body = ({"messages": MSG} if chat else {"prompt": "sss"})
    body.update(max_tokens=12, temperature=0, stream=stream)
    if rule != "none":
        assert len(full) > 4
        # a stop string from the middle of the greedy text; under the
        # min_tokens floor the match inside the first 4 tokens' text is
        # immune
        body["stop"] = full[2:4]
        if rule == "stop-min_tokens":
            body["min_tokens"] = 4
    path = H if chat else C
    want = _summary(_call(servers[0], path, body)[2], chat, stream)
    got = _summary(_call(servers[1], path, body)[2], chat, stream)
    assert got == want
    if rule == "stop":
        assert want[1] == "stop" and full.startswith(want[0])


@pytest.mark.parametrize("chat", [False, True], ids=["completions", "chat"])
def test_logprobs_match_the_reference(servers, chat):
    body = ({"messages": MSG, "logprobs": True, "top_logprobs": 3} if chat
            else {"prompt": "sss", "logprobs": 3})
    body.update(max_tokens=6, temperature=0)
    path = H if chat else C
    want = _json(_call(servers[0], path, body)[2])["choices"][0]["logprobs"]
    got = _json(_call(servers[1], path, body)[2])["choices"][0]["logprobs"]
    if chat:
        assert len(got["content"]) == len(want["content"]) == 6
        for g, w in zip(got["content"], want["content"]):
            assert (g["token"], g["bytes"]) == (w["token"], w["bytes"])
            assert abs(g["logprob"] - w["logprob"]) <= LP_TOL
            assert [t["token"] for t in g["top_logprobs"]] == \
                [t["token"] for t in w["top_logprobs"]]
            np.testing.assert_allclose(
                [t["logprob"] for t in g["top_logprobs"]],
                [t["logprob"] for t in w["top_logprobs"]], atol=LP_TOL)
        return
    assert got["tokens"] == want["tokens"] and len(want["tokens"]) == 6
    assert got["text_offset"] == want["text_offset"]
    np.testing.assert_allclose(got["token_logprobs"], want["token_logprobs"],
                               atol=LP_TOL)
    for g, w in zip(got["top_logprobs"], want["top_logprobs"]):
        assert list(g) == list(w)
        np.testing.assert_allclose(list(g.values()), list(w.values()),
                                   atol=LP_TOL)


@pytest.mark.parametrize("fmt", ["float", "base64"])
def test_embeddings_match_the_reference(servers, fmt):
    body = {"input": ["hello there", "sss"], "encoding_format": fmt}
    want = _json(_call(servers[0], E, body)[2])
    got = _json(_call(servers[1], E, body)[2])
    assert got["usage"] == want["usage"]

    def vectors(data):
        out = []
        for item in data["data"]:
            emb = item["embedding"]
            if fmt == "base64":
                emb = np.frombuffer(base64.b64decode(emb), dtype="<f4")
            out.append(np.asarray(emb, dtype=np.float32))
        return np.stack(out)

    w, g = vectors(want), vectors(got)
    assert g.shape == w.shape == (2, 64)
    np.testing.assert_allclose(g, w, atol=LP_TOL)
    np.testing.assert_allclose(np.linalg.norm(g, axis=1), 1.0, atol=1e-5)


def test_n_choices_sum_to_usage(servers):
    engine = servers[1].engine
    submitted = []
    submit = engine.submit

    def recording(*a, **kw):
        submitted.append(submit(*a, **kw))
        return submitted[-1]

    engine.submit = recording
    try:
        body = {"prompt": "pick", "max_tokens": 6, "temperature": 0.9,
                "top_p": 0.95, "n": 3}
        got = _json(_call(servers[1], C, body)[2])
        want = _json(_call(servers[0], C, body)[2])
    finally:
        del engine.submit
    assert [c["index"] for c in got["choices"]] == [0, 1, 2]
    assert len(submitted) == 3
    assert got["usage"]["completion_tokens"] == sum(r.generated
                                                    for r in submitted)
    assert got["usage"]["prompt_tokens"] == want["usage"]["prompt_tokens"]
    assert len(want["choices"]) == 3
    assert all(c["finish_reason"] in ("stop", "length")
               for c in got["choices"])


def test_a_draining_engine_answers_503_with_retry_after(servers):
    answers = []
    for app in servers:
        app.engine.drain(timeout_s=0)
        try:
            status, headers, text = _call(app, C, _body(C, {}))
        finally:
            app.engine._draining = False
        answers.append((status, headers.get("Retry-After"),
                        "error" in _json(text)))
    assert answers[1] == answers[0] == (503, "1", True)


def test_stats_and_debug_routes_have_the_reference_keys(servers):
    """/stats answers the reference's keys, fleet {lifecycle, duty_cycle}
    among them, and the observability planes serve their routes on this
    server too."""
    payloads = []
    for app in servers:
        status, _, text = _call(app, "/stats")
        assert status == 200
        payloads.append(_json(text)["data"])
        for path in ("/debug/engine", "/debug/steps", "/debug/requests",
                     "/debug/journey", "/debug/trace", "/debug/timeline",
                     "/debug/hostprof"):
            assert _call(app, path)[0] == 200, path
    want, got = payloads
    assert set(got) == set(want)
    assert set(got["fleet"]) == set(want["fleet"])
    assert 0.0 <= got["fleet"]["duty_cycle"] <= 1.0

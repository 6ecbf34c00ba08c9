"""The port's gRPC surface (grpcx/) against the reference's.

- tests/test_grpc_proto.py's cases on both packages' grpcx, side by side:
  the protobuf round trip with protoc-generated stubs (protoc runs at test
  time), the four RPC shapes, the status codes (ValueError / InvalidParam
  INVALID_ARGUMENT, a duck-typed 503 shed UNAVAILABLE, anything else
  INTERNAL) and the two packages' clients and servers talking across;
- the llm-server's ``llm.Generator/Generate`` on the port's paged and
  dense engines, streamed greedily and message for message equal to the
  JAX llm-server's own ``build_generate_service``
  (examples/llm-server/main.py) on a JAX engine with the same weights
  (``params_from_numpy``), goldens computed live; top_k=1 at temperature 1
  equal to greedy;
- the served App (``serve.build_app`` on the CPU, GRPC_PORT=0, an API key):
  gRPC and SSE /generate stream the same text, the 401 without the key,
  /.well-known without one, an empty prompt INVALID_ARGUMENT, a stream
  cancelled mid-way gives its slot and pages back, a draining engine
  UNAVAILABLE; a set GRPC_PORT without grpc fails the start;
- bert-embed's ``EmbedService/Embed`` over gRPC equal to ``/embed`` and to
  the JAX encoder on the same weights (as tests/test_torch_models.py holds
  /embed: the 6-place rounding plus 1e-5).

Every App and server these tests start is shut down.
"""

import contextlib
import http.client
import importlib.util
import json
import pathlib
import queue
import shutil
import subprocess
import sys
import threading
import time

import grpc
import jax
import numpy as np
import pytest

from gofr_tpu import grpcx as jgrpcx
from gofr_tpu.http.errors import InvalidParam as JInvalidParam
from gofr_tpu.logging import MockLogger as JMockLogger
from gofr_tpu_torch import grpcx as tgrpcx
from gofr_tpu_torch.http.errors import InvalidParam as TInvalidParam
from gofr_tpu_torch.logging import MockLogger as TMockLogger

from _torch_env import INCIDENT_DIR

ROOT = pathlib.Path(__file__).resolve().parents[1]
IMPLS = {"jax": (jgrpcx, JMockLogger, JInvalidParam),
         "torch": (tgrpcx, TMockLogger, TInvalidParam)}

PROTO = """
syntax = "proto3";
package gofrtorch;
message EmbedRequest { string text = 1; int32 id = 2; }
message EmbedResponse { repeated float vector = 1; int32 id = 2; }
message GenRequest { string prompt = 1; int32 max_tokens = 2; }
message GenChunk { string text = 1; bool done = 2; int32 tokens = 3; }
message Sample { int32 value = 1; string tag = 2; }
message Summary { int32 count = 1; int32 total = 2; string tags = 3; }
"""


@pytest.fixture(scope="module")
def pb2(tmp_path_factory):
    if shutil.which("protoc") is None:
        pytest.skip("protoc not available")
    root = tmp_path_factory.mktemp("torch_proto")
    (root / "torch_shapes.proto").write_text(PROTO)
    subprocess.run(["protoc", f"--python_out={root}", "torch_shapes.proto"],
                   cwd=root, check=True)
    sys.path.insert(0, str(root))
    try:
        import torch_shapes_pb2 as module

        yield module
    finally:
        sys.path.remove(str(root))


class _Container:
    def __init__(self, logger):
        self.logger = logger
        self.tracer = None
        self.metrics_manager = None

    def __getattr__(self, name):
        return None


@contextlib.contextmanager
def _served(impl: str, *services, client_impl: str = None):
    """A server of `impl` with `services`, and a client of `client_impl`
    (default the same package)."""
    mod, logger_cls, _ = IMPLS[impl]
    server = mod.GRPCServer(_Container(logger_cls()), port=0,
                            logger=logger_cls())
    for service in services:
        server.register(service)
    server.start()
    client = IMPLS[client_impl or impl][0].GRPCClient(
        f"127.0.0.1:{server.port}")
    try:
        yield client
    finally:
        client.close()
        server.stop()


def _shapes(impl: str, pb2) -> dict:
    """The four RPC shapes over one server of `impl`: unary and
    client-streaming over protobuf, server-streaming over protobuf, bidi
    over JSON with interleaved requests."""
    mod = IMPLS[impl][0]

    def embed(ctx):
        msg = ctx.request.payload
        assert isinstance(msg, pb2.EmbedRequest)
        return pb2.EmbedResponse(vector=[float(len(msg.text)), 2.5],
                                 id=msg.id)

    def generate(ctx):
        msg = ctx.request.payload
        for i in range(msg.max_tokens):
            yield pb2.GenChunk(text=f"{msg.prompt}-{i}")
        yield pb2.GenChunk(done=True, tokens=msg.max_tokens)

    def collect(ctx):
        items = list(ctx.request.payload)
        return pb2.Summary(count=len(items),
                           total=sum(m.value for m in items),
                           tags=",".join(m.tag for m in items))

    def echo(ctx):
        for msg in ctx.request.payload:
            yield {"got": msg["n"], "method": ctx.request.method}

    services = [
        mod.GenericService("gofrtorch.Embedder", {"Embed": embed},
                           serializer=lambda m: m.SerializeToString(),
                           deserializer=pb2.EmbedRequest.FromString),
        mod.GenericService("gofrtorch.Generator", {},
                           stream_methods={"Generate": generate},
                           serializer=lambda m: m.SerializeToString(),
                           deserializer=pb2.GenRequest.FromString),
        mod.GenericService("gofrtorch.Aggregator", {},
                           client_stream_methods={"Collect": collect},
                           serializer=lambda m: m.SerializeToString(),
                           deserializer=pb2.Sample.FromString),
        mod.GenericService("gofrtorch.Echoer", {},
                           bidi_methods={"Chat": echo}),
    ]
    out = {}
    with _served(impl, *services) as client:
        resp = client.call("gofrtorch.Embedder", "Embed",
                           pb2.EmbedRequest(text="hello", id=9),
                           serializer=lambda m: m.SerializeToString(),
                           deserializer=pb2.EmbedResponse.FromString)
        assert isinstance(resp, pb2.EmbedResponse)
        out["unary"] = (resp.id, list(resp.vector))
        chunks = client.stream("gofrtorch.Generator", "Generate",
                               pb2.GenRequest(prompt="tok", max_tokens=4),
                               serializer=lambda m: m.SerializeToString(),
                               deserializer=pb2.GenChunk.FromString)
        out["stream"] = [(c.text, c.done, c.tokens) for c in chunks]
        summary = client.client_stream(
            "gofrtorch.Aggregator", "Collect",
            [pb2.Sample(value=v, tag=t) for v, t in ((3, "a"), (4, "b"),
                                                     (5, "c"))],
            serializer=lambda m: m.SerializeToString(),
            deserializer=pb2.Summary.FromString)
        out["client_stream"] = (summary.count, summary.total, summary.tags)
        # bidi interleaved: message n+1 goes out after reply n came back
        replies, got = [], []
        received = queue.Queue()

        def requests():
            for n in range(3):
                yield {"n": n}
                replies.append(received.get(timeout=10))

        for item in client.bidi("gofrtorch.Echoer", "Chat", requests()):
            got.append(item)
            received.put(item)
        out["bidi"] = got
        out["bidi_interleaved"] = replies == got[:len(replies)]
    return out


def test_four_rpc_shapes_as_the_reference(pb2):
    want = _shapes("jax", pb2)
    got = _shapes("torch", pb2)
    assert got == want
    assert got["unary"] == (9, [5.0, 2.5])
    assert got["stream"][-1] == ("", True, 4)
    assert got["client_stream"] == (3, 12, "a,b,c")
    assert got["bidi"] == [{"got": n, "method": "/gofrtorch.Echoer/Chat"}
                           for n in range(3)]
    assert got["bidi_interleaved"]


def test_protobuf_wire_bytes_are_binary(pb2):
    raw = pb2.EmbedRequest(text="hi", id=3).SerializeToString()
    assert raw and not raw.strip().startswith(b"{")
    assert pb2.EmbedRequest.FromString(raw).text == "hi"


class _Shed(Exception):
    """A duck-typed shed, as the engines' draining / stalled / breaker
    errors are."""
    status_code = 503


def _codes(impl: str) -> list:
    mod, _, invalid = IMPLS[impl]

    def bad(ctx):
        raise ValueError("empty prompt")

    def broken(ctx):
        raise RuntimeError("engine on fire")

    def shed(ctx):
        raise _Shed("draining")

    def bad_stream(ctx):
        raise invalid(["top_p"])
        yield  # pragma: no cover

    def shed_stream(ctx):
        yield {"text": "a"}
        raise _Shed("stalled")

    def reject(ctx):
        for _ in ctx.request.payload:
            raise ValueError("bad sample")
        return {}

    service = mod.GenericService(
        "val.Svc", {"Bad": bad, "Broken": broken, "Shed": shed},
        stream_methods={"BadStream": bad_stream, "ShedStream": shed_stream},
        client_stream_methods={"Reject": reject})
    out = []
    with _served(impl, service) as client:
        for method in ("Bad", "Broken", "Shed"):
            with pytest.raises(grpc.RpcError) as err:
                client.call("val.Svc", method, {"x": 1})
            out.append((method, err.value.code(), err.value.details()))
        for method in ("BadStream", "ShedStream"):
            got = []
            with pytest.raises(grpc.RpcError) as err:
                for item in client.stream("val.Svc", method, {"x": 1}):
                    got.append(item)
            out.append((method, err.value.code(), got))
        with pytest.raises(grpc.RpcError) as err:
            client.client_stream("val.Svc", "Reject", [{"v": 1}])
        out.append(("Reject", err.value.code()))
    return out


def test_status_codes_as_the_reference():
    want = _codes("jax")
    got = _codes("torch")
    assert got == want
    codes = grpc.StatusCode
    assert [row[1] for row in got] == [
        codes.INVALID_ARGUMENT, codes.INTERNAL, codes.UNAVAILABLE,
        codes.INVALID_ARGUMENT, codes.UNAVAILABLE, codes.INVALID_ARGUMENT]
    assert got[4][2] == [{"text": "a"}]   # the messages before the shed


@pytest.mark.parametrize("server,client", [("torch", "jax"),
                                           ("jax", "torch")])
def test_wire_compatible_with_the_reference(server, client):
    mod = IMPLS[server][0]

    def hello(ctx):
        return {"message": f"Hello {ctx.request.param('name') or 'World'}!"}

    def count(ctx):
        for i in range(int(ctx.bind()["n"])):
            yield {"i": i}

    service = mod.GenericService("HelloService", {"SayHello": hello},
                                 stream_methods={"Count": count})
    with _served(server, service, client_impl=client) as c:
        assert c.call("HelloService", "SayHello", {"name": "TPU"}) == {
            "message": "Hello TPU!"}
        assert list(c.stream("HelloService", "Count", {"n": 3})) == [
            {"i": 0}, {"i": 1}, {"i": 2}]


def test_rpc_log_and_span_per_call():
    """Each call logs one RPCLog line and, with a tracer on the container,
    ends one span under the caller's traceparent."""
    from gofr_tpu_torch.tracing import InMemoryExporter, Tracer

    logger = TMockLogger()
    exporter = InMemoryExporter()
    container = _Container(logger)
    container.tracer = Tracer(service_name="t", exporter=exporter)
    server = tgrpcx.GRPCServer(container, port=0, logger=logger)
    server.register(tgrpcx.GenericService(
        "Svc", {"Echo": lambda ctx: ctx.bind()},
        stream_methods={"Two": lambda ctx: iter([{"a": 1}, {"b": 2}])}))
    server.start()
    client = tgrpcx.GRPCClient(f"127.0.0.1:{server.port}")
    trace = "0af7651916cd43dd8448eb211c80319c"
    try:
        assert client.call("Svc", "Echo", {"k": 1}, metadata={
            "traceparent": f"00-{trace}-b7ad6b7169203331-01"}) == {"k": 1}
        assert len(list(client.stream("Svc", "Two", {}))) == 2
    finally:
        client.close()
        server.stop()
    names = [s.name for s in exporter.spans]
    assert names == ["grpc /Svc/Echo", "grpc /Svc/Two"]
    assert exporter.spans[0].trace_id == trace
    assert exporter.spans[1].attributes["grpc.stream_messages"] == 2
    text = logger.output()
    assert "/Svc/Echo" in text and "/Svc/Two [2 msgs]" in text


# -- the llm-server's Generate against the JAX llm-server's -------------------------
ENGINE = dict(n_slots=2, max_seq_len=128, prefill_buckets=(8, 32),
              sampling_controls=True)
PROMPTS = ["grpc", "hello over grpc", "a longer prompt to stream"]


@pytest.fixture(scope="module")
def weights():
    from gofr_tpu.models.llama import LlamaConfig as JConfig
    from gofr_tpu.models.llama import llama_init as jax_init
    from gofr_tpu_torch.models.weights import params_from_numpy

    jparams = jax_init(JConfig.debug(), seed=0)
    return jparams, params_from_numpy(jax.device_get(jparams), device="cpu")


def _reference_llm_server():
    path = ROOT / "examples" / "llm-server" / "main.py"
    spec = importlib.util.spec_from_file_location("llm_server_torch_grpc",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class _QuietLogger:
    def debugf(self, *a): pass
    def infof(self, *a): pass
    def warnf(self, *a): pass
    def errorf(self, *a): pass


def _generate_all(impl: str, service, bodies) -> list:
    with _served(impl, service) as client:
        return [[{k: v for k, v in m.items() if k != "tok_per_s"}
                 for m in client.stream("llm.Generator", "Generate", body,
                                        timeout_s=120)]
                for body in bodies]


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_generate_streams_as_the_jax_llm_server(weights, paged):
    from gofr_tpu.models.llama import LlamaConfig as JConfig
    from gofr_tpu.models.tokenizer import DebugTokenizer as JTok
    from gofr_tpu.tpu.engine import LLMEngine as JEngine
    from gofr_tpu.tpu.paging import PagedLLMEngine as JPaged
    from gofr_tpu_torch.models.llama import LlamaConfig
    from gofr_tpu_torch.models.tokenizer import DebugTokenizer
    from gofr_tpu_torch.serve import build_generate_service
    from gofr_tpu_torch.tpu.engine import LLMEngine
    from gofr_tpu_torch.tpu.paging import PagedLLMEngine

    extra = {"page_size": 8} if paged else {}
    greedy = [{"prompt": p, "max_tokens": 10} for p in PROMPTS]
    top_k1 = {"prompt": PROMPTS[1], "max_tokens": 10, "temperature": 1.0,
              "top_k": 1}
    jcls = JPaged if paged else JEngine
    jeng = jcls(weights[0], JConfig.debug(), logger=_QuietLogger(),
                **ENGINE, **extra)
    jeng.start()
    try:
        want = _generate_all("jax", _reference_llm_server()
                             .build_generate_service(jeng, JTok(512)), greedy)
    finally:
        jeng.stop()
    tcls = PagedLLMEngine if paged else LLMEngine
    eng = tcls(weights[1], LlamaConfig.debug(), device="cpu",
               logger=_QuietLogger(), **ENGINE, **extra)
    eng.start()
    try:
        service = build_generate_service(eng, DebugTokenizer(512))
        got = _generate_all("torch", service, greedy + [top_k1])
        if paged:
            assert eng.allocator.used_pages == 0
        assert not any(s.active for s in eng.slots)
    finally:
        eng.stop()
    assert got[:len(greedy)] == want
    for stream in want:
        assert stream[-1]["done"] is True and stream[-1]["tokens"] >= 1
    # top_k=1 at temperature 1 keeps one survivor a step: greedy
    assert got[-1] == got[1]


# -- the served App: gRPC beside SSE, auth, cancel, shed ------------------------------
SERVED = {"HTTP_PORT": "0", "METRICS_PORT": "0", "GRPC_PORT": "0",
          "MAX_SEQ_LEN": "128", "PREFILL_BUCKETS": "8,32", "PAGE_SIZE": "8",
          "MAX_BATCH": "4", "WARMUP": "false", "LOG_LEVEL": "ERROR",
          "PREFIX_CACHE": "false",
          "SAMPLING_CONTROLS": "true", "REQUEST_TIMEOUT": "120",
          "HOSTPROF": "false", "INCIDENT_DIR": INCIDENT_DIR}


def _sse(port, body, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request("POST", "/generate", json.dumps(body),
                 {"Content-Type": "application/json", **(headers or {})})
    resp = conn.getresponse()
    raw = resp.read()
    conn.close()
    if resp.status != 200:
        return resp.status, dict(resp.getheaders()), json.loads(raw)
    events = [json.loads(line[6:]) for line in raw.split(b"\n")
              if line.startswith(b"data: ")]
    return resp.status, dict(resp.getheaders()), events


def test_served_grpc_equals_sse_behind_an_api_key(weights):
    from gofr_tpu_torch.serve import build_app

    app = build_app(SERVED, device="cpu")
    app.enable_api_key_auth("k1")
    engine = app.engine
    app.start()
    client = tgrpcx.GRPCClient(f"127.0.0.1:{app.grpc_port}")
    key = {"X-API-Key": "k1"}
    try:
        assert app.grpc_port not in (0, 9000)
        for prompt in PROMPTS:
            body = {"prompt": prompt, "max_tokens": 12}
            status, _, events = _sse(app.http_port, body, key)
            assert status == 200
            msgs = list(client.stream("llm.Generator", "Generate", body,
                                      timeout_s=120))
            assert "".join(m.get("text", "") for m in msgs[:-1]) == \
                "".join(e.get("text", "") for e in events[:-1])
            assert msgs[-1]["tokens"] == events[-1]["tokens"]
        # the 401 without the key; the well-known routes pass
        status, headers, body = _sse(app.http_port, {"prompt": "x"})
        assert (status, body) == (401, {"error": {"message": "Unauthorized"}})
        assert headers["WWW-Authenticate"] == "Basic"
        conn = http.client.HTTPConnection("127.0.0.1", app.http_port,
                                          timeout=60)
        conn.request("GET", "/.well-known/health")
        assert conn.getresponse().status == 200
        conn.close()
        # an empty prompt, a refused parameter
        for bad in ({"prompt": ""}, {"prompt": "x", "top_p": 2.0}, []):
            with pytest.raises(grpc.RpcError) as err:
                list(client.stream("llm.Generator", "Generate", bad))
            assert err.value.code() == grpc.StatusCode.INVALID_ARGUMENT
        # a stream cancelled mid-way: its slot and pages come back
        call = client.stream("llm.Generator", "Generate",
                             {"prompt": PROMPTS[2], "max_tokens": 100},
                             timeout_s=120)
        first = [next(call) for _ in range(2)]
        assert all("text" in m for m in first)
        call.cancel()
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and (
                any(s.active for s in engine.slots)
                or engine.allocator.used_pages):
            time.sleep(0.05)
        assert not any(s.active for s in engine.slots)
        assert engine.allocator.used_pages == 0
        # a draining engine sheds: UNAVAILABLE, the retry-elsewhere code
        threading.Thread(target=engine.drain, args=(0.5,)).start()
        time.sleep(0.1)
        with pytest.raises(grpc.RpcError) as err:
            list(client.stream("llm.Generator", "Generate",
                               {"prompt": "late", "max_tokens": 4}))
        assert err.value.code() == grpc.StatusCode.UNAVAILABLE
    finally:
        client.close()
        app.shutdown()
    assert app._grpc_server is None


def test_grpc_port_without_grpc_fails_the_start(monkeypatch):
    """A set GRPC_PORT with a service registered and no grpc package fails
    the start with nothing left listening; unset, it is logged and the
    App serves without gRPC."""
    from gofr_tpu_torch.app import App

    monkeypatch.setitem(sys.modules, "grpc", None)
    svc = tgrpcx.GenericService("S", {"M": lambda ctx: {}})
    app = App({"HTTP_PORT": "0", "METRICS_PORT": "0", "GRPC_PORT": "0",
               "LOG_LEVEL": "ERROR"})
    app.register_grpc_service(svc)
    with pytest.raises(RuntimeError, match="grpc is not importable"):
        app.start()
    assert app._http_server is None and app._metrics_server is None
    app.shutdown()
    app = App({"HTTP_PORT": "0", "METRICS_PORT": "0", "LOG_LEVEL": "ERROR"})
    app.register_grpc_service(svc)
    app.start()
    try:
        assert app._grpc_server is None and app._http_server is not None
    finally:
        app.shutdown()


# -- bert-embed's Embed -----------------------------------------------------------------
def test_bert_embed_over_grpc_equals_http_and_the_jax_encoder():
    from gofr_tpu.models import bert as jb
    from gofr_tpu_torch import serve_bert
    from gofr_tpu_torch.models.weights import params_from_numpy

    jcfg = jb.BertConfig.debug()
    jp = jb.bert_init(jcfg, seed=0)
    app = serve_bert.build_app(
        {"HTTP_PORT": "0", "METRICS_PORT": "0", "GRPC_PORT": "0",
         "LOG_LEVEL": "ERROR", "SEQ_BUCKETS": "16,32",
         "REQUEST_TIMEOUT": "60"}, device="cpu",
        params=params_from_numpy(jax.device_get(jp), "cpu"))
    app.start()
    client = tgrpcx.GRPCClient(f"127.0.0.1:{app.grpc_port}")
    try:
        for body in ({"text": "hello tpu"}, {"text": "x"},
                     {"tokens": [5, 6, 7]}):
            got = client.call("EmbedService", "Embed", body, timeout_s=60)
            conn = http.client.HTTPConnection("127.0.0.1", app.http_port,
                                              timeout=60)
            conn.request("POST", "/embed", json.dumps(body))
            http_body = json.loads(conn.getresponse().read())["data"]
            conn.close()
            assert got == http_body
            ids = (body["tokens"] if "tokens" in body
                   else [b + 1 for b in body["text"].encode()])
            want = np.asarray(jb.bert_embed(jp, jcfg, np.asarray([ids])))[0]
            np.testing.assert_allclose(got["embedding"], want,
                                       atol=5e-7 + 1e-5)
        with pytest.raises(grpc.RpcError) as err:
            client.call("EmbedService", "Embed", {"tokens": [0, 1]})
        assert err.value.code() == grpc.StatusCode.INVALID_ARGUMENT
    finally:
        client.close()
        app.shutdown()

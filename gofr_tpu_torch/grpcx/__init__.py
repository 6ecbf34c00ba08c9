"""gRPC server and client with logging, recovery and tracing per call.

A copy of ``gofr_tpu/grpcx/__init__.py``: ``RPCLog``, ``GRPCRequest`` (a
deserialized message behind the Request interface, so an HTTP handler
serves gRPC as it is), ``GenericService`` (a (service name, {method:
handler}) pair with pluggable serializers: JSON by default, or a
protoc-generated Message's ``SerializeToString`` / ``FromString`` for the
protobuf wire format), ``GRPCServer`` and ``GRPCClient``. All four RPC
shapes register:

  - unary: ``methods``, the handler returns one response;
  - server-streaming: ``stream_methods``, the handler returns an iterator,
    each item one stream message (the llm-server's ``llm.Generator/
    Generate``, serve.py, the twin of its SSE ``/generate``);
  - client-streaming: ``client_stream_methods``, ``ctx.request.payload``
    is the iterator of inbound messages, the handler returns one response;
  - bidi: ``bidi_methods``, the inbound iterator in, the handler yields.

``GRPCClient.call`` / ``stream`` / ``client_stream`` / ``bidi`` are the
consuming counterparts. Each call gets a span on the container's tracer
(under the caller's ``traceparent`` metadata), one ``RPCLog`` line and
recovery: a handler's ``ValueError`` or ``InvalidParam`` aborts
INVALID_ARGUMENT, a duck-typed 503 (a draining, stalled or breaker-open
engine's shed) UNAVAILABLE, anything else INTERNAL (``_status_for``).

``grpc`` is imported only when a server or a client is made (``App.start``
with a service registered), so the package imports without it. The server
binds ``0.0.0.0:port`` with gRPC's defaults, as the reference's does (on
Linux a second server on the same port shares it through SO_REUSEPORT);
port 0 picks a free one, in ``port`` after ``start``. ``stop`` waits out
its grace and shuts the handler pool down.
"""

from __future__ import annotations

import json
import time
from concurrent import futures
from typing import Any, Callable, Dict, Optional

from ..context import Context
from ..logging import PrettyPrint


class RPCLog(PrettyPrint):
    def __init__(self, method: str, status: str, duration_us: int, trace_id: str = ""):
        self.method = method
        self.status = status
        self.response_time_us = duration_us
        self.trace_id = trace_id

    def pretty_print(self, fp) -> None:
        fp.write(f"{self.trace_id} \x1b[34mRPC\x1b[0m {self.status} "
                 f"{self.response_time_us:>8}µs {self.method}")


class GRPCRequest:
    """Adapts a deserialized gRPC message to the framework Request interface."""

    def __init__(self, payload: Any, method: str, metadata: Dict[str, str]):
        self.payload = payload
        self.method = method
        self.metadata = metadata
        self.span = None
        self.context: Dict[str, Any] = {}

    def param(self, key: str) -> str:
        if isinstance(self.payload, dict):
            return str(self.payload.get(key, ""))
        return ""

    def path_param(self, key: str) -> str:
        return self.method if key == "method" else ""

    def host_name(self) -> str:
        return "grpc://" + self.metadata.get(":authority", "")

    def bind(self, target: Any = None) -> Any:
        import dataclasses

        data = self.payload
        if target is None:
            return data
        if isinstance(target, type) and dataclasses.is_dataclass(target):
            names = {f.name for f in dataclasses.fields(target)}
            return target(**{k: v for k, v in data.items() if k in names})
        if isinstance(target, dict):
            target.update(data)
            return target
        for k, v in data.items():
            setattr(target, k, v)
        return target


class GenericService:
    def __init__(self, name: str, methods: Dict[str, Callable[[Context], Any]],
                 serializer: Optional[Callable[[Any], bytes]] = None,
                 deserializer: Optional[Callable[[bytes], Any]] = None,
                 stream_methods: Optional[Dict[str, Callable[[Context], Any]]]
                 = None,
                 client_stream_methods: Optional[Dict[str, Callable[[Context],
                                                                    Any]]]
                 = None,
                 bidi_methods: Optional[Dict[str, Callable[[Context], Any]]]
                 = None):
        self.__grpc_service_name__ = name
        self.__grpc_methods__ = methods
        # server-streaming: handler returns an iterator; each item goes
        # through the serializer as one stream message
        self.__grpc_stream_methods__ = stream_methods or {}
        # client-streaming: ctx.request.payload is an ITERATOR of
        # deserialized messages; the handler consumes it and returns one
        # response. bidi: same inbound iterator, handler YIELDS responses
        # (free interleaving — grpc delivers each yield as it happens)
        self.__grpc_client_stream_methods__ = client_stream_methods or {}
        self.__grpc_bidi_methods__ = bidi_methods or {}
        self.serializer = serializer or (lambda obj: json.dumps(obj, default=str).encode())
        self.deserializer = deserializer or (lambda raw: json.loads(raw.decode()) if raw else {})


class GRPCServer:
    def __init__(self, container, port: int, logger):
        import grpc

        self.container = container
        self.port = port
        self.logger = logger
        self._grpc = grpc
        self._pool = futures.ThreadPoolExecutor(max_workers=32)
        self._server = grpc.server(self._pool)

    def register(self, service) -> None:
        grpc = self._grpc
        name = service.__grpc_service_name__
        methods = service.__grpc_methods__
        serializer = getattr(service, "serializer", lambda o: json.dumps(o, default=str).encode())
        deserializer = getattr(service, "deserializer", lambda raw: json.loads(raw.decode()) if raw else {})

        handlers = {}
        for method_name, fn in methods.items():
            handlers[method_name] = grpc.unary_unary_rpc_method_handler(
                self._adapt(f"/{name}/{method_name}", fn, serializer),
                request_deserializer=deserializer,
                response_serializer=lambda b: b,
            )
        for method_name, fn in getattr(service, "__grpc_stream_methods__",
                                       {}).items():
            handlers[method_name] = grpc.unary_stream_rpc_method_handler(
                self._adapt_stream(f"/{name}/{method_name}", fn, serializer),
                request_deserializer=deserializer,
                response_serializer=lambda b: b,
            )
        for method_name, fn in getattr(service,
                                       "__grpc_client_stream_methods__",
                                       {}).items():
            handlers[method_name] = grpc.stream_unary_rpc_method_handler(
                self._adapt_client_stream(f"/{name}/{method_name}", fn,
                                          serializer),
                request_deserializer=deserializer,
                response_serializer=lambda b: b,
            )
        for method_name, fn in getattr(service, "__grpc_bidi_methods__",
                                       {}).items():
            handlers[method_name] = grpc.stream_stream_rpc_method_handler(
                self._adapt_bidi(f"/{name}/{method_name}", fn, serializer),
                request_deserializer=deserializer,
                response_serializer=lambda b: b,
            )
        self._server.add_generic_rpc_handlers(
            (grpc.method_handlers_generic_handler(name, handlers),))

    def _status_for(self, exc: BaseException):
        """Client-input errors abort INVALID_ARGUMENT; everything else is a
        server fault (INTERNAL). Mirrors the HTTP surface, where the same
        engine.submit validation raises map to 400: a gRPC client must be
        able to tell a bad request from a broken server.
        Shed/overload errors (duck-typed status_code 503: draining engine,
        wedged device) map to UNAVAILABLE — the retry-elsewhere signal."""
        from ..http.errors import InvalidParam

        if isinstance(exc, (ValueError, InvalidParam)):
            return self._grpc.StatusCode.INVALID_ARGUMENT
        if getattr(exc, "status_code", None) == 503:
            return self._grpc.StatusCode.UNAVAILABLE
        return self._grpc.StatusCode.INTERNAL

    def _adapt(self, full_method: str, fn, serializer):
        def handle(payload, grpc_ctx):
            start = time.time()
            metadata = {k: v for k, v in (grpc_ctx.invocation_metadata() or [])}
            request = GRPCRequest(payload, full_method, metadata)
            span = None
            if self.container.tracer is not None:
                span = self.container.tracer.start_span(
                    f"grpc {full_method}", traceparent=metadata.get("traceparent"))
                request.span = span
            ctx = Context(request=request, container=self.container)
            status = "OK"
            try:
                result = fn(ctx)
                return serializer(result)
            except Exception as exc:  # noqa: BLE001 - the recovery interceptor
                status = "ERROR"
                self.logger.errorf("grpc handler %s failed: %s", full_method, exc)
                grpc_ctx.abort(self._status_for(exc), str(exc))
            finally:
                duration_us = int((time.time() - start) * 1e6)
                trace_id = span.trace_id if span else ""
                self.logger.info(RPCLog(full_method, status, duration_us, trace_id))
                if span is not None:
                    span.set_status(status == "OK")
                    span.end()

        return handle

    def _adapt_stream(self, full_method: str, fn, serializer):
        """Server-streaming twin of _adapt: the handler's return value is
        iterated and each item serialized as one stream message. The RPC
        log records total duration and message count at stream end; a
        handler exception mid-stream aborts the RPC (INVALID_ARGUMENT for
        client-input errors, INTERNAL otherwise — the recovery interceptor
        posture, never a silent truncation)."""
        def handle(payload, grpc_ctx):
            start = time.time()
            metadata = {k: v for k, v in (grpc_ctx.invocation_metadata() or [])}
            request = GRPCRequest(payload, full_method, metadata)
            span = None
            if self.container.tracer is not None:
                span = self.container.tracer.start_span(
                    f"grpc {full_method}", traceparent=metadata.get("traceparent"))
                request.span = span
            ctx = Context(request=request, container=self.container)
            status = "OK"
            sent = 0
            try:
                for item in fn(ctx):
                    yield serializer(item)
                    sent += 1
            except Exception as exc:  # noqa: BLE001 - recovery interceptor
                status = "ERROR"
                self.logger.errorf("grpc stream %s failed after %d messages: %s",
                                   full_method, sent, exc)
                grpc_ctx.abort(self._status_for(exc), str(exc))
            finally:
                duration_us = int((time.time() - start) * 1e6)
                trace_id = span.trace_id if span else ""
                self.logger.info(RPCLog(f"{full_method} [{sent} msgs]",
                                        status, duration_us, trace_id))
                if span is not None:
                    span.set_attribute("grpc.stream_messages", sent)
                    span.set_status(status == "OK")
                    span.end()

        return handle

    def _adapt_client_stream(self, full_method: str, fn, serializer):
        """Client-streaming: the request payload IS the (lazily consumed)
        iterator of deserialized messages; the handler aggregates and
        returns one response."""
        def handle(request_iterator, grpc_ctx):
            start = time.time()
            metadata = {k: v for k, v in (grpc_ctx.invocation_metadata() or [])}
            request = GRPCRequest(request_iterator, full_method, metadata)
            span = None
            if self.container.tracer is not None:
                span = self.container.tracer.start_span(
                    f"grpc {full_method}",
                    traceparent=metadata.get("traceparent"))
                request.span = span
            ctx = Context(request=request, container=self.container)
            status = "OK"
            try:
                return serializer(fn(ctx))
            except Exception as exc:  # noqa: BLE001 - recovery interceptor
                status = "ERROR"
                self.logger.errorf("grpc client-stream %s failed: %s",
                                   full_method, exc)
                grpc_ctx.abort(self._status_for(exc), str(exc))
            finally:
                duration_us = int((time.time() - start) * 1e6)
                trace_id = span.trace_id if span else ""
                self.logger.info(RPCLog(full_method, status, duration_us,
                                        trace_id))
                if span is not None:
                    span.set_status(status == "OK")
                    span.end()

        return handle

    def _adapt_bidi(self, full_method: str, fn, serializer):
        """Bidirectional streaming: inbound iterator as the payload, the
        handler yields responses whenever it likes (echo-per-message,
        batch-then-flush, or fully decoupled)."""
        def handle(request_iterator, grpc_ctx):
            start = time.time()
            metadata = {k: v for k, v in (grpc_ctx.invocation_metadata() or [])}
            request = GRPCRequest(request_iterator, full_method, metadata)
            span = None
            if self.container.tracer is not None:
                span = self.container.tracer.start_span(
                    f"grpc {full_method}",
                    traceparent=metadata.get("traceparent"))
                request.span = span
            ctx = Context(request=request, container=self.container)
            status = "OK"
            sent = 0
            try:
                for item in fn(ctx):
                    yield serializer(item)
                    sent += 1
            except Exception as exc:  # noqa: BLE001 - recovery interceptor
                status = "ERROR"
                self.logger.errorf("grpc bidi %s failed after %d messages: %s",
                                   full_method, sent, exc)
                grpc_ctx.abort(self._status_for(exc), str(exc))
            finally:
                duration_us = int((time.time() - start) * 1e6)
                trace_id = span.trace_id if span else ""
                self.logger.info(RPCLog(f"{full_method} [{sent} msgs]",
                                        status, duration_us, trace_id))
                if span is not None:
                    span.set_attribute("grpc.stream_messages", sent)
                    span.set_status(status == "OK")
                    span.end()

        return handle

    def start(self) -> None:
        bound = self._server.add_insecure_port(f"0.0.0.0:{self.port}")
        if self.port == 0:
            self.port = bound
        self._server.start()
        self.logger.infof("gRPC server started on port %d", self.port)

    def stop(self) -> None:
        """Refuse new calls, give those in flight 0.5 s, then cancel them;
        returns once the server has stopped."""
        self._server.stop(grace=0.5).wait(timeout=5.5)
        self._pool.shutdown(wait=False, cancel_futures=True)


class GRPCClient:
    """Counterpart client for GenericService endpoints. JSON by default;
    pass protobuf Message serializers (SerializeToString/FromString) to
    speak the binary wire format of protoc-generated stubs."""

    def __init__(self, address: str):
        import grpc

        self._grpc = grpc
        self.channel = grpc.insecure_channel(address)

    def call(self, service: str, method: str, payload: Any, timeout_s: float = 5.0,
             metadata: Optional[Dict[str, str]] = None,
             serializer: Optional[Callable[[Any], bytes]] = None,
             deserializer: Optional[Callable[[bytes], Any]] = None) -> Any:
        fn = self.channel.unary_unary(
            f"/{service}/{method}",
            request_serializer=serializer or (
                lambda obj: json.dumps(obj, default=str).encode()),
            response_deserializer=deserializer or (
                lambda raw: json.loads(raw.decode()) if raw else None),
        )
        md = list((metadata or {}).items())
        return fn(payload, timeout=timeout_s, metadata=md)

    def stream(self, service: str, method: str, payload: Any,
               timeout_s: float = 30.0,
               metadata: Optional[Dict[str, str]] = None,
               serializer: Optional[Callable[[Any], bytes]] = None,
               deserializer: Optional[Callable[[bytes], Any]] = None):
        """Server-streaming call: yields deserialized messages as they
        arrive (the gRPC twin of reading an SSE response line by line)."""
        fn = self.channel.unary_stream(
            f"/{service}/{method}",
            request_serializer=serializer or (
                lambda obj: json.dumps(obj, default=str).encode()),
            response_deserializer=deserializer or (
                lambda raw: json.loads(raw.decode()) if raw else None),
        )
        md = list((metadata or {}).items())
        return fn(payload, timeout=timeout_s, metadata=md)

    def client_stream(self, service: str, method: str, payloads,
                      timeout_s: float = 30.0,
                      metadata: Optional[Dict[str, str]] = None,
                      serializer: Optional[Callable[[Any], bytes]] = None,
                      deserializer: Optional[Callable[[bytes], Any]] = None
                      ) -> Any:
        """Client-streaming call: sends every item of `payloads` (any
        iterable), returns the server's single aggregated response."""
        fn = self.channel.stream_unary(
            f"/{service}/{method}",
            request_serializer=serializer or (
                lambda obj: json.dumps(obj, default=str).encode()),
            response_deserializer=deserializer or (
                lambda raw: json.loads(raw.decode()) if raw else None),
        )
        md = list((metadata or {}).items())
        return fn(iter(payloads), timeout=timeout_s, metadata=md)

    def bidi(self, service: str, method: str, payloads,
             timeout_s: float = 30.0,
             metadata: Optional[Dict[str, str]] = None,
             serializer: Optional[Callable[[Any], bytes]] = None,
             deserializer: Optional[Callable[[bytes], Any]] = None):
        """Bidirectional call: sends `payloads` (any iterable — a generator
        can block to interleave with responses) and yields the server's
        messages as they arrive."""
        fn = self.channel.stream_stream(
            f"/{service}/{method}",
            request_serializer=serializer or (
                lambda obj: json.dumps(obj, default=str).encode()),
            response_deserializer=deserializer or (
                lambda raw: json.loads(raw.decode()) if raw else None),
        )
        md = list((metadata or {}).items())
        return fn(iter(payloads), timeout=timeout_s, metadata=md)

    def close(self) -> None:
        self.channel.close()

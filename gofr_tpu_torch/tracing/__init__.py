"""Lightweight OTel-shaped tracing: spans, W3C traceparent propagation, exporters.

A copy of ``gofr_tpu/tracing/__init__.py``, whole: ``Span`` (attributes,
status, ``traceparent``, ``to_dict``), ``Tracer`` (``start_span`` under a
parent span or an inbound ``traceparent`` header, ``span_at``),
``parse_traceparent``, the exporters (``NoopExporter``,
``InMemoryExporter``, ``LogExporter``; ``HTTPExporter`` with its bounded
queue, batching flusher thread and drop counter
``app_obs_dropped_spans_total``, and on it ``ZipkinExporter`` (v2 JSON),
``OTLPHTTPExporter`` (OTLP/HTTP JSON) and ``OTLPGRPCExporter`` (OTLP over
gRPC with hand-encoded protobuf)), and ``exporter_from_config``
(``TRACE_EXPORTER``, ``TRACER_URL``, ``APP_NAME``).

The module imports the standard library only. The HTTP exporters POST with
``urllib.request`` (the reference uses ``requests``, the same request); the
gRPC exporter imports ``grpc`` when it first sends, as the reference's does.

The serving engines open a ``tpu.generate`` span per request under the
caller's span or traceparent, stamp ``batch.id``/``tpu.slot``/
``tpu.prefill_bucket`` on it at admission, and, when built with a tracer,
emit a ``tpu.prefill``/``tpu.decode``/``tpu.verify`` span per dispatch that
closes at the dispatch's host sync (tpu/engine.py).
"""

from __future__ import annotations

import json
import random
import threading
import time
from typing import Any, Dict, List, Optional


def _rand_hex(nbytes: int) -> str:
    return "".join(f"{random.getrandbits(8):02x}" for _ in range(nbytes))


class Span:
    def __init__(self, tracer: "Tracer", name: str, trace_id: str, parent_id: Optional[str]):
        self.tracer = tracer
        self.name = name
        self.trace_id = trace_id
        self.span_id = _rand_hex(8)
        self.parent_id = parent_id
        self.start_time = time.time()
        self.end_time: Optional[float] = None
        self.attributes: Dict[str, Any] = {}
        self.status_ok = True
        self.status_message = ""

    def set_attribute(self, key: str, value: Any) -> None:
        self.attributes[key] = value

    def set_status(self, ok: bool, message: str = "") -> None:
        self.status_ok = ok
        self.status_message = message

    def end(self) -> None:
        if self.end_time is None:
            self.end_time = time.time()
            self.tracer._export(self)

    # context-manager sugar used by Context.trace()
    def __enter__(self) -> "Span":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc is not None:
            self.set_status(False, str(exc))
        self.end()

    @property
    def traceparent(self) -> str:
        return f"00-{self.trace_id}-{self.span_id}-01"

    def to_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "traceId": self.trace_id,
            "spanId": self.span_id,
            "parentId": self.parent_id,
            "startTime": self.start_time,
            "duration_ms": ((self.end_time or self.start_time) - self.start_time) * 1e3,
            "attributes": self.attributes,
            "ok": self.status_ok,
            "statusMessage": self.status_message,
        }


class Exporter:
    def export(self, span: Span) -> None:  # pragma: no cover - interface
        raise NotImplementedError


class NoopExporter(Exporter):
    def export(self, span: Span) -> None:
        pass


class InMemoryExporter(Exporter):
    """Test exporter; the analog of the reference's span assertions in middleware tests."""

    def __init__(self):
        self.spans: List[Span] = []
        self._lock = threading.Lock()

    def export(self, span: Span) -> None:
        with self._lock:
            self.spans.append(span)


class LogExporter(Exporter):
    def __init__(self, logger):
        self.logger = logger

    def export(self, span: Span) -> None:
        self.logger.debug({"span": span.to_dict()})


class HTTPExporter(Exporter):
    """POSTs finished span batches as JSON, like the reference's custom 'gofr'
    exporter (exporter.go:48-124). Failures are logged and dropped — tracing
    must never take the service down.

    Transport runs OFF the span-ending thread: spans end on the engine
    loop / request path, and a synchronous POST there turns a slow
    collector into serving latency. ``export`` only appends to a bounded
    queue (overflow drops the span and counts it in
    ``app_obs_dropped_spans_total`` — backpressure from a dead collector
    must shed spans, not block serving); one daemon thread drains the
    queue on batch-size or flush-interval boundaries (monotonic clock, so
    an NTP step can neither stall nor storm the flusher). ``close()``
    flushes what remains."""

    def __init__(self, url: str, logger=None, batch_size: int = 64,
                 flush_interval_s: float = 5.0, max_queue: int = 2048):
        self.url = url
        self.logger = logger
        self.batch_size = batch_size
        self.flush_interval_s = flush_interval_s
        self.max_queue = max(1, int(max_queue))
        self.metrics = None
        self.dropped_total = 0
        self._buf: List[Any] = []
        self._lock = threading.Lock()
        self._last_flush = time.monotonic()
        self._wake = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._closed = False
        self._force = False
        self._sending = False

    def use_metrics(self, metrics) -> None:
        """Wire the manager that carries app_obs_dropped_spans_total."""
        self.metrics = metrics

    def _span_payload(self, span: Span) -> Dict[str, Any]:
        """Wire shape of one span; subclasses override for zipkin/OTLP."""
        return span.to_dict()

    def _wrap_batch(self, batch: List[Dict[str, Any]]) -> Any:
        """Top-level request body; subclasses override (OTLP envelopes)."""
        return batch

    def export(self, span: Span) -> None:
        dropped = False
        with self._lock:
            if self._closed:
                return
            if len(self._buf) >= self.max_queue:
                self.dropped_total += 1
                dropped = True
            else:
                self._buf.append(self._span_payload(span))
                if self._thread is None or not self._thread.is_alive():
                    self._thread = threading.Thread(
                        target=self._loop, name="trace-export", daemon=True)
                    self._thread.start()
        if dropped:
            self._count_drop()
        elif len(self._buf) >= self.batch_size:  # benign racy read: the
            self._wake.set()                     # flusher re-checks under lock
        return

    def _count_drop(self) -> None:
        if self.metrics is not None:
            try:
                self.metrics.increment_counter("app_obs_dropped_spans_total")
            except Exception:  # noqa: BLE001 - self-observability best-effort
                pass

    def _loop(self) -> None:
        while True:
            self._wake.wait(timeout=self.flush_interval_s)
            self._wake.clear()
            while True:
                with self._lock:
                    closed = self._closed
                    now = time.monotonic()
                    due = bool(self._buf) and (
                        self._force or closed
                        or len(self._buf) >= self.batch_size
                        or now - self._last_flush >= self.flush_interval_s)
                    if due:
                        batch, self._buf = self._buf, []
                        self._last_flush = now
                        self._sending = True
                    else:
                        self._force = False
                        batch = None
                if batch is None:
                    break
                try:
                    self._send(batch)
                except Exception as exc:  # noqa: BLE001 - best-effort
                    if self.logger is not None:
                        self.logger.debugf("trace export failed: %s", exc)
                finally:
                    with self._lock:
                        self._sending = False
            if closed:
                return

    def flush(self, timeout_s: float = 5.0) -> bool:
        """Synchronously drain the queue (shutdown, tests). True when the
        queue and any in-flight send finished within the timeout."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            with self._lock:
                if not self._buf and not self._sending:
                    return True
                self._force = True
                started = self._thread is not None and self._thread.is_alive()
            if not started:  # nothing will ever drain it
                return False
            self._wake.set()
            time.sleep(0.005)
        return False

    def close(self, timeout_s: float = 5.0) -> None:
        """Flush remaining spans and stop the flusher thread."""
        with self._lock:
            self._closed = True
            thread = self._thread
        self._wake.set()
        if thread is not None:
            thread.join(timeout=timeout_s)

    def _send(self, batch: List[Dict[str, Any]]) -> None:
        """Transport; subclasses override (the gRPC exporter reuses the
        batching above with a different wire)."""
        import urllib.request

        req = urllib.request.Request(
            self.url, data=json.dumps(self._wrap_batch(batch)).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        with urllib.request.urlopen(req, timeout=2) as resp:
            resp.read()


class ZipkinExporter(HTTPExporter):
    """Zipkin v2 JSON wire format (POST /api/v2/spans) — the reference's
    zipkin exporter option (gofr.go:281-313). Shares the HTTPExporter's
    batch/flush machinery; only the payload shape differs."""

    def __init__(self, url: str, service_name: str = "gofr-tpu", **kw):
        super().__init__(url, **kw)
        self.service_name = service_name

    def _span_payload(self, span: Span) -> Dict[str, Any]:
        out = {
            "traceId": span.trace_id,
            "id": span.span_id,
            "name": span.name,
            "timestamp": int(span.start_time * 1e6),       # microseconds
            "duration": max(1, int(((span.end_time or span.start_time)
                                    - span.start_time) * 1e6)),
            "localEndpoint": {"serviceName": self.service_name},
            "tags": {k: str(v) for k, v in span.attributes.items()},
        }
        if span.parent_id:
            out["parentId"] = span.parent_id
        if not span.status_ok:
            out["tags"]["error"] = span.status_message or "error"
        return out


class OTLPHTTPExporter(HTTPExporter):
    """OTLP/HTTP JSON wire format (POST /v1/traces) — the reference's
    jaeger/OTLP exporter option (gofr.go:281-313 uses otlptracegrpc; the
    JSON-over-HTTP encoding needs no gRPC client)."""

    def __init__(self, url: str, service_name: str = "gofr-tpu", **kw):
        super().__init__(url, **kw)
        self.service_name = service_name

    def _span_payload(self, span: Span) -> Dict[str, Any]:
        def attr(key, value):
            if isinstance(value, bool):
                return {"key": key, "value": {"boolValue": value}}
            if isinstance(value, int):
                return {"key": key, "value": {"intValue": str(value)}}
            if isinstance(value, float):
                return {"key": key, "value": {"doubleValue": value}}
            return {"key": key, "value": {"stringValue": str(value)}}

        return {
            "traceId": span.trace_id,
            "spanId": span.span_id,
            "parentSpanId": span.parent_id or "",
            "name": span.name,
            "kind": 2,  # SPAN_KIND_SERVER
            "startTimeUnixNano": str(int(span.start_time * 1e9)),
            "endTimeUnixNano": str(int((span.end_time or span.start_time) * 1e9)),
            "attributes": [attr(k, v) for k, v in span.attributes.items()],
            "status": ({"code": 1} if span.status_ok
                       else {"code": 2, "message": span.status_message}),
        }

    def _wrap_batch(self, batch: List[Dict[str, Any]]) -> Any:
        return {"resourceSpans": [{
            "resource": {"attributes": [
                {"key": "service.name",
                 "value": {"stringValue": self.service_name}}]},
            "scopeSpans": [{"scope": {"name": "gofr_tpu"}, "spans": batch}],
        }]}


# ---------------------------------------------------------------------------
# OTLP over gRPC
# ---------------------------------------------------------------------------

def _pb_varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _pb_field(num: int, wire: int, payload: bytes) -> bytes:
    return _pb_varint((num << 3) | wire) + payload


def _pb_len(num: int, payload: bytes) -> bytes:
    return _pb_field(num, 2, _pb_varint(len(payload)) + payload)


def _pb_str(num: int, s: str) -> bytes:
    return _pb_len(num, s.encode("utf-8"))


def _pb_fixed64(num: int, n: int) -> bytes:
    import struct as _struct

    return _pb_field(num, 1, _struct.pack("<Q", n))


def _otlp_anyvalue(value) -> bytes:
    import struct as _struct

    if isinstance(value, bool):
        return _pb_field(2, 0, _pb_varint(1 if value else 0))
    if isinstance(value, int):
        # int_value is zigzag-free varint of the two's complement
        return _pb_field(3, 0, _pb_varint(value & 0xFFFFFFFFFFFFFFFF))
    if isinstance(value, float):
        return _pb_field(4, 1, _struct.pack("<d", value))
    return _pb_str(1, str(value))


def _otlp_keyvalue(key: str, value) -> bytes:
    return _pb_str(1, key) + _pb_len(2, _otlp_anyvalue(value))


class OTLPGRPCExporter(HTTPExporter):
    """OTLP over gRPC — the reference's actual exporter transport
    (gofr.go:281-313 wires otlptracegrpc). Speaks
    opentelemetry.proto.collector.trace.v1.TraceService/Export with
    hand-encoded protobuf bytes (varint/length-delimited/fixed64 — the
    whole OTLP span subset is ~60 lines of encoder), so there is no
    opentelemetry-sdk or generated-stub dependency at runtime; the wire
    bytes are verified against protoc-decoded stubs in
    tests/test_trace_exporters.py. Batching/flush rides HTTPExporter."""

    METHOD = ("/opentelemetry.proto.collector.trace.v1."
              "TraceService/Export")

    def __init__(self, target: str, service_name: str = "gofr-tpu", **kw):
        super().__init__(target, **kw)
        self.service_name = service_name
        self._channel = None

    def _span_payload(self, span: Span) -> Dict[str, Any]:
        return span  # encode at send time; batching stores the Span itself

    def _encode_span(self, span: Span) -> bytes:
        out = bytearray()
        out += _pb_len(1, bytes.fromhex(span.trace_id))
        out += _pb_len(2, bytes.fromhex(span.span_id))
        if span.parent_id:
            out += _pb_len(4, bytes.fromhex(span.parent_id))
        out += _pb_str(5, span.name)
        out += _pb_field(6, 0, _pb_varint(2))  # SPAN_KIND_SERVER
        out += _pb_fixed64(7, int(span.start_time * 1e9))
        out += _pb_fixed64(8, int((span.end_time or span.start_time) * 1e9))
        for k, v in span.attributes.items():
            out += _pb_len(9, _otlp_keyvalue(k, v))
        status = (_pb_field(3, 0, _pb_varint(1)) if span.status_ok else
                  _pb_str(2, span.status_message or "error")
                  + _pb_field(3, 0, _pb_varint(2)))
        out += _pb_len(15, status)
        return bytes(out)

    def _encode_request(self, spans: List[Span]) -> bytes:
        resource = _pb_len(1, _otlp_keyvalue("service.name",
                                             self.service_name))
        scope = _pb_str(1, "gofr_tpu")
        scope_spans = _pb_len(1, scope) + b"".join(
            _pb_len(2, self._encode_span(s)) for s in spans)
        resource_spans = _pb_len(1, resource) + _pb_len(2, scope_spans)
        return _pb_len(1, resource_spans)

    def _send(self, batch: List[Span]) -> None:
        import grpc

        if self._channel is None:
            self._channel = grpc.insecure_channel(self.url)
        fn = self._channel.unary_unary(
            self.METHOD,
            request_serializer=lambda b: b,
            response_deserializer=lambda b: b)
        fn(self._encode_request(batch), timeout=2)


class Tracer:
    def __init__(self, service_name: str = "gofr-tpu", exporter: Optional[Exporter] = None, sampled: bool = True):
        self.service_name = service_name
        self.exporter = exporter or NoopExporter()
        self.sampled = sampled

    def start_span(self, name: str, parent: Optional[Span] = None,
                   traceparent: Optional[str] = None) -> Span:
        trace_id, parent_id = None, None
        if parent is not None:
            trace_id, parent_id = parent.trace_id, parent.span_id
        elif traceparent:
            parsed = parse_traceparent(traceparent)
            if parsed:
                trace_id, parent_id = parsed
        if trace_id is None:
            trace_id = _rand_hex(16)
        return Span(self, name, trace_id, parent_id)

    def span_at(self, name: str, start_time: float, end_time: float,
                parent: Optional[Span] = None,
                trace_id: Optional[str] = None,
                parent_id: Optional[str] = None,
                attributes: Optional[Dict[str, Any]] = None) -> Span:
        """Synthesize an already-finished span with explicit timestamps,
        exported immediately. For after-the-fact reconstruction of phases
        measured outside the tracer (the engine flight recorder builds
        queue/prefill/decode child spans from a request's timeline once
        it completes — the phases were timed by the engine, not by open
        span objects)."""
        if parent is not None:
            trace_id, parent_id = parent.trace_id, parent.span_id
        span = Span(self, name, trace_id or _rand_hex(16), parent_id)
        span.start_time = float(start_time)
        if attributes:
            span.attributes.update(attributes)
        span.end_time = max(float(start_time), float(end_time))
        self._export(span)
        return span

    def _export(self, span: Span) -> None:
        if self.sampled:
            try:
                self.exporter.export(span)
            except Exception:  # noqa: BLE001
                pass


def parse_traceparent(header: str) -> Optional[tuple]:
    """Parse a W3C `traceparent` header -> (trace_id, span_id), or None."""
    parts = header.strip().split("-")
    if len(parts) != 4 or len(parts[1]) != 32 or len(parts[2]) != 16:
        return None
    return parts[1], parts[2]


def exporter_from_config(config, logger) -> Exporter:
    """Select exporter via TRACE_EXPORTER like gofr.go:281-313 selects
    jaeger/zipkin/gofr: 'zipkin' (v2 JSON), 'jaeger'/'otlp' (OTLP/HTTP
    JSON), 'otlp-grpc' (OTLP over gRPC, TRACER_URL = host:port), 'http'/
    'gofr' (plain JSON batches), 'log', 'memory'; default noop. Network
    exporters need TRACER_URL."""
    name = (config.get_or_default("TRACE_EXPORTER", "") or "").lower()
    if name == "log":
        return LogExporter(logger)
    if name in ("http", "gofr", "zipkin", "jaeger", "otlp", "otlp-grpc",
                "otlp_grpc"):
        url = config.get_or_default("TRACER_URL", "")
        service = config.get_or_default("APP_NAME", "gofr-tpu")
        if url:
            if name == "zipkin":
                return ZipkinExporter(url, service_name=service, logger=logger)
            if name in ("otlp-grpc", "otlp_grpc"):
                return OTLPGRPCExporter(url, service_name=service,
                                        logger=logger)
            if name in ("jaeger", "otlp"):
                return OTLPHTTPExporter(url, service_name=service, logger=logger)
            return HTTPExporter(url, logger=logger)
        logger.warn("TRACE_EXPORTER set but TRACER_URL missing; tracing disabled")
    if name == "memory":
        return InMemoryExporter()
    return NoopExporter()

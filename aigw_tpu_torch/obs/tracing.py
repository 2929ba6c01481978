"""Distributed tracing with OTel GenAI semantic conventions (the port's
own copy of ``aigw_tpu/obs/tracing.py``; standard library only).

Env-driven configuration, W3C ``traceparent`` and B3 propagation,
per-request spans carrying GenAI attributes, exported from a background
flusher as JSON lines (console), OTLP/HTTP (``/v1/traces``, protobuf by
default, or JSON) or OTLP/gRPC (the same protobuf bytes as a
``TraceService/Export`` unary call, through ``grpcio``, imported when the
first batch is sent). A failed export is dropped: telemetry never stops
the data plane.

Env vars (the reference honors the same ones):
- ``OTEL_SDK_DISABLED=true``            — tracing off
- ``OTEL_TRACES_EXPORTER=console|otlp|none``
- ``OTEL_EXPORTER_OTLP_ENDPOINT``       — e.g. http://collector:4318
  (default :4318, or :4317 for grpc)
- ``OTEL_EXPORTER_OTLP_PROTOCOL`` (or ``..._TRACES_PROTOCOL``) —
  ``http/protobuf`` (default), ``http/json`` or ``grpc``
- ``OTEL_PROPAGATORS``                  — tracecontext, b3, b3multi
- ``OTEL_SERVICE_NAME``                 — default aigw-tpu
- ``AIGW_HEADER_ATTRIBUTES``            — request headers copied onto
  the gateway's span (``header_attributes``)
"""

from __future__ import annotations

import json
import os
import queue
import re
import secrets
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Any

from aigw_tpu_torch.obs.otlp_proto import encode_traces

_TRACEPARENT_RE = re.compile(
    r"^([0-9a-f]{2})-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})$"
)


@dataclass
class SpanContext:
    trace_id: str  # 32 hex
    span_id: str  # 16 hex
    sampled: bool = True

    def traceparent(self) -> str:
        flags = "01" if self.sampled else "00"
        return f"00-{self.trace_id}-{self.span_id}-{flags}"

    @staticmethod
    def parse(header: str) -> "SpanContext | None":
        m = _TRACEPARENT_RE.match(header.strip())
        if not m:
            return None
        _, trace_id, span_id, flags = m.groups()
        if trace_id == "0" * 32 or span_id == "0" * 16:
            return None
        return SpanContext(trace_id=trace_id, span_id=span_id,
                           sampled=bool(int(flags, 16) & 1))


@dataclass
class Span:
    name: str
    context: SpanContext
    parent_span_id: str = ""
    start_ns: int = field(default_factory=time.time_ns)
    end_ns: int = 0
    attributes: dict[str, Any] = field(default_factory=dict)
    # (name, time_ns, attributes) — attrs {} for plain markers
    events: list[tuple[str, int, dict]] = field(default_factory=list)
    status_error: str = ""
    _tracer: "Tracer | None" = None

    def set(self, key: str, value: Any) -> "Span":
        self.attributes[key] = value
        return self

    def add_event(self, name: str,
                  attributes: dict[str, Any] | None = None) -> None:
        self.events.append((name, time.time_ns(), attributes or {}))

    def record_error(self, message: str) -> None:
        self.status_error = message

    def end(self) -> None:
        self.end_ns = time.time_ns()
        if self._tracer is not None:
            self._tracer._export(self)


class Propagators:
    """Context propagation per ``OTEL_PROPAGATORS`` (reference
    tracing.go uses contrib autoprop, same env contract): comma list of
    ``tracecontext`` (W3C traceparent), ``b3`` (single header),
    ``b3multi`` (X-B3-* headers). Default matches the OTel SDK:
    ``tracecontext,baggage`` (baggage is a no-op here). Extraction tries
    each configured propagator in order; injection writes all of them."""

    def __init__(self, spec: str = ""):
        spec = spec or os.environ.get("OTEL_PROPAGATORS",
                                      "tracecontext,baggage")
        self.names = [p.strip().lower() for p in spec.split(",")
                      if p.strip() and p.strip().lower() != "baggage"]
        if not self.names:
            self.names = ["tracecontext"]

    def extract(self, headers: dict[str, str]) -> "SpanContext | None":
        for name in self.names:
            ctx = None
            if name == "tracecontext":
                ctx = SpanContext.parse(headers.get("traceparent", ""))
            elif name == "b3":
                ctx = self._parse_b3_single(headers.get("b3", ""))
            elif name == "b3multi":
                ctx = self._parse_b3_multi(headers)
            if ctx is not None:
                return ctx
        return None

    def inject(self, ctx: "SpanContext", headers: dict[str, str]) -> None:
        for name in self.names:
            if name == "tracecontext":
                headers["traceparent"] = ctx.traceparent()
            elif name == "b3":
                headers["b3"] = (
                    f"{ctx.trace_id}-{ctx.span_id}-"
                    f"{'1' if ctx.sampled else '0'}"
                )
            elif name == "b3multi":
                headers["x-b3-traceid"] = ctx.trace_id
                headers["x-b3-spanid"] = ctx.span_id
                headers["x-b3-sampled"] = "1" if ctx.sampled else "0"

    @staticmethod
    def _hex_id(value: str, width: int) -> str:
        """Lowercased id iff exactly ``width`` hex chars (64-bit B3
        trace ids are left-padded first); "" otherwise. Ids flow into
        protobuf export via bytes.fromhex, so non-hex input must be
        rejected here, not crash the flusher."""
        value = value.strip().lower()
        if width == 32 and len(value) == 16:
            value = "0" * 16 + value
        if len(value) != width or not all(
                c in "0123456789abcdef" for c in value):
            return ""
        return value

    @classmethod
    def _parse_b3_single(cls, value: str) -> "SpanContext | None":
        parts = value.strip().split("-")
        if len(parts) < 2:
            return None
        trace_id = cls._hex_id(parts[0], 32)
        span_id = cls._hex_id(parts[1], 16)
        if not trace_id or not span_id:
            return None
        sampled = len(parts) < 3 or parts[2] not in ("0", "false")
        return SpanContext(trace_id=trace_id, span_id=span_id,
                           sampled=sampled)

    @classmethod
    def _parse_b3_multi(cls, headers: dict[str, str]) -> "SpanContext | None":
        trace_id = cls._hex_id(headers.get("x-b3-traceid", ""), 32)
        span_id = cls._hex_id(headers.get("x-b3-spanid", ""), 16)
        if not trace_id or not span_id:
            return None
        sampled = headers.get("x-b3-sampled", "1") not in ("0", "false")
        return SpanContext(trace_id=trace_id, span_id=span_id,
                           sampled=sampled)


class Tracer:
    """Span factory + background exporter."""

    def __init__(self, exporter: str = "", service_name: str = ""):
        disabled = os.environ.get("OTEL_SDK_DISABLED", "").lower() == "true"
        self.exporter = (
            "none" if disabled
            else (exporter or os.environ.get("OTEL_TRACES_EXPORTER",
                                             "none")).lower()
        )
        self.service_name = (
            service_name or os.environ.get("OTEL_SERVICE_NAME", "aigw-tpu")
        )
        # standard OTLP protocol selection (the SDK's env contract):
        # protobuf is the default a stock collector expects, http/json
        # the other HTTP encoding, grpc the collector's :4317 service
        self.protocol = os.environ.get(
            "OTEL_EXPORTER_OTLP_TRACES_PROTOCOL",
            os.environ.get("OTEL_EXPORTER_OTLP_PROTOCOL",
                           "http/protobuf"),
        ).lower()
        self.endpoint = os.environ.get(
            "OTEL_EXPORTER_OTLP_ENDPOINT",
            "http://127.0.0.1:4317" if self.protocol == "grpc"
            else "http://127.0.0.1:4318",
        ).rstrip("/")
        self._grpc_call = None  # the TraceService/Export stub, built lazily
        self.propagators = Propagators()
        self._q: "queue.Queue[Span]" = queue.Queue(maxsize=4096)
        self._flusher: threading.Thread | None = None
        if self.exporter == "otlp":
            self._flusher = threading.Thread(
                target=self._flush_loop, name="otlp-flusher", daemon=True
            )
            self._flusher.start()

    @property
    def enabled(self) -> bool:
        return self.exporter in ("console", "otlp")

    def start_span(
        self, name: str, parent: SpanContext | None = None
    ) -> Span:
        # parent-based sampling: honor the caller's opt-out (flags 00)
        sampled = parent.sampled if parent else True
        ctx = SpanContext(
            trace_id=parent.trace_id if parent else secrets.token_hex(16),
            span_id=secrets.token_hex(8),
            sampled=sampled,
        )
        return Span(
            name=name,
            context=ctx,
            parent_span_id=parent.span_id if parent else "",
            _tracer=self if self.enabled and sampled else None,
        )

    # -- export -----------------------------------------------------------
    def _export(self, span: Span) -> None:
        if self.exporter == "console":
            print(json.dumps(self._to_dict(span)), file=sys.stderr)
        elif self.exporter == "otlp":
            try:
                self._q.put_nowait(span)
            except queue.Full:
                pass  # drop rather than block the data plane

    def _to_dict(self, s: Span) -> dict[str, Any]:
        return {
            "name": s.name,
            "traceId": s.context.trace_id,
            "spanId": s.context.span_id,
            "parentSpanId": s.parent_span_id,
            "startTimeUnixNano": s.start_ns,
            "endTimeUnixNano": s.end_ns,
            "attributes": s.attributes,
            "events": [
                {"name": n, "timeUnixNano": t,
                 **({"attributes": a} if a else {})}
                for n, t, a in s.events
            ],
            "status": {"code": 2, "message": s.status_error}
            if s.status_error
            else {"code": 1},
            "service": self.service_name,
        }

    def _flush_loop(self) -> None:
        import urllib.request

        while True:
            spans = [self._q.get()]
            try:
                while len(spans) < 128:
                    spans.append(self._q.get_nowait())
            except queue.Empty:
                pass
            try:
                if self.protocol == "grpc":
                    # the same ExportTraceServiceRequest bytes, carried
                    # as a gRPC unary call instead of an HTTP POST
                    self._grpc_export(
                        encode_traces(spans, self.service_name))
                    continue
                if self.protocol == "http/json":
                    data = json.dumps(self._otlp_payload(spans)).encode()
                    ctype = "application/json"
                else:  # http/protobuf, the standard default
                    data = encode_traces(spans, self.service_name)
                    ctype = "application/x-protobuf"
                req = urllib.request.Request(
                    f"{self.endpoint}/v1/traces",
                    data=data,
                    headers={"content-type": ctype},
                )
                urllib.request.urlopen(req, timeout=5)
            except Exception:  # noqa: BLE001 — telemetry must never crash
                pass

    def _grpc_export(self, data: bytes) -> None:
        """``opentelemetry.proto.collector.trace.v1.TraceService/Export``
        on the endpoint: a TLS channel for an https scheme, else an
        insecure one."""
        if self._grpc_call is None:
            import grpc

            target = self.endpoint
            secure = target.startswith("https://")
            for prefix in ("http://", "https://"):
                if target.startswith(prefix):
                    target = target[len(prefix):]
            channel = (
                grpc.secure_channel(target, grpc.ssl_channel_credentials())
                if secure else grpc.insecure_channel(target)
            )
            self._grpc_call = channel.unary_unary(
                "/opentelemetry.proto.collector.trace.v1."
                "TraceService/Export",
                request_serializer=lambda b: b,
                response_deserializer=lambda b: b,
            )
        self._grpc_call(data, timeout=5)

    def _otlp_payload(self, spans: list[Span]) -> dict[str, Any]:
        def attr(k: str, v: Any) -> dict[str, Any]:
            if isinstance(v, bool):
                val: dict[str, Any] = {"boolValue": v}
            elif isinstance(v, int):
                val = {"intValue": str(v)}
            elif isinstance(v, float):
                val = {"doubleValue": v}
            else:
                val = {"stringValue": str(v)}
            return {"key": k, "value": val}

        return {
            "resourceSpans": [
                {
                    "resource": {
                        "attributes": [
                            attr("service.name", self.service_name)
                        ]
                    },
                    "scopeSpans": [
                        {
                            "scope": {"name": "aigw_tpu"},
                            "spans": [
                                {
                                    **{
                                        k: v
                                        for k, v in self._to_dict(s).items()
                                        if k in ("name", "traceId", "spanId",
                                                 "parentSpanId", "status")
                                    },
                                    "kind": 3,  # CLIENT
                                    "startTimeUnixNano": str(s.start_ns),
                                    "endTimeUnixNano": str(s.end_ns),
                                    "attributes": [
                                        attr(k, v)
                                        for k, v in s.attributes.items()
                                    ],
                                    "events": [
                                        {"name": n,
                                         "timeUnixNano": str(t),
                                         "attributes": [
                                             attr(k, v)
                                             for k, v in a.items()
                                         ]}
                                        for n, t, a in s.events
                                    ],
                                }
                                for s in spans
                            ],
                        }
                    ],
                }
            ]
        }


def genai_attributes(
    *,
    operation: str,
    request_model: str,
    response_model: str = "",
    backend: str = "",
    input_tokens: int = 0,
    output_tokens: int = 0,
    streaming: bool = False,
) -> dict[str, Any]:
    """GenAI semconv span attributes (reference openinference/* builders)."""
    attrs: dict[str, Any] = {
        "gen_ai.operation.name": operation,
        "gen_ai.request.model": request_model,
        "gen_ai.provider.name": backend,
        "llm.is_streaming": streaming,
    }
    if response_model:
        attrs["gen_ai.response.model"] = response_model
    if input_tokens:
        attrs["gen_ai.usage.input_tokens"] = input_tokens
    if output_tokens:
        attrs["gen_ai.usage.output_tokens"] = output_tokens
    return attrs


def parse_header_attribute_mapping(spec: str) -> list[tuple[str, str]]:
    """``header:attribute[,header:attribute...]`` → the mapping list
    (lower-cased header names; pairs missing either side are skipped).
    The gateway reads it from ``AIGW_HEADER_ATTRIBUTES``."""
    out: list[tuple[str, str]] = []
    for pair in spec.split(","):
        pair = pair.strip()
        if not pair:
            continue
        header, _, attr = pair.partition(":")
        if header and attr:
            out.append((header.strip().lower(), attr.strip()))
    return out


DEFAULT_HEADER_ATTRIBUTES = "agent-session-id:session.id"


def header_attributes(
    headers: dict[str, str], mapping: list[tuple[str, str]]
) -> dict[str, str]:
    """The span attributes of the mapped headers the request carries."""
    return {attr: headers[h] for h, attr in mapping if h in headers}


#: the trace-context headers a gateway relays verbatim to the replica
#: when it starts no span of its own, so the replica's spans and flight
#: entries parent on the caller's trace
TRACE_HEADERS = ("traceparent", "b3", "x-b3-traceid", "x-b3-spanid",
                 "x-b3-sampled")


def relay_trace_headers(client_headers: dict[str, str],
                        headers: dict[str, str]) -> None:
    """Copy the caller's trace-context headers into ``headers``."""
    for h in TRACE_HEADERS:
        if h in client_headers:
            headers[h] = client_headers[h]

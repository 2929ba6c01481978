"""OTLP/HTTP protobuf encoding, hand-rolled on the standard library (the
port's own copy of ``aigw_tpu/obs/otlp_proto.py``, byte for byte the
same encoder).

The OTel SDK's default trace protocol is OTLP/HTTP protobuf (``POST
/v1/traces``, ``content-type: application/x-protobuf``). The message
subset it needs is small and frozen, so it is encoded here directly:

    ExportTraceServiceRequest { repeated ResourceSpans resource_spans=1 }
    ResourceSpans { Resource resource=1; repeated ScopeSpans scope_spans=2 }
    Resource      { repeated KeyValue attributes=1 }
    ScopeSpans    { InstrumentationScope scope=1; repeated Span spans=2 }
    InstrumentationScope { string name=1 }
    Span { bytes trace_id=1; bytes span_id=2; bytes parent_span_id=4;
           string name=5; SpanKind kind=6; fixed64 start=7; fixed64 end=8;
           repeated KeyValue attributes=9; repeated Event events=11;
           Status status=15 }
    Event  { fixed64 time_unix_nano=1; string name=2;
             repeated KeyValue attributes=3 }
    Status { string message=2; StatusCode code=3 }
    KeyValue { string key=1; AnyValue value=2 }
    AnyValue { string_value=1 | bool_value=2 | int_value=3 |
               double_value=4 }

(opentelemetry-proto trace/v1/trace.proto.) ``decode_message`` reads
any of it back.
"""

from __future__ import annotations

import struct
from typing import Any


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _len_field(field: int, payload: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(payload)) + payload


def _str_field(field: int, s: str) -> bytes:
    return _len_field(field, s.encode("utf-8"))


def _fixed64(field: int, n: int) -> bytes:
    return _tag(field, 1) + struct.pack("<Q", n)


def _varint_field(field: int, n: int) -> bytes:
    return _tag(field, 0) + _varint(n)


def _any_value(v: Any) -> bytes:
    if isinstance(v, bool):
        return _varint_field(2, 1 if v else 0)
    if isinstance(v, int):
        # int_value is a signed varint (zigzag NOT used; negative values
        # encode as 10-byte two's complement per proto3 int64)
        return _tag(3, 0) + _varint(v & 0xFFFFFFFFFFFFFFFF)
    if isinstance(v, float):
        return _tag(4, 1) + struct.pack("<d", v)
    return _str_field(1, str(v))


def _key_value(k: str, v: Any) -> bytes:
    return _str_field(1, k) + _len_field(2, _any_value(v))


def _span(s: Any) -> bytes:
    """``s`` is ``obs.tracing.Span`` (duck-typed to avoid a cycle)."""
    out = bytearray()
    out += _len_field(1, bytes.fromhex(s.context.trace_id))
    out += _len_field(2, bytes.fromhex(s.context.span_id))
    if s.parent_span_id:
        out += _len_field(4, bytes.fromhex(s.parent_span_id))
    out += _str_field(5, s.name)
    out += _varint_field(6, 3)  # SPAN_KIND_CLIENT
    out += _fixed64(7, s.start_ns)
    out += _fixed64(8, s.end_ns)
    for k, v in s.attributes.items():
        out += _len_field(9, _key_value(k, v))
    for name, t_ns, attrs in s.events:
        ev = _fixed64(1, t_ns) + _str_field(2, name)
        for k, v in attrs.items():
            ev += _len_field(3, _key_value(k, v))  # Event.attributes=3
        out += _len_field(11, ev)
    if s.status_error:
        out += _len_field(15, _str_field(2, s.status_error)
                          + _varint_field(3, 2))  # STATUS_CODE_ERROR
    else:
        out += _len_field(15, _varint_field(3, 1))  # STATUS_CODE_OK
    return bytes(out)


def encode_traces(spans: list[Any], service_name: str,
                  scope: str = "aigw_tpu") -> bytes:
    """spans → serialized ExportTraceServiceRequest bytes (POST body for
    /v1/traces with content-type application/x-protobuf)."""
    resource = _len_field(1, _key_value("service.name", service_name))
    scope_spans = _len_field(1, _str_field(1, scope))
    for s in spans:
        scope_spans += _len_field(2, _span(s))
    resource_spans = _len_field(1, resource) + _len_field(2, scope_spans)
    return _len_field(1, resource_spans)


# ---------------------------------------------------------------------------
# minimal decoder: lets a test (or a local trace sink) read the payload
# back the way a stock protobuf parser would

def _read_varint(buf: bytes, i: int) -> tuple[int, int]:
    shift = 0
    n = 0
    while True:
        b = buf[i]
        n |= (b & 0x7F) << shift
        i += 1
        if not b & 0x80:
            return n, i
        shift += 7


def decode_message(buf: bytes) -> dict[int, list[Any]]:
    """Generic wire-format decode → {field: [values]}; length-delimited
    values stay bytes (decode nested messages by calling again)."""
    out: dict[int, list[Any]] = {}
    i = 0
    while i < len(buf):
        key, i = _read_varint(buf, i)
        field, wire = key >> 3, key & 7
        if wire == 0:
            v, i = _read_varint(buf, i)
        elif wire == 1:
            v = struct.unpack("<Q", buf[i:i + 8])[0]
            i += 8
        elif wire == 2:
            ln, i = _read_varint(buf, i)
            v = buf[i:i + ln]
            i += ln
        elif wire == 5:
            v = struct.unpack("<I", buf[i:i + 4])[0]
            i += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        out.setdefault(field, []).append(v)
    return out

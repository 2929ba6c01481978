"""AWS event-stream (application/vnd.amazon.eventstream) binary framing.

Bedrock streaming responses use this framing instead of SSE; the upstream gateway
re-encodes it to OpenAI SSE in its openai→awsbedrock translator. Frame
layout (big-endian):

    4B total length | 4B headers length | 4B prelude CRC32
    headers (name-len u8, name, type u8, value) ...
    payload
    4B message CRC32

Header value types: 7 = string (u16 length prefix). Other types are not
produced by Bedrock response streams but are skipped structurally.

The port's copy of ``aigw_tpu/translate/eventstream.py``. Once
``utils/native.load()`` has run (the gateway's ``run`` calls it), the
C++ scanner finds the frames and checks their CRCs; the Python loop
below is its plain version, byte-exact with it.
"""

from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass

from aigw_tpu_torch.utils import native as _native


@dataclass
class EventStreamMessage:
    headers: dict[str, str]
    payload: bytes

    @property
    def event_type(self) -> str:
        return self.headers.get(":event-type", "")

    @property
    def exception_type(self) -> str:
        return self.headers.get(":exception-type", "")


class EventStreamParser:
    """Incremental decoder: feed() bytes, get complete messages."""

    def __init__(self) -> None:
        self._buf = b""

    def feed(self, chunk: bytes) -> list[EventStreamMessage]:
        self._buf += chunk
        out: list[EventStreamMessage] = []
        # native fast path: frame boundaries + CRCs validated in C++
        # (aigw_tpu_torch/native/eventstream_scan.cpp); headers still parse in Python
        while True:
            scan = _native.es_scan(self._buf)
            if scan is None:
                break
            frames, tail, truncated = scan
            for off, total, hlen in frames:
                headers = _parse_headers(
                    self._buf[off + 12 : off + 12 + hlen])
                payload = self._buf[off + 12 + hlen : off + total - 4]
                out.append(EventStreamMessage(headers=headers,
                                              payload=payload))
            self._buf = self._buf[tail:]
            if not truncated:
                return out
        while len(self._buf) >= 16:
            total_len, headers_len, prelude_crc = struct.unpack_from(
                ">III", self._buf
            )
            if len(self._buf) < total_len:
                break
            if zlib.crc32(self._buf[:8]) != prelude_crc:
                raise ValueError("event-stream prelude CRC mismatch")
            frame, self._buf = self._buf[:total_len], self._buf[total_len:]
            msg_crc = struct.unpack(">I", frame[-4:])[0]
            if zlib.crc32(frame[:-4]) != msg_crc:
                raise ValueError("event-stream message CRC mismatch")
            headers = _parse_headers(frame[12 : 12 + headers_len])
            payload = frame[12 + headers_len : -4]
            out.append(EventStreamMessage(headers=headers, payload=payload))
        return out


def _parse_headers(data: bytes) -> dict[str, str]:
    headers: dict[str, str] = {}
    i = 0
    while i < len(data):
        name_len = data[i]
        i += 1
        name = data[i : i + name_len].decode("utf-8")
        i += name_len
        vtype = data[i]
        i += 1
        if vtype == 7:  # string
            (vlen,) = struct.unpack_from(">H", data, i)
            i += 2
            headers[name] = data[i : i + vlen].decode("utf-8")
            i += vlen
        elif vtype in (0, 1):  # bool true/false — no value bytes
            headers[name] = "true" if vtype == 0 else "false"
        elif vtype == 2:  # byte
            headers[name] = str(data[i])
            i += 1
        elif vtype == 3:  # short
            headers[name] = str(struct.unpack_from(">h", data, i)[0])
            i += 2
        elif vtype == 4:  # integer
            headers[name] = str(struct.unpack_from(">i", data, i)[0])
            i += 4
        elif vtype in (5, 8):  # long / timestamp
            headers[name] = str(struct.unpack_from(">q", data, i)[0])
            i += 8
        elif vtype == 6:  # byte array
            (vlen,) = struct.unpack_from(">H", data, i)
            i += 2 + vlen
        elif vtype == 9:  # uuid
            i += 16
        else:
            raise ValueError(f"unknown event-stream header type {vtype}")
    return headers


def encode_message(headers: dict[str, str], payload: bytes) -> bytes:
    """Encode one event-stream frame (used by tests and the Bedrock fake)."""
    hdr = b""
    for name, value in headers.items():
        nb, vb = name.encode(), value.encode()
        hdr += struct.pack("B", len(nb)) + nb + b"\x07" + struct.pack(">H", len(vb)) + vb
    total = 12 + len(hdr) + len(payload) + 4
    prelude = struct.pack(">II", total, len(hdr))
    prelude_crc = struct.pack(">I", zlib.crc32(prelude))
    body = prelude + prelude_crc + hdr + payload
    return body + struct.pack(">I", zlib.crc32(body))

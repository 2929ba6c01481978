"""Server-Sent Events incremental parsing and encoding (the port's copy
of ``aigw_tpu/translate/sse.py``). Once ``utils/native.load()`` has run
(the gateway's ``run`` calls it), the C++ scanner finds the event
boundaries; the Python loop below is its plain version, byte-exact with
it.

The streaming hot loop (reference extproc processes SSE per-chunk in
ProcessResponseBody, processor_impl.go:481-575). The parser is incremental:
bytes arrive in arbitrary chunk boundaries from the upstream; events are
emitted as soon as their terminating blank line is seen, and leftover bytes
are buffered.
"""

from __future__ import annotations

from dataclasses import dataclass

from aigw_tpu_torch.utils import native as _native


@dataclass
class SSEEvent:
    data: str = ""
    event: str = ""
    id: str = ""
    retry: str = ""

    def encode(self) -> bytes:
        out = []
        if self.event:
            out.append(f"event: {self.event}")
        if self.id:
            out.append(f"id: {self.id}")
        if self.retry:
            out.append(f"retry: {self.retry}")
        for line in self.data.split("\n"):
            out.append(f"data: {line}")
        return ("\n".join(out) + "\n\n").encode()


@dataclass
class SSEParser:
    """Incremental SSE decoder; feed() returns completed events."""

    _buf: bytes = b""

    def feed(self, chunk: bytes) -> list[SSEEvent]:
        self._buf += chunk
        events: list[SSEEvent] = []
        # Fast path: the C++ scanner finds all boundaries in one pass
        # (aigw_tpu_torch/native/sse_scan.cpp; byte-exact with the loop below).
        scan = _native.sse_scan(self._buf)
        if scan is not None:
            while True:
                boundaries, tail, truncated = scan
                start = 0
                for end, sep in boundaries:
                    ev = _parse_event(self._buf[start:end])
                    if ev is not None:
                        events.append(ev)
                    start = end + sep
                self._buf = self._buf[tail:]
                if not truncated:
                    return events
                scan = _native.sse_scan(self._buf)
        while True:
            # An event terminates at the first blank line.
            sep = -1
            for cand in (b"\n\n", b"\r\n\r\n"):
                i = self._buf.find(cand)
                if i != -1 and (sep == -1 or i < sep):
                    sep = i
                    seplen = len(cand)
            if sep == -1:
                break
            raw, self._buf = self._buf[:sep], self._buf[sep + seplen :]
            ev = _parse_event(raw)
            if ev is not None:
                events.append(ev)
        return events

    def flush(self) -> list[SSEEvent]:
        """Handle a final event not terminated by a blank line."""
        if not self._buf.strip():
            self._buf = b""
            return []
        ev = _parse_event(self._buf)
        self._buf = b""
        return [ev] if ev is not None else []


def _parse_event(raw: bytes) -> SSEEvent | None:
    ev = SSEEvent()
    data_lines: list[str] = []
    for line in raw.replace(b"\r\n", b"\n").split(b"\n"):
        if not line or line.startswith(b":"):
            continue
        name, _, value = line.partition(b":")
        if value.startswith(b" "):
            value = value[1:]
        text = value.decode("utf-8", errors="replace")
        fname = name.decode("ascii", errors="replace")
        if fname == "data":
            data_lines.append(text)
        elif fname == "event":
            ev.event = text
        elif fname == "id":
            ev.id = text
        elif fname == "retry":
            ev.retry = text
    ev.data = "\n".join(data_lines)
    if not ev.data and not ev.event:
        return None
    return ev

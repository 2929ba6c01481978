"""OTel spans + costs for native-path requests (the port's copy of
``aigw_tpu/obs/native_spans.py``).

The C++ core (``aigw_tpu_torch/native/proxy_core.cpp``) relays eligible
requests without ever entering Python: fast, but with no span and no
cost of its own. Instead of teaching the core OTLP, the core writes one
JSON access-log line per request carrying the span identity it already
used on the wire (it generates a child span id and re-parents the
upstream's ``traceparent``), and this tailer turns each line into a real
OTel span through the gateway's existing exporter (protobuf OTLP / JSON
/ console) and — when the config defines LLMRequestCosts — computes the
CEL costs from the mined token usage post-hoc, feeding the same cost
sink the Python path uses. The reference gets the equivalent for free
because Envoy's filters run in-process; here the access-log pipe is the
cheap side-channel.
"""

from __future__ import annotations

import json
import logging
import os
import threading
from typing import Any, Callable

from aigw_tpu_torch.obs.tracing import Span, SpanContext, Tracer

logger = logging.getLogger(__name__)

_OPERATIONS = {
    "/v1/chat/completions": "chat",
    "/v1/completions": "text_completion",
    "/v1/embeddings": "embeddings",
    "/v1/messages": "chat",
}


class NativeLogTailer:
    """Tail the core's JSON-lines access log; emit a span per line.

    Rotation-safe: the file is reopened when its inode changes or it
    shrinks. Lines written before ``start()`` are skipped (history is
    not replayed as fresh telemetry). A log that does not exist yet at
    ``start()`` holds no history: once it appears it is read from its
    first line (the reference seeks to its end then, and loses the lines
    a core writes before the next poll)."""

    def __init__(
        self,
        path: str,
        tracer: Tracer,
        cost_fn: Callable[[dict[str, Any]], None] | None = None,
        poll_interval: float = 0.3,
        from_start: bool = False,
    ):
        self.path = path
        self.tracer = tracer
        self.cost_fn = cost_fn
        self.poll_interval = poll_interval
        self._from_start = from_start
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._run, name="native-span-tailer", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)

    # -- tail loop --------------------------------------------------------
    def _run(self) -> None:
        f = None
        ino = -1
        try:
            while not self._stop.is_set():
                if f is None:
                    try:
                        f = open(self.path, "r", encoding="utf-8",
                                 errors="replace")
                        ino = os.fstat(f.fileno()).st_ino
                        if not self._from_start:
                            f.seek(0, os.SEEK_END)
                        self._from_start = False  # reopens read fully
                    except FileNotFoundError:
                        # every line of a log made after start() is new
                        self._from_start = True
                        self._stop.wait(self.poll_interval)
                        continue
                pos = f.tell()  # cookie BEFORE the read: len(line) is
                # chars, not bytes, and non-ASCII log content would skew
                # arithmetic on the opaque text-mode offset
                line = f.readline()
                if line:
                    if line.endswith("\n"):
                        self._handle_line(line)
                    else:
                        # torn tail: rewind and wait for the writer
                        f.seek(pos)
                        self._stop.wait(self.poll_interval)
                    continue
                # EOF: check rotation/truncation, then wait
                try:
                    st = os.stat(self.path)
                    if st.st_ino != ino or st.st_size < f.tell():
                        f.close()
                        f = None
                        self._from_start = True
                        continue
                except FileNotFoundError:
                    f.close()
                    f = None
                self._stop.wait(self.poll_interval)
        finally:
            if f is not None:
                f.close()

    def _handle_line(self, line: str) -> None:
        try:
            entry = json.loads(line)
        except json.JSONDecodeError:
            return
        if not isinstance(entry, dict) or not entry.get("native"):
            return
        try:
            self._emit(entry)
        except Exception:  # noqa: BLE001 — telemetry must never crash
            logger.debug("native span emit failed", exc_info=True)

    def _emit(self, entry: dict[str, Any]) -> None:
        trace_id = str(entry.get("trace_id", ""))
        span_id = str(entry.get("span_id", ""))
        usage = entry.get("usage") or {}
        if self.cost_fn is not None and usage:
            self.cost_fn(entry)
        if not self.tracer.enabled or len(trace_id) != 32 \
                or len(span_id) != 16:
            return
        if entry.get("sampled") is False:
            return
        start_ns = int(entry.get("start_unix_ns", 0) or 0)
        duration_ms = float(entry.get("duration_ms", 0) or 0)
        path = str(entry.get("path", ""))
        model = str(entry.get("model", ""))
        operation = _OPERATIONS.get(path, "chat")
        span = Span(
            name=f"{operation} {model}".strip(),
            context=SpanContext(trace_id=trace_id, span_id=span_id),
            parent_span_id=str(entry.get("parent_span_id", "")),
            start_ns=start_ns,
            attributes={
                "gen_ai.operation.name": operation,
                "gen_ai.request.model": model,
                "gen_ai.provider.name": str(entry.get("backend", "")),
                "http.response.status_code": int(
                    entry.get("status", 0) or 0),
                "aigw.native": True,
                "aigw.relay.result": str(entry.get("result", "")),
            },
        )
        if usage.get("prompt_tokens"):
            span.attributes["gen_ai.usage.input_tokens"] = int(
                usage["prompt_tokens"])
        if usage.get("completion_tokens"):
            span.attributes["gen_ai.usage.output_tokens"] = int(
                usage["completion_tokens"])
        status = int(entry.get("status", 0) or 0)
        if status >= 500 or entry.get("result") == "upstream_broken":
            span.status_error = f"upstream status {status}"
        span.end_ns = start_ns + int(duration_ms * 1e6)
        self.tracer._export(span)


def make_cost_fn(get_runtime, cost_sink) -> Callable[[dict[str, Any]], None]:
    """Cost computation for native-path requests: CEL costs from the
    mined usage counters, post-hoc (so cost-bearing rules need not stay
    on the Python path). ``get_runtime`` is late-bound so
    config hot reloads pick up new cost programs."""
    from aigw_tpu_torch.gateway.costs import TokenUsage

    def cost_fn(entry: dict[str, Any]) -> None:
        runtime = get_runtime()
        if runtime is None:
            return
        usage = entry.get("usage") or {}
        tu = TokenUsage(
            input_tokens=int(usage.get("prompt_tokens", 0) or 0),
            output_tokens=int(usage.get("completion_tokens", 0) or 0),
            total_tokens=int(usage.get("total_tokens", 0) or 0),
        )
        model = str(entry.get("model", ""))
        backend = str(entry.get("backend", ""))
        # native rules never carry route-level costs (they stay on the
        # Python path), so the global calculator is the right one
        costs = runtime.cost_calculator_for("").calculate(
            tu, model=model, backend=backend, route_name="")
        if costs and cost_sink is not None:
            cost_sink(costs, {"model": model, "backend": backend,
                              "route": "", "native": "true"})

    return cost_fn

"""Structured JSON access logs (the port's copy of
``aigw_tpu/obs/accesslog.py``; standard library only).

One JSON line per gateway request, carrying the same enrichment the
reference injects into Envoy's access log via dynamic metadata
(``internal/extproc/util.go`` buildRequestHeaderDynamicMetadata →
``io.envoy.ai_gateway`` namespace: model name, backend name, route name,
plus per-request costs and token usage recorded at end-of-stream).

Configured via ``AIGW_ACCESS_LOG``:
- unset/empty/``off`` — disabled
- ``stdout`` / ``stderr`` — write to that stream
- any other value — append to that file path
"""

from __future__ import annotations

import json
import logging
import os
import queue
import sys
import threading
import time
from typing import Any, IO

logger = logging.getLogger(__name__)


class AccessLogger:
    """Lines are handed to a daemon writer thread — a synchronous
    write+flush per request on the event loop would be exactly the
    hot-path tax that dropping aiohttp's access log removed. The queue
    is bounded; overflow drops lines rather than stalling requests."""

    _QUEUE_MAX = 8192

    def __init__(self, target: str | None = None):
        if target is None:
            target = os.environ.get("AIGW_ACCESS_LOG", "")
        self._target = (target or "").strip()
        self._fp: IO[str] | None = None
        self._q: "queue.Queue[str]" = queue.Queue(maxsize=self._QUEUE_MAX)
        if not self._target or self._target.lower() == "off":
            return
        if self._target == "stdout":
            self._fp = sys.stdout
        elif self._target == "stderr":
            self._fp = sys.stderr
        else:
            try:
                self._fp = open(self._target, "a", encoding="utf-8")
            except OSError as e:
                logger.warning("access log %s unavailable: %s",
                               self._target, e)
        if self._fp is not None:
            threading.Thread(target=self._writer, name="access-log",
                             daemon=True).start()

    def _writer(self) -> None:
        while True:
            lines = [self._q.get()]
            # batch whatever else is queued before flushing once
            try:
                while True:
                    lines.append(self._q.get_nowait())
            except queue.Empty:
                pass
            try:
                for line in lines:
                    self._fp.write(line)
                self._fp.flush()
            except (OSError, ValueError):
                pass  # telemetry must never crash the data plane
            finally:
                for _ in lines:
                    self._q.task_done()

    def drain(self, timeout: float = 5.0) -> None:
        """Block until queued lines are written (tests, shutdown)."""
        if self._fp is None:
            return
        deadline = time.monotonic() + timeout
        while self._q.unfinished_tasks and time.monotonic() < deadline:
            time.sleep(0.01)

    @property
    def enabled(self) -> bool:
        return self._fp is not None

    def log(
        self,
        *,
        method: str,
        path: str,
        status: int,
        duration_ms: float,
        route: str = "",
        backend: str = "",
        model: str = "",
        response_model: str = "",
        stream: bool = False,
        input_tokens: int = 0,
        output_tokens: int = 0,
        total_tokens: int = 0,
        cached_tokens: int = 0,
        costs: dict[str, int] | None = None,
        error_type: str = "",
        client: str = "",
        trace_id: str = "",
        span_id: str = "",
        request_id: str = "",
        upstream_request_id: str = "",
        attempts: int = 0,
        decision: dict[str, Any] | None = None,
    ) -> None:
        if self._fp is None:
            return
        entry: dict[str, Any] = {
            "ts": time.strftime("%Y-%m-%dT%H:%M:%S%z"),
            "method": method,
            "path": path,
            "status": status,
            "duration_ms": round(duration_ms, 2),
            "route": route,
            "backend": backend,
            "model": model,
        }
        if response_model and response_model != model:
            entry["response_model"] = response_model
        if stream:
            entry["stream"] = True
        usage = {
            k: v for k, v in (
                ("input", input_tokens), ("output", output_tokens),
                ("total", total_tokens), ("cached", cached_tokens),
            ) if v
        }
        if usage:
            entry["usage"] = usage
        if costs:
            entry["costs"] = costs
        if error_type:
            entry["error"] = error_type
        if client:
            entry["client"] = client
        if trace_id:
            entry["trace_id"] = trace_id
        if span_id:
            # with trace_id, joins the line against the exported span
            # tree AND (via the replica's matching trace id) tpuserve's
            # /debug/requests flight-recorder timelines
            entry["span_id"] = span_id
        if request_id:
            entry["request_id"] = request_id
        if upstream_request_id:
            # the serving replica's own id (x-aigw-request-id): the
            # direct key into /debug/requests/{id} on that replica
            entry["upstream_request_id"] = upstream_request_id
        if attempts > 1:
            entry["attempts"] = attempts
        if decision:
            # the routing outcome: the compact view of the
            # gateway's decision-ring entry — chosen endpoint plus the
            # flags that change what a log reader does next. The full
            # explain stays in /debug/decisions (joined by
            # upstream_request_id), not on every log line.
            d: dict[str, Any] = {}
            if decision.get("chosen"):
                d["endpoint"] = decision["chosen"]
            pick = decision.get("pick") or {}
            for flag in ("kv_fleet_hit", "sticky", "prefix_affinity"):
                if pick.get(flag):
                    d[flag] = True
            if decision.get("shed"):
                d["shed"] = True
            if decision.get("migrated_to"):
                d["migrated_to"] = decision["migrated_to"]
            if d:
                entry["decision"] = d
        try:
            self._q.put_nowait(json.dumps(entry) + "\n")
        except queue.Full:
            pass  # drop rather than block the data plane

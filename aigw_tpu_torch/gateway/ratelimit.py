"""Token-budget quotas and rate limiting (the port's copy of
``aigw_tpu/gateway/ratelimit.py``; its quota service runs on the
standard-library HTTP of ``gateway/http.py`` instead of aiohttp).

Equivalent of the upstream QuotaPolicy CRD + Envoy ratelimit service leg
(api/v1alpha1/quota_policy.go:26-165, internal/ratelimit/translator —
descriptor trees keyed backend/model/client selectors) collapsed into one
in-process engine, keeping its semantics:

- **Enforcement at request time, consumption at end-of-stream**: token
  costs are only known after the response completes, so a request is
  admitted if its descriptor buckets currently have budget, and the actual
  cost is drawn down afterwards (Envoy's ``apply_on_stream_done``,
  filterconfig.go:84-87). A burst can therefore overshoot one window by
  in-flight requests.
- **Descriptors**: (rule, model, backend, client-key) tuples; the client
  key comes from a configurable request header.
- **Fixed windows** aligned to the unit boundary, like the Envoy ratelimit
  service's per-unit counters.
- **Shared enforcement** (a dedicated ratelimit service fed by xDS,
  internal/ratelimit/runner/runner.go:36-38): when AIGW_QUOTA_DIR is set,
  counters live in flock'd files in the reference's file names and
  format, so one budget is enforced across gateways given one directory,
  the reference's and the port's alike. AIGW_QUOTA_URL (which wins over
  AIGW_QUOTA_DIR) puts them behind a quota service instead.
"""

from __future__ import annotations

import fcntl
import hashlib
import json
import os
import time
from dataclasses import dataclass
from typing import Any

from aigw_tpu_torch.config.model import ConfigError


@dataclass(frozen=True)
class QuotaRule:
    """One quota: budget of a cost metric per time window, optionally
    scoped to model/backend and keyed by a client header."""

    name: str
    metadata_key: str  # which LLMRequestCost metric to draw down
    limit: int
    window_seconds: float = 60.0
    model: str = ""  # "" = any
    backend: str = ""  # "" = any
    client_key_header: str = ""  # "" = one global bucket
    # QuotaPolicy "Shared" mode (quotapolicies CRD): rules carrying the
    # same non-empty group are charged together but the request is
    # ALLOWED if at least one of them still has headroom. "" = an
    # independent cap (deny when exhausted), the native default.
    shared_group: str = ""

    @staticmethod
    def parse(value: dict[str, Any]) -> "QuotaRule":
        try:
            rule = QuotaRule(
                name=value["name"],
                metadata_key=value["metadata_key"],
                limit=int(value["limit"]),
                window_seconds=float(value.get("window_seconds", 60.0)),
                model=value.get("model", ""),
                backend=value.get("backend", ""),
                client_key_header=str(
                    value.get("client_key_header", "")
                ).lower(),
                shared_group=str(value.get("shared_group", "")),
            )
        except KeyError as e:
            raise ConfigError(f"quota rule missing field {e}") from None
        if rule.limit <= 0 or rule.window_seconds <= 0:
            raise ConfigError(f"quota {rule.name}: limit/window must be > 0")
        return rule


@dataclass
class _Window:
    start: float
    used: int


class FileQuotaBackend:
    """Shared quota counters: one flock'd JSON file per rule.

    The upstream gateway routes token budgets through a *shared* ratelimit
    service precisely so limits are global across Envoy replicas
    (internal/ratelimit/runner/runner.go:36-38). Here the shared store
    is the filesystem: SO_REUSEPORT workers on one host share it
    automatically, and replicas share it when pointed at a common
    directory (AIGW_QUOTA_DIR). Fixed windows are aligned to the unit
    boundary, so every process computes the same window start and the
    file needs only {start, used-per-client-key}.
    """

    def __init__(self, directory: str):
        self._dir = directory
        os.makedirs(directory, exist_ok=True)

    def _path(self, rule_name: str) -> str:
        safe = "".join(
            c if c.isalnum() or c in "-_" else "_" for c in rule_name
        )
        # short hash of the raw name: sanitization alone would collapse
        # distinct rules ('a b' vs 'a_b') onto one file, silently merging
        # their budgets
        digest = hashlib.sha256(rule_name.encode()).hexdigest()[:8]
        path = os.path.join(self._dir, f"quota_{safe}_{digest}.json")
        # one-time migration from the pre-hash filename so live spent
        # budgets survive an upgrade (rename is atomic; losers of the
        # race see the file already gone and just use the new path)
        legacy = os.path.join(self._dir, f"quota_{safe}.json")
        if not os.path.exists(path) and os.path.exists(legacy):
            try:
                os.rename(legacy, path)
            except OSError:
                pass
        return path

    @staticmethod
    def _load(f) -> dict:
        f.seek(0)
        raw = f.read()
        empty = {"start": -1.0, "used": {}}
        if not raw:
            return empty
        try:
            state = json.loads(raw)
        except (json.JSONDecodeError, UnicodeDecodeError):
            return empty
        # shape-validate too: valid-JSON-wrong-shape (external edit) must
        # reset, not crash every quota-matched request forever
        if not isinstance(state, dict) or \
                not isinstance(state.get("used"), dict):
            return empty
        return state

    def get(self, rule_name: str, client_key: str,
            window_start: float) -> int:
        try:
            with open(self._path(rule_name), "r") as f:
                fcntl.flock(f, fcntl.LOCK_SH)
                state = self._load(f)
        except FileNotFoundError:
            return 0
        if state.get("start") != window_start:
            return 0
        used = state.get("used", {}).get(client_key, 0)
        return int(used) if isinstance(used, (int, float)) else 0

    def add(self, rule_name: str, client_key: str, window_start: float,
            amount: int) -> int:
        with open(self._path(rule_name), "a+") as f:
            fcntl.flock(f, fcntl.LOCK_EX)
            state = self._load(f)
            if state.get("start") != window_start:
                state = {"start": window_start, "used": {}}
            used = state["used"]
            used[client_key] = int(used.get(client_key, 0)) + int(amount)
            f.seek(0)
            f.truncate()
            json.dump(state, f)
            f.flush()
            return used[client_key]


class HTTPQuotaBackend:
    """Network quota mode: counters live behind a tiny quota service
    (``python -m aigw_tpu_torch quota-service``) so multi-*node*
    replicas with no shared filesystem still enforce ONE budget — the role of the upstream
    over-the-network ratelimit service fed by xDS
    (internal/ratelimit/runner/runner.go:36-38). Selected with
    AIGW_QUOTA_URL (takes precedence over AIGW_QUOTA_DIR).

    Failure semantics are Envoy's ratelimit-filter default: **fail
    open** — an unreachable quota service admits traffic (and skips the
    draw-down) rather than turning a telemetry outage into an API
    outage; every failure is logged.
    """

    def __init__(self, base_url: str, timeout: float = 3.0):
        import threading
        import urllib.parse

        self.base_url = base_url.rstrip("/")
        self.timeout = timeout
        parts = urllib.parse.urlsplit(self.base_url)
        self._https = parts.scheme == "https"
        self._netloc = parts.netloc
        self._prefix = parts.path.rstrip("/")
        # keep-alive connection per calling thread (check/consume run on
        # executor threads): per-call urlopen would cost a fresh TCP
        # connect per quota operation and pile up TIME_WAIT sockets on
        # the quota service at gateway QPS
        self._local = threading.local()

    def _conn(self):
        import http.client

        conn = getattr(self._local, "conn", None)
        if conn is None:
            cls = (http.client.HTTPSConnection if self._https
                   else http.client.HTTPConnection)
            conn = cls(self._netloc, timeout=self.timeout)
            self._local.conn = conn
        return conn

    def _drop_conn(self) -> None:
        conn = getattr(self._local, "conn", None)
        if conn is not None:
            try:
                conn.close()
            except Exception:  # noqa: BLE001
                pass
            self._local.conn = None

    def _request(self, method: str, rule_name: str,
                 payload: dict[str, Any]) -> int | None:
        import logging
        import urllib.parse

        path = (f"{self._prefix}/v1/quota/"
                f"{urllib.parse.quote(rule_name, safe='')}")
        body = None
        headers = {}
        if method == "GET":
            path += "?" + urllib.parse.urlencode(payload)
        else:
            body = json.dumps(payload).encode()
            headers["content-type"] = "application/json"
        # one retry on a fresh connection: a keep-alive socket the
        # service closed between calls fails the first attempt benignly
        for attempt in (0, 1):
            try:
                conn = self._conn()
                conn.request(method, path, body=body, headers=headers)
                resp = conn.getresponse()
                data = resp.read()
                if resp.status >= 400:
                    raise OSError(f"HTTP {resp.status}")
                return int(json.loads(data).get("used", 0))
            except Exception as e:  # noqa: BLE001 — fail open
                self._drop_conn()
                if attempt == 1:
                    logging.getLogger(__name__).warning(
                        "quota service %s %s failed (%s: %s); "
                        "failing open", method, path,
                        type(e).__name__, e)
        return None

    def get(self, rule_name: str, client_key: str,
            window_start: float) -> int:
        used = self._request("GET", rule_name, {
            "key": client_key, "start": window_start})
        return 0 if used is None else used

    def add(self, rule_name: str, client_key: str, window_start: float,
            amount: int) -> int:
        used = self._request("POST", rule_name, {
            "key": client_key, "start": window_start,
            "amount": int(amount)})
        return 0 if used is None else used


def quota_service(directory: str):
    """The quota service itself: an ``HTTPServer`` (``gateway/http.py``)
    exposing FileQuotaBackend's two operations, the reference's
    ``quota_service_app`` routes, bodies and status codes. State stays in
    flock'd files, so the service can itself run replicated over a shared
    volume, or singly, giving budget-sharing to gateways with no shared
    filesystem at all. The file calls run off the event loop. Run with
    ``python -m aigw_tpu_torch quota-service``; ``await
    server.start(host, port)`` binds it."""
    import asyncio as _asyncio

    from aigw_tpu_torch.gateway.http import HTTPServer, json_response

    store = FileQuotaBackend(directory)

    async def get_used(request):
        rule = request.match_info["rule"]
        key = request.query.get("key", "")
        try:
            start = float(request.query.get("start", "0"))
        except ValueError:
            return json_response({"error": "bad start"}, status=400)
        used = await _asyncio.to_thread(store.get, rule, key, start)
        return json_response({"used": used})

    async def add_used(request):
        rule = request.match_info["rule"]
        try:
            body = json.loads(request.body)
            if not isinstance(body, dict):
                raise ValueError("body must be an object")
            key = str(body.get("key", ""))
            start = float(body["start"])
            amount = int(body["amount"])
        except (json.JSONDecodeError, KeyError, TypeError, ValueError):
            return json_response({"error": "bad body"}, status=400)
        used = await _asyncio.to_thread(
            store.add, rule, key, start, amount)
        return json_response({"used": used})

    async def health(_request):
        return json_response({"status": "ok"})

    return HTTPServer({
        ("GET", "/v1/quota/{rule}"): get_used,
        ("POST", "/v1/quota/{rule}"): add_used,
        ("GET", "/health"): health,
    })


class RateLimiter:
    """In-process descriptor-keyed fixed-window limiter."""

    _SWEEP_EVERY = 1024  # bucket insertions between stale-window sweeps

    def __init__(self, rules: list[QuotaRule],
                 backend: FileQuotaBackend | None = None):
        self.rules = rules
        self.backend = backend  # shared store: workers/replicas see one budget
        self._windows: dict[tuple[str, str], _Window] = {}
        self._inserts = 0
        self._window_by_rule = {r.name: r.window_seconds for r in rules}

    def adopt(self, previous: "RateLimiter | None") -> "RateLimiter":
        """Carry in-flight window counters across a config hot reload so
        a reload never refills exhausted budgets (rules are matched by
        name+shape; changed rules start fresh)."""
        if previous is None:
            return self
        if self.backend is not None:
            # shared counters live in the store, not this object; a hot
            # reload keeps them by construction
            return self
        prev_rules = {r.name: r for r in previous.rules}
        keep = {
            r.name for r in self.rules if prev_rules.get(r.name) == r
        }
        for key, window in previous._windows.items():
            if key[0] in keep:
                self._windows[key] = window
        return self

    @staticmethod
    def from_config_value(value: Any) -> "RateLimiter":
        rules = [QuotaRule.parse(v) for v in (value or ())]
        backend = None
        quota_url = os.environ.get("AIGW_QUOTA_URL")
        quota_dir = os.environ.get("AIGW_QUOTA_DIR")
        if rules and quota_url:
            # network mode wins: one budget across nodes with no shared
            # filesystem (the upstream ratelimit-service topology)
            backend = HTTPQuotaBackend(quota_url)
        elif rules and quota_dir:
            backend = FileQuotaBackend(quota_dir)
        return RateLimiter(rules, backend=backend)

    def _matching(self, model: str, backend: str) -> list[QuotaRule]:
        return [
            r
            for r in self.rules
            if (not r.model or r.model == model)
            and (not r.backend or r.backend == backend)
        ]

    def _bucket(self, rule: QuotaRule, client_key: str,
                now: float) -> _Window:
        key = (rule.name, client_key)
        w = self._windows.get(key)
        window_start = now - (now % rule.window_seconds)
        if w is None or w.start != window_start:
            w = _Window(start=window_start, used=0)
            self._windows[key] = w
            self._inserts += 1
            if self._inserts % self._SWEEP_EVERY == 0:
                self._sweep(now)
        return w

    def _sweep(self, now: float) -> None:
        """Evict expired windows so client-controlled keys can't grow
        memory without bound."""
        dead = [
            k
            for k, w in self._windows.items()
            if now - w.start > 2 * self._window_by_rule.get(k[0], 3600.0)
        ]
        for k in dead:
            del self._windows[k]

    def check(
        self,
        model: str,
        backend: str,
        headers: dict[str, str],
        now: float | None = None,
    ) -> tuple[bool, "QuotaRule | None"]:
        """(True, None) if the request may proceed; otherwise
        (False, the violated rule). Independent rules deny when
        exhausted; same-shared_group rules deny only when EVERY member
        is exhausted (QuotaPolicy Shared mode)."""
        now = time.time() if now is None else now
        group_ok: dict[str, bool] = {}
        group_violated: dict[str, QuotaRule] = {}
        for rule in self._matching(model, backend):
            client_key = headers.get(rule.client_key_header, "") \
                if rule.client_key_header else ""
            if self.backend is not None:
                start = now - (now % rule.window_seconds)
                used = self.backend.get(rule.name, client_key, start)
            else:
                used = self._bucket(rule, client_key, now).used
            ok = used < rule.limit
            if rule.shared_group:
                g = rule.shared_group
                group_ok[g] = group_ok.get(g, False) or ok
                if not ok:
                    group_violated.setdefault(g, rule)
            elif not ok:
                return False, rule
        for g, any_ok in group_ok.items():
            if not any_ok:
                return False, group_violated[g]
        return True, None

    def consume(
        self,
        costs: dict[str, int],
        model: str,
        backend: str,
        headers: dict[str, str],
        now: float | None = None,
    ) -> None:
        """Draw down matched buckets at end-of-stream."""
        now = time.time() if now is None else now
        for rule in self._matching(model, backend):
            cost = costs.get(rule.metadata_key)
            if not cost:
                continue
            client_key = headers.get(rule.client_key_header, "") \
                if rule.client_key_header else ""
            if self.backend is not None:
                start = now - (now % rule.window_seconds)
                self.backend.add(rule.name, client_key, start, cost)
            else:
                self._bucket(rule, client_key, now).used += cost

    def remaining(
        self, rule_name: str, client_key: str = "", now: float | None = None
    ) -> int | None:
        for rule in self.rules:
            if rule.name == rule_name:
                now = time.time() if now is None else now
                if self.backend is not None:
                    start = now - (now % rule.window_seconds)
                    used = self.backend.get(rule.name, client_key, start)
                else:
                    used = self._bucket(rule, client_key, now).used
                return max(0, rule.limit - used)
        return None

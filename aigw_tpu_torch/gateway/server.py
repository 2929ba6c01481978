"""The gateway data plane for self-hosted serving pools (the port's copy
of ``aigw_tpu/gateway/server.py``, on the standard-library HTTP of
``gateway/http.py`` instead of aiohttp).

It keeps the reference's two-phase processor:

  Phase 1 (route selection): parse the body enough to extract the model,
  validate it against the endpoint's typed schema, stamp the model
  header, match a route. The parsed body is captured.

  Phase 2 (upstream, per attempt): against the chosen backend, translate
  the captured body to the backend schema, apply header/body mutations,
  pick a replica of the backend's pool (``gateway/picker.py``) and send.
  A retriable failure (no connection, a reset before the first byte, a
  429 or 5xx) moves to the next backend of the rule's priority tiers,
  once to a sibling replica first; once a byte has gone to the client,
  nothing is retried.

Streamed responses are relayed frame by frame as they arrive, with token
usage mined on the side; at the end the request's token costs are
computed (``gateway/costs.py``) and recorded with the replica's
MeterRecord in the usage ledger (``gateway/usage.py``).

What this data plane carries: the reference's eleven client endpoints
(``_ENDPOINTS``): chat, completions, embeddings, ``/tokenize``,
``/v1/responses`` (passed through to OpenAI backends, mapped onto chat
for every chat-capable one, with its transcript store for
``previous_response_id``), image generation and the three audio routes
(the two multipart ones forwarded untranslated) on an OpenAI front; the
Anthropic front (``/v1/messages``); and ``/v2/rerank`` on a Cohere front;
streamed and not, to every backend schema the translators pair with the
front (``translate/``): port replicas and OpenAI, the hosted Anthropic,
Azure OpenAI, Vertex Gemini, Vertex and Bedrock Anthropic and Bedrock
Converse, whose AWS event-stream replies are streams as SSE is. Each
attempt applies the backend's upstream credentials last
(``gateway/auth``: a key header, a bearer token with the Vertex path's
project and region, or a SigV4 signature over the final body and host),
and signs again on a failover to a sibling; a missing credential
answers 401 ``authentication_error``. ``GET /v1/models``, ``/health``,
``/metrics``, ``/usage``,
``/fleet/state``, ``/fleet/metrics`` and ``/debug/decisions``; the
batch tier's proxy (``/v1/files``, ``/v1/batches``: new batch state on
the picker's batch choice, polls, cancels and fetches on the replica
that holds the id); retry
and fallback over priorities, the circuit breaker, session and prefix
affinity derived from the body, the prompt-length estimate; the fleet
operations: token quotas checked at admission and drawn down at the
end of a request (``gateway/ratelimit.py``), the mid-stream migrator
(``_Migrator``: a young stream of a prefill-pressured replica, or any
stream of a draining one, moved to a sibling through the replicas'
``/migrate`` routes and spliced into the client's stream), and one
fleet controller per pool that configures one
(``gateway/controller.py``: autoscaling, lossless drain, failover, a
launcher of replica processes that the gateway's shutdown stops).

Observability, as the reference's: with tracing on (``OTEL_*``,
``obs/tracing.py``) each request gets a span named ``"<operation>
<model>"`` that continues the caller's trace, carries the mapped request
headers (``AIGW_HEADER_ATTRIBUTES``), the OpenInference request and
response attributes (``obs/openinference.py``; a stream's through
``StreamAccumulator``), the pick's ``aigw.pick.*`` and ``aigw.endpoint``
and its GenAI attributes, and is injected into the upstream's headers, so
the replica's span is its child; with tracing off the caller's
trace-context headers are relayed to the replica verbatim. One JSON line
per request, early rejections included, goes to the access log
(``AIGW_ACCESS_LOG``, ``obs/accesslog.py``) with its span's ids, tokens
and costs. ``AIGW_ENABLE_DEBUG=true`` adds ``/debug/config`` (the live
config, credentials and MCP seeds masked) and ``/debug/stacks``.

The MCP proxy (``mcp/``) is always on its routes (``/mcp`` unless the
config's ``mcp.path`` says otherwise), and a reload updates it in place;
its ``mcp_*`` families render on ``/metrics`` after the gateway's.
"""

from __future__ import annotations

import asyncio
import gzip
import hashlib
import json
import logging
import os
import random
import time
import urllib.parse
import zlib
from typing import Any, Callable

from aigw_tpu_torch.config.model import (
    DESTINATION_ENDPOINT_HEADER,
    MODEL_NAME_HEADER,
    ORIGINAL_PATH_HEADER,
    APISchemaName,
    _thaw,
)
from aigw_tpu_torch.config.runtime import RuntimeBackend, RuntimeConfig
from aigw_tpu_torch.gateway.auth import AuthError
from aigw_tpu_torch.gateway.circuit import CircuitBreaker
from aigw_tpu_torch.gateway.controller import (
    ControllerConfig,
    FleetController,
    build_launcher,
)
from aigw_tpu_torch.gateway.costs import TokenUsage
from aigw_tpu_torch.gateway.fleetstate import (
    DecisionRing,
    merge_rollups,
    relabel_exposition,
)
from aigw_tpu_torch.gateway.http import (
    ClientError,
    ClientPayloadError,
    ClientResponse,
    HTTPClient,
    HTTPServer,
    Request,
    Response,
    StreamResponse,
    Timeout,
    json_response,
    text_response,
)
from aigw_tpu_torch.gateway.mutators import (
    apply_body_mutation,
    apply_header_mutation,
)
from aigw_tpu_torch.gateway.picker import (
    ADAPTER_HEADER,
    AFFINITY_HEADER,
    KV_CHAIN_HEADER,
    KV_PEERS_HEADER,
    PREFIX_HEADER,
    PRIORITY_HEADER,
    PROMPT_TOKENS_HEADER,
    TENANT_HEADER,
    ContextLengthError,
    Endpoint as PickerEndpoint,
    EndpointPicker,
    SLOShedError,
)
from aigw_tpu_torch.gateway.router import (
    BackendSelector,
    NoRouteError,
    match_route,
    split_model,
)
from aigw_tpu_torch.gateway.usage import UsageLedger
from aigw_tpu_torch.obs.metrics import (
    GenAIMetrics,
    RequestMetrics,
    render_controller_gauges,
    render_fleet_gauges,
    render_usage_gauges,
)
from aigw_tpu_torch.mcp import MCPConfig, MCPProxy
from aigw_tpu_torch.obs import openinference as oi
from aigw_tpu_torch.obs.accesslog import AccessLogger
from aigw_tpu_torch.obs.metrics import MCPMetrics
from aigw_tpu_torch.obs.tracing import (
    DEFAULT_HEADER_ATTRIBUTES,
    Span,
    Tracer,
    genai_attributes,
    header_attributes,
    parse_header_attribute_mapping,
    relay_trace_headers,
)
from aigw_tpu_torch.schemas import anthropic as anth
from aigw_tpu_torch.schemas import openai as oai
from aigw_tpu_torch.schemas import typed as typed_schemas
from aigw_tpu_torch.schemas import typed_response
from aigw_tpu_torch.translate import (
    Endpoint,
    RequestTx,
    TranslationError,
    get_translator,
)
from aigw_tpu_torch.utils.redaction import redact_body, redact_headers

logger = logging.getLogger(__name__)

#: endpoint path → (Endpoint, front schema, metrics operation)
_ENDPOINTS: dict[str, tuple[Endpoint, APISchemaName, str]] = {
    Endpoint.CHAT_COMPLETIONS.value: (
        Endpoint.CHAT_COMPLETIONS, APISchemaName.OPENAI, "chat"),
    Endpoint.COMPLETIONS.value: (
        Endpoint.COMPLETIONS, APISchemaName.OPENAI, "text_completion"),
    Endpoint.EMBEDDINGS.value: (
        Endpoint.EMBEDDINGS, APISchemaName.OPENAI, "embeddings"),
    Endpoint.MESSAGES.value: (
        Endpoint.MESSAGES, APISchemaName.ANTHROPIC, "chat"),
    Endpoint.TOKENIZE.value: (
        Endpoint.TOKENIZE, APISchemaName.OPENAI, "tokenize"),
    Endpoint.RESPONSES.value: (
        Endpoint.RESPONSES, APISchemaName.OPENAI, "responses"),
    Endpoint.IMAGES_GENERATIONS.value: (
        Endpoint.IMAGES_GENERATIONS, APISchemaName.OPENAI, "image_generation"),
    Endpoint.RERANK.value: (
        Endpoint.RERANK, APISchemaName.COHERE, "rerank"),
    Endpoint.AUDIO_SPEECH.value: (
        Endpoint.AUDIO_SPEECH, APISchemaName.OPENAI, "audio_speech"),
    Endpoint.AUDIO_TRANSCRIPTIONS.value: (
        Endpoint.AUDIO_TRANSCRIPTIONS, APISchemaName.OPENAI,
        "audio_transcription"),
    Endpoint.AUDIO_TRANSLATIONS.value: (
        Endpoint.AUDIO_TRANSLATIONS, APISchemaName.OPENAI,
        "audio_translation"),
}

#: endpoints whose request body is multipart/form-data, not JSON: they pass
#: through untranslated, the model read from the form's ``model`` part
_MULTIPART_ENDPOINTS = {
    Endpoint.AUDIO_TRANSCRIPTIONS,
    Endpoint.AUDIO_TRANSLATIONS,
}


def _head_digest(head: list) -> str:
    blob = json.dumps(head, sort_keys=True).encode()
    return hashlib.blake2b(blob, digest_size=12).hexdigest()


def _conversation_affinity_key(body: dict) -> str:
    """Key a conversation by its stable head, the system prompt(s) plus
    the first user message: identical on every turn of one chat, so the
    picker can pin the conversation to the replica whose prefix cache
    holds it; distinct conversations differ in their first user
    message."""
    messages = body.get("messages")
    if not isinstance(messages, list) or not messages:
        return ""
    head: list = []
    first_user = None
    for m in messages:
        if not isinstance(m, dict):
            return ""
        role = m.get("role")
        if role in ("system", "developer"):
            head.append(m)
        elif role == "user":
            first_user = m
            break
        else:
            break
    if first_user is None:
        return ""
    head.append(first_user)
    return _head_digest(head)


def _prefix_hash_key(body: dict) -> str:
    """Key the request's shared prompt prefix, the system/developer
    messages only: every request templated from one system prompt shares
    it, so the picker steers them toward the replica whose prefix cache
    already holds those pages (soft affinity, ``gateway/picker.py``)."""
    messages = body.get("messages")
    if not isinstance(messages, list) or not messages:
        return ""
    head: list = []
    for m in messages:
        if not isinstance(m, dict):
            return ""
        if m.get("role") in ("system", "developer"):
            head.append(m)
        else:
            break
    if not head:
        return ""
    return _head_digest(head)


def _prompt_token_estimate(body: dict) -> int:
    """A conservative prompt-token estimate for the picker's
    context-length filter and prompt-priced TTFT: bytes / 4, which
    under-estimates byte-level tokenizers, so a borderline prompt routes
    and the replica's own length check still guards."""
    n = 0
    prompt = body.get("prompt")
    if isinstance(prompt, str):
        n += len(prompt.encode("utf-8", errors="ignore"))
    messages = body.get("messages")
    if isinstance(messages, list):
        for m in messages:
            if not isinstance(m, dict):
                continue
            c = m.get("content")
            if isinstance(c, str):
                n += len(c.encode("utf-8", errors="ignore"))
            elif isinstance(c, list):
                for part in c:
                    if (isinstance(part, dict)
                            and isinstance(part.get("text"), str)):
                        n += len(part["text"].encode(
                            "utf-8", errors="ignore"))
    return n // 4


def _multipart_model(raw: bytes, content_type: str) -> str:
    """The ``model`` form field of a multipart body, without touching
    the (possibly large) audio parts; the boundary is parsed as the
    rewrite path parses it (``translate/multipart.py``)."""
    from aigw_tpu_torch.translate.multipart import parse_multipart_boundary

    b = parse_multipart_boundary(content_type)
    if not b:
        return ""
    boundary = b"--" + b.encode()
    for part in raw.split(boundary):
        header_end = part.find(b"\r\n\r\n")
        if header_end < 0:
            continue
        headers = part[:header_end]
        if b'name="model"' in headers:
            return (
                part[header_end + 4:]
                .rstrip(b"\r\n-")
                .decode("utf-8", errors="replace")
                .strip()
            )
    return ""


#: upstream statuses that move the request to the next backend
_RETRIABLE_STATUS = {429, 500, 502, 503, 504}
#: backend schemas whose SSE streams end with ``data: [DONE]``: only
#: their close-delimited streams can be told torn from finished
_DONE_TERMINATED = frozenset({APISchemaName.OPENAI,
                              APISchemaName.AZURE_OPENAI,
                              APISchemaName.TPUSERVE})


def _error(status: int, body: bytes,
           headers: dict[str, str] | None = None) -> Response:
    return Response(status, body, "application/json", headers)


class _RawBody:
    """A multipart request carried through phase 2 untranslated."""

    def __init__(self, raw: bytes, content_type: str, model: str):
        self.raw = raw
        self.content_type = content_type
        self.model = model


#: receives every finished request's costs and its labels (``model``,
#: ``backend``, ``route``; ``native`` for the core's requests)
CostSink = Callable[[dict[str, int], dict[str, str]], Any]


class GatewayServer:
    """The data plane: routes, pickers, breaker, metrics and ledger.

    ``rng`` draws the weighted backend picks (seed it for a reproducible
    sequence); ``tracer`` defaults to the ``OTEL_*`` environment's;
    ``cost_sink`` receives each request's costs, as the reference's
    does (the native core's tailer feeds it too)."""

    def __init__(self, runtime: RuntimeConfig, *,
                 rng: random.Random | None = None,
                 tracer: Tracer | None = None,
                 cost_sink: CostSink | None = None):
        self._runtime = runtime
        self.metrics = GenAIMetrics()
        self.rng = rng or random.Random()
        self.tracer = tracer or Tracer()
        self.cost_sink = cost_sink
        # request header → span attribute (default agent-session-id:
        # session.id)
        self._header_attrs = parse_header_attribute_mapping(
            os.environ.get("AIGW_HEADER_ATTRIBUTES",
                           DEFAULT_HEADER_ATTRIBUTES))
        # the OpenInference privacy knobs and the structured access log
        self._oi_config = oi.TraceConfig.from_env()
        self.access_log = AccessLogger()
        # one breaker keyed by backend name for logical backends and by
        # replica address for picked endpoints; every open/close lands in
        # the replica's fleet event ring, and the picker's routability
        # view consults is_open
        self.circuit = CircuitBreaker(
            on_transition=self._on_circuit_transition)
        self.usage_ledger = self._build_usage_ledger(runtime)
        self.decisions = DecisionRing(
            capacity=int(os.environ.get("AIGW_DECISION_RING", "512")))
        routes = {("POST", path): self._handle for path in _ENDPOINTS}
        routes.update({
            ("GET", "/v1/models"): self._handle_models,
            ("GET", "/health"): self._handle_health,
            ("GET", "/metrics"): self._handle_metrics,
            ("GET", "/usage"): self._handle_usage,
            ("GET", "/fleet/state"): self._handle_fleet_state,
            ("GET", "/fleet/metrics"): self._handle_fleet_metrics,
            ("GET", "/debug/decisions"): self._handle_decisions,
            # the batch tier: upload and create on a picker-chosen
            # replica, later calls on the replica that holds the id
            ("POST", "/v1/files"): self._handle_file_upload,
            ("GET", "/v1/files/{fid}/content"): self._handle_batch_forward,
            ("POST", "/v1/batches"): self._handle_batch_create,
            ("GET", "/v1/batches/{bid}"): self._handle_batch_forward,
            ("POST", "/v1/batches/{bid}/cancel"):
                self._handle_batch_forward,
        })
        # the debug surface is off on the data-plane port unless asked
        # for: any API client could otherwise read thread stacks and the
        # config's topology
        if os.environ.get("AIGW_ENABLE_DEBUG", "").lower() == "true":
            routes[("GET", "/debug/config")] = self._handle_debug_config
            routes[("GET", "/debug/stacks")] = self._handle_debug_stacks
        # the MCP proxy is always registered, so a reload can add or
        # change its backends, filters and authorization (its path is
        # fixed here)
        self.mcp = MCPProxy(MCPConfig.parse(runtime.config.mcp or {}),
                            metrics=MCPMetrics(self.metrics))
        routes.update(self.mcp.routes())
        self._batch_replica: dict[str, str] = {}
        self.http = HTTPServer(routes)
        self.client = HTTPClient()
        self.port = 0
        #: the reconciling control plane's not-accepted objects
        #: (``ConfigWatcher.not_accepted``), shown on ``/health``
        self.conditions_fn: Callable[[], dict] | None = None
        self._pickers: dict[str, EndpointPicker] = {}
        self._picker_tasks: set[asyncio.Task] = set()
        # one lifecycle manager per backend pool with a `controller`
        self._controllers: dict[str, FleetController] = {}
        self._build_pickers(runtime)

    # -- lifecycle --------------------------------------------------------
    @property
    def runtime(self) -> RuntimeConfig:
        return self._runtime

    async def start(self, host: str = "127.0.0.1", port: int = 1975,
                    reuse_port: bool = False) -> int:
        """Start the pickers' polls and the controllers' loops and
        listen (with ``SO_REUSEPORT`` when ``reuse_port``); returns the
        bound port."""
        for picker in self._pickers.values():
            await picker.start()
        for ctl in self._controllers.values():
            await ctl.start()
        self.port = await self.http.start(host, port, reuse_port)
        return self.port

    async def stop(self, grace: float = 0.0) -> None:
        """Stop listening; after ``grace`` seconds for the requests in
        flight, close their connections, the controllers (and every
        replica process their launchers started), the polls and the
        ledger."""
        await self.http.stop(grace)
        for ctl in self._controllers.values():
            await ctl.stop()
        for picker in self._pickers.values():
            await picker.stop()
        self.client.close()
        self.mcp.close()
        if self.usage_ledger is not None:
            self.usage_ledger.close()

    @staticmethod
    def _build_usage_ledger(runtime: RuntimeConfig) -> UsageLedger | None:
        """The metering ledger from the config's ``usage`` block: on by
        default (no block = in-memory ledger with defaults);
        ``usage: {enabled: false}`` turns it off."""
        raw = _thaw(runtime.config.usage) or {}
        if not isinstance(raw, dict):
            raw = {}
        if not raw.get("enabled", True):
            return None
        journal = str(raw.get("journal", "") or "")
        budgets = raw.get("budgets") or {}
        kwargs = dict(
            window_s=float(raw.get("window_s", 60.0)),
            retain_windows=int(raw.get("retain_windows", 64)),
            budgets={str(k): float(v) for k, v in budgets.items()},
            burn_windows=int(raw.get("burn_windows", 3)),
        )
        if journal:
            # crash-safe resume: replay what survived, keep appending
            return UsageLedger.replay(journal, **kwargs)
        return UsageLedger(**kwargs)

    def set_runtime(self, rc: RuntimeConfig) -> None:
        """Hot-swap the config (the watcher's callback). Pickers whose
        endpoint pools are unchanged are kept, so telemetry and session
        affinity survive reloads, and so are their controllers when
        their blocks are unchanged too."""
        if rc.config.usage != self._runtime.config.usage:
            # metering knobs changed: rebuild (a journal-backed ledger
            # replays itself, so totals survive the swap)
            old_ledger = self.usage_ledger
            self.usage_ledger = self._build_usage_ledger(rc)
            if old_ledger is not None:
                old_ledger.close()
        self._runtime = rc
        self.mcp.update_config(MCPConfig.parse(rc.config.mcp or {}))
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            loop = None
        old = self._pickers
        old_ctl = self._controllers
        self._build_pickers(rc)
        if loop is not None:
            for name, ctl in old_ctl.items():
                if self._controllers.get(name) is not ctl:
                    self._spawn(loop, ctl.stop())
            for name, picker in old.items():
                if self._pickers.get(name) is not picker:
                    self._spawn(loop, picker.stop())
            for name, picker in self._pickers.items():
                if old.get(name) is not picker:
                    self._spawn(loop, picker.start())
            for name, ctl in self._controllers.items():
                if old_ctl.get(name) is not ctl:
                    self._spawn(loop, ctl.start())

    def _spawn(self, loop: asyncio.AbstractEventLoop, coro) -> None:
        # the loop holds tasks weakly; keep them until they finish
        task = loop.create_task(coro)
        self._picker_tasks.add(task)
        task.add_done_callback(self._picker_tasks.discard)

    def _build_pickers(self, rc: RuntimeConfig) -> None:
        pickers: dict[str, EndpointPicker] = {}
        for name, rb in rc.backends.items():
            b = rb.backend
            if not b.endpoints:
                continue
            prev = self._pickers.get(name)
            key = (b.endpoints, b.picker_poll_interval, b.picker_mode,
                   b.slo_ttft_ms, b.fleet_obs, b.slo_objective,
                   b.slo_window_s, b.slo_burn_windows)
            if prev is not None and getattr(prev, "_config_key", None) == key:
                pickers[name] = prev  # unchanged pool: keep its state
                continue
            picker = EndpointPicker(
                [PickerEndpoint.parse(_thaw(e)) for e in b.endpoints],
                poll_interval=b.picker_poll_interval,
                mode=b.picker_mode,
                slo_ttft_ms=b.slo_ttft_ms,
                fleet_obs=b.fleet_obs,
                slo_objective=b.slo_objective,
                slo_window_s=b.slo_window_s,
                slo_burn_windows=b.slo_burn_windows,
            )
            picker._config_key = key  # type: ignore[attr-defined]
            pickers[name] = picker
        self._pickers = pickers
        # the picker consults the same breaker the attempt loop feeds,
        # keyed by replica address
        for picker in self._pickers.values():
            picker.breaker = self.circuit
        self._build_controllers(rc)

    def _build_controllers(self, rc: RuntimeConfig) -> None:
        controllers: dict[str, FleetController] = {}
        for name, rb in rc.backends.items():
            raw = rb.backend.controller
            picker = self._pickers.get(name)
            if raw is None or picker is None:
                continue
            cfg = ControllerConfig.parse(_thaw(raw))
            if not cfg.enabled:
                continue
            prev = self._controllers.get(name)
            if (prev is not None and prev.picker is picker
                    and getattr(prev, "_config_raw", None) == raw):
                controllers[name] = prev  # unchanged: keep its state
                continue
            ctl = FleetController(
                picker=picker, cfg=cfg,
                launcher=build_launcher(cfg.launcher),
                decisions=self.decisions, backend=name)
            ctl._config_raw = raw  # type: ignore[attr-defined]
            controllers[name] = ctl
        self._controllers = controllers

    def _on_circuit_transition(self, key: str, opened: bool,
                               failures: int) -> None:
        """Breaker open/close → the fleet event ring of the pool that
        knows this key as a replica address (backend names have none)."""
        for picker in self._pickers.values():
            if key in picker.state:
                picker.fleet.mark_breaker(key, opened, failures)

    # -- admin endpoints --------------------------------------------------
    async def _handle_health(self, _request: Request) -> Response:
        payload = {
            "status": "ok",
            "uuid": self._runtime.config.uuid,
            "circuit": self.circuit.snapshot(),
        }
        # the reconciling control plane's quarantined objects, so an
        # operator need not read aigw-status.json
        if self.conditions_fn is not None:
            bad = self.conditions_fn()
            payload["objects_not_accepted"] = len(bad)
            if bad:
                payload["not_accepted"] = sorted(bad)
        return json_response(payload)

    async def _handle_metrics(self, _request: Request) -> Response:
        body = self.metrics.export()
        if self.usage_ledger is not None:
            body += render_usage_gauges(self.usage_ledger.snapshot())
        return Response(200, body, "text/plain")

    async def _handle_usage(self, request: Request) -> Response:
        """``GET /usage``: the metering ledger's windowed per-tenant and
        per-model view. ``since`` (unix seconds), ``tenant`` and
        ``model`` filter the windows; ``export=jsonl`` answers them as
        JSON lines."""
        if self.usage_ledger is None:
            return json_response({"error": "usage metering disabled"},
                                 status=404)
        try:
            since = float(request.query.get("since", "0") or 0.0)
        except ValueError:
            since = 0.0
        payload = self.usage_ledger.query(
            since=since,
            tenant=request.query.get("tenant", ""),
            model=request.query.get("model", ""),
        )
        if request.query.get("export", "") == "jsonl":
            body = "".join(json.dumps(w, sort_keys=True) + "\n"
                           for w in payload["windows"])
            return Response(200, body.encode(), "application/jsonl")
        return json_response(payload)

    # -- the batch tier's proxy -------------------------------------------
    #: bound on the (file or batch id → replica) map
    _BATCH_MAP_MAX = 10_000

    def _batch_pick(self) -> str | None:
        """A replica for new batch state: the first configured pool's
        batch-priority pick (most idle capacity, never SLO-shed)."""
        for _name, picker in sorted(self._pickers.items()):
            dest = picker.pick({PRIORITY_HEADER: "batch"})
            if dest:
                return dest
        return None

    def _remember_batch(self, obj_id: str, addr: str) -> None:
        self._batch_replica[obj_id] = addr
        while len(self._batch_replica) > self._BATCH_MAP_MAX:
            self._batch_replica.pop(next(iter(self._batch_replica)))

    async def _proxy_batch(self, request: Request,
                           addr: str) -> tuple[int, bytes, str]:
        """Forward one batch request to its replica verbatim: (status,
        body, content type); an unreachable replica is a 502."""
        try:
            async with await self.client.request(
                    request.method, f"http://{addr}{request.path}",
                    data=request.body,
                    headers={"content-type": request.headers.get(
                        "content-type", "application/json")},
                    timeout=Timeout(total=60.0)) as resp:
                return (resp.status, await resp.read(),
                        resp.content_type or "application/json")
        except (ClientError, asyncio.TimeoutError) as e:
            return (502,
                    oai.error_body(f"batch replica {addr} unreachable: {e}",
                                   type_="server_error"),
                    "application/json")

    @staticmethod
    def _id_of(body: bytes, key: str) -> str:
        try:
            return str(json.loads(body).get(key) or "")
        except (ValueError, AttributeError):
            return ""

    async def _batch_new(self, request: Request, dest: str | None
                         ) -> Response:
        """Upload or create on ``dest``; the new object's id is mapped
        to it."""
        if dest is None:
            return _error(503, oai.error_body(
                "no replica available for batch work", type_="server_error"))
        status, body, ctype = await self._proxy_batch(request, dest)
        oid = self._id_of(body, "id") if status == 200 else ""
        if oid:
            self._remember_batch(oid, dest)
        return Response(status, body, ctype)

    async def _handle_file_upload(self, request: Request) -> Response:
        return await self._batch_new(request, self._batch_pick())

    async def _handle_batch_create(self, request: Request) -> Response:
        """``POST /v1/batches`` lands on the replica that holds its input
        file; a miss falls back to a fresh batch pick, where the unknown
        file id answers 404."""
        fid = self._id_of(request.body, "input_file_id")
        return await self._batch_new(
            request, self._batch_replica.get(fid) or self._batch_pick())

    async def _handle_batch_forward(self, request: Request) -> Response:
        """Poll, cancel and output fetch follow the id → replica map
        (batch state is replica-local)."""
        bid = request.match_info.get("bid")
        oid = bid or request.match_info.get("fid") or ""
        dest = self._batch_replica.get(oid)
        if dest is None:
            return _error(404, oai.error_body(
                f"unknown batch object {oid!r}"))
        status, body, ctype = await self._proxy_batch(request, dest)
        if status == 200 and bid:
            # a poll names the output file: its content fetch then
            # resolves to the same replica
            ofid = self._id_of(body, "output_file_id")
            if ofid:
                self._remember_batch(ofid, dest)
        return Response(status, body, ctype)

    async def _handle_fleet_state(self, _request: Request) -> Response:
        """Per-replica health state, event rings, staleness and key
        gauges, per-backend rollups and the SLO burn-rate windows of
        every picker-polled pool."""
        backends = {
            name: picker.fleet.snapshot(picker.state)
            for name, picker in self._pickers.items()
        }
        for name, ctl in self._controllers.items():
            if name in backends:
                # the lifecycle manager: scaling decisions, drains in
                # progress and its bounded action ring
                backends[name]["controller"] = ctl.snapshot()
        return json_response({
            "ts": round(time.time(), 3),
            "backends": backends,
            "fleet": merge_rollups(
                [b["rollup"] for b in backends.values()]),
            "decisions_recorded": self.decisions.recorded,
        })

    async def _handle_fleet_metrics(self, _request: Request) -> Response:
        """Every replica's ``/metrics`` samples re-exported with a
        ``replica`` label, plus the ``aigw_fleet_*`` rollup gauges."""
        chunks: list[bytes] = []
        seen: set = set()
        errors = 0

        async def scrape(addr: str) -> str | None:
            try:
                async with await self.client.get(
                        f"http://{addr}/metrics",
                        timeout=Timeout(total=2.0)) as resp:
                    if resp.status != 200:
                        return None
                    return (await resp.read()).decode(
                        "utf-8", errors="replace")
            except (ClientError, asyncio.TimeoutError):
                return None

        for name, picker in self._pickers.items():
            addrs = [e.address for e in picker.endpoints
                     if picker.fleet.health_of(e.address) != "down"]
            texts = await asyncio.gather(*(scrape(a) for a in addrs))
            for addr, text in zip(addrs, texts):
                if text is None:
                    errors += 1
                    continue
                chunks.append(
                    relabel_exposition(text, addr, seen).encode())
            label = name if len(self._pickers) > 1 else ""
            chunks.append(render_fleet_gauges(
                picker.fleet.rollup(picker.state), backend=label))
            ctl = self._controllers.get(name)
            if ctl is not None:
                chunks.append(render_controller_gauges(
                    ctl.gauge_values(), backend=label))
        chunks.append(
            b"# TYPE aigw_fleet_scrape_errors gauge\n"
            b"aigw_fleet_scrape_errors %d\n" % errors)
        return Response(200, b"".join(chunks), "text/plain")

    async def _handle_decisions(self, request: Request) -> Response:
        """The routing-decision audit ring: every pick's explain, shed
        events and costs; ``?rid=<x-aigw-request-id>`` joins one against
        the serving replica's ``/debug/requests/{id}``."""
        rid = request.query.get("rid", "")
        try:
            limit = max(1, min(1000, int(
                request.query.get("limit", "100"))))
        except ValueError:
            limit = 100
        return json_response({
            "capacity": self.decisions.capacity,
            "recorded": self.decisions.recorded,
            "decisions": self.decisions.snapshot(rid=rid, limit=limit),
        })

    async def _handle_models(self, request: Request) -> Response:
        """``/v1/models``: the configured models routed on this host,
        plus every ``<base>:<adapter>`` name the polled replicas report
        on ``/state`` whose base model routes here, with the replicas'
        capability flags."""
        rc = self._runtime
        host = request.host.split(":")[0].lower()
        visible_rules = [
            rule for route in rc.routes_for_host(host) for rule in route.rules
        ]

        def visible(name: str) -> bool:
            base = split_model(name)[0]
            for probe_name in ({name, base}):
                probe = {MODEL_NAME_HEADER: probe_name}
                if any(r.matches(probe) for r in visible_rules):
                    return True
            return False

        caps_by_model: dict[str, dict] = {}
        for picker in self._pickers.values():
            for st in picker.state.values():
                if st.healthy and st.model and st.capabilities:
                    caps_by_model[st.model] = dict(st.capabilities)

        def extra_for(name: str):
            caps = caps_by_model.get(split_model(name)[0])
            return {"capabilities": caps} if caps else None

        entries: list[tuple] = [
            (m.name, m.owned_by, m.created_at, extra_for(m.name))
            for m in rc.config.models
            if visible(m.name)
        ]
        seen = {e[0] for e in entries}
        for picker in self._pickers.values():
            for st in picker.state.values():
                if not (st.healthy and st.model):
                    continue
                for adapter in st.adapters_registered:
                    name = f"{st.model}:{adapter}"
                    if name not in seen and visible(name):
                        seen.add(name)
                        entries.append((name, "aigw-tpu-lora", 0,
                                        extra_for(name)))
        return json_response(oai.models_response(entries))

    async def _handle_debug_config(self, _request: Request) -> Response:
        """The live config with credentials and the MCP seeds masked."""
        cfg = self._runtime.config.to_dict()
        for b in cfg.get("backends", ()):
            if "auth" in b:
                b["auth"] = {"kind": b["auth"].get("kind", "?"),
                             "credentials": "[REDACTED]"}
        if "mcp" in cfg and isinstance(cfg["mcp"], dict):
            cfg["mcp"] = dict(cfg["mcp"])
            cfg["mcp"].pop("session_seed", None)
            cfg["mcp"].pop("session_fallback_seed", None)
        return json_response(cfg)

    async def _handle_debug_stacks(self, _request: Request) -> Response:
        """Every thread's stack."""
        import sys
        import traceback

        out = []
        for tid, frame in sys._current_frames().items():
            out.append(f"--- thread {tid} ---")
            out.extend(traceback.format_stack(frame))
        return text_response("\n".join(out))

    def _log_rejection(self, request: Request, status: int, started: float,
                       model: str = "", reason: str = "") -> None:
        """The access-log line of a request rejected before the attempt
        loop (schema 400s, unknown-model 404s)."""
        if not self.access_log.enabled:
            return
        self.access_log.log(
            method=request.method,
            path=request.path,
            status=status,
            duration_ms=(time.monotonic() - started) * 1000.0,
            model=model,
            error_type=reason or oi.error_type_for_status(status),
            client=request.remote or "",
            request_id=request.headers.get("x-request-id", ""),
        )

    # -- the data plane ---------------------------------------------------
    @staticmethod
    def _decode_body(raw: bytes, enc: str) -> bytes:
        """A request body in its declared content-encoding, decoded
        (gzip and deflate); ValueError on anything else or a corrupt
        body."""
        if enc in ("", "identity"):
            return raw
        try:
            if enc == "gzip":
                return gzip.decompress(raw)
            if enc == "deflate":
                try:
                    return zlib.decompress(raw)
                except zlib.error:
                    return zlib.decompress(raw, -zlib.MAX_WBITS)
        except (OSError, EOFError, zlib.error):
            raise ValueError(f"invalid {enc} request body") from None
        raise ValueError(f"unsupported content-encoding: {enc}")

    async def _handle(self, request: Request) -> "Response | StreamResponse":
        endpoint, front_schema, operation = _ENDPOINTS[request.path]
        rc = self._runtime  # pin the config for this request
        started = time.monotonic()
        error_body = (anth.error_body
                      if front_schema is APISchemaName.ANTHROPIC
                      else oai.error_body)
        try:
            raw = self._decode_body(
                request.body,
                request.headers.get("content-encoding", "").lower().strip())
        except ValueError as e:
            self._log_rejection(request, 400, started, reason="bad_encoding")
            return _error(400, error_body(str(e)))
        # ---- phase 1: route selection ----------------------------------
        body: Any
        if endpoint in _MULTIPART_ENDPOINTS:
            ctype = request.headers.get("content-type", "")
            model = _multipart_model(raw, ctype)
            if not model:
                self._log_rejection(request, 400, started,
                                    reason="missing_model")
                return _error(400, error_body("missing 'model' form field"))
            body = _RawBody(raw, ctype, model)
        else:
            try:
                body = oai.parse_json_body(raw)
                model = oai.request_model(body)
                if endpoint is Endpoint.MESSAGES:
                    anth.validate_messages_request(body)
                else:
                    typed_schemas.validate_request(endpoint.value, body)
            except oai.SchemaError as e:
                self._log_rejection(request, 400, started,
                                    reason="invalid_request")
                return _error(400, error_body(str(e)))
        client_headers = dict(request.headers)
        # the tenant: an explicit header wins, else the adapter suffix of
        # a zoo name; the cost sink and the upstream relay key on it
        tenant = client_headers.get(TENANT_HEADER, "") or \
            split_model(model)[1]
        if tenant:
            client_headers[TENANT_HEADER] = tenant
        match_headers = {
            **client_headers,
            MODEL_NAME_HEADER: model,
            ORIGINAL_PATH_HEADER: request.path,
        }
        try:
            match = match_route(rc, request.host, match_headers)
        except NoRouteError:
            self._log_rejection(request, 404, started, model=model,
                                reason="model_not_found")
            return _error(404, error_body(
                f"model {model!r} is not served by this gateway",
                type_="model_not_found"
                if front_schema is APISchemaName.OPENAI
                else "not_found_error"))

        req_metrics = RequestMetrics(
            metrics=self.metrics, operation=operation, request_model=model
        )
        selector = BackendSelector(rule=match.rule, circuit=self.circuit,
                                   rng=self.rng)
        route_name = match.route.name
        # the gateway's span continues the caller's trace
        span = None
        if self.tracer.enabled:
            parent = self.tracer.propagators.extract(client_headers)
            span = self.tracer.start_span(f"{operation} {model}", parent)
            span.attributes.update(
                header_attributes(client_headers, self._header_attrs))
            if isinstance(body, dict):
                span.attributes.update(
                    self._openinference_request_attrs(endpoint, body, raw))
        # ---- phase 2: upstream attempts --------------------------------
        status = 500
        try:
            resp_out = await self._attempt_loop(
                request, endpoint, front_schema, selector, rc, body,
                req_metrics, route_name, error_body, client_headers, span)
            status = resp_out.status
            return resp_out
        finally:
            self._end_request(request, span, operation, model, status,
                              req_metrics, route_name, client_headers)

    def _end_request(self, request: Request, span: Span | None,
                     operation: str, model: str, status: int,
                     req_metrics: RequestMetrics, route_name: str,
                     client_headers: dict[str, str]) -> None:
        """The span's GenAI attributes and error, its end, and the
        request's access-log line."""
        usage = req_metrics.final_usage or TokenUsage()
        if span is not None:
            span.attributes.update(genai_attributes(
                operation=operation,
                request_model=model,
                response_model=req_metrics.response_model,
                backend=req_metrics.provider,
                input_tokens=usage.input_tokens,
                output_tokens=usage.output_tokens,
                streaming=req_metrics.tokens_seen > 0,
            ))
            if req_metrics.error_type:
                span.record_error(req_metrics.error_type)
            span.end()
        if not self.access_log.enabled:
            return
        err = req_metrics.error_type
        if err.isdigit():
            err = oi.error_type_for_status(int(err))
        self.access_log.log(
            method=request.method,
            path=request.path,
            status=status,
            duration_ms=(time.monotonic() - req_metrics.start) * 1000.0,
            route=route_name,
            backend=req_metrics.provider,
            model=model,
            response_model=req_metrics.response_model,
            stream=req_metrics.tokens_seen > 0,
            input_tokens=usage.input_tokens,
            output_tokens=usage.output_tokens,
            total_tokens=usage.total_tokens,
            cached_tokens=usage.cached_input_tokens,
            costs=req_metrics.costs,
            error_type=err,
            client=request.remote or "",
            trace_id=span.context.trace_id if span is not None else "",
            span_id=span.context.span_id if span is not None else "",
            request_id=client_headers.get("x-request-id", ""),
            upstream_request_id=req_metrics.upstream_request_id,
            attempts=req_metrics.attempts,
            decision=req_metrics.decision,
        )

    def _openinference_request_attrs(
        self, endpoint: Endpoint, body: dict[str, Any], raw: bytes
    ) -> dict[str, Any]:
        try:
            if endpoint is Endpoint.CHAT_COMPLETIONS:
                return oi.chat_request_attributes(body, raw, self._oi_config)
            if endpoint is Endpoint.MESSAGES:
                return oi.chat_request_attributes(
                    body, raw, self._oi_config,
                    system=oi.LLM_SYSTEM_ANTHROPIC)
            if endpoint is Endpoint.EMBEDDINGS:
                return oi.embeddings_request_attributes(
                    body, raw, self._oi_config)
            if endpoint is Endpoint.COMPLETIONS:
                return oi.completion_request_attributes(
                    body, raw, self._oi_config)
            if endpoint is Endpoint.RERANK:
                return oi.rerank_request_attributes(
                    body, raw, self._oi_config)
        except Exception:  # noqa: BLE001 (telemetry never fails a request)
            logger.debug("openinference request attrs failed",
                         exc_info=True)
        return {}

    @staticmethod
    def _oi_response_builder(endpoint: "Endpoint | None"):
        """The response-attribute builder of an endpoint, for unary
        replies and streams alike (MESSAGES is the Anthropic front)."""
        return {
            Endpoint.CHAT_COMPLETIONS: oi.chat_response_attributes,
            Endpoint.MESSAGES: oi.anthropic_response_attributes,
            Endpoint.EMBEDDINGS: oi.embeddings_response_attributes,
            Endpoint.COMPLETIONS: oi.completion_response_attributes,
            Endpoint.RERANK: oi.rerank_response_attributes,
        }.get(endpoint)

    def _openinference_response_attrs(self, span: Span, endpoint: Endpoint,
                                      payload: bytes) -> None:
        builder = self._oi_response_builder(endpoint)
        if builder is None:
            return
        try:
            resp = json.loads(payload)
            if not isinstance(resp, dict):
                return
            span.attributes.update(builder(resp, self._oi_config))
        except Exception:  # noqa: BLE001 (telemetry never fails a request)
            logger.debug("openinference response attrs failed",
                         exc_info=True)

    async def _attempt_loop(
        self, request, endpoint, front_schema, selector, rc, body,
        req_metrics, route_name, error_body, client_headers, span,
    ) -> "Response | StreamResponse":
        last_error: tuple[int, bytes] = (
            502,
            error_body("all upstream backends failed",
                       type_="upstream_error"),
        )
        attempt = 0
        while True:
            ref = selector.next_backend()
            if ref is None:
                break
            rb = rc.backends[ref.backend]
            if attempt > 0:
                self.metrics.retries_total.labels(
                    route_name, rb.backend.name).inc()
            attempt += 1
            req_metrics.attempts = attempt
            req_metrics.provider = rb.backend.name
            try:
                result = await self._attempt(
                    request, endpoint, front_schema, rb, body,
                    req_metrics, route_name, error_body, client_headers,
                    span,
                )
            except _RetriableUpstreamError as e:
                logger.warning(
                    "backend %s failed (%s), trying next", rb.backend.name, e
                )
                if e.count_failure:
                    self.circuit.record_failure(rb.backend.name)
                last_error = (e.status, e.client_body)
                self.metrics.requests_total.labels(
                    route_name, rb.backend.name, str(e.status)
                ).inc()
                continue
            except AuthError as e:
                req_metrics.finish(TokenUsage(), error_type="auth")
                return _error(401, error_body(
                    str(e), type_="authentication_error"))
            except (TranslationError, oai.SchemaError) as e:
                req_metrics.finish(TokenUsage(), error_type="translation")
                status = getattr(e, "status", 400)
                return _error(status, error_body(
                    str(e), type_="not_found" if status == 404
                    else "invalid_request_error"))
            self.circuit.record_success(rb.backend.name)
            return result

        req_metrics.finish(TokenUsage(), error_type="upstream_exhausted")
        return _error(last_error[0], last_error[1])

    def _pick(self, backend, body, req_metrics, route_name, error_body,
              client_headers, headers, span):
        """The pool's replica for this request: (destination, the
        headers the pick read, its decision-ring entry, the prefix key
        it used), or a finished 429/400 ``Response`` when the picker
        sheds or no replica fits the prompt. The span gets the pick's
        attributes."""
        pick_headers = client_headers
        if backend.picker_content_affinity and isinstance(body, dict):
            derived = {}
            if AFFINITY_HEADER not in client_headers:
                key = _conversation_affinity_key(body)
                if key:
                    derived[AFFINITY_HEADER] = key
            if PREFIX_HEADER not in client_headers:
                # the shared system-prompt hash: soft cache affinity
                pkey = _prefix_hash_key(body)
                if pkey:
                    derived[PREFIX_HEADER] = pkey
            if derived:
                pick_headers = dict(client_headers) | derived
        # an adapter-suffixed zoo name prefers replicas with the LoRA row
        # resident (soft: any replica can load it)
        adapter = split_model(req_metrics.request_model)[1]
        if adapter and ADAPTER_HEADER not in pick_headers:
            pick_headers = dict(pick_headers) | {ADAPTER_HEADER: adapter}
        # prompt length is a routing input: an explicit header wins, else
        # the estimate from the prompt's bytes
        if (PROMPT_TOKENS_HEADER not in pick_headers
                and isinstance(body, dict)):
            est = _prompt_token_estimate(body)
            if est:
                pick_headers = dict(pick_headers) | {
                    PROMPT_TOKENS_HEADER: str(est)}
        picker = self._pickers[backend.name]
        request_id = client_headers.get("x-request-id", "")
        explain: dict[str, Any] = {}
        try:
            dest = picker.pick(pick_headers, explain=explain) or ""
        except SLOShedError as e:
            # every candidate's predicted TTFT blows the SLO: shed with
            # 429 + Retry-After instead of queueing into collapse
            self.metrics.slo_sheds_total.labels(
                route_name, backend.name).inc()
            self.metrics.requests_total.labels(
                route_name, backend.name, "429").inc()
            req_metrics.finish(TokenUsage(), error_type="slo_shed")
            if backend.fleet_obs:
                req_metrics.decision = self.decisions.record(
                    route=route_name, backend=backend.name,
                    model=req_metrics.request_model, request_id=request_id,
                    shed=True, retry_after_s=e.retry_after_s,
                    pick=dict(explain))
            if span is not None:
                span.set("aigw.pick.shed", True)
                span.set("aigw.pick.predicted_ttft_ms",
                         round(e.predicted_ms, 1))
            return _error(429, error_body(str(e), type_="rate_limit_error"),
                          {"retry-after": str(e.retry_after_s)})
        except ContextLengthError as e:
            # the prompt exceeds every fresh candidate's context length
            self.metrics.requests_total.labels(
                route_name, backend.name, "400").inc()
            req_metrics.finish(TokenUsage(), error_type="context_length")
            if backend.fleet_obs:
                req_metrics.decision = self.decisions.record(
                    route=route_name, backend=backend.name,
                    model=req_metrics.request_model, request_id=request_id,
                    context_rejected=True, prompt_tokens=e.prompt_tokens,
                    max_ctx=e.max_ctx, pick=dict(explain))
            if span is not None:
                span.set("aigw.pick.context_rejected", True)
                span.set("aigw.pick.prompt_tokens", e.prompt_tokens)
                span.set("aigw.pick.max_ctx", e.max_ctx)
            return _error(400, error_body(
                str(e), type_="invalid_request_error"))
        decision = None
        if dest and backend.fleet_obs:
            decision = self.decisions.record(
                route=route_name, backend=backend.name,
                model=req_metrics.request_model, request_id=request_id,
                chosen=dest, pick=dict(explain))
            req_metrics.decision = decision
        if span is not None and dest:
            # which replica served the request, and why the picker chose
            # it (affinity, cache or load; slo mode's predicted TTFTs)
            span.set("aigw.endpoint", dest)
            for k, v in (explain or {}).items():
                span.set(f"aigw.pick.{k}",
                         json.dumps(v) if isinstance(v, dict) else v)
        if dest and backend.kv_fleet:
            # name the siblings the fleet index says hold this request's
            # chain: a prefix miss on the chosen replica becomes a page
            # fetch over /kv/pages instead of a re-prefill
            peers = picker.kv_peers(dest, pick_headers)
            if peers:
                headers[KV_PEERS_HEADER] = ",".join(peers)
                if decision is not None:
                    decision["kv_peers"] = list(peers)
        return dest, pick_headers, decision, pick_headers.get(
            PREFIX_HEADER, "")

    async def _attempt(
        self,
        request: Request,
        endpoint: Endpoint,
        front_schema: APISchemaName,
        rb: RuntimeBackend,
        body: "dict[str, Any] | _RawBody",
        req_metrics: RequestMetrics,
        route_name: str,
        error_body: Callable[..., bytes],
        client_headers: dict[str, str],
        span: Span | None = None,
    ) -> "Response | StreamResponse":
        backend = rb.backend
        limited = await self._check_quota(client_headers, rb, req_metrics,
                                          error_body)
        if limited is not None:
            return limited
        if isinstance(body, _RawBody):
            # multipart passthrough: the original bytes go upstream, with
            # the model part rewritten when the backend overrides the
            # model name; the response side is the OpenAI passthrough
            translator = get_translator(Endpoint.CHAT_COMPLETIONS,
                                        APISchemaName.OPENAI,
                                        APISchemaName.OPENAI)
            out_body, out_ctype = body.raw, body.content_type
            if (backend.model_name_override
                    and backend.model_name_override != body.model):
                from aigw_tpu_torch.translate.multipart import (
                    rewrite_multipart_model,
                )

                out_body, out_ctype = rewrite_multipart_model(
                    body.raw, body.content_type,
                    backend.model_name_override)
            tx = RequestTx(body=out_body, path=request.path)
            headers = {"content-type": out_ctype,
                       "accept": "application/json"}
        else:
            translator = get_translator(
                endpoint,
                front_schema,
                backend.schema.name,
                model_name_override=backend.model_name_override,
                out_version=backend.schema.version,
            )
            # translators never mutate the captured body, so each attempt
            # re-translates it without a copy
            if self._translator_blocks(endpoint):
                # a file-backed transcript store: resolving
                # previous_response_id reads the disk, off the loop
                tx = await asyncio.to_thread(translator.request, body)
            else:
                tx = translator.request(body)
            out_body = apply_body_mutation(tx.body, backend.body_mutation)
            headers = {
                "content-type": "application/json",
                "accept": "text/event-stream" if tx.stream
                else "application/json",
            }
        # an externally pre-selected destination wins; otherwise the
        # picker chooses a replica of the backend's pool
        dest = request.headers.get(DESTINATION_ENDPOINT_HEADER, "")
        prefix_key_used = ""
        decision: dict[str, Any] | None = None
        pick_headers = client_headers
        if not dest and backend.name in self._pickers:
            picked_ = self._pick(backend, body, req_metrics, route_name,
                                 error_body, client_headers, headers, span)
            if isinstance(picked_, Response):
                return picked_
            dest, pick_headers, decision, prefix_key_used = picked_
        base_url = f"http://{dest}" if dest else backend.url
        if not base_url:
            raise _RetriableUpstreamError(
                502, error_body(f"backend {backend.name} has no url"),
                "missing url")
        headers.update(tx.headers)
        if span is not None:
            self.tracer.propagators.inject(span.context, headers)
        else:
            # tracing off at the gateway: relay the caller's trace
            # context, so the replica's spans and flight entries still
            # parent on the caller's trace
            relay_trace_headers(client_headers, headers)
        # the replica's fairness guard and two-class scheduler see the
        # tenant and the priority the gateway routed and accounts by
        for h in (TENANT_HEADER, PRIORITY_HEADER):
            if h in client_headers:
                headers[h] = client_headers[h]
        headers = apply_header_mutation(headers, backend.header_mutation)
        headers["host"] = urllib.parse.urlsplit(base_url).netloc
        path = tx.path or request.path
        # credentials last: SigV4 signs the final body and host
        headers, path = rb.auth_handler.apply(headers, out_body, path)
        if logger.isEnabledFor(logging.DEBUG):
            logger.debug(
                "upstream attempt backend=%s path=%s headers=%s body=%s",
                backend.name, path, redact_headers(headers),
                redact_body(body) if not isinstance(body, _RawBody)
                else f"[multipart {len(body.raw)} bytes]",
            )
        timeout = Timeout(
            total=backend.request_timeout,
            connect=min(10.0, backend.request_timeout),
            sock_read=backend.stream_idle_timeout if tx.stream else None,
        )
        #: the pick went through the picker (an external pin is not
        #: failed over: the pinner chose that replica on purpose)
        picked = bool(dest) and backend.name in self._pickers

        def _move_dest(nxt: str) -> None:
            # re-aim the same translated request at a sibling replica
            nonlocal dest, base_url, headers, path
            if decision is not None:
                decision.setdefault("failover_from", []).append(dest)
                decision["chosen"] = nxt
            if span is not None:
                span.set("aigw.pick.failover_from", dest)
            if KV_PEERS_HEADER in headers:
                peers = [p for p in headers[KV_PEERS_HEADER].split(",")
                         if p and p != nxt]
                if peers:
                    headers[KV_PEERS_HEADER] = ",".join(peers)
                else:
                    del headers[KV_PEERS_HEADER]
            dest = nxt
            base_url = f"http://{dest}"
            headers["host"] = urllib.parse.urlsplit(base_url).netloc
            # a new host: sign again (the handler is retry-safe)
            headers, path = rb.auth_handler.apply(headers, out_body, path)

        def _sibling(tried: set[str]) -> str | None:
            picker = self._pickers.get(backend.name)
            if picker is None:
                return None
            try:
                nxt = picker.pick(pick_headers, exclude=frozenset(tried))
            except (SLOShedError, ContextLengthError):
                return None
            return nxt if nxt and nxt not in tried else None

        # at most one sibling retry, before any byte has been relayed: a
        # connect error or an immediate retriable 5xx from a picked
        # replica re-picks the next-ranked sibling
        failed_over = not picked
        breaker_counted: set[str] = set()
        while True:
            try:
                resp = await self.client.post(
                    base_url + path, data=out_body, headers=headers,
                    timeout=timeout)
            except (ClientError, asyncio.TimeoutError) as e:
                if picked:
                    # per-replica breaker evidence
                    self.circuit.record_failure(dest)
                if not failed_over:
                    nxt = _sibling({dest})
                    if nxt is not None:
                        failed_over = True
                        logger.warning(
                            "pre-first-byte failover %s -> %s (%s)",
                            dest, nxt, e)
                        _move_dest(nxt)
                        continue
                raise _RetriableUpstreamError(
                    502, error_body(f"upstream connect error: {e}",
                                    type_="upstream_error"),
                    str(e) or type(e).__name__,
                ) from None
            if not failed_over and resp.status in (500, 502, 503, 504):
                self.circuit.record_failure(dest)
                breaker_counted.add(dest)
                nxt = _sibling({dest})
                if nxt is not None:
                    failed_over = True
                    logger.warning(
                        "pre-first-byte failover %s -> %s (status %d)",
                        dest, nxt, resp.status)
                    resp.release()
                    _move_dest(nxt)
                    continue
            break

        async with resp:
            if resp.status >= 400:
                try:
                    err = await resp.read()
                except (ClientError, asyncio.TimeoutError):
                    err = b""
                client_err = translator.response_error(resp.status, err)
                if resp.status in _RETRIABLE_STATUS:
                    if picked and dest not in breaker_counted:
                        self.circuit.record_failure(dest)
                    raise _RetriableUpstreamError(resp.status, client_err,
                                                  f"status {resp.status}")
                req_metrics.finish(TokenUsage(), error_type=str(resp.status))
                self.metrics.requests_total.labels(
                    route_name, backend.name, str(resp.status)
                ).inc()
                return _error(resp.status, client_err)

            if picked:
                # the response started: close the replica's circuit
                self.circuit.record_success(dest)
            translator.response_headers(resp.status, dict(resp.headers))
            # the replica's request id joins this request to its
            # /debug/requests/{id} timeline
            req_metrics.upstream_request_id = resp.headers.get(
                "x-aigw-request-id", "")
            if decision is not None and req_metrics.upstream_request_id:
                decision["upstream_request_id"] = (
                    req_metrics.upstream_request_id)
            if backend.name in self._pickers:
                # learn (prefix head → KV chain) from the replica's
                # response, so the fleet index can locate it later
                chain_hex = resp.headers.get(KV_CHAIN_HEADER, "")
                if chain_hex and prefix_key_used:
                    self._pickers[backend.name].note_chain(
                        prefix_key_used, chain_hex)
            ctype = resp.headers.get("content-type", "")
            if tx.stream and ("text/event-stream" in ctype
                              or "vnd.amazon.eventstream" in ctype):
                migrator = None
                if (backend.migration and dest
                        and backend.name in self._pickers
                        and endpoint in (Endpoint.CHAT_COMPLETIONS,
                                         Endpoint.COMPLETIONS)):
                    # this stream may be handed to a decode-leaning
                    # replica mid-flight if the source's prefill queue
                    # backs up, or to any sibling if the source drains
                    migrator = _Migrator(
                        picker=self._pickers[backend.name],
                        backend=backend, src=dest, client=self.client,
                        decision=decision)
                return await self._stream_response(
                    request, resp, translator, rb, req_metrics, route_name,
                    client_headers, front_schema, span=span,
                    endpoint=endpoint, migrator=migrator)
            try:
                raw = await resp.read()
            except (ClientError, asyncio.TimeoutError) as e:
                raise _RetriableUpstreamError(
                    502,
                    error_body(f"upstream body read failed: {e}",
                               type_="upstream_error"),
                    str(e) or type(e).__name__,
                ) from None
            if self._translator_blocks(endpoint):
                # the end of the response persists the transcript to disk
                rx = await asyncio.to_thread(
                    translator.response_body, raw, True)
            else:
                rx = translator.response_body(raw, True)
            # the body the gateway re-emits must carry the front schema's
            # shape: a malformed upstream body is an upstream failure,
            # retried on the next backend like any other 502
            if (not isinstance(body, _RawBody)
                    and typed_response.has_spec(endpoint)):
                parsed = rx.parsed
                try:
                    if parsed is None:
                        parsed = json.loads(rx.body or raw)
                    typed_response.validate_response(endpoint, parsed)
                except (json.JSONDecodeError, oai.SchemaError) as e:
                    if (endpoint is Endpoint.RESPONSES
                            and isinstance(parsed, dict)):
                        # the translator stored a transcript under an id
                        # the client will never see: roll it back
                        await self._forget_response(parsed.get("id"))
                    raise _RetriableUpstreamError(
                        502,
                        error_body(
                            f"upstream returned a malformed "
                            f"{endpoint.value} response: {e}",
                            type_="upstream_error"),
                        f"malformed upstream body: {e}",
                    ) from None
            usage = rx.usage
            req_metrics.response_model = rx.model
            if span is not None:
                self._openinference_response_attrs(
                    span, endpoint, rx.body or raw)
            req_metrics.finish(usage)
            await self._sink_costs(usage, req_metrics, route_name,
                                   client_headers)
            self.metrics.requests_total.labels(
                route_name, backend.name, str(resp.status)
            ).inc()
            upstream_ctype = resp.headers.get(
                "content-type", "application/json")
            out_headers = {}
            if req_metrics.upstream_request_id:
                out_headers["x-aigw-request-id"] = (
                    req_metrics.upstream_request_id)
            return Response(resp.status, rx.body or raw,
                            upstream_ctype.split(";")[0], out_headers)

    async def _stream_response(
        self,
        request: Request,
        resp: ClientResponse,
        translator: Any,
        rb: RuntimeBackend,
        req_metrics: RequestMetrics,
        route_name: str,
        client_headers: dict[str, str],
        front_schema: APISchemaName = APISchemaName.OPENAI,
        span: Span | None = None,
        endpoint: Endpoint | None = None,
        migrator: "_Migrator | None" = None,
    ) -> StreamResponse:
        """Relay the SSE stream through the translator. Nothing here
        buffers beyond one complete event: upstream bytes are handled as
        they arrive, every complete, valid event is written and drained
        at once (only a partial tail waits for its terminator), and a
        malformed event is never relayed: the stream ends with the error
        event instead. With a ``migrator``, the source's stream may be
        cut at a token boundary and the target's continuation relayed
        after it.

        A chunked body that ends before its last chunk (a replica that
        died mid-stream) is torn and ends with the error event. An
        upstream that delimits its SSE body by closing the connection
        gives no such signal, so such a stream that ends with no
        ``[DONE]`` and was not cut by the migrator ends with the error
        event too. The error event takes the front schema's shape. With
        a span, chat, Messages and completions streams rebuild their
        response from the relayed bytes (``StreamAccumulator``) for the
        span's output attributes."""
        out = StreamResponse(
            status=200,
            headers={
                "content-type": "text/event-stream",
                "cache-control": "no-cache",
                "x-accel-buffering": "no",
            },
        )
        if req_metrics.upstream_request_id:
            out.headers["x-aigw-request-id"] = (
                req_metrics.upstream_request_id)
        await out.prepare(request)
        usage = TokenUsage()
        model = ""
        # a stream's output attributes: its response rebuilt from the
        # front-schema bytes, only when a span exists (every event is
        # parsed)
        acc = None
        if span is not None and endpoint in (
                Endpoint.CHAT_COMPLETIONS, Endpoint.MESSAGES,
                Endpoint.COMPLETIONS):
            acc = oi.StreamAccumulator()
        sse_buf = b""
        check_events = typed_response.has_stream_spec(endpoint)

        def _bad_event(raw: bytes) -> "oai.SchemaError | None":
            from aigw_tpu_torch.translate.sse import _parse_event

            ev = _parse_event(raw)
            if ev is None or not ev.data or ev.data.strip() == "[DONE]":
                return None
            try:
                typed_response.validate_stream_event(
                    endpoint, json.loads(ev.data))
            except (json.JSONDecodeError, oai.SchemaError) as e:
                return oai.SchemaError(str(e))
            return None

        def _scan_events(
            buf: bytes,
        ) -> "tuple[bytes, bytes, oai.SchemaError | None]":
            """(the relay-able prefix of complete good events, the
            remainder, an error). On error the bad event stays in the
            remainder. An event ends at the first blank line, \\n\\n or
            \\r\\n\\r\\n, as in SSEParser.feed."""
            ok_end = pos = 0
            while True:
                sep = -1
                seplen = 0
                for cand in (b"\n\n", b"\r\n\r\n"):
                    i = buf.find(cand, pos)
                    if i != -1 and (sep == -1 or i < sep):
                        sep, seplen = i, len(cand)
                if sep == -1:
                    return buf[:ok_end], buf[ok_end:], None
                err = _bad_event(buf[pos:sep])
                if err is not None:
                    return buf[:ok_end], buf[ok_end:], err
                pos = ok_end = sep + seplen

        async def _relay(body: bytes) -> None:
            nonlocal sse_buf
            if not check_events:
                if acc is not None:
                    acc.feed(body)
                await out.write(body)
                return
            good, sse_buf, err = _scan_events(sse_buf + body)
            if good:
                if acc is not None:
                    acc.feed(good)
                await out.write(good)
            if err is not None:
                raise err

        done_terminated = rb.backend.schema.name in _DONE_TERMINATED

        def _torn(r: ClientResponse, tail: bytes) -> bool:
            # a close-delimited SSE body that ended before its [DONE]
            # (another schema's stream has no such marker to miss)
            return (done_terminated and r.close_delimited
                    and b"[DONE]" not in tail)

        try:
            tail = b""
            async for chunk in resp.iter_any():
                tail = (tail + chunk)[-32:]
                rx = translator.response_body(chunk, False)
                usage = usage.merge_override(rx.usage)
                model = rx.model or model
                req_metrics.record_tokens_emitted(rx.tokens_emitted)
                if rx.body:
                    await _relay(rx.body)
                if migrator is not None:
                    # may cut the session at the source: its stream then
                    # ends at a token boundary and this loop runs to its
                    # end, relaying every token before the cut
                    await migrator.maybe_export(
                        req_metrics.tokens_seen,
                        req_metrics.upstream_request_id)
            torn = (migrator is None or migrator.export is None) \
                and _torn(resp, tail)
            if migrator is not None and migrator.export is not None:
                # splice the target's continuation: its frames carry the
                # same response id, terminal frames included, so the
                # client sees one stream
                cont = await migrator.start_continuation()
                if cont is None:
                    # resume from the exported state on another sibling:
                    # the blob is in hand and no continuation byte was
                    # relayed yet
                    cont = await migrator.retry_continuation()
                if cont is None:
                    # cut and resumed nowhere: a real mid-stream loss,
                    # ended with the typed error event below
                    raise ClientPayloadError(
                        "migration continuation failed after export")
                self.metrics.migrations_total.labels(
                    route_name, rb.backend.name).inc()
                if span is not None:
                    span.set("aigw.migrated_to", migrator.target)
                async with cont:
                    tail = b""
                    async for chunk in cont.iter_any():
                        tail = (tail + chunk)[-32:]
                        rx = translator.response_body(chunk, False)
                        usage = usage.merge_override(rx.usage)
                        model = rx.model or model
                        req_metrics.record_tokens_emitted(
                            rx.tokens_emitted)
                        if rx.body:
                            await _relay(rx.body)
                    torn = _torn(cont, tail)
            if self._translator_blocks(endpoint):
                # the end of the stream persists the transcript to disk
                rx = await asyncio.to_thread(
                    translator.response_body, b"", True)
            else:
                rx = translator.response_body(b"", True)
            usage = usage.merge_override(rx.usage)
            model = rx.model or model
            if rx.body:
                await _relay(rx.body)
            if check_events and sse_buf:
                # a final event with no blank line after it: validated
                # before it is relayed, as every other
                err = _bad_event(sse_buf)
                if err is not None:
                    raise err
                await out.write(sse_buf)
                sse_buf = b""
            if torn:
                raise ClientPayloadError("upstream stream ended before "
                                         "its [DONE]")
        except (ClientError, asyncio.TimeoutError, oai.SchemaError) as e:
            # mid-stream failure: the client already has bytes, so the
            # stream ends with an SSE error event, never a retry
            malformed = isinstance(e, oai.SchemaError)
            logger.warning("stream from %s %s: %s", rb.backend.name,
                           "emitted malformed event" if malformed
                           else "aborted", e)
            msg = ("upstream emitted a malformed stream event"
                   if malformed else "upstream stream interrupted")
            if front_schema is APISchemaName.ANTHROPIC:
                # Anthropic SDKs read `event: error` with their envelope
                await out.write(
                    b'event: error\n'
                    b'data: {"type": "error", "error": {"type": '
                    b'"overloaded_error", "message": "'
                    + msg.encode() + b'"}}\n\n'
                )
            else:
                await out.write(
                    b'data: {"error": {"message": "' + msg.encode()
                    + b'", "type": "upstream_error", "code": null}}\n\n'
                )
        req_metrics.response_model = model
        if acc is not None:
            final = acc.response()
            builder = self._oi_response_builder(endpoint)
            if final is not None and builder is not None:
                try:
                    span.attributes.update(builder(final, self._oi_config))
                except Exception:  # noqa: BLE001 (telemetry only)
                    logger.debug("stream span attrs failed", exc_info=True)
        req_metrics.finish(usage)
        await self._sink_costs(usage, req_metrics, route_name,
                               client_headers)
        self.metrics.requests_total.labels(route_name, rb.backend.name,
                                           "200").inc()
        await out.write_eof()
        return out

    @staticmethod
    def _translator_blocks(endpoint: "Endpoint | None") -> bool:
        """True when the translator's request and end-of-response calls
        do disk I/O (``/v1/responses`` over a file-backed transcript
        store), so the event loop hands them to a thread."""
        if endpoint is not Endpoint.RESPONSES:
            return False
        from aigw_tpu_torch.translate.responses import RESPONSE_STORE

        return RESPONSE_STORE.blocking

    async def _forget_response(self, rid: Any) -> None:
        """Roll back a stored Responses transcript (its response failed
        typed validation and was never delivered)."""
        if not isinstance(rid, str) or not rid:
            return
        from aigw_tpu_torch.translate.responses import RESPONSE_STORE

        if RESPONSE_STORE.blocking:
            await asyncio.to_thread(RESPONSE_STORE.delete, rid)
        else:
            RESPONSE_STORE.delete(rid)

    async def _check_quota(self, client_headers, rb, req_metrics,
                           error_body) -> Response | None:
        """Admission against the token quotas; a 429 ``Response`` when a
        rule's budget is spent, else None. Consumption happens at the
        end of the request, in ``_sink_costs``. A shared (flock'd file
        or quota service) backend can block, so it runs off the event
        loop; the in-memory limiter is called inline."""
        limiter = self._runtime.rate_limiter
        if limiter is None or not limiter.rules:
            return None
        if limiter.backend is not None:
            ok, rule = await asyncio.to_thread(
                limiter.check,
                req_metrics.request_model, rb.backend.name, client_headers)
        else:
            ok, rule = limiter.check(
                req_metrics.request_model, rb.backend.name, client_headers)
        if ok:
            return None
        client_err = error_body(
            f"token quota exceeded (rule {rule.name!r})",
            type_="rate_limit_error")
        if rule.backend:
            # a backend-scoped budget: other backends may still have
            # budget, so fail over, without a circuit-breaker mark (the
            # backend is healthy; a refilled window must not find its
            # circuit open)
            raise _RetriableUpstreamError(429, client_err,
                                          f"quota {rule.name}",
                                          count_failure=False)
        req_metrics.finish(TokenUsage(), error_type="429")
        return _error(429, client_err, {"retry-after": "1"})

    async def _sink_costs(
        self,
        usage: TokenUsage,
        req_metrics: RequestMetrics,
        route_name: str,
        client_headers: dict[str, str],
    ) -> None:
        """The end-of-request cost metadata, keyed by the request model
        (the value ``_check_quota`` matched, so a model-scoped budget
        holds when the replica reports another response model): every
        finished request is recorded in the usage ledger (with the
        replica's MeterRecord from ``usage.aigw_meter``), its priced cost
        stamped on its decision-ring entry, and its costs drawn from the
        matching quotas. The access log's cost fields need it too."""
        limiter = self._runtime.rate_limiter
        has_quota = limiter is not None and limiter.rules
        ledger = self.usage_ledger
        if (self.cost_sink is None and ledger is None and not has_quota
                and not self.access_log.enabled):
            return
        model = req_metrics.request_model
        backend = req_metrics.provider
        tenant = client_headers.get(TENANT_HEADER, "")
        costs = self._runtime.cost_calculator_for(route_name).calculate(
            usage, model=model, backend=backend, route_name=route_name,
            tenant=tenant,
        )
        if ledger is not None:
            # the ledger's cost is the sum of the configured cost
            # metrics (0 with none; the token and residency columns
            # still count)
            total_cost = sum(costs.values())
            ledger.record(tenant, model, usage, cost=total_cost)
            req_metrics.decision["cost"] = total_cost
            if costs:
                req_metrics.decision["costs"] = dict(costs)
        if not costs:
            return
        req_metrics.costs = dict(costs)
        if has_quota:
            if limiter.backend is not None:
                # a shared store: lock contention must not stall the loop
                await asyncio.to_thread(
                    limiter.consume, costs, model, backend, client_headers)
            else:
                limiter.consume(costs, model, backend, client_headers)
        if self.cost_sink is not None:
            self.cost_sink(
                costs,
                {"model": model, "backend": backend, "route": route_name},
            )


class _Migrator:
    """The gateway side of moving ONE streaming session between
    replicas. While the gateway relays a stream from its source replica
    it watches the picker's polled telemetry; when the source's
    admission queue is deep (prefill pressure), the session is still
    young, and a decode-leaning sibling exists (or at once, to any
    sibling that can take it, when the source drains), it cuts the
    session through the source's ``/migrate/export`` and splices the
    target's ``/migrate/import`` continuation: the client sees one SSE
    stream under one response id.

    At most one migration attempt per request; a declined or failed
    export leaves the source serving untouched."""

    def __init__(self, picker: EndpointPicker, backend, src: str,
                 client: HTTPClient, decision: dict | None = None):
        self.picker = picker
        self.backend = backend
        self.src = src
        self.client = client
        self.attempted = False
        self.export: dict | None = None
        self.target: str | None = None
        #: the request's audit-ring entry: a fired migration is stamped
        #: there, so /debug/decisions shows the trigger beside the pick
        self.decision = decision

    def _drain_requested(self) -> bool:
        """The source replica is draining (a controller's scale-in or
        retirement, an operator's /drain, or its own /state): every
        migration-capable stream moves off whatever its queue or age."""
        h = self.picker.fleet.health.get(self.src)
        return h is not None and h.draining

    def _pick_target(self, force: bool = False,
                     exclude: set | frozenset = frozenset()
                     ) -> str | None:
        src_st = self.picker.state.get(self.src)
        if src_st is None or not src_st.healthy:
            return None
        if not src_st.migration_capable:
            # the replica reports `migration: false` on /state (its
            # prefix cache is off: no refcounted page export): stop
            # checking this stream instead of getting a 409
            self.attempted = True
            return None
        if not force and src_st.queued < self.backend.migration_queue_depth:
            return None  # no prefill pressure at the source
        now = self.picker.clock()
        best: str | None = None
        best_pred = 0.0
        for addr, st in self.picker.state.items():
            if addr == self.src or addr in exclude or not st.healthy:
                continue
            if not self.picker.is_routable(addr):
                continue  # down, draining or breaker-open: not a home
            if not st.migration_capable:
                continue  # cannot adopt a page chain
            if now - st.updated_at >= self.picker.STALE_AFTER:
                continue
            if st.queued > 0 or st.active_slots >= st.max_slots:
                continue  # not decode-leaning: no slot for the stream
            p = self.picker.predicted_ttft_ms(st)
            p = 0.0 if p is None else p
            if best is None or p < best_pred:
                best, best_pred = addr, p
        return best

    async def maybe_export(self, tokens_seen: int, rid: str) -> None:
        """The check after each relayed chunk (dict reads until the
        trigger fires). On the trigger, POSTs the source's export route;
        the source then ends its stream at a token boundary and the
        relay loop runs to its end, relaying every token before the
        cut."""
        if self.attempted or not rid or tokens_seen < 1:
            return
        draining = self._drain_requested()
        if not draining and tokens_seen > self.backend.migration_young_tokens:
            self.attempted = True  # matured past migratability
            return
        target = self._pick_target(force=draining)
        if target is None:
            return
        self.attempted = True
        try:
            async with await self.client.post(
                    f"http://{self.src}/migrate/export",
                    data=json.dumps({"request_id": rid}).encode(),
                    headers={"content-type": "application/json"},
                    timeout=Timeout(total=60)) as r:
                if r.status != 200:
                    # 409 = not now (finished or ineligible): the source
                    # keeps serving, nothing to splice
                    await r.read()
                    logger.info("migration export declined (%d)",
                                r.status)
                    return
                self.export = await r.json()
            self.target = target
            if self.decision is not None:
                self.decision["migrated_to"] = target
                self.decision["migration_trigger"] = {
                    "src_queued": int(getattr(
                        self.picker.state.get(self.src), "queued", 0)),
                    "tokens_seen": tokens_seen,
                    "drain": draining,
                }
            logger.info("migrating session %s: %s -> %s", rid, self.src,
                        target)
        except (ClientError, asyncio.TimeoutError, ValueError) as e:
            logger.warning("migration export failed: %s", e)

    async def retry_continuation(self) -> ClientResponse | None:
        """Resume from the exported state on a DIFFERENT sibling: the
        cut happened and the blob is in hand, so when the chosen target
        died or refused the import any other idle migration-capable
        replica can adopt the chain. The client's stream stays gap-free:
        the continuation starts at the cut, and no continuation byte was
        relayed before this retry. None when there is no other target
        (the caller ends the stream with the typed error event)."""
        if self.export is None or self.target is None:
            return None
        failed = self.target
        nxt = self._pick_target(force=True, exclude={failed})
        if nxt is None:
            return None
        self.target = nxt
        if self.decision is not None:
            self.decision.setdefault(
                "migration_retargeted_from", []).append(failed)
            self.decision["migrated_to"] = nxt
        logger.info("migration continuation retarget %s -> %s",
                    failed, nxt)
        return await self.start_continuation()

    async def start_continuation(self) -> ClientResponse | None:
        """Hand the blob to the target replica; the SSE response that
        continues the client's stream (the original response id), or
        None when the import failed."""
        if self.export is None or self.target is None:
            return None
        try:
            r = await self.client.post(
                f"http://{self.target}/migrate/import",
                data=json.dumps(self.export).encode(),
                headers={"content-type": "application/json"},
                timeout=Timeout(
                    total=self.backend.request_timeout,
                    sock_read=self.backend.stream_idle_timeout))
            if r.status != 200:
                body = await r.read()
                r.release()
                logger.warning("migration import failed (%d): %s",
                               r.status, body[:200])
                return None
            return r
        except (ClientError, asyncio.TimeoutError) as e:
            logger.warning("migration import failed: %s", e)
            return None


class _RetriableUpstreamError(Exception):
    def __init__(self, status: int, client_body: bytes, reason: str,
                 count_failure: bool = True):
        super().__init__(reason)
        self.status = status
        self.client_body = client_body
        #: whether the circuit breaker counts this as a backend failure
        #: (a quota refusal fails over without one: the backend is
        #: healthy)
        self.count_failure = count_failure


async def run_gateway(runtime: RuntimeConfig, host: str = "127.0.0.1",
                      port: int = 1975,
                      rng: random.Random | None = None,
                      tracer: Tracer | None = None,
                      reuse_port: bool = False,
                      cost_sink: CostSink | None = None) -> GatewayServer:
    """Start the gateway; the caller stops it (``await server.stop()``).
    ``server.port`` is the bound port (``port=0`` binds a free one);
    ``reuse_port`` binds it with ``SO_REUSEPORT``."""
    server = GatewayServer(runtime, rng=rng, tracer=tracer,
                           cost_sink=cost_sink)
    await server.start(host, port, reuse_port)
    logger.info("gateway listening on %s:%d", host, server.port)
    return server

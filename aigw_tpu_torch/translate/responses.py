"""OpenAI Responses API front → chat-completions backends (the port's
copy of ``aigw_tpu/translate/responses.py``).

OpenAI-schema backends get passthrough (passthrough.py); this module
makes the endpoint work against a chat-capable backend by mapping
Responses ⇄ chat completions and chaining the registered chat
translator for the backend's schema:

    Responses request ─→ chat request ─→ (chat translator for backend)
    backend response ─→ chat response ─→ Responses response

Streaming re-encodes chat chunks as ``response.output_text.delta`` /
``response.completed`` events (plus ``response.output_item.added`` /
``response.function_call_arguments.delta`` for tool calls).

Tool use: Responses flat function tools / ``function_call`` /
``function_call_output`` input items map onto chat ``tools`` /
assistant ``tool_calls`` / ``role:tool`` messages, and chat tool calls
map back to ``function_call`` output items.

Multi-turn state: OpenAI stores responses server-side and lets clients
chain turns with ``previous_response_id``. Chat-capable backends have
no such store, so the gateway keeps one — a bounded in-process LRU of
response id → chat transcript (``ResponseStore``). ``store: false``
opts out, matching the OpenAI contract. With ``AIGW_RESPONSES_DIR``
set the transcripts are files (``FileResponseStore``) in the
reference's on-disk format, so gateways of either package that share
the directory continue each other's conversations.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
import uuid
from typing import Any

from aigw_tpu_torch.config.model import APISchemaName
from aigw_tpu_torch.gateway.costs import TokenUsage
from aigw_tpu_torch.schemas import openai as oai
from aigw_tpu_torch.schemas.openai import NotFoundError, SchemaError
from aigw_tpu_torch.translate.base import (
    Endpoint,
    RequestTx,
    ResponseTx,
    Translator,
    get_translator,
    register_translator,
)
from aigw_tpu_torch.translate.sse import SSEEvent, SSEParser


class ResponseStore:
    """Bounded LRU of response id → chat transcript, enabling
    ``previous_response_id`` chaining against backends that keep no
    server-side state. Thread-safe; entries expire by recency (count
    bound) and age."""

    def __init__(self, max_entries: int = 4096, ttl_s: float = 3600.0):
        self._max = max_entries
        self._ttl = ttl_s
        self._lock = threading.Lock()
        self._d: "collections.OrderedDict[str, tuple[float, list]]" = (
            collections.OrderedDict()
        )

    def put(self, response_id: str,
            messages: list[dict[str, Any]]) -> None:
        now = time.monotonic()
        with self._lock:
            self._d[response_id] = (now, messages)
            self._d.move_to_end(response_id)
            while len(self._d) > self._max:
                self._d.popitem(last=False)

    def get(self, response_id: str) -> list[dict[str, Any]] | None:
        now = time.monotonic()
        with self._lock:
            entry = self._d.get(response_id)
            if entry is None:
                return None
            ts, messages = entry
            if now - ts > self._ttl:
                del self._d[response_id]
                return None
            self._d.move_to_end(response_id)
            return list(messages)

    def delete(self, response_id: str) -> None:
        """Roll back a transcript whose response the gateway rejected
        (malformed upstream body → 502; the id was never delivered)."""
        with self._lock:
            self._d.pop(response_id, None)


class FileResponseStore:
    """Transcript store shared across processes through one directory.

    A follow-up request carrying ``previous_response_id`` may land on
    another gateway process sharing the directory; a process-local dict
    would 404 it. One JSON file per response id, atomically replaced,
    GC'd by TTL and count.

    The id is client-supplied on lookup, so it is validated against a
    strict charset before ever touching the filesystem.
    """

    _GC_EVERY = 64

    def __init__(self, directory: str, max_entries: int = 4096,
                 ttl_s: float = 3600.0):
        self._dir = directory
        self._max = max_entries
        self._ttl = ttl_s
        self._puts = 0
        os.makedirs(directory, exist_ok=True)

    @staticmethod
    def _safe(response_id: str) -> str | None:
        if not response_id or len(response_id) > 128:
            return None
        if not all(c.isalnum() or c in "-_" for c in response_id):
            return None
        return response_id

    def _path(self, safe_id: str) -> str:
        return os.path.join(self._dir, f"{safe_id}.json")

    def put(self, response_id: str,
            messages: list[dict[str, Any]]) -> None:
        safe = self._safe(response_id)
        if safe is None:
            return
        path = self._path(safe)
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            json.dump(messages, f)
        os.replace(tmp, path)
        self._puts += 1
        if self._puts % self._GC_EVERY == 1:
            self._gc()

    def get(self, response_id: str) -> list[dict[str, Any]] | None:
        safe = self._safe(response_id)
        if safe is None:
            return None
        path = self._path(safe)
        try:
            if time.time() - os.stat(path).st_mtime > self._ttl:
                return None
            with open(path) as f:
                data = json.load(f)
        except (OSError, json.JSONDecodeError):
            return None
        return data if isinstance(data, list) else None

    def delete(self, response_id: str) -> None:
        safe = self._safe(response_id)
        if safe is None:
            return
        try:
            os.unlink(self._path(safe))
        except OSError:
            pass

    def _gc(self) -> None:
        try:
            entries = [
                (e.stat().st_mtime, e.path)
                for e in os.scandir(self._dir)
                if e.name.endswith(".json")
            ]
        except OSError:
            return
        now = time.time()
        entries.sort()
        doomed = [p for mt, p in entries if now - mt > self._ttl]
        overflow = len(entries) - len(doomed) - self._max
        if overflow > 0:
            doomed_set = set(doomed)
            doomed += [p for mt, p in entries
                       if p not in doomed_set][:overflow]
        for p in doomed:
            try:
                os.unlink(p)
            except OSError:
                pass


class _StoreRouter:
    """Lazily picks the store impl, so AIGW_RESPONSES_DIR is read at the
    first request, not at import."""

    def __init__(self) -> None:
        self._impl: Any = None

    def _resolve(self) -> Any:
        if self._impl is None:
            directory = os.environ.get("AIGW_RESPONSES_DIR")
            self._impl = (FileResponseStore(directory) if directory
                          else ResponseStore())
        return self._impl

    @property
    def blocking(self) -> bool:
        """True when backed by disk: callers on an event loop should
        thread-hop the translator calls that touch the store."""
        return isinstance(self._resolve(), FileResponseStore)

    def put(self, response_id: str,
            messages: list[dict[str, Any]]) -> None:
        self._resolve().put(response_id, messages)

    def get(self, response_id: str) -> list[dict[str, Any]] | None:
        return self._resolve().get(response_id)

    def delete(self, response_id: str) -> None:
        self._resolve().delete(response_id)


#: process-global store: in-memory by default, file-backed and shared
#: across gateway processes when AIGW_RESPONSES_DIR is set.
RESPONSE_STORE = _StoreRouter()


def _convert_tools(body: dict[str, Any],
                   out: dict[str, Any]) -> None:
    """Responses flat tools/tool_choice → chat nested form."""
    tools = body.get("tools")
    if tools:
        chat_tools = []
        for t in tools:
            if not isinstance(t, dict):
                raise SchemaError("tools entries must be objects")
            if t.get("type") != "function":
                raise SchemaError(
                    f"unsupported tool type {t.get('type')!r} "
                    f"(only function tools translate to chat backends)")
            fn = {"name": t.get("name", "")}
            for k in ("description", "parameters", "strict"):
                if t.get(k) is not None:
                    fn[k] = t[k]
            chat_tools.append({"type": "function", "function": fn})
        out["tools"] = chat_tools
    tc = body.get("tool_choice")
    if tc is not None:
        if isinstance(tc, dict) and tc.get("type") == "function":
            out["tool_choice"] = {
                "type": "function",
                "function": {"name": tc.get("name", "")},
            }
        else:
            out["tool_choice"] = tc
    if body.get("parallel_tool_calls") is not None:
        out["parallel_tool_calls"] = body["parallel_tool_calls"]


def _input_item_to_messages(item: dict[str, Any],
                            messages: list[dict[str, Any]]) -> None:
    itype = item.get("type", "message")
    if itype == "message":
        content = item.get("content")
        if isinstance(content, list):
            if not all(isinstance(p, dict) for p in content):
                raise SchemaError("content parts must be objects")
            text = "".join(
                p.get("text", "")
                for p in content
                if p.get("type") in ("input_text", "output_text", "text")
            )
        else:
            text = content or ""
        messages.append({"role": item.get("role", "user"),
                         "content": text})
    elif itype == "function_call":
        # assistant turn that called a tool (replayed by the client or
        # from the store). Consecutive function_call items merge into
        # ONE assistant message with multiple tool_calls — strict chat
        # backends reject interleaved assistant messages whose calls are
        # answered out of adjacency (parallel tool calls).
        call = {
            "id": item.get("call_id") or item.get("id", ""),
            "type": "function",
            "function": {
                "name": item.get("name", ""),
                "arguments": item.get("arguments", "") or "{}",
            },
        }
        last = messages[-1] if messages else None
        if (last is not None and last.get("role") == "assistant"
                and last.get("tool_calls")):
            last["tool_calls"].append(call)
        else:
            messages.append({
                "role": "assistant",
                "content": None,
                "tool_calls": [call],
            })
    elif itype == "function_call_output":
        output = item.get("output", "")
        if not isinstance(output, str):
            output = json.dumps(output)
        messages.append({
            "role": "tool",
            "tool_call_id": item.get("call_id", ""),
            "content": output,
        })
    else:
        raise SchemaError(f"unsupported input item type {itype!r}")


def responses_to_chat_request(
    body: dict[str, Any],
    store: ResponseStore | None = None,
) -> dict[str, Any]:
    """Responses request → chat completions request.

    ``previous_response_id`` resolves through ``store`` (the saved chat
    transcript is prepended); unknown ids raise NotFoundError → HTTP
    404 at the edge, mirroring OpenAI."""
    messages: list[dict[str, Any]] = []
    prev = body.get("previous_response_id")
    if prev:
        if store is None:
            raise SchemaError(
                "previous_response_id is not supported on this backend")
        stored = store.get(str(prev))
        if stored is None:
            raise NotFoundError(
                f"previous response {prev!r} not found")
        # instructions apply per request and are NOT inherited from the
        # previous turn (OpenAI semantics) — stored system messages are
        # dropped whether or not this request supplies new ones
        messages.extend(
            m for m in stored if m.get("role") != "system")
    if body.get("instructions"):
        messages.insert(
            0, {"role": "system", "content": body["instructions"]})
    raw = body.get("input")
    if isinstance(raw, str):
        messages.append({"role": "user", "content": raw})
    elif isinstance(raw, list):
        for item in raw:
            if not isinstance(item, dict):
                raise SchemaError("input items must be objects")
            _input_item_to_messages(item, messages)
    else:
        raise SchemaError("missing required field: input")
    out: dict[str, Any] = {"model": body["model"], "messages": messages}
    _convert_tools(body, out)
    if body.get("max_output_tokens") is not None:
        out["max_tokens"] = int(body["max_output_tokens"])
    for src, dst in (("temperature", "temperature"), ("top_p", "top_p")):
        if body.get(src) is not None:
            out[dst] = body[src]
    if body.get("stream"):
        out["stream"] = True
        out["stream_options"] = {"include_usage": True}
    return out


def chat_to_responses_response(
    chat: dict[str, Any], response_id: str, created: int
) -> dict[str, Any]:
    usage = oai.extract_usage(chat)
    choice = (chat.get("choices") or [{}])[0]
    msg = choice.get("message") or {}
    text = msg.get("content") or ""
    status = "completed"
    if choice.get("finish_reason") == "length":
        status = "incomplete"
    output: list[dict[str, Any]] = []
    if text:
        output.append({
            "type": "message",
            "id": f"msg_{uuid.uuid4().hex[:24]}",
            "role": "assistant",
            "status": "completed",
            "content": [
                {"type": "output_text", "text": text, "annotations": []}
            ],
        })
    for tc in msg.get("tool_calls") or ():
        fn = tc.get("function") or {}
        output.append({
            "type": "function_call",
            "id": f"fc_{uuid.uuid4().hex[:24]}",
            "call_id": tc.get("id", ""),
            "name": fn.get("name", ""),
            "arguments": fn.get("arguments", ""),
            "status": "completed",
        })
    if not output:
        # keep an (empty) message item so output is never bare
        output.append({
            "type": "message",
            "id": f"msg_{uuid.uuid4().hex[:24]}",
            "role": "assistant",
            "status": "completed",
            "content": [
                {"type": "output_text", "text": "", "annotations": []}
            ],
        })
    return {
        "id": response_id,
        "object": "response",
        "created_at": created,
        "status": status,
        "model": chat.get("model", ""),
        "output": output,
        "output_text": text,
        "usage": {
            "input_tokens": usage.input_tokens,
            "output_tokens": usage.output_tokens,
            "total_tokens": usage.total_tokens
            or usage.input_tokens + usage.output_tokens,
        },
    }


class ResponsesToChat(Translator):
    """Responses front ⇄ any chat-capable backend schema.

    Chains the registered chat translator for the backend, so one
    implementation covers every chat-capable backend schema.
    """

    def __init__(self, out_schema: APISchemaName, *,
                 model_name_override: str = "", stream: bool = False,
                 out_version: str = ""):
        self._out_schema = out_schema
        self._override = model_name_override
        self._out_version = out_version
        self._stream = stream
        self._inner: Translator | None = None
        self._id = f"resp_{uuid.uuid4().hex[:24]}"
        self._created = int(time.time())
        self._model = ""
        self._parser = SSEParser()
        self._text: list[str] = []
        self._usage = TokenUsage()
        self._started = False
        self._done = False
        self._finish = "stop"
        self._store_enabled = True
        self._chat_messages: list[dict[str, Any]] = []
        # streaming item tracking: output_index is the position in
        # _stream_items, assigned when an item first appears, and the
        # final response.completed output array is built in the SAME
        # order — so streamed indexes always match the final payload
        self._tool_calls: dict[int, dict[str, Any]] = {}
        self._stream_items: list[dict[str, Any]] = []
        self._msg_index: int | None = None
        self._tc_index: dict[int, int] = {}
        self._seq = 0

    def request(self, body: dict[str, Any]) -> RequestTx:
        oai.request_model(body)
        chat_req = responses_to_chat_request(body, RESPONSE_STORE)
        self._store_enabled = body.get("store", True) is not False
        self._chat_messages = list(chat_req["messages"])
        self._stream = bool(chat_req.get("stream", False))
        self._inner = get_translator(
            Endpoint.CHAT_COMPLETIONS,
            APISchemaName.OPENAI,
            self._out_schema,
            model_name_override=self._override,
            stream=self._stream,
            out_version=self._out_version,
        )
        tx = self._inner.request(chat_req)
        tx.stream = self._stream
        return tx

    def _save_turn(self, assistant_msg: dict[str, Any]) -> None:
        """Persist the transcript (incl. this assistant turn) so a
        follow-up can chain via previous_response_id."""
        if not self._store_enabled:
            return
        RESPONSE_STORE.put(
            self._id, self._chat_messages + [assistant_msg])

    def _event(self, etype: str, **fields: Any) -> bytes:
        self._seq += 1
        return SSEEvent(
            event=etype,
            data=json.dumps({"type": etype,
                             "sequence_number": self._seq, **fields}),
        ).encode()

    def response_headers(self, status: int, headers: dict[str, str]) -> None:
        if self._inner is not None:
            self._inner.response_headers(status, headers)

    def response_error(self, status: int, body: bytes) -> bytes:
        assert self._inner is not None
        return self._inner.response_error(status, body)

    def response_body(self, chunk: bytes, end_of_stream: bool) -> ResponseTx:
        assert self._inner is not None
        inner_rx = self._inner.response_body(chunk, end_of_stream)
        if not self._stream:
            if not end_of_stream:
                return ResponseTx()
            try:
                chat = json.loads(inner_rx.body or chunk)
            except json.JSONDecodeError:
                return inner_rx
            out = chat_to_responses_response(chat, self._id, self._created)
            msg = ((chat.get("choices") or [{}])[0].get("message")
                   or {"role": "assistant", "content": ""})
            self._save_turn(msg)
            return ResponseTx(
                body=json.dumps(out).encode(),
                usage=inner_rx.usage,
                model=inner_rx.model,
            )
        # streaming: inner produced OpenAI chat chunks; re-encode as
        # Responses events
        events = self._parser.feed(inner_rx.body)
        if end_of_stream:
            events += self._parser.flush()
        out = bytearray()
        if not self._started and (events or inner_rx.body):
            self._started = True
            out += self._event(
                "response.created",
                response={"id": self._id, "object": "response",
                          "status": "in_progress"},
            )
        for ev in events:
            if not ev.data or ev.data.strip() == "[DONE]":
                continue
            try:
                data = json.loads(ev.data)
            except json.JSONDecodeError:
                continue
            self._model = str(data.get("model", "") or "") or self._model
            if data.get("usage"):
                self._usage = self._usage.merge_override(
                    oai.extract_usage(data)
                )
            for choice in data.get("choices", ()):
                if choice.get("finish_reason"):
                    self._finish = choice["finish_reason"]
                delta_obj = choice.get("delta") or {}
                delta = delta_obj.get("content")
                if delta:
                    if self._msg_index is None:
                        self._msg_index = len(self._stream_items)
                        self._stream_items.append({"kind": "message"})
                        out += self._event(
                            "response.output_item.added",
                            output_index=self._msg_index,
                            item={"type": "message",
                                  "role": "assistant", "content": []},
                        )
                    self._text.append(delta)
                    out += self._event(
                        "response.output_text.delta",
                        output_index=self._msg_index, delta=delta)
                for tc in delta_obj.get("tool_calls") or ():
                    ti = int(tc.get("index", 0))
                    acc = self._tool_calls.setdefault(
                        ti, {"id": "", "name": "", "args": []})
                    if tc.get("id"):
                        acc["id"] = tc["id"]
                    fn = tc.get("function") or {}
                    if fn.get("name"):
                        acc["name"] = fn["name"]
                    if ti not in self._tc_index:
                        # open on FIRST sight (id, name, or arguments) —
                        # deltas must never precede output_item.added
                        idx = len(self._stream_items)
                        self._tc_index[ti] = idx
                        self._stream_items.append({"kind": "fc",
                                                   "ti": ti})
                        out += self._event(
                            "response.output_item.added",
                            output_index=idx,
                            item={"type": "function_call",
                                  "call_id": acc["id"],
                                  "name": acc["name"],
                                  "arguments": ""},
                        )
                    if fn.get("arguments"):
                        acc["args"].append(fn["arguments"])
                        out += self._event(
                            "response.function_call_arguments.delta",
                            output_index=self._tc_index[ti],
                            delta=fn["arguments"],
                        )
        if end_of_stream and not self._done:
            self._done = True
            text = "".join(self._text)
            if text:
                out += self._event("response.output_text.done",
                                   output_index=self._msg_index,
                                   text=text)
            for ti, idx in sorted(self._tc_index.items(),
                                  key=lambda kv: kv[1]):
                acc = self._tool_calls[ti]
                out += self._event(
                    "response.function_call_arguments.done",
                    output_index=idx,
                    arguments="".join(acc["args"]),
                )
            # final output in exactly the streamed item order
            output: list[dict[str, Any]] = []
            for item in self._stream_items:
                if item["kind"] == "message":
                    output.append({
                        "type": "message",
                        "id": f"msg_{uuid.uuid4().hex[:24]}",
                        "role": "assistant",
                        "status": "completed",
                        "content": [{"type": "output_text",
                                     "text": text,
                                     "annotations": []}],
                    })
                else:
                    acc = self._tool_calls[item["ti"]]
                    output.append({
                        "type": "function_call",
                        "id": f"fc_{uuid.uuid4().hex[:24]}",
                        "call_id": acc["id"],
                        "name": acc["name"],
                        "arguments": "".join(acc["args"]),
                        "status": "completed",
                    })
            if not output:
                output.append({
                    "type": "message",
                    "id": f"msg_{uuid.uuid4().hex[:24]}",
                    "role": "assistant",
                    "status": "completed",
                    "content": [{"type": "output_text", "text": "",
                                 "annotations": []}],
                })
            assistant_msg: dict[str, Any] = {
                "role": "assistant", "content": text or None}
            if self._tool_calls:
                assistant_msg["tool_calls"] = [
                    {"id": acc["id"], "type": "function",
                     "function": {"name": acc["name"],
                                  "arguments": "".join(acc["args"])}}
                    for acc in (self._tool_calls[i]
                                for i in sorted(self._tool_calls))
                ]
            final = {
                "id": self._id,
                "object": "response",
                "created_at": self._created,
                "status": ("incomplete" if self._finish == "length"
                           else "completed"),
                "model": self._model,
                "output": output,
                "output_text": text,
                "usage": {
                    "input_tokens": self._usage.input_tokens,
                    "output_tokens": self._usage.output_tokens,
                    "total_tokens": self._usage.total_tokens
                    or (self._usage.input_tokens
                        + self._usage.output_tokens),
                },
            }
            self._save_turn(assistant_msg)
            out += self._event("response.completed", response=final)
        return ResponseTx(
            body=bytes(out),
            usage=inner_rx.usage,
            model=inner_rx.model or self._model,
            tokens_emitted=inner_rx.tokens_emitted,
        )


def _install() -> None:
    for schema in (APISchemaName.ANTHROPIC, APISchemaName.AWS_BEDROCK,
                   APISchemaName.GCP_VERTEX_AI, APISchemaName.GCP_ANTHROPIC,
                   APISchemaName.AWS_ANTHROPIC, APISchemaName.TPUSERVE):
        def make(*, model_name_override: str = "", stream: bool = False,
                 out_version: str = "", _s: APISchemaName = schema):
            return ResponsesToChat(
                _s, model_name_override=model_name_override, stream=stream,
                out_version=out_version,
            )

        register_translator(Endpoint.RESPONSES, APISchemaName.OPENAI,
                            schema, make)


_install()

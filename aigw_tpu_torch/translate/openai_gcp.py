"""OpenAI chat/completions front → GCP Vertex AI Gemini backend.

Upstream pair: internal/translator openai→gcpvertexai (gemini_helper.go,
1042 LoC). Uses ``generateContent`` / ``streamGenerateContent?alt=sse``
under the project/location path; ``{GCP_PROJECT}``/``{GCP_REGION}``
placeholders are substituted by the GCP auth handler.

The port's copy of ``aigw_tpu/translate/openai_gcp.py``.
"""

from __future__ import annotations

import base64
import json
import time
import uuid
from typing import Any

from aigw_tpu_torch.config.model import APISchemaName
from aigw_tpu_torch.gateway.costs import TokenUsage
from aigw_tpu_torch.schemas import openai as oai
from aigw_tpu_torch.translate.base import (
    Endpoint,
    RequestTx,
    ResponseTx,
    TranslationError,
    Translator,
    register_translator,
)
from aigw_tpu_torch.translate import vendor_fields
from aigw_tpu_torch.translate.sse import SSEEvent, SSEParser
from aigw_tpu_torch.translate.structured import (
    JSONSchemaError,
    parse_response_format,
    to_gemini_schema,
)

_FINISH_TO_OPENAI = {
    "STOP": "stop",
    "MAX_TOKENS": "length",
    "SAFETY": "content_filter",
    "RECITATION": "content_filter",
    "PROHIBITED_CONTENT": "content_filter",
    "BLOCKLIST": "content_filter",
    "MALFORMED_FUNCTION_CALL": "tool_calls",
}


def gemini_logprobs_to_openai(result: dict[str, Any]) -> dict[str, Any] | None:
    """Gemini logprobsResult → OpenAI choice.logprobs
    (gemini_helper.go geminiLogprobsToOpenAILogprobs:991-1031)."""
    chosen = result.get("chosenCandidates") or []
    if not chosen:
        return None
    top = result.get("topCandidates") or []
    content = []
    for i, c in enumerate(chosen):
        top_lps = []
        if i < len(top) and isinstance(top[i], dict):
            for tc in top[i].get("candidates") or []:
                top_lps.append({
                    "token": tc.get("token", ""),
                    "logprob": float(tc.get("logProbability", 0.0) or 0.0),
                })
        content.append({
            "token": c.get("token", ""),
            "logprob": float(c.get("logProbability", 0.0) or 0.0),
            "top_logprobs": top_lps,
        })
    return {"content": content}


def gemini_usage(data: dict[str, Any]) -> TokenUsage:
    u = data.get("usageMetadata") or {}
    inp = int(u.get("promptTokenCount", 0) or 0)
    out = int(u.get("candidatesTokenCount", 0) or 0)
    return TokenUsage(
        input_tokens=inp,
        output_tokens=out,
        total_tokens=int(u.get("totalTokenCount", 0) or 0) or inp + out,
        cached_input_tokens=int(u.get("cachedContentTokenCount", 0) or 0),
        reasoning_tokens=int(u.get("thoughtsTokenCount", 0) or 0),
    )


def _user_parts(content: Any) -> list[dict[str, Any]]:
    """User content union → Gemini parts (text + inline/file images)."""
    if content is None:
        return []
    if isinstance(content, str):
        return [{"text": content}] if content else []
    parts: list[dict[str, Any]] = []
    for part in content:
        ptype = part.get("type")
        if ptype == "text":
            if part.get("text"):
                parts.append({"text": part["text"]})
        elif ptype == "image_url":
            url = (part.get("image_url") or {}).get("url", "")
            if url.startswith("data:"):
                media, _, b64 = url[len("data:") :].partition(";base64,")
                parts.append(
                    {"inlineData": {"mimeType": media or "image/png",
                                    "data": b64}}
                )
            else:
                parts.append(
                    {"fileData": {"mimeType": "image/png", "fileUri": url}}
                )
        else:
            raise TranslationError(f"unsupported content part {ptype!r}")
    return parts


#: Google's documented compatibility escape for clients that cannot echo
#: thought signatures (gemini_helper.go:36-39): Gemini 3.x rejects
#: multi-turn function calls with no thought_signature at all. REST wire
#: format carries signatures base64-encoded.
DUMMY_THOUGHT_SIGNATURE = base64.b64encode(
    b"skip_thought_signature_validator").decode()


def _gemini3_or_newer(model: str) -> bool:
    """True for gemini-3* model names — the version segment, not a bare
    substring ('gemini-2.5-pro-preview-03-25' contains a '3' but must
    not pass)."""
    import re

    return re.search(r"gemini-(\d+)", model.lower()) is not None and \
        int(re.search(r"gemini-(\d+)", model.lower()).group(1)) >= 3


def _reasoning_effort_to_thinking_level(effort: str, model: str) -> str:
    """OpenAI reasoning_effort → Gemini thinkingLevel, availability and
    mapping keyed on the model family (gemini_helper.go:595-636:
    Gemini-3-only; "none" and "high" are Flash-only; "medium" maps to
    HIGH on Pro)."""
    is_flash = "flash" in model.lower()
    if effort == "minimal":
        # documented OpenAI value; Flash has a native MINIMAL level,
        # Pro's floor is LOW (mirrors the Anthropic translator's
        # minimal→low downmapping)
        return "MINIMAL" if is_flash else "LOW"
    if effort == "none":
        if not is_flash:
            raise TranslationError(
                "reasoning effort 'none' is only supported for Gemini "
                "Flash models")
        return "MINIMAL"
    if effort == "low":
        return "LOW"
    if effort == "medium":
        return "MEDIUM" if is_flash else "HIGH"
    if effort == "high":
        if not is_flash:
            raise TranslationError(
                "reasoning effort 'high' is only supported for Gemini "
                "Flash models")
        return "HIGH"
    raise TranslationError(
        f"unsupported reasoning effort level: {effort!r} "
        "(supported: none, minimal, low, medium, high)")


def _assistant_thought_signature(m: dict[str, Any]) -> str:
    """First signature echoed back by the client — from thinking content
    parts or the thinking_blocks convention (gemini_helper.go:264-296).
    REST signatures are base64 strings and pass through verbatim."""
    content = m.get("content")
    if isinstance(content, list):
        for part in content:
            if isinstance(part, dict) and part.get("type") == "thinking" \
                    and part.get("signature"):
                return str(part["signature"])
    for block in m.get("thinking_blocks") or ():
        if isinstance(block, dict) and block.get("signature"):
            return str(block["signature"])
    return ""


def openai_messages_to_gemini(
    messages: list[dict[str, Any]],
) -> tuple[dict[str, Any] | None, list[dict[str, Any]]]:
    system_parts: list[dict[str, Any]] = []
    contents: list[dict[str, Any]] = []

    def push(role: str, parts: list[dict[str, Any]]) -> None:
        if not parts:
            return
        if contents and contents[-1]["role"] == role:
            contents[-1]["parts"].extend(parts)
        else:
            contents.append({"role": role, "parts": list(parts)})

    for m in messages:
        role = m.get("role")
        if role in ("system", "developer"):
            text = oai.message_content_text(m.get("content"))
            if text:
                system_parts.append({"text": text})
        elif role == "user":
            push("user", _user_parts(m.get("content")))
        elif role == "assistant":
            # part order mirrors the upstream gateway helper: functionCall
            # parts first, then text/thought parts
            # (gemini_helper.go:301-338 appends tool calls before
            # content) — the signature rule binds to the FIRST
            # functionCall, so the order is load-bearing
            parts: list[dict[str, Any]] = []
            signature = _assistant_thought_signature(m)
            tool_calls = m.get("tool_calls") or ()
            for idx, tc in enumerate(tool_calls):
                fn = tc.get("function") or {}
                try:
                    args = json.loads(fn.get("arguments") or "{}")
                except json.JSONDecodeError:
                    args = {}
                part = {"functionCall": {"name": fn.get("name", ""),
                                         "args": args}}
                # signature rides the FIRST functionCall only (parallel
                # calls carry one signature; gemini_helper.go:313-323);
                # no echoed signature → Google's compat escape
                if idx == 0 and not (
                        contents and contents[-1]["role"] == "model"
                        and any("functionCall" in p
                                for p in contents[-1]["parts"])):
                    # push() merges consecutive model turns; only the
                    # first functionCall of the MERGED content may carry
                    # a signature (Gemini rejects signatures on later
                    # parallel calls)
                    part["thoughtSignature"] = (
                        signature or DUMMY_THOUGHT_SIGNATURE)
                parts.append(part)
            content = m.get("content")
            if isinstance(content, list):
                for cp in content:
                    if not isinstance(cp, dict):
                        continue
                    if cp.get("type") == "text" and cp.get("text"):
                        parts.append({"text": cp["text"]})
                    elif cp.get("type") == "thinking":
                        t = cp.get("text") or cp.get("thinking")
                        if t:
                            thought = {"text": t, "thought": True}
                            if not tool_calls and cp.get("signature"):
                                thought["thoughtSignature"] = \
                                    cp["signature"]
                            parts.append(thought)
                    # refusal/redacted parts have no Gemini shape: skip
            else:
                text = oai.message_content_text(content)
                if text:
                    parts.append({"text": text})
            push("model", parts)
        elif role == "tool":
            content = oai.message_content_text(m.get("content"))
            try:
                response: Any = json.loads(content)
            except json.JSONDecodeError:
                response = {"result": content}
            if not isinstance(response, dict):
                response = {"result": response}
            push(
                "user",
                [
                    {
                        "functionResponse": {
                            "name": m.get("name", "") or m.get("tool_call_id", ""),
                            "response": response,
                        }
                    }
                ],
            )
        else:
            raise TranslationError(f"unsupported message role {role!r}")
    system = {"parts": system_parts} if system_parts else None
    return system, contents


class OpenAIToGeminiChat(Translator):
    def __init__(self, *, model_name_override: str = "", stream: bool = False,
                 **_: object):
        self._override = model_name_override
        self._stream = stream
        self._include_usage = False
        self._parser = SSEParser()
        self._id = f"chatcmpl-{uuid.uuid4().hex[:24]}"
        self._created = int(time.time())
        self._model = ""
        self._usage = TokenUsage()
        self._tool_idx = -1
        self._finish: str | None = None
        self._sent_role = False
        self._sent_done = False
        self._want_logprobs = False
        self._thought_text = ""
        self._thought_signature = ""

    def request(self, body: dict[str, Any]) -> RequestTx:
        oai.validate_gateway_chat_request(body)
        self._stream = bool(body.get("stream", False))
        self._include_usage = oai.include_stream_usage(body)
        self._model = self._override or body["model"]
        system, contents = openai_messages_to_gemini(body["messages"])
        out: dict[str, Any] = {"contents": contents}
        if system:
            out["systemInstruction"] = system
        gen: dict[str, Any] = {}
        max_tokens = body.get("max_completion_tokens") or body.get("max_tokens")
        if max_tokens:
            gen["maxOutputTokens"] = int(max_tokens)
        if body.get("temperature") is not None:
            gen["temperature"] = float(body["temperature"])
        if body.get("top_p") is not None:
            gen["topP"] = float(body["top_p"])
        stop = body.get("stop")
        if stop:
            gen["stopSequences"] = [stop] if isinstance(stop, str) else list(stop)
        n = int(body.get("n") or 1)
        if n > 1:
            if self._stream:
                raise TranslationError(
                    "n>1 is not supported for streaming Gemini requests"
                )
            gen["candidateCount"] = n
        if body.get("seed") is not None:
            gen["seed"] = int(body["seed"])
        if body.get("presence_penalty") is not None:
            gen["presencePenalty"] = float(body["presence_penalty"])
        if body.get("frequency_penalty") is not None:
            gen["frequencyPenalty"] = float(body["frequency_penalty"])
        # logprobs (gemini_helper.go:657-665): top_logprobs → logprobs
        # count, logprobs flag → responseLogprobs
        if body.get("top_logprobs") is not None:
            gen["logprobs"] = int(body["top_logprobs"])
        if body.get("logprobs") is not None:
            gen["responseLogprobs"] = bool(body["logprobs"])
        self._want_logprobs = bool(body.get("logprobs"))
        effort = body.get("reasoning_effort")
        if effort and _gemini3_or_newer(self._model):
            # Gemini 3.0+ only; older models silently ignore the knob
            # like the upstream gateway's availability gate
            # (gemini_helper.go:595-599, :728-736)
            gen["thinkingConfig"] = {
                "thinkingLevel": _reasoning_effort_to_thinking_level(
                    str(effort), self._model)}
        self._apply_output_format(body, gen)
        # proposal-004 vendor fields: thinking → thinkingConfig, vendor
        # generationConfig/safetySettings override translated fields
        # (openai_gcpvertexai.go:498-594)
        vendor_fields.apply_gcp_chat_vendor(body, out, gen)
        if gen:
            out["generationConfig"] = gen
        tools = body.get("tools")
        if tools:
            # function declarations + Gemini built-in tools
            # (gemini_helper.go:440-497: google_search with
            # exclude_domains/blocking_confidence/time_range_filter,
            # enterprise_search; image_generation unsupported)
            fn_decls = []
            gemini_tools: list[dict[str, Any]] = []
            for t in tools:
                ttype = t.get("type")
                if ttype == "function":
                    fn = t.get("function") or {}
                    fn_decls.append({
                        "name": fn.get("name", ""),
                        "description": fn.get("description", ""),
                        "parameters": fn.get("parameters",
                                             {"type": "object"}),
                    })
                elif ttype == "google_search":
                    gs_cfg = t.get("google_search") or {}
                    gs: dict[str, Any] = {}
                    if gs_cfg.get("exclude_domains"):
                        gs["excludeDomains"] = list(
                            gs_cfg["exclude_domains"])
                    if gs_cfg.get("blocking_confidence"):
                        gs["blockingConfidence"] = \
                            gs_cfg["blocking_confidence"]
                    trf = gs_cfg.get("time_range_filter")
                    if isinstance(trf, dict):
                        f: dict[str, Any] = {}
                        if trf.get("start_time"):
                            f["startTime"] = trf["start_time"]
                        if trf.get("end_time"):
                            f["endTime"] = trf["end_time"]
                        if f:
                            gs["timeRangeFilter"] = f
                    gemini_tools.append({"googleSearch": gs})
                elif ttype == "enterprise_search":
                    gemini_tools.append({"enterpriseWebSearch": {}})
                elif ttype == "image_generation":
                    raise TranslationError(
                        "tool-type image generation not supported yet")
            if fn_decls:
                gemini_tools.append(
                    {"functionDeclarations": fn_decls})
            if gemini_tools:
                out["tools"] = gemini_tools
        choice = body.get("tool_choice")
        if choice == "none":
            out["toolConfig"] = {"functionCallingConfig": {"mode": "NONE"}}
        elif choice == "required":
            out["toolConfig"] = {"functionCallingConfig": {"mode": "ANY"}}
        elif isinstance(choice, dict) and choice.get("type") == "function":
            out["toolConfig"] = {
                "functionCallingConfig": {
                    "mode": "ANY",
                    "allowedFunctionNames": [
                        (choice.get("function") or {}).get("name", "")
                    ],
                }
            }
        verb = "streamGenerateContent?alt=sse" if self._stream else "generateContent"
        path = (
            "/v1/projects/{GCP_PROJECT}/locations/{GCP_REGION}"
            f"/publishers/google/models/{self._model}:{verb}"
        )
        return RequestTx(
            body=json.dumps(out).encode(), path=path, stream=self._stream
        )

    def _apply_output_format(self, body: dict[str, Any],
                             gen: dict[str, Any]) -> None:
        """response_format + guided_{choice,regex,json} → Gemini response
        MIME type / schema (gemini_helper.go:667-744). The vLLM-style
        guided_* vendor fields and response_format are mutually
        exclusive."""
        specified = 0
        rf = parse_response_format(body)
        if rf is not None:
            specified += 1
            if rf.kind == "text":
                gen["responseMimeType"] = "text/plain"
            elif rf.kind == "json_object":
                gen["responseMimeType"] = "application/json"
            elif rf.kind == "json_schema" and rf.schema is not None:
                gen["responseMimeType"] = "application/json"
                try:
                    gen["responseSchema"] = to_gemini_schema(rf.schema)
                except JSONSchemaError as e:
                    raise TranslationError(
                        f"invalid JSON schema: {e}") from None
        if body.get("guided_choice") is not None:
            specified += 1
            gen["responseMimeType"] = "text/x.enum"
            gen["responseSchema"] = {"type": "STRING",
                                     "enum": list(body["guided_choice"])}
        if body.get("guided_regex"):
            specified += 1
            gen["responseMimeType"] = "application/json"
            gen["responseSchema"] = {"type": "STRING",
                                     "pattern": str(body["guided_regex"])}
        if body.get("guided_json") is not None:
            specified += 1
            gen["responseMimeType"] = "application/json"
            gen["responseJsonSchema"] = body["guided_json"]
        if specified > 1:
            raise TranslationError(
                "only one of response_format, guided_choice, guided_regex, "
                "guided_json can be specified")

    def response_body(self, chunk: bytes, end_of_stream: bool) -> ResponseTx:
        if self._stream:
            return self._stream_chunk(chunk, end_of_stream)
        if not end_of_stream:
            return ResponseTx()
        try:
            data = json.loads(chunk)
        except json.JSONDecodeError as e:
            raise TranslationError(f"invalid upstream JSON: {e}") from None
        usage = gemini_usage(data)
        model = str(data.get("modelVersion", "") or self._model)
        choices = []
        for i, cand in enumerate(data.get("candidates") or [{}]):
            parts = (cand.get("content") or {}).get("parts") or []
            # thought=true parts are the model's reasoning, NOT content
            # (gemini_helper.go:790-820: thought summary →
            # reasoning_content; signatures → thinking_blocks so the
            # next turn can echo them)
            text = "".join(p.get("text", "") for p in parts
                           if "text" in p and not p.get("thought"))
            thought = "".join(p.get("text", "") for p in parts
                              if "text" in p and p.get("thought"))
            signature = ""
            for p in parts:
                if p.get("thoughtSignature"):
                    signature = str(p["thoughtSignature"])
                    break
            tool_calls = [
                {
                    "id": f"call_{uuid.uuid4().hex[:16]}",
                    "type": "function",
                    "function": {
                        "name": p["functionCall"].get("name", ""),
                        "arguments": json.dumps(p["functionCall"].get("args", {})),
                    },
                }
                for p in parts
                if "functionCall" in p
            ]
            finish = _FINISH_TO_OPENAI.get(
                cand.get("finishReason") or "STOP", "stop"
            )
            if tool_calls:
                finish = "tool_calls"
            message: dict[str, Any] = {"role": "assistant", "content": text}
            if tool_calls:
                message["tool_calls"] = tool_calls
                if not text:
                    message["content"] = None
            if thought:
                message["reasoning_content"] = thought
            if thought or signature:
                message["thinking_blocks"] = [{
                    "type": "thinking", "thinking": thought,
                    "signature": signature}]
            choice: dict[str, Any] = {
                "index": i, "message": message, "finish_reason": finish
            }
            if self._want_logprobs:
                lp = gemini_logprobs_to_openai(
                    cand.get("logprobsResult") or {})
                if lp is not None:
                    choice["logprobs"] = lp
            choices.append(choice)
        out = {
            "id": self._id,
            "object": "chat.completion",
            "created": self._created,
            "model": model,
            "choices": choices,
            "usage": oai.usage_dict(usage),
        }
        return ResponseTx(
            body=json.dumps(out).encode(), usage=usage, model=model
        )

    def _stream_chunk(self, chunk: bytes, end_of_stream: bool) -> ResponseTx:
        events = self._parser.feed(chunk)
        if end_of_stream:
            events += self._parser.flush()
        out = bytearray()
        usage = TokenUsage()
        tokens = 0
        for ev in events:
            if not ev.data:
                continue
            try:
                data = json.loads(ev.data)
            except json.JSONDecodeError:
                continue
            self._usage = self._usage.merge_override(gemini_usage(data))
            if not self._sent_role:
                self._sent_role = True
                out += self._emit({"role": "assistant", "content": ""})
            for cand in data.get("candidates") or ():
                chunk_lp = None
                if self._want_logprobs:
                    chunk_lp = gemini_logprobs_to_openai(
                        cand.get("logprobsResult") or {})
                for p in (cand.get("content") or {}).get("parts") or ():
                    if p.get("thoughtSignature") and \
                            not self._thought_signature:
                        # FIRST signature wins, matching the unary path
                        self._thought_signature = \
                            str(p["thoughtSignature"])
                    if p.get("text") and p.get("thought"):
                        tokens += 1
                        self._thought_text += p["text"]
                        out += self._emit(
                            {"reasoning_content": p["text"]})
                    elif p.get("text"):
                        tokens += 1
                        out += self._emit({"content": p["text"]},
                                          logprobs=chunk_lp)
                        chunk_lp = None  # attach once per upstream chunk
                    elif "functionCall" in p:
                        self._tool_idx += 1
                        fc = p["functionCall"]
                        out += self._emit(
                            {
                                "tool_calls": [
                                    {
                                        "index": self._tool_idx,
                                        "id": f"call_{uuid.uuid4().hex[:16]}",
                                        "type": "function",
                                        "function": {
                                            "name": fc.get("name", ""),
                                            "arguments": json.dumps(
                                                fc.get("args", {})
                                            ),
                                        },
                                    }
                                ]
                            }
                        )
                        self._finish = "tool_calls"
                if cand.get("finishReason"):
                    self._finish = self._finish or _FINISH_TO_OPENAI.get(
                        cand["finishReason"], "stop"
                    )
        if end_of_stream and not self._sent_done:
            self._sent_done = True
            if self._thought_text or self._thought_signature:
                # the completed thinking block (with its signature) in
                # one delta so streamed turns replay like unary ones
                out += self._emit({"thinking_blocks": [{
                    "type": "thinking",
                    "thinking": self._thought_text,
                    "signature": self._thought_signature}]})
            usage = usage.merge_override(self._usage)
            out += SSEEvent(
                data=json.dumps(
                    oai.chat_completion_chunk(
                        response_id=self._id,
                        model=self._model,
                        delta={},
                        finish_reason=self._finish or "stop",
                        usage=self._usage if self._include_usage else None,
                        created=self._created,
                    )
                )
            ).encode()
            out += SSEEvent(data="[DONE]").encode()
        return ResponseTx(
            body=bytes(out), usage=usage, model=self._model, tokens_emitted=tokens
        )

    def _emit(self, delta: dict[str, Any],
              logprobs: dict[str, Any] | None = None) -> bytes:
        return oai.stream_chunk_sse(
            response_id=self._id, model=self._model, created=self._created,
            delta=delta, logprobs=logprobs,
        )


register_translator(
    Endpoint.CHAT_COMPLETIONS,
    APISchemaName.OPENAI,
    APISchemaName.GCP_VERTEX_AI,
    OpenAIToGeminiChat,
)

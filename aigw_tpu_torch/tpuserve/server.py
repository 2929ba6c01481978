"""OpenAI-surface replica server on the standard library (counterpart of
``aigw_tpu/tpuserve/server.py``).

Routes: ``POST /v1/chat/completions`` and ``POST /v1/completions``
(streamed over SSE and not, in the reference server's response shapes),
``POST /tokenize``, ``GET /v1/models``, ``GET /health`` and ``GET
/state`` (the reference's keys that this engine has, under the same
names, ``phase_percentiles`` among them). A gateway in front routes to
it like to a reference replica, and prices its TTFT from
``phase_percentiles`` as a reference replica's.

The server is ``http.server.ThreadingHTTPServer``: one thread per
connection, each waiting on its request's token queue, which the engine
thread fills. Embeddings, batches, migration, KV pages, debug and
profile routes wait for later slices (ROADMAP queue 1).
"""

from __future__ import annotations

import json
import logging
import queue
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any

import torch

from aigw_tpu_torch.device import device_name, resolve_device
from aigw_tpu_torch.models.quant import quantize_params
from aigw_tpu_torch.models.registry import family_fns, get_model_spec
from aigw_tpu_torch.schemas import openai as oai
from aigw_tpu_torch.tpuserve.engine import (
    DEFAULTS_DIFFER,
    Engine,
    EngineConfig,
    EngineOverloadedError,
    GenRequest,
)
from aigw_tpu_torch.tpuserve.sampling import SamplingParams
from aigw_tpu_torch.tpuserve.tokenizer import (
    StreamingDecoder,
    apply_chat_template,
    load_tokenizer,
)

logger = logging.getLogger(__name__)

_PARAM_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _find_stop(text: str, stop_strs: list[str]) -> int | None:
    """Earliest index where a stop sequence begins, or None."""
    hits = [i for i in (text.find(s) for s in stop_strs if s) if i >= 0]
    return min(hits) if hits else None


class TPUServeServer:
    """One model replica: engine + HTTP front end."""

    def __init__(self, model: str, engine_cfg: EngineConfig,
                 device: str | torch.device = "cuda",
                 host: str = "127.0.0.1", port: int = 8011,
                 param_dtype: str = "bfloat16", quantize: str = ""):
        self.device = resolve_device(device)
        self.model_name = model
        spec = get_model_spec(model)
        self.fns = family_fns(spec.family)
        self.model_cfg = spec.config
        self.tokenizer = load_tokenizer(spec.tokenizer)
        self.chat_template = spec.chat_template
        if spec.weights != "random":
            raise NotImplementedError(
                f"weights {spec.weights!r}: checkpoint loading is not "
                "ported yet (ROADMAP queue 1: weight quantization and "
                "checkpoints); register a weights='random' spec")
        logger.info("initializing random %s weights for %s on %s",
                    param_dtype, spec.name, self.device)
        if quantize not in ("", "int8", "int4"):
            raise ValueError(f"unknown quantization {quantize!r}")
        params = self.fns.init_params(0, self.model_cfg,
                                      _PARAM_DTYPES[param_dtype],
                                      self.device)
        if quantize:
            # on the device, one matrix at a time (consume=True)
            params = quantize_params(params, consume=True, mode=quantize)
            logger.info("weights quantized to %s (W%sA16)", quantize,
                        quantize[-1])
        self.engine = Engine(params, self.model_cfg, engine_cfg,
                             eos_token_ids=(self.tokenizer.eos_id,),
                             fns=self.fns, device=self.device)
        self._started_at = time.time()
        self.replica_id = uuid.uuid4().hex[:16]
        self.httpd = ThreadingHTTPServer((host, port), _make_handler(self))
        self.httpd.daemon_threads = True
        self._http_thread: threading.Thread | None = None

    @property
    def port(self) -> int:
        return self.httpd.server_address[1]

    def start(self) -> None:
        """Build the kernels, start the engine, then accept requests."""
        self.engine.warmup()
        self.engine.start()
        self._http_thread = threading.Thread(
            target=self.httpd.serve_forever, name="tpuserve-http",
            daemon=True)
        self._http_thread.start()
        logger.info("tpuserve listening on %s:%d (%s)",
                    *self.httpd.server_address[:2],
                    device_name(self.device))

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._http_thread is not None:
            self._http_thread.join(timeout=10)
        self.engine.stop()

    # -- endpoints --------------------------------------------------------
    def models(self) -> dict[str, Any]:
        return oai.models_response([(self.model_name, "tpuserve", 0)])

    def health(self) -> tuple[int, dict[str, Any]]:
        if not self.engine.healthy:
            return 503, {"status": "error", "model": self.model_name,
                         "error": self.engine.last_error}
        return 200, {"status": "ok", "model": self.model_name}

    def state(self) -> dict[str, Any]:
        """Endpoint-picker telemetry under the reference's /state keys."""
        eng = self.engine
        s = eng.stats
        cfg = eng.cfg
        return {
            "model": self.model_name,
            "replica_id": self.replica_id,
            "started_at": round(self._started_at, 3),
            "uptime_s": round(time.time() - self._started_at, 3),
            "draining": False,
            "device": device_name(self.device),
            "device_count": 1,
            "active_slots": s.active_slots,
            "max_slots": cfg.max_batch_size,
            "queued": s.queued,
            "queue_wait_ms": round(s.queue_wait_ms, 3),
            "kv_pages_free": s.kv_pages_free,
            "kv_occupancy": s.kv_occupancy,
            "kv_pool_bytes": s.kv_pool_bytes,
            "kv_bytes_in_use": s.kv_bytes_in_use,
            "kv_quant_bits": s.kv_quant_bits,
            "kv_bytes_per_token": s.kv_bytes_per_token,
            "kv_cache_dtype": cfg.kv_cache_dtype,
            "device_bytes_in_use": s.device_bytes_in_use,
            "device_bytes_limit": s.device_bytes_limit,
            "device_memory_frac": s.device_memory_frac,
            "max_seq_len": cfg.max_seq_len,
            "tokens_generated": s.tokens_generated,
            "decode_steps": s.decode_steps,
            "decode_window": s.decode_window,
            "window_shrinks": s.window_shrinks,
            "window_grows": s.window_grows,
            "state_rebuilds": s.state_rebuilds,
            "prefills": s.prefills,
            "chunked_prefill_steps": s.chunked_prefill_steps,
            "prefill_ms": round(s.prefill_ms, 3),
            "prefill_ms_per_token": round(s.prefill_ms_per_token(), 4),
            "transfer_ms": round(s.transfer_ms, 3),
            "emit_ms": round(s.emit_ms, 3),
            "first_emit_ms": round(s.first_emit_ms, 3),
            "warmup_ms": s.warmup_ms,
            "attention_backend": eng.attn.name,
            "attention_backend_reason": eng.attn_reason,
            "prefill_tokens_real": s.prefill_tokens_real,
            "prefill_tokens_padded": s.prefill_tokens_padded,
            "prefill_padded_frac": s.prefill_padded_frac,
            "decode_backend": cfg.decode_backend,
            "decode_attn_impl": eng.decode_attn_impl,
            "decode_attn_reason": eng.decode_attn_reason,
            # prefix cache: the picker's prefix-affinity scoring and
            # capacity dashboards read these
            "prefix_cache_hit_rate": round(s.prefix_cache_hit_rate, 4),
            "prefix_pages_resident": s.prefix_pages_resident,
            "prefix_pages_pinned": s.prefix_pages_pinned,
            "prefix_bytes_pinned": s.prefix_pages_pinned * eng.kv_page_bytes,
            "prefix_cache_hits": s.prefix_cache_hits,
            "prefix_cache_misses": s.prefix_cache_misses,
            "prefix_cache_evictions": s.prefix_cache_evictions,
            "prefix_full_hits": s.prefix_full_hits,
            "prefix_cow_copies": s.prefix_cow_copies,
            "prefix_tokens_reused": s.prefix_tokens_reused,
            # speculative decoding: acceptance telemetry
            "spec_accepted": s.spec_accepted,
            "spec_drafted": s.spec_drafted,
            "spec_accept_rate": round(s.spec_accept_rate, 4),
            "spec_draft_len": s.spec_draft_len,
            "spec_rung_ups": s.spec_rung_ups,
            "spec_rung_downs": s.spec_rung_downs,
            "spec_lookahead_slots": s.spec_lookahead_slots,
            "constrained_decoding": cfg.constrained_decoding,
            "enable_prefix_cache": cfg.enable_prefix_cache,
            "defaults_differ": dict(DEFAULTS_DIFFER),
            "migration": False,
            # serving-phase latency distributions (p50/p95/p99 per
            # phase; -1 = no observations yet): the picker's TTFT
            # prediction reads the prefill and ttft p50
            "phase_percentiles": eng.phases.percentiles(),
        }

    def tokenize(self, body: dict[str, Any]) -> dict[str, Any]:
        """The reference's ``/tokenize``: chat ``messages`` through the
        chat template, else ``prompt`` as text (no BOS), with the
        replica's context limit."""
        if isinstance(body.get("messages"), list):
            ids = apply_chat_template(body["messages"], self.tokenizer,
                                      self.chat_template)
        else:
            ids = self.tokenizer.encode(str(body.get("prompt", "")))
        return {"count": len(ids),
                "max_model_len": self.engine.cfg.max_seq_len,
                "tokens": ids}

    # -- generation -------------------------------------------------------
    def encode_chat(self, body: dict[str, Any]) -> list[int]:
        oai.validate_chat_request(body)
        return apply_chat_template(body["messages"], self.tokenizer,
                                   self.chat_template)

    def encode_text(self, body: dict[str, Any]) -> list[int]:
        oai.request_model(body)
        text = body.get("prompt", "")
        if isinstance(text, list):
            text = "".join(text)
        return [self.tokenizer.bos_id] + self.tokenizer.encode(str(text))

    def check_unsupported(self, body: dict[str, Any]) -> None:
        """400 for what this replica does not serve, as the reference
        does with the matching knob off."""
        rf = body.get("response_format")
        if (isinstance(rf, dict) and rf.get("type") not in (None, "text")) \
                or (body.get("tools") and body.get("tool_choice") != "none"):
            raise oai.SchemaError(
                "this server was started with --no-constrained-decoding; "
                "response_format json modes and tool calling are "
                "unavailable")
        if body.get("logprobs") or body.get("top_logprobs") is not None:
            raise oai.SchemaError(
                "per-token logprobs are not available on this replica")
        if int(body.get("n") or 1) > 1:
            raise oai.SchemaError("n > 1 is not supported on this server")

    def submit(self, prompt: list[int], body: dict[str, Any]):
        """Submit to the engine; returns (token queue, request). The queue
        yields (token_id, finish_reason) pairs."""
        out: "queue.Queue[tuple[int, str | None]]" = queue.Queue()
        max_tokens = int(body.get("max_completion_tokens")
                         or body.get("max_tokens") or 256)
        req = GenRequest(prompt=prompt, max_tokens=max_tokens,
                         sampling=SamplingParams.from_request(body),
                         emit=lambda t, f: out.put((t, f)))
        self.engine.submit(req)
        return out, req

    def collect(self, out: queue.Queue, stop_strs: list[str]
                ) -> tuple[str, int, str]:
        """Drain a generation to completion (non-streaming path)."""
        decoder = StreamingDecoder(self.tokenizer)
        text = ""
        n_out = 0
        while True:
            tok, fin = out.get()
            if tok >= 0:
                n_out += 1
                text += decoder.push(tok)
                hit = _find_stop(text, stop_strs)
                if hit is not None:
                    return text[:hit], n_out, "stop"
            if fin is not None:
                if fin != "error":
                    text += decoder.flush()
                return text, n_out, fin


def _make_handler(server: TPUServeServer):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        srv = server

        def log_message(self, fmt, *args):  # route to logging, not stderr
            logger.debug("%s " + fmt, self.address_string(), *args)

        def _send(self, status: int, body: bytes,
                  ctype: str = "application/json",
                  headers: dict[str, str] | None = None) -> None:
            self.send_response(status)
            self.send_header("content-type", ctype)
            self.send_header("content-length", str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _json(self, status: int, obj: Any, headers=None) -> None:
            self._send(status, json.dumps(obj).encode(), headers=headers)

        def _error(self, status: int, msg: str,
                   type_: str = "invalid_request_error", headers=None):
            self._send(status, oai.error_body(msg, type_), headers=headers)

        def do_GET(self):  # noqa: N802 (http.server naming)
            path = self.path.split("?", 1)[0]
            if path == "/v1/models":
                self._json(200, self.srv.models())
            elif path == "/health":
                self._json(*self.srv.health())
            elif path == "/state":
                self._json(200, self.srv.state())
            else:
                self._error(404, f"no route {path}", "not_found")

        def do_POST(self):  # noqa: N802
            path = self.path.split("?", 1)[0]
            chat = path == "/v1/chat/completions"
            if not chat and path not in ("/v1/completions", "/tokenize"):
                self._error(404, f"no route {path}", "not_found")
                return
            length = int(self.headers.get("content-length") or 0)
            try:
                body = oai.parse_json_body(self.rfile.read(length))
                if path == "/tokenize":
                    self._json(200, self.srv.tokenize(body))
                    return
                prompt = (self.srv.encode_chat(body) if chat
                          else self.srv.encode_text(body))
                self.srv.check_unsupported(body)
            except oai.SchemaError as e:
                self._error(400, str(e))
                return
            self._generate(body, prompt, chat)

        def _generate(self, body, prompt, chat):
            srv = self.srv
            stream = bool(body.get("stream", False))
            rid = (f"chatcmpl-{uuid.uuid4().hex[:24]}" if chat
                   else f"cmpl-{uuid.uuid4().hex[:24]}")
            created = int(time.time())
            stops = body.get("stop")
            stop_strs = [stops] if isinstance(stops, str) \
                else list(stops or [])
            try:
                out, req = srv.submit(prompt, body)
            except EngineOverloadedError as e:
                self._error(429, str(e), "rate_limit_error",
                            headers={"retry-after": "1"})
                return
            except ValueError as e:
                self._error(400, str(e))
                return
            n_prompt = len(prompt)
            if not stream:
                text, n_out, finish = srv.collect(out, stop_strs)
                # a stop-string hit ends generation (a no-op once the
                # engine has finished the request itself)
                req.cancelled.set()
                if finish == "error":
                    self._error(500, "engine failure", "server_error")
                    return
                usage = oai.TokenUsage(n_prompt, n_out, n_prompt + n_out,
                                       req.prefix_reused)
                if chat:
                    resp = oai.chat_completion_response(
                        model=srv.model_name, content=text,
                        finish_reason=finish, usage=usage, response_id=rid)
                else:
                    resp = oai.completion_response(
                        model=srv.model_name, text=text,
                        finish_reason=finish, usage=usage,
                        response_id=rid, created=created)
                self._json(200, resp, headers={"x-aigw-request-id": rid})
                return
            try:
                self._stream(out, req, chat, rid, created, stop_strs,
                             n_prompt, oai.include_stream_usage(body))
            except (BrokenPipeError, ConnectionResetError):
                req.cancelled.set()  # client went away: free the slot
                self.close_connection = True

        def _stream(self, out, req, chat, rid, created, stop_strs,
                    n_prompt, include_usage):
            srv = self.srv
            self.send_response(200)
            self.send_header("content-type", "text/event-stream")
            self.send_header("cache-control", "no-cache")
            self.send_header("x-aigw-request-id", rid)
            self.send_header("connection", "close")
            self.end_headers()
            self.close_connection = True

            def write_piece(piece: str) -> None:
                if not piece:
                    return
                if chat:
                    frame = oai.stream_chunk_sse(
                        response_id=rid, model=srv.model_name,
                        created=created, delta={"content": piece})
                else:
                    frame = oai.completion_chunk_sse(
                        response_id=rid, model=srv.model_name,
                        created=created, text=piece)
                self.wfile.write(frame)
                self.wfile.flush()

            if chat:
                self.wfile.write(oai.stream_chunk_sse(
                    response_id=rid, model=srv.model_name, created=created,
                    delta={"role": "assistant", "content": ""}))
                self.wfile.flush()
            decoder = StreamingDecoder(srv.tokenizer)
            emitted = ""
            n_out = 0
            finish = "stop"
            done = False
            while not done:
                burst = [out.get()]
                while True:  # one frame per burst of tokens
                    try:
                        burst.append(out.get_nowait())
                    except queue.Empty:
                        break
                pieces = []
                for tok, fin in burst:
                    if tok >= 0:
                        n_out += 1
                        piece = decoder.push(tok)
                        if piece:
                            emitted += piece
                            hit = _find_stop(emitted, stop_strs)
                            if hit is not None:
                                keep = hit - (len(emitted) - len(piece))
                                pieces.append(piece[:max(keep, 0)])
                                finish = "stop"
                                req.cancelled.set()
                                done = True
                                break
                            pieces.append(piece)
                    if fin is not None:
                        finish = fin
                        if fin != "error":
                            pieces.append(decoder.flush())
                        done = True
                        break
                write_piece("".join(pieces))
            usage = (oai.TokenUsage(n_prompt, n_out, n_prompt + n_out,
                                    req.prefix_reused)
                     if include_usage else None)
            if chat:
                tail = oai.stream_chunk_sse(
                    response_id=rid, model=srv.model_name, created=created,
                    delta={}, finish_reason=finish, usage=usage)
            else:
                tail = oai.completion_chunk_sse(
                    response_id=rid, model=srv.model_name, created=created,
                    text="", finish_reason=finish, usage=usage)
            self.wfile.write(tail)
            self.wfile.write(oai.sse("[DONE]"))
            self.wfile.flush()

    return Handler

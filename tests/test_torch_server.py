"""The port's replica server on the CPU (``tiny-random``, an ephemeral
port): chat and completions, streamed and not, ``/v1/models``,
``/health`` and ``/state``, in the reference server's response shapes.
The served text equals the detokenized greedy stream of the port's own
engine for the same prompt."""

import json
import threading
import urllib.error
import urllib.request

import pytest
import torch

from aigw_tpu_torch.models import llama as tllama
from aigw_tpu_torch.tpuserve import engine as tengine
from aigw_tpu_torch.tpuserve.sampling import SamplingParams
from aigw_tpu_torch.tpuserve.server import TPUServeServer
from aigw_tpu_torch.tpuserve.tokenizer import (
    ByteTokenizer,
    apply_chat_template,
)

MODEL = "tiny-random"
CFG = dict(max_batch_size=2, max_seq_len=128, page_size=16,
           decode_steps_per_tick=4)
MAX_TOKENS = 12


@pytest.fixture(scope="module")
def server():
    srv = TPUServeServer(MODEL, tengine.EngineConfig(**CFG), device="cpu",
                         port=0, param_dtype="float32")
    srv.start()
    yield srv
    srv.stop()


@pytest.fixture(scope="module")
def server_knob_off():
    """A replica started as ``--no-constrained-decoding`` would start
    it."""
    srv = TPUServeServer(MODEL, tengine.EngineConfig(
        **CFG, constrained_decoding=False), device="cpu", port=0,
        param_dtype="float32")
    srv.start()
    yield srv
    srv.stop()


def _post(srv, path, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{srv.port}{path}", data=json.dumps(body).encode(),
        headers={"content-type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.status, r.headers, r.read().decode()


def _get(srv, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}{path}",
                                timeout=60) as r:
        return r.status, json.loads(r.read())


def _sse(raw):
    frames = [ln[len("data: "):] for ln in raw.split("\n")
              if ln.startswith("data: ")]
    assert frames[-1] == "[DONE]"
    return [json.loads(f) for f in frames[:-1]]


def _engine_text(srv, prompt, cfg=CFG):
    """The port engine's greedy stream for ``prompt``, detokenized, on a
    fresh engine over the server's own weights."""
    eng = tengine.Engine(srv.engine.params, tllama.TINY,
                         tengine.EngineConfig(**cfg),
                         eos_token_ids=(ByteTokenizer.eos_id,),
                         device="cpu")
    toks, done = [], threading.Event()

    def emit(tok, fin):
        if tok >= 0:
            toks.append(tok)
        if fin is not None:
            done.set()

    eng.submit(tengine.GenRequest(prompt=prompt, max_tokens=MAX_TOKENS,
                                  sampling=SamplingParams(temperature=0.0),
                                  emit=emit))
    eng.start()
    try:
        assert done.wait(60)
    finally:
        eng.stop()
    return ByteTokenizer().decode(toks), len(toks)


MSGS = [{"role": "user", "content": "hello there"}]


def test_chat_completion(server):
    status, headers, raw = _post(server, "/v1/chat/completions", {
        "model": MODEL, "messages": MSGS, "max_tokens": MAX_TOKENS,
        "temperature": 0})
    assert status == 200 and headers["x-aigw-request-id"].startswith(
        "chatcmpl-")
    body = json.loads(raw)
    assert body["object"] == "chat.completion"
    assert body["model"] == MODEL
    choice = body["choices"][0]
    assert choice["message"]["role"] == "assistant"
    prompt = apply_chat_template(MSGS, ByteTokenizer())
    text, n = _engine_text(server, prompt)
    assert choice["message"]["content"] == text
    meter = body["usage"].pop("aigw_meter")
    assert body["usage"] == {"prompt_tokens": len(prompt),
                             "completion_tokens": n,
                             "total_tokens": len(prompt) + n}
    # the engine's MeterRecord rides the usage, as the reference's does
    assert meter["decode_tokens"] == n and meter["finish"] \
        == choice["finish_reason"]
    assert meter["prefill_real"] + meter["prefix_reused"] == len(prompt)
    assert choice["finish_reason"] in ("stop", "length")


def test_chat_completion_stream(server):
    status, headers, raw = _post(server, "/v1/chat/completions", {
        "model": MODEL, "messages": MSGS, "max_tokens": MAX_TOKENS,
        "temperature": 0, "stream": True,
        "stream_options": {"include_usage": True}})
    assert status == 200
    assert headers["content-type"] == "text/event-stream"
    chunks = _sse(raw)
    assert all(c["object"] == "chat.completion.chunk" for c in chunks)
    assert chunks[0]["choices"][0]["delta"] == {"role": "assistant",
                                                "content": ""}
    text = "".join(c["choices"][0]["delta"].get("content", "")
                   for c in chunks)
    want, n = _engine_text(server, apply_chat_template(MSGS,
                                                       ByteTokenizer()))
    assert text == want
    assert chunks[-1]["choices"][0]["finish_reason"] in ("stop", "length")
    assert chunks[-1]["usage"]["completion_tokens"] == n


def test_completion(server):
    status, headers, raw = _post(server, "/v1/completions", {
        "model": MODEL, "prompt": "once upon", "max_tokens": MAX_TOKENS,
        "temperature": 0})
    body = json.loads(raw)
    assert status == 200 and body["object"] == "text_completion"
    prompt = [ByteTokenizer.bos_id] + ByteTokenizer().encode("once upon")
    text, n = _engine_text(server, prompt)
    assert body["choices"][0]["text"] == text
    assert body["usage"]["completion_tokens"] == n


def test_completion_stream(server):
    status, _h, raw = _post(server, "/v1/completions", {
        "model": MODEL, "prompt": "once upon", "max_tokens": MAX_TOKENS,
        "temperature": 0, "stream": True})
    chunks = _sse(raw)
    assert all(c["object"] == "text_completion" for c in chunks)
    text = "".join(c["choices"][0]["text"] for c in chunks)
    prompt = [ByteTokenizer.bos_id] + ByteTokenizer().encode("once upon")
    assert text == _engine_text(server, prompt)[0]
    assert chunks[-1]["choices"][0]["finish_reason"] in ("stop", "length")


def test_models_health_state(server):
    status, models = _get(server, "/v1/models")
    assert status == 200 and models["object"] == "list"
    assert models["data"][0]["id"] == MODEL
    assert _get(server, "/health") == (200, {"status": "ok",
                                             "model": MODEL})
    status, state = _get(server, "/state")
    assert status == 200
    for key in ("active_slots", "max_slots", "queued", "kv_pages_free",
                "kv_occupancy", "tokens_generated", "decode_window",
                "attention_backend", "attention_backend_reason",
                "decode_attn_impl", "decode_attn_reason",
                "prefill_padded_frac", "constrained_decoding",
                "prefix_cache_hit_rate", "prefix_pages_resident",
                "prefix_pages_pinned", "prefix_bytes_pinned",
                "prefix_cache_hits", "prefix_cache_misses",
                "prefix_cache_evictions"):
        assert key in state, key
    # the reference's defaults and what they run: the bucket ladder and
    # the gather rung
    assert state["attention_backend"] == "xla-bucketed"
    assert state["attention_backend_reason"] == "requested"
    assert state["decode_attn_impl"] == "gather-torch"
    # constrained decoding and the prefix cache on, no default differing
    assert state["constrained_decoding"] is True
    assert state["enable_prefix_cache"] is True
    assert state["defaults_differ"] == {}
    assert models["data"][0]["capabilities"] == state["capabilities"]
    assert state["capabilities"]["tools"] is True
    for key in ("constrained_slots", "constraint_requests",
                "constraint_rollbacks", "constraint_mask_updates",
                "constraint_grammars"):
        assert isinstance(state[key], int), key


SPEC_KEYS = ("spec_accepted", "spec_drafted", "spec_accept_rate",
             "spec_draft_len", "spec_rung_ups", "spec_rung_downs",
             "spec_lookahead_slots")


def test_state_carries_speculation_keys():
    """A speculating replica exports the reference's seven ``spec_*``
    /state keys, and a pinned greedy request moves them."""
    srv = TPUServeServer(MODEL, tengine.EngineConfig(
        **CFG, spec_tokens=3, spec_adaptive=False), device="cpu", port=0,
        param_dtype="float32")
    srv.start()
    try:
        status, _, raw = _post(srv, "/v1/completions", {
            "model": MODEL, "prompt": "abcab", "max_tokens": 16,
            "temperature": 0, "logit_bias": {"97": 100}})
        assert status == 200
        assert json.loads(raw)["choices"][0]["text"] == "a" * 16
        _, state = _get(srv, "/state")
    finally:
        srv.stop()
    assert set(SPEC_KEYS) <= set(state)
    assert state["spec_accepted"] > 0 and state["spec_draft_len"] == 3
    assert state["spec_accept_rate"] == round(
        state["spec_accepted"] / state["spec_drafted"], 4)


@pytest.mark.parametrize("body,knob_off", [
    ({"messages": MSGS}, False),  # no model
    # served by default: refused by a --no-constrained-decoding replica
    ({"model": MODEL, "messages": MSGS,
      "response_format": {"type": "json_object"}}, True),
    ({"model": MODEL, "messages": MSGS, "logprobs": True}, False),
], ids=["missing_model", "response_format", "logprobs"])
def test_bad_requests_get_400(server, server_knob_off, body, knob_off):
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server_knob_off if knob_off else server,
              "/v1/chat/completions", body)
    assert e.value.code == 400
    err = json.loads(e.value.read())["error"]
    if knob_off:
        assert err["message"] == (
            "this server was started with --no-constrained-decoding; "
            "response_format json modes and tool calling are unavailable")


def test_stop_string_ends_stream(server):
    full = _engine_text(server, apply_chat_template(MSGS,
                                                    ByteTokenizer()))[0]
    if len(full) < 3:
        pytest.skip("greedy text too short to cut")
    stop = full[1:3]
    _s, _h, raw = _post(server, "/v1/chat/completions", {
        "model": MODEL, "messages": MSGS, "max_tokens": MAX_TOKENS,
        "temperature": 0, "stop": stop})
    body = json.loads(raw)
    assert body["choices"][0]["message"]["content"] == full[:full.index(stop)]
    assert body["choices"][0]["finish_reason"] == "stop"


QCFG = {**CFG, "kv_cache_dtype": "int8"}


def test_quantized_replica_serves_its_greedy_stream():
    """``quantize="int8"`` (W8A16 weights, quantized on the device after
    init) over int8 KV pages: the served text equals the port engine's
    greedy stream over the same quantized weights and pool, and /state
    exports the pool's dtype and byte math."""
    srv = TPUServeServer(MODEL, tengine.EngineConfig(**QCFG), device="cpu",
                         port=0, param_dtype="float32", quantize="int8")
    srv.start()
    try:
        assert srv.engine.params["l0.wq.q"].dtype == torch.int8
        status, _h, raw = _post(srv, "/v1/chat/completions", {
            "model": MODEL, "messages": MSGS, "max_tokens": MAX_TOKENS,
            "temperature": 0})
        assert status == 200
        prompt = apply_chat_template(MSGS, ByteTokenizer())
        text, n = _engine_text(srv, prompt, QCFG)
        body = json.loads(raw)
        assert body["choices"][0]["message"]["content"] == text
        assert body["usage"]["completion_tokens"] == n
        _s, state = _get(srv, "/state")
        assert state["kv_cache_dtype"] == "int8"
        assert state["kv_quant_bits"] == 8
        # L * 2 * Hkv * (D + 4) bytes per token: packed rows plus scales
        c = tllama.TINY
        assert state["kv_bytes_per_token"] == (
            c.n_layers * 2 * c.n_kv_heads * (c.head_dim + 4))
        # the defaults over int8 pages: the bucketed prefill and the
        # gather rung, dequantizing at the gather (the reference's rows)
        assert state["attention_backend_reason"] == "requested"
        assert "int8 KV pages dequantize against their per-page scales" \
            in state["decode_attn_reason"]
    finally:
        srv.stop()
    with pytest.raises(ValueError, match="quantization"):
        TPUServeServer(MODEL, tengine.EngineConfig(**CFG), device="cpu",
                       port=0, quantize="fp8")

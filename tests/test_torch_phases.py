"""The port replica's serving-phase histograms and ``/tokenize`` against
the reference: ``EnginePhases`` gives the reference's percentiles on the
same observations, a served request fills ``/state``'s
``phase_percentiles``, the reference gateway's picker prices the port
replica's TTFT from its polled ``/state``, and ``POST /tokenize`` answers
as the reference's ``_tokenize`` does (chat or prompt body; 400 on a
body that does not parse)."""

import asyncio
import json
import urllib.error
import urllib.request

import aiohttp
import numpy as np
import pytest

from aigw_tpu.gateway.picker import Endpoint, EndpointPicker
from aigw_tpu.models.registry import get_model_spec as ref_model_spec
from aigw_tpu.obs import metrics as ref_metrics
from aigw_tpu.tpuserve import tokenizer as ref_tok
from aigw_tpu_torch.obs import metrics
from aigw_tpu_torch.tpuserve import engine as tengine
from aigw_tpu_torch.tpuserve.server import TPUServeServer

MODEL = "tiny-random"
CFG = dict(max_batch_size=2, max_seq_len=128, page_size=16,
           decode_steps_per_tick=4)
PHASES = ("queue_wait", "prefill", "ttft", "first_emit",
          "decode_per_token", "transfer")


@pytest.fixture(scope="module")
def server():
    srv = TPUServeServer(MODEL, tengine.EngineConfig(**CFG), device="cpu",
                         port=0, param_dtype="float32")
    srv.start()
    yield srv
    srv.stop()


def _post(srv, path, body: bytes):
    req = urllib.request.Request(
        f"http://127.0.0.1:{srv.port}{path}", data=body,
        headers={"content-type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.status, json.loads(r.read())


def _state(srv):
    with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/state",
                                timeout=60) as r:
        return json.loads(r.read())


def test_phase_table_is_the_reference_table():
    assert metrics.ENGINE_HISTOGRAMS == ref_metrics.ENGINE_HISTOGRAMS
    assert metrics.PHASE_BUCKETS_MS == ref_metrics.PHASE_BUCKETS_MS
    assert tuple(k for k, _ in metrics.ENGINE_HISTOGRAMS) == PHASES


@pytest.mark.parametrize("n", [0, 1, 7, 400])
def test_engine_phases_match_reference(n):
    """The same observations (bucket edges, +Inf, a phase left empty)
    give the reference's percentiles, -1 for an empty phase."""
    rng = np.random.default_rng(n)
    ms = list(rng.lognormal(2.0, 2.0, n)) + list(
        metrics.PHASE_BUCKETS_MS[:n])
    ours, ref = metrics.EnginePhases(), ref_metrics.EnginePhases()
    for i, x in enumerate(ms):
        phase = PHASES[i % (len(PHASES) - 1)]  # "transfer" stays empty
        ours.observe(phase, float(x))
        ref.observe(phase, float(x))
    ours.observe("no_such_phase", 1.0)  # ignored, as by the reference
    assert ours.percentiles() == ref.percentiles()
    assert ours.percentiles()["transfer"] == {"p50": -1.0, "p95": -1.0,
                                              "p99": -1.0}


def test_state_carries_phase_percentiles(server):
    """After a served chat request /state carries every phase, each
    observed (the decode window's token copy included)."""
    status, body = _post(server, "/v1/chat/completions", json.dumps({
        "model": MODEL, "messages": [{"role": "user", "content": "hi"}],
        "max_tokens": 8, "temperature": 0}).encode())
    assert status == 200 and body["usage"]["completion_tokens"] >= 1
    pp = _state(server)["phase_percentiles"]
    assert set(pp) == set(PHASES)
    for phase in ("queue_wait", "prefill", "ttft", "first_emit"):
        assert pp[phase]["p50"] >= 0, (phase, pp)
        assert pp[phase]["p50"] <= pp[phase]["p95"] <= pp[phase]["p99"]
    if body["usage"]["completion_tokens"] > 1:
        assert pp["decode_per_token"]["p50"] >= 0
        assert pp["transfer"]["p50"] >= 0


def test_reference_picker_prices_a_port_replica(server):
    """The reference picker polls the port replica's /state and predicts
    its TTFT (a number, not None) from the prefill p50."""
    _post(server, "/v1/completions", json.dumps({
        "model": MODEL, "prompt": "abc", "max_tokens": 4}).encode())
    addr = f"127.0.0.1:{server.port}"
    picker = EndpointPicker([Endpoint(addr)], mode="slo")

    async def poll():
        async with aiohttp.ClientSession(
                timeout=aiohttp.ClientTimeout(total=10.0)) as session:
            await picker._poll_one(session, picker.endpoints[0])

    asyncio.run(poll())
    st = picker.state[addr]
    assert st.healthy
    assert st.phase_percentiles["prefill"]["p50"] >= 0
    pred = picker.predicted_ttft_ms(st)
    assert isinstance(pred, float) and pred >= 0


TOKENIZE_BODIES = {
    "chat": {"model": MODEL, "messages": [
        {"role": "system", "content": "be brief"},
        {"role": "user", "content": "héllo there"}]},
    "prompt": {"model": MODEL, "prompt": "once upon a time"},
    "empty": {"model": MODEL},
}


@pytest.mark.parametrize("case", sorted(TOKENIZE_BODIES))
def test_tokenize_answers_as_the_reference(server, case):
    """The reference's _tokenize on the same body: chat messages through
    its chat template, else the prompt as text, with the same count,
    tokens and max_model_len."""
    body = TOKENIZE_BODIES[case]
    spec = ref_model_spec(MODEL)
    tok = ref_tok.load_tokenizer(spec.tokenizer)
    if isinstance(body.get("messages"), list):
        want = ref_tok.apply_chat_template(body["messages"], tok,
                                           spec.chat_template)
    else:
        want = tok.encode(str(body.get("prompt", "")))
    status, got = _post(server, "/tokenize", json.dumps(body).encode())
    assert status == 200
    assert got == {"count": len(want), "max_model_len": CFG["max_seq_len"],
                   "tokens": list(want)}


@pytest.mark.parametrize("raw", [b"{not json", b"[1, 2]"],
                         ids=["not_json", "not_object"])
def test_tokenize_bad_body_gets_400(server, raw):
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server, "/tokenize", raw)
    assert e.value.code == 400
    assert "error" in json.loads(e.value.read())

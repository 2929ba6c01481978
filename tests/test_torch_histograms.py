"""The replica's GenAI request histograms and ``/state``'s device keys
against the JAX package's replica.

- ``obs/metrics.py``: ``LabeledHistogram`` / ``RequestMetrics`` render
  what ``prometheus_client.generate_latest`` renders for the reference's
  ``GenAIMetrics`` on the same observations, byte for byte once the
  ``_created`` times are set equal (the durations come from one stepped
  clock on both sides).
- Two replicas, the reference's and the port's, on the same float32
  weights, serve the same requests one at a time: chat and completions,
  streamed and not, ``n: 2`` streamed (recorded) and buffered (not
  recorded, as the reference), a 400, and one engine failure. Their
  ``/metrics`` expositions carry the same four GenAI families, label
  sets, buckets, counts and token sums (durations are compared by
  count only).
- ``/state``: the port replica's key set is the reference replica's
  plus the port's own (``MESH_STATE_KEYS``, the reference's keys the
  port does not export, is empty since the ``sp`` keys were ported, and
  the five carry the reference's values off a mesh); the four device
  keys carry the engine's values; the reference picker's ``worst_hbm_frac`` and
  ``worst_kv_occupancy`` read them off a polled port replica.
"""

import asyncio
import json
import threading
import time
import types
import urllib.error
import urllib.request

import aiohttp
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from prometheus_client.parser import text_string_to_metric_families

from aigw_tpu.gateway.costs import TokenUsage as JUsage
from aigw_tpu.models import llama as jllama
from aigw_tpu.obs import metrics as jmetrics
from aigw_tpu.tpuserve import engine as jengine
from aigw_tpu_torch.models import convert
from aigw_tpu_torch.models import llama as tllama
from aigw_tpu_torch.obs import metrics as tmetrics
from aigw_tpu_torch.schemas.openai import TokenUsage as TUsage
from aigw_tpu_torch.tpuserve import engine as tengine

MODEL = "tiny-random"
EOS = (257,)
SERVER_CFG = dict(max_batch_size=4, max_seq_len=256, page_size=16,
                  decode_steps_per_tick=4, kv_cache_dtype="float32",
                  attention_backend="pallas-ragged")
GENAI = ("gen_ai_client_token_usage",
         "gen_ai_server_request_duration_seconds",
         "gen_ai_server_time_to_first_token_seconds",
         "gen_ai_server_time_per_output_token_seconds")
# the reference's /state keys the port does not export: none (the mesh,
# slice-topology and sequence-parallel keys are served)
MESH_STATE_KEYS = frozenset()
# the sequence-parallel keys, with the reference's values off a mesh
SP_STATE_KEYS = ("sp", "sp_prefill_mode", "sp_chunked_prefills",
                 "sp_resume_prefills", "sp_interactive_admits")
# the port's /state keys the reference's replica has only on /metrics or
# not at all (the counters behind the engine gauges, the device's name,
# the defaults table)
PORT_STATE_KEYS = frozenset({
    "chunked_prefill_steps", "defaults_differ", "device",
    "enable_prefix_cache", "prefills", "prefix_cow_copies",
    "prefix_full_hits", "prefix_tokens_reused", "window_grows",
    "window_shrinks"})
CHAT, TEXT = "/v1/chat/completions", "/v1/completions"
USAGE = {"stream_options": {"include_usage": True}}
MSGS = [{"role": "user", "content": "hello there"}]
CALLS = [
    (CHAT, {"messages": MSGS, "max_tokens": 6, "temperature": 0.0}),
    (CHAT, {"messages": MSGS, "max_tokens": 5, "temperature": 0.0,
            "stream": True, **USAGE}),
    (TEXT, {"prompt": "once upon", "max_tokens": 7, "temperature": 0.8,
            "seed": 3}),
    (TEXT, {"prompt": "abc", "max_tokens": 4, "temperature": 0.0,
            "stream": True}),
    (CHAT, {"messages": MSGS, "max_tokens": 3, "temperature": 0.9,
            "seed": 5, "n": 2, "stream": True}),
    (TEXT, {"prompt": "n two", "max_tokens": 3, "temperature": 0.0,
            "n": 2}),
    (CHAT, {"max_tokens": 3}),  # no messages: a 400, nothing recorded
]
# the last request meets a failing engine: a 500, error_type "engine"
FAIL = (CHAT, {"messages": MSGS, "max_tokens": 4, "temperature": 0.0})


def _http(port, path, body=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=None if body is None else json.dumps(body).encode(),
        headers={"content-type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _fail_when_busy(engine) -> None:
    """The engine's next decode tick with a live slot raises: the loop
    errors every request it holds (``finish == "error"``)."""
    def boom():
        if any(s is not None for s in engine._slots):
            raise RuntimeError("injected engine failure")
        return False

    engine._decode_tick = boom


def _drive(port: int, engine) -> dict:
    replies = []
    for path, body in CALLS:
        replies.append(_http(port, path, {"model": MODEL, **body}))
    _fail_when_busy(engine)
    replies.append(_http(port, FAIL[0], {"model": MODEL, **FAIL[1]}))
    return {"statuses": [s for s, _ in replies],
            "replies": [r for _, r in replies],
            "metrics": _http(port, "/metrics")[1],
            "state": json.loads(_http(port, "/state")[1])}


@pytest.fixture(scope="module")
def weights():
    p = jllama.init_params(jax.random.PRNGKey(0), jllama.TINY,
                           dtype=jnp.float32)
    return p, convert.params_from_numpy(
        {k: np.asarray(v) for k, v in p.items()}, device="cpu")


@pytest.fixture(scope="module")
def reference_run(weights):
    from aiohttp import web

    from aigw_tpu.tpuserve import server as jserver

    class F32Server(jserver.TPUServeServer):
        def _load_params(self, spec):
            return weights[0]

    holder = {}
    started = threading.Event()

    def run():
        async def main():
            server = F32Server(MODEL, jengine.EngineConfig(**SERVER_CFG))
            holder["server"] = server
            runner = web.AppRunner(server.app)
            await runner.setup()
            site = web.TCPSite(runner, "127.0.0.1", 0)
            await site.start()
            holder["port"] = site._server.sockets[0].getsockname()[1]
            holder["loop"] = asyncio.get_running_loop()
            holder["stop"] = asyncio.Event()
            started.set()
            await holder["stop"].wait()
            await runner.cleanup()

        asyncio.run(main())

    t = threading.Thread(target=run, daemon=True)
    t.start()
    assert started.wait(timeout=300)
    try:
        return _drive(holder["port"], holder["server"].engine)
    finally:
        holder["loop"].call_soon_threadsafe(holder["stop"].set)
        t.join(timeout=60)


def _port_server(weights):
    from aigw_tpu_torch.tpuserve.server import TPUServeServer

    srv = TPUServeServer(MODEL, tengine.EngineConfig(**SERVER_CFG),
                         device="cpu", port=0, param_dtype="float32")
    srv.engine = tengine.Engine(weights[1], tllama.TINY, srv.engine.cfg,
                                eos_token_ids=EOS, fns=srv.fns, device="cpu")
    return srv


@pytest.fixture(scope="module")
def port_run(weights):
    srv = _port_server(weights)
    srv.start()
    try:
        return _drive(srv.port, srv.engine)
    finally:
        srv.stop()


def _genai(text: str) -> dict:
    """The GenAI families of an exposition → ``{family: {(sample name,
    labels): value}}`` (the ``_created`` samples dropped)."""
    out = {}
    for fam in text_string_to_metric_families(text):
        if fam.name not in GENAI:
            continue
        assert fam.type == "histogram", fam
        out[fam.name] = {
            (s.name, tuple(sorted(s.labels.items()))): s.value
            for s in fam.samples if not s.name.endswith("_created")}
    return out


def _timeless(fams: dict) -> dict:
    """Durations are the clocks': keep their counts and bucket sets."""
    out = {}
    for name, samples in fams.items():
        if name == "gen_ai_client_token_usage":
            out[name] = samples
            continue
        out[name] = {k: v for k, v in samples.items()
                     if k[0].endswith("_count")}
        out[name]["le"] = sorted({dict(k[1])["le"] for k in samples
                                  if k[0].endswith("_bucket")})
    return out


# -- the renderer -------------------------------------------------------------
def _observe(metrics, rm_cls, usage_cls, clock=time.monotonic):
    for op, model, err, usage in (
            ("chat", "m\"1", "", (5, 2, 7, 1)),
            ("text_completion", "m\\2", "engine", (3, 0, 3, 0)),
            ("chat", "m\"1", "", (1_000_000, 64, 1_000_064, 0))):
        rm = rm_cls(metrics=metrics, operation=op, provider="tpuserve",
                    request_model=model, response_model="r\n",
                    start=clock())
        for _ in range(3):
            rm.record_tokens_emitted(1)
        rm.record_tokens_emitted(0)
        rm.finish(usage_cls(*usage), error_type=err)


def _stepped_clock(monkeypatch, module):
    """``module``'s ``time.monotonic`` advances 0.25 s a call from 0, so
    both sides observe the same durations whatever the host's load."""
    ticks = iter(range(1_000))
    fake = types.SimpleNamespace(time=time.time,
                                 monotonic=lambda: 0.25 * next(ticks))
    monkeypatch.setattr(module, "time", fake)
    return fake


def test_genai_histograms_render_like_generate_latest(monkeypatch):
    ref, ours = jmetrics.GenAIMetrics(), tmetrics.GenAIMetrics()
    _observe(ref, jmetrics.RequestMetrics, JUsage,
             _stepped_clock(monkeypatch, jmetrics).monotonic)
    _observe(ours, tmetrics.RequestMetrics, TUsage,
             _stepped_clock(monkeypatch, tmetrics).monotonic)
    # the creation stamps are the wall clock's: set the port's to the
    # reference's
    for mine, theirs in ((ours.token_usage, ref.token_usage),
                         (ours.request_duration, ref.request_duration),
                         (ours.time_to_first_token,
                          ref.time_to_first_token),
                         (ours.time_per_output_token,
                          ref.time_per_output_token)):
        for labels, child in mine._children.items():
            other = theirs.labels(*labels)
            child[2] = other._created
    assert ours.export() == ref.export()
    assert tmetrics.render_genai_families() \
        == jmetrics.GenAIMetrics().export()


def test_parse_exposition_folds_created_into_its_histogram():
    m = tmetrics.GenAIMetrics()
    _observe(m, tmetrics.RequestMetrics, TUsage)
    fams = tmetrics.parse_exposition(m.export().decode())
    assert set(fams) == {n for n, _t, _h in tmetrics.GENAI_FAMILIES}
    with pytest.raises(ValueError, match="undeclared"):
        tmetrics.parse_exposition("x_created 1\n")


def test_label_count_is_checked():
    h = tmetrics.GenAIMetrics().time_to_first_token
    with pytest.raises(ValueError, match="label values"):
        h.observe(("chat",), 1.0)


# -- two replicas, the same requests ------------------------------------------
def test_replies_match_reference(port_run, reference_run):
    assert port_run["statuses"] == reference_run["statuses"] == [
        200, 200, 200, 200, 200, 200, 400, 500]
    for i in (0, 2, 5):  # buffered: the completions and usage
        got, want = json.loads(port_run["replies"][i]), json.loads(
            reference_run["replies"][i])
        assert got["usage"]["completion_tokens"] == \
            want["usage"]["completion_tokens"]
        assert [c["text"] if "text" in c else c["message"]["content"]
                for c in got["choices"]] == [
            c["text"] if "text" in c else c["message"]["content"]
            for c in want["choices"]]


def test_genai_families_match_reference(port_run, reference_run):
    got, want = _genai(port_run["metrics"]), _genai(
        reference_run["metrics"])
    assert set(got) == set(want) == set(GENAI)
    assert _timeless(got) == _timeless(want)
    # every duration family carries the same label sets as the reference
    for name in GENAI[1:]:
        assert {k[1] for k in got[name] if not k[0].endswith("_bucket")} \
            == {k[1] for k in want[name] if not k[0].endswith("_bucket")}


def test_genai_counts_are_the_traffic(port_run):
    fams = _genai(port_run["metrics"])

    def total(name, suffix, **labels):
        return sum(v for (n, ls), v in fams[name].items()
                   if n == name + suffix
                   and labels.items() <= dict(ls).items())

    # recorded: 3 buffered (one the failure), 2 streamed, 1 n=2 stream
    dur = "gen_ai_server_request_duration_seconds"
    assert total(dur, "_count") == 6
    assert total(dur, "_count", error_type="engine") == 1
    assert total(dur, "_count", gen_ai_operation_name="text_completion") \
        == 2
    # streamed requests with a token: the chat, the completion, the n=2
    ttft = "gen_ai_server_time_to_first_token_seconds"
    assert total(ttft, "_count") == 3
    # each streamed token after a request's first is one inter-token
    # observation: (5 - 1) + (4 - 1) + (2 x 3 - 1)
    assert total("gen_ai_server_time_per_output_token_seconds",
                 "_count") == 12
    usage = "gen_ai_client_token_usage"
    out = total(usage, "_sum", gen_ai_token_type="output")
    inp = total(usage, "_sum", gen_ai_token_type="input")
    assert total(usage, "_sum", gen_ai_token_type="total") == out + inp
    # the failed request's prefill emitted its first token before the
    # decode tick that failed
    assert out == 6 + 5 + 7 + 4 + 2 * 3 + 1
    labels = {dict(ls)["gen_ai_provider_name"] for (_n, ls) in fams[dur]}
    assert labels == {"tpuserve"}


# -- /state -------------------------------------------------------------------
def test_state_keys_are_the_references_less_the_mesh(port_run,
                                                     reference_run):
    got, want = set(port_run["state"]), set(reference_run["state"])
    assert MESH_STATE_KEYS == frozenset()
    assert got == want | PORT_STATE_KEYS
    assert not PORT_STATE_KEYS & want
    assert {k: port_run["state"][k] for k in SP_STATE_KEYS} \
        == {k: reference_run["state"][k] for k in SP_STATE_KEYS} \
        == {"sp": 1, "sp_prefill_mode": "off", "sp_chunked_prefills": 0,
            "sp_resume_prefills": 0, "sp_interactive_admits": 0}


def test_state_device_keys_carry_the_engines_values(port_run,
                                                    reference_run,
                                                    weights):
    st, ref = port_run["state"], reference_run["state"]
    nbytes = sum(t.numel() * t.element_size() for t in weights[1].values())
    assert st["param_bytes_total"] == nbytes \
        == ref["param_bytes_total"]
    assert st["param_bytes_per_device"] == {"0": nbytes} \
        == ref["param_bytes_per_device"]
    assert [set(d) for d in st["devices"]] == [set(d) for d in
                                                ref["devices"]]
    (dev,) = st["devices"]
    assert dev["id"] == 0 and dev["platform"] == "cpu"
    assert dev["param_bytes"] == nbytes
    assert st["device_memory_frac_worst"] == dev["memory_frac"] \
        == st["device_memory_frac"]


def test_reference_picker_reads_the_device_keys(weights):
    """The reference picker polls a port replica and prices its worst
    device from ``devices`` / ``device_memory_frac_worst``."""
    from aigw_tpu.gateway.picker import Endpoint, EndpointPicker

    srv = _port_server(weights)
    srv.start()
    try:
        addr = f"127.0.0.1:{srv.port}"
        picker = EndpointPicker([Endpoint(addr)])
        # a worst device the engine's refresh would not report on the
        # CPU (it reads no memory there): held for the poll
        srv.engine._refresh_device_stats = lambda: None
        srv.engine.device_stats = [dict(srv.engine.device_stats[0],
                                        memory_frac=0.5,
                                        kv_occupancy=0.25)]
        srv.engine.stats.device_memory_frac_worst = 0.625

        async def poll():
            async with aiohttp.ClientSession(
                    timeout=aiohttp.ClientTimeout(total=10.0)) as session:
                await picker._poll_one(session, picker.endpoints[0])

        asyncio.run(poll())
        st = picker.state[addr]
        assert st.healthy and len(st.devices) == 1
        assert st.hbm_frac_worst == 0.625
        assert st.worst_hbm_frac() == 0.625
        assert st.worst_kv_occupancy() == 0.25
    finally:
        srv.stop()

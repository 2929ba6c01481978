"""Usage metering: the port engine's MeterRecords against the JAX
package's.

- Whole engines: the reference ``Engine`` and the port's
  (``attention_backend="pallas-ragged"``, the reference's
  ``init_params(PRNGKey(0), TINY, float32)`` weights over a float32
  pool, the prefix cache on) serve one scripted stream, phase by phase:
  a batched prefill of three tenants' requests, a page-aligned prompt
  (a miss), a resume at its cached offset, the same prompt again (a full
  hit), two choices of one prompt (an ``n = 2`` fan-out), a request
  cancelled while queued and one cancelled by its consumer mid-stream
  (a stop-string hit); then, with speculation at a pinned width of 3,
  a pinned stream beside a free greedy one. Every request gets exactly
  one record, equal to the reference's in every count field and in
  ``tenant``, ``priority``, ``finish`` and ``segments``; residency is
  positive for every request that held a slot. The engines' ``meter_*``
  totals are the records' sums, token for token.
- The server: ``usage_from_meter`` and ``merge_meter_boxes`` against
  the reference server's, ``usage.aigw_meter`` against the reference's
  ``usage_dict``; a CPU replica's responses carry a record each, and
  ``/state``'s ``meter_*`` deltas equal their sums.
- The gateway: the reference ``UsageLedger`` folds the port's
  ``usage.aigw_meter`` (as its ``extract_usage`` reads it) to the same
  per-tenant counts as the reference's own records, with no
  reconciliation mismatch.
"""

import json
import threading
import time
import types
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from aigw_tpu.models import llama as jllama
from aigw_tpu.tpuserve import engine as jengine
from aigw_tpu.tpuserve.sampling import SamplingParams as JSampling
from aigw_tpu_torch.models import convert
from aigw_tpu_torch.models import llama as tllama
from aigw_tpu_torch.schemas import openai as toai
from aigw_tpu_torch.tpuserve import engine as tengine
from aigw_tpu_torch.tpuserve.sampling import SamplingParams as TSampling

EOS = (257,)
CFG = dict(max_batch_size=4, max_seq_len=128, page_size=16,
           decode_steps_per_tick=4, kv_cache_dtype="float32",
           attention_backend="pallas-ragged", decode_backend="fused",
           ragged_chunk_tokens=16, ragged_max_chunks=4)
GREEDY = dict(temperature=0.0)
SEEDED = dict(temperature=0.8, seed=11)
ALIGNED = [(7 * i + 3) % 250 for i in range(32)]  # two full pages
#: every field of a record but residency, which is wall-clock
COUNT_FIELDS = ("schema", "finish", "prefill_real", "prefill_padded",
                "prefix_reused", "decode_tokens", "spec_drafted",
                "spec_accepted", "host_page_byte_s", "segments", "tenant",
                "priority")
METER_TOTALS = {
    "meter_prefill_tokens": "prefill_real",
    "meter_prefill_padded_tokens": "prefill_padded",
    "meter_prefix_reused_tokens": "prefix_reused",
    "meter_decode_tokens": "decode_tokens",
    "meter_spec_drafted": "spec_drafted",
    "meter_spec_accepted": "spec_accepted",
}
#: (prompt, max_tokens, sampling, tenant, how): how = "" (served),
#: "queued" (cancelled before it is admitted) or "stop" (the consumer
#: cancels after its third token, as a stop-string hit does)
PHASES = [
    [([10, 20, 30, 40, 50], 9, GREEDY, "a", ""),
     ([3, 1, 4, 1, 5, 9, 2], 7, SEEDED, "b", ""),
     ([99, 98, 97], 6, GREEDY, "", "")],
    [(ALIGNED, 5, GREEDY, "a", "")],
    [(ALIGNED + [11, 12, 13], 6, SEEDED, "b", "")],
    [(ALIGNED, 5, GREEDY, "a", "")],
    # n = 2: one prompt, two choices (seeds 7 and 8)
    [([8, 6, 4, 2] * 5, 6, dict(temperature=0.7, seed=7), "c", ""),
     ([8, 6, 4, 2] * 5, 6, dict(temperature=0.7, seed=8), "c", "")],
    [([1, 2, 3], 4, GREEDY, "a", "queued"),
     ([4, 5, 6, 7], 40, GREEDY, "b", "stop")],
]
PINNED = ([5, 6, 7, 5, 6], 10, dict(temperature=0.0,
                                   logit_bias=((7, 100.0),)), "p", "")
SPEC_PHASES = [[PINNED, ([1, 2, 3, 1, 2, 3], 8, GREEDY, "q", "")]]


@pytest.fixture(scope="module")
def weights():
    p = jllama.init_params(jax.random.PRNGKey(0), jllama.TINY,
                           dtype=jnp.float32)
    return p, convert.params_from_numpy(
        {k: np.asarray(v) for k, v in p.items()}, device="cpu")


def _serve(eng, mod, sp_cls, phases):
    """Serve ``phases`` one after the other; returns per request its
    MeterRecords (every one it got) and its finish."""
    out = []
    eng.start()
    try:
        for phase in phases:
            recs = [[] for _ in phase]
            fins: list = [None] * len(phase)
            done = [threading.Event() for _ in phase]
            reqs = []
            for i, (prompt, n, kw, tenant, how) in enumerate(phase):
                def emit(t, f, i=i):
                    if t >= 0 and phase[i][4] == "stop":
                        emitted[i] += 1
                        if emitted[i] == 3:
                            reqs[i].cancelled.set()
                    if f is not None:
                        fins[i] = f
                        done[i].set()

                def sink(rec, i=i):
                    recs[i].append(dict(rec))
                    if phase[i][4] == "queued":
                        done[i].set()  # consumed without an emit

                reqs.append(mod.GenRequest(
                    prompt=list(prompt), max_tokens=n, sampling=sp_cls(**kw),
                    emit=emit, tenant=tenant, meter_sink=sink))
            emitted = [0] * len(phase)
            for r, item in zip(reqs, phase):
                if item[4] == "queued":
                    r.cancelled.set()
                eng.submit(r)
            assert all(d.wait(300) for d in done), "a request did not end"
            deadline = time.monotonic() + 60
            while (eng._inflight is not None
                   or eng._device_state is not None
                   or any(not r for r in recs)) \
                    and time.monotonic() < deadline:
                time.sleep(0.01)
            out += [(r, f) for r, f in zip(recs, fins)]
        assert eng.healthy, eng.last_error
    finally:
        eng.stop()
    return out


@pytest.fixture(scope="module", params=["stream", "speculative"])
def served(request, weights):
    phases = PHASES if request.param == "stream" else SPEC_PHASES
    over = ({} if request.param == "stream"
            else dict(spec_tokens=3, spec_adaptive=False))
    jeng = jengine.Engine(weights[0], jllama.TINY,
                          jengine.EngineConfig(**CFG, **over),
                          eos_token_ids=EOS)
    want = _serve(jeng, jengine, JSampling, phases)
    teng = tengine.Engine(weights[1], tllama.TINY,
                          tengine.EngineConfig(**CFG, **over),
                          eos_token_ids=EOS, device="cpu")
    got = _serve(teng, tengine, TSampling, phases)
    return request.param, got, want, teng.stats, jeng.stats


def test_one_record_per_request_equal_to_reference(served):
    name, got, want, _ts, _js = served
    assert len(got) == len(want)
    for i, ((grecs, gfin), (wrecs, wfin)) in enumerate(zip(got, want)):
        assert len(grecs) == len(wrecs) == 1, (name, i)
        g, w = grecs[0], wrecs[0]
        assert set(g) == set(w), (name, i)
        assert {k: g[k] for k in COUNT_FIELDS} \
            == {k: w[k] for k in COUNT_FIELDS}, (name, i)
        assert gfin == wfin, (name, i)
        if g["segments"]:
            assert g["hbm_page_byte_s"] > 0, (name, i)
        else:
            assert g["hbm_page_byte_s"] == 0.0, (name, i)


def test_stream_covers_every_path(served):
    """The scripted stream reaches each path it is meant to: cached
    tokens reused, a queued cancel's zero record, a cancel mid-stream,
    speculation's drafts accepted."""
    name, got, _w, _ts, _js = served
    recs = [r[0][0] for r in got]
    if name == "stream":
        assert [r["prefix_reused"] for r in recs[3:6]] == [0, 32, 31]
        assert recs[5]["prefill_real"] == 1  # the full hit's one row
        queued, stopped = recs[-2], recs[-1]
        assert queued["finish"] == "cancelled" and queued["segments"] == 0
        assert queued["decode_tokens"] == 0
        assert stopped["finish"] == "cancelled"
        assert 3 <= stopped["decode_tokens"] < 40
        assert {r["tenant"] for r in recs} == {"a", "b", "c", ""}
    else:
        assert recs[0]["spec_accepted"] > 0
        assert recs[0]["spec_drafted"] >= recs[0]["spec_accepted"]
    assert all(r["priority"] == "interactive" for r in recs)


def test_meter_totals_are_the_records_sums(served):
    _n, got, _w, tstats, jstats = served
    recs = [r[0][0] for r in got]
    assert tstats.meter_records == jstats.meter_records == len(recs)
    for key, field in METER_TOTALS.items():
        assert getattr(tstats, key) == getattr(jstats, key) \
            == sum(r[field] for r in recs), key
    assert tstats.meter_hbm_page_byte_s == pytest.approx(
        sum(r["hbm_page_byte_s"] for r in recs), abs=1e-5)
    assert tstats.meter_host_page_byte_s == 0.0


# -- the server ----------------------------------------------------------------
BOXES = [
    {},
    {"schema": 1, "finish": "length", "prefill_real": 5,
     "prefill_padded": 8, "prefix_reused": 16, "decode_tokens": 7,
     "spec_drafted": 3, "spec_accepted": 2, "hbm_page_byte_s": 12.345678,
     "host_page_byte_s": 0.0, "segments": 1, "tenant": "a",
     "priority": "interactive"},
    {"schema": 1, "finish": "stop", "prefill_real": 1,
     "prefill_padded": 1, "prefix_reused": 31, "decode_tokens": 2,
     "spec_drafted": 0, "spec_accepted": 0, "hbm_page_byte_s": 0.000001,
     "host_page_byte_s": 0.0, "segments": 1, "tenant": "a",
     "priority": "interactive"},
]


@pytest.mark.parametrize("i", range(len(BOXES)))
def test_usage_from_meter_matches_reference(i):
    from aigw_tpu.schemas import openai as joai
    from aigw_tpu.tpuserve import server as jserver
    from aigw_tpu_torch.tpuserve.server import TPUServeServer

    want = joai.usage_dict(jserver.TPUServeServer._usage_from_meter(
        None, 11, 7, dict(BOXES[i])))
    got = toai.usage_dict(TPUServeServer.usage_from_meter(
        11, 7, dict(BOXES[i])))
    assert got == want
    assert ("aigw_meter" in got) == bool(BOXES[i])


def test_merge_meter_boxes_matches_reference():
    from aigw_tpu.tpuserve import server as jserver
    from aigw_tpu_torch.tpuserve.server import TPUServeServer

    boxes = [dict(b) for b in BOXES]
    assert TPUServeServer.merge_meter_boxes(boxes) \
        == jserver.TPUServeServer._merge_meter_boxes(boxes)
    merged = TPUServeServer.merge_meter_boxes(boxes)
    assert merged["decode_tokens"] == 9 and merged["tenant"] == "a"


def _http(port, path, body=None, headers=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=None if body is None else json.dumps(body).encode(),
        headers={"content-type": "application/json", **(headers or {})})
    with urllib.request.urlopen(req, timeout=300) as r:
        return r.status, r.read().decode()


def _usage_of(raw, stream):
    if not stream:
        return json.loads(raw)["usage"]
    frames = [json.loads(ln[6:]) for ln in raw.split("\n")
              if ln.startswith("data: ") and ln[6:] != "[DONE]"]
    return [f["usage"] for f in frames if f.get("usage")][-1]


SERVER_CFG = dict(max_batch_size=4, max_seq_len=256, page_size=16,
                  decode_steps_per_tick=4, kv_cache_dtype="float32",
                  attention_backend="pallas-ragged")
USAGE = {"stream_options": {"include_usage": True}}
CALLS = [
    ("/v1/chat/completions", {"messages": [{"role": "user",
                                            "content": "hello there"}],
                              "max_tokens": 6}, "a"),
    ("/v1/completions", {"prompt": "x" * 40, "max_tokens": 5,
                         "stream": True, **USAGE}, "b"),
    ("/v1/completions", {"prompt": "x" * 40, "max_tokens": 4}, "b"),
    ("/v1/chat/completions", {"messages": [{"role": "user",
                                            "content": "two"}],
                              "max_tokens": 3, "n": 2,
                              "temperature": 0.5}, "a"),
    ("/v1/completions", {"prompt": "zz", "max_tokens": 4, "n": 2,
                         "temperature": 0.9, "stream": True, **USAGE}, ""),
]


@pytest.fixture(scope="module")
def replica_run(weights):
    """A CPU port replica serving CALLS one at a time: each response's
    usage, and /state before and after."""
    from aigw_tpu_torch.tpuserve.server import TPUServeServer

    srv = TPUServeServer("tiny-random", tengine.EngineConfig(**SERVER_CFG),
                         device="cpu", port=0, param_dtype="float32")
    srv.engine = tengine.Engine(weights[1], tllama.TINY, srv.engine.cfg,
                                eos_token_ids=EOS, device="cpu")
    srv.start()
    try:
        before = json.loads(_http(srv.port, "/state")[1])
        usages = []
        for path, body, tenant in CALLS:
            status, raw = _http(srv.port, path,
                                {"model": "tiny-random", **body},
                                {"x-aigw-tenant": tenant})
            assert status == 200
            usages.append(_usage_of(raw, body.get("stream", False)))
        after = json.loads(_http(srv.port, "/state")[1])
    finally:
        srv.stop()
    return usages, before, after


def test_replica_state_reconciles_with_its_responses(replica_run):
    usages, before, after = replica_run
    meters = [u["aigw_meter"] for u in usages]
    for u, m, (_p, body, tenant) in zip(usages, meters, CALLS):
        assert m["decode_tokens"] == u["completion_tokens"]
        assert m["prefill_real"] + m["prefix_reused"] \
            == u["prompt_tokens"] * (body.get("n") or 1)
        assert m["tenant"] == tenant and m["hbm_page_byte_s"] > 0
        assert m["segments"] == (body.get("n") or 1)
    for key, field in METER_TOTALS.items():
        assert after[key] - before[key] == sum(m[field] for m in meters)
    assert after["meter_records"] - before["meter_records"] == 7
    assert after["meter_hbm_page_byte_s"] - before[
        "meter_hbm_page_byte_s"] == pytest.approx(
        sum(m["hbm_page_byte_s"] for m in meters), abs=1e-5)
    # a repeated prompt's cached tokens come from the record
    assert usages[2]["prompt_tokens_details"]["cached_tokens"] \
        == meters[2]["prefix_reused"] > 0


def test_usage_ledger_folds_port_meters_like_reference(served, replica_run):
    """The reference UsageLedger fed each engine's records as its
    gateway reads them off a response (``extract_usage`` of the usage
    the server renders): per-tenant counts equal, no mismatch, and the
    ledger's residency total the port's records' sum."""
    from aigw_tpu.gateway.usage import UsageLedger
    from aigw_tpu.schemas import openai as joai
    from aigw_tpu.tpuserve import server as jserver
    from aigw_tpu_torch.tpuserve.server import TPUServeServer

    _n, got, want, _ts, _js = served
    ledgers = []
    for recs, usage_of in (
            ([r[0][0] for r in got],
             lambda rec: toai.usage_dict(TPUServeServer.usage_from_meter(
                 4, rec["decode_tokens"], rec))),
            ([r[0][0] for r in want],
             lambda rec: joai.usage_dict(
                 jserver.TPUServeServer._usage_from_meter(
                     None, 4, rec["decode_tokens"], rec)))):
        led = UsageLedger(window_s=3600.0)
        for rec in recs:
            usage = joai.extract_usage({"usage": usage_of(rec)})
            led.record(rec["tenant"], "tiny-random", usage, ts=1000.0)
        ledgers.append(led)
    q_port, q_ref = (led.query() for led in ledgers)
    strip = ("hbm_page_byte_s", "t0", "t1")
    assert {t: {k: v for k, v in agg.items() if k not in strip}
            for t, agg in q_port["tenants"].items()} \
        == {t: {k: v for k, v in agg.items() if k not in strip}
            for t, agg in q_ref["tenants"].items()}
    assert ledgers[0].reconcile_mismatches == 0
    assert q_port["totals"]["hbm_page_byte_s"] == pytest.approx(
        sum(r[0][0]["hbm_page_byte_s"] for r in got), abs=1e-5)
    # and a replica's responses, read by the same gateway code
    usages = replica_run[0]
    led = UsageLedger(window_s=3600.0)
    for u, (_p, _b, tenant) in zip(usages, CALLS):
        led.record(tenant, "tiny-random",
                   joai.extract_usage({"usage": u}), ts=1000.0)
    assert led.totals()["decode_tokens"] == sum(
        u["completion_tokens"] for u in usages)
    assert led.reconcile_mismatches == 0


def test_meter_fields_and_tuple_match_reference():
    from aigw_tpu.gateway import costs as jcosts

    rec = dict(BOXES[1])
    assert toai.meter_to_tuple(rec) == jcosts.meter_to_tuple(rec)
    assert set(toai.METER_FIELDS) == set(rec)
    meter_vars = jcosts.COST_VARIABLES[jcosts.COST_VARIABLES.index(
        "prefill_padded_tokens"):]
    assert len(meter_vars) == 8  # the cost expressions' meter surface


def test_zero_record_of_a_request_without_a_slot():
    """``_meter_zero``'s record (a request cancelled while queued, an
    unknown adapter, an abort) is all zeros with the request's identity,
    and it moves the counters like any record."""
    got = []
    eng = types.SimpleNamespace(stats=tengine.EngineStats())
    eng._meter_emit = lambda rec, sink: tengine.Engine._meter_emit(
        eng, rec, sink)
    req = tengine.GenRequest(prompt=[1], max_tokens=1,
                             sampling=TSampling(), tenant="t",
                             meter_sink=got.append)
    tengine.Engine._meter_zero(eng, req, "cancelled")
    assert got == [{"schema": 1, "finish": "cancelled", "prefill_real": 0,
                    "prefill_padded": 0, "prefix_reused": 0,
                    "decode_tokens": 0, "spec_drafted": 0,
                    "spec_accepted": 0, "hbm_page_byte_s": 0.0,
                    "host_page_byte_s": 0.0, "segments": 0, "tenant": "t",
                    "priority": "interactive"}]
    assert eng.stats.meter_records == 1


def test_schema_usage_dict_matches_reference():
    from aigw_tpu.gateway import costs as jcosts
    from aigw_tpu.schemas import openai as joai

    rec = dict(BOXES[2])
    t = toai.TokenUsage(3, 2, 5, 31, meter=toai.meter_to_tuple(rec))
    j = jcosts.TokenUsage(input_tokens=3, output_tokens=2, total_tokens=5,
                          cached_input_tokens=31,
                          meter=jcosts.meter_to_tuple(rec))
    assert toai.usage_dict(t) == joai.usage_dict(j)

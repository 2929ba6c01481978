"""The port's gateway modules held against the reference's on the CPU:
route matching and seeded backend selection, the circuit breaker under
a stepped clock, cost programs, usage-ledger windows, the endpoint
picker fed identical ``observe()`` sequences, config loading and its
refusals, typed request checks and mutators; and the port's
standard-library HTTP (``gateway/http.py``) on its own: framing,
keep-alive reuse, a pooled connection the upstream closed, the body
limit and an unbuffered relay."""

import asyncio
import json
import pathlib
import random
import subprocess
import sys
import types

import pytest

from aigw_tpu.config import model as jmodel
from aigw_tpu.config import runtime as jruntime
from aigw_tpu.gateway import circuit as jcircuit
from aigw_tpu.gateway import costs as jcosts
from aigw_tpu.gateway import fleetstate as jfleet
from aigw_tpu.gateway import mutators as jmut
from aigw_tpu.gateway import picker as jpicker
from aigw_tpu.gateway import router as jrouter
from aigw_tpu.gateway import usage as jusage
from aigw_tpu.obs import slomon as jslomon
from aigw_tpu.schemas import openai as joai
from aigw_tpu.schemas import typed as jtyped
from aigw_tpu_torch.config import model as tmodel
from aigw_tpu_torch.config import runtime as truntime
from aigw_tpu_torch.gateway import circuit as tcircuit
from aigw_tpu_torch.gateway import costs as tcosts
from aigw_tpu_torch.gateway import fleetstate as tfleet
from aigw_tpu_torch.gateway import http as thttp
from aigw_tpu_torch.gateway import mutators as tmut
from aigw_tpu_torch.gateway import picker as tpicker
from aigw_tpu_torch.gateway import router as trouter
from aigw_tpu_torch.gateway import usage as tusage
from aigw_tpu_torch.obs import slomon as tslomon
from aigw_tpu_torch.schemas import openai as toai
from aigw_tpu_torch.schemas import typed as ttyped

ROOT = pathlib.Path(__file__).resolve().parent.parent

# -- routing ------------------------------------------------------------------
ROUTING = {
    "version": "v1",
    "backends": [{"name": n, "schema": "OpenAI", "url": f"http://h/{n}"}
                 for n in ("a", "b", "c", "d", "e")],
    "routes": [
        {"name": "hosted", "hostnames": ["api.example.com"], "rules": [
            {"models": ["m-host"], "backends": ["e"]}]},
        {"name": "main", "rules": [
            {"models": ["m1"], "backends": [
                {"backend": "a", "weight": 3},
                {"backend": "b", "weight": 1},
                {"backend": "c", "weight": 2, "priority": 1},
                {"backend": "d", "weight": 0, "priority": 1}]},
            {"model_prefixes": ["llama"], "headers": [
                {"name": "x-tier", "value": "gold|silver", "regex": True}],
             "backends": [{"backend": "b", "weight": 5},
                          {"backend": "d", "weight": 5}]},
            {"model_prefixes": ["llama"], "backends": ["c"]},
            {"headers": [{"name": "x-team", "value": ""}],
             "backends": ["d", "e"]},
        ]},
    ],
}

ROUTE_CASES = [
    ("api.example.com", {}, "m-host"),
    ("other:8080", {}, "m-host"),
    ("h", {}, "m1"),
    ("h", {}, "m1:tenant-a"),
    ("h", {"x-tier": "gold"}, "llama-3-8b"),
    ("h", {"x-tier": "bronze"}, "llama-3-8b"),
    ("h", {}, "llama-3-8b:fr"),
    ("h", {"x-team": ""}, "other"),
    ("h", {}, "other"),
]


def _runtimes(raw):
    return (jruntime.RuntimeConfig.build(jmodel.Config.parse(raw)),
            truntime.RuntimeConfig.build(tmodel.Config.parse(raw)))


def _match(mod, rc, host, headers, model):
    hdr = {**headers, mod.MODEL_NAME_HEADER: model}
    try:
        m = (jrouter if mod is jmodel else trouter).match_route(
            rc, host, hdr)
    except (jrouter.NoRouteError, trouter.NoRouteError):
        return None
    return m.route.name, m.route.rules.index(m.rule), m.rule.to_dict()


@pytest.mark.parametrize("host,headers,model", ROUTE_CASES)
def test_match_route_matches_reference(host, headers, model):
    jrc, trc = _runtimes(ROUTING)
    assert _match(tmodel, trc, host, headers, model) == \
        _match(jmodel, jrc, host, headers, model)


@pytest.mark.parametrize("seed", range(4))
def test_seeded_backend_selection_matches_reference(seed):
    """Weighted picks within a tier, priority fallback, zero weights and
    open circuits (deferred to a second pass), over many draws."""
    jrc, trc = _runtimes(ROUTING)
    clock = [100.0]
    jcb = jcircuit.CircuitBreaker(threshold=1)
    tcb = tcircuit.CircuitBreaker(threshold=1, clock=lambda: clock[0])
    for cb in (jcb, tcb):
        cb.record_failure("b", now=clock[0])
    jrng, trng = random.Random(seed), random.Random(seed)
    for i in range(40):
        rule_j = jrc.config.routes[1].rules[i % 2]
        rule_t = trc.config.routes[1].rules[i % 2]
        circuit = (jcb, tcb) if i % 3 else (None, None)
        js = jrouter.BackendSelector(rule=rule_j, circuit=circuit[0],
                                     rng=jrng)
        ts = trouter.BackendSelector(rule=rule_t, circuit=circuit[1],
                                     rng=trng)
        if circuit[0] is not None:
            # the reference's breaker reads the real clock; pin it open
            jcb._states["b"].open_until = float("inf")
        seq_j, seq_t = [], []
        for sel, out in ((js, seq_j), (ts, seq_t)):
            while (ref := sel.next_backend()) is not None:
                out.append(ref.to_dict())
        assert seq_t == seq_j, i


def test_circuit_breaker_transitions_under_a_stepped_clock():
    clock = [0.0]
    jt, tt = [], []
    jcb = jcircuit.CircuitBreaker(
        threshold=3, cooldown=5.0,
        on_transition=lambda *a: jt.append(a))
    tcb = tcircuit.CircuitBreaker(
        threshold=3, cooldown=5.0, clock=lambda: clock[0],
        on_transition=lambda *a: tt.append(a))
    script = ["f", "f", "s", "f", "f", "f", "f", "t3", "f", "t6", "s",
              "f", "f", "f", "t20", "s", "s"]
    for op in script:
        if op.startswith("t"):
            clock[0] += float(op[1:])
        for cb in (jcb, tcb):
            if op == "f":
                cb.record_failure("k", now=clock[0])
            elif op == "s":
                cb.record_success("k")
        assert tcb.is_open("k") == jcb.is_open("k", now=clock[0]), op
        assert (tcb._states["k"].consecutive_failures
                == jcb._states["k"].consecutive_failures)
    assert tt == jt and len(tt) >= 4


# -- costs and the usage ledger -----------------------------------------------
EXPRESSIONS = [
    "input_tokens + 4 * output_tokens",
    "total_tokens if model == 'm' else 0",
    "max(decode_tokens, 1) + prefill_padded_tokens // 2",
    "int(kv_page_byte_seconds * 1e-6) + (10 if priority == 'batch' else 0)",
    "min(cached_input_tokens, 7) + reasoning_tokens",
    "spec_accepted_tokens * 2 + len_tokens if False else tenant == 'acme'",
]
METER = {"schema": 1, "finish": "stop", "prefill_real": 24,
         "prefill_padded": 32, "prefix_reused": 16, "decode_tokens": 7,
         "spec_drafted": 4, "spec_accepted": 3,
         "hbm_page_byte_s": 12345678.25, "host_page_byte_s": 0.5,
         "segments": 1, "tenant": "acme", "priority": "batch"}
USAGES = [
    dict(),
    dict(input_tokens=24, output_tokens=7, total_tokens=31),
    dict(input_tokens=24, output_tokens=7, total_tokens=31,
         cached_input_tokens=16, reasoning_tokens=2),
]


@pytest.mark.parametrize("expr", EXPRESSIONS)
def test_cost_programs_match_reference(expr):
    try:
        jprog = jcosts.CostProgram(expr)
    except jmodel.ConfigError as e:
        with pytest.raises(tmodel.ConfigError) as got:
            tcosts.CostProgram(expr)
        assert str(got.value) == str(e)
        return
    tprog = tcosts.CostProgram(expr)
    for u in USAGES:
        for meter in ((), jcosts.meter_to_tuple(METER)):
            for kw in (dict(model="m", tenant="acme"),
                       dict(model="x", backend="b", route_name="r")):
                assert tprog.evaluate(tcosts.TokenUsage(**u, meter=meter),
                                      **kw) == \
                    jprog.evaluate(jcosts.TokenUsage(**u, meter=meter), **kw)


def test_cost_calculators_match_reference():
    costs = [{"metadata_key": k, "type": t} for k, t in (
        ("in", "InputToken"), ("out", "OutputToken"), ("tot", "TotalToken"),
        ("cached", "CachedInputToken"), ("reason", "ReasoningToken"),
        ("create", "CacheCreationInputToken"))]
    costs.append({"metadata_key": "w", "type": "Expression",
                  "expression": EXPRESSIONS[0]})
    raw = {"version": "v1", "llm_request_costs": costs}
    jc = jcosts.CostCalculator.from_config(jmodel.Config.parse(raw))
    tc = tcosts.CostCalculator.from_config(tmodel.Config.parse(raw))
    for u in USAGES:
        assert tc.calculate(tcosts.TokenUsage(**u), model="m") == \
            jc.calculate(jcosts.TokenUsage(**u), model="m")


def test_usage_ledger_windows_match_reference(tmp_path):
    """Records over three windows, two tenants and two models, budgets
    and the burn machine; the journal replays to the same totals."""
    kw = dict(window_s=10.0, retain_windows=8, budgets={"acme": 20.0},
              burn_windows=2)
    jl = jusage.UsageLedger(str(tmp_path / "j.jsonl"), **kw)
    tl = tusage.UsageLedger(str(tmp_path / "t.jsonl"), **kw)
    rng = random.Random(0)
    for i in range(40):
        tenant = ("acme", "beta", "")[i % 3]
        model = ("m1", "m2")[i % 2]
        meter = dict(METER, decode_tokens=rng.randrange(1, 30),
                     hbm_page_byte_s=rng.random() * 1e6)
        u = dict(input_tokens=rng.randrange(1, 50),
                 output_tokens=meter["decode_tokens"],
                 total_tokens=0)
        u["total_tokens"] = u["input_tokens"] + u["output_tokens"]
        if i % 7 == 0:
            u["output_tokens"] += 1  # a reconcile mismatch
        ts = 1000.0 + i * 0.8
        cost = rng.randrange(0, 9)
        jl.record(tenant, model, jcosts.TokenUsage(
            **u, meter=jcosts.meter_to_tuple(meter)), cost, ts=ts)
        tl.record(tenant, model, tcosts.TokenUsage(
            **u, meter=tcosts.meter_to_tuple(meter)), cost, ts=ts)
    for args in ({}, {"tenant": "acme"}, {"model": "m2"},
                 {"since": 1010.0}):
        assert tl.query(**args) == jl.query(**args), args
    assert tl.snapshot() == jl.snapshot()
    assert tl.burn("acme") == jl.burn("acme")
    jl.close()
    tl.close()
    assert (tmp_path / "t.jsonl").read_text() == \
        (tmp_path / "j.jsonl").read_text()
    assert tusage.UsageLedger.replay(str(tmp_path / "t.jsonl"),
                                     **kw).totals() == tl.totals()


# -- the picker -----------------------------------------------------------------
ADDRS = ("10.0.0.1:8000", "10.0.0.2:8000", "10.0.0.3:8000")
PP = {"prefill": {"p50": 40.0, "p95": 90.0, "p99": 99.0},
      "ttft": {"p50": 60.0, "p95": 95.0, "p99": 99.0}}


class _Clock:
    def __init__(self):
        self.t = 1000.0

    def monotonic(self):
        return self.t

    def time(self):
        return 1.7e9 + self.t


def _pickers(monkeypatch, **kw):
    clock = _Clock()
    for mod in (jpicker, jfleet, jslomon):
        monkeypatch.setattr(mod, "time", clock)
    for mod in (tfleet, tslomon):
        monkeypatch.setattr(mod, "time", clock)
    eps = [{"address": a, "slice": "s0" if i < 2 else "s1"}
           for i, a in enumerate(ADDRS)]
    jp = jpicker.EndpointPicker([jpicker.Endpoint.parse(e) for e in eps],
                                **kw)
    tp = tpicker.EndpointPicker([tpicker.Endpoint.parse(e) for e in eps],
                                clock=clock.monotonic, **kw)
    return clock, jp, tp


def _both(jp, tp, fn):
    """Run ``fn`` on both pickers; results (or exception messages)."""
    out = []
    for p in (jp, tp):
        try:
            out.append(("ok", fn(p)))
        except Exception as e:  # noqa: BLE001
            out.append((type(e).__name__, str(e)))
    return out


OBS = [  # (address index, observe kwargs)
    (0, dict(kv_occupancy=0.2, queued=1, active_slots=3, max_slots=8,
             queue_wait_ms=20.0, phase_percentiles=PP, max_seq_len=4096,
             model="llama", adapters_registered=("fr", "de"),
             adapters_resident=("fr",), kv_chains=("c1",))),
    (1, dict(kv_occupancy=0.1, queued=0, active_slots=1, max_slots=8,
             phase_percentiles=PP, max_seq_len=2048,
             prefill_ms_per_token=0.05, kv_chains=("c2",))),
    (2, dict(kv_occupancy=0.6, queued=4, active_slots=8, max_slots=8,
             queue_wait_ms=300.0, hbm_frac=0.7, moe_expert_imbalance=1.6,
             phase_percentiles=PP, max_seq_len=8192,
             batch_queued=3, devices=({"memory_frac": 0.9,
                                       "kv_occupancy": 0.7},))),
]

PICKS = [
    {},
    {"x-aigw-session-affinity": "conv-1"},
    {"x-aigw-session-affinity": "conv-1"},
    {"x-aigw-prefix-hash": "p1"},
    {"x-aigw-prefix-hash": "p1"},
    {"x-aigw-adapter": "fr"},
    {"x-aigw-kv-chain": "c2"},
    {"x-aigw-priority": "batch"},
    {"x-aigw-prompt-tokens": "3000"},
    {"x-aigw-prompt-tokens": "9000"},
    {"x-aigw-session-affinity": "conv-2", "x-aigw-prefix-hash": "p1"},
]


def _script(clock, jp, tp, mode):
    """The same pick sequence over load, affinity, prefix, adapter, kv,
    batch and context headers; then a drained, a stale and a breaker-
    open replica; then no telemetry at all (round-robin)."""
    results = []

    def feed():
        for i, kw in OBS:
            for p in (jp, tp):
                p.observe(ADDRS[i], **kw)

    def run(tag):
        for h in PICKS:
            jx, tx = {}, {}
            r = _both(jp, tp, lambda p: p.pick(
                h, explain=jx if p is jp else tx))
            assert r[1] == r[0], (tag, h)
            assert tx == jx, (tag, h)
            results.append(r[0])
            clock.t += 0.25
        for chosen in ADDRS:
            h = {"x-aigw-kv-chain": "c1"}
            assert tp.kv_peers(chosen, h) == jp.kv_peers(chosen, h)

    feed()
    run("load")
    for p in (jp, tp):
        p.fleet.mark_draining(ADDRS[1])
        p.note_chain("p9", "c2")
    run("drained")
    for p in (jp, tp):
        p.fleet.mark_draining(ADDRS[1], False)
    clock.t += 11.0  # every replica's telemetry is stale now
    for p in (jp, tp):
        p.observe(ADDRS[2], **OBS[2][1])
    run("stale")
    clock.t += 11.0
    run("blind")
    feed()
    for p in (jp, tp):
        p.breaker = types.SimpleNamespace(
            is_open=lambda a: a == ADDRS[0])
    run("breaker")
    return results


@pytest.mark.parametrize("mode,slo", [("static", 0.0), ("slo", 0.0),
                                      ("slo", 70.0), ("slo", 30.0)])
def test_pickers_pick_alike(monkeypatch, mode, slo):
    clock, jp, tp = _pickers(monkeypatch, mode=mode, slo_ttft_ms=slo)
    results = _script(clock, jp, tp, mode)
    assert len({str(r) for r in results}) > 2  # the picks move
    fleet_j = jp.fleet.snapshot(jp.state)
    fleet_t = tp.fleet.snapshot(tp.state)
    assert fleet_t == fleet_j
    for a in ADDRS:
        assert tp.predicted_ttft_ms(tp.state[a], 100) == \
            jp.predicted_ttft_ms(jp.state[a], 100)


# -- config loading -------------------------------------------------------------
def test_inference_pool_example_loads_like_reference(tmp_path):
    """The one example that names only ported fields: its YAML and its
    JSON twin load into the reference's config; the runtime compiles."""
    path = ROOT / "examples" / "inference-pool" / "config.yaml"
    want = jmodel.load_config(str(path))
    twin = tmp_path / "config.json"
    twin.write_text(json.dumps(want.to_dict()))
    for src in (path, twin):
        got = tmodel.load_config(str(src))
        assert got.to_dict() == want.to_dict()
        assert got.checksum() == want.checksum()
    truntime.RuntimeConfig.build(got)


#: fields the port's config refused until its gateway carried them: their
#: cases below now load equal to the reference's instead
CARRIED = {"auth", "controller", "mcp", "migration", "quotas", "schema"}


@pytest.mark.parametrize("example,field", [
    ("basic", "auth"), ("mcp", "mcp"), ("provider-fallback", "auth"),
    ("token-ratelimit", "quotas")])
def test_out_of_scope_examples_raise_naming_the_field(example, field):
    """An example naming a field the port does not carry raises naming
    it; one whose field the port carries loads equal to the
    reference's."""
    path = ROOT / "examples" / example / "config.yaml"
    want = jmodel.load_config(str(path))  # the reference loads it
    if field in CARRIED:
        got = tmodel.load_config(str(path))
        assert got.to_dict() == want.to_dict()
        assert got.checksum() == want.checksum()
        truntime.RuntimeConfig.build(got)
        return
    with pytest.raises(tmodel.ConfigError, match=f"'{field}'"):
        tmodel.load_config(str(path))


BASE_BACKEND = {"name": "p", "schema": "TPUServe",
                "endpoints": ["127.0.0.1:1"]}
REFUSED = [
    ({"backends": [dict(BASE_BACKEND, schema="Anthropic")]}, "schema"),
    ({"backends": [dict(BASE_BACKEND,
                        schema={"name": "AWSBedrock"})]}, "schema"),
    ({"backends": [dict(BASE_BACKEND,
                        auth={"kind": "APIKey", "api_key": "k"})]}, "auth"),
    ({"backends": [dict(BASE_BACKEND,
                        controller={"min_replicas": 1})]}, "controller"),
    ({"backends": [dict(BASE_BACKEND, migration=True)]}, "migration"),
    ({"quotas": [{"name": "q", "metadata_key": "t", "limit": 1}]},
     "quotas"),
    ({"mcp": {"path": "/mcp"}}, "mcp"),
]


@pytest.mark.parametrize("extra,field", REFUSED,
                         ids=[f for _e, f in REFUSED])
def test_unported_fields_raise(extra, field, tmp_path):
    """A field the port does not carry raises naming it, parsed or
    loaded; one it carries (``CARRIED``) parses and loads to the
    reference's ``to_dict``."""
    raw = {"version": "v1", "backends": [BASE_BACKEND], **extra}
    path = tmp_path / "c.json"
    path.write_text(json.dumps(raw))
    if field in CARRIED:
        want = jmodel.Config.parse(raw).to_dict()
        assert tmodel.Config.parse(raw).to_dict() == want
        assert tmodel.load_config(str(path)).to_dict() == want
        return
    with pytest.raises(tmodel.ConfigError, match=f"'{field}'"):
        tmodel.Config.parse(raw)
    with pytest.raises(tmodel.ConfigError, match=f"'{field}'"):
        tmodel.load_config(str(path))


def test_ported_fields_pass_and_crd_manifests_are_refused(tmp_path):
    raw = {"version": "v1", "backends": [
        dict(BASE_BACKEND, auth={"kind": "None"}, migration=False,
             picker_mode="slo", slo_ttft_ms=500,
             header_mutation={"set": [{"name": "X-A", "value": "1"}]},
             body_mutation={"remove": ["user"]}),
        {"name": "o", "schema": {"name": "OpenAI", "version": "v1"},
         "url": "http://127.0.0.1:2"}],
        "usage": {"window_s": 5}}
    assert tmodel.Config.parse(raw).to_dict() == \
        jmodel.Config.parse(raw).to_dict()
    # a CRD manifest compiles as the reference compiles it
    crd = tmp_path / "crd.yaml"
    crd.write_text("apiVersion: aigateway.envoyproxy.io/v1alpha1\n"
                   "kind: AIGatewayRoute\nmetadata: {name: r}\n")
    assert tmodel.load_config(str(crd)).to_dict() == \
        jmodel.load_config(str(crd)).to_dict()


def test_yaml_without_pyyaml_names_it(tmp_path):
    """With ``yaml`` unimportable, a JSON config loads and a YAML one
    raises ConfigError naming pyyaml."""
    jpath = tmp_path / "c.json"
    jpath.write_text(json.dumps({"version": "v1", "backends": [
        BASE_BACKEND]}))
    code = (
        "import sys\n"
        "sys.modules['yaml'] = None\n"
        "from aigw_tpu_torch.config.model import load_config, ConfigError\n"
        f"assert load_config({str(jpath)!r}).backends[0].name == 'p'\n"
        "try:\n"
        f"    load_config({str(ROOT / 'examples/inference-pool/config.yaml')!r})\n"
        "except ConfigError as e:\n"
        "    assert 'pyyaml' in str(e), e\n"
        "else:\n"
        "    raise AssertionError('loaded YAML without pyyaml')\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


# -- typed checks and mutators --------------------------------------------------
CHAT = {"model": "m", "messages": [{"role": "user", "content": "hi"}]}
BAD_BODIES = [
    ("/v1/chat/completions", CHAT),
    ("/v1/chat/completions", dict(CHAT, temperature=3)),
    ("/v1/chat/completions", dict(CHAT, logprobs=1)),
    ("/v1/chat/completions", dict(CHAT, top_logprobs=21)),
    ("/v1/chat/completions", dict(CHAT, stream_options={})),
    ("/v1/chat/completions", dict(CHAT, tools=[{"type": "x"}])),
    ("/v1/chat/completions", dict(CHAT, tool_choice="required")),
    ("/v1/chat/completions", dict(CHAT, tool_choice={
        "type": "function", "function": {"name": "f"}})),
    ("/v1/chat/completions", dict(CHAT, messages=[
        {"role": "user", "content": [{"type": "bogus"}]}])),
    ("/v1/chat/completions", dict(CHAT, messages=[{"role": "tool"}])),
    ("/v1/chat/completions", dict(CHAT, response_format={"type": "x"})),
    ("/v1/chat/completions", dict(CHAT, thinking={"type": "enabled"})),
    ("/v1/chat/completions", dict(CHAT, n=0)),
    ("/v1/completions", {"model": "m", "prompt": "hi"}),
    ("/v1/completions", {"model": "m"}),
    ("/v1/completions", {"model": "m", "prompt": [], "n": 2}),
    ("/v1/completions", {"model": "m", "prompt": "x", "logprobs": 9}),
    ("/v1/completions", {"model": "m", "prompt": "x", "stop": [1]}),
    ("/v1/embeddings", {"model": "m", "input": "x"}),
    ("/v1/embeddings", {"model": "m"}),
    ("/v1/embeddings", {"model": "m", "input": "x", "messages": []}),
    ("/v1/embeddings", {"model": "m", "input": [{"content": 1}]}),
    ("/v1/embeddings", {"model": "m", "input": "x", "task_type": "Q"}),
]


@pytest.mark.parametrize("path,body", BAD_BODIES)
def test_typed_request_checks_match_reference(path, body):
    def run(typed, oai):
        try:
            oai.request_model(body)
            typed.validate_request(path, body)
        except oai.SchemaError as e:
            return str(e)
        return None

    assert run(ttyped, toai) == run(jtyped, joai)


def test_mutators_match_reference():
    raw = {"set": [{"name": "X-A", "value": "1"}], "remove": ["x-b"]}
    braw = {"set": [{"name": "k", "value": {"a": [1, 2]}}],
            "remove": ["user"]}
    for got, want in (
        (tmut.apply_header_mutation({"x-b": "2", "c": "3"},
                                    tmodel.HeaderMutation.parse(raw)),
         jmut.apply_header_mutation({"x-b": "2", "c": "3"},
                                    jmodel.HeaderMutation.parse(raw))),
        (tmut.apply_body_mutation(b'{"user": 1, "m": 2}',
                                  tmodel.BodyMutation.parse(braw)),
         jmut.apply_body_mutation(b'{"user": 1, "m": 2}',
                                  jmodel.BodyMutation.parse(braw))),
    ):
        assert got == want


# -- the standard-library HTTP --------------------------------------------------
def _run(coro):
    return asyncio.run(asyncio.wait_for(coro, 30))


async def _echo_server(**kw):
    async def echo(req):
        return thttp.json_response({"len": len(req.body),
                                    "q": req.query, "peer": req.remote})

    async def stream(req):
        out = thttp.StreamResponse(headers={"content-type": "text/plain"})
        await out.prepare(req)
        for i in range(3):
            await out.write(b"part%d;" % i)
            await asyncio.sleep(0.05)
        await out.write_eof()
        return out

    srv = thttp.HTTPServer({("POST", "/echo"): echo,
                            ("GET", "/stream"): stream}, **kw)
    return srv, await srv.start("127.0.0.1", 0)


def test_http_framing_keepalive_and_limits():
    async def main():
        srv, port = await _echo_server(client_max_size=1024)
        client = thttp.HTTPClient()
        base = f"http://127.0.0.1:{port}"
        try:
            r = await client.post(base + "/echo?a=1", data=b"x" * 100)
            assert r.status == 200 and (await r.json())["len"] == 100
            r.release()
            assert len(client._idle[("127.0.0.1", port, False)]) == 1
            r = await client.post(base + "/echo", data=b"y" * 10)
            body = await r.json()
            r.release()
            assert body["len"] == 10  # on the pooled connection
            assert len(client._idle[("127.0.0.1", port, False)]) == 1
            r = await client.post(base + "/echo", data=b"z" * 2048)
            assert r.status == 413
            await r.read()
            r.release()
            r = await client.get(base + "/nope")
            assert r.status == 404
            r.release()
            r = await client.get(base + "/echo")
            assert r.status == 405
            r.release()
            # a chunked request body, by hand, after a 100-continue
            reader, writer = await asyncio.open_connection("127.0.0.1", port)
            writer.write(b"POST /echo HTTP/1.1\r\nhost: x\r\n"
                         b"expect: 100-continue\r\n"
                         b"transfer-encoding: chunked\r\n\r\n")
            await writer.drain()
            assert await reader.readuntil(b"\r\n\r\n") == \
                b"HTTP/1.1 100 Continue\r\n\r\n"
            writer.write(b"3\r\nabc\r\n2\r\nde\r\n0\r\n\r\n")
            await writer.drain()
            head = await reader.readuntil(b"\r\n\r\n")
            n = int(thttp._parse_headers(
                head.split(b"\r\n")[1:])["content-length"])
            assert json.loads(await reader.readexactly(n))["len"] == 5
            writer.close()
        finally:
            client.close()
            await srv.stop()

    _run(main())


def test_http_stale_pooled_connection_is_replaced():
    """The upstream closes an idle pooled connection; the next request
    goes out again on a new one instead of failing."""
    async def main():
        srv, port = await _echo_server()
        client = thttp.HTTPClient()
        base = f"http://127.0.0.1:{port}"
        try:
            r = await client.post(base + "/echo", data=b"a")
            await r.read()
            r.release()
            for w in list(srv._conns):
                w.close()  # the server drops its idle keep-alive
            await asyncio.sleep(0.05)
            r = await client.post(base + "/echo", data=b"abc")
            assert (await r.json())["len"] == 3
            r.release()
            await srv.stop()
            with pytest.raises(thttp.ClientConnectionError):
                await client.post(base + "/echo", data=b"a")
        finally:
            client.close()

    _run(main())


def test_http_stream_arrives_unbuffered():
    """Each chunk of a streamed response reaches ``iter_any`` before the
    upstream writes the next one."""
    async def main():
        srv, port = await _echo_server()
        client = thttp.HTTPClient()
        try:
            r = await client.get(f"http://127.0.0.1:{port}/stream",
                                 timeout=thttp.Timeout(total=10,
                                                       sock_read=5))
            loop = asyncio.get_running_loop()
            seen = []
            async for piece in r.iter_any():
                seen.append((piece, loop.time()))
            r.release()
            assert b"".join(p for p, _t in seen) == b"part0;part1;part2;"
            assert len(seen) == 3
            assert seen[-1][1] - seen[0][1] >= 0.08
            r = await client.get(f"http://127.0.0.1:{port}/stream",
                                 timeout=thttp.Timeout(sock_read=0.01))
            with pytest.raises(asyncio.TimeoutError):
                await r.read()
            r.release()
        finally:
            client.close()
            await srv.stop()

    _run(main())

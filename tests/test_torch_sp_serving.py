"""Sequence-parallel serving: the port's engine and replica at ``sp = 2``
against the reference's ``Engine(mesh=make_mesh(MeshSpec(sp=...)))``.

The port's replica is two processes over gloo on the CPU: this test
process leads a ``TPUServeServer(sp=2)`` started once for the module,
whose follower process (``tpuserve/follower.py``) is rank 1; the later
cases build their engines on the same mesh (the follower drops each
engine when the leader stops it). The reference runs on the virtual
8-device CPU mesh ``tests/conftest.py`` sets, on the same float32
weights.

- The replica: a long prompt prefills as sp chunks; ``/state``'s five
  ``sp`` keys carry the reference engine's values after the same
  request; a page size the ``sp`` ranks do not divide and
  ``sp_prefill_mode="monolithic"`` route to the monolithic program (the
  mode says so), ``--sp`` on a family with no ``prefill_sp`` is refused
  with the reference's message, and ``dp > 1`` still is.
- Three ways (the port of the reference's
  ``test_three_way_byte_identical_mixed_features``): the chunked ``sp``
  engine, the monolithic one and the one-rank one stream identical
  tokens over greedy long prompts, a speculating slot, seeded sampling
  and penalties on sp-length prompts, a constrained slot and a partial
  prefix hit resumed in the chunk loop, and the same tokens as the
  reference's chunked ``sp = 8`` engine; the counters as there.
- Chunk-boundary admission (the port of
  ``test_interactive_admission_mid_prefill`` and
  ``test_interactive_stream_survives_long_install``): a short arrival
  queued while a long prompt prefills gets its first token first, and
  its slot survives the long prompt's install; the ranks' pools then
  agree byte for byte (``Engine.rank_page_digests``).
"""

import json
import re
import threading
import time
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aigw_tpu.models import llama as jllama
from aigw_tpu.parallel import MeshSpec as JMeshSpec
from aigw_tpu.parallel import make_mesh as jmake_mesh
from aigw_tpu.tpuserve import constrain as jconstrain
from aigw_tpu.tpuserve import engine as jengine
from aigw_tpu.tpuserve.sampling import SamplingParams as JSampling
from aigw_tpu.tpuserve.tokenizer import ByteTokenizer as JByteTokenizer
from aigw_tpu_torch.models import convert
from aigw_tpu_torch.models import llama as tllama
from aigw_tpu_torch.parallel import MeshSpec
from aigw_tpu_torch.tpuserve import constrain as tconstrain
from aigw_tpu_torch.tpuserve import engine as tengine
from aigw_tpu_torch.tpuserve.sampling import SamplingParams as TSampling
from aigw_tpu_torch.tpuserve.tokenizer import ByteTokenizer

#: the reference test's model: page_size 16 divides over sp 8 and 2
JCFG = jllama.LlamaConfig(vocab_size=512, dim=64, n_layers=2, n_heads=8,
                          n_kv_heads=8, ffn_dim=128, max_seq_len=256,
                          rope_theta=10000.0)
TCFG = tllama.LlamaConfig(vocab_size=512, dim=64, n_layers=2, n_heads=8,
                          n_kv_heads=8, ffn_dim=128, max_seq_len=256,
                          rope_theta=10000.0)
#: the reference test's geometry: prompts of 96 tokens or more take the
#: sp path in 64-token chunks
GEOM = dict(max_batch_size=4, max_seq_len=256, page_size=16,
            min_prefill_bucket=16, decode_steps_per_tick=4,
            kv_cache_dtype="float32", spec_tokens=4,
            adaptive_decode_window=False, sp_prefill_min_tokens=96,
            sp_chunk_tokens=64)
TOK = ByteTokenizer()
_RNG = np.random.RandomState(29)
PROMPTS = {L: _RNG.randint(1, 500, L).tolist()
           for L in (9, 24, 120, 150, 200)}
SP_KEYS = ("sp", "sp_prefill_mode", "sp_chunked_prefills",
           "sp_resume_prefills", "sp_interactive_admits")


@pytest.fixture(scope="module")
def weights():
    p = jllama.init_params(jax.random.PRNGKey(7), JCFG, jnp.float32)
    return p, convert.params_from_numpy(
        {k: np.asarray(v) for k, v in p.items()}, device="cpu")


@pytest.fixture(scope="module")
def tiny():
    p = jllama.init_params(jax.random.PRNGKey(0), jllama.TINY, jnp.float32)
    return p, convert.params_from_numpy(
        {k: np.asarray(v) for k, v in p.items()}, device="cpu")


@pytest.fixture(scope="module")
def server(tiny):
    """The module's ``sp = 2`` replica (tiny-random on float32 weights):
    its follower process is every case's rank 1."""
    from aigw_tpu_torch.tpuserve.server import TPUServeServer

    srv = TPUServeServer("tiny-random", tengine.EngineConfig(**GEOM),
                         device="cpu", port=0, params=tiny[1], sp=2)
    srv.start()
    yield srv
    srv.stop()


def _engine(srv, params, sp: bool, **over):
    """A port engine on the replica's mesh (``sp``) or on one rank."""
    srv.engine.stop()  # the follower drops the replica's engine
    return tengine.Engine(
        params, TCFG, tengine.EngineConfig(**{**GEOM, **over}),
        eos_token_ids=(TOK.eos_id,), device="cpu",
        mesh=srv.replica_mesh.mesh if sp else None)


def _burst(eng, req_cls, sp_cls, reqs, n=8):
    """Submit ``reqs`` ((prompt, sampling kwargs, constraint)) at once;
    their streams."""
    events, results = [], []
    for prompt, kw, cn in reqs:
        done = threading.Event()
        toks: list[int] = []

        def emit(t, f, toks=toks, done=done):
            if t >= 0:
                toks.append(t)
            if f is not None:
                done.set()

        eng.submit(req_cls(prompt=prompt, max_tokens=n,
                           sampling=sp_cls(**kw), emit=emit,
                           constraint=cn))
        events.append(done)
        results.append(toks)
    for e in events:
        assert e.wait(timeout=300)
    return results


def _fsm(mod, tok):
    schema = {"type": "object", "properties": {
        "t": {"type": "string", "maxLength": 8}},
        "required": ["t"], "additionalProperties": False}
    return mod.compile_constraint(
        tok, JCFG.vocab_size, (tok.eos_id,),
        mod.spec_for_response_format("json_schema", schema))


def _three_way_traffic(eng, req_cls, sp_cls, constraint):
    base = PROMPTS[200]
    resumed = base[:112] + PROMPTS[120]  # 7 pages adopted, 120 suffix
    rep = [5, 6, 7, 8] * 14
    first = _burst(eng, req_cls, sp_cls, [
        (base, dict(temperature=0.0), None),  # seeds the cache
        (rep, dict(temperature=0.0), None),  # speculating
        (PROMPTS[120], dict(temperature=0.8, top_p=0.9, seed=1234), None),
        (PROMPTS[150], dict(temperature=0.0, frequency_penalty=0.7),
         None),
    ])
    second = _burst(eng, req_cls, sp_cls, [
        (resumed, dict(temperature=0.0), None),  # a partial hit
        (TOK.encode("longctx json"), dict(temperature=0.0), constraint),
        (PROMPTS[9], dict(temperature=0.0), None),
        (PROMPTS[24], dict(temperature=0.0, logit_bias=((42, 3.0),)),
         None),
    ], n=16)
    return first + second


def _state(srv) -> dict:
    with urllib.request.urlopen(
            f"http://127.0.0.1:{srv.port}/state", timeout=30) as r:
        return json.loads(r.read())


# -- (vi) the replica ------------------------------------------------------------
def test_replica_state_sp_keys_are_the_references(server, tiny):
    """One long completion through the replica's HTTP route: chunked
    over both ranks; the five ``sp`` keys equal what the reference's
    server reports after the same request on its engine."""
    text = "".join(chr(97 + i % 26) for i in range(150))
    body = {"model": "tiny-random", "prompt": text, "max_tokens": 6,
            "temperature": 0.0}
    prompt = server.tokenizer.encode(body["prompt"])
    assert len(prompt) >= GEOM["sp_prefill_min_tokens"]
    req = urllib.request.Request(
        f"http://127.0.0.1:{server.port}/v1/completions",
        data=json.dumps(body).encode(),
        headers={"content-type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        assert json.loads(r.read())["usage"]["completion_tokens"] == 6
    got = _state(server)
    jeng = jengine.Engine(tiny[0], jllama.TINY,
                          jengine.EngineConfig(**GEOM),
                          eos_token_ids=(server.tokenizer.eos_id,),
                          mesh=jmake_mesh(JMeshSpec(sp=2)))
    jeng.start()
    try:
        _burst(jeng, jengine.GenRequest, JSampling,
               [(prompt, dict(temperature=0.0), None)], n=6)
    finally:
        jeng.stop()
    s = jeng.stats
    want = {"sp": jeng._sp,
            "sp_prefill_mode": "chunked"
            if jeng._prefill_sp_suffix_fn is not None else "monolithic",
            "sp_chunked_prefills": s.sp_chunked_prefills,
            "sp_resume_prefills": s.sp_resume_prefills,
            "sp_interactive_admits": s.sp_interactive_admits}
    assert {k: got[k] for k in SP_KEYS} == want
    assert want["sp"] == 2 and want["sp_chunked_prefills"] == 1
    assert got["mesh_axes"]["sp"] == 2 and got["mesh_devices"] == 2
    # the ranks hold whole weights: the pool and the weights are
    # replicated over sp
    per = list(got["param_bytes_per_device"].values())
    assert len(per) == 2 and per[0] == per[1] == server.engine.param_bytes


def test_routing_follows_the_references(server, weights):
    """The chunked program exists only in "chunked" mode with pages the
    sp ranks divide; otherwise the monolithic program serves (and
    ``sp_prefill_mode`` says which), as the reference builds them."""
    for over, mode in (({}, "chunked"),
                       ({"page_size": 15, "max_seq_len": 240},
                        "monolithic"),
                       ({"sp_prefill_mode": "monolithic"}, "monolithic")):
        jeng = jengine.Engine(weights[0], JCFG,
                              jengine.EngineConfig(**{**GEOM, **over}),
                              mesh=jmake_mesh(JMeshSpec(sp=2)))
        teng = _engine(server, weights[1], True, **over)
        try:
            for eng in (jeng, teng):
                got = ("chunked" if eng._prefill_sp_suffix_fn is not None
                       else "monolithic" if eng._prefill_sp_fn is not None
                       else "off")
                assert got == mode, (over, eng)
        finally:
            teng.stop()
    one = tengine.Engine(weights[1], TCFG, tengine.EngineConfig(**GEOM),
                         device="cpu")
    assert one._sp == 1 and one._prefill_sp_fn is None
    assert one._prefill_sp_suffix_fn is None
    # the tail rung of an sp chunk divides over sp; the ladder's own
    # intermediate rungs stay
    assert [one._prefill_bucket(n, multiple_of=3) for n in (10, 20, 40)] \
        == [18, 24, 48]
    assert [one._prefill_bucket(n) for n in (10, 20, 40)] == [16, 24, 48]


def test_config_and_stats_fields_are_the_references():
    """With the sp knobs and counters ported, the port's EngineConfig
    and EngineStats have every field of the reference's, with its
    defaults, and nothing is left unported."""
    import dataclasses

    for cls in ("EngineConfig", "EngineStats"):
        ref = {f.name: f.default for f in dataclasses.fields(
            getattr(jengine, cls))}
        port = {f.name: f.default for f in dataclasses.fields(
            getattr(tengine, cls))}
        assert set(ref) <= set(port), set(ref) - set(port)
        if cls == "EngineConfig":
            assert port == ref
    assert tengine.NOT_PORTED == {} and tengine.DEFAULTS_DIFFER == {}
    cfg = tengine.EngineConfig()
    assert (cfg.sp_prefill_min_tokens, cfg.sp_prefill_mode,
            cfg.sp_chunk_tokens) == (1024, "chunked", 2048)


def test_refusals_are_the_references(monkeypatch):
    from aigw_tpu_torch.models import registry
    from aigw_tpu_torch.parallel import make_mesh
    from aigw_tpu_torch.tpuserve import server as tserver

    real = registry.family_fns

    def no_sp(family):
        import dataclasses

        return dataclasses.replace(real(family), prefill_sp=None)

    monkeypatch.setattr(tserver, "family_fns", no_sp)
    with pytest.raises(ValueError, match=re.escape(
            "--sp requires a model family with a sequence-parallel "
            "prefill; 'llama' has none (devices on the sp axis would sit "
            "idle)")):
        tserver.TPUServeServer("tiny-random", tengine.EngineConfig(),
                               device="cpu", port=0, sp=2)
    with pytest.raises(NotImplementedError, match="dp=2"):
        make_mesh(MeshSpec(dp=2), device="cpu")


# -- (iv) three ways ----------------------------------------------------------------
def test_three_way_streams_match_reference(server, weights):
    """The chunked-sp, monolithic-sp and one-rank engines stream
    identical tokens over the mixed-feature traffic, and the same tokens
    as the reference's chunked sp = 8 engine; zero state rebuilds."""
    jeng = jengine.Engine(weights[0], JCFG, jengine.EngineConfig(**GEOM),
                          eos_token_ids=(TOK.eos_id,),
                          mesh=jmake_mesh(JMeshSpec(sp=8)))
    jeng.start()
    try:
        want = _three_way_traffic(jeng, jengine.GenRequest, JSampling,
                                  _fsm(jconstrain, JByteTokenizer()))
    finally:
        jeng.stop()
    assert jeng.stats.sp_chunked_prefills >= 3
    out, stats = {}, {}
    for name, sp, over in (("chunked", True, {}),
                           ("mono", True,
                            {"sp_prefill_mode": "monolithic"}),
                           ("single", False, {})):
        eng = _engine(server, weights[1], sp, **over)
        eng.start()
        try:
            out[name] = _three_way_traffic(eng, tengine.GenRequest,
                                           TSampling, _fsm(tconstrain, TOK))
            assert eng.healthy, eng.last_error
        finally:
            eng.stop()
        st = stats[name] = eng.stats
        assert st.prefix_cache_hits >= 1, "resume not taken"
        assert st.spec_drafted > 0
        assert st.state_rebuilds == 0
    assert out["chunked"] == out["single"] == want
    assert out["mono"] == out["single"]
    ch = stats["chunked"]
    assert ch.sp_chunked_prefills == jeng.stats.sp_chunked_prefills >= 3
    assert ch.sp_resume_prefills == jeng.stats.sp_resume_prefills >= 1
    assert ch.sp_prefills == ch.sp_chunked_prefills
    assert ch.chunked_prefill_steps > 0
    mono = stats["mono"]
    assert mono.sp_prefills >= 1 and mono.sp_chunked_prefills == 0
    assert stats["single"].sp_prefills == 0


# -- (v) chunk-boundary admission ------------------------------------------------------
def _hooked(eng):
    """Pause the engine thread at the first chunk boundary until the
    short request is queued (the reference test's hook)."""
    orig = eng._admit_interactive
    at_boundary, short_queued = threading.Event(), threading.Event()

    def hooked():
        if not at_boundary.is_set():
            at_boundary.set()
            short_queued.wait(timeout=30)
        return orig()

    eng._admit_interactive = hooked
    return at_boundary, short_queued


def test_interactive_admission_mid_prefill(server, weights):
    """A short arrival queued while a long chunked-sp prefill runs is
    admitted at a chunk boundary and streams its first token before the
    long prompt's; its 32 new tokens outlast the long prompt's install,
    so its slot must survive it (the reservation)."""
    eng = _engine(server, weights[1], True)
    at_boundary, short_queued = _hooked(eng)
    times: dict[str, float] = {}
    toks: dict[str, list] = {"long": [], "short": []}
    done = {"long": threading.Event(), "short": threading.Event()}

    def emit_for(name):
        def emit(t, f):
            if t >= 0:
                times.setdefault(name, time.monotonic())
                toks[name].append(t)
            if f is not None:
                done[name].set()
        return emit

    eng.start()
    try:
        eng.submit(tengine.GenRequest(
            prompt=PROMPTS[200], max_tokens=8,
            sampling=TSampling(temperature=0.0), emit=emit_for("long")))
        assert at_boundary.wait(timeout=60), "chunk loop never ticked"
        eng.submit(tengine.GenRequest(
            prompt=PROMPTS[24], max_tokens=32,
            sampling=TSampling(temperature=0.0), emit=emit_for("short")))
        short_queued.set()
        assert done["short"].wait(timeout=120), "short stream orphaned"
        assert done["long"].wait(timeout=120)
        # the ranks' replicas of the pool agree byte for byte
        digests = eng.rank_page_digests(list(range(eng.cfg.num_pages)))
        assert len(digests) == 2 and digests[0] == digests[1]
    finally:
        eng.stop()
    assert eng.healthy, eng.last_error
    assert eng.stats.sp_interactive_admits >= 1
    assert times["short"] < times["long"], times
    assert len(toks["long"]) == 8
    assert len(toks["short"]) == 32

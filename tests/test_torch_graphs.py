"""The port's compiled programs and warm-up against the reference's.

The reference compiles each decode window and prefill geometry with
``jax.jit`` and warms them in ``Engine.warmup``; the port captures a
CUDA graph per key (``tpuserve/programs.py``) and warms the same
surface. On the CPU a program runs its body eagerly but is keyed and
registered all the same, so these tests see the card's program surface:

- the warm surface equals the reference's for the same config: the
  warm page buckets (``_warm_page_buckets``, several geometries), the
  prompt-bucket rungs (``_bucket_rungs``), the prefill shapes the two
  backends' ``warm`` cover (the reference's walk recorded by running its
  ``warm`` over recording program stand-ins, no compile), and the
  decode programs per ``decode[k,lean,d]`` family, projected from the
  port's extra key parts, against one real reference warm-up;
- the reference's zero-compile tripwires, ported: after ``warmup()`` a
  burst inside the warmed geometry adds no program
  (``compiles_since(cp) == 0``) on the fused rung with speculation, the
  default programs, the prefix cache, constrained decoding and Mixtral,
  and a burst outside it adds some;
- ``/state`` and ``/metrics`` carry ``warm_programs``, ``xla_compiles``
  and ``xla_compile_ms``;
- the pieces: the tracker's arithmetic, launch counting during a
  capture, the decode state allocated once, the pool's identity, and
  ``warmup()`` refused on a running engine.

The streams of a warmed engine against the reference engine's are
``test_streams_at_warm_settings_match_reference`` in
``tests/test_torch_engine.py``.
"""

import json
import threading
import types
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aigw_tpu.models import llama as jllama
from aigw_tpu.obs.xla_events import CompileTracker as JCompileTracker
from aigw_tpu.tpuserve import attention as jattention
from aigw_tpu.tpuserve import engine as jengine
from aigw_tpu_torch.models import llama as tllama
from aigw_tpu_torch.models import mixtral as tmixtral
from aigw_tpu_torch.models.registry import family_fns
from aigw_tpu_torch.obs import metrics as tmetrics
from aigw_tpu_torch.obs.graph_events import CompileTracker
from aigw_tpu_torch.ops import _build
from aigw_tpu_torch.tpuserve import constrain as tc
from aigw_tpu_torch.tpuserve import engine as tengine
from aigw_tpu_torch.tpuserve.programs import (
    CapturedProgram,
    ProgramFamily,
    ProgramPool,
)
from aigw_tpu_torch.tpuserve.sampling import SamplingParams
from aigw_tpu_torch.tpuserve.tokenizer import ByteTokenizer

EOS = (257,)
#: the tiny geometry every engine here uses: 8 pages of 16 tokens
GEOM = dict(max_batch_size=2, max_seq_len=128, page_size=16,
            kv_cache_dtype="float32", ragged_chunk_tokens=16,
            ragged_max_chunks=2)
KERNEL_PATH = dict(attention_backend="pallas-ragged",
                   decode_backend="fused")
WARM = dict(warm_prefill_buckets=2, warm_decode_buckets=3)


@pytest.fixture(scope="module")
def params():
    return tllama.init_params(0, tllama.TINY, torch.float32, device="cpu")


def _engine(params, model_cfg=tllama.TINY, fns=None, **kw):
    cfg = tengine.EngineConfig(**{**GEOM, **kw})
    return tengine.Engine(params, model_cfg, cfg, eos_token_ids=EOS,
                          fns=fns, device="cpu")


# -- the warm surface against the reference ------------------------------
@pytest.mark.parametrize("n,max_seq_len,page_size", [
    (0, 128, 16), (1, 128, 16), (2, 128, 16), (3, 128, 16), (4, 128, 16),
    (5, 128, 16), (3, 48, 16), (6, 2048, 128)])
def test_warm_page_buckets_match_reference(n, max_seq_len, page_size):
    geom = dict(max_seq_len=max_seq_len, page_size=page_size,
                warm_decode_buckets=n)
    ref = types.SimpleNamespace(cfg=jengine.EngineConfig(**geom),
                                _decode_bucket_pages=lambda: 1)
    port = types.SimpleNamespace(cfg=tengine.EngineConfig(**geom),
                                 _decode_bucket_pages=lambda: 1)
    want = jengine.Engine._warm_page_buckets(ref)
    assert tengine.Engine._warm_page_buckets(port) == want


@pytest.mark.parametrize("rungs", [1, 2, 4])
@pytest.mark.parametrize("min_bucket,max_seq_len", [(64, 2048), (16, 208)])
def test_bucket_rungs_match_reference(rungs, min_bucket, max_seq_len):
    geom = dict(min_prefill_bucket=min_bucket, max_seq_len=max_seq_len,
                page_size=16, prefill_bucket_rungs=rungs)
    ref = types.SimpleNamespace(cfg=jengine.EngineConfig(**geom))
    port = types.SimpleNamespace(cfg=tengine.EngineConfig(**geom))
    for octave in range(6):
        assert tengine.Engine._bucket_rungs(port, octave) == \
            jengine.Engine._bucket_rungs(ref, octave)


def _reference_prefill_surface(backend: str, **geom) -> set:
    """The shapes the reference backend's ``warm`` runs, recorded: its
    own ``warm`` (and ``_warm_prefill_shapes``) over stand-ins of the
    compiled programs that record the token shape."""
    cfg = jengine.EngineConfig(**geom)
    seen = set()

    def record(params, lora, tokens, *rest):
        seen.add(tuple(tokens.shape))
        return None, None, None

    eng = types.SimpleNamespace(
        cfg=cfg, model_cfg=jllama.TINY, params=None, lora_params=None,
        kv_cache=None, _base_row=0, _prefill_fn=record,
        _prefill_ragged_fn=record)
    eng._bucket_rungs = lambda o: jengine.Engine._bucket_rungs(eng, o)
    eng._warm_prefill_shapes = (
        lambda S: jengine.Engine._warm_prefill_shapes(eng, S))
    if backend == "xla-bucketed":
        jattention.XlaBucketedBackend.warm(types.SimpleNamespace(eng=eng))
        return seen
    be = types.SimpleNamespace(eng=eng)
    be.budget = jattention.RaggedPrefillBackend.budget.fget(be)
    be.rungs = lambda: jattention.RaggedPrefillBackend.rungs(be)
    jattention.RaggedPrefillBackend.warm(be)
    return seen


def _port_prefill_surface(eng, name: str) -> set:
    """The token shape of every program in the port's prefill family
    ``name`` (keys are (adapters, input shapes); the tokens come
    first)."""
    fam = eng.compile_tracker._fns[name]
    return {key[1][0][0] for key in fam}


@pytest.mark.parametrize("backend,geom", [
    ("xla-bucketed", dict(warm_prefill_buckets=1)),
    ("xla-bucketed", dict(warm_prefill_buckets=2)),
    ("xla-bucketed", dict(warm_prefill_buckets=3, prefill_bucket_rungs=4,
                          min_prefill_bucket=16)),
    ("xla-bucketed", dict(warm_prefill_buckets=4, min_prefill_bucket=16,
                          max_seq_len=208, prefill_bucket_rungs=1)),
    ("pallas-ragged", dict(warm_prefill_buckets=1)),
    ("pallas-ragged", dict(warm_prefill_buckets=1, ragged_chunk_tokens=32,
                           ragged_max_chunks=3)),
    ("pallas-ragged", dict(warm_prefill_buckets=0)),
])
def test_prefill_warm_shapes_match_reference(params, backend, geom):
    geom = {**GEOM, "max_batch_size": 4, "adaptive_decode_window": False,
            "decode_steps_per_tick": 1, **geom}
    if geom["max_seq_len"] % geom["page_size"]:
        geom["page_size"] = 16
    want = _reference_prefill_surface(
        backend, **{k: v for k, v in geom.items()
                    if k != "kv_cache_dtype"},
        attention_backend=backend)
    eng = _engine(params, attention_backend=backend, **geom)
    eng.warmup()
    name = "prefill" if backend == "xla-bucketed" else "prefill_ragged"
    got = _port_prefill_surface(eng, name)
    # the bucketed keys are (G2, S) token shapes, the ragged ones (T,)
    assert got == want and (want or geom["warm_prefill_buckets"] == 0)
    assert eng.stats.warm_programs == eng.compile_tracker.program_count()


#: the config of the one real reference warm-up: a speculative ladder
#: (rungs 0 and 2) at two page buckets, one window length
DECODE_GEOM = dict(max_batch_size=2, max_seq_len=64, page_size=16,
                   kv_cache_dtype="float32", decode_backend="fused",
                   adaptive_decode_window=False, decode_steps_per_tick=2,
                   spec_tokens=2, spec_adaptive=False,
                   warm_decode_buckets=2, enable_prefix_cache=False)


@pytest.fixture(scope="module")
def reference_warm():
    """One reference warm-up: its compiled programs per family."""
    jp = jllama.init_params(jax.random.PRNGKey(0), jllama.TINY,
                            dtype=jnp.float32)
    eng = jengine.Engine(jp, jllama.TINY, jengine.EngineConfig(
        **DECODE_GEOM), eos_token_ids=EOS)
    eng.warmup()
    return eng.compile_tracker.programs(), eng.stats.warm_programs


def _project(programs: dict) -> dict:
    """The port's decode families onto the reference's names: the page
    buckets of every port family with the same (k, lean, d), whatever
    its greedy and adapter parts."""
    out: dict = {}
    for name, fam in programs.items():
        if name.startswith("decode["):
            k, lean, d = name[len("decode["):-1].split(",")[:3]
            out.setdefault(f"decode[{k},{lean},{d}]", set()).update(fam)
    return out


def test_decode_programs_match_reference(params, reference_warm):
    want, _ = reference_warm
    eng = tengine.Engine(params, tllama.TINY, tengine.EngineConfig(
        **DECODE_GEOM), eos_token_ids=EOS, device="cpu")
    eng.warmup()
    fams = {name: p for name, p in eng.compile_tracker._fns.items()
            if name.startswith("decode[")}
    got = _project(fams)
    assert {n: len(p) for n, p in got.items()} == {
        n: c for n, c in want.items() if n.startswith("decode[")}
    # every port variant (greedy and sampled) holds every warm bucket
    buckets = set(eng._warm_page_buckets())
    assert all(set(p) == buckets for p in fams.values())
    assert len(fams) == 2 * sum(n.startswith("decode[") for n in want)
    # prefill programs: neither side warms any without the prefill knob
    assert want["prefill"] == want["prefill_ragged"] == 0
    assert eng.compile_tracker.programs()["prefill_ragged"] == 0


# -- the zero-compile tripwires -------------------------------------------
def _burst(eng, items, timeout=120):
    """Serve ``items`` ((prompt, max_tokens, sampling kwargs[, constraint]))
    as one burst on a started engine; returns the streams."""
    out = [[] for _ in items]
    done = [threading.Event() for _ in items]
    reqs = []
    for i, (prompt, max_tokens, kw, *cn) in enumerate(items):
        def emit(t, f, i=i):
            if t >= 0:
                out[i].append(t)
            if f is not None:
                done[i].set()
        reqs.append(tengine.GenRequest(
            prompt=prompt, max_tokens=max_tokens,
            sampling=SamplingParams(**kw), emit=emit,
            constraint=cn[0] if cn else None))
    for r in reqs:
        eng.submit(r)
    assert all(d.wait(timeout) for d in done)
    assert eng.healthy, eng.last_error
    return out


def _prompts(seed, lens, shared=()):
    rng = np.random.default_rng(seed)
    return [list(shared) + rng.integers(0, 256, n).tolist() for n in lens]


def _mix(prompts, max_tokens=16):
    """Greedy, seeded, top-k and penalized requests over ``prompts``."""
    kws = [dict(temperature=0.0), dict(temperature=0.8, top_k=20, seed=11),
           dict(temperature=0.0, logit_bias=((7, 100.0),)),
           dict(temperature=1.0, top_p=0.9, seed=5, frequency_penalty=0.5)]
    return [(p, max_tokens, kws[i % len(kws)]) for i, p in enumerate(prompts)]


def _fsm(kind):
    tok = ByteTokenizer()
    spec = (tc.spec_for_response_format("json_object", None)
            if kind == "json_object" else tc.spec_for_response_format(
                "json_schema", {"type": "object", "properties": {
                    "n": {"type": "integer"}}, "required": ["n"],
                    "additionalProperties": False}))
    return tc.compile_constraint(tok, tllama.TINY.vocab_size, EOS, spec)


SHARED = np.random.default_rng(7).integers(0, 256, 32).tolist()

#: case → (engine kwargs, model, the bursts served in turn under the wire,
#: each sequence at most 64 tokens: the warm page buckets 1, 2 and 4)
TRIPWIRES = {
    "fused_spec": (dict(KERNEL_PATH, spec_tokens=3, spec_adaptive=False,
                        enable_prefix_cache=False), "llama",
                   lambda: [_mix(_prompts(1, (3, 17, 9, 30)))]),
    "defaults": (dict(enable_prefix_cache=False), "llama",
                 lambda: [_mix(_prompts(2, (5, 30, 12, 40)))]),
    # the second burst resumes every prompt behind the cached pages
    "prefix_cache": (dict(KERNEL_PATH), "llama", lambda: [
        _mix(_prompts(3, (4, 9), SHARED)),
        _mix(_prompts(4, (6, 2, 11), SHARED))]),
    "constrained": (dict(KERNEL_PATH, enable_prefix_cache=False), "llama",
                    lambda: [[
                        (_prompts(5, (6,))[0], 24, dict(temperature=0.0),
                         _fsm("json_object")),
                        (_prompts(6, (9,))[0], 24,
                         dict(temperature=0.7, seed=3), _fsm("schema")),
                        *_mix(_prompts(7, (12,)))]]),
    "mixtral": (dict(KERNEL_PATH, enable_prefix_cache=False), "mixtral",
                lambda: [_mix(_prompts(8, (3, 17, 9, 30)))]),
}


@pytest.mark.parametrize("case", list(TRIPWIRES))
def test_no_program_after_warmup_inside_the_warmed_geometry(params, case):
    kw, family, bursts = TRIPWIRES[case]
    if family == "mixtral":
        eng = _engine(tmixtral.init_params(7, tmixtral.TINY_MOE,
                                           torch.float32, device="cpu"),
                      tmixtral.TINY_MOE, family_fns("mixtral"),
                      **kw, **WARM)
    else:
        eng = _engine(params, **kw, **WARM)
    eng.warmup()
    cp = eng.compile_tracker.checkpoint()
    assert cp[0] == eng.stats.warm_programs > 0
    eng.start()
    try:
        for items in bursts():
            assert all(_burst(eng, items))
        assert eng.compile_tracker.compiles_since(cp) == 0, (
            case, eng.compile_tracker.programs())
        assert eng.compile_tracker.compiles() == cp[1]
        assert eng.stats.state_rebuilds == 0
    finally:
        eng.stop()
    if case == "prefix_cache":
        assert eng.stats.prefix_cache_hits >= 3


@pytest.mark.parametrize("what", ["page_bucket", "prefill_bucket"])
def test_a_burst_outside_the_warmed_geometry_adds_programs(params, what):
    if what == "page_bucket":
        # one warm page bucket (16 tokens): a 40-token sequence needs 4
        eng = _engine(params, **KERNEL_PATH, enable_prefix_cache=False,
                      warm_decode_buckets=1, warm_prefill_buckets=1)
        items = _mix(_prompts(9, (30,)), max_tokens=10)
    else:
        # one warm octave (S 64, 96): a 100-token prompt takes S 128
        eng = _engine(params, enable_prefix_cache=False,
                      prefill_chunk_tokens=0, warm_decode_buckets=4,
                      warm_prefill_buckets=1)
        items = _mix(_prompts(9, (100,)), max_tokens=4)
    eng.warmup()
    cp = eng.compile_tracker.checkpoint()
    eng.start()
    try:
        _burst(eng, items)
    finally:
        eng.stop()
    grew = eng.compile_tracker.programs()
    assert eng.compile_tracker.compiles_since(cp) > 0
    assert eng.stats.xla_compiles > cp[1]
    if what == "page_bucket":
        assert any(4 in p for n, p in eng.compile_tracker._fns.items()
                   if n.startswith("decode[")), grew
    else:
        assert ((1, 128), torch.int32) in {
            key[1][0] for key in eng.compile_tracker._fns["prefill"]}


# -- /state and /metrics ----------------------------------------------------
def _http(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=60) as r:
        return r.read().decode()


def test_state_and_metrics_carry_the_warm_gauges():
    from aigw_tpu_torch.tpuserve.server import TPUServeServer

    srv = TPUServeServer("tiny-random", tengine.EngineConfig(
        max_seq_len=256, page_size=16, **KERNEL_PATH, **WARM),
        device="cpu", port=0)
    srv.start()
    try:
        state = json.loads(_http(srv.port, "/state"))
        eng = srv.engine
        assert state["warm_programs"] == eng.stats.warm_programs \
            == eng.compile_tracker.program_count() > 0
        assert state["xla_compiles"] == eng.compile_tracker.compiles() \
            == state["warm_programs"]
        assert state["xla_compile_ms"] == 0.0  # the CPU captures nothing
        assert state["warmup_ms"] > 0
        text = _http(srv.port, "/metrics")
        lines = text.splitlines()
        for attr in ("warm_programs", "xla_compiles", "xla_compile_ms"):
            assert attr not in tmetrics.GAUGES_NOT_PORTED
            name = dict(tmetrics.ENGINE_GAUGES)[attr]
            assert f"# TYPE {name} gauge" in lines
            assert f"{name} {state[attr]}" in lines
    finally:
        srv.stop()


# -- the pieces -------------------------------------------------------------
def test_tracker_keeps_the_references_method_names_and_arithmetic():
    names = ("register", "programs", "program_count", "compiles",
             "compiles_total_ms", "checkpoint", "compiles_since",
             "snapshot")
    assert all(callable(getattr(JCompileTracker, n)) for n in names)
    assert all(callable(getattr(CompileTracker, n)) for n in names)
    tr = CompileTracker()
    a = tr.register("a", {})
    b = tr.register("b", {1: None})
    cp = tr.checkpoint()
    assert tr.programs() == {"a": 0, "b": 1} and cp == (1, 0)
    a[1] = a[2] = None
    tr.note_compile(2.5)
    tr.note_compile(0.25)
    assert tr.compiles_since(cp) == 2 and tr.compiles() == 2
    assert tr.snapshot() == {"xla_compiles": 2, "xla_compile_ms": 2.75,
                             "programs": {"a": 2, "b": 1}}
    # two engines never see each other's counts
    assert CompileTracker().compiles() == 0


def test_cpu_program_runs_its_body_and_counts_one_build():
    tr = CompileTracker()
    pool = ProgramPool(torch.device("cpu"), tr)
    calls = []
    fam = tr.register("f", ProgramFamily(
        lambda key: lambda x: calls.append(key) or x * key, pool))
    prog = fam.program(3)
    assert isinstance(prog, CapturedProgram) and fam.program(3) is prog
    for v in (1.0, 2.0):
        assert prog(torch.tensor(v)).item() == 3 * v
    assert calls == [3, 3] and tr.compiles() == 1 and pool.bytes() == 0
    assert prog.graph is None and tr.programs() == {"f": 1}


def test_launches_during_a_capture_go_to_its_tally():
    def fn():
        pass

    fn.launches, fn.launches_int8 = 5, 0
    with _build.capture_tally() as tally:
        _build.count_launch(fn)
        _build.count_launch(fn)
        _build.count_launch(fn, "launches_int8")
    assert (fn.launches, fn.launches_int8) == (5, 0)
    assert tally == {(fn, "launches"): 2, (fn, "launches_int8"): 1}
    _build.count_launch(fn)
    assert fn.launches == 6


def test_decode_state_is_allocated_once_and_the_pool_kept(params):
    eng = _engine(params, **KERNEL_PATH, enable_prefix_cache=False)
    eng.warmup()
    ptrs = {k: v.data_ptr() for k, v in eng._state.items()}
    pool = eng.kv_cache
    eng.start()
    try:
        for seed in (10, 11):  # two busy periods: a rebuild each
            _burst(eng, _mix(_prompts(seed, (5, 20)), max_tokens=6))
            while eng._inflight is not None or eng._device_state is not None:
                threading.Event().wait(0.01)
    finally:
        eng.stop()
    assert {k: v.data_ptr() for k, v in eng._state.items()} == ptrs
    assert eng.kv_cache is pool
    # a model entry point that returned another pool is refused
    with pytest.raises(RuntimeError, match="another KV pool"):
        eng._model(lambda p, c, *a, **kw: (None, pool.clone()))


def test_warmup_runs_before_the_engine_starts(params):
    eng = _engine(params)
    eng.start()
    try:
        with pytest.raises(RuntimeError, match="before the engine starts"):
            eng.warmup()
    finally:
        eng.stop()

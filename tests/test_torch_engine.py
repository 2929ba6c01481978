"""Whole-engine streams: the port's engine against the JAX package's.

Both engines run on the CPU with the reference's
``init_params(PRNGKey(0), TINY, float32)`` weights (carried across by
``aigw_tpu_torch.models.convert``), a float32 KV pool, the ragged prefill
backend and the fused decode rung, and serve the same batch of
mixed-length prompts, larger than ``max_batch_size`` so admission
queues, with greedy, seeded, top-k/top-p and penalized requests. On the
CPU the reference resolves to its XLA rungs (the windowed ragged prefill
and ``fused-xla``; its own tests hold those equal to its Pallas kernels),
the port to its kernels' plain versions. The streams must be identical
token for token; a greedy divergence is accepted only at a near-tie
(top-2 logit gap under 1e-4 in the reference model, the tie-aware rule
of the reference's own equivalence tests), after which the stream is
not compared further.
"""

import json
import os
import subprocess
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aigw_tpu.models import llama as jllama
from aigw_tpu.tpuserve import engine as jengine
from aigw_tpu.tpuserve.sampling import SamplingParams as JSampling
from aigw_tpu_torch.models import convert
from aigw_tpu_torch.models import llama as tllama
from aigw_tpu_torch.tpuserve import engine as tengine
from aigw_tpu_torch.tpuserve.sampling import SamplingParams as TSampling

EOS = (257,)
TIE_GAP = 1e-4
CFG = dict(max_batch_size=2, max_seq_len=128, page_size=16,
           decode_steps_per_tick=4, kv_cache_dtype="float32",
           attention_backend="pallas-ragged", decode_backend="fused",
           ragged_chunk_tokens=16, ragged_max_chunks=2)
# (prompt length, max_tokens, sampling kwargs)
REQUESTS = [
    (3, 12, dict(temperature=0.0)),
    (17, 20, dict(temperature=0.8, top_k=20, seed=11)),
    (9, 8, dict(temperature=0.0)),
    (30, 16, dict(temperature=1.0, top_p=0.9, seed=5)),
    (5, 10, dict(temperature=0.0, frequency_penalty=0.5)),
]


def _prompts():
    rng = np.random.default_rng(123)
    return [rng.integers(0, 256, n).tolist() for n, _, _ in REQUESTS]


def _run(engine, req_cls, sampling_cls, prompts, timeout=180):
    streams = [[] for _ in prompts]
    done = [threading.Event() for _ in prompts]

    def emitter(i):
        def emit(tok, fin):
            if tok >= 0:
                streams[i].append(tok)
            if fin is not None:
                done[i].set()
        return emit

    for i, (prompt, (_n, max_tokens, kw)) in enumerate(
            zip(prompts, REQUESTS)):
        engine.submit(req_cls(prompt=prompt, max_tokens=max_tokens,
                              sampling=sampling_cls(**kw),
                              emit=emitter(i)))
    engine.start()
    try:
        for d in done:
            assert d.wait(timeout), "stream did not finish"
        assert engine.healthy, engine.last_error
    finally:
        engine.stop()
    return streams


@pytest.fixture(scope="module")
def weights():
    p = jllama.init_params(jax.random.PRNGKey(0), jllama.TINY,
                           dtype=jnp.float32)
    return p, convert.params_from_numpy(
        {k: np.asarray(v) for k, v in p.items()}, device="cpu")


@pytest.fixture(scope="module")
def reference_streams(weights):
    jp, _ = weights
    cfg = jengine.EngineConfig(enable_prefix_cache=False, **CFG)
    eng = jengine.Engine(jp, jllama.TINY, cfg, eos_token_ids=EOS)
    assert eng.decode_attn_impl == "fused-xla"
    return _run(eng, jengine.GenRequest, JSampling, _prompts())


def _port_streams(weights, **overrides):
    _, tp = weights
    cfg = tengine.EngineConfig(**{**CFG, **overrides})
    eng = tengine.Engine(tp, tllama.TINY, cfg, eos_token_ids=EOS,
                         device="cpu")
    return eng, _run(eng, tengine.GenRequest, TSampling, _prompts())


def _top2_gap(jp, tokens, mcfg=jllama.TINY, kv_dtype="float32"):
    """Top-2 logit gap of the reference model after ``tokens``."""
    from aigw_tpu.models import kvq as jkvq

    S = 1 << max(3, (len(tokens) - 1).bit_length())
    toks = np.zeros((1, S), np.int32)
    toks[0, :len(tokens)] = tokens
    pool = jkvq.make_pool((mcfg.n_layers, 2, S, mcfg.n_kv_heads,
                           mcfg.head_dim), kv_dtype)
    logits, _ = jllama.prefill(
        jp, mcfg, jnp.asarray(toks),
        jnp.asarray([len(tokens)], jnp.int32), pool,
        jnp.arange(S // 8, dtype=jnp.int32)[None], 8)
    top = np.sort(np.asarray(logits[0]))[-2:]
    return float(top[1] - top[0])


def _assert_streams_match(got, want, weights, mcfg=jllama.TINY,
                          kv_dtype="float32"):
    jp, _ = weights
    for i, (g, w) in enumerate(zip(got, want)):
        if g == w:
            continue
        j = next((k for k, (a, b) in enumerate(zip(g, w)) if a != b),
                 min(len(g), len(w)))
        greedy = REQUESTS[i][2].get("temperature", 1.0) <= 0.0
        gap = (_top2_gap(jp, _prompts()[i] + w[:j], mcfg, kv_dtype)
               if greedy else None)
        assert greedy and gap < TIE_GAP, (
            f"stream {i} diverges at token {j} (greedy={greedy}, top-2 "
            f"gap={gap}):\n port {g}\n  ref {w}")


def test_engine_streams_match_reference_fused(weights, reference_streams):
    eng, got = _port_streams(weights)
    assert eng.decode_attn_impl == "fused-torch"
    _assert_streams_match(got, reference_streams, weights)
    assert eng.stats.chunked_prefill_steps > 0  # a burst split at budget
    assert eng.stats.prefills == len(REQUESTS)


def test_engine_streams_match_reference_chained(weights, reference_streams):
    eng, got = _port_streams(weights, decode_backend="auto",
                             pallas_attn=True)
    assert eng.decode_attn_impl == "chained-torch"
    _assert_streams_match(got, reference_streams, weights)


@pytest.mark.parametrize("rung", [dict(decode_backend="fused"),
                                  dict(decode_backend="auto",
                                       pallas_attn=True)],
                         ids=["fused", "chained"])
def test_engine_streams_match_reference_speculative(weights,
                                                    reference_streams, rung):
    """Speculation (width 3, the adaptive ladder) on the mixed batch of
    greedy, seeded top-k/top-p and penalized requests: the reference's
    streams on both rungs. The verify step runs K5's plain version on the
    chained rung and the gather path on the fused rung."""
    eng, got = _port_streams(weights, spec_tokens=3, **rung)
    assert eng._verify_impl == ("chained" if "pallas_attn" in rung else "")
    _assert_streams_match(got, reference_streams, weights)
    assert eng.stats.spec_drafted > 0


@pytest.mark.parametrize("rung", [dict(decode_backend="fused"),
                                  dict(decode_backend="fused", spec_tokens=3),
                                  dict(decode_backend="auto",
                                       pallas_attn=True)],
                         ids=["fused", "fused_spec", "chained"])
def test_streams_at_warm_settings_match_reference(weights,
                                                  reference_streams, rung):
    """An engine warmed at the reference's warm settings (the decode
    ladder at page buckets 1, 2 and 4, the ragged prefill's rungs)
    serves the reference's streams: every window and prefill call runs
    a program warm-up built, and no other (on the card each replays a
    captured graph of the same body)."""
    _, tp = weights
    eng = tengine.Engine(tp, tllama.TINY, tengine.EngineConfig(**{
        **CFG, **rung, "enable_prefix_cache": False,
        "warm_prefill_buckets": 2, "warm_decode_buckets": 3}),
        eos_token_ids=EOS, device="cpu")
    eng.warmup()
    cp = eng.compile_tracker.checkpoint()
    got = _run(eng, tengine.GenRequest, TSampling, _prompts())
    _assert_streams_match(got, reference_streams, weights)
    assert eng.compile_tracker.compiles_since(cp) == 0


def test_engine_streams_fixed_window_sync_transfers(weights,
                                                    reference_streams):
    """Window size and transfer mode change only timing, never tokens."""
    _, got = _port_streams(weights, adaptive_decode_window=False,
                           async_transfers=False, decode_steps_per_tick=3)
    _assert_streams_match(got, reference_streams, weights)


def test_engine_interpret_kernels_match_port(weights):
    """One short case against the reference forced onto its Pallas
    kernels (interpret mode): ragged prefill and fused decode."""
    jp, tp = weights
    prompt = [5, 3, 8, 1, 9, 12, 7]
    cfg = dict(max_batch_size=1, max_seq_len=64, page_size=16,
               decode_steps_per_tick=2, kv_cache_dtype="float32",
               attention_backend="pallas-ragged", decode_backend="fused",
               ragged_chunk_tokens=16, ragged_max_chunks=1)
    env = {"AIGW_DECODE_FUSED_IMPL": "pallas",
           "AIGW_RAGGED_PREFILL_IMPL": "pallas"}
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        jeng = jengine.Engine(
            jp, jllama.TINY,
            jengine.EngineConfig(enable_prefix_cache=False, **cfg),
            eos_token_ids=EOS)
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    assert jeng.decode_attn_impl == "fused-pallas"
    out = {}
    for name, eng, req_cls, sp_cls in (
            ("ref", jeng, jengine.GenRequest, JSampling),
            ("port", tengine.Engine(tp, tllama.TINY,
                                    tengine.EngineConfig(**cfg),
                                    eos_token_ids=EOS, device="cpu"),
             tengine.GenRequest, TSampling)):
        done = threading.Event()
        toks: list[int] = []

        def emit(tok, fin, toks=toks, done=done):
            if tok >= 0:
                toks.append(tok)
            if fin is not None:
                done.set()

        eng.submit(req_cls(prompt=prompt, max_tokens=5,
                           sampling=sp_cls(temperature=0.0), emit=emit))
        eng.start()
        try:
            assert done.wait(300)
            assert eng.healthy, eng.last_error
        finally:
            eng.stop()
        out[name] = toks
    assert out["port"] == out["ref"]


@pytest.mark.parametrize("rung", [dict(decode_backend="fused"),
                                  dict(decode_backend="auto",
                                       pallas_attn=True)])
def test_engine_request_filling_max_seq_len(weights, rung):
    """A request whose prompt + max_tokens is exactly max_seq_len, beside
    a shorter one: the device runs past the long slot's last position
    inside a window (its row then sits at max_seq_len, inactive), and
    the engine must stay healthy and deliver every token."""
    _, tp = weights
    cfg = tengine.EngineConfig(
        max_batch_size=2, max_seq_len=64, page_size=16,
        decode_steps_per_tick=8, adaptive_decode_window=False,
        kv_cache_dtype="float32", attention_backend="pallas-ragged", **rung)
    eng = tengine.Engine(tp, tllama.TINY, cfg, device="cpu")
    got: dict[int, list] = {0: [], 1: []}
    done = [threading.Event(), threading.Event()]
    for i, (n, max_tokens) in enumerate(((18, 46), (2, 26))):
        def emit(tok, fin, i=i):
            got[i].append((tok, fin))
            if fin is not None:
                done[i].set()
        eng.submit(tengine.GenRequest(
            prompt=list(range(1, n + 1)), max_tokens=max_tokens,
            sampling=TSampling(temperature=0.0), emit=emit))
    eng.start()
    try:
        assert all(d.wait(120) for d in done)
        assert eng.healthy, eng.last_error
    finally:
        eng.stop()
    assert [len(got[0]), got[0][-1][1]] == [46, "length"]
    assert [len(got[1]), got[1][-1][1]] == [26, "length"]


def test_engine_config_refuses_unported_knobs():
    # no knob is refused since the two warm knobs were ported (a captured
    # CUDA graph stands for the reference's compiled program): both are
    # accepted, with the reference's defaults, and warm what the
    # reference warms (tests/test_torch_graphs.py holds the surface)
    assert tengine.NOT_PORTED == {}
    ref = jengine.EngineConfig()
    for name in ("warm_prefill_buckets", "warm_decode_buckets"):
        assert getattr(tengine.EngineConfig(), name) == getattr(ref, name)
        assert getattr(tengine.EngineConfig(**{name: 2}), name) == 2
    eng = tengine.Engine({}, tllama.TINY, tengine.EngineConfig(
        max_seq_len=256, page_size=16, warm_decode_buckets=3),
        device="cpu")
    assert eng._warm_page_buckets() == [1, 2, 4]
    # logprobs, the tenant cap, the spill tier and the bucket ladder are
    # ported; logprobs still exclude speculation, as in the reference
    for kw in (dict(logprobs_topk=2), dict(tenant_slot_cap=1),
               dict(kv_host_bytes=1 << 20), dict(prefill_chunk_tokens=0),
               dict(min_prefill_bucket=16), dict(prefill_bucket_rungs=4)):
        assert getattr(tengine.EngineConfig(**kw), next(iter(kw))) == \
            next(iter(kw.values()))
    with pytest.raises(ValueError, match="mutually exclusive"):
        tengine.EngineConfig(logprobs_topk=2, spec_tokens=2)
    # chained without pallas_attn is the gather rung, as in the reference
    eng = tengine.Engine({}, tllama.TINY,
                         tengine.EngineConfig(decode_backend="chained"),
                         device="cpu")
    assert eng.decode_attn_impl == "gather-torch"
    assert eng._decode_impl == "" and eng._verify_impl == ""


def test_engine_config_defaults_match_reference():
    """Every field the port keeps has the reference's default
    (constrained decoding and the prefix cache on among them)."""
    import dataclasses

    ref = {f.name: f.default for f in dataclasses.fields(
        jengine.EngineConfig)}
    port = {f.name: f.default for f in dataclasses.fields(
        tengine.EngineConfig)}
    differ = {k for k in port if port[k] != ref[k]}
    assert differ == set(tengine.DEFAULTS_DIFFER) == set()
    assert port["enable_prefix_cache"] is True
    assert port["constrained_decoding"] is True


# -- quantized serving ---------------------------------------------------------
# 128-aligned widths so the W8A16 decode matmuls reach K6 (the reference's
# interpret-mode Pallas kernel, the port's plain version)
QJ = jllama.LlamaConfig(vocab_size=512, dim=128, n_layers=2, n_heads=4,
                        n_kv_heads=2, ffn_dim=256, max_seq_len=256,
                        rope_theta=10000.0)
QT = tllama.LlamaConfig(vocab_size=512, dim=128, n_layers=2, n_heads=4,
                        n_kv_heads=2, ffn_dim=256, max_seq_len=256,
                        rope_theta=10000.0)


def _reference_streams_quantized(wmode: str, qdt: str) -> dict:
    """The reference Engine's streams and KV byte gauges for the
    quantized case (run by the test below in a subprocess)."""
    from aigw_tpu.models import quant as jquant

    jp = jllama.init_params(jax.random.PRNGKey(0), QJ, dtype=jnp.float32)
    if wmode:
        jp = jquant.quantize_params(jp, mode=wmode)
    eng = jengine.Engine(jp, QJ, jengine.EngineConfig(
        enable_prefix_cache=False, **{**CFG, "kv_cache_dtype": qdt}),
        eos_token_ids=EOS)
    streams = _run(eng, jengine.GenRequest, JSampling, _prompts())
    return {"impl": eng.decode_attn_impl, "streams": streams,
            "kv_page_bytes": eng.kv_page_bytes,
            "kv_bytes_per_token": eng.stats.kv_bytes_per_token,
            "kv_quant_bits": eng.stats.kv_quant_bits,
            "kv_pool_bytes": eng.stats.kv_pool_bytes}


@pytest.mark.parametrize("wmode,qdt", [("int8", "int8"), ("int4", "int4")],
                         ids=["w8_kv8", "w4_kv4"])
def test_engine_streams_match_reference_quantized(wmode, qdt):
    """W8A16 / W4A16 weights over int8 / int4 KV pages: the reference
    Engine (windowed prefill, ``fused-xla`` decode with in-pass
    quantization, K6's Pallas kernel in interpret mode) against the
    port's (windowed prefill, K6's and K7's plain versions); identical
    streams, seeded draws included, greedy tie-aware.

    Quantized weights put bf16 values in the forward pass (the
    dequantized operand, the embedding rows), and the reference rounds
    them to bf16 as its source says only when XLA's
    ``--xla_allow_excess_precision`` is off: with the default, its jitted
    programs keep some of them in float32 and its logits move by ~0.03
    from its own eager functions (ROADMAP §3). So the reference Engine
    runs in a subprocess with that flag off."""
    code = (
        "import json, sys\n"
        f"sys.path.insert(0, {str(os.path.dirname(__file__))!r})\n"
        "import jax\n"
        "jax.config.update('jax_platforms', 'cpu')\n"
        "import test_torch_engine as te\n"
        f"print(json.dumps(te._reference_streams_quantized({wmode!r}, "
        f"{qdt!r})))\n")
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_allow_excess_precision=false"}
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    ref = json.loads(proc.stdout.strip().splitlines()[-1])
    assert ref["impl"] == "fused-xla"
    from aigw_tpu.models import quant as jquant

    jp = jquant.quantize_params(
        jllama.init_params(jax.random.PRNGKey(0), QJ, dtype=jnp.float32),
        mode=wmode)
    weights = (jp, convert.params_from_numpy(
        {k: np.asarray(v) for k, v in jp.items()}, device="cpu"))
    teng = tengine.Engine(weights[1], QT, tengine.EngineConfig(
        **{**CFG, "kv_cache_dtype": qdt}), eos_token_ids=EOS, device="cpu")
    assert teng.decode_attn_impl == "fused-torch"
    assert teng.attn_reason.startswith("windowed program")
    got = _run(teng, tengine.GenRequest, TSampling, _prompts())
    _assert_streams_match(got, ref["streams"], weights, QJ, qdt)
    # the /state byte math: packed elements plus the scales
    assert teng.kv_page_bytes == ref["kv_page_bytes"]
    for key in ("kv_bytes_per_token", "kv_quant_bits", "kv_pool_bytes"):
        assert getattr(teng.stats, key) == ref[key], key


@pytest.mark.parametrize("qdt", ["int8", "int4"])
def test_engine_streams_match_reference_quantized_pool(weights, qdt):
    """float32 weights over int8 / int4 KV pages, against the reference
    Engine in this process (no bf16 value in the forward pass, so
    excess precision changes nothing): identical streams."""
    jp, tp = weights
    cfg = {**CFG, "kv_cache_dtype": qdt}
    jeng = jengine.Engine(jp, jllama.TINY, jengine.EngineConfig(
        enable_prefix_cache=False, **cfg), eos_token_ids=EOS)
    want = _run(jeng, jengine.GenRequest, JSampling, _prompts())
    teng = tengine.Engine(tp, tllama.TINY, tengine.EngineConfig(**cfg),
                          eos_token_ids=EOS, device="cpu")
    got = _run(teng, tengine.GenRequest, TSampling, _prompts())
    _assert_streams_match(got, want, weights, jllama.TINY, qdt)


def test_quantized_pool_resolves_to_fused_and_windowed():
    """The fallback matrix's quantized rows: the chained kernel and the
    ragged prefill kernel have no quantized rung."""
    from aigw_tpu_torch.tpuserve.attention import (
        resolve_attention_backend,
        resolve_decode_backend,
    )

    cpu = torch.device("cpu")
    cfg = tengine.EngineConfig(kv_cache_dtype="int4", pallas_attn=True)
    impl, why = resolve_decode_backend(cfg, cpu)
    assert impl == "fused-torch" and "no quantized rung" in why
    _, why = resolve_attention_backend(
        tengine.EngineConfig(kv_cache_dtype="int8",
                             attention_backend="pallas-ragged"), cpu)
    assert "windowed" in why and "plain PyTorch" in why

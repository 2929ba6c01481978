"""Tensor-parallel serving: the port's engine at ``tp = 2`` against the
reference's ``Engine(mesh=make_mesh(MeshSpec(tp=2)))``.

The port's replica is two processes over gloo on the CPU: this test
process is rank 0, the leader, and a follower process, started once for
the module by ``tpuserve.follower.start_replica_mesh`` with ``file://``
rendezvous under ``tmp_path``, is rank 1. The reference runs on the
virtual 8-device CPU mesh ``tests/conftest.py`` sets, on the same
``init_params(PRNGKey(0), TINY, float32)`` weights (2 KV heads: one per
rank). Each case serves the same requests on both and holds the streams
token for token: greedy ones tie-aware (a divergence only where the
reference's top-2 logit gap is under ``TIE_GAP``, after which the
stream is not compared), seeded ones identical. Cases: the kernel path
(ragged prefill, fused decode) with a zoo of LoRA adapters over two
store rows, the reference's default programs (bucketed prefill, gather
decode), an int8 pool with W8A16 weights, and speculation at a fixed
draft width. The kernel-path case also exports its cached pages through
the fleet fetch (whole heads, gathered from the two head shards); the
reference's int8 wire pages imported into the shards come back out byte
for byte.

A one-command replica (``python -m aigw_tpu_torch tpuserve --tp 2
--device cpu``) serves a request; its ``/state`` carries the
reference's mesh keys and values and its ``/metrics`` the two ICI
gauges; a follower killed under it fails the leader's engine within the
group's timeout, and the replica still exits on SIGTERM. The server's
refusals are the reference's.
"""

import os
import re
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aigw_tpu.models import llama as jllama
from aigw_tpu.models import lora as jlora
from aigw_tpu.models import quant as jquant
from aigw_tpu.parallel import MeshSpec as JMeshSpec
from aigw_tpu.parallel import make_mesh as jmake_mesh
from aigw_tpu.parallel.sharding import (
    analytical_ici_bytes_per_token as j_ici,
)
from aigw_tpu.tpuserve import adapters as jadapters
from aigw_tpu.tpuserve import engine as jengine
from aigw_tpu.tpuserve.sampling import SamplingParams as JSampling
from aigw_tpu_torch.models import convert
from aigw_tpu_torch.models import llama as tllama
from aigw_tpu_torch.parallel import MeshSpec
from aigw_tpu_torch.tpuserve import adapters as tadapters
from aigw_tpu_torch.tpuserve import engine as tengine
from aigw_tpu_torch.tpuserve import follower
from aigw_tpu_torch.tpuserve.sampling import SamplingParams as TSampling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EOS = (257,)
#: a greedy divergence is accepted only where the reference's top-2
#: logits are this close (float32 weights and pool: the tp ranks' and
#: GSPMD's partial sums differ in order only)
TIE_GAP = 1e-4
#: bf16 activations over W8A16 weights round each rank's partial sums
#: (the reference's and the port's in another order): near-ties within
#: this gap may flip
TIE_GAP_BF16 = 0.05
#: one window length (no adaptive ladder): fewer programs to compile
GEOM = dict(max_batch_size=2, max_seq_len=128, page_size=16,
            decode_steps_per_tick=4, adaptive_decode_window=False,
            kv_cache_dtype="float32")
KERNEL = dict(attention_backend="pallas-ragged", decode_backend="fused",
              ragged_chunk_tokens=16, ragged_max_chunks=2)
# (prompt length, max_tokens, sampling kwargs)
REQUESTS = [
    (3, 12, dict(temperature=0.0)),
    (17, 20, dict(temperature=0.8, top_k=20, seed=11)),
    (40, 8, dict(temperature=0.0)),
    (30, 16, dict(temperature=1.0, top_p=0.9, seed=5)),
    (5, 10, dict(temperature=0.0, frequency_penalty=0.5)),
]
LORA = jlora.LoRAConfig(rank=4, alpha=8.0, targets=("wq", "wv", "wo",
                                                    "w_down"))
LORA_ADAPTERS = ("ad0", "ad1", "", "ad2", "ad0")
PINNED = dict(temperature=0.0, logit_bias=((7, 100.0),))


def _prompts():
    rng = np.random.default_rng(123)
    return [rng.integers(0, 256, n).tolist() for n, _, _ in REQUESTS]


@pytest.fixture(scope="module")
def weights():
    p = jllama.init_params(jax.random.PRNGKey(0), jllama.TINY,
                           dtype=jnp.float32)
    return p, convert.params_from_numpy(
        {k: np.asarray(v) for k, v in p.items()}, device="cpu")


@pytest.fixture(scope="module")
def jmesh():
    return jmake_mesh(JMeshSpec(tp=2))


@pytest.fixture(scope="module")
def replica(tmp_path_factory):
    rdv = tmp_path_factory.mktemp("rdv") / "init"
    rm = follower.start_replica_mesh(MeshSpec(tp=2), "cpu",
                                     init_method=f"file://{rdv}",
                                     timeout_s=120)
    yield rm
    rm.close()


def _run(engine, req_cls, sp_cls, reqs, adapters=None, export=None,
         timeout=180):
    """Serve ``reqs`` ((prompt, max_tokens, sampling kwargs)) at once;
    returns the streams and, with ``export`` (prompts), the pages the
    fleet fetch exports for each prompt's chain."""
    streams = [[] for _ in reqs]
    done = [threading.Event() for _ in reqs]
    for i, (prompt, max_tokens, kw) in enumerate(reqs):
        def emit(tok, fin, i=i):
            if tok >= 0:
                streams[i].append(tok)
            if fin is not None:
                done[i].set()
        engine.submit(req_cls(prompt=prompt, max_tokens=max_tokens,
                              sampling=sp_cls(**kw), emit=emit,
                              adapter=(adapters or [""] * len(reqs))[i]))
    engine.start()
    pages = None
    try:
        for d in done:
            assert d.wait(timeout), "stream did not finish"
        assert engine.healthy, engine.last_error
        if export is not None:
            from aigw_tpu_torch.tpuserve.kvcache import page_chain_hashes

            pages = [engine.kv_export_pages(page_chain_hashes(p, 16))
                     for p in export]
    finally:
        engine.stop()
    return streams, pages


def _top2_gap(jp, tokens):
    """Top-2 logit gap of the one-device reference model after
    ``tokens``."""
    from aigw_tpu.models import kvq as jkvq

    mcfg = jllama.TINY
    S = 1 << max(3, (len(tokens) - 1).bit_length())
    toks = np.zeros((1, S), np.int32)
    toks[0, :len(tokens)] = tokens
    pool = jkvq.make_pool((mcfg.n_layers, 2, S, mcfg.n_kv_heads,
                           mcfg.head_dim), "float32")
    logits, _ = jllama.prefill(
        jp, mcfg, jnp.asarray(toks),
        jnp.asarray([len(tokens)], jnp.int32), pool,
        jnp.arange(S // 8, dtype=jnp.int32)[None], 8)
    top = np.sort(np.asarray(logits[0]))[-2:]
    return float(top[1] - top[0])


def _assert_streams(got, want, reqs, jp, gap=TIE_GAP):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        if g == w:
            continue
        j = next((k for k, (a, b) in enumerate(zip(g, w)) if a != b),
                 min(len(g), len(w)))
        greedy = reqs[i][2].get("temperature", 1.0) <= 0.0
        near = greedy and _top2_gap(jp, reqs[i][0] + w[:j]) < gap
        assert near, (f"stream {i} diverges at token {j} (greedy="
                      f"{greedy}): {g} vs {w}")


def _reqs():
    return [(p, n, kw) for p, (_l, n, kw) in zip(_prompts(), REQUESTS)]


def _engines(weights, jmesh, replica, jparams=None, tparams=None,
             jstore=None, tstore=None, **cfg):
    jp, tp = weights
    jeng = jengine.Engine(jparams or jp, jllama.TINY,
                          jengine.EngineConfig(**{**GEOM, **cfg}),
                          eos_token_ids=EOS, mesh=jmesh,
                          adapter_store=jstore)
    teng = tengine.Engine(tparams or tp, tllama.TINY,
                          tengine.EngineConfig(**{**GEOM, **cfg}),
                          eos_token_ids=EOS, device="cpu",
                          mesh=replica.mesh, adapter_store=tstore)
    return jeng, teng


def _zoo_stores():
    """Three adapters (wq, wv, wo, w_down) registered in a 2-row store
    on each side."""
    j = jlora.init_lora_adapters(jax.random.PRNGKey(7), jllama.TINY, LORA,
                                 3, random_b=True)
    zoo = {f"ad{i}": {k: np.asarray(v[i]) for k, v in j.items()}
           for i in range(3)}
    jstore = jadapters.AdapterStore(n_slots=2)
    tstore = tadapters.AdapterStore(n_slots=2, device="cpu")
    for name, ad in zoo.items():
        jstore.register(name, ad)
        tstore.register(name, ad)
    return jstore, tstore


def test_kernel_path_lora_zoo_and_fleet_export(weights, jmesh, replica):
    """Ragged prefill and the fused rung, the prefix cache on, a zoo of
    three adapters over two store rows (an eviction and a reload; every
    row load performed on both ranks) on all four target kinds:
    column-parallel ``wq``/``wv`` through the rank's B columns,
    row-parallel ``wo``/``w_down`` through its A rows. Streams equal
    (the adapter requests' exactly), the resolved rungs the reference's
    mesh rows, and the pages the fleet fetch exports whole (both head
    shards) and equal to the reference's within float32 rounding."""
    jstore, tstore = _zoo_stores()
    jeng, teng = _engines(weights, jmesh, replica, jstore=jstore,
                          tstore=tstore, **KERNEL)
    assert jeng.decode_attn_impl == "fused-xla-spmd"
    assert teng.decode_attn_impl == "fused-torch"
    assert "local head shard" in teng.decode_attn_reason
    assert "windowed program" in teng.attn_reason  # names the reference
    assert teng.mesh_axes() == jeng.mesh_axes()
    assert teng.stats.ici_bytes_per_token == jeng.ici_bytes_per_token > 0
    # the adapter requests' prompts share no page with the base ones:
    # the prefix cache keys on tokens only, and when a page registers
    # follows the scheduler
    rng = np.random.default_rng(321)
    ad_reqs = [(rng.integers(256, 512, 6 + 5 * i).tolist(), 8,
                dict(temperature=0.0)) for i in range(len(LORA_ADAPTERS))]
    reqs = _reqs() + ad_reqs
    names = [""] * len(REQUESTS) + list(LORA_ADAPTERS)
    cached = [reqs[2][0]]  # 40 tokens: 2 full pages
    want, jpages = _run(jeng, jengine.GenRequest, JSampling, reqs, names,
                        export=cached)
    got, tpages = _run(teng, tengine.GenRequest, TSampling, reqs, names,
                       export=cached)
    n = len(REQUESTS)
    _assert_streams(got[:n], want[:n], reqs[:n], weights[0])
    assert got[n:] == want[n:]
    # both stores loaded every adapter and evicted one (how often
    # follows when slots free up)
    assert min(tstore.loads, jstore.loads) >= 3
    assert min(tstore.evictions, jstore.evictions) >= 1
    assert teng.stats.ici_bytes_total == (
        teng.stats.ici_bytes_per_token * teng.stats.tokens_generated)
    (jrows,), (trows,) = jpages, tpages
    assert [k for k, _ in trows] == [k for k, _ in jrows] and len(trows) == 2
    for (_k, t), (_k2, j) in zip(trows, jrows):
        assert tuple(t.shape) == (2, 2, 16, 2, 16)  # whole heads
        # float32 rows: the two frameworks' matmuls round apart
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0,
                                   atol=1e-5)


def test_default_programs_streams(weights, jmesh, replica):
    """The reference's defaults on a mesh: bucketed prefill, gather
    decode."""
    jeng, teng = _engines(weights, jmesh, replica,
                          enable_prefix_cache=False)
    assert jeng.decode_attn_impl == "xla-gather"
    assert teng.decode_attn_impl == "gather-torch"
    reqs = _reqs()
    want, _ = _run(jeng, jengine.GenRequest, JSampling, reqs)
    got, _ = _run(teng, tengine.GenRequest, TSampling, reqs)
    _assert_streams(got, want, reqs, weights[0])


def test_int8_pool_w8a16_streams(weights, jmesh, replica):
    """W8A16 weights (each rank's int8 shards and per-column scales)
    over an int8 KV pool (each rank's KV heads and their scale rows),
    the prefix cache on: greedy streams tie-aware at the bf16 gap; the
    fleet fetch exports whole int8 pages; the reference's exported
    pages, imported into the port's shards and exported again, come
    back byte for byte (the sharded wire is the reference's)."""
    jp, _ = weights
    jq = jquant.quantize_params(
        {k: v.astype(jnp.bfloat16) for k, v in jp.items()}, mode="int8")
    tq = convert.params_from_numpy({k: np.asarray(v)
                                    for k, v in jq.items()}, device="cpu")
    jeng, teng = _engines(weights, jmesh, replica, jparams=jq, tparams=tq,
                          **{**KERNEL, "kv_cache_dtype": "int8"})
    # greedy, unpenalized: the tie check reads the model's own logits
    reqs = [(p, n, dict(temperature=0.0)) for p, n, _kw in _reqs()[:4]]
    want, jpages = _run(jeng, jengine.GenRequest, JSampling, reqs,
                        export=[reqs[2][0]])
    got, tpages = _run(teng, tengine.GenRequest, TSampling, reqs,
                       export=[reqs[2][0]])
    _assert_streams(got, want, reqs, jq, gap=TIE_GAP_BF16)
    (jrows,), (trows,) = jpages, tpages
    assert len(trows) == len(jrows) == 2
    assert all(t["dtype"] == "int8" and tuple(t["q"].shape)
               == (2, 2, 16, 2, 16) for _k, t in trows)  # whole heads
    # the reference's wire pages imported (each rank scatters its KV
    # heads) and exported again (the ranks' heads gathered): byte for
    # byte the reference's
    teng = tengine.Engine(tq, tllama.TINY, tengine.EngineConfig(
        **{**GEOM, **KERNEL, "kv_cache_dtype": "int8"}), eos_token_ids=EOS,
        device="cpu", mesh=replica.mesh)
    teng.start()
    try:
        from aigw_tpu_torch.tpuserve.kvcache import page_chain_hashes

        prompt = reqs[2][0]
        assert teng.kv_import_pages(
            prompt, [{"q": torch.from_numpy(np.asarray(j["q"])),
                      "scale": torch.from_numpy(np.asarray(j["scale"])),
                      "dtype": "int8"} for _k, j in jrows]) == 2
        back = teng.kv_export_pages(page_chain_hashes(prompt, 16))
    finally:
        teng.stop()
    assert [k for k, _ in back] == [k for k, _ in jrows]
    for (_k, t), (_k2, j) in zip(back, jrows):
        np.testing.assert_array_equal(t["q"].numpy(), np.asarray(j["q"]))
        np.testing.assert_array_equal(t["scale"].numpy(),
                                      np.asarray(j["scale"]))


def test_speculation_streams(weights, jmesh, replica):
    """A fixed draft width of 3: on a mesh both verify on the gather
    path; pinned requests accept drafts, equal counts."""
    jeng, teng = _engines(weights, jmesh, replica,
                          enable_prefix_cache=False, spec_tokens=3,
                          spec_adaptive=False, **KERNEL)
    reqs = _reqs()[:2] + [([5, 6, 7, 5, 6], 16, PINNED),
                          ([9, 9, 9], 12, PINNED)]
    want, _ = _run(jeng, jengine.GenRequest, JSampling, reqs)
    got, _ = _run(teng, tengine.GenRequest, TSampling, reqs)
    _assert_streams(got, want, reqs, weights[0])
    assert teng.stats.spec_accepted == jeng.stats.spec_accepted > 0
    assert teng.stats.spec_drafted == jeng.stats.spec_drafted


def test_server_refusals_are_the_references():
    """``--ep`` without experts or not dividing them, ``--tp`` not
    dividing the KV heads: the reference's messages (``--sp``'s refusal,
    a family with no sequence-parallel prefill, is
    ``tests/test_torch_sp_serving.py``'s); too few cards the
    reference's mesh message."""
    from aigw_tpu_torch.tpuserve.server import TPUServeServer

    cfg = tengine.EngineConfig(**GEOM)
    cases = [("tiny-random", dict(ep=2),
              "--ep requires a MoE model family; 'tiny-random' has no "
              "experts"),
             ("tiny-moe", dict(ep=3), "n_experts 4 not divisible by ep=3"),
             ("tiny-random", dict(tp=4),
              "n_kv_heads 2 not divisible by tp=4")]
    for model, kw, msg in cases:
        with pytest.raises(ValueError, match=re.escape(msg)):
            TPUServeServer(model, cfg, device="cpu", port=0, **kw)


def test_too_few_cards_is_refused(monkeypatch):
    from aigw_tpu_torch.tpuserve.server import TPUServeServer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match=re.escape(
            "needs 2 devices, have 1")):
        TPUServeServer("tiny-random", tengine.EngineConfig(**GEOM),
                       device="cuda", port=0, tp=2)


def _http(port, path, body=None, timeout=60):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_one_command_replica_state_metrics_and_a_dead_follower():
    """``tpuserve --tp 2 --device cpu`` starts its follower, serves,
    exports the mesh keys with the reference's values (and the key set
    of a one-device replica), renders the ICI gauges; a killed follower
    fails the leader (``/health`` 503) instead of hanging it; SIGTERM
    still exits."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "aigw_tpu_torch", "tpuserve", "--model",
         "tiny-random", "--device", "cpu", "--tp", "2", "--port", "0",
         "--max-seq-len", "128", "--page-size", "16", "--drain-grace",
         "5"], cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    lines: list[str] = []
    threading.Thread(target=lambda: lines.extend(proc.stderr),
                     daemon=True).start()
    try:
        port = int(re.search(r":(\d+)$", proc.stdout.readline()
                             .strip()).group(1))
        st, body = _http(port, "/v1/completions", {
            "model": "tiny-random", "prompt": "hello", "max_tokens": 6,
            "temperature": 0.0})
        assert st == 200, body
        state = json.loads(_http(port, "/state")[1])
        assert state["mesh_axes"] == {"dp": 1, "tp": 2, "sp": 1, "ep": 1,
                                      "pp": 1}
        assert state["mesh_devices"] == state["device_count"] == 2
        mesh = jmake_mesh(JMeshSpec(tp=2))
        want = j_ici(jllama.TINY, mesh, 2)
        assert state["ici_bytes_per_token"] == want > 0
        assert state["ici_bytes_total"] == want * state["tokens_generated"]
        assert state["slice"] == "" and state["device_coords"] == []
        assert [d["id"] for d in state["devices"]] == [0, 1]
        per = state["param_bytes_per_device"]
        assert set(per) == {"0", "1"} and per["0"] == per["1"]
        assert sum(per.values()) == state["param_bytes_total"]
        from aigw_tpu_torch.tpuserve.server import TPUServeServer

        solo = TPUServeServer("tiny-random", tengine.EngineConfig(),
                              device="cpu", port=0)
        assert set(state) == set(solo.state())
        assert solo.state()["mesh_axes"] == {}
        solo.httpd.server_close()
        metrics = _http(port, "/metrics")[1].decode()
        assert f"tpuserve_ici_bytes_per_token {want}" in metrics
        assert "tpuserve_ici_bytes_total " in metrics
        assert "tpuserve_device_count 2" in metrics
        pids = [int(x) for x in re.findall(
            r"follower pids \[(\d+)\]", "".join(lines))]
        assert len(pids) == 1, lines
        os.kill(pids[0], signal.SIGKILL)
        t0 = time.monotonic()
        # the idle engine's next collective (its device-stats gather)
        # fails on the dead peer: the leader's loop stops, loudly
        while _http(port, "/health")[0] != 503:
            assert time.monotonic() - t0 < 120, "leader never failed"
            time.sleep(0.2)
        # the leader still exits on a signal (not 0: its followers
        # cannot be told to close)
        proc.send_signal(signal.SIGTERM)
        proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)

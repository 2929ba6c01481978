"""Expert-parallel serving: the port's Mixtral engine at ``ep = 2``
against the reference's ``Engine(mesh=make_mesh(MeshSpec(ep=2)))``.

Two ranks over gloo on the CPU (this test process leads; one follower
process, started once for the module, with ``file://`` rendezvous under
``tmp_path``). Each holds two of the tiny MoE model's four experts; the
router is replicated, every rank routes every row and runs the capacity
fence, and an all-reduce over ``tp`` x ``ep`` sums the experts' partial
outputs. Both sides serve the reference's ``init_params(PRNGKey(0),
TINY_MOE, float32)`` weights on the reference's default programs (the
bucketed prefill and the gather decode rung), one request at a time on an idle
engine: the streams (greedy and seeded) must be identical, and the
routing counts of one prefill call through the two ranks (the engine's
device operation) every count of the reference model's on one device
(the engines' running totals also count the junk steps of windows a
finished stream still had in flight, whose number follows the
scheduler's timing in both frameworks). The embeddings pass and the launch-count gather run on the
leader's engine thread, where every collective is issued.
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aigw_tpu.models import mixtral as jmixtral
from aigw_tpu.models.registry import family_fns as jfamily_fns
from aigw_tpu.parallel import MeshSpec as JMeshSpec
from aigw_tpu.parallel import make_mesh as jmake_mesh
from aigw_tpu.tpuserve import engine as jengine
from aigw_tpu.tpuserve.sampling import SamplingParams as JSampling
from aigw_tpu_torch.models import convert
from aigw_tpu_torch.models import mixtral as tmixtral
from aigw_tpu_torch.models.registry import family_fns as tfamily_fns
from aigw_tpu_torch.parallel import MeshSpec
from aigw_tpu_torch.tpuserve import engine as tengine
from aigw_tpu_torch.tpuserve import follower
from aigw_tpu_torch.tpuserve.sampling import SamplingParams as TSampling

EOS = (257,)
CFG = dict(max_batch_size=2, max_seq_len=128, page_size=16,
           decode_steps_per_tick=4, adaptive_decode_window=False,
           kv_cache_dtype="float32", enable_prefix_cache=False)
REQUESTS = [
    (3, 10, dict(temperature=0.0)),
    (21, 12, dict(temperature=0.9, top_k=30, seed=4)),
    (9, 8, dict(temperature=0.0)),
    (30, 10, dict(temperature=1.0, top_p=0.8, seed=2)),
]


@pytest.fixture(scope="module")
def weights():
    p = jmixtral.init_params(jax.random.PRNGKey(0), jmixtral.TINY_MOE,
                             dtype=jnp.float32)
    return p, convert.params_from_numpy(
        {k: np.asarray(v) for k, v in p.items()}, device="cpu")


@pytest.fixture(scope="module")
def replica(tmp_path_factory):
    rdv = tmp_path_factory.mktemp("rdv") / "init"
    rm = follower.start_replica_mesh(MeshSpec(ep=2), "cpu",
                                     init_method=f"file://{rdv}",
                                     timeout_s=120)
    yield rm
    rm.close()


def _run(engine, req_cls, sp_cls, timeout=180):
    """The requests one after the other, each on an idle engine (no slot,
    no window in flight): the rows the router sees, padding and idle
    slots included, then do not depend on when admission found them."""
    rng = np.random.default_rng(9)
    streams = [[] for _ in REQUESTS]
    engine.start()
    try:
        for i, (n, max_tokens, kw) in enumerate(REQUESTS):
            # on an idle engine: a window still in flight when the next
            # request arrives would route other rows
            deadline = time.monotonic() + timeout
            while engine._inflight is not None \
                    or engine.stats.active_slots:
                assert time.monotonic() < deadline, "engine never idled"
                time.sleep(0.005)
            done = threading.Event()

            def emit(tok, fin, i=i, done=done):
                if tok >= 0:
                    streams[i].append(tok)
                if fin is not None:
                    done.set()
            engine.submit(req_cls(prompt=rng.integers(0, 256, n).tolist(),
                                  max_tokens=max_tokens,
                                  sampling=sp_cls(**kw), emit=emit))
            assert done.wait(timeout), "stream did not finish"
        assert engine.healthy, engine.last_error
        load = engine.moe_expert_load()
        drops = engine.moe_layer_drops()
    finally:
        engine.stop()
    return streams, load, drops


def test_ep2_streams_and_routing_counts_are_the_references(weights,
                                                           replica):
    jp, tp = weights
    jeng = jengine.Engine(jp, jmixtral.TINY_MOE, jengine.EngineConfig(**CFG),
                          eos_token_ids=EOS, fns=jfamily_fns("mixtral"),
                          mesh=jmake_mesh(JMeshSpec(ep=2)))
    teng = tengine.Engine(tp, tmixtral.TINY_MOE, tengine.EngineConfig(**CFG),
                          eos_token_ids=EOS, fns=tfamily_fns("mixtral"),
                          device="cpu", mesh=replica.mesh)
    assert teng.mesh_axes() == jeng.mesh_axes() == {
        "dp": 1, "tp": 1, "sp": 1, "ep": 2, "pp": 1}
    # the reference prices ep as an all-to-all; the port copies the
    # figure as it is
    assert teng.stats.ici_bytes_per_token == jeng.ici_bytes_per_token > 0
    # each rank holds two of the four experts, every column of them
    assert teng.params["l0.w_gate"].shape == (2, 64, 128)
    # the routing counts of one prefill call on the two ranks (the
    # engine's device operation, before it starts) against the
    # reference model's on one device: every row and every count
    toks = np.random.default_rng(5).integers(0, 256, (2, 24)).astype(
        np.int32)
    lens = np.array([24, 17], np.int32)
    pt = np.arange(4, dtype=np.int32).reshape(2, 2)
    from aigw_tpu.models import kvq as jkvq

    cfg = jmixtral.TINY_MOE
    _l, _kv, jstats = jmixtral.prefill(
        jp, cfg, jnp.asarray(toks), jnp.asarray(lens),
        jkvq.make_pool((cfg.n_layers, 2, 5 * 16, cfg.n_kv_heads,
                        cfg.head_dim), "float32"),
        jnp.asarray(pt), 16, moe_stats=True)
    _tok, tstats = teng._prefill_step(
        teng.fns.prefill, (torch.from_numpy(toks), torch.from_numpy(lens),
                           torch.from_numpy(pt)),
        (torch.zeros((2, 2), dtype=torch.int64), torch.zeros(2),
         torch.ones(2), torch.zeros(2, dtype=torch.int32),
         torch.zeros((2, cfg.vocab_size)),
         torch.full((2,), teng._base_row, dtype=torch.int32)))
    np.testing.assert_array_equal(tstats.numpy(), np.asarray(jstats))
    # the served streams, greedy and seeded (the engines' routing totals
    # count every window run, the junk steps a finished stream's window
    # still runs included, and their number follows the scheduler's
    # timing in both frameworks: reported by the engine, not compared)
    want = _run(jeng, jengine.GenRequest, JSampling)
    got = _run(teng, tengine.GenRequest, TSampling)
    assert got[0] == want[0]
    assert sum(got[1]) > 0 and len(got[1]) == len(want[1]) == 4


def test_embeddings_and_launch_counts_on_the_engine_thread(weights,
                                                           replica):
    """On a mesh ``hidden_states`` (``/v1/embeddings``) and the per-rank
    launch counts are jobs of the engine thread: every rank joins them
    in the leader's order."""
    _jp, tp = weights
    teng = tengine.Engine(tp, tmixtral.TINY_MOE, tengine.EngineConfig(**CFG),
                          eos_token_ids=EOS, fns=tfamily_fns("mixtral"),
                          device="cpu", mesh=replica.mesh)
    teng.start()
    try:
        toks = torch.tensor([[3, 1, 4, 1, 5, 9, 2, 6]], dtype=torch.int32)
        # the embeddings pass runs on the engine thread on a mesh
        h = teng.hidden_states(toks, torch.tensor([8], dtype=torch.int32))
        assert h.shape == (1, 64) and bool(torch.isfinite(h).all())
        counts = teng.rank_counts(["qmatmul.w8a16_matmul"])
        assert len(counts) == 2 and counts[0] == counts[1]
    finally:
        teng.stop()

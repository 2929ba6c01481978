"""chip_smoke.py's native core block (``_gw_core``) on two tiny-random CPU
replicas: ``aigw-core`` and the scanner library built with g++,
``core-config`` compiling the replicas' rule native and stopping at the
pinned rule, the core in front of ``python -m aigw_tpu_torch run`` on the
fallback port tailing the core's access log, native and fallback streams
equal to direct, ``/aigw-core/stats`` counting the traffic, one gateway
span per native request under its client's trace id, every gate held."""

import pytest

from aigw_tpu_torch.tpuserve.engine import EngineConfig
from aigw_tpu_torch.tpuserve.server import TPUServeServer


@pytest.fixture(scope="module")
def replicas():
    reps = [TPUServeServer(
        "tiny-random", EngineConfig(max_batch_size=4, max_seq_len=1024,
                                    page_size=16, enable_prefix_cache=False),
        device="cpu", port=0, param_dtype="float32") for _ in range(2)]
    for r in reps:
        r.start()
    yield reps
    for r in reps:
        r.stop()


def test_chip_smoke_core_block_on_cpu_replicas(replicas):
    import chip_smoke as cs

    out = cs._gw_core(replicas, model="tiny-random")
    # the equality checks, then an untimed burst and the turns' on each
    bursts = (1 + cs.GW_CORE_TURNS) * cs.GW_CORE_BURST
    n_native = cs.GW_CORE_CHECKS + bursts
    assert out["sent"] == {"native": n_native, "fallback": 1 + bursts}
    assert out["stats"]["native_requests"] == n_native
    assert sum(out["stats"]["per_backend"].values()) == n_native
    assert min(out["stats"]["per_backend"].values()) > 0  # 1:1 weights
    assert out["native_spans"] == n_native
    assert out["streams_equal_direct"] == cs.GW_CORE_CHECKS + 1
    assert out["startup"][0].startswith("native-core telemetry: tailing ")
    assert out["startup"][1].startswith("native scanners: ")
    assert set(out["paths"]) == {"direct", "gateway", "core_native",
                                 "direct_one", "core_fallback"}
    assert all(len(v) == cs.GW_CORE_TURNS for v in out["turns"].values())
    assert set(out["builds"]) == {"scanner", "core"}
    line = cs._core_line(out, {"ragged_prefill_attention": 1,
                               "fused_paged_decode": 1}, "cpu")
    assert line.startswith("serve_gateway core (cpu): builds scanner ")

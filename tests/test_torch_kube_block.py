"""chip_smoke.py's cluster block (``_gw_kube``) on two tiny-random CPU
replicas: the webhook over TLS, ``validate kube:``, two gateways on one
Lease in front of the replicas (one from a JSON-text kubeconfig, one from
the webhook's injected sidecar args in-cluster) against the block's
standard-library TLS API server, a route edit, a bad route, a watch
ended by a 410 with an edit in the gap, the leader's SIGTERM and the
follower's takeover, and the typed clientset, every gate held."""

import pytest

from aigw_tpu_torch.tpuserve.engine import EngineConfig
from aigw_tpu_torch.tpuserve.server import TPUServeServer


@pytest.fixture(scope="module")
def replicas():
    reps = [TPUServeServer(
        "tiny-random", EngineConfig(max_batch_size=4, max_seq_len=256,
                                    page_size=16, enable_prefix_cache=False),
        device="cpu", port=0, param_dtype="float32") for _ in range(2)]
    for r in reps:
        r.start()
    yield reps
    for r in reps:
        r.stop()


def test_chip_smoke_kube_block_on_cpu_replicas(replicas):
    import chip_smoke as cs

    out = cs._gw_kube(replicas, model="tiny-random")
    assert out["tls"] is True
    assert out["validate"]["ok_rc"] == 0 and out["validate"]["bad_rc"] == 1
    assert out["before"] == {"k0": [0, 0], "k1": [0, 0]}
    assert out["patches_b"] == {"AIServiceBackend/llama-0": 1,
                                "AIServiceBackend/llama-1": 1,
                                "AIGatewayRoute/serving": 1}
    assert all(v is not None for v in out["route_moved_s"].values())
    assert out["bad_route"]["serving"] == {"k0": 1, "k1": 1}
    assert out["watch_loss"]["streams_ended"] == 2
    assert 0 <= out["takeover_s"] <= cs.GW_KUBE_RENEW_S + 1.0
    assert out["after_takeover"]["last_route_patch_by"] == "token-k1"
    assert out["typed"]["store"] == ["bad-route", "serving", "typed"]
    assert out["lease_writes"]["token-k0"] > 0
    assert out["patches"]["token-k1"] > 0

"""The port's command line in subprocesses, held against the
reference's: ``validate``, ``status``, ``translate``, ``healthcheck``
and ``--version`` print what ``python -m aigw_tpu`` prints and exit as
it exits; ``run``'s refusals; ``run`` over a bundle directory; and
``chip_smoke.py``'s control block on two CPU replicas: ``run --workers
2`` sharing one port, one quota budget and the Responses store, a
``--reuse-port`` roll with no failed request, ``run DIR`` over a
manifest directory with a quarantined object, and ``run`` with no config
(autoconfig)."""

import asyncio
import json
import pathlib
import signal
import subprocess
import sys
import threading
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest
import yaml

from aigw_tpu_torch.config import bundle as tbundle
from aigw_tpu_torch.config import model as tmodel
from aigw_tpu_torch.config import runtime as truntime
from aigw_tpu_torch.gateway import server as tserver
from aigw_tpu_torch.tpuserve.engine import EngineConfig
from aigw_tpu_torch.tpuserve.server import TPUServeServer

ROOT = pathlib.Path(__file__).resolve().parent.parent
AIGW = "aigateway.envoyproxy.io/v1alpha1"


def _cli(pkg: str, *args, env=None):
    import os

    proc = subprocess.run([sys.executable, "-m", pkg, *args], cwd=ROOT,
                          capture_output=True, text=True, timeout=120,
                          env=dict(os.environ, **(env or {})))
    return proc.returncode, proc.stdout, proc.stderr


def _crd(kind, name, spec, api=AIGW):
    return {"apiVersion": api, "kind": kind, "metadata": {"name": name},
            "spec": spec}


def _manifests(d: pathlib.Path, broken: bool) -> None:
    d.mkdir()
    docs = [
        _crd("Backend", "a", {"endpoints": [{"ip": {
            "address": "127.0.0.1", "port": 9}}]},
            "gateway.envoyproxy.io/v1alpha1"),
        _crd("AIServiceBackend", "a", {"schema": {"name": "OpenAI"},
                                       "backendRef": {"name": "a"}}),
        _crd("AIGatewayRoute", "r", {"rules": [{"matches": [{"headers": [
            {"type": "Exact", "name": "x-ai-eg-model", "value": "m"}]}],
            "backendRefs": [{"name": "a"}]}],
            "llmRequestCosts": [{"metadataKey": "t", "type": "TotalToken"}]})]
    (d / "all.yaml").write_text(yaml.safe_dump_all(docs))
    if broken:
        (d / "bad.yaml").write_text(yaml.safe_dump_all([
            _crd("AIServiceBackend", "b", {"schema": {"name": "Nope"}}),
            _crd("MCPRoute", "m", {"backendRefs": []})]))
        (d / "torn.yml").write_text("kind: [\n")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    _manifests(root / "clean", broken=False)
    _manifests(root / "broken", broken=True)
    (root / "plain").mkdir()
    (root / "bad.json").write_text(json.dumps({
        "version": "v1", "backends": [{"name": "x", "schema": "Nope",
                                       "url": "http://a"}]}))
    (root / "crd.yaml").write_text((root / "clean" / "all.yaml").read_text())
    (root / "quota.json").write_text(json.dumps({
        "version": "v1",
        "backends": [{"name": "p", "schema": "TPUServe",
                      "endpoints": ["127.0.0.1:1"]},
                     {"name": "o", "schema": "OpenAI", "url": "http://a",
                      "auth": {"kind": "APIKey", "api_key": "k"}},
                     {"name": "c", "schema": "Cohere", "url": "http://c"}],
        "routes": [{"name": "r", "rules": [
            {"models": ["m"], "model_prefixes": ["g"],
             "backends": [{"backend": "p", "weight": 2},
                          {"backend": "o", "priority": 1}]},
            {"backends": ["c"]}]}],
        "models": ["m"],
        "llm_request_costs": [{"metadata_key": "t", "type": "TotalToken"}],
        "quotas": [{"name": "q", "metadata_key": "t", "limit": 5}],
        "mcp": {"backends": [{"name": "kb", "url": "http://127.0.0.1:2"}]}}))
    return root


CASES = {
    "validate-json": ["validate", "{quota}"],
    "validate-example": ["validate", "examples/inference-pool/config.yaml"],
    "validate-crd-file": ["validate", "{crd}"],
    "validate-invalid": ["validate", "{bad}"],
    "validate-missing": ["validate", "{missing}"],
    "validate-dir": ["validate", "{clean}"],
    "validate-dir-broken": ["validate", "{broken}"],
    "status-dir": ["status", "{clean}"],
    "status-dir-broken": ["status", "{broken}"],
    "status-dir-broken-json": ["status", "{broken}", "--json"],
    "status-not-a-dir": ["status", "{plain}"],
    "translate-json": ["translate", "{quota}"],
    "translate-crd-file": ["translate", "{crd}"],
    "translate-basic": ["translate", "examples/basic/config.yaml"],
    "translate-mcp": ["translate", "examples/mcp/config.yaml"],
    "translate-invalid": ["translate", "{bad}"],
    "version": ["--version"],
}


def _mask_times(text: str) -> str:
    """A live reconcile stamps its conditions with the clock: the JSON
    view's transition times masked."""
    try:
        data = json.loads(text)
    except json.JSONDecodeError:
        return text
    for cond in data.get("objects", {}).values():
        cond.pop("lastTransitionTime", None)
    return json.dumps(data, sort_keys=True)


@pytest.mark.parametrize("case", sorted(CASES))
def test_cli_tools_match_reference(case, files):
    names = {"quota": "quota.json", "crd": "crd.yaml", "bad": "bad.json",
             "missing": "missing.json", "clean": "clean",
             "broken": "broken", "plain": "plain"}
    args = [a.format(**{k: files / v for k, v in names.items()})
            for a in CASES[case]]
    want = _cli("aigw_tpu", *args)
    got = _cli("aigw_tpu_torch", *args)
    assert (got[0], _mask_times(got[1])) == (want[0], _mask_times(want[1]))
    # what each prints on stderr under its own lines: the verdicts
    verdicts = [[ln.split(":")[0] if ln.startswith("INVALID") else ln
                 for ln in err.splitlines() if ln.startswith((
                     "NOT ACCEPTED", "INVALID", "aigw"))]
                for err in (got[2], want[2])]
    assert verdicts[0] == verdicts[1]
    assert got[0] == (1 if "broken" in case or "invalid" in case
                      or "missing" in case else
                      2 if case == "status-not-a-dir" else 0)


class _Health(BaseHTTPRequestHandler):
    def do_GET(self):  # noqa: N802
        body = json.dumps({"status": "draining"}).encode()
        self.send_response(200)
        self.send_header("content-length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *a):
        pass


def test_healthcheck_matches_reference():
    """A running port gateway (healthy), a server answering another
    status, and a closed port: the same output and exit codes."""
    fake = ThreadingHTTPServer(("127.0.0.1", 0), _Health)
    threading.Thread(target=fake.serve_forever, daemon=True).start()
    loop = asyncio.new_event_loop()
    thread = threading.Thread(target=loop.run_forever, daemon=True)
    thread.start()

    def on(coro):
        return asyncio.run_coroutine_threadsafe(coro, loop).result(60)

    gw = on(tserver.run_gateway(truntime.RuntimeConfig.build(
        tmodel.Config.parse({"version": "v1", "uuid": "hc", "backends": [],
                             "routes": []})), port=0))
    try:
        for url, rc in ((f"http://127.0.0.1:{gw.port}", 0),
                        (f"http://127.0.0.1:{fake.server_address[1]}/", 1),
                        ("http://127.0.0.1:9", 1)):
            want = _cli("aigw_tpu", "healthcheck", url, "--timeout", "5")
            got = _cli("aigw_tpu_torch", "healthcheck", url, "--timeout", "5")
            assert got == want and got[0] == rc
        assert json.loads(_cli("aigw_tpu_torch", "healthcheck",
                               f"http://127.0.0.1:{gw.port}")[1])[
            "uuid"] == "hc"
    finally:
        on(gw.stop())
        loop.call_soon_threadsafe(loop.stop)
        thread.join(timeout=10)
        loop.close()
        fake.shutdown()
        fake.server_close()


@pytest.mark.parametrize("args,msg", [
    (["--port", "0", "--workers", "2"],
     "--workers requires an explicit --port"),
    (["--port", "1", "--workers", "2", "--mcp-json", "{}"],
     "config error: --mcp-config/--mcp-json is incompatible with --workers"),
])
def test_run_refusals_match_reference(args, msg, files):
    want = _cli("aigw_tpu", "run", str(files / "quota.json"), *args)
    got = _cli("aigw_tpu_torch", "run", str(files / "quota.json"), *args)
    assert got[0] == want[0] == 1
    assert got[2].strip().splitlines()[-1] == \
        want[2].strip().splitlines()[-1]
    assert got[2].startswith(msg)


def test_run_refuses_a_live_cluster_and_empty_environment(files):
    # outside a cluster, kube:in-cluster ends as the reference's does
    got = [_cli(pkg, "run", "kube:in-cluster", "--port", "0",
                env={"KUBERNETES_SERVICE_HOST": ""})
           for pkg in ("aigw_tpu", "aigw_tpu_torch")]
    assert got[1][0] == got[0][0] == 1
    assert got[1][2].strip().splitlines()[-1] == \
        got[0][2].strip().splitlines()[-1]
    assert "KUBERNETES_SERVICE_HOST unset" in got[1][2]
    env = {k: "" for k in ("OPENAI_API_KEY", "ANTHROPIC_API_KEY",
                           "AZURE_OPENAI_API_KEY", "TPUSERVE_URL")}
    rc, _out, err = _cli("aigw_tpu_torch", "run", "--port", "0", env=env)
    assert rc == 1 and "config error: autoconfig found no credentials" in err


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


def test_run_serves_a_bundle_directory(replicas, tmp_path):
    """``run BUNDLE`` serves a chat through the bundle's pool, and a
    rewritten bundle (another uuid) is picked up by the watcher."""
    import chip_smoke as cs

    cfg = {"version": "v1", "uuid": "b1", "backends": [
        {"name": "p", "schema": "TPUServe",
         "endpoints": [f"127.0.0.1:{r.port}" for r in replicas]}],
        "routes": [{"name": "r", "rules": [{"backends": ["p"]}]}]}
    bdir = tmp_path / "bundle"
    tbundle.write_bundle(tmodel.Config.parse(cfg), str(bdir), part_size=100)
    proc, port, err, _lines = cs._spawn_gateway(
        [str(bdir), "--port", "0", "--watch-interval", "0.2"],
        str(tmp_path), "bundle")
    try:
        out = cs._gw_call(port, "chat", False, {
            "model": "tiny-random", "max_tokens": 4, "temperature": 0,
            "messages": [{"role": "user", "content": "hi"}]})
        assert out["n"] == 4
        tbundle.write_bundle(tmodel.Config.parse(dict(cfg, uuid="b2")),
                             str(bdir))
        cs._gw_wait(lambda: cs._gw_json(port, "/health")["uuid"] == "b2",
                    "the rewritten bundle", 10)
        # a watched source that is not a manifest directory has no
        # objects to refuse (the reference's /health says the same)
        assert cs._gw_json(port, "/health")["objects_not_accepted"] == 0
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=30) == 0
    finally:
        cs._stop_tree(proc)
        err.close()


def test_chip_smoke_control_block_on_cpu_replicas(replicas):
    """chip_smoke's ``_gw_control`` on two tiny-random CPU replicas, every
    gate: ``--workers 2`` on one port (the burst spread over both
    workers, streams equal to direct, one quota budget, the Responses
    store), a ``--reuse-port`` roll with no failed request, ``run DIR``
    rerouted and quarantining, and autoconfig."""
    import chip_smoke as cs

    out = cs._gw_control(replicas, model="tiny-random")
    assert out["streams_equal_direct"] == 4 and out["ties"] == 0
    q = out["quota"]
    assert q["workers"] == q["one_process"] == [200] * 3 + [429] * 5
    assert out["responses_followups"] == [200] * 8
    assert all(0 < v < 8 for v in out["burst"]["per_worker_seen"])
    roll = out["roll"]
    assert roll["failures"] == [] and roll["uuids_after"] == ["roll-new"]
    assert roll["requests"] > 2
    m = out["manifests"]
    assert (m["before"], m["after"], m["serving_while_quarantined"]) == \
        ([0, 0], [1, 1, 1], [1])
    assert m["not_accepted"] == ["AIServiceBackend/llama-bad"]
    assert m["status"] == {"rc": 1, "not_accepted": [
        "AIServiceBackend/llama-bad"], "objects": 6,
        "source": "aigw-status.json"}
    assert m["validate_rc"] == 1
    assert out["autoconfig"]["startup"] == [
        "autoconfig: 1 backend(s): tpuserve"]


def test_health_counts_objects_not_accepted(tmp_path):
    """``/health`` of a gateway over a manifest directory carries
    ``objects_not_accepted`` and, when non-zero, the sorted keys, as the
    reference's does."""
    from aigw_tpu_torch.config.watcher import ConfigWatcher

    _manifests(tmp_path / "m", broken=True)

    async def main():
        w = ConfigWatcher(str(tmp_path / "m"), lambda rc: None)
        srv = await tserver.run_gateway(w.load_initial(), port=0)
        srv.conditions_fn = w.not_accepted
        try:
            body = await asyncio.to_thread(
                lambda: urllib.request.urlopen(
                    f"http://127.0.0.1:{srv.port}/health", timeout=10).read())
        finally:
            await srv.stop()
        return json.loads(body)

    health = asyncio.run(main())
    assert health["objects_not_accepted"] == 3
    assert health["not_accepted"] == ["AIServiceBackend/b", "MCPRoute/m",
                                      "file/torn.yml"]

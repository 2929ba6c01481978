"""The port's live cluster source (``aigw_tpu_torch/config/kube.py``)
held against the reference's (``aigw_tpu/config/kube.py``) on one fake
API server, the reference's ``tests.test_kube.FakeAPIServer`` (list,
chunked watch streams with heartbeats, merge-patch of ``/status``,
Leases), run on a thread of its own for the module: kubeconfig parsing
and the tables, two sources (one per package) through the same applies,
deletes and an injected 410, the two reconcilers' configs, conditions
and status patches, leader election (the reference's five cases on the
port's elector, and a port elector and a reference elector on one
Lease), and the command line: ``validate kube:`` against the
reference's, and ``run kube:in-cluster`` with the webhook's sidecar
args over TLS rerouting live chats and landing conditions."""

import asyncio
import base64
import dataclasses
import json
import os
import pathlib
import signal
import ssl
import subprocess
import sys
import threading
import time
import urllib.request

import pytest
import yaml

from aigw_tpu.config import kube as jkube
from aigw_tpu_torch.config import kube as tkube
from aigw_tpu_torch.config import webhook as twebhook
from tests.fakes import FakeUpstream, openai_chat_response
from tests.test_kube import FakeAPIServer, _backend_objs, _route_obj

ROOT = pathlib.Path(__file__).resolve().parent.parent
KINDS = ("jax", "torch")
PKG = {"jax": jkube, "torch": tkube}


class ApiThread:
    """A ``FakeAPIServer`` on an event loop of its own thread, so both
    packages' sources, reconcilers and command lines reach it from
    anywhere."""

    def __init__(self, ssl_context=None):
        self.api = FakeAPIServer()
        self.loop = asyncio.new_event_loop()
        self._thread = threading.Thread(target=self.loop.run_forever,
                                        daemon=True)
        self._thread.start()
        self.run(self.api.start(ssl_context))

    def run(self, coro, timeout: float = 30.0):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(
            timeout)

    def call(self, fn):
        async def on_loop():
            return fn()

        return self.run(on_loop())

    def put(self, *objs) -> None:
        """Objects in the store without a watch event (set-up)."""
        def do():
            for obj in objs:
                self.api.objects[FakeAPIServer._key(obj)] = obj

        self.call(do)

    def reset(self) -> None:
        def do():
            self.api.objects.clear()
            self.api.leases.clear()
            self.api.status_patches.clear()

        self.call(do)

    def streams(self, kind: str) -> set:
        return self.call(lambda: {id(q) for k, q in self.api._streams
                                  if k == kind})

    def close(self) -> None:
        self.run(self.api.stop())
        self.loop.call_soon_threadsafe(self.loop.stop)
        self._thread.join(timeout=10)


@pytest.fixture(scope="module")
def fake():
    t = ApiThread()
    yield t
    t.close()


@pytest.fixture
def api(fake):
    fake.reset()
    yield fake
    fake.reset()


def _wait(pred, what, timeout: float = 15.0) -> None:
    deadline = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.05)


def _kubeconfig(tmp_path, doc: dict, as_json: bool = False) -> str:
    path = tmp_path / ("kubeconfig.json" if as_json else "kubeconfig")
    path.write_text(json.dumps(doc) if as_json else yaml.safe_dump(doc))
    return str(path)


def _kc_doc(server: str, user: dict | None = None,
            cluster: dict | None = None, context: str = "test") -> dict:
    return {
        "apiVersion": "v1", "kind": "Config", "current-context": context,
        "contexts": [{"name": "test",
                      "context": {"cluster": "c", "user": "u"}}],
        "clusters": [{"name": "c", "cluster": {"server": server,
                                               **(cluster or {})}}],
        "users": [{"name": "u", "user": user or {"token": "test-token"}}],
    }


def _mk_cert(tmp_path, name: str) -> tuple[str, str]:
    crt, key = tmp_path / f"{name}.crt", tmp_path / f"{name}.key"
    subprocess.run(
        ["openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes",
         "-keyout", str(key), "-out", str(crt), "-days", "1",
         "-subj", "/CN=127.0.0.1", "-addext", "subjectAltName=IP:127.0.0.1"],
        check=True, capture_output=True)
    return str(crt), str(key)


def _auth_view(auth) -> dict:
    """A KubeAuth's fields, client certificates by their files' bytes
    (each package writes ``*-data`` to temporary files of its own)."""
    out = dataclasses.asdict(auth)
    if auth.client_cert:
        out["client_cert"] = tuple(pathlib.Path(p).read_bytes()
                                   for p in auth.client_cert)
    return out


# -- kubeconfig and tables ---------------------------------------------------------
def test_tables_equal_the_reference():
    assert tkube.RESOURCES == jkube.RESOURCES
    assert tkube.STATUS_KINDS == jkube.STATUS_KINDS
    assert tkube.LEASE_PATH == jkube.LEASE_PATH
    for kind in jkube.RESOURCES:
        for ns, name in (("", ""), ("ns1", ""), ("ns1", "o1"), ("", "o1")):
            assert tkube.resource_path(kind, ns, name) == \
                jkube.resource_path(kind, ns, name), (kind, ns, name)


@pytest.mark.parametrize("case", [
    "token", "token_file", "cert_data", "cert_files", "ca_file",
    "insecure", "missing_context", "no_server"])
def test_kubeconfig_matches_reference(case, tmp_path):
    crt, key = _mk_cert(tmp_path, "client")
    b64 = {p: base64.b64encode(pathlib.Path(p).read_bytes()).decode()
           for p in (crt, key)}
    server = "https://127.0.0.1:6443"
    (tmp_path / "tok").write_text("from-file\n")
    doc = {
        "token": _kc_doc("http://127.0.0.1:8443"),
        "token_file": _kc_doc(server, {"tokenFile": str(tmp_path / "tok")},
                              {"certificate-authority-data": b64[crt]}),
        "cert_data": _kc_doc(server, {"client-certificate-data": b64[crt],
                                      "client-key-data": b64[key]},
                             {"certificate-authority-data": b64[crt]}),
        "cert_files": _kc_doc(server + "/", {"client-certificate": crt,
                                             "client-key": key},
                              {"certificate-authority": crt}),
        "ca_file": _kc_doc(server, None, {"certificate-authority": crt}),
        "insecure": _kc_doc(server, None, {"insecure-skip-tls-verify": True}),
        "missing_context": _kc_doc(server, context="nope"),
        "no_server": _kc_doc("", None),
    }[case]
    path = _kubeconfig(tmp_path, doc)
    got = {}
    for k in KINDS:
        try:
            auth = PKG[k].load_kubeconfig(path)
        except ValueError as e:
            got[k] = (type(e), str(e))
            continue
        ctx = auth.ssl_context()
        got[k] = (_auth_view(auth), ctx if ctx is False else (
            ctx.verify_mode, ctx.check_hostname,
            len(ctx.get_ca_certs())))
    assert got["torch"] == got["jax"]


def test_json_kubeconfig_loads_with_yaml_blocked(tmp_path):
    """Without pyyaml (the card machine) a kubeconfig of JSON text loads
    as the reference loads it; YAML text raises naming pyyaml."""
    doc = _kc_doc("http://127.0.0.1:8443", {"token": "t0"})
    jpath = _kubeconfig(tmp_path, doc, as_json=True)
    ypath = _kubeconfig(tmp_path, doc)
    code = (
        "import sys, json, dataclasses\n"
        "sys.modules['yaml'] = None\n"
        "from aigw_tpu_torch.config import kube\n"
        f"a = kube.parse_kube_target('kube:{jpath}')\n"
        "print(json.dumps(dataclasses.asdict(a)))\n"
        "try:\n"
        f"    kube.load_kubeconfig({ypath!r})\n"
        "except ValueError as e:\n"
        "    print(type(e).__name__, e)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert json.loads(lines[0]) == dataclasses.asdict(
        jkube.load_kubeconfig(jpath))
    assert lines[1].startswith("ConfigError") and "pyyaml" in lines[1]


def test_parse_kube_target_matches_reference(tmp_path, monkeypatch):
    path = _kubeconfig(tmp_path, _kc_doc("http://127.0.0.1:1"))
    monkeypatch.delenv("KUBERNETES_SERVICE_HOST", raising=False)
    monkeypatch.setenv("HOME", str(tmp_path))
    def same(target):
        return dataclasses.asdict(tkube.parse_kube_target(target)) == \
            dataclasses.asdict(jkube.parse_kube_target(target))

    assert same(f"kube:{path}") and same(path)
    monkeypatch.setenv("KUBECONFIG", path)
    assert same("kube:")
    monkeypatch.delenv("KUBECONFIG")
    errs = []
    for k in KINDS:
        with pytest.raises(ValueError) as e:
            PKG[k].parse_kube_target("kube:")
        errs.append(str(e.value))
    assert errs[0] == errs[1] and "KUBERNETES_SERVICE_HOST" in errs[0]
    sa = tmp_path / "sa"
    sa.mkdir()
    (sa / "token").write_text("sa-token\n")
    (sa / "ca.crt").write_bytes(b"ca-bytes")
    (sa / "namespace").write_text("team-a")
    monkeypatch.setenv("KUBERNETES_SERVICE_HOST", "10.0.0.1")
    monkeypatch.setenv("AIGW_SA_DIR", str(sa))
    assert same("kube:in-cluster")
    assert tkube._pod_namespace() == jkube._pod_namespace() == "team-a"


# -- sources and reconcilers --------------------------------------------------------
def _start_source(k: str, url: str, events: list | None = None, **kw):
    src = PKG[k].KubeSource(PKG[k].KubeAuth(server=url), **kw)
    if events is not None:
        src.add_listener(lambda et, o: events.append((
            et, o.get("kind"), (o.get("metadata") or {}).get("name"),
            (o.get("metadata") or {}).get("resourceVersion"))))
    src.start()
    assert src.wait_synced(30)
    return src


def _names(src, kind="AIGatewayRoute") -> list:
    return sorted(o["metadata"]["name"] for o in src.objects()
                  if o["kind"] == kind)


def test_sources_see_the_same_events_and_resync(api):
    """Both packages' sources through applies, a delete, an in-stream
    410 with an apply, a modify and a delete in the gap (only the
    re-list sees them: the resync delta), then a watch event again."""
    api.put(_route_obj("r1", "m1", "b1"), _route_obj("r0", "m0", "b1"),
            *_backend_objs("b1", "127.0.0.1", 9))
    events = {k: [] for k in KINDS}
    old = api.streams("AIGatewayRoute")
    srcs = {k: _start_source(k, api.api.url, events[k]) for k in KINDS}
    try:
        def both(pred):
            return all(pred(s) for s in srcs.values())

        # the fake replays nothing to a watch that starts late: apply
        # once both watch
        _wait(lambda: len(api.streams("AIGatewayRoute") - old) == 2,
              "both watches")

        gen0 = {k: s.generation for k, s in srcs.items()}
        api.api.apply(_route_obj("r2", "m2", "b1"))
        _wait(lambda: both(lambda s: "r2" in _names(s)), "r2")
        api.api.delete("AIGatewayRoute", "default", "r2")
        _wait(lambda: both(lambda s: "r2" not in _names(s)), "r2 deleted")
        assert all(srcs[k].generation > gen0[k] for k in KINDS)
        old = api.streams("AIGatewayRoute")
        # the 410, then the gap's changes (their stream lines come after
        # the error line, which ends each stream)
        api.api.push_error("AIGatewayRoute")
        api.api.apply(_route_obj("r3", "m3", "b1"))
        api.api.apply(_route_obj("r0", "m0-moved", "b1", generation=2))
        api.api.delete("AIGatewayRoute", "default", "r1")
        _wait(lambda: both(lambda s: _names(s) == ["r0", "r3"]),
              "the re-list", 20)
        _wait(lambda: len(api.streams("AIGatewayRoute") - old) == 2,
              "both watches back")
        assert all(o.get("kind") != "Status"
                   for s in srcs.values() for o in s.objects())
        api.api.apply(_route_obj("r4", "m4", "b1"))
        _wait(lambda: both(lambda s: "r4" in _names(s)), "r4")
    finally:
        for s in srcs.values():
            s.stop()

    def key(o):
        return (o["kind"], o["metadata"]["name"])

    assert sorted(srcs["torch"].objects(), key=key) == \
        sorted(srcs["jax"].objects(), key=key)

    def per_kind(evs):
        out = {}
        for ev in evs:
            out.setdefault(ev[1], []).append(ev)
        return out

    assert per_kind(events["torch"]) == per_kind(events["jax"])
    routes = [(e, n) for e, _k, n, _rv in
              per_kind(events["torch"])["AIGatewayRoute"]]
    assert routes == [("ADDED", "r1"), ("ADDED", "r0"), ("ADDED", "r2"),
                      ("DELETED", "r2"), ("DELETED", "r1"),
                      ("MODIFIED", "r0"), ("ADDED", "r3"), ("ADDED", "r4")]


def _cluster_objects() -> list:
    return (_backend_objs("be-a", "127.0.0.1", 9101)
            + _backend_objs("be-b", "127.0.0.1", 9102)
            + [_route_obj("r1", "m1", "be-a"),
               _route_obj("r2", "m2", "be-b", ns="team", generation=3),
               {"apiVersion": "aigateway.envoyproxy.io/v1alpha1",
                "kind": "BackendSecurityPolicy",
                "metadata": {"name": "bad-bsp", "namespace": "default",
                             "generation": 1},
                "spec": {"type": "Bogus", "targetRefs": [{"name": "be-b"}]}},
               {"apiVersion": "aigateway.envoyproxy.io/v1alpha1",
                "kind": "QuotaPolicy",
                "metadata": {"name": "q1", "namespace": "default",
                             "generation": 1},
                "spec": {"targetRefs": [{"kind": "AIServiceBackend",
                                         "name": "be-a"}],
                         "perModelQuotas": [{"modelName": "m1", "quota": {
                             "defaultBucket": {"duration": "1h",
                                               "limit": 60}}}]}}])


def _untimed(conds: dict) -> dict:
    return {k: {f: v for f, v in c.items() if f != "lastTransitionTime"}
            for k, c in conds.items()}


def test_reconcilers_match_reference(api, tmp_path):
    """The same cluster through each package's source and reconciler:
    equal configs and conditions, equal status patches (apart from
    times), deduplicated on the next tick, a failed patch's stamp
    cleared, and a dry run patching nothing."""
    objs = _cluster_objects()
    status_kinds = sum(o["kind"] in jkube.STATUS_KINDS for o in objs)
    got = {}
    for k in KINDS:
        api.reset()
        api.put(*json.loads(json.dumps(objs)))
        src = _start_source(k, api.api.url)
        try:
            dry = PKG[k].KubeReconciler(
                src, status_path=str(tmp_path / f"{k}-dry.json"),
                leader_election=False, dry_run=True)
            dry.load()
            rec = PKG[k].KubeReconciler(
                src, status_path=str(tmp_path / f"{k}.json"),
                leader_election=False)
            cfg = rec.load()
            _wait(lambda: len(api.api.status_patches) >= status_kinds,
                  "the status patches")
            rec.load()
            time.sleep(0.3)
            patches = list(api.api.status_patches)
            # a patch the server refuses (its object gone, no event):
            # the stamp is cleared so the next tick retries
            api.call(lambda: api.api.objects.pop(
                ("AIGatewayRoute", "default", "r1")))
            rec._patched["AIGatewayRoute/r1"] = "stale"
            rec.load()
            _wait(lambda: "AIGatewayRoute/r1" not in rec._patched,
                  "the failed patch's stamp cleared")
        finally:
            src.stop()
        got[k] = {
            "config": cfg.to_dict(), "checksum": cfg.checksum(),
            "conditions": _untimed(rec.conditions()),
            "dry": _untimed(dry.conditions()),
            "not_accepted": sorted(rec.not_accepted()),
            "patches": sorted(
                (key, [{f: v for f, v in c.items()
                        if f != "lastTransitionTime"}
                       for c in p["status"]["conditions"]])
                for key, p in patches),
            "status_file": sorted(json.loads(
                (tmp_path / f"{k}.json").read_text())["objects"]),
        }
    assert got["torch"] == got["jax"]
    assert len(got["torch"]["patches"]) == status_kinds
    assert got["torch"]["not_accepted"] == ["BackendSecurityPolicy/bad-bsp"]
    assert dict(got["torch"]["patches"])["AIGatewayRoute/r2"][0][
        "observedGeneration"] == 3


# -- leader election ----------------------------------------------------------------
def _elected(rec) -> bool:
    return rec._elector is not None and rec._elector.is_leader


def test_single_replica_elects_and_patches(api):
    api.put(*_backend_objs("b1", "127.0.0.1", 8901),
            _route_obj("r1", "m1", "b1"))
    src = _start_source("torch", api.api.url)
    try:
        rec = tkube.KubeReconciler(src)
        _wait(lambda: _elected(rec), "the election")
        assert "aigw-tpu-status-writer" in api.api.leases
        rec.load()
        _wait(lambda: api.api.status_patches, "a status patch")
    finally:
        rec.shutdown()
        src.stop()


def test_non_leader_serves_without_patching(api):
    api.put(*_backend_objs("b1", "127.0.0.1", 8901),
            _route_obj("r1", "m1", "b1"))
    api.call(lambda: api.api.leases.update({"aigw-tpu-status-writer": {
        "metadata": {"name": "aigw-tpu-status-writer"},
        "spec": {"holderIdentity": "other-replica",
                 "leaseDurationSeconds": 3600,
                 "renewTime": time.strftime("%Y-%m-%dT%H:%M:%S.000000Z",
                                            time.gmtime())}}}))
    src = _start_source("torch", api.api.url)
    try:
        rec = tkube.KubeReconciler(src)
        time.sleep(0.5)  # an election attempt
        assert not rec._elector.is_leader
        cfg = rec.load()
        assert [r.name for r in cfg.routes] == ["r1"]
        time.sleep(0.3)
        assert api.api.status_patches == []
    finally:
        rec._elector.stop()
        src.stop()


def test_takeover_on_expired_lease(api):
    api.call(lambda: api.api.leases.update({"aigw-tpu-status-writer": {
        "metadata": {"name": "aigw-tpu-status-writer"},
        "spec": {"holderIdentity": "dead-replica",
                 "leaseDurationSeconds": 1,
                 "renewTime": "2020-01-01T00:00:00Z"}}}))
    src = _start_source("torch", api.api.url)
    try:
        rec = tkube.KubeReconciler(src)
        _wait(lambda: _elected(rec), "the takeover")
        spec = api.api.leases["aigw-tpu-status-writer"]["spec"]
        assert spec["holderIdentity"] == rec._elector.identity
        assert spec["leaseTransitions"] == 1
    finally:
        rec._elector.stop()
        src.stop()


def test_stale_release_does_not_overwrite_new_holder(api):
    """A's Lease lapses, B acquires, then A's delayed surrender runs: it
    must not blank B's Lease (a third candidate could then acquire)."""

    async def main():
        clients = [tkube.KubeClient(tkube.KubeAuth(server=api.api.url))
                   for _ in range(3)]
        a, b, c = (tkube.LeaderElector(cl, lease_name="race", identity=i,
                                       lease_seconds=s)
                   for cl, i, s in zip(clients, "abc", (1.0, 60.0, 60.0)))
        try:
            assert await a.try_acquire()
            await asyncio.sleep(1.2)
            assert await b.try_acquire()
            await a.release()
            assert api.api.leases["race"]["spec"]["holderIdentity"] == "b"
            assert not await c.try_acquire()
            assert api.api.leases["race"]["spec"]["holderIdentity"] == "b"
        finally:
            for cl in clients:
                await cl.close()

    asyncio.run(main())


def test_release_on_shutdown(api):
    src = _start_source("torch", api.api.url)
    try:
        rec = tkube.KubeReconciler(src)
        _wait(lambda: _elected(rec), "the election")
        rec.shutdown()
        _wait(lambda: api.api.leases["aigw-tpu-status-writer"]["spec"].get(
            "holderIdentity") == "", "the surrender")
        peer = tkube.LeaderElector(src.client,
                                   lease_name="aigw-tpu-status-writer")
        fut = asyncio.run_coroutine_threadsafe(peer.try_acquire(), src._loop)
        assert fut.result(10)
    finally:
        src.stop()


def test_port_and_reference_electors_never_both_lead(api):
    """One Lease, a port candidate and a reference candidate renewing
    every 0.2 s: the Lease each writes has the reference's shape, one
    leads at a time, and a surrender hands over to the other."""
    lease = "mixed"

    async def main():
        cands = {k: PKG[k].LeaderElector(
            PKG[k].KubeClient(PKG[k].KubeAuth(server=api.api.url)),
            lease_name=lease, identity=k, lease_seconds=2.0,
            renew_seconds=0.2) for k in KINDS}
        bodies = {}
        for k in KINDS:  # each one's first write onto an absent Lease
            api.call(lambda: api.api.leases.clear())
            assert await cands[k].try_acquire()
            bodies[k] = api.api.leases[lease]
            cands[k]._leader = False
        api.call(lambda: api.api.leases.clear())
        tasks = [asyncio.create_task(c.run()) for c in cands.values()]
        both, leaders = 0, []
        try:
            for step in range(60):
                await asyncio.sleep(0.05)
                now = [k for k in KINDS if cands[k].is_leader]
                both += len(now) > 1
                leaders.append(tuple(now))
                if step == 30:
                    # the leader stops: its renew loop ends with the
                    # surrender
                    first = now[0]
                    cands[first].stop()
                    await tasks[KINDS.index(first)]
        finally:
            for c in cands.values():
                c.stop()
            await asyncio.gather(*tasks)
            for c in cands.values():
                await c.client.close()
        return bodies, both, leaders

    bodies, both, leaders = asyncio.run(main())

    def shape(b):
        spec = dict(b["spec"], holderIdentity="", acquireTime="",
                    renewTime="")
        return dict(b, spec=spec)

    assert shape(bodies["torch"]) == shape(bodies["jax"])
    assert both == 0, leaders
    held = [lead for lead in leaders if lead]
    assert held[0] != held[-1] and len(set(held)) == 2, leaders


# -- the command line ---------------------------------------------------------------
def _cli(pkg: str, *args, env=None):
    proc = subprocess.run([sys.executable, "-m", pkg, *args], cwd=ROOT,
                          capture_output=True, text=True, timeout=120,
                          env=dict(os.environ, **(env or {})))
    return proc.returncode, proc.stdout, proc.stderr


def _verdicts(err: str) -> list:
    return [ln for ln in err.splitlines()
            if ln.startswith(("NOT ACCEPTED", "INVALID"))]


@pytest.mark.parametrize("case", ["good", "bad", "no_kubeconfig"])
def test_validate_kube_matches_reference(case, api, tmp_path):
    objs = [o for o in _cluster_objects()
            if case == "bad" or o["metadata"]["name"] != "bad-bsp"]
    api.put(*objs)
    kc = (_kubeconfig(tmp_path, _kc_doc(api.api.url), as_json=True)
          if case != "no_kubeconfig" else "/no/such/kubeconfig")
    got = {k: _cli(f"aigw_tpu{'_torch' if k == 'torch' else ''}",
                   "validate", f"kube:{kc}", env={"JAX_PLATFORMS": "cpu"})
           for k in KINDS}
    assert got["torch"][0] == got["jax"][0] == (0 if case == "good" else 1)
    assert got["torch"][1] == got["jax"][1]
    assert _verdicts(got["torch"][2]) == _verdicts(got["jax"][2])
    if case == "good":
        assert got["torch"][1].startswith("OK: 2 backends, 2 routes")
    else:
        assert _verdicts(got["torch"][2])
    assert api.api.status_patches == []  # a dry run writes nothing


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _post_chat(port: int) -> tuple[int, str]:
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/chat/completions",
        data=json.dumps({"model": "m1", "messages": [
            {"role": "user", "content": "hi"}]}).encode(),
        headers={"content-type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as r:
        return r.status, json.loads(r.read())["choices"][0]["message"][
            "content"]


def test_run_in_cluster_sidecar_reroutes_and_lands_conditions(tmp_path):
    """The webhook's sidecar args (``run kube:in-cluster``) run as the
    port's gateway against a TLS API server (its token and CA through
    ``AIGW_SA_DIR``): chats reach upstream A, a route edit moves them to
    B, the leader patches Accepted onto the route and NotAccepted onto a
    bad policy, ``/health`` counts it, and SIGTERM surrenders the
    Lease."""
    crt, key = _mk_cert(tmp_path, "apiserver")
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.load_cert_chain(crt, key)
    t = ApiThread(ctx)
    ups = [FakeUpstream().on_json("/v1/chat/completions",
                                  openai_chat_response(content=c))
           for c in "AB"]
    for up in ups:
        t.run(up.start())
    hp = [up.url.split("//")[1].split(":") for up in ups]
    t.put(*_backend_objs("be-a", hp[0][0], int(hp[0][1])),
          *_backend_objs("be-b", hp[1][0], int(hp[1][1])),
          _route_obj("r1", "m1", "be-a"))
    sa = tmp_path / "sa"
    sa.mkdir()
    (sa / "token").write_text("sa-token")
    (sa / "ca.crt").write_bytes(pathlib.Path(crt).read_bytes())
    port = _free_port()
    err = open(tmp_path / "gateway.log", "w")
    args = twebhook.build_sidecar("img", port=port)["args"]
    args[args.index("--host") + 1] = "127.0.0.1"
    proc = subprocess.Popen(
        [sys.executable, "-m", "aigw_tpu_torch", *args,
         "--watch-interval", "0.2"], cwd=ROOT,
        env=dict(os.environ, KUBERNETES_SERVICE_HOST="127.0.0.1",
                 KUBERNETES_SERVICE_PORT=str(t.api.port),
                 AIGW_SA_DIR=str(sa), AIGW_DRAIN_SECONDS="0"),
        stdout=subprocess.PIPE, stderr=err, text=True)
    try:
        assert proc.stdout.readline().startswith("gateway listening on")
        _wait(lambda: t.streams("AIGatewayRoute")
              and t.streams("BackendSecurityPolicy"), "the watches")
        assert _post_chat(port) == (200, "A")
        t.api.apply(_route_obj("r1", "m1", "be-b", generation=2))
        _wait(lambda: _post_chat(port)[1] == "B", "the reroute")

        def cond(kind, name):
            obj = t.call(lambda: t.api.objects.get((kind, "default", name),
                                                   {}))
            return (obj.get("status") or {}).get("conditions") or [{}]

        _wait(lambda: cond("AIGatewayRoute", "r1")[0].get(
            "observedGeneration") == 2, "the route's condition")
        assert cond("AIGatewayRoute", "r1")[0]["status"] == "True"
        t.api.apply({"apiVersion": "aigateway.envoyproxy.io/v1alpha1",
                     "kind": "BackendSecurityPolicy",
                     "metadata": {"name": "bad-bsp", "namespace": "default",
                                  "generation": 1},
                     "spec": {"type": "Bogus",
                              "targetRefs": [{"name": "be-b"}]}})
        _wait(lambda: cond("BackendSecurityPolicy", "bad-bsp")[0].get(
            "status") == "False", "the policy's condition")
        assert _post_chat(port) == (200, "B")
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/health",
                                    timeout=10) as r:
            health = json.loads(r.read())
        assert health["objects_not_accepted"] == 1
        assert health["not_accepted"] == ["BackendSecurityPolicy/bad-bsp"]
        holder = t.api.leases["aigw-tpu-status-writer"]["spec"][
            "holderIdentity"]
        assert holder
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
        assert t.api.leases["aigw-tpu-status-writer"]["spec"][
            "holderIdentity"] == ""
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
        proc.stdout.close()
        err.close()
        for up in ups:
            t.run(up.stop())
        t.close()


def test_status_event_repatches_reference_fact(api, tmp_path):
    """The patched stamp covers the whole object, its resourceVersion
    and status included (``observedChecksum``), so an API server that
    answers a status patch with a MODIFIED event (a real one does; the
    reference's test double does not) makes the leader patch the same
    condition again on each such event, in both packages."""
    objs = _backend_objs("b1", "127.0.0.1", 9) + [_route_obj("r1", "m1",
                                                             "b1")]
    got = {}
    for k in KINDS:
        api.reset()
        api.put(*json.loads(json.dumps(objs)))
        old = api.streams("AIGatewayRoute")
        src = _start_source(k, api.api.url)
        try:
            _wait(lambda: api.streams("AIGatewayRoute") - old, "the watch")
            rec = PKG[k].KubeReconciler(
                src, status_path=str(tmp_path / f"{k}.json"),
                leader_election=False)
            counts = []
            for _ in range(3):
                rec.load()
                _wait(lambda: len(api.api.status_patches) > sum(counts),
                      "a patch")
                time.sleep(0.2)
                counts.append(len(api.api.status_patches) - sum(counts))
                # the server's MODIFIED event for the patched object
                patched = api.call(lambda: json.loads(json.dumps(
                    api.api.objects[("AIGatewayRoute", "default", "r1")])))
                gen = src.generation
                api.api.apply(patched)
                _wait(lambda: src.generation > gen, "the event")
        finally:
            src.stop()
        got[k] = (counts, sorted(key for key, _p in api.api.status_patches))
    assert got["torch"] == got["jax"]
    assert got["torch"][0] == [2, 1, 1]  # the backend and the route, then
    # the route again after each event


def test_uninstalled_kind_lists_empty_as_reference(api, monkeypatch):
    """A kind whose CRD is not installed (the list answers 404) lists
    as empty and not installed in both packages, and a source counts it
    synced without a watch on it."""
    import tests.test_kube as jtest

    monkeypatch.delitem(jtest._PLURAL_TO_KIND, "mcproutes")
    api.put(_route_obj("r1", "m1", "b1"))

    async def lists():
        out = {}
        for k in KINDS:
            client = PKG[k].KubeClient(PKG[k].KubeAuth(server=api.api.url))
            try:
                out[k] = [await client.list_resource(kind)
                          for kind in ("MCPRoute", "AIGatewayRoute")]
            finally:
                await client.close()
        return out

    got = asyncio.run(lists())
    assert got["torch"] == got["jax"]
    assert got["torch"][0] == ([], "", False)
    assert [o["metadata"]["name"] for o in got["torch"][1][0]] == ["r1"]
    old = api.streams("MCPRoute") | api.streams("AIGatewayRoute")
    src = _start_source("torch", api.api.url,
                        kinds=("MCPRoute", "AIGatewayRoute"))
    try:
        _wait(lambda: api.streams("AIGatewayRoute") - old, "the route watch")
        assert not api.streams("MCPRoute") - old
        assert _names(src) == ["r1"]
    finally:
        src.stop()

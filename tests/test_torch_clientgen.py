"""The port's typed clientset (``aigw_tpu_torch/config/clientgen.py`` and
its committed output, ``config/generated/clients.py``) held against the
reference's: the generator's output is current and differs from the
reference's only in module paths, every CRD's typed spec round-trips
as the reference's does, and the clientset and an informer (its resync
delta included) work over the port's ``KubeClient`` and ``KubeSource``
against the reference's fake API server."""

import asyncio
import copy
import os
import time

import pytest

from aigw_tpu.config import clientgen as jclientgen
from aigw_tpu.config.generated import clients as jgen
from aigw_tpu_torch.config import clientgen as tclientgen
from aigw_tpu_torch.config import kube as tkube
from aigw_tpu_torch.config.generated import clients as tgen
from tests.test_kube import FakeAPIServer, _backend_objs, _route_obj

_SAMPLE = {"string": "s", "integer": 7, "number": 0.5, "boolean": True,
           "object": {"k": {"n": [1]}}, "array": [{"name": "x"}]}


@pytest.fixture(scope="module")
def crds():
    """The chart's CRDs, parsed once (pyyaml takes seconds on them);
    both generators read the same directory."""
    assert os.path.realpath(tclientgen.CRD_DIR) == \
        os.path.realpath(jclientgen.CRD_DIR)
    return tclientgen.load_crds()


@pytest.fixture
def cached(crds, monkeypatch):
    for mod in (tclientgen, jclientgen):
        monkeypatch.setattr(mod, "load_crds", lambda: copy.deepcopy(crds))


def test_committed_output_matches_generator(cached):
    with open(tclientgen.OUT_PATH) as f:
        assert f.read() == tclientgen.generate(), (
            "generated/clients.py is stale: run "
            "python -m aigw_tpu_torch.config.clientgen")


def test_output_differs_from_reference_only_in_module_paths(cached, crds):
    ours = tclientgen.generate()
    assert "aigw_tpu." not in ours.replace("aigw_tpu_torch.", "")
    assert ours.replace("aigw_tpu_torch.", "aigw_tpu.").replace(
        "tests/test_torch_clientgen.py", "tests/test_clientgen.py") == \
        jclientgen.generate()
    assert tgen.ALL_KINDS == jgen.ALL_KINDS
    assert [tclientgen._spec_fields(c) for c in crds] == \
        [jclientgen._spec_fields(c) for c in crds]


@pytest.mark.parametrize("kind", jgen.ALL_KINDS)
def test_typed_objects_round_trip_as_the_reference(kind, crds):
    crd, = [c for c in crds if c["spec"]["names"]["kind"] == kind]
    props = (crd["spec"]["versions"][0]["schema"]["openAPIV3Schema"]
             ["properties"]["spec"]["properties"])
    full = {name: copy.deepcopy(_SAMPLE.get(schema.get("type", ""), "v"))
            for name, schema in props.items()}
    for spec in (full, {}, None, {next(iter(props)): None}):
        obj = {"metadata": {"name": "o", "namespace": "team"},
               "spec": copy.deepcopy(spec),
               "status": {"conditions": [{"type": "Accepted"}]}}
        t = getattr(tgen, kind).from_dict(copy.deepcopy(obj))
        j = getattr(jgen, kind).from_dict(copy.deepcopy(obj))
        assert t.spec.to_dict() == j.spec.to_dict()
        assert (t.name, t.namespace, t.status, t.raw, t.metadata) == \
            (j.name, j.namespace, j.status, j.raw, j.metadata)
        for name, py, _ in tclientgen._spec_fields(crd):
            assert getattr(t.spec, py) == getattr(j.spec, py)
    assert getattr(tgen, kind).from_dict(
        {"spec": copy.deepcopy(full)}).spec.to_dict() == full
    for attr in ("API_VERSION", "KIND", "PLURAL"):
        assert getattr(getattr(tgen, kind), attr) == \
            getattr(getattr(jgen, kind), attr)


def test_clientset_and_informer_against_the_api_server(monkeypatch):
    """List and get through ``AigwClientset``, an informer's store and
    events from the shared watch, and its resync delta: an object made
    while the first watch was down reaches the handler from the
    re-list."""

    async def main():
        api = FakeAPIServer()
        await api.start()
        for obj in (_backend_objs("be", "127.0.0.1", 9)
                    + [_route_obj("r1", "m1", "be")]):
            api.objects[FakeAPIServer._key(obj)] = obj
        client = tkube.KubeClient(tkube.KubeAuth(server=api.url))
        cs = tgen.AigwClientset(client)
        try:
            assert sorted(vars(cs)) == sorted(vars(jgen.AigwClientset(None)))
            routes = await cs.ai_gateway_route.list()
            assert [r.name for r in routes] == ["r1"]
            got = await cs.ai_gateway_route.get("r1")
            assert got is not None and got.spec.rules
            assert await cs.ai_gateway_route.get("nope") is None
            assert await cs.ai_gateway_route.get("r1", "other") is None
            assert await cs.quota_policy.list() == []
            assert await cs.ai_gateway_route.patch_status(got, [
                {"type": "Accepted", "status": "True"}])
            assert api.status_patches == [("AIGatewayRoute/r1", {
                "status": {"conditions": [
                    {"type": "Accepted", "status": "True"}]}})]
        finally:
            await client.close()

        calls = {"n": 0}
        orig = tkube.KubeClient.watch_resource

        async def flaky_watch(self, kind, rv, cb):
            calls["n"] += 1
            if calls["n"] == 1:  # the stream drops; r2 made in the gap
                r2 = _route_obj("r2", "m2", "be")
                api.objects[FakeAPIServer._key(r2)] = r2
                raise RuntimeError("watch stream dropped")
            return await orig(self, kind, rv, cb)

        monkeypatch.setattr(tkube.KubeClient, "watch_resource", flaky_watch)
        source = tkube.KubeSource(tkube.KubeAuth(server=api.url),
                                  kinds=("AIGatewayRoute",))
        inf = tgen.AIGatewayRouteInformer(source)
        other = tgen.QuotaPolicyInformer(source)
        events: list = []
        inf.add_event_handler(lambda et, o: events.append((et, o.name)))
        other.add_event_handler(lambda et, o: events.append(("quota", et)))
        source.start()
        try:
            assert await asyncio.to_thread(source.wait_synced, 30)
            deadline = time.time() + 20
            while time.time() < deadline and ("ADDED", "r2") not in events:
                await asyncio.sleep(0.1)
            assert events[:2] == [("ADDED", "r1"), ("ADDED", "r2")], events
            assert sorted(r.name for r in inf.store()) == ["r1", "r2"]
            assert other.store() == []
            while len(api._streams) < 1:
                await asyncio.sleep(0.05)
            api.apply(_route_obj("r3", "m3", "be"))
            deadline = time.time() + 15
            while time.time() < deadline and ("ADDED", "r3") not in events:
                await asyncio.sleep(0.1)
            assert events == [("ADDED", "r1"), ("ADDED", "r2"),
                              ("ADDED", "r3")]
            assert isinstance(inf.store()[0], tgen.AIGatewayRoute)
        finally:
            await asyncio.to_thread(source.stop)
            await api.stop()

    asyncio.run(main())

"""The port's pod mutating webhook (``aigw_tpu_torch/config/webhook.py``
and the ``webhook`` subcommand) held against the reference's: the
JSONPatch and AdmissionReview for the reference's pods, and both
packages' ``webhook`` subcommands answering the same AdmissionReview
JSON over HTTP and over TLS (a certificate made by openssl, as the
reference's test makes one), bad JSON, the routes' statuses, and half a
TLS pair refused with the reference's message."""

import base64
import copy
import json
import os
import pathlib
import signal
import socket
import ssl
import subprocess
import sys
import time
import urllib.error
import urllib.request

import pytest

from aigw_tpu.config import webhook as jwebhook
from aigw_tpu_torch.config import webhook as twebhook
from tests.test_webhook import IMAGE, _gateway_pod, _review

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _pods() -> dict:
    plain = {"kind": "Pod", "metadata": {"name": "app",
                                         "labels": {"app": "x"}},
             "spec": {"containers": [{"name": "c"}]}}
    empty = _gateway_pod()
    empty["spec"]["containers"] = []
    return {"gateway": _gateway_pod(),
            "with_sidecar": _gateway_pod(with_sidecar=True),
            "plain": plain, "no_labels": {"kind": "Pod", "spec": {}},
            "no_containers": empty, "malformed": {"spec": 42}}


def test_constants_equal_the_reference():
    for name in ("OWNING_GATEWAY_NAME_LABEL",
                 "OWNING_GATEWAY_NAMESPACE_LABEL", "SIDECAR_NAME"):
        assert getattr(twebhook, name) == getattr(jwebhook, name)


@pytest.mark.parametrize("kw", [
    {}, {"port": 2080}, {"port": 1976, "log_level": "debug",
                         "extra_env": [{"name": "A", "value": "1"}]}],
    ids=["default", "port", "env"])
@pytest.mark.parametrize("pod", sorted(_pods()))
def test_mutate_and_review_match_reference(pod, kw):
    obj = _pods()[pod]
    if pod != "malformed":
        assert twebhook.mutate_pod(copy.deepcopy(obj), IMAGE, **kw) == \
            jwebhook.mutate_pod(copy.deepcopy(obj), IMAGE, **kw)
    review = _review(obj)
    for rv in (review, {"request": {"uid": "u1", "object": obj}}, {}):
        got = twebhook.review_response(copy.deepcopy(rv), IMAGE, **kw)
        assert got == jwebhook.review_response(copy.deepcopy(rv), IMAGE, **kw)
    if pod == "gateway":
        patch = json.loads(base64.b64decode(
            twebhook.review_response(review, IMAGE, **kw)["response"][
                "patch"]))
        assert patch[0]["value"] == twebhook.build_sidecar(IMAGE, **kw)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _request(url: str, data: bytes | None, ctx) -> tuple[int, str, bytes]:
    req = urllib.request.Request(url, data=data)
    try:
        with urllib.request.urlopen(req, timeout=10, context=ctx) as r:
            return r.status, r.headers.get("content-type"), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("content-type"), e.read()


@pytest.fixture(scope="module")
def cert(tmp_path_factory):
    d = tmp_path_factory.mktemp("webhook-tls")
    crt, key = d / "tls.crt", d / "tls.key"
    subprocess.run(
        ["openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes",
         "-keyout", str(key), "-out", str(crt), "-days", "1",
         "-subj", "/CN=127.0.0.1", "-addext", "subjectAltName=IP:127.0.0.1"],
        check=True, capture_output=True)
    return str(crt), str(key)


@pytest.mark.parametrize("tls", [False, True], ids=["http", "tls"])
def test_webhook_subcommands_answer_alike(tls, cert, tmp_path):
    """Both packages' ``webhook`` subcommands, side by side: the same
    answers to a gateway pod's review, a plain pod's, bad JSON, the
    health route and a GET of /mutate."""
    procs, ports = {}, {}
    extra = ["--tls-cert", cert[0], "--tls-key", cert[1]] if tls else []
    for pkg in ("aigw_tpu", "aigw_tpu_torch"):
        ports[pkg] = _free_port()
        procs[pkg] = subprocess.Popen(
            [sys.executable, "-m", pkg, "webhook", "--host", "127.0.0.1",
             "--port", str(ports[pkg]), "--image", IMAGE,
             "--gateway-port", "2080", *extra], cwd=ROOT,
            env=dict(os.environ, JAX_PLATFORMS="cpu"),
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    ctx = ssl.create_default_context(cafile=cert[0]) if tls else None
    scheme = "https" if tls else "http"
    try:
        startup = {pkg: p.stdout.readline().strip()
                   for pkg, p in procs.items()}
        answers = {}
        for pkg, port in ports.items():
            assert startup[pkg] == (
                f"webhook listening on {scheme}://127.0.0.1:{port}/mutate "
                f"(sidecar image {IMAGE})")
            base = f"{scheme}://127.0.0.1:{port}"
            deadline = time.monotonic() + 60
            while True:
                try:
                    health = _request(base + "/health", None, ctx)
                    break
                except (urllib.error.URLError, ConnectionError):
                    if time.monotonic() > deadline:
                        raise
                    time.sleep(0.2)
            answers[pkg] = [health] + [
                _request(base + "/mutate", body, ctx) for body in (
                    json.dumps(_review(_gateway_pod())).encode(),
                    json.dumps(_review(_pods()["plain"])).encode(),
                    b"{not json")] + [_request(base + "/mutate", None, ctx)]
    finally:
        for p in procs.values():
            p.send_signal(signal.SIGTERM)
        codes = {pkg: p.wait(timeout=30) for pkg, p in procs.items()}
        for p in procs.values():
            p.stdout.close()
    assert codes == {"aigw_tpu": 0, "aigw_tpu_torch": 0}
    want, got = answers["aigw_tpu"], answers["aigw_tpu_torch"]
    assert [a[0] for a in got] == [a[0] for a in want] == [
        200, 200, 200, 400, 405]
    for (ws, wct, wb), (gs, gct, gb) in zip(want[:4], got[:4]):
        assert gct == wct and json.loads(gb) == json.loads(wb)
    sidecar = json.loads(base64.b64decode(json.loads(got[1][2])[
        "response"]["patch"]))[0]["value"]
    assert sidecar["ports"][0]["containerPort"] == 2080
    assert sidecar["args"][:2] == ["run", "kube:in-cluster"]
    assert "patch" not in json.loads(got[2][2])["response"]


@pytest.mark.parametrize("half", ["cert", "key"])
def test_half_a_tls_pair_is_refused_as_the_reference(half, cert):
    flag = ["--tls-cert", cert[0]] if half == "cert" else \
        ["--tls-key", cert[1]]
    got = {}
    for pkg in ("aigw_tpu", "aigw_tpu_torch"):
        proc = subprocess.run(
            [sys.executable, "-m", pkg, "webhook", "--image", IMAGE,
             "--port", str(_free_port()), *flag], cwd=ROOT,
            capture_output=True, text=True, timeout=120,
            env=dict(os.environ, JAX_PLATFORMS="cpu"))
        got[pkg] = (proc.returncode, proc.stdout,
                    proc.stderr.strip().splitlines()[-1])
    assert got["aigw_tpu_torch"] == got["aigw_tpu"]
    assert got["aigw_tpu_torch"][0] == 1

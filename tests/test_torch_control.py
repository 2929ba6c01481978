"""The port's file control plane held against the reference's on the CPU:
the CRD compiler over manifests of every kind it handles, admission's
rules (each broken at least once, and clean objects), ReferenceGrants,
the directory reconciler's conditions through add, edit, quarantine and
removal (each package's ``status`` reading the other's
``aigw-status.json``), bundles across packages, autoconfig over
environment combinations, the watcher over a manifest directory and a
bundle directory, and the JSON-text manifest reader equal to pyyaml's.
Manifests are built here, inline."""

import asyncio
import base64
import copy
import json
import pathlib
import subprocess
import sys

import pytest
import yaml

from aigw_tpu.config import admission as jadmission
from aigw_tpu.config import autoconfig as jauto
from aigw_tpu.config import bundle as jbundle
from aigw_tpu.config import controller as jcontroller
from aigw_tpu.config import crd as jcrd
from aigw_tpu.config import model as jmodel
from aigw_tpu.config import refgrant as jrefgrant
from aigw_tpu.config import watcher as jwatcher
from aigw_tpu_torch.config import admission as tadmission
from aigw_tpu_torch.config import autoconfig as tauto
from aigw_tpu_torch.config import bundle as tbundle
from aigw_tpu_torch.config import controller as tcontroller
from aigw_tpu_torch.config import crd as tcrd
from aigw_tpu_torch.config import model as tmodel
from aigw_tpu_torch.config import refgrant as trefgrant
from aigw_tpu_torch.config import runtime as truntime
from aigw_tpu_torch.config import watcher as twatcher

ROOT = pathlib.Path(__file__).resolve().parent.parent
AIGW = "aigateway.envoyproxy.io/v1alpha1"
EG = "gateway.envoyproxy.io/v1alpha1"


def obj(kind, name, spec=None, api=AIGW, ns=None, **extra):
    meta = {"name": name}
    if ns:
        meta["namespace"] = ns
    out = {"apiVersion": api, "kind": kind, "metadata": meta}
    if spec is not None:
        out["spec"] = spec
    out.update(extra)
    return out


def _secret_ref(name):
    return {"secretRef": {"name": name}}


#: a manifest set that uses every kind the compiler handles (and skips)
FULL = [
    obj("Secret", "openai-key", api="v1",
        stringData={"apiKey": "sk-${AIGW_CTL_TEST_KEY}-x"}),
    obj("Secret", "aws-creds", api="v1", data={"credentials": base64.b64encode(
        b"[default]\naws_access_key_id = AKIA1\n"
        b"aws_secret_access_key = sekrit\naws_session_token = tok\n"
    ).decode()}),
    obj("Secret", "anthropic-key", api="v1", stringData={"apiKey": "ak-1"}),
    obj("Secret", "azure-secret", api="v1",
        stringData={"client-secret": "az-tok"}),
    obj("Secret", "mcp-key", api="v1", stringData={"token": "mcp-tok"}),
    obj("Backend", "openai-be", {"endpoints": [
        {"fqdn": {"hostname": "api.openai.com", "port": 443}}]}, EG),
    obj("Backend", "pool-be", {"endpoints": [
        {"ip": {"address": "10.0.0.1", "port": 8000}},
        {"ip": {"address": "10.0.0.2", "port": 8000}},
        {"unix": {"path": "/tmp/x.sock"}}]}, EG),
    obj("Backend", "tls-be", {"endpoints": [
        {"fqdn": {"hostname": "claude.example", "port": 8443}}]}, EG),
    obj("Backend", "bedrock-be", {"endpoints": [
        {"fqdn": {"hostname": "bedrock.example", "port": 443}}]}, EG),
    obj("Backend", "mcp-be", {"endpoints": [
        {"fqdn": {"hostname": "mcp.example", "port": 9000}}]}, EG),
    obj("BackendTLSPolicy", "tls", {"targetRefs": [{"name": "tls-be"}]},
        "gateway.networking.k8s.io/v1alpha3"),
    obj("AIServiceBackend", "openai", {
        "schema": {"name": "OpenAI"}, "backendRef": {"name": "openai-be"},
        "timeouts": {"request": "30s"}}),
    obj("AIServiceBackend", "pool", {
        "schema": {"name": "OpenAI", "version": "v1"},
        "backendRef": {"name": "pool-be", "kind": "Backend"}}),
    obj("AIServiceBackend", "anthropic", {
        "schema": {"name": "Anthropic"}, "backendRef": {"name": "tls-be"}}),
    obj("AIServiceBackend", "bedrock", {
        "schema": {"name": "AWSBedrock"},
        "backendRef": {"name": "bedrock-be"}}),
    obj("AIServiceBackend", "azure", {
        "schema": {"name": "AzureOpenAI", "version": "2024-10-21"},
        "backendRef": {"name": "openai-be"}}),
    obj("AIServiceBackend", "vertex", {
        "schema": {"name": "GCPVertexAI"},
        "backendRef": {"name": "openai-be"}}),
    obj("BackendSecurityPolicy", "openai-auth", {
        "type": "APIKey", "apiKey": _secret_ref("openai-key"),
        "targetRefs": [{"name": "openai", "kind": "AIServiceBackend"}]}),
    obj("BackendSecurityPolicy", "anthropic-auth", {
        "type": "AnthropicAPIKey",
        "anthropicAPIKey": dict(_secret_ref("anthropic-key"),
                                apiVersion="2023-06-01"),
        "targetRefs": [{"name": "anthropic"}]}),
    obj("BackendSecurityPolicy", "bedrock-auth", {
        "type": "AWSCredentials", "awsCredentials": {
            "region": "us-east-1",
            "credentialsFile": _secret_ref("aws-creds")},
        "targetRefs": [{"name": "bedrock"}]}),
    obj("BackendSecurityPolicy", "azure-auth", {
        "type": "AzureCredentials", "azureCredentials": {
            "clientID": "c", "tenantID": "t",
            "clientSecretRef": {"name": "azure-secret"}},
        "targetRefs": [{"name": "azure"}]}),
    obj("BackendSecurityPolicy", "vertex-auth", {
        "type": "GCPCredentials", "gcpCredentials": {
            "projectName": "proj", "region": "us-central1",
            "credentialsFile": _secret_ref("gcp")},
        "targetRefs": [{"name": "vertex"}]}),
    obj("InferencePool", "llama-pool", {"targetPortNumber": 8000},
        "inference.networking.k8s.io/v1"),
    obj("AIGatewayRoute", "main", {
        "parentRefs": [{"name": "gw", "kind": "Gateway"}],
        "rules": [
            {"matches": [
                {"headers": [{"type": "Exact", "name": "x-ai-eg-model",
                              "value": "gpt-4o"}]},
                {"headers": [{"type": "Exact", "name": "x-ai-eg-model",
                              "value": "gpt-4o-mini"},
                             {"type": "Exact", "name": "X-Team",
                              "value": "a"}]}],
             "backendRefs": [{"name": "openai", "weight": 3},
                             {"name": "azure", "weight": 1,
                              "priority": 1}],
             "timeouts": {"request": "45s"}},
            {"matches": [{"headers": [
                {"type": "RegularExpression", "name": "x-ai-eg-model",
                 "value": "claude-.*"}]}],
             "backendRefs": [{"name": "anthropic"}]},
            {"matches": [{"headers": [
                {"type": "RegularExpression", "name": "x-ai-eg-model",
                 "value": ".*"},
                {"type": "RegularExpression", "name": "x-tenant",
                 "value": "t[0-9]+"}]}],
             "backendRefs": [{"name": "bedrock"}]},
            {"matches": [{"headers": [{"type": "Exact",
                                       "name": "x-ai-eg-model",
                                       "value": "llama"}]}],
             "backendRefs": [{"name": "llama-pool",
                              "group": "inference.networking.k8s.io",
                              "kind": "InferencePool"}]},
            {"backendRefs": []}],
        "llmRequestCosts": [
            {"metadataKey": "total", "type": "TotalToken"},
            {"metadataKey": "weighted", "type": "CEL",
             "cel": "input_tokens + output_tokens * 2"}]}),
    obj("AIGatewayRoute", "beta", {
        "rules": [{"matches": [{"headers": [
            {"type": "Exact", "name": "x-ai-eg-model", "value": "pooled"}]}],
            "backendRefs": [{"name": "pool"}, {"name": "vertex"}],
            "timeouts": {"request": "2m"}}],
        "llmRequestCosts": [{"metadataKey": "total",
                             "type": "TotalToken"}]},
        "aigateway.envoyproxy.io/v1beta1"),
    obj("GatewayConfig", "global", {"globalLLMRequestCosts": [
        {"metadataKey": "input", "type": "InputToken"},
        {"metadataKey": "total", "type": "TotalToken"}]}),
    obj("BackendTrafficPolicy", "limits", {"rateLimit": {"global": {"rules": [
        {"clientSelectors": [{"headers": [
            {"type": "Distinct", "name": "X-User-Id"}]}],
         "limit": {"requests": 1000, "unit": "Hour"},
         "cost": {"response": {"metadata": {
             "namespace": "io.envoy.ai_gateway", "key": "total"}}}},
        {"limit": {"requests": 50, "unit": "Minute"},
         "cost": {"response": {"metadata": {"namespace": "other",
                                            "key": "x"}}}},
        {"limit": {"requests": 7, "unit": "Day"},
         "cost": {"response": {"metadata": {"key": "input"}}}}]}}}, EG),
    obj("QuotaPolicy", "qp-b", {
        "targetRefs": [{"name": "openai", "kind": "AIServiceBackend"}],
        "serviceQuota": {"quota": {"limit": 5000, "duration": "1d"}},
        "perModelQuotas": [
            {"modelName": "gpt-4o", "quota": {
                "defaultBucket": {"limit": 100, "duration": "1m"},
                "bucketRules": [
                    {"clientSelectors": [{"headers": [
                        {"type": "Distinct", "name": "X-Org"}]}],
                     "quota": {"limit": 40, "duration": "1h"}},
                    {"shadowMode": True,
                     "quota": {"limit": 1, "duration": "1s"}}],
                "costExpression": "output_tokens"}}]}),
    obj("QuotaPolicy", "qp-a", {
        "targetRefs": [{"name": "openai"}],
        "perModelQuotas": [
            {"modelName": "gpt-4o", "quota": {
                "bucketRules": [{"shadowMode": True, "quota": {
                    "limit": 3}}]}},
            {"modelName": "gpt-4o-mini", "quota": {
                "defaultBucket": {"limit": 10}}}]}, ns="team"),
    obj("MCPRoute", "tools", {
        "path": "/mcp/v1",
        "backendRefs": [
            {"name": "mcp-be", "path": "/rpc",
             "toolSelector": {"include": ["a"], "includeRegex": ["b.*"]},
             "securityPolicy": {"apiKey": _secret_ref("mcp-key")}},
            {"name": "pool-be"}]}),
    obj("Gateway", "gw", {"gatewayClassName": "x"},
        "gateway.networking.k8s.io/v1"),
    obj("GatewayClass", "x", {}, "gateway.networking.k8s.io/v1"),
    obj("HTTPRoute", "h", {}, "gateway.networking.k8s.io/v1"),
    obj("ReferenceGrant", "g", {"from": [], "to": []},
        "gateway.networking.k8s.io/v1beta1"),
    obj("SomethingElse", "z", {}),
]


@pytest.fixture(autouse=True)
def _key_env(monkeypatch):
    monkeypatch.setenv("AIGW_CTL_TEST_KEY", "abc")


def _cut(docs, *drop):
    return [d for d in docs if d["kind"] not in drop]


#: manifest sets for the compiler: the whole corpus, and cuts of it
COMPILE_CASES = {
    "full": FULL,
    "no-mcp-no-quota": _cut(FULL, "MCPRoute", "QuotaPolicy",
                            "BackendTrafficPolicy"),
    "routes-only": [d for d in FULL if d["kind"] in (
        "AIGatewayRoute", "AIServiceBackend", "Backend")],
    "pool-only": [d for d in FULL if d["metadata"]["name"] in (
        "llama-pool", "gw")] + [obj("AIGatewayRoute", "r", {"rules": [
            {"backendRefs": [{"name": "llama-pool"}]}]})],
}


@pytest.mark.parametrize("case", sorted(COMPILE_CASES))
def test_compile_matches_reference(case):
    docs = COMPILE_CASES[case]
    want = jcrd.compile_crd_objects(copy.deepcopy(docs))
    got = tcrd.compile_crd_objects(copy.deepcopy(docs))
    assert got == want
    cfg = tmodel.Config.parse(got)
    assert cfg.to_dict() == jmodel.Config.parse(want).to_dict()
    truntime.RuntimeConfig.build(cfg)


def test_compile_covers_every_handled_kind():
    kinds = {d["kind"] for d in FULL}
    assert tcrd._HANDLED <= kinds | {"QuotaPolicy"}
    assert (tcrd._HANDLED, tcrd._SKIPPED) == (jcrd._HANDLED, jcrd._SKIPPED)
    out = tcrd.compile_crd_objects(copy.deepcopy(FULL))
    auth = {b["name"]: b.get("auth", {}).get("kind") for b in out["backends"]}
    assert auth["openai"] == "APIKey" and auth["bedrock"] == "AWSSigV4"
    assert [b for b in out["backends"] if b["name"] == "openai"][0][
        "auth"]["api_key"] == "sk-abc-x"  # ${ENV} substituted
    assert out["mcp"]["path"] == "/mcp/v1" and out["quotas"]


COMPILE_ERRORS = [
    [obj("AIGatewayRoute", "r", {"rules": [{"matches": [{"headers": [
        {"type": "Prefix", "name": "x", "value": "y"}]}],
        "backendRefs": [{"name": "b"}]}]})],
    [obj("AIServiceBackend", "b", {"schema": {"name": "OpenAI"},
                                   "timeouts": {"request": "soon"}})],
    [obj("AIServiceBackend", "b", {"schema": {"name": "OpenAI"}}),
     obj("BackendSecurityPolicy", "p", {"type": "Kerberos",
                                        "targetRefs": [{"name": "b"}]})],
    [obj("MCPRoute", "m", {"backendRefs": [{"name": "nowhere"}]})],
]


@pytest.mark.parametrize("i", range(len(COMPILE_ERRORS)))
def test_compile_errors_match_reference(i):
    docs = COMPILE_ERRORS[i]
    with pytest.raises(jmodel.ConfigError) as want:
        jcrd.compile_crd_objects(copy.deepcopy(docs))
    with pytest.raises(tmodel.ConfigError) as got:
        tcrd.compile_crd_objects(copy.deepcopy(docs))
    assert str(got.value) == str(want.value)


# -- admission ----------------------------------------------------------------------
def _route(rules=None, **spec):
    return obj("AIGatewayRoute", "r", dict(spec, rules=rules or []))


def _rule(*refs, **kw):
    return dict(kw, backendRefs=list(refs))


POOL_REF = {"name": "p", "group": "inference.networking.k8s.io",
            "kind": "InferencePool"}


def _bsp(**spec):
    return obj("BackendSecurityPolicy", "p", spec)


def _mcp(**spec):
    spec.setdefault("backendRefs", [{"name": "m"}])
    return obj("MCPRoute", "m", spec)


ADMISSION = {
    # AIGatewayRoute
    "route-clean": _route([_rule({"name": "a"}, {"name": "b"},
                                 name="x", timeouts={"request": "30s",
                                                     "backendRequest": "10s"}),
                           _rule(POOL_REF)],
                          parentRefs=[{"name": "g"}]),
    "route-parent-kind": _route(parentRefs=[{"name": "g",
                                             "kind": "Service"}]),
    "route-too-many": _route([_rule({"name": "a"})] * 16),
    "route-reserved": _route([_rule({"name": "a"}, name="route-not-found")]),
    "route-dup-name": _route([_rule({"name": "a"}, name="x"),
                              _rule({"name": "b"}, name="x")]),
    "route-group-only": _route([_rule({"name": "a", "group": "g"})]),
    "route-kind-only": _route([_rule({"name": "a", "kind": "Backend"})]),
    "route-bad-pool-group": _route([_rule(dict(POOL_REF, group="x.io"))]),
    "route-bad-pool-kind": _route([_rule(dict(POOL_REF, kind="Service"))]),
    "route-timeouts": _route([_rule({"name": "a"}, timeouts={
        "request": "10s", "backendRequest": "1m"})]),
    "route-timeouts-unparsed": _route([_rule({"name": "a"}, timeouts={
        "request": "soon", "backendRequest": "1h2m3s500ms"})]),
    "route-mixed": _route([_rule(POOL_REF, {"name": "a"})]),
    "route-two-pools": _route([_rule(POOL_REF, dict(POOL_REF, name="q"))]),
    # AIServiceBackend
    "backend-clean": obj("AIServiceBackend", "b", {
        "schema": {"name": "AWSBedrock"}, "backendRef": {"name": "x"}}),
    "backend-schema": obj("AIServiceBackend", "b", {
        "schema": {"name": "TPUServe"}}),
    "backend-no-schema": obj("AIServiceBackend", "b", {}),
    "backend-ref-kind": obj("AIServiceBackend", "b", {
        "schema": {"name": "OpenAI"},
        "backendRef": {"name": "x", "kind": "Service"}}),
    # BackendSecurityPolicy
    "bsp-clean": _bsp(type="APIKey", apiKey=_secret_ref("k"),
                      targetRefs=[{"name": "b"}, dict(POOL_REF)]),
    "bsp-type": _bsp(type="Token"),
    "bsp-field-missing": _bsp(type="APIKey"),
    "bsp-two-fields": _bsp(type="APIKey", apiKey={}, azureAPIKey={}),
    "bsp-azure-empty": _bsp(type="AzureCredentials", azureCredentials={
        "clientID": "", "clientSecretRef": {"name": "s"},
        "oidcExchangeToken": {}}),
    "bsp-azure-neither": _bsp(type="AzureCredentials", azureCredentials={
        "clientID": "c", "tenantID": "t"}),
    "bsp-azure-clean": _bsp(type="AzureCredentials", azureCredentials={
        "clientID": "c", "tenantID": "t", "oidcExchangeToken": {}}),
    "bsp-gcp-both": _bsp(type="GCPCredentials", gcpCredentials={
        "workloadIdentityFederationConfig": {}, "credentialsFile": {}}),
    "bsp-gcp-neither": _bsp(type="GCPCredentials", gcpCredentials={}),
    "bsp-target-kind": _bsp(type="APIKey", apiKey={},
                            targetRefs=[{"name": "b", "kind": "Service"}]),
    "bsp-target-group": _bsp(type="APIKey", apiKey={}, targetRefs=[
        {"name": "b", "kind": "AIServiceBackend", "group": "x.io"}]),
    # MCPRoute
    "mcp-clean": _mcp(backendRefs=[
        {"name": "m", "toolSelector": {"include": ["a"],
                                       "excludeRegex": ["b"]},
         "securityPolicy": {"apiKey": {"inline": "k", "header": "x"}}},
        {"name": "n", "group": "gateway.envoyproxy.io", "kind": "Backend"}],
        securityPolicy={"oauth": {"jwks": {"remoteJWKS": {}}},
                        "authorization": {"rules": [{"source": {"jwt": {
                            "scopes": ["s"]}}}]}}),
    "mcp-parent": _mcp(parentRefs=[{"kind": "HTTPRoute"}]),
    "mcp-singular": _mcp(backendRef={"name": "m"}),
    "mcp-none": _mcp(backendRefs=[]),
    "mcp-group": _mcp(backendRefs=[{"name": "m", "group": "x.io"}]),
    "mcp-kind": _mcp(backendRefs=[{"name": "m", "kind": "Pod"}]),
    "mcp-dup": _mcp(backendRefs=[{"name": "m"}, {"name": "m"}]),
    "mcp-selector-empty": _mcp(backendRefs=[{"name": "m",
                                             "toolSelector": {}}]),
    "mcp-selector-include": _mcp(backendRefs=[{"name": "m", "toolSelector": {
        "include": ["a"], "includeRegex": ["b"]}}]),
    "mcp-selector-exclude": _mcp(backendRefs=[{"name": "m", "toolSelector": {
        "exclude": ["a"], "excludeRegex": ["b"]}}]),
    "mcp-apikey-both": _mcp(backendRefs=[{"name": "m", "securityPolicy": {
        "apiKey": {"inline": "k", "secretRef": {"name": "s"}}}}]),
    "mcp-apikey-neither": _mcp(backendRefs=[{"name": "m", "securityPolicy": {
        "apiKey": {"header": "h", "queryParam": "q"}}}]),
    "mcp-jwks-neither": _mcp(securityPolicy={"oauth": {"jwks": {}}}),
    "mcp-jwks-both": _mcp(securityPolicy={"oauth": {"jwks": {
        "remoteJWKS": {}, "localJWKS": {}}}}),
    "mcp-jwt-no-oauth": _mcp(securityPolicy={"authorization": {"rules": [
        {"source": {"jwt": {"claims": [{"name": "scope"}]}}},
        {"source": {"jwt": {}}}, {"source": {}}]}}),
    # QuotaPolicy
    "quota-clean": obj("QuotaPolicy", "q", {
        "targetRefs": [{"name": "b"}],
        "rules": [{"matches": [{"headers": [{"name": "x"}]}]}]}),
    "quota-target": obj("QuotaPolicy", "q", {
        "targetRefs": [{"name": "b", "kind": "InferencePool"}]}),
    "quota-match": obj("QuotaPolicy", "q", {
        "rules": [{"matches": [{}, {"path": {"value": "/"}}]}]}),
    # kinds with no rules
    "secret": obj("Secret", "s", api="v1"),
    "no-kind": {"spec": {}},
}


@pytest.mark.parametrize("case", sorted(ADMISSION))
def test_admission_matches_reference(case):
    o = ADMISSION[case]
    want = jadmission.validate(copy.deepcopy(o))
    assert tadmission.validate(copy.deepcopy(o)) == want
    assert bool(want) == (not case.endswith("clean") and case not in (
        "secret", "no-kind", "route-timeouts-unparsed"))


def test_admission_breaks_every_rule():
    """Every message the reference's validator can give (its f-string
    fields taken as wildcards) comes out of the corpus at least once."""
    import re

    src = (ROOT / "aigw_tpu" / "config" / "admission.py").read_text()
    templates = []
    for lit in re.findall(r'errors\.append\(\s*((?:f?"[^"]*"\s*)+)\)', src):
        text = "".join(re.findall(r'f?"([^"]*)"', lit))
        templates.append(re.compile(".*?".join(
            re.escape(part) for part in re.split(r"\{[^}]*\}", text))))
    got = [msg for o in ADMISSION.values()
           for msg in tadmission.validate(copy.deepcopy(o))]
    missing = [t.pattern for t in templates
               if not any(t.fullmatch(m) for m in got)]
    assert len(templates) >= 30 and not missing, missing


# -- reference grants ---------------------------------------------------------------
def _grant(ns, from_ns, to_kind="AIServiceBackend", name=None,
           group=AIGW.split("/")[0], spec=None):
    to = {"group": group, "kind": to_kind}
    if name:
        to["name"] = name
    return obj("ReferenceGrant", "g", spec if spec is not None else {
        "from": [{"group": AIGW.split("/")[0], "kind": "AIGatewayRoute",
                  "namespace": from_ns}], "to": [to]},
        "gateway.networking.k8s.io/v1beta1", ns=ns)


def _xroute(ns, *refs):
    return obj("AIGatewayRoute", "r", {"rules": [
        {"backendRefs": list(refs)}, "not-a-rule"]}, ns=ns)


REFGRANT = {
    "same-ns": [_xroute("a", {"name": "b", "namespace": "a"})],
    "no-grant": [_xroute("a", {"name": "b", "namespace": "b"})],
    "granted": [_xroute("a", {"name": "b", "namespace": "b"}),
                _grant("b", "a")],
    "grant-wrong-from": [_xroute("a", {"name": "b", "namespace": "b"}),
                         _grant("b", "c")],
    "grant-wrong-ns": [_xroute("a", {"name": "b", "namespace": "b"}),
                       _grant("c", "a")],
    "grant-named": [_xroute("a", {"name": "b", "namespace": "b"}),
                    _grant("b", "a", name="b")],
    "grant-other-name": [_xroute("a", {"name": "b", "namespace": "b"}),
                         _grant("b", "a", name="z")],
    "pool-granted": [_xroute("a", dict(POOL_REF, namespace="b")),
                     _grant("b", "a", "InferencePool",
                            group="inference.networking.k8s.io")],
    "pool-wrong-group": [_xroute("a", dict(POOL_REF, namespace="b")),
                         _grant("b", "a", "InferencePool")],
    "null-grant": [_xroute("a", {"name": "b", "namespace": "b"}),
                   _grant("b", "a", spec={"from": None, "to": None})],
    "default-route": [_xroute(None, {"name": "b", "namespace": "b"}),
                      _grant("b", "default")],
    "two-routes": [_xroute("a", {"name": "b", "namespace": "b"}),
                   dict(_xroute("c", "x", {"name": "b", "namespace": "b"}),
                        metadata={"name": "r2", "namespace": "c"})],
}


@pytest.mark.parametrize("case", sorted(REFGRANT))
def test_refgrant_matches_reference(case):
    objs = REFGRANT[case]
    want = jrefgrant.validate(copy.deepcopy(objs))
    assert trefgrant.validate(copy.deepcopy(objs)) == want
    assert bool(want) == (case in ("no-grant", "grant-wrong-from",
                                   "grant-wrong-ns", "grant-other-name",
                                   "pool-wrong-group", "null-grant",
                                   "two-routes"))


# -- the reconciler -----------------------------------------------------------------
def _dump(docs) -> str:
    return "---\n".join(yaml.safe_dump(d, sort_keys=False) for d in docs)


BASE_DIR = {
    "backends.yaml": _dump([
        obj("Backend", "a", {"endpoints": [{"ip": {"address": "127.0.0.1",
                                                   "port": 9001}}]}, EG),
        obj("Backend", "b", {"endpoints": [{"ip": {"address": "127.0.0.1",
                                                   "port": 9002}}]}, EG),
        obj("AIServiceBackend", "a", {"schema": {"name": "OpenAI"},
                                      "backendRef": {"name": "a"}}),
        obj("AIServiceBackend", "b", {"schema": {"name": "OpenAI"},
                                      "backendRef": {"name": "b"}})]),
    "route.yaml": _dump([obj("AIGatewayRoute", "r", {"rules": [
        {"matches": [{"headers": [{"type": "Exact", "name": "x-ai-eg-model",
                                   "value": "m"}]}],
         "backendRefs": [{"name": "a"}]}]})]),
    "notes.txt": "not a manifest",
}
#: each step's files written over the last's (None removes one)
STEPS = [
    {},
    {"route.yaml": _dump([obj("AIGatewayRoute", "r", {"rules": [
        {"backendRefs": [{"name": "b"}]}]})])},
    {"bad.yaml": _dump([
        obj("AIServiceBackend", "c", {"schema": {"name": "Nope"}}),
        obj("BackendSecurityPolicy", "p", {
            "type": "Kerberos", "kerberos": {},
            "targetRefs": [{"name": "a"}]}),
        obj("AIGatewayRoute", "x", {"rules": [{"matches": [{"headers": [
            {"type": "Prefix", "name": "h", "value": "v"}]}],
            "backendRefs": [{"name": "a"}]}]}),
        obj("AIGatewayRoute", "y", {"rules": [{"backendRefs": [
            {"name": "a", "namespace": "other"}]}]}, ns="team")]),
        "torn.yml": "kind: [unclosed\n"},
    {"bad.yaml": None},
    {"torn.yml": None, "route.yaml": None},
]


def _apply(d: pathlib.Path, files: dict) -> None:
    for name, text in files.items():
        if text is None:
            (d / name).unlink()
        else:
            (d / name).write_text(text)


def _no_time(conds: dict) -> dict:
    return {k: {f: v for f, v in c.items() if f != "lastTransitionTime"}
            for k, c in conds.items()}


def test_reconciler_conditions_match_reference(tmp_path):
    """Both reconcilers over the same directory contents, step by step:
    equal configs and conditions (timestamps aside), equal status files
    but for them; a transition time moves only on a flip."""
    dirs = {s: tmp_path / s for s in ("ref", "port")}
    for d in dirs.values():
        d.mkdir()
        _apply(d, BASE_DIR)
    recs = {"ref": jcontroller.Reconciler(str(dirs["ref"])),
            "port": tcontroller.Reconciler(str(dirs["port"]))}
    times = []
    for step in STEPS:
        for d in dirs.values():
            _apply(d, step)
        got = {}
        for side, rec in recs.items():
            cfg = rec.load()
            status = json.loads((dirs[side] / "aigw-status.json").read_text())
            got[side] = (cfg.to_dict(), _no_time(rec.conditions()),
                         _no_time(status["objects"]), sorted(
                             rec.not_accepted()), status["kind"])
        assert got["port"] == got["ref"]
        times.append(recs["port"].conditions())
    assert sorted(times[2]) == sorted([
        "AIGatewayRoute/r", "AIGatewayRoute/team/y", "AIGatewayRoute/x",
        "AIServiceBackend/a", "AIServiceBackend/b", "AIServiceBackend/c",
        "Backend/a", "Backend/b", "BackendSecurityPolicy/p",
        "file/torn.yml"])
    assert sorted(recs["port"].not_accepted()) == []
    assert "AIGatewayRoute/r" not in times[4]  # removed with its file
    # an object that stays accepted keeps its transition time
    assert times[2]["Backend/a"]["lastTransitionTime"] == \
        times[0]["Backend/a"]["lastTransitionTime"]


def test_reconciler_errors_match_reference(tmp_path):
    for side in ("ref", "port"):
        (tmp_path / side).mkdir()
    with pytest.raises(jmodel.ConfigError) as want:
        jcontroller.Reconciler(str(tmp_path / "none")).load()
    with pytest.raises(tmodel.ConfigError) as got:
        tcontroller.Reconciler(str(tmp_path / "none")).load()
    assert str(got.value) == str(want.value)
    for path in (tmp_path / "ref", tmp_path, tmp_path / "none"):
        assert tcontroller.is_manifest_dir(str(path)) == \
            jcontroller.is_manifest_dir(str(path))
    (tmp_path / "ref" / "x.yaml").write_text("{}")
    assert tcontroller.is_manifest_dir(str(tmp_path / "ref"))
    (tmp_path / "ref" / "index.json").write_text("{}")
    assert not tcontroller.is_manifest_dir(str(tmp_path / "ref"))


def _cli(pkg: str, *args, cwd=ROOT):
    proc = subprocess.run([sys.executable, "-m", pkg, *args], cwd=cwd,
                          capture_output=True, text=True, timeout=120)
    return proc.returncode, proc.stdout


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_status_reads_the_other_packages_file(tmp_path, writer):
    """A directory reconciled by one package: each package's ``status``
    shows that package's ``aigw-status.json`` (its checksums match the
    live view), with the same output and exit code."""
    _apply(tmp_path, BASE_DIR)
    _apply(tmp_path, STEPS[2])
    rec = (jcontroller if writer == "ref" else tcontroller).Reconciler(
        str(tmp_path))
    rec.load()
    for args in (["status", str(tmp_path)],
                 ["status", str(tmp_path), "--json"]):
        want = _cli("aigw_tpu", *args)
        got = _cli("aigw_tpu_torch", *args)
        assert got == want
        assert want[0] == 1 and "aigw-status.json" in want[1]


# -- bundles ------------------------------------------------------------------------
NATIVE = {"version": "v1", "uuid": "bundle-1",
          "backends": [{"name": "p", "schema": "TPUServe",
                        "endpoints": ["127.0.0.1:1", "127.0.0.1:2"]}],
          "routes": [{"name": "r", "rules": [{"backends": ["p"]}]}],
          "llm_request_costs": [{"metadata_key": "t", "type": "TotalToken"}]}


@pytest.mark.parametrize("part_size", [64, 1 << 20])
def test_bundles_cross_packages(tmp_path, part_size):
    """A bundle written by either package is byte for byte the other's
    and reads back in both; a torn part is refused by both with the same
    message."""
    dirs = {}
    for side, bmod, mmod in (("ref", jbundle, jmodel),
                             ("port", tbundle, tmodel)):
        dirs[side] = tmp_path / side
        assert bmod.write_bundle(mmod.Config.parse(NATIVE), str(dirs[side]),
                                 part_size=part_size) == "bundle-1"
    names = sorted(p.name for p in dirs["ref"].iterdir())
    assert names == sorted(p.name for p in dirs["port"].iterdir())
    assert len(names) > (2 if part_size == 64 else 1)
    for n in names:
        assert (dirs["ref"] / n).read_bytes() == (dirs["port"] / n).read_bytes()
    want = jmodel.Config.parse(NATIVE).to_dict()
    for d in dirs.values():
        assert tbundle.read_bundle(str(d)).to_dict() == want
        assert jbundle.read_bundle(str(d)).to_dict() == want
    part = dirs["ref"] / "part-0.json"
    part.write_bytes(part.read_bytes()[:-1] + b" ")
    with pytest.raises(jmodel.ConfigError) as jerr:
        jbundle.read_bundle(str(dirs["ref"]))
    with pytest.raises(tmodel.ConfigError) as terr:
        tbundle.read_bundle(str(dirs["ref"]))
    assert str(terr.value) == str(jerr.value)
    assert "checksum mismatch" in str(terr.value)


# -- autoconfig ---------------------------------------------------------------------
AUTO_ENVS = {
    "none": {},
    "tpuserve": {"TPUSERVE_URL": "http://127.0.0.1:8011"},
    "openai": {"OPENAI_API_KEY": "sk-1"},
    "openai-base": {"OPENAI_API_KEY": "sk-1",
                    "OPENAI_BASE_URL": "http://127.0.0.1:9"},
    "anthropic": {"ANTHROPIC_API_KEY": "ak",
                  "ANTHROPIC_BASE_URL": "http://127.0.0.1:8"},
    "azure-half": {"AZURE_OPENAI_API_KEY": "az"},
    "azure": {"AZURE_OPENAI_API_KEY": "az",
              "AZURE_OPENAI_ENDPOINT": "https://x.openai.azure.com",
              "AZURE_OPENAI_API_VERSION": "2024-10-21"},
    "all-models": {"TPUSERVE_URL": "http://127.0.0.1:8011",
                   "OPENAI_API_KEY": "sk-1", "ANTHROPIC_API_KEY": "ak",
                   "AZURE_OPENAI_API_KEY": "az",
                   "AZURE_OPENAI_ENDPOINT": "https://x",
                   "AIGW_MODELS": " llama , , tiny-random "},
}


@pytest.mark.parametrize("case", sorted(AUTO_ENVS))
def test_autoconfig_matches_reference(case):
    env = AUTO_ENVS[case]
    if case in ("none", "azure-half"):
        with pytest.raises(jmodel.ConfigError) as want:
            jauto.autoconfig_from_env(dict(env))
        with pytest.raises(tmodel.ConfigError) as got:
            tauto.autoconfig_from_env(dict(env))
        assert str(got.value) == str(want.value)
        return
    got = tauto.autoconfig_from_env(dict(env))
    assert got.to_dict() == jauto.autoconfig_from_env(dict(env)).to_dict()
    truntime.RuntimeConfig.build(got)


def test_autoconfig_reads_the_environment(monkeypatch):
    for k in ("OPENAI_API_KEY", "ANTHROPIC_API_KEY", "AZURE_OPENAI_API_KEY",
              "AIGW_MODELS"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("TPUSERVE_URL", "http://127.0.0.1:1")
    assert [b.name for b in tauto.autoconfig_from_env().backends] == \
        ["tpuserve"]


# -- the watcher --------------------------------------------------------------------
def test_watcher_over_directories(tmp_path, monkeypatch):
    """A manifest directory reconciled on every tick (a quarantined
    object shows in ``not_accepted``, an edit reloads), a bundle
    directory rewritten, and ``kube:`` refused naming the source."""
    mdir = tmp_path / "m"
    mdir.mkdir()
    _apply(mdir, BASE_DIR)
    bdir = tmp_path / "b"
    tbundle.write_bundle(tmodel.Config.parse(NATIVE), str(bdir))
    seen = {"m": [], "b": []}

    async def main():
        ws = {k: twatcher.ConfigWatcher(str(d), seen[k].append,
                                        interval=0.05)
              for k, d in (("m", mdir), ("b", bdir))}
        for w in ws.values():
            w.load_initial()
            await w.start()
        assert ws["m"].not_accepted() == {} == ws["b"].not_accepted()
        _apply(mdir, STEPS[1])
        _apply(mdir, {"bad.yaml": STEPS[2]["bad.yaml"]})
        tbundle.write_bundle(tmodel.Config.parse(dict(NATIVE, uuid="two")),
                             str(bdir))
        for _ in range(100):
            await asyncio.sleep(0.05)
            if len(seen["m"]) > 1 and len(seen["b"]) > 1:
                break
        out = (sorted(ws["m"].not_accepted()), ws["b"].not_accepted())
        for w in ws.values():
            await w.stop()
        return out

    bad, none = asyncio.run(main())
    assert bad == ["AIGatewayRoute/team/y", "AIGatewayRoute/x",
                   "AIServiceBackend/c", "BackendSecurityPolicy/p"]
    assert none == {}
    assert [rc.config.routes[0].rules[0].backends[0].backend
            for rc in seen["m"]] == ["a", "b"]
    assert [rc.config.uuid for rc in seen["b"]] == ["bundle-1", "two"]
    # kube:in-cluster outside a cluster: the reference's exception
    monkeypatch.delenv("KUBERNETES_SERVICE_HOST", raising=False)
    raised = []
    for watcher in (jwatcher, twatcher):
        with pytest.raises(Exception) as e:
            watcher.ConfigWatcher("kube:in-cluster", lambda rc: None) \
                .load_initial()
        raised.append((type(e.value), str(e.value)))
    assert raised[1] == raised[0] == (
        ValueError, "not running in-cluster (KUBERNETES_SERVICE_HOST unset)")


def test_load_config_compiles_crd_manifests(tmp_path):
    path = tmp_path / "m.yaml"
    path.write_text(_dump(FULL))
    assert tmodel.load_config(str(path)).to_dict() == \
        jmodel.load_config(str(path)).to_dict()


# -- the JSON-text reader -----------------------------------------------------------
JSON_TEXTS = {
    "object": json.dumps(FULL[11]),
    "unicode-numbers": json.dumps({"apiVersion": "v1", "kind": "Secret",
                                   "metadata": {"name": "é"}, "n": [1, 2.5,
                                                                   -3e2],
                                   "t": True, "z": None}, indent=2),
    "list": json.dumps(FULL[:6]),
    "empty": "  \n",
    "scalar": "3",
}


def _json_reader(texts: dict) -> dict:
    """``load_documents`` on each text in a process where pyyaml cannot
    be imported."""
    code = (
        "import json, sys\n"
        "sys.modules['yaml'] = None\n"
        "from aigw_tpu_torch.config.crd import load_documents\n"
        "texts = json.loads(sys.stdin.read())\n"
        "out = {}\n"
        "for k, t in texts.items():\n"
        "    try:\n"
        "        out[k] = load_documents(t)\n"
        "    except Exception as e:\n"
        "        out[k] = type(e).__name__ + ': ' + str(e)\n"
        "print(json.dumps(out))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          input=json.dumps(texts), capture_output=True,
                          text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout)


def test_json_text_reader_equals_pyyaml():
    """Without pyyaml a JSON text gives the documents pyyaml gives (a
    list of mappings the stream of them, as ``---`` would separate
    them); YAML that is not JSON raises ConfigError naming pyyaml."""
    texts = dict(JSON_TEXTS, yaml="kind: Secret\nmetadata: {name: s}\n")
    got = _json_reader(texts)
    for k, text in JSON_TEXTS.items():
        want = list(yaml.safe_load_all(text))
        if k == "list":
            want = list(yaml.safe_load_all(_dump(FULL[:6])))
        assert got[k] == want == tcrd.load_documents(text), k
    assert got["yaml"].startswith("ConfigError") and "pyyaml" in got["yaml"]
    assert tcrd.load_crd_documents(JSON_TEXTS["list"]) == FULL[:6]
    assert jcrd.load_crd_documents(JSON_TEXTS["object"]) == \
        tcrd.load_crd_documents(JSON_TEXTS["object"])

"""Pod mutating webhook: sidecar injection for gateway pods (the port's
copy of ``aigw_tpu/config/webhook.py``).

Upstream's controller registers a MutatingWebhookConfiguration and
mutates Envoy Gateway pods to inject its extproc container
(internal/controller/gateway_mutator.go:126 ``Default``, :201). Here the
injected sidecar is the gateway itself running against the cluster
(``run kube:in-cluster``): pods labeled with the owning-gateway labels
get the container; every other pod is admitted untouched.

The wire is admission.k8s.io/v1's AdmissionReview: the API server POSTs
a JSON AdmissionReview, the answer carries a base64-encoded RFC 6902
JSONPatch. ``webhook_app`` serves it on the port's standard-library
server (``POST /mutate``, ``GET /health``); Kubernetes requires TLS on
a webhook, which ``HTTPServer.start(..., ssl=)`` gives (the CLI's
``--tls-cert`` / ``--tls-key``); plain HTTP serves tests and
mesh-terminated TLS.
"""

from __future__ import annotations

import base64
import json
import logging
from typing import Any

from aigw_tpu_torch.gateway.http import HTTPServer, Request, json_response

logger = logging.getLogger(__name__)

#: the labels Envoy Gateway stamps on the pods it owns (upstream keys
#: its mutation on the same pair, gateway_mutator.go:131-132)
OWNING_GATEWAY_NAME_LABEL = "gateway.envoyproxy.io/owning-gateway-name"
OWNING_GATEWAY_NAMESPACE_LABEL = \
    "gateway.envoyproxy.io/owning-gateway-namespace"

SIDECAR_NAME = "ai-gateway-sidecar"  # upstream's ai-gateway-extproc


def build_sidecar(
    image: str,
    *,
    port: int = 1975,
    log_level: str = "info",
    extra_env: list[dict[str, str]] | None = None,
) -> dict[str, Any]:
    """The injected container: the whole gateway, configured from the
    cluster's CRDs through the in-cluster kube source.

    It runs under the pod's service account (Envoy Gateway's), which
    needs list/watch on the CRD kinds and patch on their /status: the
    chart ships a ClusterRole and binding for it
    (charts/aigw-tpu/templates/webhook.yaml). Without them the
    sidecar's in-cluster list answers 403."""
    return {
        "name": SIDECAR_NAME,
        "image": image,
        "args": ["run", "kube:in-cluster",
                 "--host", "0.0.0.0",
                 "--port", str(port),
                 "--log-level", log_level],
        "ports": [{"containerPort": port, "name": "aigw"}],
        "env": list(extra_env or ()),
        "readinessProbe": {
            "httpGet": {"path": "/health", "port": port},
            "initialDelaySeconds": 2,
            "periodSeconds": 5,
        },
    }


def mutate_pod(pod: dict[str, Any], image: str,
               **sidecar_kwargs: Any) -> list[dict[str, Any]]:
    """JSONPatch ops injecting the gateway sidecar, or [] when the pod
    is not a gateway pod or already carries the sidecar (webhooks fire
    again on every pod update)."""
    labels = (pod.get("metadata") or {}).get("labels") or {}
    if not labels.get(OWNING_GATEWAY_NAME_LABEL):
        return []
    spec = pod.get("spec") or {}
    containers = spec.get("containers") or []
    if any(c.get("name") == SIDECAR_NAME for c in containers):
        return []
    sidecar = build_sidecar(image, **sidecar_kwargs)
    if not containers:
        return [{"op": "add", "path": "/spec/containers",
                 "value": [sidecar]}]
    return [{"op": "add", "path": "/spec/containers/-",
             "value": sidecar}]


def review_response(review: dict[str, Any], image: str,
                    **sidecar_kwargs: Any) -> dict[str, Any]:
    """AdmissionReview in → AdmissionReview out, always allowed: a
    failed injection must never block a pod's creation (upstream's
    webhook has failurePolicy Ignore for the same reason)."""
    request = review.get("request") or {}
    uid = request.get("uid", "")
    response: dict[str, Any] = {"uid": uid, "allowed": True}
    try:
        # mutate_pod is a no-op for anything without the owning-gateway
        # label (and the webhook's rules already restrict it to pods)
        obj = request.get("object") or {}
        patch = mutate_pod(obj, image, **sidecar_kwargs)
        if patch:
            response["patchType"] = "JSONPatch"
            response["patch"] = base64.b64encode(
                json.dumps(patch).encode()).decode()
            name = (obj.get("metadata") or {}).get("name", "?")
            logger.info("injecting %s into pod %s", SIDECAR_NAME, name)
    except Exception:  # noqa: BLE001 — admission must not block pods
        logger.warning("pod mutation failed; admitting unmodified",
                       exc_info=True)
    return {
        "apiVersion": review.get("apiVersion", "admission.k8s.io/v1"),
        "kind": "AdmissionReview",
        "response": response,
    }


def webhook_app(image: str, **sidecar_kwargs: Any) -> HTTPServer:
    """The webhook's server: ``POST /mutate`` and ``GET /health``."""

    async def mutate(request: Request):
        try:
            review = json.loads(request.body)
        except json.JSONDecodeError:
            return json_response({"error": "invalid JSON"}, status=400)
        return json_response(
            review_response(review, image, **sidecar_kwargs))

    async def health(_request: Request):
        return json_response({"status": "ok"})

    return HTTPServer({("POST", "/mutate"): mutate,
                       ("GET", "/health"): health})

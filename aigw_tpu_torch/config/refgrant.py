"""ReferenceGrant enforcement for cross-namespace references (the
port's copy of ``aigw_tpu/config/refgrant.py``).

Gateway-API semantics (upstream
``internal/controller/referencegrant.go:21-180``): an AIGatewayRoute may
reference an AIServiceBackend or InferencePool in ANOTHER namespace only
if a ReferenceGrant in the TARGET namespace allows it — From must name
{group aigateway.envoyproxy.io, kind AIGatewayRoute, namespace
<route's>}, To must name the target's {group, kind}. Same-namespace
references never need a grant. Without this check any tenant could
route through any other namespace's backends.

Runs as a cross-object admission step of the directory reconciler
(``config/controller.py``); a violating route is NotAccepted with a
message naming the missing grant, as upstream's condition text does.
"""

from __future__ import annotations

from typing import Any

AIGW_GROUP = "aigateway.envoyproxy.io"
#: admission (config/admission.py) only admits InferencePool refs whose
#: backendRef.group is exactly this — grants must use the same group
INFERENCE_GROUP = "inference.networking.k8s.io"
ROUTE_KIND = "AIGatewayRoute"

#: referenceable target kinds → their API group (reference validates
#: AIServiceBackend and InferencePool refs; referencegrant.go:43-70)
_TARGET_GROUPS = {
    "AIServiceBackend": AIGW_GROUP,
    "InferencePool": INFERENCE_GROUP,
}


def _namespace(obj: dict[str, Any]) -> str:
    return (obj.get("metadata") or {}).get("namespace") or "default"


def obj_key(obj: dict[str, Any]) -> str:
    """Same identity as the reconciler's (controller._obj_key):
    namespace-qualified outside the default namespace, so verdicts
    key onto exactly the condition each object receives."""
    from aigw_tpu_torch.config.controller import _obj_key

    return _obj_key(obj)


def _grant_allows(grant: dict[str, Any], from_ns: str, to_group: str,
                  to_kind: str, to_name: str) -> bool:
    # explicit-null tolerance throughout (`or ()`): `from:`/`to:` as
    # YAML null must quarantine nothing and crash nothing
    spec = grant.get("spec") or {}
    from_ok = any(
        f.get("group") == AIGW_GROUP
        and f.get("kind") == ROUTE_KIND
        and f.get("namespace") == from_ns
        for f in (spec.get("from") or ()) if isinstance(f, dict)
    )
    if not from_ok:
        return False
    # Gateway API: a To entry with a name restricts the grant to that
    # one resource. (The reference matches group+kind only,
    # referencegrant.go matchesTo — honoring the name is strictly
    # narrower, per the upstream ReferenceGrant spec.)
    return any(
        t.get("group") == to_group and t.get("kind") == to_kind
        and (not t.get("name") or t.get("name") == to_name)
        for t in (spec.get("to") or ()) if isinstance(t, dict)
    )


def validate(objects: list[dict[str, Any]]) -> dict[str, str]:
    """Check every AIGatewayRoute's cross-namespace backendRefs against
    the ReferenceGrants present in ``objects``. Returns
    ``{obj_key(route): message}`` for each violating route."""
    grants_by_ns: dict[str, list[dict[str, Any]]] = {}
    for obj in objects:
        if obj.get("kind") == "ReferenceGrant":
            grants_by_ns.setdefault(_namespace(obj), []).append(obj)

    errors: dict[str, str] = {}
    for obj in objects:
        if obj.get("kind") != ROUTE_KIND:
            continue
        route_ns = _namespace(obj)
        key = obj_key(obj)
        spec = obj.get("spec") or {}
        for rule in (spec.get("rules") or ()):
            if not isinstance(rule, dict):
                continue
            for ref in (rule.get("backendRefs") or ()):
                if not isinstance(ref, dict):
                    continue
                target_ns = ref.get("namespace")
                if not target_ns or target_ns == route_ns:
                    continue
                kind = ref.get("kind") or "AIServiceBackend"
                group = ref.get("group") or _TARGET_GROUPS.get(
                    kind, AIGW_GROUP)
                ref_name = str(ref.get("name", "") or "")
                allowed = any(
                    _grant_allows(g, route_ns, group, kind, ref_name)
                    for g in grants_by_ns.get(target_ns, ())
                )
                if not allowed:
                    errors[key] = (
                        f"cross-namespace reference from AIGatewayRoute "
                        f"in namespace {route_ns} to {kind} "
                        f"{ref.get('name', '?')} in namespace "
                        f"{target_ns} is not permitted: no valid "
                        f"ReferenceGrant found in namespace {target_ns}."
                        f" A ReferenceGrant must allow AIGatewayRoute "
                        f"from namespace {route_ns} to reference {kind} "
                        f"in namespace {target_ns}"
                    )
                    break
            if key in errors:
                break
    return errors

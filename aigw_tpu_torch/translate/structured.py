"""OpenAI ``response_format`` parsing and JSON-schema ``$ref``
dereferencing (the port's own copy of the replica-side part of
``aigw_tpu/translate/structured.py``; the Gemini schema conversion
serves the gateway, not a replica, and is not copied).

``parse_response_format`` validates and normalizes the
``response_format`` union; ``dereference`` substitutes every ``$ref``
with circular-reference and recursion-depth guards. Every error is a
``JSONSchemaError`` (a client-facing 400) with the reference's message.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

MAX_RECURSION_DEPTH = 100


class JSONSchemaError(ValueError):
    """Invalid json_schema in response_format (client-facing 400)."""


# ---------------------------------------------------------------------------
# response_format parsing
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ResponseFormat:
    """Normalized OpenAI response_format."""

    kind: str  # "text" | "json_object" | "json_schema"
    schema: dict[str, Any] | None = None
    name: str = ""
    strict: bool = False


def parse_response_format(body: dict[str, Any]) -> ResponseFormat | None:
    """Validate + normalize ``body["response_format"]``; None if absent.

    Raises JSONSchemaError on malformed input."""
    rf = body.get("response_format")
    if rf is None:
        return None
    if not isinstance(rf, dict):
        raise JSONSchemaError("response_format must be an object")
    kind = rf.get("type")
    if kind in ("text", "json_object"):
        return ResponseFormat(kind=kind)
    if kind != "json_schema":
        raise JSONSchemaError(
            f"response_format.type must be one of 'text', 'json_object', "
            f"'json_schema'; got {kind!r}"
        )
    js = rf.get("json_schema")
    if not isinstance(js, dict):
        raise JSONSchemaError(
            "response_format.json_schema must be an object")
    schema = js.get("schema")
    if schema is not None and not isinstance(schema, dict):
        raise JSONSchemaError(
            "response_format.json_schema.schema must be an object")
    return ResponseFormat(
        kind="json_schema",
        schema=schema,
        name=str(js.get("name", "") or ""),
        strict=bool(js.get("strict", False)),
    )


# ---------------------------------------------------------------------------
# $ref dereferencing
# ---------------------------------------------------------------------------


def _retrieve_ref(path: str, schema: dict[str, Any]) -> Any:
    if not path.startswith("#/"):
        raise JSONSchemaError(
            f"ref paths must start with '#/', got: {path}")
    components = path.split("/")[1:]
    current: Any = schema
    for i, comp in enumerate(components):
        if not comp:
            raise JSONSchemaError(
                f"ref path contains empty component at position {i + 1}")
        if ".." in comp or "./" in comp:
            raise JSONSchemaError(
                f"ref path contains invalid characters: {comp}")
        if not isinstance(current, dict) or comp not in current:
            raise JSONSchemaError(
                f"reference {path!r} not found: component {comp!r} "
                "does not exist")
        current = current[comp]
    import copy

    return copy.deepcopy(current)


#: definition-container keys that hold referenced-only subschemas: they are
#: left un-dereferenced in place (consumers strip them). Only these may be
#: skipped — skipping arbitrary first-path components (e.g. a ref into
#: '#/properties/a') would exempt every same-named key from dereferencing.
_DEFINITION_CONTAINERS = frozenset({"$defs", "definitions"})


def _skip_keys(obj: Any, full: dict[str, Any], seen: set[str],
               depth: int) -> list[str]:
    """Definition-container keys reachable via $ref (e.g. '$defs') —
    left in place during dereferencing, dropped by consumers."""
    if depth >= MAX_RECURSION_DEPTH:
        raise JSONSchemaError(f"maximum recursion depth exceeded: {depth}")
    keys: list[str] = []
    if isinstance(obj, dict):
        for k, v in obj.items():
            if k == "$ref":
                if not isinstance(v, str):
                    raise JSONSchemaError("'$ref' value must be a string")
                if v in seen:
                    raise JSONSchemaError(
                        f"circular reference detected: {v}")
                seen.add(v)
                ref = _retrieve_ref(v, full)
                comps = v.split("/")
                if len(comps) > 1 and comps[1] in _DEFINITION_CONTAINERS:
                    keys.append(comps[1])
                keys.extend(_skip_keys(ref, full, seen, depth + 1))
                seen.discard(v)
            elif isinstance(v, (dict, list)):
                keys.extend(_skip_keys(v, full, seen, depth + 1))
    elif isinstance(obj, list):
        for el in obj:
            keys.extend(_skip_keys(el, full, seen, depth + 1))
    return keys


def _deref(obj: Any, full: dict[str, Any], skip: list[str],
           seen: set[str], depth: int) -> Any:
    if depth >= MAX_RECURSION_DEPTH:
        raise JSONSchemaError(f"maximum recursion depth exceeded: {depth}")
    if isinstance(obj, dict):
        out: dict[str, Any] = {}
        for k, v in obj.items():
            if k in skip:
                out[k] = v
                continue
            if k == "$ref":
                if not isinstance(v, str):
                    raise JSONSchemaError("'$ref' value must be a string")
                if v in seen:
                    raise JSONSchemaError(
                        f"circular reference detected: {v}")
                seen.add(v)
                ref = _retrieve_ref(v, full)
                resolved = _deref(ref, full, skip, seen, depth + 1)
                seen.discard(v)
                return resolved
            if isinstance(v, (dict, list)):
                out[k] = _deref(v, full, skip, seen, depth + 1)
            else:
                out[k] = v
        return out
    if isinstance(obj, list):
        return [_deref(el, full, skip, seen, depth + 1) for el in obj]
    return obj


def dereference(schema: dict[str, Any]) -> Any:
    """Substitute every ``$ref`` in a JSON Schema (circular-safe)."""
    if schema is None:
        raise JSONSchemaError("schema object cannot be None")
    skip = _skip_keys(schema, schema, set(), 0)
    return _deref(schema, schema, skip, set(), 0)

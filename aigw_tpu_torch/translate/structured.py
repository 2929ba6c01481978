"""OpenAI ``response_format`` parsing, JSON-schema ``$ref``
dereferencing and the Gemini schema conversion (the port's copy of
``aigw_tpu/translate/structured.py``).

``parse_response_format`` validates and normalizes the
``response_format`` union; ``dereference`` substitutes every ``$ref``
with circular-reference and recursion-depth guards; ``to_gemini_schema``
turns a JSON schema into Gemini's (GAPIC) form: allowed-field filtering,
``type: [T, "null"]`` → ``nullable: true``, single-element ``allOf``
collapse, and ``anyOf`` flattening with null-branch extraction. Every
error is a ``JSONSchemaError`` (a client-facing 400) with the reference's
message.
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


# ---------------------------------------------------------------------------
# Gemini (GAPIC) schema conversion
# ---------------------------------------------------------------------------

#: fields genai.Schema supports
GEMINI_ALLOWED_FIELDS = frozenset({
    "anyOf", "default", "description", "enum", "example", "format",
    "items", "maxItems", "maxLength", "maxProperties", "maximum",
    "minItems", "minLength", "minProperties", "minimum", "nullable",
    "pattern", "properties", "propertyOrdering", "required", "title",
    "type",
})


def _type_field(value: Any) -> dict[str, Any]:
    if isinstance(value, list):
        if len(value) != 2:
            raise JSONSchemaError(
                f"if type is a list, length must be 2, got {len(value)}")
        has_null = "null" in value
        non_null = next((t for t in value if t != "null"), None)
        if not has_null or non_null is None:
            raise JSONSchemaError(
                "if type is a list, it must contain one non-null type "
                "and 'null'")
        if isinstance(non_null, dict):
            raise JSONSchemaError("unexpected map type in type array")
        return {"type": str(non_null), "nullable": True}
    if isinstance(value, str):
        return {"type": value}
    raise JSONSchemaError(
        f"'type' must be a list or string, got {type(value).__name__}")


def _to_gapic(schema: dict[str, Any]) -> dict[str, Any]:
    out: dict[str, Any] = {}
    for key, value in schema.items():
        if key in _DEFINITION_CONTAINERS:
            continue
        if key == "$ref":
            # a $ref that survived dereferencing would silently become an
            # accept-anything schema — fail loudly instead
            raise JSONSchemaError(
                f"unresolved $ref in schema: {value!r}")
        if key == "items":
            if not isinstance(value, dict):
                raise JSONSchemaError(
                    f"'items' must be a dict, got {type(value).__name__}")
            out["items"] = _to_gapic(value)
        elif key == "properties":
            if not isinstance(value, dict):
                raise JSONSchemaError(
                    f"'properties' must be a dict, "
                    f"got {type(value).__name__}")
            props = {}
            for pk, pv in value.items():
                if not isinstance(pv, dict):
                    raise JSONSchemaError(
                        f"property {pk!r} must be a dict, "
                        f"got {type(pv).__name__}")
                props[pk] = _to_gapic(pv)
            out["properties"] = props
        elif key == "type":
            out.update(_type_field(value))
        elif key == "allOf":
            if not isinstance(value, list) or not value:
                raise JSONSchemaError("'allOf' must be a non-empty list")
            if len(value) > 1:
                raise JSONSchemaError(
                    f"only one value for 'allOf' key is supported, "
                    f"got {len(value)}")
            if not isinstance(value[0], dict):
                raise JSONSchemaError("item in 'allOf' must be an object")
            return _to_gapic(value[0])
        elif key == "anyOf":
            if not isinstance(value, list) or not value:
                raise JSONSchemaError("'anyOf' must be a non-empty list")
            branches = []
            nullable = False
            for i, v in enumerate(value):
                if not isinstance(v, dict):
                    raise JSONSchemaError(
                        f"item {i} in 'anyOf' must be a dict")
                if v.get("type") == "null":
                    nullable = True
                else:
                    branches.append(_to_gapic(v))
            if nullable:
                out["nullable"] = True
            out["anyOf"] = branches
        elif key in GEMINI_ALLOWED_FIELDS:
            out[key] = value
        # unknown fields are dropped (not in the allowed set)
    return out


def to_gemini_schema(schema: dict[str, Any]) -> dict[str, Any]:
    """JSON Schema → Gemini responseSchema dict (dereference + filter)."""
    deref = dereference(schema)
    if not isinstance(deref, dict):
        raise JSONSchemaError("dereferenced schema is not an object")
    return _to_gapic(deref)

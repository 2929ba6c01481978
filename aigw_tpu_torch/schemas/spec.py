"""Declarative typed-schema engine for request validation.

The reference gateway carries a fully-typed API schema layer
(reference internal/apischema/openai/openai.go — ~8.8k lines of Go
structs with union (un)marshalling) so malformed bodies are rejected at
the gateway, before any upstream traffic. Go needs a struct per shape;
the idiomatic Python equivalent is a small declarative spec language —
each endpoint's request type is written as a ``Spec`` of ``Field``
declarations (type, bounds, enum, nesting, unions) and validated
structurally. Strictness is per-field, not whole-body: unknown fields
pass through untouched (the reference marshals through typed structs
but deliberately re-attaches vendor-specific fields — proposal
docs/proposals/004-vendor-specific-fields/ — and backends accept
superset bodies; rejecting unknowns would break that contract).

Errors carry a JSON-path-ish location (``messages[2].content``) the way
the reference's unmarshal errors name the offending field.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable

from aigw_tpu_torch.schemas.openai import SchemaError

#: sentinel distinguishing "absent" from "present as null"
_MISSING = object()

# type atoms. "number" accepts int+float (JSON number), "integer" only
# int (bool is excluded from both — json booleans must not pass as 1/0).
_ATOMS: dict[str, Callable[[Any], bool]] = {
    "string": lambda v: isinstance(v, str),
    "integer": lambda v: isinstance(v, int) and not isinstance(v, bool),
    "number": lambda v: isinstance(v, (int, float))
    and not isinstance(v, bool),
    "boolean": lambda v: isinstance(v, bool),
    "object": lambda v: isinstance(v, dict),
    "array": lambda v: isinstance(v, list),
    "null": lambda v: v is None,
    "any": lambda v: True,
}


@dataclass(frozen=True)
class Field:
    """One field of a request object."""

    type: str = "any"  # atom name, or "array"/"object" with item/spec
    required: bool = False
    nullable: bool = True  # explicit null allowed for optional fields?
    enum: tuple[Any, ...] | None = None
    ge: float | None = None
    le: float | None = None
    min_len: int | None = None
    max_len: int | None = None
    item: "Field | None" = None  # array element type
    spec: "Spec | None" = None  # nested object spec
    union: tuple["Field", ...] | None = None  # any-of alternatives
    check: Callable[[Any, str], None] | None = None  # custom hook


@dataclass(frozen=True)
class Spec:
    """An object schema: named fields + cross-field checks."""

    fields: dict[str, Field] = field(default_factory=dict)
    checks: tuple[Callable[[dict, str], None], ...] = ()


def _fail(path: str, msg: str) -> None:
    raise SchemaError(f"{path}: {msg}" if path else msg)


def _type_name(v: Any) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "boolean"
    if isinstance(v, (int, float)):
        return "number"
    if isinstance(v, str):
        return "string"
    if isinstance(v, list):
        return "array"
    if isinstance(v, dict):
        return "object"
    return type(v).__name__


def _validate_field(value: Any, f: Field, path: str) -> None:
    if value is None:
        if f.nullable and not f.required:
            return
        _fail(path, "must not be null")
    if f.union is not None:
        errors = []
        for alt in f.union:
            try:
                _validate_field(value, alt, path)
                break
            except SchemaError as e:
                errors.append(str(e))
        else:
            # prefer the alternative that matched deepest (longest error
            # path) — for `input: [{"title": "x"}]` that is the object
            # form's "input[0].content: is required", not the flat
            # "must be string" of the scalar forms
            deepest = max(errors, key=lambda e: len(e.split(": ", 1)[0]))
            if deepest.split(": ", 1)[0] != path:
                raise SchemaError(deepest)
            _fail(path, "matched no allowed form (" + "; ".join(
                e.split(": ", 1)[-1] for e in errors[:4]) + ")")
        return
    atom = _ATOMS.get(f.type)
    if atom is None:
        raise RuntimeError(f"unknown field type {f.type!r} in spec")
    if not atom(value):
        _fail(path, f"must be {f.type}, got {_type_name(value)}")
    if f.enum is not None and value not in f.enum:
        _fail(path, f"must be one of {sorted(map(str, f.enum))}, "
                    f"got {value!r}")
    if isinstance(value, (int, float)) and not isinstance(value, bool):
        if f.ge is not None and value < f.ge:
            _fail(path, f"must be >= {f.ge}")
        if f.le is not None and value > f.le:
            _fail(path, f"must be <= {f.le}")
    if isinstance(value, (str, list, dict)):
        if f.min_len is not None and len(value) < f.min_len:
            _fail(path, f"must have at least {f.min_len} "
                        f"{'characters' if isinstance(value, str) else 'items'}")
        if f.max_len is not None and len(value) > f.max_len:
            _fail(path, f"must have at most {f.max_len} "
                        f"{'characters' if isinstance(value, str) else 'items'}")
    if isinstance(value, list) and f.item is not None:
        for i, v in enumerate(value):
            _validate_field(v, f.item, f"{path}[{i}]")
    if isinstance(value, dict) and f.spec is not None:
        validate_object(value, f.spec, path)
    if f.check is not None:
        f.check(value, path)


def validate_object(body: Any, spec: Spec, path: str = "") -> None:
    """Validate ``body`` against ``spec``; raises SchemaError on the
    first violation. Unknown fields are ignored (vendor passthrough)."""
    if not isinstance(body, dict):
        _fail(path, f"must be object, got {_type_name(body)}")
    for name, f in spec.fields.items():
        sub = f"{path}.{name}" if path else name
        value = body.get(name, _MISSING)
        if value is _MISSING:
            if f.required:
                _fail(sub, "is required")
            continue
        if value is None and f.required:
            _fail(sub, "must not be null")
        _validate_field(value, f, sub)
    for check in spec.checks:
        check(body, path)

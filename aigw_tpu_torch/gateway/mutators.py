"""Header/body mutators (reference internal/headermutator,
internal/bodymutator): backend-level set/remove of request headers and
top-level JSON body fields, applied after translation, before auth."""

from __future__ import annotations

import json

from aigw_tpu_torch.config.model import BodyMutation, HeaderMutation, _thaw


def apply_header_mutation(
    headers: dict[str, str], mutation: HeaderMutation
) -> dict[str, str]:
    if not mutation.set and not mutation.remove:
        return headers
    for name in mutation.remove:
        headers.pop(name, None)
    for name, value in mutation.set:
        headers[name] = value
    return headers


def apply_body_mutation(body: bytes, mutation: BodyMutation) -> bytes:
    if not mutation.set and not mutation.remove:
        return body
    try:
        data = json.loads(body)
    except json.JSONDecodeError:
        return body
    if not isinstance(data, dict):
        return body
    for name in mutation.remove:
        data.pop(name, None)
    for name, value in mutation.set:
        data[name] = _thaw(value)
    return json.dumps(data).encode()

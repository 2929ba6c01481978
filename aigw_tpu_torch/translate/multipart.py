"""Multipart/form-data helpers for the audio endpoints (the port's copy
of ``aigw_tpu/translate/multipart.py``).

The reference re-encodes a multipart body to apply a backend's model
name override, copying every other part (including the large audio file
part) verbatim (multipart_helper.go:16-66 rewriteMultipartModel,
:67-78 parseMultipartBoundary; used by the openai-openai audio
translators). Here the splice is done in place on the raw bytes — only
the ``model`` part's value bytes are replaced, so the boundary and
Content-Type stay valid and the file part is never copied through a
parser."""

from __future__ import annotations

import re


def parse_multipart_boundary(content_type: str) -> str:
    """Boundary parameter of a multipart Content-Type, or "" when the
    header is not multipart/has no boundary (multipart_helper.go:67)."""
    if "multipart" not in content_type.lower():
        return ""
    m = re.search(r'boundary="?([^";,]+)"?', content_type)
    return m.group(1) if m else ""


def rewrite_multipart_model(
    raw: bytes, content_type: str, new_model: str
) -> tuple[bytes, str]:
    """Replace the value of the ``model`` form field with ``new_model``,
    all other parts byte-for-byte untouched. Returns (body, content_type)
    — unchanged input when no model part / boundary is found (the caller
    forwards as-is, mirroring the reference's no-mutation path)."""
    boundary = parse_multipart_boundary(content_type)
    if not boundary:
        return raw, content_type
    delim = b"--" + boundary.encode()
    pos = 0
    while True:
        start = raw.find(delim, pos)
        if start < 0:
            return raw, content_type
        header_start = start + len(delim)
        header_end = raw.find(b"\r\n\r\n", header_start)
        if header_end < 0:
            return raw, content_type
        headers = raw[header_start:header_end]
        if re.search(rb'name="?model"?(;|\s|$)', headers):
            value_start = header_end + 4
            value_end = raw.find(b"\r\n" + delim, value_start)
            if value_end < 0:
                return raw, content_type
            return (
                raw[:value_start] + new_model.encode() + raw[value_end:],
                content_type,
            )
        pos = header_end

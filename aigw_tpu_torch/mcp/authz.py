"""MCP authorization: JWT validation + tool-level claim rules (the
port's copy of ``aigw_tpu/mcp/authz.py``).

Reference: internal/mcpproxy/authorization.go — OAuth2 protected-resource
metadata, JWT validation per ``MCPRouteAuthorizationRule``, tool-level
claims matching (api/v1alpha1/mcp_route.go JWTSource/JWKS rules).

Self-contained JWS verification (no PyJWT in the image): HS256 via hmac,
RS256 via the cryptography package, imported only when an RS256 key is
configured. Checks exp/nbf/iss/aud, then matches
tool-glob + required-claim rules.
"""

from __future__ import annotations

import base64
import fnmatch
import hashlib
import hmac
import json
import time
from dataclasses import dataclass
from typing import Any


class AuthzError(Exception):
    """Token missing/invalid (→ 401) or not permitted (→ 403)."""

    def __init__(self, message: str, status: int = 401):
        super().__init__(message)
        self.status = status


def _b64url(data: str) -> bytes:
    return base64.urlsafe_b64decode(data + "=" * (-len(data) % 4))


@dataclass(frozen=True)
class AuthzRule:
    """Allow tools matching ``tools`` globs to callers whose JWT carries
    all ``claims`` (values compared as strings; list claims match any)."""

    tools: tuple[str, ...] = ("*",)
    claims: tuple[tuple[str, str], ...] = ()

    def permits(self, tool: str, token_claims: dict[str, Any]) -> bool:
        if not any(fnmatch.fnmatch(tool, p) for p in self.tools):
            return False
        for name, want in self.claims:
            have = token_claims.get(name)
            if isinstance(have, list):
                if want not in [str(x) for x in have]:
                    return False
            elif str(have) != want:
                return False
        return True


@dataclass(frozen=True)
class MCPAuthzConfig:
    hs256_secret: str = ""
    rs256_public_key_pem: str = ""
    issuer: str = ""
    audience: str = ""
    rules: tuple[AuthzRule, ...] = ()
    # served at /.well-known/oauth-protected-resource (RFC 9728)
    resource: str = ""
    authorization_servers: tuple[str, ...] = ()

    @staticmethod
    def parse(value: dict[str, Any] | None) -> "MCPAuthzConfig | None":
        if not value:
            return None
        jwt = value.get("jwt") or {}
        rules = tuple(
            AuthzRule(
                tools=tuple(r.get("tools", ("*",))),
                claims=tuple(
                    (str(k), str(v))
                    for k, v in (r.get("claims") or {}).items()
                ),
            )
            for r in value.get("rules", ())
        ) or (AuthzRule(),)
        secret = jwt.get("hs256_secret", "")
        if secret.startswith("file:"):
            with open(secret[5:], "r", encoding="utf-8") as f:
                secret = f.read().strip()
        pem = jwt.get("rs256_public_key_pem", "")
        if pem.startswith("file:"):
            with open(pem[5:], "r", encoding="utf-8") as f:
                pem = f.read()
        if not secret and not pem:
            raise ValueError(
                "mcp.authorization.jwt needs hs256_secret or "
                "rs256_public_key_pem"
            )
        return MCPAuthzConfig(
            hs256_secret=secret,
            rs256_public_key_pem=pem,
            issuer=jwt.get("issuer", ""),
            audience=jwt.get("audience", ""),
            rules=rules,
            resource=value.get("resource", ""),
            authorization_servers=tuple(
                value.get("authorization_servers", ())
            ),
        )


class JWTValidator:
    def __init__(self, cfg: MCPAuthzConfig):
        self.cfg = cfg
        self._rsa_key = None
        if cfg.rs256_public_key_pem:
            from cryptography.hazmat.primitives.serialization import (
                load_pem_public_key,
            )

            self._rsa_key = load_pem_public_key(
                cfg.rs256_public_key_pem.encode()
            )

    def validate(self, token: str) -> dict[str, Any]:
        """Verify signature + standard claims; returns the claim set."""
        try:
            header_b64, payload_b64, sig_b64 = token.split(".")
            header = json.loads(_b64url(header_b64))
            payload = json.loads(_b64url(payload_b64))
            sig = _b64url(sig_b64)
        except (ValueError, json.JSONDecodeError) as e:
            raise AuthzError(f"malformed JWT: {e}") from None
        signing_input = f"{header_b64}.{payload_b64}".encode()

        alg = header.get("alg")
        if alg == "HS256" and self.cfg.hs256_secret:
            want = hmac.new(self.cfg.hs256_secret.encode(), signing_input,
                            hashlib.sha256).digest()
            if not hmac.compare_digest(want, sig):
                raise AuthzError("JWT signature invalid")
        elif alg == "RS256" and self._rsa_key is not None:
            from cryptography.exceptions import InvalidSignature
            from cryptography.hazmat.primitives import hashes
            from cryptography.hazmat.primitives.asymmetric import padding

            try:
                self._rsa_key.verify(sig, signing_input, padding.PKCS1v15(),
                                     hashes.SHA256())
            except InvalidSignature:
                raise AuthzError("JWT signature invalid") from None
        else:
            raise AuthzError(f"unsupported/unconfigured JWT alg {alg!r}")

        now = time.time()
        if "exp" in payload and now >= float(payload["exp"]):
            raise AuthzError("JWT expired")
        if "nbf" in payload and now < float(payload["nbf"]):
            raise AuthzError("JWT not yet valid")
        if self.cfg.issuer and payload.get("iss") != self.cfg.issuer:
            raise AuthzError("JWT issuer mismatch")
        if self.cfg.audience:
            aud = payload.get("aud")
            auds = aud if isinstance(aud, list) else [aud]
            if self.cfg.audience not in auds:
                raise AuthzError("JWT audience mismatch")
        return payload

    def authorize_tool(self, tool: str, claims: dict[str, Any]) -> None:
        if not any(r.permits(tool, claims) for r in self.cfg.rules):
            raise AuthzError(
                f"tool {tool!r} not permitted for this principal", status=403
            )


def sign_hs256(claims: dict[str, Any], secret: str) -> str:
    """Test helper: mint an HS256 JWT."""

    def enc(obj: Any) -> str:
        return base64.urlsafe_b64encode(
            json.dumps(obj).encode()
        ).rstrip(b"=").decode()

    head = enc({"alg": "HS256", "typ": "JWT"})
    body = enc(claims)
    sig = hmac.new(secret.encode(), f"{head}.{body}".encode(),
                   hashlib.sha256).digest()
    return f"{head}.{body}." + base64.urlsafe_b64encode(sig).rstrip(
        b"=").decode()

"""Backend auth handler implementations.

Parity map to the upstream gateway (internal/backendauth):
- ``ApiKeyHandler``          ≈ apikey.go   (Authorization: Bearer)
- ``AnthropicApiKeyHandler`` ≈ anthropic key handling (x-api-key + version)
- ``AzureApiKeyHandler``     ≈ azure.go    (api-key header)
- ``AzureTokenHandler``      ≈ azure OIDC token (Authorization: Bearer)
- ``GcpTokenHandler``        ≈ gcp.go      (Bearer + {project}/{region} path rewrite)
- ``AwsSigV4Handler``        ≈ aws.go      (SigV4 signing incl. body SHA-256)

Credentials may be literals or ``file:<path>`` references; file-backed
secrets are re-read when the file changes (the upstream gateway's rotators update
mounted Secret files in place — controller/rotators/*).

The port's copy of ``aigw_tpu/gateway/auth/handlers.py``.
"""

from __future__ import annotations

import datetime
import hashlib
import hmac
import os
import urllib.parse
from typing import Protocol

from aigw_tpu_torch.config.model import AuthConfig, AuthKind


class AuthError(Exception):
    """Credential missing/invalid (upstream ErrCredentialMissing → 401)."""


class AuthHandler(Protocol):
    def apply(
        self, headers: dict[str, str], body: bytes, path: str
    ) -> tuple[dict[str, str], str]: ...


class _Secret:
    """A literal or file-backed secret value with mtime-based refresh."""

    def __init__(self, value: str):
        self._path: str | None = None
        self._value = value
        self._mtime = 0.0
        if value.startswith("file:"):
            self._path = value[len("file:") :]
            self._value = ""

    def get(self) -> str:
        if self._path is None:
            return self._value
        try:
            mtime = os.stat(self._path).st_mtime
            if mtime != self._mtime or not self._value:
                with open(self._path, "r", encoding="utf-8") as f:
                    self._value = f.read().strip()
                self._mtime = mtime
        except OSError as e:
            raise AuthError(f"cannot read credential file {self._path}: {e}") from e
        return self._value


class NoopHandler:
    def apply(self, headers, body, path):
        return headers, path


class ApiKeyHandler:
    """Authorization: Bearer <key> (upstream backendauth/apikey.go)."""

    def __init__(self, key: str):
        self._key = _Secret(key)

    def apply(self, headers, body, path):
        key = self._key.get()
        if not key:
            raise AuthError("API key credential missing")
        headers["authorization"] = f"Bearer {key}"
        return headers, path


class AnthropicApiKeyHandler:
    """x-api-key + anthropic-version headers."""

    def __init__(self, key: str, version: str):
        self._key = _Secret(key)
        self._version = version

    def apply(self, headers, body, path):
        key = self._key.get()
        if not key:
            raise AuthError("Anthropic API key credential missing")
        headers["x-api-key"] = key
        headers.setdefault("anthropic-version", self._version)
        headers.pop("authorization", None)
        return headers, path


class AzureApiKeyHandler:
    """api-key header (upstream backendauth/azure.go)."""

    def __init__(self, key: str):
        self._key = _Secret(key)

    def apply(self, headers, body, path):
        key = self._key.get()
        if not key:
            raise AuthError("Azure API key credential missing")
        headers["api-key"] = key
        headers.pop("authorization", None)
        return headers, path


class BearerTokenHandler:
    """Authorization: Bearer <token> from a (possibly rotated) token file —
    used for Azure OIDC and plain OAuth backends."""

    def __init__(self, token: str):
        self._token = _Secret(token)

    def apply(self, headers, body, path):
        tok = self._token.get()
        if not tok:
            raise AuthError("bearer token credential missing")
        headers["authorization"] = f"Bearer {tok}"
        return headers, path


class GcpTokenHandler:
    """Bearer token plus `{GCP_PROJECT}`/`{GCP_REGION}` path substitution
    (the upstream gateway rewrites the Vertex path with project/region,
    backendauth/gcp.go + gcpauth)."""

    def __init__(self, token: str, project: str, region: str):
        self._token = _Secret(token)
        self._project = project
        self._region = region

    def apply(self, headers, body, path):
        tok = self._token.get()
        if not tok:
            raise AuthError("GCP access token credential missing")
        headers["authorization"] = f"Bearer {tok}"
        path = path.replace("{GCP_PROJECT}", self._project).replace(
            "{GCP_REGION}", self._region
        )
        return headers, path


class AwsSigV4Handler:
    """AWS Signature V4 request signing (upstream backendauth/aws.go).

    Signs method, canonical path/query, host, x-amz-date, x-amz-security-token
    (if present) and the SHA-256 of the final body — which is why the
    gateway re-applies auth after every retranslation/retry.
    """

    _SIGNED_HEADERS = ("host", "x-amz-date", "x-amz-security-token")

    def __init__(
        self,
        access_key_id: str,
        secret_access_key: str,
        session_token: str,
        region: str,
        service: str,
    ):
        self._akid = _Secret(access_key_id)
        self._secret = _Secret(secret_access_key)
        self._session = _Secret(session_token) if session_token else None
        self._region = region
        self._service = service

    def apply(self, headers, body, path):
        akid, secret = self._akid.get(), self._secret.get()
        if not akid or not secret:
            raise AuthError("AWS credentials missing")
        now = datetime.datetime.now(datetime.timezone.utc)
        amz_date = now.strftime("%Y%m%dT%H%M%SZ")
        datestamp = now.strftime("%Y%m%d")
        headers["x-amz-date"] = amz_date
        if self._session is not None:
            tok = self._session.get()
            if tok:
                headers["x-amz-security-token"] = tok

        parsed = urllib.parse.urlsplit(path)
        canonical_uri = urllib.parse.quote(parsed.path or "/", safe="/-_.~")
        query_pairs = urllib.parse.parse_qsl(parsed.query, keep_blank_values=True)
        canonical_query = "&".join(
            f"{urllib.parse.quote(k, safe='-_.~')}={urllib.parse.quote(v, safe='-_.~')}"
            for k, v in sorted(query_pairs)
        )
        present = [h for h in self._SIGNED_HEADERS if h in headers]
        canonical_headers = "".join(f"{h}:{headers[h].strip()}\n" for h in present)
        signed_headers = ";".join(present)
        payload_hash = hashlib.sha256(body or b"").hexdigest()
        canonical_request = "\n".join(
            (
                "POST",
                canonical_uri,
                canonical_query,
                canonical_headers,
                signed_headers,
                payload_hash,
            )
        )
        scope = f"{datestamp}/{self._region}/{self._service}/aws4_request"
        string_to_sign = "\n".join(
            (
                "AWS4-HMAC-SHA256",
                amz_date,
                scope,
                hashlib.sha256(canonical_request.encode()).hexdigest(),
            )
        )

        def _hmac(key: bytes, msg: str) -> bytes:
            return hmac.new(key, msg.encode(), hashlib.sha256).digest()

        k_date = _hmac(b"AWS4" + secret.encode(), datestamp)
        k_region = _hmac(k_date, self._region)
        k_service = _hmac(k_region, self._service)
        k_signing = _hmac(k_service, "aws4_request")
        signature = hmac.new(
            k_signing, string_to_sign.encode(), hashlib.sha256
        ).hexdigest()
        headers["authorization"] = (
            f"AWS4-HMAC-SHA256 Credential={akid}/{scope}, "
            f"SignedHeaders={signed_headers}, Signature={signature}"
        )
        return headers, path


def new_handler(auth: AuthConfig) -> AuthHandler:
    """Dispatch on auth kind (upstream backendauth.NewHandler, auth.go:19-61)."""
    k = auth.kind
    if k is AuthKind.NONE:
        return NoopHandler()
    if k is AuthKind.API_KEY:
        return ApiKeyHandler(auth.api_key)
    if k is AuthKind.ANTHROPIC_API_KEY:
        return AnthropicApiKeyHandler(auth.api_key, auth.anthropic_version)
    if k is AuthKind.AZURE_API_KEY:
        return AzureApiKeyHandler(auth.azure_api_key or auth.api_key)
    if k is AuthKind.AZURE_TOKEN:
        return BearerTokenHandler(auth.azure_access_token)
    if k is AuthKind.GCP_TOKEN:
        return GcpTokenHandler(auth.gcp_access_token, auth.gcp_project, auth.gcp_region)
    if k is AuthKind.AWS_SIGV4:
        return AwsSigV4Handler(
            auth.aws_access_key_id,
            auth.aws_secret_access_key,
            auth.aws_session_token,
            auth.aws_region,
            auth.aws_service,
        )
    raise AuthError(f"unsupported auth kind {k}")

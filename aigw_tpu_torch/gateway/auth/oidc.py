"""OIDC → cloud-credential exchange (background rotation).

Equivalent of the upstream gateway's credential rotators + token providers
(internal/controller/rotators/{aws_oidc_rotator.go:198,
gcp_oidc_token_rotator.go:400, azure_token_rotator.go:143},
tokenprovider/oidc_token_provider.go:113): a client-credentials OIDC token
is exchanged for provider credentials which are refreshed in the
background before expiry and exposed to the auth handlers.

Flows:
- ``OIDCTokenProvider``   — client_credentials grant against a token URL
- ``AWSOIDCExchanger``    — STS ``AssumeRoleWithWebIdentity`` (XML)
- ``GCPOIDCExchanger``    — GCP STS token exchange (+ optional service
                            account impersonation)
- ``AzureOIDCExchanger``  — AAD client_credentials for a scope

All HTTP targets are configurable, so tests drive them against local fake
servers (no egress).

The port's copy of ``aigw_tpu/gateway/auth/oidc.py``, on the gateway's
standard-library client (``gateway/http.py`` ``HTTPClient``) instead of an
aiohttp session: ``fetch`` takes the client, forms go out
``application/x-www-form-urlencoded`` and JSON bodies ``application/json``
with the bytes aiohttp would send, and every exchange is bounded by
``TIMEOUT`` (the reference rotator's 30 s session limit).
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import re
import time
import urllib.parse
from dataclasses import dataclass
from typing import Any

from aigw_tpu_torch.gateway.http import HTTPClient, Timeout

logger = logging.getLogger(__name__)

#: the limit of one exchange request
TIMEOUT = Timeout(total=30.0)


async def _post_form(client: HTTPClient, url: str,
                     form: dict[str, str]) -> tuple[int, bytes]:
    resp = await client.post(
        url, data=urllib.parse.urlencode(form).encode(),
        headers={"content-type": "application/x-www-form-urlencoded"},
        timeout=TIMEOUT)
    async with resp:
        return resp.status, await resp.read()


async def _post_json(client: HTTPClient, url: str, payload: Any,
                     headers: dict[str, str] | None = None
                     ) -> tuple[int, bytes]:
    resp = await client.post(
        url, data=json.dumps(payload).encode(),
        headers={**(headers or {}), "content-type": "application/json"},
        timeout=TIMEOUT)
    async with resp:
        return resp.status, await resp.read()


@dataclass
class Credential:
    value: dict[str, str]
    expires_at: float  # epoch seconds


class OIDCTokenProvider:
    """client_credentials grant → (access|id) token."""

    def __init__(self, token_url: str, client_id: str, client_secret: str,
                 scope: str = "openid"):
        self.token_url = token_url
        self.client_id = client_id
        self.client_secret = client_secret
        self.scope = scope

    async def fetch(self, client: HTTPClient) -> Credential:
        status, raw = await _post_form(client, self.token_url, {
            "grant_type": "client_credentials",
            "client_id": self.client_id,
            "client_secret": self.client_secret,
            "scope": self.scope,
        })
        if status != 200:
            raise RuntimeError(f"OIDC token endpoint returned {status}")
        data = json.loads(raw)
        token = data.get("id_token") or data.get("access_token", "")
        ttl = float(data.get("expires_in", 3600))
        return Credential({"token": token}, time.time() + ttl)


class AWSOIDCExchanger:
    """OIDC token → STS AssumeRoleWithWebIdentity temporary keys."""

    def __init__(self, provider: OIDCTokenProvider, role_arn: str,
                 sts_url: str = "https://sts.amazonaws.com",
                 session_name: str = "aigw-tpu"):
        self.provider = provider
        self.role_arn = role_arn
        self.sts_url = sts_url
        self.session_name = session_name

    async def fetch(self, client: HTTPClient) -> Credential:
        oidc = await self.provider.fetch(client)
        # form-encoded POST body (never the URL: the bearer token must
        # not land in proxy/server access logs)
        params = {
            "Action": "AssumeRoleWithWebIdentity",
            "Version": "2011-06-15",
            "RoleArn": self.role_arn,
            "RoleSessionName": self.session_name,
            "WebIdentityToken": oidc.value["token"],
        }
        status, raw = await _post_form(client, self.sts_url + "/", params)
        text = raw.decode("utf-8", "replace")
        if status != 200:
            raise RuntimeError(f"STS returned {status}: {text[:200]}")

        def xml(tag: str) -> str:
            m = re.search(rf"<{tag}>([^<]+)</{tag}>", text)
            return m.group(1) if m else ""

        expiry = xml("Expiration")
        expires_at = time.time() + 3600
        if expiry:
            try:
                from datetime import datetime, timezone

                expires_at = datetime.fromisoformat(
                    expiry.replace("Z", "+00:00")
                ).timestamp()
            except ValueError:
                pass
        return Credential(
            {
                "aws_access_key_id": xml("AccessKeyId"),
                "aws_secret_access_key": xml("SecretAccessKey"),
                "aws_session_token": xml("SessionToken"),
            },
            expires_at,
        )


class GCPOIDCExchanger:
    """OIDC token → GCP STS federated token (→ optional SA impersonation)."""

    def __init__(self, provider: OIDCTokenProvider, audience: str,
                 sts_url: str = "https://sts.googleapis.com/v1/token",
                 impersonate_url: str = ""):
        self.provider = provider
        self.audience = audience
        self.sts_url = sts_url
        self.impersonate_url = impersonate_url

    async def fetch(self, client: HTTPClient) -> Credential:
        oidc = await self.provider.fetch(client)
        status, raw = await _post_json(
            client, self.sts_url, {
                "grantType": (
                    "urn:ietf:params:oauth:grant-type:token-exchange"
                ),
                "audience": self.audience,
                "requestedTokenType": (
                    "urn:ietf:params:oauth:token-type:access_token"
                ),
                "subjectToken": oidc.value["token"],
                "subjectTokenType": (
                    "urn:ietf:params:oauth:token-type:jwt"
                ),
                "scope": "https://www.googleapis.com/auth/cloud-platform",
            })
        if status != 200:
            raise RuntimeError(f"GCP STS returned {status}")
        data = json.loads(raw)
        token = data.get("access_token", "")
        ttl = float(data.get("expires_in", 3600))
        expires_at = time.time() + ttl
        if self.impersonate_url:
            status, raw = await _post_json(
                client, self.impersonate_url,
                {"scope": ["https://www.googleapis.com/auth/cloud-platform"]},
                headers={"authorization": f"Bearer {token}"})
            if status != 200:
                raise RuntimeError(f"SA impersonation returned {status}")
            data = json.loads(raw)
            token = data.get("accessToken", token)
            # the SA token's own lifetime may be shorter than the
            # federated token's — honor the earlier expiry
            expire_time = data.get("expireTime", "")
            if expire_time:
                try:
                    from datetime import datetime

                    sa_exp = datetime.fromisoformat(
                        expire_time.replace("Z", "+00:00")
                    ).timestamp()
                    expires_at = min(expires_at, sa_exp)
                except ValueError:
                    pass
        return Credential({"gcp_access_token": token}, expires_at)


class AzureOIDCExchanger:
    """AAD client-credentials flow for a resource scope."""

    def __init__(self, token_url: str, client_id: str, client_secret: str,
                 scope: str = "https://cognitiveservices.azure.com/.default"):
        self._inner = OIDCTokenProvider(token_url, client_id, client_secret,
                                        scope)

    async def fetch(self, client: HTTPClient) -> Credential:
        cred = await self._inner.fetch(client)
        return Credential({"azure_access_token": cred.value["token"]},
                          cred.expires_at)


class CredentialRotator:
    """Background refresh loop writing rotated credentials to files the
    auth handlers watch (``file:<path>`` secrets re-read on mtime change —
    the same mounted-Secret contract as the upstream gateway's rotators)."""

    #: refresh when under this fraction of lifetime remains
    REFRESH_MARGIN = 0.2

    def __init__(self, exchanger: Any, out_paths: dict[str, str],
                 min_interval: float = 30.0):
        self.exchanger = exchanger
        self.out_paths = out_paths  # credential key → file path
        self.min_interval = min_interval
        self.current: Credential | None = None
        self._task: asyncio.Task | None = None

    @staticmethod
    def _write_secret(path: str, value: str) -> None:
        """Atomic, owner-only write: a reader never sees a truncated file
        and other local users can't read the credential (0600)."""
        tmp = f"{path}.tmp"
        fd = os.open(tmp, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
        try:
            os.write(fd, value.encode())
        finally:
            os.close(fd)
        os.replace(tmp, path)

    async def refresh_once(self, client: HTTPClient) -> None:
        cred = await self.exchanger.fetch(client)
        # NOTE: the three AWS files still update one-by-one; the SigV4
        # handler re-reads each on its own mtime, so a request landing
        # mid-rotation could pair an old secret with a new key id. STS
        # keys overlap in validity, so the stale *pair* (until the last
        # file flips) stays consistent per file-read; to avoid a mixed
        # pair we write the dependent files in reverse dependency order
        # (session token, secret, then key id last).
        ordered = sorted(
            self.out_paths.items(),
            key=lambda kv: kv[0] != "aws_access_key_id",
            reverse=True,
        )
        for key, path in ordered:
            if key in cred.value:
                self._write_secret(path, cred.value[key])
        self.current = cred
        logger.info("rotated credentials (%s), valid for %.0fs",
                    ",".join(self.out_paths), cred.expires_at - time.time())

    async def start(self) -> None:
        self._task = asyncio.create_task(self._run(), name="cred-rotator")

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass

    async def _run(self) -> None:
        client = HTTPClient()
        try:
            while True:
                try:
                    await self.refresh_once(client)
                    ttl = self.current.expires_at - time.time()
                    delay = max(self.min_interval,
                                ttl * (1 - self.REFRESH_MARGIN))
                except asyncio.CancelledError:
                    raise
                except Exception as e:  # keep last good credentials
                    logger.warning("credential rotation failed: %s", e)
                    delay = self.min_interval
                await asyncio.sleep(delay)
        finally:
            client.close()

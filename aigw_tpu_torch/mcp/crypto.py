"""Session-ID encryption (the port's copy of ``aigw_tpu/mcp/crypto.py``;
reference internal/mcpproxy/crypto.go: PBKDF2-derived AES-GCM with
primary/fallback seeds for rotation).

``cryptography``'s ``AESGCM`` is used where that package imports, and
otherwise the standard-library stand-in below, byte for byte the JAX
package's: a port gateway and a reference gateway given one seed accept
each other's tokens whenever both run the same AEAD. ``AEAD`` names the
one in use.

The client-facing MCP session ID *is* the encrypted map of per-backend
session IDs — the gateway keeps no session table and any replica can
resume any session (reference session.go:51-66).
"""

from __future__ import annotations

import base64
import hashlib
import hmac as _hmac
import os

try:
    from cryptography.exceptions import InvalidTag
    from cryptography.hazmat.primitives.ciphers.aead import AESGCM
except ModuleNotFoundError:  # pragma: no cover - environment-dependent
    # ``cryptography`` is a real dependency (pyproject), but minimal
    # images may lack the wheel. The session-ID tokens are produced AND
    # consumed only by gateway replicas sharing the same seed, so a
    # stdlib-only AEAD with the same interface keeps the feature alive:
    # SHA256-counter keystream XOR + truncated HMAC-SHA256 tag
    # (encrypt-then-MAC). NOT wire-compatible with the AES-GCM tokens —
    # a mixed fleet must install ``cryptography`` everywhere.
    class InvalidTag(Exception):  # type: ignore[no-redef]
        pass

    class AESGCM:  # type: ignore[no-redef]
        """Drop-in stand-in for cryptography's AESGCM (see above)."""

        def __init__(self, key: bytes):
            self._key = key

        def _stream(self, nonce: bytes, n: int) -> bytes:
            out = bytearray()
            ctr = 0
            while len(out) < n:
                out += hashlib.sha256(
                    self._key + nonce + ctr.to_bytes(8, "big")
                ).digest()
                ctr += 1
            return bytes(out[:n])

        def _tag(self, nonce: bytes, ct: bytes) -> bytes:
            return _hmac.new(
                self._key, b"tag" + nonce + ct, hashlib.sha256
            ).digest()[:16]

        def encrypt(self, nonce: bytes, data: bytes, _aad) -> bytes:
            ct = bytes(a ^ b
                       for a, b in zip(data, self._stream(nonce,
                                                          len(data))))
            return ct + self._tag(nonce, ct)

        def decrypt(self, nonce: bytes, data: bytes, _aad) -> bytes:
            if len(data) < 16:
                raise InvalidTag()
            ct, tag = data[:-16], data[-16:]
            if not _hmac.compare_digest(tag, self._tag(nonce, ct)):
                raise InvalidTag()
            return bytes(a ^ b
                         for a, b in zip(ct, self._stream(nonce,
                                                          len(ct))))

#: the AEAD this process seals session ids with
AEAD = ("AES-GCM (cryptography)" if AESGCM.__module__.startswith(
    "cryptography") else "SHA256-CTR + HMAC-SHA256 (standard library)")

_PBKDF2_ITERS = 100_000
_SALT = b"aigw-tpu-mcp-session"


class SessionCryptoError(Exception):
    pass


class SessionCrypto:
    """Encrypt/decrypt session payloads; fallback seed enables seamless
    key rotation (decrypt tries primary then fallback)."""

    def __init__(self, seed: str, fallback_seed: str = ""):
        self._keys = [self._derive(seed)]
        if fallback_seed:
            self._keys.append(self._derive(fallback_seed))

    @staticmethod
    def _derive(seed: str) -> AESGCM:
        key = hashlib.pbkdf2_hmac(
            "sha256", seed.encode(), _SALT, _PBKDF2_ITERS, dklen=32
        )
        return AESGCM(key)

    def encrypt(self, plaintext: bytes) -> str:
        nonce = os.urandom(12)
        ct = self._keys[0].encrypt(nonce, plaintext, None)
        return base64.urlsafe_b64encode(nonce + ct).decode().rstrip("=")

    def decrypt(self, token: str) -> bytes:
        try:
            raw = base64.urlsafe_b64decode(token + "=" * (-len(token) % 4))
        except Exception as e:
            raise SessionCryptoError(f"malformed session id: {e}") from None
        if len(raw) < 13:
            raise SessionCryptoError("session id too short")
        nonce, ct = raw[:12], raw[12:]
        for aead in self._keys:
            try:
                return aead.decrypt(nonce, ct, None)
            except InvalidTag:
                continue
        raise SessionCryptoError("session id failed authentication")

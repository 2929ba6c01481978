"""The MCP proxy's pure parts against the JAX package's: the session
crypto (tokens cross between the packages in both directions, with
``cryptography``'s AES-GCM and, with it blocked, with the standard-library
AEAD; a rotated fallback seed is accepted and an unknown one refused),
JWT validation and tool rules (the same claims, statuses and messages),
``FileReplayStore`` on one shared directory (events appended by either
package replay from the other with the same ids) and the memory store,
``parse_mcp_servers``, ``MCPConfig.parse`` and the routed ids."""

import base64
import dataclasses
import hashlib
import hmac
import importlib.util
import json
import pathlib
import random
import sys
import time

import pytest

from aigw_tpu.mcp import authz as jauthz
from aigw_tpu.mcp import crypto as jcrypto
from aigw_tpu.mcp import proxy as jproxy
from aigw_tpu.mcp import replay as jreplay
from aigw_tpu.mcp import stdio_bridge as jstdio
from aigw_tpu_torch.mcp import authz as tauthz
from aigw_tpu_torch.mcp import crypto as tcrypto
from aigw_tpu_torch.mcp import proxy as tproxy
from aigw_tpu_torch.mcp import replay as treplay
from aigw_tpu_torch.mcp import stdio_bridge as tstdio

ROOT = pathlib.Path(__file__).resolve().parent.parent


# -- session crypto -------------------------------------------------------------
def _load_blocked(path: pathlib.Path, name: str, monkeypatch):
    """``path`` loaded as a fresh module ``name`` while ``cryptography``
    cannot be imported."""
    for k in [k for k in sys.modules if k.split(".")[0] == "cryptography"]:
        monkeypatch.setitem(sys.modules, k, None)
    monkeypatch.setitem(sys.modules, "cryptography", None)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(params=["aes-gcm", "stdlib"])
def cryptos(request, monkeypatch):
    """(reference module, port module) under one AEAD."""
    if request.param == "aes-gcm":
        assert tcrypto.AEAD.startswith("AES-GCM")
        return jcrypto, tcrypto
    j = _load_blocked(ROOT / "aigw_tpu/mcp/crypto.py", "_ref_crypto_std",
                      monkeypatch)
    t = _load_blocked(ROOT / "aigw_tpu_torch/mcp/crypto.py",
                      "_port_crypto_std", monkeypatch)
    assert t.AEAD.endswith("(standard library)")
    assert not j.AESGCM.__module__.startswith("cryptography")
    return j, t


def test_session_tokens_cross_both_ways(cryptos):
    j, t = cryptos
    rng = random.Random(5)
    for _ in range(8):
        payload = json.dumps({f"b{i}": f"s-{rng.getrandbits(40):x}"
                              for i in range(rng.randint(0, 3))}).encode()
        assert j.SessionCrypto("seed").decrypt(
            t.SessionCrypto("seed").encrypt(payload)) == payload
        assert t.SessionCrypto("seed").decrypt(
            j.SessionCrypto("seed").encrypt(payload)) == payload


def test_rotation_accepts_fallback_and_refuses_unknown(cryptos):
    j, t = cryptos
    for mint, read, err in ((j, t, t.SessionCryptoError),
                            (t, j, j.SessionCryptoError)):
        tok = mint.SessionCrypto("old").encrypt(b"x")
        assert read.SessionCrypto("new", fallback_seed="old").decrypt(
            tok) == b"x"
        with pytest.raises(err, match="failed authentication"):
            read.SessionCrypto("new", fallback_seed="other").decrypt(tok)
        for bad, msg in (("", "too short"), ("@@@", "too short"),
                         (tok[:-2] + ("AA" if tok[-2:] != "AA" else "BB"),
                          "failed authentication")):
            with pytest.raises(err, match=msg):
                read.SessionCrypto("old").decrypt(bad)


def test_the_two_aeads_do_not_cross(monkeypatch):
    """The stand-in is not wire-compatible with AES-GCM, in either
    package: a mixed fleet must run one AEAD everywhere."""
    std = _load_blocked(ROOT / "aigw_tpu_torch/mcp/crypto.py",
                        "_port_crypto_std2", monkeypatch)
    tok = tcrypto.SessionCrypto("s").encrypt(b"x")
    with pytest.raises(std.SessionCryptoError):
        std.SessionCrypto("s").decrypt(tok)
    with pytest.raises(tcrypto.SessionCryptoError):
        tcrypto.SessionCrypto("s").decrypt(
            std.SessionCrypto("s").encrypt(b"x"))


# -- authorization --------------------------------------------------------------
def _b64(obj) -> str:
    raw = obj if isinstance(obj, bytes) else json.dumps(obj).encode()
    return base64.urlsafe_b64encode(raw).rstrip(b"=").decode()


def _rsa():
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import padding, rsa

    key = rsa.generate_private_key(public_exponent=65537, key_size=2048)
    pem = key.public_key().public_bytes(
        serialization.Encoding.PEM,
        serialization.PublicFormat.SubjectPublicKeyInfo).decode()

    def sign(claims, alg="RS256"):
        head, body = _b64({"alg": alg, "typ": "JWT"}), _b64(claims)
        sig = key.sign(f"{head}.{body}".encode(), padding.PKCS1v15(),
                       hashes.SHA256())
        return f"{head}.{body}.{_b64(sig)}"

    return pem, sign


def _tokens(sign_rs):
    now = time.time()
    good = {"iss": "https://auth.example", "aud": "mcp", "role": "user"}
    hs = lambda c, k="jwt-secret": tauthz.sign_hs256(c, k)  # noqa: E731
    none_tok = f"{_b64({'alg': 'none'})}.{_b64(good)}."
    return {
        "valid": hs(good),
        "valid_list_aud": hs(dict(good, aud=["x", "mcp"])),
        "admin": hs(dict(good, role="admin")),
        "groups": hs(dict(good, role=["a", "user"])),
        "rs256": sign_rs(good),
        "rs256_forged": sign_rs(good)[:-4] + "AAAA",
        "wrong_secret": hs(good, "other"),
        "expired": hs(dict(good, exp=now - 10)),
        "not_yet": hs(dict(good, nbf=now + 600)),
        "issuer": hs(dict(good, iss="https://evil")),
        "audience": hs(dict(good, aud="other")),
        "alg_none": none_tok,
        "malformed": "a.b",
        "bad_json": f"{_b64(b'{')}.{_b64(good)}.x",
    }


def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 (compared across packages)
        return (type(e).__name__, str(e), getattr(e, "status", None))


def test_jwt_validation_and_rules_match_reference(tmp_path):
    pem, sign_rs = _rsa()
    (tmp_path / "secret").write_text("jwt-secret\n")
    (tmp_path / "key.pem").write_text(pem)
    raw = {
        "resource": "/mcp",
        "authorization_servers": ["https://auth.example"],
        "jwt": {"hs256_secret": f"file:{tmp_path / 'secret'}",
                "rs256_public_key_pem": f"file:{tmp_path / 'key.pem'}",
                "issuer": "https://auth.example", "audience": "mcp"},
        "rules": [{"tools": ["alpha__search"], "claims": {"role": "user"}},
                  {"tools": ["alpha__*"], "claims": {"role": "admin"}}],
    }
    jc, tc = jauthz.MCPAuthzConfig.parse(raw), tauthz.MCPAuthzConfig.parse(raw)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    jv, tv = jauthz.JWTValidator(jc), tauthz.JWTValidator(tc)
    seen = set()
    for name, tok in _tokens(sign_rs).items():
        got, want = _outcome(lambda: tv.validate(tok)), \
            _outcome(lambda: jv.validate(tok))
        assert got == want, name
        seen.add(got[0])
        if got[0] != "ok":
            continue
        for tool in ("alpha__search", "alpha__admin_reset", "beta__x"):
            assert _outcome(lambda: tv.authorize_tool(tool, got[1])) == \
                _outcome(lambda: jv.authorize_tool(tool, want[1])), \
                (name, tool)
    assert seen == {"ok", "AuthzError"}
    # the statuses: a bad token is a 401, a refused tool a 403
    with pytest.raises(tauthz.AuthzError) as e:
        tv.authorize_tool("alpha__admin_reset", {"role": "user"})
    assert e.value.status == 403
    assert tauthz.sign_hs256({"a": 1}, "k") == jauthz.sign_hs256({"a": 1}, "k")


@pytest.mark.parametrize("raw", [
    None, {}, {"jwt": {}}, {"jwt": {"hs256_secret": "k"}},
    {"jwt": {"hs256_secret": "k"}, "rules": [{"claims": {"n": 1}}]},
    {"jwt": {"hs256_secret": "file:/nonexistent/secret"}},
], ids=["none", "empty", "no-secret", "default-rule", "claim-str",
        "missing-file"])
def test_authz_config_parse_matches_reference(raw):
    want = _outcome(lambda: jauthz.MCPAuthzConfig.parse(raw))
    got = _outcome(lambda: tauthz.MCPAuthzConfig.parse(raw))
    if want[0] == "ok" and want[1] is not None:
        assert dataclasses.asdict(got[1]) == dataclasses.asdict(want[1])
    else:
        assert got == want


# -- replay stores --------------------------------------------------------------
def _enc(event_id: int) -> bytes:
    return f"id: {event_id}\ndata: x\n\n".encode()


def test_file_replay_store_is_shared_across_packages(tmp_path):
    """Appends by either package allocate one id sequence on one spool
    and replay from the other, trims included."""
    rng = random.Random(11)
    stores = [jreplay.FileReplayStore(str(tmp_path)),
              treplay.FileReplayStore(str(tmp_path))]
    bufs = [s.buffer("tok") for s in stores]
    out = []
    for i in range(treplay._REPLAY_EVENTS + 70):
        out.append(bufs[rng.randrange(2)].append(_enc))
    assert out == [_enc(i + 1) for i in range(len(out))]
    for last in (0, 5, len(out) - 3):
        assert bufs[1].events_after(last) == bufs[0].events_after(last)
    assert bufs[1].events_after(len(out) - 3) == \
        [_enc(i) for i in range(len(out) - 2, len(out) + 1)]
    assert treplay._key("tok") == jreplay._key("tok")
    assert treplay.FileReplayStore(str(tmp_path)).buffer(
        "never").events_after(0) == []


def test_memory_replay_store_matches_reference():
    rng = random.Random(3)
    j, t = jreplay.MemoryReplayStore(), treplay.MemoryReplayStore()
    assert j.buffer("") is None and t.buffer("") is None
    for _ in range(300):
        tok = f"s{rng.randrange(4)}"
        assert t.buffer(tok).append(_enc) == j.buffer(tok).append(_enc)
    for tok in ("s0", "s3"):
        assert t.buffer(tok).events_after(10) == \
            j.buffer(tok).events_after(10)
    assert isinstance(treplay.make_store(""), treplay.MemoryReplayStore)
    assert treplay.make_store("/tmp").blocking is True


# -- configs and routed ids -----------------------------------------------------
MCP_SERVERS = [
    {"mcpServers": {
        "web": {"url": "http://127.0.0.1:7001/mcp",
                "headers": {"Authorization": "Bearer t"},
                "includeTools": ["search*"]},
        "local": {"command": "python", "args": ["srv.py", 1],
                  "env": {"A": "1"}, "includeTools": ["echo"]},
        "plain": {"url": "http://h/mcp"}}},
    {"mcpServers": {}},
    "not json",
    {"servers": {}},
    {"mcpServers": {"x": 1}},
    {"mcpServers": {"x": {"args": []}}},
]


@pytest.mark.parametrize("raw", MCP_SERVERS,
                         ids=["mixed", "empty", "bad-json", "no-key",
                              "not-object", "no-url"])
def test_parse_mcp_servers_matches_reference(raw):
    text = raw if isinstance(raw, str) else json.dumps(raw)
    want = _outcome(lambda: jstdio.parse_mcp_servers(text))
    got = _outcome(lambda: tstdio.parse_mcp_servers(text))
    if want[0] == "ok":
        (jb, js), (tb, ts) = want[1], got[1]
        assert tb == jb
        assert [dataclasses.asdict(s) for s in ts] == \
            [dataclasses.asdict(s) for s in js]
    else:
        assert got == want


def test_mcp_config_parse_matches_reference(tmp_path):
    (tmp_path / "k").write_text("sec")
    raw = {
        "path": "/tools", "session_seed": "a", "session_fallback_seed": "b",
        "replay_dir": str(tmp_path / "spool"),
        "backends": [
            {"name": "alpha", "url": "http://a/mcp",
             "tool_filter": {"include": ["s*"], "exclude": ["s_x"],
                             "include_regex": ["^f.*$"]},
             "headers": [{"name": "X-Key", "value": "v"}]},
            {"name": "beta", "url": "http://b/mcp"}],
        "authorization": {"jwt": {"hs256_secret": f"file:{tmp_path / 'k'}"}},
    }
    for value in (raw, {}):
        j, t = jproxy.MCPConfig.parse(value), tproxy.MCPConfig.parse(value)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
    j, t = jproxy.MCPConfig.parse(raw), tproxy.MCPConfig.parse(raw)
    for tool in ("search", "s_x", "fetch", "other", "f"):
        assert [b.allows(tool) for b in t.backends] == \
            [b.allows(tool) for b in j.backends], tool


def test_routed_ids_match_reference():
    rng = random.Random(2)
    values = [7, "str-id", 1.5, "with.dots", "", None, [1, "a"],
              {"k": rng.random()}]
    for prefix in (tproxy.S2C_ID_PREFIX, tproxy.PROGRESS_TOKEN_PREFIX):
        for v in values:
            for backend in ("alpha", "back.end"):
                enc = tproxy._encode_routed(prefix, v, backend)
                assert enc == jproxy._encode_routed(prefix, v, backend)
                assert tproxy._decode_routed(prefix, enc) == \
                    jproxy._decode_routed(prefix, enc) == (v, backend)
        for bad in ("plain", 12, prefix + "nodot", prefix + "!!!.b",
                    prefix + "e30.", None):
            assert tproxy._decode_routed(prefix, bad) == \
                jproxy._decode_routed(prefix, bad)
    assert (tproxy.S2C_ID_PREFIX, tproxy.PROGRESS_TOKEN_PREFIX,
            tproxy.PING_ID_PREFIX, tproxy.S2C_REQUEST_METHODS,
            tproxy.PROTOCOL_VERSION) == (
        jproxy.S2C_ID_PREFIX, jproxy.PROGRESS_TOKEN_PREFIX,
        jproxy.PING_ID_PREFIX, jproxy.S2C_REQUEST_METHODS,
        jproxy.PROTOCOL_VERSION)
    for status in (400, 401, 403, 404, 413, 500, 502):
        assert tproxy._metric_error_type(status) == \
            jproxy._metric_error_type(status)
    for code in (-32601, -32602, -32700, -32600, -32603, -32000, -32001, 1):
        assert tproxy._rpc_error_type(code) == jproxy._rpc_error_type(code)


def test_hs256_signature_is_plain_hmac():
    """``sign_hs256`` is HMAC-SHA256 over the JOSE signing input."""
    tok = tauthz.sign_hs256({"sub": "u"}, "k")
    head, body, sig = tok.split(".")
    want = hmac.new(b"k", f"{head}.{body}".encode(), hashlib.sha256).digest()
    assert tauthz._b64url(sig) == want

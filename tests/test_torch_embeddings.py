"""``POST /v1/embeddings`` on a port replica against the reference
server's, on the reference's tiny-random weights in float32.

Both servers answer the same bodies one at a time: a string, a list of
strings, one token-id list (ids past the vocabulary taken mod it), a
list of token-id lists, an input longer than ``max_seq_len`` (cut to
it), nine inputs (the port replica's small ``embed_logits_bytes`` runs
them, and most lists, in sub-batches), and every refusal (no input, an empty list, a bad element, a
non-JSON body). Statuses and error bodies are equal; a vector reply
equals the reference's in every key, its vectors within ``LOGIT_TOL``
per element, ``usage`` and the ``index`` order exactly. Then each
replica drains and answers an embeddings call all the same, while it
refuses a completion with the drain's 503.
"""

import asyncio
import dataclasses
import json
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from aigw_tpu.models import llama as jllama
from aigw_tpu.tpuserve import engine as jengine
from aigw_tpu_torch.models import convert
from aigw_tpu_torch.models import llama as tllama
from aigw_tpu_torch.tpuserve import engine as tengine

MODEL = "tiny-random"
EOS = (257,)
LOGIT_TOL = 1e-4
CFG = dict(max_batch_size=2, max_seq_len=64, page_size=16,
           kv_cache_dtype="float32")
#: the port replica's embeddings budget: 4 inputs a sub-batch at S 16
#: ("many": 9 inputs of 12 tokens; "strings", 3 inputs, fits one), one
#: at S 32 and S 64 ("id_lists" and "long" run an input a call)
SUB_ROWS, SUB_S = 4, 16
_LONG = "".join(chr(97 + i % 26) for i in range(150))
#: (name, raw request body)
CALLS = [
    ("string", {"model": MODEL, "input": "hello embeddings"}),
    ("strings", {"model": MODEL, "input": ["a", "second input", ""]}),
    ("ids", {"model": MODEL, "input": [5, 9, 700, 3]}),
    ("id_lists", {"model": MODEL, "input": [[1, 2, 3], [4] * 20, []]}),
    ("long", {"model": MODEL, "input": [_LONG, list(range(100))]}),
    ("many", {"model": MODEL,
              "input": [f"sub-batch {i:02d}" for i in range(9)]}),
    ("no_input", {"model": MODEL}),
    ("empty_list", {"model": MODEL, "input": []}),
    ("bad_element", {"model": MODEL, "input": ["ok", 3.5]}),
    ("mixed_list", {"model": MODEL, "input": [[1, 2], [3, "x"]]}),
    ("not_json", b"{not json"),
]


def _post(port, path, body):
    data = body if isinstance(body, bytes) else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=data, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _drive(port):
    out = [_post(port, "/v1/embeddings", body) for _name, body in CALLS]
    status, _ = _post(port, "/drain", {})
    assert status == 200
    out.append(_post(port, "/v1/embeddings", CALLS[0][1]))
    out.append(_post(port, "/v1/completions",
                     {"model": MODEL, "prompt": "hi", "max_tokens": 2})[0])
    return out


@pytest.fixture(scope="module")
def weights():
    p = jllama.init_params(jax.random.PRNGKey(0), jllama.TINY,
                           dtype=jnp.float32)
    return p, convert.params_from_numpy(
        {k: np.asarray(v) for k, v in p.items()}, device="cpu")


@pytest.fixture(scope="module")
def reference_run(weights):
    from aiohttp import web

    from aigw_tpu.tpuserve import server as jserver

    jp, _ = weights

    class F32Server(jserver.TPUServeServer):
        def _load_params(self, spec):
            return jp

    holder = {}
    started = threading.Event()

    def run():
        async def main():
            server = F32Server(MODEL, jengine.EngineConfig(**CFG))
            runner = web.AppRunner(server.app)
            await runner.setup()
            site = web.TCPSite(runner, "127.0.0.1", 0)
            await site.start()
            holder["port"] = site._server.sockets[0].getsockname()[1]
            holder["loop"] = asyncio.get_running_loop()
            holder["stop"] = asyncio.Event()
            started.set()
            await holder["stop"].wait()
            await runner.cleanup()

        asyncio.run(main())

    t = threading.Thread(target=run, daemon=True)
    t.start()
    assert started.wait(timeout=300)
    try:
        return _drive(holder["port"])
    finally:
        holder["loop"].call_soon_threadsafe(holder["stop"].set)
        t.join(timeout=60)


@pytest.fixture(scope="module")
def port_run(weights):
    from aigw_tpu_torch.tpuserve.server import TPUServeServer

    srv = TPUServeServer(MODEL, tengine.EngineConfig(**CFG), device="cpu",
                         port=0, param_dtype="float32")
    srv.engine = tengine.Engine(weights[1], tllama.TINY, srv.engine.cfg,
                                eos_token_ids=EOS, fns=srv.fns, device="cpu")
    srv.embed_logits_bytes = SUB_ROWS * 4 * tllama.TINY.n_heads * SUB_S ** 2
    calls = []

    def recorded(p, cfg, tokens, lens, **kw):
        calls.append(tuple(tokens.shape))
        return tllama.hidden_states(p, cfg, tokens, lens, **kw)

    srv.fns = dataclasses.replace(srv.fns, hidden_states=recorded)
    srv.start()
    try:
        return _drive(srv.port), calls
    finally:
        srv.stop()


def _assert_same_reply(got, want, where):
    g_status, g = got
    w_status, w = want
    assert g_status == w_status, (where, g, w)
    if w_status != 200:
        assert g == w, where
        return
    assert set(g) == set(w) and g["object"] == w["object"] == "list"
    assert g["model"] == w["model"] and g["usage"] == w["usage"]
    assert [d["index"] for d in g["data"]] == [d["index"] for d in w["data"]]
    assert [d["object"] for d in g["data"]] == [d["object"]
                                                 for d in w["data"]]
    np.testing.assert_allclose(
        np.array([d["embedding"] for d in g["data"]], np.float64),
        np.array([d["embedding"] for d in w["data"]], np.float64),
        rtol=LOGIT_TOL, atol=LOGIT_TOL, err_msg=where)


@pytest.mark.parametrize("i", range(len(CALLS)),
                         ids=[name for name, _ in CALLS])
def test_embeddings_reply_matches_reference(port_run, reference_run, i):
    _assert_same_reply(port_run[0][i], reference_run[i], CALLS[i][0])


def test_draining_replica_still_embeds(port_run, reference_run):
    """Draining gates generations, not embeddings, on both replicas: the
    reply after the drain equals the first call's, and a completion
    gets the drain's 503."""
    n = len(CALLS)
    for run in (port_run[0], reference_run):
        _assert_same_reply(run[n], run[0], "draining")
        assert run[n + 1] == 503


def test_embeddings_shapes_and_cut(port_run):
    """Beyond parity: one dim-wide vector per input, the over-long input
    cut to max_seq_len in usage, an empty input pooled to zeros."""
    dim = tllama.TINY.dim
    status, body = port_run[0][[n for n, _ in CALLS].index("long")]
    assert status == 200
    assert [len(d["embedding"]) for d in body["data"]] == [dim, dim]
    assert body["usage"] == {"prompt_tokens": 2 * CFG["max_seq_len"],
                             "total_tokens": 2 * CFG["max_seq_len"]}
    _s, strings = port_run[0][1]
    assert not any(strings["data"][2]["embedding"])


def test_embeddings_split_into_sub_batches(port_run):
    """Inputs past one sub-batch of ``embed_logits_bytes`` run as several
    ``hidden_states`` calls over the same block length, in order: the
    9 inputs of "many" as 4 + 4 + 1 at S 16, the 2 of "long" one at a
    time at S 64; their replies equal the reference's unsplit pass
    (``test_embeddings_reply_matches_reference``)."""
    _replies, calls = port_run
    many = calls.index((SUB_ROWS, SUB_S))
    assert calls[many:many + 3] == [(4, 16), (4, 16), (1, 16)]
    long = calls.index((1, 64))
    assert calls[long:long + 2] == [(1, 64), (1, 64)]

"""Checkpoints of the port (``models/checkpoint.py``, the server's
``orbax:`` weights, the CLI's ``convert`` and ``--lora``) against the
JAX package's ``aigw_tpu/models/checkpoint.py``.

- The standard-library safetensors reader: every dtype it reads, a
  zero-size tensor and ``__metadata__`` from ``safetensors.numpy``'s
  files; its writer read back by ``safetensors``.
- ``import_hf_checkpoint``: HF-layout shards written with
  ``safetensors.numpy.save_file`` from the reference's ``init_params``
  (two files and an unmapped tensor) equal the reference's import byte
  for byte, for tiny-random, tiny-moe (experts stacked) and tiny-qwen
  (QKV biases, tied embeddings), from bf16 and float32 files.
- orbax directories both ways: the reference's ``save_checkpoint`` read
  by the port, the port's read by the reference with and without
  ``like``; ``like`` mismatches raise.
- A registry row with ``orbax:`` weights: the port replica's greedy and
  seeded streams equal a reference replica's built from the same
  directory, bf16 and ``quantize="int8"``.
- ``convert`` and ``--lora NAME=ORBAX_DIR`` end to end; ``hf:`` and an
  unknown source raise as the reference does; with tensorstore missing
  every orbax path raises naming it.
"""

import asyncio
import json
import logging
import os
import subprocess
import sys
import threading
import urllib.request

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from safetensors.numpy import load_file, save_file

from aigw_tpu.models import checkpoint as jckpt
from aigw_tpu.models import llama as jllama
from aigw_tpu.models import lora as jlora
from aigw_tpu.models import mixtral as jmixtral
from aigw_tpu.models import registry as jregistry
from aigw_tpu.tpuserve import engine as jengine
from aigw_tpu_torch.models import checkpoint as tckpt
from aigw_tpu_torch.models import llama as tllama
from aigw_tpu_torch.models import registry as tregistry
from aigw_tpu_torch.tpuserve import engine as tengine

MODELS = {
    "tiny-random": (jllama.init_params, jllama.TINY),
    "tiny-moe": (jmixtral.init_params, jmixtral.TINY_MOE),
    "tiny-qwen": (jllama.init_params,
                  jregistry.get_model_spec("tiny-qwen").config),
}

# the port's [in, out] names → HF's [out, in] ones (the inverse of _HF_MAP)
_LAYER = {"attn_norm": ("input_layernorm.weight", False),
          "wq": ("self_attn.q_proj.weight", True),
          "wk": ("self_attn.k_proj.weight", True),
          "wv": ("self_attn.v_proj.weight", True),
          "wo": ("self_attn.o_proj.weight", True),
          "bq": ("self_attn.q_proj.bias", False),
          "bk": ("self_attn.k_proj.bias", False),
          "bv": ("self_attn.v_proj.bias", False),
          "mlp_norm": ("post_attention_layernorm.weight", False),
          "w_gate": ("mlp.gate_proj.weight", True),
          "w_up": ("mlp.up_proj.weight", True),
          "w_down": ("mlp.down_proj.weight", True),
          "gate": ("block_sparse_moe.gate.weight", True)}
_EXPERT = {"w_gate": "w1", "w_up": "w3", "w_down": "w2"}
_TOP = {"embed": ("model.embed_tokens.weight", False),
        "norm_f": ("model.norm.weight", False),
        "lm_head": ("lm_head.weight", True)}


def _hf_layout(params: dict) -> dict[str, np.ndarray]:
    """Flat params → HF tensors (Mixtral's experts one tensor each)."""
    out = {}
    for name, v in params.items():
        a = np.asarray(v)
        if name in _TOP:
            hf, tr = _TOP[name]
            out[hf] = a.T if tr else a
            continue
        layer, _, kind = name.partition(".")
        pre = f"model.layers.{layer[1:]}."
        if a.ndim == 3:  # [E, in, out] expert stacks
            for e in range(a.shape[0]):
                out[f"{pre}block_sparse_moe.experts.{e}."
                    f"{_EXPERT[kind]}.weight"] = a[e].T
            continue
        hf, tr = _LAYER[kind]
        out[pre + hf] = a.T if tr else a
    return {k: np.ascontiguousarray(v) for k, v in out.items()}


def _reference_params(model: str):
    init, cfg = MODELS[model]
    p = {k: np.asarray(v) for k, v in init(jax.random.PRNGKey(3), cfg,
                                           jnp.float32).items()}
    rng = np.random.default_rng(5)
    for k in p:  # the reference draws zero biases and unit norms: vary
        if k.split(".")[-1] in ("bq", "bk", "bv", "attn_norm", "mlp_norm",
                                "norm_f"):
            p[k] = rng.normal(1.0, 0.1, p[k].shape).astype(np.float32)
    return p


def _write_shards(tmp, model: str, file_dtype) -> str:
    hf = _hf_layout(_reference_params(model))
    hf = {k: v.astype(file_dtype) for k, v in hf.items()}
    hf["model.layers.0.self_attn.rotary_emb.inv_freq"] = np.ones(
        8, np.float32)  # unmapped
    names = sorted(hf)
    half = len(names) // 2
    d = tmp / f"hf-{model}"
    d.mkdir()
    save_file({k: hf[k] for k in names[:half]},
              str(d / "model-00001-of-00002.safetensors"))
    save_file({k: hf[k] for k in names[half:]},
              str(d / "model-00002-of-00002.safetensors"),
              metadata={"format": "pt"})
    return str(d)


def _bits(a) -> np.ndarray:
    """Any bf16 array (jax, torch) → its uint16 bit patterns."""
    if isinstance(a, torch.Tensor):
        assert a.dtype == torch.bfloat16, a.dtype
        return a.view(torch.int16).numpy().view(np.uint16)
    a = np.asarray(a)
    assert a.dtype == ml_dtypes.bfloat16, a.dtype
    return a.view(np.uint16)


def _assert_same(got: dict, want: dict) -> None:
    assert set(got) == set(want), sorted(set(got) ^ set(want))
    for k in want:
        assert tuple(got[k].shape) == tuple(np.shape(want[k])), k
        np.testing.assert_array_equal(_bits(got[k]), _bits(want[k]),
                                      err_msg=k)


# -- the safetensors reader and writer ----------------------------------------
def test_safetensors_reader_reads_every_dtype(tmp_path):
    rng = np.random.default_rng(0)
    arrays = {
        "bf16": rng.normal(size=(3, 5)).astype(ml_dtypes.bfloat16),
        "f16": rng.normal(size=(4,)).astype(np.float16),
        "f32": rng.normal(size=(2, 3, 4)).astype(np.float32),
        "f64": rng.normal(size=(2,)).astype(np.float64),
        "i8": rng.integers(-128, 127, (7,)).astype(np.int8),
        "u8": rng.integers(0, 255, (3, 3)).astype(np.uint8),
        "i32": rng.integers(-9, 9, (5,)).astype(np.int32),
        "i64": rng.integers(-9, 9, (2, 2)).astype(np.int64),
        "bool": rng.random((6,)) > 0.5,
        "empty": np.zeros((0, 4), np.float32),
        "scalar": np.array(2.5, np.float32),
    }
    path = str(tmp_path / "x.safetensors")
    save_file(arrays, path, metadata={"format": "np"})
    got = {k: v.clone() for k, v in tckpt.iter_safetensors(path)}
    assert list(got) == sorted(arrays)
    for k, a in arrays.items():
        g = got[k]
        assert tuple(g.shape) == a.shape, k
        if a.dtype == ml_dtypes.bfloat16:
            np.testing.assert_array_equal(_bits(g), a.view(np.uint16))
        else:
            np.testing.assert_array_equal(g.numpy(), a, err_msg=k)
    # the writer: safetensors reads what it wrote, bytes and all
    back = str(tmp_path / "y.safetensors")
    n = tckpt.save_safetensors(got, back)
    assert n == (tmp_path / "y.safetensors").stat().st_size
    loaded = load_file(back)
    for k, a in arrays.items():
        assert loaded[k].dtype == a.dtype and loaded[k].shape == a.shape
        assert loaded[k].tobytes() == a.tobytes(), k


# -- import_hf_checkpoint -----------------------------------------------------
@pytest.mark.parametrize("file_dtype", [ml_dtypes.bfloat16, np.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("model", sorted(MODELS))
def test_import_matches_reference(tmp_path, caplog, model, file_dtype):
    d = _write_shards(tmp_path, model, file_dtype)
    want = jckpt.import_hf_checkpoint(d)
    with caplog.at_level(logging.WARNING,
                         logger="aigw_tpu_torch.models.checkpoint"):
        got = tckpt.import_hf_checkpoint(d, device="cpu")
    _assert_same(got, want)
    assert any("rotary_emb.inv_freq" in r.getMessage()
               for r in caplog.records)
    if model == "tiny-moe":
        cfg = MODELS[model][1]
        assert got["l0.w_gate"].shape == (cfg.n_experts, cfg.dim,
                                          cfg.ffn_dim)
    if model == "tiny-qwen":
        assert "lm_head" not in got and "l1.bv" in got


def test_import_of_an_empty_directory_raises_as_reference(tmp_path):
    with pytest.raises(FileNotFoundError) as want:
        jckpt.import_hf_checkpoint(str(tmp_path))
    with pytest.raises(FileNotFoundError) as got:
        tckpt.import_hf_checkpoint(str(tmp_path), device="cpu")
    assert str(got.value) == str(want.value)


def test_import_refuses_cuda_without_it(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    d = _write_shards(tmp_path, "tiny-random", np.float32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tckpt.import_hf_checkpoint(d)


# -- orbax directories, both ways ---------------------------------------------
def _bf16_params(model: str) -> dict:
    return {k: jnp.asarray(v).astype(jnp.bfloat16)
            for k, v in _reference_params(model).items()}


def _family_like(model: str) -> dict:
    spec = tregistry.get_model_spec(model)
    return tckpt.param_like(tregistry.family_fns(spec.family).iter_params,
                            spec.config, torch.bfloat16)


@pytest.mark.parametrize("model", sorted(MODELS))
def test_reference_directory_read_by_port(tmp_path, model):
    want = _bf16_params(model)
    jckpt.save_checkpoint(want, str(tmp_path / "ck"))
    _assert_same(tckpt.restore_checkpoint(str(tmp_path / "ck"),
                                          device="cpu"), want)
    _assert_same(tckpt.restore_checkpoint(
        str(tmp_path / "ck"), _family_like(model), device="cpu"), want)


@pytest.mark.parametrize("like", [False, True], ids=["plain", "like"])
@pytest.mark.parametrize("model", sorted(MODELS))
def test_port_directory_read_by_reference(tmp_path, model, like):
    want = _bf16_params(model)
    port = {k: torch.from_numpy(np.asarray(v).view(np.int16).copy()).view(
        torch.bfloat16) for k, v in want.items()}
    tckpt.save_checkpoint(port, str(tmp_path / "ck"))
    shapes = jax.tree.map(
        lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), want)
    got = jckpt.restore_checkpoint(str(tmp_path / "ck"),
                                   shapes if like else None)
    _assert_same({k: torch.from_numpy(np.asarray(v).view(np.int16).copy())
                  .view(torch.bfloat16) for k, v in got.items()}, want)
    with pytest.raises(FileExistsError):
        tckpt.save_checkpoint(port, str(tmp_path / "ck"))


def test_port_directory_keeps_other_dtypes(tmp_path):
    """int8 / float32 / int32 leaves (a quantized adapter store's kinds)
    round-trip through both packages."""
    rng = np.random.default_rng(1)
    want = {"a.q": rng.integers(-127, 127, (4, 6)).astype(np.int8),
            "a.scale": rng.random((6,)).astype(np.float32),
            "ids": np.arange(5, dtype=np.int32)}
    tckpt.save_checkpoint({k: torch.from_numpy(v) for k, v in want.items()},
                          str(tmp_path / "ck"))
    ref = jckpt.restore_checkpoint(str(tmp_path / "ck"))
    got = tckpt.restore_checkpoint(str(tmp_path / "ck"), device="cpu")
    for k, v in want.items():
        np.testing.assert_array_equal(np.asarray(ref[k]), v)
        np.testing.assert_array_equal(got[k].numpy(), v)


def test_restore_holds_the_like(tmp_path):
    want = _bf16_params("tiny-random")
    jckpt.save_checkpoint(want, str(tmp_path / "ck"))
    like = _family_like("tiny-random")
    bad_shape = dict(like, **{"l0.wq": tckpt.Like((3, 3), torch.bfloat16)})
    with pytest.raises(ValueError, match="l0.wq"):
        tckpt.restore_checkpoint(str(tmp_path / "ck"), bad_shape, "cpu")
    bad_dtype = dict(like, **{"l0.wq": tckpt.Like(
        like["l0.wq"].shape, torch.float32)})
    with pytest.raises(ValueError, match="float32"):
        tckpt.restore_checkpoint(str(tmp_path / "ck"), bad_dtype, "cpu")
    missing = dict(like, extra=tckpt.Like((1,), torch.bfloat16))
    with pytest.raises(ValueError, match="extra"):
        tckpt.restore_checkpoint(str(tmp_path / "ck"), missing, "cpu")
    # the qwen row's tensors (biases, no lm_head) are not tiny-random's
    with pytest.raises(ValueError, match="missing"):
        tckpt.restore_checkpoint(str(tmp_path / "ck"),
                                 _family_like("tiny-qwen"), "cpu")


# -- the CLI ------------------------------------------------------------------
def test_convert_cli_matches_reference(tmp_path, capsys):
    from aigw_tpu_torch.cli import main

    d = _write_shards(tmp_path, "tiny-moe", np.float32)
    out = str(tmp_path / "orbax")
    assert main(["convert", d, out]) == 0
    want = jckpt.import_hf_checkpoint(d)
    assert capsys.readouterr().out.strip() == (
        f"converted {len(want)} tensors -> {out}")
    _assert_same(tckpt.restore_checkpoint(out, device="cpu"), want)
    _assert_same({k: torch.from_numpy(np.asarray(v).view(np.int16).copy())
                  .view(torch.bfloat16)
                  for k, v in jckpt.restore_checkpoint(out).items()}, want)


def _http(port, path, body=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=None if body is None else json.dumps(body).encode(),
        headers={"content-type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.status, json.loads(r.read())


def test_lora_cli_serves_an_orbax_adapter(tmp_path):
    """``--lora fr=DIR`` restores the reference's adapter directory, and
    a replica serving it answers ``tiny-random:fr`` as a replica handed
    the same tensors in memory."""
    from aigw_tpu_torch.cli import build_parser, lora_adapters
    from aigw_tpu_torch.tpuserve.server import TPUServeServer

    stacks = jlora.init_lora_adapters(
        jax.random.PRNGKey(7), jllama.TINY, jlora.LoRAConfig(rank=4), 1,
        jnp.float32, random_b=True)
    one = {k: v[0] for k, v in stacks.items()}
    jckpt.save_checkpoint(one, str(tmp_path / "fr"))
    args = build_parser().parse_args(
        ["tpuserve", "--model", "tiny-random", "--device", "cpu",
         "--lora", f"fr={tmp_path / 'fr'}", "--lora-slots", "1"])
    zoo = lora_adapters(args.lora)
    assert list(zoo) == ["fr"]
    for k, v in one.items():
        np.testing.assert_array_equal(zoo["fr"][k].numpy(), np.asarray(v))
    body = {"model": "tiny-random:fr", "prompt": "bonjour",
            "max_tokens": 8, "temperature": 0.0}
    texts = []
    for adapters in (zoo, {"fr": {k: torch.from_numpy(np.array(v))
                                  for k, v in one.items()}}):
        srv = TPUServeServer("tiny-random", tengine.EngineConfig(
            max_seq_len=128, page_size=16), device="cpu", port=0,
            lora_adapters=adapters, lora_slots=args.lora_slots)
        srv.start()
        try:
            status, reply = _http(srv.port, "/v1/completions", body)
            assert status == 200
            texts.append(reply["choices"][0]["text"])
            models = _http(srv.port, "/v1/models")[1]
            assert "tiny-random:fr" in [m["id"] for m in models["data"]]
        finally:
            srv.stop()
    assert texts[0] == texts[1]


# -- a replica on an orbax: row -----------------------------------------------
SERVER_CFG = dict(max_batch_size=4, max_seq_len=256, page_size=16,
                  decode_steps_per_tick=4, kv_cache_dtype="float32",
                  attention_backend="pallas-ragged", decode_backend="fused")
BODIES = [
    ("/v1/chat/completions", {"messages": [
        {"role": "user", "content": "tell me about the sea"}],
        "max_tokens": 12, "temperature": 0.0}),
    ("/v1/completions", {"prompt": "once upon a time", "max_tokens": 12,
                         "temperature": 0.9, "seed": 17}),
    ("/v1/completions", {"prompt": "0123456789", "max_tokens": 10,
                         "temperature": 0.0}),
]


def _drive(port: int, model: str) -> list:
    out = []
    for path, body in BODIES:
        status, reply = _http(port, path, {"model": model, **body})
        assert status == 200, reply
        c = reply["choices"][0]
        out.append((c.get("text") or c["message"]["content"],
                    reply["usage"]["completion_tokens"]))
    return out


def _register_row(name: str, weights: str) -> None:
    jregistry.register_model(jregistry.ModelSpec(
        name, "llama", jllama.TINY, weights=weights))
    tregistry.register_model(tregistry.ModelSpec(
        name, "llama", tllama.TINY, weights=weights))


def _reference_replica(model: str, weights: str, quantize: str) -> list:
    """The reference server on the row ``model`` (registered here: this
    runs in a subprocess), driven with BODIES."""
    from aiohttp import web

    from aigw_tpu.tpuserve import server as jserver

    _register_row(model, weights)
    holder = {}
    started = threading.Event()

    def run():
        async def main():
            server = jserver.TPUServeServer(
                model, jengine.EngineConfig(**SERVER_CFG),
                quantize=quantize)
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
        return _drive(holder["port"], model)
    finally:
        holder["loop"].call_soon_threadsafe(holder["stop"].set)
        t.join(timeout=60)


@pytest.fixture(scope="module")
def orbax_row(tmp_path_factory):
    """A tiny-random row whose weights are an orbax directory the
    reference wrote (bf16), registered in both packages."""
    d = str(tmp_path_factory.mktemp("orbax") / "tiny")
    jckpt.save_checkpoint(jllama.init_params(jax.random.PRNGKey(0),
                                             jllama.TINY), d)
    name = "tiny-random-orbax"
    _register_row(name, f"orbax:{d}")
    return name, f"orbax:{d}"


QUANTIZE = ["", "int8"]


@pytest.fixture(scope="module")
def reference_replies(orbax_row):
    """The reference replica on the row, once per quantization, in one
    subprocess: the forward pass carries bf16 values, which the
    reference's jitted programs round as its source says only with XLA's
    ``--xla_allow_excess_precision`` off (``test_torch_engine.py``'s
    quantized case)."""
    name, weights = orbax_row
    code = (
        "import json, sys\n"
        f"sys.path.insert(0, {os.path.dirname(__file__)!r})\n"
        "import jax\n"
        "jax.config.update('jax_platforms', 'cpu')\n"
        "import test_torch_checkpoint as tc\n"
        f"print(json.dumps([tc._reference_replica({name!r}, {weights!r}, "
        f"q) for q in {QUANTIZE!r}]))\n")
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_allow_excess_precision=false"}
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    runs = json.loads(proc.stdout.strip().splitlines()[-1])
    return {q: [tuple(r) for r in run] for q, run in zip(QUANTIZE, runs)}


@pytest.mark.parametrize("quantize", QUANTIZE, ids=["bf16", "int8"])
def test_orbax_replica_matches_reference(orbax_row, reference_replies,
                                         quantize):
    """The reference replica restores the row's directory (its weights
    bf16, as ``_load_params`` asks for them), the port's too; both
    quantize tensor by tensor for ``int8``: the same replies."""
    from aigw_tpu_torch.tpuserve.server import TPUServeServer

    name, _weights = orbax_row
    srv = TPUServeServer(name, tengine.EngineConfig(**SERVER_CFG),
                         device="cpu", port=0, quantize=quantize)
    expect = {"": "l0.wq", "int8": "l0.wq.q"}[quantize]
    assert expect in srv.engine.params
    srv.start()
    try:
        got = _drive(srv.port, name)
    finally:
        srv.stop()
    assert got == reference_replies[quantize]


# -- refusals -----------------------------------------------------------------
@pytest.mark.parametrize("weights", ["hf:/models/llama", "s3://bucket/x"])
def test_other_weight_sources_raise_as_reference(weights):
    from aigw_tpu.tpuserve import server as jserver
    from aigw_tpu_torch.tpuserve.server import TPUServeServer

    name = f"tiny-random-{weights.split(':')[0]}"
    _register_row(name, weights)
    with pytest.raises(ValueError) as want:
        jserver.TPUServeServer(name, jengine.EngineConfig(
            max_seq_len=128, page_size=16))
    with pytest.raises(ValueError) as got:
        TPUServeServer(name, tengine.EngineConfig(max_seq_len=128,
                                                  page_size=16),
                       device="cpu", port=0)
    assert str(got.value) == str(want.value) == (
        f"unsupported weight source {weights}")


def test_missing_tensorstore_raises_naming_it(tmp_path, monkeypatch,
                                              orbax_row):
    from aigw_tpu_torch.cli import lora_adapters, main
    from aigw_tpu_torch.tpuserve.server import TPUServeServer

    d = _write_shards(tmp_path, "tiny-random", np.float32)
    monkeypatch.setitem(sys.modules, "tensorstore", None)
    calls = [
        lambda: tckpt.restore_checkpoint(str(tmp_path), device="cpu"),
        lambda: tckpt.save_checkpoint({}, str(tmp_path / "out")),
        lambda: lora_adapters([f"fr={tmp_path}"]),
        lambda: main(["convert", d, str(tmp_path / "conv")]),
        lambda: TPUServeServer(orbax_row[0], tengine.EngineConfig(
            max_seq_len=128, page_size=16), device="cpu", port=0),
    ]
    for call in calls:
        with pytest.raises(ImportError, match="tensorstore"):
            call()
    # the safetensors half needs none of it
    assert "embed" in tckpt.import_hf_checkpoint(d, device="cpu")

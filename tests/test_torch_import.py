"""Import discipline of the port: ``aigw_tpu_torch`` and ``chip_smoke.py``
import ``torch`` and never ``jax`` or anything of ``aigw_tpu``; every
entry point takes an explicit device and refuses CUDA when there is
none."""

import ast
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "aigw_tpu_torch"
PORT_FILES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
MODULES = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts)
    for p in PKG.rglob("*.py") if p.name != "__main__.py")


def _imported_names(path: pathlib.Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            names.append(node.module)
    return names


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_no_jax_or_reference_imports(path):
    bad = [n for n in _imported_names(path)
           if n == "jax" or n.startswith(("jax.", "jaxlib"))
           or n == "aigw_tpu" or n.startswith("aigw_tpu.")]
    assert not bad, f"{path.name} imports {bad}"


def test_every_module_imports_with_jax_blocked():
    """In a fresh interpreter where importing jax (or the reference
    package) fails, every module of the port imports."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['aigw_tpu'] = None\n"
        "import importlib\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "assert 'jax' not in [k for k, v in sys.modules.items() if v]\n"
        "print('ok', len(sys.argv))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


def test_quantized_serving_modules_are_covered():
    """The quantized-serving modules and K6's source are in the scans
    above, and importing a kernel module builds nothing."""
    for m in ("aigw_tpu_torch.models.quant", "aigw_tpu_torch.models.kvq",
              "aigw_tpu_torch.ops.qmatmul", "aigw_tpu_torch.ops.decode_fused"):
        assert m in MODULES, m
    assert (PKG / "csrc" / "qmatmul.cu").exists()
    from aigw_tpu_torch.ops import _build, qmatmul

    assert "aigw_w8a16_matmul" in _build.SIGNATURES
    assert isinstance(qmatmul.w8a16_matmul.launches, int)
    if not torch.cuda.is_available():
        assert _build.library.cache_info().currsize == 0  # nothing built


def test_speculation_modules_are_covered():
    """The speculation module is in the scans above, and K4's and K5's
    entry points are bound and counted without building anything (K4
    launches K3's body, ``aigw_paged_decode``)."""
    assert "aigw_tpu_torch.tpuserve.speculation" in MODULES
    from aigw_tpu_torch.ops import _build, paged_attention

    assert "aigw_paged_decode_split" not in _build.SIGNATURES
    for name in ("aigw_paged_verify", "aigw_paged_decode"):
        assert name in _build.SIGNATURES, name
    for fn in (paged_attention.paged_attention_verify,
               paged_attention.paged_attention_decode):
        assert isinstance(fn.launches, int)
    if not torch.cuda.is_available():
        assert _build.library.cache_info().currsize == 0  # nothing built


def test_constraint_modules_are_covered():
    """The grammar-constrained decoding modules are in the scans above:
    the port's own copies, never the reference's JAX-free modules."""
    for m in ("aigw_tpu_torch.tpuserve.constrain",
              "aigw_tpu_torch.translate.structured"):
        assert m in MODULES, m
    names = _imported_names(PKG / "tpuserve" / "constrain.py")
    assert "aigw_tpu_torch.translate.structured" in names


def test_moe_modules_are_covered():
    """The mixtral family is in the scans above: the port's own module
    over the port's llama skeleton, never the reference's."""
    assert "aigw_tpu_torch.models.mixtral" in MODULES
    names = _imported_names(PKG / "models" / "mixtral.py")
    assert "aigw_tpu_torch.models" in names
    assert "aigw_tpu_torch.models.llama" in names
    from aigw_tpu_torch.models.registry import family_fns

    assert family_fns("mixtral").moe_stats


def test_lora_modules_are_covered():
    """The multi-LoRA modules are in the scans above, the port's own
    copies; the adapter math is plain PyTorch, and its store and the
    engine default to CUDA."""
    import inspect

    for m in ("aigw_tpu_torch.models.lora",
              "aigw_tpu_torch.tpuserve.adapters"):
        assert m in MODULES, m
    names = _imported_names(PKG / "tpuserve" / "adapters.py")
    assert "aigw_tpu_torch.models.lora" in names
    assert "aigw_tpu_torch.ops" not in str(
        _imported_names(PKG / "models" / "lora.py"))
    from aigw_tpu_torch.tpuserve.adapters import AdapterStore

    sig = inspect.signature(AdapterStore.__init__)
    assert sig.parameters["device"].default == "cuda"


def test_request_surface_names_import_with_jax_blocked():
    """The request surface's names (the logprobs intake, the n fan-out,
    the fairness guard, the histogram's cumulative buckets) import in a
    fresh interpreter where jax and the reference package cannot, and
    pull in nothing of either."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['aigw_tpu'] = None\n"
        "from aigw_tpu_torch.tpuserve.server import TPUServeServer\n"
        "from aigw_tpu_torch.tpuserve.engine import Engine\n"
        "from aigw_tpu_torch.obs.metrics import PhaseHistogram\n"
        "from aigw_tpu_torch.tpuserve.sampling import token_logprobs\n"
        "for fn in (TPUServeServer.check_logprobs, TPUServeServer.submit_n,\n"
        "           Engine._fair_admission, PhaseHistogram.cumulative,\n"
        "           token_logprobs):\n"
        "    assert callable(fn)\n"
        "bad = [k for k, v in sys.modules.items() if v and (\n"
        "    k.split('.')[0] in ('jax', 'jaxlib', 'aigw_tpu'))]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_ops_surface_modules_import_with_jax_blocked():
    """The operations surface's modules (the flight recorder, tracing and
    its OTLP encoder, the metrics) are the port's own copies: in the
    scans above, standard library only apart from the port, and
    importable in a fresh interpreter where jax and the reference
    package cannot be imported, pulling in nothing of either."""
    import sys as _sys

    for m in ("aigw_tpu_torch.obs.flight", "aigw_tpu_torch.obs.tracing",
              "aigw_tpu_torch.obs.otlp_proto", "aigw_tpu_torch.obs.metrics"):
        assert m in MODULES, m
        path = ROOT / (m.replace(".", "/") + ".py")
        outside = [n for n in _imported_names(path)
                   if n.split(".")[0] not in _sys.stdlib_module_names
                   and not n.startswith("aigw_tpu_torch")]
        assert not outside, (m, outside)
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['aigw_tpu'] = None\n"
        "from aigw_tpu_torch.obs.flight import FlightRecorder, RequestTrace\n"
        "from aigw_tpu_torch.obs.tracing import Tracer, Propagators\n"
        "from aigw_tpu_torch.obs.otlp_proto import encode_traces\n"
        "from aigw_tpu_torch.obs.metrics import metric_families\n"
        "from aigw_tpu_torch.schemas.openai import meter_to_tuple\n"
        "from aigw_tpu_torch.tpuserve.server import TPUServeServer\n"
        "for fn in (FlightRecorder.snapshot, RequestTrace.prefill,\n"
        "           Tracer.start_span, Propagators.extract, encode_traces,\n"
        "           meter_to_tuple, TPUServeServer.drain,\n"
        "           TPUServeServer.profile, TPUServeServer.metrics):\n"
        "    assert callable(fn)\n"
        "assert len(metric_families()) == 116\n"
        "bad = [k for k, v in sys.modules.items() if v and (\n"
        "    k.split('.')[0] in ('jax', 'jaxlib', 'aigw_tpu',\n"
        "                        'prometheus_client', 'grpc'))]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_kv_mobility_modules_import_with_jax_and_ml_dtypes_blocked():
    """The KV-mobility names (the spill tier, the host pages, the wire
    codec, continuation_request) are the port's own: the spill tier
    is standard library apart from the port, and they import in a fresh
    interpreter where jax, the reference package and ``ml_dtypes`` (the
    reference's int4 host dtype, which the card may lack) cannot be
    imported, pulling in none of them."""
    import sys as _sys

    assert "aigw_tpu_torch.tpuserve.kvhost" in MODULES
    outside = [n for n in _imported_names(PKG / "tpuserve" / "kvhost.py")
               if n.split(".")[0] not in _sys.stdlib_module_names
               and not n.startswith("aigw_tpu_torch")]
    assert not outside, outside
    code = (
        "import sys\n"
        "for m in ('jax', 'aigw_tpu', 'ml_dtypes'):\n"
        "    sys.modules[m] = None\n"
        "from aigw_tpu_torch.tpuserve.kvhost import HostKVTier\n"
        "from aigw_tpu_torch.models.kvq import (page_nbytes,\n"
        "    page_shape_ok, page_matches_dtype, pages_to_host)\n"
        "from aigw_tpu_torch.tpuserve.engine import (MigrationError,\n"
        "    continuation_request)\n"
        "from aigw_tpu_torch.tpuserve.server import (encode_wire_page,\n"
        "    decode_wire_page)\n"
        "import numpy as np\n"
        "t = HostKVTier(64)\n"
        "q = np.array([9, 15, 0, 1, 7], np.uint8)\n"
        "page = {'q': q, 'scale': np.ones(1, np.float32), 'dtype': 'int4'}\n"
        "assert t.put(b'k', page) and t.bytes_used == 2 + 4\n"
        "back = decode_wire_page(encode_wire_page(page))\n"
        "assert back['q'].tolist() == q.tolist()\n"
        "bad = [k for k, v in sys.modules.items() if v and (\n"
        "    k.split('.')[0] in ('jax', 'jaxlib', 'aigw_tpu', 'ml_dtypes'))]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_default_programs_and_embeddings_import_with_jax_blocked():
    """The default programs' names (the bucketed prefill, the suffix
    prefill, the embeddings pass for both families, the backend contract
    and the bucketed backend, the bucket ladder and the page bucket, the
    embeddings route, its sub-batch size and its body) are the port's
    own: they import in a fresh interpreter where jax and the reference
    package cannot, pull in nothing of either, and the route's server
    and the engine default to CUDA."""
    code = (
        "import sys, inspect\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['aigw_tpu'] = None\n"
        "from aigw_tpu_torch.models import llama, mixtral\n"
        "from aigw_tpu_torch.models.registry import family_fns\n"
        "from aigw_tpu_torch.tpuserve.attention import (AttentionBackend,\n"
        "    XlaBucketedBackend, RaggedPrefillBackend)\n"
        "from aigw_tpu_torch.tpuserve.engine import Engine\n"
        "from aigw_tpu_torch.tpuserve.server import TPUServeServer\n"
        "from aigw_tpu_torch.schemas.openai import embeddings_response\n"
        "for fam, mod in (('llama', llama), ('mixtral', mixtral)):\n"
        "    fns = family_fns(fam)\n"
        "    assert (fns.prefill, fns.prefill_suffix, fns.hidden_states) \\\n"
        "        == (mod.prefill, mod.prefill_suffix, mod.hidden_states)\n"
        "assert issubclass(XlaBucketedBackend, AttentionBackend)\n"
        "assert RaggedPrefillBackend.packs_long_prompts\n"
        "assert not XlaBucketedBackend.packs_long_prompts\n"
        "for fn in (Engine._prefill_bucket, Engine._pow2_pages,\n"
        "           TPUServeServer.embeddings, TPUServeServer.embed_rows,\n"
        "           embeddings_response):\n"
        "    assert callable(fn)\n"
        "for fn in (Engine.__init__, TPUServeServer.__init__):\n"
        "    assert inspect.signature(fn).parameters['device'].default \\\n"
        "        == 'cuda'\n"
        "bad = [k for k, v in sys.modules.items() if v and (\n"
        "    k.split('.')[0] in ('jax', 'jaxlib', 'aigw_tpu'))]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_cuda_request_without_cuda_raises():
    from aigw_tpu_torch.device import resolve_device

    assert resolve_device("cpu").type == "cpu"
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device(None)  # the default is CUDA, never a quiet CPU


def test_engine_and_server_default_to_cuda():
    import inspect

    from aigw_tpu_torch.tpuserve.engine import Engine
    from aigw_tpu_torch.tpuserve.server import TPUServeServer

    for fn in (Engine.__init__, TPUServeServer.__init__):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        from aigw_tpu_torch.tpuserve.engine import EngineConfig

        with pytest.raises(RuntimeError, match="CUDA is not available"):
            TPUServeServer("tiny-random", EngineConfig())


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """chip_smoke.py exits non-zero and prints no result without a card,
    and alone in an empty directory."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    proc = subprocess.run([sys.executable, str(alone)], cwd=tmp_path,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout

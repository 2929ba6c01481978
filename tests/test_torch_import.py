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
                   and not n.startswith("aigw_tpu_torch")
                   # obs/tracing.py: lazily, for the OTLP gRPC export
                   and not (m.endswith(".tracing") and n == "grpc")]
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
        "assert len(metric_families()) == 122\n"
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


def test_checkpoint_module_imports_with_its_packages_blocked():
    """``models/checkpoint.py`` imports, and reads safetensors shards,
    in a fresh interpreter where jax, the reference package,
    ``ml_dtypes``, ``tensorstore`` and ``safetensors`` cannot be
    imported (the card machine has none of the last three); its orbax
    paths then raise naming tensorstore."""
    assert "aigw_tpu_torch.models.checkpoint" in MODULES
    code = (
        "import sys, tempfile, os\n"
        "for m in ('jax', 'aigw_tpu', 'ml_dtypes', 'tensorstore',\n"
        "          'safetensors'):\n"
        "    sys.modules[m] = None\n"
        "import torch\n"
        "from aigw_tpu_torch.models import checkpoint\n"
        "from aigw_tpu_torch import cli\n"
        "d = tempfile.mkdtemp()\n"
        "w = torch.arange(6, dtype=torch.float32).reshape(2, 3)\n"
        "checkpoint.save_safetensors({'model.layers.0.self_attn.q_proj."
        "weight': w.to(torch.bfloat16)}, os.path.join(d, 'x.safetensors'))\n"
        "p = checkpoint.import_hf_checkpoint(d, device='cpu')\n"
        "assert torch.equal(p['l0.wq'].float(), w.T)\n"
        "calls = (lambda: checkpoint.restore_checkpoint(d, device='cpu'),\n"
        "         lambda: cli.lora_adapters(['a=' + d]))\n"
        "for call in calls:\n"
        "    try:\n"
        "        call()\n"
        "    except ImportError as e:\n"
        "        assert 'tensorstore' in str(e), e\n"
        "    else:\n"
        "        raise AssertionError('no ImportError')\n"
        "bad = [k for k, v in sys.modules.items() if v and k.split('.')[0]\n"
        "       in ('jax', 'jaxlib', 'aigw_tpu', 'ml_dtypes', 'tensorstore',\n"
        "           'safetensors')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_parallel_modules_are_covered():
    """The mesh, sharding and pipeline modules and the follower loop are
    in the scans above, the port's own copies; importing them starts no
    process group and no process, and the mesh defaults to CUDA."""
    import inspect

    for m in ("aigw_tpu_torch.parallel.__init__",
              "aigw_tpu_torch.parallel.mesh",
              "aigw_tpu_torch.parallel.sharding",
              "aigw_tpu_torch.parallel.pipeline",
              "aigw_tpu_torch.tpuserve.follower"):
        assert m in MODULES, m
    import multiprocessing

    import torch.distributed as dist

    from aigw_tpu_torch.parallel import make_mesh
    from aigw_tpu_torch.tpuserve import follower

    assert not dist.is_initialized()
    assert not multiprocessing.active_children()
    assert inspect.signature(make_mesh).parameters["device"].default \
        == "cuda"
    assert inspect.signature(
        follower.start_replica_mesh).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        from aigw_tpu_torch.parallel import MeshSpec

        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make_mesh(MeshSpec(tp=1), rank=0, world_size=1,
                      init_method="file:///nonexistent/rdv")


def test_gateway_modules_import_with_aiohttp_and_yaml_blocked():
    """The gateway's modules (config, gateway, translate, obs, schemas)
    are the port's own copies on the standard library: every one imports
    in a fresh interpreter where jax, the reference package, aiohttp and
    yaml cannot be imported, and pulls in none of them (nor
    prometheus_client); the gateway and its CLI entry are callable."""
    mods = [m for m in MODULES if m.split(".")[1] in (
        "gateway", "config", "translate", "obs", "schemas")]
    for m in ("aigw_tpu_torch.gateway.server", "aigw_tpu_torch.gateway.http",
              "aigw_tpu_torch.gateway.picker", "aigw_tpu_torch.gateway.router",
              "aigw_tpu_torch.gateway.circuit", "aigw_tpu_torch.gateway.costs",
              "aigw_tpu_torch.gateway.usage", "aigw_tpu_torch.gateway.kvindex",
              "aigw_tpu_torch.gateway.fleetstate",
              "aigw_tpu_torch.gateway.mutators",
              "aigw_tpu_torch.config.model", "aigw_tpu_torch.config.runtime",
              "aigw_tpu_torch.config.watcher",
              "aigw_tpu_torch.translate.base",
              "aigw_tpu_torch.translate.passthrough",
              "aigw_tpu_torch.translate.sse", "aigw_tpu_torch.obs.slomon",
              "aigw_tpu_torch.schemas.spec", "aigw_tpu_torch.schemas.typed",
              "aigw_tpu_torch.schemas.typed_response"):
        assert m in mods, m
    import sys as _sys

    for m in mods:
        path = ROOT / (m.replace(".", "/") + ".py")
        outside = [n for n in _imported_names(path)
                   if n.split(".")[0] not in _sys.stdlib_module_names
                   and not n.startswith("aigw_tpu_torch")
                   and n != "yaml"  # config/model.py: lazily, for YAML
                   # obs/tracing.py: lazily, for the OTLP gRPC export
                   and not (m.endswith(".tracing") and n == "grpc")]
        assert not outside, (m, outside)
    code = (
        "import sys, importlib\n"
        "for m in ('jax', 'aigw_tpu', 'aiohttp', 'yaml'):\n"
        "    sys.modules[m] = None\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "from aigw_tpu_torch.gateway.server import GatewayServer, run_gateway\n"
        "from aigw_tpu_torch.cli import build_parser, run_gateway_cli\n"
        "assert build_parser().parse_args(['run', 'c.json']).port == 1975\n"
        "for fn in (GatewayServer._handle, run_gateway, run_gateway_cli):\n"
        "    assert callable(fn)\n"
        "bad = [k for k, v in sys.modules.items() if v and k.split('.')[0]\n"
        "       in ('jax', 'jaxlib', 'aigw_tpu', 'aiohttp', 'yaml',\n"
        "           'prometheus_client', 'torch', 'grpc')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_fleet_modules_import_with_aiohttp_and_yaml_blocked():
    """The fleet operations (the controller and its launcher, the rate
    limiter and the quota service, the launcher's child) import in a
    fresh interpreter where jax, the reference package, aiohttp and yaml
    cannot be imported; none of them, nor torch, is pulled in by the
    imports (the child imports torch only when it builds its replica);
    the CLI parses ``quota-service``."""
    mods = ["aigw_tpu_torch.gateway.controller",
            "aigw_tpu_torch.gateway.ratelimit",
            "aigw_tpu_torch.tpuserve.child"]
    for m in mods:
        assert m in MODULES, m
    code = (
        "import sys, importlib\n"
        "for m in ('jax', 'aigw_tpu', 'aiohttp', 'yaml'):\n"
        "    sys.modules[m] = None\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "from aigw_tpu_torch.gateway.controller import (\n"
        "    FleetController, LocalProcessLauncher, build_launcher)\n"
        "from aigw_tpu_torch.gateway.ratelimit import (\n"
        "    RateLimiter, quota_service)\n"
        "from aigw_tpu_torch.tpuserve.child import main\n"
        "from aigw_tpu_torch.cli import build_parser\n"
        "a = build_parser().parse_args(['quota-service', '--dir', 'q'])\n"
        "assert (a.cmd, a.port, a.dir) == ('quota-service', 1981, 'q')\n"
        "l = build_launcher({'kind': 'local', 'spec': {'model': 'm'}})\n"
        "assert l.command()[1:3] == ['-m', 'aigw_tpu_torch.tpuserve.child']\n"
        "assert callable(quota_service) and callable(main)\n"
        "bad = [k for k, v in sys.modules.items() if v and k.split('.')[0]\n"
        "       in ('jax', 'jaxlib', 'aigw_tpu', 'aiohttp', 'yaml',\n"
        "           'prometheus_client', 'torch')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_front_modules_import_with_aiohttp_and_yaml_blocked():
    """The client fronts (the Anthropic and Responses translators, the
    rerank passthrough, the multipart helpers, the Anthropic schema)
    import in a fresh interpreter where jax, the reference package,
    aiohttp and yaml cannot be imported, and pull in none of them nor
    torch; the translator registry then holds the Anthropic front to
    port replicas and the Responses front's chat mapping."""
    mods = ["aigw_tpu_torch.schemas.anthropic",
            "aigw_tpu_torch.translate.anthropic_openai",
            "aigw_tpu_torch.translate.responses",
            "aigw_tpu_torch.translate.multipart",
            "aigw_tpu_torch.translate.rerank"]
    for m in mods:
        assert m in MODULES, m
    code = (
        "import sys, importlib\n"
        "for m in ('jax', 'aigw_tpu', 'aiohttp', 'yaml'):\n"
        "    sys.modules[m] = None\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "from aigw_tpu_torch.config.model import APISchemaName as S\n"
        "from aigw_tpu_torch.translate import Endpoint as E, get_translator\n"
        "t = get_translator(E.MESSAGES, S.ANTHROPIC, S.TPUSERVE)\n"
        "assert type(t).__name__ == 'AnthropicToOpenAIChat'\n"
        "t = get_translator(E.RESPONSES, S.OPENAI, S.TPUSERVE)\n"
        "assert type(t).__name__ == 'ResponsesToChat'\n"
        "t = get_translator(E.RESPONSES, S.OPENAI, S.OPENAI)\n"
        "assert type(t).__name__ == 'PassthroughTranslator'\n"
        "bad = [k for k, v in sys.modules.items() if v and k.split('.')[0]\n"
        "       in ('jax', 'jaxlib', 'aigw_tpu', 'aiohttp', 'yaml',\n"
        "           'prometheus_client', 'torch')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


HOSTED_MODULES = [
    "aigw_tpu_torch.gateway.auth", "aigw_tpu_torch.gateway.auth.handlers",
    "aigw_tpu_torch.gateway.auth.oidc", "aigw_tpu_torch.utils.redaction",
    "aigw_tpu_torch.translate.eventstream",
    "aigw_tpu_torch.translate.vendor_fields",
    "aigw_tpu_torch.translate.openai_anthropic",
    "aigw_tpu_torch.translate.anthropic_hosted",
    "aigw_tpu_torch.translate.openai_azure",
    "aigw_tpu_torch.translate.openai_awsbedrock",
    "aigw_tpu_torch.translate.anthropic_awsbedrock",
    "aigw_tpu_torch.translate.openai_gcp",
    "aigw_tpu_torch.translate.tokenize",
    "aigw_tpu_torch.translate.embeddings"]


def test_hosted_modules_import_with_aiohttp_and_yaml_blocked():
    """The upstream credentials (handlers, the OIDC exchangers on the
    gateway's own client), the log redaction and the hosted-provider
    translators import in a fresh interpreter where jax, the reference
    package, aiohttp and yaml cannot be imported, pull in none of them
    nor torch, and import only the standard library and the port; the
    registry then holds every hosted pair."""
    import sys as _sys

    for m in HOSTED_MODULES:
        assert m in MODULES or m + ".__init__" in MODULES, m
        path = ROOT / (m.replace(".", "/") + ".py")
        if not path.exists():
            path = ROOT / m.replace(".", "/") / "__init__.py"
        outside = [n for n in _imported_names(path)
                   if n.split(".")[0] not in _sys.stdlib_module_names
                   and not n.startswith("aigw_tpu_torch")]
        assert not outside, (m, outside)
    code = (
        "import sys, importlib\n"
        "for m in ('jax', 'aigw_tpu', 'aiohttp', 'yaml'):\n"
        "    sys.modules[m] = None\n"
        f"for m in {HOSTED_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "from aigw_tpu_torch.config.model import APISchemaName as S\n"
        "from aigw_tpu_torch.translate import Endpoint as E, get_translator\n"
        "want = {(E.CHAT_COMPLETIONS, S.ANTHROPIC): 'OpenAIToAnthropicChat',\n"
        "        (E.CHAT_COMPLETIONS, S.AWS_BEDROCK): 'OpenAIToBedrockChat',\n"
        "        (E.CHAT_COMPLETIONS, S.GCP_VERTEX_AI): 'OpenAIToGeminiChat',\n"
        "        (E.MESSAGES, S.AWS_BEDROCK): 'AnthropicToBedrockConverse',\n"
        "        (E.MESSAGES, S.GCP_ANTHROPIC): 'AnthropicToVertexAnthropic',\n"
        "        (E.RESPONSES, S.AWS_ANTHROPIC): 'ResponsesToChat'}\n"
        "for (e, s), name in want.items():\n"
        "    f = S.ANTHROPIC if e is E.MESSAGES else S.OPENAI\n"
        "    assert type(get_translator(e, f, s)).__name__ == name, (e, s)\n"
        "bad = [k for k, v in sys.modules.items() if v and k.split('.')[0]\n"
        "       in ('jax', 'jaxlib', 'aigw_tpu', 'aiohttp', 'yaml',\n"
        "           'prometheus_client', 'torch')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


MCP_OBS_MODULES = [
    "aigw_tpu_torch.mcp", "aigw_tpu_torch.mcp.crypto",
    "aigw_tpu_torch.mcp.authz", "aigw_tpu_torch.mcp.replay",
    "aigw_tpu_torch.mcp.proxy", "aigw_tpu_torch.mcp.stdio_bridge",
    "aigw_tpu_torch.obs.openinference", "aigw_tpu_torch.obs.accesslog"]


def test_mcp_and_gateway_obs_modules_import_with_optional_packages_blocked():
    """The MCP proxy, its session crypto, authorization, replay stores
    and stdio bridge, and the gateway's OpenInference and access-log
    modules import only the standard library and the port (the session
    crypto and RS256 keys reach ``cryptography`` where it imports); in a
    fresh interpreter where jax, the reference package, aiohttp, yaml,
    cryptography and grpc cannot be imported every one imports, the
    session crypto falls back to the standard-library AEAD, and none of
    them nor torch is pulled in."""
    import sys as _sys

    for m in MCP_OBS_MODULES:
        assert m in MODULES or m + ".__init__" in MODULES, m
        path = ROOT / (m.replace(".", "/") + ".py")
        if not path.exists():
            path = ROOT / m.replace(".", "/") / "__init__.py"
        outside = [n for n in _imported_names(path)
                   if n.split(".")[0] not in _sys.stdlib_module_names
                   and not n.startswith("aigw_tpu_torch")
                   and n.split(".")[0] != "cryptography"]
        assert not outside, (m, outside)
    code = (
        "import sys, importlib\n"
        "for m in ('jax', 'aigw_tpu', 'aiohttp', 'yaml', 'cryptography',\n"
        "          'grpc'):\n"
        "    sys.modules[m] = None\n"
        f"for m in {MCP_OBS_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "from aigw_tpu_torch.mcp import crypto\n"
        "assert crypto.AEAD.endswith('(standard library)'), crypto.AEAD\n"
        "tok = crypto.SessionCrypto('s').encrypt(b'x')\n"
        "assert crypto.SessionCrypto('n', 's').decrypt(tok) == b'x'\n"
        "from aigw_tpu_torch.gateway.server import GatewayServer\n"
        "bad = [k for k, v in sys.modules.items() if v and k.split('.')[0]\n"
        "       in ('jax', 'jaxlib', 'aigw_tpu', 'aiohttp', 'yaml',\n"
        "           'prometheus_client', 'torch', 'grpc', 'cryptography')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


KUBE_MODULES = [
    "aigw_tpu_torch.config.kube", "aigw_tpu_torch.config.webhook",
    "aigw_tpu_torch.config.clientgen",
    "aigw_tpu_torch.config.generated.clients"]


def test_cluster_modules_import_with_optional_packages_blocked():
    """The live cluster source, the webhook, the clientset generator and
    its generated clients import only the standard library and the port
    (the generator imports pyyaml when it runs, as the reference's
    does); in a fresh interpreter where jax, the reference package,
    aiohttp and yaml cannot be imported every one imports, a JSON-text
    kubeconfig loads, and neither torch nor any of those is pulled in."""
    import sys as _sys

    for m in KUBE_MODULES:
        assert m in MODULES, m
        outside = [n for n in _imported_names(
            ROOT / (m.replace(".", "/") + ".py"))
            if n.split(".")[0] not in _sys.stdlib_module_names
            and not n.startswith("aigw_tpu_torch")]
        assert outside == (["yaml"] if m.endswith("clientgen") else []), \
            (m, outside)
    code = (
        "import sys, importlib, json, tempfile\n"
        "for m in ('jax', 'aigw_tpu', 'aiohttp', 'yaml'):\n"
        "    sys.modules[m] = None\n"
        f"for m in {KUBE_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "from aigw_tpu_torch.config import kube\n"
        "with tempfile.NamedTemporaryFile('w', suffix='.json') as f:\n"
        "    json.dump({'current-context': 'c', 'contexts': [{'name': 'c',\n"
        "        'context': {'cluster': 'k', 'user': 'u'}}], 'clusters': [\n"
        "        {'name': 'k', 'cluster': {'server': 'http://h:1'}}],\n"
        "        'users': [{'name': 'u', 'user': {'token': 't'}}]}, f)\n"
        "    f.flush()\n"
        "    a = kube.load_kubeconfig(f.name)\n"
        "assert (a.server, a.token) == ('http://h:1', 't'), a\n"
        "bad = [k for k, v in sys.modules.items() if v and k.split('.')[0]\n"
        "       in ('jax', 'jaxlib', 'aigw_tpu', 'aiohttp', 'yaml', 'torch')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


#: the port's last modules: the native scanners' bindings and their build
#: helper, the core's compiler and span tailer, aigw-check, the cassettes
NATIVE_AND_CHECK_MODULES = (
    "aigw_tpu_torch.native", "aigw_tpu_torch.utils.native",
    "aigw_tpu_torch.config.nativecore", "aigw_tpu_torch.obs.native_spans",
    "aigw_tpu_torch.analysis", "aigw_tpu_torch.analysis.core",
    "aigw_tpu_torch.analysis.registry", "aigw_tpu_torch.analysis.manifest",
    "aigw_tpu_torch.analysis.passes",
    "aigw_tpu_torch.analysis.passes.async_blocking",
    "aigw_tpu_torch.analysis.passes.capture_registry",
    "aigw_tpu_torch.analysis.passes.determinism",
    "aigw_tpu_torch.analysis.passes.gauge_drift",
    "aigw_tpu_torch.analysis.passes.thread_discipline",
    "aigw_tpu_torch.testing", "aigw_tpu_torch.testing.cassettes",
    "aigw_tpu_torch.testing.yaml_subset")


def test_native_check_and_cassette_modules_import_with_packages_blocked():
    """The native scanners' bindings and build helper, ``core-config``'s
    compiler, the span tailer, aigw-check and the cassette harness import
    only the standard library and the port; in a fresh interpreter where
    jax, the reference package, aiohttp and yaml cannot be imported every
    one imports, builds nothing, loads no scanner, reads a go-vcr
    cassette and runs a lint pass, and neither torch nor any of those is
    pulled in (the engine imports ``analysis.registry`` for its
    sanitizer)."""
    import sys as _sys

    for m in NATIVE_AND_CHECK_MODULES:
        assert m in MODULES or m + ".__init__" in MODULES, m
        path = ROOT / (m.replace(".", "/") + ".py")
        if not path.exists():
            path = ROOT / m.replace(".", "/") / "__init__.py"
        outside = [n for n in _imported_names(path)
                   if n.split(".")[0] not in _sys.stdlib_module_names
                   and not n.startswith("aigw_tpu_torch")]
        assert not outside, (m, outside)
    code = (
        "import sys, importlib, tempfile, pathlib\n"
        "for m in ('jax', 'aigw_tpu', 'aiohttp', 'yaml'):\n"
        "    sys.modules[m] = None\n"
        f"for m in {NATIVE_AND_CHECK_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "from aigw_tpu_torch.utils import native\n"
        "assert not native.available()\n"
        "from aigw_tpu_torch.testing import load_cassette\n"
        "d = pathlib.Path(tempfile.mkdtemp())\n"
        "(d / 'c.yaml').write_text('---\\nversion: 2\\ninteractions:\\n'\n"
        "    '    - id: 0\\n      request:\\n        body: \\'{}\\'\\n'\n"
        "    '        url: https://h/v1/x\\n        method: POST\\n'\n"
        "    '      response:\\n        body: |-\\n            {\"a\": 1}\\n'\n"
        "    '        code: 200\\n')\n"
        "it = load_cassette(d / 'c.yaml').interactions[0]\n"
        "assert (it.path, it.status, it.response_body) == (\n"
        "    '/v1/x', 200, '{\"a\": 1}'), it\n"
        "from aigw_tpu_torch.analysis.core import run_checks\n"
        "root = pathlib.Path('.').resolve()\n"
        "found, _ = run_checks(root, paths=['aigw_tpu_torch/analysis'])\n"
        "assert found == [], found\n"
        "bad = [k for k, v in sys.modules.items() if v and k.split('.')[0]\n"
        "       in ('jax', 'jaxlib', 'aigw_tpu', 'aiohttp', 'yaml',\n"
        "           'torch')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"

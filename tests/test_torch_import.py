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

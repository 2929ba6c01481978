"""aigw-check for the port (``aigw_tpu_torch/analysis``,
``tools/torch_staticcheck.py``): the per-rule fixtures of the reference's
``tests/test_staticcheck.py`` with each pass held against the
reference's on the same sources, the port's ``capture-registry`` (the
counterpart of ``jit-registry``) and torch RNG rule, the suppression
syntax, the ``@engine_thread_only`` sanitizer on the port's live engine
(``tests/conftest.py`` sets ``AIGW_TSAN=1``), and the gate: zero
unsuppressed findings over ``aigw_tpu_torch/``."""

from __future__ import annotations

import json
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

from aigw_tpu.analysis import core as jcore
from aigw_tpu.analysis import registry as jregistry
from aigw_tpu_torch.analysis import manifest
from aigw_tpu_torch.analysis.core import Source, run_checks, run_passes
from aigw_tpu_torch.analysis.passes import RULES
from aigw_tpu_torch.analysis.registry import (
    DEFAULT_CONFIG,
    TSAN,
    AnalysisConfig,
    EngineThreadViolation,
    ThreadDomain,
    engine_thread_only,
)

ROOT = Path(__file__).resolve().parents[1]


def _fixture_config(**kw) -> AnalysisConfig:
    base = dict(thread_domains=(), capture_scope=(), capture_surface={},
                determinism_modules=(), wallclock_modules=(),
                state_server="absent.py", fleetstate_module="absent.py",
                usage_module="absent.py")
    base.update(kw)
    return AnalysisConfig(**base)


def _reference_config(**kw) -> jregistry.AnalysisConfig:
    base = dict(thread_domains=(), jit_scope=(), jit_warm_surface={},
                determinism_modules=(), wallclock_modules=(),
                state_server="absent.py", fleetstate_module="absent.py",
                usage_module="absent.py")
    for k, v in kw.items():
        if k == "thread_domains":
            v = tuple(jregistry.ThreadDomain(**vars(d)) for d in v)
        base[k] = v
    return jregistry.AnalysisConfig(**base)


def _check(tmp_path: Path, rel: str, code: str, config: AnalysisConfig,
           rules: set[str] | None = None):
    p = tmp_path / rel
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(code)
    return run_passes([Source.load(p, tmp_path)], config, rules=rules)


def _both(tmp_path: Path, rel: str, code: str, **cfg) -> list:
    """The port's findings on one fixture, after asserting the
    reference's passes find the same (rule, path, line)s."""
    p = tmp_path / rel
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(code)
    got, _ = run_passes([Source.load(p, tmp_path)], _fixture_config(**cfg))
    want, _ = jcore.run_passes([jcore.Source.load(p, tmp_path)],
                               _reference_config(**cfg))
    key = [(f.rule, f.path, f.line) for f in got]
    assert key == [(f.rule, f.path, f.line) for f in want]
    return got


# -- engine-thread, against the reference --------------------------------

THREAD = dict(thread_domains=(ThreadDomain(
    path="fix/eng.py", cls="Eng", thread_attr="_thread",
    entry_methods=("_run",), allowed_methods=("__init__",),
    guarded_fields=("_state", "_slots")),))


def test_engine_thread_fires_on_undecorated_mutation(tmp_path):
    findings = _both(tmp_path, "fix/eng.py", (
        "class Eng:\n"
        "    def __init__(self):\n"
        "        self._state = None\n"
        "        self._slots = [None]\n"
        "    def _run(self):\n"
        "        self._state = 1\n"
        "    def warmup(self):\n"
        "        self._state = object()\n"
        "        self._slots[0] = 'x'\n"
        "        self._slots.append('y')\n"
        "        del self._slots[0]\n"
        "        self._state, other = 1, 2\n"
    ), **THREAD)
    assert [f.rule for f in findings] == ["engine-thread"] * 5
    assert [f.line for f in findings] == [8, 9, 10, 11, 12]


def test_engine_thread_clean_when_annotated(tmp_path):
    findings = _both(tmp_path, "fix/eng.py", (
        "from aigw_tpu_torch.analysis.registry import engine_thread_only\n"
        "class Eng:\n"
        "    def __init__(self):\n"
        "        self._state = None\n"
        "        self._slots = [None]\n"
        "    def _run(self):\n"
        "        self._state = 1\n"
        "        self._slots[0] = None\n"
        "    @engine_thread_only\n"
        "    def _tick(self):\n"
        "        self._state, self._slots = None, []\n"
        "    def reader(self):\n"
        "        return self._state\n"
    ), **THREAD)
    assert findings == []


def test_engine_thread_flags_stale_registry_entries(tmp_path):
    findings = _both(tmp_path, "fix/eng.py", (
        "class Eng:\n"
        "    def __init__(self):\n"
        "        self._state = None\n"
        "    def _run(self):\n"
        "        pass\n"
    ), thread_domains=(ThreadDomain(
        path="fix/eng.py", cls="Eng", thread_attr="_thread",
        entry_methods=("_run", "_gone"), allowed_methods=("__init__",),
        guarded_fields=("_renamed_away",)),))
    msgs = [f.message for f in findings]
    assert len(findings) == 2
    assert any("_gone" in m for m in msgs)
    assert any("stale THREAD_DOMAINS entry" in m for m in msgs)


def test_engine_thread_missing_class(tmp_path):
    findings = _both(tmp_path, "fix/eng.py", "x = 1\n", **THREAD)
    assert len(findings) == 1 and "does not exist" in findings[0].message


# -- async-blocking, against the reference -------------------------------


def test_async_blocking_fires_inside_async_def(tmp_path):
    findings = _both(tmp_path, "fix/srv.py", (
        "import time, subprocess, urllib.request\n"
        "async def handler(request):\n"
        "    time.sleep(1.0)\n"
        "    eng.migrate_export(req)\n"
        "    subprocess.run(['true'])\n"
        "    urllib.request.urlopen('http://x')\n"
        "    srv.engine.kv_import_pages(a, b)\n"
    ))
    assert [f.rule for f in findings] == ["async-blocking"] * 5
    assert [f.line for f in findings] == [3, 4, 5, 6, 7]


def test_async_blocking_clean_for_to_thread_idiom(tmp_path):
    findings = _both(tmp_path, "fix/srv.py", (
        "import asyncio, time\n"
        "async def handler(request):\n"
        "    def capture():\n"
        "        time.sleep(1.0)\n"
        "    await asyncio.to_thread(capture)\n"
        "    out = await asyncio.to_thread(eng.migrate_export, req)\n"
        "    await asyncio.sleep(0.1)\n"
        "    f = lambda: time.sleep(1)\n"
        "def sync_path():\n"
        "    time.sleep(1.0)\n"
    ))
    assert findings == []


# -- determinism, against the reference ----------------------------------

DET = dict(determinism_modules=("fix/",), wallclock_modules=("fix/pure/",))


def test_determinism_fires_on_global_rng_and_wallclock(tmp_path):
    findings = _both(tmp_path, "fix/pure/sampling.py", (
        "import random, time, datetime\n"
        "import numpy as np\n"
        "def draw():\n"
        "    a = random.random()\n"
        "    b = np.random.rand(3)\n"
        "    t = time.monotonic()\n"
        "    c = random.choice([1, 2])\n"
        "    d = datetime.datetime.now()\n"
        "    return a, b, t, c, d\n"
    ), **DET)
    assert [f.line for f in findings] == [4, 5, 6, 7, 8]


def test_determinism_clean_for_keyed_and_seeded_rng(tmp_path):
    findings = _both(tmp_path, "fix/pure/sampling.py", (
        "import jax, random\n"
        "import numpy as np\n"
        "def draw(key):\n"
        "    a = jax.random.categorical(key, logits)\n"
        "    rng = np.random.default_rng(1234)\n"
        "    r = random.Random(7)\n"
        "    return a, rng.random(), r.random()\n"
    ), **DET)
    assert findings == []


def test_determinism_wallclock_scoped_to_pure_modules(tmp_path):
    findings = _both(tmp_path, "fix/engine.py", (
        "import time\n"
        "def tick():\n"
        "    return time.monotonic()\n"
    ), **DET)
    assert findings == []


def test_determinism_torch_draws_need_a_generator(tmp_path):
    """The port's rule also holds torch's global generator: a draw
    without ``generator=`` is a finding, a seeded one is not."""
    findings, _ = _check(tmp_path, "fix/pure/init.py", (
        "import torch\n"
        "def init(gen):\n"
        "    a = torch.randn(3)\n"
        "    b = torch.randn(3, generator=gen)\n"
        "    c = torch.multinomial(p, 1)\n"
        "    d = torch.multinomial(p, 1, generator=gen)\n"
        "    g = torch.Generator(device='cpu')\n"
        "    e = torch.randint(0, 5, (2,))\n"
        "    return a, b, c, d, g, e\n"
    ), _fixture_config(**DET))
    assert [f.line for f in findings] == [3, 5, 8]
    assert all("generator" in f.message for f in findings)


# -- gauge-drift, against the port's manifest ----------------------------


def _state_code(keys) -> str:
    body = ",\n".join(f"            {k!r}: 0" for k in keys)
    return ("class Srv:\n"
            "    def state(self):\n"
            "        return {\n"
            f"{body},\n"
            "            **device_topology(),\n"
            "        }\n")


def test_gauge_drift_clean_on_manifest_exact_keys(tmp_path):
    findings, _ = _check(tmp_path, "fix/srv.py", _state_code(
        sorted(manifest.expected_state_keys())),
        _fixture_config(state_server="fix/srv.py"))
    assert findings == []


def test_gauge_drift_fires_on_unknown_and_lost_fields(tmp_path):
    keys = sorted(manifest.expected_state_keys())
    keys.remove("kv_occupancy")
    keys.append("bogus_new_field")
    findings, _ = _check(tmp_path, "fix/srv.py", _state_code(keys),
                         _fixture_config(state_server="fix/srv.py"))
    msgs = "\n".join(f.message for f in findings)
    assert all(f.rule == "gauge-drift" for f in findings)
    assert "bogus_new_field" in msgs
    assert "kv_occupancy" in msgs and "lost" in msgs


def test_gauge_drift_names_a_missing_handler(tmp_path):
    findings, _ = _check(tmp_path, "fix/srv.py", "def other():\n    pass\n",
                         _fixture_config(state_server="fix/srv.py"))
    assert len(findings) == 1 and "'state' not found" in findings[0].message


@pytest.mark.parametrize("module,fn,key", [
    ("fleetstate_module", "rollup", "replicas_up"),
    ("usage_module", "snapshot", None)])
def test_gauge_drift_checks_fleet_and_usage_rollups(tmp_path, module, fn,
                                                    key):
    findings, _ = _check(tmp_path, "fix/m.py", (
        f"class X:\n    def {fn}(self, *a):\n"
        "        return {'replicas_total': 1}\n"),
        _fixture_config(**{module: "fix/m.py"}))
    assert findings and all(f.rule == "gauge-drift" for f in findings)
    if key is not None:
        assert any(key in f.message for f in findings)


def test_manifest_reads_the_port_gauges_and_states_its_own_keys():
    from aigw_tpu.analysis import manifest as jmanifest
    from aigw_tpu_torch.obs.metrics import ENGINE_GAUGES

    attrs = {a for a, _ in ENGINE_GAUGES}
    for key in manifest.expected_state_keys():
        assert key in attrs or key in manifest.STATE_ONLY, key
    # the port's /state is the reference's plus the port's keys
    # (tests/test_torch_histograms.py PORT_STATE_KEYS)
    extra = manifest.expected_state_keys() - jmanifest.expected_state_keys()
    assert extra == {"device", "enable_prefix_cache", "defaults_differ",
                     "prefills", "chunked_prefill_steps", "window_shrinks",
                     "window_grows", "prefix_full_hits", "prefix_cow_copies",
                     "prefix_tokens_reused"}
    assert jmanifest.expected_state_keys() <= manifest.expected_state_keys()
    for group in manifest.GROUPS:
        assert set(manifest.state_fields(group)) >= set(
            jmanifest.state_fields(group)), group
    assert "tpuserve_prefix_full_hits_total" in manifest.gauge_names(
        "prefix")


# -- capture-registry (the port's counterpart of jit-registry) -----------

CAP = dict(capture_scope=("fix/",))


def test_capture_registry_fires_on_an_unreported_capture(tmp_path):
    findings, _ = _check(tmp_path, "fix/eng.py", (
        "import torch\n"
        "class E:\n"
        "    def build(self):\n"
        "        g = torch.cuda.CUDAGraph()\n"
        "        with torch.cuda.graph(g):\n"
        "            pass\n"
        "def f():\n"
        "    return torch.cuda.make_graphed_callables(m, (x,))\n"
    ), _fixture_config(**CAP))
    assert [f.rule for f in findings] == ["capture-registry"] * 3
    assert [f.line for f in findings] == [4, 5, 8]


def test_capture_registry_clean_when_the_capture_is_reported(tmp_path):
    # the program pool's idiom: capture, then note_compile in the same
    # function; a nested def's note_compile does not count for its parent
    findings, _ = _check(tmp_path, "fix/programs.py", (
        "import torch\n"
        "class P:\n"
        "    def _capture(self):\n"
        "        graph = torch.cuda.CUDAGraph()\n"
        "        graph.capture_begin()\n"
        "        self.pool.tracker.note_compile(1.0)\n"
        "    def other(self):\n"
        "        g = torch.cuda.CUDAGraph()\n"
        "        def inner():\n"
        "            tracker.note_compile(0)\n"
        "        return g\n"
    ), _fixture_config(**CAP))
    assert [f.line for f in findings] == [8]


def test_capture_registry_surface_and_stale_entries(tmp_path):
    code = ("import torch\n"
            "def bench():\n"
            "    return torch.cuda.CUDAGraph()\n")
    ok = _fixture_config(capture_scope=("fix/",), capture_surface={
        "fix/k.py::bench": "a measurement, outside serving"})
    assert _check(tmp_path, "fix/k.py", code, ok)[0] == []
    assert len(_check(tmp_path, "fix/k.py", code,
                      _fixture_config(**CAP))[0]) == 1
    stale = _fixture_config(capture_scope=("fix/",), capture_surface={
        "fix/k.py::bench": "ok", "fix/k.py::renamed": "stale"})
    findings, _ = _check(tmp_path, "fix/k.py", code, stale)
    assert len(findings) == 1 and "stale" in findings[0].message


def test_capture_registry_scope(tmp_path):
    code = "import torch\ng = torch.cuda.CUDAGraph()\n"
    assert _check(tmp_path, "tools/x.py", code,
                  _fixture_config(**CAP))[0] == []
    findings, _ = _check(tmp_path, "fix/x.py", code, _fixture_config(**CAP))
    assert len(findings) == 1 and "<module>" in findings[0].message


def test_the_program_pool_is_the_ports_one_capture_site():
    findings, _ = run_checks(ROOT, paths=["aigw_tpu_torch/tpuserve"],
                             rules={"capture-registry"})
    assert findings == []
    src = (ROOT / "aigw_tpu_torch/tpuserve/programs.py").read_text()
    assert "torch.cuda.CUDAGraph()" in src and "note_compile" in src
    assert DEFAULT_CONFIG.capture_surface == {}


# -- suppression syntax, against the reference ---------------------------


def test_suppression_honored_with_reason(tmp_path):
    code = ("import time\n"
            "async def handler(request):\n"
            "    # aigw: lint-ok(async-blocking): sub-ms debug knob\n"
            "    time.sleep(0.001)\n")
    findings, suppressed = _check(tmp_path, "fix/srv.py", code,
                                  _fixture_config())
    jf, js = jcore.run_passes(
        [jcore.Source.load(tmp_path / "fix/srv.py", tmp_path)],
        _reference_config())
    assert findings == [] == jf
    assert [f.rule for f in suppressed] == ["async-blocking"] == \
        [f.rule for f in js]


@pytest.mark.parametrize("code,rules", [
    ("import time\nasync def h(r):\n"
     "    time.sleep(0.001)  # aigw: lint-ok(async-blocking)\n",
     ["async-blocking", "suppression"]),
    ("# aigw: lint-ok(no-such-rule): whatever\nx = 1\n", ["suppression"]),
    ("import time\nasync def h(r):\n"
     "    # aigw: lint-ok(determinism): wrong rule named\n"
     "    time.sleep(0.001)\n", ["async-blocking"]),
])
def test_suppression_syntax_polices_itself(tmp_path, code, rules):
    findings = _both(tmp_path, "fix/srv.py", code)
    assert sorted(f.rule for f in findings) == rules


# -- the runtime sanitizer -----------------------------------------------


class _Dummy:
    def __init__(self):
        self._thread = None

    @engine_thread_only
    def poke(self):
        return 42


def test_tsan_is_on_in_the_suite():
    assert TSAN  # tests/conftest.py sets AIGW_TSAN=1 before any import
    assert _Dummy.poke.__engine_thread_only__


def test_tsan_decorator_allows_when_owner_thread_dead():
    d = _Dummy()
    assert d.poke() == 42
    t = threading.Thread(target=lambda: None)
    t.start()
    t.join()
    d._thread = t
    assert d.poke() == 42


def test_tsan_decorator_raises_from_foreign_thread_while_live():
    d = _Dummy()
    stop = threading.Event()
    t = threading.Thread(target=stop.wait, daemon=True)
    t.start()
    d._thread = t
    try:
        with pytest.raises(EngineThreadViolation):
            d.poke()
        out: list = []
        t2 = threading.Thread(target=lambda: out.append(d.poke()))
        d._thread = t2
        t2.start()
        t2.join()
        assert out == [42]
    finally:
        stop.set()


def test_tsan_guards_the_ports_engine_loop():
    """On a started port engine, an engine-thread-only method called from
    this thread raises; ``refresh_stats`` routes the same work through
    the loop; after ``stop()`` the direct call is legal again, and
    ``warmup`` on a started engine still refuses with its own error."""
    import torch

    from aigw_tpu_torch.models import llama
    from aigw_tpu_torch.tpuserve.engine import Engine, EngineConfig

    params = llama.init_params(0, llama.TINY, torch.float32, device="cpu")
    eng = Engine(params, llama.TINY, EngineConfig(
        max_batch_size=2, max_seq_len=64, page_size=16,
        enable_prefix_cache=False), device="cpu")
    decorated = [n for n in dir(Engine)
                 if getattr(getattr(Engine, n), "__engine_thread_only__",
                            False)]
    assert {"_refresh_stats", "_decode_tick", "_abort_all", "_emit_token",
            "_op_window", "_quiesce", "_warm_decode_windows"} <= set(
        decorated)
    eng.start()
    try:
        deadline = time.monotonic() + 10
        while not eng._thread.is_alive():
            assert time.monotonic() < deadline
        with pytest.raises(EngineThreadViolation):
            eng._refresh_stats()
        with pytest.raises(EngineThreadViolation):
            eng._quiesce()
        eng.refresh_stats()
        with pytest.raises(RuntimeError, match="before the engine starts"):
            eng.warmup()
    finally:
        eng.stop()
    eng._refresh_stats()
    eng.refresh_stats()


# -- the gate ------------------------------------------------------------


def test_whole_tree_has_zero_unsuppressed_findings():
    findings, suppressed = run_checks(ROOT, config=DEFAULT_CONFIG)
    assert findings == [], "\n" + "\n".join(f.render() for f in findings)
    # the four wall-clock reads of the build and checkpoint modules, each
    # with its reason; no engine-thread finding is suppressed
    assert sorted((f.path, f.rule) for f in suppressed) == [
        ("aigw_tpu_torch/models/checkpoint.py", "determinism"),
        ("aigw_tpu_torch/models/checkpoint.py", "determinism"),
        ("aigw_tpu_torch/ops/_build.py", "determinism"),
        ("aigw_tpu_torch/ops/_build.py", "determinism")]


def test_engine_findings_without_decorators(tmp_path):
    """The engine with its decorators stripped: the engine-thread pass
    finds the undecorated mutations (63 of them, in the methods the
    decorators now mark)."""
    src = (ROOT / "aigw_tpu_torch/tpuserve/engine.py").read_text()
    stripped = "\n".join(ln for ln in src.splitlines()
                         if ln.strip() != "@engine_thread_only")
    p = tmp_path / "aigw_tpu_torch/tpuserve/engine.py"
    p.parent.mkdir(parents=True)
    p.write_text(stripped)
    findings, _ = run_passes([Source.load(p, tmp_path)],
                             rules={"engine-thread"})
    assert len(findings) == 63
    assert {f.rule for f in findings} == {"engine-thread"}


def test_the_gate_command():
    proc = subprocess.run([sys.executable, "tools/torch_staticcheck.py"],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "aigw-check: ok — 0 finding(s), 4 suppressed" in proc.stderr
    proc = subprocess.run(
        [sys.executable, "tools/torch_staticcheck.py", "--json", "--rule",
         "engine-thread", "aigw_tpu_torch/tpuserve"], cwd=ROOT,
        capture_output=True, text=True, timeout=120)
    out = json.loads(proc.stdout)
    assert proc.returncode == 0 and out["findings"] == []
    proc = subprocess.run(
        [sys.executable, "tools/torch_staticcheck.py", "--list-rules"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert [ln.split()[0] for ln in proc.stdout.splitlines()] == list(RULES)
    proc = subprocess.run(
        [sys.executable, "tools/torch_staticcheck.py", "--rule",
         "jit-registry"], cwd=ROOT, capture_output=True, text=True,
        timeout=120)
    assert proc.returncode == 2 and "unknown rule" in proc.stderr

"""CPU tests of the benchmark's harness, at tiny sizes (run them with
``python -m pytest portbench/``; the repository's own suite under
``tests/`` does not collect them).

Each cell's path runs end to end on the kernels' plain versions: the
replica in this process, the gateway and the load generator in child
processes, the output check against the plain reference. The control
(the reference in a lower precision) and faults planted in the served
path must fail that check. The load generator's schedules are fixed by
the seed, every seed gets the same lengths and gaps, the operation and
byte counts agree with hand counts, and no run loads JAX or the JAX
package. Card-only tests are marked ``gpu`` and decide inside a fixture
whether a card is there.
"""

from __future__ import annotations

import json
import os
import random
import subprocess
import sys
import time

import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import check  # noqa: E402
import flops  # noqa: E402
import loadgen  # noqa: E402
import run  # noqa: E402
import weights  # noqa: E402
from reference import Model  # noqa: E402

with open(os.path.join(run.ROOT, "BENCHMARK.json")) as _f:
    BENCH = json.load(_f)

TINY_LLAMA = {
    "name": "tiny-qwen-bench", "family": "llama", "hidden_size": 64,
    "intermediate_size": 128, "num_hidden_layers": 2,
    "num_attention_heads": 4, "num_key_value_heads": 2, "vocab_size": 512,
    "rope_theta": 10000.0, "rms_norm_eps": 1e-6,
    "tie_word_embeddings": False, "qkv_bias": True,
    "engine": {"max_batch_size": 8, "max_seq_len": 512, "page_size": 16,
               "num_pages": 256, "attention_backend": "pallas-ragged",
               "decode_backend": "fused"}}
TINY_MOE = dict(
    TINY_LLAMA, name="tiny-moe-bench", family="mixtral", qkv_bias=False,
    num_local_experts=4, num_experts_per_tok=2, capacity_factor=2.0,
    quantization="int8")
LENGTHS = {"prompt_tokens": {"median": 80, "sigma": 0.5, "min": 30,
                             "max": 200},
           "output_tokens": {"median": 8, "sigma": 0.5, "min": 4,
                             "max": 16}}
CHAT = dict(LENGTHS, arrival="poisson", via_gateway=True, rate=4.0,
            ramp_s=1, tail_s=5, grace_s=30, ttft_slo_ms=2000,
            trace_offset_s=1, trace_s=1)
BATCH = dict(LENGTHS, arrival="closed", clients=4, requests_per_client=4,
             ramp_timeout_s=60, trace_offset_s=1, trace_s=1)
#: on the CPU the program's logits are the plain reference's to
#: rounding: bf16 weights, float32 sums, the same order of operations
#: up to the paged layout
LIMITS = {"widest_gap": 0.02, "mean_gap": 0.002, "sample_tokens": 60,
          "sample_requests": 4}
CELLS = {
    "qwen2-7b.chat": (TINY_LLAMA, CHAT),
    "mixtral-8x7b-w8a16.batch": (TINY_MOE, BATCH),
}


def tiny_run(cell: str, seed: int = 2 ** 31 + 7, control=None):
    cfg, traffic = CELLS[cell]
    entry = {"name": cell, "config": cfg["name"], "traffic": cell,
             "chips": 1}
    return run.run_cell(BENCH, entry, cfg, traffic, LIMITS, seed, 3.0,
                        False, device="cpu", control=control)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_cell_path_end_to_end(cell):
    res = tiny_run(cell)
    assert res["correct"], res["check"]
    assert res["failed"] == 0 and res["attempted"] > 0
    names = {m["name"] for m in run.cell_metrics(BENCH, "end_to_end", cell)}
    assert set(res["metrics"]) == names, res["metrics"]
    assert res["check_info"]["positions"] > 0


@pytest.mark.parametrize("cell,lowp", [("qwen2-7b.chat", "fp8"),
                                       ("mixtral-8x7b-w8a16.batch",
                                        "int4")])
def test_control_fails_the_check(cell, lowp):
    """The reference in the precision below the configuration's, put in
    the program's place (its best token at each position standing for
    the served one), comes out not correct through the same limits that
    the program's served tokens meet."""
    res = tiny_run(cell, control=lowp)
    assert not res["correct"], res["check"]
    assert check.passed(res["program_check"]), res["program_check"]
    assert res["check"]["token_count_mismatches"]["value"] == 0


def _alter_tokens(monkeypatch):
    """A token altered where it is produced: the sampler's pick moves
    to the next letter."""
    from aigw_tpu_torch.tpuserve import engine, sampling

    real = sampling.sample

    def altered(*a, **k):
        tok = real(*a, **k)
        return torch.where((tok >= 97) & (tok < 122), tok + 1, tok)

    monkeypatch.setattr(sampling, "sample", altered)
    monkeypatch.setattr(engine, "sample", altered, raising=False)


def _freeze_cache(monkeypatch):
    """A step that returns its state unchanged: the decode step's fused
    append leaves the paged K/V pool as it was."""
    from aigw_tpu_torch.ops import decode_fused

    real = decode_fused.fused_paged_decode

    def frozen(q, k, v, k_pool, v_pool, *a, **kw):
        keep_k, keep_v = k_pool.clone(), v_pool.clone()
        out = real(q, k, v, k_pool, v_pool, *a, **kw)
        k_pool.copy_(keep_k)
        v_pool.copy_(keep_v)
        return out

    monkeypatch.setattr(decode_fused, "fused_paged_decode", frozen)


@pytest.mark.parametrize("fault", [_alter_tokens, _freeze_cache])
@pytest.mark.parametrize("cell", ["qwen2-7b.chat",
                                  "mixtral-8x7b-w8a16.batch"])
def test_faults_fail_the_check(monkeypatch, cell, fault):
    fault(monkeypatch)
    res = tiny_run(cell)
    assert not res["correct"], res["check"]


def test_schedules_fixed_by_the_seed():
    tr = dict(LENGTHS, rate=10.0)
    plans = []
    for seed in (1, 1, 2 ** 31 + 5):
        rng = random.Random(seed)
        gaps = loadgen.gap_set(40, 4.0, rng)
        lens = loadgen.quantile_set(40, tr["prompt_tokens"], rng)
        body = loadgen.text(50, rng)
        plans.append((gaps, lens, body))
    assert plans[0] == plans[1]
    assert plans[0] != plans[2]
    assert sorted(plans[0][1]) == sorted(plans[2][1])
    # the same gaps in another order: the same span
    assert sorted(plans[0][0][1:]) != [] and abs(
        max(plans[0][0]) - max(plans[2][0])) < 4.0
    assert all(30 <= n <= 200 for n in plans[0][1])


def test_summary_counts_a_failed_request_as_unanswered():
    """The TTFT tail on each run's summary line is over every request
    due in the window, from its due time; one that failed ranks last."""
    recs = [{"segment": "window", "due": 0.0, "sent": 0.001, "ok": True,
             "times": [0.1 * (i + 1), 0.1 * (i + 1) + 0.05]}
            for i in range(19)]
    recs.append({"segment": "window", "due": 0.0, "sent": 0.0,
                 "ok": False, "times": []})
    s = run.summary(run.SimpleNamespace(records=recs))
    assert s["ttft_ms_p50"] == pytest.approx(1050.0)
    assert s["ttft_ms_p95"] == float("inf")
    assert len(s["ttft_ms"]) == 19 and s["finished"] == 19


def test_prompt_ids_match_the_byte_template():
    from aigw_tpu_torch.tpuserve.tokenizer import (ByteTokenizer,
                                                   apply_chat_template)

    msgs = [{"role": "system", "content": "ab c"},
            {"role": "user", "content": "xyz"}]
    assert check.prompt_ids(msgs) == apply_chat_template(msgs,
                                                         ByteTokenizer())


def test_flop_and_byte_counts_by_hand():
    cfg = TINY_LLAMA  # D 64, H 4, Hkv 2, hd 16, F 128, V 512, L 2
    per_layer = 64 * 64 * 2 + 64 * 32 * 2 + 3 * 64 * 128
    assert flops.layer_matmul_params(cfg) == per_layer
    # positions 2..4 attend 3 + 4 + 5 keys
    assert flops.attn_flops(cfg, 2, 5) == 4 * 2 * 4 * 16 * 12
    assert flops.decode_flops(cfg, 9) == (2 * 2 * per_layer
                                          + 4 * 2 * 4 * 16 * 10
                                          + 2 * 64 * 512)
    ops, nbytes = flops.k1_work(cfg, 2, 5)
    assert nbytes == 2 * 2 * (2 * 3 * 64 + 2 * 5 * 32)
    assert flops.k2_bytes(cfg, 10) == 2 * 2 * (2 * 64 + 4 * 32
                                               + 2 * 10 * 32)
    moe = TINY_MOE
    assert flops.layer_matmul_params(moe) == (64 * 64 * 2 + 64 * 32 * 2
                                              + 64 * 4 + 2 * 3 * 64 * 128)


def test_reference_matches_a_dense_float32_pass():
    """The reference's blocked attention and its dropless routing equal
    a direct float32 computation of the same equations."""
    p = weights.make(TINY_MOE, 3, "cpu")
    m = Model(TINY_MOE, p)
    toks = list(range(97, 97 + 40))
    a = m.logits(toks, 5)
    old = run.sys.modules["reference"].Q_BLOCK
    run.sys.modules["reference"].Q_BLOCK = 7
    try:
        b = m.logits(toks, 5)
    finally:
        run.sys.modules["reference"].Q_BLOCK = old
    assert torch.allclose(a, b, atol=1e-4, rtol=1e-5)


def test_watchdog_ends_a_hung_run(tmp_path):
    """A run past its deadline prints the threads' stacks, kills its
    children and leaves with exit code 4."""
    script = tmp_path / "hung.py"
    script.write_text(
        "import subprocess, sys, time\n"
        f"sys.path.insert(0, {HERE!r})\n"
        "import run\n"
        "child = subprocess.Popen([sys.executable, '-c', "
        "'import time; time.sleep(120)'])\n"
        "run.CHILDREN.append(child)\n"
        "print(child.pid, flush=True)\n"
        "run.Watchdog(time.monotonic() + 1.0)\n"
        "time.sleep(60)\n")
    out = subprocess.run([sys.executable, str(script)], capture_output=True,
                         text=True, timeout=60)
    assert out.returncode == 4
    assert "past the run's deadline" in out.stderr
    assert "most recent call first" in out.stderr
    pid = int(out.stdout.split()[0])
    with pytest.raises(ProcessLookupError):
        for _ in range(50):
            os.kill(pid, 0)
            time.sleep(0.1)


def test_no_jax_loaded_in_a_run():
    """A run of the harness's path in a fresh process loads neither JAX
    nor the JAX package, compared by whole top-level names."""
    code = (
        "import sys; sys.path.insert(0, %r); import test_portbench_cpu as "
        "t, run; t.tiny_run('mixtral-8x7b-w8a16.batch'); "
        "print(run.forbidden_modules()); "
        "print(sorted({m.split('.')[0] for m in sys.modules} & "
        "{'aigw_tpu_torch'}))" % HERE)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=run.ROOT,
                         env={k: v for k, v in os.environ.items()
                              if k != "JAX_PLATFORMS"})
    lines = out.stdout.strip().splitlines()
    assert out.returncode == 0, out.stderr[-2000:]
    assert lines[-2:] == ["[]", "['aigw_tpu_torch']"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the port's CUDA kernels have no "
                    "CPU mode)")
    return "cuda"


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["qwen2-7b.chat",
                                  "mixtral-8x7b-w8a16.batch"])
def test_cell_path_on_the_card(cuda, cell):
    """The tiny cells on the card's kernels: the served tokens within
    the limits, and the control in their place not correct."""
    cfg, traffic = CELLS[cell]
    entry = {"name": cell, "config": cfg["name"], "traffic": cell,
             "chips": 1}
    lowp = "int4" if cfg.get("quantization") else "fp8"
    res = run.run_cell(BENCH, entry, cfg, traffic,
                       dict(LIMITS, widest_gap=0.1, mean_gap=0.01),
                       2 ** 31 + 11, 3.0, False, device=cuda,
                       control=lowp)
    assert not res["correct"], res["check"]
    assert check.passed(res["program_check"]), res["program_check"]
    assert res["device"]["memory_peak_bytes"] > 0

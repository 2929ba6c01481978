"""The pipeline (``parallel/pipeline.py``) against the reference's
``pipeline_logits`` on the virtual 8-device CPU mesh.

Two stages over gloo on the CPU: this test process is stage 0 (rank 0)
and a spawned process stage 1, ``file://`` rendezvous under
``tmp_path``. Both hold the reference's ``init_params(PRNGKey(0), cfg,
float32)`` weights of a 4-layer model (2 layers a stage) and score the
same ``[4, 16]`` token block in microbatches of 2; the last stage's
logits, gathered to rank 0, equal the reference's within 2e-5 (float32:
the two frameworks' matmuls round apart) and the one-device model's
dense pass. The reference's refusals (layers or batch that do not
divide) are the port's.
"""

import dataclasses
import multiprocessing as mp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from aigw_tpu.models import llama as jllama
from aigw_tpu.parallel import MeshSpec as JMeshSpec
from aigw_tpu.parallel import make_mesh as jmake_mesh
from aigw_tpu.parallel import pipeline as jpipeline
from aigw_tpu_torch.models import convert
from aigw_tpu_torch.models import llama as tllama
from aigw_tpu_torch.parallel import MeshSpec, make_mesh, pipeline

CFG = dataclasses.replace(jllama.TINY, n_layers=4)
TCFG = dataclasses.replace(tllama.TINY, n_layers=4)
#: float32 logits of two frameworks' matmuls
TOL = 2e-5


def _stage(rank, init, flat, tokens, out):
    """Stage ``rank`` of the pipeline in a spawned process."""
    mesh = make_mesh(MeshSpec(pp=2), device="cpu", rank=rank, world_size=2,
                     init_method=init, timeout_s=60)
    try:
        params = convert.params_from_numpy(flat, device="cpu")
        res = pipeline.pipeline_logits(params, TCFG, torch.from_numpy(tokens),
                                       mesh=mesh, pp=2, microbatch=2)
        out.put(res is None)
    finally:
        mesh.close()


@pytest.fixture(scope="module")
def weights():
    return jllama.init_params(jax.random.PRNGKey(0), CFG, dtype=jnp.float32)


def test_pipeline_logits_match_the_references(weights, tmp_path):
    flat = {k: np.asarray(v) for k, v in weights.items()}
    tokens = np.random.default_rng(4).integers(0, 512, (4, 16)).astype(
        np.int32)
    want = np.asarray(jpipeline.pipeline_logits(
        weights, CFG, jnp.asarray(tokens),
        mesh=jmake_mesh(JMeshSpec(pp=2)), pp=2, microbatch=2))
    init = f"file://{tmp_path / 'rdv'}"
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    proc = ctx.Process(target=_stage, args=(1, init, flat, tokens, out),
                       daemon=True)
    proc.start()
    try:
        mesh = make_mesh(MeshSpec(pp=2), device="cpu", rank=0, world_size=2,
                         init_method=init, timeout_s=60)
        try:
            got = pipeline.pipeline_logits(
                convert.params_from_numpy(flat, device="cpu"), TCFG,
                torch.from_numpy(tokens), mesh=mesh, pp=2, microbatch=2)
        finally:
            mesh.close()
        assert out.get(timeout=60) is True  # stage 1 returns nothing
        proc.join(timeout=30)
        assert not proc.is_alive() and proc.exitcode == 0
    finally:
        if proc.is_alive():
            proc.kill()
        if dist.is_initialized():
            dist.destroy_process_group()
    assert got.shape == (4, 16, 512) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
    # and the one-device model's dense causal pass over the same block
    params = convert.params_from_numpy(flat, device="cpu")
    pool = torch.zeros((4, 2, 4 * 16 + 16, 2, 16))
    for b in range(4):
        x = tllama.prefill(params, TCFG, torch.from_numpy(tokens[b:b + 1]),
                           torch.tensor([16]), pool,
                           torch.arange(1, dtype=torch.int32)[None], 16)
        np.testing.assert_allclose(x[0][0].numpy(), got[b, -1].numpy(),
                                   rtol=0, atol=TOL)


def test_pipeline_refusals_are_the_references(weights):
    tp = convert.params_from_numpy(
        {k: np.asarray(v) for k, v in weights.items()}, device="cpu")
    with pytest.raises(ValueError, match="n_layers 4 not divisible by pp=3"):
        pipeline.stack_stage_params(tp, TCFG, 3)
    with pytest.raises(ValueError, match="n_layers 4 not divisible by pp=3"):
        jpipeline.stack_stage_params(weights, CFG, 3)
    stages = pipeline.stack_stage_params(tp, TCFG, 2)
    jstages = jpipeline.stack_stage_params(weights, CFG, 2)
    for k, v in stages.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(jstages[k]))
    import types

    mesh = types.SimpleNamespace(shape={"pp": 2})
    with pytest.raises(ValueError, match="batch 3 not divisible by "
                                         "microbatch 2"):
        pipeline.pipeline_logits(tp, TCFG,
                                 torch.zeros((3, 8), dtype=torch.int32),
                                 mesh=mesh, pp=2, microbatch=2)

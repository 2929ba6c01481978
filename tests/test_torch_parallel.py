"""The port's mesh, shardings and per-shard decode walk against the
reference's ``aigw_tpu/parallel`` on the virtual 8-device CPU mesh.

- ``llama_param_specs`` / ``mixtral_param_specs`` / ``kv_cache_spec``
  equal the reference's ``PartitionSpec`` entries, for Llama, Qwen-style
  (QKV bias, tied embeddings) and Mixtral configs;
- ``shard_params`` gives each rank exactly the shard the reference's
  engine places on the device at that mesh position (its ``spec_for``
  over ``jax.device_put``), for bf16, W8A16 and W4A16 weights, and the
  same bytes per device; an int4 row-parallel split inside a scale
  group raises;
- ``analytical_ici_bytes_per_token`` equals the reference's for several
  meshes and models;
- ``fused_paged_decode_shard`` run on each rank's head shard of a pool
  (RoPE, the append, the walk) gives, joined, the reference's
  ``paged_decode_walk_spmd`` over the pool after the same append, within
  float32 rounding, over float32 and int8 pools;
- the decode resolver's mesh rows name the reference's rungs;
- rank coordinates follow the reference's device grid, and the mesh's
  refusals (``sp``, ``dp``, a world too small).
"""

import dataclasses
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from aigw_tpu.models import llama as jllama
from aigw_tpu.models import mixtral as jmixtral
from aigw_tpu.models import quant as jquant
from aigw_tpu.ops.pallas import decode_fused as jdf
from aigw_tpu.parallel import MeshSpec as JMeshSpec
from aigw_tpu.parallel import make_mesh as jmake_mesh
from aigw_tpu.parallel import sharding as jsharding
from aigw_tpu.tpuserve import attention as jattention
from aigw_tpu.tpuserve import engine as jengine
from aigw_tpu_torch.models import convert, kvq
from aigw_tpu_torch.models import llama as tllama
from aigw_tpu_torch.models import mixtral as tmixtral
from aigw_tpu_torch.ops import decode_fused
from aigw_tpu_torch.parallel import mesh as tmesh
from aigw_tpu_torch.parallel import sharding as tsharding
from aigw_tpu_torch.tpuserve import attention as tattention
from aigw_tpu_torch.tpuserve import engine as tengine

#: head_dim 16, 4 query and 2 KV heads, an FFN of two int4 groups
J_CFG = jllama.LlamaConfig(vocab_size=512, dim=64, n_layers=2, n_heads=4,
                           n_kv_heads=2, ffn_dim=256, max_seq_len=256,
                           rope_theta=10000.0)
T_CFG = tllama.LlamaConfig(**dataclasses.asdict(J_CFG))
ENGINE = dict(max_batch_size=2, max_seq_len=64, page_size=16)


def _stub(spec: tmesh.MeshSpec, rank: int):
    """A rank's view of a mesh without a process group: what the
    sharding code reads (its shape and coordinates)."""
    coords = tmesh._coords(rank, spec)
    return types.SimpleNamespace(
        shape={a: getattr(spec, a) for a in tmesh.AXES},
        axis_index=lambda a: coords[a], rank=rank)


@pytest.mark.parametrize("name", ["llama", "qwen", "mixtral"])
def test_param_specs_are_the_references(name):
    if name == "mixtral":
        jcfg = jmixtral.TINY_MOE
        want = jsharding.mixtral_param_specs(jcfg)
        got = tsharding.mixtral_param_specs(tmixtral.TINY_MOE)
    else:
        tcfg = T_CFG if name == "llama" else tllama.TINY_QWEN
        jcfg = jllama.LlamaConfig(**dataclasses.asdict(tcfg))
        want = jsharding.llama_param_specs(jcfg)
        got = tsharding.llama_param_specs(tcfg)
    assert got == {k: tuple(v) for k, v in want.items()}
    assert tsharding.kv_cache_spec() == tuple(jsharding.kv_cache_spec())


def _reference_shards(jp, jcfg, spec: JMeshSpec):
    """The reference engine's placed params: per device (in mesh rank
    order) each leaf's shard, and its per-device bytes."""
    mesh = jmake_mesh(spec)
    eng = jengine.Engine(jp, jcfg, jengine.EngineConfig(**ENGINE),
                         mesh=mesh)
    devs = list(mesh.devices.flat)
    shards = [{} for _ in devs]
    for k, v in eng.params.items():
        for sh in v.addressable_shards:
            if sh.device in devs:
                shards[devs.index(sh.device)][k] = np.asarray(sh.data)
    return shards, eng.param_bytes_by_device


@pytest.mark.parametrize("mode", ["bf16", "int8", "int4"])
def test_shard_params_match_the_references_placement(mode):
    jp = jllama.init_params(jax.random.PRNGKey(0), J_CFG, dtype=jnp.bfloat16)
    if mode != "bf16":
        jp = jquant.quantize_params(jp, mode=mode)
    tp = convert.params_from_numpy({k: np.asarray(v) for k, v in jp.items()},
                                   device="cpu")
    spec = JMeshSpec(tp=2)
    want, want_bytes = _reference_shards(jp, J_CFG, spec)
    for rank in range(2):
        got = tsharding.shard_params(
            tp, T_CFG, _stub(tmesh.MeshSpec(tp=2), rank))
        assert set(got) == set(want[rank])
        for k, t in list(got.items()):
            w = want[rank][k]
            if t.dtype == torch.uint8 and k.endswith(".q"):  # int4
                t = kvq.unpack_int4(t, dim=-2)
                w = w.astype(np.int8)
            np.testing.assert_array_equal(
                t.float().numpy() if t.dtype == torch.bfloat16
                else t.numpy(), w.astype(np.float32)
                if t.dtype == torch.bfloat16 else w, err_msg=k)
        # per-device bytes: jax counts an int4 element as one byte
        # (``nbytes`` of an int4 array), the port's packed shard holds
        # two a byte
        nbytes = sum(v.numel() * v.element_size()
                     * (2 if k.endswith(".q") and v.dtype == torch.uint8
                        else 1) for k, v in got.items())
        assert nbytes == want_bytes[list(want_bytes)[rank]]


def test_int4_split_inside_a_scale_group_raises():
    cfg = dataclasses.replace(J_CFG, ffn_dim=384)  # 3 groups of 128
    jp = jquant.quantize_params(
        jllama.init_params(jax.random.PRNGKey(0), cfg, dtype=jnp.bfloat16),
        mode="int4")
    tp = convert.params_from_numpy({k: np.asarray(v) for k, v in jp.items()},
                                   device="cpu")
    with pytest.raises(ValueError, match="whole groups"):
        tsharding.shard_params(tp, dataclasses.replace(T_CFG, ffn_dim=384),
                               _stub(tmesh.MeshSpec(tp=2), 0))


@pytest.mark.parametrize("shape", [
    {}, {"tp": 1}, {"tp": 2}, {"tp": 4}, {"tp": 8}, {"tp": 2, "ep": 2},
    {"ep": 2}])
@pytest.mark.parametrize("model", ["llama-3-8b", "mixtral-8x7b", "tiny"])
def test_analytical_ici_bytes_are_the_references(shape, model):
    jcfg, tcfg = {"llama-3-8b": (jllama.LLAMA3_8B, tllama.LLAMA3_8B),
                  "mixtral-8x7b": (jmixtral.MIXTRAL_8X7B,
                                   tmixtral.MIXTRAL_8X7B),
                  "tiny": (jllama.TINY, tllama.TINY)}[model]
    mesh = None if not shape else types.SimpleNamespace(
        shape={a: shape.get(a, 1) for a in tmesh.AXES})
    for nbytes in (1, 2, 4):
        assert tsharding.analytical_ici_bytes_per_token(
            tcfg, mesh, nbytes) == jsharding.analytical_ici_bytes_per_token(
                jcfg, mesh, nbytes)


@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
def test_shard_decode_walk_matches_paged_decode_walk_spmd(kv_dtype):
    """Each rank's fused decode over its head shard (plain version: RoPE,
    the append, the walk), joined over the ranks, against the
    reference's ``paged_decode_walk_spmd`` on a tp=2 mesh over the pool
    after the same append."""
    rng = np.random.default_rng(3)
    B, H, Hkv, D, ps, P = 3, 4, 2, 16, 16, 3
    n = (B * P + 1) * ps
    theta = 10000.0
    q = rng.standard_normal((B, H, D), np.float32)
    k_new = rng.standard_normal((B, Hkv, D), np.float32)
    v_new = rng.standard_normal((B, Hkv, D), np.float32)
    k0 = rng.standard_normal((n, Hkv, D), np.float32)
    v0 = rng.standard_normal((n, Hkv, D), np.float32)
    pt = np.arange(B * P, dtype=np.int32).reshape(B, P)
    pos = np.array([5, 20, 40], np.int32)
    active = np.array([True, True, False])
    # the reference: RoPE, the rows appended where the fused kernel
    # appends them (inactive slots write nothing the walk reads), the
    # walk over each device's local heads
    qr = np.asarray(jllama.rope(jnp.asarray(q)[:, None],
                                jnp.asarray(pos)[:, None], theta))[:, 0]
    kr = np.asarray(jllama.rope(jnp.asarray(k_new)[:, None],
                                jnp.asarray(pos)[:, None], theta))[:, 0]
    slot = pt[np.arange(B), pos // ps] * ps + pos % ps
    kj, vj = k0.copy(), v0.copy()
    ks = vs = None
    if kv_dtype == "int8":
        # a pool of int8 rows and their scales, written as the kernel
        # writes them
        def quant(x):
            q8, s = kvq.quantize_rows(torch.from_numpy(x), "int8")
            return q8.numpy(), s.numpy()
        kj, ks = quant(k0)
        vj, vs = quant(v0)
        for i in np.flatnonzero(active):
            kj[slot[i]], ks[slot[i]] = quant(kr[i])
            vj[slot[i]], vs[slot[i]] = quant(v_new[i])
    else:
        for i in np.flatnonzero(active):
            kj[slot[i]], vj[slot[i]] = kr[i], v_new[i]
    lengths = np.where(active, pos + 1, 0).astype(np.int32)
    want = np.asarray(jdf.paged_decode_walk_spmd(
        jnp.asarray(qr), jnp.asarray(kj), jnp.asarray(vj), jnp.asarray(pt),
        jnp.asarray(lengths), mesh=jmake_mesh(JMeshSpec(tp=2)),
        page_size=ps, k_scale=None if ks is None else jnp.asarray(ks),
        v_scale=None if vs is None else jnp.asarray(vs)))
    spec = tmesh.MeshSpec(tp=2)
    outs = []
    for rank in range(2):
        hq, hk = slice(rank * 2, rank * 2 + 2), slice(rank, rank + 1)
        if kv_dtype == "int8":
            pools = [torch.from_numpy(kvq.quantize_rows(
                torch.from_numpy(x[:, hk]), "int8")[i].numpy().copy())
                for x in (k0, v0) for i in (0, 1)]
            kp, kps, vp, vps = pools
        else:
            kp = torch.from_numpy(k0[:, hk].copy())
            vp = torch.from_numpy(v0[:, hk].copy())
            kps = vps = None
        res = decode_fused.fused_paged_decode_shard(
            torch.from_numpy(q[:, hq].copy()),
            torch.from_numpy(k_new[:, hk].copy()),
            torch.from_numpy(v_new[:, hk].copy()), kp, vp,
            torch.from_numpy(pt), torch.from_numpy(pos),
            torch.from_numpy(active), kps, vps,
            step=decode_fused.fused_paged_decode_plain,
            mesh=_stub(spec, rank), n_heads=H, n_kv_heads=Hkv,
            rope_theta=theta, page_size=ps)
        outs.append(res[0].numpy())
        rows = res[1].numpy()[slot[active]]
        ref_rows = kj[slot[active]][:, hk]
        if kv_dtype == "int8":
            assert np.abs(rows.astype(int) - ref_rows.astype(int)).max() <= 1
        else:
            np.testing.assert_allclose(rows, ref_rows, rtol=0, atol=2e-6)
    got = np.concatenate(outs, axis=1)
    np.testing.assert_allclose(got[active], want[active], rtol=0, atol=2e-5)
    assert not got[~active].any()  # a slot that attends nothing is zero
    with pytest.raises(ValueError, match="not one of tp=2 shards"):
        decode_fused.fused_paged_decode_shard(
            torch.from_numpy(q), torch.from_numpy(k_new),
            torch.from_numpy(v_new), torch.from_numpy(k0),
            torch.from_numpy(v0), torch.from_numpy(pt),
            torch.from_numpy(pos), torch.from_numpy(active),
            step=decode_fused.fused_paged_decode_plain,
            mesh=_stub(spec, 0), n_heads=H, n_kv_heads=Hkv,
            rope_theta=theta, page_size=ps)


@pytest.mark.parametrize("kw", [
    dict(decode_backend="fused"), dict(decode_backend="auto"),
    dict(decode_backend="auto", pallas_attn=True),
    dict(decode_backend="auto", pallas_attn=True, kv_cache_dtype="int8"),
    dict(decode_backend="fused", kv_cache_dtype="int4")])
@pytest.mark.parametrize("tp", [2, 4])
def test_decode_resolver_mesh_rows_are_the_references(kw, tp):
    """fused-xla-spmd ↔ fused-*, xla-gather ↔ gather-* (at tp=4 the
    tiny model's 2 KV heads do not divide: the narrowed row)."""
    jimpl, jwhy = jattention.resolve_decode_backend(
        jengine.EngineConfig(**ENGINE, **kw), jllama.TINY,
        jmake_mesh(JMeshSpec(tp=tp)))
    timpl, twhy = tattention.resolve_decode_backend(
        tengine.EngineConfig(**ENGINE, **kw), torch.device("cpu"),
        tllama.TINY, _stub(tmesh.MeshSpec(tp=tp), 0))
    assert {"fused-xla-spmd": "fused", "xla-gather": "gather"}[jimpl] \
        == timpl.split("-")[0]
    if jimpl == "xla-gather" and "narrowed" in jwhy:
        assert "narrowed" in twhy and f"tp={tp}" in twhy


def test_rank_coordinates_follow_the_references_device_grid():
    for spec in (JMeshSpec(tp=2), JMeshSpec(tp=2, ep=2), JMeshSpec(ep=4),
                 JMeshSpec(pp=2), JMeshSpec(tp=4, ep=2), JMeshSpec(sp=2),
                 JMeshSpec(tp=2, sp=2, ep=2)):
        mesh = jmake_mesh(spec)
        grid = mesh.devices
        devs = list(grid.flat)
        tspec = tmesh.MeshSpec(**dataclasses.asdict(spec))
        for r, d in enumerate(devs):
            idx = np.argwhere(grid == d)[0]
            assert tmesh._coords(r, tspec) == dict(zip(tmesh.AXES,
                                                       map(int, idx)))


def test_mesh_refusals(tmp_path):
    # sp is accepted up to the process group
    with pytest.raises(ValueError, match="no process group"):
        tmesh.make_mesh(tmesh.MeshSpec(sp=2), device="cpu")
    with pytest.raises(NotImplementedError, match="dp=2"):
        tmesh.make_mesh(tmesh.MeshSpec(dp=2), device="cpu")
    try:
        with pytest.raises(ValueError, match=re.escape(
                "needs 2 devices, have 1")):
            tmesh.make_mesh(tmesh.MeshSpec(tp=2), device="cpu", rank=0,
                            world_size=1,
                            init_method=f"file://{tmp_path / 'rdv'}",
                            timeout_s=30)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()

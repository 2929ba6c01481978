"""The sequence-parallel attention and prefills (``ops/ring_attention.py``,
``prefill_sp`` / ``prefill_sp_suffix`` of both families) against the
reference's on the virtual 8-device CPU mesh.

Each rank's computation is held two ways. In one process: the local
functions (``_ring_attention_local``, ``_ring_prefix_attention_local``,
``_ulysses_attention_local``) run with ``mesh=None`` for every rank
``idx`` of ``n`` over every rank's blocks, at ``sp`` 2 and 4, and the
ranks' rows, concatenated, equal the reference's ``ring_attention`` /
``ring_attention_prefix`` over an ``sp`` mesh of the same size within
its own tolerance (2e-4). Over two processes: this test process is rank
0 of a ``MeshSpec(sp=2)`` mesh over gloo and a follower process,
started once for the module (``file://`` rendezvous), rank 1; every case
sends the follower the function and inputs it runs (``follower.send``),
both ranks run it, and the ranks' results are gathered over ``sp``.

The model functions run on the reference's ``init_params(PRNGKey(0),
cfg, float32)`` weights carried across by ``models/convert.py`` over a
float32 pool: logits within ``LOGIT_TOL`` of the reference's ``sp = 2``
functions, the pool rows written within ``POOL_TOL`` of the reference's
and byte-equal on both ranks. Mixtral's routing counts equal the
reference's exactly, in a case whose global capacity fence drops
assignments that a fence over each rank's rows alone would keep.
"""

import dataclasses
import multiprocessing as mp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aigw_tpu.models import llama as jllama
from aigw_tpu.models import lora as jlora
from aigw_tpu.models import mixtral as jmixtral
from aigw_tpu.ops import ring_attention as jring
from aigw_tpu.parallel import MeshSpec as JMeshSpec
from aigw_tpu.parallel import make_mesh as jmake_mesh
from aigw_tpu_torch.models import convert, kvq
from aigw_tpu_torch.models import llama as tllama
from aigw_tpu_torch.models import mixtral as tmixtral
from aigw_tpu_torch.models.registry import family_fns
from aigw_tpu_torch.ops import ring_attention as tring
from aigw_tpu_torch.parallel import MeshSpec, make_mesh
from aigw_tpu_torch.tpuserve import follower

#: the reference's own tolerance for ring attention
ATTN_TOL = 2e-4
#: float32 logits of two frameworks' matmuls (the port's model tests')
LOGIT_TOL = 1e-4
#: float32 K/V rows written into the pool
POOL_TOL = 1e-5
PS = 8
CPU = torch.device("cpu")
#: a capacity at which the tiny MoE model's fence drops assignments
MOE_CF = 0.5


# -- the two-rank harness ----------------------------------------------------
def _worker(init: str) -> None:
    """Rank 1: run every function the leader sends, until it exits."""
    mesh = make_mesh(MeshSpec(sp=2), device="cpu", rank=1, world_size=2,
                     init_method=init, timeout_s=120)
    try:
        while True:
            op, args = follower.recv(mesh)
            if op == "exit":
                return
            globals()[op](mesh, *args)
    finally:
        mesh.close()


@pytest.fixture(scope="module")
def mesh(tmp_path_factory):
    init = f"file://{tmp_path_factory.mktemp('rdv') / 'init'}"
    ctx = mp.get_context("spawn")
    proc = ctx.Process(target=_worker, args=(init,), daemon=True)
    proc.start()
    m = make_mesh(MeshSpec(sp=2), device="cpu", rank=0, world_size=2,
                  init_method=init, timeout_s=120)
    yield m
    try:
        follower.send(m, "exit")
    finally:
        proc.join(timeout=30)
        if proc.is_alive():
            proc.kill()
        m.close()


def _both(mesh, name: str, *args):
    """Run ``name(mesh, *args)`` on both ranks; rank 0's result."""
    follower.send(mesh, name, *args)
    return globals()[name](mesh, *args)


def _shard(x: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's rows (dim 1) of a chunk sharded over ``sp``."""
    n, r = mesh.shape["sp"], mesh.axis_index("sp")
    w = x.shape[1] // n
    return x[:, r * w:(r + 1) * w]


def _ring_call(mesh, q, k, v, causal, strategy):
    out = tring.ring_attention(_shard(q, mesh), _shard(k, mesh),
                               _shard(v, mesh), mesh=mesh, causal=causal,
                               strategy=strategy)
    return mesh.all_gather_last(out, "sp", dim=1)


def _prefix_call(mesh, q, k, v, kc, vc, prefix_lens):
    out = tring.ring_attention_prefix(
        _shard(q, mesh), _shard(k, mesh), _shard(v, mesh), kc, vc,
        prefix_lens, mesh=mesh)
    return mesh.all_gather_last(out, "sp", dim=1)


def _model_call(mesh, family, name, params, cfg, args, pool, kw):
    """One sequence-parallel entry point on this rank, its pool a copy
    of ``pool``; returns (the entry point's outputs, every rank's pool
    stacked ``[sp, ...]``)."""
    pool = pool.clone()
    fn = getattr(family_fns(family), name)
    out = fn(params, cfg, *args[:-1], pool, args[-1], PS, mesh=mesh, **kw)
    return out, tring.gather_blocks(pool, mesh)


# -- inputs --------------------------------------------------------------------
def _qkv(seed, B, S, H, Hkv, D, T=0):
    rng = np.random.default_rng(seed)
    shapes = [(B, S, H, D), (B, S, Hkv, D), (B, S, Hkv, D)]
    if T:
        shapes += [(B, T, Hkv, D), (B, T, Hkv, D)]
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _blocks(x: np.ndarray, n: int) -> torch.Tensor:
    """``[B, S, ...]`` → every rank's rows stacked ``[n, B, S/n, ...]``."""
    t = torch.from_numpy(x)
    return torch.stack(t.chunk(n, dim=1))


# -- (i) attention ---------------------------------------------------------------
@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("causal", [True, False])
def test_ring_local_matches_reference(n, causal):
    q, k, v = _qkv(1, 2, 32, 4, 2, 16)
    want = np.asarray(jring.ring_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        mesh=jmake_mesh(JMeshSpec(sp=n)), causal=causal))
    qb, kb, vb = (_blocks(x, n) for x in (q, k, v))
    got = torch.cat([tring._ring_attention_local(
        qb[r], kb, vb, idx=r, n=n, causal=causal) for r in range(n)], 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=ATTN_TOL,
                               atol=ATTN_TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_ulysses_local_matches_reference(causal):
    q, k, v = _qkv(2, 2, 32, 4, 2, 16)
    want = np.asarray(jring.ring_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        mesh=jmake_mesh(JMeshSpec(sp=2)), causal=causal,
        strategy="ulysses"))
    qb, kb, vb = (_blocks(x, 2) for x in (q, k, v))
    got = torch.cat([tring._ulysses_attention_local(
        qb, kb, vb, idx=r, n=2, causal=causal) for r in range(2)], 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=ATTN_TOL,
                               atol=ATTN_TOL)
    with pytest.raises(ValueError, match="divisible"):
        tring._ulysses_attention_local(qb, kb[..., :1, :], vb[..., :1, :],
                                       idx=0, n=2)


@pytest.mark.parametrize("strategy", ["ring", "ulysses"])
def test_ring_attention_over_two_ranks(mesh, strategy):
    """The module entry point on each rank's shard over gloo: the
    blocks gathered (ring) or the heads exchanged all-to-all
    (Ulysses)."""
    q, k, v = _qkv(3, 2, 32, 4, 2, 16)
    for causal in (True, False):
        want = np.asarray(jring.ring_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            mesh=jmake_mesh(JMeshSpec(sp=2)), causal=causal,
            strategy=strategy))
        got = _both(mesh, "_ring_call", *map(torch.from_numpy, (q, k, v)),
                    causal, strategy)
        np.testing.assert_allclose(got.numpy(), want, rtol=ATTN_TOL,
                                   atol=ATTN_TOL)


# -- (ii) the prefix pass --------------------------------------------------------
@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("prefix_lens", [(24, 0), (8, 40)])
def test_ring_prefix_local_matches_reference(n, prefix_lens):
    """Page-aligned offsets that are not multiples of a rank's window
    block (T / n) or of the chunk; a zero offset's window adds
    nothing."""
    q, k, v, kc, vc = _qkv(4, 2, 32, 4, 2, 16, T=64)
    pl = np.asarray(prefix_lens, np.int32)
    want = np.asarray(jring.ring_attention_prefix(
        *map(jnp.asarray, (q, k, v, kc, vc)), jnp.asarray(pl),
        mesh=jmake_mesh(JMeshSpec(sp=n))))
    qb, kb, vb = (_blocks(x, n) for x in (q, k, v))
    got = torch.cat([tring._ring_prefix_attention_local(
        qb[r], kb, vb, torch.from_numpy(kc), torch.from_numpy(vc),
        torch.from_numpy(pl), idx=r, n=n) for r in range(n)], 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=ATTN_TOL,
                               atol=ATTN_TOL)


def test_ring_prefix_over_two_ranks(mesh):
    q, k, v, kc, vc = _qkv(5, 2, 32, 4, 2, 16, T=64)
    pl = np.asarray((16, 0), np.int32)
    want = np.asarray(jring.ring_attention_prefix(
        *map(jnp.asarray, (q, k, v, kc, vc)), jnp.asarray(pl),
        mesh=jmake_mesh(JMeshSpec(sp=2))))
    got = _both(mesh, "_prefix_call",
                *map(torch.from_numpy, (q, k, v, kc, vc, pl)))
    np.testing.assert_allclose(got.numpy(), want, rtol=ATTN_TOL,
                               atol=ATTN_TOL)


# -- (iii) the model functions ----------------------------------------------------
def _family(family: str, cf: float = 0.0):
    """(the reference's module, its config, the port's config); a
    Mixtral capacity factor ``cf`` replaces the default."""
    if family == "llama":
        return jllama, jllama.TINY, tllama.TINY
    jcfg, tcfg = jmixtral.TINY_MOE, tmixtral.TINY_MOE
    if cf:
        jcfg = dataclasses.replace(jcfg, capacity_factor=cf)
        tcfg = dataclasses.replace(tcfg, capacity_factor=cf)
    return jmixtral, jcfg, tcfg


_PARAMS: dict = {}


def _params(family: str):
    """The reference's float32 weights (once per family) and the port's
    copy."""
    if family not in _PARAMS:
        jmod, jcfg, _tcfg = _family(family)
        jp = jmod.init_params(jax.random.PRNGKey(0), jcfg,
                              dtype=jnp.float32)
        _PARAMS[family] = (jp, convert.params_from_numpy(
            {k: np.asarray(v) for k, v in jp.items()}, device="cpu"))
    return _PARAMS[family]


def _pool(cfg, n_pages: int, seed: int):
    """A float32 pool of random rows (a cached prefix to resume over),
    the reference's and the port's."""
    shape = (cfg.n_layers, 2, (n_pages + 1) * PS, cfg.n_kv_heads,
             cfg.head_dim)
    rows = np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)
    return jnp.asarray(rows), torch.from_numpy(rows)


def _check_pools(jpool, tpools, written):
    """Rows ``written`` (flat slots) within POOL_TOL of the reference's;
    the ranks' pools byte for byte equal (the dump page aside)."""
    j = np.asarray(jpool)
    t0, t1 = tpools[0].numpy(), tpools[1].numpy()
    live = slice(0, j.shape[2] - PS)
    np.testing.assert_array_equal(t0[:, :, live], t1[:, :, live])
    np.testing.assert_allclose(t0[:, :, written], j[:, :, written],
                               rtol=0, atol=POOL_TOL)
    untouched = np.setdiff1d(np.arange(j.shape[2] - PS), written)
    np.testing.assert_array_equal(t0[:, :, untouched], j[:, :, untouched])


def _lora(jcfg):
    cfg = jlora.LoRAConfig(rank=4, alpha=8.0,
                           targets=("wq", "wv", "wo", "w_down"))
    j = jlora.init_lora_adapters(jax.random.PRNGKey(7), jcfg, cfg, 2,
                                 dtype=jnp.float32, random_b=True)
    return j, convert.adapters_from_numpy(
        {k: np.asarray(v) for k, v in j.items()}, torch.float32, "cpu")


@pytest.mark.parametrize("family,case", [
    ("llama", "plain"), ("llama", "lora"), ("mixtral", "plain"),
    ("mixtral", "drops")])
def test_prefill_sp_matches_reference(mesh, family, case):
    """Two sequences right-padded to a 32-row chunk (lengths 29 and 11):
    the logits at each one's last row (owned by rank 1 and rank 0) and
    the rows written; with adapters on every target kind; Mixtral's
    routing counts over the whole chunk, padding included."""
    jmod, jcfg, tcfg = _family(family, MOE_CF if case == "drops" else 0)
    jp, tp = _params(family)
    B, S = 2, 32
    rng = np.random.default_rng(11)
    tokens = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    seq_lens = np.asarray([29, 11], np.int32)
    pt = np.asarray([[0, 1, 2, 3], [4, 5, 6, 7]], np.int32)
    jpool, tpool = _pool(jcfg, 8, seed=1)
    jkw: dict = {}
    tkw: dict = {}
    if family == "mixtral":
        jkw["moe_stats"] = tkw["moe_stats"] = True
    if case == "lora":
        jst, tst = _lora(jcfg)
        rows = np.asarray([1, 0], np.int32)
        jkw.update(lora=jst, adapter_idx=jnp.asarray(rows))
        tkw.update(lora=tst, adapter_idx=torch.from_numpy(rows))
    want = jmod.prefill_sp(jp, jcfg, jnp.asarray(tokens),
                           jnp.asarray(seq_lens), jpool, jnp.asarray(pt),
                           PS, mesh=jmake_mesh(JMeshSpec(sp=2)), **jkw)
    got, pools = _both(mesh, "_model_call", family, "prefill_sp", tp, tcfg,
                       tuple(map(torch.from_numpy, (tokens, seq_lens, pt))),
                       tpool, tkw)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=0, atol=LOGIT_TOL)
    written = np.concatenate([pt[b, :].repeat(PS) * PS
                              + np.tile(np.arange(PS), 4)
                              for b in range(B)])
    written = np.concatenate([written[:seq_lens[0]],
                              written[S:S + seq_lens[1]]])
    _check_pools(want[1], pools, written)
    if family == "mixtral":
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
        if case == "drops":
            assert int(np.asarray(want[2])[:, -1].sum()) > 0


def _moe_call(mesh, tp, tcfg, h):
    """Layer 0's MoE over this rank's rows of ``h`` as a
    sequence-parallel chunk: (every rank's output rows, the counts
    summed over ``sp``)."""
    stats: list = []
    out = tmixtral.moe_mlp(tp, 0, _shard(h, mesh), tcfg, stats, mesh,
                           sp=True)
    return (mesh.all_gather_last(out, "sp", dim=1),
            mesh.all_reduce(stats[0], "sp"))


def test_moe_fence_is_the_global_one(mesh):
    """Each rank routes its half of two sequences' rows; the capacity
    and every position inside an expert are the whole chunk's, so the
    counts equal one fence over all rows exactly (and the outputs within
    float32 rounding: a rank's buffer holds only its rows), where a
    fence over each half alone keeps and drops other assignments."""
    _jmod, _jcfg, tcfg = _family("mixtral", MOE_CF)
    _jp, tp = _params("mixtral")
    h = torch.from_numpy(np.random.default_rng(13).standard_normal(
        (2, 32, tcfg.dim)).astype(np.float32))
    stats: list = []
    want = tmixtral.moe_mlp(tp, 0, h, tcfg, stats)
    got, counts = _both(mesh, "_moe_call", tp, tcfg, h)
    np.testing.assert_array_equal(counts.numpy(), stats[0].numpy())
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=1e-5)
    assert int(stats[0][-1]) > 0  # the fence binds
    # fenced alone, the halves keep assignments the chunk's fence drops
    # (and drop others): their rows come out otherwise
    alone = torch.cat([tmixtral.moe_mlp(tp, 0, half, tcfg)
                       for half in h.chunk(2, dim=1)], dim=1)
    assert (alone - want).abs().amax() > 1e-2


@pytest.mark.parametrize("family", ["llama", "mixtral"])
def test_prefill_sp_suffix_matches_reference(mesh, family):
    """A 16-row chunk over a random cached window of 4 pages (32 rows),
    resuming at page-aligned offsets that are not multiples of a rank's
    window block (16): 8 and 0 (the window masked out whole)."""
    jmod, jcfg, tcfg = _family(family)
    jp, tp = _params(family)
    B, S = 2, 16
    rng = np.random.default_rng(12)
    tokens = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    prefix = np.asarray([8, 0], np.int32)
    seq_lens = np.asarray([8 + 13, 16], np.int32)
    pt = np.asarray([[2, 0, 5, 7], [1, 3, 4, 6]], np.int32)
    jpool, tpool = _pool(jcfg, 8, seed=2)
    kw = {"moe_stats": True} if family == "mixtral" else {}
    want = jmod.prefill_sp_suffix(
        jp, jcfg, jnp.asarray(tokens), jnp.asarray(prefix),
        jnp.asarray(seq_lens), jpool, jnp.asarray(pt), PS,
        mesh=jmake_mesh(JMeshSpec(sp=2)), **kw)
    got, pools = _both(
        mesh, "_model_call", family, "prefill_sp_suffix", tp, tcfg,
        tuple(map(torch.from_numpy, (tokens, prefix, seq_lens, pt))),
        tpool, kw)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=0, atol=LOGIT_TOL)
    written = []
    for b in range(B):
        for t in range(int(prefix[b]), int(seq_lens[b])):
            written.append(int(pt[b, t // PS]) * PS + t % PS)
    _check_pools(want[1], pools, np.asarray(written))
    if family == "mixtral":
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


def test_chunk_must_divide_over_sp(mesh):
    _jp, tp = _params("llama")
    pool = kvq.make_pool((2, 2, 9 * PS, 2, 16), "float32", CPU)
    with pytest.raises(ValueError, match="does not divide over sp=2"):
        tllama.prefill_sp(tp, tllama.TINY,
                          torch.zeros((1, 7), dtype=torch.int32),
                          torch.ones((1,), dtype=torch.int32), pool,
                          torch.zeros((1, 4), dtype=torch.int32), PS,
                          mesh=mesh)

"""The port's model layers, ViT paths, KV pool reuse and weight bridge
against the JAX package's, with the same weights and numpy inputs.

Tolerances: f32 math 1e-5; bf16 outputs of one attention block 3e-2
(one bf16 rounding step of O(1) values); ViT tokens after two layers and
the projector 5e-2 of the output scale (bf16 matmuls whose rounding
points differ between the frameworks).  Slab writes and the weight
bridge are exact.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import ModelCfg, ViTCfg  # noqa: E402
from repro.configs.registry import get_config as j_get_config  # noqa: E402
from repro.core import kv_pool as jkv_pool  # noqa: E402
from repro.core import pruning as jpruning  # noqa: E402
from repro.core.kvc import WindowLayout as JWindowLayout  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.models import vit as jvit  # noqa: E402
from repro.models.init import ParamBuilder, split_tree  # noqa: E402
from repro.training import checkpoint  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ModelCfg as TModelCfg  # noqa: E402
from repro_torch.configs.base import ViTCfg as TViTCfg  # noqa: E402
from repro_torch.core import kv_pool, pruning  # noqa: E402
from repro_torch.core.kvc import WindowLayout  # noqa: E402
from repro_torch.models import layers, transformer, vit  # noqa: E402
from repro_torch.models.init import (  # noqa: E402
    from_numpy_tree, init_lm_params, init_vit_params, load_npz_params, to_tensor,
)
from torch_threads import torch_one_thread  # noqa: E402,F401

LM = dict(name="tiny-vlm", family="vlm", n_layers=2, d_model=64, n_heads=4, n_kv=2,
          d_ff=128, vocab=64, tied_embeddings=True)
VIT = dict(n_layers=2, d_model=128, n_heads=4, d_ff=256, patch=14, image=112, group=2)


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def f32(a):
    return a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)


def close(a, b, tol):
    a, b = f32(a), f32(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    err = float(np.abs(a - b).max())
    assert err <= tol, err


@pytest.fixture(scope="module")
def attn():
    cfg, tcfg = ModelCfg(**LM), TModelCfg(**LM)
    pb = ParamBuilder(jax.random.PRNGKey(0))
    jp, _ = split_tree(jlayers.init_attention(pb, cfg))
    return cfg, tcfg, jp, from_numpy_tree(np_tree(jp))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_matches_jax(dtype):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 7, 64)).astype(np.float32)
    scale = rng.normal(size=(64,)).astype(np.float32)
    xj = jnp.asarray(x).astype(dtype)
    xt = to_tensor(np.asarray(xj))
    out_j = jlayers.rmsnorm({"scale": jnp.asarray(scale)}, xj)
    out_t = layers.rmsnorm({"scale": torch.from_numpy(scale)}, xt)
    assert out_t.dtype == xt.dtype
    close(out_t, out_j, 1e-5 if dtype == "float32" else 1e-2)


@pytest.mark.parametrize("tied", [True, False])
def test_lm_logits_keep_the_f32_head_product(tied):
    """The head product's f32 result, as the jitted JAX ``lm_logits``
    gives it.  Operands are multiples of 1/8 below 2 in magnitude, so
    every partial sum is exact in f32 and any summation order gives the
    same value: the f32 product, bitwise.  Rounded to bf16 it differs,
    so the check tells the two apart.  The vocab spans several of the
    CPU path's column chunks."""
    rng = np.random.default_rng(21)
    d, vocab = 64, 2 * transformer.HEAD_CHUNK + 300
    cfg = ModelCfg(**{**LM, "vocab": vocab, "tied_embeddings": tied})
    tcfg = TModelCfg(**{**LM, "vocab": vocab, "tied_embeddings": tied})
    h = (rng.integers(-15, 16, (3, d)) / 8).astype(np.float32)
    w = (rng.integers(-15, 16, (vocab, d) if tied else (d, vocab)) / 8).astype(np.float32)
    name = "embed" if tied else "lm_head"
    jp = {name: jnp.asarray(w, jnp.bfloat16)}
    tp = {name: torch.from_numpy(w).bfloat16()}
    exact = h.astype(np.float64) @ (w.T if tied else w).astype(np.float64)
    out_j = jax.jit(lambda p, x: jtfm.lm_logits(cfg, p, x))(jp, jnp.asarray(h, jnp.bfloat16))
    out_t = transformer.lm_logits(tcfg, tp, torch.from_numpy(h).bfloat16())
    assert out_t.dtype == torch.float32 and out_j.dtype == jnp.float32
    np.testing.assert_array_equal(np.asarray(out_j), exact.astype(np.float32))
    np.testing.assert_array_equal(out_t.numpy(), exact.astype(np.float32))
    rounded = torch.from_numpy(exact.astype(np.float32)).bfloat16().float().numpy()
    assert np.abs(rounded - exact).max() > 0


def _slab_case(cfg, n_streams=2, pages_per=2, seed=3):
    rng = np.random.default_rng(seed)
    total = n_streams * pages_per + 1
    shape = (total * 128, cfg.n_kv, cfg.d_head)
    k = jnp.asarray(rng.normal(size=shape).astype(np.float32)).astype(jnp.bfloat16)
    v = jnp.asarray(rng.normal(size=shape).astype(np.float32)).astype(jnp.bfloat16)
    pt = rng.permutation(total)[: n_streams * pages_per].reshape(n_streams, pages_per)
    return k, v, pt.astype(np.int32)


@pytest.mark.parametrize("mode", ["fresh", "scatter", "decode"])
def test_attention_block_paged_matches_jax(attn, mode):
    cfg, tcfg, jp, tp = attn
    k, v, pt = _slab_case(cfg)
    S = pt.shape[1] * 128
    rng = np.random.default_rng(7)
    if mode == "fresh":
        idx = np.arange(200, dtype=np.int32)
    elif mode == "scatter":
        idx = np.concatenate([np.arange(0, 16), np.arange(120, 180)]).astype(np.int32)
    else:
        idx = np.asarray([201], np.int32)
    T = len(idx)
    x = jnp.asarray(rng.normal(size=(2, T, cfg.d_model)).astype(np.float32)).astype(jnp.bfloat16)
    pos = np.broadcast_to(idx[None], (2, T)).astype(np.int32)
    kvv = rng.random((2, S)) < 0.7
    kw_j = dict(cache=jlayers.KVCache(k, v), cache_len=S, page_table=jnp.asarray(pt),
                page_size=128)
    kw_t = dict(cache=layers.KVCache(to_tensor(np.asarray(k)), to_tensor(np.asarray(v))),
                cache_len=S, page_table=torch.from_numpy(pt), page_size=128)
    if mode == "decode":
        kw_j.update(cache_offset=jnp.asarray(int(idx[0]), jnp.int32))
        kw_t.update(cache_offset=int(idx[0]))
    else:
        kw_j.update(scatter_idx=jnp.asarray(idx), kv_valid=jnp.asarray(kvv))
        kw_t.update(scatter_idx=torch.from_numpy(idx), kv_valid=torch.from_numpy(kvv))
    out_j, cache_j = jlayers.attention_block(jp, cfg, x, jnp.asarray(pos), None, **kw_j)
    out_t, cache_t = layers.attention_block(tp, tcfg, to_tensor(np.asarray(x)),
                                            torch.from_numpy(pos), None, **kw_t)
    close(out_t, out_j, 3e-2)
    # the slab is updated in place with the same K/V rows
    close(kw_t["cache"].k, cache_j.k, 3e-2)
    close(kw_t["cache"].v, cache_j.v, 3e-2)
    assert cache_t.k is kw_t["cache"].k


def test_reuse_pool_caches_matches_jax():
    cfg, tcfg = ModelCfg(**LM), TModelCfg(**LM)
    lay_j, lay_t = JWindowLayout(8, 4, 4, 16, 8, 8), WindowLayout(8, 4, 4, 16, 8, 8)
    rng = np.random.default_rng(9)
    R, P = cfg.repeats, 3 * 128
    shape = (R, P, cfg.n_kv, cfg.d_head)
    k = rng.normal(size=shape).astype(np.float32)
    v = rng.normal(size=shape).astype(np.float32)
    pt = np.asarray([[2], [0]], np.int32)
    kj = jnp.asarray(k).astype(jnp.bfloat16)
    vj = jnp.asarray(v).astype(jnp.bfloat16)
    out_j = jkv_pool.reuse_pool_caches(
        cfg, jtfm.Caches((jlayers.KVCache(kj, vj),), None), jnp.asarray(pt), lay_j)
    slab = transformer.Caches((layers.KVCache(to_tensor(np.asarray(kj)),
                                              to_tensor(np.asarray(vj))),), None)
    out_t = kv_pool.reuse_pool_caches(tcfg, slab, torch.from_numpy(pt), lay_t)
    assert out_t is slab
    close(slab.blocks[0].k, out_j.blocks[0].k, 2e-2)
    np.testing.assert_array_equal(f32(slab.blocks[0].v), f32(out_j.blocks[0].v))
    # the page no stream owns is untouched
    np.testing.assert_array_equal(f32(slab.blocks[0].k)[:, 128:256], f32(kj)[:, 128:256])


def test_kv_pool_lifo_free_list_and_bytes():
    tcfg = TModelCfg(**LM)
    pool = kv_pool.KVPool(tcfg, 6)
    a = pool.admit_streams(2, 2)
    np.testing.assert_array_equal(a, [[0, 1], [2, 3]])
    pool.evict(a[0])
    np.testing.assert_array_equal(pool.admit(2), [1, 0])
    with pytest.raises(kv_pool.PoolExhausted):
        pool.admit(3)
    with pytest.raises(ValueError):
        pool.evict([5])
    assert pool.slab_bytes == 2 * tcfg.repeats * 6 * 128 * tcfg.n_kv * tcfg.d_head * 2
    assert pool.bytes_per_stream(2) == 2 * pool.page_bytes()


@pytest.fixture(scope="module")
def vit_params():
    v = ViTCfg(**VIT)
    pb = ParamBuilder(jax.random.PRNGKey(1))
    jp, _ = split_tree(jvit.init_vit(pb, v, 96))
    return v, TViTCfg(**VIT), jp, from_numpy_tree(np_tree(jp))


def test_vit_encode_full_matches_jax(vit_params):
    v, tv, jp, tp = vit_params
    frames = np.random.default_rng(2).uniform(0, 255, (3, 112, 112)).astype(np.float32)
    out_j = jvit.encode_full(jp, v, jnp.asarray(frames))
    out_t = vit.encode_full(tp, tv, torch.from_numpy(frames))
    np.testing.assert_array_equal(vit.patchify(torch.from_numpy(frames), tv).numpy(),
                                  np.asarray(jvit.patchify(jnp.asarray(frames), v)))
    close(out_t, out_j, 5e-2 * max(1.0, float(np.abs(f32(out_j)).max())))


def test_vit_encode_packed_matches_jax(vit_params):
    v, tv, jp, tp = vit_params
    rng = np.random.default_rng(4)
    frames = rng.uniform(0, 255, (6, 112, 112)).astype(np.float32)
    dyn = rng.random((6, 8, 8)) < 0.3
    score = rng.random((6, 8, 8)).astype(np.float32)
    kg = jpruning.capacity_groups(v, 0.5)
    plan_j = jpruning.pack_plan(jpruning.select_tokens(
        jnp.asarray(dyn), jnp.asarray(score), v, kg), v)
    plan_t = pruning.pack_plan(pruning.select_tokens(
        torch.from_numpy(dyn), torch.from_numpy(score), tv, kg), tv)
    bm = plan_j.block_map
    out_j = jvit.encode_packed_tokens(
        jp, v, jnp.asarray(frames), jnp.asarray(plan_j.patch_src),
        jnp.asarray(plan_j.seg_id), jnp.asarray(plan_j.group_src),
        jnp.asarray(plan_j.group_dst), jnp.asarray(bm.tile_ids),
        jnp.asarray(bm.tile_count), n_out=6 * kg, tq=bm.tq, tk=bm.tk)
    out_t = vit.encode_packed_tokens(
        tp, tv, torch.from_numpy(frames), torch.from_numpy(plan_t.patch_src),
        torch.from_numpy(plan_t.seg_id), torch.from_numpy(plan_t.group_src),
        torch.from_numpy(plan_t.group_dst), plan_t.block_map, n_out=6 * kg)
    close(out_t, out_j, 5e-2 * max(1.0, float(np.abs(f32(out_j)).max())))
    dropped = plan_t.group_dst.size and np.setdiff1d(np.arange(6 * kg), plan_t.group_dst)
    assert (out_t[torch.as_tensor(dropped)] == 0).all()


def test_weight_bridge_and_npz_loader(tmp_path):
    cfg = j_get_config("internvl3-14b-smoke")
    jp, _ = jtfm.init_params(cfg, jax.random.PRNGKey(0))
    tree = from_numpy_tree(np_tree(jp))
    flat_j = jax.tree_util.tree_leaves_with_path(jp)
    assert isinstance(tree["blocks"], tuple)
    for path, leaf in flat_j:
        node = tree
        for p in path:
            node = node[p.key] if hasattr(p, "key") else node[p.idx]
        assert tuple(node.shape) == leaf.shape
        assert str(node.dtype).endswith(str(leaf.dtype)), (path, node.dtype, leaf.dtype)
        np.testing.assert_array_equal(node.float().numpy(), np.asarray(leaf, np.float32))
    path = str(tmp_path / "ckpt.npz")
    checkpoint.save(path, jp)
    loaded = load_npz_params(path, get_config("internvl3-14b-smoke"))
    flat_t = dict(jax.tree_util.tree_leaves_with_path(tree))
    for p, leaf in jax.tree_util.tree_leaves_with_path(loaded):
        assert leaf.dtype == flat_t[p].dtype
        assert torch.equal(leaf, flat_t[p])
    assert len(flat_t) == len(jax.tree_util.tree_leaves(loaded))


def test_init_params_match_jax_structure():
    cfg = j_get_config("internvl3-14b-smoke")
    tcfg = get_config("internvl3-14b-smoke")
    jp, _ = jtfm.init_params(cfg, jax.random.PRNGKey(0))
    tp = init_lm_params(tcfg, seed=0, device="cpu")
    for (pj, lj), (pt, lt) in zip(jax.tree_util.tree_leaves_with_path(jp),
                                  jax.tree_util.tree_leaves_with_path(tp)):
        assert pj == pt and lj.shape == tuple(lt.shape)
        assert str(lt.dtype).endswith(str(lj.dtype))
    wq = tp["blocks"][0]["mixer"]["wq"]
    assert float(wq.float().abs().max()) <= 2 * tcfg.d_model ** -0.5 + 1e-3
    again = init_lm_params(tcfg, seed=0, device="cpu")
    assert torch.equal(again["embed"], tp["embed"])
    v = TViTCfg(**VIT)
    jv, _ = split_tree(jvit.init_vit(ParamBuilder(jax.random.PRNGKey(1)), ViTCfg(**VIT), 96))
    tv = init_vit_params(v, 96, seed=1, device="cpu")
    for (pj, lj), (pt, lt) in zip(jax.tree_util.tree_leaves_with_path(jv),
                                  jax.tree_util.tree_leaves_with_path(tv)):
        assert pj == pt and lj.shape == tuple(lt.shape)

"""The reference's remaining entry points in the port, against the JAX
package on the same seeded numpy inputs (each JAX reference computed
once per module in a fixture where several tests read it; the weights
are the port's random init, handed to JAX as arrays of the same values;
the JAX model functions run jitted, as its serving path runs them).

Tolerances, per test:

* ``estimate_bits``: every key within 1e-3 relative.  The quantised
  symbols are the same but for a rounding flip where the two codecs'
  residual means differ (by up to 4e-7 relative).
* ``NaiveDecoder``: frames and ``decode_count`` equal.
* ``full_decision``, ``pruning_stats``, ``gather_pages``,
  ``pool_pages_needed``: equal.
* ``encode_pruned`` / ``encode_pruned_tokens``: within 5e-2 of the
  output scale, the ViT parity limit of ``test_torch_models.py`` (bf16
  matmuls round at other points in the two frameworks).
* ``full_prefill`` / ``selective_refresh``: f32 logits within 2e-2 (the
  training parity tests' logit limit, ``test_torch_train.py``), the bf16
  caches within 3e-2 (one bf16 step of O(1) values, as
  ``test_torch_models.py``'s attention block).
* ``GreedyDecoder.decode``: bitwise ``start`` followed by the fetch.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.codec import NaiveDecoder as JNaiveDecoder  # noqa: E402
from repro.codec import encode_stream as j_encode_stream  # noqa: E402
from repro.codec import estimate_bits as j_estimate_bits  # noqa: E402
from repro.configs.base import CodecCfg, ModelCfg, ViTCfg  # noqa: E402
from repro.core import kv_pool as jkv_pool  # noqa: E402
from repro.core import kvc as jkvc  # noqa: E402
from repro.core import pruning as jpruning  # noqa: E402
from repro.data.video import VideoSpec, generate_video  # noqa: E402
from repro.models import vit as jvit  # noqa: E402
from repro_torch.codec import NaiveDecoder, encode_stream, estimate_bits  # noqa: E402
from repro_torch.configs.base import CodecCfg as TCodecCfg  # noqa: E402
from repro_torch.configs.base import ModelCfg as TModelCfg  # noqa: E402
from repro_torch.configs.base import ViTCfg as TViTCfg  # noqa: E402
from repro_torch.core import (  # noqa: E402
    WindowLayout, full_decision, full_prefill, gather_pages, pool_pages_needed,
    pruning_stats, reuse_caches, selective_refresh, select_tokens,
)
from repro_torch.models import transformer as ttfm  # noqa: E402
from repro_torch.models.layers import KVCache  # noqa: E402
from repro_torch.models import vit as tvit  # noqa: E402
from repro_torch.models.init import init_lm_params, init_vit_params, map_tree  # noqa: E402
from repro_torch.serving import EngineCfg  # noqa: E402
from repro_torch.serving.api import GreedyDecoder  # noqa: E402
from torch_threads import torch_one_thread  # noqa: E402,F401

CODEC = dict(gop=4, block=16, search_radius=4, window_frames=8, stride_frames=4,
             keep_ratio=0.5)
VIT = dict(n_layers=2, d_model=128, n_heads=4, d_ff=256, patch=14, image=112, group=2)
LM = dict(name="tiny-vlm", family="vlm", n_layers=2, d_model=64, n_heads=4, n_kv=2,
          d_ff=128, vocab=64, tied_embeddings=True)
GEOM = dict(window=8, stride=4, gop=4, g_tokens=16, k_tokens=8, query_len=3)


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
def encoded():
    frames, _ = generate_video(VideoSpec(n_frames=16, height=112, width=112,
                                         n_objects=3, speed=2.5, anomaly=True,
                                         anomaly_start=4, seed=5))
    jbs, jmd = j_encode_stream(jnp.asarray(frames), CodecCfg(**CODEC))
    tbs, tmd = encode_stream(torch.from_numpy(frames), TCodecCfg(**CODEC))
    return jbs, jmd, tbs, tmd


@pytest.mark.parametrize("gop", [4, 1])
def test_estimate_bits_matches_jax(gop):
    """The stream as served and the all-intra baseline (gop 1)."""
    frames, _ = generate_video(VideoSpec(n_frames=8, height=112, width=112,
                                         n_objects=3, speed=2.5, seed=5))
    codec = dict(CODEC, gop=gop, window_frames=4, stride_frames=gop)
    jbs, _ = j_encode_stream(jnp.asarray(frames), CodecCfg(**codec))
    tbs, _ = encode_stream(torch.from_numpy(frames), TCodecCfg(**codec))
    want, got = j_estimate_bits(jbs), estimate_bits(tbs)
    assert set(got) == set(want)
    for key, val in want.items():
        assert got[key] == pytest.approx(val, rel=1e-3), key
    assert got["compression_ratio"] > 1


def test_naive_decoder_matches_jax(encoded):
    jbs, jmd, tbs, tmd = encoded
    jd, td = JNaiveDecoder(CodecCfg(**CODEC)), NaiveDecoder(TCodecCfg(**CODEC))
    jd.ingest(jbs, jmd)
    td.ingest(tbs, tmd)
    for k in range(3):
        fj, mj = jd.window(k)
        ft, mt = td.window(k)
        np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))
        np.testing.assert_array_equal(mt.mv.numpy(), np.asarray(mj.mv))
        np.testing.assert_array_equal(mt.frame_types.numpy(), np.asarray(mj.frame_types))
        np.testing.assert_array_equal(td.decode_count, jd.decode_count)
    # the covering prefix is decoded once per window: frame 0 three times
    np.testing.assert_array_equal(td.decode_count[[0, 7, 15]], [3, 3, 1])


def test_full_decision_and_pruning_stats_match_jax():
    v, tv = ViTCfg(**VIT), TViTCfg(**VIT)
    fj, ft = jpruning.full_decision(v, 5), full_decision(tv, 5, device="cpu")
    for a, b in zip(fj, ft):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
    assert pruning_stats(ft) == jpruning.pruning_stats(fj)
    assert pruning_stats(ft)["pruned_frac"] == 0.0
    rng = np.random.default_rng(3)
    pp = v.patches_per_side
    dyn = rng.random((6, pp, pp)) < 0.2
    score = rng.random((6, pp, pp)).astype(np.float32)
    kg = jpruning.capacity_groups(v, 0.5)
    dj = jpruning.select_tokens(jnp.asarray(dyn), jnp.asarray(score), v, kg)
    dt = select_tokens(torch.from_numpy(dyn), torch.from_numpy(score), tv, kg)
    assert pruning_stats(dt) == jpruning.pruning_stats(dj)
    assert 0 < pruning_stats(dt)["pruned_frac"] < 1


def test_gather_pages_and_pool_pages_needed_match_jax():
    rng = np.random.default_rng(4)
    leaf = rng.normal(size=(2, 7 * 128, 2, 8)).astype(np.float32)   # (R, P_phys, n_kv, d)
    pt = rng.permutation(7)[:6].reshape(3, 2).astype(np.int32)
    want = jkv_pool.gather_pages(jnp.asarray(leaf), jnp.asarray(pt))
    got = gather_pages(torch.from_numpy(leaf), torch.from_numpy(pt))
    assert tuple(got.shape) == (2, 3, 256, 2, 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert pool_pages_needed(384) == jkv_pool.pool_pages_needed(384) == 3
    with pytest.raises(ValueError):
        pool_pages_needed(200)


def to_jax(tree):
    """A port tree as JAX arrays of the same values and dtypes (the port
    makes the weights: its initialiser is the faster of the two)."""
    return map_tree(lambda t: jnp.asarray(t.float().numpy()).astype(
        jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32), tree)


@pytest.fixture(scope="module")
def vit_params():
    tp = init_vit_params(TViTCfg(**VIT), 96, 1, "cpu")
    return ViTCfg(**VIT), TViTCfg(**VIT), to_jax(tp), tp


def test_encode_pruned_matches_jax(vit_params):
    """Padding lanes (a group that is not dynamic) encode nothing: the
    full-grid output is zero off the valid lanes, and the projected
    tokens of both packages agree."""
    v, tv, jp, tp = vit_params
    rng = np.random.default_rng(5)
    frames = rng.uniform(0, 255, (4, 112, 112)).astype(np.float32)
    pp = v.patches_per_side
    dyn = rng.random((4, pp, pp)) < 0.15
    score = rng.random((4, pp, pp)).astype(np.float32)
    kg = jpruning.capacity_groups(v, 0.5)
    dj = jpruning.select_tokens(jnp.asarray(dyn), jnp.asarray(score), v, kg)
    dt = select_tokens(torch.from_numpy(dyn), torch.from_numpy(score), tv, kg)
    assert not bool(dt.patch_valid.all())
    full_j = jax.jit(lambda p, f, pi, pv: jvit.encode_pruned(p, v, f, pi, pv))(
        jp, jnp.asarray(frames), dj.patch_idx, dj.patch_valid)
    full_t = tvit.encode_pruned(tp, tv, torch.from_numpy(frames), dt.patch_idx, dt.patch_valid)
    close(full_t, full_j, 5e-2 * max(1.0, float(np.abs(f32(full_j)).max())))
    kept = np.zeros((4, v.n_patches), bool)
    np.put_along_axis(kept, dt.patch_idx.numpy(), dt.patch_valid.numpy(), axis=1)
    assert (full_t.float().numpy()[~kept] == 0).all()
    tok_j = jvit.project(jp, v, full_j)     # the reference's encode_pruned_tokens
    tok_t = tvit.encode_pruned_tokens(tp, tv, torch.from_numpy(frames), dt.patch_idx,
                                      dt.patch_valid)
    close(tok_t, tok_j, 5e-2 * max(1.0, float(np.abs(f32(tok_j)).max())))


@pytest.fixture(scope="module")
def refreshed():
    """One window prefilled from scratch, reused and selectively
    refreshed, by both packages with the same weights and embeddings."""
    jcfg, tcfg = ModelCfg(**LM), TModelCfg(**LM)
    tp = init_lm_params(tcfg, 0, "cpu")
    jp = to_jax(tp)
    lay, tlay = jkvc.WindowLayout(**GEOM), WindowLayout(**GEOM)
    rng = np.random.default_rng(6)
    B, T, d = 2, lay.total_len, jcfg.d_model
    emb = rng.normal(size=(B, T, d)).astype(np.float32)
    valid = rng.random((B, T)) > 0.2
    valid[:, -lay.query_len:] = True
    n_ref = len(lay.refresh_token_idx)
    r_emb = rng.normal(size=(B, n_ref, d)).astype(np.float32)
    r_valid = rng.random((B, n_ref)) > 0.1
    kv_valid = np.asarray(jkvc.shift_valid(jnp.asarray(valid), lay))

    # jitted, as the reference's serving path runs them
    jemb = jnp.asarray(emb).astype(jnp.bfloat16)
    jl0, jc, _ = jax.jit(lambda p, e, vl: jkvc.full_prefill(jcfg, p, e, vl, lay))(
        jp, jemb, jnp.asarray(valid))
    jcaches0 = np_tree(jc)
    jl1, jc, _ = jax.jit(lambda p, c, e, rv, kv: jkvc.selective_refresh(
        jcfg, p, jkvc.reuse_caches(jcfg, c, lay), e, rv, kv, lay))(
        jp, jc, jnp.asarray(r_emb).astype(jnp.bfloat16), jnp.asarray(r_valid),
        jnp.asarray(kv_valid))

    tl0, tc, _ = full_prefill(tcfg, tp, torch.from_numpy(np.array(jemb.astype(jnp.float32)))
                              .bfloat16(), torch.from_numpy(valid), tlay)
    tcaches0 = [(b.k.clone(), b.v.clone()) for b in tc.blocks]
    tc = reuse_caches(tcfg, tc, tlay)
    tl1, tc, _ = selective_refresh(
        tcfg, tp, tc, torch.from_numpy(r_emb).bfloat16(), torch.from_numpy(r_valid),
        torch.from_numpy(kv_valid), tlay)
    return lay, tp, (jl0, jcaches0, jl1, np_tree(jc)), (tl0, tcaches0, tl1, tc)


def test_full_prefill_matches_jax(refreshed):
    lay, _, (jl0, jc0, _, _), (tl0, tc0, _, _) = refreshed
    assert tl0.dtype == torch.float32
    close(tl0, jl0, 2e-2)
    T = lay.total_len
    for (tk, tv_), jb in zip(tc0, jc0.blocks):
        assert tk.shape[2] == 128            # total_len rounded up to a whole tile
        close(tk[:, :, :T], jb.k, 3e-2)
        close(tv_[:, :, :T], jb.v, 3e-2)
        assert not tk[:, :, T:].any()


def test_selective_refresh_matches_jax(refreshed):
    lay, _, (_, _, jl1, jc1), (_, _, tl1, tc1) = refreshed
    close(tl1, jl1, 2e-2)
    T = lay.total_len
    for tb, jb in zip(tc1.blocks, jc1.blocks):
        close(tb.k[:, :, :T], jb.k, 3e-2)
        close(tb.v[:, :, :T], jb.v, 3e-2)


def test_greedy_decode_is_start_then_fetch(refreshed):
    lay, tp, _, (tl0, tc0, _, _) = refreshed
    cfg = TModelCfg(**LM)
    dec = GreedyDecoder(cfg, tp, EngineCfg(max_new_tokens=3))
    flops_len = lambda i: lay.total_len + i + 1  # noqa: E731

    def caches():
        return ttfm.Caches(tuple(KVCache(k.clone(), v.clone()) for k, v in tc0), None)

    c1, c2 = caches(), caches()
    answers, yes_no, out, flops = dec.decode(tl0, c1, lay.total_len, flops_len)
    assert out is c1
    pend = dec.start(tl0, c2, lay.total_len, flops_len, None, 128)
    np.testing.assert_array_equal(answers, pend.answers.numpy().astype(np.int64))
    np.testing.assert_array_equal(yes_no, pend.yes_no.double().numpy())
    assert flops == pend.flops_decode > 0
    for a, b in zip(c1.blocks, c2.blocks):
        assert torch.equal(a.k, b.k) and torch.equal(a.v, b.v)

"""The port's codec, motion analyzer, token pruner, packing plan and
window geometry against the JAX package's, on the same numpy inputs.

Equal, not close: frame types, MVs (see the near-tie rule in
``test_torch_kernels.assert_mv_match``), the quantized bitstream,
decoded frames, dynamic masks, selected groups and every packing array.
The f32 residual means (sums of 256 terms in another order) are held
to 1e-6 relative, the motion scores to 1e-5.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.codec import StreamDecoder as JStreamDecoder  # noqa: E402
from repro.codec import encode_stream as j_encode_stream  # noqa: E402
from repro.configs.base import CodecCfg, ViTCfg  # noqa: E402
from repro.core import kvc as jkvc  # noqa: E402
from repro.core import motion as jmotion  # noqa: E402
from repro.core import pruning as jpruning  # noqa: E402
from repro.data.video import VideoSpec, generate_video  # noqa: E402
from repro_torch.codec import StreamDecoder, decode_stream, encode_stream  # noqa: E402
from repro_torch.codec.metadata import CodecMetadata  # noqa: E402
from repro_torch.configs.base import CodecCfg as TCodecCfg  # noqa: E402
from repro_torch.configs.base import ViTCfg as TViTCfg  # noqa: E402
from repro_torch.core import kvc, motion, pruning  # noqa: E402
from repro_torch.data.video import generate_video as t_generate_video  # noqa: E402
from torch_threads import torch_one_thread  # noqa: E402,F401

CODEC = dict(gop=4, block=16, search_radius=4, window_frames=8, stride_frames=4,
             keep_ratio=0.5)
VIT = dict(n_layers=2, d_model=128, n_heads=4, d_ff=256, patch=14, image=112, group=2)


def t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def encoded():
    frames, _ = generate_video(VideoSpec(n_frames=16, height=112, width=112,
                                         n_objects=3, speed=2.5, anomaly=True,
                                         anomaly_start=4, seed=5))
    jbs, jmd = j_encode_stream(jnp.asarray(frames), CodecCfg(**CODEC))
    tbs, tmd = encode_stream(t(frames), TCodecCfg(**CODEC))
    return frames, jbs, jmd, tbs, tmd


def test_video_generator_is_the_same():
    spec = dict(n_frames=6, height=64, width=48, anomaly=True, anomaly_start=2, seed=9)
    a, la = generate_video(VideoSpec(**spec))
    from repro_torch.data.video import VideoSpec as TVideoSpec
    b, lb = t_generate_video(TVideoSpec(**spec))
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(la, lb)


def test_encode_stream_matches_jax(encoded):
    frames, jbs, jmd, tbs, tmd = encoded
    np.testing.assert_array_equal(tbs.frame_types.numpy(), np.asarray(jbs.frame_types))
    np.testing.assert_array_equal(tmd.mv.numpy(), np.asarray(jmd.mv))
    np.testing.assert_array_equal(tbs.iframe_data.numpy(), np.asarray(jbs.iframe_data))
    np.testing.assert_array_equal(tbs.residual_q.numpy(), np.asarray(jbs.residual_q))
    np.testing.assert_allclose(tmd.residual.numpy(), np.asarray(jmd.residual),
                               rtol=1e-6, atol=1e-5)
    assert (tmd.mv.numpy() != 0).any(), "the clip should carry motion"


def test_decode_is_exact_inverse(encoded):
    frames, jbs, _, tbs, tmd = encoded
    rec = decode_stream(tbs, 16)
    dec = JStreamDecoder(CodecCfg(**CODEC))
    dec.ingest(jbs, _)
    np.testing.assert_array_equal(rec.numpy(), dec._frames)
    sd = StreamDecoder(TCodecCfg(**CODEC))
    sd.ingest(tbs, tmd)
    assert sd.n_windows() == dec.n_windows() == 3
    for k in range(sd.n_windows()):
        fr, md = sd.window(k)
        fj, mj = dec.window(k)
        np.testing.assert_array_equal(fr.numpy(), fj)
        np.testing.assert_array_equal(md.mv.numpy(), np.asarray(mj.mv))
        np.testing.assert_array_equal(md.frame_types.numpy(), np.asarray(mj.frame_types))
    np.testing.assert_array_equal(sd.decode_count, np.ones(16, np.int32))
    with pytest.raises(IndexError):
        sd.window(3)


def test_motion_mask_matches_jax(encoded):
    _, _, jmd, _, tmd = encoded
    v = ViTCfg(**VIT)
    d_j, s_j = jmotion.motion_mask(jmd, CodecCfg(**CODEC), v.patches_per_side)
    d_t, s_t = motion.motion_mask(tmd, TCodecCfg(**CODEC), v.patches_per_side)
    np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j))
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), atol=1e-5)


def _decisions(seed, T=12):
    """Dynamic masks and scores with heavy ties (scores on a coarse grid),
    so the top-k order depends on the tie-break rule."""
    rng = np.random.default_rng(seed)
    v = ViTCfg(**VIT)
    pp = v.patches_per_side
    dyn = rng.random((T, pp, pp)) < 0.15
    score = (rng.integers(0, 3, (T, pp, pp)) * 0.5).astype(np.float32)
    return dyn, score


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("keep_ratio", [0.25, 0.5])
def test_select_tokens_and_pack_plan_match_jax(seed, keep_ratio):
    v, tv = ViTCfg(**VIT), TViTCfg(**VIT)
    kg = jpruning.capacity_groups(v, keep_ratio)
    assert pruning.capacity_groups(tv, keep_ratio) == kg
    dyn, score = _decisions(seed)
    dj = jpruning.select_tokens(jnp.asarray(dyn), jnp.asarray(score), v, kg)
    dt = pruning.select_tokens(t(dyn), t(score), tv, kg)
    for a, b in zip(dt, dj):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    pj = jpruning.pack_plan(dj, v)
    pt = pruning.pack_plan(dt, tv)
    assert (pt.l_pack, pt.n_frames, pt.k_groups, pt.n_rows, pt.n_slots, pt.k_pack,
            pt.n_kept_groups) == (pj.l_pack, pj.n_frames, pj.k_groups, pj.n_rows,
                                  pj.n_slots, pj.k_pack, pj.n_kept_groups)
    for f in ("patch_src", "seg_id", "group_src", "group_dst", "kept_patches"):
        np.testing.assert_array_equal(getattr(pt, f), getattr(pj, f))
    np.testing.assert_array_equal(pt.block_map.tile_ids, pj.block_map.tile_ids)
    np.testing.assert_array_equal(pt.block_map.tile_count, pj.block_map.tile_count)
    assert pt.fill == pj.fill


def test_select_tokens_breaks_ties_by_lower_index():
    tv = TViTCfg(**VIT)
    dyn = np.zeros((1, 8, 8), bool)
    score = np.zeros((1, 8, 8), np.float32)
    dec = pruning.select_tokens(t(dyn), t(score), tv, 5)
    np.testing.assert_array_equal(dec.group_idx.numpy(), [[0, 1, 2, 3, 4]])
    assert not dec.group_valid.any()


@pytest.mark.parametrize("geom", [(16, 4, 4, 256, 128, 8), (8, 4, 4, 16, 8, 8),
                                  (16, 8, 4, 64, 16, 8), (12, 4, 2, 16, 4, 3)])
def test_window_layout_and_refresh_map_match_jax(geom):
    w, s, gop, g, k, q = geom
    a = kvc.WindowLayout(w, s, gop, g, k, q)
    b = jkvc.WindowLayout(w, s, gop, g, k, q)
    for f in ("frame_tokens", "frame_offsets", "vis_len", "total_len", "shift_tokens",
              "overlap_tokens", "n_refresh"):
        assert getattr(a, f) == getattr(b, f), f
    np.testing.assert_array_equal(a.anchor_token_idx, b.anchor_token_idx)
    np.testing.assert_array_equal(a.refresh_token_idx, b.refresh_token_idx)
    slots = -(-(a.total_len + 1) // 128) * 128
    ma = kvc.refresh_block_map(a, kv_len=slots)
    mb = jkvc.refresh_block_map(b, kv_len=slots)
    for f in ("q_pos", "tile_ids", "tile_count"):
        np.testing.assert_array_equal(getattr(ma, f), getattr(mb, f))
    assert (ma.n_q, ma.kv_len) == (mb.n_q, mb.kv_len)


def test_window_layout_rejects_unaligned_stride():
    with pytest.raises(ValueError):
        kvc.WindowLayout(16, 3, 4, 16, 8, 8)


def test_codec_metadata_window_and_magnitude():
    mv = torch.tensor([[[[3, 4]]], [[[0, -1]]]], dtype=torch.int32)
    md = CodecMetadata(torch.tensor([0, 1], dtype=torch.int32), mv, torch.zeros(2, 1, 1))
    np.testing.assert_array_equal(md.mv_magnitude.numpy(), [[[5.0]], [[1.0]]])
    assert md.window(1, 1).frame_types.tolist() == [1]

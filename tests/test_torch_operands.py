"""The operands the attention kernels, rope_shift and mv_sad take,
against the JAX package.

* The contract verdict on meta tensors: ``ok`` for every attention op at
  every head dim d = 1, 2, ..., 512 and past it (513 to 4096: the DEEP
  build) with bf16 operands, with f32 queries over bf16 K/V and, in
  flash_packed and flash_prefill, with f32 q/k/v; the named refusal for
  f16 operands;
  ``ok`` for rope_shift at every even d up to 512; ``ok`` for mv_sad at
  radius 16 and 32, at blocks 8 and 12, and past one band's shared
  memory (radius 128, block 64 at radius 96, block 240 at radius 1: the
  tiled kernel, whose tiling ``launch_geometry`` gives).
* The JAX quickstart's model at its own widths (LM 4 heads of 16 over 2
  kv heads, ViT 4 heads of 16), a 2-layer f32 LM, and 2-layer LMs with
  heads of 256 (2 over 1 kv head, what the kernels' WIDE build serves),
  of 512 and of 320 (the SLAB build's exact and ragged widths) and of
  1024 (the DEEP build; its ViT at 1 head of 1024) in bf16 and in f32,
  each served by the port's ``Engine`` on the CPU
  from the JAX package's weights, against the JAX package's ``Engine``
  on the same stream: no call the card would refuse
  (``kernel_fallbacks`` 0, every verdict ``ok``); yes/no logits within
  the serving tests' LOGIT_TOL (8e-3, ``test_torch_serving.py``),
  answers equal where the JAX margin exceeds twice it.
* The seven attention kernels' plain versions at head dims 256, 512, 320,
  300, 520, 1000, 1023 and 1024, and refresh, paged refresh with int8 cold pages, packed and
  prefill at head dims 20, 33 and 90, against the JAX package's oracles
  (``repro.kernels.ref``) on the same inputs: f32 within 1e-5 and bf16
  within 3e-2 (``test_torch_kernels.py``'s limits: sums in another
  order; one bf16 step of O(1) values); rope_shift at d 90 (half 45)
  and 320 (half 160) and mv_sad at block 240, radius 1 on a 240^2 frame (its macroblock
  alone is 230 KB) against the same.
* internvl3-14b-smoke re-cut to LM heads of 90 and ViT heads of 75
  (``audit.odd_heads``) served as the models above.
* ``encode_stream`` at search radius 16: motion vectors equal to the
  JAX package's and the f32 residual means within 4e-7 of the largest
  (sums of 256 terms in another order: read 2.5e-7 at this size, 1e-6
  elementwise at the smallest means).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.codec import encode_stream as j_encode_stream  # noqa: E402
from repro.configs.base import CodecCfg as JCodecCfg  # noqa: E402
from repro.configs.base import ModelCfg as JModelCfg  # noqa: E402
from repro.configs.base import ViTCfg as JViTCfg  # noqa: E402
from repro.configs.registry import get_config as j_get_config  # noqa: E402
from repro.data.video import VideoSpec, generate_video  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.models import vit as jvitm  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models.init import ParamBuilder, split_tree  # noqa: E402
from repro.serving import Engine as JEngine  # noqa: E402
from repro.serving import EngineCfg as JEngineCfg  # noqa: E402
from repro_torch.codec import encode_stream  # noqa: E402
from repro_torch.configs import CodecCfg, ModelCfg, ViTCfg, get_config  # noqa: E402
from repro_torch.kernels import audit, contracts, ops  # noqa: E402
from repro_torch.kernels.flash_packed import build_pack_map, flash_packed_plain  # noqa: E402
from repro_torch.kernels.flash_prefill import (  # noqa: E402
    flash_prefill_paged_plain, flash_prefill_plain,
)
from repro_torch.kernels.flash_refresh import (  # noqa: E402
    build_block_map, flash_refresh_paged_plain, flash_refresh_plain,
)
from repro_torch.kernels.mv_sad import SMEM_LIMIT as MV_SAD_SMEM_LIMIT  # noqa: E402
from repro_torch.kernels.mv_sad import launch_geometry as mv_sad_launch_geometry  # noqa: E402
from repro_torch.kernels.mv_sad import mv_sad_plain  # noqa: E402
from repro_torch.kernels.rope_shift import rope_shift_plain  # noqa: E402
from repro_torch.models.init import from_numpy_tree  # noqa: E402
from repro_torch.serving import Engine, EngineCfg  # noqa: E402
from torch_threads import torch_one_thread  # noqa: E402,F401

LOGIT_TOL = 8e-3      # test_torch_serving.py's
BF16, F32, F16 = torch.bfloat16, torch.float32, torch.float16

# the JAX quickstart's widths (examples/quickstart.py)
LM = dict(name="demo", family="vlm", n_layers=2, d_model=64, n_heads=4, n_kv=2, d_ff=128,
          vocab=64, tied_embeddings=True)
VIT = dict(n_layers=2, d_model=64, n_heads=4, d_ff=128, patch=14, image=112, group=2)
CODEC = dict(gop=4, window_frames=8, stride_frames=4, keep_ratio=0.4)
# a 2-layer f32 LM (the reference's ModelCfg.dtype="float32")
LM_F32 = dict(LM, name="f32", n_heads=2, n_kv=1, dtype="float32")
# 2-layer LMs with heads of 256 (ModelCfg.d_head apart from d_model /
# n_heads), in bf16 and in f32
LM_D256 = dict(LM, name="d256", n_heads=2, n_kv=1, d_head=256)
# ... and with heads of 512 and 320 (the D-512 build: two column slabs of
# V and O, exact at 512 and ragged at 320)
LM_D512 = dict(LM, name="d512", n_heads=2, n_kv=1, d_head=512)
LM_D320 = dict(LM, name="d320", n_heads=2, n_kv=1, d_head=320)
# ... and with heads of 1024 (the DEEP build: Q K^T over four depth
# chunks, four column slabs of V and O), its ViT at 1 head of 1024
LM_D1024 = dict(LM, name="d1024", n_heads=2, n_kv=1, d_head=1024)
SERVED_LMS = {"quickstart": LM, "f32": LM_F32, "d256": LM_D256,
              "d256-f32": dict(LM_D256, name="d256-f32", dtype="float32"),
              "d512": LM_D512, "d512-f32": dict(LM_D512, name="d512-f32", dtype="float32"),
              "d320": LM_D320, "d320-f32": dict(LM_D320, name="d320-f32", dtype="float32"),
              "d1024": LM_D1024,
              "d1024-f32": dict(LM_D1024, name="d1024-f32", dtype="float32")}
# the ViT a served LM takes where it is not the quickstart's
SERVED_VITS = {name: dict(VIT, d_model=1024, n_heads=1) for name in ("d1024", "d1024-f32")}


# ----------------------------------------------------------------------
# the contract verdicts on meta tensors
# ----------------------------------------------------------------------
def _m(shape, dtype=BF16):
    return torch.empty(shape, dtype=dtype, device="meta")


def _verdicts(d: int, q_dt, kv_dt):
    """{op: verdict} of each attention op at head dim d, q in q_dt and
    K/V in kv_dt (the int8 ops' hot slab too), on meta tensors."""
    H, Hkv, B = 4, 2, 2
    pos = np.arange(40, 200)
    bm = build_block_map(pos, 256)
    q, qp = _m((B, len(pos), H, d), q_dt), _m((B, len(pos)), torch.int32)
    caches, slab = _m((B, 256, Hkv, d), kv_dt), _m((B * 256, Hkv, d), kv_dt)
    kvv, pt = _m((B, 256), torch.bool), _m((B, 2), torch.int32)
    cold = (_m((128, Hkv, d), torch.int8), _m((128, Hkv, d), torch.int8),
            _m((1, Hkv), F32), _m((1, Hkv), F32))
    qf = _m((B, 300, H, d), q_dt)
    seg = np.repeat(np.arange(4, dtype=np.int32), 64)[None].repeat(2, 0)
    pq, pk = _m((2, 256, H, d), q_dt), _m((2, 256, Hkv, d), kv_dt)
    calls = {
        "flash_refresh": lambda: contracts.flash_refresh_verdict(
            q, caches, caches, qp, kvv, causal=True, window=None, block_map=bm),
        "flash_refresh_paged": lambda: contracts.flash_refresh_paged_verdict(
            q, slab, slab, qp, kvv, pt, page=128, causal=True, window=None, block_map=bm),
        "flash_refresh_paged_int8": lambda: contracts.flash_refresh_paged_verdict(
            q, slab, slab, qp, kvv, pt, page=128, causal=True, window=None, block_map=bm,
            cold=cold),
        "flash_prefill": lambda: contracts.flash_prefill_verdict(
            qf, caches, caches, causal=True, window=None, q_offset=0),
        "flash_prefill_paged": lambda: contracts.flash_prefill_paged_verdict(
            qf, slab, slab, pt, page=128, causal=True, window=None, q_offset=0),
        "flash_prefill_paged_int8": lambda: contracts.flash_prefill_paged_verdict(
            qf, slab, slab, pt, page=128, causal=True, window=None, q_offset=0, cold=cold),
        "flash_packed": lambda: contracts.flash_packed_verdict(
            pq, pk, pk, _m((2, 256), torch.int32), build_pack_map(seg)),
    }
    return {op: call().reason for op, call in calls.items()}


ATTN_OPS = ("flash_refresh", "flash_refresh_paged", "flash_refresh_paged_int8",
            "flash_prefill", "flash_prefill_paged", "flash_prefill_paged_int8", "flash_packed")
F32_KV_OPS = {"flash_prefill", "flash_packed"}     # f32 K/V: the oracles round nothing
Q_DTYPES = (BF16, F16, F32)


def _f32_kv_verdicts():
    """f32 K/V under any q: taken by flash_prefill and flash_packed, the
    cache kernels' 'kernel-dtype' otherwise (their K/V are bf16 or f16)."""
    return {op: "ok" if op in F32_KV_OPS else "kernel-dtype" for op in ATTN_OPS}


def _assert_every_dtype_pair(d):
    """Every q type over bf16 and f16 K/V is taken by every attention op;
    over f32 K/V by flash_prefill and flash_packed."""
    for kv_dt in (BF16, F16):
        for q_dt in Q_DTYPES:
            assert _verdicts(d, q_dt, kv_dt) == {op: "ok" for op in ATTN_OPS}, (q_dt, kv_dt)
    for q_dt in Q_DTYPES:
        assert _verdicts(d, q_dt, F32) == _f32_kv_verdicts(), q_dt


@pytest.mark.parametrize("d", range(1, 257))
def test_every_attention_op_takes_every_head_dim_and_f32_operands(d):
    _assert_every_dtype_pair(d)


@pytest.mark.parametrize("d", range(257, 513))
def test_every_attention_op_takes_every_head_dim_past_256(d):
    """d 257 to 512: the D-512 build (exact at 512, ragged below) in every
    operand mode the narrower builds take."""
    _assert_every_dtype_pair(d)


@pytest.mark.parametrize("d", [513, 520, 640, 1000, 1022, 1023, 1024, 1040, 2048, 4096])
def test_every_attention_op_takes_every_head_dim_past_512(d):
    """Past 512: the DEEP build (Q K^T summed over depth chunks) in every
    operand mode the D-512 build takes."""
    _assert_every_dtype_pair(d)


@pytest.mark.parametrize("d, q_dt, kv_dt, code", [
    (20, BF16, BF16, "ok"), (520, BF16, BF16, "ok"), (520, F32, BF16, "ok"),
    (1024, BF16, BF16, "ok"), (1024, F32, BF16, "ok"), (4096, BF16, BF16, "ok"),
    (4096, F32, BF16, "ok"), (64, F16, F16, "ok"), (64, F16, BF16, "ok"),
    (64, BF16, F16, "ok"), (64, F32, F16, "ok"), (64, BF16, F32, "kernel-dtype"),
    (64, F16, F32, "kernel-dtype"), (1024, F32, F32, "kernel-dtype")])
def test_refused_operands_name_their_rule(d, q_dt, kv_dt, code):
    """f32 K/V in the cache kernels is refused by name, under any q
    (flash_prefill and flash_packed take it); f16 q/k/v, once refused (no
    f16 build), a query of another type than its bf16 or f16 K/V, once
    refused (no build mixed them), d 20, once refused for not being a
    multiple of 8, and d 520, 1024 and 4096, once refused for passing
    512, are taken."""
    want = ({op: code for op in ATTN_OPS} if code == "ok" else _f32_kv_verdicts())
    assert _verdicts(d, q_dt, kv_dt) == want


@pytest.mark.parametrize("d", [20, 64, 90, 128, 256, 512, 520, 1024, 4096])
def test_every_attention_op_takes_f16_qkv(d):
    """f16 q, k and v (the f16 builds: ragged up to 256, the SLAB build to
    512, the DEEP one past it) at every width class, and an f16 query over
    bf16 K/V or a bf16 or f32 one over f16 K/V."""
    assert _verdicts(d, F16, F16) == {op: "ok" for op in ATTN_OPS}
    assert _verdicts(d, F16, BF16) == {op: "ok" for op in ATTN_OPS}
    assert _verdicts(d, BF16, F16) == {op: "ok" for op in ATTN_OPS}
    assert _verdicts(d, F32, F16) == {op: "ok" for op in ATTN_OPS}


@pytest.mark.parametrize("d", range(2, 513, 2))
def test_rope_shift_takes_every_even_head_dim(d):
    k, delta = _m((2, 40, 4, d)), _m((2, 40), torch.int32)
    assert contracts.rope_shift_verdict(k, delta).reason == "ok"
    assert contracts.rope_shift_verdict(_m((2, 40, 4, d), F32), delta).reason == "ok"
    assert contracts.rope_shift_verdict(_m((2, 40, 4, d), F16), delta).reason == "ok"


@pytest.mark.parametrize("block, radius", [(16, 16), (16, 32), (8, 16), (12, 32), (8, 4),
                                           (12, 4), (16, 128), (64, 96), (240, 1)])
def test_mv_sad_takes_any_radius_and_block(block, radius):
    n = block * (448 // block)
    frame = _m((n, n), F32)
    assert contracts.mv_sad_verdict(frame, frame, block, radius).reason == "ok"


@pytest.mark.parametrize("block, radius", [(16, 16), (16, 32), (8, 16), (12, 32), (16, 50),
                                           (6, 5)])
def test_mv_sad_launch_geometry_shares_candidates_evenly(block, radius):
    """Past 1024 candidates each thread walks several, as few whole warps
    as share them evenly (no more than one candidate apart), within the
    227 KB an H100 block can have; the band's row stride keeps a warp's
    32 consecutive candidates on 32 distinct banks."""
    threads, ldr, smem, tile = mv_sad_launch_geometry(block, radius)
    assert tile is None
    n2 = (2 * radius + 1) ** 2
    per = -(-n2 // threads)
    assert threads % 32 == 0 and threads <= 1024 and n2 <= per * threads < n2 + per * 32
    assert smem == 4 * (block * block + (block + 2 * radius) * ldr + 2 * (threads // 32))
    assert smem <= MV_SAD_SMEM_LIMIT == 232448
    assert ldr % 32 == (2 * radius + 1) % 32


def test_mv_sad_refuses_only_a_band_past_the_shared_memory():
    """No band is refused any more: block 240 at radius 1, whose
    macroblock alone (230 KB) passes one block's shared memory, is taken
    (the tiled kernel), and mv_sad has no eligibility rule left, as the
    reference has none."""
    frame = _m((240, 240), F32)
    assert contracts.mv_sad_verdict(frame, frame, 240, 1).reason == "ok"
    assert [r.code for r in contracts.MV_SAD.eligibility] == []
    assert mv_sad_launch_geometry(240, 1).tile == (3, 3, 115)


@pytest.mark.parametrize("block, radius, tile", [
    (16, 128, (15, 257, 16)), (64, 96, (21, 193, 64)), (240, 1, (3, 3, 115)),
    (16, 2100, (1, 4096, 14))])
def test_mv_sad_tiles_a_band_past_the_shared_memory(block, radius, tile):
    """Past 227 KB the tiled kernel: tiles of ty dy rows by tx dx columns
    (at most 1024 threads x 4 candidates), the macroblock whole where it
    fits beside ty rows of the band slice, else in strips of rs rows; the
    slice's rows padded so that a warp's 32 consecutive candidates of a
    tile row hit 32 distinct banks."""
    threads, ldr, smem, got = mv_sad_launch_geometry(block, radius)
    ty, tx, rs = got
    n_cand = 2 * radius + 1
    assert got == tile and threads == 1024 and ty * tx <= 4 * threads
    assert tx <= n_cand and ty <= n_cand and 1 <= rs <= block
    assert smem == 4 * (rs * block + (ty - 1 + rs) * ldr + 2 * (threads // 32))
    assert smem <= MV_SAD_SMEM_LIMIT < 4 * (block * block + (block + 2 * radius) ** 2)
    assert tx - 1 + block <= ldr < tx - 1 + block + 32 and ldr % 32 == tx % 32
    if rs < block:      # strips only where the whole macroblock does not fit beside ty rows
        assert 4 * (block * block + (ty - 1 + block) * ldr) > MV_SAD_SMEM_LIMIT


# ----------------------------------------------------------------------
# the quickstart's widths and an f32 LM, served on the CPU against JAX
# ----------------------------------------------------------------------
def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _stream():
    frames, _ = generate_video(VideoSpec(n_frames=12, height=112, width=112, anomaly=True,
                                         anomaly_start=5, anomaly_len=8, seed=0))
    return frames


ODD = "internvl3-14b-smoke, heads of 90 and 75"


def _served_cfgs(name: str):
    """(JAX LM, JAX ViT, port LM, port ViT) of a served model: an LM of
    SERVED_LMS with the quickstart's ViT, or ODD (``audit.odd_heads`` of
    internvl3-14b-smoke in both packages)."""
    if name == ODD:
        j = j_get_config("internvl3-14b-smoke")
        j = dataclasses.replace(j, d_head=audit.ODD_HEAD, vit=dataclasses.replace(
            j.vit, d_model=j.vit.n_heads * audit.ODD_VIT_HEAD))
        c = audit.odd_heads(get_config("internvl3-14b-smoke"))
        assert (c.d_head, c.vit.d_model // c.vit.n_heads) == (90, 75) and c.vit == ViTCfg(
            **dataclasses.asdict(j.vit))
        return j, j.vit, c, c.vit
    lm, vit = SERVED_LMS[name], SERVED_VITS.get(name, VIT)
    return JModelCfg(**lm), JViTCfg(**vit), ModelCfg(**lm), ViTCfg(**vit)


@pytest.fixture(scope="module", params=sorted(SERVED_LMS) + [ODD])
def served(request):
    """(JAX results, port results, port card verdicts) of one model: the
    JAX package's Engine on its own weights, then the port's Engine on
    the same weights and stream (12 frames: one fresh and one incremental
    window)."""
    frames = _stream()
    jcfg, jvit, cfg, vit = _served_cfgs(request.param)
    jparams, _ = jtfm.init_params(jcfg, jax.random.PRNGKey(0))
    jvparams, _ = split_tree(jvitm.init_vit(ParamBuilder(jax.random.PRNGKey(1)), jvit,
                                            jcfg.d_model))
    jres = JEngine(jcfg, jvit, jparams, jvparams,
                   JEngineCfg(mode="codecflow", codec=JCodecCfg(**CODEC))).run_stream(frames)
    ops.reset_card_verdicts()
    eng = Engine(cfg, vit, from_numpy_tree(_np_tree(jparams)),
                 from_numpy_tree(_np_tree(jvparams)),
                 EngineCfg(mode="codecflow", codec=CodecCfg(**CODEC)), device="cpu")
    tres = eng.run_stream(frames)
    return jres, tres, ops.card_verdicts()


def test_served_with_no_refusal(served):
    _, tres, verdicts = served
    assert [r.kernel_fallbacks for r in tres] == [0, 0]
    assert set(verdicts) == {"mv_sad", "flash_packed", "flash_refresh_paged", "rope_shift"}
    assert all(set(c) == {"ok"} for c in verdicts.values()), verdicts


@pytest.mark.parametrize("name", ["d512", "d320-f32", "d1024"])
def test_jax_weights_carry_across_at_head_dims_past_256(name):
    """``models.init.from_numpy_tree`` needs nothing new past 256: the JAX
    package's LM tree at heads of 512 (or 320, f32; or 1024) arrives leaf for leaf
    in the port's layout (the paths, shapes and dtypes of the port's own
    ``init_lm_params`` at the same config), values unchanged."""
    from repro_torch.models.init import init_lm_params, leaf_paths, tree_leaves
    jcfg, _, cfg, _ = _served_cfgs(name)
    jparams, _ = jtfm.init_params(jcfg, jax.random.PRNGKey(0))
    got = from_numpy_tree(_np_tree(jparams))
    own = init_lm_params(cfg, 0, "cpu")
    assert [k for k, _ in leaf_paths(got)] == [k for k, _ in leaf_paths(own)]
    for a, b in zip(tree_leaves(got), tree_leaves(own)):
        assert a.shape == b.shape and a.dtype == b.dtype
    for a, b in zip(tree_leaves(got), jax.tree_util.tree_leaves(jparams)):
        np.testing.assert_array_equal(a.float().numpy(), np.asarray(b, np.float32))


def test_served_logits_match_jax(served):
    jres, tres, _ = served
    assert len(jres) == len(tres) == 2
    for a, b in zip(jres, tres):
        lj, lt = np.asarray(a.logits_yes_no), np.asarray(b.logits_yes_no)
        assert np.isfinite(lt).all()
        assert np.abs(lj - lt).max() <= LOGIT_TOL, (lj, lt)
        if abs(lj[0] - lj[1]) > 2 * LOGIT_TOL:
            assert a.answer == b.answer
        assert (a.tokens_vis, a.tokens_valid, a.tokens_refreshed) == (
            b.tokens_vis, b.tokens_valid, b.tokens_refreshed)


# ----------------------------------------------------------------------
# the codec at search radius 16
# ----------------------------------------------------------------------
def test_encode_stream_at_radius_16_matches_jax():
    frames, _ = generate_video(VideoSpec(n_frames=8, height=112, width=112, n_objects=3,
                                         speed=6.0, anomaly=True, anomaly_start=2, seed=5))
    codec = dict(gop=4, block=16, search_radius=16, window_frames=8, stride_frames=4,
                 keep_ratio=0.5)
    jbs, jmd = j_encode_stream(jnp.asarray(frames), JCodecCfg(**codec))
    tbs, tmd = encode_stream(torch.from_numpy(np.array(frames)), CodecCfg(**codec))
    np.testing.assert_array_equal(tmd.mv.numpy(), np.asarray(jmd.mv))
    assert (np.abs(tmd.mv.numpy()) > 4).any(), "the clip should move past radius 4"
    res, jres = tmd.residual.numpy(), np.asarray(jmd.residual)
    assert np.abs(res - jres).max() <= 4e-7 * np.abs(jres).max()
    np.testing.assert_array_equal(tbs.residual_q.numpy(), np.asarray(jbs.residual_q))



# ----------------------------------------------------------------------
# the attention kernels' plain versions at head dim 256 against JAX
# ----------------------------------------------------------------------
def _wide_inputs(dtype: str, seed: int = 29, D: int = 256):
    """numpy inputs at head dim D (H 4 over Hkv 2), rounded to bf16 or
    f16 once where ``dtype`` is, for both frameworks: queries at a
    scatter of 150 positions over 3 pages of 128 keys per stream, a
    shuffled slab of 7 pages (2 int8 cold pages with per-(page, head)
    scales), and two packed rows of three and one segment."""
    rng = np.random.default_rng(seed)
    H, Hkv = 4, 2

    def both(a):
        a = a.astype(np.float32)
        if dtype in ("bfloat16", "float16"):
            tt = torch.from_numpy(a).to(getattr(torch, dtype))
            return jnp.asarray(tt.float().numpy()).astype(getattr(jnp, dtype)), tt
        return jnp.asarray(a), torch.from_numpy(a)

    q_pos = np.concatenate([np.arange(0, 30), np.arange(260, 380)]).astype(np.int32)
    qp = np.broadcast_to(q_pos[None], (2, len(q_pos))).copy()
    return dict(
        q=both(rng.normal(size=(2, len(q_pos), H, D))),
        qf=both(rng.normal(size=(2, 200, H, D))),
        caches=[both(rng.normal(size=(2, 384, Hkv, D))) for _ in range(2)],
        slab=[both(rng.normal(size=(7 * 128, Hkv, D))) for _ in range(2)],
        cold=(rng.integers(-127, 128, size=(256, Hkv, D)).astype(np.int8),
              rng.integers(-127, 128, size=(256, Hkv, D)).astype(np.int8),
              rng.uniform(0.01, 0.03, size=(2, Hkv)).astype(np.float32),
              rng.uniform(0.01, 0.03, size=(2, Hkv)).astype(np.float32)),
        pt=rng.permutation(7)[:6].reshape(2, 3).astype(np.int32),
        pt8=np.asarray([[7, 1, 4], [2, 8, 0]], np.int32),
        qp=qp, kvv=rng.random((2, 384)) > 0.3,
        seg=np.asarray([[0] * 60 + [1] * 100 + [2] * 40 + [-1] * 56, [3] * 256], np.int32),
        pq=both(rng.normal(size=(2, 256, H, D))),
        pkv=[both(rng.normal(size=(2, 256, Hkv, D))) for _ in range(2)])


WIDE_OPS = ("flash_refresh", "flash_refresh_paged", "flash_refresh_paged_int8",
            "flash_prefill", "flash_prefill_paged", "flash_prefill_paged_int8", "flash_packed")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("op", WIDE_OPS)
def test_plain_versions_at_head_dim_256_match_jax(op, dtype):
    _plain_matches_jax(op, dtype, 256)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("op", WIDE_OPS)
@pytest.mark.parametrize("d", [512, 320, 300])
def test_plain_versions_at_head_dims_past_256_match_jax(d, op, dtype):
    """The widths of the D-512 build (exact 512; 320 and 300, ragged on
    it, 300 off the 16-byte grid): the plain versions the card is held to
    agree with the JAX package's oracles as at 256."""
    _plain_matches_jax(op, dtype, d)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("op", WIDE_OPS)
@pytest.mark.parametrize("d", [520, 1000, 1023, 1024])
def test_plain_versions_at_head_dims_past_512_match_jax(d, op, dtype):
    """The DEEP build's widths (just past 512; 8-byte rows; odd, 2-byte
    rows; 7(l)'s 1024): the plain versions the card is held to agree with
    the JAX package's oracles as at 256."""
    _plain_matches_jax(op, dtype, d)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("op", ["flash_refresh", "flash_refresh_paged_int8", "flash_packed",
                                "flash_prefill"])
@pytest.mark.parametrize("d", [20, 33, 90])
def test_plain_versions_at_head_dims_off_the_8_grid_match_jax(d, op, dtype):
    """Head dims that are not multiples of 8 (odd, 2 and 4 mod 8), which
    the kernels now take: the plain versions the card is held to agree
    with the JAX package's oracles as at 256."""
    _plain_matches_jax(op, dtype, d)


def _plain_matches_jax(op: str, dtype: str, D: int):
    x = _wide_inputs(dtype, D=D)
    (qj, qt), (qfj, qft) = x["q"], x["qf"]
    (kj, kt), (vj, vt) = x["caches"]
    (skj, skt), (svj, svt) = x["slab"]
    qp, kvv = x["qp"], x["kvv"]
    cold_t = tuple(torch.from_numpy(a) for a in x["cold"])
    cold_j = tuple(jnp.asarray(a) for a in x["cold"])
    pt = x["pt8"] if op.endswith("int8") else x["pt"]
    cold = (cold_j, cold_t) if op.endswith("int8") else (None, None)
    t = torch.from_numpy
    if op == "flash_refresh":
        o_j = jref.flash_refresh_ref(qj, kj, vj, jnp.asarray(qp), jnp.asarray(kvv))
        o_t = flash_refresh_plain(qt, kt, vt, t(qp), t(kvv), q_chunk=64)
    elif op.startswith("flash_refresh_paged"):
        o_j = jref.flash_refresh_paged_ref(qj, skj, svj, jnp.asarray(qp), jnp.asarray(kvv),
                                           jnp.asarray(pt), cold=cold[0])
        o_t = flash_refresh_paged_plain(qt, skt, svt, t(qp), t(kvv), t(pt), q_chunk=64,
                                        cold=cold[1])
    elif op == "flash_prefill":
        o_j = jref.flash_prefill_ref(qfj, kj, vj, window=150, q_offset=60)
        o_t = flash_prefill_plain(qft, kt, vt, window=150, q_offset=60)
    elif op.startswith("flash_prefill_paged"):
        o_j = jref.flash_prefill_paged_ref(qfj, skj, svj, jnp.asarray(pt), q_offset=100,
                                           cold=cold[0])
        o_t = flash_prefill_paged_plain(qft, skt, svt, t(pt), q_offset=100, cold=cold[1])
    else:
        (pqj, pqt), ((pkj, pkt), (pvj, pvt)) = x["pq"], x["pkv"]
        o_j = jref.flash_packed_ref(pqj, pkj, pvj, jnp.asarray(x["seg"]))
        o_t = flash_packed_plain(pqt, pkt, pvt, t(x["seg"]))
    assert tuple(o_t.shape) == tuple(o_j.shape) and o_t.shape[-1] == D
    assert o_t.dtype == getattr(torch, dtype)
    tol = {"float32": 1e-5, "bfloat16": 3e-2, "float16": 4e-3}[dtype]
    np.testing.assert_allclose(o_t.float().numpy(), np.asarray(o_j, np.float32), atol=tol)


def test_rope_shift_plain_at_an_odd_half_matches_jax():
    """d 90: 45 rotation pairs a half (the kernel's one-pair chunks), f32,
    bf16 and f16, against the JAX package's oracle (test_torch_kernels.py's
    limits: 1e-4 in f32 at angles of hundreds of radians, one bf16 step;
    one f16 step, 2^-10 at values below 2)."""
    rng = np.random.default_rng(31)
    k = rng.normal(size=(2, 64, 8, 90)).astype(np.float32)
    delta = rng.integers(-700, 700, size=(2, 64)).astype(np.int32)
    for dt, tol in ((F32, 1e-4), (BF16, 2.0 ** -6), (F16, 2.0 ** -9)):
        kt = torch.from_numpy(k).to(dt)
        kj = jnp.asarray(kt.float().numpy()).astype(str(dt)[6:])
        out_t = rope_shift_plain(kt, torch.from_numpy(delta))
        out_j = jref.rope_shift_ref(kj, jnp.asarray(delta))
        assert out_t.dtype == dt and out_t.shape == k.shape
        np.testing.assert_allclose(out_t.float().numpy(), np.asarray(out_j, np.float32),
                                   atol=tol)


def test_mv_sad_plain_at_block_240_matches_jax():
    """Block 240 at radius 1 on a 240^2 frame (one macroblock of 230 KB,
    nine candidates): the motion vector equal and the SAD within 1e-5 of
    the JAX package's oracle (sums of 57,600 terms in another order)."""
    rng = np.random.default_rng(33)
    cur = (rng.random((240, 240)) * 255).astype(np.float32)
    prev = np.roll(cur, (1, -1), axis=(0, 1)) + rng.normal(0, 2, (240, 240)).astype(np.float32)
    mv_t, sad_t = mv_sad_plain(torch.from_numpy(cur), torch.from_numpy(prev), 240, 1)
    mv_j, sad_j = jref.mv_sad_ref(jnp.asarray(cur), jnp.asarray(prev), 240, 1)
    np.testing.assert_array_equal(mv_t.numpy(), np.asarray(mv_j))
    assert mv_t.numpy().tolist() == [[[1, -1]]]      # prev is cur moved by (1, -1)
    np.testing.assert_allclose(sad_t.numpy(), np.asarray(sad_j), rtol=1e-5)


def _chip_smoke():
    import importlib.util
    from pathlib import Path
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def test_chip_smoke_phase_7i_case_is_internvl3_14b_with_odd_heads():
    """chip_smoke's phase 7(i) serves internvl3-14b at full width, 12 of
    its 48 layers (CUT_LAYERS: phase 7(k) carries the full depth at full
    attention width), with 40 LM heads of 90 over 8 (refresh on the D-128
    build, rope_shift at an odd half of 45), InternViT re-cut to d_model
    1200 in 16 heads of 75 at 448^2, and search radius 128 (mv_sad's
    tiled kernel), 2 x 24 frames of codecflow; the dispatch audit's third
    table takes its every call."""
    cs = _chip_smoke()
    key, arch, cfg, modes, frames, _ = {m[0]: m for m in cs.family_models()}["(i)"]
    full = get_config("internvl3-14b")
    assert (arch, modes, frames) == (cs.ODD_ARCH, ("codecflow",), 24)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.d_head) == (
        cs.CUT_LAYERS, full.d_model, 40, 8, 90) and cs.CUT_LAYERS == 12 < full.n_layers
    assert (cfg.vit.d_model, cfg.vit.n_heads, cfg.vit.image) == (1200, 16, 448)
    assert cs.FAMILY_CODECS[key] == {"search_radius": 128} and cs.FAMILY_FRAMES[key] == 448
    assert mv_sad_launch_geometry(16, 128).tile is not None
    rows = {r.op: r for r in audit.variant_rows() if r.arch.startswith(
        "internvl3-14b, heads of 90")}
    assert set(rows) == {"mv_sad", "flash_packed", "flash_refresh", "flash_refresh_paged",
                         "rope_shift"}
    assert all(r.verdict == "kernel" for r in rows.values()), rows
    assert (rows["mv_sad"].geometry, rows["flash_packed"].geometry) == (
        "448^2 b16 r128", "ViT H 16 D 75")


def test_chip_smoke_phase_7k_case_is_internvl3_14b_with_heads_of_512():
    """chip_smoke's phase 7(k) serves internvl3-14b at full width and 12
    of its 48 layers (CUT_LAYERS: phase 7(l) carries the full depth at
    heads of 1024) with 10 LM heads of 512 over 2 and InternViT
    (d_model 1024) re-cut to 2 heads of 512 at 448^2: the parameters, the
    KV bytes per stream and the attention FLOPs of its 40 heads of 128
    over 8 and 16 ViT heads of 64; every serving kernel takes its calls
    (the dispatch audit's third table: flash_packed, flash_refresh_paged,
    flash_refresh at D 512, rope_shift at D 512), with the further paths
    per-stream caches and int8 cold pages."""
    cs = _chip_smoke()
    key, arch, cfg, modes, frames, _ = {m[0]: m for m in cs.family_models()}["(k)"]
    full = get_config("internvl3-14b")
    assert (arch, modes, frames) == (cs.D512_ARCH, ("codecflow",), 24)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.d_head) == (
        cs.CUT_LAYERS, full.d_model, 10, 2, 512)
    assert cfg.n_heads * cfg.d_head == full.n_heads * full.d_head
    assert cfg.n_kv * cfg.d_head == full.n_kv * full.d_head
    assert cfg.n_heads // cfg.n_kv == full.n_heads // full.n_kv == 5
    assert (cfg.vit.d_model, cfg.vit.n_heads, cfg.vit.image) == (full.vit.d_model, 2, 448)
    assert cfg.vit.d_model // cfg.vit.n_heads == 512
    assert cs.HEADS_512 == audit.HEADS_512 and cs.FAMILY_FRAMES[key] == 448
    assert key not in cs.FAMILY_CODECS
    assert [lab for lab, _ in cs.FAMILY_PATHS[key]] == ["per-stream KV", "int8 cold pages"]
    rows = {r.op: r for r in audit.variant_rows() if r.arch.startswith(
        "internvl3-14b, LM and ViT heads of 512")}
    assert set(rows) == {"mv_sad", "flash_packed", "flash_refresh", "flash_refresh_paged",
                         "rope_shift"}
    assert all(r.verdict == "kernel" for r in rows.values()), rows
    assert rows["flash_packed"].geometry == "ViT H 2 D 512"
    assert rows["rope_shift"].geometry == "Hkv 2, D 512, bfloat16"


def test_chip_smoke_phase_7l_case_is_internvl3_14b_with_heads_of_1024():
    """chip_smoke's phase 7(l) serves internvl3-14b at full size (48
    layers, d_model 5120) with 5 LM heads of 1024 over 1 and InternViT
    (d_model 1024) re-cut to 1 head of 1024 at 448^2: the parameters, the
    KV bytes per stream (528,482,304 in phase 4's layout) and the
    attention FLOPs of its 40 heads of 128 over 8 and 16 ViT heads of 64,
    and its GQA group of 5; every serving kernel takes its calls (the
    dispatch audit's third table: flash_packed, flash_refresh_paged,
    flash_refresh and rope_shift at D 1024, the DEEP build), with the
    further paths per-stream caches and int8 cold pages."""
    cs = _chip_smoke()
    key, arch, cfg, modes, frames, _ = {m[0]: m for m in cs.family_models()}["(l)"]
    full = get_config("internvl3-14b")
    assert (arch, modes, frames) == (cs.D1024_ARCH, ("codecflow",), 24)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.d_head) == (
        full.n_layers, full.d_model, 5, 1, 1024)
    assert cfg.n_heads * cfg.d_head == full.n_heads * full.d_head
    assert cfg.n_kv * cfg.d_head == full.n_kv * full.d_head
    assert cfg.n_heads // cfg.n_kv == full.n_heads // full.n_kv == 5
    assert (cfg.vit.d_model, cfg.vit.n_heads, cfg.vit.image) == (full.vit.d_model, 1, 448)
    assert cfg.vit.d_model // cfg.vit.n_heads == 1024
    assert cs.HEADS_1024 == audit.HEADS_1024 and cs.FAMILY_FRAMES[key] == 448
    assert key not in cs.FAMILY_CODECS and "(l)" in cs.FAMILY_BESIDE
    assert [lab for lab, _ in cs.FAMILY_PATHS[key]] == ["per-stream KV", "int8 cold pages"]
    # KV bytes per stream: K and V, 48 layers, phase 4's 2688 slots a stream (21
    # pages of 128), kv width 1024 (as 8 x 128), 2 bytes of bf16
    assert 2 * cfg.n_layers * 2688 * cfg.n_kv * cfg.d_head * 2 == 528_482_304
    rows = {r.op: r for r in audit.variant_rows() if r.arch.startswith(
        "internvl3-14b, LM and ViT heads of 1024")}
    assert set(rows) == {"mv_sad", "flash_packed", "flash_refresh", "flash_refresh_paged",
                         "rope_shift"}
    assert all(r.verdict == "kernel" for r in rows.values()), rows
    assert rows["flash_packed"].geometry == "ViT H 1 D 1024"
    assert rows["rope_shift"].geometry == "Hkv 1, D 1024, bfloat16"


def test_chip_smoke_f16_phase_names_every_kernel_with_a_float_operand():
    """chip_smoke's f16 phase (``--only f16``, also run in the full run's
    phase 3) has an f16 row for every kernel of PERF.md's rows 2-10 (every
    kernel but mv_sad, whose frames take any real dtype), each naming the
    TPU kernel it replaces and an f16 source in the checkout, with its own
    launch path (the phase's run of the ops); the attention kernels at d 90,
    512 and 1024 beside their serving shapes (on the ragged, SLAB and DEEP
    f16 builds), the scan at mamba2-2.7b's four serving shapes and at N
    256, its backward at the training shape; the registry takes f16 q/k/v
    at each of those widths."""
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    cs = _chip_smoke()
    assert set(cs.F16_ROWS) == {
        "rope_shift", "flash_refresh_paged", "flash_refresh_paged_int8", "flash_refresh",
        "flash_packed", "flash_prefill", "flash_prefill_paged", "flash_prefill_paged_int8",
        "ssd_scan", "ssd_scan_bwd"}
    for name, (replaces, source, cases) in cs.F16_ROWS.items():
        assert (root / source).is_file(), source
        assert replaces.startswith("none") or (root / replaces.split(":")[0]).is_file()
        assert cs.LAUNCH_PATH[cs.F16_NAME.format(name)] == cs.F16_PATH
        if name.startswith("flash_"):
            assert source.endswith("attention_f16.cu") and cases[-3:] == cs.F16_WIDE
    assert cs.F16_WIDE == ("D 90", "D 512", "D 1024")
    assert set(cs.F16_PACKED_HEADS) == set(cs.F16_WIDE)
    assert {label: (root / src).is_file() for label, src in cs.F16_SOURCES.items()} == {
        "D 512": True, "D 1024": True}
    assert [c[5] for c in cs.SCAN_F16.values()] == [128, 128, 128, 128, 256]
    assert [c[1] for c in cs.SCAN_F16.values()] == [160, 40, 8, 4096, 160]
    assert cs.SCAN_BWD_F16 == {"mamba2-2.7b training": (2, 2048, 80, 64, 1, 128, 256)}
    for d in (128, 90, 512, 1024):
        assert _verdicts(d, F16, F16) == {op: "ok" for op in ATTN_OPS}


@pytest.mark.parametrize("op", ["flash_prefill", "flash_refresh", "flash_packed"])
@pytest.mark.parametrize("d", [64, 90, 128])
def test_chip_smoke_f16_limit_tells_f16_from_bf16_numerics(op, d):
    """chip_smoke's f16 attention limit (F16_ROW_TOL) on the plain
    versions, with operands drawn in f16: the f16 answer sits inside it
    from the same function in f32, while the answer over operands
    rounded through bf16 (the control each f16 case runs on the kernel),
    and the f16 answer rounded through bf16, fall outside it."""
    cs = _chip_smoke()
    g = torch.Generator().manual_seed(d)
    H, Hkv, S = 4, 1, 512

    def draw(*shape):
        return torch.randn(shape, generator=g).half()

    q, k, v = draw(1, S, H, d), draw(1, S, Hkv, d), draw(1, S, Hkv, d)
    if op == "flash_prefill":
        fn = flash_prefill_plain
    elif op == "flash_refresh":
        q_pos, valid = torch.arange(S)[None], torch.ones((1, S), dtype=torch.bool)

        def fn(q, k, v):
            return flash_refresh_plain(q, k, v, q_pos, valid)
    else:
        seg = torch.as_tensor(np.repeat(np.arange(4), S // 4)[None], dtype=torch.int32)
        k, v = draw(1, S, H, d), draw(1, S, H, d)

        def fn(q, k, v):
            return flash_packed_plain(q, k, v, seg)

    def rel(a, b):
        err = (a.float() - b.float()).abs() / b.float().abs().amax(-1, keepdim=True)
        return float(err.max())

    out = fn(q, k, v)
    assert out.dtype == F16
    assert rel(out, fn(q.float(), k.float(), v.float())) <= cs.F16_ROW_TOL
    assert rel(fn(*(t.bfloat16().half() for t in (q, k, v))), out) > 2 * cs.F16_ROW_TOL
    assert rel(out.bfloat16().half(), out) > cs.F16_ROW_TOL

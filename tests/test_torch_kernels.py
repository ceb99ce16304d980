"""The port's kernel modules against the JAX package's.

* Plain PyTorch versions vs the Pallas kernels run in interpret mode (and
  vs the ``repro.kernels.ref`` oracles), on the same numpy inputs.
* Host-side visit-list maps: equal array for array.
* ``ops`` dispatch on CPU tensors, its counters and preconditions.

The CUDA kernels against their plain versions on the card are in
``test_torch_gpu.py`` (which imports no JAX).

Tolerances: f32 outputs 1e-5 (sums in another order); bf16 outputs 3e-2
(one bf16 rounding step of O(1) values, as ``tests/test_kernels.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_packed import (  # noqa: E402
    build_pack_map as j_build_pack_map, dense_pack_map as j_dense_pack_map,
    flash_packed_pallas,
)
from repro.kernels.flash_refresh import (  # noqa: E402
    build_block_map as j_build_block_map, dense_block_map as j_dense_block_map,
)
from repro.kernels.mv_sad import mv_sad_pallas  # noqa: E402
from repro.kernels.rope_shift import rope_shift_pallas  # noqa: E402
from repro_torch.kernels import cuda, ops, ref  # noqa: E402
from repro_torch.kernels.mv_sad import SMEM_LIMIT as MV_SAD_SMEM_LIMIT  # noqa: E402
from repro_torch.kernels.mv_sad import launch_geometry as mv_sad_launch_geometry  # noqa: E402
from repro_torch.kernels.flash_packed import (  # noqa: E402
    build_pack_map, dense_pack_map, flash_packed_plain,
)
from repro_torch.kernels.flash_refresh import (  # noqa: E402
    build_block_map, dense_block_map, flash_refresh_paged_plain,
)
from torch_threads import torch_one_thread  # noqa: E402,F401

BF16_TOL = 3e-2
F32_TOL = 1e-5
# f16 rounds at 2^-11: outputs of about unit size agree within a few of its
# steps (P rounded to f16 after softmaxes that differ in order)
F16_TOL = 4e-3
TOL = {"float32": F32_TOL, "bfloat16": BF16_TOL, "float16": F16_TOL}
DTYPES = ["float32", "bfloat16", "float16"]


def t(x):
    return torch.from_numpy(np.array(x))


def as_dtype(x: np.ndarray, dtype: str):
    """The same values for both frameworks: bf16 and f16 inputs are
    rounded once (through torch) and handed over as exactly representable
    f32."""
    if dtype == "float32":
        return jnp.asarray(x), t(x)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    xf = xt.float().numpy()
    return jnp.asarray(xf).astype(getattr(jnp, dtype)), xt


def f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


# ----------------------------------------------------------------------
# mv_sad
# ----------------------------------------------------------------------
def _frames(h, w, seed=0):
    rng = np.random.default_rng(seed)
    prev = rng.uniform(0, 255, (h, w)).astype(np.float32)
    cur = np.roll(prev, (2, -3), axis=(0, 1)) + rng.normal(0, 2, (h, w)).astype(np.float32)
    return cur.astype(np.float32), prev


def assert_mv_match(mv_a, sad_a, mv_b, cur, prev, block, rtol=1e-5):
    """MVs equal, except a near tie: where they differ, both candidates'
    SADs (recomputed exactly in f64) agree within rtol.  SADs are f32
    sums of block^2 terms whose order differs between the frameworks."""
    diff = np.any(mv_a != mv_b, axis=-1)
    for by, bx in zip(*np.nonzero(diff)):
        sads = []
        for mv in (mv_a[by, bx], mv_b[by, bx]):
            ys = np.clip(np.arange(by * block, (by + 1) * block) + mv[0], 0, cur.shape[0] - 1)
            xs = np.clip(np.arange(bx * block, (bx + 1) * block) + mv[1], 0, cur.shape[1] - 1)
            blk = cur[by * block:(by + 1) * block, bx * block:(bx + 1) * block]
            sads.append(np.abs(blk.astype(np.float64) - prev[np.ix_(ys, xs)]).sum())
        assert abs(sads[0] - sads[1]) <= rtol * max(sads[0], 1.0), (by, bx, sads)


@pytest.mark.parametrize("h,w,block,radius", [(64, 64, 16, 4), (112, 112, 16, 4),
                                              (64, 128, 8, 2)])
def test_mv_sad_plain_matches_pallas(h, w, block, radius):
    cur, prev = _frames(h, w)
    mv_j, sad_j = mv_sad_pallas(jnp.asarray(cur), jnp.asarray(prev), block=block,
                                radius=radius, interpret=True)
    mv_o, sad_o = jref.mv_sad_ref(jnp.asarray(cur), jnp.asarray(prev), block, radius)
    mv_t, sad_t = ref.mv_sad_ref(t(cur), t(prev), block, radius)
    assert mv_t.dtype == torch.int32 and mv_t.shape == (h // block, w // block, 2)
    for mv_r, sad_r in ((mv_j, sad_j), (mv_o, sad_o)):
        assert_mv_match(np.asarray(mv_r), np.asarray(sad_r), mv_t.numpy(), cur, prev, block)
        np.testing.assert_allclose(sad_t.numpy(), np.asarray(sad_r), rtol=1e-5)


def test_mv_sad_plain_keeps_first_minimum():
    """Ties go to the first candidate in dy-major order (strict '<')."""
    flat = np.full((32, 32), 7.0, np.float32)
    mv, sad = ref.mv_sad_ref(t(flat), t(flat), 16, 2)
    assert (mv.numpy() == -2).all() and (sad.numpy() == 0).all()


@pytest.mark.parametrize("block", [8, 16])
@pytest.mark.parametrize("radius", [2, 3, 4, 5, 6, 7])
def test_mv_sad_launch_geometry(block, radius):
    """Up to radius 7: one thread per candidate in whole warps, within
    1024 threads and the 48 KB of shared memory a block gets without
    opting in (larger radii: test_torch_operands.py); the band's row
    stride is padded to n_cand (mod 32), so the 32 consecutive candidates
    of a warp read 32 distinct banks."""
    threads, ldr, smem, tile = mv_sad_launch_geometry(block, radius)
    assert tile is None                  # one band: the untiled kernel
    n_cand, band = 2 * radius + 1, block + 2 * radius
    assert n_cand ** 2 <= threads < n_cand ** 2 + 32 and threads % 32 == 0 and threads <= 1024
    assert smem <= 48 * 1024 <= MV_SAD_SMEM_LIMIT
    assert band <= ldr < band + 32 and ldr % 32 == n_cand % 32
    banks = {(dy * ldr + dx) % 32 for dy in range(n_cand) for dx in range(n_cand)
             if dy * n_cand + dx < 32}
    assert len(banks) == min(32, n_cand ** 2)


# ----------------------------------------------------------------------
# rope_shift
# ----------------------------------------------------------------------
@pytest.mark.parametrize("dtype", DTYPES)
def test_rope_shift_plain_matches_pallas(dtype):
    rng = np.random.default_rng(1)
    k = rng.normal(size=(2, 128, 2, 64)).astype(np.float32)
    delta = rng.integers(-700, 700, size=(2, 128)).astype(np.int32)
    kj, kt = as_dtype(k, dtype)
    out_j = rope_shift_pallas(kj, jnp.asarray(delta), seq_tile=64, interpret=True)
    out_o = jref.rope_shift_ref(kj, jnp.asarray(delta))
    out_t = ref.rope_shift_ref(kt, t(delta))
    assert out_t.dtype == kt.dtype
    tol = {**TOL, "float32": 1e-4}[dtype]
    np.testing.assert_allclose(f32(out_t), f32(out_j), atol=tol)
    np.testing.assert_allclose(f32(out_t), f32(out_o), atol=tol)


def test_apply_rope_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 40, 4, 32)).astype(np.float32)
    pos = np.tile(np.arange(40, dtype=np.int32), (2, 1)) * 37
    np.testing.assert_allclose(
        ref.apply_rope_ref(t(x), t(pos)).numpy(),
        np.asarray(jref.apply_rope_ref(jnp.asarray(x), jnp.asarray(pos))), atol=1e-4)


# ----------------------------------------------------------------------
# flash_refresh_paged
# ----------------------------------------------------------------------
SCATTER_PATTERNS = {
    "anchors_only": np.arange(0, 32, dtype=np.int32),
    "anchors_tail": np.concatenate([np.arange(0, 24, dtype=np.int32),
                                    np.arange(160, 256, dtype=np.int32)]),
    "single_token": np.asarray([255], np.int32),
    "fresh": np.arange(0, 200, dtype=np.int32),
}


def _paged_case(n_streams=2, pages_per=2, h=4, hkv=2, d=32, seed=11, dtype="float32"):
    """Slab with two spare pages no stream owns, shuffled page tables and
    ragged validity — the masks, not the allocator, must hide stale rows."""
    rng = np.random.default_rng(seed)
    total = n_streams * pages_per + 2
    slab_k = rng.normal(size=(total * 128, hkv, d)).astype(np.float32)
    slab_v = rng.normal(size=(total * 128, hkv, d)).astype(np.float32)
    pt = rng.permutation(total)[: n_streams * pages_per].reshape(n_streams, pages_per)
    kvv = rng.random((n_streams, pages_per * 128)) > 0.3
    return (*as_dtype(slab_k, dtype), *as_dtype(slab_v, dtype), pt.astype(np.int32), kvv)


@pytest.mark.parametrize("pattern", sorted(SCATTER_PATTERNS))
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_refresh_paged_plain_matches_pallas(pattern, dtype):
    q_pos = SCATTER_PATTERNS[pattern]
    kj, kt, vj, vt, pt, kvv = _paged_case(dtype=dtype)
    rng = np.random.default_rng(5)
    qj, qt = as_dtype(rng.normal(size=(2, len(q_pos), 4, 32)).astype(np.float32), dtype)
    qp = np.broadcast_to(q_pos[None], (2, len(q_pos)))
    bm = j_build_block_map(q_pos, 256, tq=128, tk=128, causal=True)
    with jops.kernel_mode("interpret"):
        o_j = jops.flash_refresh_paged(qj, kj, vj, jnp.asarray(qp), jnp.asarray(kvv),
                                       jnp.asarray(pt), block_map=bm)
    o_o = jref.flash_refresh_paged_ref(qj, kj, vj, jnp.asarray(qp), jnp.asarray(kvv),
                                       jnp.asarray(pt))
    o_t = flash_refresh_paged_plain(qt, kt, vt, t(qp), t(kvv), t(pt), q_chunk=64)
    tol = TOL[dtype]
    np.testing.assert_allclose(f32(o_t), f32(o_j), atol=tol)
    np.testing.assert_allclose(f32(o_t), f32(o_o), atol=tol)


def test_flash_refresh_paged_fully_masked_rows_are_zero():
    kj, kt, vj, vt, pt, kvv = _paged_case()
    kvv[:, :] = False
    kvv[0, 5] = True
    q = torch.randn(2, 3, 4, 32)
    qp = torch.tensor([[3, 10, 20], [3, 10, 20]])
    out = flash_refresh_paged_plain(q, kt, vt, qp, t(kvv), t(pt))
    assert (out[1] == 0).all() and (out[0, 0] == 0).all()
    assert (out[0, 1:] != 0).any()


# ----------------------------------------------------------------------
# flash_refresh (per-stream caches)
# ----------------------------------------------------------------------
@pytest.mark.parametrize("pattern", sorted(SCATTER_PATTERNS))
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_refresh_plain_matches_pallas(pattern, dtype):
    """Per-stream caches (B, Sk, Hkv, D): the op's plain version (through
    a map, as the serving path calls it) against the Pallas kernel in
    interpret mode and the JAX oracle."""
    q_pos = SCATTER_PATTERNS[pattern]
    rng = np.random.default_rng(7)
    (kj, kt), (vj, vt) = (as_dtype(rng.normal(size=(2, 256, 2, 32)).astype(np.float32), dtype)
                          for _ in range(2))
    qj, qt = as_dtype(rng.normal(size=(2, len(q_pos), 4, 32)).astype(np.float32), dtype)
    kvv = rng.random((2, 256)) > 0.3
    qp = np.broadcast_to(q_pos[None], (2, len(q_pos))).copy()
    bm_j = j_build_block_map(q_pos, 256, tq=128, tk=128, causal=True)
    with jops.kernel_mode("interpret"):
        o_j = jops.flash_refresh(qj, kj, vj, jnp.asarray(qp), jnp.asarray(kvv), block_map=bm_j)
    o_o = jref.flash_refresh_ref(qj, kj, vj, jnp.asarray(qp), jnp.asarray(kvv))
    o_t = ops.flash_refresh(qt, kt, vt, t(qp), t(kvv), block_map=build_block_map(q_pos, 256),
                            q_chunk=64)
    tol = TOL[dtype]
    np.testing.assert_allclose(f32(o_t), f32(o_j), atol=tol)
    np.testing.assert_allclose(f32(o_t), f32(o_o), atol=tol)
    assert o_t.dtype == qt.dtype


# ----------------------------------------------------------------------
# flash_refresh_paged with int8 cold pages
# ----------------------------------------------------------------------
def _quant_case(seed=21, hkv=2, d=32):
    """Two-precision slab: 5 hot and 3 cold pages; stream 0 reads two
    cold pages and one hot, stream 1 one cold and two hot (unified ids:
    entry >= 5 is cold page entry - 5).  Cold content is int8 with
    per-(page, head) scales, one cold page all zero (scale 1.0)."""
    rng = np.random.default_rng(seed)
    n_hot, n_cold = 5, 3
    hk = rng.normal(size=(n_hot * 128, hkv, d)).astype(np.float32)
    hv = rng.normal(size=(n_hot * 128, hkv, d)).astype(np.float32)
    k8 = rng.integers(-127, 128, size=(n_cold * 128, hkv, d)).astype(np.int8)
    v8 = rng.integers(-127, 128, size=(n_cold * 128, hkv, d)).astype(np.int8)
    k8[256:] = 0
    ks = rng.uniform(0.005, 0.02, size=(n_cold, hkv)).astype(np.float32)
    vs = rng.uniform(0.005, 0.02, size=(n_cold, hkv)).astype(np.float32)
    ks[2] = 1.0
    pt = np.asarray([[5, 6, 2], [7, 0, 4]], np.int32)
    kvv = rng.random((2, 3 * 128)) > 0.3
    return hk, hv, (k8, v8, ks, vs), pt, kvv


@pytest.mark.parametrize("dtype", DTYPES)
def test_paged_gather_quant_equals_jax(dtype):
    hk, _, (k8, _, ks, _), pt, _ = _quant_case()
    hj, ht = as_dtype(hk, dtype)
    g_j = jref.paged_gather_quant_ref(hj, jnp.asarray(k8), jnp.asarray(ks), jnp.asarray(pt), 128)
    g_t = ref.paged_gather_quant_ref(ht, t(k8), t(ks), t(pt), 128)
    assert g_t.dtype == ht.dtype
    np.testing.assert_array_equal(f32(g_t), f32(g_j))
    assert (f32(g_t)[1, :128] == 0).all()          # the all-zero cold page


@pytest.mark.parametrize("pattern", sorted(SCATTER_PATTERNS))
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_refresh_paged_int8_plain_matches_pallas(pattern, dtype):
    q_pos = SCATTER_PATTERNS[pattern]
    hk, hv, (k8, v8, ks, vs), pt, kvv = _quant_case()
    (kj, kt), (vj, vt) = as_dtype(hk, dtype), as_dtype(hv, dtype)
    cold_j = tuple(jnp.asarray(a) for a in (k8, v8, ks, vs))
    cold_t = tuple(t(a) for a in (k8, v8, ks, vs))
    rng = np.random.default_rng(8)
    qj, qt = as_dtype(rng.normal(size=(2, len(q_pos), 4, 32)).astype(np.float32), dtype)
    qp = np.broadcast_to(q_pos[None], (2, len(q_pos))).copy()
    bm_j = j_build_block_map(q_pos, 384, tq=128, tk=128, causal=True)
    args_j = (jnp.asarray(qp), jnp.asarray(kvv), jnp.asarray(pt))
    with jops.kernel_mode("interpret"):
        o_j = jops.flash_refresh_paged(qj, kj, vj, *args_j, block_map=bm_j, cold=cold_j)
    o_o = jref.flash_refresh_paged_ref(qj, kj, vj, *args_j, cold=cold_j)
    ops.reset_dispatch_counts()
    o_t = ops.flash_refresh_paged(qt, kt, vt, t(qp), t(kvv), t(pt),
                                  block_map=build_block_map(q_pos, 384), q_chunk=64,
                                  cold=cold_t)
    assert ops.dispatch_counts() == {"flash_refresh_paged_int8": {"backend:ok": 1}}
    tol = TOL[dtype]
    np.testing.assert_allclose(f32(o_t), f32(o_j), atol=tol)
    np.testing.assert_allclose(f32(o_t), f32(o_o), atol=tol)


def test_flash_refresh_paged_int8_all_hot_equals_bf16():
    """With every page-table entry hot the cold group is never read: the
    int8 path gives exactly the bf16 path's result."""
    hk, hv, cold, _, kvv = _quant_case()
    pt = t(np.asarray([[0, 3, 1], [2, 4, 0]], np.int32))
    k, v = (torch.from_numpy(a).bfloat16() for a in (hk, hv))
    q = torch.randn(2, 200, 4, 32, generator=torch.Generator().manual_seed(0)).bfloat16()
    qp = torch.arange(200)[None].expand(2, 200)
    out8 = flash_refresh_paged_plain(q, k, v, qp, t(kvv), pt, cold=tuple(t(a) for a in cold))
    assert torch.equal(out8, flash_refresh_paged_plain(q, k, v, qp, t(kvv), pt))


@pytest.mark.parametrize("pattern", sorted(SCATTER_PATTERNS))
@pytest.mark.parametrize("window", [None, 48])
def test_block_maps_equal_jax(pattern, window):
    q_pos = SCATTER_PATTERNS[pattern]
    for build_t, build_j in ((build_block_map, j_build_block_map),
                             (dense_block_map, j_dense_block_map)):
        a = build_t(q_pos, 300, tq=64, tk=128, window=window)
        b = build_j(q_pos, 300, tq=64, tk=128, window=window)
        for f in ("tq", "tk", "n_q", "kv_len", "causal", "window", "n_q_tiles", "t_max"):
            assert getattr(a, f) == getattr(b, f), f
        for f in ("q_pos", "tile_ids", "tile_count"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        assert a.density == b.density


# ----------------------------------------------------------------------
# flash_packed
# ----------------------------------------------------------------------
def _seg_layout(rows, L):
    seg = np.full((len(rows), L), -1, np.int32)
    for r, row in enumerate(rows):
        off = 0
        for s, n in row:
            seg[r, off: off + n] = s
            off += n
    return seg


PACK_LAYOUTS = {
    "single": [[(0, 100)]],
    "multi": [[(0, 60), (1, 100), (2, 40)], [(3, 256)]],
    "ragged_pad": [[(0, 12), (1, 4)], [(2, 140)], []],
}


@pytest.mark.parametrize("layout", sorted(PACK_LAYOUTS))
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_packed_plain_matches_pallas(layout, dtype):
    seg = _seg_layout(PACK_LAYOUTS[layout], 256)
    R = seg.shape[0]
    rng = np.random.default_rng(sorted(PACK_LAYOUTS).index(layout))
    (qj, qt), (kj, kt), (vj, vt) = (
        as_dtype(rng.normal(size=(R, 256, 4, 32)).astype(np.float32), dtype)
        for _ in range(3))
    bm = j_build_pack_map(seg)
    o_j = flash_packed_pallas(qj, kj, vj, jnp.asarray(seg), jnp.asarray(bm.tile_ids),
                              jnp.asarray(bm.tile_count), interpret=True)
    o_o = jref.flash_packed_ref(qj, kj, vj, jnp.asarray(seg))
    o_t = flash_packed_plain(qt, kt, vt, t(seg), q_chunk=128)
    tol = TOL[dtype]
    np.testing.assert_allclose(f32(o_t), f32(o_j), atol=tol)
    np.testing.assert_allclose(f32(o_t), f32(o_o), atol=tol)
    assert (f32(o_t)[seg < 0] == 0).all()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pack_maps_equal_jax(seed):
    rng = np.random.default_rng(seed)
    rows = [[(s, int(rng.integers(1, 90))) for s in range(3 * r, 3 * r + 3)]
            for r in range(3)] + [[]]
    seg = _seg_layout(rows, 384)
    for build_t, build_j in ((build_pack_map, j_build_pack_map),
                             (dense_pack_map, j_dense_pack_map)):
        a, b = build_t(seg), build_j(seg)
        assert (a.tq, a.tk, a.t_max, a.visited) == (b.tq, b.tk, b.t_max, b.visited)
        np.testing.assert_array_equal(a.tile_ids, b.tile_ids)
        np.testing.assert_array_equal(a.tile_count, b.tile_count)
        assert a.density == b.density


def _scan_spans(seg):
    """first | last << 16 of each live slot's segment in its row, by a
    scan of the whole row (-1 for padding)."""
    span = np.full(seg.shape, -1, np.int64)
    for r, i in zip(*np.nonzero(seg >= 0)):
        js = np.flatnonzero(seg[r] == seg[r, i])
        span[r, i] = js[0] | js[-1] << 16
    return span


def _pack_plan_layout(seed):
    """seg_id of ``pack_plan`` on seeded random decisions: 12 frames, each
    keeping between 1 and all capacity groups, so segments share rows and
    cross 128-slot tiles."""
    from repro_torch.configs.base import ViTCfg
    from repro_torch.core.pruning import capacity_groups, pack_plan, select_tokens
    v = ViTCfg(patch=14, image=224)                 # 16 x 16 patches, 64 groups
    rng = np.random.default_rng(seed)
    kg = capacity_groups(v, 0.5)
    gdyn = np.zeros((12, v.n_groups), bool)
    for f, n in enumerate(rng.integers(1, kg + 1, 12)):
        gdyn[f, rng.choice(v.n_groups, n, replace=False)] = True
    gs, g = v.groups_per_side, v.group
    dyn = np.repeat(np.repeat(gdyn.reshape(12, gs, gs), g, 1), g, 2)
    score = rng.random(dyn.shape).astype(np.float32)
    return pack_plan(select_tokens(t(dyn), t(score), v, kg), v).seg_id


PACK_PLAN_SEEDS = (0, 1, 2)


@pytest.mark.parametrize("layout", sorted(PACK_LAYOUTS) + [
    f"pack_plan-{s}" for s in PACK_PLAN_SEEDS] + ["empty-row"])
def test_pack_map_spans_equal_a_scan(layout):
    """The kernel's per-slot key range is its segment's [first, last] slot
    of the row, and every layout pack_plan makes is single-run; the visit
    lists stay the JAX package's."""
    if layout.startswith("pack_plan"):
        seg = _pack_plan_layout(int(layout.split("-")[1]))
        assert seg.shape[1] % 128 == 0 and (np.diff(seg, axis=1) != 0).any()
    elif layout == "empty-row":
        seg = np.full((2, 256), -1, np.int32)
    else:
        seg = _seg_layout(PACK_LAYOUTS[layout], 256)
    bm, bj = build_pack_map(seg), j_build_pack_map(seg)
    assert bm.single_run
    np.testing.assert_array_equal(bm.span, _scan_spans(seg))
    np.testing.assert_array_equal(bm.seg_id, seg)
    np.testing.assert_array_equal(bm.tile_ids, bj.tile_ids)
    np.testing.assert_array_equal(bm.tile_count, bj.tile_count)


def test_pack_map_flags_split_segments_and_plain_still_answers():
    """A segment in two runs of one row is not single-run (the kernel
    refuses it on the card); the plain version answers it as the JAX
    oracle does."""
    seg = _seg_layout([[(0, 50), (1, 30), (0, 20)], [(2, 256)]], 256)
    assert not build_pack_map(seg).single_run
    assert not dense_pack_map(seg).single_run
    assert dense_pack_map(_seg_layout([[(0, 50), (1, 30)]], 256)).single_run
    rng = np.random.default_rng(9)
    q, k, v = (rng.normal(size=(2, 256, 4, 32)).astype(np.float32) for _ in range(3))
    o_t = ops.flash_packed(t(q), t(k), t(v), t(seg), build_pack_map(seg))
    o_j = jref.flash_packed_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                jnp.asarray(seg))
    np.testing.assert_allclose(f32(o_t), f32(o_j), atol=F32_TOL)


# ----------------------------------------------------------------------
# ops: dispatch, counters, preconditions
# ----------------------------------------------------------------------
def test_ops_cpu_runs_plain_and_counts():
    ops.reset_dispatch_counts()
    before = ops.launch_counts()
    cur, prev = _frames(32, 32)
    mv, _ = ops.mv_sad(t(cur), t(prev), 16, 2)
    mv_r, _ = ref.mv_sad_ref(t(cur), t(prev), 16, 2)
    assert torch.equal(mv, mv_r)
    k = torch.randn(1, 8, 2, 16)
    with ops.kernel_mode("plain"):
        ops.rope_shift(k, torch.zeros(1, 8, dtype=torch.int32))
    counts = ops.dispatch_counts()
    assert counts["mv_sad"] == {"backend:ok": 1}
    assert counts["rope_shift"] == {"backend:ok": 1}
    assert ops.plain_calls_on_cuda() == {"mv_sad": 0, "rope_shift": 0}
    assert ops.launch_counts() == before
    with pytest.raises(ValueError):
        ops.set_kernel_mode("interpret")


BAD_CALLS = {
    "mv_sad-rank": lambda: ops.mv_sad(torch.zeros(1, 32, 32), torch.zeros(1, 32, 32)),
    "mv_sad-block": lambda: ops.mv_sad(torch.zeros(30, 32), torch.zeros(30, 32)),
    "mv_sad-radius": lambda: ops.mv_sad(torch.zeros(32, 32), torch.zeros(32, 32), 16, 0),
    "rope-delta-shape": lambda: ops.rope_shift(torch.zeros(1, 8, 2, 16),
                                               torch.zeros(1, 7, dtype=torch.int32)),
    "rope-delta-dtype": lambda: ops.rope_shift(torch.zeros(1, 8, 2, 16), torch.zeros(1, 8)),
    "rope-odd-head": lambda: ops.rope_shift(torch.zeros(1, 8, 2, 15),
                                            torch.zeros(1, 8, dtype=torch.int32)),
    "refresh-gqa": lambda: ops.flash_refresh_paged(
        torch.zeros(1, 4, 3, 16), torch.zeros(128, 2, 16), torch.zeros(128, 2, 16),
        torch.zeros(1, 4, dtype=torch.int32), torch.ones(1, 128, dtype=torch.bool),
        torch.zeros(1, 1, dtype=torch.int32)),
    "refresh-kv-valid": lambda: ops.flash_refresh_paged(
        torch.zeros(1, 4, 4, 16), torch.zeros(128, 2, 16), torch.zeros(128, 2, 16),
        torch.zeros(1, 4, dtype=torch.int32), torch.ones(1, 100, dtype=torch.bool),
        torch.zeros(1, 1, dtype=torch.int32)),
    "refresh-slab-align": lambda: ops.flash_refresh_paged(
        torch.zeros(1, 4, 4, 16), torch.zeros(100, 2, 16), torch.zeros(100, 2, 16),
        torch.zeros(1, 4, dtype=torch.int32), torch.ones(1, 128, dtype=torch.bool),
        torch.zeros(1, 1, dtype=torch.int32)),
    "refresh-positions-map": lambda: ops.flash_refresh_paged(
        torch.zeros(1, 4, 4, 16), torch.zeros(128, 2, 16), torch.zeros(128, 2, 16),
        torch.tensor([[3, 4, 5, 7]]), torch.ones(1, 128, dtype=torch.bool),
        torch.zeros(1, 1, dtype=torch.int32), block_map=build_block_map([3, 4, 5, 6], 128)),
    "stream-positions-map": lambda: ops.flash_refresh(
        torch.zeros(1, 4, 4, 16), torch.zeros(1, 128, 2, 16), torch.zeros(1, 128, 2, 16),
        torch.tensor([[3, 4, 5, 7]]), block_map=build_block_map([3, 4, 5, 6], 128)),
    "stream-kv-valid": lambda: ops.flash_refresh(
        torch.zeros(1, 4, 4, 16), torch.zeros(1, 128, 2, 16), torch.zeros(1, 128, 2, 16),
        torch.zeros(1, 4, dtype=torch.int32), torch.ones(1, 100, dtype=torch.bool)),
    "stream-batch": lambda: ops.flash_refresh(
        torch.zeros(2, 4, 4, 16), torch.zeros(1, 128, 2, 16), torch.zeros(1, 128, 2, 16),
        torch.zeros(2, 4, dtype=torch.int32)),
    "cold-dtype": lambda: ops.flash_refresh_paged(
        torch.zeros(1, 4, 4, 16), torch.zeros(128, 2, 16), torch.zeros(128, 2, 16),
        torch.arange(4, dtype=torch.int32)[None], torch.ones(1, 128, dtype=torch.bool),
        torch.zeros(1, 1, dtype=torch.int32), block_map=build_block_map(np.arange(4), 128),
        cold=(torch.zeros(128, 2, 16), torch.zeros(128, 2, 16), torch.ones(1, 2),
              torch.ones(1, 2))),
    "cold-scale": lambda: ops.flash_refresh_paged(
        torch.zeros(1, 4, 4, 16), torch.zeros(128, 2, 16), torch.zeros(128, 2, 16),
        torch.zeros(1, 4, dtype=torch.int32), torch.ones(1, 128, dtype=torch.bool),
        torch.zeros(1, 1, dtype=torch.int32),
        cold=(torch.zeros(128, 2, 16, dtype=torch.int8), torch.zeros(128, 2, 16, dtype=torch.int8),
              torch.ones(2, 2), torch.ones(2, 2))),
    "refresh-page-range": lambda: ops.flash_refresh_paged(
        torch.zeros(1, 4, 4, 16), torch.zeros(128, 2, 16), torch.zeros(128, 2, 16),
        torch.zeros(1, 4, dtype=torch.int32), torch.ones(1, 128, dtype=torch.bool),
        torch.ones(1, 1, dtype=torch.int32)),
    "cold-page-range": lambda: ops.flash_refresh_paged(
        torch.zeros(1, 4, 4, 16), torch.zeros(128, 2, 16), torch.zeros(128, 2, 16),
        torch.zeros(1, 4, dtype=torch.int32), torch.ones(1, 256, dtype=torch.bool),
        torch.tensor([[1, 2]], dtype=torch.int32),
        cold=(torch.zeros(128, 2, 16, dtype=torch.int8), torch.zeros(128, 2, 16, dtype=torch.int8),
              torch.ones(1, 2), torch.ones(1, 2))),
    "packed-seg-shape": lambda: ops.flash_packed(
        torch.zeros(1, 128, 4, 16), torch.zeros(1, 128, 4, 16), torch.zeros(1, 128, 4, 16),
        torch.zeros(1, 64, dtype=torch.int32)),
    "packed-segments-map": lambda: ops.flash_packed(
        torch.zeros(1, 128, 4, 16), torch.zeros(1, 128, 4, 16), torch.zeros(1, 128, 4, 16),
        torch.zeros(1, 128, dtype=torch.int32),
        block_map=build_pack_map(np.ones((1, 128), np.int32))),
    "packed-dtype": lambda: ops.flash_packed(
        torch.zeros(1, 128, 4, 16), torch.zeros(1, 128, 4, 16, dtype=torch.float64),
        torch.zeros(1, 128, 4, 16, dtype=torch.float64), torch.zeros(1, 128, dtype=torch.int32)),
}


# cases the registry refuses by an eligibility rule, as the JAX package's
# does: the card raises KernelIneligibleError, the CPU runs the plain
# version and records the code in ``card_verdicts``
REFUSED_ON_CARD = {"cold-dtype": ("flash_refresh_paged_int8", "cold-dtype")}


@pytest.mark.parametrize("case", sorted(BAD_CALLS))
def test_ops_preconditions_raise(case):
    if case in REFUSED_ON_CARD:
        op, code = REFUSED_ON_CARD[case]
        ops.reset_card_verdicts()
        BAD_CALLS[case]()
        assert ops.card_verdicts() == {op: {code: 1}}
        return
    with pytest.raises(ops.KernelContractError):
        BAD_CALLS[case]()


def test_refresh_positions_checked_against_map():
    """A map must be built for the caller's positions; the check is
    repeated when the positions tensor changes in place."""
    bm = build_block_map([3, 4, 5, 6], 128)
    q = torch.randn(1, 4, 4, 16)
    slab = torch.randn(128, 2, 16)
    qp = torch.tensor([[3, 4, 5, 6]])
    args = (slab, slab, qp, torch.ones(1, 128, dtype=torch.bool),
            torch.zeros(1, 1, dtype=torch.int32))
    out = ops.flash_refresh_paged(q, *args, block_map=bm)
    torch.testing.assert_close(out, flash_refresh_paged_plain(q, *args))
    ops.flash_refresh_paged(q, *args, block_map=bm)
    qp[0, 3] = 7
    with pytest.raises(ops.KernelContractError, match="positions-match"):
        ops.flash_refresh_paged(q, *args, block_map=bm)


def test_packed_segments_checked_against_map():
    """A pack map must be built from the caller's layout; the check is
    repeated when the layout tensor changes in place."""
    seg = torch.from_numpy(_seg_layout([[(0, 60), (1, 68)]], 128))
    bm = build_pack_map(seg.numpy())
    q = torch.randn(1, 128, 4, 16)
    out = ops.flash_packed(q, q, q, seg, bm)
    torch.testing.assert_close(out, flash_packed_plain(q, q, q, seg))
    ops.flash_packed(q, q, q, seg, bm)
    seg[0, 127] = -1
    with pytest.raises(ops.KernelContractError, match="segments-match"):
        ops.flash_packed(q, q, q, seg, bm)


def test_cuda_library_is_not_built_at_import():
    assert cuda._LIB is None or torch.cuda.is_available()
    assert cuda.BUILD_DIR.parts[-2:] == ("build", "repro_torch")
    assert {p.name for p in cuda.CSRC.glob("*.cu")} == set(cuda.SOURCES)


@pytest.mark.parametrize("offset", [0, 1, 16])
def test_refresh_kv_valid_is_handed_over_aligned(offset):
    """The refresh kernels copy kv_valid in 16-byte pieces: a view that
    starts off a 16-byte boundary is copied once, values unchanged."""
    from repro_torch.kernels.flash_refresh import _valid_bytes
    base = torch.from_numpy(np.random.default_rng(offset).random(2 * 256 + 16) > 0.5)
    view = base[offset: offset + 2 * 256].view(2, 256)
    out = _valid_bytes(view)
    assert out.data_ptr() % 16 == 0 and out.is_contiguous()
    assert torch.equal(out, view)
    assert (out.data_ptr() == view.data_ptr()) == (view.data_ptr() % 16 == 0)

"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is ``gpu``-marked and skips without a CUDA device (the
decision is made in a fixture, never at import).  The file imports no
JAX, so it also runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

(``--noconftest``: the repository's ``tests/conftest.py`` imports JAX.)
``python3 chip_smoke.py`` makes the same comparisons at serving shapes.

Tolerances: f32 SADs 1e-5 relative with the near-tie rule for MVs.
rope_shift in bf16: elementwise, one bf16 step of the value (2^-7
relative) plus 1e-3 for the f32 angle.  Attention: per (.., head) row,
max |k - p| / max |p| within two bf16 steps (2^-6) of the row's largest
value, since the kernel rounds its unnormalised probabilities and the
plain version its normalised ones.  Fully masked rows and padding slots
exactly zero (refresh, packed); rows with no visible key the mean of V
(prefill, as its plain version).  ssd_scan: y (bf16) within one bf16
step (2^-7) of each (b, t, head) row's largest value, since both round
f32 values that differ by the summation order; the f32 state within
1e-4 of each (b, head) state's largest value (sums of up to 256 terms
and the cumulative log-decay taken in another order, the latter entering
through exp).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.flash_packed import (  # noqa: E402
    build_pack_map, flash_packed_cuda, flash_packed_plain,
)
from repro_torch.kernels.cuda import KernelError  # noqa: E402
from repro_torch.kernels.flash_prefill import (  # noqa: E402
    flash_prefill_cuda, flash_prefill_paged_cuda, flash_prefill_paged_plain,
    flash_prefill_plain,
)
from repro_torch.kernels.flash_refresh import (  # noqa: E402
    build_block_map, flash_refresh_cuda, flash_refresh_paged_cuda,
    flash_refresh_paged_plain, flash_refresh_plain,
)
from repro_torch.kernels.ssd_scan import ssd_scan_cuda, ssd_scan_plain  # noqa: E402
from repro_torch.kernels.mv_sad import mv_sad_cuda  # noqa: E402
from repro_torch.kernels.rope_shift import rope_shift_cuda  # noqa: E402

# row-relative limits: two bf16 steps where the kernel rounds its
# probabilities to bf16 (refresh, packed); one where it keeps the
# oracle's f32 numerics and only the output's rounding differs (prefill)
ROW_TOL = 2.0 ** -6
PREFILL_ROW_TOL = 2.0 ** -7
pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _row_rel_err(out_k, out_p):
    """Max over (.., head) rows of max |k - p| / max |p|."""
    d = (out_k.float() - out_p.float()).abs()
    scale = out_p.float().abs().amax(-1, keepdim=True)
    return (d / scale.clamp_min(torch.finfo(torch.float32).tiny)).max().item()


def _frames(h, w, seed=0):
    rng = np.random.default_rng(seed)
    prev = rng.uniform(0, 255, (h, w)).astype(np.float32)
    cur = np.roll(prev, (2, -3), axis=(0, 1)) + rng.normal(0, 2, (h, w)).astype(np.float32)
    return torch.from_numpy(cur.astype(np.float32)), torch.from_numpy(prev)


def _sad_at(cur, prev, mv, block):
    H, W = cur.shape
    yy, xx = torch.meshgrid(torch.arange(H), torch.arange(W), indexing="ij")
    dy = mv[..., 0].repeat_interleave(block, 0).repeat_interleave(block, 1)
    dx = mv[..., 1].repeat_interleave(block, 0).repeat_interleave(block, 1)
    pred = prev.double()[(yy + dy).clamp(0, H - 1), (xx + dx).clamp(0, W - 1)]
    hb, wb = H // block, W // block
    return (cur.double() - pred).abs().reshape(hb, block, wb, block).sum(dim=(1, 3))


@pytest.mark.parametrize("hw,block,radius", [(448, 16, 4), (112, 16, 4), (64, 8, 2),
                                             (224, 16, 7)])
def test_mv_sad_kernel_matches_plain(dev, hw, block, radius):
    cur, prev = _frames(hw, hw)
    mv_k, sad_k = mv_sad_cuda(cur.to(dev), prev.to(dev), block, radius)
    mv_p, sad_p = ref.mv_sad_ref(cur, prev, block, radius)
    mv_k, sad_k = mv_k.cpu(), sad_k.cpu()
    torch.testing.assert_close(sad_k, sad_p, rtol=1e-5, atol=1e-3)
    flipped = (mv_k != mv_p).any(-1)
    # near-tie rule: a flipped MV must have the same SAD within 1e-5
    tie = (_sad_at(cur, prev, mv_k, block) - _sad_at(cur, prev, mv_p, block)).abs()
    assert bool((~flipped | (tie <= 1e-5 * sad_p.double().clamp(min=1))).all())


def test_mv_sad_exact_ties_keep_the_first_minimum(dev):
    """Frames that repeat every 4 pixels, integer-valued: every SAD is
    exact in any summation order, and candidates 4 apart tie exactly
    inside the frame.  The kernel must return the plain version's first
    minimum in dy-major order (strict '<') at every macroblock."""
    rng = np.random.default_rng(7)
    prev = np.tile(rng.integers(0, 256, (4, 4)), (28, 28)).astype(np.float32)
    cur = np.tile(rng.integers(0, 256, (4, 4)), (28, 28)).astype(np.float32)
    cur, prev = torch.from_numpy(cur), torch.from_numpy(prev)
    mv_k, sad_k = mv_sad_cuda(cur.to(dev), prev.to(dev), 16, 4)
    mv_p, sad_p = ref.mv_sad_ref(cur, prev, 16, 4)
    assert torch.equal(sad_k.cpu(), sad_p)
    assert torch.equal(mv_k.cpu(), mv_p)
    # inside the frame the winner is the first of its class of ties
    assert bool((mv_p[1:-1, 1:-1] < 0).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rope_shift_kernel_matches_plain(dev, dtype):
    g = torch.Generator(device=dev).manual_seed(0)
    k = torch.randn(4, 300, 8, 128, device=dev, generator=g).to(dtype)
    delta = torch.randint(-700, 700, (4, 300), device=dev, dtype=torch.int32, generator=g)
    out_k = rope_shift_cuda(k, delta)
    out_p = ref.rope_shift_ref(k, delta)
    assert out_k.dtype == dtype
    d = (out_k.float() - out_p.float()).abs()
    if dtype == torch.bfloat16:
        d = d - 2.0 ** -7 * out_p.float().abs()
        assert d.max().item() <= 1e-3
    else:
        assert d.max().item() <= 1e-4


@pytest.mark.parametrize("d_h", [24, 64, 128])
@pytest.mark.parametrize("n_kv", [1, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rope_shift_kernel_at_head_widths(dev, d_h, n_kv, dtype):
    """Token counts that fill no whole block, per-token deltas including
    0 and +-2000 (angles past 2000 rad), every head of a token rotated by
    the token's angles."""
    g = torch.Generator(device=dev).manual_seed(3)
    k = torch.randn(3, 133, n_kv, d_h, device=dev, generator=g).to(dtype)
    delta = torch.randint(-2000, 2001, (3, 133), device=dev, dtype=torch.int32, generator=g)
    delta[0, :3] = torch.tensor([0, 2000, -2000], device=dev)
    out_k = rope_shift_cuda(k, delta)
    out_p = ref.rope_shift_ref(k, delta)
    d = (out_k.float() - out_p.float()).abs()
    if dtype == torch.bfloat16:
        d = d - 2.0 ** -7 * out_p.float().abs()
        assert d.max().item() <= 1e-3
    else:
        assert d.max().item() <= 1e-4
    assert torch.equal(out_k[0, 0], k[0, 0])       # delta 0: no rotation


def test_rope_shift_operands_the_kernel_does_not_take_raise(dev):
    delta = torch.zeros(1, 4, dtype=torch.int32, device=dev)
    with pytest.raises(KernelError, match="head dim"):
        rope_shift_cuda(torch.zeros(1, 4, 2, 20, device=dev, dtype=torch.bfloat16), delta)
    with pytest.raises(KernelError, match="head dim"):
        rope_shift_cuda(torch.zeros(1, 4, 2, 12, device=dev), delta)
    with pytest.raises(KernelError, match="aligned"):
        rope_shift_cuda(torch.zeros(4 * 2 * 64 + 2, device=dev)[2:].view(1, 4, 2, 64), delta)


SCATTER_PATTERNS = {
    "anchors_tail": np.concatenate([np.arange(0, 24), np.arange(160, 256)]),
    "single_token": np.asarray([255]),
    "fresh": np.arange(0, 200),
    "decode": np.asarray([201]),
}


@pytest.mark.parametrize("pattern", sorted(SCATTER_PATTERNS))
@pytest.mark.parametrize("d,h,hkv,window", [(128, 8, 2, None), (64, 4, 4, None),
                                            (32, 4, 1, 48),
                                            (128, 16, 16, None),    # olmoe-1b-7b's heads
                                            (24, 4, 2, None)])      # the JAX benchmarks' VLM
def test_flash_refresh_paged_kernel_matches_plain(dev, pattern, d, h, hkv, window):
    q_pos = SCATTER_PATTERNS[pattern].astype(np.int32)
    rng = np.random.default_rng(11)
    total = 6
    k = torch.from_numpy(rng.normal(size=(total * 128, hkv, d)).astype(np.float32)).bfloat16()
    v = torch.from_numpy(rng.normal(size=(total * 128, hkv, d)).astype(np.float32)).bfloat16()
    pt = torch.from_numpy(rng.permutation(total)[:4].reshape(2, 2).astype(np.int32))
    kvv = torch.from_numpy(rng.random((2, 256)) > 0.3)
    q = torch.from_numpy(rng.normal(size=(2, len(q_pos), h, d)).astype(np.float32)).bfloat16()
    qp = torch.from_numpy(np.broadcast_to(q_pos[None], (2, len(q_pos))).copy())
    bm = build_block_map(q_pos, 256, window=window)
    before = ops.launch_counts().get("flash_refresh_paged", 0)
    out_k = flash_refresh_paged_cuda(q.to(dev), k.to(dev), v.to(dev), kvv.to(dev),
                                     pt.to(dev), bm, window=window).cpu()
    assert ops.launch_counts()["flash_refresh_paged"] == before + 1
    out_p = flash_refresh_paged_plain(q, k, v, qp, kvv, pt, window=window)
    assert _row_rel_err(out_k, out_p) <= ROW_TOL
    dead = (out_p == 0).all(-1).all(-1)          # rows no key reaches
    assert bool((out_k[dead] == 0).all())


@pytest.mark.parametrize("pattern", sorted(SCATTER_PATTERNS))
@pytest.mark.parametrize("d,h,hkv,window", [(128, 8, 2, None), (64, 4, 4, None),
                                            (32, 4, 1, 48),
                                            (128, 32, 8, None),     # jamba-v0.1-52b's heads
                                            (24, 4, 2, 48)])        # the JAX benchmarks' VLM
def test_flash_refresh_kernel_matches_plain(dev, pattern, d, h, hkv, window):
    """Per-stream caches (B, Sk, Hkv, D), no page table."""
    q_pos = SCATTER_PATTERNS[pattern].astype(np.int32)
    rng = np.random.default_rng(12)
    k, v = (torch.from_numpy(rng.normal(size=(2, 256, hkv, d)).astype(np.float32)).bfloat16()
            for _ in range(2))
    kvv = torch.from_numpy(rng.random((2, 256)) > 0.3)
    q = torch.from_numpy(rng.normal(size=(2, len(q_pos), h, d)).astype(np.float32)).bfloat16()
    qp = torch.from_numpy(np.broadcast_to(q_pos[None], (2, len(q_pos))).copy())
    bm = build_block_map(q_pos, 256, window=window)
    before = ops.launch_counts().get("flash_refresh", 0)
    out_k = flash_refresh_cuda(q.to(dev), k.to(dev), v.to(dev), kvv.to(dev), bm,
                               window=window).cpu()
    assert ops.launch_counts()["flash_refresh"] == before + 1
    out_p = flash_refresh_plain(q, k, v, qp, kvv, window=window)
    assert _row_rel_err(out_k, out_p) <= ROW_TOL
    dead = (out_p == 0).all(-1).all(-1)
    assert bool((out_k[dead] == 0).all())


def _quant_slab(rng, n_hot, n_cold, hkv, d):
    """Hot bf16 pages and int8 cold pages with per-(page, head) scales
    that dequantise to about unit values, as demotion leaves them."""
    hk, hv = (torch.from_numpy(rng.normal(size=(n_hot * 128, hkv, d)).astype(np.float32))
              .bfloat16() for _ in range(2))
    k8, v8 = (torch.from_numpy(rng.integers(-127, 128, size=(n_cold * 128, hkv, d))
                               .astype(np.int8)) for _ in range(2))
    ks, vs = (torch.from_numpy(rng.uniform(0.01, 0.03, size=(n_cold, hkv)).astype(np.float32))
              for _ in range(2))
    return hk, hv, (k8, v8, ks, vs)


@pytest.mark.parametrize("pattern", sorted(SCATTER_PATTERNS))
@pytest.mark.parametrize("d,h,hkv", [(128, 8, 2), (32, 4, 1), (24, 4, 2)])
def test_flash_refresh_paged_int8_kernel_matches_plain(dev, pattern, d, h, hkv):
    """A page table that mixes hot and cold entries (ids >= n_hot)."""
    q_pos = SCATTER_PATTERNS[pattern].astype(np.int32)
    rng = np.random.default_rng(13)
    hk, hv, cold = _quant_slab(rng, 4, 3, hkv, d)
    pt = torch.tensor([[4, 1], [3, 6]], dtype=torch.int32)
    kvv = torch.from_numpy(rng.random((2, 256)) > 0.3)
    q = torch.from_numpy(rng.normal(size=(2, len(q_pos), h, d)).astype(np.float32)).bfloat16()
    qp = torch.from_numpy(np.broadcast_to(q_pos[None], (2, len(q_pos))).copy())
    bm = build_block_map(q_pos, 256)
    before = ops.launch_counts().get("flash_refresh_paged_int8", 0)
    out_k = flash_refresh_paged_cuda(q.to(dev), hk.to(dev), hv.to(dev), kvv.to(dev),
                                     pt.to(dev), bm, cold=tuple(c.to(dev) for c in cold)).cpu()
    assert ops.launch_counts()["flash_refresh_paged_int8"] == before + 1
    out_p = flash_refresh_paged_plain(q, hk, hv, qp, kvv, pt, cold=cold)
    assert _row_rel_err(out_k, out_p) <= ROW_TOL
    dead = (out_p == 0).all(-1).all(-1)
    assert bool((out_k[dead] == 0).all())


def test_flash_refresh_paged_int8_all_hot_is_bitwise_bf16(dev):
    """Every entry hot: the int8 kernel loads the same bf16 tiles as the
    bf16 kernel, so the results are bitwise equal."""
    rng = np.random.default_rng(14)
    hk, hv, cold = _quant_slab(rng, 4, 3, 2, 128)
    hk, hv, cold = hk.to(dev), hv.to(dev), tuple(c.to(dev) for c in cold)
    pt = torch.tensor([[2, 0], [1, 3]], dtype=torch.int32, device=dev)
    kvv = torch.from_numpy(rng.random((2, 256)) > 0.3).to(dev)
    q_pos = SCATTER_PATTERNS["fresh"]
    q = torch.from_numpy(rng.normal(size=(2, len(q_pos), 8, 128)).astype(np.float32)).bfloat16()
    bm = build_block_map(q_pos, 256)
    out8 = flash_refresh_paged_cuda(q.to(dev), hk, hv, kvv, pt, bm, cold=cold)
    out16 = flash_refresh_paged_cuda(q.to(dev), hk, hv, kvv, pt, bm)
    assert torch.equal(out8, out16)


# Visit lists of 8-10 tiles (16-20 steps of 64 keys, wrapping the
# kernels' ring of three slots several times): q positions, kv length,
# sliding window.  Query counts that are not multiples of 128 reach the
# kernel unpadded.
LONG_CASES = {
    "fresh": (np.arange(1100), 1280, None),
    "fresh-window": (np.arange(1100), 1280, 1000),
    "scatter": (np.concatenate([np.arange(0, 40), np.arange(700, 1250)]), 1280, None),
    "decode": (np.asarray([1250]), 1280, None),
    "scatter-window": (np.concatenate([np.arange(0, 40), np.arange(700, 1250)]), 1280, 900),
}


@pytest.mark.parametrize("kind", ["stream", "paged", "paged-int8"])
@pytest.mark.parametrize("case", sorted(LONG_CASES))
def test_refresh_kernels_over_long_visit_lists(dev, case, kind):
    """GQA at internvl3-14b's ratio (10 : 2 heads) and head dim; the
    paged kinds read a shuffled slab, the int8 one with every other page
    of each stream cold."""
    q_pos, kv_len, window = LONG_CASES[case]
    q_pos = q_pos.astype(np.int32)
    rng = np.random.default_rng(15)
    B, h, hkv, d = 2, 10, 2, 128
    n_pages = kv_len // 128
    q = torch.from_numpy(rng.normal(size=(B, len(q_pos), h, d)).astype(np.float32)).bfloat16()
    qp = torch.from_numpy(np.broadcast_to(q_pos[None], (B, len(q_pos))).copy())
    kvv = torch.from_numpy(rng.random((B, kv_len)) > 0.2)
    bm = build_block_map(q_pos, kv_len, window=window)
    assert bm.t_max >= 8
    if kind == "stream":
        k, v = (torch.from_numpy(rng.normal(size=(B, kv_len, hkv, d)).astype(np.float32))
                .bfloat16() for _ in range(2))
        out_k = flash_refresh_cuda(q.to(dev), k.to(dev), v.to(dev), kvv.to(dev), bm,
                                   window=window).cpu()
        out_p = flash_refresh_plain(q, k, v, qp, kvv, window=window)
    else:
        n_hot = B * n_pages + 3
        hk, hv, cold = _quant_slab(rng, n_hot, B * n_pages // 2, hkv, d)
        pt = rng.permutation(n_hot)[: B * n_pages].reshape(B, n_pages)
        if kind == "paged-int8":
            pt[:, ::2] = n_hot + rng.permutation(B * n_pages // 2).reshape(B, -1)
        else:
            cold = None
        pt = torch.from_numpy(pt.astype(np.int32))
        out_k = flash_refresh_paged_cuda(
            q.to(dev), hk.to(dev), hv.to(dev), kvv.to(dev), pt.to(dev), bm, window=window,
            cold=None if cold is None else tuple(c.to(dev) for c in cold)).cpu()
        out_p = flash_refresh_paged_plain(q, hk, hv, qp, kvv, pt, window=window, cold=cold)
    assert out_k.shape == out_p.shape
    assert _row_rel_err(out_k, out_p) <= ROW_TOL
    dead = (out_p == 0).all(-1).all(-1)
    assert bool((out_k[dead] == 0).all())


def test_stream_map_for_other_positions_raises_on_card(dev):
    q = torch.zeros(1, 4, 4, 32, device=dev, dtype=torch.bfloat16)
    cache = torch.zeros(1, 128, 2, 32, device=dev, dtype=torch.bfloat16)
    qp = torch.tensor([[3, 4, 5, 7]], device=dev)
    before = ops.launch_counts().get("flash_refresh", 0)
    with pytest.raises(ops.KernelContractError, match="positions-match"):
        ops.flash_refresh(q, cache, cache, qp, block_map=build_block_map([3, 4, 5, 6], 128))
    with pytest.raises(ops.KernelContractError, match="RefreshBlockMap"):
        ops.flash_refresh(q, cache, cache, qp)
    assert ops.launch_counts().get("flash_refresh", 0) == before
    ops.flash_refresh(q, cache, cache, qp, block_map=build_block_map([3, 4, 5, 7], 128))
    assert ops.launch_counts()["flash_refresh"] == before + 1


def _seg_layout(rows, L):
    seg = np.full((len(rows), L), -1, np.int32)
    for r, row in enumerate(rows):
        off = 0
        for s, n in row:
            seg[r, off: off + n] = s
            off += n
    return seg


def _first_fit(lengths, L):
    """pack_plan's layout of segments of the given lengths: first fit in
    order, each segment one run."""
    rows, used = [], []
    for s, n in enumerate(lengths):
        r = next((i for i, u in enumerate(used) if u + n <= L), len(used))
        if r == len(used):
            rows.append([])
            used.append(0)
        rows[r].append((s, n))
        used[r] += n
    return rows


# (rows of (segment, length), row length).  busy: every frame keeps its
# whole 512-slot budget; mixed: kept-group counts in [1, 128] (4 slots a
# group), so segments share rows and cross 128-slot tiles
PACK_LAYOUTS = {
    "single": ([[(0, 100)]], 256),
    "multi": ([[(0, 60), (1, 100), (2, 40)], [(3, 256)]], 256),
    "ragged_pad": ([[(0, 12), (1, 4)], [(2, 140)], []], 256),
    "one_slot": ([[(0, 1), (1, 127), (2, 1), (3, 1), (4, 126)]], 256),
    "busy": ([[(s, 512)] for s in range(6)], 512),
    "mixed": (_first_fit(4 * np.random.default_rng(17).integers(1, 129, 16), 512), 512),
}


def _packed_inputs(layout, h, hkv, d, seed=1):
    rows, L = PACK_LAYOUTS[layout]
    seg = torch.from_numpy(_seg_layout(rows, L))
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(seg.shape[0], L, h, d, generator=g).bfloat16()
    k, v = (torch.randn(seg.shape[0], L, hkv, d, generator=g).bfloat16() for _ in range(2))
    return q, k, v, seg


@pytest.mark.parametrize("layout", sorted(PACK_LAYOUTS))
@pytest.mark.parametrize("d", [24, 32, 64, 128])
def test_flash_packed_kernel_matches_plain(dev, layout, d):
    q, k, v, seg = _packed_inputs(layout, 16, 16, d)
    bm = build_pack_map(seg.numpy())
    assert bm.single_run
    out_k = flash_packed_cuda(q.to(dev), k.to(dev), v.to(dev), bm).cpu()
    out_p = flash_packed_plain(q, k, v, seg)
    assert _row_rel_err(out_k, out_p) <= ROW_TOL
    assert bool((out_k[seg < 0] == 0).all())


@pytest.mark.parametrize("layout", ["mixed", "multi"])
@pytest.mark.parametrize("d", [64, 128])
def test_flash_packed_gqa_matches_plain(dev, layout, d):
    """16 query heads over 4 kv heads."""
    q, k, v, seg = _packed_inputs(layout, 16, 4, d, seed=2)
    out_k = flash_packed_cuda(q.to(dev), k.to(dev), v.to(dev),
                              build_pack_map(seg.numpy())).cpu()
    out_p = flash_packed_plain(q, k, v, seg)
    assert _row_rel_err(out_k, out_p) <= ROW_TOL
    assert bool((out_k[seg < 0] == 0).all())


def test_flash_packed_split_segment_raises_on_card(dev):
    """A segment in two runs of a row is refused by the kernel (its mask
    is one key range per slot), never handed to the plain version."""
    seg = torch.from_numpy(_seg_layout([[(0, 50), (1, 30), (0, 20)]], 128)).to(dev)
    bm = build_pack_map(seg.cpu().numpy())
    q = torch.zeros(1, 128, 2, 32, device=dev, dtype=torch.bfloat16)
    before = ops.launch_counts().get("flash_packed", 0)
    ops.reset_dispatch_counts()
    with pytest.raises(ops.KernelContractError, match="single-run"):
        flash_packed_cuda(q, q, q, bm)
    with pytest.raises(ops.KernelContractError, match="single-run"):
        ops.flash_packed(q, q, q, seg, bm)
    assert ops.launch_counts().get("flash_packed", 0) == before
    assert ops.plain_calls_on_cuda().get("flash_packed", 0) == 0


def test_ops_route_cuda_tensors_to_kernels(dev):
    """auto mode launches the kernel on CUDA tensors; plain mode runs the
    plain version there and is counted as such."""
    ops.reset_dispatch_counts()
    cur, prev = _frames(64, 64)
    before = ops.launch_counts().get("mv_sad", 0)
    ops.mv_sad(cur.to(dev), prev.to(dev))
    assert ops.launch_counts()["mv_sad"] == before + 1
    with ops.kernel_mode("plain"):
        ops.mv_sad(cur.to(dev), prev.to(dev))
    assert ops.launch_counts()["mv_sad"] == before + 1
    assert ops.dispatch_counts()["mv_sad"] == {"kernel": 1, "mode:plain": 1}
    assert ops.plain_calls_on_cuda()["mv_sad"] == 1
    with pytest.raises(ops.KernelContractError):
        ops.flash_packed(*(torch.zeros(1, 128, 2, 32, device=dev, dtype=torch.bfloat16)
                           for _ in range(3)), torch.zeros(1, 128, dtype=torch.int32, device=dev))


def test_refresh_map_for_other_positions_raises_on_card(dev):
    """The kernel masks by the map's positions: a map built for other
    positions of the same length is refused, not silently used."""
    q = torch.zeros(1, 4, 4, 32, device=dev, dtype=torch.bfloat16)
    slab = torch.zeros(128, 2, 32, device=dev, dtype=torch.bfloat16)
    args = (slab, slab, torch.tensor([[3, 4, 5, 7]], device=dev),
            torch.ones(1, 128, dtype=torch.bool, device=dev),
            torch.zeros(1, 1, dtype=torch.int32, device=dev))
    before = ops.launch_counts().get("flash_refresh_paged", 0)
    with pytest.raises(ops.KernelContractError, match="positions-match"):
        ops.flash_refresh_paged(q, *args, block_map=build_block_map([3, 4, 5, 6], 128))
    assert ops.launch_counts().get("flash_refresh_paged", 0) == before
    ops.flash_refresh_paged(q, *args, block_map=build_block_map([3, 4, 5, 7], 128))
    assert ops.launch_counts()["flash_refresh_paged"] == before + 1


def test_page_ids_out_of_range_raise_on_card(dev):
    """An entry past the hot and cold slabs is refused before the kernel
    could read outside them."""
    rng = np.random.default_rng(15)
    hk, hv, cold = _quant_slab(rng, 2, 1, 2, 32)
    hk, hv, cold = hk.to(dev), hv.to(dev), tuple(c.to(dev) for c in cold)
    q = torch.zeros(1, 4, 4, 32, device=dev, dtype=torch.bfloat16)
    qp = torch.tensor([[3, 4, 5, 6]], device=dev)
    kvv = torch.ones(1, 256, dtype=torch.bool, device=dev)
    bm = build_block_map([3, 4, 5, 6], 256)
    before = ops.launch_counts().get("flash_refresh_paged_int8", 0)
    with pytest.raises(ops.KernelContractError, match="page-range"):
        ops.flash_refresh_paged(q, hk, hv, qp, kvv,
                                torch.tensor([[2, 3]], dtype=torch.int32, device=dev),
                                block_map=bm, cold=cold)
    assert ops.launch_counts().get("flash_refresh_paged_int8", 0) == before
    ops.flash_refresh_paged(q, hk, hv, qp, kvv,
                            torch.tensor([[2, 1]], dtype=torch.int32, device=dev),
                            block_map=bm, cold=cold)
    assert ops.launch_counts()["flash_refresh_paged_int8"] == before + 1


# ----------------------------------------------------------------------
# prefill attention
# ----------------------------------------------------------------------
# (Sq, Sk, H, Hkv, D, causal, window, q_offset): causal from 0, a chunk at
# an offset, a window, bidirectional, rows with no visible key (a
# negative offset; a window past Sk), ragged Sq and Sk; keys ending part
# way through a 64-key step; five causal query tiles at internvl3-14b's
# GQA ratio 5 : 1; a window whose lower edge falls inside a step; tiles
# that mix rows with and without visible keys across warps (a prefix, and
# a suffix past Sk)
PREFILL = {
    "causal": (256, 256, 8, 2, 128, True, None, 0),
    "chunk-offset": (128, 384, 4, 1, 64, True, None, 256),
    "window": (384, 384, 4, 2, 32, True, 100, 0),
    "bidirectional": (128, 256, 4, 4, 64, False, None, 0),
    "dead-prefix": (256, 256, 4, 2, 128, True, None, -70),
    "window-past-sk": (200, 128, 4, 2, 32, False, 16, 100),
    "ragged": (200, 300, 8, 2, 128, True, 150, 50),
    "sk-200-mid-step": (200, 200, 8, 2, 128, True, None, 0),
    "sk-330-mid-step": (256, 330, 4, 2, 64, False, None, 0),
    "gqa-5to1-five-tiles": (640, 640, 10, 2, 128, True, None, 0),
    "window-edge-mid-step": (512, 600, 8, 2, 128, True, 160, 88),
    "dead-suffix-mixed": (256, 300, 4, 2, 128, False, 64, 200),
    # head dim 24 (the JAX benchmarks' VLM): causal, and ragged with a window
    "d24-causal": (384, 384, 4, 2, 24, True, None, 0),
    "d24-ragged": (200, 300, 4, 2, 24, True, 150, 50),
}


def _bf16(rng, *shape):
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).bfloat16()


@pytest.mark.parametrize("case", sorted(PREFILL))
def test_flash_prefill_kernel_matches_plain(dev, case):
    Sq, Sk, H, Hkv, D, causal, window, off = PREFILL[case]
    rng = np.random.default_rng(16)
    q, k, v = _bf16(rng, 2, Sq, H, D), _bf16(rng, 2, Sk, Hkv, D), _bf16(rng, 2, Sk, Hkv, D)
    before = ops.launch_counts().get("flash_prefill", 0)
    out_k = flash_prefill_cuda(q.to(dev), k.to(dev), v.to(dev), causal=causal,
                               window=window, q_offset=off).cpu()
    assert ops.launch_counts()["flash_prefill"] == before + 1
    out_p = flash_prefill_plain(q, k, v, causal=causal, window=window, q_offset=off)
    assert _row_rel_err(out_k, out_p) <= PREFILL_ROW_TOL


def test_flash_prefill_rows_without_keys_are_the_mean_of_v(dev):
    rng = np.random.default_rng(17)
    q, k, v = _bf16(rng, 1, 64, 4, 64), _bf16(rng, 1, 130, 2, 64), _bf16(rng, 1, 130, 2, 64)
    out = flash_prefill_cuda(q.to(dev), k.to(dev), v.to(dev), q_offset=-20).cpu()
    mean = v.float().mean(1, keepdim=True).repeat_interleave(2, dim=2)
    assert _row_rel_err(out[:, :20], mean.expand(1, 20, 4, 64)) <= PREFILL_ROW_TOL
    assert (_row_rel_err(out[:, 20:], flash_prefill_plain(q, k, v, q_offset=-20)[:, 20:])
            <= PREFILL_ROW_TOL)


# (Sq, n_pages, H, Hkv, D, window, q_offset, cold (stream, page) entries;
# none: the bf16 kernel)
INT8_COLD = ((0, 0), (1, 1), (1, 0))
PREFILL_PAGED = {
    "fresh": (384, 3, 8, 2, 128, None, 0, ()),
    "offset-window": (128, 4, 4, 1, 64, 200, 300, ()),
    "ragged": (100, 2, 4, 2, 32, None, 150, ()),
    "int8": (384, 3, 8, 2, 128, None, 0, INT8_COLD),
    "int8-offset": (128, 4, 4, 2, 64, None, 384, INT8_COLD),
    # the last query tile's diagonal page cold in both streams
    "int8-cold-diagonal": (384, 3, 10, 2, 128, None, 0, ((0, 2), (1, 2), (0, 1))),
    "d24": (384, 3, 4, 2, 24, None, 0, ()),
    "d24-int8": (384, 3, 4, 2, 24, None, 0, INT8_COLD),
}


@pytest.mark.parametrize("case", sorted(PREFILL_PAGED))
def test_flash_prefill_paged_kernel_matches_plain(dev, case):
    Sq, n_pages, H, Hkv, D, window, off, cold_at = PREFILL_PAGED[case]
    rng = np.random.default_rng(18)
    n_hot = 2 * n_pages + 1
    q = _bf16(rng, 2, Sq, H, D)
    hk, hv, cold = _quant_slab(rng, n_hot, 3, Hkv, D)
    pt = torch.from_numpy(rng.permutation(n_hot)[: 2 * n_pages].reshape(2, n_pages)
                          .astype(np.int32))
    name = "flash_prefill_paged"
    if cold_at:
        for i, (b, j) in enumerate(cold_at):
            pt[b, j] = n_hot + i
        name = "flash_prefill_paged_int8"
    else:
        cold = None
    before = ops.launch_counts().get(name, 0)
    out_k = flash_prefill_paged_cuda(
        q.to(dev), hk.to(dev), hv.to(dev), pt.to(dev), window=window, q_offset=off,
        cold=None if cold is None else tuple(c.to(dev) for c in cold)).cpu()
    assert ops.launch_counts()[name] == before + 1
    out_p = flash_prefill_paged_plain(q, hk, hv, pt, window=window, q_offset=off, cold=cold)
    assert _row_rel_err(out_k, out_p) <= PREFILL_ROW_TOL


def test_flash_prefill_reads_no_key_row_past_sk(dev):
    """k and v are views of buffers whose rows from Sk on are NaN: the
    kernel must neither read them nor let them reach the output."""
    rng = np.random.default_rng(20)
    Sk = 200
    big_k, big_v = _bf16(rng, 1, Sk + 72, 2, 128), _bf16(rng, 1, Sk + 72, 2, 128)
    big_k[:, Sk:], big_v[:, Sk:] = float("nan"), float("nan")
    q = _bf16(rng, 1, Sk, 8, 128)
    k, v = big_k[:, :Sk], big_v[:, :Sk]
    assert k.is_contiguous() and v.is_contiguous()
    big_k, big_v = big_k.to(dev), big_v.to(dev)
    for causal in (True, False):
        out_k = flash_prefill_cuda(q.to(dev), big_k[:, :Sk], big_v[:, :Sk],
                                   causal=causal).cpu()
        assert torch.isfinite(out_k.float()).all()
        out_p = flash_prefill_plain(q, k, v, causal=causal)
        assert _row_rel_err(out_k, out_p) <= PREFILL_ROW_TOL


def test_flash_prefill_paged_int8_all_hot_is_bitwise_bf16(dev):
    rng = np.random.default_rng(19)
    hk, hv, cold = _quant_slab(rng, 4, 3, 2, 128)
    hk, hv, cold = hk.to(dev), hv.to(dev), tuple(c.to(dev) for c in cold)
    pt = torch.tensor([[2, 0], [1, 3]], dtype=torch.int32, device=dev)
    q = _bf16(rng, 2, 256, 8, 128).to(dev)
    out8 = flash_prefill_paged_cuda(q, hk, hv, pt, cold=cold)
    out16 = flash_prefill_paged_cuda(q, hk, hv, pt)
    assert torch.equal(out8, out16)


def test_prefill_operands_the_kernel_does_not_take_raise(dev):
    q = torch.zeros(1, 128, 4, 48, device=dev, dtype=torch.bfloat16)
    kv = torch.zeros(1, 128, 2, 48, device=dev, dtype=torch.bfloat16)
    with pytest.raises(KernelError, match="head dim"):
        ops.flash_prefill(q, kv, kv)
    q32 = torch.zeros(1, 128, 4, 32, device=dev)
    kv32 = torch.zeros(1, 128, 2, 32, device=dev)
    with pytest.raises(KernelError, match="bf16"):
        ops.flash_prefill(q32, kv32, kv32)
    qt = torch.zeros(1, 4, 128, 32, device=dev, dtype=torch.bfloat16).transpose(1, 2)
    kvb = kv32.bfloat16()
    with pytest.raises(KernelError, match="contiguous"):
        ops.flash_prefill(qt, kvb, kvb)


# ----------------------------------------------------------------------
# ssd_scan
# ----------------------------------------------------------------------
def _ssd_operands(rng, B, L, H, P, G, N, with_init=True):
    x = _bf16(rng, B, L, H, P)
    la = torch.from_numpy(-rng.uniform(1e-3, 1.0, size=(B, L, H)).astype(np.float32))
    b = (_bf16(rng, B, L, G, N).float() * 0.3).bfloat16()
    c = (_bf16(rng, B, L, G, N).float() * 0.3).bfloat16()
    init = (torch.from_numpy(rng.normal(size=(B, H, P, N)).astype(np.float32))
            if with_init else None)
    return x, la, b, c, init


def _state_rel_err(st_k, st_p):
    d = (st_k - st_p).abs().amax(dim=(-1, -2))
    return (d / st_p.abs().amax(dim=(-1, -2)).clamp_min(1e-30)).max().item()


# (B, L, H, P, G, N, chunk, init): the serving shapes of mamba2-2.7b (a
# fresh window, an incremental one, the query), a long prefill over whole
# chunks and a ragged one, groups G > 1 at a small width; P below, equal
# to and past the kernel's 32-row slice (16, 24, 32, 48: the last slice
# ragged at 24 and 48); every state width N (16, 64, 128) at short and
# long chunks; L 1, and L 17 (one chunk of 17 rows over two 16-row
# tiles, or chunks of 16 with a ragged last chunk of one step)
SSD = {
    "fresh-160": (2, 160, 80, 64, 1, 128, 256, True),
    "step-40": (2, 40, 80, 64, 1, 128, 256, True),
    "query-8": (2, 8, 80, 64, 1, 128, 256, True),
    "long-1024": (1, 1024, 16, 64, 1, 128, 256, False),
    "ragged-1000": (1, 1000, 16, 64, 1, 128, 256, True),
    "groups-2": (2, 100, 8, 32, 2, 16, 16, True),
    "groups-4": (1, 77, 8, 32, 4, 64, 32, False),
    "p16": (2, 60, 8, 16, 1, 64, 32, True),
    "p32-n128": (2, 60, 8, 32, 1, 128, 64, True),
    "p48-ragged-slice": (1, 200, 4, 48, 1, 128, 256, True),
    "p24-ragged-slice": (2, 50, 4, 24, 1, 64, 64, True),
    "n16-long-chunk": (1, 300, 8, 64, 1, 16, 256, True),
    "n64-long-chunk": (1, 200, 8, 64, 1, 64, 128, False),
    "len-1": (2, 1, 8, 64, 1, 128, 256, True),
    "len-17": (2, 17, 8, 64, 1, 128, 256, True),
    "len-17-chunk-16": (2, 17, 8, 32, 1, 16, 16, False),
    "groups-4-h8-init": (2, 70, 8, 64, 4, 128, 32, True),
}


@pytest.mark.parametrize("case", sorted(SSD))
def test_ssd_scan_kernel_matches_plain(dev, case):
    B, L, H, P, G, N, chunk, with_init = SSD[case]
    rng = np.random.default_rng(20)
    x, la, b, c, init = _ssd_operands(rng, B, L, H, P, G, N, with_init)
    before = ops.launch_counts().get("ssd_scan", 0)
    y_k, st_k = ssd_scan_cuda(x.to(dev), la.to(dev), b.to(dev), c.to(dev),
                              None if init is None else init.to(dev), chunk)
    assert ops.launch_counts()["ssd_scan"] == before + 1
    y_p, st_p = ssd_scan_plain(x, la, b, c, init, chunk)
    assert y_k.dtype == torch.bfloat16 and st_k.dtype == torch.float32
    assert _row_rel_err(y_k.cpu(), y_p) <= 2.0 ** -7
    assert _state_rel_err(st_k.cpu(), st_p) <= 1e-4


def test_ssd_scan_masked_decay_does_not_overflow_to_nan(dev):
    """log_a down to -100 a step: cum falls by thousands over the chunk,
    so exp(cum_t - cum_s) overflows f32 wherever s > t.  The kernel forms
    it only where s <= t, so y and the state stay finite and agree with
    the plain version."""
    rng = np.random.default_rng(24)
    x, la, b, c, init = _ssd_operands(rng, 2, 40, 8, 64, 1, 128)
    la = la * 100.0
    y_k, st_k = ssd_scan_cuda(x.to(dev), la.to(dev), b.to(dev), c.to(dev), init.to(dev), 256)
    y_p, st_p = ssd_scan_plain(x, la, b, c, init, 256)
    assert bool(torch.isfinite(y_k).all()) and bool(torch.isfinite(st_k).all())
    assert _row_rel_err(y_k.cpu(), y_p) <= 2.0 ** -7
    assert _state_rel_err(st_k.cpu(), st_p) <= 1e-4


def test_ssd_scan_reads_strided_b_c_in_place(dev):
    """b and c as the mixer hands them over: slices of one conv output
    (time stride = the conv width), not copies."""
    rng = np.random.default_rng(21)
    x, la, b, c, init = _ssd_operands(rng, 2, 40, 8, 32, 1, 16)
    conv = torch.cat([x.reshape(2, 40, -1), b.reshape(2, 40, -1), c.reshape(2, 40, -1)], -1)
    conv = conv.to(dev)
    bs = conv[..., 256:272].reshape(2, 40, 1, 16)
    cs = conv[..., 272:288].reshape(2, 40, 1, 16)
    assert bs.stride(1) == 288 and not bs.is_contiguous()
    y_k, st_k = ssd_scan_cuda(x.to(dev), la.to(dev), bs, cs, init.to(dev), 16)
    y_p, st_p = ssd_scan_plain(x, la, b, c, init, 16)
    assert _row_rel_err(y_k.cpu(), y_p) <= 2.0 ** -7
    assert _state_rel_err(st_k.cpu(), st_p) <= 1e-4


def test_ssd_scan_operands_the_kernel_does_not_take_raise(dev):
    rng = np.random.default_rng(22)
    x, la, b, c, init = (t.to(dev) for t in _ssd_operands(rng, 1, 16, 4, 32, 1, 16))
    before = ops.launch_counts().get("ssd_scan", 0)
    with pytest.raises(KernelError, match="bf16"):
        ops.ssd_scan(x.float(), la, b, c, init, 16)
    with pytest.raises(KernelError, match="contiguous"):
        ops.ssd_scan(x, la, b, c, init.transpose(2, 3).contiguous().transpose(2, 3), 16)
    with pytest.raises(KernelError, match="packed"):
        ops.ssd_scan(x.transpose(2, 3).contiguous().transpose(2, 3), la, b, c, init, 16)
    long = [t.to(dev) for t in _ssd_operands(rng, 1, 1024, 4, 32, 1, 16, with_init=False)[:4]]
    with pytest.raises(KernelError, match="chunk"):
        ops.ssd_scan(*long, chunk=512)
    wide = [t.to(dev) for t in _ssd_operands(rng, 1, 16, 4, 32, 1, 32)]
    with pytest.raises(KernelError, match="state width"):
        ops.ssd_scan(*wide, chunk=16)
    narrow = [t.to(dev) for t in _ssd_operands(rng, 1, 16, 4, 12, 1, 16)]
    with pytest.raises(KernelError, match="multiple of 8"):
        ops.ssd_scan(*narrow, chunk=16)
    conv = torch.zeros(1, 16, 33, device=dev, dtype=torch.bfloat16)   # b, c 2 bytes in
    bc = [conv[..., i:i + 16].reshape(1, 16, 1, 16) for i in (1, 17)]
    with pytest.raises(KernelError, match="aligned"):
        ops.ssd_scan(x, la, *bc, init, 16)
    assert ops.launch_counts().get("ssd_scan", 0) == before
    ops.ssd_scan(x, la, b, c, init, 16)
    assert ops.launch_counts()["ssd_scan"] == before + 1


@pytest.mark.parametrize("tied", [False, True])
def test_lm_logits_keep_the_f32_head_product(dev, tied):
    """On the card the head is one bf16 GEMM with an f32 output, at
    internvl3-14b's width (d 5120, vocab 151674): within 2^-14 of each
    row's largest logit of the f32 product of the same bf16 operands (a
    summation order apart), while that product rounded to bf16 misses
    the limit."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.transformer import lm_logits

    cfg = dataclasses.replace(get_config("internvl3-14b"), tied_embeddings=tied)
    g = torch.Generator(device=dev).manual_seed(23)
    shape = (cfg.vocab, cfg.d_model) if tied else (cfg.d_model, cfg.vocab)
    w = (torch.randn(shape, generator=g, device=dev) * 0.02).bfloat16()
    h = torch.randn(4, cfg.d_model, generator=g, device=dev).bfloat16()
    out = lm_logits(cfg, {"embed" if tied else "lm_head": w}, h)
    head = w.T if tied else w
    ref = torch.cat([h.float() @ head[:, i:i + 16384].float()
                     for i in range(0, cfg.vocab, 16384)], dim=-1)
    scale = ref.abs().amax(-1, keepdim=True)
    assert out.dtype == torch.float32 and out.shape == (4, cfg.vocab)
    assert ((out - ref).abs() / scale).max().item() <= 2.0 ** -14
    assert ((ref.bfloat16().float() - ref).abs() / scale).max().item() > 2.0 ** -14


# ----------------------------------------------------------------------
# the stage-pipelined scheduler on the card
# ----------------------------------------------------------------------
ASYNC_CASES = {
    "codecflow-paged": ("internvl3-14b-smoke", 0.5, {}),
    "codecflow-int8": ("internvl3-14b-smoke", 1.0, {"stale_page_dtype": "int8"}),
    "mamba2-codecflow": ("mamba2-2.7b-smoke", 0.5, {}),
    "olmoe-codecflow-paged": ("olmoe-1b-7b-smoke", 0.5, {}),
    "jamba-codecflow": ("jamba-v0.1-52b-smoke", 0.5, {}),
}


@pytest.mark.parametrize("case", sorted(ASYNC_CASES))
def test_async_engine_launches_kernels_and_equals_lockstep(dev, case):
    """The pipelined engine on a smoke pipeline launches every kernel of
    its path with no plain call on a CUDA tensor, and gives bitwise the
    lockstep engine's logits (three streams admitted at once: both
    engines fuse the same groups)."""
    from repro_torch.configs import CodecCfg
    from repro_torch.data.pipeline import anomaly_dataset
    from repro_torch.launch.serve import build_pipeline
    from repro_torch.serving import (
        EngineCfg, EventProtocolValidator, KVCfg, Scheduler, SchedulerCfg,
        ServingPipeline, StreamRequest,
    )

    arch, keep, kv = ASYNC_CASES[case]
    codec = CodecCfg(gop=4, window_frames=16, stride_frames=4, keep_ratio=keep)
    base = build_pipeline(arch, "codecflow", codec, device=dev)
    videos = anomaly_dataset(3, 24, 112, 112)
    runs = {}
    for pipelined in (False, True):
        pipe = ServingPipeline(base.cfg, base.v, base.params, base.vparams,
                               EngineCfg(mode="codecflow", codec=codec, kv=KVCfg(**kv)),
                               device=dev)
        sched = Scheduler(pipe, SchedulerCfg(max_concurrent=3, pipelined=pipelined))
        ops.reset_launch_counts()
        ops.reset_dispatch_counts()
        for i, (f, _) in enumerate(videos):
            sched.submit(StreamRequest(i, np.asarray(f)))
        validator = EventProtocolValidator()
        events = [(type(e).__name__, e.sid, getattr(e, "window", None))
                  for e in validator.wrap(sched.events())]
        validator.assert_complete()
        launches = ops.launch_counts()
        assert all(launches.get(k, 0) > 0 for k in pipe.kernels), (launches, pipe.kernels)
        assert not any(ops.plain_calls_on_cuda().values())
        runs[pipelined] = (
            sorted(events, key=lambda e: e[1]),
            [r.stats.logits_yes_no for s in range(3) for r in sched.session(s).results])
    assert runs[True][0] == runs[False][0]
    assert len(runs[True][1]) == 9 and runs[True][1] == runs[False][1]
    assert np.isfinite(np.asarray(runs[True][1])).all()


def test_checks_on_host_twins_raise_on_card(dev):
    """Uploaded operands are checked on their host arrays, with no sync:
    'positions-match', 'page-range' and 'segments-match' still refuse
    before any launch."""
    from repro_torch.kernels import transfer

    q = torch.zeros(1, 4, 4, 32, device=dev, dtype=torch.bfloat16)
    slab = torch.zeros(256, 2, 32, device=dev, dtype=torch.bfloat16)
    kvv = torch.ones(1, 256, dtype=torch.bool, device=dev)
    bm = build_block_map([3, 4, 5, 6], 256)
    pt = transfer.upload([[1, 0]], dev, torch.int32)
    qp = transfer.upload([[3, 4, 5, 6]], dev, torch.long)
    before = ops.launch_counts().get("flash_refresh_paged", 0)
    with pytest.raises(ops.KernelContractError, match="positions-match"):
        ops.flash_refresh_paged(q, slab, slab, transfer.upload([[3, 4, 5, 7]], dev, torch.long),
                                kvv, pt, block_map=bm)
    with pytest.raises(ops.KernelContractError, match="page-range"):
        ops.flash_refresh_paged(q, slab, slab, qp, kvv,
                                transfer.upload([[1, 2]], dev, torch.int32), block_map=bm)
    assert ops.launch_counts().get("flash_refresh_paged", 0) == before
    ops.flash_refresh_paged(q, slab, slab, qp, kvv, pt, block_map=bm)
    assert ops.launch_counts()["flash_refresh_paged"] == before + 1
    seg = _seg_layout([[(0, 60), (1, 40)]], 128)
    other = seg.copy()
    other[0, 99] = -1
    qk = torch.zeros(1, 128, 2, 32, device=dev, dtype=torch.bfloat16)
    before = ops.launch_counts().get("flash_packed", 0)
    with pytest.raises(ops.KernelContractError, match="segments-match"):
        ops.flash_packed(qk, qk, qk, transfer.upload(other, dev), build_pack_map(seg))
    assert ops.launch_counts().get("flash_packed", 0) == before
    ops.flash_packed(qk, qk, qk, transfer.upload(seg, dev), build_pack_map(seg))
    assert ops.launch_counts()["flash_packed"] == before + 1


# ----------------------------------------------------------------------
# the MoE block on the card
# ----------------------------------------------------------------------
MOE_CASES = {    # (E, top-k, d, d_ff_expert, factor, B, T)
    "olmoe-routing-prefill": (64, 8, 256, 128, 1.25, 2, 168),
    "olmoe-routing-decode": (64, 8, 256, 128, 1.25, 2, 1),
    "jamba-routing-factor-0.01": (16, 2, 256, 128, 0.01, 2, 160),
}


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_moe_block_on_card_repeats_bitwise_and_matches_cpu(dev, case):
    """``moe_block`` on the card twice over one input: bitwise equal (the
    combine is a fixed order of adds, no atomics), with no sync reported
    by the debug mode; against the same call on the CPU: equal expert
    choices and kept slots (gates within 1e-5: the two f32 router
    products sum in other orders) and the output within 2^-5 of its
    largest magnitude (bf16 GEMMs that accumulate in other orders)."""
    from repro_torch.configs.base import MoECfg
    from repro_torch.models import layers

    E, k, d, f, factor, B, T = MOE_CASES[case]
    cfg = MoECfg(n_experts=E, top_k=k, d_ff_expert=f, capacity_factor=factor)
    g = torch.Generator().manual_seed(3)
    p = {"router": torch.randn(d, E, generator=g) * 0.02,
         "wg": torch.randn(E, d, f, generator=g) * d ** -0.5,
         "wu": torch.randn(E, d, f, generator=g) * d ** -0.5,
         "wd": torch.randn(E, f, d, generator=g) * f ** -0.5}
    p = {n: t.bfloat16() for n, t in p.items()}
    x = torch.randn(B, T, d, generator=g).bfloat16()
    pc = {n: t.to(dev) for n, t in p.items()}
    xc = x.to(dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out1, aux1 = layers.moe_block(pc, cfg, xc)
        out2, aux2 = layers.moe_block(pc, cfg, xc)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(out1, out2) and torch.equal(aux1, aux2)
    r_c = layers.moe_route(pc, cfg, xc.reshape(B * T, d))
    r_h = layers.moe_route(p, cfg, x.reshape(B * T, d))
    assert (r_c.gates.cpu() - r_h.gates).abs().max().item() <= 1e-5
    assert torch.equal(r_c.tope.cpu(), r_h.tope) and torch.equal(r_c.keep.cpu(), r_h.keep)
    out_h, aux_h = layers.moe_block(p, cfg, x)
    scale = out_h.float().abs().max().item()
    assert (out1.cpu().float() - out_h.float()).abs().max().item() <= 2.0 ** -5 * scale
    assert abs(aux1.item() - aux_h.item()) <= 1e-5


# ----------------------------------------------------------------------
# no kernel has a backward: operands that require grad are refused
# ----------------------------------------------------------------------
def _grad_case(name, dev):
    """(op call, its tensor operands) at shapes the kernel takes."""
    bf = dict(device=dev, dtype=torch.bfloat16)
    g = torch.Generator(device=dev).manual_seed(31)

    def rnd(*shape, **kw):
        return torch.randn(shape, generator=g, **{**bf, **kw})

    if name == "mv_sad":
        cur, prev = (t.to(dev) for t in _frames(64, 64))
        return (lambda: ops.mv_sad(cur, prev)), (cur, prev)
    if name == "rope_shift":
        k = rnd(1, 8, 2, 64)
        return (lambda: ops.rope_shift(k, torch.full((1, 8), 3, dtype=torch.int32,
                                                     device=dev))), (k,)
    if name == "flash_refresh":
        q, k, v = rnd(1, 8, 4, 64), rnd(1, 128, 2, 64), rnd(1, 128, 2, 64)
        pos = torch.arange(120, 128, device=dev)[None]
        bm = build_block_map(np.arange(120, 128), 128)
        return (lambda: ops.flash_refresh(q, k, v, pos, block_map=bm)), (q, k, v)
    if name in ("flash_refresh_paged", "flash_refresh_paged_int8"):
        q, k, v = rnd(1, 4, 4, 32), rnd(128, 2, 32), rnd(128, 2, 32)
        cold = None
        pt = torch.zeros(1, 1, dtype=torch.int32, device=dev)
        if name.endswith("int8"):
            cold = (torch.zeros(128, 2, 32, dtype=torch.int8, device=dev),) * 2 + (
                torch.ones(1, 2, device=dev),) * 2
            pt = torch.ones(1, 1, dtype=torch.int32, device=dev)
        pos = torch.tensor([[3, 4, 5, 7]], device=dev)
        valid = torch.ones(1, 128, dtype=torch.bool, device=dev)
        bm = build_block_map([3, 4, 5, 7], 128)
        return (lambda: ops.flash_refresh_paged(q, k, v, pos, valid, pt, block_map=bm,
                                                cold=cold)), (q, k, v)
    if name == "flash_packed":
        q, k, v = rnd(1, 128, 2, 32), rnd(1, 128, 2, 32), rnd(1, 128, 2, 32)
        seg = np.array([[0] * 40 + [1] * 60 + [-1] * 28], np.int32)
        bm = build_pack_map(seg)
        st = torch.from_numpy(seg).to(dev)
        return (lambda: ops.flash_packed(q, k, v, st, bm)), (q, k, v)
    if name == "flash_prefill":
        q, k, v = rnd(1, 16, 4, 64), rnd(1, 16, 2, 64), rnd(1, 16, 2, 64)
        return (lambda: ops.flash_prefill(q, k, v)), (q, k, v)
    if name == "flash_prefill_paged":
        q, k, v = rnd(1, 16, 4, 64), rnd(256, 2, 64), rnd(256, 2, 64)
        pt = torch.tensor([[1, 0]], dtype=torch.int32, device=dev)
        return (lambda: ops.flash_prefill_paged(q, k, v, pt)), (q, k, v)
    if name == "ssd_scan":
        x, b, c = rnd(1, 32, 2, 64), rnd(1, 32, 1, 16), rnd(1, 32, 1, 16)
        la = -torch.rand((1, 32, 2), generator=g, device=dev)
        return (lambda: ops.ssd_scan(x, la, b, c, None, 16)), (x, la, b, c)
    raise KeyError(name)


GRAD_OPS = ("mv_sad", "rope_shift", "flash_refresh", "flash_refresh_paged",
            "flash_refresh_paged_int8", "flash_packed", "flash_prefill",
            "flash_prefill_paged", "ssd_scan")


@pytest.mark.parametrize("which", ["first", "last"])
@pytest.mark.parametrize("name", GRAD_OPS)
def test_kernel_ops_refuse_operands_that_require_grad(dev, name, which):
    """Under grad mode an operand that requires grad raises before any
    launch (the kernel's output would carry no gradient); under no_grad
    the same call launches; the plain version on the card differentiates."""
    call, operands = _grad_case(name, dev)
    t = operands[0] if which == "first" else operands[-1]
    t.requires_grad_(True)
    before = ops.launch_counts().get(name, 0)
    with pytest.raises(ops.KernelContractError, match="no backward kernel"):
        call()
    assert ops.launch_counts().get(name, 0) == before
    with torch.no_grad():
        call()
    assert ops.launch_counts()[name] == before + 1
    if name != "mv_sad":          # motion vectors are integers
        with ops.kernel_mode("plain"):
            out = call()
        out = out[0] if isinstance(out, tuple) else out
        (grad,) = torch.autograd.grad(out.float().square().sum(), (t,))
        assert bool(torch.isfinite(grad).all())


def test_f32_head_product_differentiates_on_card(dev):
    """``layers.f32_matmul``'s card path (one GEMM with an f32 output and
    a backward of two f32 products) against the CPU path's autograd on
    the same bf16 operands: the forward within 2^-14 of each row's
    largest logit (a summation order apart), the gradients within one
    bf16 step of their largest element."""
    from repro_torch.models.layers import f32_matmul
    g = torch.Generator().manual_seed(37)
    x = torch.randn(6, 256, generator=g).bfloat16()
    w = (torch.randn(256, 1000, generator=g) * 0.05).bfloat16()
    up = torch.randn(6, 1000, generator=g)
    outs = []
    for d in ("cpu", dev):
        xd, wd = x.to(d).requires_grad_(True), w.to(d).requires_grad_(True)
        y = f32_matmul(xd, wd)
        assert y.dtype == torch.float32
        gx, gw = torch.autograd.grad((y * up.to(d)).sum(), (xd, wd))
        outs.append([t.float().cpu() for t in (y, gx, gw)])
    (yc, gxc, gwc), (yk, gxk, gwk) = outs
    scale = yc.abs().amax(-1, keepdim=True)
    assert ((yk - yc).abs() / scale).max().item() <= 2.0 ** -14
    for a, b in ((gxc, gxk), (gwc, gwk)):
        assert (a - b).abs().max().item() <= 2.0 ** -7 * a.abs().max().item()


def _widened_mha(q, k, v, qpos, kpos, kvalid, window):
    """The dense mha's formula with K, V and P widened to f32 (its CPU
    path), on whatever device the operands are."""
    B, Sq, H, dh = q.shape
    K = k.shape[2]
    qq = (q.float() * dh ** -0.5).bfloat16().reshape(B, Sq, K, H // K, dh)
    logits = torch.einsum("btkgd,bskd->bkgts", qq.float(), k.float())
    m = ((kpos[:, None, :] <= qpos[:, :, None]) & (kpos[:, None, :] > qpos[:, :, None] - window)
         & kvalid[:, None, :])
    p = torch.softmax(logits.masked_fill(~m[:, None, None], -1e30), dim=-1).bfloat16()
    return torch.einsum("bkgts,bskd->btkgd", p.float(), v.float()).reshape(B, Sq, H, dh)


@pytest.mark.parametrize("shape", [(2, 160, 300, 4, 2, 24), (3, 70, 70, 8, 8, 64)])
def test_dense_mha_takes_bf16_products_on_card(dev, shape):
    """``layers.mha``'s card path (bf16 batched GEMMs with f32 outputs,
    ``_F32BatchProduct``) against the widened formula on the card.  The
    forward, with an f32 query so that the output is not rounded, within
    2^-14 of each row's largest value.  Operands lie on a grid of 2^-3 so
    that every logit is exact in f32 whatever the summation order: both
    softmaxes then see equal scores and round P alike (a last-bit
    difference in a score can flip P's bf16 rounding, a step of the
    formula both versions share, which moves a row by up to 2^-8 p |v|).
    The gradients, on normal operands, against CPU autograd within the
    training parity tests' gradient limit, 2^-5 of each operand's largest
    gradient (``STEP_LIMITS["grad"]`` of ``tests/torch_train_parity.py``;
    the card rounds the scores' gradient to bf16)."""
    from repro_torch.models.layers import mha
    B, Sq, Sk, H, K, dh = shape
    g = torch.Generator().manual_seed(41)
    qpos = torch.arange(Sq)[None].repeat(B, 1) + Sk - Sq
    kpos = torch.arange(Sk)[None].repeat(B, 1)
    kvalid = torch.rand(B, Sk, generator=g) > 0.1
    grid = [torch.randint(-8, 9, (B, n, h, dh), generator=g).float() / 8
            for n, h in ((Sq, H), (Sk, K), (Sk, K))]
    q, k, v = (t.to(dev) for t in grid)
    args = (qpos.to(dev), kpos.to(dev), kvalid.to(dev))
    out = mha(q, k.bfloat16(), v.bfloat16(), *args, window=200, q_chunk=64)
    assert out.dtype == torch.float32
    want = _widened_mha(q, k, v, *args, 200)
    scale = want.abs().amax(-1, keepdim=True).clamp_min(1e-30)
    assert ((out - want).abs() / scale).max().item() <= 2.0 ** -14

    q, k, v = (torch.randn(B, n, h, dh, generator=g).bfloat16()
               for n, h in ((Sq, H), (Sk, K), (Sk, K)))
    up = torch.randn(B, Sq, H, dh, generator=g)
    grads = []
    for d in ("cpu", dev):
        ts = [t.to(d).requires_grad_(True) for t in (q, k, v)]
        o = mha(*ts, qpos.to(d), kpos.to(d), kvalid.to(d), window=200, q_chunk=64)
        grads.append([t.float().cpu() for t in
                      torch.autograd.grad((o.float() * up.to(d)).sum(), ts)])
    for a, b in zip(*grads):
        assert (a - b).abs().max().item() <= 2.0 ** -5 * a.abs().max().item()

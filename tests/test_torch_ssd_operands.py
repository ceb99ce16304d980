"""Every operand the reference's scan takes, through the port's scan.

The JAX package's ``ssd_scan_pallas`` takes any head width P, state
width N and chunk, x / log_a / b / c in f32, bf16 or f16 (b == c), and
any L.  The port's kernel takes all of it (``contracts.SSD_SCAN`` has
no eligibility rule left): bf16 x, b and c in the serving layout are
read in place, anything else (f16 too: an f16 value is exactly its bf16
hi + lo halves) passes a staging kernel first
(``ssd_scan.operand_mode``), a chunk past 256 runs as sub-chunks of
at most 256 steps (``ssd_scan.scan_chunk``), and N past 128 runs on the
slabbed build as N / 128 column slabs of 128 (``ssd_scan.column_slabs``;
other N on the next multiple of 128).
Here, on CPU tensors and the same numpy inputs:

* ``ops.ssd_scan`` (its plain version) against the JAX package's
  ``ops.ssd_scan`` in f32, bf16, f16 and the f16 / bf16 mixes (x in one,
  b and c in the other) at chunk 512 over a ragged L, N 24, 32, 192,
  256, 320 and 384, P 12, a strided x and a bf16 log_a, within
  ``test_torch_ssd.py``'s limits (f32: 2e-5 of the output's scale; bf16:
  y within 2^-7, the state within 2e-5; f16: y within one f16 step
  above f32's, 2^-9), and each case's verdict and operand mode; f16
  taken, N 264 taken;
* the sub-chunk identity: the plain version mirroring the kernel's
  sub-chunks equals the JAX scan at the whole chunk (f32, 2e-5); the
  column-slab identity the slabbed build rests on (N 256 and 384): y and
  every gradient but b's, c's and the states' (which split by column)
  are the sums of the slabs' scans, within f32 summation order;
* ``SsdScanFn`` over the plain pair on f32 operands with sub-chunks,
  ragged P and N, and at N 256 and 384: f32 gradients within 1e-5 of
  ``jax.grad``'s per slice;
* the dispatch audit's scan rows, the launches' shared memory for every
  admitted (mode, build N, chunk), the bytes counted at the operands'
  element sizes (an f32 call, and the meta count of an f32 mamba2 step);
* one f32 mamba2-2.7b-smoke LM prefill through both packages within 1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as j_get_config
from repro.kernels import ops as jops
from repro.models import transformer as jtfm
from repro_torch.analysis import roofline as rl
from repro_torch.configs import get_config
from repro_torch.kernels import audit, contracts, ops
from repro_torch.kernels import ssd_scan as S
from repro_torch.models import transformer as tfm
from repro_torch.models.init import from_numpy_tree, meta_lm_params, trainable
from repro_torch.training.train_step import Batch, loss_fn, tree_grads
from torch_threads import torch_one_thread  # noqa: F401

F32_TOL, BF16_TOL, F16_TOL = 2e-5, 2.0 ** -7, 2.0 ** -9
# (B, L, H, P, G, N, chunk, layout): layout "packed", "strided" (x a
# view with its heads and features transposed in memory) or "bf16 log_a"
CASES = {
    "chunk 512, ragged L": (1, 600, 2, 8, 1, 16, 512, "packed"),
    "N 24": (2, 40, 4, 8, 2, 24, 16, "packed"),
    "N 32": (2, 40, 4, 8, 2, 32, 16, "packed"),
    "N 192": (2, 40, 4, 8, 2, 192, 16, "packed"),
    "N 256": (2, 40, 4, 8, 1, 256, 16, "packed"),
    "N 320": (2, 24, 2, 8, 1, 320, 16, "packed"),
    "N 384": (2, 24, 2, 8, 1, 384, 16, "packed"),
    "P 12": (2, 40, 4, 12, 1, 16, 16, "packed"),
    "strided x": (2, 40, 4, 16, 1, 16, 16, "strided"),
    "bf16 log_a": (2, 40, 4, 8, 1, 16, 16, "bf16 log_a"),
}
# x's dtype, or "x+bc": x in one dtype, b and c in the other (the
# reference's rule: b == c)
DTYPES = ("float32", "bfloat16", "float16", "float16+bfloat16", "bfloat16+float16")
Y_TOL = {"float32": F32_TOL, "bfloat16": BF16_TOL, "float16": F16_TOL}


def split_dtype(dtype: str):
    """(x's dtype, b's and c's) of a ``DTYPES`` entry."""
    x_dt, _, bc_dt = dtype.partition("+")
    return x_dt, bc_dt or x_dt


def arrays(case: str, dtype: str, seed: int = 0):
    """numpy inputs of one case; bf16 and f16 operands (and a bf16 log_a)
    rounded once through torch, so both packages see the same values."""
    B, L, H, P, G, N, _, layout = CASES[case]
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, L, H, P)).astype(np.float32)
    la = (-np.abs(rng.normal(size=(B, L, H))) * 0.3).astype(np.float32)
    b, c = ((rng.normal(size=(B, L, G, N)) * 0.5).astype(np.float32) for _ in range(2))
    init = (rng.normal(size=(B, H, P, N)) * 0.1).astype(np.float32)

    def rounded(a, dt="bfloat16"):
        return a if dt == "float32" else torch.from_numpy(a).to(getattr(torch, dt)).float().numpy()
    x_dt, bc_dt = split_dtype(dtype)
    x, b, c = rounded(x, x_dt), rounded(b, bc_dt), rounded(c, bc_dt)
    if layout == "bf16 log_a":
        la = rounded(la)
    return x, la, b, c, init


def torch_operands(case: str, dtype: str):
    x, la, b, c, init = arrays(case, dtype)
    xd, bd = (getattr(torch, dt) for dt in split_dtype(dtype))
    layout = CASES[case][-1]
    xt = torch.from_numpy(x).to(xd)
    if layout == "strided":
        xt = xt.transpose(2, 3).contiguous().transpose(2, 3)
    lat = torch.from_numpy(la).to(torch.bfloat16 if layout == "bf16 log_a" else torch.float32)
    return xt, lat, torch.from_numpy(b).to(bd), torch.from_numpy(c).to(bd), torch.from_numpy(init)


def jax_scan(case: str, dtype: str, chunk=None):
    x, la, b, c, init = arrays(case, dtype)
    xd, bd = (getattr(jnp, dt) for dt in split_dtype(dtype))
    ld = jnp.bfloat16 if CASES[case][-1] == "bf16 log_a" else jnp.float32
    y, st = jops.ssd_scan(jnp.asarray(x, xd), jnp.asarray(la, ld), jnp.asarray(b, bd),
                          jnp.asarray(c, bd), jnp.asarray(init), chunk=chunk or CASES[case][6])
    return np.asarray(y.astype(jnp.float32)), np.asarray(st)


@pytest.fixture(scope="module")
def jax_refs():
    return {(case, dt): jax_scan(case, dt) for case in CASES for dt in DTYPES}


def close(a, b, rel):
    a = a.float().numpy() if torch.is_tensor(a) else a
    assert a.shape == b.shape, (a.shape, b.shape)
    err, scale = float(np.abs(a - b).max()), float(np.abs(b).max())
    assert err <= rel * scale, (err / scale, rel)


# the operand mode each case takes on the card: bf16 N 32, 256 and 384 and
# P 8 are a build read in place; N 24, 192 and 320, P 12, a strided x and
# f32 are staged as hi and lo halves
MODES = {("N 32", "bfloat16"): S.FAST, ("chunk 512, ragged L", "bfloat16"): S.FAST,
         ("bf16 log_a", "bfloat16"): S.FAST, ("N 256", "bfloat16"): S.FAST,
         ("N 384", "bfloat16"): S.FAST}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", sorted(CASES))
def test_every_reference_operand_matches_jax_and_takes_the_kernel(case, dtype, jax_refs):
    ops_ = torch_operands(case, dtype)
    y, st = ops.ssd_scan(*ops_, chunk=CASES[case][6])
    y_j, s_j = jax_refs[case, dtype]
    x_dt = split_dtype(dtype)[0]
    assert y.dtype == getattr(torch, x_dt) and st.dtype == torch.float32
    close(y, y_j, Y_TOL[x_dt])
    close(st, s_j, F32_TOL)
    assert contracts.ssd_scan_verdict(*ops_, CASES[case][6]).use_kernel, case
    x, _, b, c, _ = ops_
    want = MODES.get((case, dtype), S.SPLIT)
    assert S.operand_mode(x, b, c) == want, (case, dtype)


def test_f16_and_n136_are_refused_by_name():
    """f16 operands, once refused by name (no f16 build), are taken
    (staged), alone and beside f32 and bf16 ones; N 264, once the first
    width past the builds, runs staged on the slabbed build at 384, as N
    136 runs on 256; the scan has no eligibility rule left."""
    x, la, b, c, init = torch_operands("N 24", "float32")
    for args in ((x.half(), la, b, c, init), (x, la, b.half(), c.half(), None),
                 (x, la, b, c, init.half()), (x.half(), la.half(), b.half(), c.half(), None),
                 (x.bfloat16(), la, b.half(), c.half(), init)):
        assert contracts.ssd_scan_verdict(*args, 16).reason == "ok"
        assert S.operand_mode(*args[:1], *args[2:4]) == S.SPLIT
    wide = torch.zeros(2, 40, 2, 264)
    assert contracts.ssd_scan_verdict(x, la, wide, wide, None, 16).use_kernel
    assert contracts.ssd_scan_verdict(x, la, wide[..., :256], wide[..., :256], None,
                                      16).use_kernel
    assert [S.build_width(n) for n in (136, 256, 264, 320, 384, 512)] == [
        256, 256, 384, 384, 384, 512]
    assert [r.code for r in contracts.SSD_SCAN.eligibility] == []


def test_sub_chunks_equal_the_whole_chunk():
    """L 600 at chunk 512: the kernel runs 256-step sub-chunks (and the
    plain version mirrors it: 3 of them, the last ragged), which equal the
    JAX scan's two 512-step chunks in exact arithmetic."""
    assert S.scan_chunk(600, 512) == 256 and S.chunk_count(600, 512) == 3
    assert S.scan_chunk(300, 512) == 150 and S.scan_chunk(1000, 1000) == 250
    assert S.scan_chunk(4096, 256) == 256 and S.scan_chunk(160, 256) == 160
    x, la, b, c, init = torch_operands("chunk 512, ragged L", "float32")
    y, st, states = S.ssd_scan_plain(x, la, b, c, init, 512, states=True)
    assert states.shape[2] == 3
    y_j, s_j = jax_scan("chunk 512, ragged L", "float32")
    close(y, y_j, F32_TOL)
    close(st, s_j, F32_TOL)
    assert contracts.ssd_scan_facts(x, la, b, c, chunk=512)["scan_chunk"] == 256


def test_f32_gradients_through_the_plain_pair_match_jax_grad():
    """SsdScanFn over (ssd_scan_fwd_plain, ssd_scan_bwd_plain) on f32
    operands with P 12, N 24, G 2 and chunk 512 over L 300 (two 150-step
    sub-chunks against the reference's one 300-step chunk): f32 gradients
    within 1e-5 of jax.grad's, per slice (read: dx 6.2e-6, the others
    3.6e-6 or less; the reference's exp(cum_t - cum_s) over a 300-step
    chunk carries the f32 rounding of cum, |cum| x 2^-24 relative)."""
    _gradients_match_jax_grad(2, 300, 4, 12, 2, 24, 512, seed=7)


def test_f32_gradients_at_n256_through_the_plain_pair_match_jax_grad():
    """The same at N 256 (two column slabs; G 1, P 8, chunk 16 over a
    ragged L 40): f32 gradients within 1e-5 of jax.grad's."""
    _gradients_match_jax_grad(2, 40, 4, 8, 1, 256, 16, seed=8)


def test_f32_gradients_at_n384_through_the_plain_pair_match_jax_grad():
    """The same at N 384 (three column slabs; L 24, H 2)."""
    _gradients_match_jax_grad(2, 24, 2, 8, 1, 384, 16, seed=9)


def _gradients_match_jax_grad(B, L, H, P, G, N, chunk, seed):
    rng = np.random.default_rng(seed)
    a = dict(x=rng.normal(0, 1, (B, L, H, P)), log_a=-np.abs(rng.normal(0, 0.3, (B, L, H))),
             b=rng.normal(0, 0.5, (B, L, G, N)), c=rng.normal(0, 0.5, (B, L, G, N)),
             init=rng.normal(0, 1, (B, H, P, N)))
    a = {k: v.astype(np.float32) for k, v in a.items()}
    gy = rng.normal(0, 1, (B, L, H, P)).astype(np.float32)
    gs = rng.normal(0, 1, (B, H, P, N)).astype(np.float32)

    def loss(ins):
        y, st = jops.ssd_scan(ins["x"], ins["log_a"], ins["b"], ins["c"], ins["init"],
                              chunk=chunk)
        return jnp.sum(y * gy) + jnp.sum(st * gs)
    want = jax.grad(loss)({k: jnp.asarray(v) for k, v in a.items()})
    t = {k: torch.from_numpy(v).requires_grad_() for k, v in a.items()}
    y, st = S.SsdScanFn.apply(S.ssd_scan_fwd_plain, S.ssd_scan_bwd_plain, chunk, t["x"],
                              t["log_a"], t["b"], t["c"], t["init"])
    ((y * torch.from_numpy(gy)).sum() + (st * torch.from_numpy(gs)).sum()).backward()
    dims = {"x": (1, 3), "log_a": (1,), "b": (1, 3), "c": (1, 3), "init": (2, 3)}
    for k, d in dims.items():
        g, w = t[k].grad, torch.from_numpy(np.array(want[k]))
        assert g.dtype == torch.float32, k
        rel = ((g - w).abs().amax(d) / w.abs().amax(d).clamp_min(1e-30)).max()
        assert float(rel) <= 1e-5, (k, float(rel))


def test_column_slabs_sum_to_the_whole_scan():
    """The identity the slabbed build rests on (``column_slabs``): a scan
    at N 256 equals its two 128-column slabs scanned apart.  y, dx and
    dlog_a are the slabs' sums (the kernels' f32 partials, added in slab
    order); the final state, the chunk states, db, dc and d_init are the
    slabs' columns side by side.  f32, within 1e-5 of each output's scale
    (the same products summed in another order)."""
    assert S.column_slabs(128) == S.column_slabs(16) == 1
    _slabs_sum_to_the_whole(2, 40, 4, 8, 2, 256, 16, seed=12)


def test_column_slabs_sum_to_the_whole_scan_at_n384():
    """The same over three slabs (N 384)."""
    _slabs_sum_to_the_whole(2, 24, 2, 8, 1, 384, 16, seed=13)


def _slabs_sum_to_the_whole(B, L, H, P, G, N, chunk, seed):
    assert S.column_slabs(N) == N // S.N_SLAB
    rng = np.random.default_rng(seed)

    def normal(scale, *shape):
        return torch.from_numpy(rng.normal(0, scale, shape).astype(np.float32))
    x, b, c = normal(1, B, L, H, P), normal(0.5, B, L, G, N), normal(0.5, B, L, G, N)
    la = -torch.from_numpy(rng.uniform(1e-3, 1.0, (B, L, H)).astype(np.float32))
    init, dy, dfin = normal(1, B, H, P, N), normal(1, B, L, H, P), normal(1, B, H, P, N)
    y, st, states = S.ssd_scan_fwd_plain(x, la, b, c, init, chunk)
    grads = S.ssd_scan_bwd_plain(x, la, b, c, states, dy, dfin, chunk)
    slabs = []
    for n0 in range(0, N, S.N_SLAB):
        cols = slice(n0, n0 + S.N_SLAB)
        fwd = S.ssd_scan_fwd_plain(x, la, b[..., cols], c[..., cols], init[..., cols], chunk)
        bwd = S.ssd_scan_bwd_plain(x, la, b[..., cols], c[..., cols], fwd[2], dy,
                                   dfin[..., cols], chunk)
        slabs.append((fwd, bwd))

    def summed(i, j):
        return sum(s[i][j] for s in slabs)

    def side_by_side(i, j):
        return torch.cat([s[i][j] for s in slabs], dim=-1)
    pairs = [(y, summed(0, 0)), (st, side_by_side(0, 1)), (states, side_by_side(0, 2)),
             (grads[0], summed(1, 0)), (grads[1], summed(1, 1)), (grads[2], side_by_side(1, 2)),
             (grads[3], side_by_side(1, 3)), (grads[4], side_by_side(1, 4))]
    for whole, parts in pairs:
        close(parts, whole.numpy(), 1e-5)


def test_audit_scan_rows_take_the_kernel():
    rows = [r for r in audit._slab_rows() if r.op == "ssd_scan"]
    assert [r.geometry for r in rows] == [row[0] for row in audit.SSD_AUDIT_ROWS]
    assert [r.failure for r in rows] == [None] * len(rows)
    got = {r.geometry: r.decision for r in rows}
    assert got["B2 L100 H8 G2 N32 f32"] == got["B2 L100 H8 G2 N32 bf16"] == "kernel"
    assert got["B1 L1024 H8 P64 N16 f32 (the JAX benchmarks' row)"] == "kernel"
    assert got["B2 L160 H80 P64 N128 f32 (mamba2-2.7b, dtype f32)"] == "kernel"
    assert got["B2 L100 H8 G2 N136 bf16"] == "kernel"
    assert got["B2 L100 H8 G2 N264 bf16"] == "kernel"
    assert got["B2 L160 H80 P64 N512 bf16 (mamba2-2.7b at d_state 512)"] == "kernel"


def test_every_admitted_launch_fits_an_h100():
    """Shared memory of the forward and the backward's launches within
    one block's 232,448 bytes for every operand mode, build N (one
    block's, and the slabbed build at N 256, 384 and 512) and chunk q up
    to 256 (a longer chunk runs as sub-chunks of at most 256)."""
    for mode in (S.FAST, S.SPLIT):
        for N in S.STATE_WIDTHS + (256, 384, 512):
            fwd = max(S.launch_geometry(2, 80, 64, N, q, mode)[2] for q in range(1, 257))
            assert fwd <= S.SMEM_LIMIT, (mode, N, fwd)
            for q in (1, 16, 100, 256, 512, 1000):
                launches, _ = S.bwd_launch_geometry(2, 2048, 80, 64, 1, N, q, mode)
                assert all(smem <= S.SMEM_LIMIT for *_, smem in launches.values()), (mode, N, q)
    # SPLIT at N 128: two hi / lo copies of B and x, one block per SM; its
    # chunk-local kernel on 16-column P slabs (32 below N 128), one head
    assert S.launch_geometry(2, 80, 64, 128, 256, S.SPLIT)[2] == 198_688
    launches, scratch = S.bwd_launch_geometry(2, 2048, 80, 64, 1, 128, 256, S.SPLIT)
    assert launches["local"][0] == (8 * 4, 80, 2) and launches["chunk"][0] == (8, 80, 2)
    assert scratch["lpart"] == 4 * 2 * 2048 * 80 * 4
    assert S.bwd_launch_geometry(2, 2048, 80, 64, 1, 64, 256, S.SPLIT)[0]["local"][0] == (
        8 * 2, 80, 2)
    assert S.bwd_launch_geometry(1, 64, 4, 64, 1, 16, 64, la_bf16=True)[1]["lpart"] > 0
    # N 256, 320 (staged on 384), 384 and 512: the N-128 layout at N / 128
    # times the grid (column slabs), in both modes, forward and backward
    for mode in (S.FAST, S.SPLIT):
        g128, _, s128 = S.launch_geometry(2, 80, 64, 128, 256, mode)
        w128, _ = S.bwd_launch_geometry(2, 2048, 80, 64, 1, 128, 256, mode)
        for n in (256, 320, 384, 512):
            N = S.build_width(n)
            ns = N // 128
            g, _, sm = S.launch_geometry(2, 80, 64, N, 256, mode)
            assert g == (ns * g128[0],) + g128[1:] and sm == s128
            w, scratch = S.bwd_launch_geometry(2, 2048, 80, 64, 1, N, 256, mode)
            for k in ("chunk", "local"):
                assert w[k][0] == (ns * w128[k][0][0],) + w128[k][0][1:]
                assert w[k][2] == w128[k][2]
            assert scratch["dx"] == 4 * 2 * 2048 * 80 * ns * 64


def test_bytes_are_counted_at_the_operands_element_sizes():
    """An f32 call counts x, b, c and y at 4 bytes (the bf16 formula's
    rows doubled); the meta count of an f32 mamba2-2.7b-smoke train step
    reports those larger bytes for the scan and its backward."""
    L, H, P, G, N, chunk, B = 160, 80, 64, 1, 128, 256, 2
    f_bf, b_bf = S.ssd_scan_work(L, H, P, G, N, chunk, B)
    f_32, b_32 = S.ssd_scan_work(L, H, P, G, N, chunk, B, 4, 4)
    assert f_32 == f_bf and b_32 - b_bf == B * L * (H * P * 2 * 2 + 2 * G * N * 2)
    _, bw_bf = S.ssd_scan_bwd_work(L, H, P, G, N, chunk, B)
    _, bw_32 = S.ssd_scan_bwd_work(L, H, P, G, N, chunk, B, 4, 4)
    assert bw_32 - bw_bf == B * L * (3 * H * P * 2 + 4 * G * N * 2)

    def count(dtype):
        cfg = dataclasses.replace(get_config("mamba2-2.7b-smoke"), dtype=dtype)
        p = trainable(meta_lm_params(cfg))
        tok = torch.empty((2, 32), dtype=torch.int32, device="meta")
        batch = Batch(tokens=tok, targets=tok, loss_mask=torch.empty((2, 32), device="meta"))
        d = rl.count_step(lambda: tree_grads(loss_fn(cfg, p, batch, q_chunk=16, remat=True)[0], p))
        return cfg, d["kernels"]
    cfg, k32 = count("float32")
    _, k16 = count("bfloat16")
    s = cfg.ssm
    Hs, n_layers = s.n_heads(cfg.d_model), cfg.n_layers
    _, want = S.ssd_scan_bwd_work(32, Hs, s.head_dim, s.n_groups, s.d_state, s.chunk, 2, 4, 4)
    assert k32["ssd_scan_bwd"]["bytes"] == n_layers * want
    assert k32["ssd_scan"]["bytes"] > k16["ssd_scan"]["bytes"]
    assert k32["ssd_scan_bwd"]["bytes"] > k16["ssd_scan_bwd"]["bytes"]


def test_f32_mamba2_lm_prefill_matches_jax():
    """mamba2-2.7b-smoke with dtype f32: one 40-token prefill of two
    streams from empty caches, logits, the last hidden state, conv tails
    and SSD states within 1e-5 of the reference's largest magnitude."""
    arch = "mamba2-2.7b-smoke"
    jc = dataclasses.replace(j_get_config(arch), dtype="float32")
    tc = dataclasses.replace(get_config(arch), dtype="float32")
    params, _ = jtfm.init_params(jc, jax.random.PRNGKey(0))
    tp = from_numpy_tree(jax.tree_util.tree_map(np.asarray, params))
    S_, T, slots = 2, 40, 64
    rng = np.random.default_rng(4)
    x = rng.normal(size=(S_, T, jc.d_model)).astype(np.float32)
    valid = rng.random((S_, T)) < 0.8
    lj, cj, hj = jtfm.prefill(jc, params, jnp.zeros((S_, T), jnp.int32),
                              jtfm.init_caches(jc, S_, slots, dtype=jnp.float32), valid=valid,
                              inputs_embeds=x, cache_offset=0)
    lt, ct, ht = tfm.prefill(tc, tp, torch.zeros((S_, T), dtype=torch.long),
                             tfm.init_caches(tc, S_, slots, dtype=torch.float32),
                             valid=torch.from_numpy(valid), inputs_embeds=torch.from_numpy(x),
                             cache_offset=0)
    pairs = [(lt, lj), (ht, hj)] + [(a, b) for bt, bj in zip(ct.blocks, cj.blocks)
                                    for a, b in zip(bt, bj)]
    for a, b in pairs:
        b = np.asarray(b)
        assert a.dtype == torch.float32
        assert np.abs(a.numpy() - b).max() <= 1e-5 * np.abs(b).max()


def test_chip_smoke_phase_7j_case_is_the_full_model_at_d_state_512():
    """chip_smoke's phase 7(j) serves mamba2-2.7b at full size re-cut to
    d_state 512 (four column slabs, read in place), 2 x 40 frames of
    codecflow; the dispatch audit's third table takes its every call, the
    scan at (H 80, P 64, N 512) on the kernel."""
    import importlib.util
    from pathlib import Path
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    key, arch, cfg, modes, frames, _ = {m[0]: m for m in cs.family_models()}["(j)"]
    full = get_config("mamba2-2.7b")
    assert (arch, modes, frames) == ("mamba2-2.7b, d_state 512", ("codecflow",), 40)
    assert cfg == audit.with_state(full, 512) and cfg.ssm.d_state == cs.WIDER_STATE
    assert cfg.n_layers == full.n_layers == 64 and S.column_slabs(cfg.ssm.d_state) == 4
    rows = [r for r in audit.variant_rows() if r.arch == arch]
    assert {r.op for r in rows} == {"mv_sad", "flash_packed", "ssd_scan"}
    assert all(r.verdict == "kernel" for r in rows), rows
    assert [r.geometry for r in rows if r.op == "ssd_scan"] == [
        "H 80, P 64, N 512, chunk 256, bfloat16"]

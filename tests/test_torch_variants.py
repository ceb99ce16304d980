"""The serving variants of the port against the JAX package's, on the CPU.

* int8 cold pages: ``page_quant_scale`` / ``quantize_kv`` /
  ``dequantize_kv`` bitwise, ``KVPool`` cold accounting step by step,
  ``demote_pool_caches`` and the two-precision ``reuse_pool_caches`` on
  the same slab.
* ``codecflow`` on per-stream caches, ``codecflow`` with int8 cold
  pages, and the online-refresh baselines ``vlcache`` and ``cacheblend``
  on both KV layouts, served through both lockstep schedulers
  (``torch_mode_parity``; the other baselines are in
  ``test_torch_modes.py``).  Equal: the event order (throttling
  included), token accounting, refresh sets, demotions and the FLOP
  ledger.  Yes/no logits within ``torch_mode_parity.LOGIT_TOL``
  (1.75e-2, 1.5x the largest gap measured, cacheblend's); answers equal
  where the JAX margin exceeds twice that.
* cacheblend's online probe against the JAX package's on reused caches
  that deviate for real, on per-stream caches, a bf16 slab and a
  two-precision slab.

The int8 run is held against the JAX package's int8 run, not against
bf16 answers.  Its geometry keeps every patch (keep 1.0) so one overlap
page per stream demotes at this size, and the second stream is admitted
only after the first has demoted.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core import kv_pool as jkv  # noqa: E402
from repro.core.kvc import WindowLayout as JWindowLayout  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.serving import api as japi  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import kv_pool as tkv  # noqa: E402
from repro_torch.core.kvc import WindowLayout  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import transformer as ttfm  # noqa: E402
from torch_mode_parity import (  # noqa: E402
    ARCH, assert_no_refusals, assert_parity, assert_plain_dispatch, jax_pipeline,
    port_pipeline, serve,
)
from torch_threads import torch_one_thread  # noqa: E402,F401

def bf16_pair(x: np.ndarray):
    """The same bf16 values for both frameworks."""
    xt = torch.from_numpy(x).to(torch.bfloat16)
    return jnp.asarray(xt.float().numpy()).astype(jnp.bfloat16), xt


def as_np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return (a.float() if a.dtype == torch.bfloat16 else a).numpy()
    return np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a)


# ----------------------------------------------------------------------
# quantisation helpers
# ----------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quant_helpers_bitwise_equal_jax(dtype):
    rng = np.random.default_rng(0)
    vals = rng.normal(size=(3, 4, 16, 2, 8)).astype(np.float32) * 3
    vals[1, 2] = 0.0                                       # an all-zero page
    if dtype == "bfloat16":
        vj, vt = bf16_pair(vals)
    else:
        vj, vt = jnp.asarray(vals), torch.from_numpy(vals)
    sj = jlayers.page_quant_scale(vj, (2, 4))
    st = tlayers.page_quant_scale(vt, (2, 4))
    np.testing.assert_array_equal(as_np(st), as_np(sj))
    assert (st[1, 2] == 1.0).all()
    qj = jlayers.quantize_kv(vj, sj[:, :, None, :])
    qt = tlayers.quantize_kv(vt, st[:, :, None, :])
    assert qt.dtype == torch.int8
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    assert (qt[1, 2] == 0).all()
    for out in (jnp.bfloat16, jnp.float32):
        tdt = torch.bfloat16 if out == jnp.bfloat16 else torch.float32
        dj = jlayers.dequantize_kv(qj, sj[:, :, None, :], out)
        dt = tlayers.dequantize_kv(qt, st[:, :, None, :], tdt)
        assert dt.dtype == tdt
        np.testing.assert_array_equal(as_np(dt), as_np(dj))


def test_quantize_rounds_half_to_even_and_saturates():
    scale = np.full((1, 2), 0.5, np.float32)
    vals = np.array([[[0.25, 0.75, -0.25, 1.25], [100.0, -100.0, 0.0, 63.25]]], np.float32)
    qj = np.asarray(jlayers.quantize_kv(jnp.asarray(vals), jnp.asarray(scale)))
    qt = tlayers.quantize_kv(torch.from_numpy(vals), torch.from_numpy(scale)).numpy()
    np.testing.assert_array_equal(qt, qj)
    np.testing.assert_array_equal(qt[0, 0], [0, 2, 0, 2])
    np.testing.assert_array_equal(qt[0, 1], [127, -127, 0, 126])


# ----------------------------------------------------------------------
# KVPool cold accounting
# ----------------------------------------------------------------------
def _pool_state(pool):
    return (pool.free_pages, pool.free_cold_pages, pool.used_pages,
            pool._reserved_cold, sorted(pool._in_use), list(pool._free),
            list(pool._free_cold))


def test_kv_pool_cold_accounting_equals_jax():
    jp = jkv.KVPool(j_get_config(ARCH), 5, cold_pages=4)
    tp = tkv.KVPool(get_config(ARCH), 5, cold_pages=4)
    assert _pool_state(tp) == _pool_state(jp)
    assert tp.slab_bytes == jp.slab_bytes
    assert tp.page_bytes() == jp.page_bytes()
    assert tp.page_bytes(cold=True) == jp.page_bytes(cold=True)
    assert tp.bytes_per_stream(2, 1) == jp.bytes_per_stream(2, 1)

    steps = [
        ("can_admit_streams", (1, 3, 2)), ("can_admit_streams", (2, 3, 2)),
        ("admit_streams", (1, 3, 2)), ("can_admit_streams", (1, 3, 2)),
        ("demote", ([0, 1],)), ("can_admit_streams", (1, 3, 2)),
        ("admit_streams", (1, 3, 2)), ("unreserve_cold", (2,)),
        ("evict", ([2, 5, 6],)), ("evict", ([1, 0, 3],)),
        ("admit_streams", (1, 3, 2)), ("demote", ([3],)), ("unreserve_cold", (5,)),
    ]
    for name, args in steps:
        out_j = getattr(jp, name)(*args)
        out_t = getattr(tp, name)(*args)
        if isinstance(out_j, np.ndarray):
            np.testing.assert_array_equal(out_t, out_j)
        else:
            assert out_t == out_j, name
        assert _pool_state(tp) == _pool_state(jp), (name, args)
    with pytest.raises(tkv.PoolExhausted):
        tp.admit_streams(1, 3, 4)
    with pytest.raises(ValueError):
        tp.evict([4])


# ----------------------------------------------------------------------
# demotion and two-precision reuse on the same slab
# ----------------------------------------------------------------------
def _quant_slabs(cfg_j, cfg_t, n_hot, n_cold, seed):
    """A two-precision slab with the same content in both frameworks."""
    rng = np.random.default_rng(seed)
    jp = jkv.KVPool(cfg_j, n_hot, cold_pages=n_cold)
    tp = tkv.KVPool(cfg_t, n_hot, cold_pages=n_cold)
    blocks_j = []
    for blk_t in tp.slab.blocks:
        leaves = []
        for leaf in blk_t:
            shape = tuple(leaf.shape)
            if leaf.dtype == torch.int8:
                x = rng.integers(-127, 128, size=shape).astype(np.int8)
                xj, xt = jnp.asarray(x), torch.from_numpy(x)
            elif leaf.dtype == torch.float32:
                x = rng.uniform(0.01, 0.05, size=shape).astype(np.float32)
                xj, xt = jnp.asarray(x), torch.from_numpy(x)
            else:
                xj, xt = bf16_pair(rng.normal(size=shape).astype(np.float32))
            leaf.copy_(xt)
            leaves.append(xj)
        blocks_j.append(jlayers.QuantKVCache(*leaves))
    jp.slab = jp.slab._replace(blocks=tuple(blocks_j))
    return jp, tp


def _assert_slabs_equal(jslab, tslab, k_rtol=0.0, k8_tol=0):
    for bj, bt in zip(jslab.blocks, tslab.blocks):
        np.testing.assert_array_equal(as_np(bt.v), as_np(bj.v))
        np.testing.assert_array_equal(as_np(bt.v8), as_np(bj.v8))
        np.testing.assert_array_equal(as_np(bt.v_scale), as_np(bj.v_scale))
        np.testing.assert_allclose(as_np(bt.k), as_np(bj.k), rtol=k_rtol,
                                   atol=1e-3 if k_rtol else 0)
        np.testing.assert_allclose(as_np(bt.k8).astype(np.int32),
                                   as_np(bj.k8).astype(np.int32), atol=k8_tol, rtol=0)
        np.testing.assert_allclose(as_np(bt.k_scale), as_np(bj.k_scale), rtol=k_rtol)


def test_demote_pool_caches_equals_jax():
    jp, tp = _quant_slabs(j_get_config(ARCH), get_config(ARCH), 6, 4, seed=1)
    src = np.array([[4, 1], [0, 5]], np.int32)
    dst = np.array([[7, 9], [6, 8]], np.int32)
    jslab = jkv.demote_pool_caches(jp.slab, jnp.asarray(src), jnp.asarray(dst), 128)
    tslab = tkv.demote_pool_caches(tp.slab, torch.from_numpy(src), torch.from_numpy(dst), 128)
    _assert_slabs_equal(jslab, tslab)                     # no rotation: bitwise


@pytest.mark.parametrize("cold_cols", [(), (0,), (0, 1)])
def test_two_precision_reuse_equals_jax(cold_cols):
    """Overlap pages [0, n_full) of each stream hot or cold: hot writes,
    dequantised gathers and requantisation with fresh scales.  The keys
    go through RoPE, whose f32 angles and sin/cos differ in the last bits
    between the frameworks (up to ~1e-5 |k| at the shift's angles): hot
    keys within one bf16 step plus 1e-3 (the bound ``test_torch_gpu.py``
    holds the bf16 rope_shift to), key scales within one bf16 step,
    requantised keys within one int8 step; values are bitwise equal."""
    cfg_t = get_config(ARCH)
    lay_args = dict(window=16, stride=4, gop=4, g_tokens=64, k_tokens=64, query_len=8)
    layout_j, layout_t = JWindowLayout(**lay_args), WindowLayout(**lay_args)
    assert layout_t.overlap_tokens // 128 == 6
    n_pages = -(-(layout_t.total_len + 1) // 128)          # 9 pages per stream
    jp, tp = _quant_slabs(j_get_config(ARCH), cfg_t, 2 * n_pages, 12, seed=2)
    pt = np.arange(2 * n_pages, dtype=np.int32).reshape(2, n_pages)
    for col in cold_cols:
        pt[0, col] = 2 * n_pages + col
        pt[1, 2 + col] = 2 * n_pages + 6 + col
    jslab = jkv.reuse_pool_caches(j_get_config(ARCH), jp.slab, jnp.asarray(pt), layout_j, 128)
    tslab = tkv.reuse_pool_caches(cfg_t, tp.slab, torch.from_numpy(pt), layout_t, 128)
    _assert_slabs_equal(jslab, tslab, k_rtol=2.0 ** -7, k8_tol=1)


# ----------------------------------------------------------------------
# serving: the port against the JAX package, both lockstep schedulers
# ----------------------------------------------------------------------
CONFIGS = {
    "codecflow-stream": ("codecflow", False, "bf16", 0.5),
    "codecflow-int8": ("codecflow", True, "int8", 1.0),
    "vlcache-paged": ("vlcache", True, "bf16", 0.5),
    "vlcache-stream": ("vlcache", False, "bf16", 0.5),
    "cacheblend-paged": ("cacheblend", True, "bf16", 0.5),
    "cacheblend-stream": ("cacheblend", False, "bf16", 0.5),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_variant_serves_like_jax(name):
    j, t = serve(*CONFIGS[name])
    assert_parity(j, t, exact_refresh=not name.startswith("cacheblend"))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_variant_dispatches_its_kernels_plainly_on_cpu(name):
    assert_plain_dispatch(serve(*CONFIGS[name])[1])


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_variant_windows_report_no_kernel_fallbacks(name):
    """bf16 slabs, per-stream caches and int8 cold pages: the card takes
    every kernel call of every window."""
    assert_no_refusals(serve(*CONFIGS[name])[1][1])


def test_int8_run_demotes_and_staggers_admission():
    j, t = serve(*CONFIGS["codecflow-int8"])
    kinds = [e[0] for e in t[0]]
    assert "StreamThrottled" in kinds
    # stream 1 waits for stream 0's first demotion (window 1)
    assert kinds.index("StreamThrottled") < t[0].index(("WindowDone", 0, 1)) \
        < t[0].index(("StreamAdmitted", 1, None))
    assert len(t[3]) == 2 and all(d.size == 1 for d in t[3])
    pipe = t[5]
    pool = pipe.backend.pool
    assert pool.n_cold == 2 and pool.used_pages == 0 and pool._reserved_cold == 0
    # steady state: (P - D) hot bf16 pages + D int8 pages with scales
    bf16_page = pool.page_bytes()
    assert t[1][0][-1].stats.kv_bytes_per_stream == (
        (pipe.backend.pages_per_stream - 1) * bf16_page + pool.page_bytes(cold=True))
    assert pool.page_bytes(cold=True) < bf16_page


@pytest.mark.parametrize("name", ["cacheblend-paged", "cacheblend-stream"])
def test_cacheblend_refreshes_its_top_deviations(name):
    """While serving, cacheblend's set is the top-``budget`` overlap tokens
    by the port's own layer-0 key deviation.  There the overlap's
    embeddings are cached, so recomputed and reused keys differ by
    rounding alone and which tokens make the cut is decided by last bits
    where the frameworks differ; the probe itself is held to the JAX
    package's on real deviations by ``test_cacheblend_probe_equals_jax``."""
    j, t = serve(*CONFIGS[name])
    lay, devs = t[5].layout, t[6]
    budget = len(lay.anchor_token_idx)
    tail = np.arange(lay.overlap_tokens, lay.total_len)
    assert len(devs) == len(t[2]) == 4      # 2 streams x 2 incremental windows
    for dev, ridx in zip(devs, t[2]):
        assert dev.shape == (lay.overlap_tokens,) and np.isfinite(dev).all()
        top = np.argsort(-dev, kind="stable")[:budget]
        np.testing.assert_array_equal(ridx, np.union1d(top, tail))


def _probe_caches(cfg, slots, slab, rng):
    """Reused caches (JAX, port) and page tables of one stream whose
    layer-0 keys are random, scaled per slot: not the keys the embeddings
    give, so each overlap token deviates by its own real amount.  ``slab``:
    per-stream caches, a bf16 slab through a shuffled page table, or a
    two-precision slab whose table alternates hot and int8 cold pages."""
    R, n_kv, dh = cfg.repeats, cfg.n_kv, cfg.d_head
    n_pages = slots // 128

    def keys(lead, n_rows):
        scale = rng.uniform(0.25, 2.0, size=(1,) * len(lead) + (n_rows, 1, 1))
        return bf16_pair((rng.normal(size=lead + (n_rows, n_kv, dh)) * scale)
                         .astype(np.float32))

    if slab == "stream":
        kj, kt = keys((R, 1), slots)
        return ((jtfm.Caches((jlayers.KVCache(kj, kj),)), None),
                (ttfm.Caches((tlayers.KVCache(kt, kt),)), None))
    n_hot = n_pages + 2
    kj, kt = keys((R,), n_hot * 128)
    pt = rng.permutation(n_hot)[:n_pages].astype(np.int32)[None]
    if slab == "paged-bf16":
        blk_j, blk_t = jlayers.KVCache(kj, kj), tlayers.KVCache(kt, kt)
    else:
        n_cold = n_pages
        k8 = rng.integers(-127, 128, size=(R, n_cold * 128, n_kv, dh)).astype(np.int8)
        sc = rng.uniform(0.005, 0.02, size=(R, n_cold, n_kv)).astype(np.float32)
        blk_j = jlayers.QuantKVCache(kj, kj, jnp.asarray(k8), jnp.asarray(k8),
                                     jnp.asarray(sc), jnp.asarray(sc))
        blk_t = tlayers.QuantKVCache(kt, kt, torch.from_numpy(k8), torch.from_numpy(k8),
                                     torch.from_numpy(sc), torch.from_numpy(sc))
        cold = np.arange(n_pages) % 2 == 0
        pt[0, cold] = n_hot + rng.permutation(n_cold)[: int(cold.sum())]
    return ((jtfm.Caches((blk_j,)), jnp.asarray(pt)),
            (ttfm.Caches((blk_t,)), torch.from_numpy(pt)))


# deviations: the norm over (kv head, d_head) of recomputed minus reused
# layer-0 keys, in f32.  The recomputed keys are bf16 and come out equal
# in both frameworks here; the norms sum n_kv * d_head squares in their
# own orders, which moves a sum by at most that many f32 roundings
# (2^-24 relative each)
def probe_rtol(cfg) -> float:
    return cfg.n_kv * cfg.d_head * 2.0 ** -24


@pytest.mark.parametrize("slab", ["stream", "paged-bf16", "paged-int8"])
def test_cacheblend_probe_equals_jax(slab, monkeypatch):
    """The port's ``cacheblend_deviation`` against the deviations the JAX
    package's ``refresh_indices`` ranks (recorded where it sorts them), on
    the same embeddings and reused caches, within ``probe_rtol``; the
    refresh sets are equal wherever the deviations at the cut are further
    apart than that.  Keep 1.0 makes the overlap six pages long, so the
    int8 slab's overlap reads hot and cold pages."""
    paged, stale = slab != "stream", ("int8" if slab == "paged-int8" else "bf16")
    jb = jax_pipeline("cacheblend", paged, stale, keep_ratio=1.0).backend
    tb = port_pipeline("cacheblend", paged, stale, keep_ratio=1.0).backend
    cfg, lay = tb.cfg, tb.layout
    rng = np.random.default_rng(7)
    ej, et = bf16_pair(rng.normal(size=(1, lay.total_len, cfg.d_model)).astype(np.float32))
    (cj, ptj), (ct, ptt) = _probe_caches(cfg, tb.cache_slots, slab, rng)

    sorted_by_jax = []

    class SortSpy:
        """The JAX module's ``jnp``, recording what its probe sorts."""

        def __getattr__(self, name):
            return getattr(jnp, name)

        @staticmethod
        def argsort(a, *args, **kw):
            sorted_by_jax.append(-np.asarray(a, np.float32))
            return jnp.argsort(a, *args, **kw)

    monkeypatch.setattr(japi, "jnp", SortSpy())
    ridx_j = jb.refresh_indices(ej, cj, page_table=ptj)
    monkeypatch.undo()
    assert len(sorted_by_jax) == 1
    dev_j = sorted_by_jax[0]
    dev_t = tb.cacheblend_deviation(et, ct, page_table=ptt).numpy()
    ridx_t = tb.refresh_indices(et, ct, page_table=ptt)

    assert dev_t.shape == dev_j.shape == (lay.overlap_tokens,)
    assert dev_j.min() > 1.0                  # every token deviates for real
    rtol = probe_rtol(cfg)
    np.testing.assert_allclose(dev_t, dev_j, rtol=rtol, atol=0)
    budget = len(lay.anchor_token_idx)
    s = np.sort(dev_j)[::-1]
    tol = rtol * s[budget - 1]
    tail = np.arange(lay.overlap_tokens, lay.total_len)
    np.testing.assert_array_equal(ridx_t[ridx_t >= lay.overlap_tokens], tail)
    np.testing.assert_array_equal(ridx_j[ridx_j >= lay.overlap_tokens], tail)
    # a token the two sets disagree on lies within tol of the cut
    for i in np.setxor1d(ridx_t, ridx_j):
        assert s[budget] - tol <= dev_j[i] <= s[budget - 1] + tol, i
    assert s[budget - 1] - s[budget] > 2 * tol, "this input separates the cut"
    np.testing.assert_array_equal(ridx_t, ridx_j)


def test_cacheblend_never_fuses_incremental_windows():
    j, t = serve(*CONFIGS["cacheblend-paged"])
    steps = [e for e in t[0] if e[0] == "WindowDone" and e[2] > 0]
    assert len(steps) == len(t[2]) == 4     # one refresh set per stream and window
    pipe = t[5]
    assert pipe.backend.t_map > 0 and pipe.backend.block_map is None

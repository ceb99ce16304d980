"""The MoE family on the port against the JAX package.

``moe_block`` on identical bf16 inputs, through ``jax.jit`` of the
reference's and the port's: at the ``-smoke`` widths of olmoe-1b-7b,
moonshot-v1-16b-a3b and arctic-480b (dense residual), which seldom drop
(4 experts, capacity factor 2.0), and at a narrow width (d 64) with
olmoe's own routing (64 experts, top-8, factor 1.25): a prefill-shaped
call, a decode-shaped one (B 2, T 1, so ``cap`` 1), and factor 0.01,
where most assignments drop.  Equal: expert choices, their sorted
order, kept slots and buffer rows.  Within tolerance: the output to
2^-5 of its largest magnitude (measured up to 1.1e-2: the bf16 SwiGLU
rounds at other points in the two frameworks, as in ``mlp_block``), and
the aux loss to 1e-6 (f32 sums in another order).

olmoe-1b-7b-smoke serves like the reference in all six modes on the
paged slab (modes without reuse keep per-stream caches), through both
lockstep schedulers (``torch_mode_parity``).  Equal in the port's own
run: event order, token accounting, the FLOP ledger and the refresh sets
(cacheblend's in size and past the overlap, as for internvl).  The two
frameworks round differently, so some tokens pick other experts on near
ties: ``torch_moe_routes`` reports each with its gate margin, and the
port is served again on the reference's choices (and cacheblend's
refresh sets), where every choice it would have made otherwise must be
a near tie and its yes/no logits are within 1.1e-2 of the reference's
(1.5x the largest gap measured there, 7.1e-3 in refresh_only).  In f32
the olmoe-smoke stack is the reference's to 1e-5.
"""
import dataclasses
import functools
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import MoECfg as JMoECfg  # noqa: E402
from repro.configs.registry import get_config as j_get_config  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.models.init import ParamBuilder, split_tree  # noqa: E402
from repro.serving import Scheduler as JScheduler  # noqa: E402
from repro.serving import SchedulerCfg as JSchedulerCfg  # noqa: E402
from repro.serving import StreamRequest as JStreamRequest  # noqa: E402
from repro.training import checkpoint  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import MoECfg  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.flash_refresh import build_block_map  # noqa: E402
from repro_torch.launch.serve import main as serve_main  # noqa: E402
from repro_torch.models import layers, transformer  # noqa: E402
from repro_torch.models.init import (  # noqa: E402
    from_numpy_tree, init_lm_params, load_npz_params, to_tensor,
)
from repro_torch.serving import (  # noqa: E402
    MODES, REUSE_MODES, Scheduler, SchedulerCfg, StreamRequest,
)
import torch_mode_parity as parity  # noqa: E402
import torch_moe_routes as routes  # noqa: E402

ARCH = "olmoe-1b-7b-smoke"
OUT_TOL = 2.0 ** -5
AUX_TOL = 1e-6
LOGIT_TOL = 1.1e-2

NARROW = dict(n_experts=64, top_k=8, d_ff_expert=32)      # olmoe's routing at d 64
BLOCK_CASES = {
    "olmoe-smoke": ("olmoe-1b-7b-smoke", None, None, (2, 24)),
    "moonshot-smoke": ("moonshot-v1-16b-a3b-smoke", None, None, (2, 24)),
    "arctic-smoke-dense-residual": ("arctic-480b-smoke", None, None, (2, 24)),
    "olmoe-routing-prefill": (None, NARROW, 64, (2, 40)),
    "olmoe-routing-decode": (None, NARROW, 64, (2, 1)),
    "olmoe-routing-factor-0.01": (None, dict(NARROW, capacity_factor=0.01), 64, (2, 40)),
}


def _moe_case(name):
    """(JAX MoECfg, port MoECfg, d, d_ff of the dense residual, (B, T))."""
    arch, moe, d, shape = BLOCK_CASES[name]
    if arch is not None:
        jc, tc = j_get_config(arch), get_config(arch)
        return jc.moe, tc.moe, jc.d_model, jc.d_ff, shape
    return JMoECfg(**moe), MoECfg(**moe), d, 96, shape


def _jax_route(p, cfg, x):
    """The reference ``moe_block``'s routing lines, jitted: choices, sorted
    order, kept flags, buffer rows."""
    E, k = cfg.n_experts, cfg.top_k
    x2 = x.reshape(-1, x.shape[-1])
    n = x2.shape[0]
    gates = jax.nn.softmax((x2 @ p["router"]).astype(jnp.float32), axis=-1)
    _, tope = jax.lax.top_k(gates, k)
    flat_e = tope.reshape(-1)
    order = jnp.argsort(flat_e)
    se = flat_e[order]
    counts = jnp.zeros((E,), jnp.int32).at[flat_e].add(1)
    starts = jnp.cumsum(counts) - counts
    pos = jnp.arange(n * k) - starts[se]
    cap = int(cfg.capacity_factor * n * k / E) + 1
    keep = pos < cap
    return tope, order, keep, se * cap + jnp.where(keep, pos, cap - 1)


@functools.lru_cache(maxsize=None)
def moe_run(name):
    jcfg, tcfg, d, d_ff, (B, T) = _moe_case(name)
    jp, _ = split_tree(jlayers.init_moe(ParamBuilder(jax.random.PRNGKey(4)), d, jcfg, d_ff))
    tp = from_numpy_tree(jax.tree_util.tree_map(np.asarray, jp))
    x = np.random.default_rng(5).normal(size=(B, T, d)).astype(np.float32)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    out_j, aux_j = jax.jit(lambda p, x: jlayers.moe_block(p, jcfg, x))(jp, xj)
    route_j = jax.jit(lambda p, x: _jax_route(p, jcfg, x))(jp, xj)
    xt = to_tensor(np.asarray(xj))
    out_t, aux_t = layers.moe_block(tp, tcfg, xt)
    route_t = layers.moe_route(tp, tcfg, xt.reshape(B * T, d))
    return (out_j, aux_j, [np.asarray(a) for a in route_j]), (out_t, aux_t, route_t), tcfg, B * T


@pytest.mark.parametrize("name", sorted(BLOCK_CASES))
def test_moe_block_matches_jax(name):
    (out_j, aux_j, (tope_j, order_j, keep_j, slot_j)), (out_t, aux_t, r), cfg, n = moe_run(name)
    np.testing.assert_array_equal(r.tope.numpy(), tope_j)
    np.testing.assert_array_equal(r.order.numpy(), order_j)
    np.testing.assert_array_equal(r.keep.numpy(), keep_j)
    np.testing.assert_array_equal(r.slot.numpy(), slot_j)
    assert r.cap == int(cfg.capacity_factor * n * cfg.top_k / cfg.n_experts) + 1
    a = np.asarray(out_j.astype(jnp.float32))
    b = out_t.float().numpy()
    assert out_t.dtype == torch.bfloat16 and np.isfinite(b).all()
    assert np.abs(a - b).max() <= OUT_TOL * np.abs(a).max(), np.abs(a - b).max()
    assert aux_t.dtype == torch.float32
    assert abs(float(aux_t) - float(aux_j)) <= AUX_TOL


def test_capacity_drops_like_the_reference():
    """One decode step of 2 streams at olmoe's routing has cap 1: a second
    token choosing an expert is dropped; at factor 0.01 most are."""
    *_, (_, _, r), _, _ = moe_run("olmoe-routing-decode")
    assert r.cap == 1
    e = r.tope.numpy()
    shared = set(e[0]) & set(e[1])
    assert int((~r.keep).sum()) == len(shared)
    *_, (_, _, r), _, _ = moe_run("olmoe-routing-factor-0.01")
    assert r.cap == 1 and float(r.keep.float().mean()) < 0.25


def test_top_k_breaks_ties_toward_the_lower_expert():
    gates = np.asarray([[0.25, 0.25, 0.25, 0.25], [0.1, 0.3, 0.3, 0.3],
                        [0.3, 0.2, 0.3, 0.2], [0.2, 0.2, 0.4, 0.2]], np.float32)
    for k in (1, 2, 3):
        vj, ij = jax.lax.top_k(jnp.asarray(gates), k)
        vt, it = layers.top_k_lower_first(torch.from_numpy(gates), k)
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
        np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))


def test_combine_equals_the_reference_scatter_add_bitwise():
    """The port's fixed-order bf16 sum of each token's k expert rows is
    the reference's ``zeros.at[token].add(y)`` over the sorted
    assignments, bit for bit, on rows whose magnitudes span 2^-8 .. 2^8
    (so the order of the adds shows in the bf16 result)."""
    rng = np.random.default_rng(11)
    n, k, d, E = 37, 8, 48, 64
    tope = np.stack([rng.choice(E, k, replace=False) for _ in range(n)])
    order = np.argsort(tope.reshape(-1), kind="stable")
    y = (rng.normal(size=(n * k, d)) * 2.0 ** rng.integers(-8, 9, (n * k, 1))).astype(np.float32)
    yj = jnp.asarray(y).astype(jnp.bfloat16)
    st = jnp.asarray(order // k)
    out_j = jax.jit(lambda y, st: jnp.zeros((n, d), jnp.bfloat16).at[st].add(y))(yj, st)
    out_t = layers.combine_sorted(to_tensor(np.asarray(yj)), torch.from_numpy(order), n, k)
    np.testing.assert_array_equal(out_t.float().numpy(), np.asarray(out_j, np.float32))
    other = layers.combine_sorted(to_tensor(np.asarray(yj)).flip(0),
                                  torch.from_numpy(order), n, k)
    assert not torch.equal(other, out_t)      # the data does tell orders apart


# ----------------------------------------------------------------------
# olmoe-1b-7b-smoke served through both packages
# ----------------------------------------------------------------------
def _port_run(mode, choices, force=None, refresh=None):
    pipe = parity.port_pipeline(mode, True, arch=ARCH)
    if refresh is not None:
        sets = iter(refresh)
        pipe.backend.refresh_indices = lambda *a, **kw: next(sets)
    ops.reset_dispatch_counts()
    with routes.port_choices(choices, force=force):
        out = parity._drive(pipe, Scheduler(pipe, SchedulerCfg(max_concurrent=2,
                                                                pipelined=False)),
                            StreamRequest)
    return out + (ops.dispatch_counts(), pipe, None)


@functools.lru_cache(maxsize=None)
def served(mode):
    """(JAX run, port run, port run on the JAX choices or None, flips of
    the port's run, flips the port would have made on the JAX choices)."""
    jlog = []
    with routes.jax_choices(jlog):
        jp = parity.jax_pipeline(mode, mode in REUSE_MODES, arch=ARCH)
        j = parity._drive(jp, JScheduler(jp, JSchedulerCfg(max_concurrent=2, pipelined=False)),
                          JStreamRequest)
    tlog = []
    t = _port_run(mode, tlog)
    found = routes.flips(jlog, tlog)
    forced, forced_flips = None, []
    if found:
        flog = []
        forced = _port_run(mode, flog, force=jlog,
                           refresh=j[2] if mode == "cacheblend" else None)
        forced_flips = routes.flips(jlog, flog)
    return j, t, forced, found, forced_flips


@pytest.mark.parametrize("mode", MODES)
def test_olmoe_serves_like_jax(mode):
    j, t, forced, found, forced_flips = served(mode)
    exact = mode != "cacheblend"
    parity.assert_parity(j, t, exact_refresh=exact, tol=np.inf)
    routes.assert_near_ties(forced_flips)
    parity.assert_parity(j, forced or t, exact_refresh=exact, tol=LOGIT_TOL)
    if found:
        print(f"{mode}: {len(found)} tokens chose other experts in the port's run; "
              f"on the reference's choices {len(forced_flips)} would, with margins "
              f"{[round(f[4], 6) for f in forced_flips]}")


@pytest.mark.parametrize("mode", MODES)
def test_olmoe_dispatches_its_kernels_plainly_on_cpu(mode):
    _, t, _, _, _ = served(mode)
    parity.assert_plain_dispatch(t)
    pipe = t[5]
    attn = "flash_refresh_paged" if mode in REUSE_MODES else "flash_refresh"
    assert pipe.kernels == ({"mv_sad", attn} | ({"flash_packed"} if pipe.prune else set())
                            | ({"rope_shift"} if pipe.reuse else set()))


# ----------------------------------------------------------------------
# weights
# ----------------------------------------------------------------------
@pytest.mark.parametrize("mode", MODES)
def test_olmoe_windows_report_no_kernel_fallbacks(mode):
    parity.assert_no_refusals(served(mode)[1][1])


@pytest.mark.parametrize("arch", ["olmoe-1b-7b-smoke", "arctic-480b-smoke"])
def test_moe_weight_bridge_and_npz_round_trip(arch, tmp_path):
    """The JAX package's MoE tree bridges leaf for leaf and a checkpoint
    of it loads back exactly: router and experts bf16, norm scales f32,
    arctic's dense residual under ``ffn/residual``."""
    jp, _ = jtfm.init_params(j_get_config(arch), jax.random.PRNGKey(0))
    tree = from_numpy_tree(jax.tree_util.tree_map(np.asarray, jp))
    flat_t = dict(jax.tree_util.tree_leaves_with_path(tree))
    for path, leaf in jax.tree_util.tree_leaves_with_path(jp):
        assert tuple(flat_t[path].shape) == leaf.shape
        assert str(flat_t[path].dtype).endswith(str(leaf.dtype)), path
        np.testing.assert_array_equal(flat_t[path].float().numpy(), np.asarray(leaf, np.float32))
    path = str(tmp_path / "moe.npz")
    checkpoint.save(path, jp)
    loaded = load_npz_params(path, get_config(arch))
    flat_l = jax.tree_util.tree_leaves_with_path(loaded)
    assert len(flat_l) == len(flat_t)
    for p, leaf in flat_l:
        assert leaf.dtype == flat_t[p].dtype and torch.equal(leaf, flat_t[p]), p
    ffn = loaded["blocks"][0]["ffn"]
    assert ffn["router"].dtype == torch.bfloat16 and ffn["wg"].dim() == 4
    assert loaded["blocks"][0]["ln2"]["scale"].dtype == torch.float32
    assert ("residual" in ffn) == (arch == "arctic-480b-smoke")


@pytest.mark.parametrize("arch", ["olmoe-1b-7b-smoke", "moonshot-v1-16b-a3b-smoke",
                                  "arctic-480b-smoke"])
def test_random_moe_params_match_jax_structure(arch):
    jp, _ = jtfm.init_params(j_get_config(arch), jax.random.PRNGKey(0))
    tp = init_lm_params(get_config(arch), seed=0, device="cpu")
    flat_j = jax.tree_util.tree_leaves_with_path(jp)
    flat_t = jax.tree_util.tree_leaves_with_path(tp)
    assert [p for p, _ in flat_j] == [p for p, _ in flat_t]
    for (p, lj), (_, lt) in zip(flat_j, flat_t):
        assert lj.shape == tuple(lt.shape) and str(lt.dtype).endswith(str(lj.dtype)), p
    router = tp["blocks"][0]["ffn"]["router"].float()
    assert float(router.abs().max()) <= 2 * 0.02 + 1e-3


def test_f32_moe_stack_is_the_reference_function():
    """olmoe-smoke in f32 through two contiguous appends into per-stream
    caches: logits, hidden state and K/V within 1e-5 of the reference's
    largest magnitude (its expert choices then agree: no bf16 rounding
    separates the two)."""
    jc = dataclasses.replace(j_get_config(ARCH), dtype="float32")
    tc = dataclasses.replace(get_config(ARCH), dtype="float32")
    jp, _ = jtfm.init_params(jc, jax.random.PRNGKey(0))
    tp = from_numpy_tree(jax.tree_util.tree_map(np.asarray, jp))
    S, slots, off = 2, 256, 0
    rng = np.random.default_rng(2)
    jcaches = jtfm.init_caches(jc, S, slots, dtype=jnp.float32)
    tcaches = transformer.init_caches(tc, S, slots, dtype=torch.float32)
    step = jax.jit(lambda p, c, e, o: jtfm.prefill(
        jc, p, jnp.zeros(e.shape[:2], jnp.int32), c, inputs_embeds=e, cache_offset=o))
    for T in (150, 30):
        x = rng.normal(size=(S, T, jc.d_model)).astype(np.float32)
        lj, jcaches, hj = step(jp, jcaches, x, off)
        lt, tcaches, ht = transformer.prefill(
            tc, tp, torch.zeros((S, T), dtype=torch.long), tcaches,
            inputs_embeds=torch.from_numpy(x), cache_offset=off,
            block_map=build_block_map(np.arange(off, off + T), slots))
        off += T
        pairs = [(lt, lj), (ht, hj)] + [(leaf_t, leaf_j) for blk_t, blk_j in
                                        zip(tcaches.blocks, jcaches.blocks)
                                        for leaf_t, leaf_j in zip(blk_t, blk_j)]
        for a, b in pairs:
            b = np.asarray(b)
            assert np.abs(a.numpy() - b).max() <= 1e-5 * np.abs(b).max()


def test_launch_serve_olmoe_smoke_on_cpu(capsys):
    serve_main(["--arch", ARCH, "--device", "cpu", "--videos", "2", "--streams", "2",
                "--frames", "20"])
    out = capsys.readouterr().out
    report = json.loads(out[out.index("{"):])
    assert report["arch"] == ARCH and report["windows_total"] == 4
    assert report["scheduler"] == "pipelined" and report["GFLOP_per_window"] > 0

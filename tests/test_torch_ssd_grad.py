"""The SSD scan's backward: the port's plain backward against autograd and
against the JAX package's ``jax.grad``, its ``autograd.Function``, and the
meta path the dry run counts.

``ssd_scan_bwd_plain`` (the formulas the CUDA backward kernel computes,
chunk by chunk from the saved chunk states) is held against autograd
through the port's ``ssd_scan_plain`` and against ``jax.grad`` of the JAX
package's ``ops.ssd_scan`` (its reference scan on the CPU), on the same
numpy inputs, with y's cotangent and the final state's (or none).
Limits, per gradient, over each slice's largest |g| (x and dx per (batch
row, head), b/c per (batch row, group), log_a per (batch row, head), the
initial state per (batch row, head)): f32 within 1e-5 (both sum the same
f32 products in other orders: read 1e-7 .. 4e-7 of the global max); bf16
within 2^-7, one bf16 step (both round f32 values that differ by that
order); f16 within 2^-9, two f16 steps.  The cases run N 16 and, at two
column slabs, N 256 (f32, and bf16 at G 2), and f16 at N 16 and 256.

The backward kernel's three stages in their plain versions (each
chunk's (e o dY)^T C, the sequential dS pass, the chunk-local rest),
composed, equal ``ssd_scan_bwd_plain`` within 1e-6 of each slice's max
in f32 (the same f32 formulas, batched over chunks), and
``bwd_launch_geometry`` (the kernels' launches and scratch) fits an
H100: shared memory within 227 KB at every N, and the dB / dC partials
at mamba2-2.7b's training shape within a quarter of the first version's
671,088,640 bytes.

``SsdScanFn`` over the plain pair equals autograd through ``ops.ssd_scan``
on CPU tensors (which differentiates the plain version) for every
combination of inputs that require grad, a None init and a None
cotangent.  On meta tensors under grad, ``ops.ssd_scan`` keeps autograd,
and ``analysis.roofline.count_step`` of a train step counts its backward
as ``ssd_scan_bwd``, once per mamba layer, by ``ssd_scan_bwd_work``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.analysis import roofline as rl
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.kernels.ssd_scan import (
    SMEM_LIMIT, STATE_WIDTHS, SsdScanFn, bwd_launch_geometry, ssd_scan_bwd_plain,
    ssd_scan_bwd_staged, ssd_scan_bwd_work, ssd_scan_fwd_plain, ssd_scan_plain,
)
from repro_torch.models.init import meta_lm_params, trainable
from repro_torch.training.train_step import Batch, loss_fn, tree_grads
from torch_threads import torch_one_thread  # noqa: E402,F401

F32_TOL, BF16_TOL, F16_TOL = 1e-5, 2.0 ** -7, 2.0 ** -9
TOL = {"float32": F32_TOL, "bfloat16": BF16_TOL, "float16": F16_TOL}
NAMES = ("x", "log_a", "b", "c", "init")
# the dims of each gradient reduced within one slice
SLICE_DIMS = {"x": (1, 3), "log_a": (1,), "b": (1, 3), "c": (1, 3), "init": (2, 3)}
# (B, L, H, P, G, N, chunk, init, final-state cotangent, dtype)
CASES = {
    "G1, L a multiple of the chunk": (2, 32, 4, 8, 1, 16, 8, True, True, "float32"),
    "G2, ragged L": (2, 30, 4, 8, 2, 16, 8, False, True, "float32"),
    "G2, chunk >= L": (1, 20, 4, 8, 2, 16, 32, True, False, "float32"),
    "G1, ragged, no cotangent of the state": (2, 37, 4, 8, 1, 16, 16, False, False, "float32"),
    "G2, bf16": (2, 40, 4, 16, 2, 16, 16, True, True, "bfloat16"),
    "G1, bf16, ragged": (1, 21, 4, 8, 1, 16, 8, False, True, "bfloat16"),
    "N 256, ragged": (1, 30, 2, 8, 1, 256, 16, True, True, "float32"),
    "N 256, G2, bf16": (2, 24, 4, 8, 2, 256, 8, False, True, "bfloat16"),
    "G2, f16": (2, 40, 4, 16, 2, 16, 16, True, True, "float16"),
    "N 256, f16, ragged": (1, 30, 2, 8, 1, 256, 16, False, True, "float16"),
}


def case_arrays(case: str) -> dict:
    """numpy inputs and cotangents of one case, from a seed."""
    B, L, H, P, G, N, chunk, init, dfin, dt = CASES[case]
    rng = np.random.default_rng(sorted(CASES).index(case))
    a = dict(x=rng.normal(0, 1, (B, L, H, P)), log_a=-rng.uniform(1e-3, 1.0, (B, L, H)),
             b=rng.normal(0, 0.5, (B, L, G, N)), c=rng.normal(0, 0.5, (B, L, G, N)),
             init=rng.normal(0, 1, (B, H, P, N)) if init else None,
             gy=rng.normal(0, 1, (B, L, H, P)),
             gs=rng.normal(0, 1, (B, H, P, N)) if dfin else None)
    return {k: None if v is None else v.astype(np.float32) for k, v in a.items()}


def jax_grads(case: str) -> dict:
    """jax.grad of sum(y * gy) + sum(state * gs) through the JAX
    package's ``ops.ssd_scan``, in the case's dtype (log_a and the state
    in f32)."""
    *_, chunk, _, _, dt = CASES[case]
    a = case_arrays(case)
    names = [n for n in NAMES if a[n] is not None]
    ins = {n: jnp.asarray(a[n], dt if n in ("x", "b", "c") else jnp.float32) for n in names}

    def loss(ins):
        y, st = jops.ssd_scan(ins["x"], ins["log_a"], ins["b"], ins["c"], ins.get("init"),
                              chunk=chunk)
        out = jnp.sum(y.astype(jnp.float32) * a["gy"])
        return out if a["gs"] is None else out + jnp.sum(st * a["gs"])

    g = jax.grad(loss)(ins)
    return {n: np.asarray(g[n].astype(jnp.float32)) for n in names}


@pytest.fixture(scope="module")
def jax_refs():
    return {case: jax_grads(case) for case in CASES}


def torch_inputs(case: str, requires_grad: bool = False) -> dict:
    dt = getattr(torch, CASES[case][-1])
    a = case_arrays(case)
    out = {}
    for n in NAMES:
        if a[n] is None:
            out[n] = None
            continue
        t = torch.from_numpy(a[n]).to(dt if n in ("x", "b", "c") else torch.float32)
        out[n] = t.requires_grad_(requires_grad)
    return out


def within(got: torch.Tensor, want, name: str, tol: float) -> float:
    """max over slices of max |got - want| / the slice's max |want|."""
    want = want.float() if torch.is_tensor(want) else torch.from_numpy(np.array(want))
    dims = SLICE_DIMS[name]
    d = (got.float() - want).abs().amax(dims)
    return float((d / want.abs().amax(dims).clamp_min(1e-30)).max())


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_backward_matches_autograd_and_jax_grad(case, jax_refs):
    *_, chunk, _, _, dt = CASES[case]
    tol = TOL[dt]
    a = case_arrays(case)
    t = torch_inputs(case, requires_grad=True)
    names = [n for n in NAMES if t[n] is not None]
    y, st = ssd_scan_plain(t["x"], t["log_a"], t["b"], t["c"], t["init"], chunk)
    gy = torch.from_numpy(a["gy"])
    gs = None if a["gs"] is None else torch.from_numpy(a["gs"])
    loss = (y.float() * gy).sum() + (0 if gs is None else (st * gs).sum())
    auto = dict(zip(names, torch.autograd.grad(loss, [t[n] for n in names])))
    plain = {n: None if v is None else v.detach() for n, v in t.items()}
    _, _, states = ssd_scan_fwd_plain(plain["x"], plain["log_a"], plain["b"], plain["c"],
                                      plain["init"], chunk)
    got = ssd_scan_bwd_plain(plain["x"], plain["log_a"], plain["b"], plain["c"], states,
                             gy.to(y.dtype), gs, chunk, need_init=t["init"] is not None)
    got = dict(zip(NAMES, got))
    for n in names:
        assert got[n].dtype == (torch.float32 if n in ("log_a", "init") else t[n].dtype), n
        assert got[n].shape == t[n].shape, n
        assert within(got[n], auto[n], n, tol) <= tol, (case, n, "autograd")
        assert within(got[n], jax_refs[case][n], n, tol) <= tol, (case, n, "jax.grad")
    assert got["init"] is None or t["init"] is not None


# (inputs that require grad, a None init, which cotangents the loss gives)
FN_CASES = [
    (("x", "log_a", "b", "c", "init"), False, "both"),
    (("x",), True, "y"),
    (("b", "c"), False, "state"),
    (("log_a", "init"), False, "both"),
    (("x", "b"), True, "state"),
]


@pytest.mark.parametrize("need,no_init,cot", FN_CASES)
def test_autograd_function_over_the_plain_pair_equals_autograd(need, no_init, cot):
    case = "G2, ragged L"
    chunk = CASES[case][6]
    a = case_arrays(case)
    base = torch_inputs(case)
    base["init"] = None if no_init else torch.from_numpy(
        np.random.default_rng(9).normal(0, 1, CASES[case][0:1] + (4, 8, 16)).astype(np.float32))
    gy, gs = torch.from_numpy(a["gy"]), torch.from_numpy(
        np.random.default_rng(8).normal(0, 1, (2, 4, 8, 16)).astype(np.float32))
    grads = []
    for use_fn in (False, True):
        t = {n: None if v is None else v.clone().requires_grad_(n in need)
             for n, v in base.items()}
        args = (t["x"], t["log_a"], t["b"], t["c"], t["init"])
        if use_fn:
            y, st = SsdScanFn.apply(ssd_scan_fwd_plain, ssd_scan_bwd_plain, chunk, *args)
        else:
            y, st = ops.ssd_scan(*args, chunk=chunk)
        loss = ((y.float() * gy).sum() if cot in ("y", "both") else 0) + (
            (st * gs).sum() if cot in ("state", "both") else 0)
        wrt = [t[n] for n in need if t[n] is not None]
        got = torch.autograd.grad(loss, wrt, allow_unused=True)
        # an input the loss does not reach: None through autograd, zeros
        # through the Function (c, with the final state's cotangent alone)
        grads.append([torch.zeros_like(w) if g is None else g for g, w in zip(got, wrt)])
    for n, g_auto, g_fn in zip([n for n in need if base[n] is not None], *grads):
        assert g_fn.dtype == g_auto.dtype and g_fn.shape == g_auto.shape, n
        tol = F32_TOL * max(float(g_auto.abs().max()), 1e-30)
        assert float((g_fn - g_auto).abs().max()) <= tol, (need, n)


def test_meta_scan_keeps_autograd_and_the_step_counts_its_backward():
    """On meta tensors under grad ``ops.ssd_scan``'s outputs have a
    grad_fn and the gradients come back as shapes; count_step of a
    mamba2-2.7b-smoke train step (remat: forward, recompute, backward)
    lists ``ssd_scan_bwd`` once per layer with ``ssd_scan_bwd_work``'s
    figures."""
    x = torch.empty(2, 32, 4, 8, dtype=torch.bfloat16, device="meta", requires_grad=True)
    la = torch.empty(2, 32, 4, device="meta", requires_grad=True)
    b = torch.empty(2, 32, 1, 16, dtype=torch.bfloat16, device="meta", requires_grad=True)
    y, st = ops.ssd_scan(x, la, b, b, None, 16)
    assert y.grad_fn is not None and st.grad_fn is not None
    gx, gla, gb = torch.autograd.grad(y.float().sum() + st.sum(), (x, la, b))
    assert (gx.shape, gx.dtype, gla.dtype, gb.shape, gb.dtype) == (
        x.shape, torch.bfloat16, torch.float32, b.shape, torch.bfloat16)
    cfg = get_config("mamba2-2.7b-smoke")
    p = trainable(meta_lm_params(cfg))
    tok = torch.empty((2, 32), dtype=torch.int32, device="meta")
    batch = Batch(tokens=tok, targets=tok, loss_mask=torch.empty((2, 32), device="meta"))

    def step():
        return tree_grads(loss_fn(cfg, p, batch, q_chunk=16, remat=True)[0], p)

    d = rl.count_step(step)
    s = cfg.ssm
    flops, n_bytes = ssd_scan_bwd_work(32, s.n_heads(cfg.d_model), s.head_dim, s.n_groups,
                                       s.d_state, s.chunk, 2)
    n_mamba = sum(kind == "mamba" for kind in cfg.block_pattern) * cfg.repeats
    assert n_mamba == cfg.n_layers == 2
    assert d["kernels"]["ssd_scan_bwd"] == {"calls": n_mamba, "flops": n_mamba * flops,
                                            "bytes": n_mamba * n_bytes}
    assert d["kernels"]["ssd_scan"]["calls"] == 2 * n_mamba     # forward and recompute


# (B, L, H, P, G, N, chunk, init, final-state cotangent): N 16, 64 and 256,
# G 1 and 4, ragged and whole chunks, with and without init and the
# final state's cotangent
STAGE_CASES = {
    "N16 G1 ragged, init and cotangent": (2, 37, 4, 8, 1, 16, 16, True, True),
    "N64 G4 ragged, neither": (1, 50, 8, 16, 4, 64, 16, False, False),
    "N16 G4, cotangent only": (2, 32, 4, 8, 4, 16, 8, False, True),
    "N64 G1 ragged, init only": (1, 45, 4, 16, 1, 64, 32, True, False),
    "N256 G2 ragged": (1, 30, 4, 8, 2, 256, 16, True, True),
}


@pytest.mark.parametrize("case", sorted(STAGE_CASES))
def test_staged_backward_equals_the_reference_backward(case):
    B, L, H, P, G, N, chunk, init, dfin = STAGE_CASES[case]
    rng = np.random.default_rng(sorted(STAGE_CASES).index(case) + 40)

    def normal(scale, *shape):
        return torch.from_numpy(rng.normal(0, scale, shape).astype(np.float32))

    x, b, c = normal(1, B, L, H, P), normal(0.5, B, L, G, N), normal(0.5, B, L, G, N)
    la = -torch.from_numpy(rng.uniform(1e-3, 1.0, (B, L, H)).astype(np.float32))
    init_state = normal(1, B, H, P, N) if init else None
    dy = normal(1, B, L, H, P)
    d_final = normal(1, B, H, P, N) if dfin else None
    states = ssd_scan_fwd_plain(x, la, b, c, init_state, chunk)[2]
    want = ssd_scan_bwd_plain(x, la, b, c, states, dy, d_final, chunk)
    got = ssd_scan_bwd_staged(x, la, b, c, states, dy, d_final, chunk)
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == w.dtype == torch.float32 and g.shape == w.shape, name
        assert within(g, w, name, 1e-6) <= 1e-6, (case, name)


def test_backward_launch_geometry_fits_an_h100():
    """Shared memory of every launch within one block's 232,448 bytes at
    chunk 256 for each N; at mamba2-2.7b's training shape (B 2, L 2048,
    H 80, P 64, N 128) head pairs (640 chunk-local blocks), one P slab,
    dS scratch the size of the chunk states, and dB / dC partials within
    a quarter of the first version's (2, B, L, H, P / 32, N) f32."""
    for N in STATE_WIDTHS:
        launches, _ = bwd_launch_geometry(2, 2048, 80, 64, 1, N, 256)
        assert all(threads == 256 and smem <= SMEM_LIMIT
                   for _, threads, smem in launches.values()), N
    launches, scratch = bwd_launch_geometry(2, 2048, 80, 64, 1, 128, 256)
    assert launches["local"][0] == (8, 40, 2) and launches["chunk"][0] == (8, 80, 2)
    assert scratch["states"] == 2 * 80 * 8 * 64 * 128 * 4 and scratch["lpart"] == 0
    assert scratch["partials"] + scratch["lpart"] <= 671_088_640 // 4
    # an odd head count per group takes one head a block; P past one slab
    # takes slabs and dlog_a partials
    launches, scratch = bwd_launch_geometry(1, 200, 6, 96, 2, 64, 64)
    assert launches["local"][0] == (4 * 2, 6, 1)
    assert scratch["lpart"] == 4 * 200 * 6 * 2
    # N 256: (a) and (c) on two column slabs of 128, dX's f32 partials
    # per slab and dlog_a's per P and column slab
    launches, scratch = bwd_launch_geometry(2, 2048, 80, 64, 1, 256, 256)
    assert launches["local"][0] == (8 * 2, 40, 2) and launches["chunk"][0] == (8 * 2, 80, 2)
    assert scratch["states"] == 2 * 80 * 8 * 64 * 256 * 4
    assert scratch["dx"] == 4 * 2 * 2048 * 80 * 2 * 64
    assert scratch["lpart"] == 4 * 2 * 2048 * 80 * 2

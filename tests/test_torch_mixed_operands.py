"""Every (q, K/V) dtype pair the attention kernels take besides q in K/V's
type, through the port's ``ops`` on the CPU against the JAX package's
oracles (``repro.kernels.ref``) on the same numpy-seeded inputs.

The pairs (``MIXED_PAIRS``): an f16 query over bf16 K/V, a bf16 or f32
query over f16 K/V (all seven attention ops), and a bf16 or f16 query
over f32 K/V (``flash_packed`` and ``flash_prefill``, whose oracles round
nothing); at head dims 20 (off the 8-column grid), 90, 320 (the D-512
build) and 520 (the DEEP build).  Each call's verdict is ``ok`` (the card
would take it), its output is in q's dtype, and it agrees with the oracle
within ``test_torch_kernels.py``'s limit (f32 1e-5, bf16 3e-2, f16 4e-3)
of the coarser of the products' type (K/V's) and the output's (q's): the
oracle rounds q x scale to K's type and P to V's in the refresh and
packed ops, and every op rounds its output to q's type, so a bf16 output
differs by one bf16 step wherever the two f32 sums fall on either side of
a rounding boundary.  A bf16 query with elements past f16's 65504 over
f16 K/V (what the kernel's f16 halves of a scaled query row must hold)
runs through both prefill ops.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.flash_packed import build_pack_map  # noqa: E402
from repro_torch.kernels.flash_refresh import build_block_map  # noqa: E402
from torch_threads import torch_one_thread  # noqa: E402,F401

BF16, F16, F32 = "bfloat16", "float16", "float32"
TOL = {F32: 1e-5, BF16: 3e-2, F16: 4e-3}     # test_torch_kernels.py's
# (q dtype, K/V dtype) pairs the kernels take besides q in K/V's type
CACHE_PAIRS = ((F16, BF16), (BF16, F16), (F32, F16))
F32_KV_PAIRS = ((BF16, F32), (F16, F32))
CACHE_OPS = ("flash_refresh", "flash_refresh_paged", "flash_refresh_paged_int8",
             "flash_prefill_paged", "flash_prefill_paged_int8")
F32_KV_OPS = ("flash_packed", "flash_prefill")   # also take f32 K/V
MIXED_PAIRS = [(op, q, kv) for op in CACHE_OPS + F32_KV_OPS for q, kv in CACHE_PAIRS] + [
    (op, q, kv) for op in F32_KV_OPS for q, kv in F32_KV_PAIRS]
HEAD_DIMS = (20, 90, 320, 520)
H, HKV = 4, 2


def _both(a: np.ndarray, dtype: str):
    """The same values for both frameworks: rounded once to ``dtype``
    (through torch) and handed to JAX as exactly representable f32."""
    tt = torch.from_numpy(a.astype(np.float32)).to(getattr(torch, dtype))
    return jnp.asarray(tt.float().numpy()).astype(getattr(jnp, dtype)), tt


def _inputs(d: int, q_dt: str, kv_dt: str, past_f16: bool = False, seed: int = 3):
    """numpy inputs at head dim d (H 4 over Hkv 2), each drawn in f32 and
    rounded once to its own dtype: queries at a scatter of 72 positions
    over 3 pages of 128 keys per stream (and 100 dense prefill rows at
    offset 150), per-stream caches of 384 keys, a shuffled slab of 7 pages
    (2 int8 cold pages with per-(page, head) scales), and two packed rows
    of three segments and one.  ``past_f16``: every query row's column 0
    at 7e4 to 1.3e5 in magnitude (past f16's 65504), K's and V's column 0
    1e4 times smaller, so that the scores stay O(1)."""
    rng = np.random.default_rng(seed + d)

    def normal(*shape, big=None):
        x = rng.normal(size=shape)
        if past_f16 and big is not None:
            if big:
                x[..., 0] = rng.choice([-1.0, 1.0], size=shape[:-1]) * rng.uniform(
                    7e4, 1.3e5, shape[:-1])
            else:
                x[..., 0] *= 1e-4
        return x
    q_pos = np.concatenate([np.arange(10, 40), np.arange(300, 342)]).astype(np.int32)
    return dict(
        q=_both(normal(2, len(q_pos), H, d, big=True), q_dt),
        qf=_both(normal(2, 100, H, d, big=True), q_dt),
        caches=[_both(normal(2, 384, HKV, d, big=False), kv_dt) for _ in range(2)],
        slab=[_both(normal(7 * 128, HKV, d, big=False), kv_dt) for _ in range(2)],
        cold=(rng.integers(-127, 128, size=(256, HKV, d)).astype(np.int8),
              rng.integers(-127, 128, size=(256, HKV, d)).astype(np.int8),
              rng.uniform(0.01, 0.03, size=(2, HKV)).astype(np.float32),
              rng.uniform(0.01, 0.03, size=(2, HKV)).astype(np.float32)),
        pt=rng.permutation(7)[:6].reshape(2, 3).astype(np.int32),
        pt8=np.asarray([[7, 1, 4], [2, 8, 0]], np.int32),
        pos=q_pos, qp=np.broadcast_to(q_pos[None], (2, len(q_pos))).copy(),
        kvv=rng.random((2, 384)) > 0.3,
        seg=np.asarray([[0] * 60 + [1] * 100 + [2] * 40 + [-1] * 56, [3] * 256], np.int32),
        pq=_both(rng.normal(size=(2, 256, H, d)), q_dt),
        pkv=[_both(rng.normal(size=(2, 256, HKV, d)), kv_dt) for _ in range(2)])


def _run(op: str, x: dict):
    """(the JAX oracle's output, the port's ``ops`` call's output) of
    ``op`` on inputs ``x``."""
    t = torch.from_numpy
    (qj, qt), (qfj, qft) = x["q"], x["qf"]
    (kj, kt), (vj, vt) = x["caches"]
    (skj, skt), (svj, svt) = x["slab"]
    int8 = op.endswith("int8")
    pt = x["pt8"] if int8 else x["pt"]
    cold_j = tuple(jnp.asarray(a) for a in x["cold"]) if int8 else None
    cold_t = tuple(t(a) for a in x["cold"]) if int8 else None
    qp, kvv = x["qp"], x["kvv"]
    if op == "flash_refresh":
        o_j = jref.flash_refresh_ref(qj, kj, vj, jnp.asarray(qp), jnp.asarray(kvv))
        o_t = ops.flash_refresh(qt, kt, vt, t(qp), t(kvv), q_chunk=64,
                                block_map=build_block_map(x["pos"], 384))
    elif op.startswith("flash_refresh_paged"):
        o_j = jref.flash_refresh_paged_ref(qj, skj, svj, jnp.asarray(qp), jnp.asarray(kvv),
                                           jnp.asarray(pt), cold=cold_j)
        o_t = ops.flash_refresh_paged(qt, skt, svt, t(qp), t(kvv), t(pt), q_chunk=64,
                                      cold=cold_t, block_map=build_block_map(x["pos"], 384))
    elif op == "flash_prefill":
        o_j = jref.flash_prefill_ref(qfj, kj, vj, window=200, q_offset=150)
        o_t = ops.flash_prefill(qft, kt, vt, window=200, q_offset=150)
    elif op.startswith("flash_prefill_paged"):
        o_j = jref.flash_prefill_paged_ref(qfj, skj, svj, jnp.asarray(pt), q_offset=150,
                                           cold=cold_j)
        o_t = ops.flash_prefill_paged(qft, skt, svt, t(pt), q_offset=150, cold=cold_t)
    else:
        (pqj, pqt), ((pkj, pkt), (pvj, pvt)) = x["pq"], x["pkv"]
        o_j = jref.flash_packed_ref(pqj, pkj, pvj, jnp.asarray(x["seg"]))
        o_t = ops.flash_packed(pqt, pkt, pvt, t(x["seg"]), build_pack_map(x["seg"]))
    return np.asarray(o_j, np.float32), o_t


@pytest.fixture(scope="module")
def oracle():
    """Each case's inputs and JAX oracle output, computed once per module:
    (op, q dtype, K/V dtype, d) -> (inputs, oracle output)."""
    cache = {}

    def get(op, q_dt, kv_dt, d):
        key = (op, q_dt, kv_dt, d)
        if key not in cache:
            x = _inputs(d, q_dt, kv_dt)
            cache[key] = (x, _run(op, x)[0])
        return cache[key]
    return get


def _check(op, q_dt, kv_dt, x, o_j, tol):
    ops.reset_card_verdicts()
    _, o_t = _run(op, x)
    assert ops.card_verdicts() == {op: {"ok": 1}}
    assert o_t.dtype == getattr(torch, q_dt)
    assert tuple(o_t.shape) == o_j.shape
    assert np.isfinite(o_j).all()
    np.testing.assert_allclose(o_t.float().numpy(), o_j, atol=tol)


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("op, q_dt, kv_dt", MIXED_PAIRS)
def test_mixed_pair_matches_jax(oracle, op, q_dt, kv_dt, d):
    x, o_j = oracle(op, q_dt, kv_dt, d)
    _check(op, q_dt, kv_dt, x, o_j, max(TOL[q_dt], TOL[kv_dt]))


@pytest.mark.parametrize("op", ["flash_prefill", "flash_prefill_paged"])
def test_prefill_takes_a_bf16_query_past_f16_range_over_f16_kv(op):
    """A bf16 query whose column 0 lies past 65504 (f16's largest) in every
    row over f16 K/V: the prefill oracle keeps the query exact in f32, and
    so must the kernel (its f16 halves of each row scaled by a power of
    two)."""
    x = _inputs(90, BF16, F16, past_f16=True, seed=11)
    q = x["qf"][1]
    assert (q.float()[..., 0].abs() > 65504).all()
    o_j, _ = _run(op, x)
    _check(op, BF16, F16, x, o_j, TOL[BF16])

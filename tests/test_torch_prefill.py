"""The port's prefill attention (``flash_prefill``, ``flash_prefill_paged``
and its int8 cold group) against the JAX package's.

The port's ops on CPU tensors (their plain versions) against the JAX
package's Pallas kernels in interpret mode, where those take the
geometry (Sq and Sk multiples of their tiles), and against its oracles
``flash_prefill_ref`` / ``flash_prefill_paged_ref`` everywhere,
including a ragged Sq and Sk, which the port's kernel masks and the JAX
package sends to its oracle.  Rows with no visible key (a negative
``q_offset``, a window past Sk) give the mean of V in all three.

Tolerances, relative to the reference's largest magnitude (the output
scale): f32 operands 1e-5 of it (sums in another order); bf16 operands
one bf16 step (2^-7) of it.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_prefill import (  # noqa: E402
    flash_prefill_pallas, flash_prefill_paged_pallas,
)
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.flash_prefill import (  # noqa: E402
    flash_prefill_paged_plain, flash_prefill_plain,
)
from torch_threads import torch_one_thread  # noqa: E402,F401


def f32(a) -> np.ndarray:
    return a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)


def close(a, b, rel):
    a, b = f32(a), f32(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    err = float(np.abs(a - b).max())
    scale = float(np.abs(b).max())
    assert err <= rel * scale, (err / scale if scale else err, rel)


def operands(shapes, dtype, seed):
    """numpy arrays for both frameworks (bf16 rounded once, through torch)."""
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=s).astype(np.float32) for s in shapes]
    if dtype == "bfloat16":
        arrs = [torch.from_numpy(a).bfloat16().float().numpy() for a in arrs]
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    return ([torch.from_numpy(a).to(td) for a in arrs],
            [jnp.asarray(a).astype(jd) for a in arrs])


# (Sq, Sk, H, Hkv, D, causal, window, q_offset): causal from 0, a later
# chunk against a longer cache, a sliding window, bidirectional, rows with
# no visible key (negative offset; a window past Sk), ragged Sq and Sk
DENSE = {
    "causal": (128, 128, 4, 2, 32, True, None, 0),
    "chunk-offset": (64, 256, 4, 1, 32, True, None, 192),
    "window": (256, 256, 4, 2, 32, True, 48, 0),
    "bidirectional": (128, 256, 2, 2, 64, False, None, 0),
    "dead-prefix": (128, 128, 4, 2, 32, True, None, -10),
    "window-past-sk": (128, 128, 2, 1, 32, False, 16, 100),
    "ragged": (100, 200, 4, 2, 32, True, 40, 60),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(DENSE))
def test_flash_prefill_matches_jax(case, dtype):
    Sq, Sk, H, Hkv, D, causal, window, off = DENSE[case]
    (q, k, v), (qj, kj, vj) = operands(
        [(2, Sq, H, D), (2, Sk, Hkv, D), (2, Sk, Hkv, D)], dtype,
        seed=sorted(DENSE).index(case))
    tol = 2.0 ** -7 if dtype == "bfloat16" else 1e-5
    out = ops.flash_prefill(q, k, v, causal=causal, window=window, q_offset=off)
    assert out.dtype == q.dtype
    close(out, jref.flash_prefill_ref(qj, kj, vj, causal=causal, window=window,
                                      q_offset=off), tol)
    if Sq % min(128, Sq) == 0 and Sk % min(128, Sk) == 0:
        close(out, flash_prefill_pallas(qj, kj, vj, causal=causal, window=window,
                                        q_offset=off, interpret=True), tol)
    # chunking over queries shifts q_offset with the chunk
    close(flash_prefill_plain(q, k, v, causal=causal, window=window, q_offset=off,
                              q_chunk=48), out, 1e-6)


def test_rows_without_keys_are_the_mean_of_v():
    (q, k, v), _ = operands([(1, 16, 2, 32), (1, 64, 2, 32), (1, 64, 2, 32)],
                            "float32", seed=3)
    out = ops.flash_prefill(q, k, v, causal=True, q_offset=-4)
    torch.testing.assert_close(out[:, :4], v.mean(1, keepdim=True).expand(1, 4, 2, 32))
    out = ops.flash_prefill(q, k, v, causal=False, window=8, q_offset=80)
    torch.testing.assert_close(out, v.mean(1, keepdim=True).expand(1, 16, 2, 32))


@pytest.mark.parametrize("S,H,Hkv", [(96, 4, 2), (130, 10, 2)])
def test_sdpa_is_causal_equals_the_masked_yardstick(S, H, Hkv):
    """``chip_smoke.py`` times SDPA's ``is_causal`` call beside the masked
    one where they compute the same function (q_offset 0, Sq == Sk, no
    window): both equal the prefill oracles (f32, 1e-5 of the output
    scale: sums in another order)."""
    import torch.nn.functional as F
    from repro_torch.kernels.ref import flash_prefill_ref
    (q, k, v), (qj, kj, vj) = operands([(2, S, H, 32), (2, S, Hkv, 32), (2, S, Hkv, 32)],
                                       "float32", seed=S)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    mask = torch.ones(S, S, dtype=torch.bool).tril()
    masked = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, enable_gqa=True)
    causal = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)
    close(causal.transpose(1, 2), masked.transpose(1, 2), 1e-5)
    close(causal.transpose(1, 2), flash_prefill_ref(q, k, v), 1e-5)
    close(causal.transpose(1, 2), jref.flash_prefill_ref(qj, kj, vj), 1e-5)


def _quant_group(rng, n_cold, hkv, d):
    k8, v8 = (rng.integers(-127, 128, size=(n_cold * 128, hkv, d)).astype(np.int8)
              for _ in range(2))
    ks, vs = (rng.uniform(0.01, 0.03, size=(n_cold, hkv)).astype(np.float32)
              for _ in range(2))
    return (k8, v8, ks, vs)


# (Sq, n_pages, H, Hkv, D, window, q_offset, cold pages): fresh prefill
# from slot 0, a chunk at an offset, a window, a ragged Sq, int8 cold
# pages among the hot ones
PAGED = {
    "fresh": (256, 2, 4, 2, 32, None, 0, False),
    "offset": (128, 3, 4, 1, 64, None, 256, False),
    "window": (256, 2, 4, 2, 32, 40, 0, False),
    "ragged": (70, 2, 4, 2, 32, None, 150, False),
    "int8": (256, 3, 4, 2, 32, None, 0, True),
    "int8-window-offset": (128, 3, 2, 2, 32, 100, 200, True),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(PAGED))
def test_flash_prefill_paged_matches_jax(case, dtype):
    Sq, n_pages, H, Hkv, D, window, off, quant = PAGED[case]
    rng = np.random.default_rng(7)
    n_hot = 2 * n_pages
    (q, k, v), (qj, kj, vj) = operands(
        [(2, Sq, H, D), (n_hot * 128, Hkv, D), (n_hot * 128, Hkv, D)], dtype, seed=8)
    pt = rng.permutation(n_hot)[: 2 * n_pages].reshape(2, n_pages).astype(np.int32)
    cold = cold_j = None
    if quant:
        grp = _quant_group(rng, 2, Hkv, D)
        cold = tuple(torch.from_numpy(a) for a in grp)
        cold_j = tuple(jnp.asarray(a) for a in grp)
        pt[0, 0], pt[1, 1] = n_hot, n_hot + 1          # two cold entries
    tol = 2.0 ** -7 if dtype == "bfloat16" else 1e-5
    out = ops.flash_prefill_paged(q, k, v, torch.from_numpy(pt), window=window,
                                  q_offset=off, cold=cold)
    close(out, jref.flash_prefill_paged_ref(qj, kj, vj, jnp.asarray(pt), window=window,
                                            q_offset=off, cold=cold_j), tol)
    if Sq % min(128, Sq) == 0:
        close(out, flash_prefill_paged_pallas(qj, kj, vj, jnp.asarray(pt), window=window,
                                              q_offset=off, interpret=True, cold=cold_j), tol)
    close(flash_prefill_paged_plain(q, k, v, torch.from_numpy(pt), window=window,
                                    q_offset=off, cold=cold, q_chunk=32), out, 1e-6)


def test_dispatch_counts_name_the_int8_body():
    ops.reset_dispatch_counts()
    rng = np.random.default_rng(9)
    (q, k, v), _ = operands([(1, 128, 2, 32), (256, 2, 32), (256, 2, 32)], "float32", 9)
    cold = tuple(torch.from_numpy(a) for a in _quant_group(rng, 1, 2, 32))
    ops.flash_prefill_paged(q, k, v, torch.tensor([[2]], dtype=torch.int32), cold=cold)
    ops.flash_prefill_paged(q, k, v, torch.tensor([[1]], dtype=torch.int32))
    counts = ops.dispatch_counts()
    assert counts["flash_prefill_paged_int8"] == {"backend:ok": 1}
    assert counts["flash_prefill_paged"] == {"backend:ok": 1}


def _paged(q=(1, 4, 4, 16), slab=(128, 2, 16), pt=None, **kw):
    pt = torch.zeros(1, 1, dtype=torch.int32) if pt is None else pt
    return lambda: ops.flash_prefill_paged(torch.zeros(q), torch.zeros(slab),
                                           torch.zeros(slab), pt, **kw)


BAD_CALLS = {
    "prefill-rank": lambda: ops.flash_prefill(torch.zeros(4, 4, 16), torch.zeros(1, 8, 2, 16),
                                              torch.zeros(1, 8, 2, 16)),
    "prefill-kv-shape": lambda: ops.flash_prefill(torch.zeros(1, 4, 4, 16),
                                                  torch.zeros(1, 8, 2, 16),
                                                  torch.zeros(1, 9, 2, 16)),
    "prefill-batch": lambda: ops.flash_prefill(torch.zeros(2, 4, 4, 16),
                                               torch.zeros(1, 8, 2, 16),
                                               torch.zeros(1, 8, 2, 16)),
    "prefill-gqa": lambda: ops.flash_prefill(torch.zeros(1, 4, 3, 16), torch.zeros(1, 8, 2, 16),
                                             torch.zeros(1, 8, 2, 16)),
    "prefill-dtype": lambda: ops.flash_prefill(torch.zeros(1, 4, 4, 16),
                                               torch.zeros(1, 8, 2, 16, dtype=torch.float64),
                                               torch.zeros(1, 8, 2, 16, dtype=torch.float64)),
    "prefill-window": lambda: ops.flash_prefill(torch.zeros(1, 4, 4, 16),
                                                torch.zeros(1, 8, 2, 16),
                                                torch.zeros(1, 8, 2, 16), window=0),
    "paged-rank": _paged(slab=(1, 128, 2, 16)),
    "paged-pt-batch": _paged(pt=torch.zeros(2, 1, dtype=torch.int32)),
    "paged-head-dim": _paged(q=(1, 4, 4, 32)),
    "paged-pt-dtype": _paged(pt=torch.zeros(1, 1)),
    "paged-slab-align": _paged(slab=(100, 2, 16)),
    "paged-causal": _paged(causal=False),
    "paged-window": _paged(window=0),
    "paged-page-range": _paged(pt=torch.ones(1, 1, dtype=torch.int32)),
    "paged-cold-dtype": _paged(cold=(torch.zeros(128, 2, 16), torch.zeros(128, 2, 16),
                                     torch.ones(1, 2), torch.ones(1, 2))),
    "paged-cold-scale": _paged(cold=(torch.zeros(128, 2, 16, dtype=torch.int8),
                                     torch.zeros(128, 2, 16, dtype=torch.int8),
                                     torch.ones(2, 2), torch.ones(2, 2))),
}
CODES = {"prefill-rank": "rank", "prefill-kv-shape": "kv-shape", "prefill-batch": "batch",
         "prefill-gqa": "gqa", "prefill-dtype": "dtype", "prefill-window": "window",
         "paged-rank": "rank", "paged-pt-batch": "pt-batch", "paged-head-dim": "head-dim",
         "paged-pt-dtype": "pt-dtype", "paged-slab-align": "slab-align",
         "paged-causal": "causal", "paged-window": "window", "paged-page-range": "page-range",
         "paged-cold-dtype": "cold-dtype", "paged-cold-scale": "scale-shape"}
# an eligibility rule, as in the JAX package's registry: the card raises
# KernelIneligibleError, the CPU runs the plain version and records it
REFUSED_ON_CARD = {"paged-cold-dtype": "flash_prefill_paged_int8"}


@pytest.mark.parametrize("case", sorted(BAD_CALLS))
def test_prefill_preconditions_raise(case):
    if case in REFUSED_ON_CARD:
        ops.reset_card_verdicts()
        BAD_CALLS[case]()
        assert ops.card_verdicts() == {REFUSED_ON_CARD[case]: {CODES[case]: 1}}
        return
    with pytest.raises(ops.KernelContractError, match=f"'{CODES[case]}'"):
        BAD_CALLS[case]()

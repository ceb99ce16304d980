"""The paper's baselines without online refresh, against the JAX package.

``fullcomp`` (every frame fully encoded, every window prefilled from
scratch), ``prune_only`` (pruned ViT, no reuse) and ``refresh_only``
(full ViT, reuse with the static refresh set), each asked for with the
paged slab and with per-stream caches (modes without reuse keep
per-stream caches either way, as in the JAX package), served through
both lockstep schedulers by ``torch_mode_parity``.  Equal: the event
order, token accounting, refresh sets and the FLOP ledger (a dense ViT
ledger where nothing is pruned); yes/no logits within 2e-2.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.serving import flops  # noqa: E402
from torch_mode_parity import (  # noqa: E402
    assert_no_refusals, assert_parity, assert_plain_dispatch, serve,
)
from torch_threads import torch_one_thread  # noqa: E402,F401

CONFIGS = {
    f"{mode}-{'paged' if paged else 'stream'}": (mode, paged)
    for mode in ("fullcomp", "prune_only", "refresh_only") for paged in (True, False)
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_mode_serves_like_jax(name):
    j, t = serve(*CONFIGS[name])
    assert_parity(j, t)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_mode_dispatches_its_kernels_plainly_on_cpu(name):
    assert_plain_dispatch(serve(*CONFIGS[name])[1])


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_mode_windows_report_no_kernel_fallbacks(name):
    """bf16 serving: the card takes every kernel call of every window."""
    assert_no_refusals(serve(*CONFIGS[name])[1][1])


@pytest.mark.parametrize("mode", ["fullcomp", "refresh_only"])
def test_unpruned_modes_encode_every_frame_densely(mode):
    """Every frame a window encodes goes through the dense ViT: the whole
    window when it is served fresh (always, without reuse), the new
    stride when the overlap is reused."""
    _, t = serve(mode, True)
    pipe = t[5]
    v, lay = pipe.v, pipe.layout
    assert lay.k_tokens == lay.g_tokens
    for res in t[1].values():
        for r in res:
            fresh = r.window == 0 or not pipe.reuse
            n_frames = lay.window if fresh else lay.stride
            assert r.stats.vit_patches == r.stats.vit_slots == n_frames * v.n_patches
            assert r.stats.flops_vit == flops.vit_flops(v, n_frames * v.n_patches)


@pytest.mark.parametrize("mode", ["fullcomp", "prune_only"])
def test_modes_without_reuse_prefill_every_window(mode):
    _, t = serve(mode, False)
    lay = t[5].layout
    assert t[2] == []                   # no refresh set is ever chosen
    for res in t[1].values():
        for r in res:
            assert r.stats.tokens_refreshed == lay.total_len
            assert r.stats.flops_prefill == flops.prefill_flops(
                t[5].cfg, lay.total_len, lay.total_len)

"""The port's SSD scan and Mamba-2 layers against the JAX package's.

* ``ops.ssd_scan`` on CPU tensors (its plain version) against the JAX
  package's ``ssd_scan_pallas`` in interpret mode and its ``ops.ssd_scan``
  (the chunked oracles), on the same numpy inputs; the port's oracles
  against the JAX package's.
* ``mamba_block`` and ``mamba_decode`` against the JAX layers at
  ``mamba2-2.7b-smoke`` width, with the JAX package's weights.
* Each precondition of ``ops.ssd_scan`` raises its ``KernelContractError``.

Tolerances, each relative to the reference's largest magnitude (its
scale): with f32 operands 2e-5 of the output scale (the chunked sums
run in another order); with bf16 operands the outputs are bf16, held to
one bf16 step (2^-7) of the output scale, the state to 2e-5 of its scale
(f32 sums of the same bf16 values).  Layers: 3e-2 of the output scale
(bf16 matmuls round at other points in the two frameworks); the updated
conv tail (bf16 in_proj outputs) to one bf16 step and the SSD state
within 1e-3 of its scale (it sums bf16 operands that rounded at those
points).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_config as j_get_config  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.ssd_scan import ssd_scan_pallas  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.registry import all_configs  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.ssd_scan import (  # noqa: E402
    SMEM_LIMIT, STATE_WIDTHS, launch_geometry, scan_chunk, ssd_scan_work,
)
from repro_torch.models import layers  # noqa: E402
from repro_torch.models.init import from_numpy_tree  # noqa: E402
from torch_threads import torch_one_thread  # noqa: E402,F401

ARCH = "mamba2-2.7b-smoke"


def f32(a) -> np.ndarray:
    return a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)


def close(a, b, rel):
    a, b = f32(a), f32(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    scale = float(np.abs(b).max())
    err = float(np.abs(a - b).max())
    assert err <= rel * scale, (err / scale if scale else err, rel)


def ssd_inputs(B, L, H, P, G, N, dtype, seed=0, with_init=True):
    """numpy inputs for both frameworks; bf16 operands rounded once
    through torch so both see the same values."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, L, H, P)).astype(np.float32)
    la = (-np.abs(rng.normal(size=(B, L, H))) * 0.3).astype(np.float32)
    b = (rng.normal(size=(B, L, G, N)) * 0.5).astype(np.float32)
    c = (rng.normal(size=(B, L, G, N)) * 0.5).astype(np.float32)
    init = (rng.normal(size=(B, H, P, N)) * 0.1).astype(np.float32) if with_init else None
    if dtype == "bfloat16":
        x, b, c = (torch.from_numpy(a).bfloat16().float().numpy() for a in (x, b, c))
    return x, la, b, c, init


def to_jax(x, la, b, c, init, dtype):
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    return (jnp.asarray(x).astype(jd), jnp.asarray(la), jnp.asarray(b).astype(jd),
            jnp.asarray(c).astype(jd), None if init is None else jnp.asarray(init))


def to_torch(x, la, b, c, init, dtype):
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    return (torch.from_numpy(x).to(td), torch.from_numpy(la), torch.from_numpy(b).to(td),
            torch.from_numpy(c).to(td), None if init is None else torch.from_numpy(init))


# (L, chunk, G, init): L % chunk != 0 (padded chunk), L < chunk, several
# whole chunks, groups G > 1, with and without an initial state
SCAN_CASES = {
    "ragged-g1-init": (40, 16, 1, True),
    "short-g1": (8, 16, 1, False),
    "whole-g2-init": (64, 16, 2, True),
    "ragged-g2": (40, 16, 2, False),
    "short-g4-init": (12, 16, 4, True),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(SCAN_CASES))
def test_ssd_scan_matches_jax(case, dtype):
    L, chunk, G, with_init = SCAN_CASES[case]
    B, H, P, N = 2, 4, 8, 16
    arrs = ssd_inputs(B, L, H, P, G, N, dtype, with_init=with_init)
    y_t, s_t = ops.ssd_scan(*to_torch(*arrs, dtype), chunk=chunk)
    jin = to_jax(*arrs, dtype)
    y_o, s_o = jops.ssd_scan(*jin, chunk=chunk)
    with jops.kernel_mode("interpret"):
        y_p, s_p = jops.ssd_scan(*jin, chunk=chunk)
    assert y_t.dtype == (torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    assert s_t.dtype == torch.float32
    y_tol = 2.0 ** -7 if dtype == "bfloat16" else 2e-5
    for y_j, s_j in ((y_o, s_o), (y_p, s_p)):
        close(y_t, y_j, y_tol)
        close(s_t, s_j, 2e-5)


@pytest.mark.parametrize("G", [1, 2])
def test_ssd_oracles_match_jax(G):
    """The port's exact recurrence, per-head and grouped chunked scans
    against the JAX package's, and against each other."""
    B, L, H, P, N, chunk = 2, 32, 4, 8, 16, 8
    x, la, b, c, init = ssd_inputs(B, L, H, P, G, N, "float32", seed=1)
    bh, ch = np.repeat(b, H // G, 2), np.repeat(c, H // G, 2)
    t = torch.from_numpy
    y_e, s_e = ref.ssd_scan_ref(t(x), t(la), t(bh), t(ch), t(init))
    y_je, s_je = jref.ssd_scan_ref(x, la, bh, ch, init)
    close(y_e, y_je, 2e-5)
    close(s_e, s_je, 2e-5)
    y_c, s_c = ref.ssd_chunked_scan_ref(t(x), t(la), t(bh), t(ch), chunk, t(init))
    close(y_c, jref.ssd_chunked_scan_ref(x, la, bh, ch, chunk, init)[0], 2e-5)
    y_g, s_g = ref.ssd_chunked_scan_grouped_ref(t(x), t(la), t(b), t(c), chunk, t(init))
    y_jg, s_jg = jref.ssd_chunked_scan_grouped_ref(x, la, b, c, chunk, init)
    close(y_g, y_jg, 2e-5)
    close(s_g, s_jg, 2e-5)
    for y, s in ((y_c, s_c), (y_g, s_g)):
        close(y, y_e, 2e-5)
        close(s, s_e, 2e-5)


def test_ssd_pallas_interpret_matches_plain_on_padded_geometry():
    """``ssd_scan_pallas`` itself (interpret mode) on the geometry the
    port's plain version pads to: L = 40 at chunk 16 runs three chunks of
    16, the last with 8 identity steps."""
    B, H, P, G, N = 1, 2, 8, 1, 16
    x, la, b, c, init = ssd_inputs(B, 40, H, P, G, N, "float32", seed=2)
    pad = ((0, 0), (0, 8), (0, 0), (0, 0))
    y_p, s_p = ssd_scan_pallas(jnp.pad(x, pad), jnp.pad(la, pad[:3]), jnp.pad(b, pad),
                               jnp.pad(c, pad), jnp.asarray(init), chunk=16, n_groups=G,
                               interpret=True)
    y_t, s_t = ops.ssd_scan(*to_torch(x, la, b, c, init, "float32"), chunk=16)
    close(y_t, np.asarray(y_p)[:, :40], 2e-5)
    close(s_t, s_p, 2e-5)


def test_ssd_decode_steps_equal_the_scan():
    """Stepping ``ssd_decode_ref`` through the sequence gives the scan's
    outputs and final state; and it equals the JAX package's step."""
    B, L, H, P, N = 2, 12, 4, 8, 16
    x, la, b, c, init = ssd_inputs(B, L, H, P, H, N, "float32", seed=3)
    t = torch.from_numpy
    y_s, s_s = ref.ssd_chunked_scan_ref(t(x), t(la), t(b), t(c), 4, t(init))
    state = t(init)
    for i in range(L):
        y, state = ref.ssd_decode_ref(state, t(x[:, i]), t(la[:, i]), t(b[:, i]), t(c[:, i]))
        close(y, y_s[:, i], 2e-5)
    close(state, s_s, 2e-5)
    y_j, s_j = jref.ssd_decode_ref(init, x[:, 0], la[:, 0], b[:, 0], c[:, 0])
    y_t, s_t = ref.ssd_decode_ref(t(init), t(x[:, 0]), t(la[:, 0]), t(b[:, 0]), t(c[:, 0]))
    close(y_t, y_j, 1e-6)
    close(s_t, s_j, 1e-6)


def test_scan_chunk_and_work():
    assert scan_chunk(160, 256) == 160 and scan_chunk(4096, 256) == 256
    assert scan_chunk(1000, 256) == 256 and scan_chunk(40, 16) == 16
    flops, n_bytes = ssd_scan_work(160, 80, 64, 1, 128, 256, B=2)
    assert flops == 2 * 80 * (160 * 161 * (128 + 64) + 4.0 * 160 * 64 * 128)
    assert n_bytes == 2 * 160 * (80 * 64 * 4 + 80 * 4 + 2 * 128 * 2) + 2 * 2 * 80 * 64 * 128 * 4


SSM_ARCHS = sorted(n for n, c in all_configs().items() if c.ssm is not None)


@pytest.mark.parametrize("arch", SSM_ARCHS + [f"{n}-smoke" for n in SSM_ARCHS])
def test_ssd_launch_geometry_fits_every_ssm_config(arch):
    """The kernel's shared memory stays within the 227 KB a block may use
    on an H100 at every chunk q 1..256 of each SSM configuration's head
    width P and state width N, and the kernel is built for that N."""
    cfg = get_config(arch)
    s = cfg.ssm
    P, N, H = s.head_dim, s.d_state, s.n_heads(cfg.d_model)
    assert N in STATE_WIDTHS and P % 8 == 0
    worst = max(launch_geometry(2, H, P, N, q)[2] for q in range(1, 257))
    assert worst <= SMEM_LIMIT, (arch, worst)
    grid, threads, smem = launch_geometry(2, H, P, N, s.chunk)
    assert grid == (-(-P // 32), H, 2) and threads == 256 and smem <= worst


def test_ssd_launch_geometry_at_mamba2_serving_shapes():
    """mamba2-2.7b (P 64, N 128, H 80, 2 streams): 320 blocks of two P
    slices; 106 KB at chunk 256, so two blocks fit one SM's 228 KB."""
    assert launch_geometry(2, 80, 64, 128, 256) == ((2, 80, 2), 256, 108_576)
    assert launch_geometry(2, 80, 64, 128, 8)[2] == 36_192
    assert 2 * (launch_geometry(2, 80, 64, 128, 256)[2] + 1024) <= 228 * 1024


# ----------------------------------------------------------------------
# Mamba-2 layers at smoke width
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def mamba():
    """JAX config and layer-0 mixer weights, and the port's twins."""
    jcfg = j_get_config(ARCH)
    jp, _ = jtfm.init_params(jcfg, jax.random.PRNGKey(0))
    mixer = jax.tree_util.tree_map(lambda a: a[0], jp["blocks"][0]["mixer"])
    tp = from_numpy_tree(jax.tree_util.tree_map(np.asarray, mixer))
    return jcfg, mixer, get_config(ARCH), tp


def _cache(jcfg, B, rng):
    s = jcfg.ssm
    di = s.d_inner(jcfg.d_model)
    conv = rng.normal(size=(B, s.d_conv - 1, di + 2 * s.n_groups * s.d_state)).astype(np.float32)
    conv = torch.from_numpy(conv).bfloat16()
    ssm = (rng.normal(size=(B, s.n_heads(jcfg.d_model), s.head_dim, s.d_state)) * 0.1
           ).astype(np.float32)
    return (jlayers.SSMCache(jnp.asarray(conv.float().numpy()).astype(jnp.bfloat16),
                             jnp.asarray(ssm)),
            layers.SSMCache(conv.clone(), torch.from_numpy(ssm.copy())))


@pytest.mark.parametrize("T", [40, 8])
def test_mamba_block_matches_jax(mamba, T):
    """A chunk continuing from a carried conv tail and state."""
    jcfg, jp, tcfg, tp = mamba
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(size=(2, T, jcfg.d_model)).astype(np.float32)).bfloat16()
    jc, tc = _cache(jcfg, 2, rng)
    out_j, nc_j = jlayers.mamba_block(jp, jcfg, jnp.asarray(x.float().numpy()).astype(
        jnp.bfloat16), jc, return_cache=True)
    out_t, nc_t = layers.mamba_block(tp, tcfg, x, tc)
    assert nc_t is tc                                   # updated in place
    close(out_t, out_j, 3e-2)
    close(nc_t.conv, nc_j.conv, 2.0 ** -7)
    close(nc_t.ssm, nc_j.ssm, 1e-3)


def test_mamba_decode_matches_jax(mamba):
    jcfg, jp, tcfg, tp = mamba
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(2, 1, jcfg.d_model)).astype(np.float32)).bfloat16()
    jc, tc = _cache(jcfg, 2, rng)
    out_j, nc_j = jlayers.mamba_decode(jp, jcfg, jnp.asarray(x.float().numpy()).astype(
        jnp.bfloat16), jc)
    out_t, nc_t = layers.mamba_decode(tp, tcfg, x, tc)
    close(out_t, out_j, 3e-2)
    close(nc_t.conv, nc_j.conv, 2.0 ** -7)
    close(nc_t.ssm, nc_j.ssm, 1e-3)


# ----------------------------------------------------------------------
# preconditions
# ----------------------------------------------------------------------
def _scan_args(B=1, L=8, H=4, P=8, G=2, N=16):
    return (torch.zeros(B, L, H, P), torch.zeros(B, L, H), torch.zeros(B, L, G, N),
            torch.zeros(B, L, G, N))


BAD_SCANS = {
    "rank": lambda: ops.ssd_scan(torch.zeros(1, 8, 32), *_scan_args()[1:]),
    "bc-shape": lambda: ops.ssd_scan(*_scan_args()[:3], torch.zeros(1, 8, 2, 8)),
    "log-a-shape": lambda: ops.ssd_scan(_scan_args()[0], torch.zeros(1, 8, 5),
                                        *_scan_args()[2:]),
    "batch-len": lambda: ops.ssd_scan(*_scan_args()[:2], torch.zeros(1, 7, 2, 16),
                                      torch.zeros(1, 7, 2, 16)),
    "gqa": lambda: ops.ssd_scan(*_scan_args()[:2], torch.zeros(1, 8, 3, 16),
                                torch.zeros(1, 8, 3, 16)),
    "dtype": lambda: ops.ssd_scan(_scan_args()[0].int(), *_scan_args()[1:]),
    "chunk": lambda: ops.ssd_scan(*_scan_args(), chunk=0),
}


@pytest.mark.parametrize("code", sorted(BAD_SCANS))
def test_ssd_scan_preconditions_raise(code):
    with pytest.raises(ops.KernelContractError, match=f"'{code}'"):
        BAD_SCANS[code]()

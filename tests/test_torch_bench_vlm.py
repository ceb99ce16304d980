"""The JAX benchmarks' own VLM (``benchmarks/common.py``: LM d 96 with 4
heads over 2 kv heads, ViT d 96 with 4 heads, so head dim 24 in both) in
the port, against the JAX package on the CPU.

* Served in codecflow (paged bf16 slab) and fullcomp through the
  lockstep schedulers of both packages, on the port's random weights
  (seed 0 for the LM, 1 for the ViT) handed to the JAX package as
  arrays of the same values, and the same 2 x 24-frame videos: events,
  stats and refresh sets equal, yes/no logits within
  ``torch_mode_parity.LOGIT_TOL`` (answers equal where the JAX margin
  exceeds twice that).
* The plain versions of every attention kernel and of ``rope_shift`` at
  D 24 against ``src/repro/kernels/ref.py`` on the same numpy inputs:
  bf16 outputs within 3e-2 (one bf16 rounding step of O(1) values, as
  ``test_torch_kernels.py``), f32 ``rope_shift`` within 1e-5.  The CUDA
  kernels at D 24 against these plain versions: ``test_torch_gpu.py``.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import CodecCfg as JCodecCfg  # noqa: E402
from repro.configs.base import ModelCfg as JModelCfg  # noqa: E402
from repro.configs.base import ViTCfg as JViTCfg  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.serving import EngineCfg as JEngineCfg  # noqa: E402
from repro.serving import Scheduler as JScheduler  # noqa: E402
from repro.serving import SchedulerCfg as JSchedulerCfg  # noqa: E402
from repro.serving import ServingPipeline as JServingPipeline  # noqa: E402
from repro.serving import StreamRequest as JStreamRequest  # noqa: E402
from repro_torch.configs.base import CodecCfg, ModelCfg, ViTCfg  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.flash_packed import flash_packed_plain  # noqa: E402
from repro_torch.kernels.flash_prefill import (  # noqa: E402
    flash_prefill_paged_plain, flash_prefill_plain,
)
from repro_torch.kernels.flash_refresh import (  # noqa: E402
    flash_refresh_paged_plain, flash_refresh_plain,
)
from repro_torch.kernels.rope_shift import rope_shift_plain  # noqa: E402
from repro_torch.models.init import init_lm_params, init_vit_params, map_tree  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    EngineCfg, Scheduler, SchedulerCfg, ServingPipeline, StreamRequest,
)
from torch_mode_parity import _drive, assert_parity, assert_plain_dispatch  # noqa: E402
from torch_threads import torch_one_thread  # noqa: E402,F401

# benchmarks/common.py's model, as test_torch_anomaly.py copies it
CODEC = dict(gop=4, block=16, search_radius=4, window_frames=16, stride_frames=4,
             keep_ratio=0.5, mv_threshold=0.25)
LM = dict(name="bench-vlm", family="vlm", n_layers=4, d_model=96, n_heads=4, n_kv=2,
          d_ff=192, vocab=64, tied_embeddings=True)
VIT = dict(n_layers=2, d_model=96, n_heads=4, d_ff=192, patch=14, image=112, group=2)
D = 24
BF16_TOL = 3e-2


def to_jax(tree):
    """A port tree as JAX arrays of the same values and dtypes."""
    return map_tree(lambda t: jnp.asarray(t.float().numpy()).astype(
        jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32), tree)


@functools.lru_cache(maxsize=None)
def _weights():
    tp = init_lm_params(ModelCfg(**LM), 0, "cpu")
    tvp = init_vit_params(ViTCfg(**VIT), LM["d_model"], 1, "cpu")
    return to_jax(tp), to_jax(tvp), tp, tvp


def test_bench_vlm_has_head_dim_24():
    assert ModelCfg(**LM).d_head == D
    v = ViTCfg(**VIT)
    assert v.d_model // v.n_heads == D


@pytest.mark.parametrize("mode", ["codecflow", "fullcomp"])
def test_bench_vlm_serves_like_jax(mode):
    jp, jvp, tp, tvp = _weights()
    jpipe = JServingPipeline(JModelCfg(**LM), JViTCfg(**VIT), jp, jvp,
                             JEngineCfg(mode=mode, codec=JCodecCfg(**CODEC)))
    j = _drive(jpipe, JScheduler(jpipe, JSchedulerCfg(max_concurrent=2, pipelined=False)),
               JStreamRequest)
    pipe = ServingPipeline(ModelCfg(**LM), ViTCfg(**VIT), tp, tvp,
                           EngineCfg(mode=mode, codec=CodecCfg(**CODEC)), device="cpu")
    ops.reset_dispatch_counts()
    t = _drive(pipe, Scheduler(pipe, SchedulerCfg(max_concurrent=2, pipelined=False)),
               StreamRequest)
    t = t + (ops.dispatch_counts(), pipe, None)
    assert_parity(j, t)
    assert_plain_dispatch(t)


def _bf16(rng, *shape):
    """The same bf16 values for both packages: rounded once through torch."""
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).bfloat16()
    return jnp.asarray(x.float().numpy()).astype(jnp.bfloat16), x


def _quant(rng, n_hot, n_cold, hkv):
    hk, hv = _bf16(rng, n_hot * 128, hkv, D), _bf16(rng, n_hot * 128, hkv, D)
    k8, v8 = (rng.integers(-127, 128, size=(n_cold * 128, hkv, D)).astype(np.int8)
              for _ in range(2))
    ks, vs = (rng.uniform(0.005, 0.02, size=(n_cold, hkv)).astype(np.float32)
              for _ in range(2))
    return hk, hv, (k8, v8, ks, vs)


def _t(a):
    return torch.from_numpy(np.array(a))


def _jit(fn, *args):
    """``fn(*args)`` compiled as one program (JAX's eager dispatch
    compiles op by op, several times slower at these sizes)."""
    return jax.jit(fn)(*args)


def _case(name, rng):
    """(JAX oracle output, the port's plain output) at D 24 with the LM's
    heads (4 over 2) or the ViT's (4 over 4)."""
    q_pos = np.concatenate([np.arange(0, 24), np.arange(160, 256)]).astype(np.int32)
    qp = np.broadcast_to(q_pos[None], (2, len(q_pos))).copy()
    kvv = rng.random((2, 256)) > 0.3
    if name == "flash_refresh":
        (qj, qt), (kj, kt), (vj, vt) = (_bf16(rng, 2, len(q_pos), 4, D),
                                        _bf16(rng, 2, 256, 2, D), _bf16(rng, 2, 256, 2, D))
        return (_jit(jref.flash_refresh_ref, qj, kj, vj, jnp.asarray(qp), jnp.asarray(kvv)),
                flash_refresh_plain(qt, kt, vt, _t(qp), _t(kvv), q_chunk=64))
    if name in ("flash_refresh_paged", "flash_refresh_paged_int8"):
        (kj, kt), (vj, vt), cold = _quant(rng, 5, 3, 2)
        int8 = name.endswith("int8")
        pt = np.asarray([[5, 1], [3, 7]] if int8 else [[4, 1], [3, 0]], np.int32)
        qj, qt = _bf16(rng, 2, len(q_pos), 4, D)
        cj = tuple(jnp.asarray(a) for a in cold) if int8 else None
        ct = tuple(_t(a) for a in cold) if int8 else None
        return (_jit(lambda *a: jref.flash_refresh_paged_ref(*a[:6], cold=a[6]), qj, kj, vj,
                     jnp.asarray(qp), jnp.asarray(kvv), jnp.asarray(pt), cj),
                flash_refresh_paged_plain(qt, kt, vt, _t(qp), _t(kvv), _t(pt), cold=ct,
                                          q_chunk=64))
    if name == "flash_packed":
        seg = np.full((2, 256), -1, np.int32)
        seg[0, :60], seg[0, 60:160], seg[1, :200] = 0, 1, 2
        (qj, qt), (kj, kt), (vj, vt) = (_bf16(rng, 2, 256, 4, D) for _ in range(3))
        return (_jit(jref.flash_packed_ref, qj, kj, vj, jnp.asarray(seg)),
                flash_packed_plain(qt, kt, vt, _t(seg), q_chunk=128))
    if name == "flash_prefill":
        (qj, qt), (kj, kt), (vj, vt) = (_bf16(rng, 2, 200, 4, D), _bf16(rng, 2, 300, 2, D),
                                        _bf16(rng, 2, 300, 2, D))
        kw = dict(causal=True, window=150, q_offset=50)
        return (_jit(lambda *a: jref.flash_prefill_ref(*a, **kw), qj, kj, vj),
                flash_prefill_plain(qt, kt, vt, q_chunk=64, **kw))
    if name in ("flash_prefill_paged", "flash_prefill_paged_int8"):
        (kj, kt), (vj, vt), cold = _quant(rng, 5, 3, 2)
        int8 = name.endswith("int8")
        pt = np.asarray([[5, 1, 6], [3, 7, 0]] if int8 else [[4, 1, 2], [3, 0, 2]], np.int32)
        cj = tuple(jnp.asarray(a) for a in cold) if int8 else None
        ct = tuple(_t(a) for a in cold) if int8 else None
        qj, qt = _bf16(rng, 2, 384, 4, D)
        return (_jit(lambda *a: jref.flash_prefill_paged_ref(*a[:4], cold=a[4]), qj, kj, vj,
                     jnp.asarray(pt), cj),
                flash_prefill_paged_plain(qt, kt, vt, _t(pt), cold=ct, q_chunk=128))
    dtype = name.rsplit("_", 1)[1]
    delta = rng.integers(-700, 700, (2, 133)).astype(np.int32)
    if dtype == "bf16":
        kj, kt = _bf16(rng, 2, 133, 2, D)
    else:
        k = rng.normal(size=(2, 133, 2, D)).astype(np.float32)
        kj, kt = jnp.asarray(k), _t(k)
    # eager: under jit XLA evaluates the f32 angles (up to ~700 rad)
    # otherwise, about 1e-4 away
    return jref.rope_shift_ref(kj, jnp.asarray(delta)), rope_shift_plain(kt, _t(delta))


KERNEL_CASES = ("flash_refresh", "flash_refresh_paged", "flash_refresh_paged_int8",
                "flash_packed", "flash_prefill", "flash_prefill_paged",
                "flash_prefill_paged_int8", "rope_shift_bf16", "rope_shift_f32")


@pytest.mark.parametrize("name", KERNEL_CASES)
def test_plain_versions_at_head_dim_24_match_the_jax_oracles(name):
    want, got = _case(name, np.random.default_rng(KERNEL_CASES.index(name)))
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert tuple(got.shape) == want.shape and got.shape[-1] == D
    tol = 1e-5 if name == "rope_shift_f32" else BF16_TOL
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol)

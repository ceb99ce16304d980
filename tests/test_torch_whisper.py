"""The encoder-decoder family (whisper-large-v3 at its ``-smoke`` size) in
the port, against the JAX package on the CPU.

Same weights (``init_params`` carried across by ``from_numpy_tree``) and
seed-made inputs through both.  Limits and the readings they rest on:

* the parameter tree: the same keys, shapes and dtypes as the JAX
  package's ``init_params`` (whisper adds ``encoder``, ``enc_norm``,
  ``enc_embed`` and each block's ``lnx``/``xattn``);
* ``run_encoder`` output and the cross K/V within 2^-6 of their largest
  value (read 1.02e-2: the JAX package's own eager and jitted encoders
  differ by the same 1.02e-2);
* prefill and 2 decode steps over per-stream caches and the cross K/V
  (the JAX steps jitted, as serving runs them): every logit of both
  streams within 2e-2 (read 1.03e-2 .. 1.23e-2).  The archs parity's
  7e-3 holds a few yes/no logits; over all 1024 logits the JAX package
  itself moves by 9.2e-3 .. 1.08e-2 between XLA's default flags and
  ``--xla_allow_excess_precision=false`` (every bf16 op rounded, as
  PyTorch does), and the rounding points where the port departs are
  named by tests/torch_train_gap.py: (1) ``jax.nn.silu`` on bf16, which
  XLA's CPU backend computes as exp(-x), 1 + that, its reciprocal and
  the product, each rounded (the port's ``F.silu`` rounds once; with
  that expansion the port's MLP matches op for op); (2) XLA's excess
  precision under jit, which keeps bf16 chains in f32 inside fusions;
  with both matched the port reads 7.1e-3 .. 9.2e-3, and op by op on
  the reference's own inputs every op of the decoder differs in under
  0.05% of its outputs by at most a quarter bf16 step, but (3) the
  first cross-attention, one bf16 step in 0.84% of its outputs
  (its softmax's f32 exp and sums differ in their last bits between
  XLA and PyTorch, and the bf16 rounding of p and of the output flips
  a step near a boundary), and (4) the head, rounded to bf16 by the
  reference with every op rounded (half a step, 1.9e-3).  The limit is
  1.5x the largest reading, the archs parity's rule;
* ``forward_train`` logits within test_torch_train.py's 2e-2 over every
  logit (read 1.37e-2, the same as the JAX package's own spread
  between the two flag settings, 1.37e-2), CE and aux within 1e-3
  relative;
* one train step (with remat) within ``torch_train_parity.STEP_LIMITS``;
* the uncached ``attention_block`` (causal or not, a sliding window, a
  ``valid`` mask) and ``cross_attention_block`` within one bf16 step
  (2^-7) of the largest output (read 8.6e-4 .. 2.25e-3, and 0); the cross
  K/V products within one bf16 step (one element of 16384 differs, by
  one step).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import layers as jlayers  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import transformer as ttfm  # noqa: E402
from repro_torch.models.init import from_numpy_tree, init_lm_params, leaf_paths  # noqa: E402
from repro_torch.training import train_step as tts  # noqa: E402
from torch_train_parity import (  # noqa: E402
    assert_step_within, batch_arrays, f32, jax_batch, jax_step, port_batch, port_step,
    setup, step_gaps,
)
from torch_threads import torch_one_thread  # noqa: E402,F401

ARCH = "whisper-large-v3-smoke"
DECODE_TOL = 2e-2
TRAIN_LOGIT_TOL = 2e-2
ROW = 2.0 ** -6


def _rel(a, b) -> float:
    a, b = f32(a), f32(b)
    return float(np.abs(a - b).max() / np.abs(a).max())


def test_whisper_tree_matches_jax():
    jcfg, tcfg, jp, _ = setup(ARCH)
    jkeys = {"/".join(str(k) for k in path): (tuple(leaf.shape), str(leaf.dtype))
             for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]}
    tp = init_lm_params(tcfg, 0, "cpu")
    tkeys = {k: (tuple(t.shape), str(t.dtype).replace("torch.", ""))
             for k, t in leaf_paths(tp)}
    assert tkeys == jkeys
    assert {"encoder", "enc_norm", "enc_embed"} <= set(tp)
    assert {"lnx", "xattn"} <= set(tp["blocks"][0])


def _encoder_pair(jcfg, tcfg, jp, tp, feats):
    je = jax.jit(lambda p, f: jtfm.run_encoder(jcfg, p, f, q_chunk=16))(jp, jnp.asarray(feats))
    jkv = jax.jit(lambda p, e: jtfm.build_cross_kv(jcfg, p, e))(jp, je)
    with torch.no_grad():
        te = ttfm.run_encoder(tcfg, tp, torch.from_numpy(feats), q_chunk=16)
        tkv = ttfm.build_cross_kv(tcfg, tp, te)
    return je, jkv, te, tkv


def test_whisper_encoder_prefill_and_decode_match_jax():
    jcfg, tcfg, jp, tp = setup(ARCH)
    B, S = 2, 16
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, jcfg.vocab, (B, S)).astype(np.int32)
    feats = rng.normal(0, 1, (B, jcfg.enc_seq, jcfg.d_model)).astype(np.float32)
    je, jkv, te, tkv = _encoder_pair(jcfg, tcfg, jp, tp, feats)
    assert _rel(je, te) <= ROW
    assert tkv[0].shape == (jcfg.repeats, B, jcfg.enc_seq, jcfg.n_kv, jcfg.d_head)
    assert _rel(jkv[0], tkv[0]) <= ROW and _rel(jkv[1], tkv[1]) <= ROW

    jc = jtfm.init_caches(jcfg, B, S + 4)
    jc = jtfm.Caches(jc.blocks, jkv)
    jl, jc, _ = jax.jit(lambda p, t, c: jtfm.prefill(jcfg, p, t, c))(jp, jnp.asarray(tokens), jc)
    tc = ttfm.init_caches(tcfg, B, S + 4)
    tc = ttfm.Caches(tc.blocks, tkv)
    with torch.no_grad():
        tl, tc, _ = ttfm.prefill(tcfg, tp, torch.from_numpy(tokens).long(), tc)
    gaps = [float(np.abs(f32(jl) - f32(tl)).max())]
    step = jax.jit(lambda p, t, c, n: jtfm.decode_step(jcfg, p, t, c, n))
    for i in range(2):
        tok = jnp.argmax(jl, -1)[:, None].astype(jnp.int32)       # the reference's tokens
        jl, jc = step(jp, tok, jc, S + i)
        with torch.no_grad():
            tl, tc = ttfm.decode_step(tcfg, tp, torch.from_numpy(np.array(tok)).long(), tc,
                                      S + i)
        assert bool(torch.isfinite(tl).all())
        gaps.append(float(np.abs(f32(jl) - f32(tl)).max()))
    assert max(gaps) <= DECODE_TOL, gaps


def test_whisper_forward_train_matches_jax():
    jcfg, tcfg, jp, tp = setup(ARCH)
    a = batch_arrays(jcfg, 2, 32)
    b, pb = jax_batch(a), port_batch(a)
    jl, ja = jax.jit(lambda p: jtfm.forward_train(jcfg, p, b.tokens, enc_feats=b.enc_feats,
                                                  remat=False, q_chunk=16))(jp)
    with torch.no_grad():
        tl, ta = ttfm.forward_train(tcfg, tp, pb.tokens, enc_feats=pb.enc_feats, remat=False,
                                    q_chunk=16)
    assert float(np.abs(f32(jl) - f32(tl)).max()) <= TRAIN_LOGIT_TOL
    from repro.training.train_step import cross_entropy
    jce = float(cross_entropy(jl, b.targets, b.loss_mask))
    tce = float(tts.cross_entropy(tl, pb.targets, pb.loss_mask))
    assert abs(tce - jce) <= 1e-3 * abs(jce)
    assert float(ja) == float(ta) == 0.0


def test_whisper_train_step_matches_jax():
    jcfg, tcfg, jp, tp = setup(ARCH)
    a = batch_arrays(jcfg, 2, 32)
    assert_step_within(step_gaps(jax_step(jcfg, jp, a, remat=True),
                                 port_step(tcfg, tp, a, remat=True)))


@pytest.mark.parametrize("causal,window,masked", [
    (True, None, False), (False, None, False), (True, 8, False), (True, None, True)])
def test_uncached_attention_block_matches_jax(causal, window, masked):
    jcfg0, tcfg0, jp, tp = setup(ARCH)
    jcfg = dataclasses.replace(jcfg0, sliding_window=window)
    tcfg = dataclasses.replace(tcfg0, sliding_window=window)
    B, T = 2, 24
    rng = np.random.default_rng(2)
    x = rng.normal(0, 1, (B, T, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(T), (B, T)).astype(np.int32)
    valid = rng.random((B, T)) < 0.7 if masked else None
    lp = jax.tree_util.tree_map(lambda t: t[0], jp["blocks"][0]["mixer"])
    jo, jcache = jlayers.attention_block(
        lp, jcfg, jnp.asarray(x, jnp.bfloat16), jnp.asarray(pos),
        None if valid is None else jnp.asarray(valid), causal=causal, q_chunk=16)
    tlp = from_numpy_tree(jax.tree_util.tree_map(np.asarray, lp))
    to, tcache = tlayers.attention_block(
        tlp, tcfg, torch.from_numpy(x).bfloat16(), torch.from_numpy(pos.copy()),
        None if valid is None else torch.from_numpy(valid), causal=causal, q_chunk=16)
    assert jcache is None and tcache is None
    assert _rel(jo, to) <= 2.0 ** -7


def test_cross_attention_block_matches_jax():
    jcfg, tcfg, jp, tp = setup(ARCH)
    B, T, Se = 2, 5, jcfg.enc_seq
    rng = np.random.default_rng(3)
    x = rng.normal(0, 1, (B, T, jcfg.d_model)).astype(np.float32)
    enc = rng.normal(0, 1, (B, Se, jcfg.d_model)).astype(np.float32)
    lp = jax.tree_util.tree_map(lambda t: t[0], jp["blocks"][0]["xattn"])
    tlp = from_numpy_tree(jax.tree_util.tree_map(np.asarray, lp))
    jkv = jlayers.cross_attention_kv(lp, jcfg, jnp.asarray(enc, jnp.bfloat16))
    tkv = tlayers.cross_attention_kv(tlp, tcfg, torch.from_numpy(enc).bfloat16())
    for a, b in zip(jkv, tkv):
        a, b = f32(a), f32(b)
        assert (np.abs(a - b) <= 2.0 ** -7 * np.abs(a)).all()
    jo = jlayers.cross_attention_block(lp, jcfg, jnp.asarray(x, jnp.bfloat16), jkv)
    to = tlayers.cross_attention_block(tlp, tcfg, torch.from_numpy(x).bfloat16(), tkv)
    assert _rel(jo, to) <= 2.0 ** -7

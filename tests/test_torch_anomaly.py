"""The anomaly task (joint ViT + LM training on the synthetic CCTV
streams) in the port, against the JAX package on the CPU, and serving
with weights fresh from training.

* ``window_examples``: equal windows and labels.
* One anomaly step at ``benchmarks/common.py``'s LM and ViT config (d 96,
  4 heads): NLL and accuracy within 1e-3 (read 1.34e-5 and 0), gradients,
  updated parameters and moments within
  ``torch_train_parity.STEP_LIMITS`` (readings beside them there).
* ``train_tiny_vlm`` saves its weights where ``cache_path`` says, a
  second call loads them bitwise, and the JAX package's
  ``checkpoint.load`` reads the same file bitwise.
* Serving takes trainable trees (leaves that require grad) without
  recording a graph: no output requires grad, and the logits equal a
  detached run's.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs.base import CodecCfg as JCodecCfg  # noqa: E402
from repro.configs.base import ModelCfg as JModelCfg  # noqa: E402
from repro.configs.base import ViTCfg as JViTCfg  # noqa: E402
from repro.data.pipeline import anomaly_dataset as janomaly  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.models import vit as jvit  # noqa: E402
from repro.models.init import ParamBuilder, split_tree  # noqa: E402
from repro.training import anomaly_task as jtask  # noqa: E402
from repro.training import checkpoint as jckpt  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import CodecCfg, ModelCfg, ViTCfg  # noqa: E402
from repro_torch.data.pipeline import anomaly_dataset  # noqa: E402
from repro_torch.models import transformer as ttfm  # noqa: E402
from repro_torch.models import vit as tvit  # noqa: E402
from repro_torch.models.init import (  # noqa: E402
    from_numpy_tree, init_lm_params, init_vit_params, trainable, tree_leaves,
)
from repro_torch.serving import Engine, EngineCfg, ServingPipeline  # noqa: E402
from repro_torch.training import anomaly_task as ttask  # noqa: E402
from repro_torch.training import optimizer as topt  # noqa: E402
from repro_torch.training.train_step import tree_grads  # noqa: E402
from torch_train_parity import OCFG, assert_step_within, f32, step_gaps  # noqa: E402
from torch_threads import torch_one_thread  # noqa: E402,F401

CODEC = dict(gop=4, block=16, search_radius=4, window_frames=16, stride_frames=4,
             keep_ratio=0.5, mv_threshold=0.25)
LM = dict(name="bench-vlm", family="vlm", n_layers=4, d_model=96, n_heads=4, n_kv=2,
          d_ff=192, vocab=64, tied_embeddings=True)
VIT = dict(n_layers=2, d_model=96, n_heads=4, d_ff=192, patch=14, image=112, group=2)


def test_window_examples_match_jax():
    videos = anomaly_dataset(3, 28, 112, 112, anomaly_frac=0.6, seed=0)
    jw, jl = jtask.window_examples(janomaly(3, 28, 112, 112, anomaly_frac=0.6, seed=0),
                                   JCodecCfg(**CODEC))
    tw, tl = ttask.window_examples(videos, CodecCfg(**CODEC))
    np.testing.assert_array_equal(tw, jw)
    np.testing.assert_array_equal(tl, jl)
    assert tl.any() and not tl.all()


def test_anomaly_step_matches_jax():
    jlm, jv = JModelCfg(**LM), JViTCfg(**VIT)
    tlm, tv = ModelCfg(**LM), ViTCfg(**VIT)
    key = jax.random.PRNGKey(0)
    jlp, _ = jtfm.init_params(jlm, key)
    jvp, _ = split_tree(jvit.init_vit(ParamBuilder(jax.random.fold_in(key, 1)), jv,
                                      jlm.d_model))
    jboth = {"lm": jlp, "vit": jvp}
    wins, labels = ttask.window_examples(
        anomaly_dataset(2, 24, 112, 112, anomaly_frac=0.6, seed=0), CodecCfg(**CODEC))
    idx = np.array([0, len(wins) - 1])
    fw, lb = wins[idx].astype(np.float32), labels[idx]

    ocfg = dict(lr=OCFG["lr"], warmup=10, total_steps=250, weight_decay=0.01)
    (jnll, jacc), jg = jax.jit(jax.value_and_grad(
        lambda b: jtask.loss_fn(jlm, jv, b["lm"], b["vit"], fw, lb), has_aux=True))(jboth)
    jocfg = jopt.OptCfg(**ocfg)
    jnew, jst, jm = jax.jit(lambda p, g, s: jopt.apply_updates(p, g, s, jocfg))(
        jboth, jg, jopt.init_opt_state(jboth, jocfg))

    tboth = trainable(from_numpy_tree(jax.tree_util.tree_map(np.asarray, jboth)))
    tnll, tacc = ttask.loss_fn(tlm, tv, tboth["lm"], tboth["vit"], torch.from_numpy(fw),
                               torch.from_numpy(lb))
    tg = tree_grads(tnll, tboth)
    tocfg = topt.OptCfg(**ocfg)
    tnew, tst, tm = topt.apply_updates(tboth, tg, topt.init_opt_state(tboth, tocfg), tocfg)
    assert abs(float(tnll.detach()) - float(jnll)) <= 1e-3
    assert abs(float(tacc) - float(jacc)) <= 1e-3
    leaves = jax.tree_util.tree_leaves
    j = dict(loss=float(jnll), grad_norm=float(jm["grad_norm"]),
             grads=[f32(x) for x in leaves(jg)], old=[f32(x) for x in leaves(jboth)],
             params=[f32(x) for x in leaves(jnew)], mu=[f32(x) for x in leaves(jst.mu)],
             nu=[f32(x) for x in leaves(jst.nu)])
    t = dict(loss=float(tnll.detach()), grad_norm=float(tm["grad_norm"]),
             grads=[f32(x) for x in tree_leaves(tg)],
             params=[f32(x) for x in tree_leaves(tnew)],
             mu=[f32(x) for x in tree_leaves(tst.mu)], nu=[f32(x) for x in tree_leaves(tst.nu)])
    assert_step_within(step_gaps(j, t))


def test_train_tiny_vlm_caches_and_reloads(tmp_path, monkeypatch):
    lm, v = ModelCfg(**LM), ViTCfg(**VIT)
    path = os.path.join(tmp_path, "tiny.npz")
    hist = []
    step_loss = ttask.loss_fn
    monkeypatch.setattr(ttask, "loss_fn", lambda *a: hist.append(step_loss(*a)) or hist[-1])
    kw = dict(n_videos=3, n_frames=20, steps=3, batch=2, cache_path=path, device="cpu")
    lm_p, vit_p = ttask.train_tiny_vlm(lm, v, CodecCfg(**CODEC), **kw)
    assert os.path.exists(path) and len(hist) == 3
    assert all(bool(torch.isfinite(n)) for n, _ in hist)
    assert not any(t.requires_grad for t in tree_leaves((lm_p, vit_p)))
    lm2, vit2 = ttask.train_tiny_vlm(lm, v, CodecCfg(**CODEC), **kw)
    assert len(hist) == 3                       # the second call loaded, not trained
    for a, b in zip(tree_leaves((lm_p, vit_p)), tree_leaves((lm2, vit2))):
        assert a.dtype == b.dtype and torch.equal(a, b)
    moved = init_lm_params(lm, 0, "cpu")
    assert any(not torch.equal(a, b) for a, b in zip(tree_leaves(moved), tree_leaves(lm_p)))
    jlm, jv = JModelCfg(**LM), JViTCfg(**VIT)
    key = jax.random.PRNGKey(0)
    jlp, _ = jtfm.init_params(jlm, key)
    jvp, _ = split_tree(jvit.init_vit(ParamBuilder(jax.random.fold_in(key, 1)), jv,
                                      jlm.d_model))
    jboth, step = jckpt.load(path, {"lm": jlp, "vit": jvp})
    assert step == 3
    for a, b in zip(jax.tree_util.tree_leaves(jboth), tree_leaves({"lm": lm_p, "vit": vit_p})):
        np.testing.assert_array_equal(f32(a), f32(b))


def test_serving_trainable_weights_builds_no_graph(monkeypatch):
    cfg = get_config("internvl3-14b-smoke")
    params = init_lm_params(cfg, 0, "cpu")
    vparams = init_vit_params(cfg.vit, cfg.d_model, 1, "cpu")
    frames = anomaly_dataset(1, 20, 112, 112, seed=0)[0][0]
    seen = []
    orig_logits, orig_vit = ttfm.lm_logits, tvit.encode_packed_tokens

    def logits(*a, **k):
        out = orig_logits(*a, **k)
        seen.append(out.requires_grad)
        return out

    def vit(*a, **k):
        out = orig_vit(*a, **k)
        seen.append(out.requires_grad)
        return out

    monkeypatch.setattr(ttfm, "lm_logits", logits)
    monkeypatch.setattr(tvit, "encode_packed_tokens", vit)
    runs = {}
    for name, (lp, vp) in {"trainable": (trainable(params), trainable(vparams)),
                           "detached": (params, vparams)}.items():
        pipe = ServingPipeline(cfg, cfg.vit, lp, vp, EngineCfg(codec=CodecCfg(**CODEC)),
                               device="cpu")
        assert not any(t.requires_grad for t in tree_leaves((pipe.params, pipe.vparams)))
        runs[name] = [s.logits_yes_no for s in Engine.from_pipeline(pipe).run_stream(frames)]
    assert len(seen) > 0 and not any(seen)
    assert runs["trainable"] == runs["detached"] and len(runs["detached"]) == 2

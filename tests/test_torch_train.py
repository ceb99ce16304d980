"""The port's training path against the JAX package, on the CPU.

Same seed-made weights (the JAX package's ``init_params``, carried across
by ``from_numpy_tree``) and batches (numpy) through both:

* ``forward_train`` logits within 2e-2 over every (B, S, V) logit, CE
  and aux within 1e-3 relative.  The archs parity's 7e-3 holds a few
  yes/no logits; over all 65,536 logits here the port reads 7.8e-3
  (mamba2) to 1.37e-2 (whisper, test_torch_whisper.py), and the JAX
  package itself moves by up to 1.56e-2 (internvl3; deepseek 9.8e-3,
  olmoe 1.04e-2, whisper 1.37e-2, mamba2 0) between XLA's default
  flags and ``--xla_allow_excess_precision=false`` (every bf16 op
  rounded, as PyTorch does).  These logits are bf16 in both packages,
  so one step at |logit| in [1, 2) is already 7.8e-3.  The rounding
  points where the port departs (tests/torch_train_gap.py, which
  prints these readings): XLA's excess precision under jit, and
  ``jax.nn.silu`` on bf16, which XLA's CPU backend computes as exp(-x),
  1 + that, its reciprocal and the product, each rounded (``F.silu``
  rounds once); with every op rounded and that silu in the port, the
  port reads 7.8e-3 .. 1.17e-2.  The limit is 1.5x the largest
  reading, the archs parity's rule;
* one train step within ``torch_train_parity.STEP_LIMITS`` (the readings
  stand beside each limit there), and within 1e-5 relative where the
  config is f32 (the same formulas: read 1.4e-7 .. 2.0e-6);
* ``apply_updates`` on identical f32 gradients: parameters within one
  bf16 ulp (read 0, and 1.5e-5 of one on the f32 leaf), moments within
  1e-6 of each leaf's largest (read 1.0e-7 with f32 moments: the
  gradient norm's f32 sum differs by one ulp at the clipped step; 0 with
  bf16 moments);
* the JAX package's own training tests, re-run on the port: chunked CE
  equals full CE in value and gradients, microbatch 2 matches
  microbatch 1, the bigram task's loss falls;
* ``lm_batches`` yields the same arrays; checkpoints cross both ways
  bitwise; the launcher runs; the plain kernel versions differentiate.

olmoe-1b-7b-smoke runs on the JAX package's expert choices
(``torch_moe_routes``; without remat, so that each layer routes once per
step in both packages); every choice the port would have made otherwise
must be a near tie.
"""
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.data import pipeline as jpipe  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.training import checkpoint as jckpt  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402
from repro_torch.configs.base import ModelCfg as TModelCfg  # noqa: E402
from repro_torch.data import pipeline as tpipe  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.flash_packed import build_pack_map  # noqa: E402
from repro_torch.kernels.flash_refresh import build_block_map  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models import transformer as ttfm  # noqa: E402
from repro_torch.models.init import (  # noqa: E402
    detached, from_numpy_tree, init_lm_params, trainable, tree_leaves,
)
from repro_torch.training import checkpoint as tckpt  # noqa: E402
from repro_torch.training import optimizer as topt  # noqa: E402
from repro_torch.training import train_step as tts  # noqa: E402
from torch_moe_routes import assert_near_ties, flips, jax_choices, port_choices  # noqa: E402
from torch_train_parity import (  # noqa: E402
    assert_step_within, batch_arrays, f32, jax_batch, jax_step, port_batch, port_step,
    setup, step_gaps,
)
from torch_threads import torch_one_thread  # noqa: E402,F401

LOGIT_TOL = 2e-2
ARCHS = ("deepseek-7b-smoke", "olmoe-1b-7b-smoke", "internvl3-14b-smoke",
         "mamba2-2.7b-smoke")
DENSE = dict(name="t", family="dense", n_layers=2, d_model=64, n_heads=4, n_kv=2,
             d_ff=128, vocab=128, tied_embeddings=True)


def forward_pair(arch):
    jcfg, tcfg, jp, tp = setup(arch)
    a = batch_arrays(jcfg, 2, 32)
    b = jax_batch(a)
    kw = dict(inputs_embeds=b.inputs_embeds, embed_mask=b.embed_mask,
              enc_feats=b.enc_feats, remat=False, q_chunk=16)
    jlog = []
    fwd = jax.jit(lambda p: jtfm.forward_train(jcfg, p, b.tokens, **kw))
    if jcfg.moe is not None:
        with jax_choices(jlog):
            jl, ja = fwd(jp)
            jl.block_until_ready()
    else:
        jl, ja = fwd(jp)
    pb = port_batch(a)
    tlog = []
    with torch.no_grad(), port_choices(tlog, force=jlog if jlog else None):
        tl, ta = ttfm.forward_train(tcfg, tp, pb.tokens, inputs_embeds=pb.inputs_embeds,
                                    embed_mask=pb.embed_mask, enc_feats=pb.enc_feats,
                                    remat=False, q_chunk=16)
    if jlog:
        assert_near_ties(flips(jlog, tlog))
    jce = float(jax.jit(lambda l: jpipe_ce(l, b))(jl))
    tce = float(tts.cross_entropy(tl, pb.targets, pb.loss_mask))
    return f32(jl), f32(tl), float(ja), float(ta), jce, tce


def jpipe_ce(logits, b):
    from repro.training.train_step import cross_entropy
    return cross_entropy(logits, b.targets, b.loss_mask)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_train_matches_jax(arch):
    jl, tl, ja, ta, jce, tce = forward_pair(arch)
    assert tl.shape == jl.shape
    assert np.abs(tl - jl).max() <= LOGIT_TOL, np.abs(tl - jl).max()
    assert abs(tce - jce) <= 1e-3 * abs(jce), (tce, jce)
    assert abs(ta - ja) <= 1e-3 * max(abs(ja), 1e-30) or ja == ta == 0.0, (ta, ja)
    if "olmoe" in arch:
        assert ta > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax(arch):
    jcfg, tcfg, jp, tp = setup(arch)
    a = batch_arrays(jcfg, 2, 32)
    remat = jcfg.moe is None
    jlog, tlog = [], []
    if jcfg.moe is not None:
        with jax_choices(jlog):
            j = jax_step(jcfg, jp, a, remat=remat)
        with port_choices(tlog, force=jlog):
            t = port_step(tcfg, tp, a, remat=remat)
        assert len(jlog) == tcfg.n_layers
        assert_near_ties(flips(jlog, tlog))
        assert t["aux"] > 0
    else:
        j = jax_step(jcfg, jp, a, remat=remat)
        t = port_step(tcfg, tp, a, remat=remat)
    assert_step_within(step_gaps(j, t))


def test_train_step_in_f32_matches_jax_closely():
    """The same formulas: with f32 weights nothing rounds to bf16, and
    the step agrees to float32 summation order."""
    arch = "deepseek-7b-smoke"
    jcfg0, tcfg0, _, _ = setup(arch)
    jcfg = dataclasses.replace(jcfg0, dtype="float32")
    tcfg = dataclasses.replace(tcfg0, dtype="float32")
    jp, _ = jtfm.init_params(jcfg, jax.random.PRNGKey(0))
    tp = from_numpy_tree(jax.tree_util.tree_map(np.asarray, jp))
    a = batch_arrays(jcfg, 2, 32)
    g = step_gaps(jax_step(jcfg, jp, a, remat=True), port_step(tcfg, tp, a, remat=True))
    assert max(g["loss"], g["grad_norm"], g["grad"], g["mu"], g["nu"]) <= 1e-5, g


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_apply_updates_matches_jax(state_dtype):
    """Three steps on identical f32 gradients (the second clipped, the
    schedule in warm-up and decay) over bf16 and f32 leaves."""
    rng = np.random.default_rng(0)
    shapes = {"w": (3, 16, 8), "b": (8,), "s": (16,)}
    p0 = {k: rng.normal(0, 0.5, s).astype(np.float32) for k, s in shapes.items()}
    jparams = {"w": jnp.asarray(p0["w"], jnp.bfloat16), "b": jnp.asarray(p0["b"], jnp.bfloat16),
               "s": jnp.asarray(p0["s"])}
    tparams = {"w": torch.from_numpy(p0["w"]).bfloat16(),
               "b": torch.from_numpy(p0["b"]).bfloat16(), "s": torch.from_numpy(p0["s"])}
    kw = dict(lr=1e-2, warmup=2, total_steps=5, state_dtype=state_dtype)
    jcfg, tcfg = jopt.OptCfg(**kw), topt.OptCfg(**kw)
    jst, tst = jopt.init_opt_state(jparams, jcfg), topt.init_opt_state(tparams, tcfg)
    step = jax.jit(lambda p, g, s: jopt.apply_updates(p, g, s, jcfg))
    for i, gscale in enumerate((0.1, 50.0, 0.01)):
        g = {k: rng.normal(0, gscale, s).astype(np.float32) for k, s in shapes.items()}
        jparams, jst, jm = step(jparams, {k: jnp.asarray(v) for k, v in g.items()}, jst)
        tparams, tst, tm = topt.apply_updates(
            tparams, {k: torch.from_numpy(v) for k, v in g.items()}, tst, tcfg)
        assert int(tst.step) == int(jst.step) == i + 1
        assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
        assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-6)
        for k in shapes:
            pj, pt = f32(jparams[k]), f32(tparams[k])
            ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(pj), 2.0 ** -126))) - 7)
            assert (np.abs(pt - pj) <= ulp).all(), k
            for mj, mt in ((jst.mu[k], tst.mu[k]), (jst.nu[k], tst.nu[k])):
                mj, mt = f32(mj), f32(mt)
                assert np.abs(mt - mj).max() <= 1e-6 * np.abs(mj).max(), k


def test_apply_updates_in_slices_equals_the_whole_leaf(monkeypatch):
    """A leaf above ``SLICE_ELEMS`` is updated slice by slice along its
    first dimension (bounded f32 temporaries): the parameters and moments
    come out bitwise equal to the whole leaf's update, the grad_norm
    within f32 summation order."""
    rng = np.random.default_rng(3)
    p0 = {"w": rng.normal(0, 0.5, (6, 16, 8)).astype(np.float32),
          "b": rng.normal(0, 0.5, (8,)).astype(np.float32)}
    g = {k: torch.from_numpy(rng.normal(0, 0.1, v.shape).astype(np.float32))
         for k, v in p0.items()}
    cfg = topt.OptCfg(lr=1e-2, warmup=1, total_steps=5)
    out = []
    for limit in (topt.SLICE_ELEMS, 256):
        monkeypatch.setattr(topt, "SLICE_ELEMS", limit)
        params = {k: torch.from_numpy(v).bfloat16() for k, v in p0.items()}
        st = topt.init_opt_state(params, cfg)
        for _ in range(2):
            params, st, m = topt.apply_updates(params, g, st, cfg)
        out.append((params, st, float(m["grad_norm"])))
    (pa, sa, na), (pb, sb, nb) = out
    assert len(list(topt._slices(pb["w"]))) == 3          # two layers a slice
    for k in p0:
        assert torch.equal(pa[k], pb[k]), k
        assert torch.equal(sa.mu[k], sb.mu[k]) and torch.equal(sa.nu[k], sb.nu[k]), k
    assert nb == pytest.approx(na, rel=1e-6)


def test_schedule_matches_jax():
    cfg = dict(lr=1.0, warmup=10, total_steps=100, min_lr_frac=0.1)
    for s in (0, 1, 5, 10, 11, 50, 99, 100, 150):
        assert float(topt.schedule(topt.OptCfg(**cfg), s)) == pytest.approx(
            float(jopt.schedule(jopt.OptCfg(**cfg), jnp.asarray(s))), rel=1e-6, abs=1e-9)


def test_grad_clip():
    params = {"w": torch.zeros(4)}
    st = topt.init_opt_state(params, topt.OptCfg(lr=0.0))
    _, _, m = topt.apply_updates(params, {"w": torch.full((4,), 100.0)}, st,
                                 topt.OptCfg(lr=0.0, clip_norm=1.0))
    assert float(m["grad_norm"]) == pytest.approx(200.0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_chunked_ce_equals_full(dtype):
    g = torch.Generator().manual_seed(0)
    B, S, d, V = 2, 32, 16, 50
    h = torch.randn((B, S, d), generator=g).to(dtype).requires_grad_(True)
    head = torch.randn((d, V), generator=g).to(dtype).requires_grad_(True)
    tgt = torch.randint(0, V, (B, S), generator=g)
    mask = (torch.rand((B, S), generator=g) > 0.3).float()
    full = tts.cross_entropy(torch.matmul(h.float(), head.float()), tgt, mask)
    chunked = tts.chunked_cross_entropy(h, head, tgt, mask, chunk=8)
    assert float(chunked.detach()) == pytest.approx(float(full.detach()), rel=1e-5)
    g_full = torch.autograd.grad(full, (h, head))
    g_chunk = torch.autograd.grad(chunked, (h, head))
    if dtype == torch.float32:
        for a, b in zip(g_full, g_chunk):
            torch.testing.assert_close(b, a, rtol=0, atol=1e-5)
    else:
        # d h: the same f32 product per row, rounded once: bitwise (read
        # so).  d head: each chunk's contribution is rounded to bf16 and
        # the 4 are summed in bf16, 7 roundings of at most 2^-9 of the
        # leaf's largest value against one: within 2^-6 of it (read 6.0e-3)
        assert torch.equal(g_chunk[0], g_full[0])
        a, b = g_full[1].float(), g_chunk[1].float()
        assert float((a - b).abs().max()) <= 2.0 ** -6 * float(a.abs().max())


def test_microbatch_equals_full_batch():
    """The JAX package's bounds (tests/test_training.py): loss within 2e-2
    relative, updated parameters within 0.05."""
    cfg = TModelCfg(**DENSE)
    B, S = 4, 16
    tokens = torch.randint(0, cfg.vocab, (B, S), generator=torch.Generator().manual_seed(2))
    batch = tts.Batch(tokens=tokens, targets=torch.roll(tokens, -1, 1),
                      loss_mask=torch.ones((B, S)))
    ocfg = topt.OptCfg(lr=1e-3, warmup=1, total_steps=10)
    out = []
    for mb in (1, 2):
        p = trainable(init_lm_params(cfg, 2, "cpu"))
        p, _, m = tts.make_train_step(cfg, ocfg, microbatch=mb)(
            p, topt.init_opt_state(p, ocfg), batch)
        out.append((p, float(m["loss"])))
    (p1, l1), (p2, l2) = out
    assert l2 == pytest.approx(l1, rel=2e-2)
    assert max(float((a.float() - b.float()).abs().max())
               for a, b in zip(tree_leaves(p1), tree_leaves(p2))) < 0.05
    assert all(not t.requires_grad for t in tree_leaves(detached(p1)))


def test_loss_decreases_on_bigram_task():
    """The JAX package's recipe (tests/test_training.py): 120 steps at
    lr 3e-3 on ``lm_batches(cfg, 8, 32, seed=0)``."""
    cfg = TModelCfg(**dict(DENSE, name="b", vocab=64))
    ocfg = topt.OptCfg(lr=3e-3, warmup=10, total_steps=120)
    params = trainable(init_lm_params(cfg, 3, "cpu"))
    opt = topt.init_opt_state(params, ocfg)
    step = tts.make_train_step(cfg, ocfg)
    it = tpipe.lm_batches(cfg, 8, 32, seed=0, device="cpu")
    losses = []
    for _ in range(120):
        params, opt, m = step(params, opt, next(it))
        losses.append(float(m["loss"]))
    first, last = np.mean(losses[:10]), np.mean(losses[-10:])
    assert last < first - 0.3, (first, last)


@pytest.mark.parametrize("arch", ["deepseek-7b-smoke", "internvl3-14b-smoke",
                                  "whisper-large-v3-smoke"])
def test_lm_batches_match_jax(arch):
    from repro.configs import get_config as jget
    from repro_torch.configs import get_config as tget
    jc, tc = jget(arch), tget(arch)
    vlm = 8 if jc.family == "vlm" else 0
    jit_ = jpipe.lm_batches(jc, 3, 16, seed=5, vlm_tokens=vlm)
    tit = tpipe.lm_batches(tc, 3, 16, seed=5, vlm_tokens=vlm, device="cpu")
    for _ in range(3):
        jb, tb = next(jit_), next(tit)
        for name, jx, tx in zip(jb._fields, jb, tb):
            assert (jx is None) == (tx is None), name
            if jx is not None:
                np.testing.assert_array_equal(tx.numpy(), np.asarray(jx), err_msg=name)
    if jc.family == "vlm":
        assert tb.inputs_embeds is not None
    if jc.enc_dec:
        assert tuple(tb.enc_feats.shape) == (3, tc.enc_seq, tc.d_model)


def _opt_numpy(opt):
    return jax.tree_util.tree_map(np.asarray, opt)


def test_checkpoint_port_to_jax(tmp_path):
    """A port save (after a step, so the moments are non-zero) read by
    the JAX package's ``checkpoint.load`` into its templates: bitwise."""
    arch = "whisper-large-v3-smoke"
    jcfg, tcfg, jp, tp = setup(arch)
    ocfg = topt.OptCfg(lr=1e-3, warmup=1, total_steps=4)
    p = trainable(tp)
    opt = topt.init_opt_state(p, ocfg)
    b = next(tpipe.lm_batches(tcfg, 2, 8, seed=1, device="cpu"))
    p, opt, _ = tts.make_train_step(tcfg, ocfg, remat=False)(p, opt, b)
    path = os.path.join(tmp_path, "port.npz")
    tckpt.save(path, p, opt, step=1)
    jopt_t = jopt.init_opt_state(jp, jopt.OptCfg())
    jp2, jo2, step = jckpt.load(path, jp, jopt_t)
    assert step == 1 and int(jo2.step) == 1
    for a, b_ in zip(jax.tree_util.tree_leaves(jp2), tree_leaves(p)):
        np.testing.assert_array_equal(f32(a), f32(b_))
    for a, b_ in zip(jax.tree_util.tree_leaves((jo2.mu, jo2.nu)), tree_leaves((opt.mu, opt.nu))):
        np.testing.assert_array_equal(f32(a), f32(b_))
    assert jax.tree_util.tree_leaves(jp2)[0].dtype == jax.tree_util.tree_leaves(jp)[0].dtype


def test_checkpoint_jax_to_port(tmp_path):
    """A JAX save read by the port into its own templates, params and
    opt state (``from_numpy_tree`` of the JAX state gives the same
    values), bitwise, dtypes kept."""
    arch = "olmoe-1b-7b-smoke"
    jcfg, tcfg, jp, tp = setup(arch, seed=3)
    ocfg = jopt.OptCfg()
    jst = jopt.init_opt_state(jp, ocfg)
    g = jax.tree_util.tree_map(lambda x: jnp.full(x.shape, 0.01, x.dtype), jp)
    jp, jst, _ = jopt.apply_updates(jp, g, jst, ocfg)
    path = os.path.join(tmp_path, "jax.npz")
    jckpt.save(path, jp, jst, step=7)
    tmpl = init_lm_params(tcfg, 0, "cpu")
    tp2, to2, step = tckpt.load(path, tmpl, topt.init_opt_state(tmpl, topt.OptCfg()))
    assert step == 7 and int(to2.step) == 1
    bridged = from_numpy_tree(_opt_numpy(jst))
    assert isinstance(bridged, topt.OptState)
    for a, b_ in zip(tree_leaves(tp2), jax.tree_util.tree_leaves(jp)):
        assert a.dtype == (torch.bfloat16 if b_.dtype == jnp.bfloat16 else torch.float32)
        np.testing.assert_array_equal(f32(a), f32(b_))
    for a, b_, c in zip(tree_leaves(to2), jax.tree_util.tree_leaves(jst), tree_leaves(bridged)):
        np.testing.assert_array_equal(f32(a), f32(b_))
        np.testing.assert_array_equal(f32(c), f32(b_))


def test_checkpoint_roundtrip_in_port(tmp_path):
    tcfg = TModelCfg(**DENSE)
    params = init_lm_params(tcfg, 4, "cpu")
    opt = topt.init_opt_state(params, topt.OptCfg())
    path = os.path.join(tmp_path, "ck.npz")
    tckpt.save(path, params, opt, step=7)
    p2, o2, step = tckpt.load(path, params, opt)
    assert step == 7
    for a, b in zip(tree_leaves(params), tree_leaves(p2)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_launch_train_main_on_cpu(tmp_path, capsys):
    path = os.path.join(tmp_path, "ck.npz")
    tlaunch.main(["--device", "cpu", "--arch", "deepseek-7b-smoke", "--steps", "3",
                  "--batch", "2", "--seq", "32", "--ckpt", path])
    out = capsys.readouterr().out
    lines = [ln for ln in out.splitlines() if ln.startswith("step ")]
    assert [ln.split()[1] for ln in lines] == ["0", "2"]
    assert "final loss" in out and os.path.exists(path)
    with np.load(path) as data:
        assert int(data["__step__"]) == 3
        assert "params/['blocks']/[0]/['mixer']/['wq']" in data.files
        assert "opt/.mu/['embed']" in data.files and "opt/.step" in data.files
    # the production mesh needs its 256 ranks; this process has none
    with pytest.raises(ValueError, match="256"):
        tlaunch.train("deepseek-7b-smoke", 1, 2, 8, mesh_kind="single", device="cpu")


def test_trainable_and_detached_share_storage():
    params = init_lm_params(TModelCfg(**DENSE), 0, "cpu")
    tr = trainable(params)
    assert all(t.requires_grad and t.is_leaf for t in tree_leaves(tr))
    de = detached(tr)
    assert not any(t.requires_grad for t in tree_leaves(de))
    assert all(a.data_ptr() == b.data_ptr() for a, b in zip(tree_leaves(tr), tree_leaves(de)))


# ----------------------------------------------------------------------
# the plain versions of the kernel ops differentiate (on the card, the
# kernels refuse operands that require grad: tests/test_torch_gpu.py)
# ----------------------------------------------------------------------
def _attn(B, Sq, Sk, H, K, D, seed):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(s, generator=g).requires_grad_(True)
            for s in ((B, Sq, H, D), (B, Sk, K, D), (B, Sk, K, D))]


def _plain_calls(name):
    """(the op called on CPU tensors that require grad, its inputs)."""
    if name == "flash_refresh":
        q, k, v = _attn(2, 8, 16, 4, 2, 32, 0)
        pos = torch.arange(8, 16)[None].expand(2, 8)
        return lambda: ops.flash_refresh(q, k, v, pos, block_map=build_block_map(
            np.arange(8, 16), 16)), (q, k, v)
    if name == "flash_refresh_paged":
        q, k, v = _attn(1, 8, 256, 4, 2, 32, 1)
        k, v = (t.detach()[0].requires_grad_(True) for t in (k, v))
        pt = torch.tensor([[1, 0]], dtype=torch.int32)
        pos = torch.arange(8)[None]
        return lambda: ops.flash_refresh_paged(
            q, k, v, pos, torch.ones((1, 256), dtype=torch.bool), pt), (q, k, v)
    if name == "flash_packed":
        q, k, v = _attn(1, 128, 128, 2, 2, 32, 2)
        seg = torch.tensor([[0] * 40 + [1] * 60 + [-1] * 28])
        return lambda: ops.flash_packed(q, k, v, seg, build_pack_map(seg.numpy())), (q, k, v)
    if name == "flash_prefill":
        q, k, v = _attn(1, 8, 8, 4, 2, 32, 3)
        return lambda: ops.flash_prefill(q, k, v), (q, k, v)
    if name == "flash_prefill_paged":
        q, k, v = _attn(1, 8, 256, 4, 2, 32, 4)
        k, v = (t.detach()[0].requires_grad_(True) for t in (k, v))
        pt = torch.tensor([[1, 0]], dtype=torch.int32)
        return lambda: ops.flash_prefill_paged(q, k, v, pt), (q, k, v)
    if name == "ssd_scan":
        g = torch.Generator().manual_seed(5)
        x = torch.randn((1, 12, 2, 8), generator=g).requires_grad_(True)
        la = (-torch.rand((1, 12, 2), generator=g)).requires_grad_(True)
        b = torch.randn((1, 12, 1, 4), generator=g).requires_grad_(True)
        c = torch.randn((1, 12, 1, 4), generator=g).requires_grad_(True)
        return lambda: ops.ssd_scan(x, la, b, c, chunk=4)[0], (x, la, b, c)
    if name == "rope_shift":
        k = torch.randn((1, 6, 2, 8), generator=torch.Generator().manual_seed(6))
        k.requires_grad_(True)
        return lambda: ops.rope_shift(k, torch.full((1, 6), 3, dtype=torch.int32)), (k,)
    raise KeyError(name)


@pytest.mark.parametrize("name", ["flash_refresh", "flash_refresh_paged", "flash_packed",
                                  "flash_prefill", "flash_prefill_paged", "ssd_scan",
                                  "rope_shift"])
def test_plain_versions_differentiate(name):
    call, inputs = _plain_calls(name)
    out = call()
    assert out.requires_grad
    grads = torch.autograd.grad(out.float().square().sum(), inputs)
    assert all(g is not None and bool(torch.isfinite(g).all()) and bool(g.abs().sum() > 0)
               for g in grads)

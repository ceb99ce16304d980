"""Shared helpers of the training parity tests: one seed-made batch and
one set of weights through the JAX package's train step and the port's.

Weights are the JAX package's ``init_params`` carried across by
``from_numpy_tree``; a batch's arrays are made once with numpy and given
to both.  ``jax_step`` and ``port_step`` return the loss, CE, aux,
grad_norm, every gradient leaf and the updated parameters and moments,
flattened in the JAX package's leaf order, as numpy f32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jget_config
from repro.models import transformer as jtfm
from repro.training import optimizer as jopt
from repro.training import train_step as jts
from repro_torch.configs import get_config as tget_config
from repro_torch.models.init import from_numpy_tree, map_tree, trainable, tree_leaves
from repro_torch.training import optimizer as topt
from repro_torch.training import train_step as tts

OCFG = dict(lr=1e-3, warmup=1, total_steps=10)


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def setup(arch: str, seed: int = 0):
    """(JAX cfg, port cfg, JAX params, the port's copy of them)."""
    jcfg, tcfg = jget_config(arch), tget_config(arch)
    jp, _ = jtfm.init_params(jcfg, jax.random.PRNGKey(seed))
    return jcfg, tcfg, jp, from_numpy_tree(jax.tree_util.tree_map(np.asarray, jp))


def batch_arrays(cfg, B: int, S: int, seed: int = 0, n_embed: int = 8) -> dict:
    """numpy arrays of one batch: tokens, targets (tokens shifted), an
    all-ones loss mask, plus ``inputs_embeds``/``embed_mask`` (first
    ``n_embed`` positions) for the vlm family and ``enc_feats`` for
    encoder-decoder configs."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, size=(B, S + 1)).astype(np.int32)
    out = dict(tokens=toks[:, :-1].copy(), targets=toks[:, 1:].copy(),
               loss_mask=np.ones((B, S), np.float32))
    if cfg.family == "vlm":
        out["inputs_embeds"] = rng.normal(0, 0.5, (B, S, cfg.d_model)).astype(np.float32)
        out["embed_mask"] = np.arange(S)[None].repeat(B, 0) < n_embed
    if cfg.enc_dec:
        out["enc_feats"] = rng.normal(0, 0.5, (B, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    return out


def jax_batch(a: dict) -> jts.Batch:
    return jts.Batch(**{k: jnp.asarray(v) for k, v in a.items()})


def port_batch(a: dict) -> tts.Batch:
    return tts.Batch(**{k: torch.from_numpy(np.array(v)) for k, v in a.items()})


def jax_step(cfg, params, arrays: dict, *, remat: bool, q_chunk: int = 16):
    """The JAX package's train step, its gradients taken apart: jitted
    ``value_and_grad(loss_fn)`` then ``apply_updates``."""
    ocfg = jopt.OptCfg(**OCFG)
    opt = jopt.init_opt_state(params, ocfg)
    batch = jax_batch(arrays)
    vg = jax.jit(jax.value_and_grad(
        lambda p: jts.loss_fn(cfg, p, batch, q_chunk=q_chunk, remat=remat), has_aux=True))
    (loss, (ce, aux)), grads = vg(params)
    new_p, new_opt, m = jax.jit(lambda p, g, o: jopt.apply_updates(p, g, o, ocfg))(
        params, grads, opt)
    leaves = jax.tree_util.tree_leaves
    return dict(loss=float(loss), ce=float(ce), aux=float(aux),
                grad_norm=float(m["grad_norm"]),
                grads=[f32(g) for g in leaves(grads)],
                params=[f32(p) for p in leaves(new_p)],
                old=[f32(p) for p in leaves(params)],
                mu=[f32(x) for x in leaves(new_opt.mu)],
                nu=[f32(x) for x in leaves(new_opt.nu)])


def port_step(cfg, params, arrays: dict, *, remat: bool, q_chunk: int = 16, device="cpu"):
    """The port's ``make_train_step`` on a trainable copy of ``params``."""
    ocfg = topt.OptCfg(**OCFG)
    p = trainable(map_tree(lambda t: t.clone().to(device), params))
    opt = topt.init_opt_state(p, ocfg)
    batch = tts.Batch(*(None if x is None else x.to(device) for x in port_batch(arrays)))
    grads = {}

    def loss_of(pp, b):
        loss, (ce, aux) = tts.loss_fn(cfg, pp, b, q_chunk=q_chunk, remat=remat)
        grads["tree"] = tts.tree_grads(loss, pp)
        return loss.detach(), ce.detach(), aux.detach()

    loss, ce, aux = loss_of(p, batch)
    g = grads["tree"]
    p, opt, m = topt.apply_updates(p, g, opt, ocfg)
    return dict(loss=float(loss), ce=float(ce), aux=float(aux),
                grad_norm=float(m["grad_norm"]),
                grads=[f32(x) for x in tree_leaves(g)],
                params=[f32(x) for x in tree_leaves(p)],
                mu=[f32(x) for x in tree_leaves(opt.mu)],
                nu=[f32(x) for x in tree_leaves(opt.nu)])


def bf16_ulp(*arrays: np.ndarray) -> np.ndarray:
    """The spacing of bf16 values (8 significand bits) at the largest
    magnitude of ``arrays``, elementwise (at least that of the smallest
    normal)."""
    m = np.float32(2.0 ** -126)
    for a in arrays:
        m = np.maximum(m, np.abs(a))
    return np.exp2(np.floor(np.log2(m)) - 7)


def step_gaps(j: dict, t: dict) -> dict:
    """The readings the step tolerances are stated against: relative
    loss and grad_norm gaps; per leaf the gradient gap over the leaf's
    max |g|; the parameter gap beyond one bf16 ulp in units of lr
    (everywhere), and in bf16 ulps where both gradients share a sign and
    |g| exceeds 2^-6 of the leaf's max; the moments' gaps over their
    leaf's max.  The ulp is taken at the larger of the parameter's old
    and new magnitudes: the update ``p - lr * delta`` is an f32 sum at
    |p|'s scale, and where it cancels (|p| near lr) the result's own ulp
    is finer than the f32 difference that the eps term leaves between
    the two packages (``g / (|g| + eps)`` with |g| gaps of 2^-5 of the
    leaf's max)."""
    lr = float(np.float32(OCFG["lr"]))           # the f32 value the update uses
    r = dict(loss=abs(t["loss"] - j["loss"]) / abs(j["loss"]),
             grad_norm=abs(t["grad_norm"] - j["grad_norm"]) / j["grad_norm"],
             grad=0.0, param_lr=0.0, param_ulp=0.0, mu=0.0, nu=0.0)
    for gj, gt, p0, pj, pt, mj, mt, vj, vt in zip(
            j["grads"], t["grads"], j["old"], j["params"], t["params"], j["mu"], t["mu"],
            j["nu"], t["nu"]):
        gmax = max(float(np.abs(gj).max()), 1e-30)
        r["grad"] = max(r["grad"], float(np.abs(gt - gj).max()) / gmax)
        dp = np.abs(pt.astype(np.float64) - pj)
        ulp = bf16_ulp(p0, pj, pt).astype(np.float64)
        r["param_lr"] = max(r["param_lr"], float(np.maximum(dp - ulp, 0).max()) / lr)
        firm = (np.sign(gj) == np.sign(gt)) & (np.abs(gj) > 2.0 ** -6 * gmax)
        if firm.any():
            r["param_ulp"] = max(r["param_ulp"], float((dp / ulp)[firm].max()))
        r["mu"] = max(r["mu"], float(np.abs(mt - mj).max()) / max(float(np.abs(mj).max()), 1e-30))
        r["nu"] = max(r["nu"], float(np.abs(vt - vj).max()) / max(float(np.abs(vj).max()), 1e-30))
    return r


# One train step, port against the JAX package (readings at B 2, S 32,
# lr 1e-3, bf16 weights; test_torch_train.py, test_torch_whisper.py and
# the anomaly step of test_torch_anomaly.py):
#   loss       1e-3 relative   (read 6.1e-7 .. 7.3e-5)
#   grad_norm  1e-2 relative   (read 9.0e-4 .. 3.0e-3)
#   grad       2^-5 of each leaf's max |g| (read 9.1e-3 .. 2.22e-2; the
#              JAX package's own jitted and eager gradients of the
#              whisper-smoke step differ by 2.26e-2 on this measure)
#   param_lr   2 (x lr, beyond one bf16 ulp: a near-zero gradient whose
#              sign differs moves the weight the other way; read 2)
#   param_ulp  1 bf16 ulp where both gradients share a sign and |g| >
#              2^-6 of the leaf's max (read 0 .. 1)
#   mu         2^-5 of each leaf's max (read 1.0e-2 .. 2.42e-2): 0.1 g
#              at the first step, so the gradient's limit
#   nu         2^-4 of each leaf's max (read 2.0e-2 .. 4.90e-2, the
#              anomaly step): 0.05 g^2 at the first step, and g^2's gap
#              |g_t - g_j| |g_t + g_j| is up to twice the gradient's
#              limit of 2^-5 when both lie near the max; the optimizer's
#              formulas agree to 1e-7 on equal gradients (test_torch_train.py)
STEP_LIMITS = dict(loss=1e-3, grad_norm=1e-2, grad=2.0 ** -5, param_lr=2.0,
                   param_ulp=1.0, mu=2.0 ** -5, nu=2.0 ** -4)


def assert_step_within(gaps: dict, limits: dict = STEP_LIMITS) -> None:
    over = {k: (v, limits[k]) for k, v in gaps.items() if v > limits[k]}
    assert not over, (over, gaps)

"""The readings behind ``test_torch_hybrid_train.py``'s limits: one train
step of jamba-v0.1-52b-smoke cut to one period (8 layers: attention at
position 4, MoE at the odd positions, SSD mixers elsewhere), B 2, S 32,
no remat, in the port and in the JAX package.

    PYTHONPATH=src:tests JAX_PLATFORMS=cpu python tests/torch_hybrid_gap.py

Runs the JAX package's step twice, each in its own process: once with
XLA's default flags (as the tests run it; its expert choices recorded)
and once with ``--xla_allow_excess_precision=false`` (every bf16 op
rounded to bf16, as PyTorch does) on those same choices
(``torch_moe_routes.jax_forced``).  Prints, in the measures of
``torch_train_parity.step_gaps``:

* the port's f32 and bf16 steps against the JAX package's (default
  flags), the port on the JAX package's choices, with the worst leaves
  of the gradient and ``param_ulp`` readings, and the bf16 step against
  the JAX package's with every op rounded;
* the JAX package's bf16 step under one flag setting against the other:
  the reference's own drift at the same shape and choices;
* the near-tie flips of the port's own choices.

About two and a half minutes on a CPU.
"""
import dataclasses
import os
import subprocess
import sys
import tempfile

import numpy as np

STRICT = "--xla_allow_excess_precision=false"
ARCH = "jamba-v0.1-52b-smoke"
B, S = 2, 32


def one_period(dtype: str = "bfloat16", seed: int = 0):
    """(JAX cfg, port cfg, JAX params, the port's copy) of ARCH cut to one
    period, in ``dtype``."""
    import jax
    from repro.configs import get_config as jget
    from repro.models import transformer as jtfm
    from repro_torch.configs import get_config as tget
    from repro_torch.models.init import from_numpy_tree
    j0, t0 = jget(ARCH), tget(ARCH)
    jcfg = dataclasses.replace(j0, n_layers=j0.period, dtype=dtype)
    tcfg = dataclasses.replace(t0, n_layers=t0.period, dtype=dtype)
    jp, _ = jtfm.init_params(jcfg, jax.random.PRNGKey(seed))
    return jcfg, tcfg, jp, from_numpy_tree(jax.tree_util.tree_map(np.asarray, jp))


def leaf_names(jp) -> list:
    import jax
    return [jax.tree_util.keystr(k) for k, _ in jax.tree_util.tree_flatten_with_path(jp)[0]]


def worst_leaves(j: dict, t: dict, names: list) -> str:
    """The leaves of the largest gradient gap and of the largest
    ``param_ulp`` reading, that element's two gradients beside it."""
    from torch_train_parity import bf16_ulp
    grad = [float(np.abs(gt - gj).max()) / max(float(np.abs(gj).max()), 1e-30)
            for gj, gt in zip(j["grads"], t["grads"])]
    ulps = []
    for gj, gt, p0, pj, pt in zip(j["grads"], t["grads"], j["old"], j["params"], t["params"]):
        dp = np.abs(pt.astype(np.float64) - pj) / bf16_ulp(p0, pj, pt)
        firm = (np.sign(gj) == np.sign(gt)) & (np.abs(gj) > 2.0 ** -6 * np.abs(gj).max())
        at = int(np.argmax(np.where(firm, dp, -1.0)))
        ulps.append((float(dp.flat[at]) if firm.any() else 0.0, float(gj.flat[at]),
                     float(gt.flat[at]), float(np.abs(gj).max())))
    i, k = int(np.argmax(grad)), int(np.argmax([u[0] for u in ulps]))
    u = ulps[k]
    return (f"worst gradient leaf {names[i]} {grad[i]:.3g}; worst param_ulp leaf {names[k]} "
            f"{u[0]:.3g} (gradients there {u[1]:.3g} and {u[2]:.3g}, the leaf's max {u[3]:.3g})")


def jax_step_recorded(dtype: str, force=None):
    """The JAX package's step on the one-period stack: (step, its choices)."""
    from torch_moe_routes import jax_choices, jax_forced
    from torch_train_parity import batch_arrays, jax_step
    jcfg, _, jp, _ = one_period(dtype)
    a = batch_arrays(jcfg, B, S)
    log = []
    if force is None:
        with jax_choices(log):
            j = jax_step(jcfg, jp, a, remat=False)
    else:
        with jax_forced(force), jax_choices(log):
            j = jax_step(jcfg, jp, a, remat=False)
    return j, log


def port_step_forced(dtype: str, jlog: list):
    """The port's step on the JAX package's choices: (step, its own choices)."""
    from torch_moe_routes import port_choices
    from torch_train_parity import batch_arrays, port_step
    jcfg, tcfg, _, tp = one_period(dtype)
    a = batch_arrays(jcfg, B, S)
    tlog = []
    with port_choices(tlog, force=jlog):
        t = port_step(tcfg, tp, a, remat=False)
    return t, tlog


def save_step(path: str, j: dict, log: list) -> None:
    arrays = {f"{k}_{i}": v for k in ("grads", "params", "old", "mu", "nu")
              for i, v in enumerate(j[k])}
    arrays.update({f"choice_{i}": e for i, (_, e) in enumerate(log)})
    np.savez(path, loss=j["loss"], grad_norm=j["grad_norm"], **arrays)


def load_step(path: str):
    with np.load(path) as z:
        n = sum(1 for f in z.files if f.startswith("grads_"))
        j = dict(loss=float(z["loss"]), grad_norm=float(z["grad_norm"]),
                 **{k: [z[f"{k}_{i}"] for i in range(n)]
                    for k in ("grads", "params", "old", "mu", "nu")})
        choices = [(None, z[f"choice_{i}"]) for i in
                   range(sum(1 for f in z.files if f.startswith("choice_")))]
    return j, choices


def fmt(g: dict) -> str:
    return ", ".join(f"{k} {v:.3g}" for k, v in g.items())


def child(out: str, choices_path: str) -> None:
    force = load_step(choices_path)[1] if os.path.exists(choices_path) else None
    j, log = jax_step_recorded("bfloat16", force)
    save_step(out, j, log)


def main() -> None:
    if sys.argv[1:2] == ["--child"]:
        child(sys.argv[2], sys.argv[3])
        return
    from torch_moe_routes import flips
    from torch_train_parity import step_gaps
    with tempfile.TemporaryDirectory() as tmp:
        runs = []
        for flags in (None, STRICT):
            env = dict(os.environ)
            env.pop("XLA_FLAGS", None)
            if flags:
                env["XLA_FLAGS"] = flags
            runs.append(os.path.join(tmp, f"{len(runs)}.npz"))
            subprocess.run([sys.executable, __file__, "--child", runs[-1], runs[0]],
                           env=env, check=True)
        (jd, log), (js, _) = load_step(runs[0]), load_step(runs[1])
    names = leaf_names(one_period()[2])
    drift = step_gaps(jd, js)
    print(f"the JAX package, default flags vs every op rounded (same choices): {fmt(drift)}; "
          f"{worst_leaves(jd, js, names)}")
    for dtype in ("float32", "bfloat16"):
        j, jlog = jax_step_recorded(dtype)
        t, tlog = port_step_forced(dtype, jlog)
        found = flips(jlog, tlog)
        print(f"{dtype}: port vs the JAX package: {fmt(step_gaps(j, t))}; "
              f"{worst_leaves(j, t, names)}; {len(found)} flips, near ties: "
              f"{all(f[4] <= 2 * f[5] for f in found)}")
    print(f"bfloat16: port vs the JAX package with every op rounded: {fmt(step_gaps(js, t))}; "
          f"{worst_leaves(js, t, names)}")


if __name__ == "__main__":
    main()

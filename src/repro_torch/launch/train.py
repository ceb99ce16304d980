"""Training launcher, on the card unless ``--device cpu`` is given.

    PYTHONPATH=src python -m repro_torch.launch.train --arch deepseek-7b-smoke \
        --steps 100 --batch 8 --seq 128
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
        --arch whisper-large-v3-smoke --steps 3 --batch 2 --seq 32

Same flags, step lines and ``final loss`` line as ``repro.launch.train``:
random weights from the seed (``models.init.init_lm_params``), the
synthetic bigram stream of ``data.pipeline.lm_batches``, AdamW with
warm-up ``min(100, steps // 10 + 1)`` and cosine decay, per-layer
recomputation in the backward.  ``--ckpt`` writes the npz layout that
both packages read.  Only ``--mesh host`` (one device) is ported.
"""
from __future__ import annotations

import argparse
import time

from ..configs import get_config
from ..data.pipeline import lm_batches
from ..models.init import init_lm_params, trainable
from ..serving.api import resolve_device
from ..training import checkpoint
from ..training.optimizer import OptCfg, init_opt_state
from ..training.train_step import make_train_step


def train(
    arch: str, steps: int, batch: int, seq: int, *,
    lr: float = 3e-4, mesh_kind: str = "host", seed: int = 0,
    log_every: int = 10, ckpt_path: str | None = None,
    microbatch: int = 1, q_chunk: int = 1024, device="cuda",
):
    """Train ``arch`` for ``steps`` steps from the seed's random weights;
    returns (params, losses)."""
    if mesh_kind != "host":
        raise NotImplementedError(
            f"--mesh {mesh_kind}: sharded meshes are not ported (ROADMAP, sharding)")
    dev = resolve_device(device)
    cfg = get_config(arch)
    ocfg = OptCfg(lr=lr, warmup=min(100, steps // 10 + 1), total_steps=steps)
    params = trainable(init_lm_params(cfg, seed, dev))
    opt_state = init_opt_state(params, ocfg)
    step_fn = make_train_step(cfg, ocfg, q_chunk=q_chunk, microbatch=microbatch)
    it = lm_batches(cfg, batch, seq, seed=seed,
                    vlm_tokens=seq // 4 if cfg.family == "vlm" else 0, device=dev)
    losses = []
    t0 = time.time()
    for i in range(steps):
        b = next(it)
        params, opt_state, m = step_fn(params, opt_state, b)
        losses.append(float(m["loss"]))
        if i % log_every == 0 or i == steps - 1:
            print(f"step {i:5d} loss {losses[-1]:.4f} "
                  f"lr {float(m['lr']):.2e} gnorm {float(m['grad_norm']):.3f} "
                  f"({(time.time()-t0)/(i+1):.2f}s/step)", flush=True)
    if ckpt_path:
        checkpoint.save(ckpt_path, params, opt_state, steps)
        print(f"saved {ckpt_path}")
    return params, losses


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--mesh", default="host", choices=["host", "single", "multi"])
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    _, losses = train(
        args.arch, args.steps, args.batch, args.seq, lr=args.lr,
        mesh_kind=args.mesh, ckpt_path=args.ckpt,
        microbatch=args.microbatch, device=args.device,
    )
    print(f"final loss {losses[-1]:.4f} (start {losses[0]:.4f})")


if __name__ == "__main__":
    main()

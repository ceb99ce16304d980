"""Training launcher, on the card unless ``--device cpu`` is given.

    PYTHONPATH=src python -m repro_torch.launch.train --arch deepseek-7b-smoke \
        --steps 100 --batch 8 --seq 128
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
        --arch whisper-large-v3-smoke --steps 3 --batch 2 --seq 32
    torchrun --nproc-per-node 8 --nnodes 32 ... -m repro_torch.launch.train \
        --arch deepseek-7b --mesh single --batch 256 --seq 4096

Same flags, step lines and ``final loss`` line as ``repro.launch.train``:
random weights from the seed (``models.init.init_lm_params``), the
synthetic bigram stream of ``data.pipeline.lm_batches``, AdamW with
warm-up ``min(100, steps // 10 + 1)`` and cosine decay, per-layer
recomputation in the backward.  ``--ckpt`` writes the npz layout that
both packages read.

``--mesh host`` trains on one device: on its 1x1 mesh every placement
is whole, so the tree stays plain tensors (as JAX's ``device_put`` on a
one-device mesh is a plain put).  ``--mesh single|multi`` is the
production mesh, (16, 16) ``("data", "model")`` or (2, 16, 16) ``("pod",
"data", "model")``, one rank per GPU in the process group that
``torchrun`` makes: ``train_on_mesh`` places each parameter by the
sharding rules (FSDP over data, TP over model) as a DTensor, splits the
batch over the batch axes, and runs the step under the mesh's activation
constraints.  Each rank draws the whole model from the seed and keeps
its shard, so every mesh trains the same weights.
"""
from __future__ import annotations

import argparse
import time

from ..configs import get_config
from ..data.pipeline import lm_batches
from ..models.init import init_lm_params, logical_specs, map_tree, trainable
from ..serving.api import resolve_device
from ..sharding import rules as shr
from ..sharding.ctx import activation_mesh, is_dtensor, whole_mesh_strategies
from ..training import checkpoint
from ..training.optimizer import OptCfg, init_opt_state
from ..training.train_step import Batch, make_train_step
from .mesh import make_production_mesh


def shard_params(cfg, params, mesh):
    """``params`` as DTensors on ``mesh``, each placed by the rules
    (``rules.param_shardings`` of ``logical_specs(cfg)``, with the
    divisibility fallback)."""
    from torch.distributed.tensor import distribute_tensor
    sh = shr.param_shardings(logical_specs(cfg), mesh, params_tree=params)

    def walk(p, s):
        if isinstance(p, dict):
            return {k: walk(p[k], s[k]) for k in p}
        if isinstance(p, tuple):
            return tuple(walk(a, b) for a, b in zip(p, s))
        return distribute_tensor(p, mesh, s.placements, src_data_rank=None)
    return walk(params, sh)


def shard_batch(batch: Batch, mesh) -> Batch:
    """Each field split over the batch axes where they divide its batch
    (every rank holds the same batch and keeps its slice)."""
    from torch.distributed.tensor import distribute_tensor
    return Batch(*(None if f is None else distribute_tensor(
        f, mesh, shr.to_placements(shr.data_spec(mesh, f.shape[0], f.dim()), mesh),
        src_data_rank=None) for f in batch))


def train_on_mesh(cfg, mesh, ocfg: OptCfg, params, batches, steps: int, *,
                  log_every: int = 10, microbatch: int = 1, q_chunk: int = 1024):
    """The JAX launcher's sharded flow on any named ``DeviceMesh``:
    ``params`` (a plain tree, the same on every rank) placed by the
    rules, each batch of ``batches`` split over the batch axes, and
    ``steps`` steps run under ``activation_mesh(mesh)`` where the mesh has
    more than one device (a 1x1 mesh runs the DTensor step without
    constraints, as JAX does); plain tensors the step makes (positions,
    masks) count as replicated (``implicit_replication``), and DTensor
    takes its whole-mesh sharding strategies (``whole_mesh_strategies``).
    Returns (params as DTensors, opt state, each step's metrics as whole
    tensors)."""
    from torch.distributed.tensor.experimental import implicit_replication
    params = trainable(shard_params(cfg, params, mesh))
    opt_state = init_opt_state(params, ocfg)
    step_fn = make_train_step(cfg, ocfg, q_chunk=q_chunk, microbatch=microbatch)
    metrics = []
    t0 = time.time()
    with (activation_mesh(mesh if mesh.size() > 1 else None), implicit_replication(),
          whole_mesh_strategies()):
        for i in range(steps):
            params, opt_state, m = step_fn(params, opt_state, shard_batch(next(batches), mesh))
            m = {k: v.full_tensor() if is_dtensor(v) else v for k, v in m.items()}
            metrics.append(m)
            if i % log_every == 0 or i == steps - 1:
                print(f"step {i:5d} loss {float(m['loss']):.4f} "
                      f"lr {float(m['lr']):.2e} gnorm {float(m['grad_norm']):.3f} "
                      f"({(time.time()-t0)/(i+1):.2f}s/step)", flush=True)
    return params, opt_state, metrics


def train(
    arch: str, steps: int, batch: int, seq: int, *,
    lr: float = 3e-4, mesh_kind: str = "host", seed: int = 0,
    log_every: int = 10, ckpt_path: str | None = None,
    microbatch: int = 1, q_chunk: int = 1024, device="cuda",
):
    """Train ``arch`` for ``steps`` steps from the seed's random weights;
    returns (params, losses).  ``mesh_kind`` "single" or "multi" needs a
    process group of 256 or 512 ranks (``ValueError`` otherwise)."""
    dev = resolve_device(device)
    cfg = get_config(arch)
    ocfg = OptCfg(lr=lr, warmup=min(100, steps // 10 + 1), total_steps=steps)
    if mesh_kind not in ("host", "single", "multi"):
        raise ValueError(f"mesh {mesh_kind!r}: host, single or multi")
    if mesh_kind != "host":
        mesh = make_production_mesh(multi_pod=mesh_kind == "multi", device=dev)
        it = lm_batches(cfg, batch, seq, seed=seed,
                        vlm_tokens=seq // 4 if cfg.family == "vlm" else 0, device=dev)
        params, opt_state, metrics = train_on_mesh(
            cfg, mesh, ocfg, init_lm_params(cfg, seed, dev), it, steps,
            log_every=log_every, microbatch=microbatch, q_chunk=q_chunk)
        losses = [float(m["loss"]) for m in metrics]
        if ckpt_path:
            full = lambda t: t.full_tensor()
            params = map_tree(full, params)
            opt_state = map_tree(full, opt_state)
            if mesh.get_rank() == 0:
                checkpoint.save(ckpt_path, params, opt_state, steps)
                print(f"saved {ckpt_path}")
        return params, losses
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

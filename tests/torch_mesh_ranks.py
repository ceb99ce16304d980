"""The sharded train step on a 2x2 ("data", "model") mesh of four gloo
ranks on the CPU, against the same step without a mesh.

    PYTHONPATH=src python tests/torch_mesh_ranks.py STORE_FILE [ARCH ...]

Each rank draws the same f32 weights and batch from the seed, runs the
meshless step and ``launch.train.train_on_mesh``'s step on its shard,
and compares each shard with the matching slice of the meshless result:
rank 0 prints one JSON line per arch with the two losses and grad
norms, the largest gap of a first moment (the clipped gradient times
1 - b1) relative to its leaf's largest, and the largest parameter gap
where the gradient stands above FLOOR of its leaf's largest (the
largest of each over the ranks).  Below it a gradient is within f32
summation noise of zero: Adam's first step moves such a weight by
lr * g / (|g| + eps), which the noise decides.
``tests/test_torch_sharding.py`` runs it in a subprocess: a process
group is global to a process.
"""
from __future__ import annotations

import dataclasses
import json
import sys

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WORLD = 4
B, S = 4, 16
FLOOR = 1e-5


def rank_main(rank: int, store: str, archs: list) -> None:
    torch.set_num_threads(1)        # four ranks share the host's cores
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=WORLD)
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import lm_batches
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import train_on_mesh
    from repro_torch.models.init import init_lm_params, leaf_paths, map_tree, trainable
    from repro_torch.training.optimizer import OptCfg, init_opt_state
    from repro_torch.training.train_step import make_train_step
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    ocfg = OptCfg(warmup=1, total_steps=4)          # lr 3e-4 from the first step
    for arch in archs:
        cfg = dataclasses.replace(get_config(arch), dtype="float32")
        params = init_lm_params(cfg, 0, "cpu")
        batch = next(lm_batches(cfg, B, S, seed=0, device="cpu"))
        ref = trainable(map_tree(lambda t: t.clone(), params))
        ref, ref_opt, m_ref = make_train_step(cfg, ocfg, q_chunk=8)(
            ref, init_opt_state(ref, ocfg), batch)
        sharded, opt, [got] = train_on_mesh(cfg, mesh, ocfg, params, iter([batch]), 1,
                                            q_chunk=8, log_every=10**9)
        grad_gap = param_gap = 0.0
        for (_, a), (_, d), (_, mu), (_, mu_d) in zip(
                leaf_paths(ref), leaf_paths(sharded), leaf_paths(ref_opt.mu),
                leaf_paths(opt.mu)):
            assert isinstance(d, DTensor) and isinstance(mu_d, DTensor)
            shape, off = compute_local_shape_and_global_offset(d.shape, mesh, d.placements)
            sl = tuple(slice(o, o + n) for o, n in zip(off, shape))
            top = float(mu.abs().max())
            if top == 0.0:
                continue
            g, g_d = mu[sl], mu_d.to_local()
            grad_gap = max(grad_gap, float((g - g_d).abs().max()) / top)
            above = g.abs() > FLOOR * top
            if above.any():
                gap = (a.detach()[sl] - d.to_local().detach()).abs()[above]
                param_gap = max(param_gap, float(gap.max()))
        gaps = [None] * WORLD
        dist.all_gather_object(gaps, (grad_gap, param_gap))
        if rank == 0:
            print(json.dumps(dict(arch=arch, loss=float(m_ref["loss"]), loss_mesh=float(got["loss"]),
                                  gnorm=float(m_ref["grad_norm"]),
                                  gnorm_mesh=float(got["grad_norm"]),
                                  grad_gap=max(g for g, _ in gaps),
                                  param_gap=max(p for _, p in gaps))),
                  flush=True)
    dist.destroy_process_group()


if __name__ == "__main__":
    mp.start_processes(rank_main, args=(sys.argv[1], sys.argv[2:]), nprocs=WORLD,
                       start_method="spawn")

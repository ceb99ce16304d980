"""Multi-pod dry run: build every (architecture x input shape) program on
the production meshes, run it once on the meta device and count its
roofline terms.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch deepseek-7b \\
        --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both

It runs on no device: the counterpart of the JAX package's abstract
evaluation.  One process stands for rank 0 of a fake process group of
256 or 512 ranks (``torch.testing._internal.distributed.fake_pg``, whose
collectives move nothing), the parameters, optimizer state, batches and
caches are meta tensors placed as DTensors by the sharding rules, and
``analysis.roofline.count_step`` counts what rank 0 runs: FLOPs, bytes,
collective bytes and the peak of live bytes.  Results land in
experiments/dryrun_torch/<arch>__<shape>__<mesh>.json and the aggregate
table of an untagged ``--all`` sweep in experiments/roofline_torch.json.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import torch

from ..analysis import roofline as rl
from ..configs import get_config
from ..configs.base import INPUT_SHAPES
from ..configs.registry import ASSIGNED, SKIPS
from ..sharding.ctx import activation_mesh, set_seq_sharding, whole_mesh_strategies
from .mesh import make_production_mesh
from .specs import build_program, place

MESH_RANKS = {"single": 256, "multi": 512}


def fake_group(world_size: int) -> None:
    """This process as rank 0 of a fake process group of ``world_size``
    ranks (replacing any group it had)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == world_size and dist.get_backend() == "fake":
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)


def _count(fn, args, shardings, grad: bool):
    from torch.distributed.tensor.experimental import implicit_replication
    placed = place(args, shardings)
    with torch.set_grad_enabled(grad), implicit_replication():
        return rl.count_step(fn, *placed)


def run_one(arch: str, shape_name: str, mesh_name: str, outdir: str, *,
            parts: bool = True, q_chunk: int = 512, overrides: dict | None = None,
            tag: str = "") -> rl.Report:
    cfg = get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    fake_group(MESH_RANKS[mesh_name])
    mesh = make_production_mesh(multi_pod=mesh_name == "multi", device="cpu")
    chips = mesh.size()
    rep = rl.Report(arch=arch, shape=shape_name, mesh=mesh_name, chips=chips, ok=False)
    if (arch, shape_name) in SKIPS:
        rep.error = "SKIP: " + SKIPS[(arch, shape_name)]
        return rep
    overrides = overrides or {}
    try:
        prog = build_program(cfg, shape, mesh, q_chunk=q_chunk, overrides=overrides)
        rep.model_flops = prog.model_flops
        set_seq_sharding(bool(overrides.get("seq_shard_acts")))
        t0 = time.time()
        with activation_mesh(mesh), whole_mesh_strategies():
            d = _count(prog.fn, prog.args, prog.in_shardings, prog.grad)
            rep.compile_seconds = time.time() - t0
            rep.peak_bytes_per_device = d["peak_bytes"]
            rep.arg_bytes_per_device = d["arg_bytes"]
            rep.full_collectives = {k: v["operand_bytes"] for k, v in d["coll_detail"].items()}
            rep.kernels = d["kernels"]
            if parts:
                costs = []
                for name, mult, fn, args, shardings in prog.parts:
                    c = _count(fn, args, shardings, prog.grad)
                    costs.append(rl.PartCost(
                        name=name, multiplier=mult, flops=c["flops"],
                        bytes_accessed=c["bytes_accessed"],
                        coll_operand_bytes=c["coll_operand_bytes"],
                        coll_detail={k: v["operand_bytes"] for k, v in c["coll_detail"].items()}))
                rl.assemble(rep, costs)
            else:
                rep.flops_per_device = d["flops"]
                rep.bytes_per_device = d["bytes_accessed"]
                rep.coll_bytes_per_device = d["coll_operand_bytes"]
        rep.ok = True
    except Exception as e:  # noqa: BLE001 - report, don't crash the sweep
        rep.error = f"{type(e).__name__}: {e}"
        rep.parts = []
        traceback.print_exc()
    finally:
        set_seq_sharding(False)
    if outdir:
        os.makedirs(outdir, exist_ok=True)
        suffix = f"__{tag}" if tag else ""
        path = os.path.join(outdir, f"{arch}__{shape_name}__{mesh_name}{suffix}.json")
        with open(path, "w") as f:
            json.dump({**rep.summary(), "parts": rep.parts, "kernels": rep.kernels,
                       "full_collectives": rep.full_collectives}, f, indent=1)
    return rep


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Count the roofline terms of each (architecture x shape x mesh) "
                    "program on the meta device: no GPU is used, the process stands "
                    "for rank 0 of a fake 256- or 512-rank process group.")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--outdir", default="experiments/dryrun_torch")
    ap.add_argument("--no-parts", action="store_true",
                    help="skip per-layer roofline assembly (faster)")
    ap.add_argument("--override", nargs="*", default=[],
                    help="hillclimb knobs, e.g. no_fsdp=1 q_chunk=2048")
    ap.add_argument("--tag", default="", help="output filename suffix")
    args = ap.parse_args(argv)
    overrides = {}
    for kv in args.override:
        k, v = kv.split("=", 1)
        overrides[k] = float(v) if "." in v else int(v)

    archs = ASSIGNED if args.all or args.arch is None else [args.arch]
    shapes = list(INPUT_SHAPES) if args.all or args.shape is None else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    rows, ok = [], True
    for mesh_name in meshes:
        for arch in archs:
            for shape in shapes:
                t0 = time.time()
                rep = run_one(arch, shape, mesh_name, args.outdir,
                              parts=not args.no_parts, overrides=overrides, tag=args.tag)
                status = "OK " if rep.ok else ("SKIP" if rep.error.startswith("SKIP") else "FAIL")
                ok = ok and status != "FAIL"
                print(
                    f"[{status}] {arch:22s} {shape:12s} {mesh_name:6s} "
                    f"count={rep.compile_seconds:6.1f}s "
                    f"peak={rep.peak_bytes_per_device/2**30:7.2f}GiB "
                    f"dom={rep.dominant if rep.ok else '-':10s} "
                    f"wall={time.time()-t0:6.1f}s {rep.error[:80]}",
                    flush=True,
                )
                print(json.dumps({**rep.summary(), "kernels": rep.kernels}), flush=True)
                rows.append(rep.summary())
    if args.all and not args.tag:
        # only a full untagged sweep owns the aggregate table
        with open(os.path.join(args.outdir, "..", "roofline_torch.json"), "w") as f:
            json.dump(rows, f, indent=1)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())

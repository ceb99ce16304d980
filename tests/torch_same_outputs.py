"""Whether two checkouts' PyTorch packages give the same outputs without
a mesh, bit for bit, on the CPU.

    PYTHONPATH=src python tests/torch_same_outputs.py OLD_SRC NEW_SRC

Each checkout's ``repro_torch`` runs in a subprocess of its own (``--dump
SRC FILE``).  For one smoke config per family it trains one step from
the seed's weights (loss, grad_norm and every updated parameter) and,
for the families that serve, serves two streams of 24 frames at 112^2
(GOP 4, the launcher's) in codecflow through the lockstep engine (every
window's yes/no logits).  Prints one line per case and exits non-zero if any output
differs.  A change to model code that should leave the meshless paths
as they were is checked against its parent's ``src`` (unpacked with
``git archive``).
"""
from __future__ import annotations

import os
import subprocess
import sys
import tempfile

TRAIN = ("deepseek-7b-smoke", "olmoe-1b-7b-smoke", "mamba2-2.7b-smoke",
         "jamba-v0.1-52b-smoke", "internvl3-14b-smoke", "whisper-large-v3-smoke")
SERVE = ("deepseek-7b-smoke", "olmoe-1b-7b-smoke", "mamba2-2.7b-smoke",
         "jamba-v0.1-52b-smoke", "internvl3-14b-smoke")


def dump(path: str) -> None:
    """This process's ``repro_torch`` outputs, saved to ``path``."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import CodecCfg
    from repro_torch.data.pipeline import anomaly_dataset, lm_batches
    from repro_torch.launch.serve import build_pipeline
    from repro_torch.models.init import init_lm_params, trainable, tree_leaves
    from repro_torch.serving import Scheduler, SchedulerCfg, StreamRequest
    from repro_torch.training.optimizer import OptCfg, init_opt_state
    from repro_torch.training.train_step import make_train_step
    torch.manual_seed(0)
    out = {}
    for arch in TRAIN:
        cfg = get_config(arch)
        ocfg = OptCfg(lr=1e-3, warmup=1, total_steps=4)
        params = trainable(init_lm_params(cfg, 0, "cpu"))
        batch = next(lm_batches(cfg, 2, 16, seed=1, device="cpu",
                                vlm_tokens=4 if cfg.family == "vlm" else 0))
        params, _, m = make_train_step(cfg, ocfg, q_chunk=8)(
            params, init_opt_state(params, ocfg), batch)
        out[f"train {arch}"] = [m["loss"].detach(), m["grad_norm"].detach()] + [
            t.detach().clone() for t in tree_leaves(params)]
    for arch in SERVE:
        pipe = build_pipeline(arch, "codecflow", CodecCfg(gop=4), seed=0, device="cpu")
        sched = Scheduler(pipe, SchedulerCfg(max_concurrent=2, pipelined=False))
        videos = anomaly_dataset(2, 24, 112, 112, seed=0)
        sids = [sched.submit(StreamRequest(i, np.asarray(f), tag=lab))
                for i, (f, lab) in enumerate(videos)]
        for _ in sched.events():
            pass
        out[f"serve {arch}"] = [torch.tensor([r.stats.logits_yes_no for r in
                                              sched.session(s).results]) for s in sids]
    torch.save(out, path)


def outputs(src: str, path: str) -> dict:
    import torch
    env = dict(os.environ, PYTHONPATH=os.path.abspath(src))
    subprocess.run([sys.executable, os.path.abspath(__file__), "--dump", src, path],
                   env=env, check=True, timeout=1800)
    return torch.load(path)


def main(argv) -> int:
    if argv[0] == "--dump":
        dump(argv[2])
        return 0
    import torch
    with tempfile.TemporaryDirectory() as tmp:
        old = outputs(argv[0], os.path.join(tmp, "old.pt"))
        new = outputs(argv[1], os.path.join(tmp, "new.pt"))
    same = True
    for case in old:
        a, b = old[case], new.get(case, [])
        here = len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))
        print(f"{case}: {len(a)} tensors, {'bitwise equal' if here else 'DIFFERENT'}")
        same = same and here
    return 0 if same and set(old) == set(new) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

"""Render the PyTorch port's roofline table from its dry-run results as
markdown (``examples/roofline_report.py``'s table, from the port's file).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh single
    python examples/torch_roofline_report.py [experiments/roofline_torch.json]

The terms are seconds per step on NVIDIA H100s (``repro_torch.analysis
.roofline``'s constants); MODEL/HLO is the model FLOPs over the counted
ones.
"""
import json
import os
import sys

PATH = sys.argv[1] if len(sys.argv) > 1 else "experiments/roofline_torch.json"

if not os.path.exists(PATH):
    raise SystemExit(f"{PATH} missing — run repro_torch.launch.dryrun --all first")

rows = json.load(open(PATH))
hdr = ("| arch | shape | mesh | peak GiB/dev | t_compute | t_memory "
       "| t_collective | dominant | MODEL/HLO |")
print(hdr)
print("|" + "---|" * 9)
for r in rows:
    if not r["ok"]:
        print(f"| {r['arch']} | {r['shape']} | {r['mesh']} | — | — | — | — "
              f"| {r['error'][:40]} | — |")
        continue
    print(
        f"| {r['arch']} | {r['shape']} | {r['mesh']} "
        f"| {r['peak_GiB_per_device']:.2f} "
        f"| {r['t_compute_s']:.2e} | {r['t_memory_s']:.2e} "
        f"| {r['t_collective_s']:.2e} | **{r['dominant']}** "
        f"| {r['useful_ratio']:.2f} |"
    )

"""The port's three examples run on the CPU with their smallest flags:
exit 0 and the lines their JAX twins print (``examples/quickstart.py``,
``streaming_analytics.py``, ``train_anomaly_vlm.py``).  Each runs as a
subprocess with the examples' own ``--device cpu``; this file imports
neither JAX nor the JAX package."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
from torch_threads import torch_one_thread  # noqa: E402,F401

ROOT = Path(__file__).resolve().parents[1]

EXAMPLES = {
    "torch_quickstart.py": ((), [
        r"^stream: \(16, 112, 112\), anomaly frames: 8$",
        r"^motion vectors: \(16, 7, 7, 2\), mean \|v\| on P-frames: \d+\.\d\d px$",
        r"^pruning: \{'kept_tokens': \d+, 'total_tokens': 256, ",
        r"^window: answer=(Yes|No) tokens=\d+/\d+ refreshed=\d+ GFLOP=\d+\.\d{3}$",
    ]),
    "torch_streaming_analytics.py": (("--streams", "2", "--frames", "16"), [
        r"^  cam-[01]: done after 3 windows$",
        r"^mode=codecflow arch=internvl3-14b-smoke$",
        r"^streams=2 windows=6 wall=\d+\.\ds \(\d+\.\d\d windows/s aggregate\)$",
        r"^window latency p50=\d+\.\d{3}s p99=\d+\.\d{3}s  ttft p50=\d+\.\d{3}s$",
        r"^decisions=\[[01], [01]\] truths=\[[01], [01]\]  P=\d\.\d\d R=\d\.\d\d F1=\d\.\d\d$",
        r"^total GFLOP=\d+\.\d\d$",
    ]),
    "torch_train_anomaly_vlm.py": (("--steps", "3", "--videos", "2"), [
        r"^training tiny VLM \(0\.\dM params\) for 3 steps on synthetic anomaly streams\.\.\.$",
        r"^  anomaly-train step    [02] nll \d+\.\d{4} acc \d\.\d\d$",
        r"^eval fullcomp   F1=\d\.\d\d$",
        r"^eval codecflow  F1=\d\.\d\d$",
    ]),
}


def run_example(name, flags):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="2")
    return subprocess.run([sys.executable, str(ROOT / "examples" / name), *flags,
                           "--device", "cpu"], env=env, capture_output=True, text=True,
                          timeout=300, cwd=ROOT)


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_runs_on_cpu_and_prints_its_lines(name):
    flags, patterns = EXAMPLES[name]
    proc = run_example(name, flags)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    lines = proc.stdout.splitlines()
    for pat in patterns:
        assert any(re.search(pat, ln) for ln in lines), (pat, proc.stdout)
    if name == "torch_quickstart.py":          # every window of the 16-frame stream
        assert sum(bool(re.search(patterns[-1], ln)) for ln in lines) == 3


def test_examples_import_only_torch_numpy_and_the_port():
    for name in EXAMPLES:
        text = (ROOT / "examples" / name).read_text()
        roots = set(re.findall(r"^(?:from|import) ([a-z_]+)", text, re.M))
        assert roots <= {"argparse", "time", "numpy", "torch", "repro_torch"}, (name, roots)

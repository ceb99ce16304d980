"""Where the CPU test run's time goes: thread oversubscription and the
junit's worker-seconds.

    # COPIES concurrent pytest runs of one test, each with torch held at
    # THREADS intra-op threads; prints each run's wall seconds
    PYTHONPATH=src:tests JAX_PLATFORMS=cpu python tests/torch_thread_probe.py \\
        concurrent --copies 6 --threads 8 \\
        "tests/test_torch_hybrid.py::test_hybrid_serves_like_jax[fullcomp]"
    # worker-seconds of a junit file (pytest --junitxml), in all and per
    # test file; with a second file, the two side by side
    python tests/torch_thread_probe.py junit RUN.xml [BASELINE.xml]

The first is the measurement behind ``tests/torch_threads.py``: on an
8-core host, six copies at 8 threads took 836-837 s each, at one thread
42-44 s each.
"""
import argparse
import collections
import subprocess
import sys
import time
import xml.etree.ElementTree as ET

# the run keeps THREADS: torch_threads' fixture cannot change it
_ONE_RUN = """
import sys, time, torch
torch.set_num_threads(int(sys.argv[1]))
torch.set_num_threads = lambda n: None
import pytest
t = time.time()
rc = pytest.main(["-q", "-p", "no:cacheprovider", sys.argv[2]])
print(f"threads {sys.argv[1]}: {time.time() - t:.1f} s, exit {int(rc)}", flush=True)
"""


def concurrent(copies: int, threads: int, test_id: str) -> None:
    t0 = time.time()
    procs = [subprocess.Popen([sys.executable, "-c", _ONE_RUN, str(threads), test_id],
                              stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
             for _ in range(copies)]
    for i, p in enumerate(procs):
        out, _ = p.communicate()
        last = [line for line in out.splitlines() if line.startswith("threads ")]
        print(f"copy {i + 1}: {last[-1] if last else 'no result'}")
    print(f"{copies} copies at {threads} threads: {time.time() - t0:.1f} s of wall")


def worker_seconds(path: str) -> collections.Counter:
    per_file = collections.Counter()
    for case in ET.parse(path).getroot().iter("testcase"):
        per_file[case.get("classname").split(".")[-1]] += float(case.get("time", 0))
    return per_file


def junit(paths) -> None:
    runs = [worker_seconds(p) for p in paths]
    print("total " + " ".join(f"{sum(r.values()):.1f}" for r in runs))
    names = sorted(set().union(*runs), key=lambda k: -runs[-1].get(k, 0.0))
    for name in names:
        print(f"{name:36s} " + " ".join(f"{r.get(name, 0.0):8.1f}" for r in runs))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    c = sub.add_parser("concurrent")
    c.add_argument("--copies", type=int, default=6)
    c.add_argument("--threads", type=int, default=8)
    c.add_argument("test_id")
    j = sub.add_parser("junit")
    j.add_argument("files", nargs="+")
    args = ap.parse_args(argv)
    if args.cmd == "concurrent":
        concurrent(args.copies, args.threads, args.test_id)
    else:
        junit(args.files)


if __name__ == "__main__":
    main()

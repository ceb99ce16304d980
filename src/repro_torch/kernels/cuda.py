"""Build, load and count the port's CUDA kernels.

The sources under ``src/repro_torch/csrc/`` have plain C entry points.
On first use each ``.cu`` file is compiled by its own ``nvcc`` process
(all started together) for ``sm_90a``, the objects are linked into one
shared library under ``build/repro_torch/`` in the checkout (listed in
``.gitignore``), and the library is bound with ``ctypes``.  The library
name carries a hash of the sources and flags, so an edit never loads a
stale build.  Nothing here runs at import: the CPU tests import every
module of the port and never build.

Every wrapper that launches a kernel calls :func:`record_launch` right
after the launch succeeded, and nowhere else; :func:`launch_counts`
reads the counts (``chip_smoke.py`` resets them just before it drives
the serving path and reads them just after).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Optional

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("mv_sad.cu", "rope_shift.cu", "attention.cu", "ssd_scan.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_p, _i, _ll, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SIGNATURES = {
    "cs_mv_sad_f32": (_p, _p, _i, _i, _i, _i, _p, _p, _p),
    "cs_rope_shift": (_p, _p, _p, _ll, _i, _i, _f, _i, _p),
    "cs_attn_refresh_bf16": (
        _p, _p, _p, _p, _p, _p, _p, _p,
        _i, _i, _i, _i, _i, _i, _i, _i, _i, _f, _p,
    ),
    "cs_attn_refresh_paged_bf16": (
        _p, _p, _p, _p, _p, _p, _p, _p, _p,
        _i, _i, _i, _i, _i, _i, _i, _i, _i, _f, _p,
    ),
    "cs_attn_refresh_paged_int8": (
        _p, _p, _p, _p, _p, _p, _p, _p, _p, _p, _p, _p, _p,
        _i, _i, _i, _i, _i, _i, _i, _i, _i, _i, _f, _p,
    ),
    "cs_attn_packed_bf16": (
        _p, _p, _p, _p, _p, _p, _p, _i, _i, _i, _i, _i, _i, _f, _p,
    ),
    "cs_attn_prefill_bf16": (
        _p, _p, _p, _p, _i, _i, _i, _i, _i, _i, _i, _i, _i, _f, _p,
    ),
    "cs_attn_prefill_paged_bf16": (
        _p, _p, _p, _p, _p, _i, _i, _i, _i, _i, _i, _i, _i, _f, _p,
    ),
    "cs_attn_prefill_paged_int8": (
        _p, _p, _p, _p, _p, _p, _p, _p, _p, _i,
        _i, _i, _i, _i, _i, _i, _i, _i, _f, _p,
    ),
    "cs_ssd_scan": (
        _p, _p, _p, _p, _p, _p, _p, _i, _i, _i, _i, _i, _i, _i,
        _ll, _ll, _ll, _ll, _ll, _ll, _p,
    ),
}

# head dims of the attention kernels (csrc/attention.cu's launch switch)
HEAD_DIMS = (24, 32, 64, 128)

_LIB: Optional[ctypes.CDLL] = None
_BUILD_LOG: Dict[str, str] = {}
_LAUNCHES: Counter = Counter()


class KernelError(RuntimeError):
    """A kernel did not build, was refused at launch, or was handed
    operands it does not take."""


class KernelContractError(ValueError):
    """A kernel-op precondition was violated (``ops`` checks them; a
    wrapper raises it for a precondition only its kernel has)."""


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise KernelError("nvcc not found (set CUDA_HOME)")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(p.name for p in CSRC.iterdir()):
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile every source (one nvcc each, in parallel) and link the
    shared library; returns its path.  Reuses an existing build of the
    same sources and flags."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = _digest()
    lib = BUILD_DIR / f"libcodecsight_{tag}.so"
    if lib.exists():
        return lib
    exe = nvcc()

    def compile_one(src: str):
        obj = BUILD_DIR / f"{Path(src).stem}_{tag}.o"
        cmd = [exe, *NVCC_FLAGS, "-c", str(CSRC / src), "-o", str(obj)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        return src, obj, proc

    with ThreadPoolExecutor(max_workers=len(SOURCES)) as pool:
        results = list(pool.map(compile_one, SOURCES))
    for src, _, proc in results:
        _BUILD_LOG[src] = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise KernelError(f"nvcc failed on {src}:\n{proc.stdout}{proc.stderr}")
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [exe, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
           *[str(obj) for _, obj, _ in results], "-o", str(tmp)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise KernelError(f"link failed:\n{proc.stdout}{proc.stderr}")
    tmp.replace(lib)
    return lib


def build_log() -> Dict[str, str]:
    """nvcc output per source of this process's build (``-Xptxas -v``:
    registers, shared memory and spills per kernel); empty when the
    library was already built."""
    return dict(_BUILD_LOG)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def stream_handle(t: torch.Tensor) -> int:
    """The current stream of t's card as a raw handle (no Stream object
    is made: every launch of every layer calls this)."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise KernelError(f"{name}: launch failed with CUDA error {rc}")


def require(cond: bool, name: str, what: str) -> None:
    if not cond:
        raise KernelError(f"{name}: {what}")


def require_aligned(name: str, *tensors: torch.Tensor) -> None:
    """16-byte loads: every operand must start on a 16-byte boundary."""
    for t in tensors:
        require(t.data_ptr() % 16 == 0, name, "operand not 16-byte aligned")


def record_launch(name: str) -> None:
    _LAUNCHES[name] += 1


def launch_counts() -> Dict[str, int]:
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    _LAUNCHES.clear()

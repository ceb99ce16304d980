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
SOURCES = ("mv_sad.cu", "rope_shift.cu", "attention.cu", "attention_any.cu",
           "attention_q32.cu", "attention_f32.cu", "attention_512.cu", "attention_q32_512.cu",
           "attention_deep.cu", "attention_q32_deep.cu", "attention_f16.cu",
           "attention_f16_512.cu", "attention_f16_deep.cu", "attention_q16.cu", "ssd_scan.cu",
           "ssd_scan_staged.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_p, _i, _ll, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SIGNATURES = {
    "cs_mv_sad_f32": (_p, _p, _i, _i, _i, _i, _p, _p, _p),
    "cs_rope_shift": (_p, _p, _p, _ll, _i, _i, _p, _i, _p),
    # the attention entry points: ..., scale, q's type (Q_TYPES), stream
    "cs_attn_refresh_bf16": (
        _p, _p, _p, _p, _p, _p, _p, _p,
        _i, _i, _i, _i, _i, _i, _i, _i, _i, _f, _i, _p,
    ),
    "cs_attn_refresh_paged_bf16": (
        _p, _p, _p, _p, _p, _p, _p, _p, _p,
        _i, _i, _i, _i, _i, _i, _i, _i, _i, _f, _i, _p,
    ),
    "cs_attn_refresh_paged_int8": (
        _p, _p, _p, _p, _p, _p, _p, _p, _p, _p, _p, _p, _p,
        _i, _i, _i, _i, _i, _i, _i, _i, _i, _i, _f, _i, _p,
    ),
    "cs_attn_packed_bf16": (
        _p, _p, _p, _p, _p, _p, _p, _i, _i, _i, _i, _i, _i, _f, _i, _p,
    ),
    "cs_attn_prefill_bf16": (
        _p, _p, _p, _p, _i, _i, _i, _i, _i, _i, _i, _i, _i, _f, _i, _p,
    ),
    "cs_attn_prefill_paged_bf16": (
        _p, _p, _p, _p, _p, _i, _i, _i, _i, _i, _i, _i, _i, _f, _i, _p,
    ),
    "cs_attn_prefill_paged_int8": (
        _p, _p, _p, _p, _p, _p, _p, _p, _p, _i,
        _i, _i, _i, _i, _i, _i, _i, _i, _f, _i, _p,
    ),
    # ..., scale, q's type, scratch, stream
    "cs_attn_packed_f32": (
        _p, _p, _p, _p, _p, _p, _p, _i, _i, _i, _i, _i, _i, _f, _i, _p, _p,
    ),
    "cs_attn_prefill_f32": (
        _p, _p, _p, _p, _i, _i, _i, _i, _i, _i, _i, _i, _i, _f, _i, _p, _p,
    ),
    "cs_ssd_scan": (
        _p, _p, _p, _p, _p, _p, _p, _p, _p, _i, _i, _i, _i, _i, _i, _i,
        _ll, _ll, _ll, _ll, _ll, _ll, _i, _i, _ll, _ll, _i, _i, _p,
    ),
    "cs_ssd_scan_bwd": (
        _p, _p, _p, _p, _p, _p, _p, _p, _p, _p, _p, _p, _p, _p,
        _i, _i, _i, _i, _i, _i, _i, _ll, _ll, _ll, _ll, _ll, _ll, _i, _i, _ll, _ll, _i, _i, _p,
    ),
    "cs_ssd_scan_bwd_occupancy": (_i, _i, _p),
    "cs_ssd_stage": (_p, _i, _ll, _i, _i, _i, _ll, _ll, _ll, _ll, _p, _i, _i, _ll, _p),
    "cs_ssd_scan_bwd_occupancy_staged": (_i, _i, _p),
}
# the scan's staged builds (ssd_scan_staged.cu) share the bf16 ones' signatures
for _name in ("cs_ssd_scan", "cs_ssd_scan_bwd"):
    _SIGNATURES[_name + "_staged"] = _SIGNATURES[_name]

# the attention kernels' entry points over bf16 K/V (csrc/attention.cuh
# CS_ATTN_EXPORTS): each has an exact bf16 build (attention.cu), a ragged
# bf16 one (``_any``: attention_any.cu) and one for an f32 or f16 query
# (``_q32``: attention_q32.cu), and past head dim 256 a bf16 one
# (``_512``: attention_512.cu) and an f32- or f16-query one
# (``_q32_512``: attention_q32_512.cu), all with one signature; past 512
# the DEEP builds (``_deep``: attention_deep.cu, ``_q32_deep``:
# attention_q32_deep.cu) take one more pointer before the stream, the
# query's scratch.  The f16 builds (f16 K/V: attention_f16.cu,
# attention_f16_512.cu, attention_f16_deep.cu) have entry points of their
# own, named by ``f16_entry`` (``_f16`` for ``_bf16``, ``_int8_f16`` for
# ``_int8``), with the same signatures and suffixes (none, ``_512``,
# ``_deep``); the prefill kernels' builds for a bf16 or f32 query over f16
# K/V (attention_q16.cu) add ``_q16`` before the suffix.  Every entry
# point takes q's type (``Q_TYPES``) after the scale; the output is in it.
ATTN_ENTRIES = ("cs_attn_refresh_bf16", "cs_attn_refresh_paged_bf16",
                "cs_attn_refresh_paged_int8", "cs_attn_packed_bf16", "cs_attn_prefill_bf16",
                "cs_attn_prefill_paged_bf16", "cs_attn_prefill_paged_int8")
# the prefill kernels' entry points: their oracle keeps the query exact,
# so a query wider than the products runs on a build that splits it
PREFILL_ENTRIES = ATTN_ENTRIES[4:]
# q's type code (csrc/attention.cuh Q_BF16, Q_F16, Q_F32)
Q_TYPES = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}


def f16_entry(name: str) -> str:
    """The f16 builds' name of attention entry point ``name`` (one of
    ``ATTN_ENTRIES``)."""
    return name[:-5] + "_f16" if name.endswith("_bf16") else name + "_f16"


for _name in ATTN_ENTRIES:
    for _suffix in ("_any", "_q32", "_512", "_q32_512"):
        _SIGNATURES[_name + _suffix] = _SIGNATURES[_name]
    for _suffix in ("_deep", "_q32_deep"):
        _SIGNATURES[_name + _suffix] = _SIGNATURES[_name][:-1] + (_p, _p)
    for _q16 in ("", "_q16") if _name in PREFILL_ENTRIES else ("",):
        for _suffix in ("", "_512"):
            _SIGNATURES[f16_entry(_name) + _q16 + _suffix] = _SIGNATURES[_name]
        _SIGNATURES[f16_entry(_name) + _q16 + "_deep"] = _SIGNATURES[_name][:-1] + (_p, _p)

# head dims of the attention kernels' exact builds (attention.cu, and
# attention_512.cu at 512); every other head dim up to SLAB_HEAD_DIM runs
# on the smallest ragged build that holds it (d 129 to 255 on the D-256
# one, whose blocks own 64 query rows; d 257 to 511 on the D-512 one,
# whose blocks own a 256-column slab of V and O each), and every head dim
# past it on the DEEP build (Q K^T summed over depth chunks of 256
# columns, the chunk count and the slabs of V and O runtime counts), its
# rows copied 16, 8 or 4 bytes at a time, or element by element at an odd
# d, as their alignment allows (csrc/attention.cuh)
HEAD_DIMS = (24, 32, 64, 128, 256, 512)
SLAB_HEAD_DIM = 512

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


def attention_entry(name: str, q: torch.Tensor, k: torch.Tensor, d: int):
    """A launcher of attention entry point ``name`` (one of
    ``ATTN_ENTRIES``, over bf16 or f16 K/V) for K's type, q's and head dim
    ``d``, called with the entry point's arguments but q's type: over bf16
    K/V the exact bf16 build, the ragged one, or for an f32 or f16 q the
    ``_q32`` one; over f16 K/V the f16 one, or in the prefill kernels for
    a bf16 or f32 q the ``_q16`` one (past 256: their D-512 builds).  Past
    512 the DEEP one, which it hands the query's scratch
    (``deep_q_elems``) before the stream.  It passes q's type after the
    scale: the kernel reads q and writes the output in it."""
    wide_q = q.dtype != k.dtype
    if k.dtype == torch.float16:
        name = f16_entry(name) + ("_q16" if wide_q and name in PREFILL_ENTRIES else "")
    elif wide_q:
        name += "_q32"
    suffix = "_deep" if d > SLAB_HEAD_DIM else "_512" if d > 256 else ""
    if not (suffix or wide_q or k.dtype == torch.float16 or d in HEAD_DIMS):
        suffix = "_any"
    fn = getattr(library(), name + suffix)
    qt = Q_TYPES[q.dtype]
    if d > SLAB_HEAD_DIM:
        def launch(*args):
            scratch = torch.empty(deep_q_elems(q, k), dtype=torch.bfloat16, device=q.device)
            return fn(*args[:-1], qt, scratch.data_ptr(), args[-1])
    else:
        def launch(*args):
            return fn(*args[:-1], qt, args[-1])
    return launch


def f32_kv_launch(fn, q: torch.Tensor, k: torch.Tensor, *args) -> int:
    """Call f32-K/V entry point ``fn`` (``cs_attn_packed_f32``,
    ``cs_attn_prefill_f32``) with its arguments up to the scale, q's type,
    and the scratch it splits K and V into (``f32_scratch_elems``)."""
    scratch = torch.empty(f32_scratch_elems(q, k), dtype=torch.bfloat16, device=q.device)
    return fn(*args, Q_TYPES[q.dtype], scratch.data_ptr(), stream_handle(q))


def split_elems(k: torch.Tensor) -> int:
    """Elements of each of the four bf16 arrays an f32 q/k/v kernel
    splits K and V into (``csrc/attention_f32.cu``): k's, rounded up to 8
    so that each array starts on a 16-byte boundary."""
    return -(-k.numel() // 8) * 8


def deep_q_elems(q: torch.Tensor, k: torch.Tensor) -> int:
    """16-bit elements of the query's scratch of the DEEP build (head dims
    past ``SLAB_HEAD_DIM``; ``csrc/attention.cuh`` launch_mma): q's rows
    at its head dim rounded up to 16 (bf16, or f16 over f16 K/V), twice
    where the query may be split (a q of another type than K's, or f32),
    and over f16 K/V then a row factor (f32) per row."""
    d = q.shape[-1]
    rows = q.numel() // d
    if q.dtype == k.dtype != torch.float32:
        return rows * (-(-d // 16) * 16)
    return 2 * rows * (-(-d // 16) * 16) + (2 * rows if k.dtype == torch.float16 else 0)


def f32_scratch_elems(q: torch.Tensor, k: torch.Tensor) -> int:
    """bf16 elements of an f32 q/k/v kernel's scratch: K's and V's halves
    (four arrays of ``split_elems``), and past ``SLAB_HEAD_DIM`` the
    query's two halves after them."""
    return 4 * split_elems(k) + (deep_q_elems(q, k) if q.shape[-1] > SLAB_HEAD_DIM else 0)


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

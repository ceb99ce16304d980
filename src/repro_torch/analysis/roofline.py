"""Three-term roofline of a step on NVIDIA H100s, the JAX package's
``analysis/roofline.py`` with the H100's constants and the counts taken
while the step runs (``count_step``) instead of from XLA's compiled
cost analysis.

    compute    = FLOPs            / (chips * PEAK_FLOPS)
    memory     = bytes accessed   / (chips * HBM_BW)
    collective = collective bytes / (chips * LINK_BW)

Constants, per GPU (this module is the port's one copy of them):

* ``PEAK_FLOPS`` 989.4e12: dense bf16 tensor-core rate of the H100 SXM5
  (NVIDIA H100 data sheet: 1,979 TFLOP/s with 2:4 sparsity, half of it
  dense), at the 700 W power limit;
* ``HBM_BW`` 3.35e12 B/s: its HBM3 (same data sheet);
* ``LINK_BW`` 50e9 B/s: one 400 Gb/s NDR InfiniBand link per GPU.  Both
  production meshes (256 and 512 GPUs) span many 8-GPU nodes, so a
  collective over either axis crosses the node's network links, not
  only NVLink (900 GB/s within a node).

Each part's totals are assembled as the JAX package assembles them:
embed/head (and the optimizer, for train) once, one part per pattern
position multiplied by its repeat count.  Eager counting sees every
layer, so the parts are not needed to count right; they keep a dry run
of a 480 B model to one layer per pattern position.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Any, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from .collectives import CollectiveCounter, collective_kind, nbytes

PEAK_FLOPS = 989.4e12    # bf16 dense / GPU (H100 SXM5)
HBM_BW = 3.35e12         # bytes/s / GPU (HBM3)
LINK_BW = 50e9           # bytes/s / GPU (400 Gb/s NDR)
F32_FLOPS = 67e12        # f32 outside the tensor cores (same data sheet)


@dataclasses.dataclass
class PartCost:
    name: str
    multiplier: int
    flops: float            # per-device, single instance
    bytes_accessed: float
    coll_operand_bytes: float
    coll_detail: Dict[str, Any]


@dataclasses.dataclass
class Report:
    arch: str
    shape: str
    mesh: str
    chips: int
    ok: bool
    error: str = ""
    # the whole program's run
    peak_bytes_per_device: float = 0.0
    arg_bytes_per_device: float = 0.0
    compile_seconds: float = 0.0        # seconds of the counted run (no compile)
    full_collectives: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # assembled per-device totals
    flops_per_device: float = 0.0
    bytes_per_device: float = 0.0
    coll_bytes_per_device: float = 0.0
    parts: list = dataclasses.field(default_factory=list)
    # analytic
    model_flops: float = 0.0
    # kernel ops of the whole program, each by its work formula
    kernels: Dict[str, Any] = dataclasses.field(default_factory=dict)

    # ------------------------------------------------------------------
    @property
    def hlo_flops_global(self) -> float:
        return self.flops_per_device * self.chips

    @property
    def t_compute(self) -> float:
        return self.hlo_flops_global / (self.chips * PEAK_FLOPS)

    @property
    def t_memory(self) -> float:
        return self.bytes_per_device * self.chips / (self.chips * HBM_BW)

    @property
    def t_collective(self) -> float:
        return self.coll_bytes_per_device * self.chips / (self.chips * LINK_BW)

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.t_compute,
            "memory": self.t_memory,
            "collective": self.t_collective,
        }
        return max(terms, key=terms.get)

    @property
    def useful_ratio(self) -> float:
        """MODEL_FLOPS / counted FLOPs.  ``FlopCounterMode``'s formulas
        count matrix products, convolutions and attention only, where
        XLA's count adds elementwise work: the ratio reads higher than
        the JAX package's for the same program."""
        return self.model_flops / self.hlo_flops_global if self.hlo_flops_global else 0.0

    def summary(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips, "ok": self.ok, "error": self.error,
            "peak_GiB_per_device": self.peak_bytes_per_device / 2**30,
            "compile_s": round(self.compile_seconds, 2),
            "HLO_TFLOPs_global": self.hlo_flops_global / 1e12,
            "HLO_GB_global": self.bytes_per_device * self.chips / 1e9,
            "coll_GB_global": self.coll_bytes_per_device * self.chips / 1e9,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "dominant": self.dominant,
            "MODEL_TFLOPs": self.model_flops / 1e12,
            "useful_ratio": round(self.useful_ratio, 4),
        }


# ops that move no bytes: metadata, views, and the collectives' waits
_NO_TRAFFIC = {
    "aten::detach", "aten::empty", "aten::empty_strided", "aten::empty_like",
    "aten::lift_fresh", "aten::_local_scalar_dense", "aten::sym_size",
    "aten::sym_stride", "aten::sym_numel", "aten::sym_storage_offset",
    "aten::is_same_size", "_c10d_functional::wait_tensor",
    "_c10d_functional::_wrap_tensor_autograd",
}


def _tensors(x):
    if torch.is_tensor(x):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)


class _StepCounter(TorchDispatchMode):
    """Counts each aten op a step runs on local (per-device) tensors:
    FLOPs by ``FlopCounterMode``'s formulas (``flop_registry``), bytes
    as each op's tensor inputs read and outputs written once, the
    functional collectives (``collectives.CollectiveCounter``), and the
    bytes of live storage with their peak.  A DTensor op is passed on to
    DTensor (``NotImplemented``), which runs it as local ops this mode
    then sees; the shape propagation DTensor runs on fake tensors is not
    counted.  ``FlopCounterMode`` itself counts a DTensor op once at its
    global shape, which is why its formulas are used here on the local
    ops instead."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.coll = CollectiveCounter()
        self.kernels: Dict[str, Dict[str, float]] = {}
        self.live = 0.0
        self.peak = 0.0
        self._held: Dict[int, Any] = {}
        self._quiet = 0

    # -- live storage -----------------------------------------------------
    def hold(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._held:
            return
        n = st.nbytes()
        self._held[key] = weakref.ref(st, lambda _, k=key, n=n: self._free(k, n))
        self.live += n
        self.peak = max(self.peak, self.live)

    def _free(self, key: int, n: int) -> None:
        if self._held.pop(key, None) is not None:
            self.live -= n

    # -- kernel ops (ops.count_work) ------------------------------------
    def kernel(self, op: str, formula):
        """Count a kernel op by its work formula (``formula()`` -> (flops,
        bytes)); neither the formula's arithmetic nor what the op's body
        runs is counted (the context manager returned)."""
        with _Quiet(self):
            flops, n_bytes = formula()
        k = self.kernels.setdefault(op, {"calls": 0, "flops": 0.0, "bytes": 0.0})
        k["calls"] += 1
        k["flops"] += flops
        k["bytes"] += n_bytes
        if not self._quiet:
            self.flops += flops
            self.bytes += n_bytes
        return _Quiet(self)

    # ------------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        ins = list(_tensors((args, kwargs)))
        if any(isinstance(t, FakeTensor) for t in ins):
            return out
        outs = list(_tensors(out))
        for t in outs:
            if not isinstance(t, FakeTensor):
                self.hold(t)
        if self._quiet:
            return out
        kind = collective_kind(func)
        if kind is not None:
            self.coll.record(kind, args[0], out)
            return out
        name = func._schema.name
        if func.is_view or name in _NO_TRAFFIC:
            return out
        packet = func._overloadpacket
        if packet in flop_registry:
            # mm / bmm with an f32 output (``.dtype``): the formula takes
            # the operands alone
            fargs = args[:2] if func._overloadname == "dtype" else args
            self.flops += flop_registry[packet](*fargs, **kwargs, out_val=out)
        self.bytes += sum(nbytes(t) for t in ins) + sum(nbytes(t) for t in outs)
        return out


class _Quiet:
    def __init__(self, counter: _StepCounter):
        self.counter = counter

    def __enter__(self):
        self.counter._quiet += 1

    def __exit__(self, *exc):
        self.counter._quiet -= 1


def count_step(fn, *args) -> Dict[str, Any]:
    """Run ``fn(*args)`` once and count it per device: ``flops`` (the
    matrix products, convolutions and attention of ``FlopCounterMode``'s
    formulas, plus each kernel op's work formula), ``bytes_accessed``
    (every aten op's inputs and outputs once: unfused traffic, an upper
    bound of XLA's fused count; kernel ops by their formula, views and
    metadata none), ``coll_operand_bytes`` and ``coll_detail`` (the
    functional collectives), ``peak_bytes`` (the arguments' local bytes
    plus the most the run held live at once), ``kernels`` (each kernel
    op's calls and work) and ``out`` (what ``fn`` returned).  DTensor
    arguments count their local shards."""
    from ..kernels import ops
    from torch.distributed.tensor import DTensor
    counter = _StepCounter()
    arg_bytes = 0.0
    for t in _tensors(args):
        st = (t.to_local() if isinstance(t, DTensor) else t).untyped_storage()
        if id(st) not in counter._held:         # held by the caller throughout
            counter._held[id(st)] = st
            arg_bytes += st.nbytes()
    with ops.count_work(counter), counter:
        out = fn(*args)
    return {
        "flops": float(counter.flops),
        "bytes_accessed": float(counter.bytes),
        "coll_operand_bytes": float(counter.coll.total_collective_bytes()),
        "coll_detail": counter.coll.collective_bytes(),
        "peak_bytes": arg_bytes + counter.peak,
        "arg_bytes": arg_bytes,
        "kernels": counter.kernels,
        "out": out,
    }


def assemble(report: Report, parts: list) -> Report:
    report.parts = [dataclasses.asdict(p) for p in parts]
    report.flops_per_device = sum(p.flops * p.multiplier for p in parts)
    report.bytes_per_device = sum(p.bytes_accessed * p.multiplier for p in parts)
    report.coll_bytes_per_device = sum(
        p.coll_operand_bytes * p.multiplier for p in parts
    )
    return report

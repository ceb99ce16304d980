"""The port's roofline, collective counter and dry run
(``repro_torch.analysis``, ``launch.specs``, ``launch.dryrun``) against
the JAX package's (``tests/test_analysis.py``, ``tests/test_sharding.py``).

* Roofline math: ``tests/test_analysis.py``'s cases through both
  packages' ``Report``, the port's inputs rescaled by the ratio of the
  two chips' constants (H100 989.4 TFLOP/s, 3.35 TB/s, 50 GB/s against
  TPU v5e 197 TFLOP/s, 819 GB/s, 50 GB/s), so each term is the same
  number of seconds.
* Collectives: the same all-gather and all-reduce as
  ``test_collective_parser``'s HLO text, issued by DTensor on a fake
  16-way axis, give the JAX parser's byte counts.
* ``_model_flops`` equal to JAX's for every (config, shape).
* The dry run of deepseek-7b-smoke's train step on a fake 2x2 mesh.
"""
import json
import os
import runpy
import subprocess
import sys

import pytest
import torch
import torch.distributed as dist
from torch.utils.flop_counter import FlopCounterMode
from torch_threads import torch_one_thread  # noqa: E402,F401

from repro.analysis import hlo as jhlo
from repro.analysis import roofline as jrl
from repro.configs import INPUT_SHAPES as JSHAPES
from repro.configs import get_config as jax_config
from repro.configs import shape_plan as jshape_plan
from repro.launch import specs as jspecs
from repro_torch.analysis import roofline as rl
from repro_torch.configs import get_config
from repro_torch.configs.base import INPUT_SHAPES, ShapeCfg
from repro_torch.configs.registry import all_configs
from repro_torch.kernels import ops
from repro_torch.launch import dryrun, specs
from repro_torch.launch.mesh import make_mesh
from repro_torch.sharding.ctx import activation_mesh, whole_mesh_strategies

HERE = os.path.dirname(os.path.abspath(__file__))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: these tests run many small ops (DTensor's
    dispatch, meta tensors), which other workers' thread pools would
    otherwise preempt."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)
SCALE = {"flops": rl.PEAK_FLOPS / jrl.PEAK_FLOPS, "bytes": rl.HBM_BW / jrl.HBM_BW,
         "coll": rl.LINK_BW / jrl.LINK_BW}


def _both(chips, flops, n_bytes, coll, model_flops=0.0):
    j = jrl.Report(arch="a", shape="s", mesh="single", chips=chips, ok=True)
    j.flops_per_device, j.bytes_per_device, j.coll_bytes_per_device = flops, n_bytes, coll
    j.model_flops = model_flops
    p = rl.Report(arch="a", shape="s", mesh="single", chips=chips, ok=True)
    p.flops_per_device = flops * SCALE["flops"]
    p.bytes_per_device = n_bytes * SCALE["bytes"]
    p.coll_bytes_per_device = coll * SCALE["coll"]
    p.model_flops = model_flops * SCALE["flops"]
    return j, p


def test_report_terms_and_dominance():
    j, p = _both(256, 197e12, 819e9 * 2, 50e9 * 0.5)   # 1 s, 2 s, 0.5 s
    for term in ("t_compute", "t_memory", "t_collective"):
        assert getattr(p, term) == pytest.approx(getattr(j, term), rel=1e-12)
    assert abs(p.t_compute - 1.0) < 1e-6 and abs(p.t_memory - 2.0) < 1e-6
    assert abs(p.t_collective - 0.5) < 1e-6
    assert p.dominant == j.dominant == "memory"
    j, p = _both(4, 197e12 * 3, 819e9, 50e9)
    assert p.dominant == j.dominant == "compute"


def test_useful_ratio():
    j, p = _both(2, 100.0, 0.0, 0.0, model_flops=150.0)
    assert abs(p.useful_ratio - 0.75) < 1e-9 and abs(j.useful_ratio - 0.75) < 1e-9
    assert set(p.summary()) == set(j.summary())


def test_assemble_multipliers():
    def parts(mod):
        return [mod.PartCost("embed", 1, flops=10, bytes_accessed=5,
                             coll_operand_bytes=1, coll_detail={}),
                mod.PartCost("layer0", 30, flops=100, bytes_accessed=50,
                             coll_operand_bytes=2, coll_detail={})]
    j = jrl.assemble(jrl.Report("a", "s", "single", 1, True), parts(jrl))
    p = rl.assemble(rl.Report("a", "s", "single", 1, True), parts(rl))
    assert p.flops_per_device == j.flops_per_device == 10 + 30 * 100
    assert p.bytes_per_device == j.bytes_per_device == 5 + 30 * 50
    assert p.coll_bytes_per_device == j.coll_bytes_per_device == 1 + 30 * 2
    assert p.parts == j.parts


@pytest.mark.parametrize("arch", sorted(all_configs()))
def test_model_flops_match_jax(arch):
    for shape, runnable, _ in jshape_plan(arch):
        assert specs._model_flops(get_config(arch), INPUT_SHAPES[shape]) == \
            jspecs._model_flops(jax_config(arch), JSHAPES[shape]), (arch, shape, runnable)


@pytest.fixture
def fake_group():
    """A fake process group of the asked size (collectives move nothing),
    destroyed afterwards: a process has one group at a time."""
    try:
        yield dryrun.fake_group
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_collectives_match_the_hlo_parser(fake_group):
    """test_collective_parser's text: an all-gather of a bf16 [16, 1024]
    shard into [256, 1024] and an all-reduce of f32[128]."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    want = jhlo.collective_bytes("""
  %ag = bf16[256,1024]{1,0} all-gather(bf16[16,1024]{1,0} %x), replica_groups={}
  %ar.1 = f32[128]{0} all-reduce(f32[128]{0} %y), to_apply=%add
""")
    fake_group(16)
    mesh = make_mesh((16,), ("model",), "cpu")
    x = DTensor.from_local(torch.zeros((16, 1024), dtype=torch.bfloat16), mesh, [Shard(0)])
    y = DTensor.from_local(torch.zeros(128), mesh, [Partial()])
    d = rl.count_step(lambda x, y: (x.redistribute(mesh, [Replicate()]),
                                    y.redistribute(mesh, [Replicate()])), x, y)
    for kind in ("all-gather", "all-reduce"):
        for key in ("count", "operand_bytes", "result_bytes"):
            assert d["coll_detail"][kind][key] == want[kind][key], (kind, key)
    assert d["coll_operand_bytes"] == jhlo.total_collective_bytes("""
  %ag = bf16[256,1024]{1,0} all-gather(bf16[16,1024]{1,0} %x), replica_groups={}
  %ar.1 = f32[128]{0} all-reduce(f32[128]{0} %y), to_apply=%add
""") == 16 * 1024 * 2 + 128 * 4


def test_count_step_flops_are_flop_counter_modes():
    from repro_torch.data.pipeline import lm_batches
    from repro_torch.models.init import init_lm_params
    from repro_torch.training.train_step import loss_fn
    cfg = get_config("deepseek-7b-smoke")
    params = init_lm_params(cfg, 0, "cpu")
    batch = next(lm_batches(cfg, 2, 16, device="cpu"))

    @torch.no_grad()
    def f(p, b):
        return loss_fn(cfg, p, b, q_chunk=8, remat=False)[0]

    d = rl.count_step(f, params, batch)
    with FlopCounterMode(display=False) as fc:
        f(params, batch)
    assert d["flops"] == fc.get_total_flops() > 0
    assert d["bytes_accessed"] > d["arg_bytes"] > 0 and d["peak_bytes"] >= d["arg_bytes"]
    assert d["coll_detail"] == {}


def test_kernel_ops_count_their_work_formula():
    """flash_refresh and ssd_scan count their work formulas; the plain
    versions' step-by-step arithmetic is not counted; on the meta device
    they return shapes alone."""
    from repro_torch.kernels.flash_refresh import flash_refresh_work
    from repro_torch.kernels.ssd_scan import ssd_scan_work
    g = torch.Generator().manual_seed(0)
    B, S, H, K, D = 2, 40, 4, 2, 16
    q = torch.randn(B, S, H, D, generator=g)
    k, v = torch.randn(B, S, K, D, generator=g), torch.randn(B, S, K, D, generator=g)
    pos = torch.arange(S, dtype=torch.int32)[None].expand(B, S)
    d = rl.count_step(lambda: ops.flash_refresh(q, k, v, pos, q_chunk=8))
    f, n = flash_refresh_work(q, k, pos)
    assert f == 4.0 * D * H * B * S * (S + 1) // 2
    assert d["flops"] == f and d["bytes_accessed"] == n
    assert d["kernels"]["flash_refresh"]["calls"] == 1
    meta = [t.to("meta") for t in (q, k, v)]
    out = ops.flash_refresh(*meta, pos.to("meta"))
    assert out.device.type == "meta" and out.shape == q.shape
    assert flash_refresh_work(meta[0], meta[1], pos.to("meta")) == (f, n)
    L, P, G, N = 24, 8, 1, 16
    x = torch.randn(B, L, H, P, generator=g).to(torch.bfloat16)
    log_a = -torch.rand(B, L, H, generator=g)
    b = torch.randn(B, L, G, N, generator=g).to(torch.bfloat16)
    d = rl.count_step(lambda: ops.ssd_scan(x, log_a, b, b, chunk=8))
    assert (d["flops"], d["bytes_accessed"]) == ssd_scan_work(L, H, P, G, N, 8, B)
    y, st = ops.ssd_scan(x.to("meta"), log_a.to("meta"), b.to("meta"), b.to("meta"))
    assert y.shape == x.shape and st.shape == (B, H, P, N) and st.dtype == torch.float32


@pytest.mark.parametrize("B,Sq,Sk,causal,window", [
    (2, 40, 40, True, None), (2, 1, 64, True, None), (3, 16, 64, True, 8),
    (2, 16, 64, False, None), (1, 5, 5, True, 3), (2, 1, 64, True, 8)])
def test_refresh_work_on_meta_matches_the_data(B, Sq, Sk, causal, window):
    """The meta device's count (queries at the last Sq positions, every
    key valid) equals the count from those positions' data."""
    from repro_torch.kernels.flash_refresh import flash_refresh_work
    q, k = torch.zeros(B, Sq, 4, 16), torch.zeros(B, Sk, 2, 16)
    pos = torch.arange(Sk - Sq, Sk, dtype=torch.int32)[None].expand(B, Sq)
    assert flash_refresh_work(q.to("meta"), k.to("meta"), causal=causal, window=window) \
        == flash_refresh_work(q, k, pos, causal=causal, window=window)


def test_dryrun_on_a_fake_2x2_mesh(fake_group):
    """deepseek-7b-smoke's train step on a fake 2x2 ("data", "model")
    mesh.  Every product the step counts splits four ways (batch rows
    over 'data'; heads, FFN columns and vocab over 'model'): the
    per-device count is the one-device count over 4 (ratio 1.0 here).
    The rest the 10 % limit allows for is work DTensor would run whole on
    a mesh axis: the LM head's forward product ran whole over 'data'
    (8.5 % of the step) while the embedding lookup left the hidden rows
    split over d_model, before the lookup ran on local shards.  The
    step runs under DTensor's whole-mesh strategies, as the dry run's
    count does (``whole_mesh_strategies``: 1.70x under torch 2.13's
    single-dim expansion).  The parts, multiplied, count what the whole
    program counts."""
    fake_group(4)
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    cfg = get_config("deepseek-7b-smoke")
    prog = specs.build_program(cfg, ShapeCfg("mini_train", 32, 4, "train"), mesh, q_chunk=16)
    with torch.enable_grad():
        one = rl.count_step(prog.fn, *prog.args)
        with activation_mesh(mesh), whole_mesh_strategies():
            whole = dryrun._count(prog.fn, prog.args, prog.in_shardings, True)
            parts = [rl.PartCost(name, mult, flops=c["flops"],
                                 bytes_accessed=c["bytes_accessed"],
                                 coll_operand_bytes=c["coll_operand_bytes"], coll_detail={})
                     for name, mult, fn, args, sh in prog.parts
                     for c in [dryrun._count(fn, args, sh, True)]]
    assert whole["flops"] == pytest.approx(one["flops"] / 4, rel=0.10)
    rep = rl.assemble(rl.Report("a", "s", "fake4", 4, True), parts)
    assert rep.flops_per_device == pytest.approx(whole["flops"], rel=0.02)
    assert whole["coll_operand_bytes"] > 0 and whole["peak_bytes"] > whole["arg_bytes"] > 0
    assert {"all-gather", "reduce-scatter"} <= set(whole["coll_detail"])


def test_dryrun_main_writes_its_report(fake_group, tmp_path, capsys):
    out = tmp_path / "dryrun_torch"
    assert dryrun.main(["--arch", "whisper-large-v3-smoke", "--shape", "decode_32k",
                        "--mesh", "single", "--no-parts", "--outdir", str(out)]) == 0
    rep = json.loads((out / "whisper-large-v3-smoke__decode_32k__single.json").read_text())
    assert rep["ok"] and rep["chips"] == 256 and rep["t_memory_s"] > 0
    assert rep["kernels"]["flash_refresh"]["calls"] == get_config(
        "whisper-large-v3-smoke").n_layers
    line = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")][-1]
    assert json.loads(line)["dominant"] == rep["dominant"]
    skip = dryrun.run_one("whisper-large-v3", "long_500k", "single", "")
    assert not skip.ok and skip.error.startswith("SKIP")


def test_dryrun_microbatches_keep_rows_on_every_data_shard(fake_group, monkeypatch):
    """A train program whose remat budget asks for more microbatches than rows per
    data shard (the reference's count at qwen1.5-110b, mistral-large-123b
    and internvl2-76b train_4k: 32 microbatches of 8 rows over 16 data
    shards) takes at most batch / data_shards of them: DTensor cannot cut
    fewer rows than shards from the sharded batch (the step raised 'unevenly
    sharded' under the CPU's torch and the card's). Here deepseek-7b-smoke
    at batch 16 on a fake 4x2 mesh, a budget that asks for 8 microbatches of
    2 rows over 4 data shards: it takes 4."""
    assert [specs.microbatch_count(w, 256, 16) for w in (1, 3, 4, 18, 32)] == [1, 4, 4, 16, 16]
    assert specs.microbatch_count(3, 30, 16) == 3        # 16 shards do not divide 30 rows
    fake_group(8)
    mesh = make_mesh((4, 2), ("data", "model"), "cpu")
    cfg = get_config("deepseek-7b-smoke")
    B, S = 16, 32
    # the remat budget of B * S / 8 tokens over the 4 data shards
    budget = B * S / 8 * cfg.n_layers * cfg.d_model * 2 / 4
    made = []
    orig = specs.make_train_step

    def recorded(*a, **k):
        made.append(k["microbatch"])
        return orig(*a, **k)
    monkeypatch.setattr(specs, "make_train_step", recorded)
    prog = specs.build_program(cfg, ShapeCfg("mini_train", S, B, "train"), mesh, q_chunk=16,
                               overrides={"micro_budget": budget})
    assert made == [4]
    with activation_mesh(mesh), whole_mesh_strategies():
        got = dryrun._count(prog.fn, prog.args, prog.in_shardings, True)
    assert got["flops"] > 0 and got["peak_bytes"] > 0


class _PartialMeetsSplit(torch.overrides.TorchFunctionMode):
    """Records each add or subtract whose operand with the most split
    mesh dims (the first on a tie), which a linear op's result follows,
    holds partial sums on a mesh dim where another operand is split: the
    split operand would have to become partial, a redistribution
    DTensor lacks (qwen1.5-110b's prefill_32k raised it on the card)."""

    OPS = {torch.add, torch.sub, torch.Tensor.add, torch.Tensor.sub, torch.Tensor.__add__,
           torch.Tensor.__radd__, torch.Tensor.__sub__, torch.Tensor.__rsub__}

    def __init__(self):
        super().__init__()
        self.found = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor, Partial
        ds = [a for a in args if isinstance(a, DTensor)]
        if func in self.OPS and len(ds) > 1:
            lead = max(ds, key=lambda d: sum(p.is_shard() for p in d.placements))
            for i, p in enumerate(lead.placements):
                if isinstance(p, Partial) and any(d.placements[i].is_shard() for d in ds):
                    self.found.append((func.__name__, [tuple(d.placements) for d in ds]))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("arch,shape", [("qwen1.5-110b-smoke", "prefill_32k"),
                                        ("qwen1.5-110b-smoke", "decode_32k")])
def test_dryrun_adds_no_split_operand_to_partial_sums(fake_group, arch, shape):
    """qwen's q/k/v biases are added after the products' partial sums are
    resolved (the constraint to the heads' layout), not to them."""
    mode = _PartialMeetsSplit()
    with mode:
        rep = dryrun.run_one(arch, shape, "single", "", parts=False)
    assert rep.ok, rep.error
    assert mode.found == []


def test_dryrun_ssd_decode_runs_on_local_shards(fake_group, monkeypatch):
    """The SSD decode step runs on local shards under a mesh, as the scan
    does: its einsum over a state split on batch and heads would flatten
    two split dims, which the card's DTensor refused (mamba2-2.7b and
    jamba-v0.1-52b decode_32k)."""
    from repro_torch.models import layers
    seen = []
    orig = layers.ssd_decode_ref

    def recorded(*args):
        seen.append(all(type(a) is torch.Tensor for a in args))
        return orig(*args)
    monkeypatch.setattr(layers, "ssd_decode_ref", recorded)
    rep = dryrun.run_one("mamba2-2.7b-smoke", "decode_32k", "single", "", parts=False)
    assert rep.ok, rep.error
    assert seen and all(seen)


def test_roofline_report_example(tmp_path):
    rows = [dict(arch="a", shape="train_4k", mesh="single", ok=True, error="",
                 peak_GiB_per_device=1.5, t_compute_s=1e-3, t_memory_s=2e-3,
                 t_collective_s=3e-3, dominant="collective", useful_ratio=0.5),
            dict(arch="b", shape="long_500k", mesh="single", ok=False,
                 error="SKIP: no sliding window")]
    path = tmp_path / "roofline_torch.json"
    path.write_text(json.dumps(rows))
    out = subprocess.run([sys.executable, os.path.join(HERE, "..", "examples",
                                                       "torch_roofline_report.py"), str(path)],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0].startswith("| arch | shape | mesh | peak GiB/dev")
    assert "| a | train_4k | single | 1.50 |" in lines[2] and "**collective**" in lines[2]
    assert "SKIP" in lines[3]

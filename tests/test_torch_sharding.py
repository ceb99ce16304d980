"""The port's sharding rules, meshes and sharded train step
(``repro_torch.sharding``, ``launch.mesh``, ``launch.train``) against the
JAX package's (``tests/test_sharding.py``).

* The rules: every registry config's parameter specs at the production
  meshes, (16, 16) ("data", "model") and (2, 16, 16) ("pod", "data",
  "model"), leaf for leaf equal to JAX's ``param_pspecs`` over an
  ``AbstractMesh`` (the JAX rules read only the mesh's shape and axis
  names, so no 256 devices are needed); the meta parameter tree's shapes
  and dtypes equal to JAX's abstract ``init_params``; the KV-cache, SSM
  cache and data specs over a grid of batch, seq_shard, n_kv and d_head.
* ``constrain`` without a mesh is the identity.
* The host mesh: one step of olmoe-1b-7b-smoke on a 1x1 gloo mesh
  (DTensor parameters) equals the meshless step bitwise.
* The sharded step: four gloo ranks on a 2x2 mesh in one subprocess
  (``tests/torch_mesh_ranks.py``; a process group is global to a
  process), deepseek-7b-smoke, olmoe-1b-7b-smoke and mamba2-2.7b-smoke in
  f32: loss and grad_norm within 1e-5 relative, every parameter shard
  within 1e-5 of the meshless result's slice.
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import pytest
import torch
from jax.sharding import AbstractMesh, PartitionSpec
from torch_threads import torch_one_thread  # noqa: E402,F401

from repro.configs import get_config as jax_config
from repro.models import transformer as jtfm
from repro.sharding import rules as jshr
from repro_torch.configs import get_config
from repro_torch.configs.registry import all_configs
from repro_torch.data.pipeline import lm_batches
from repro_torch.launch import train as tlaunch
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.init import (
    init_lm_params, leaf_paths, logical_specs, map_tree, meta_lm_params, trainable,
    tree_leaves,
)
from repro_torch.sharding import ctx as shctx
from repro_torch.sharding import rules as shr
from repro_torch.training.optimizer import OptCfg, init_opt_state
from repro_torch.training.train_step import make_train_step

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
ARCHS = sorted(all_configs()) + sorted(n + "-smoke" for n in all_configs())
MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}


def _port_specs(tree, path=()):
    """(key, leaf) of a port spec or sharding tree in the JAX package's
    key format (``jax.tree_util.keystr`` with '/' between levels); a
    leaf is a spec tuple or a ``NamedSharding``."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _port_specs(tree[k], path + (f"['{k}']",))
    elif isinstance(tree, tuple) and any(isinstance(e, dict) for e in tree):
        for i, v in enumerate(tree):
            yield from _port_specs(v, path + (f"[{i}]",))
    else:
        yield "/".join(path), tree


@pytest.fixture(scope="module")
def jax_trees():
    """Each config's JAX abstract parameters and logical specs, built once."""
    return {a: jtfm.init_params(jax_config(a), jax.random.PRNGKey(0), abstract=True)
            for a in ARCHS}


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_pspecs_match_jax(jax_trees, arch, mesh_name):
    shape, axes = MESHES[mesh_name]
    params, specs = jax_trees[arch]
    jp = jshr.param_pspecs(specs, AbstractMesh(shape, axes))
    flat = jax.tree_util.tree_flatten_with_path(
        jp, is_leaf=lambda x: isinstance(x, PartitionSpec))[0]
    want = {jax.tree_util.keystr(k, separator="/"): tuple(v) for k, v in flat}
    mesh = shr.MeshShape(shape, axes)
    cfg = get_config(arch)
    assert dict(_port_specs(shr.param_pspecs(logical_specs(cfg), mesh))) == want
    # with the divisibility fallback, on the meta tree's shapes
    jsh = jshr.param_shardings(specs, AbstractMesh(shape, axes), params_tree=params)
    flat = jax.tree_util.tree_flatten_with_path(
        jsh, is_leaf=lambda x: hasattr(x, "spec"))[0]
    want = {jax.tree_util.keystr(k, separator="/"): tuple(v.spec) for k, v in flat}
    psh = shr.param_shardings(logical_specs(cfg), mesh, params_tree=meta_lm_params(cfg))
    assert {k: v.spec for k, v in _port_specs(psh)} == want


@pytest.mark.parametrize("arch", ARCHS)
def test_meta_params_match_jax_abstract(jax_trees, arch):
    params, _ = jax_trees[arch]
    want = {jax.tree_util.keystr(k, separator="/"): (tuple(v.shape), str(v.dtype))
            for k, v in jax.tree_util.tree_flatten_with_path(params)[0]}
    got = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
           for k, v in leaf_paths(meta_lm_params(get_config(arch)))}
    assert got == want


BATCHES = (1, 2, 8, 16, 32, 48, 128, 256, 512, 1000)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_cache_and_data_specs_match_jax(mesh_name):
    shape, axes = MESHES[mesh_name]
    am, pm = AbstractMesh(shape, axes), shr.MeshShape(shape, axes)
    for b in BATCHES:
        for rank in (2, 3):
            assert shr.data_spec(pm, b, rank) == tuple(jshr.data_spec(am, b, rank)), (b, rank)
        for n_heads in (0, 8, 24, 32, 80):
            for conv in (0, 100, 5376):
                got = shr.ssm_cache_specs(pm, b, n_heads, conv)
                want = jshr.ssm_cache_specs(am, b, n_heads, conv)
                assert got == tuple(tuple(w) for w in want), (b, n_heads, conv)
        for seq_shard in (False, True):
            for n_kv in (0, 1, 8, 16, 32):
                for d_head in (0, 64, 100, 128):
                    got = shr.kv_cache_spec(pm, b, seq_shard=seq_shard, n_kv=n_kv,
                                            d_head=d_head)
                    want = jshr.kv_cache_spec(am, b, seq_shard=seq_shard, n_kv=n_kv,
                                              d_head=d_head)
                    assert got == tuple(want), (b, seq_shard, n_kv, d_head)


def test_default_rules_and_divisibility_fallback():
    single, multi = shr.MeshShape(*MESHES["single"]), shr.MeshShape(*MESHES["multi"])
    assert shr.default_rules(single)["embed"] == "data"
    assert shr.default_rules(multi)["embed"] == ("pod", "data")
    # mamba2's 50280 vocab does not divide the 16-way model axis
    assert shr.logical_to_pspec(("vocab", "embed"), shr.default_rules(single),
                                (50280, 2560), single) == (None, "data")
    assert shr.logical_to_pspec(("vocab", "embed"), shr.default_rules(single),
                                (50288, 2560), single) == ("model", "data")


def test_to_placements_follow_mesh_order():
    from torch.distributed.tensor import Replicate, Shard
    multi = shr.MeshShape(*MESHES["multi"])
    assert shr.to_placements((("pod", "data"), None, "model"), multi) == (
        Shard(0), Shard(0), Shard(2))
    assert shr.to_placements((None, None), multi) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="pod"):
        shr.to_placements(("pod",), shr.MeshShape(*MESHES["single"]))


def test_constrain_noop_without_mesh():
    x = torch.ones((4, 8))
    assert shctx.get_mesh() is None
    assert shctx.constrain(x, "batch", "model") is x
    assert shctx.local(len, None, None, None) is len


def test_whole_mesh_strategies_are_scoped():
    """Inside, no op keeps a single-dim strategy beside its whole-mesh
    one; on exit DTensor's tables are as they were (a torch without
    single-dim strategies has nothing to drop)."""
    from torch.distributed.tensor import DTensor
    prop = DTensor._op_dispatcher.sharding_propagator
    single = getattr(prop, "op_single_dim_strategy_funcs", {})
    before = dict(single)
    with shctx.whole_mesh_strategies():
        assert not [op for op in single if op in prop.op_strategy_funcs]
    assert single == before


def test_meshless_serving_never_imports_dtensor():
    """Serving jamba-v0.1-52b-smoke without a mesh (attention over
    per-stream caches, the SSD scan and the MoE, each a local region
    under a mesh) leaves torch.distributed.tensor unimported, as before
    the cut points were added: without a mesh each costs a type check.
    (Training imports it through torch itself: autograd's checkpoint
    loads torch._dynamo, which loads FSDP.)  In a subprocess on one
    thread, since other tests of a worker import it."""
    code = ("import sys, torch\n"
            "torch.set_num_threads(1)\n"
            "from repro_torch.launch import serve\n"
            "serve.main(['--device', 'cpu', '--arch', 'jamba-v0.1-52b-smoke', '--streams', '1',"
            " '--videos', '1', '--frames', '20', '--lockstep'])\n"
            "print('dtensor imported:', 'torch.distributed.tensor' in sys.modules)\n")
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [os.path.join(HERE, "..", "src")] + sys.path))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    assert out.stdout.splitlines()[-1] == "dtensor imported: False", out.stdout[-2000:]


def test_production_mesh_needs_its_world_size():
    with pytest.raises(ValueError, match="256"):
        tlaunch.train("deepseek-7b-smoke", 1, 2, 8, mesh_kind="single", device="cpu")
    with pytest.raises(ValueError, match="512"):
        tlaunch.train("deepseek-7b-smoke", 1, 2, 8, mesh_kind="multi", device="cpu")


@pytest.fixture
def host_mesh():
    import torch.distributed as dist
    mesh = make_host_mesh("cpu")
    try:
        yield mesh
    finally:
        dist.destroy_process_group()


def test_host_mesh_step_is_bitwise_meshless(host_mesh):
    """One olmoe-1b-7b-smoke step with DTensor parameters on a 1x1 gloo
    mesh gives the meshless step's loss, grad_norm and parameters bit
    for bit (the MoE routing, dispatch and combine run in local
    regions, the same ops on the same tensors)."""
    cfg = get_config("olmoe-1b-7b-smoke")
    params = init_lm_params(cfg, 1, "cpu")
    batch = next(lm_batches(cfg, 2, 16, seed=2, device="cpu"))
    ocfg = OptCfg(lr=1e-3, warmup=1, total_steps=4)
    ref = trainable(map_tree(lambda t: t.clone(), params))
    ref, _, m = make_train_step(cfg, ocfg, q_chunk=8)(ref, init_opt_state(ref, ocfg), batch)
    sharded, _, [got] = tlaunch.train_on_mesh(
        cfg, host_mesh, ocfg, params, iter([batch]), 1, q_chunk=8)
    assert float(got["loss"]) == float(m["loss"])
    assert float(got["grad_norm"]) == float(m["grad_norm"])
    for a, b in zip(tree_leaves(ref), tree_leaves(sharded)):
        assert torch.equal(a.detach(), b.full_tensor().detach())


def test_sharded_step_matches_meshless(tmp_path):
    """Four gloo ranks on a 2x2 ("data", "model") mesh, the default
    AdamW.  The limits are f32 summation order: the ranks sum partial
    products, gradients and norms in another order.  Every gradient
    shard (the first moment) is held within 1e-5 of its leaf's largest
    gradient; every parameter shard within 1e-5 where its gradient lies
    above that limit (tests/torch_mesh_ranks.py's FLOOR).  Below it
    Adam's first step, lr * g / (|g| + eps), is decided by the noise:
    1.9e-5 at deepseek-7b-smoke's worst such weight, where the gradients
    differ by 1.5e-6 of their leaf's largest."""
    archs = ("deepseek-7b-smoke", "olmoe-1b-7b-smoke", "mamba2-2.7b-smoke")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(HERE, "..", "src")] + sys.path))
    out = subprocess.run(
        [sys.executable, os.path.join(HERE, "torch_mesh_ranks.py"),
         str(tmp_path / "store"), *archs],
        capture_output=True, text=True, env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    rows = [json.loads(ln) for ln in out.stdout.splitlines() if ln.startswith("{")]
    assert [r["arch"] for r in rows] == list(archs)
    for r in rows:
        assert abs(r["loss_mesh"] - r["loss"]) <= 1e-5 * abs(r["loss"]), r
        assert abs(r["gnorm_mesh"] - r["gnorm"]) <= 1e-5 * abs(r["gnorm"]), r
        assert r["grad_gap"] <= 1e-5, r
        assert r["param_gap"] <= 1e-5, r

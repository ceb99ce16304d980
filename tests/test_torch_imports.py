"""Import hygiene of the port: it imports ``torch`` and numpy, never JAX
and nothing of the JAX package (``repro``), and its CUDA build stays out
of module import."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
from torch_threads import torch_one_thread  # noqa: E402,F401

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0], node.lineno


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [(m, ln) for m, ln in _imported_roots(path) if m in FORBIDDEN]
    assert not bad, f"{path}: {bad}"


def test_importing_the_port_loads_no_jax():
    pytest.importorskip("torch")
    code = ("import sys, repro_torch.launch.serve, repro_torch.kernels.ops; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')); print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_each_kernel_module_imports_first():
    """Every ``repro_torch.kernels`` module imports in an interpreter where
    no other module of the port was imported before it (no import cycle
    reads a half-built module)."""
    names = sorted(p.stem for p in (PORT / "kernels").glob("*.py") if p.stem != "__init__")
    code = ("import importlib, sys, torch\n"
            f"for name in {names!r}:\n"
            "    for m in [m for m in sys.modules if m.split('.')[0] == 'repro_torch']:\n"
            "        del sys.modules[m]\n"
            "    importlib.import_module('repro_torch.kernels.' + name)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]


# the port's test modules that need not run torch on one intra-op thread:
# the card's tests run alone (``-m gpu``), beside no other xdist worker
ONE_THREAD_EXEMPT = {"test_torch_gpu.py"}


def test_every_port_test_module_runs_torch_on_one_thread():
    """Each ``tests/test_torch_*.py`` imports ``torch_threads``'s module
    fixture: without it every xdist worker starts a torch thread per core
    and the workers stall each other (``tests/torch_threads.py``)."""
    missing = []
    for path in sorted((ROOT / "tests").glob("test_torch_*.py")):
        tree = ast.parse(path.read_text(), filename=str(path))
        imported = any(isinstance(n, ast.ImportFrom) and n.module == "torch_threads"
                       and any(a.name == "torch_one_thread" for a in n.names)
                       for n in tree.body)
        if not imported and path.name not in ONE_THREAD_EXEMPT:
            missing.append(path.name)
    assert missing == [], f"import torch_threads.torch_one_thread in {missing}"


def test_port_lints_clean():
    sys.path.insert(0, str(ROOT))
    try:
        from tools.check import lints
    finally:
        sys.path.remove(str(ROOT))
    findings = lints.lint_paths([str(PORT), str(ROOT / "chip_smoke.py")])
    assert findings == [], "\n".join(f.render() for f in findings)


def _unused_imports(tree: ast.Module):
    """Names bound by imports and never used (pyflakes F401, roughly)."""
    bound = {}
    for node in ast.walk(tree):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            for alias in node.names:
                name = alias.asname or alias.name.split(".")[0]
                if name != "annotations":
                    bound[name] = node.lineno
    used = {n.id for n in ast.walk(tree) if isinstance(n, ast.Name)}
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and any(
                isinstance(tg, ast.Name) and tg.id == "__all__" for tg in node.targets):
            used |= {e.value for e in node.value.elts if isinstance(e, ast.Constant)}
    return sorted((n, ln) for n, ln in bound.items() if n not in used)


def _unused_locals(tree: ast.Module):
    """Plain ``name = ...`` locals never read in their function (F841)."""
    out = []
    for fn in ast.walk(tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        stored = {}
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign):
                for tg in node.targets:
                    if isinstance(tg, ast.Name):
                        stored.setdefault(tg.id, node.lineno)
        loaded = {n.id for n in ast.walk(fn) if isinstance(n, ast.Name)
                  and isinstance(n.ctx, ast.Load)}
        loaded |= {name for n in ast.walk(fn) if isinstance(n, (ast.Global, ast.Nonlocal))
                   for name in n.names}
        out += [(n, ln) for n, ln in stored.items() if n not in loaded and n != "_"]
    return sorted(out)


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_unused_imports_or_locals(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    unused = [] if path.name == "__init__.py" else _unused_imports(tree)
    assert not unused, f"{path}: unused imports {unused}"
    assert not _unused_locals(tree), f"{path}: unused locals {_unused_locals(tree)}"

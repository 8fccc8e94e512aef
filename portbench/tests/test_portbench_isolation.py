"""Nothing the benchmark runs holds JAX or the JAX package; the reference holds nothing of the port."""

import ast
import subprocess
import sys
import types

import pytest

from portbench import bench
from portbench.bench import PKG, REPO


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("name,bad", [("jax", True), ("jax.numpy", True), ("jaxlib", True), ("flax.linen", True),
                                      ("vfi_tpu", True), ("vfi_tpu.ops.sepconv", True), ("vfi_tpu_torch", False),
                                      ("vfi_tpu_torch.api", False), ("jaxtyping", False)])
def test_top_level_names_compared_whole(monkeypatch, name, bad):
    for mod in list(sys.modules):
        if mod.split(".")[0] in bench.FORBIDDEN:
            monkeypatch.delitem(sys.modules, mod)
    monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert (name in bench.forbidden_modules()) == bad
    if bad:
        with pytest.raises(bench.IsolationError):
            bench.check_isolation()


def test_sources_import_neither_jax_nor_the_jax_package():
    for path in PKG.rglob("*.py"):
        for mod in _imports(path):
            assert mod.split(".")[0] not in bench.FORBIDDEN, (path, mod)


def test_reference_imports_nothing_of_the_port():
    for path in (PKG / "reference").rglob("*.py"):
        for mod in _imports(path):
            assert mod.split(".")[0] not in ("vfi_tpu_torch", "vfi_tpu"), (path, mod)


def test_a_run_loads_no_forbidden_module(tmp_path):
    """A whole tiny run of each entry on the CPU, in a fresh process, then the check."""
    code = f"""
import sys, torch
sys.path.insert(0, {str(REPO)!r})
from portbench import bench
from portbench.tests import tiny
root = tiny.make(__import__('pathlib').Path({str(tmp_path)!r}))
for w in ("tai_gray.serve_int8_b64", "tai_gray.train_sampled_b32"):
    cell = bench.load_cell(w, root)
    bench.entry(cell).run(cell, 3, 1, False, torch.device("cpu"), check_only=True)
print(bench.forbidden_modules())
"""
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600, cwd=tmp_path)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "[]"

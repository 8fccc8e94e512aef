"""The port stands alone: no module under vfi_tpu_torch/, and not
chip_smoke.py, imports JAX, flax, optax, orbax or vfi_tpu (the card's
machine has none of them).  Read from the source's syntax tree, so imports
inside functions count too."""

import ast
import os

import pytest

from . import torch_threads  # noqa: F401  (one torch thread per xdist worker)

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "vfi_tpu")


def _port_sources():
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(REPO, "vfi_tpu_torch")):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(paths)


def _imported(tree):
    """Top-level package of every absolute import in a module's syntax tree."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", None)) in (
                "import_module", "__import__") and node.args and isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


def test_the_scan_sees_the_port():
    names = {os.path.relpath(p, REPO) for p in _port_sources()}
    assert {"chip_smoke.py", "vfi_tpu_torch/cli/predict.py", "vfi_tpu_torch/data/datasets.py",
            "vfi_tpu_torch/ops/warp.py", "vfi_tpu_torch/nn/vgg.py", "vfi_tpu_torch/nn/transformer.py",
            "vfi_tpu_torch/models/slomo.py", "vfi_tpu_torch/models/sct.py", "vfi_tpu_torch/models/legacy_sct.py",
            "vfi_tpu_torch/train/slomo_env.py", "vfi_tpu_torch/parallel/mesh.py",
            "vfi_tpu_torch/utils/torch_import.py", "vfi_tpu_torch/cli/import_torch_checkpoint.py",
            "vfi_tpu_torch/models/optical_flow.py", "vfi_tpu_torch/eval/tables.py",
            "vfi_tpu_torch/cli/summarize_quant_results.py", "vfi_tpu_torch/utils/optional.py",
            "vfi_tpu_torch/eval/animate.py", "vfi_tpu_torch/eval/figures.py", "vfi_tpu_torch/eval/records.py",
            "vfi_tpu_torch/cli/animate_qual_results.py", "vfi_tpu_torch/cli/generate_comparison_videos.py",
            "vfi_tpu_torch/cli/compare_visual_results.py", "vfi_tpu_torch/cli/compare_intermediate_preds.py",
            "vfi_tpu_torch/cli/generate_unified_boxplot_fig.py", "vfi_tpu_torch/cli/paper_figures.py",
            "vfi_tpu_torch/ops/dynamic.py", "vfi_tpu_torch/train/dynamic_env.py"} <= names
    assert len(names) > 25
    tree = ast.parse("import jax.numpy as jnp\nfrom vfi_tpu.ops import sepconv\nimportlib.import_module('optax')")
    assert set(_imported(tree)) == {"jax", "vfi_tpu", "optax"}


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: os.path.relpath(p, REPO))
def test_port_module_imports_no_jax(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    bad = sorted(set(_imported(tree)) & set(FORBIDDEN))
    assert not bad, f"{os.path.relpath(path, REPO)} imports {bad}"

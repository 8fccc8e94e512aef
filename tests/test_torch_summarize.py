"""vfi_tpu_torch.cli.summarize_quant_results against vfi_tpu's
cli/summarize_quant_results.py on the CPU.

Two results.npz trees (seeded scores, some PSNRs above the clamp at 100) go
through both CLIs, each in this process.  Gates: byte-identical
``metric_summary_text_file`` and ``video_metric_text_file`` outputs over the
flags that change them; the port's text subcommands run with matplotlib made
unimportable, and a plot subcommand then raises an ImportError naming it;
with matplotlib, the port's three plot subcommands write the files vfi_tpu's
write."""

import os
import sys

import numpy as np
import pytest

from cli.summarize_quant_results import main as jax_summarize
from vfi_tpu_torch.cli import summarize_quant_results as summarize
from . import torch_threads  # noqa: F401  (one torch thread per xdist worker)

TEXT_RUNS = {
    "summary_psnr": ["metric_summary_text_file", "--metric", "psnr"],
    "summary_ssim_precision": ["metric_summary_text_file", "--metric", "ssim", "--mean_precision", "4",
                               "--std_err_precision", "5"],
    "videos_psnr_mean": ["video_metric_text_file", "--metric", "psnr"],
    "videos_ssim_min": ["video_metric_text_file", "--metric", "ssim", "--summary_method", "min"],
}
PLOTS = {
    "avg_metric_plot": ["psnr_final.pdf", "psnr_final.png"],
    "sorted_metric_plot": ["sorted_psnr_scores.pdf", "sorted_psnr_scores.png"],
    "metric_box_plot": ["boxplot_psnr_scores.pdf", "boxplot_psnr_scores.png"],
}


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    base = tmp_path_factory.mktemp("quant")
    rng = np.random.RandomState(8)
    out = []
    for i, n_videos in enumerate((5, 7)):
        root = str(base / f"model{i}")
        os.makedirs(root)
        psnr = rng.uniform(20.0, 40.0, (n_videos, 3))
        psnr[0, 1] = 120.0  # identical frames score above the clamp
        np.savez(os.path.join(root, "results.npz"), psnr=psnr, ssim=rng.uniform(0.5, 1.0, (n_videos, 3)),
                 video=np.array([os.path.join(root, "qual", f"clip{v}.npy_1-15") for v in range(n_videos)]))
        out.append(root)
    return out


def _args(cmd, roots, dest, labels=True):
    return [cmd[0], "--quant_results_roots", *roots, *(["--labels", "bi-TAI", "MC-Net"] if labels else []),
            "--dest_path", dest, *cmd[1:]]


def _files(dest):
    out = {}
    for name in sorted(os.listdir(dest)):
        with open(os.path.join(dest, name), "rb") as f:
            out[name] = f.read()
    return out


@pytest.mark.parametrize("labels", [True, False], ids=["labels", "no_labels"])
@pytest.mark.parametrize("run", sorted(TEXT_RUNS))
def test_text_tables_are_byte_identical(roots, tmp_path, monkeypatch, run, labels):
    jax_dest, dest = str(tmp_path / "jax"), str(tmp_path / "torch")
    jax_summarize(_args(TEXT_RUNS[run], roots, jax_dest, labels))
    monkeypatch.setitem(sys.modules, "matplotlib", None)  # the text subcommands need none
    summarize.main(_args(TEXT_RUNS[run], roots, dest, labels))
    got, want = _files(dest), _files(jax_dest)
    assert got == want and len(got) == 1 and next(iter(got.values()))


def test_plot_subcommand_without_matplotlib_raises_naming_it(roots, tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="need matplotlib") as e:
        summarize.main(_args(["metric_box_plot"], roots, str(tmp_path / "plots")))
    assert e.value.name == "matplotlib"


def test_plot_subcommands_write_the_files_vfi_tpu_writes(roots, tmp_path):
    for cmd, names in PLOTS.items():
        jax_dest, dest = str(tmp_path / cmd / "jax"), str(tmp_path / cmd / "torch")
        jax_summarize(_args([cmd], roots, jax_dest))
        summarize.main(_args([cmd], roots, dest))
        assert sorted(os.listdir(dest)) == sorted(os.listdir(jax_dest)) == names
        assert all(os.path.getsize(os.path.join(dest, n)) > 0 for n in names)

"""The port's figure and animation tools against vfi_tpu's on the CPU.

vfi_tpu_torch's ``eval/animate.py``, ``eval/figures.py``, ``eval/records.py``
and the six CLIs built on them (animate_qual_results,
generate_comparison_videos, compare_visual_results,
compare_intermediate_preds, generate_unified_boxplot_fig, paper_figures)
run in this process beside vfi_tpu's ``cli/`` counterparts, each side into
its own directory, on the same trees:

  * a synthetic results tree (three experiments, K=T=F=2, 24x32, every PNG
    name predict writes, the intermediate predictions included);
  * one experiment written by the port's own ``cli.predict --device cpu
    --intermediate_preds`` from a toy TAI snapshot (two clips);
  * two seeded results.npz trees, for the boxplot and ``paper_figures plot``.

Gates: PDFs, GIFs, PNG and JPG frames and the registry JSON byte-identical
(under ``SOURCE_DATE_EPOCH=0``, each side in matplotlib's default rc state,
as both share this process); MP4s decoded by cv2 equal frame by frame.  With
matplotlib made unimportable the non-matplotlib tools still run and each
matplotlib tool raises an ImportError naming it; likewise imageio for the
GIF tools.
"""

import json
import os
import shutil
import sys

import cv2
import matplotlib
import numpy as np
import pytest
from PIL import Image

from cli import animate_qual_results as jax_animate
from cli import compare_intermediate_preds as jax_intermediate
from cli import compare_visual_results as jax_visual
from cli import generate_comparison_videos as jax_comparison
from cli import generate_unified_boxplot_fig as jax_boxplot
from cli import paper_figures as jax_paper
from vfi_tpu_torch.cli import animate_qual_results as animate
from vfi_tpu_torch.cli import compare_intermediate_preds as intermediate
from vfi_tpu_torch.cli import compare_visual_results as visual
from vfi_tpu_torch.cli import generate_comparison_videos as comparison
from vfi_tpu_torch.cli import generate_unified_boxplot_fig as boxplot
from vfi_tpu_torch.cli import paper_figures as paper
from vfi_tpu_torch.cli import predict
from vfi_tpu_torch.cli.predict import INTERMEDIATE_PREDS
from vfi_tpu_torch.data.synthetic import make_videolist
from vfi_tpu_torch.utils import checkpoint as ckpt
from vfi_tpu_torch.utils.params import params_from_jax, random_jax_params
from . import torch_threads  # noqa: F401  (one torch thread per xdist worker)

K = T = F = 2
H, W = 24, 32
DATASET = "KTH-test_data_list_T=2"
EXPS = ["expA", "expB", "expC"]
CLIP = "person01_boxing_d1.avi_1-6"
# The port's predict run: a toy TAI (gray, 32x32) on two clips.
TOY = {"class": "TAIFillInModel", "args": [],
       "kwargs": dict(gf_dim=8, c_dim=1, feature_size=3, ks=5, num_block=5, kf_dim=4, layers=3)}
TOY_DATASET, TOY_EXP, TOY_HW, TOY_CLIPS = "toy", "toy_tai", 32, ["clip0.npy_1-6", "clip1.npy_1-6"]
ZOOM = [".2", ".2", ".6", ".6"]
WINDOW = [".0", ".0", ".5", ".5"]


def _names():
    return ([f"gt_preceding_{t:04d}.png" for t in range(K)]
            + [f"gt_middle_{t:04d}.png" for t in range(K, K + T)]
            + [f"pred_middle_{t:04d}.png" for t in range(K, K + T)]
            + [f"gt_following_{t:04d}.png" for t in range(K + T, K + T + F)]
            + [f"{prefix}_{t:04d}.png" for _, prefix in INTERMEDIATE_PREDS for t in range(K, K + T)])


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """{"synthetic": root, "predicted": root} results trees, each laid out as
    ``root/<dataset>/images/<exp>/<clip>/*.png``."""
    root = tmp_path_factory.mktemp("results")
    rng = np.random.RandomState(0)
    for exp in EXPS:
        d = root / "synthetic" / DATASET / "images" / exp / CLIP
        d.mkdir(parents=True)
        for n in _names():
            Image.fromarray(rng.randint(0, 255, (H, W, 3), np.uint8)).save(d / n)

    work = str(root / "predict")
    videolist = make_videolist(os.path.join(work, "clips"), len(TOY_CLIPS), seed=3, n_frames=K + T + F, hw=TOY_HW)
    ckpt.write_payload(os.path.join(work, "ckpt", TOY_EXP), "model_best.ckpt",
                       {"generator": params_from_jax(random_jax_params(TOY, 7)),
                        "counters": {"updates": 0, "sum_avg_psnr_err": 0.0, "sum_avg_ssim_err": 0.0}})
    qual = str(root / "predicted" / TOY_DATASET / "images" / TOY_EXP)
    predict.main(["--K", str(K), "--T", str(T), "--F", str(F), "--c_dim", "1", "--image_size", str(TOY_HW),
                  "--batch_size", "2", "--model_key", json.dumps(TOY), "--name", TOY_EXP,
                  "--checkpoints_dir", os.path.join(work, "ckpt"), "--test_video_list_path", videolist,
                  "--qual_result_root", qual, "--num_threads", "0", "--intermediate_preds", "--device", "cpu"])
    return {"synthetic": str(root / "synthetic"), "predicted": str(root / "predicted")}


def test_the_port_predict_run_writes_every_name_the_tools_read(trees):
    qual = os.path.join(trees["predicted"], TOY_DATASET, "images", TOY_EXP)
    assert sorted(os.listdir(qual)) == TOY_CLIPS
    for clip in TOY_CLIPS:
        assert sorted(os.listdir(os.path.join(qual, clip))) == sorted(_names())


@pytest.fixture
def fixed_dates(monkeypatch):
    monkeypatch.setenv("SOURCE_DATE_EPOCH", "0")  # matplotlib's PDF dates


def _files(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            with open(os.path.join(d, n), "rb") as f:
                out[os.path.relpath(os.path.join(d, n), root)] = f.read()
    return out


def _both(jax_main, port_main, argv_of, base):
    """Each side's ``main(argv_of(dest))`` into ``base/jax`` and
    ``base/torch``, in matplotlib's default rc state; (vfi_tpu's files,
    the port's files) as {relative path: bytes}."""
    out = []
    for side, main in (("jax", jax_main), ("torch", port_main)):
        dest = os.path.join(base, side)
        with matplotlib.rc_context():
            matplotlib.rcdefaults()
            main(argv_of(dest))
        if "matplotlib.pyplot" in sys.modules:
            sys.modules["matplotlib.pyplot"].close("all")
        out.append(_files(dest))
    return out


def _visual_args(tree, exps, *extra):
    return lambda dest: ["--results_root", tree, "--dataset_name", DATASET, "--clip_names", CLIP,
                         "--exp_names", *exps, "--dest_path", dest, *extra]


VISUAL_PDFS = {
    "grid_with_zoom": (EXPS[:2], ["--model_labels", "Model A", "Model B", "--frame_indexes", "0", "2", "4",
                                  "--pdf_zoom_region", *ZOOM, "--pdf_zoom_window_position", *WINDOW]),
    "grid": (EXPS, ["--frame_indexes", "1", "3", "5"]),
    "one_middle_frame": (EXPS, ["--model_labels", "A", "B", "C", "--frame_indexes", "1", "2", "4",
                                "--pdf_zoom_region", *ZOOM, "--pdf_zoom_window_position", *WINDOW,
                                "--pdf_one_middle_frame"]),
}


@pytest.mark.parametrize("layout", sorted(VISUAL_PDFS))
def test_compare_visual_results_pdfs_are_byte_identical(trees, tmp_path, fixed_dates, layout):
    exps, extra = VISUAL_PDFS[layout]
    want, got = _both(jax_visual.main, visual.main, _visual_args(trees["synthetic"], exps, *extra), str(tmp_path))
    assert list(got) == [f"{CLIP}.pdf"] and got == want


def _mp4_frames(path):
    cap = cv2.VideoCapture(path)
    frames = []
    try:
        while True:
            ok, frame = cap.read()
            if not ok:
                return frames
            frames.append(frame)
    finally:
        cap.release()


VIDEOS = {"gif": ["video.gif"], "mp4": ["video.mp4"], "mp4-uncomp": ["video.mp4"],
          "images": [f"{t:02d}.jpg" for t in range(K + T + F)],
          "images-uncomp": [os.path.join("video_frames", f"{t:02d}.png") for t in range(K + T + F)]}


@pytest.mark.parametrize("video_type", sorted(VIDEOS))
def test_compare_visual_results_videos_are_identical(trees, tmp_path, video_type):
    want, got = _both(jax_visual.main, visual.main,
                      _visual_args(trees["synthetic"], EXPS[:2], "--total_num_frames", str(K + T + F), "--no_pdf",
                                   "--video_type", video_type), str(tmp_path))
    assert sorted(got) == sorted(VIDEOS[video_type])
    if video_type.startswith("mp4"):
        a, b = (_mp4_frames(str(tmp_path / side / "video.mp4")) for side in ("jax", "torch"))
        assert len(a) == len(b) == K + T + F and all(np.array_equal(x, y) for x, y in zip(a, b))
    else:
        assert got == want


@pytest.mark.parametrize("tree", ["synthetic", "predicted"])
@pytest.mark.parametrize("command", ["bidirectional_pred", "interp_net_pred"])
def test_compare_intermediate_preds_pdfs_are_byte_identical(trees, tmp_path, fixed_dates, command, tree):
    dataset, exps, clips = (DATASET, EXPS[:2], [CLIP]) if tree == "synthetic" else (TOY_DATASET, [TOY_EXP], TOY_CLIPS)
    zoom = [a for _ in clips for a in ("--pdf_zoom_region", ".1", ".1", ".9", ".9")] if tree == "synthetic" else []
    want, got = _both(jax_intermediate.main, intermediate.main, lambda dest: [
        "--results_root", trees[tree], "--dataset_name", dataset, "--clip_names", *clips, "--exp_names", *exps,
        "--ts", "2", "3", *zoom, "--dest_path", dest, command], str(tmp_path))
    assert sorted(got) == sorted(os.path.join(c, f"{t:02d}.pdf") for c in clips for t in (2, 3)) and got == want


def _gifs(root):
    return {k: v for k, v in _files(root).items() if k.endswith(".gif")}


@pytest.mark.parametrize("case", ["pred", "create_gt_gif", "two_workers"])
def test_animate_qual_results_gifs_are_byte_identical(trees, tmp_path, case):
    tree, exp = ("predicted", os.path.join(TOY_DATASET, "images", TOY_EXP)) if case == "two_workers" else \
        ("synthetic", os.path.join(DATASET, "images", EXPS[0]))
    extra = ["--create_gt_gif"] if case != "pred" else []
    for side, main, workers in (("jax", jax_animate.main, "1"),
                                ("torch", animate.main, "2" if case == "two_workers" else "1")):
        shutil.copytree(os.path.join(trees[tree], exp), str(tmp_path / side))  # the GIFs land beside the PNGs
        main([str(tmp_path / side), "--num_workers", workers, *extra])
    want, got = _gifs(str(tmp_path / "jax")), _gifs(str(tmp_path / "torch"))
    clips = TOY_CLIPS if case == "two_workers" else [CLIP]
    names = ["pred_final.gif"] + (["gt.gif"] if extra else [])
    assert sorted(got) == sorted(os.path.join(c, n) for c in clips for n in names) and got == want


def test_generate_comparison_videos_gif_is_byte_identical(trees, tmp_path):
    want, got = _both(jax_comparison.main, comparison.main, lambda dest: [
        "--results_root", os.path.join(trees["synthetic"], DATASET), "--exp_names", *EXPS,
        "--exp_labels", "A", "B", "C", "--clip_names", CLIP, "--save_root", dest], str(tmp_path))
    assert list(got) == [f"{CLIP}.gif"] and got == want


@pytest.fixture(scope="module")
def quant_trees(tmp_path_factory):
    """Seeded results.npz trees: the boxplot's
    ``<dataset>-test_data_list_T=<T>/quantitative/<exp>`` and ``plot``'s
    ``quantitative/<dataset>/<exp>`` (some PSNRs above the clamp at 100)."""
    root = tmp_path_factory.mktemp("quant")
    rng = np.random.RandomState(1)
    for Tm in (3, 5):
        for exp in ("m1", "m2"):
            d = root / "box" / f"KTH-test_data_list_T={Tm}" / "quantitative" / exp
            d.mkdir(parents=True)
            psnr = rng.uniform(20, 40, (6, Tm))
            psnr[0, 0] = 120.0
            np.savez(d / "results.npz", psnr=psnr, ssim=rng.uniform(0.7, 1.0, (6, Tm)),
                     video=np.array([f"v{i}" for i in range(6)]))
    for exp in ("bi-TAI_run", "MC-Net_run"):
        d = root / "plot" / "quantitative" / "KTH" / exp
        d.mkdir(parents=True)
        psnr = rng.uniform(20, 40, (5, 5))
        psnr[1, 2] = 150.0
        np.savez(d / "results.npz", psnr=psnr, ssim=rng.uniform(0.5, 1.0, (5, 5)),
                 video=np.array([f"v{i}" for i in range(5)]))
    return str(root)


def test_unified_boxplot_is_byte_identical(quant_trees, tmp_path, fixed_dates):
    want, got = _both(jax_boxplot.main, boxplot.main, lambda dest: [
        "--results_root", os.path.join(quant_trees, "box"), "--dest_path", os.path.join(dest, "boxplot.pdf"),
        "--dataset", "KTH", "--T_a", "3", "--T_b", "5", "--exp_names", "m1", "m2",
        "--model_labels", "Model 1", "Model 2", "--psnr_range", "20", "44", "--ssim_range", ".6", "1"], str(tmp_path))
    assert list(got) == ["boxplot.pdf"] and got == want


def test_paper_figures_register_plot_images_are_byte_identical(trees, quant_trees, tmp_path, fixed_dates):
    def run(main, dest):
        registry = os.path.join(dest, "records", "experiments.json")
        for model, exp in (("bi-TAI", "bi-TAI_run"), ("MC-Net", "MC-Net_run"), ("bi-TAI", "bi-TAI_run")):
            main(["register", "--registry", registry, "--dataset", "KTH", "--model", model, "--io_key", "5_10",
                  "--exp_name", exp])
        main(["plot", "--registry", registry, "--results_dir", os.path.join(quant_trees, "plot"),
              "--output_dir", os.path.join(dest, "plots"), "--dataset", "KTH", "--models", "bi-TAI", "MC-Net",
              "SepConv", "--io_key", "5_10"])
        clip_dirs = [os.path.join(trees["synthetic"], DATASET, "images", e, CLIP) for e in EXPS]
        main(["images", "--clip_dirs", *clip_dirs, "--output", os.path.join(dest, "strip.png")])
        main(["images", "--clip_dirs", *clip_dirs[:2], "--output", os.path.join(dest, "strip_skip.png"),
              "--skip", "2", "--start", "1"])

    want, got = _both(lambda d: run(jax_paper.main, d), lambda d: run(paper.main, d), lambda dest: dest,
                      str(tmp_path))
    assert sorted(got) == sorted([os.path.join("records", "experiments.json"), os.path.join("plots", "KTH_5_10_psnr.pdf"),
                                  os.path.join("plots", "KTH_5_10_ssim.pdf"), "strip.png", "strip_skip.png"])
    assert got == want
    assert json.loads(got[os.path.join("records", "experiments.json")]) == {
        "KTH": {"MC-Net": {"5_10": ["MC-Net_run"]}, "bi-TAI": {"5_10": ["bi-TAI_run"]}}}


# -- without the optional packages ------------------------------------------------

def _visual(trees, dest, *extra):
    visual.main(_visual_args(trees["synthetic"], EXPS[:2], "--total_num_frames", str(K + T + F), *extra)(dest))


MATPLOTLIB_TOOLS = {
    "compare_visual_results_pdf": lambda trees, q, dest: _visual(trees, dest),
    "compare_intermediate_preds": lambda trees, q, dest: intermediate.main([
        "--results_root", trees["predicted"], "--dataset_name", TOY_DATASET, "--clip_names", TOY_CLIPS[0],
        "--exp_names", TOY_EXP, "--ts", "2", "--dest_path", dest, "bidirectional_pred"]),
    "paper_figures_plot": lambda trees, q, dest: paper.main([
        "plot", "--registry", os.path.join(dest, "none.json"), "--results_dir", os.path.join(q, "plot"),
        "--output_dir", dest, "--dataset", "KTH", "--models", "bi-TAI", "--io_key", "5_10"]),
    "generate_unified_boxplot_fig": lambda trees, q, dest: boxplot.main([
        "--results_root", os.path.join(q, "box"), "--dest_path", os.path.join(dest, "b.pdf"), "--dataset", "KTH",
        "--T_a", "3", "--T_b", "5", "--exp_names", "m1", "--model_labels", "M", "--psnr_range", "20", "44",
        "--ssim_range", ".6", "1"]),
}
GIF_TOOLS = {
    "animate_qual_results": lambda trees, dest: animate.main([
        os.path.join(trees["synthetic"], DATASET, "images", EXPS[0]), "--num_workers", "1"]),
    "generate_comparison_videos": lambda trees, dest: comparison.main([
        "--results_root", os.path.join(trees["synthetic"], DATASET), "--exp_names", *EXPS[:2],
        "--clip_names", CLIP, "--save_root", dest]),
    "compare_visual_results_gif": lambda trees, dest: _visual(trees, dest, "--no_pdf", "--video_type", "gif"),
}


@pytest.mark.parametrize("tool", sorted(MATPLOTLIB_TOOLS))
def test_matplotlib_tools_without_matplotlib_raise_naming_it(trees, quant_trees, tmp_path, monkeypatch, tool):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="needs matplotlib, which is not installed") as e:
        MATPLOTLIB_TOOLS[tool](trees, quant_trees, str(tmp_path))
    assert e.value.name == "matplotlib"


def test_the_other_tools_run_without_matplotlib(trees, tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    for video_type in ("mp4", "images-uncomp"):
        _visual(trees, str(tmp_path / video_type), "--no_pdf", "--video_type", video_type)
    strip = str(tmp_path / "strip.png")
    paper.main(["register", "--registry", str(tmp_path / "r.json"), "--dataset", "KTH", "--model", "bi-TAI",
                "--io_key", "2_4", "--exp_name", TOY_EXP])
    paper.main(["images", "--clip_dirs", os.path.join(trees["predicted"], TOY_DATASET, "images", TOY_EXP,
                                                       TOY_CLIPS[0]), "--output", strip])
    GIF_TOOLS["generate_comparison_videos"](trees, str(tmp_path / "gifs"))
    assert os.path.getsize(str(tmp_path / "mp4" / "video.mp4")) > 0 and Image.open(strip).size == (
        (K + T + F) * TOY_HW, TOY_HW)
    assert len(os.listdir(tmp_path / "images-uncomp" / "video_frames")) == K + T + F
    assert Image.open(str(tmp_path / "gifs" / f"{CLIP}.gif")).n_frames == K + T + F


@pytest.mark.parametrize("tool", sorted(GIF_TOOLS))
def test_gif_tools_without_imageio_raise_naming_it(trees, tmp_path, monkeypatch, tool):
    monkeypatch.setitem(sys.modules, "imageio", None)
    with pytest.raises(ImportError, match="needs imageio, which is not installed") as e:
        GIF_TOOLS[tool](trees, str(tmp_path))
    assert e.value.name == "imageio"

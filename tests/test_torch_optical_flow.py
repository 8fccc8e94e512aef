"""The optical-flow baseline (vfi_tpu_torch.models.optical_flow) against
vfi_tpu's, on the CPU at toy sizes.

Gates: ``host_forward`` equals vfi_tpu's bit for bit on synthetic gray and
color clips (the same OpenCV, scipy and numpy); ``api.VideoInpainter`` serves
it as vfi_tpu's does, bit for bit; the port's predict CLI with ``--model_key
OFFillInModel``, with and without ``--device_normalize``, writes the PNGs of
vfi_tpu's ``cli/predict.py`` (run in this process) within 1 uint8 level; and
where OpenCV or scipy cannot be imported, building the model raises an
ImportError that names the package."""

import os
import sys

import numpy as np
import pytest

from cli.predict import main as jax_predict_main
from vfi_tpu.api import VideoInpainter as JaxInpainter
from vfi_tpu.models.optical_flow import OFFillInModel as JaxOF
from vfi_tpu_torch.api import VideoInpainter
from vfi_tpu_torch.cli import predict
from vfi_tpu_torch.data.datasets import ContiguousVideoClipDataset
from vfi_tpu_torch.data.synthetic import make_videolist
from vfi_tpu_torch.models.optical_flow import OFFillInModel
from vfi_tpu_torch.models.registry import create_model
from vfi_tpu_torch.utils.png import read_png
from . import torch_threads  # noqa: F401  (one torch thread per xdist worker)

K, T, F = 2, 3, 2
HW, N_CLIPS = 32, 3


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("of_clips"))
    return make_videolist(os.path.join(root, "clips"), N_CLIPS, seed=4, n_frames=K + T + F, hw=HW)


def _targets(videolist, c_dim):
    ds = ContiguousVideoClipDataset(c_dim, videolist, K + T + F, False, False, (HW, HW), False)
    return np.stack([ds[i]["targets"] for i in range(len(ds))])


@pytest.mark.parametrize("c_dim", [1, 3], ids=["gray", "color"])
def test_host_forward_equals_vfi_tpu(clips, c_dim):
    targets = _targets(clips, c_dim)
    p, f = targets[:, :K], targets[:, K + T:]
    got = create_model("OFFillInModel").host_forward(T, p, f)
    want = JaxOF().host_forward(T, p, f)
    assert sorted(got) == sorted(want) == ["pred"]
    assert got["pred"].shape == (N_CLIPS, T, HW, HW, c_dim) and got["pred"].dtype == np.float32
    np.testing.assert_array_equal(got["pred"], want["pred"])


def test_video_inpainter_serves_it_as_vfi_tpu_does():
    rng = np.random.RandomState(0)
    pre = rng.randint(0, 256, (2, K, HW, HW, 3), np.uint8)
    fol = np.roll(pre, 2, axis=3)
    got = VideoInpainter.from_checkpoint("OFFillInModel").inpaint(pre, fol, T)
    want = JaxInpainter.from_checkpoint("OFFillInModel").inpaint(pre, fol, T)
    assert got.shape == (2, T, HW, HW, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    assert VideoInpainter("OFFillInModel").device is None


def _args(videolist, qual, extra=()):
    return ["--K", str(K), "--T", str(T), "--F", str(F), "--c_dim", "1", "--image_size", str(HW),
            "--batch_size", "2", "--model_key", "OFFillInModel", "--name", "of", "--checkpoints_dir", "unused",
            "--test_video_list_path", videolist, "--qual_result_root", qual, "--num_threads", "0", *extra]


@pytest.mark.parametrize("extra", [[], ["--device_normalize"]], ids=["host_float", "device_normalize"])
def test_predict_cli_matches_vfi_tpu(clips, tmp_path, extra):
    """No snapshot is read (--checkpoints_dir names nothing), the bf16 dtype
    is not applied, and every PNG of vfi_tpu's run is written within 1 level."""
    qual_jax, qual = str(tmp_path / "qual_jax"), str(tmp_path / "qual_torch")
    jax_predict_main(_args(clips, qual_jax, extra))
    stats = predict.main(_args(clips, qual, [*extra, "--device", "cpu", "--dtype", "bfloat16"]))
    assert stats["clips"] == N_CLIPS and stats["batches"] == 2
    names = {c: sorted(os.listdir(os.path.join(qual_jax, c))) for c in sorted(os.listdir(qual_jax))}
    assert {c: sorted(os.listdir(os.path.join(qual, c))) for c in sorted(os.listdir(qual))} == names
    assert len(names) == N_CLIPS and all(len(v) == K + 2 * T + F for v in names.values())
    worst = 0
    for clip, files in names.items():
        for name in files:
            a, b = (read_png(os.path.join(q, clip, name)).astype(np.int16) for q in (qual, qual_jax))
            worst = max(worst, int(np.abs(a.reshape(b.shape) - b).max()))
    assert worst <= 1


@pytest.mark.parametrize("module,package", [("cv2", "OpenCV"), ("scipy.spatial", "scipy")])
def test_missing_package_raises_at_build(monkeypatch, module, package):
    monkeypatch.setitem(sys.modules, module, None)
    with pytest.raises(ImportError, match=f"OFFillInModel needs {package} \\({module}\\)") as e:
        create_model("OFFillInModel")
    assert e.value.name == module
    with pytest.raises(ImportError, match=package):
        OFFillInModel()

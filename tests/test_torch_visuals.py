"""vfi_tpu_torch/utils/visuals.py against vfi_tpu/utils/visuals.py: the
TensorBoard image grid and the per-timestep metric plot, pixel for pixel (the
port decodes matplotlib's PNG with its own reader, vfi_tpu with PIL)."""

import numpy as np
import pytest

from vfi_tpu.utils import visuals as jvis
from vfi_tpu_torch.utils import visuals as tvis
from . import torch_threads  # noqa: F401  (one torch thread per xdist worker)


@pytest.mark.parametrize("c_dim", [1, 3])
def test_visual_grid_matches_vfi_tpu(c_dim):
    rng = np.random.RandomState(c_dim)
    K, T, F = 2, 3, 2
    vis = {"pred_vis_seq": rng.uniform(-1, 1, (2, K + T + F, 12, 10, c_dim)).astype(np.float32),
           "target_vis_seq": rng.uniform(-1, 1, (2, K + T + F, 12, 10, c_dim)).astype(np.float32)}
    got, want = tvis.visual_grid(vis, K, T), jvis.visual_grid(vis, K, T)
    assert got.shape == want.shape == (2 * 2 * 14 + 2, 7 * 12 + 2, 3)
    np.testing.assert_array_equal(got, want)


def test_draw_err_plot_matches_vfi_tpu(tmp_path):
    err = np.random.RandomState(0).uniform(20, 40, (6, 5))
    got, want = tvis.draw_err_plot(err, "PSNR"), jvis.draw_err_plot(err, "PSNR")
    assert got.dtype == want.dtype == np.uint8 and got.ndim == 3 and got.shape[-1] == 3
    np.testing.assert_array_equal(got, want)
    assert tvis.draw_err_plot(err, "SSIM", lims=[0, 6, 0, 1], path=str(tmp_path / "p.png")) is None
    assert (tmp_path / "p.png").stat().st_size > 0

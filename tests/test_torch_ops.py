"""vfi_tpu_torch.ops against vfi_tpu.ops on the CPU: image primitives, the
sepconv padding and plain versions, and the CUDA kernel's CPU-side guards."""

import importlib
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vfi_tpu.ops import image as jimage
from vfi_tpu_torch.ops import image as timage
from vfi_tpu_torch.ops import sepconv as tsep
from . import torch_threads  # noqa: F401  (one torch thread per xdist worker)

jsep = importlib.import_module("vfi_tpu.ops.sepconv")  # vfi_tpu.ops re-exports a function of that name
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(atol=3e-4, rtol=1e-3)


def _nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("align_corners", [True, False])
def test_upsample2x_bilinear(align_corners):
    x = np.random.RandomState(0).uniform(-1, 1, (2, 5, 7, 3)).astype(np.float32)
    want = np.asarray(jimage.upsample2x_bilinear(jnp.asarray(x), align_corners))
    got = _nhwc(timage.upsample2x_bilinear(_nchw(x), align_corners))
    np.testing.assert_allclose(got, want, **TOL)


def test_fixed_unpooling():
    x = np.random.RandomState(1).uniform(-1, 1, (2, 4, 6, 3)).astype(np.float32)
    want = np.asarray(jimage.fixed_unpooling(jnp.asarray(x)))
    np.testing.assert_array_equal(_nhwc(timage.fixed_unpooling(_nchw(x))), want)


def test_value_and_color_transforms():
    rng = np.random.RandomState(2)
    frames = rng.uniform(-1, 1, (2, 3, 4, 5, 3)).astype(np.float32)
    u8 = rng.randint(0, 256, (2, 4, 5, 3)).astype(np.uint8)
    pairs = [
        (jimage.inverse_transform(jnp.asarray(frames)), timage.inverse_transform(torch.from_numpy(frames))),
        (jimage.fore_transform(jnp.asarray(frames)), timage.fore_transform(torch.from_numpy(frames))),
        (jimage.bgr_to_gray(jnp.asarray(frames)), timage.bgr_to_gray(torch.from_numpy(frames))),
        (jimage.to_gray_frames(jnp.asarray(frames)), timage.to_gray_frames(torch.from_numpy(frames))),
        (jimage.to_gray_frames(jnp.asarray(frames[..., :1])), timage.to_gray_frames(torch.from_numpy(frames[..., :1]))),
        (jimage.frames_from_uint8(jnp.asarray(u8), 1), timage.frames_from_uint8(torch.from_numpy(u8), 1)),
        (jimage.frames_from_uint8(jnp.asarray(u8), 3), timage.frames_from_uint8(torch.from_numpy(u8), 3)),
        (jimage.time_weights(5), timage.time_weights(5)),
    ]
    for want, got in pairs:
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("ks", [4, 5])
def test_pad_for_sepconv(ks):
    x = np.random.RandomState(3).uniform(-1, 1, (2, 6, 9, 3)).astype(np.float32)
    want = np.asarray(jsep.pad_for_sepconv(jnp.asarray(x), ks))
    got = tsep.pad_for_sepconv(torch.from_numpy(x), ks).numpy()
    assert got.shape == (2, 6 + ks - 1, 9 + ks - 1, 3)
    np.testing.assert_array_equal(got, want)


def _operands(B, H, W, C, ks, seed):
    """Outputs of O(1): x in [-1, 1], v and h in [0, 2/ks]."""
    rng = np.random.RandomState(seed)
    x = rng.uniform(-1, 1, (B, H + ks - 1, W + ks - 1, C)).astype(np.float32)
    v = rng.uniform(0, 2.0 / ks, (B, H, W, ks)).astype(np.float32)
    h = rng.uniform(0, 2.0 / ks, (B, H, W, ks)).astype(np.float32)
    return x, v, h


@pytest.mark.parametrize("impl", ["sepconv_direct", "sepconv_banded"])
@pytest.mark.parametrize("H,W,C,ks", [
    (8, 8, 1, 4), (8, 8, 1, 5), (8, 8, 3, 4), (8, 8, 3, 5),
    (7, 13, 1, 5),  # W not a power of two, odd H
    (4, 136, 3, 5),  # wide: W > 128
])
def test_sepconv_plain_matches_jax_direct(impl, H, W, C, ks):
    x, v, h = _operands(2, H, W, C, ks, seed=H * W + C + ks)
    want = np.asarray(jsep.sepconv_direct(jnp.asarray(x), jnp.asarray(v), jnp.asarray(h)))
    # the kernel heads' layout: NCHW [B, ks, H, W] viewed as [B, H, W, ks]
    vt = torch.from_numpy(np.ascontiguousarray(v.transpose(0, 3, 1, 2))).permute(0, 2, 3, 1)
    ht = torch.from_numpy(h)
    got = getattr(tsep, impl)(torch.from_numpy(x), vt, ht).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("H,W,C,ks", [(8, 8, 1, 5), (8, 10, 3, 4), (16, 16, 1, 51)])
def test_sepconv_banded_matches_pallas_kernel_interpret(H, W, C, ks):
    """Against the TPU kernel _sepconv_pallas_mxu_raw run by the Pallas
    interpreter.  Its f32 path is a 3-pass bf16 split (~2^-16 relative per
    product), hence 1e-4 on O(1) outputs."""
    from jax.experimental.pallas import tpu as pltpu

    x, v, h = _operands(2, H, W, C, ks, seed=ks)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jsep.sepconv_pallas_mxu(jnp.asarray(x), jnp.asarray(v), jnp.asarray(h)))
    got = tsep.sepconv_banded(torch.from_numpy(x), torch.from_numpy(v), torch.from_numpy(h)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_sepconv_dispatch_and_shape_checks():
    x, v, h = (torch.from_numpy(a) for a in _operands(1, 6, 6, 1, 5, seed=0))
    torch.testing.assert_close(tsep.sepconv(x, v, h), tsep.sepconv_banded(x, v, h), rtol=0, atol=0)
    with pytest.raises(ValueError, match="pre-padded"):
        tsep.sepconv(x[:, 1:], v, h)
    with pytest.raises(ValueError, match="differ"):
        tsep.sepconv(x, v, h[..., 1:])


def test_kernel_wrapper_refuses_cpu_tensors():
    x, v, h = (torch.from_numpy(a) for a in _operands(1, 6, 6, 1, 5, seed=0))
    before = tsep.sepconv_fwd_launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        tsep.sepconv_fwd_cuda(x, v, h)
    assert tsep.sepconv_fwd_launches == before


def test_importing_the_kernel_loader_builds_nothing():
    code = (
        "import ctypes, subprocess, torch\n"
        "def boom(*a, **k): raise AssertionError('built or loaded at import')\n"
        "subprocess.Popen = boom\n"
        "ctypes.CDLL = boom\n"
        "import vfi_tpu_torch.ops._kernels as k, vfi_tpu_torch.ops.sepconv, vfi_tpu_torch.api\n"
        "import vfi_tpu_torch.train.environments\n"
        "assert k._libs == {}\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr

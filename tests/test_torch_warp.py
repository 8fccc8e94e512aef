"""vfi_tpu_torch.ops.warp and nn.vgg against vfi_tpu on the CPU: the backward
warp in both modes through both routes (values, and the gradients of the
image and of the flow), flows that leave the frame included; the float32
sampling grid under a bf16 image; and the VGG16 features from one seeded
.npz, with the loader's refusals."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vfi_tpu.nn import vgg as jvgg
from vfi_tpu.ops.warp import flow_warp as jflow_warp
from vfi_tpu_torch.nn import vgg as tvgg
from vfi_tpu_torch.ops.warp import flow_warp, flow_warp_gather
from . import torch_threads  # noqa: F401  (one torch thread per xdist worker)

B, C, H, W = 2, 3, 9, 13
ROUTES = {"grid_sample": flow_warp, "gather": flow_warp_gather}


def _inputs(seed=0, spread=6.0):
    """Images and flows whose displacements reach ``spread`` pixels, so that
    samples land between pixels, on the border and outside the frame."""
    rng = np.random.RandomState(seed)
    img = rng.uniform(-1, 1, (B, H, W, C)).astype(np.float32)
    flow = rng.uniform(-spread, spread, (B, H, W, 2)).astype(np.float32)
    flow[0, 0, 0] = (-0.5, 0.25)  # a corner whose samples straddle the edge
    flow[1, 2, 3] = (2.0, -1.0)  # an integer displacement
    return img, flow


def _nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("mode", ["pixel", "torch03"])
def test_flow_warp_matches_jax(mode, route):
    img, flow = _inputs()
    want = np.asarray(jflow_warp(jnp.asarray(img), jnp.asarray(flow), mode))
    got = ROUTES[route](_nchw(img), _nchw(flow), mode).permute(0, 2, 3, 1).numpy()
    assert np.abs(want).max() > 0.5 and (np.abs(want) < 1e-6).any()  # samples inside and wholly outside the frame
    np.testing.assert_allclose(got, want, atol=2e-6, rtol=0)


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("mode", ["pixel", "torch03"])
def test_flow_warp_gradients_match_jax(mode, route):
    img, flow = _inputs(seed=1)
    cot = np.random.RandomState(2).standard_normal((B, H, W, C)).astype(np.float32)
    _, vjp = jax.vjp(lambda a, f: jflow_warp(a, f, mode), jnp.asarray(img), jnp.asarray(flow))
    want_img, want_flow = (np.asarray(g) for g in vjp(jnp.asarray(cot)))

    t_img, t_flow = _nchw(img).requires_grad_(), _nchw(flow).requires_grad_()
    out = ROUTES[route](t_img, t_flow, mode)
    out.backward(_nchw(cot))
    np.testing.assert_allclose(t_img.grad.permute(0, 2, 3, 1).numpy(), want_img, atol=1e-5, rtol=0)
    np.testing.assert_allclose(t_flow.grad.permute(0, 2, 3, 1).numpy(), want_flow, atol=5e-5, rtol=1e-5)
    assert np.abs(want_flow).max() > 0.1


def test_flow_warp_samples_a_bf16_image_at_float32_coordinates():
    """At x ~ 300 a bf16 coordinate resolves 2 pixels; the warp's grid is
    float32 whatever the dtypes, so a bf16 image (and a bf16 flow) sample
    where their float32 copies do."""
    rng = np.random.RandomState(3)
    img = torch.from_numpy(rng.uniform(-1, 1, (1, 1, 4, 320)).astype(np.float32)).bfloat16()
    flow = torch.zeros(1, 2, 4, 320)
    flow[:, 0] = 0.37
    got = flow_warp(img, flow.bfloat16())
    assert got.dtype == torch.bfloat16
    want = flow_warp(img.float(), flow.bfloat16().float())
    torch.testing.assert_close(got, want.bfloat16(), atol=0, rtol=0)
    torch.testing.assert_close(flow_warp_gather(img, flow.bfloat16()).float(), want, atol=1e-2, rtol=0)
    with pytest.raises(ValueError, match="mode"):
        flow_warp(img, flow, "bilinear")


@pytest.fixture(scope="module")
def vgg_npz(tmp_path_factory):
    return tvgg.random_vgg16_npz(str(tmp_path_factory.mktemp("vgg") / "vgg16.weights"), seed=4)


def test_vgg16_features_match_jax(vgg_npz):
    x = np.random.RandomState(5).uniform(0, 1, (2, 24, 16, 3)).astype(np.float32)
    jmodel, variables = jvgg.try_load_vgg16(vgg_npz)
    want = np.asarray(jax.jit(jmodel.apply)(variables, x))
    model = tvgg.try_load_vgg16(vgg_npz)
    assert not model.training and not any(p.requires_grad for p in model.parameters())
    with torch.no_grad():
        got = model(_nchw(x)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (2, 3, 2, 512)
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max(), rtol=0)
    assert np.abs(want).max() > 0.1


def test_vgg16_loader_refusals_and_the_seeded_file(vgg_npz, tmp_path):
    assert tvgg.try_load_vgg16(None) is None and tvgg.try_load_vgg16("") is None
    with pytest.raises(RuntimeError, match="could not load VGG16 weights"):
        tvgg.try_load_vgg16(str(tmp_path / "missing.npz"))
    z = dict(np.load(vgg_npz))
    assert len(z) == 20 and z["conv1_1/kernel"].shape == (3, 3, 3, 64) and z["conv4_3/bias"].shape == (512,)
    del z["conv4_3/bias"]
    np.savez(tmp_path / "partial.npz", **z)
    with pytest.raises(RuntimeError, match="could not load VGG16 weights"):
        tvgg.try_load_vgg16(str(tmp_path / "partial.npz"))
    again = np.load(tvgg.random_vgg16_npz(str(tmp_path / "again.npz"), seed=4))
    assert all(np.array_equal(again[k], np.load(vgg_npz)[k]) for k in again)

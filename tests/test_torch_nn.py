"""vfi_tpu_torch.nn against vfi_tpu.nn on the CPU at toy widths: pooling,
ConvLSTMCell, MC-Net and KernelNet on the same weights and inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vfi_tpu.nn import kernelnet as jkn
from vfi_tpu.nn import layers as jlayers
from vfi_tpu.nn import mcnet as jmc
from vfi_tpu_torch.models.registry import create_model
from vfi_tpu_torch.nn import layers as tlayers
from vfi_tpu_torch.utils.params import params_from_jax, random_jax_params
from . import torch_threads  # noqa: F401  (one torch thread per xdist worker)

TOL = dict(atol=3e-4, rtol=1e-3)
GF, KF, KS, LAYERS = 8, 4, 5, 3


def _nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, -3)))


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return np.moveaxis(t.detach().numpy(), -3, -1)


def _toy(c_dim, num_block, cls="TAIFillInModel"):
    spec = {"class": cls, "kwargs": dict(gf_dim=GF, c_dim=c_dim, feature_size=3, ks=KS,
                                         num_block=num_block, kf_dim=KF, layers=LAYERS)}
    jp = random_jax_params(spec, seed=num_block + c_dim)
    model = create_model(spec)
    model.load_state_dict(params_from_jax(jp))
    return jp, model.eval()


@pytest.mark.parametrize("H,W", [(8, 12), (7, 9)])
def test_pooling(H, W):
    x = np.random.RandomState(0).uniform(-1, 1, (2, H, W, 3)).astype(np.float32)
    for jf, tf in ((jlayers.max_pool2, tlayers.max_pool2), (jlayers.avg_pool2, tlayers.avg_pool2)):
        np.testing.assert_allclose(_nhwc(tf(_nchw(x))), np.asarray(jf(jnp.asarray(x))), atol=1e-6, rtol=1e-6)


def test_conv_lstm_cell():
    cin, feat = 6, 5
    rng = np.random.RandomState(1)
    kernel = (rng.standard_normal((3, 3, cin + feat, 4 * feat)) * 0.3).astype(np.float32)
    bias = (rng.standard_normal(4 * feat) * 0.1).astype(np.float32)
    x = rng.uniform(-1, 1, (2, 8, 8, cin)).astype(np.float32)
    state = rng.uniform(-1, 1, (2, 8, 8, 2 * feat)).astype(np.float32)

    want_h, want_s = jlayers.ConvLSTMCell(feat, 3, 0.5).apply(
        {"params": {"gates": {"kernel": kernel, "bias": bias}}}, jnp.asarray(x), jnp.asarray(state))
    cell = tlayers.ConvLSTMCell(cin, feat, 3, 0.5)
    cell.load_state_dict(params_from_jax({"gates": {"kernel": kernel, "bias": bias}}))
    got_h, got_s = cell(_nchw(x), _nchw(state))
    np.testing.assert_allclose(_nhwc(got_h), np.asarray(want_h), **TOL)
    np.testing.assert_allclose(_nhwc(got_s), np.asarray(want_s), **TOL)


@pytest.mark.parametrize("c_dim", [1, 3])
def test_mcnet_rollout(c_dim):
    jp, model = _toy(c_dim, 5)
    B, K, T, H, W = 2, 3, 3, 32, 32
    rng = np.random.RandomState(2)
    diff = rng.uniform(-0.5, 0.5, (B, K - 1, H, W, 1)).astype(np.float32)
    xt = rng.uniform(-1, 1, (B, H, W, c_dim)).astype(np.float32)

    jnet = jmc.MCNet(GF, c_dim)
    want = jax.jit(lambda prm, d, x: jnet.apply({"params": prm}, T, d, x))(jp["mcnet"], diff, xt)
    with torch.no_grad():
        got = model.mcnet(T, torch.from_numpy(diff), torch.from_numpy(xt))
    for name, w, g in zip(want._fields, want, got):
        np.testing.assert_allclose(_nhwc(g), np.asarray(w), err_msg=name, **TOL)


@pytest.mark.parametrize("c_dim,num_block", [(1, 5), (3, 4)])
def test_kernelnet(c_dim, num_block):
    """TAI_gray-like (ratio plane injected at dec3) and TAI_color-like
    (num_block=4: the ratio plane is never injected)."""
    jp, model = _toy(c_dim, num_block)
    B, H, W = 3, 32, 32
    rng = np.random.RandomState(3)

    def u(*shape):
        return rng.uniform(-1, 1, shape).astype(np.float32)

    frames = [u(B, H, W, c_dim) for _ in range(2)]
    enc = [np.maximum(u(B, H // 8, W // 8, 4 * GF), 0) for _ in range(4)]
    m2, m3 = u(B, H // 2, W // 2, 2 * KF), u(B, H // 4, W // 4, 4 * KF)
    ratio = np.array([0.8, 0.5, 0.2], np.float32)

    jnet = jkn.KernelNet(GF, KS, num_block, LAYERS, KF, use_ratio=True)
    want = jax.jit(lambda prm, *a: jnet.apply({"params": prm}, *a))(jp["kernelnet"], *frames, *enc, m2, m3, ratio)
    with torch.no_grad():
        got = model.kernelnet(*map(_nchw, frames + enc + [m2, m3]), torch.from_numpy(ratio))
    for w, g in zip(want, got):
        assert tuple(g.shape) == (B, H, W, c_dim)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)

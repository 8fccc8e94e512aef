"""The port's sepconv gradient on the CPU: the plain adjoints against the TPU
adjoint kernels (Pallas interpreter) and JAX autograd, finite differences of
the autograd Function, the CUDA wrappers' guards, and the tie-splitting
max_pool2 gradient against vfi_tpu."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vfi_tpu.nn import layers as jlayers
from vfi_tpu_torch.nn import layers as tlayers
from vfi_tpu_torch.ops import sepconv as tsep
from . import torch_threads  # noqa: F401  (one torch thread per xdist worker)

jsep = importlib.import_module("vfi_tpu.ops.sepconv")  # vfi_tpu.ops re-exports a function of that name
CASES = [(5, 8, 8, 1), (4, 8, 10, 3)]  # (ks, H, W, C)


def _operands(B, H, W, C, ks, seed):
    """x in [-1, 1], v and h in [0, 2/ks] (O(1) outputs), cotangent g in [-1, 1]."""
    rng = np.random.RandomState(seed)
    x = rng.uniform(-1, 1, (B, H + ks - 1, W + ks - 1, C)).astype(np.float32)
    v = rng.uniform(0, 2.0 / ks, (B, H, W, ks)).astype(np.float32)
    h = rng.uniform(0, 2.0 / ks, (B, H, W, ks)).astype(np.float32)
    g = rng.uniform(-1, 1, (B, H, W, C)).astype(np.float32)
    return x, v, h, g


def _plain_adjoints(x, v, h, g):
    xt, vt, ht, gt = (torch.from_numpy(a) for a in (x, v, h, g))
    gv, gh = tsep.sepconv_bwd_vh_plain(xt, vt, ht, gt)
    gx = tsep.sepconv_bwd_x_plain(vt, ht, gt)
    return gx.numpy(), gv.numpy(), gh.numpy()


@pytest.mark.parametrize("ks,H,W,C", CASES)
def test_plain_adjoints_match_pallas_kernels_interpret(ks, H, W, C):
    """Against _sepconv_pallas_bwd_vh_raw and _sepconv_pallas_bwd_x_raw run by
    the Pallas interpreter.  Their f32 path is a 3-pass bf16 hi/lo split,
    hence 2e-3 (the tolerance vfi_tpu's own test of them uses)."""
    from jax.experimental.pallas import tpu as pltpu

    x, v, h, g = _operands(2, H, W, C, ks, seed=ks + C)
    TH = jsep._pick_row_tile_bwd(H, W, ks)
    with pltpu.force_tpu_interpret_mode():
        want_v, want_h = jsep._sepconv_pallas_bwd_vh_raw(*map(jnp.asarray, (x, v, h, g)), row_tile=TH)
        want_x = jsep._sepconv_pallas_bwd_x_raw(*map(jnp.asarray, (v, h, g)), row_tile=TH)
    got_x, got_v, got_h = _plain_adjoints(x, v, h, g)
    for name, got, want in (("grad_x", got_x, want_x), ("grad_v", got_v, want_v), ("grad_h", got_h, want_h)):
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got, np.asarray(want), atol=2e-3, rtol=2e-3, err_msg=name)


@pytest.mark.parametrize("ks,H,W,C", CASES + [(3, 5, 7, 2)])
def test_plain_adjoints_match_jax_autograd(ks, H, W, C):
    x, v, h, g = _operands(2, H, W, C, ks, seed=10 * ks + C)
    _, vjp = jax.vjp(jsep.sepconv_mxu, *map(jnp.asarray, (x, v, h)))
    want = vjp(jnp.asarray(g))
    got = _plain_adjoints(x, v, h, g)
    for name, a, b in zip(("grad_x", "grad_v", "grad_h"), got, want):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-4, rtol=1e-4, err_msg=name)


def test_sepconv_function_against_finite_differences():
    rng = np.random.RandomState(3)
    ks, H, W = 3, 6, 6
    x = torch.from_numpy(rng.uniform(-1, 1, (1, H + ks - 1, W + ks - 1, 1))).requires_grad_()
    v = torch.from_numpy(rng.uniform(0, 1, (1, ks, H, W))).permute(0, 2, 3, 1).requires_grad_()
    h = torch.from_numpy(rng.uniform(0, 1, (1, H, W, ks))).requires_grad_()
    assert torch.autograd.gradcheck(tsep.SepConv.apply, (x, v, h))


def test_sepconv_function_computes_only_the_gradients_asked(monkeypatch):
    x, v, h, g = (torch.from_numpy(a) for a in _operands(1, 6, 6, 1, 5, seed=0))
    calls = []
    for name in ("sepconv_bwd_vh_plain", "sepconv_bwd_x_plain"):
        fn = getattr(tsep, name)
        monkeypatch.setattr(tsep, name, lambda *a, _fn=fn, _n=name: calls.append(_n) or _fn(*a))
    v.requires_grad_()
    (tsep.SepConv.apply(x, v, h) * g).sum().backward()
    assert calls == ["sepconv_bwd_vh_plain"] and v.grad is not None and x.grad is None
    calls.clear()
    x.requires_grad_()
    v.requires_grad_(False)
    (tsep.SepConv.apply(x, v, h) * g).sum().backward()
    assert calls == ["sepconv_bwd_x_plain"] and x.grad is not None
    gv, _ = tsep.sepconv_bwd_vh_plain(x.detach(), v, h, g)
    np.testing.assert_array_equal(v.grad.numpy(), gv.numpy())


def test_adjoint_wrappers_refuse_cpu_tensors_and_bad_shapes():
    x, v, h, g = (torch.from_numpy(a) for a in _operands(1, 6, 6, 1, 5, seed=0))
    before = (tsep.sepconv_bwd_vh_launches, tsep.sepconv_bwd_x_launches)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tsep.sepconv_bwd_vh_cuda(x, v, h, g)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tsep.sepconv_bwd_x_cuda(v, h, g)
    with pytest.raises(ValueError, match="cotangent"):
        tsep.sepconv_bwd_vh_plain(x, v, h, g[:, 1:])
    with pytest.raises(ValueError, match="cotangent"):
        tsep.sepconv_bwd_x_plain(v, h, g[:, :, 1:])
    assert (tsep.sepconv_bwd_vh_launches, tsep.sepconv_bwd_x_launches) == before


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


@pytest.mark.parametrize("H,W", [(4, 6), (5, 7)])
def test_max_pool2_gradient_matches_jax_on_ties(H, W):
    """Planted ties: every 2x2 window holds its maximum twice (bf16
    activations make such ties common).  vfi_tpu splits the cotangent evenly
    among tied elements for even extents; odd extents keep the windowed pool
    on both sides."""
    rng = np.random.RandomState(H)
    x = rng.randint(-3, 3, (2, H, W, 3)).astype(np.float32)
    x[:, 0:H - H % 2:2, 0:W - W % 2:2] = 5.0
    x[:, 1:H - H % 2:2, 1:W - W % 2:2] = 5.0
    ct = rng.uniform(0.5, 1.5, (2, H // 2, W // 2, 3)).astype(np.float32)
    want = jax.grad(lambda a: jnp.sum(jlayers.max_pool2(a) * ct))(jnp.asarray(x))
    xt = _nchw(x).requires_grad_()
    (tlayers.max_pool2(xt) * _nchw(ct)).sum().backward()
    got = np.moveaxis(xt.grad.numpy(), 1, -1)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-6, rtol=0)
    if H % 2 == 0 and W % 2 == 0:
        assert np.allclose(got[0, 0, 0], 0.5 * ct[0, 0, 0])  # the split, not the first argmax

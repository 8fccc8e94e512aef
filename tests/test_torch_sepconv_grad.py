"""The port's sepconv gradient on the CPU: the plain adjoints and the
emulations of the two CUDA adjoint kernels' tiling against the TPU adjoint
kernels (Pallas interpreter), JAX autograd and each other, finite
differences of the autograd Function, the CUDA wrappers' guards, and the
tie-splitting max_pool2 gradient against vfi_tpu."""

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


# Small tiles for the emulations of the adjoint kernels' tiling, so that toy
# shapes meet ragged and multiple row and column tiles.
TILES = dict(tile_h=3, tile_w=16, tile_s=16, tile_u=8)


def _torch_adjoints(impl, xt, vt, ht, gt):
    """(grad_x, grad_v, grad_h) of torch tensors: the plain adjoints, or the
    emulations of the two kernels' tiling at ``TILES``."""
    if impl == "plain":
        gv, gh = tsep.sepconv_bwd_vh_plain(xt, vt, ht, gt)
        return tsep.sepconv_bwd_x_plain(vt, ht, gt), gv, gh
    gv, gh = tsep._sepconv_bwd_vh_tiled(xt, vt, ht, gt, TILES["tile_h"], TILES["tile_w"])
    return tsep._sepconv_bwd_x_tiled(vt, ht, gt, TILES["tile_s"], TILES["tile_u"]), gv, gh


def _plain_adjoints(x, v, h, g, impl="plain"):
    return tuple(a.numpy() for a in _torch_adjoints(impl, *(torch.from_numpy(a) for a in (x, v, h, g))))


@pytest.mark.parametrize("impl,ks,H,W,C", [
    pytest.param("plain", 5, 8, 8, 1, id="5-8-8-1"),
    pytest.param("plain", 4, 8, 10, 3, id="4-8-10-3"),
    pytest.param("tiled", 5, 8, 8, 1, id="tiled-5-8-8-1"),
    pytest.param("tiled", 4, 14, 20, 3, id="tiled-4-14-20-3"),  # 2 column tiles, 2x3 input tiles, ragged
])
def test_plain_adjoints_match_pallas_kernels_interpret(impl, ks, H, W, C):
    """Against _sepconv_pallas_bwd_vh_raw and _sepconv_pallas_bwd_x_raw run by
    the Pallas interpreter: the plain adjoints, and ("tiled") the emulations
    of the two CUDA adjoint kernels' tiling.  The TPU kernels' f32 path is a
    3-pass bf16 hi/lo split, hence 2e-3 (the tolerance vfi_tpu's own test of
    them uses)."""
    from jax.experimental.pallas import tpu as pltpu

    x, v, h, g = _operands(2, H, W, C, ks, seed=ks + C)
    TH = jsep._pick_row_tile_bwd(H, W, ks)
    with pltpu.force_tpu_interpret_mode():
        want_v, want_h = jsep._sepconv_pallas_bwd_vh_raw(*map(jnp.asarray, (x, v, h, g)), row_tile=TH)
        want_x = jsep._sepconv_pallas_bwd_x_raw(*map(jnp.asarray, (v, h, g)), row_tile=TH)
    got_x, got_v, got_h = _plain_adjoints(x, v, h, g, impl)
    for name, got, want in (("grad_x", got_x, want_x), ("grad_v", got_v, want_v), ("grad_h", got_h, want_h)):
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got, np.asarray(want), atol=2e-3, rtol=2e-3, err_msg=name)


def _bf16_ulp(t):
    """The spacing of bf16 numbers at |t| (8 significant bits)."""
    return torch.exp2(torch.floor(torch.log2(t.abs().clamp_min(2.0**-126))) - 7)


@pytest.mark.parametrize("impl,ks,H,W,C,g_stride0", [
    pytest.param("plain", 5, 8, 8, 1, False, id="5-8-8-1"),
    pytest.param("plain", 4, 8, 10, 3, False, id="4-8-10-3"),
    pytest.param("plain", 3, 5, 7, 2, False, id="3-5-7-2"),
    pytest.param("tiled", 5, 8, 8, 1, False, id="tiled-5-8-8-1"),
    pytest.param("tiled", 4, 14, 20, 3, True, id="tiled-4-14-20-3-g_stride0"),
    pytest.param("tiled", 6, 7, 37, 2, False, id="tiled-6-7-37-2"),  # 3 column tiles, the last ragged
])
def test_plain_adjoints_match_jax_autograd(impl, ks, H, W, C, g_stride0):
    """The plain adjoints against JAX autograd of vfi_tpu's sepconv_mxu (1e-4);
    ("tiled") the emulations of the two CUDA adjoint kernels' tiling against
    the plain adjoints: f32 within 1e-5 (the bf16 hi/lo split's own error),
    and on bf16 operands within one bf16 ulp of the f32 plain result on the
    same inputs (x, g >= 0 there: no cancellation, so an ulp of every output
    is meaningful).  g_stride0: one cotangent value per image, expanded."""
    x, v, h, g = _operands(2, H, W, C, ks, seed=10 * ks + C)
    if g_stride0:
        g = np.broadcast_to(g[:, :1, :1], g.shape)
    if impl == "plain":
        _, vjp = jax.vjp(jsep.sepconv_mxu, *map(jnp.asarray, (x, v, h)))
        want = vjp(jnp.asarray(g))
        got = _plain_adjoints(x, v, h, np.ascontiguousarray(g))
        for name, a, b in zip(("grad_x", "grad_v", "grad_h"), got, want):
            np.testing.assert_allclose(a, np.asarray(b), atol=1e-4, rtol=1e-4, err_msg=name)
        return
    names = ("grad_x", "grad_v", "grad_h")
    xt, vt, ht = (torch.from_numpy(a) for a in (x, v, h))
    vt = vt.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)  # the kernel heads' layout
    gt = torch.from_numpy(g[:, :1, :1].copy()).expand(g.shape) if g_stride0 else torch.from_numpy(g)
    want = _torch_adjoints("plain", xt, vt, ht, gt)
    for name, a, b in zip(names, _torch_adjoints("tiled", xt, vt, ht, gt), want):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=0, err_msg=f"f32 {name}")
    xb, vb, hb, gb = ((t.abs() if t is xt or t is gt else t).bfloat16() for t in (xt, vt, ht, gt))
    want = _torch_adjoints("plain", *(t.float() for t in (xb, vb, hb, gb)))
    for name, a, b in zip(names, _torch_adjoints("tiled", xb, vb, hb, gb), want):
        assert a.dtype == torch.bfloat16, name
        ulps = float(((a.float() - b).abs() / _bf16_ulp(b)).max())
        assert ulps <= 1.0, f"bf16 {name}: {ulps} ulps"


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

"""The port's ``sepconv(impl=...)`` routes against vfi_tpu's on the CPU: each
impl's forward and gradient, the emulation of the banded CUDA kernel's tiling
against the TPU kernel it replaces (Pallas interpreter), the dispatch and the
wrapper's guards, a bi-TAI model with ``sepconv_impl="pallas"``, and the
color golden that chip_smoke.py holds the card against."""

import contextlib
import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import chip_smoke
from vfi_tpu.models.fill_in import TAIFillInModel as JTAI
from vfi_tpu_torch.api import VideoInpainter
from vfi_tpu_torch.models.registry import create_model
from vfi_tpu_torch.nn.kernelnet import KernelNet
from vfi_tpu_torch.ops import sepconv as tsep
from vfi_tpu_torch.utils.params import params_from_jax, random_jax_params
from . import torch_threads  # noqa: F401  (one torch thread per xdist worker)

jsep = importlib.import_module("vfi_tpu.ops.sepconv")  # vfi_tpu.ops re-exports a function of that name
PALLAS = ("pallas", "pallas_mxu")


def _operands(B, H, W, C, ks, seed):
    """x in [-1, 1], v and h in [0, 2/ks] (O(1) outputs), cotangent g in [-1, 1]."""
    rng = np.random.RandomState(seed)
    x = rng.uniform(-1, 1, (B, H + ks - 1, W + ks - 1, C)).astype(np.float32)
    v = rng.uniform(0, 2.0 / ks, (B, H, W, ks)).astype(np.float32)
    h = rng.uniform(0, 2.0 / ks, (B, H, W, ks)).astype(np.float32)
    g = rng.uniform(-1, 1, (B, H, W, C)).astype(np.float32)
    return x, v, h, g


def _global_rel(got, want) -> float:
    num = sum(float(np.sum((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)) for a, b in zip(got, want))
    den = sum(float(np.sum(np.asarray(b, np.float64) ** 2)) for b in want)
    return (num / den) ** 0.5


def _interpret(impl):
    return pltpu.force_tpu_interpret_mode() if impl in PALLAS else contextlib.nullcontext()


@pytest.mark.parametrize("impl", tsep.IMPLS)
@pytest.mark.parametrize("H,W,C,ks", [(4, 136, 3, 5), (8, 10, 1, 4)])
def test_sepconv_impl_matches_jax(impl, H, W, C, ks):
    """Forward within 1e-5 (1.5e-7 at most measured) and 1e-4 for pallas_mxu,
    whose TPU kernel runs f32 as a bf16 hi/lo split, ~2^-16 per product
    (3.4e-6 measured); the gradient of all three operands within 1e-4
    global-L2-relative (8.3e-8 at most measured).  The Pallas ones run in
    the interpreter; their backward is XLA's adjoint of sepconv_mxu."""
    x, v, h, g = _operands(2, H, W, C, ks, seed=H + W + C + ks)
    with _interpret(impl):
        want, vjp = jax.vjp(lambda *a: jsep.sepconv(*a, impl=impl), *map(jnp.asarray, (x, v, h)))
        want_grads = vjp(jnp.asarray(g))
    xt, vt, ht = (torch.from_numpy(a).requires_grad_() for a in (x, v, h))
    got = tsep.sepconv(xt, vt, ht, impl=impl)
    (got * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-4 if impl == "pallas_mxu" else 1e-5,
                               rtol=0)
    assert _global_rel([t.grad.numpy() for t in (xt, vt, ht)], want_grads) <= 1e-4


@pytest.mark.parametrize("H,W,C,ks", [
    (4, 136, 1, 5),  # two column tiles, the second ragged
    (3, 45, 3, 5),  # one ragged tile, three channels
    (2, 136, 3, 51),  # the full tap count, wide
])
def test_mxu_tiling_emulation_matches_the_tpu_kernel(H, W, C, ks):
    """_sepconv_mxu_tiled against _sepconv_pallas_mxu_raw (interpreter): the
    same bf16 hi/lo split in f32, so only the order of the f32 sums differs
    (6.0e-8 at most measured on these cases, gate 1e-5); bf16 operands within
    one bf16 ulp (equal here).  Against sepconv_direct, the split's own error
    (4.6e-6 at most measured, gate 1e-4)."""
    x, v, h, _ = _operands(2, H, W, C, ks, seed=W + C + ks)
    th = jsep._pick_row_tile_mxu(H, W, ks, 4)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jsep._sepconv_pallas_mxu_raw(*map(jnp.asarray, (x, v, h)), row_tile=th))
        want16 = np.asarray(jsep._sepconv_pallas_mxu_raw(*(jnp.asarray(a, jnp.bfloat16) for a in (x, v, h)),
                                                         row_tile=th)).astype(np.float32)
    xt, vt, ht = (torch.from_numpy(a) for a in (x, v, h))
    got = tsep._sepconv_mxu_tiled(xt, vt, ht).numpy()
    got16 = tsep._sepconv_mxu_tiled(xt.bfloat16(), vt.bfloat16(), ht.bfloat16()).float().numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got16, want16, atol=0, rtol=2.0**-7)
    np.testing.assert_allclose(got, tsep.sepconv_direct(xt, vt, ht).numpy(), atol=1e-4, rtol=0)


def test_cpu_routes_take_the_plain_versions(monkeypatch):
    """None is "mxu" on the CPU; the Pallas names take the plain forward of
    their formulation and the plain adjoints."""
    x, v, h, g = (torch.from_numpy(a) for a in _operands(1, 6, 7, 2, 5, seed=0))
    same = dict(rtol=0, atol=0)
    torch.testing.assert_close(tsep.sepconv(x, v, h), tsep.sepconv_banded(x, v, h), **same)
    torch.testing.assert_close(tsep.sepconv(x, v, h, impl="direct"), tsep.sepconv_direct(x, v, h), **same)
    torch.testing.assert_close(tsep.sepconv(x, v, h, impl="pallas"), tsep.sepconv_direct(x, v, h), **same)
    torch.testing.assert_close(tsep.sepconv(x, v, h, impl="pallas_mxu"), tsep.sepconv_banded(x, v, h), **same)
    calls = []
    for name in ("sepconv_bwd_vh_plain", "sepconv_bwd_x_plain"):
        fn = getattr(tsep, name)
        monkeypatch.setattr(tsep, name, lambda *a, _fn=fn, _n=name: calls.append(_n) or _fn(*a))
    for impl in (None, "mxu", "direct", "pallas", "pallas_mxu"):
        calls.clear()
        vg = v.clone().requires_grad_()
        (tsep.sepconv(x, vg, h, impl=impl) * g).sum().backward()
        assert calls == (["sepconv_bwd_vh_plain"] if impl in PALLAS else []), impl
        torch.testing.assert_close(vg.grad, tsep.sepconv_bwd_vh_plain(x, v, h, g)[0], rtol=1e-5, atol=1e-6)


def test_unknown_impl_raises_and_the_kernel_wrapper_refuses_cpu_tensors():
    x, v, h, _ = (torch.from_numpy(a) for a in _operands(1, 6, 6, 1, 5, seed=1))
    with pytest.raises(ValueError, match="unknown sepconv impl 'xla'"):
        tsep.sepconv(x, v, h, impl="xla")
    with pytest.raises(ValueError, match="unknown sepconv impl"):
        KernelNet(8, 5, sepconv_impl="triton")
    before = (tsep.sepconv_fwd_mxu_launches, tsep.sepconv_fwd_launches)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tsep.sepconv_fwd_mxu_cuda(x, v, h)
    assert (tsep.sepconv_fwd_mxu_launches, tsep.sepconv_fwd_launches) == before


def test_tai_with_sepconv_impl_pallas_matches_jax():
    """A JSON-style spec with ``sepconv_impl`` builds the model; the field
    holds no weights; the forward matches vfi_tpu's with the same field (its
    Pallas kernel in the interpreter) within 1e-5 (1.1e-6 measured)."""
    kw = dict(gf_dim=8, c_dim=1, feature_size=3, ks=5, num_block=5, kf_dim=4, layers=3)
    spec = {"class": "TAIFillInModel", "kwargs": dict(kw, sepconv_impl="pallas")}
    jp = random_jax_params(spec, seed=3)
    plain = random_jax_params({"class": "TAIFillInModel", "kwargs": kw}, seed=3)
    assert all(np.array_equal(a, b) for a, b in zip(jax.tree_util.tree_leaves(jp), jax.tree_util.tree_leaves(plain)))
    model = create_model(spec)
    assert model.kernelnet.sepconv_impl == "pallas"
    model.load_state_dict(params_from_jax(jp))
    model.eval()

    B, K, T, F, H, W = 1, 2, 2, 2, 32, 32
    rng = np.random.RandomState(4)
    p = rng.uniform(-1, 1, (B, K, H, W, 1)).astype(np.float32)
    f = rng.uniform(-1, 1, (B, F, H, W, 1)).astype(np.float32)
    jmodel = JTAI(**kw, sepconv_impl="pallas")
    with pltpu.force_tpu_interpret_mode():
        want = jax.jit(lambda prm, a, b: jmodel.apply({"params": prm}, T, a, b))(jp, p, f)
    with torch.no_grad():
        got = model(T, torch.from_numpy(p), torch.from_numpy(f))
    for key in ("pred", "interp_net_outputs_1", "interp_net_outputs_2"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=1e-5, rtol=0, err_msg=key)


def test_color_golden_fixture_matches_chip_smoke():
    z = np.load(chip_smoke.COLOR_GOLDEN_PATH)
    cfg = chip_smoke.COLOR_GOLDEN
    assert {k: z[k].item() for k in cfg} == cfg
    np.testing.assert_array_equal(z["points"], chip_smoke.golden_points())
    assert z["pred_u8"].shape == (cfg["B"], cfg["T"], cfg["H"], cfg["W"], cfg["C"]) and z["pred_u8"].dtype == np.uint8
    for key in chip_smoke.PRED_KEYS:
        vals = z[f"{key}_at_points"]
        assert vals.shape == (cfg["n_points"],) and vals.dtype == np.float32 and np.isfinite(vals).all()
    np.testing.assert_array_equal(chip_smoke.u8(z["pred_at_points"]), z["pred_u8"].reshape(-1)[z["points"]])
    assert os.path.getsize(chip_smoke.COLOR_GOLDEN_PATH) < 1e6


@pytest.mark.slow
def test_full_width_color_forward_matches_golden():
    """The port on the CPU at the TAI_color width (256x320) against the JAX
    golden (measured: max-abs 7.5e-7 on pred, 8.7e-6 on the MC-Net outputs;
    pred's uint8 frames at 96.0 dB)."""
    cfg = chip_smoke.COLOR_GOLDEN
    z = np.load(chip_smoke.COLOR_GOLDEN_PATH)
    ip = VideoInpainter(cfg["model_key"], params_from_jax(random_jax_params(cfg["model_key"], cfg["param_seed"])),
                        device="cpu")
    p, f = chip_smoke.golden_inputs(cfg)
    with torch.inference_mode():
        out = ip.model(cfg["T"], torch.from_numpy(p), torch.from_numpy(f))
    res = chip_smoke.check_color_golden(out, z)
    for key in chip_smoke.PRED_KEYS:
        assert res[f"{key}_max_abs"] <= 5e-3, (key, res)
    assert res["pred_u8_psnr_db"] >= 45.0, res

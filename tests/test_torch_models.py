"""vfi_tpu_torch.models against vfi_tpu.models on the CPU: the bi-TAI and
bi-TWI forwards at toy widths, the registry (all 30 of vfi_tpu's keys), and
the weight map."""

import importlib.util
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vfi_tpu.models import fill_in as jfill
from vfi_tpu.models import registry as jregistry
from vfi_tpu_torch.models import fill_in as tfill
from vfi_tpu_torch.models.registry import create_model, model_keys
from vfi_tpu_torch.utils.params import params_from_jax, random_jax_params
from . import torch_threads  # noqa: F401  (one torch thread per xdist worker)

TOL = dict(atol=3e-4, rtol=1e-3)
TOY = dict(gf_dim=8, feature_size=3, ks=5, kf_dim=4, layers=3)
OUT_KEYS = ("pred", "pred_forward", "pred_backward", "interp_net_outputs_1", "interp_net_outputs_2")


def _toy_spec(cls, c_dim, num_block):
    return {"class": cls, "kwargs": dict(TOY, c_dim=c_dim, num_block=num_block)}


@pytest.mark.parametrize("cls,c_dim,num_block,K,F", [
    ("TAIFillInModel", 1, 5, 3, 3),  # TAI_gray-like: doubled-batch rollout, ratio plane at dec3
    ("TAIFillInModel", 3, 4, 3, 3),  # TAI_color-like: the ratio plane is never injected
    ("TAIFillInModel", 1, 5, 3, 4),  # K != F: two separate rollouts
    ("TWIFillInModel", 1, 5, 3, 3),  # time-weighted blend, no ratio plane
])
def test_fill_in_forward_matches_jax(cls, c_dim, num_block, K, F):
    spec = _toy_spec(cls, c_dim, num_block)
    jp = random_jax_params(spec, seed=c_dim + num_block)
    model = create_model(spec)
    model.load_state_dict(params_from_jax(jp))
    model.eval()

    B, T, H, W = 2, 2, 32, 32
    rng = np.random.RandomState(K + F)
    p = rng.uniform(-1, 1, (B, K, H, W, c_dim)).astype(np.float32)
    f = rng.uniform(-1, 1, (B, F, H, W, c_dim)).astype(np.float32)

    jmodel = getattr(jfill, cls)(**spec["kwargs"])
    want = jax.jit(lambda prm, a, b: jmodel.apply({"params": prm}, T, a, b))(jp, p, f)
    with torch.no_grad():
        got = model(T, torch.from_numpy(p), torch.from_numpy(f))
    assert sorted(got) == sorted(OUT_KEYS)
    for key in OUT_KEYS:
        assert tuple(got[key].shape) == (B, T, H, W, c_dim), key
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), err_msg=key, **TOL)


def test_diff_frames_and_fold_match_jax():
    rng = np.random.RandomState(5)
    frames = rng.uniform(-1, 1, (2, 4, 6, 5, 3)).astype(np.float32)
    np.testing.assert_allclose(tfill._diff_frames(torch.from_numpy(frames)).numpy(),
                               np.asarray(jfill._diff_frames(jnp.asarray(frames))), atol=1e-6, rtol=0)
    tm = rng.uniform(-1, 1, (3, 2, 4)).astype(np.float32)  # [T, B, ...]
    np.testing.assert_array_equal(tfill._fold(torch.from_numpy(tm)).numpy(), np.asarray(jfill._fold(jnp.asarray(tm))))
    np.testing.assert_array_equal(tfill._bt(torch.from_numpy(tm)).numpy(), np.asarray(jfill._bt(jnp.asarray(tm))))


@pytest.mark.parametrize("key", ["TAI_gray", "TAI_color", "TimeWeightedInterpolationFillInModel_gray",
                                 "TimeWeightedInterpolationFillInModel_color", "MCNet_gray", "MCNet_color",
                                 "BidirectionalSimpleAverageFillInModel_color",
                                 "BidirectionalTimeWeightedAverageFillInModel_gray", "TimeWeightedPFFillInModel",
                                 "SloMoFillInModel_gray", "SloMoFillInModel_color", "SCTSkipConScaledTForward_gray",
                                 "SCTSkipConScaledTInward_color", "SCTSkipConScaledTRandom_gray",
                                 "SCTSkipConScaledTRandomB_color", "SCTSkipConScaledTRandomC_gray",
                                 "SCTSkipConScaledTRandomD_color", "SCTBypassScaledTForward_gray",
                                 "SCTFrameEncDecBNSkipConScaledTForward_color"])
def test_random_jax_params_match_the_flax_tree(key):
    """Every flax parameter of the JAX model, with its shape, and nothing else;
    and every port parameter is filled from it."""
    jmodel = jregistry.create_model(key)
    c = getattr(jmodel, "c_dim", 1)
    spec = jax.ShapeDtypeStruct((1, 2, 64, 64, c), np.float32)
    rngs = {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)}  # "sample": SCT's random orders
    template = jax.eval_shape(lambda a, b: jmodel.init(rngs, 2, a, b), spec, spec).get("params", {})
    want = {tuple(k.key for k in path): leaf.shape for path, leaf in jax.tree_util.tree_flatten_with_path(template)[0]}

    jp = random_jax_params(key, seed=0)
    got = {tuple(k.key for k in path): leaf.shape for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]}
    assert got == want

    state = params_from_jax(jp)
    with torch.device("meta"):
        port = create_model(key)
    assert set(state) == set(port.state_dict())
    for name, t in port.state_dict().items():
        assert tuple(state[name].shape) == tuple(t.shape), name


def test_random_jax_params_are_seeded():
    spec = _toy_spec("TAIFillInModel", 1, 5)
    a, b, c = (random_jax_params(spec, seed=s) for s in (0, 0, 1))
    flat = lambda tree: jax.tree_util.tree_leaves(tree)  # noqa: E731
    assert all(np.array_equal(x, y) for x, y in zip(flat(a), flat(b)))
    assert not all(np.array_equal(x, y) for x, y in zip(flat(a), flat(c)))


def test_params_from_jax_conv_layout():
    kernel = np.arange(3 * 5 * 2 * 4, dtype=np.float32).reshape(3, 5, 2, 4)  # HWIO
    bias = np.arange(4, dtype=np.float32)
    state = params_from_jax({"kernelnet": {"up0": {"kernel": kernel, "bias": bias}}})
    assert sorted(state) == ["kernelnet.up0.bias", "kernelnet.up0.weight"]
    w = state["kernelnet.up0.weight"].numpy()
    assert w.shape == (4, 2, 3, 5)  # OIHW
    assert w[3, 1, 2, 4] == kernel[2, 4, 1, 3]
    np.testing.assert_array_equal(state["kernelnet.up0.bias"].numpy(), bias)


def test_registry_keys():
    """The ported keys are vfi_tpu's 30 keys, with vfi_tpu's classes and
    widths; OFFillInModel builds where OpenCV and scipy import (and raises an
    ImportError naming the package where not); the legacy SCT classes build
    from JSON keys."""
    assert model_keys() == sorted(jregistry.model_keys()) and len(model_keys()) == 30
    of_packages = all(importlib.util.find_spec(m) is not None for m in ("cv2", "scipy"))
    for key in model_keys():
        if key == "OFFillInModel" and not of_packages:
            with pytest.raises(ImportError, match="OFFillInModel needs"):
                create_model(key)
            continue
        with torch.device("meta"):
            port = create_model(key)
        jm = jregistry.create_model(key)
        assert type(port).__name__ == type(jm).__name__
        assert getattr(port, "c_dim", 1) == getattr(jm, "c_dim", 1)
        for field in ("gf_dim", "base_dim", "warp_mode", "num_blocks", "num_heads", "d_v", "d_ff", "frame_norm",
                      "enc_return_all", "dec_enc_attend"):
            if hasattr(jm, field):
                assert getattr(port, field) == getattr(jm, field), (key, field)
        if hasattr(jm, "ks"):
            assert (port.kernelnet.ks, port.kernelnet.num_block) == (jm.ks, jm.num_block)
    for cls in ("SCTSkipConFillInModel", "SCTSuperSkipConFillInModel"):
        key = json.dumps({"class": cls, "args": [], "kwargs": {"c_dim": 1, "num_blocks": 2, "num_heads": 3,
                                                              "d_v": 256, "d_ff": 2048}})
        with torch.device("meta"):
            port = create_model(key)
        jm = jregistry.create_model(key)
        assert type(port).__name__ == type(jm).__name__ == cls
        assert (port.enc_return_all, port.dec_enc_attend) == (jm.enc_return_all, jm.dec_enc_attend)

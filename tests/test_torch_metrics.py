"""vfi_tpu_torch.ops.metrics and the evaluation environment against vfi_tpu
on the CPU.  Gates: quantize_uint8 equal; PSNR within 1e-4 dB and SSIM
within 1e-6 on the same uint8-valued arrays (both in float32, summed in
different orders); eval_metrics of a toy TAI from the same weights within
the same gates, L2 within rel 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vfi_tpu.models.fill_in import TAIFillInModel as JTAI
from vfi_tpu.ops import metrics as jmetrics
from vfi_tpu.train import environments as jenvs
from vfi_tpu.utils.config import TrainConfig as JTrainConfig
from vfi_tpu_torch.models.registry import create_model
from vfi_tpu_torch.ops import metrics as tmetrics
from vfi_tpu_torch.train.environments import BaseEnvironment, create_eval_environment
from vfi_tpu_torch.utils.config import TrainConfig
from vfi_tpu_torch.utils.params import params_from_jax, random_jax_params
from . import torch_threads  # noqa: F401  (one torch thread per xdist worker)


def _pairs(shape, seed):
    """uint8-valued frame pairs: noise, a near copy (high PSNR), constant (SSIM's C1/C2 terms), identical."""
    rng = np.random.RandomState(seed)
    a = rng.randint(0, 256, shape).astype(np.float32)
    near = np.clip(a + rng.randint(-2, 3, shape), 0, 255).astype(np.float32)
    const = np.full(shape, 77, np.float32)
    return [(a, rng.randint(0, 256, shape).astype(np.float32)), (a, near), (const, a), (a, a)]


@pytest.mark.parametrize("shape", [(2, 3, 16, 16, 1), (3, 9, 12, 3), (1, 2, 7, 7, 1)])
def test_psnr_ssim_match_vfi_tpu(shape):
    for i, (x, y) in enumerate(_pairs(shape, seed=len(shape))):
        for clamp in (None, 100.0):
            got = tmetrics.psnr(torch.from_numpy(x), torch.from_numpy(y), clamp=clamp).numpy()
            want = np.asarray(jmetrics.psnr(jnp.asarray(x), jnp.asarray(y), clamp=clamp))
            assert got.shape == want.shape == shape[:-3]
            np.testing.assert_allclose(got, want, atol=1e-4, rtol=0, err_msg=f"pair {i} clamp {clamp}")
        got = tmetrics.ssim(torch.from_numpy(x), torch.from_numpy(y)).numpy()
        want = np.asarray(jmetrics.ssim(jnp.asarray(x), jnp.asarray(y)))
        assert got.shape == want.shape == shape[:-3]
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0, err_msg=f"pair {i}")


def test_quantize_uint8_matches_vfi_tpu():
    x = np.random.RandomState(0).uniform(-1.2, 1.2, (4, 5, 9, 3)).astype(np.float32)
    x[0, 0, 0] = [-1.0, 1.0, 0.5 / 255 * 2 - 1]  # the ends and a rounding tie
    got = tmetrics.quantize_uint8(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jmetrics.quantize_uint8(jnp.asarray(x))))
    assert got.min() == 0 and got.max() == 255


def test_eval_metrics_match_vfi_tpu():
    """A toy TAI from the same weights scores the same batch alike."""
    spec = {"class": "TAIFillInModel", "kwargs": dict(gf_dim=8, c_dim=1, feature_size=3, ks=5, num_block=5,
                                                      kf_dim=4, layers=3)}
    K, T, F = 3, 2, 3
    g = random_jax_params(spec, 21)
    targets = np.random.RandomState(22).uniform(-1, 1, (2, K + T + F, 32, 32, 1)).astype(np.float32)
    jenv = jenvs.create_eval_environment(JTAI(**spec["kwargs"]), JTrainConfig(K=K, T=T, F=F))
    want = {k: np.asarray(v) for k, v in jenv.eval_metrics(g, K, T, F, jnp.asarray(targets)).items()}

    model = create_model(spec)
    model.load_state_dict(params_from_jax(g))
    env = create_eval_environment(model.eval(), TrainConfig(K=K, T=T, F=F))
    assert isinstance(env, BaseEnvironment) and env.needs_snapshot
    got = {k: v.numpy() for k, v in env.eval_metrics(K, T, F, targets).items()}
    assert sorted(got) == sorted(want) == ["l2", "psnr", "ssim"]
    for k in want:
        assert got[k].shape == want[k].shape == (2, T)
    np.testing.assert_allclose(got["psnr"], want["psnr"], atol=1e-4, rtol=0)
    np.testing.assert_allclose(got["ssim"], want["ssim"], atol=1e-6, rtol=0)
    np.testing.assert_allclose(got["l2"], want["l2"], rtol=1e-5, atol=0)
    out = env.forward_test(T, torch.from_numpy(targets[:, :K]), torch.from_numpy(targets[:, K + T:]))
    assert out["pred"].shape == (2, T, 32, 32, 1) and not out["pred"].requires_grad
    assert not create_eval_environment(torch.nn.Identity(), TrainConfig(K=K, T=T, F=F)).needs_snapshot

"""The port's training losses, SN discriminator and discriminator weight map
against vfi_tpu on the CPU at toy widths."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vfi_tpu.nn.discriminator import SNDiscriminator as JDisc
from vfi_tpu.train import losses as jlosses
from vfi_tpu_torch.nn.discriminator import SNDiscriminator
from vfi_tpu_torch.train import losses as tlosses
from vfi_tpu_torch.utils.config import TrainConfig
from vfi_tpu_torch.utils.params import disc_variables_from_jax, random_jax_disc_variables
from . import torch_threads  # noqa: F401  (one torch thread per xdist worker)


def test_losses_match_jax():
    rng = np.random.RandomState(0)
    pred = rng.uniform(0, 1, (2, 3, 9, 7, 3)).astype(np.float32)
    gt = rng.uniform(0, 1, (2, 3, 9, 7, 3)).astype(np.float32)
    logits = rng.standard_normal((2, 5)).astype(np.float32) * 3
    labels = (rng.uniform(size=(2, 5)) > 0.5).astype(np.float32)
    pairs = [
        (jlosses.gdl_loss(pred, gt), tlosses.gdl_loss(torch.from_numpy(pred), torch.from_numpy(gt))),
        (jlosses.l2_loss(pred, gt), tlosses.l2_loss(torch.from_numpy(pred), torch.from_numpy(gt))),
        (jlosses.l1_loss(pred, gt), tlosses.l1_loss(torch.from_numpy(pred), torch.from_numpy(gt))),
        (jlosses.bce_with_logits(logits, labels),
         tlosses.bce_with_logits(torch.from_numpy(logits), torch.from_numpy(labels))),
    ]
    for want, got in pairs:
        assert got.ndim == 0
        assert float(got) == pytest.approx(float(want), rel=1e-5)  # f32 means summed in another order


@pytest.mark.parametrize("K,T,F,window", [(3, 2, 3, 3), (5, 5, 5, 3), (2, 3, 2, 2), (1, 1, 4, 3)])
def test_disc_window_labels_match_jax(K, T, F, window):
    want = np.asarray(jlosses.disc_window_labels(K, T, F, window))
    got = tlosses.disc_window_labels(K, T, F, window)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def _disc_pair(c_dim, H, W, Ip, seed):
    cfg = TrainConfig(K=3, T=2, F=3, df_dim=8, Ip=Ip, disc_window_size=3)
    variables = random_jax_disc_variables(cfg, H, W, c_dim, seed)
    disc = SNDiscriminator(cfg.disc_window_size, c_dim, (H, W), cfg.df_dim, cfg.Ip)
    disc.load_state_dict(disc_variables_from_jax(variables))
    return variables, JDisc(window_size=3, df_dim=8, Ip=Ip), disc


def test_random_disc_variables_have_the_flax_init_tree():
    """Same paths and shapes as vfi_tpu's SNDiscriminator.init (H != W)."""
    variables, jdisc, _ = _disc_pair(3, 32, 48, 1, seed=0)
    init = jax.eval_shape(jdisc.init, jax.random.PRNGKey(0), jnp.zeros((1, 8, 32, 48, 3)))
    want = jax.tree_util.tree_map(lambda a: a.shape, {"params": init["params"], "sn": init["sn"]})
    got = jax.tree_util.tree_map(lambda a: a.shape, variables)
    assert got == want


@pytest.mark.parametrize("c_dim,H,W,Ip", [
    (1, 32, 32, 3),  # TAI_gray-like, vfi_tpu's default Ip
    (3, 32, 48, 1),  # color, H != W: the head's flatten order is checked
])
def test_discriminator_matches_jax(c_dim, H, W, Ip):
    variables, jdisc, disc = _disc_pair(c_dim, H, W, Ip, seed=c_dim)
    video = np.random.RandomState(5).uniform(-1, 1, (2, 8, H, W, c_dim)).astype(np.float32)

    want_eval = jax.jit(lambda v, x: jdisc.apply(v, x, train=False))(variables, video)
    want_train, mut = jax.jit(lambda v, x: jdisc.apply(v, x, train=True, mutable=["sn"]))(variables, video)
    u_before = {k: v.clone() for k, v in disc.state_dict().items() if k.endswith(".u")}
    with torch.no_grad():
        got_eval = disc(torch.from_numpy(video), train=False)
        assert all(torch.equal(disc.state_dict()[k], u) for k, u in u_before.items())  # eval writes no u
        got_train = disc(torch.from_numpy(video), train=True)

    assert tuple(got_eval.shape) == (2, 6)
    np.testing.assert_allclose(got_eval.numpy(), np.asarray(want_eval), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got_train.numpy(), np.asarray(want_train), atol=1e-5, rtol=1e-5)
    want_u = disc_variables_from_jax({"params": variables["params"], "sn": mut["sn"]})
    for key in u_before:
        np.testing.assert_allclose(disc.state_dict()[key].numpy(), want_u[key].numpy(), atol=1e-5, rtol=0,
                                   err_msg=key)
        assert not torch.equal(disc.state_dict()[key], u_before[key]), key


def test_discriminator_weight_gradients_match_jax():
    """Sigma carries no gradient on either side."""
    variables, jdisc, disc = _disc_pair(1, 32, 32, 1, seed=4)
    video = np.random.RandomState(6).uniform(-1, 1, (2, 6, 32, 32, 1)).astype(np.float32)
    want = jax.jit(jax.grad(lambda p: jnp.sum(jdisc.apply({"params": p, "sn": variables["sn"]}, video,
                                                          train=False) ** 2)))(variables["params"])
    want = disc_variables_from_jax({"params": want})
    (disc(torch.from_numpy(video), train=False) ** 2).sum().backward()
    for name, p in disc.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), atol=1e-5, rtol=1e-4, err_msg=name)


def test_discriminator_runs_on_bf16_weights_with_f32_power_iteration():
    """Under mixed precision the weights arrive as bf16 copies; u stays f32."""
    _, _, disc = _disc_pair(1, 32, 32, 1, seed=2)
    params = {k: p.detach().to(torch.bfloat16) for k, p in disc.named_parameters()}
    video = torch.zeros(1, 4, 32, 32, 1, dtype=torch.bfloat16)
    logits = torch.func.functional_call(disc, params, (video,), {"train": True})
    assert logits.dtype == torch.bfloat16 and tuple(logits.shape) == (1, 2)
    assert all(b.dtype == torch.float32 for b in disc.buffers())

"""The SCT conv-transformer family in vfi_tpu_torch against vfi_tpu on the CPU
at a toy width (d_v 16, 2 heads, 16x16 frames): the transformer blocks, all
8 variants and the 2 legacy classes with their random orders pinned on both
sides, the teacher-forced pass, one SCTEnvironment step on each
teacher-forcing branch, the teacher-forcing schedule, the pooling gradient on
tied inputs, the port's order draws, and the golden that chip_smoke.py holds
the card against.

vfi_tpu draws a random order per row with ``jax.vmap(jax.random.permutation)``
and the port with ``_draw_orders``; the tests replace vfi_tpu's ``jax.vmap``
inside ``vfi_tpu.models.sct`` (no vfi_tpu file changes) and the port's
``_draw_orders`` with the same fixed permutations."""

import os
import types

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import chip_smoke
from vfi_tpu.models import legacy_sct as jlegacy
from vfi_tpu.models import sct as jsct
from vfi_tpu.nn import transformer as jtr
from vfi_tpu.nn.discriminator import SNDiscriminator as JDisc
from vfi_tpu.train import environments as jenvs
from vfi_tpu.utils.config import TrainConfig as JTrainConfig
from vfi_tpu_torch.models import sct as tsct
from vfi_tpu_torch.models.registry import create_model
from vfi_tpu_torch.nn import transformer as ttr
from vfi_tpu_torch.train.environments import SCTEnvironment, create_training_environment
from vfi_tpu_torch.utils.config import TrainConfig
from vfi_tpu_torch.utils.params import (disc_variables_from_jax, params_from_jax, random_jax_disc_variables,
                                        random_jax_params)
from . import torch_threads  # noqa: F401  (one torch thread per xdist worker)

B, K, T, F_, HW = 2, 3, 2, 2, 16
TOY = dict(num_blocks=1, num_heads=2, d_v=16, d_ff=32)
SKIP_CONNECTED = ("SCTSkipConScaledTRandomCFillInModel", "SCTSkipConScaledTRandomDFillInModel",
                  "SCTSuperSkipConFillInModel")  # two blocks, so that their levels pair across
PERMS = np.array([[1, 0], [0, 1]])
VARIANTS = [(jsct, name) for name in sorted(c.__name__ for c in jsct.SCT_CLASSES.values())] + [
    (jlegacy, "SCTSkipConFillInModel"), (jlegacy, "SCTSuperSkipConFillInModel")]


def _global_rel(got: dict, want: dict) -> float:
    assert sorted(got) == sorted(want)
    num = sum(float(((got[k].double() - want[k].double()) ** 2).sum()) for k in want)
    den = sum(float((want[k].double() ** 2).sum()) for k in want)
    return (num / den) ** 0.5


def _seq(a: np.ndarray) -> torch.Tensor:
    """[B, T, H, W, C] numpy -> [B, T, C, H, W] torch."""
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 1, 4, 2, 3)))


def _random_tree(tree, rng):
    """Random values shaped like a flax params tree: kernels He-normal, norm
    scales 1 plus small normals, biases small normals (sorted key order)."""
    out = {}
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            out[k] = _random_tree(v, rng)
        elif k == "kernel":
            out[k] = (rng.standard_normal(v.shape) * np.sqrt(2.0 / np.prod(v.shape[:-1]))).astype(np.float32)
        else:
            out[k] = (float(k == "scale") + rng.standard_normal(v.shape) * 0.1).astype(np.float32)
    return out


@pytest.fixture
def pinned_orders(monkeypatch):
    """Both packages generate the rows' frames in the orders PERMS."""
    fake = types.SimpleNamespace(**{k: getattr(jax, k) for k in dir(jax) if not k.startswith("__")})
    fake.vmap = lambda fn: (lambda keys: jnp.asarray(PERMS))
    monkeypatch.setattr(jsct, "jax", fake)
    monkeypatch.setattr(tsct, "_draw_orders", lambda b, t, generator: torch.as_tensor(PERMS))


def _inputs(seed, c_dim=1):
    rng = np.random.RandomState(seed)
    return tuple(rng.uniform(-1, 1, (B, n, HW, HW, c_dim)).astype(np.float32) for n in (K, T, F_))


def _close(got: np.ndarray, want: np.ndarray) -> None:
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= 5e-3
    assert chip_smoke.u8_psnr(chip_smoke.u8(got), chip_smoke.u8(want)) >= 45.0
    assert np.abs(want[0] - want[1]).max() > 1e-4  # the two rows' inputs differ, and so do their outputs


def test_positional_encoding_matches_jax():
    t = np.array([[0.0, 0.2, 0.4, 2.0, 2.5], [1.0, 1.5, 3.0, 7.0, 0.1]], np.float32)
    np.testing.assert_allclose(ttr.positional_encoding(torch.from_numpy(t), 16).numpy(),
                               np.asarray(jtr.positional_encoding(jnp.asarray(t), 16)), atol=1e-6, rtol=0)
    x = np.random.RandomState(0).standard_normal((2, 5, 3, 4, 16)).astype(np.float32)
    got = ttr.add_spatial_pe(_seq(x), torch.from_numpy(t)).permute(0, 1, 3, 4, 2).numpy()
    np.testing.assert_allclose(got, np.asarray(jtr.add_spatial_pe(jnp.asarray(x), jnp.asarray(t))), atol=1e-6)


def _block_case(kind):
    """(flax module, port module, JAX args, port args) of a transformer unit."""
    rng = np.random.RandomState(1)
    d = TOY["d_v"]
    x = rng.standard_normal((B, 4, HW // 4, HW // 4, d)).astype(np.float32)
    enc = rng.standard_normal((B, 5, HW // 4, HW // 4, d)).astype(np.float32)
    seq_mask = np.ones((B, 5), np.float32)
    seq_mask[1, 3:] = 0  # padded positions
    causal = np.broadcast_to(np.tril(np.ones((4, 4), np.float32)), (B, 4, 4)).copy()
    causal[0, 1] = 0  # a row that attends nothing: uniform, not NaN, under -1e10
    t_enc = np.broadcast_to(np.arange(5, dtype=np.float32) / 5, (B, 5)).copy()
    t_dec = np.broadcast_to(np.arange(4, dtype=np.float32) / 4 + 1.0, (B, 4)).copy()
    if kind == "encoder_block":
        return (jtr.EncoderBlock(2, d), ttr.EncoderBlock(2, d), (enc, seq_mask),
                (_seq(enc), torch.from_numpy(seq_mask)))
    if kind == "decoder_block":
        return (jtr.DecoderBlock(2, d), ttr.DecoderBlock(2, d), (x, x, enc, seq_mask, causal),
                (_seq(x), _seq(x), _seq(enc), torch.from_numpy(seq_mask), torch.from_numpy(causal)))
    if kind == "encoder_all":
        return (jtr.ConvTransformerEncoder(2, 2, d, return_all=True), ttr.ConvTransformerEncoder(2, 2, d, True),
                (enc, seq_mask, t_enc), (_seq(enc), torch.from_numpy(seq_mask), torch.from_numpy(t_enc)))
    attend = kind.split("_")[1]
    enc_out = [enc, enc * 0.5] if attend != "top" else enc
    t_enc_out = [_seq(e) for e in enc_out] if attend != "top" else _seq(enc)
    init = x[:, :1]
    tril = np.broadcast_to(np.tril(np.ones((4, 4), np.float32)), (B, 4, 4)).copy()
    return (jtr.ConvTransformerDecoder(2, 2, d, enc_attend=attend), ttr.ConvTransformerDecoder(2, 2, d, attend),
            (enc_out, seq_mask, init, t_dec, tril),
            (t_enc_out, torch.from_numpy(seq_mask), _seq(init), torch.from_numpy(t_dec), torch.from_numpy(tril)))


@pytest.mark.parametrize("kind", ["encoder_block", "decoder_block", "encoder_all", "decoder_top", "decoder_skip",
                                  "decoder_same"])
def test_transformer_units_match_jax(kind):
    jmod, tmod, jargs, targs = _block_case(kind)
    template = jax.eval_shape(lambda *a: jmod.init(jax.random.PRNGKey(0), *a), *jargs)["params"]
    params = _random_tree(template, np.random.RandomState(2))
    tmod.load_state_dict(params_from_jax(params))
    want = jmod.apply({"params": params}, *jargs)
    with torch.no_grad():
        got = tmod(*targs)
    want, got = (w if isinstance(w, list) else [w] for w in (want, got))
    for g, w in zip(got, want):
        g = g.permute(0, 1, 3, 4, 2).numpy()
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, np.asarray(w), atol=2e-4 * max(1.0, float(np.abs(w).max())), rtol=0)


@pytest.mark.parametrize("module,name", VARIANTS, ids=[n for _, n in VARIANTS])
def test_sct_variant_forward_matches_jax(module, name, pinned_orders):
    spec = {"class": name, "args": [], "kwargs": dict(TOY, c_dim=1, num_blocks=2 if name in SKIP_CONNECTED else 1)}
    jp = random_jax_params(spec, seed=3)
    model = create_model(spec)
    model.load_state_dict(params_from_jax(jp))
    model.eval()
    p, _, f = _inputs(4)
    jm = getattr(module, name)(**spec["kwargs"])
    want = jax.jit(lambda prm, a, b: jm.apply({"params": prm}, T, a, b, rngs={"sample": jax.random.PRNGKey(0)}))(
        jp, p, f)
    with torch.no_grad():
        got = model(T, torch.from_numpy(p), torch.from_numpy(f))
    assert list(got) == ["pred"] and model.random_order == ("Random" in name)
    _close(got["pred"].numpy(), np.asarray(want["pred"]))


@pytest.mark.parametrize("module,name", [(jsct, "SCTSkipConScaledTForwardFillInModel"),
                                         (jlegacy, "SCTSuperSkipConFillInModel")])
def test_forward_train_matches_jax(module, name):
    spec = {"class": name, "args": [], "kwargs": dict(TOY, c_dim=3, num_blocks=2)}
    jp = random_jax_params(spec, seed=5)
    model = create_model(spec)
    model.load_state_dict(params_from_jax(jp))
    p, m, f = _inputs(6, c_dim=3)
    jm = getattr(module, name)(**spec["kwargs"])
    want = jax.jit(lambda prm, a, g, b: jm.apply({"params": prm}, T, a, b, g, method="forward_train"))(jp, p, m, f)
    with torch.no_grad():
        got = model.forward_train(T, *(torch.from_numpy(a) for a in (p, f, m)))
    _close(got["pred"].numpy(), np.asarray(want["pred"]))


@pytest.fixture(scope="module", params=[1.0, 0.0], ids=["teacher_forced", "free_running"])
def sct_step(request):
    """One train_step of each package from the same weights and batch, the
    branch pinned by tf_p_min = tf_p_max (a uniform draw is below 1, never
    below 0); JAX's gradients are read from its Adam first moments."""
    spec = {"class": "SCTSkipConScaledTForwardFillInModel", "args": [], "kwargs": dict(TOY, c_dim=1)}
    p_tf = request.param
    cfg_kw = dict(K=K, T=T, F=F_, df_dim=8, Ip=1, disc_window_size=3, tf_p_min=p_tf, tf_p_max=p_tf)
    g_params = random_jax_params(spec, seed=7)
    d_vars = random_jax_disc_variables(TrainConfig(**cfg_kw), HW, HW, 1, seed=8)
    targets = np.random.RandomState(9).uniform(-1, 1, (B, K + T + F_, HW, HW, 1)).astype(np.float32)

    jenv = jenvs.create_training_environment(jsct.SCTSkipConScaledTForwardFillInModel(**spec["kwargs"]),
                                             JTrainConfig(**cfg_kw))
    jenv.discriminator = JDisc(window_size=3, df_dim=8, Ip=1)
    gp, dp, dsn = (jax.tree.map(jnp.asarray, t) for t in (g_params, d_vars["params"], d_vars["sn"]))
    jstate = jenvs.TrainState(step=jnp.zeros((), jnp.int32), g_params=gp, g_opt=jax.jit(jenv.g_tx().init)(gp),
                              d_params=dp, d_sn=dsn, d_opt=jax.jit(jenv.d_tx().init)(dp), rng=jax.random.PRNGKey(0))
    jstate, want = jenv.train_step(jstate, K, T, F_, targets)
    b1 = jenv.cfg.beta1
    grads = [params_from_jax(jax.tree.map(lambda a: np.asarray(a) / (1.0 - b1), jstate.g_opt[0].mu)),
             disc_variables_from_jax({"params": jax.tree.map(lambda a: np.asarray(a) / (1.0 - b1),
                                                             jstate.d_opt[0].mu)})]

    env = create_training_environment(create_model(spec), TrainConfig(**cfg_kw))
    state = env.init_state((HW, HW), g_params=g_params, d_variables=d_vars, device="cpu")
    state, got = env.train_step(state, K, T, F_, targets)
    return dict(p_tf=p_tf, want={k: float(v) for k, v in want.items()}, got={k: float(v) for k, v in got.items()},
                grads=grads, got_grads=[{n: p.grad for n, p in mod.named_parameters()}
                                        for mod in (state.generator, state.discriminator)])


def test_sct_environment_step_matches_jax(sct_step):
    got, want = sct_step["got"], sct_step["want"]
    assert sorted(got) == sorted([*want, "teacher_forced"]) and got["teacher_forced"] == sct_step["p_tf"]
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-3 * abs(want[k]), (k, got[k], want[k])
    for got_g, want_g in zip(sct_step["got_grads"], sct_step["grads"]):
        assert _global_rel(got_g, want_g) <= 1e-3


def test_tf_rate_matches_jax():
    kw = dict(K=K, T=T, F=F_, tf_p_max=1.0, tf_p_min=0.0, tf_offset=10.0, tf_decay=2.0)
    jenv = jenvs.SCTEnvironment(None, JTrainConfig(**kw))
    env = SCTEnvironment(None, TrainConfig(**kw))
    for step in (0, 5, 9, 10, 11, 20, 40, 10**6):
        assert abs(env.tf_rate(step) - float(jenv.tf_rate(jnp.asarray(step, jnp.int32)))) <= 1e-6, step
    far = SCTEnvironment(None, TrainConfig(K=K, T=T, F=F_, tf_p_max=0.5, tf_p_min=0.1, tf_offset=1e5, tf_decay=1.0))
    assert far.tf_rate(0) == 0.5 and far.tf_rate(10**6) == pytest.approx(0.1)


def test_max_pool_tie_gradient_matches_jax():
    """flax's nn.max_pool sends a tied window's gradient to one element, as
    F.max_pool2d does (MC-Net's max_pool2 splits it); held on a tied input
    alone and through the SCT frame encoder on constant frames."""
    x = np.random.RandomState(10).randint(0, 3, (2, 6, 8, 3)).astype(np.float32)  # NHWC, many ties
    cot = np.random.RandomState(11).standard_normal((2, 3, 4, 3)).astype(np.float32)
    want = jax.grad(lambda a: jnp.sum(fnn.max_pool(a, (2, 2), strides=(2, 2)) * cot))(jnp.asarray(x))
    t = torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).requires_grad_()
    (F.max_pool2d(t, 2) * torch.from_numpy(cot.transpose(0, 3, 1, 2).copy())).sum().backward()
    np.testing.assert_array_equal(t.grad.permute(0, 2, 3, 1).numpy(), np.asarray(want))

    frames = np.full((1, 2, HW, HW, 1), 0.3, np.float32)
    frames[0, 1, 5, 7] = -0.4
    jenc = jsct.FrameEncoder(16)
    params = random_jax_params({"class": "SCTSkipConScaledTForwardFillInModel", "kwargs": dict(TOY, c_dim=1)},
                               seed=12)["frame_encoder"]
    r = np.random.RandomState(13).standard_normal((1, 2, 2, 2, 16)).astype(np.float32)
    want = jax.grad(lambda a: jnp.sum(jenc.apply({"params": params}, a)[-1] * r))(jnp.asarray(frames))
    tenc = tsct.FrameEncoder(1, 16)
    tenc.load_state_dict(params_from_jax(params))
    inp = _seq(frames).requires_grad_()
    (tenc(inp)[-1] * _seq(r)).sum().backward()
    np.testing.assert_allclose(inp.grad.permute(0, 1, 3, 4, 2).numpy(), np.asarray(want), atol=1e-5, rtol=1e-4)


def test_order_draws_are_seeded_permutations():
    g = torch.Generator().manual_seed(3)
    perms = tsct._draw_orders(64, 5, g)
    assert perms.dtype == torch.int64 and (perms.sort(dim=1).values == torch.arange(5)).all()
    assert len({tuple(r) for r in perms.tolist()}) > 20
    assert torch.equal(tsct._draw_orders(4, 5, torch.Generator().manual_seed(3)), perms[:4])
    assert torch.equal(tsct._draw_orders(4, 5, None), tsct._draw_orders(4, 5, torch.Generator().manual_seed(0)))

    spec = {"class": "SCTSkipConScaledTRandomBFillInModel", "args": [], "kwargs": dict(TOY, c_dim=1)}
    model = create_model(spec).eval()
    p, _, f = (torch.from_numpy(a) for a in _inputs(14))
    with torch.no_grad():
        a, b = model(T, p, f)["pred"], model(T, p, f)["pred"]
        c = model(T, p, f, generator=torch.Generator().manual_seed(0))["pred"]
    assert torch.equal(a, b) and torch.equal(a, c)


def test_sct_environment_dispatch_and_its_generator():
    """Every SCT class trains in SCTEnvironment; the state carries a seeded
    generator; a variant without forward_train always runs free and draws its
    orders from that generator."""
    cfg = TrainConfig(K=K, T=T, F=F_, df_dim=8, Ip=1, tf_p_min=1.0, tf_p_max=1.0)
    for _, name in VARIANTS:
        env = create_training_environment(create_model({"class": name, "kwargs": dict(TOY, c_dim=1)}), cfg)
        assert isinstance(env, SCTEnvironment), name
    env = create_training_environment(create_model({"class": "SCTSkipConScaledTRandomBFillInModel",
                                                    "kwargs": dict(TOY, c_dim=1)}), cfg)
    targets = np.random.RandomState(15).uniform(-1, 1, (B, K + T + F_, HW, HW, 1)).astype(np.float32)
    states = [env.init_state((HW, HW), device="cpu", seed=s) for s in (4, 4)]
    assert torch.equal(states[0].rng.get_state(), torch.Generator().manual_seed(4).get_state())
    terms = [env.train_step(st, K, T, F_, targets)[1] for st in states]
    assert float(terms[0]["teacher_forced"]) == 0.0 and np.isfinite(float(terms[0]["G_loss"]))
    assert float(terms[0]["G_loss"]) == float(terms[1]["G_loss"])
    assert not torch.equal(states[0].rng.get_state(), torch.Generator().manual_seed(4).get_state())


def test_sct_golden_fixture_matches_chip_smoke():
    z = np.load(chip_smoke.SCT_GOLDEN_PATH)
    cfg = chip_smoke.SCT_GOLDEN
    assert {k: z[k].item() for k in cfg} == cfg
    n = cfg["B"] * cfg["T"] * cfg["H"] * cfg["W"] * cfg["C"]
    for run in chip_smoke.SCT_GOLDEN_RUNS:
        assert z[f"{run}/pred_at_points"].shape == (cfg["n_points"],)
        u = z[f"{run}/pred_u8_at_points"]
        assert u.shape == (n,) and ((u > 12) & (u < 243)).mean() > 0.8  # tanh off its rails
    assert os.path.getsize(chip_smoke.SCT_GOLDEN_PATH) < 2e6


@pytest.mark.slow
def test_full_width_sct_matches_golden():
    reports = chip_smoke.check_sct_golden(torch.device("cpu"))
    assert all(r["ok"] for r in reports.values()), reports

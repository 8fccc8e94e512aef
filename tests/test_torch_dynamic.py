"""The dynamic-(K, T, F) path of vfi_tpu_torch against vfi_tpu on the CPU, at
toy widths (TAI gf_dim 8, ks 5, kf_dim 4; gray 32x32; max K = T = F = 3):
the seven pad-to-max helpers of ``ops/dynamic.py``, MC-Net's
``warmup_skip``, the ``lengths=`` forwards of the twelve model classes, the
dynamic training steps of four families, and ``create_dynamic_environment``
over the registry.

Each forward and step is held twice: against vfi_tpu on the same weights,
and against the port's own static path at the same lengths (the valid
frames, the loss terms).  vfi_tpu's forwards and jitted steps come from
``tests/torch_golden_dynamic_toy.npz``, written by
``tests/make_torch_dynamic_golden.py`` on this module's inputs; it stores
their fingerprint, so a golden made on other inputs or weights fails.

Random and RandomB draw their orders from pinned uniforms ``ORDER_UNIFORMS``
on both sides (vfi_tpu's ``jax.random.uniform`` inside ``vfi_tpu.models.sct``
replaced in the golden's maker, the port's ``_draw_uniforms`` here); the
port's static forward takes the same order, the uniforms' ranks.

vfi_tpu's dynamic SloMo step takes its perceptual term over all max_T
frames, the padding's included, so at T < max_T it departs from its own
static step; the port's masks that term, and is held there against
vfi_tpu's static step (and against its dynamic step on the other terms).
"""

import hashlib
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from vfi_tpu.models import legacy_sct as jlegacy
from vfi_tpu.models.registry import create_model as jax_create_model
from vfi_tpu.ops import dynamic as jdyn
from vfi_tpu.train import dynamic_env as jdyn_env
from vfi_tpu.utils.config import TrainConfig as JTrainConfig
from vfi_tpu_torch.models import sct as tsct
from vfi_tpu_torch.models.registry import create_model, model_keys
from vfi_tpu_torch.nn.vgg import random_vgg16_npz
from vfi_tpu_torch.ops import dynamic as dyn
from vfi_tpu_torch.train.dynamic_env import create_dynamic_environment
from vfi_tpu_torch.train.environments import create_training_environment
from vfi_tpu_torch.utils.config import TrainConfig
from vfi_tpu_torch.utils.params import (disc_variables_to_jax, params_from_jax, params_to_jax,
                                        random_jax_disc_variables, random_jax_params)
from . import torch_threads  # noqa: F401  (one torch thread per xdist worker)

GOLDEN_PATH = __file__.rsplit("/", 1)[0] + "/torch_golden_dynamic_toy.npz"
MAX_K = MAX_T = MAX_F = 3
B, HW = 2, 32
LENGTHS = ((2, 2, 2), (3, 3, 2))  # all below the maximum; T at it
ORDER_UNIFORMS = np.array([[0.7, 0.2, 0.5], [0.1, 0.9, 0.4]], np.float32)
VGG_SEED = 3
TAI_KW = dict(gf_dim=8, c_dim=1, ks=5, num_block=5, kf_dim=4)
MC_KW = dict(gf_dim=8, c_dim=1)
SCT_KW = dict(c_dim=1, num_blocks=1, num_heads=2, d_v=16, d_ff=32)


def _spec(cls: str, **kw) -> dict:
    return {"class": cls, "args": [], "kwargs": kw}


MODELS = {
    "TAI": _spec("TAIFillInModel", **TAI_KW),
    "TWI": _spec("TWIFillInModel", **TAI_KW),
    "biTWA": _spec("BidirectionalTimeWeightedAverageFillInModel", **MC_KW),
    "biSA": _spec("BidirectionalSimpleAverageFillInModel", **MC_KW),
    "MCNet": _spec("MCNetFillInModel", **MC_KW),
    "TWPF": _spec("TimeWeightedPFFillInModel"),
    "SloMo": _spec("SloMoFillInModel", base_dim=4, c_dim=1),
    "SCTForward": _spec("SCTSkipConScaledTForwardFillInModel", **SCT_KW),
    "SCTInward": _spec("SCTSkipConScaledTInwardFillInModel", **SCT_KW),
    "SCTRandom": _spec("SCTSkipConScaledTRandomFillInModel", **SCT_KW),
    "SCTRandomB": _spec("SCTSkipConScaledTRandomBFillInModel", **SCT_KW),
    "SCTRandomC": _spec("SCTSkipConScaledTRandomCFillInModel", **dict(SCT_KW, num_blocks=2)),
}
FORWARDS = [*MODELS, "SCTForward_train"]  # the last: Forward's teacher-forced pass
GAN = dict(K=MAX_K, T=MAX_T, F=MAX_F, df_dim=8, Ip=1, disc_window_size=2)
STEPS = {  # setup -> (model, TrainConfig keywords); seeds: weights 11, discriminator 12
    "tai": ("TAI", GAN),
    "mcnet": ("MCNet", GAN),
    "sct_forced": ("SCTForward", dict(GAN, tf_p_min=1.0, tf_p_max=1.0)),
    "sct_free": ("SCTForward", dict(GAN, tf_p_min=0.0, tf_p_max=0.0)),
    "slomo": ("SloMo", dict(K=MAX_K, T=MAX_T, F=MAX_F, lambda_p=0.005)),
}
SLOMO_PERCEPTUAL = ("perceptual_loss", "G_loss")  # the terms vfi_tpu's dynamic SloMo takes over the padding


def clip() -> np.ndarray:
    """The max-length clip ``[B, 9, 32, 32, 1]``."""
    return np.random.RandomState(0).uniform(-1, 1, (B, MAX_K + MAX_T + MAX_F, HW, HW, 1)).astype(np.float32)


def model_params(name: str) -> dict:
    return random_jax_params(MODELS[name], seed=1)


def step_variables(setup: str):
    """(generator params, discriminator variables or None) of a step setup."""
    name, cfg_kw = STEPS[setup]
    disc = None if name == "SloMo" else random_jax_disc_variables(TrainConfig(**cfg_kw), HW, HW, 1, seed=12)
    return random_jax_params(MODELS[name], seed=11), disc


def _leaves(tree, prefix=""):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def fingerprint(vgg_path: str) -> str:
    """sha256 of every input the golden was made from."""
    h = hashlib.sha256()
    arrays = [("clip", clip()), ("orders", ORDER_UNIFORMS)]
    arrays += [(f"{n}/{k}", a) for n in MODELS for k, a in _leaves(model_params(n))]
    for setup in STEPS:
        g, d = step_variables(setup)
        arrays += [(f"{setup}/{k}", a) for k, a in _leaves({"g": g, "d": d or {}})]
    with np.load(vgg_path) as z:
        arrays += [(f"vgg/{k}", z[k]) for k in sorted(z.files)]
    for name, a in arrays:
        h.update(name.encode())
        h.update(np.ascontiguousarray(a, np.float32).tobytes())
    return h.hexdigest()


def _ktf_name(ktf) -> str:
    return "".join(map(str, ktf))


@pytest.fixture(scope="module")
def vgg_npz(tmp_path_factory):
    return random_vgg16_npz(str(tmp_path_factory.mktemp("vgg") / "vgg16.npz"), seed=VGG_SEED)


@pytest.fixture(scope="module")
def golden(vgg_npz):
    with np.load(GOLDEN_PATH) as z:
        g = {k: z[k] for k in z.files}
    assert str(g["fingerprint"]) == fingerprint(vgg_npz), (
        "tests/torch_golden_dynamic_toy.npz was made on other inputs or weights; rerun "
        "JAX_PLATFORMS=cpu python tests/make_torch_dynamic_golden.py")
    return g


@pytest.fixture
def pinned_uniforms(monkeypatch):
    """The port's random orders: the dynamic forwards rank ORDER_UNIFORMS over
    the valid steps, and the static forwards take those ranks as their order."""
    u = torch.from_numpy(ORDER_UNIFORMS)
    monkeypatch.setattr(tsct, "_draw_uniforms", lambda b, t, generator: u[:b, :t].clone())
    monkeypatch.setattr(tsct, "_draw_orders", lambda b, t, generator: u[:b, :t].argsort(1).argsort(1))


def _lengths(ktf, device="cpu"):
    return tuple(torch.tensor(v, device=device) for v in ktf)


def _pack(ktf):
    return dyn.pack_context(torch.from_numpy(clip()), *_lengths(ktf), MAX_K, MAX_T, MAX_F)


# -- the helpers ------------------------------------------------------------------

ALL_KTF = [(K, T, F) for K in range(1, MAX_K + 1) for T in range(1, MAX_T + 1) for F in range(1, MAX_F + 1)]


def _helper_pairs(name: str, ktf):
    """(port result, vfi_tpu result) of one helper at one (K, T, F), as numpy."""
    K, T, F = _lengths(ktf)
    jK, jT, jF = (jnp.int32(v) for v in ktf)
    x = clip()
    rng = np.random.RandomState(sum(ktf))
    if name == "pack_context":
        got = dyn.pack_context(torch.from_numpy(x), K, T, F, MAX_K, MAX_T, MAX_F)
        want = jdyn.pack_context(jnp.asarray(x), jK, jT, jF, MAX_K, MAX_T, MAX_F)
    elif name == "middle_mask":
        got, want = [dyn.middle_mask(T, MAX_T)], [jdyn.middle_mask(jT, MAX_T)]
    elif name == "dynamic_time_weights":
        got, want = [dyn.dynamic_time_weights(T, MAX_T)], [jdyn.dynamic_time_weights(jT, MAX_T)]
    elif name == "reverse_middle":
        a = rng.standard_normal((MAX_T, B, 4)).astype(np.float32)
        got, want = [dyn.reverse_middle(torch.from_numpy(a), T)], [jdyn.reverse_middle(jnp.asarray(a), jT)]
    elif name == "masked_mean":
        a = rng.standard_normal((B, MAX_T, 5, 5, 1)).astype(np.float32)
        mask = (np.arange(MAX_T) < ktf[1]).astype(np.float32)[None, :, None, None, None]
        got = [dyn.masked_mean(torch.from_numpy(a), torch.from_numpy(mask)),
               dyn.masked_mean(torch.from_numpy(a), torch.from_numpy(mask), dim=(0, 2, 3, 4))]
        want = [jdyn.masked_mean(jnp.asarray(a), jnp.asarray(mask)),
                jdyn.masked_mean(jnp.asarray(a), jnp.asarray(mask), axis=(0, 2, 3, 4))]
    elif name == "compact_video":
        p, m, f = dyn.pack_context(torch.from_numpy(x), K, T, F, MAX_K, MAX_T, MAX_F)
        got = [dyn.compact_video(p, m, f, K, T, F)]
        jp_, jm, jf = jdyn.pack_context(jnp.asarray(x), jK, jT, jF, MAX_K, MAX_T, MAX_F)
        want = [jdyn.compact_video(jp_, jm, jf, jK, jT, jF)]
        np.testing.assert_array_equal(got[0][:, : sum(ktf)].numpy(), x[:, : sum(ktf)])
    else:
        assert name == "dynamic_window_labels"
        got = dyn.dynamic_window_labels(K, T, F, MAX_K + MAX_T + MAX_F, 2)
        want = jdyn.dynamic_window_labels(jK, jT, jF, MAX_K + MAX_T + MAX_F, 2)
    return [g.numpy() for g in got], [np.asarray(w) for w in want]


@pytest.mark.parametrize("name", ["pack_context", "middle_mask", "dynamic_time_weights", "reverse_middle",
                                  "masked_mean", "compact_video", "dynamic_window_labels"])
def test_helper_matches_jax(name):
    """Every (K, T, F) up to 3/3/3: gathers and masks equal, floats within 1e-7."""
    for ktf in ALL_KTF:
        for got, want in zip(*_helper_pairs(name, ktf)):
            assert got.shape == want.shape, (name, ktf)
            if name in ("masked_mean", "dynamic_time_weights"):
                np.testing.assert_allclose(got, want, rtol=0, atol=1e-7, err_msg=f"{name} {ktf}")
            else:
                np.testing.assert_array_equal(got, want, err_msg=f"{name} {ktf}")


def test_lengths_are_checked_on_the_host():
    maxima = (MAX_K, MAX_T, MAX_F)
    for bad in ((0, 1, 1), (1, 4, 1), (1, 1, 4), (1, 0, 2)):
        with pytest.raises(ValueError, match="outside"):
            dyn.as_lengths(bad, "cpu", maxima)
    with pytest.raises(ValueError, match="outside"):
        dyn.as_lengths(np.array([1, 2, 2]), "cpu", maxima, (2, 1, 2))
    with pytest.raises(ValueError, match="integer"):
        dyn.as_lengths((2.5, 1, 1), "cpu", maxima)
    K, T, F = dyn.as_lengths(torch.tensor([3, 1, 2], dtype=torch.int32), "cpu", maxima)
    assert (K.dtype, K.dim(), int(K), int(T), int(F)) == (torch.int64, 0, 3, 1, 2)
    assert [int(v) for v in dyn.as_lengths(np.array([2, 3, 1]), "cpu", maxima)] == [2, 3, 1]
    model = create_model(MODELS["TAI"])
    p, _, f = _pack((2, 2, 2))
    with pytest.raises(ValueError, match="T=4"):
        model(MAX_T, p, f, lengths=(2, 4, 2))
    env = create_dynamic_environment(model, TrainConfig(**GAN))
    state = env.init_state((HW, HW), device="cpu")
    with pytest.raises(ValueError, match="K=1"):  # TAI samples K, F >= 2
        env.train_step_dynamic(state, clip(), np.array([1, 2, 2]))
    with pytest.raises(ValueError, match="9 frames"):
        env.train_step_dynamic(state, clip()[:, :8], (2, 2, 2))


# -- MC-Net's warmup_skip -------------------------------------------------------------

def _mcnet():
    model = create_model(MODELS["MCNet"])
    model.load_state_dict(params_from_jax(model_params("MCNet")))
    return model.mcnet


def _warmup_inputs():
    x = torch.from_numpy(clip())
    g = (x + 1.0) / 2.0
    return g[:, 1:5] - g[:, :4], x[:, 4]  # 4 difference frames, the content frame


def test_warmup_skip_equals_the_shorter_warmup(golden):
    """A per-row skip ([0, 2]) and a scalar one (1): each row equals MC-Net on
    its shorter warm-up (f32, <= 1e-6; each reference row is taken from a run
    of the whole batch, as a different batch size may pick other conv
    algorithms), and vfi_tpu's MCNet with the same skip (<= 1e-5); under
    ``remat`` the outputs and gradients are the same."""
    mc = _mcnet()
    diff, xt = _warmup_inputs()
    with torch.no_grad():
        rows = mc(2, diff, xt, warmup_skip=torch.tensor([0, 2]))
        short = [mc(2, diff, xt), mc(2, diff[:, 2:], xt)]
        scalar = mc(2, diff, xt, warmup_skip=torch.tensor(1))
        short1 = mc(2, diff[:, 1:], xt)
    for i, field in enumerate(rows._fields):
        for b in range(B):
            assert float((rows[i][:, b] - short[b][i][:, b]).abs().max()) <= 1e-6, (field, b)
        assert float((scalar[i] - short1[i]).abs().max()) <= 1e-6, field
        want = golden[f"mcnet_skip/{field}"]  # vfi_tpu's NHWC, time-major
        assert float(np.abs(rows[i].permute(0, 1, 3, 4, 2).numpy() - want).max()) <= 1e-5, field

    grads = []
    for remat in (False, True):
        mc.remat = remat
        out = mc(2, diff, xt, warmup_skip=torch.tensor([0, 2]))
        loss = sum(a.square().mean() for a in out)
        grads.append((torch.stack([a.detach() for a in out[:1]]),
                      torch.autograd.grad(loss, list(mc.parameters()), allow_unused=True)))
    mc.remat = False
    assert torch.allclose(grads[0][0], grads[1][0], atol=1e-6)
    for a, b in zip(grads[0][1], grads[1][1]):
        assert (a is None) == (b is None) and (a is None or torch.allclose(a, b, rtol=1e-5, atol=1e-7))


# -- the forwards with lengths= ----------------------------------------------------------

def _port_model(name: str):
    model = create_model(MODELS[name.removesuffix("_train")])
    params = model_params(name.removesuffix("_train"))
    if params:
        model.load_state_dict(params_from_jax(params))
    return model.eval()


@pytest.mark.parametrize("ktf", LENGTHS, ids=_ktf_name)
@pytest.mark.parametrize("name", FORWARDS)
def test_forward_with_lengths(name, ktf, golden, pinned_uniforms):
    """vfi_tpu's ``apply(..., lengths=)`` on the same weights within the
    forward gate (f32 max-abs <= 5e-3); the valid frames equal the port's
    static forward at those lengths (rtol 2e-4, atol 2e-5)."""
    K, T, F = ktf
    model = _port_model(name)
    x = torch.from_numpy(clip())
    p, m, f = _pack(ktf)
    with torch.no_grad():
        if name.endswith("_train"):
            got = model.forward_train(MAX_T, p, f, m, lengths=_lengths(ktf))
            static = model.forward_train(T, x[:, :K], x[:, K + T : K + T + F], x[:, K : K + T])
        else:
            got = model(MAX_T, p, f, lengths=_lengths(ktf))
            static = model(T, x[:, :K], x[:, K + T : K + T + F])
    prefix = f"fwd/{name}/{_ktf_name(ktf)}/"
    keys = sorted(k[len(prefix):] for k in golden if k.startswith(prefix))
    assert keys == sorted(got), (keys, sorted(got))
    worst = 0.0
    for key in keys:
        a = got[key].numpy()
        assert np.isfinite(a).all(), key
        worst = max(worst, float(np.abs(a - golden[prefix + key]).max()))
        valid = a[:, :T] if static[key].shape[1] == T and a.shape[1] == MAX_T else a
        np.testing.assert_allclose(valid, static[key].numpy(), rtol=2e-4, atol=2e-5, err_msg=key)
    print(f"forward {name} {ktf}: max-abs vs vfi_tpu {worst:.3e}")
    assert worst <= 5e-3, worst


# -- the steps --------------------------------------------------------------------------

def _step(setup: str, ktf, dynamic: bool, vgg_npz: str, dtype: str = "float32"):
    """One port step of a setup from its seeded state: (terms as floats, state)."""
    name, cfg_kw = STEPS[setup]
    cfg = TrainConfig(**cfg_kw, train_dtype=dtype, vgg16_weights=vgg_npz if name == "SloMo" else None)
    model = create_model(MODELS[name])
    env = (create_dynamic_environment if dynamic else create_training_environment)(model, cfg)
    g, d = step_variables(setup)
    kw = {} if d is None else {"d_variables": d}
    state = env.init_state((HW, HW), g_params=g, device="cpu", **kw)
    if dynamic:
        state, terms = env.train_step_dynamic(state, clip(), torch.tensor(ktf))
    else:
        K, T, F = ktf
        state, terms = env.train_step(state, K, T, F, clip()[:, : K + T + F])
    return {k: float(v) for k, v in terms.items()}, state


def _global_rel(got: dict, want: dict) -> float:
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert sorted(got) == sorted(want)
    num = sum(float(((got[k].astype(np.float64) - want[k]) ** 2).sum()) for k in want)
    return (num / sum(float((want[k].astype(np.float64) ** 2).sum()) for k in want)) ** 0.5


def _after_step(golden, prefix: str, start: dict, part: str) -> dict:
    """vfi_tpu's params after its step: the start plus the stored update."""
    return {k: a + golden[f"{prefix}{part}/{k}"].astype(np.float32) for k, a in _leaves(start)}


@pytest.mark.parametrize("ktf", LENGTHS, ids=_ktf_name)
@pytest.mark.parametrize("setup", list(STEPS))
def test_dynamic_step(setup, ktf, golden, vgg_npz):
    """The port's ``train_step_dynamic``: its terms equal its static step's at
    the same lengths (rtol 2e-4, atol 1e-5) and are within rel 1e-3 of
    vfi_tpu's ``train_step_dynamic``; its generator and discriminator
    parameters after the step within global-L2-relative 1e-4 of vfi_tpu's."""
    got, state = _step(setup, ktf, True, vgg_npz)
    static, _ = _step(setup, ktf, False, vgg_npz)
    assert sorted(got) == sorted(static)
    for k in static:
        np.testing.assert_allclose(got[k], static[k], rtol=2e-4, atol=1e-5, err_msg=k)

    prefix = f"step/{setup}/{_ktf_name(ktf)}/"
    want = {k[len(prefix) + 6:]: float(golden[k]) for k in golden if k.startswith(prefix + "terms/")}
    ref = prefix
    if setup == "slomo" and ktf[1] < MAX_T:
        # vfi_tpu's dynamic SloMo step takes the perceptual term over the padding:
        # its other terms hold here, and its static step holds for all of them.
        for k in set(want) - set(SLOMO_PERCEPTUAL):
            assert abs(got[k] - want[k]) <= 1e-3 * abs(want[k]), (k, got[k], want[k])
        ref = f"step/slomo_static/{_ktf_name(ktf)}/"
        want = {k[len(ref) + 6:]: float(golden[k]) for k in golden if k.startswith(ref + "terms/")}
    assert sorted(want) == sorted(set(got) - {"teacher_forced"})
    if "teacher_forced" in got:
        assert got["teacher_forced"] == STEPS[setup][1]["tf_p_max"]
    worst = max(abs(got[k] - want[k]) / abs(want[k]) for k in want)
    print(f"step {setup} {ktf}: terms max rel vs vfi_tpu {worst:.3e}")
    assert worst <= 1e-3, {k: (got[k], want[k]) for k in want}

    g0, d0 = step_variables(setup)
    g_rel = _global_rel(params_to_jax(state.generator.state_dict()), _after_step(golden, ref, g0, "g"))
    print(f"step {setup} {ktf}: G params global rel vs vfi_tpu {g_rel:.3e}")
    assert g_rel <= 1e-4, g_rel
    if d0 is not None:
        d_rel = _global_rel(disc_variables_to_jax(state.discriminator.state_dict())["params"],
                            _after_step(golden, ref, d0["params"], "d"))
        print(f"step {setup} {ktf}: D params global rel vs vfi_tpu {d_rel:.3e}")
        assert d_rel <= 1e-4, d_rel


def test_vfi_tpu_dynamic_slomo_takes_the_padding_into_its_perceptual_term(golden):
    """The fault the port does not copy: at T < max_T vfi_tpu's dynamic
    perceptual term is not its static one, while its other terms are."""
    name = _ktf_name(LENGTHS[0])
    dyn_t = {k: float(golden[f"step/slomo/{name}/terms/{k}"]) for k in ("perceptual_loss", "reconstruction_loss")}
    stat_t = {k: float(golden[f"step/slomo_static/{name}/terms/{k}"]) for k in dyn_t}
    assert abs(dyn_t["reconstruction_loss"] - stat_t["reconstruction_loss"]) <= 1e-5 * stat_t["reconstruction_loss"]
    assert abs(dyn_t["perceptual_loss"] - stat_t["perceptual_loss"]) > 1e-2 * stat_t["perceptual_loss"]


def test_dynamic_step_mixed_precision_close_to_f32(vgg_npz):
    """bf16 compute on f32 masters: the terms within 5 % of the f32 step's
    (``tests/test_dynamic_ktf.py``'s gate for vfi_tpu); the masters stay f32."""
    f32, _ = _step("tai", LENGTHS[0], True, vgg_npz)
    bf16, state = _step("tai", LENGTHS[0], True, vgg_npz, "bfloat16")
    for k in ("G_Lp", "G_gdl", "G_GAN", "D_fake", "D_real"):
        assert abs(f32[k] - bf16[k]) < 0.05 * max(1.0, abs(f32[k])), (k, f32[k], bf16[k])
    assert all(p.dtype == torch.float32 for p in state.generator.parameters())


class _Ops(TorchDispatchMode):
    """Records each aten op with the shapes of its tensor arguments."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        shapes = tuple(tuple(a.shape) for a in torch.utils._pytree.tree_leaves((args, kwargs)) if torch.is_tensor(a))
        self.calls.append((str(func), shapes))
        return func(*args, **(kwargs or {}))


def test_dynamic_step_runs_the_same_ops_at_every_length(vgg_npz):
    """The TAI step launches the same ops on the same shapes at two (K, T, F),
    and its losses and their gradients read no value on the host (no
    ``_local_scalar_dense``, ``nonzero`` or ``item``): one step for every
    length, which a CUDA graph could capture once."""
    seqs = []
    for ktf in ((2, 1, 3), (3, 3, 2)):
        cfg = TrainConfig(**GAN)
        env = create_dynamic_environment(create_model(MODELS["TAI"]), cfg)
        g, d = step_variables("tai")
        state = env.init_state((HW, HW), g_params=g, d_variables=d, device="cpu")
        targets, (K, T, F) = env._dynamic_inputs(state, clip(), torch.tensor(ktf))
        with _Ops() as ops:
            loss, (out, packed, _) = env._g_loss_dyn(state, K, T, F, targets)
            torch.autograd.grad(loss, list(state.generator.parameters()), allow_unused=True)
            d_loss, _ = env._d_loss_dyn(state, out["pred"], *packed, K, T, F)
            torch.autograd.grad(d_loss, list(state.discriminator.parameters()))
        host_reads = [c for c, _ in ops.calls if any(s in c for s in ("_local_scalar_dense", "nonzero", "item"))]
        assert not host_reads, host_reads
        seqs.append(ops.calls)
    assert len(seqs[0]) > 1000 and seqs[0] == seqs[1]


# -- the registry -----------------------------------------------------------------------

def _class_name(env):
    return None if env is None else type(env).__name__


LEGACY = [_spec(n, **dict(SCT_KW, num_blocks=2)) for n in ("SCTSkipConFillInModel", "SCTSuperSkipConFillInModel")]
NO_VGG = dict(K=5, T=5, F=5, lambda_p=0.0)  # SloMo's environments refuse lambda_p > 0 without VGG16 weights


def test_create_dynamic_environment_matches_vfi_tpu():
    """Every registry key gets the counterpart of vfi_tpu's class (None where
    vfi_tpu gives None); the two legacy SCT classes get None, where vfi_tpu
    gives an SCT environment that cannot step."""
    import json

    for key in model_keys():
        want = _class_name(jdyn_env.create_dynamic_environment(jax_create_model(key), JTrainConfig(**NO_VGG)))
        with torch.device("meta"):
            got = _class_name(create_dynamic_environment(create_model(key), TrainConfig(**NO_VGG)))
        assert got == want, (key, got, want)
    for spec in LEGACY:
        want = _class_name(jdyn_env.create_dynamic_environment(jax_create_model(json.dumps(spec)),
                                                               JTrainConfig(**NO_VGG)))
        assert want == "DynamicSCTEnvironment"
        with torch.device("meta"):
            assert create_dynamic_environment(create_model(spec), TrainConfig(**NO_VGG)) is None


def test_vfi_tpu_legacy_sct_takes_no_lengths():
    """Why the port returns None for them: vfi_tpu's legacy ``__call__`` and
    ``forward_train`` have no ``lengths`` parameter, so its dynamic step would
    raise ``TypeError`` at the model call."""
    for cls in (jlegacy.SCTSkipConFillInModel, jlegacy.SCTSuperSkipConFillInModel):
        for method in (cls.__call__, cls.forward_train):
            assert "lengths" not in inspect.signature(method).parameters, (cls.__name__, method.__name__)
    with torch.device("meta"):
        for spec in LEGACY:
            assert "lengths" not in inspect.signature(create_model(spec).forward).parameters

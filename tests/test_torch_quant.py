"""int8 serving in vfi_tpu_torch (nn/quant.py, ops/qconv.py, VFI_INT8,
predict --quantize) against vfi_tpu's int8 mode on the CPU at toy sizes.

vfi_tpu runs compiled, and XLA turns its division by the constant 127 into
a product with float32(1/127): the port's scales do the same, and vfi_tpu is
run under ``jax.jit`` here.  The port's plain int8 conv is held exactly to
XLA's int8 conv; its QConv to vfi_tpu's QConv (static and dynamic, f32
within 1e-6 * max(1, max|y|), bf16 within one bf16 ulp); its calibration
from zero to vfi_tpu's ``apply(..., mutable=["quant"])`` from an all-zero
"quant" collection (amax within rel 1e-5); the order and shapes of the int8
convs' inputs to vfi_tpu's jaxpr, since dynamic scales depend on how a batch
is split into calls.  The toy TAI, SloMo and SCT forwards: every int8 conv
call (dynamic), given the port's input, within 1e-6 of vfi_tpu's QConv, and
``pred`` at uint8 PSNR >= 45 dB end to end.  End to end the two packages
part where float noise flips one int8 rounding in the rollout, which
re-quantizes its own predictions, so max-abs is reported, not gated.  The
predict CLI: ``--quantize int8_dynamic`` against vfi_tpu's
``cli/predict.py`` on a converted snapshot, PNGs within 1 uint8 level;
``--quantize int8`` against the port's own calibrate-then-forward; the
``--validate_quant`` gate's refuse, force and skip.

vfi_tpu's toy TAI forwards and its predict CLI's PNGs are computed once, by
tests/make_torch_quant_golden.py on this module's inputs, and read from
tests/torch_golden_quant_toy.npz; the per-call comparisons run vfi_tpu's
QConv here, on the port's recorded inputs.
"""

import functools
import json
import os
import subprocess
import sys

import jax
import jax.extend.core as jcore
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scripts.convert_checkpoint_torch import to_torch_payload
from vfi_tpu.models.registry import create_model as jax_create_model
from vfi_tpu.nn import quant as jquant
from vfi_tpu_torch.cli import predict
from vfi_tpu_torch.data.datasets import ContiguousVideoClipDataset
from vfi_tpu_torch.data.synthetic import make_videolist
from vfi_tpu_torch.models.registry import create_model
from vfi_tpu_torch.nn import quant
from vfi_tpu_torch.nn.layers import Conv
from vfi_tpu_torch.nn.transformer import Conv1x1
from vfi_tpu_torch.ops import qconv
from vfi_tpu_torch.train.environments import create_training_environment
from vfi_tpu_torch.utils import checkpoint as tckpt
from vfi_tpu_torch.utils.config import TrainConfig
from vfi_tpu_torch.utils.params import params_from_jax, quant_from_jax, random_jax_params
from vfi_tpu_torch.utils.png import read_png
from . import torch_threads  # noqa: F401  (one torch thread per xdist worker)
from .test_torch_predict import jax_snapshot

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
# vfi_tpu's side of the toy TAI fixture and of the predict CLI test, on this
# module's inputs (tests/make_torch_quant_golden.py).
GOLDEN_PATH = os.path.join(REPO, "tests", "torch_golden_quant_toy.npz")
# The toy TAI of tests/test_quant.py's test_tai_forward_int8_static_close_to_f32.
TAI = {"class": "TAIFillInModel", "args": [],
       "kwargs": dict(gf_dim=8, c_dim=1, feature_size=3, ks=5, num_block=5, kf_dim=4)}
PRED_KEYS = ("pred", "pred_forward", "pred_backward")


def _u8(x):
    return np.round(np.clip((np.asarray(x, np.float64) + 1.0) / 2.0, 0.0, 1.0) * 255.0)


def _u8_psnr(a, b) -> float:
    mse = float(np.mean((_u8(a) - _u8(b)) ** 2))
    return 10.0 * np.log10(255.0**2 / max(mse, 1e-10))


def _bf16_ulp(a: np.ndarray) -> np.ndarray:
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(a), 2.0**-126))) - 7)


def _port_model(spec, params, mode, monkeypatch, dtype=torch.float32):
    monkeypatch.setenv("VFI_INT8", mode)
    m = create_model(spec)
    monkeypatch.delenv("VFI_INT8")
    m.load_state_dict(params_from_jax(params))
    return m.to(dtype).eval()


@functools.lru_cache(maxsize=None)
def _jax_qconv(c_out: int, k: int, static: bool):
    """vfi_tpu's QConv, compiled as vfi_tpu always runs it: XLA turns its
    division by the constant 127 into a product with float32(1/127)."""
    return jax.jit(jquant.QConv(c_out, k, static=static).apply)


# -- the arithmetic -----------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("per", ["tensor", "channel"])
def test_quantize_symmetric_matches_jax(dtype, per):
    rng = np.random.RandomState(0)
    a = (rng.standard_normal((3, 3, 5, 7)) * np.exp(rng.uniform(-3, 3, (1, 1, 1, 7)))).astype(np.float32)
    a[0, 0, 0] = 0.0  # a zero and an all-zero channel: the 1e-12 floor
    a[..., 2] = 0.0
    axes = (0, 1, 2, 3) if per == "tensor" else (0, 1, 2)
    jq, js = jax.jit(jquant.quantize_symmetric, static_argnums=1)(jnp.asarray(a, dtype), axes)
    tq, ts = quant.quantize_symmetric(torch.from_numpy(a).to(getattr(torch, dtype)), axes)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("k", qconv.KERNEL_SIZES)
def test_plain_int8_conv_equals_xla(k):
    """Every C_in in {1, 3, 65} and C_out in {1, 51, 64}: int32 sums exactly XLA's."""
    rng = np.random.RandomState(k)
    for c_in in (1, 3, 65):
        for c_out in (1, 51, 64):
            x = rng.randint(-127, 128, (2, 9, 11, c_in)).astype(np.int8)
            w = rng.randint(-127, 128, (k, k, c_in, c_out)).astype(np.int8)
            want = jax.lax.conv_general_dilated(jnp.asarray(x), jnp.asarray(w), (1, 1), "SAME",
                                                dimension_numbers=("NHWC", "HWIO", "NHWC"),
                                                preferred_element_type=jnp.int32)
            cp = qconv.padded_channels(c_in)
            xq = torch.nn.functional.pad(torch.from_numpy(x), (0, cp - c_in))
            wq = torch.nn.functional.pad(torch.from_numpy(w).permute(3, 0, 1, 2), (0, cp - c_in))
            got = qconv.qconv_int8_plain(xq.contiguous(), wq.contiguous())
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), np.asarray(want), err_msg=f"{c_in}->{c_out}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("static", [True, False], ids=["static", "dynamic"])
def test_qconv_matches_vfi_tpu(static, dtype):
    rng = np.random.RandomState(1)
    x = (rng.standard_normal((2, 10, 12, 24)) * 2).astype(np.float32)
    w = (rng.standard_normal((3, 3, 24, 40)) * 0.1).astype(np.float32)
    b = (rng.standard_normal(40) * 0.1).astype(np.float32)
    amax = 0.8 * float(np.abs(x).max())  # below max|x|: the largest inputs clip
    jdt = getattr(jnp, dtype)
    variables = {"params": {"kernel": jnp.asarray(w, jdt), "bias": jnp.asarray(b, jdt)}}
    if static:
        variables["quant"] = {"act_amax": jnp.asarray(amax, jnp.float32)}
    want = np.asarray(_jax_qconv(40, 3, static)(variables, jnp.asarray(x, jdt)), np.float32)

    m = torch.nn.Sequential(Conv(24, 40, 3))
    m[0].weight.data = torch.from_numpy(w.transpose(3, 2, 0, 1).copy())
    m[0].bias.data = torch.from_numpy(b)
    quant.quantize_convs(m, static).to(getattr(torch, dtype))
    if static:
        quant.load_act_amax(m, {"0.act_amax": torch.tensor(amax)})
    with torch.inference_mode():
        got = m(torch.from_numpy(x).permute(0, 3, 1, 2).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    got = got.float().permute(0, 2, 3, 1).numpy()
    err = np.abs(got - want)
    if dtype == "float32":
        assert err.max() <= 1e-6 * max(1.0, float(np.abs(want).max())), err.max()
    else:
        assert np.all(err <= _bf16_ulp(want)), err.max()


def test_vfi_tpu_init_records_act_amax():
    """The reference fault the port does not copy (ROADMAP queue 3): flax's
    init makes "quant" mutable, so vfi_tpu's static QConv records the init
    forward's amax, and its predict CLI calibrates from there; the port's
    calibration starts from zero."""
    x = np.random.RandomState(2).uniform(-5, 5, (1, 6, 6, 3)).astype(np.float32)
    v = jquant.QConv(4, 1, static=True).init(jax.random.PRNGKey(0), jnp.asarray(x))
    assert float(v["quant"]["act_amax"]) == float(np.abs(x).max()) > 4.0
    m = quant.quantize_convs(torch.nn.Sequential(Conv(3, 4, 1)), static=True)
    assert float(quant.act_amax_state(m)["0.act_amax"]) == 0.0


# -- the toy TAI: calibration, forwards and the int8 convs' call structure -----

def _int8_conv_inputs(jaxpr) -> list:
    """The lhs shapes of every conv_general_dilated with int8 operands, in
    program order, sub-jaxprs included."""
    shapes = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "conv_general_dilated" and eqn.invars[0].aval.dtype == jnp.int8:
            shapes.append(tuple(eqn.invars[0].aval.shape))
        for p in eqn.params.values():
            for sub in (p if isinstance(p, (list, tuple)) else (p,)):
                if isinstance(sub, jcore.ClosedJaxpr):
                    shapes += _int8_conv_inputs(sub.jaxpr)
                elif isinstance(sub, jcore.Jaxpr):
                    shapes += _int8_conv_inputs(sub)
    return shapes


def _tai_inputs():
    rng = np.random.RandomState(0)
    p = rng.uniform(-1, 1, (2, 3, 32, 32, 1)).astype(np.float32)
    f = rng.uniform(-1, 1, (2, 3, 32, 32, 1)).astype(np.float32)
    return p, f


@pytest.fixture(scope="module")
def golden():
    g = np.load(GOLDEN_PATH)
    assert int(g["tai_param_seed"]) == 0 and json.loads(str(g["cli"])) == CLI_META, \
        "tests/torch_golden_quant_toy.npz was made on other inputs: rerun tests/make_torch_quant_golden.py"
    return g


@pytest.fixture(scope="module")
def tai_jax(golden):
    """vfi_tpu's toy TAI (random_jax_params seed 0) under VFI_INT8=2 and =1,
    as tests/make_torch_quant_golden.py computed it on ``_tai_inputs``: the
    "quant" collection calibrated from zero (flax creates it at 0.0 in a
    mutable apply) on the inputs, the static forward with it, the dynamic
    forward, and the dynamic program's int8 convs; with the params."""
    quant_tree = {}
    for key in golden.files:
        if key.startswith("amax/"):
            node = quant_tree
            *path, leaf = key.split("/")[1:]
            for part in path:
                node = node.setdefault(part, {})
            node[leaf] = golden[key]
    return dict(params=random_jax_params(TAI, 0), quant=quant_tree,
                calls=[tuple(int(d) for d in c) for c in golden["calls"]],
                static={k: golden[f"static/{k}"] for k in PRED_KEYS},
                dynamic={k: golden[f"dynamic/{k}"] for k in PRED_KEYS})


def _forward_by_call(m, *args):
    """``m(*args)`` with every QConv call recorded: (outputs, [(path, x, y)])."""
    rec = []
    hooks = [mod.register_forward_hook(lambda mod, inp, out, n=n: rec.append((n, inp[0].clone(), out.clone())))
             for n, mod in quant.qconvs(m).items()]
    try:
        with torch.inference_mode():
            out = m(*(torch.from_numpy(a) if isinstance(a, np.ndarray) else a for a in args))
    finally:
        for h in hooks:
            h.remove()
    return out, rec


def _calls_vs_vfi_tpu(rec, params, quant_tree=None) -> float:
    """Each of the port's int8 conv calls, fed to vfi_tpu's QConv with that
    layer's params (and amax, static when ``quant_tree`` is given), all in one
    compiled program, as vfi_tpu runs (XLA turns QConv's division by the
    constant 127 into a product with float32(1/127)): the worst
    |y - y_jax| / max(1, max|y_jax|) over the calls."""
    mods, variables, xs = [], [], []
    for path, x, _ in rec:
        v = {"params": params, **({} if quant_tree is None else {"quant": quant_tree})}
        for k in path.split("."):
            v = {col: tree[k] for col, tree in v.items()}
        k, _, _, c_out = v["params"]["kernel"].shape
        mods.append(jquant.QConv(c_out, k, static=quant_tree is not None))
        variables.append(v)
        xs.append(x.permute(0, 2, 3, 1).numpy())
    wants = jax.jit(lambda vs, xs: [m.apply(v, x) for m, v, x in zip(mods, vs, xs)])(variables, xs)
    return max(float(np.abs(y.permute(0, 2, 3, 1).numpy() - np.asarray(w)).max()) / max(1.0, float(np.abs(w).max()))
               for (_, _, y), w in zip(rec, wants))


def _report(out: dict, want: dict, keys) -> str:
    return "; ".join(f"{k}: max-abs {float(np.abs(out[k].numpy() - want[k]).max()):.3g}, uint8 PSNR "
                     f"{_u8_psnr(out[k].numpy(), want[k]):.2f} dB" for k in keys)


def test_calibration_matches_vfi_tpu(tai_jax, monkeypatch):
    m = _port_model(TAI, tai_jax["params"], "2", monkeypatch)
    p, f = _tai_inputs()
    with torch.inference_mode(), quant.calibrate(m):
        m(3, torch.from_numpy(p), torch.from_numpy(f))
    got = quant.act_amax_state(m)
    want = quant_from_jax(tai_jax["quant"])
    leaves = jax.tree.leaves(tai_jax["quant"])
    assert len(quant.qconvs(m)) == len(leaves) == len(want) == len(got) > 60
    assert sorted(got) == sorted(want)
    for key, t in got.items():
        assert t.dtype == torch.float32
        assert abs(float(t) - float(want[key])) <= 1e-5 * abs(float(want[key])), key


@pytest.mark.parametrize("mode", ["static", "dynamic"])
def test_tai_int8_forward_matches_vfi_tpu(tai_jax, mode, monkeypatch):
    """f32, the JAX scales carried over in static mode.  The calls' inputs
    come in vfi_tpu's order and shapes; in dynamic mode every int8 conv call,
    given the port's input, gives vfi_tpu's QConv's output (1e-6); end to
    end, ``pred`` (the served output) at uint8 PSNR >= 45 dB.  The rollouts'
    frames are reported, not gated: the two runs part where float noise of
    a few ulps in a predicted frame moves a dynamic scale by one ulp and
    flips an int8 rounding at rollout step 1, and every later dynamic scale
    moves with it."""
    m = _port_model(TAI, tai_jax["params"], "2" if mode == "static" else "1", monkeypatch)
    if mode == "static":
        quant.load_act_amax(m, quant_from_jax(tai_jax["quant"]))
    p, f = _tai_inputs()
    out, rec = _forward_by_call(m, 3, p, f)
    assert [(n, h, w, c) for _, (n, c, h, w), _ in ((r[0], r[1].shape, r[2]) for r in rec)] == tai_jax["calls"]
    assert len(rec) > len(quant.qconvs(m))  # the rollout reruns MC-Net's convs at every step
    if mode == "dynamic":
        err = _calls_vs_vfi_tpu(rec, tai_jax["params"])
        assert err <= 1e-6, err
    report = _report(out, tai_jax[mode], PRED_KEYS)
    assert _u8_psnr(out["pred"].numpy(), tai_jax[mode]["pred"]) >= 45.0, report
    print(f"{mode}: {report}")


# -- the zoo ----------------------------------------------------------------------

ZOO = {
    "SloMo": {"class": "SloMoFillInModel", "args": [], "kwargs": {"base_dim": 8, "c_dim": 3}},
    "SCT": {"class": "SCTSkipConScaledTForwardFillInModel", "args": [],
            "kwargs": {"c_dim": 3, "num_blocks": 1, "num_heads": 2, "d_v": 16}},
}


@pytest.mark.parametrize("name", sorted(ZOO))
def test_zoo_int8_matches_vfi_tpu(name, monkeypatch):
    """tests/test_quant.py's toy SloMo and SCT keys: as many QConvs as
    vfi_tpu's "quant" leaves, SCT's 1x1 proj left float, and the dynamic
    forward against vfi_tpu's as the TAI test holds it."""
    spec = ZOO[name]
    params = random_jax_params(spec, 0)
    rng = np.random.RandomState(0)
    p = rng.uniform(-1, 1, (1, 2, 32, 32, 3)).astype(np.float32)
    f = rng.uniform(-1, 1, (1, 2, 32, 32, 3)).astype(np.float32)
    model = jax_create_model(json.dumps(spec))
    sample = {"sample": jax.random.PRNGKey(1)}
    monkeypatch.setenv("VFI_INT8", "2")
    quant_tree = jax.eval_shape(lambda prm: model.apply({"params": prm}, 2, p, f, mutable=["quant"], rngs=sample),
                                params)[1]["quant"]
    monkeypatch.setenv("VFI_INT8", "1")
    want = jax.jit(lambda prm: model.apply({"params": prm}, 2, p, f, rngs=sample))(params)

    m = _port_model(spec, params, "1", monkeypatch)
    assert len(quant.qconvs(m)) == len(jax.tree.leaves(quant_tree)) > 10
    conv1x1 = [mod for mod in m.modules() if isinstance(mod, Conv1x1)]
    assert (len(conv1x1) > 0) == (name == "SCT")  # the attentions' value projections
    assert not any(isinstance(mod, quant.QConv) for mod in conv1x1)
    out, rec = _forward_by_call(m, 2, p, f)
    assert len(rec) >= len(quant.qconvs(m))
    assert _calls_vs_vfi_tpu(rec, params) <= 1e-6
    report = _report(out, {"pred": np.asarray(want["pred"])}, ("pred",))
    assert _u8_psnr(out["pred"].numpy(), np.asarray(want["pred"])) >= 45.0, report
    print(f"{name}: {report}")


# -- VFI_INT8 at create_model ----------------------------------------------------

@pytest.mark.parametrize("mode", ["0", "1", "2", "3"])
def test_vfi_int8_at_create_model(mode, monkeypatch):
    monkeypatch.delenv("VFI_INT8", raising=False)
    ref = create_model(TAI).state_dict()
    monkeypatch.setenv("VFI_INT8", mode)
    m = create_model(TAI)
    convs = quant.qconvs(m)
    if mode in ("1", "2"):
        assert len(convs) == sum(isinstance(mod, Conv) for mod in m.modules()) > 60
        assert all(c.static == (mode == "2") for c in convs.values())
        with pytest.raises(RuntimeError, match="inference-only"):
            create_training_environment(m, TrainConfig(K=3, T=3, F=3))
    else:
        assert not convs
    sd = m.state_dict()
    assert list(sd) == list(ref)
    assert all(sd[k].shape == ref[k].shape and sd[k].dtype == ref[k].dtype for k in ref)
    m.to(torch.bfloat16)
    assert all(t.dtype == torch.float32 for t in quant.act_amax_state(m).values())
    assert all(c.weight.dtype == torch.bfloat16 for c in convs.values())


# -- the predict CLI --------------------------------------------------------------

K = T = F = 2
HW, N_CLIPS, BATCH = 32, 3, 2
NAME = "toy_tai_int8"
CLI_META = dict(K=K, T=T, F=F, HW=HW, clips=N_CLIPS, batch=BATCH, clip_seed=5, snapshot_seed=9)
CLI_DYNAMIC = ("--quantize", "int8_dynamic", "--validate_quant", "0", "--device_normalize")


def _args(root, qual, ckpt, *extra):
    return ["--K", str(K), "--T", str(T), "--F", str(F), "--c_dim", "1", "--image_size", str(HW),
            "--batch_size", str(BATCH), "--model_key", json.dumps(TAI), "--name", NAME,
            "--checkpoints_dir", os.path.join(root, ckpt), "--test_video_list_path", os.path.join(root, "list.txt"),
            "--qual_result_root", qual, "--num_threads", "0", *extra]


def make_cli_root(root: str) -> str:
    """Into ``root``: a vfi_tpu snapshot (random weights), its conversion,
    the clips and their list."""
    lst = make_videolist(os.path.join(root, "clips"), N_CLIPS, seed=CLI_META["clip_seed"], n_frames=K + T + F, hw=HW)
    os.replace(lst, os.path.join(root, "list.txt"))
    raw = jax_snapshot(os.path.join(root, "ckpt_jax", NAME), "model_best.ckpt", TAI,
                       TrainConfig(K=K, T=T, F=F, df_dim=8, Ip=1), HW, seed=CLI_META["snapshot_seed"])
    tckpt.write_payload(os.path.join(root, "ckpt_torch", NAME), "model_best.ckpt",
                        to_torch_payload(raw["state"], raw["counters"], json.dumps(TAI)))
    return root


@pytest.fixture(scope="module")
def cli_root(tmp_path_factory):
    return make_cli_root(str(tmp_path_factory.mktemp("int8_predict")))


def _pred_pngs(qual):
    return {(clip, name): read_png(os.path.join(qual, clip, name)).astype(np.int16)
            for clip in sorted(os.listdir(qual)) for name in sorted(os.listdir(os.path.join(qual, clip)))
            if name.startswith("pred_middle_")}


def test_predict_int8_dynamic_matches_vfi_tpu(cli_root, golden):
    """vfi_tpu's cli/predict.py on the vfi_tpu snapshot (its PNGs from
    tests/make_torch_quant_golden.py, which runs it in its process on this
    module's ``cli_root``); the port on its conversion."""
    qual = os.path.join(cli_root, "qual_dynamic")
    predict.main(_args(cli_root, qual, "ckpt_torch", *CLI_DYNAMIC, "--device", "cpu"))
    got = _pred_pngs(qual)
    want = {tuple(k.split("/")[1:]): golden[k].astype(np.int16) for k in golden.files if k.startswith("png/")}
    assert sorted(got) == sorted(want) and len(got) == N_CLIPS * T
    worst = max(int(np.abs(got[k] - want[k]).max()) for k in want)
    assert worst <= 1, worst
    assert "VFI_INT8" not in os.environ


def test_predict_int8_static_equals_calibrate_then_forward(cli_root, capsys, monkeypatch):
    qual = os.path.join(cli_root, "qual_static")
    predict.main(_args(cli_root, qual, "ckpt_torch", "--quantize", "int8", "--calib_clips", "2", "--device", "cpu"))
    out = capsys.readouterr().out
    assert "int8 activation scales calibrated on 2 clips" in out
    assert "validate_quant (2 clips): PSNR f32" in out and "REFUSED" not in out
    assert "VFI_INT8" not in os.environ

    payload, _ = tckpt.load_snapshot(os.path.join(cli_root, "ckpt_torch", NAME), "model_best.ckpt")
    monkeypatch.setenv("VFI_INT8", "2")
    m = create_model(TAI)
    monkeypatch.delenv("VFI_INT8")
    m.load_state_dict(payload["generator"])
    m.eval()
    ds = ContiguousVideoClipDataset(1, os.path.join(cli_root, "list.txt"), K + T + F, False, False, (HW, HW), False,
                                    (0, 0))
    vids = torch.from_numpy(np.stack([ds[i]["targets"] for i in range(N_CLIPS)]))
    with torch.inference_mode():
        with quant.calibrate(m):  # the CLI's calibration batch: the first 2 clips
            m(T, vids[:2, :K], vids[:2, K + T:])
        # the CLI's batches: clips 0-1, then clip 2 padded with itself
        preds = [m(T, v[:, :K], v[:, K + T:])["pred"] for v in (vids[:2], vids[[2, 2]])]
    want = predict.to_uint8(torch.cat([preds[0], preds[1][:1]])).numpy()[..., 0]
    got = _pred_pngs(qual)
    assert len(got) == N_CLIPS * T
    for (clip, name), png in got.items():
        i, t = int(clip[len("clip"):].split(".")[0]), int(name[len("pred_middle_"):-4]) - K
        np.testing.assert_array_equal(png, want[i, t], err_msg=f"{clip}/{name}")


@pytest.mark.parametrize("case", ["refuse", "force", "skip"])
def test_predict_validate_quant_gate(cli_root, case, capsys):
    qual = os.path.join(cli_root, f"qual_gate_{case}")
    extra = {"refuse": ["--quant_tol_db", "-100"], "force": ["--quant_tol_db", "-100", "--force_quant"],
             "skip": ["--validate_quant", "0"]}[case]
    args = _args(cli_root, qual, "ckpt_torch", "--quantize", "int8_dynamic", "--device", "cpu", *extra)
    if case == "refuse":
        with pytest.raises(SystemExit) as e:
            predict.main(args)
        assert "validate_quant REFUSED this checkpoint for int8_dynamic serving" in str(e.value.code)
        assert not os.path.exists(qual)
        return
    stats = predict.main(args)
    out = capsys.readouterr().out
    assert stats["clips"] == N_CLIPS
    assert ("validate_quant FAILED" in out) == (case == "force")
    assert ("validate_quant (" in out) == (case == "force")

"""The port's reference-checkpoint import (vfi_tpu_torch.utils.torch_import and
cli.import_torch_checkpoint) against vfi_tpu's importer and the reference's
own forward, on the CPU at toy widths.

A seeded ``tests/torch_mirror.py`` model (the reference's state_dict layout,
its forward semantics, written in modern PyTorch) stands in for a published
snapshot.  Gates:
  * the port's import equals ``params_from_jax`` of vfi_tpu's import bit for
    bit (both are numpy, with no JAX compile), for TAI gray and color, TWI,
    MC-Net and the bidirectional kind, Super SloMo and, through
    ``disc_variables_from_jax``, the discriminator; the report skips exactly
    ``merge_residual1``'s four tensors for TAI and TWI;
  * the port's forward on the imported weights matches the mirror's forward
    within vfi_tpu's own tolerance (tests/test_torch_import.py: atol 3e-4,
    rtol 1e-3);
  * torch.save -> the port's import CLI -> the port's predict CLI (--device
    cpu) writes PNGs within 1 uint8 level of the mirror's forward on the
    same clips;
  * a missing key raises a KeyError naming every missing key, and
    ``model_kind_for_key`` agrees with vfi_tpu's on all 30 registry keys."""

import json
import os

import numpy as np
import pytest
import torch

from vfi_tpu.models import registry as jregistry
from vfi_tpu.utils import torch_import as jimport
from vfi_tpu_torch.cli import import_torch_checkpoint as import_cli
from vfi_tpu_torch.cli import predict
from vfi_tpu_torch.data.datasets import ContiguousVideoClipDataset
from vfi_tpu_torch.data.synthetic import make_videolist
from vfi_tpu_torch.models.registry import create_model, model_config
from vfi_tpu_torch.nn.discriminator import SNDiscriminator
from vfi_tpu_torch.utils import checkpoint as tckpt
from vfi_tpu_torch.utils import torch_import
from vfi_tpu_torch.utils.params import disc_variables_from_jax, params_from_jax
from vfi_tpu_torch.utils.png import read_png
from . import torch_mirror
from . import torch_threads  # noqa: F401  (one torch thread per xdist worker)

TOL = dict(atol=3e-4, rtol=1e-3)
GF, KF, KS, FS, LAYERS = 8, 4, 5, 3, 3
DEAD = ["merge_residual1.res.0.bias", "merge_residual1.res.0.weight", "merge_residual1.res.2.bias",
        "merge_residual1.res.2.weight"]


def _kth(cls, c_dim, num_block):
    return {"class": cls, "args": [], "kwargs": dict(gf_dim=GF, c_dim=c_dim, feature_size=FS, ks=KS,
                                                     num_block=num_block, kf_dim=KF, layers=LAYERS)}


def _mcnet(cls):
    return {"class": cls, "args": [], "kwargs": dict(gf_dim=GF, c_dim=1, feature_size=FS)}


# kind -> (mirror builder, importer kind, port spec, (K, T, F), compared outputs, skipped keys)
GENERATORS = {
    "tai_gray": (lambda: torch_mirror.TAIFillInModel(GF, 1, FS, KS, num_block=5, kf_dim=KF, layers=LAYERS), "tai",
                 _kth("TAIFillInModel", 1, 5), (3, 2, 3),
                 ("pred", "pred_forward", "pred_backward", "interp_net_outputs_1", "interp_net_outputs_2"), DEAD),
    "tai_color": (lambda: torch_mirror.TAIFillInModel(GF, 3, FS, KS, num_block=4, kf_dim=KF, layers=LAYERS), "tai",
                  _kth("TAIFillInModel", 3, 4), (3, 2, 3),
                  ("pred", "pred_forward", "pred_backward", "interp_net_outputs_1", "interp_net_outputs_2"), DEAD),
    "twi": (lambda: torch_mirror.TWIFillInModel(GF, 1, FS, KS, num_block=5, kf_dim=KF, layers=LAYERS), "twi",
            _kth("TWIFillInModel", 1, 5), (3, 2, 3), ("pred", "interp_net_outputs_1", "interp_net_outputs_2"), DEAD),
    "mcnet": (lambda: torch_mirror.MCNetFillInModel(GF, 1, FS), "mcnet", _mcnet("MCNetFillInModel"), (4, 3, 2),
              ("pred",), []),
    # bi-SA / bi-TWA checkpoints hold one shared MC-Net under "generator."
    # (no mirror of their blend: the import and the load are checked).
    "bidirectional": (lambda: torch_mirror.MCNetFillInModel(GF, 1, FS), "bidirectional",
                      _mcnet("BidirectionalSimpleAverageFillInModel"), None, (), []),
    "slomo": (lambda: torch_mirror.SloMoFillInModel(gf_dim=4, c_input_dim=1), "slomo",
              {"class": "SloMoFillInModel", "args": [], "kwargs": dict(base_dim=4, c_dim=1, warp_mode="torch03")},
              (2, 3, 2), ("pred", "F_0_1", "F_1_0", "F_t_0_collector", "F_t_1_collector"), []),
}
DISC = dict(df=8, c_dim=1, window=3, B=2, T=5, H=32, W=32)


def _numpy_state(m: torch.nn.Module) -> dict:
    return {k: v.detach().numpy() for k, v in m.state_dict().items()}


def _mirror(name: str, seed: int) -> torch.nn.Module:
    torch.manual_seed(seed)
    return GENERATORS[name][0]().eval()


def _port_import(name: str, sd: dict):
    _, kind, spec, *_ = GENERATORS[name]
    kw = spec["kwargs"]
    return torch_import.import_generator_state_dict(sd, kind, num_block=kw.get("num_block", 5),
                                                    layers=kw.get("layers", 3))


def _assert_state_equal(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype == torch.float32 and torch.equal(got[k], want[k]), k


def _nhwc(x: torch.Tensor) -> np.ndarray:
    """A mirror output, [B, T, C, H, W] or [B, C, H, W], channels last."""
    x = x.detach().numpy()
    return x.transpose(0, 1, 3, 4, 2) if x.ndim == 5 else x.transpose(0, 2, 3, 1)


@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_generator_import_equals_vfi_tpu(name):
    """Bit for bit against params_from_jax of vfi_tpu's import, the same
    report, and a strict load into the port's model."""
    _, kind, spec, *_, skipped = GENERATORS[name]
    sd = _numpy_state(_mirror(name, 0))
    state, report = _port_import(name, sd)
    kw = spec["kwargs"]
    jparams, jreport = jimport.import_generator_state_dict(sd, kind, num_block=kw.get("num_block", 5),
                                                           layers=kw.get("layers", 3))
    _assert_state_equal(state, params_from_jax(jparams))
    assert sorted(report.skipped) == sorted(jreport.skipped) == skipped
    assert report.converted == jreport.converted == len(state)
    create_model(spec).load_state_dict(state, strict=True)


def test_discriminator_import_equals_vfi_tpu():
    c = DISC
    torch.manual_seed(9)
    sd = _numpy_state(torch_mirror.SNDiscriminator((c["H"], c["W"]), c["c_dim"], c["window"], c["df"], Ip=1))
    state, report = torch_import.import_discriminator_state_dict(sd, c["df"])
    params, sn, jreport = jimport.import_discriminator_state_dict(sd, c["df"])
    _assert_state_equal(state, disc_variables_from_jax({"params": params, "sn": sn}))
    assert report.skipped == jreport.skipped == [] and report.converted == jreport.converted == 10
    assert sorted(k for k in state if k.endswith(".u")) == [f"conv{i}.sn.u" for i in range(4)] + ["head.sn.u"]


@pytest.mark.parametrize("name", sorted(n for n, g in GENERATORS.items() if g[3] is not None))
def test_forward_on_imported_weights_matches_mirror(name):
    _, _, spec, (K, T, F), keys, _ = GENERATORS[name]
    mirror = _mirror(name, 1)
    c_dim = spec["kwargs"]["c_dim"]
    rng = np.random.RandomState(42)
    p = rng.uniform(-1, 1, (2, K, c_dim, 32, 32)).astype(np.float32)
    f = rng.uniform(-1, 1, (2, F, c_dim, 32, 32)).astype(np.float32)
    with torch.no_grad():
        want = mirror(T, torch.from_numpy(p), torch.from_numpy(f))
    model = create_model(spec)
    model.load_state_dict(_port_import(name, _numpy_state(mirror))[0])
    with torch.no_grad():
        got = model.eval()(T, torch.from_numpy(p.transpose(0, 1, 3, 4, 2)), torch.from_numpy(f.transpose(0, 1, 3, 4, 2)))
    for key in keys:
        np.testing.assert_allclose(got[key].numpy(), _nhwc(want[key]), err_msg=key, **TOL)


def test_discriminator_forward_on_imported_weights_matches_mirror():
    c = DISC
    torch.manual_seed(9)
    mirror = torch_mirror.SNDiscriminator((c["H"], c["W"]), c["c_dim"], c["window"], c["df"], Ip=1).eval()
    video = np.random.RandomState(13).uniform(-1, 1, (c["B"], c["T"], c["c_dim"], c["H"], c["W"])).astype(np.float32)
    with torch.no_grad():
        want = mirror(torch.from_numpy(video)).numpy()
    disc = SNDiscriminator(c["window"], c["c_dim"], (c["H"], c["W"]), c["df"], 1)
    disc.load_state_dict(torch_import.import_discriminator_state_dict(_numpy_state(mirror), c["df"])[0])
    with torch.no_grad():
        got = disc(torch.from_numpy(video.transpose(0, 1, 3, 4, 2)), train=False).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_import_cli_then_predict_cli_serve_the_mirror(tmp_path):
    """torch.save -> the port's import CLI -> the port's predict CLI on the
    CPU: the PNGs within 1 uint8 level of the mirror's forward."""
    K = T = F = 2
    mirror = _mirror("tai_gray", 5)
    src = str(tmp_path / "model_best_ref.ckpt")
    torch.save({"updates": 200000, "sum_avg_psnr_err": 170.1, "sum_avg_ssim_err": 4.5,
                "generator": mirror.state_dict(), "optimizer_G": {}}, src)
    spec = json.dumps(GENERATORS["tai_gray"][2])
    out = import_cli.main([src, "--model_key", spec, "--dest_dir", str(tmp_path / "ckpt" / "imported")])
    assert sorted(out["report"].skipped) == DEAD and out["discriminator_report"] is None
    payload, counters = tckpt.load_snapshot(str(tmp_path / "ckpt" / "imported"), "model_best.ckpt")
    assert counters == {"updates": 200000, "sum_avg_psnr_err": 170.1, "sum_avg_ssim_err": 4.5}
    assert payload["step"] == 200000 and "g_opt" not in payload

    videolist = make_videolist(str(tmp_path / "clips"), 3, seed=3, n_frames=K + T + F, hw=32)
    qual = str(tmp_path / "qual")
    predict.main(["--K", str(K), "--T", str(T), "--F", str(F), "--c_dim", "1", "--image_size", "32",
                  "--batch_size", "2", "--model_key", spec, "--name", "imported",
                  "--checkpoints_dir", str(tmp_path / "ckpt"), "--test_video_list_path", videolist,
                  "--qual_result_root", qual, "--num_threads", "0", "--device", "cpu"])
    ds = ContiguousVideoClipDataset(1, videolist, K + T + F, False, False, (32, 32), False)
    clips = np.stack([ds[i]["targets"] for i in range(len(ds))]).transpose(0, 1, 4, 2, 3)
    with torch.no_grad():
        pred = mirror(T, torch.from_numpy(clips[:, :K]), torch.from_numpy(clips[:, K + T:]))["pred"]
    want = np.round(np.clip((_nhwc(pred) + 1.0) / 2.0, 0.0, 1.0) * 255.0)
    for i in range(len(ds)):
        label = ds[i]["clip_label"]
        got = np.stack([read_png(os.path.join(qual, label, f"pred_middle_{K + t:04d}.png")) for t in range(T)])
        assert np.abs(got.astype(np.float64).reshape(want[i].shape) - want[i]).max() <= 1, label


def test_import_cli_with_discriminator_serves_and_refuses_to_resume(tmp_path):
    """A training checkpoint's discriminator is carried over, u buffers and
    all; the snapshot holds no optimizer state, so resuming from it raises a
    clear error."""
    torch.manual_seed(6)
    gen = torch_mirror.MCNetFillInModel(GF, 1, FS)
    disc = torch_mirror.SNDiscriminator((32, 32), 1, 3, 8, Ip=1)
    src = str(tmp_path / "model_latest_ref.ckpt")
    torch.save({"updates": 7, "sum_avg_psnr_err": 1.0, "sum_avg_ssim_err": 1.0,
                "generator": gen.state_dict(), "discriminator": disc.state_dict()}, src)
    dest = str(tmp_path / "imported")
    out = import_cli.main([src, "--model_key", json.dumps(_mcnet("MCNetFillInModel")), "--dest_dir", dest,
                           "--df_dim", "8", "--snapshot_file_name", "model_latest.ckpt"])
    assert out["discriminator_report"].converted == 10
    payload, counters = tckpt.load_snapshot(dest, "model_latest.ckpt")
    assert counters["updates"] == 7
    params, sn, _ = jimport.import_discriminator_state_dict(_numpy_state(disc), 8)
    _assert_state_equal(payload["discriminator"], disc_variables_from_jax({"params": params, "sn": sn}))
    with pytest.raises(ValueError, match="no optimizer state"):
        tckpt.load_snapshot(dest, "model_latest.ckpt", state=object())


def test_missing_keys_raise_listing_every_one(tmp_path):
    sd = _numpy_state(_mirror("tai_gray", 0))
    gone = ["generator.motion_enc.dyn_conv1.0.weight", "kernelnet.moduleUpsample.0.1.weight"]
    for k in gone:
        del sd[k]
    with pytest.raises(KeyError) as e:
        _port_import("tai_gray", sd)
    assert all(k in str(e.value) for k in gone)
    torch.save(sd, str(tmp_path / "bare.pth"))  # a bare state_dict through the CLI
    with pytest.raises(KeyError, match="dyn_conv1"):
        import_cli.main([str(tmp_path / "bare.pth"), "--model_key", json.dumps(GENERATORS["tai_gray"][2]),
                         "--dest_dir", str(tmp_path / "out")])
    assert not os.path.exists(tmp_path / "out")


def _kind(fn, key):
    try:
        return fn(key)
    except ValueError:
        return ValueError


@pytest.mark.parametrize("key", sorted(jregistry.model_keys()))
def test_model_kind_for_key_agrees_with_vfi_tpu(key):
    """On the registry key and on its class name (what the CLI passes for a JSON key)."""
    for name in (key, model_config(key)["class"]):
        assert _kind(torch_import.model_kind_for_key, name) == _kind(jimport.model_kind_for_key, name), name


def test_import_cli_refuses_a_checkpoint_of_another_width(tmp_path):
    """The structural gate: a gf 8 checkpoint under a gf 16 model key stops
    before anything is written."""
    torch.save(_mirror("tai_gray", 0).state_dict(), str(tmp_path / "bare.pth"))
    wider = json.loads(json.dumps(GENERATORS["tai_gray"][2]))
    wider["kwargs"]["gf_dim"] = 16
    with pytest.raises(SystemExit, match="shape mismatch at mcnet.motion_enc.dyn1.weight"):
        import_cli.main([str(tmp_path / "bare.pth"), "--model_key", json.dumps(wider),
                         "--dest_dir", str(tmp_path / "out")])
    assert not os.path.exists(tmp_path / "out")

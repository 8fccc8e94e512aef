"""vfi_tpu_torch.api against vfi_tpu.api on the CPU, the full-width golden
fixture that chip_smoke.py holds the card against, and the port's isolation
from JAX."""

import ast
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import chip_smoke
from vfi_tpu import api as japi
from vfi_tpu.models.fill_in import TAIFillInModel as JTAI
from vfi_tpu_torch.api import VideoInpainter
from vfi_tpu_torch.utils.params import params_from_jax, random_jax_params
from . import torch_threads  # noqa: F401  (one torch thread per xdist worker)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = os.path.join(REPO, "vfi_tpu_torch")
FORBIDDEN = {"jax", "jaxlib", "flax", "vfi_tpu"}


@pytest.mark.parametrize("c_dim,num_block,channels,batched", [
    (1, 5, 3, True),  # gray model, RGB uint8 in: RGB->BGR, then luma
    (1, 5, 1, False),  # gray model, single-channel in, no batch axis
    (3, 4, 3, True),  # color model: BGR inside, RGB out
])
def test_inpaint_matches_jax(c_dim, num_block, channels, batched):
    kw = dict(gf_dim=8, c_dim=c_dim, feature_size=3, ks=5, num_block=num_block, kf_dim=4, layers=3)
    jp = random_jax_params({"class": "TAIFillInModel", "kwargs": kw}, seed=7)
    rng = np.random.RandomState(8)
    lead = (2, 3) if batched else (3,)
    pre = rng.randint(0, 256, lead + (32, 32, channels)).astype(np.uint8)
    fol = rng.randint(0, 256, lead + (32, 32, channels)).astype(np.uint8)

    want = japi.VideoInpainter(JTAI(**kw), g_params=jp).inpaint(pre, fol, T=2)
    port = VideoInpainter({"class": "TAIFillInModel", "kwargs": kw}, params_from_jax(jp), device="cpu")
    got = port.inpaint(pre, fol, T=2)

    assert got.dtype == np.uint8 and got.shape == want.shape
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= 1
    assert np.count_nonzero(diff) <= 1e-3 * diff.size


def test_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = {"class": "TWIFillInModel", "kwargs": dict(gf_dim=4, c_dim=1, ks=3, kf_dim=2, layers=2)}
    state = params_from_jax(random_jax_params(spec, seed=0))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        VideoInpainter(spec, state)
    ip = VideoInpainter(spec, state, device="cpu", dtype=torch.bfloat16)
    assert next(ip.model.parameters()).dtype == torch.bfloat16
    frames = np.zeros((2, 32, 32, 3), np.uint8)
    assert ip.inpaint(frames, frames, T=1).shape == (1, 32, 32, 1)


def _imported_roots(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_sources_import_no_jax():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(PACKAGE):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 10
    bad = {os.path.relpath(f, REPO): sorted(set(_imported_roots(f)) & FORBIDDEN) for f in files}
    assert {f: m for f, m in bad.items() if m} == {}


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys, pkgutil, importlib, vfi_tpu_torch, chip_smoke\n"
        "for m in pkgutil.walk_packages(vfi_tpu_torch.__path__, 'vfi_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'vfi_tpu'))\n"
        "assert not bad, bad\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_chip_smoke_fails_without_a_card_or_the_repo(tmp_path):
    """Here (no CUDA) it exits non-zero and prints no result; so it does in a
    directory that holds nothing else of the repo."""
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), alone)
    for cwd, script in ((REPO, "chip_smoke.py"), (tmp_path, str(alone))):
        r = subprocess.run([sys.executable, script], cwd=cwd, capture_output=True, text=True, timeout=120)
        assert r.returncode != 0, (cwd, r.stdout)
        assert '"ok"' not in r.stdout


def test_chip_smoke_bound_at_the_main_path_shape():
    """Bytes each read or written once over 3.35 TB/s: about 1.10 GB in bf16."""
    peak = chip_smoke.PEAKS["H100"]
    with torch.device("meta"):
        for dtype, want in ((torch.bfloat16, 0.3285), (torch.float32, 0.6569)):
            x = torch.empty(320, 178, 178, 1, dtype=dtype)
            v = h = torch.empty(320, 128, 128, 51, dtype=dtype)
            ms, by = chip_smoke.sepconv_bound_ms(x, v, h, peak)
            assert by == "bytes" and ms == pytest.approx(want, rel=1e-3)


def test_chip_smoke_adjoint_bounds_at_the_training_shape():
    """B*T=40 (B=8): bwd_vh moves x, g, v, h, grad_v and grad_h once (0.271 GB
    in bf16), bwd_x moves v, h, g and grad_x once (0.138 GB); both above
    their operation bounds (4*ks*(ks+1) and ks*(2*ks+1) flops per output
    pixel, 0.104 and 0.051 ms on the f32 CUDA cores)."""
    peak = chip_smoke.PEAKS["H100"]
    with torch.device("meta"):
        for dtype, want_vh, want_x in ((torch.bfloat16, 0.080965, 0.041056), (torch.float32, 0.16193, 0.082113)):
            x = torch.empty(40, 178, 178, 1, dtype=dtype)
            v = h = torch.empty(40, 128, 128, 51, dtype=dtype)
            g = torch.empty(40, 128, 128, 1, dtype=dtype)
            ms, by = chip_smoke.sepconv_bwd_vh_bound_ms(x, v, h, g, peak)
            assert by == "bytes" and ms == pytest.approx(want_vh, rel=1e-4)
            ms, by = chip_smoke.sepconv_bwd_x_bound_ms(v, h, g, peak)
            assert by == "bytes" and ms == pytest.approx(want_x, rel=1e-4)
        # the operation bounds alone, on the f32 CUDA cores
        assert 4 * 51 * 52 * 40 * 128 * 128 / 67e12 * 1e3 == pytest.approx(0.10376, rel=1e-4)
        assert 51 * 103 * 40 * 128 * 128 / 67e12 * 1e3 == pytest.approx(0.051382, rel=1e-4)


def test_golden_fixture_matches_chip_smoke():
    z = np.load(chip_smoke.GOLDEN_PATH)
    cfg = chip_smoke.GOLDEN
    assert {k: z[k].item() for k in cfg} == cfg
    shape = (cfg["B"], cfg["T"], cfg["H"], cfg["W"], cfg["C"])
    for key in ("pred", "pred_forward", "pred_backward"):
        assert z[key].shape == shape and z[key].dtype == np.float32 and np.isfinite(z[key]).all()
    assert os.path.getsize(chip_smoke.GOLDEN_PATH) < 1.5e6


@pytest.mark.slow
def test_full_width_forward_matches_golden():
    """The port on the CPU at full TAI_gray width against the JAX golden."""
    cfg = chip_smoke.GOLDEN
    z = np.load(chip_smoke.GOLDEN_PATH)
    ip = VideoInpainter(cfg["model_key"], params_from_jax(random_jax_params(cfg["model_key"], cfg["param_seed"])),
                        device="cpu")
    p, f = chip_smoke.golden_inputs()
    with torch.inference_mode():
        out = ip.model(cfg["T"], torch.from_numpy(p), torch.from_numpy(f))
    for key in ("pred", "pred_forward", "pred_backward"):
        got = out[key].numpy()
        assert np.abs(got - z[key]).max() <= 5e-3, key
        assert chip_smoke.u8_psnr(chip_smoke.u8(got), chip_smoke.u8(z[key])) >= 45.0, key

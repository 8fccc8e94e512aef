"""vfi_tpu_torch.cli.train against vfi_tpu's cli/train.py on the CPU, at a toy
TAI width (gf_dim 8, ks 5, 32x32 gray clips).

Both CLIs start from one vfi_tpu snapshot at updates=0 (random weights); the
port's is its conversion by scripts/convert_checkpoint_torch.py.  The data
order is deterministic in both: --serial_batches --no_backwards --no_flip,
clips of exactly K+T+F frames (so the crop is the whole clip) and
--num_threads 0.  Each CLI runs the same two invocations, with a snapshot
every 2 iterations and a validation sweep of three sets every 2
(--device_normalize): iterations 1-2 at K=T=F=3, then the resume to 5 under
--sample_KTF (vfi_tpu's padded dynamic step; the port's static step at each
sampled (K, T, F)); both resume from the port's iteration-2 snapshot (see
the fixture).  One vfi_tpu invocation costs about 18 s of its init on this
CPU, so the sampled run is the resumed one.  The port runs in-process with
--device cpu.  vfi_tpu's side, its two invocations of cli/train.py with
tensorboardX unimportable (so it writes no TensorBoard events and runs no
visualisation forwards, which change no logged number), is read from
tests/torch_golden_train_cli.npz: its log and its iteration-4 snapshot, and
the port's iteration-2 snapshot it resumed from, written by
``JAX_PLATFORMS=cpu python tests/make_torch_train_cli_golden.py`` on this
module's inputs.

Gates: every logged loss term within rel 1e-3; validation PSNR within 1e-3
dB and SSIM within 1e-4 on each of the three sets; model_best.ckpt at the
same iterations; the iteration-4 snapshot, converted back by to_jax, held to
vfi_tpu's under tests/test_torch_checkpoint.py's resume gates (weights, the
update since the resume, both Adam moments within global-L2-relative 1e-4;
the step counts equal); and the port's iteration-2 snapshot equal to the
one the golden's vfi_tpu run resumed from (weights and Adam moments within
global-L2-relative 1e-6), so that a golden made from another state fails."""

import glob
import json
import os

import numpy as np
import pytest
import torch

from scripts.convert_checkpoint_torch import to_jax_state, to_torch_payload
from vfi_tpu_torch.cli import train as train_cli
from vfi_tpu_torch.data.synthetic import make_videolist
from vfi_tpu_torch.utils import checkpoint as tckpt
from vfi_tpu_torch.utils.config import TrainConfig
from . import torch_threads  # noqa: F401  (one torch thread per xdist worker)
from .test_torch_predict import jax_snapshot

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
HW, B = 32, 2
SPEC = {"class": "TAIFillInModel", "args": [],
        "kwargs": dict(gf_dim=8, c_dim=1, feature_size=3, ks=5, num_block=5, kf_dim=4, layers=3)}
LENS = dict(K=3, T=3, F=3, alt_K=4, alt_T=4, alt_F=4)  # validation sets of 9, 10 and 11 frames
TERMS = ("G_Lp", "G_gdl", "G_GAN", "G_Lp_forward", "G_Lp_backward", "G_gdl_forward", "G_gdl_backward", "G_loss",
         "D_fake", "D_real")

GOLDEN_PATH = os.path.join(REPO, "tests", "torch_golden_train_cli.npz")
# What the golden was made on: this module's constants and seeds.
GOLDEN_META = dict(spec=SPEC, lens=LENS, hw=HW, batch=B, clip_seeds=[1, 2, 3, 4], start_seed=11, seed=5,
                   max_iters=[2, 5], flags=["--save_latest_freq", "2", "--validate_freq", "2", "--device_normalize"])


def _args(root, side, name, lens, lists, max_iter, extra=()):
    return ["--name", name, "--model_key", json.dumps(SPEC), "--c_dim", "1", "--image_size", str(HW),
            "--batch_size", str(B), "--df_dim", "8", "--Ip", "1", "--seed", "5", "--num_threads", "0",
            "--serial_batches", "--no_backwards", "--no_flip", "--print_freq", "1",
            *(a for k, v in lens.items() for a in (f"--{k}", str(v))),
            "--train_video_list_path", lists["train"], "--val_video_list_path", lists["val"],
            "--val_video_list_alt_T_path", lists["alt_T"], "--val_video_list_alt_K_F_path", lists["alt_K_F"],
            "--checkpoints_dir", os.path.join(root, f"ckpt_{side}"), "--tensorboard_dir", os.path.join(root, f"tb_{side}"),
            "--log_json", os.path.join(root, f"{side}_{name}.jsonl"), "--max_iter", str(max_iter), *extra]


def _lists(root, lens, tag):
    K, T, F = lens["K"], lens["T"], lens["F"]
    return {"train": make_videolist(os.path.join(root, f"{tag}_train"), 4, seed=1, n_frames=K + T + F, hw=HW),
            "val": make_videolist(os.path.join(root, f"{tag}_val"), B, seed=2, n_frames=K + T + F, hw=HW),
            "alt_T": make_videolist(os.path.join(root, f"{tag}_alt_T"), B, seed=3, n_frames=K + lens["alt_T"] + F,
                                    hw=HW),
            "alt_K_F": make_videolist(os.path.join(root, f"{tag}_alt_K_F"), B, seed=4,
                                      n_frames=lens["alt_K"] + T + lens["alt_F"], hw=HW)}


def _events(path, kind=None):
    with open(path) as f:
        events = [json.loads(ln) for ln in f if ln.strip()]
    return [e for e in events if kind is None or e["event"] == kind]


def _start_snapshot(root, name):
    """The same updates=0 snapshot for both CLIs: vfi_tpu's, and its conversion."""
    raw = jax_snapshot(os.path.join(root, "ckpt_jax", name), "model_latest.ckpt", SPEC,
                       TrainConfig(K=2, T=2, F=2, df_dim=8, Ip=1), HW, seed=11)
    tckpt.write_payload(os.path.join(root, "ckpt_torch", name), "model_latest.ckpt",
                        to_torch_payload(raw["state"], raw["counters"], json.dumps(SPEC)))


def plan(lists):
    """The two invocations: iterations 1-2 at fixed (K, T, F), then the resume to 5 under --sample_KTF."""
    flags = GOLDEN_META["flags"]
    return [("run", LENS, lists, 2, flags), ("run", LENS, lists, 5, flags + ["--sample_KTF"])]


def run_port(root, lists, invocation):
    """The port's CLI on one invocation of ``plan``, in this process, on one
    torch thread (as in every pytest-xdist worker and in the golden's run:
    the iteration-2 snapshot is then the golden's bit for bit)."""
    args = plan(lists)[invocation]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return train_cli.main(_args(root, "torch", *args[:4], [*args[4], "--device", "cpu",
                                                               "--vis_video_list_path", lists["val"]]))
    finally:
        torch.set_num_threads(threads)


def port_state(root, name):
    """A snapshot of the port's run, converted back by to_jax."""
    payload, _ = tckpt.load_snapshot(os.path.join(root, "ckpt_torch", "run"), name)
    return to_jax_state(payload, json.dumps(SPEC))


def _unflatten(golden, prefix):
    tree = {}
    for key in golden.files:
        if key.startswith(prefix + "/"):
            *path, leaf = key[len(prefix) + 1:].split("/")
            node = tree
            for k in path:
                node = node.setdefault(k, {})
            node[leaf] = golden[key]
    return tree


@pytest.fixture(scope="module")
def golden():
    g = np.load(GOLDEN_PATH)
    assert json.loads(str(g["meta"])) == json.loads(json.dumps(GOLDEN_META)), \
        "tests/torch_golden_train_cli.npz was made on other inputs: rerun tests/make_torch_train_cli_golden.py"
    return g


@pytest.fixture(scope="module")
def runs(tmp_path_factory, golden):
    """The port's two invocations, and vfi_tpu's from the golden.  Before its
    second invocation, vfi_tpu's model_latest.ckpt was replaced by the port's
    iteration-2 snapshot, converted back by to_jax, so both resume from one
    state: over steps from zero Adam moments, float reassociation alone moves
    a run by more than the resume gates (the port's own iteration-4 Adam
    moments differ by 5.7e-4 global-relative between one torch thread and
    eight), and the second invocation is what resuming is."""
    root = str(tmp_path_factory.mktemp("train_cli"))
    lists = _lists(root, LENS, "clips")
    _start_snapshot(root, "run")
    stats = [run_port(root, lists, 0), run_port(root, lists, 1)]
    with open(os.path.join(root, "jax_run.jsonl"), "w") as f:
        f.write(str(golden["jax_log"]))
    return dict(root=root, lists=lists, resumed=port_state(root, "model_00000002.ckpt")[0], stats=stats,
                jax_iter4=(_unflatten(golden, "jax_iter4"), _unflatten(golden, "jax_iter4_counters")),
                jax_start=_unflatten(golden, "port_at_2"))


def _rel(got, want):
    return abs(got - want) / max(abs(want), 1e-12)


@pytest.mark.parametrize("iters", [(1, 2), (3, 4, 5)], ids=["fixed_KTF", "sample_KTF_after_resume"])
def test_logged_terms_match_vfi_tpu(runs, iters):
    """Every iteration's loss terms (rel 1e-3), at the same iterations, and
    the resume events (the start snapshot, then iteration 2)."""
    got, want = (_events(os.path.join(runs["root"], f"{side}_run.jsonl")) for side in ("torch", "jax"))
    assert [e["iter"] for e in got if e["event"] == "iter"] == [e["iter"] for e in want if e["event"] == "iter"]
    assert [e["iter"] for e in got if e["event"] == "resume"] == [e["iter"] for e in want if e["event"] == "resume"]
    assert [e["iter"] for e in got if e["event"] == "resume"] == [0, 2]
    g_its, w_its = ({e["iter"]: e for e in ev if e["event"] == "iter"} for ev in (got, want))
    assert sorted(g_its) == [1, 2, 3, 4, 5]
    for i in iters:
        for k in TERMS:
            assert _rel(g_its[i][k], w_its[i][k]) <= 1e-3, (i, k, g_its[i][k], w_its[i][k])
    assert [e["iter"] for e in got if e["event"] == "done"] == [2, 5]


def test_sampled_lengths_follow_the_seed(runs):
    """--sample_KTF draws (K, T, F) from RandomState(--seed) as vfi_tpu's
    TAI environment does (K, F from 2, T from 1), anew in each invocation:
    the port's logged lengths."""
    rng = np.random.RandomState(5)
    want = [(3, 3, 3)] * 2 + [(rng.randint(2, 4), rng.randint(1, 4), rng.randint(2, 4)) for _ in range(3)]
    got = [(e["K"], e["T"], e["F"]) for e in _events(os.path.join(runs["root"], "torch_run.jsonl"), "iter")]
    assert got == want and len(set(got[2:])) > 1


def test_validation_and_best_snapshot_match_vfi_tpu(runs):
    got, want = (_events(os.path.join(runs["root"], f"{side}_run.jsonl")) for side in ("torch", "jax"))
    gv, wv = ([(e["iter"], e["tag"], e["psnr"], e["ssim"]) for e in ev if e["event"] == "val"] for ev in (got, want))
    assert [v[:2] for v in gv] == [v[:2] for v in wv] and len(gv) == 6
    for (it, tag, p, s), (_, _, wp, ws) in zip(gv, wv):
        assert abs(p - wp) <= 1e-3 and abs(s - ws) <= 1e-4, (it, tag, p, wp, s, ws)
    assert [e["iter"] for e in got if e["event"] == "best"] == [e["iter"] for e in want if e["event"] == "best"]
    assert any(e["event"] == "best" for e in got)
    names = {os.path.basename(p) for p in glob.glob(os.path.join(runs["root"], "ckpt_torch", "run", "*.ckpt"))}
    assert names == {"model_latest.ckpt", "model_00000002.ckpt", "model_00000004.ckpt", "model_best.ckpt"}
    assert os.path.isfile(os.path.join(runs["root"], "ckpt_torch", "run", "train_opt.txt"))


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (str(k),)))
        return out
    return {prefix: np.asarray(tree, np.float64)}


def _global_rel(got: dict, want: dict) -> float:
    assert sorted(got) == sorted(want)
    num = sum(float(((got[k] - want[k]) ** 2).sum()) for k in want)
    den = sum(float((want[k] ** 2).sum()) for k in want)
    return (num / den) ** 0.5


def test_resumed_snapshot_matches_vfi_tpu(runs):
    """The port's model_00000004.ckpt (resumed at 2, two sampled steps),
    converted back by to_jax, against vfi_tpu's from the same resumed state:
    weights, the update since the resume, Adam moments, steps and counters."""
    payload, counters = tckpt.load_snapshot(os.path.join(runs["root"], "ckpt_torch", "run"), "model_00000004.ckpt")
    got, got_counters = to_jax_state(payload, json.dumps(SPEC))
    want, want_counters = runs["jax_iter4"]
    start = {"g_params": runs["resumed"].g_params, "d_params": runs["resumed"].d_params}
    assert int(got.step) == int(np.asarray(want["step"])) == 4 and got_counters["updates"] == 4
    assert abs(got_counters["sum_avg_ssim_err"] - float(want_counters["sum_avg_ssim_err"])) <= 1e-3
    for name in ("g_params", "d_params"):
        g, w, s = _flat(getattr(got, name)), _flat(want[name]), _flat(start[name])
        assert _global_rel(g, w) <= 1e-4, name
        assert _global_rel({k: g[k] - s[k] for k in w}, {k: w[k] - s[k] for k in w}) <= 1e-4, name
    assert _global_rel(_flat(got.d_sn), _flat(want["d_sn"])) <= 1e-4
    for name in ("g_opt", "d_opt"):
        adam = getattr(got, name)[0]
        assert int(adam.count) == int(np.asarray(want[name]["0"]["count"])) == 4
        for m in ("mu", "nu"):
            assert _global_rel(_flat(getattr(adam, m)), _flat(want[name]["0"][m])) <= 1e-4, (name, m)


def test_device_cache_equals_the_streamed_run_and_profile_writes_a_trace(runs, monkeypatch, capsys):
    """--device_cache 2 cycles through the two batches after the init batch;
    with two batches an epoch that is the streamed sequence.  The same run
    traces iterations 2-3 (--profile_steps 2 3), and validates at 3 where
    matplotlib is not installed: TensorBoard then gets the scores but no
    PSNR-curve image."""
    root = runs["root"]
    lists = runs["lists"]
    base = ["--save_latest_freq", "100", "--device", "cpu", "--device_normalize"]
    trace_dir = os.path.join(root, "trace")
    terms = {}
    for name, extra in (("streamed", ["--validate_freq", "100"]),
                        ("cached", ["--validate_freq", "3", "--device_cache", "2", "--profile_steps", "2", "3",
                                    "--profile_dir", trace_dir])):
        _start_snapshot(root, name)
        if name == "cached":
            real = train_cli.importlib.util.find_spec
            monkeypatch.setattr(train_cli.importlib.util, "find_spec",
                                lambda n, *a: None if n == "matplotlib" else real(n, *a))
        stats = train_cli.main(_args(root, "torch", name, LENS, lists, 3, base + extra))
        terms[name] = [[e[k] for k in TERMS] for e in _events(os.path.join(root, f"torch_{name}.jsonl"), "iter")]
    assert len(terms["cached"]) == 3
    np.testing.assert_allclose(terms["cached"], terms["streamed"], rtol=1e-6, atol=0)
    assert stats["trace"] and os.path.dirname(stats["trace"]) == trace_dir
    with open(stats["trace"]) as f:
        assert json.load(f)["traceEvents"]
    assert "matplotlib is not installed" in capsys.readouterr().out
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    acc = EventAccumulator(os.path.join(root, "tb_torch", "cached"), size_guidance={"images": 0})
    acc.Reload()
    assert "val/avg_psnr" in acc.Tags()["scalars"] and "train_vis" in acc.Tags()["images"]
    assert not any(t.endswith("psnr_curve") for t in acc.Tags()["images"])


def test_tensorboard_events(runs):
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    acc = EventAccumulator(os.path.join(runs["root"], "tb_torch", "run"), size_guidance={"images": 0})
    acc.Reload()
    tags = acc.Tags()
    assert {"loss/G_loss", "val/avg_psnr", "val_alt_T/avg_ssim", "time_per_item"} <= set(tags["scalars"])
    assert {"train_vis", "val/psnr_curve", "samples/val", "val_alt_K_F/psnr_curve"} <= set(tags["images"])
    assert [s.step for s in acc.Scalars("loss/G_loss")] == [1, 2, 3, 4, 5]
    assert all(s["tensorboard"] for s in runs["stats"])


def test_train_refusals_and_tf32(runs, monkeypatch, tmp_path):
    """Without a GPU the CPU must be asked for; a launch's rank without a card
    of its own and VFI_INT8 raise; --train_dtype float32 runs with TF32 off and puts both
    flags back when main returns and when it raises."""
    root = runs["root"]
    args = _args(str(tmp_path), "torch", "refused", LENS, runs["lists"], 1,
                 ["--save_latest_freq", "100", "--validate_freq", "100"])
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        with monkeypatch.context() as m:
            m.setattr(torch.cuda, "is_available", lambda: False)
            with pytest.raises(RuntimeError, match="device='cpu'"):
                train_cli.main(args)
        assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
        with monkeypatch.context() as m:  # a launch's rank without a card of its own
            m.setattr(torch.cuda, "is_available", lambda: True)
            m.setattr(torch.cuda, "device_count", lambda: 1)
            m.setenv("LOCAL_RANK", "1")
            with pytest.raises(RuntimeError, match="LOCAL_RANK=1 but 1 CUDA device"):
                train_cli.main(args + ["--device", "cuda"])
        with monkeypatch.context() as m:
            m.setenv("VFI_INT8", "1")
            with pytest.raises(RuntimeError, match="VFI_INT8"):
                train_cli.main(args + ["--device", "cpu"])
        assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
        flags = []
        monkeypatch.setattr(train_cli, "_train", lambda opt: flags.append(
            (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)))
        train_cli.main(args + ["--device", "cpu"])
        assert flags == [(False, False)]
        assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    assert os.path.isdir(root)


def fingerprint(state) -> dict:
    """What the golden keeps of the port's iteration-2 state (weights, SN
    vectors, both Adam states, the step): per leaf, its sum, its sum of
    squares and every 61st value, in float64."""
    tree = {"g_params": state.g_params, "d_params": state.d_params, "d_sn": state.d_sn, "step": state.step,
            **{name: {m: getattr(getattr(state, name)[0], m) for m in ("count", "mu", "nu")}
               for name in ("g_opt", "d_opt")}}
    return {k: np.concatenate([[v.sum(), (v * v).sum()], v.ravel()[::61]]) for k, v in _flat(tree).items()}


def test_golden_resumed_from_this_port_state(runs):
    """vfi_tpu's recorded run resumed from the port's iteration-2 snapshot:
    that snapshot must still be the one this port writes (the fingerprints
    of weights, SN vectors and Adam moments within global-L2-relative 1e-6,
    the steps equal)."""
    got, want = fingerprint(runs["resumed"]), _flat(runs["jax_start"])
    assert sorted(got) == sorted(want) and len(want) > 100
    for part in ("g_params", "d_params", "d_sn", "g_opt", "d_opt"):
        sub = lambda tree: {k: v for k, v in tree.items() if k[0] == part}  # noqa: E731
        assert _global_rel(sub(got), sub(want)) <= 1e-6, part
    assert got[("step",)][0] == want[("step",)][0] == 2
    assert all(got[k][0] == want[k][0] == 2 for k in want if k[-1] == "count")

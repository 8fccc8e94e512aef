"""vfi_tpu_torch.utils.config against vfi_tpu.utils.config on the CPU: both
parsers have vfi_tpu's option set, defaults, types, choices and nargs, plus
the port's --device; argfiles (`@file` with `#` comments) parse alike;
--mesh_shape is checked against the launch's WORLD_SIZE (no model axis)."""

import argparse

import pytest

from vfi_tpu.utils import config as jconfig
from vfi_tpu_torch.utils import config as tconfig
from . import torch_threads  # noqa: F401  (one torch thread per xdist worker)

PORT_ONLY = {"device"}
TEST_ARGS = ["--K", "5", "--T", "5", "--F", "5", "--model_key", "TAI_gray", "--test_video_list_path", "l.txt",
             "--qual_result_root", "q"]
TRAIN_ARGS = ["--K", "5", "--T", "5", "--F", "5", "--model_key", "TAI_gray", "--alt_K", "3", "--alt_T", "3",
              "--alt_F", "3", "--train_video_list_path", "t.txt", "--val_video_list_path", "v.txt"]


def _options(parser: argparse.ArgumentParser) -> dict:
    return {a.dest: (tuple(a.option_strings), a.default, a.type, a.choices, a.nargs, a.required, type(a).__name__)
            for a in parser._actions if a.dest != "help"}


@pytest.mark.parametrize("which", ["build_train_parser", "build_test_parser"])
def test_parsers_have_vfi_tpus_options_and_defaults(which):
    got, want = _options(getattr(tconfig, which)()), _options(getattr(jconfig, which)())
    assert set(got) - set(want) == PORT_ONLY and set(want) <= set(got)
    for dest in want:
        assert got[dest] == want[dest], dest
    assert got["device"][1] == "cuda"


@pytest.mark.parametrize("which,args", [("build_test_parser", TEST_ARGS), ("build_train_parser", TRAIN_ARGS)])
def test_argfiles_parse_as_vfi_tpus(tmp_path, which, args):
    base = tmp_path / "base.txt"
    base.write_text("# defaults\n--image_size 64 48   # H W\n--padding_size=8\n--batch_size=16\n\n--c_dim=1\n")
    extra = tmp_path / "extra.txt"
    extra.write_text("--batch_size 4  # later flags override\n--name 'kth bi-TAI'\n")
    argv = [f"@{base}", f"@{extra}"] + args
    got = tconfig.parse_args(getattr(tconfig, which)(), argv)
    want = jconfig.parse_args(getattr(jconfig, which)(), argv)
    assert {k: v for k, v in vars(got).items() if k not in PORT_ONLY} == vars(want)
    assert got.image_size == [64, 48] and got.padding_size == [8, 8] and got.batch_size == 4
    assert got.name == "kth bi-TAI" and got.device == "cuda"
    assert tconfig.TrainConfig.from_opt(got) == tconfig.TrainConfig(K=5, T=5, F=5)


def test_unported_flags_raise(monkeypatch):
    """Nothing is refused any more but a mesh the launch cannot have: a model
    axis, or a data axis other than WORLD_SIZE (int8 serving and data
    parallelism are ported)."""
    for mode in ("int8", "int8_dynamic"):
        assert tconfig.parse_args(tconfig.build_test_parser(), TEST_ARGS + ["--quantize", mode]).quantize == mode
    with pytest.raises(ValueError, match="model axis of 2"):
        tconfig.parse_args(tconfig.build_train_parser(), TRAIN_ARGS + ["--mesh_shape", "1", "2"])
    with pytest.raises(ValueError, match="data axis of 2 against a launch of 1"):
        tconfig.parse_args(tconfig.build_train_parser(), TRAIN_ARGS + ["--mesh_shape", "2"])
    monkeypatch.setenv("WORLD_SIZE", "2")
    for shape in (["2"], ["2", "1"]):
        assert tconfig.parse_args(tconfig.build_train_parser(), TRAIN_ARGS + ["--mesh_shape", *shape]).mesh_shape \
            == [int(n) for n in shape]
    with pytest.raises(ValueError, match="model axis of 2"):
        tconfig.parse_args(tconfig.build_train_parser(), TRAIN_ARGS + ["--mesh_shape", "2", "2"])
    assert tconfig.parse_args(tconfig.build_test_parser(), TEST_ARGS).K == 5  # a launch of predict parses
    monkeypatch.delenv("WORLD_SIZE")
    opt = tconfig.parse_args(tconfig.build_test_parser(), TEST_ARGS + ["--quantize", "none", "--device", "cpu"],
                             allow_unknown=True)
    assert opt.quantize == "none" and opt.device == "cpu"


def test_listopt_prints_every_option(capsys):
    opt = tconfig.parse_args(tconfig.build_test_parser(), TEST_ARGS)
    tconfig.listopt(opt)
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("---") and out[-1].startswith("---")
    assert sorted(line.split(":")[0] for line in out[1:-1]) == sorted(vars(opt))

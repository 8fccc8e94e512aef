"""vfi_tpu_torch.data against vfi_tpu.data on the CPU (mirrors
tests/test_data.py): the same clips, labels and batches from `.npy` and
PNG-directory clips, with and without resizing, `emit_uint8`, the disjoint
videolist, `batch_iterator`'s shards and its drop_last refusal, the
Prefetcher, the native loader, and the synthetic clip families.  Gate:
equal arrays (both packages run the same numpy, cv2 and C++ code), except
where noted."""

import os
import random

import numpy as np
import pytest
from PIL import Image

from vfi_tpu.data import datasets as jdata
from vfi_tpu.data import native_loader as jnative
from vfi_tpu.data import prefetch as jprefetch
from vfi_tpu.data import synthetic as jsynthetic
from vfi_tpu_torch.data import datasets as tdata
from vfi_tpu_torch.data import native_loader as tnative
from vfi_tpu_torch.data import prefetch as tprefetch
from vfi_tpu_torch.data import synthetic as tsynthetic
from . import torch_threads  # noqa: F401  (one torch thread per xdist worker)


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    """One .npy clip (10 frames, 24x20) and two PNG-directory clips (RGB, gray)."""
    root = tmp_path_factory.mktemp("data")
    rng = np.random.RandomState(0)
    vid = rng.randint(0, 255, (10, 24, 20, 3), dtype=np.uint8)
    npy = str(root / "a.npy")
    np.save(npy, vid)
    dirs = []
    for name, shape in (("b", (24, 20, 3)), ("c", (24, 20))):
        d = root / name
        d.mkdir()
        for t in range(10):
            Image.fromarray(rng.randint(0, 255, shape, dtype=np.uint8)).save(d / f"{t:03d}.png")
        dirs.append(str(d))
    lst = str(root / "list.txt")
    with open(lst, "w") as f:
        f.write(f"{npy} 1-10\n{dirs[0]} 2-9\n{dirs[1]}\n")
    disjoint = str(root / "disjoint.txt")
    with open(disjoint, "w") as f:
        f.write(f"{npy} 1-3 8-10\n{dirs[0]} 2-4 7-9\n")
    return dict(list=lst, disjoint=disjoint, npy=npy, dirs=dirs, vid=vid)


def _both(cls_name, *args, **kw):
    return getattr(jdata, cls_name)(*args, **kw), getattr(tdata, cls_name)(*args, **kw)


def _same_items(jds, tds, seed=0):
    """Every item of both datasets under the same random state: equal targets and labels."""
    assert len(jds) == len(tds)
    for i in range(len(jds)):
        random.seed(seed + i)
        want = jds[i]
        random.seed(seed + i)
        got = tds[i]
        assert got["clip_label"] == want["clip_label"]
        assert got["targets"].dtype == want["targets"].dtype and got["targets"].shape == want["targets"].shape
        np.testing.assert_array_equal(got["targets"], want["targets"], err_msg=want["clip_label"])


@pytest.mark.parametrize("c_dim,size,seq,emit_uint8,padding", [
    (3, (24, 20), 8, False, (0, 0)),  # no resize: .npy and PNG frames decode alike
    (1, (24, 20), 6, False, (3, 5)),  # gray, padded
    (3, (24, 20), 6, True, (2, 0)),  # --device_normalize's uint8 BGR
    (3, (16, 16), 6, False, (0, 0)),  # resized (cv2 on both sides)
])
def test_contiguous_dataset_matches_vfi_tpu(clips, c_dim, size, seq, emit_uint8, padding):
    for use_native in (False, True):
        jds, tds = _both("ContiguousVideoClipDataset", c_dim, clips["list"], seq, False, False, size, False, padding,
                         use_native=use_native, emit_uint8=emit_uint8)
        _same_items(jds, tds)
    item = tds[0]
    assert item["targets"].shape == (seq, size[0] + padding[0], size[1] + padding[1], 3 if emit_uint8 else c_dim)
    assert item["clip_label"].endswith("a.npy_1-10")


def test_augmentations_match_vfi_tpu(clips):
    """Flip and time reversal draw from `random` in the same order."""
    jds, tds = _both("ContiguousVideoClipDataset", 3, clips["list"], 5, True, True, (24, 20), False,
                     use_native=False)
    for seed in range(6):
        _same_items(jds, tds, seed=10 * seed)


def test_npy_clip_values_and_too_short_range(clips):
    tds = tdata.ContiguousVideoClipDataset(3, clips["list"], 10, False, False, (24, 20), False, use_native=False)
    want = clips["vid"][..., ::-1].astype(np.float32) / 255.0 * 2 - 1  # stored RGB -> BGR in [-1, 1]
    np.testing.assert_allclose(tds[0]["targets"], want, atol=1e-6)
    with pytest.raises(RuntimeError, match="too short"):
        tds[1]  # range 2-9 has only 8 frames


def test_disjoint_dataset_matches_vfi_tpu(clips):
    jds, tds = _both("DisjointVideoClipDataset", 1, clips["disjoint"], 3, 3, (24, 20))
    _same_items(jds, tds)
    assert tds[0]["targets"].shape == (6, 24, 20, 1) and tds[0]["clip_label"].endswith("a.npy_1-3_8-10")
    with open(clips["disjoint"] + ".bad", "w") as f:
        f.write(f"{clips['npy']} 1-3\n")
    with pytest.raises(RuntimeError, match="expected line"):
        tdata.DisjointVideoClipDataset(1, clips["disjoint"] + ".bad", 3, 3, (24, 20))[0]


@pytest.mark.parametrize("shuffle,drop_last,shards,workers", [(False, False, 1, 0), (True, False, 2, 2),
                                                               (False, True, 1, 0), (True, True, 1, 3)])
def test_batch_iterator_matches_vfi_tpu(clips, shuffle, drop_last, shards, workers):
    jds, tds = _both("ContiguousVideoClipDataset", 1, clips["list"], 6, False, False, (16, 16), False)
    for shard in range(shards):
        kw = dict(seed=3, num_shards=shards, shard_index=shard, num_workers=workers)
        random.seed(0)
        want = list(jdata.batch_iterator(jds, 2, shuffle, drop_last, **kw))
        random.seed(0)
        got = list(tdata.batch_iterator(tds, 2, shuffle, drop_last, **kw))
        assert [b["clip_label"] for b in got] == [b["clip_label"] for b in want]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g["targets"], w["targets"])
    labels = [b["clip_label"] for s in range(2) for b in tdata.batch_iterator(tds, 1, False, False, num_shards=2,
                                                                             shard_index=s)]
    assert sorted(sum(labels, [])) == sorted(it["clip_label"] for it in (tds[i] for i in range(3)))


def test_batch_iterator_rejects_undersized_dataset():
    class FakeDs:
        def __len__(self):
            return 4

        def __getitem__(self, i):
            raise AssertionError("should not be reached")

    with pytest.raises(ValueError, match="drop_last"):
        next(tdata.batch_iterator(FakeDs(), 8, True, True, loop=True))


def test_prefetcher_matches_vfi_tpu_and_propagates_errors():
    assert list(tprefetch.Prefetcher(iter(range(7)), depth=2)) == list(jprefetch.Prefetcher(iter(range(7)), depth=2))

    def failing():
        yield 1
        raise OSError("decode failed")

    it = tprefetch.Prefetcher(failing(), depth=1)
    assert next(it) == 1
    with pytest.raises(OSError, match="decode failed"):
        next(it)


def test_native_loader_matches_vfi_tpus(clips):
    """The port's copy of the C++ loader, built into vfi_tpu_torch/_build/,
    against vfi_tpu's build of the same source, and against the Python path
    (the resize kernels differ by about one uint8 level, as in tests/test_data.py)."""
    if not (tnative.available() and jnative.available()):
        pytest.skip("native loader unavailable (g++, libpng or libjpeg missing)")
    assert tnative.library_path().parent == tnative.BUILD_DIR and tnative.library_path().is_file()
    paths = [[os.path.join(d, f"{t:03d}.png") for t in range(2, 8)] for d in clips["dirs"]]
    for c_dim in (1, 3):
        kw = dict(padding_size=(2, 3), flip_flags=[True, False], reverse_flags=[False, True])
        got = tnative.load_clip_batch(paths, (16, 16), c_dim, **kw)
        np.testing.assert_array_equal(got, jnative.load_clip_batch(paths, (16, 16), c_dim, **kw))
    ds_py = tdata.ContiguousVideoClipDataset(1, clips["list"], 8, False, False, (16, 16), False, use_native=False)
    ds_nat = tdata.ContiguousVideoClipDataset(1, clips["list"], 8, False, False, (16, 16), False, use_native=True)
    assert np.abs(ds_nat[1]["targets"] - ds_py[1]["targets"]).max() < 0.02


@pytest.mark.parametrize("family", sorted(tsynthetic.FAMILIES))
def test_synthetic_clips_match_vfi_tpu(tmp_path, family):
    got = tsynthetic.make_videolist(str(tmp_path / "t"), 2, seed=5, n_frames=7, hw=32, family=family)
    want = jsynthetic.make_videolist(str(tmp_path / "j"), 2, seed=5, n_frames=7, hw=32, family=family)
    for i in range(2):
        np.testing.assert_array_equal(np.load(tmp_path / "t" / f"clip{i}.npy"),
                                      np.load(tmp_path / "j" / f"clip{i}.npy"))
    with open(got) as f:
        assert [ln.split()[1] for ln in f] == ["1-7", "1-7"]

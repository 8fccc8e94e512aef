"""Host-side clip datasets (counterpart of ``vfi_tpu/data/datasets.py``).

Behavioral reference: src/data/base_dataset.py, as vfi_tpu keeps it.
  * Videolist line formats:
      contiguous:  "<path>"  or  "<path> A-B"      (1-indexed inclusive range)
      disjoint:    "<path> A-B C-D"                (preceding + following ranges)
  * Processing order (base_dataset.py:73-100): decode (RGB) -> resize ->
    RGB->BGR -> optional horizontal flip -> pad bottom/right -> optional time
    reversal -> [0,1] -> [-1,1] -> optional grayscale.
  * Fault tolerance: open/decode retries, resample-on-fail for training sets,
    hard errors for eval sets (base_dataset.py:110-140,160-200).

A clip "video" is a video file (imageio/ffmpeg), a directory of image frames,
or a ``.npy`` [T, H, W, C] uint8 array.  Output is NHWC numpy ``float32
[T, H, W, C]`` in [-1, 1], or uint8 BGR with ``emit_uint8``.

``.npy`` clips at the model's size need no image library.  PNG frames are
read by the port's own codec (``utils/png.py``); cv2 is imported only for
other frame formats and for resizing, imageio only for video files.
"""

from __future__ import annotations

import os
import random
import re
from typing import Iterator, List, Optional, Sequence
from warnings import warn

import numpy as np

from ..ops.image import BGR_LUMA
from ..utils.png import read_png

_IMG_EXTS = (".png", ".jpg", ".jpeg", ".bmp")


def _read_frame_file(path: str) -> np.ndarray:
    """An RGB uint8 frame [H, W, 3] (or [H, W] for gray PNGs) of an image file,
    as cv2's ``IMREAD_COLOR`` gives it: any alpha dropped."""
    if path.lower().endswith(".png"):
        img = read_png(path)
        if img.ndim == 3 and img.shape[2] in (2, 4):
            img = img[..., 0] if img.shape[2] == 2 else img[..., :3]
        return img
    import cv2

    img = cv2.imread(path, cv2.IMREAD_COLOR)  # BGR
    if img is None:
        raise IOError(f"failed to read {path}")
    return img[:, :, ::-1]  # -> RGB


class _VideoReader:
    """Uniform frame access over video files, frame directories and .npy clips."""

    def __init__(self, path: str):
        self.path = path
        self._frames = None
        self._reader = None
        if os.path.isdir(path):
            names = sorted(n for n in os.listdir(path) if n.lower().endswith(_IMG_EXTS))
            if not names:
                raise IOError(f"no frames in directory {path}")
            self._frame_paths = [os.path.join(path, n) for n in names]
            self._len = len(names)
        elif path.endswith(".npy"):
            self._frames = np.load(path)  # [T, H, W, C] uint8, RGB
            self._len = len(self._frames)
        else:
            import imageio

            self._reader = imageio.get_reader(path, "ffmpeg")
            self._len = self._reader.count_frames()

    def __len__(self) -> int:
        return self._len

    def get_frame(self, idx: int) -> np.ndarray:
        """Returns an RGB uint8 frame [H, W, 3] (or [H, W] for gray sources)."""
        if self._frames is not None:
            return self._frames[idx]
        if self._reader is not None:
            return np.asarray(self._reader.get_data(idx))
        return _read_frame_file(self._frame_paths[idx])


def _open_video(path: str, retries: int = 5) -> Optional[_VideoReader]:
    for _ in range(retries):
        try:
            return _VideoReader(path)
        except (IOError, OSError, ValueError):
            warn(f"failed to open video {path}, retrying")
    warn(f"failed to open video {path} after {retries} attempts")
    return None


class ContiguousVideoClipDataset:
    """Random temporal crops of ``seq_len = K+T+F`` frames from listed clips."""

    def __init__(
        self,
        c_dim: int,
        video_list_path: str,
        seq_length: int,
        backwards: bool,
        flip: bool,
        image_size: Sequence[int],
        resample_on_fail: bool,
        padding_size: Sequence[int] = (0, 0),
        data_root: str | None = None,
        use_native: bool = True,
        emit_uint8: bool = False,
    ):
        self.c_dim = c_dim
        self.seq_len = seq_length
        self.backwards = backwards
        self.flip = flip
        self.image_size = tuple(image_size)  # (H, W)
        self.padding_size = tuple(padding_size)  # (pad_bottom, pad_right)
        self.resample_on_fail = resample_on_fail
        self.data_root = data_root or ""
        self.use_native = use_native
        self.emit_uint8 = emit_uint8
        with open(video_list_path) as f:
            self.files = [ln.strip() for ln in f if ln.strip()]

    def __len__(self) -> int:
        return len(self.files)

    # -- frame processing ----------------------------------------------------
    def _process_frames(self, frames: List[np.ndarray], flip_flag: bool, back_flag: bool) -> np.ndarray:
        H, W = self.image_size
        out = []
        for img in frames:
            if img.ndim == 2:
                img = np.stack([img] * 3, axis=-1)
            if img.shape[:2] != (H, W):
                import cv2

                img = cv2.resize(img, (W, H))
            img = img[:, :, ::-1]  # RGB -> BGR (reference convention)
            if flip_flag:
                img = img[:, ::-1, :]
            pb, pr = self.padding_size
            if pb or pr:
                img = np.pad(img, ((0, pb), (0, pr), (0, 0)))
            out.append(img)
        if back_flag:
            out = out[::-1]
        if self.emit_uint8:
            # uint8 BGR; normalization/grayscale happen on the device
            # (ops/image.py:frames_from_uint8) — 4x less H2D traffic.
            return np.stack(out)
        video = np.stack(out).astype(np.float32) / 255.0  # [T, H, W, 3] in [0,1]
        video = video * 2.0 - 1.0
        if self.c_dim == 1:
            video = video @ np.asarray(BGR_LUMA, np.float32)
            video = video[..., None]
        return video

    def _read_seq(self, vid: _VideoReader, frame_indexes, clip_label: str):
        flip_flag = self.flip and random.random() > 0.5
        back_flag = self.backwards and random.random() > 0.5

        # Fast path: frame-directory sources decode + preprocess in the native
        # C++ loader (thread pool, no GIL) — see csrc/vfidata.cpp.
        if getattr(vid, "_frame_paths", None) is not None and self.use_native and not self.emit_uint8:
            from . import native_loader

            if native_loader.available():
                try:
                    batch = native_loader.load_clip_batch(
                        [[vid._frame_paths[t] for t in frame_indexes]],
                        self.image_size,
                        self.c_dim,
                        self.padding_size,
                        flip_flags=[flip_flag],
                        reverse_flags=[back_flag],
                    )
                    return {"targets": batch[0], "clip_label": clip_label}
                except IOError:
                    pass  # fall through to the Python path

        frames = []
        for t in frame_indexes:
            try:
                frames.append(vid.get_frame(t))
            except Exception:
                warn(f"failed to read frame {t} of {vid.path}")
                return None
        return {
            "targets": self._process_frames(frames, flip_flag, back_flag),
            "clip_label": clip_label,
        }

    def __getitem__(self, index: int):
        while True:
            parts = self.files[index].split()
            video_path = os.path.join(self.data_root, parts[0]) if self.data_root else parts[0]
            vid = _open_video(video_path)
            if vid is None:
                if not self.resample_on_fail:
                    raise RuntimeError(f"video at {video_path} could not be opened")
                index = np.random.randint(len(self.files))
                continue

            if len(parts) == 1:
                full_range = (0, len(vid) - 1)
            else:
                a, b = parts[1].split("-")
                full_range = (int(a) - 1, int(b) - 1)  # 1-indexed inclusive -> 0-indexed

            if full_range[1] - full_range[0] + 1 < self.seq_len:
                if not self.resample_on_fail:
                    raise RuntimeError(f"interval {full_range} in {video_path} too short")
                index = np.random.randint(len(self.files))
                continue

            start = random.randint(full_range[0], full_range[1] - self.seq_len + 1)
            label = f"{os.path.basename(video_path)}_{full_range[0] + 1}-{full_range[1] + 1}"
            item = self._read_seq(vid, range(start, start + self.seq_len), label)
            if item is None:
                if not self.resample_on_fail:
                    raise RuntimeError(f"failed to sample frames at {start} in {video_path}")
                index = np.random.randint(len(self.files))
                continue
            return item


class DisjointVideoClipDataset(ContiguousVideoClipDataset):
    """Inference-only dataset: preceding + following ranges without middles
    (reference base_dataset.py:205-248)."""

    def __init__(self, c_dim, video_list_path, K, F, image_size, padding_size=(0, 0), data_root=None,
                 emit_uint8: bool = False):
        # seq_len = K + F: the frames actually read per item (the overridden
        # __getitem__ ignores it, but keep the parent's invariant meaningful).
        super().__init__(c_dim, video_list_path, K + F, False, False, image_size, False, padding_size, data_root,
                         emit_uint8=emit_uint8)
        self.K = K
        self.F = F

    def __getitem__(self, index: int):
        m = re.match(r"(.+) (\d+)-(\d+) (\d+)-(\d+)", self.files[index])
        if m is None:
            raise RuntimeError(
                f'expected line "<video_path> <A-B> <C-D>", found "{self.files[index]}"'
            )
        video_path = os.path.join(self.data_root, m.group(1)) if self.data_root else m.group(1)
        p_a, p_b, f_a, f_b = (int(m.group(i)) - 1 for i in range(2, 6))
        vid = _open_video(video_path)
        if vid is None:
            raise RuntimeError(f"video at {video_path} could not be opened")
        idxs = list(range(p_a, p_b + 1)) + list(range(f_a, f_b + 1))
        label = f"{os.path.basename(video_path)}_{p_a + 1}-{p_b + 1}_{f_a + 1}-{f_b + 1}"
        item = self._read_seq(vid, idxs, label)
        if item is None:
            raise RuntimeError(f"failed to read frames {idxs} of {video_path}")
        return item


def batch_iterator(
    dataset,
    batch_size: int,
    shuffle: bool,
    drop_last: bool,
    seed: int = 0,
    num_shards: int = 1,
    shard_index: int = 0,
    loop: bool = False,
    num_workers: int = 0,
) -> Iterator[dict]:
    """Minimal host batcher with per-process sharding.

    Each process reads only its shard of the videolist.  ``num_workers > 1``
    decodes the samples of a batch on a thread pool — the role of the
    reference DataLoader's worker processes (--num_threads,
    train.py:40-41); clip decoding in the native C++ loader releases the GIL,
    so threads genuinely overlap.
    """
    pool = None
    if num_workers > 1:
        from concurrent.futures import ThreadPoolExecutor

        pool = ThreadPoolExecutor(max_workers=num_workers)
    try:
        rng = random.Random(seed)
        order = list(range(len(dataset)))[shard_index::num_shards]
        if drop_last and len(order) < batch_size:
            # Would otherwise spin forever yielding nothing (every chunk is
            # dropped) — a silent infinite loop in the prefetcher.
            raise ValueError(
                f"rank {shard_index} of {num_shards}: its dataset shard has {len(order)} of {len(dataset)} items "
                f"but batch_size={batch_size} "
                f"with drop_last=True would never yield a batch"
            )
        while True:
            idxs = order[:]
            if shuffle:
                rng.shuffle(idxs)
            for i in range(0, len(idxs), batch_size):
                chunk = idxs[i : i + batch_size]
                if len(chunk) < batch_size and drop_last:
                    continue
                if pool is not None:
                    items = list(pool.map(dataset.__getitem__, chunk))
                else:
                    items = [dataset[j] for j in chunk]
                yield {
                    "targets": np.stack([it["targets"] for it in items]),
                    "clip_label": [it["clip_label"] for it in items],
                }
            if not loop:
                return
    finally:
        if pool is not None:
            pool.shutdown(wait=False)

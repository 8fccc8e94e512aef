"""Synthetic video-clip families (a copy of ``vfi_tpu/data/synthetic.py``).

Deterministic clips written as ``.npy`` videos plus a reference-format
videolist (``path start-end`` lines), for tests and smoke runs that must not
download data (KTH / UCF-101 / HMDB-51).  The same seed gives the same clips
as vfi_tpu's copy.

Two families with deliberately different spectra:

* ``gratings`` — drifting sinusoid gratings (band-limited, smooth motion).
* ``textures`` — broadband moving textures: a smoothed-noise background
  panning at one velocity with a second textured patch moving over it
  (occlusion + disocclusion), the stress case for reduced-precision serving.
"""

from __future__ import annotations

import os

import numpy as np


def grating_clip(rng: np.random.RandomState, n_frames: int, hw: int) -> np.ndarray:
    """Drifting sinusoid grating -> [T, H, W, 3] uint8."""
    yy, xx = np.mgrid[0:hw, 0:hw].astype(np.float32)
    vx, vy = rng.uniform(-3, 3, 2)
    wl = rng.uniform(16, 48)
    phase = rng.uniform(0, 2 * np.pi)
    frames = []
    for t in range(n_frames):
        img = 127.5 + 70 * np.sin(2 * np.pi * (xx + vx * t) / wl + phase) * np.cos(
            2 * np.pi * (yy + vy * t) / wl
        )
        frames.append(img)
    vid = np.clip(np.stack(frames), 0, 255).astype(np.uint8)[..., None]
    return np.repeat(vid, 3, axis=-1)


def _smooth_noise(rng: np.random.RandomState, h: int, w: int, blur: int) -> np.ndarray:
    """Box-smoothed uniform noise field, renormalized to [0, 255]."""
    x = rng.uniform(0, 1, (h, w)).astype(np.float32)
    if blur > 1:
        k = np.ones(blur, np.float32) / blur
        x = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), 1, x)
        x = np.apply_along_axis(lambda c: np.convolve(c, k, "same"), 0, x)
    lo, hi = x.min(), x.max()
    return (x - lo) / max(hi - lo, 1e-6) * 255.0


def texture_clip(rng: np.random.RandomState, n_frames: int, hw: int) -> np.ndarray:
    """Moving broadband textures with occlusion -> [T, H, W, 3] uint8.

    A large background texture pans at an integer velocity (frames are
    translated crops, so the motion is exact); a smaller, differently
    textured patch slides over it at another velocity.
    """
    margin = 3 * n_frames + 8
    bg = _smooth_noise(rng, hw + 2 * margin, hw + 2 * margin, blur=3)
    patch_hw = hw // 3
    patch = _smooth_noise(rng, patch_hw, patch_hw, blur=2) * 0.6 + 90.0
    bvx, bvy = rng.randint(-2, 3), rng.randint(-2, 3)
    pvx, pvy = rng.randint(-3, 4), rng.randint(-3, 4)
    if pvx == bvx and pvy == bvy:
        pvx += 1  # guarantee relative motion (occlusion/disocclusion)
    px0 = rng.randint(patch_hw, hw - patch_hw)
    py0 = rng.randint(patch_hw, hw - patch_hw)
    frames = []
    for t in range(n_frames):
        ox, oy = margin + bvx * t, margin + bvy * t
        img = bg[oy : oy + hw, ox : ox + hw].copy()
        py = int(np.clip(py0 + pvy * t, 0, hw - patch_hw))
        px = int(np.clip(px0 + pvx * t, 0, hw - patch_hw))
        img[py : py + patch_hw, px : px + patch_hw] = patch
        frames.append(img)
    vid = np.clip(np.stack(frames), 0, 255).astype(np.uint8)[..., None]
    return np.repeat(vid, 3, axis=-1)


FAMILIES = {"gratings": grating_clip, "textures": texture_clip}


def make_videolist(root: str, n_clips: int, seed: int, n_frames: int = 16,
                   hw: int = 128, family: str = "gratings") -> str:
    """Write ``n_clips`` .npy clips + a reference-format videolist; returns
    the videolist path."""
    clip_fn = FAMILIES[family]
    rng = np.random.RandomState(seed)
    os.makedirs(root, exist_ok=True)
    lines = []
    for i in range(n_clips):
        vid = clip_fn(rng, n_frames, hw)
        path = os.path.join(root, f"clip{i}.npy")
        np.save(path, vid)
        lines.append(f"{path} 1-{n_frames}")
    list_path = os.path.join(root, "list.txt")
    with open(list_path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return list_path

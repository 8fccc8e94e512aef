"""GIF / video generation helpers for qualitative results (counterpart of
``vfi_tpu/eval/animate.py``).

Behavioral reference: animate_qual_results.py and
generate_comparison_videos.py (moviepy/ImageMagick there; imageio+PIL here,
as in vfi_tpu).  PIL is required; imageio is imported when a GIF is written
and, where it is missing, raises an ``ImportError`` naming it.
"""

from __future__ import annotations

import os
import re
from typing import List, Sequence

import numpy as np
from PIL import Image, ImageDraw

from ..utils.optional import require

GREEN = "lime"
RED = "red"


def draw_border(image: Image.Image, color) -> Image.Image:
    """2px border around a PIL image (animate_qual_results.py:30-41)."""
    img = image.convert("RGB")
    w, h = img.size
    draw = ImageDraw.Draw(img)
    draw.line([(1, 0), (w - 2, 0), (w - 2, h - 1), (1, h - 1), (1, 0)], width=2, fill=color)
    return img


def files_matching(root: str, pattern: str) -> List[str]:
    rx = re.compile(pattern)
    names = sorted(n for n in os.listdir(root) if rx.match(n))
    return [os.path.join(root, n) for n in names]


def write_gif(frames: Sequence[Image.Image], path: str, fps: int) -> None:
    imageio = require("imageio", "write_gif")
    imageio.mimsave(path, [np.array(f) for f in frames], format="GIF", duration=1000.0 / fps, loop=0)


def animate_clip_folder(clip_path: str, fps: int = 3, create_gt_gif: bool = False) -> None:
    """Build pred_final.gif (and optionally gt.gif) for one predict output
    folder, with lime context / red generated borders
    (animate_qual_results.py:54-105)."""
    gt_frames: List[Image.Image] = []
    pred_frames: List[Image.Image] = []

    for p in files_matching(clip_path, r"gt_preceding_[0-9]+\.png"):
        f = draw_border(Image.open(p), GREEN)
        gt_frames.append(f)
        pred_frames.append(f)

    gt_middles = files_matching(clip_path, r"gt_middle_[0-9]+\.png")
    if create_gt_gif:
        if not gt_middles:
            raise RuntimeError(f"GT GIF requested but no GT middle frames in {clip_path}")
        gt_frames += [draw_border(Image.open(p), RED) for p in gt_middles]

    pred_frames += [draw_border(Image.open(p), RED) for p in files_matching(clip_path, r"pred_middle_[0-9]+\.png")]

    for p in files_matching(clip_path, r"gt_following_[0-9]+\.png"):
        f = draw_border(Image.open(p), GREEN)
        gt_frames.append(f)
        pred_frames.append(f)

    if create_gt_gif:
        write_gif(gt_frames, os.path.join(clip_path, "gt.gif"), fps)
    write_gif(pred_frames, os.path.join(clip_path, "pred_final.gif"), fps)


def labeled_stack_frame(frames: Sequence[Image.Image], labels: Sequence[str], border_color) -> Image.Image:
    """Vertically stack per-experiment frames with text labels — one output
    frame of a comparison video (generate_comparison_videos.py:55-102)."""
    from PIL import ImageFont

    bordered = [draw_border(f, border_color) for f in frames]
    w = max(f.size[0] for f in bordered)
    label_h = 18
    total_h = sum(f.size[1] + label_h for f in bordered)
    canvas = Image.new("RGB", (w, total_h), "white")
    draw = ImageDraw.Draw(canvas)
    y = 0
    font = ImageFont.load_default()
    for f, label in zip(bordered, labels):
        draw.text((2, y + 2), label, fill="black", font=font)
        canvas.paste(f, (0, y + label_h))
        y += f.size[1] + label_h
    return canvas

"""Centimeter-precise PDF figure canvas for the paper-artifact CLIs
(counterpart of ``vfi_tpu/eval/figures.py``).

The reference renders its comparison figures with fpdf (src/util/vis_utils.py:
add_image_to_pdf :75-97, add_cropped_image_to_pdf :100-129, add_text_to_pdf,
create_pdf :173-190) using top-left-origin centimeter coordinates.  As in
vfi_tpu, this module provides the same drawing surface on top of matplotlib
(Agg), so the figure-generation CLIs can compute layouts in the exact
geometry of the reference scripts.

Coordinates: (x_cm, y_cm) measured from the TOP-LEFT of the page, like fpdf.

Optional packages, imported where used (an ``ImportError`` naming the
package where it is missing): matplotlib for :class:`PdfCanvas` and
:func:`text_width_cm`, imageio for GIFs and OpenCV (cv2) for MP4s in
:func:`write_video`.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np

from ..utils.optional import require

CM_PER_IN = 2.54

# Reference color constants (vis_utils.py:10-15), as 0-1 RGB.
ORANGE = (1.0, 128 / 255, 0.0)
PURPLE = (153 / 255, 51 / 255, 1.0)
YELLOW = (1.0, 215 / 255, 0.0)
GREEN = (0.0, 215 / 255, 0.0)
WHITE = (1.0, 1.0, 1.0)
CYAN = (0.0, 215 / 255, 215 / 255)

_FONT_FAMILY = "serif"


def in2cm(length_in: float) -> float:
    return length_in * CM_PER_IN


def cm2in(length_cm: float) -> float:
    return length_cm / CM_PER_IN


def text_width_cm(text: str, font_size_pt: float) -> float:
    """Width of rendered text in cm (vis_utils.get_text_width equivalent)."""
    require("matplotlib", "text_width_cm")
    from matplotlib.font_manager import FontProperties
    from matplotlib.textpath import TextPath

    if not text:
        return 0.0
    tp = TextPath((0, 0), text, size=font_size_pt, prop=FontProperties(family=_FONT_FAMILY))
    return in2cm(tp.get_extents().width / 72.0)


def _load_image(path: str) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB"))


class PdfCanvas:
    """A fixed-size page addressed in top-left-origin centimeters."""

    def __init__(self, width_cm: float, height_cm: float):
        matplotlib = require("matplotlib", "PdfCanvas")
        matplotlib.use("Agg")
        from matplotlib.figure import Figure

        self.width_cm = width_cm
        self.height_cm = height_cm
        self.fig = Figure(figsize=(cm2in(width_cm), cm2in(height_cm)))
        self.fig.patch.set_facecolor("white")

    def _frac(self, x_cm: float, y_cm: float, w_cm: float, h_cm: float):
        """Top-left cm rect -> matplotlib bottom-left figure-fraction rect."""
        return (
            x_cm / self.width_cm,
            1.0 - (y_cm + h_cm) / self.height_cm,
            w_cm / self.width_cm,
            h_cm / self.height_cm,
        )

    def _border(self, x_cm, y_cm, w_cm, h_cm, b_cm, color):
        from matplotlib.patches import Rectangle

        left, bottom, width, height = self._frac(x_cm - b_cm, y_cm - b_cm, w_cm + 2 * b_cm, h_cm + 2 * b_cm)
        self.fig.patches.append(
            Rectangle((left, bottom), width, height, transform=self.fig.transFigure,
                      facecolor=color, edgecolor="none", zorder=1)
        )

    def add_image(self, path: str, x_cm: float, y_cm: float, w_cm: float, h_cm: float,
                  b_cm: float = 0.0, color=None):
        """vis_utils.add_image_to_pdf: image at (x,y) sized (w,h) with a
        surrounding border of thickness b_cm in the given color."""
        if b_cm > 0 and color is not None:
            self._border(x_cm, y_cm, w_cm, h_cm, b_cm, color)
        ax = self.fig.add_axes(self._frac(x_cm, y_cm, w_cm, h_cm), zorder=2)
        ax.imshow(_load_image(path), aspect="auto", interpolation="bilinear")
        ax.set_axis_off()

    def add_cropped_image(self, path: str, region: Sequence[float], x_cm: float, y_cm: float,
                          w_cm: float, h_cm: float, b_cm: float = 0.0, color=None):
        """vis_utils.add_cropped_image_to_pdf: draw the fractional sub-region
        (tl_x, tl_y, br_x, br_y) of the image, scaled to (w,h) cm."""
        img = _load_image(path)
        H, W = img.shape[:2]
        tlx, tly, brx, bry = region
        crop = img[int(round(tly * H)): int(round(bry * H)), int(round(tlx * W)): int(round(brx * W))]
        if crop.size == 0:
            return
        if b_cm > 0 and color is not None:
            self._border(x_cm, y_cm, w_cm, h_cm, b_cm, color)
        ax = self.fig.add_axes(self._frac(x_cm, y_cm, w_cm, h_cm), zorder=2)
        ax.imshow(crop, aspect="auto", interpolation="bilinear")
        ax.set_axis_off()

    def add_text(self, text: str, x_cm: float, y_cm: float, font_size_pt: float):
        """Text whose top-left corner sits at (x,y) cm, like fpdf's text cell."""
        self.fig.text(x_cm / self.width_cm, 1.0 - y_cm / self.height_cm, text,
                      fontsize=font_size_pt, ha="left", va="top", family=_FONT_FAMILY)

    def save(self, path: str):
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        self.fig.savefig(path, facecolor=self.fig.get_facecolor())


def write_video(frame_paths_or_arrays, dest: str, fps: int, video_type: str):
    """Write a sequence of RGB uint8 frames as gif/mp4/mp4-uncomp.

    The reference shells out to ffmpeg (compare_visual_results.py:58-69);
    as vfi_tpu does, this uses imageio for GIFs and cv2's VideoWriter for
    MP4s.  mp4-uncomp takes the same writer as mp4, as in vfi_tpu.
    """
    frames = [np.asarray(f) for f in frame_paths_or_arrays]
    if video_type == "gif":
        imageio = require("imageio", "write_video (gif)")
        imageio.mimsave(dest, frames, duration=1000.0 / fps, loop=0)
    elif video_type in ("mp4", "mp4-uncomp"):
        cv2 = require("cv2", f"write_video ({video_type})")
        h, w = frames[0].shape[:2]
        writer = cv2.VideoWriter(dest, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
        if not writer.isOpened():
            raise RuntimeError(f"cv2 VideoWriter could not open {dest}")
        for f in frames:
            writer.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
        writer.release()
    else:
        raise ValueError(f"unknown video_type {video_type}")

"""Classical optical-flow interpolation baseline (counterpart of
``vfi_tpu/models/optical_flow.py``; host code, no learning, no torch).

Behavioral reference: src/models/optical_flow_fill_in/ — Farnebäck flow both
directions (optical_flow_utils.py:119-129), cKDTree-based flow inversion with
inverse-distance interpolation (:7-104), per-t blend (:107-116).  The
reference's per-pixel Python loops in ``adjustFlow_G`` and ``frameadjust``
are vectorized (the same algorithm).

Exposed via ``host_forward`` (numpy in/out): the predict CLI and
``api.VideoInpainter`` dispatch on that attribute and run it on the host,
without a device, a snapshot or a dtype.  The port hands its models videos
``[B, T, H, W, C]``, the layout ``host_forward`` takes, so nothing is
transposed.  It needs OpenCV (``cv2``) and scipy: where either is missing,
building the model raises an ``ImportError`` that names it (vfi_tpu fails at
the first forward instead).
"""

from __future__ import annotations

import importlib

import numpy as np

_FARNEBACK = dict(pyr_scale=0.8, levels=7, winsize=15, iterations=3, poly_n=7, poly_sigma=1.5, flags=2)


def _farneback(a_gray: np.ndarray, b_gray: np.ndarray) -> np.ndarray:
    import cv2

    return cv2.calcOpticalFlowFarneback(a_gray, b_gray, None, **_FARNEBACK)


def invert_flow(flow: np.ndarray, p: float = 3.0, k: int = 5):
    """Invert a dense flow field by splatting source coords into a KD-tree and
    inverse-distance interpolating the k nearest splats at each target pixel.

    Returns (reverse_flow, matched_mask).  Vectorized equivalent of the
    reference's adjustFlow_G (optical_flow_utils.py:31-76): pixels with no
    splat within distance 1 keep the sentinel mapping (-1000), exact hits take
    the exact splat with the largest source displacement, everything else is
    IDW-interpolated with power p over the non-zero-distance neighbors.
    """
    from scipy import spatial

    h, w = flow.shape[:2]
    gx, gy = np.meshgrid(np.arange(w, dtype=np.float32), np.arange(h, dtype=np.float32))
    coord = np.stack([gx, gy], axis=-1)  # [h, w, 2] (x, y)

    splat = (flow + coord).reshape(-1, 2)
    tree = spatial.cKDTree(splat)
    dist, idx = tree.query(coord.reshape(-1, 2), k=k)  # [hw, k]
    dist = dist.reshape(h, w, k)
    idx = idx.reshape(h, w, k)

    src = np.stack([(idx % w).astype(np.float32), (idx // w).astype(np.float32)], axis=0)  # [2, h, w, k]

    close = np.any(dist < 1.0, axis=-1)  # [h, w]
    exact = np.any(dist == 0.0, axis=-1)

    reverse = np.full((h, w, 2), -1000.0, np.float32)

    # Exact matches: among the k neighbors pick the one with max displacement
    # from the target pixel; use it iff its distance is exactly 0.
    disp = np.sqrt((src[1] - gy[..., None]) ** 2 + (src[0] - gx[..., None]) ** 2)  # [h, w, k]
    md_k = np.argmax(disp, axis=-1)  # [h, w]
    take = np.take_along_axis
    md_dist = take(dist, md_k[..., None], axis=-1)[..., 0]
    exact_ok = exact & (md_dist == 0.0)
    exact_val = np.stack(
        [take(src[0], md_k[..., None], axis=-1)[..., 0], take(src[1], md_k[..., None], axis=-1)[..., 0]], axis=-1
    )

    # IDW interpolation over neighbors with dist > 0.
    pos = dist > 0
    with np.errstate(divide="ignore", invalid="ignore"):
        wgt = np.where(pos, 1.0 / np.maximum(dist, 1e-20) ** p, 0.0)
    wsum = wgt.sum(axis=-1)
    interp = np.stack(
        [(src[0] * wgt).sum(-1), (src[1] * wgt).sum(-1)], axis=-1
    ) / np.maximum(wsum, 1e-20)[..., None]

    use_exact = close & exact_ok
    use_interp = close & ~exact_ok
    reverse[use_exact] = exact_val[use_exact]
    reverse[use_interp] = interp[use_interp]

    return (reverse - coord).astype(np.float32), close


def _fill_holes(frame: np.ndarray, alt: np.ndarray) -> np.ndarray:
    """Replace all-zero pixels with the alternative frame (frameadjust)."""
    hole = np.all(frame == 0, axis=-1)
    out = frame.copy()
    out[hole] = alt[hole]
    return out


def interpolate_frames(before: np.ndarray, after: np.ndarray, num_new: int):
    """[H, W, 3] uint8 BGR endpoints -> list of interpolated uint8 frames."""
    import cv2

    before_g = cv2.cvtColor(before, cv2.COLOR_BGR2GRAY)
    after_g = cv2.cvtColor(after, cv2.COLOR_BGR2GRAY)
    # Matches get_flow's naming: fwd_flow maps after->before, back_flow the converse.
    back_flow = _farneback(before_g, after_g)
    fwd_flow = _farneback(after_g, before_g)

    h, w = before.shape[:2]
    gx, gy = np.meshgrid(np.arange(w, dtype=np.float32), np.arange(h, dtype=np.float32))
    coords = np.stack([gx, gy], axis=-1)

    frames = []
    for i in range(1, num_new + 1):
        t = i / (1.0 + num_new)
        inv_b, _ = invert_flow(back_flow * t)
        inv_f, _ = invert_flow(fwd_flow * (1.0 - t))
        from_prev = cv2.remap(before, inv_b + coords, None, cv2.INTER_LINEAR)
        from_next = cv2.remap(after, inv_f + coords, None, cv2.INTER_LINEAR)
        from_next = _fill_holes(from_next, before)
        from_prev = _fill_holes(from_prev, after)
        frame = ((1.0 - t) * from_prev + t * from_next).astype(np.uint8)
        frames.append(frame)
    return frames


class OFFillInModel:
    """Host model: numpy-in/numpy-out, uniform fill-in signature.  Building
    it checks that OpenCV and scipy import."""

    def __init__(self):
        for package, module in (("OpenCV", "cv2"), ("scipy", "scipy.spatial")):
            try:
                importlib.import_module(module)
            except ImportError as e:
                raise ImportError(f"OFFillInModel needs {package} ({module}), which is not installed: {e}",
                                  name=module) from e

    def host_forward(self, T: int, preceding: np.ndarray, following: np.ndarray) -> dict:
        """
        :param preceding/following: [B, K/F, H, W, C] float32 BGR in [-1, 1]
        """
        import cv2

        B, _, H, W, C = preceding.shape
        last_p = ((preceding[:, -1] + 1.0) / 2.0 * 255.0).astype(np.uint8)
        first_f = ((following[:, 0] + 1.0) / 2.0 * 255.0).astype(np.uint8)

        preds = []
        for b in range(B):
            a, z = last_p[b], first_f[b]
            if C == 1:
                a = cv2.cvtColor(a, cv2.COLOR_GRAY2BGR)
                z = cv2.cvtColor(z, cv2.COLOR_GRAY2BGR)
            mids = interpolate_frames(a, z, T)
            if C == 1:
                mids = [cv2.cvtColor(m, cv2.COLOR_BGR2GRAY)[..., None] for m in mids]
            preds.append(np.stack(mids))
        pred = np.stack(preds).astype(np.float32) / 255.0 * 2.0 - 1.0
        return {"pred": pred}

"""The TAI / TWI kernel-prediction network (counterpart of ``vfi_tpu/nn/kernelnet.py``).

A small U-Net over the concatenated MC-Net encodings emits four per-pixel 1-D
kernel stacks that filter the two predicted frames through :func:`sepconv`.

Reference behaviour kept as vfi_tpu keeps it:
  * with ``num_block=4`` the decoder has 3 blocks, so the ratio plane at
    decoder index ``rc_loc-1 == 3`` is never injected;
  * the reference's ``merge_residual1`` output is never read, so it is not
    computed.

The feature maps are NCHW.  The frames come in NCHW; the outputs are
sepconv's ``[B, H, W, C]``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.image import upsample2x_bilinear
from ..ops.sepconv import IMPLS, pad_for_sepconv, sepconv
from .layers import Conv, ConvBlock, avg_pool2


class KernelHead(nn.Module):
    """convs -> relu -> 2x bilinear upsample -> conv; output ``[B, ks, H, W]``."""

    def __init__(self, in_features: int, kf_dim: int, ks: int, layers: int, align_corners: bool = True):
        super().__init__()
        self.layers = layers
        self.align_corners = align_corners
        c = in_features
        for i in range(layers - 1):
            self.add_module(f"conv{i}", Conv(c, kf_dim * 2, 3))
            c = kf_dim * 2
        self.to_ks = Conv(c, ks, 3)
        self.post_up = Conv(ks, ks, 3)

    def forward(self, x):
        for i in range(self.layers - 1):
            x = F.relu(getattr(self, f"conv{i}")(x))
        x = F.relu(self.to_ks(x))
        return self.post_up(upsample2x_bilinear(x, self.align_corners))


class KernelNet(nn.Module):
    """U-Net + four kernel heads + the two sepconv applications.

    :param use_ratio: True for TAI (inject the time plane), False for TWI.
    :param sepconv_impl: :func:`sepconv`'s ``impl`` for both applications
        (None: the device's default).
    """

    def __init__(self, gf_dim: int, ks: int, num_block: int = 5, layers: int = 3, kf_dim: int = 32,
                 use_ratio: bool = True, rc_loc: int = 4, align_corners: bool = True,
                 sepconv_impl: Optional[str] = None):
        super().__init__()
        if num_block < 4:
            raise ValueError(f"num_block must be >= 4, got {num_block}")
        if sepconv_impl not in (None, *IMPLS):
            raise ValueError(f"unknown sepconv impl {sepconv_impl!r}; one of {IMPLS} or None")
        self.ks, self.num_block, self.use_ratio, self.rc_loc = ks, num_block, use_ratio, rc_loc
        self.sepconv_impl = sepconv_impl
        nb, kf = num_block, kf_dim
        c = 16 * gf_dim  # [dyn1, dyn2, cont1, cont2], 4g channels each
        for i in range(3, nb):
            self.add_module(f"enc{i}", ConvBlock(c, kf * 2**i, layers))
            c = kf * 2**i
        ndec = nb - 1
        for i in range(ndec):
            c_out = kf * 2 ** (ndec - i)
            self.add_module(f"dec{i}", ConvBlock(c, c_out, layers))
            ratio_plane = int(use_ratio and i == rc_loc - 1)
            self.add_module(f"up{i}", Conv(c_out + ratio_plane, c_out, 3))
            c = c_out
        for name in ("vertical1", "vertical2", "horizontal1", "horizontal2"):
            self.add_module(name, KernelHead(c, kf, ks, layers, align_corners))
        self.align_corners = align_corners

    def forward(self, frame1, frame2, dyn1, dyn2, cont1, cont2, merged_res2, merged_res3, ratio):
        """
        :param frame1/frame2: forward/backward predicted frames ``[B, C, H, W]``
        :param dyn1/dyn2, cont1/cont2: motion/content encodings ``[B, 4g, H/8, W/8]``
        :param merged_res2: merged residual ``[B, 2kf, H/2, W/2]``
        :param merged_res3: merged residual ``[B, 4kf, H/4, W/4]``
        :param ratio: per-batch-element time ratio ``[B]`` (read only when use_ratio)
        :return: (dot1, dot2), the two filtered frames ``[B, H, W, C]``
        """
        nb = self.num_block
        x = torch.cat([dyn1, dyn2, cont1, cont2], dim=1)
        enc = []
        for i in range(3, nb):
            x = getattr(self, f"enc{i}")(x)
            enc.append(x)
            x = avg_pool2(x)

        for i in range(nb - 1):
            x = getattr(self, f"dec{i}")(x)
            if self.use_ratio and i == self.rc_loc - 1:
                B, _, h, w = x.shape
                plane = ratio.to(x.dtype)[:, None, None, None].expand(B, 1, h, w)
                x = torch.cat([x, plane], dim=1)
            x = F.relu(getattr(self, f"up{i}")(upsample2x_bilinear(x, self.align_corners)))
            if i < nb - 3:
                x = x + enc[nb - 3 - i - 1]
            elif i == nb - 3:
                x = x + merged_res3
            else:
                x = x + merged_res2

        # Heads emit NCHW [B, ks, H, W]; the permuted view is sepconv's
        # [B, H, W, ks] with tap stride H*W, which the kernel reads as is.
        v1, v2, h1, h2 = (getattr(self, n)(x).permute(0, 2, 3, 1)
                          for n in ("vertical1", "vertical2", "horizontal1", "horizontal2"))
        dot1 = sepconv(pad_for_sepconv(frame1.permute(0, 2, 3, 1), self.ks), v1, h1, impl=self.sepconv_impl)
        dot2 = sepconv(pad_for_sepconv(frame2.permute(0, 2, 3, 1), self.ks), v2, h2, impl=self.sepconv_impl)
        return dot1, dot2

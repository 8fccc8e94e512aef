"""bi-TAI, plain PyTorch: the benchmark's reference of the served and trained model.

The architecture of "A Temporally-Aware Interpolation Network for Video
Frame Inpainting" (Sun, Szeto, Corso; ACCV 2018) as the upstream code runs
it: MC-Net forward from the preceding frames and backward from the reversed
following frames, KernelNet predicting per-pixel separable kernels, the two
sepconv applications and the 0.5 / 0.5 blend.  Videos are channels-last
``[B, T, H, W, C]`` in [-1, 1]; the networks compute in NCHW and float32.

Parameter names are the port's state_dict keys, so one weight dict loads
into both.  ``sepconv_fn`` replaces the separable convolution (the FLOP
counter passes a stub that records its shapes).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from . import sepconv as sepconv_ref
from .layers import Conv, ConvLSTMCell, fixed_unpooling, max_pool2, to_gray_frames, upsample2x_bilinear


class MotionEnc(nn.Module):
    def __init__(self, g: int):
        super().__init__()
        self.dyn1 = Conv(1, g, 5)
        self.dyn2 = Conv(g, g * 2, 5)
        self.dyn3 = Conv(g * 2, g * 4, 7)

    def forward(self, diff):
        r1 = F.relu(self.dyn1(diff))
        r2 = F.relu(self.dyn2(max_pool2(r1)))
        r3 = F.relu(self.dyn3(max_pool2(r2)))
        return max_pool2(r3), (r1, r2, r3)


class ContentEnc(nn.Module):
    def __init__(self, g: int, c_dim: int):
        super().__init__()
        self.c1a, self.c1b = Conv(c_dim, g, 3), Conv(g, g, 3)
        self.c2a, self.c2b = Conv(g, g * 2, 3), Conv(g * 2, g * 2, 3)
        self.c3a, self.c3b, self.c3c = Conv(g * 2, g * 4, 3), Conv(g * 4, g * 4, 3), Conv(g * 4, g * 4, 3)

    def forward(self, frame):
        r1 = F.relu(self.c1b(F.relu(self.c1a(frame))))
        r2 = F.relu(self.c2b(F.relu(self.c2a(max_pool2(r1)))))
        r3 = F.relu(self.c3c(F.relu(self.c3b(F.relu(self.c3a(max_pool2(r2)))))))
        return max_pool2(r3), (r1, r2, r3)


class CombLayers(nn.Module):
    def __init__(self, g: int):
        super().__init__()
        self.comb1, self.comb2, self.comb3 = Conv(g * 8, g * 4, 3), Conv(g * 4, g * 2, 3), Conv(g * 2, g * 4, 3)

    def forward(self, h_dyn, h_cont):
        x = F.relu(self.comb1(torch.cat([h_dyn, h_cont], dim=1)))
        return F.relu(self.comb3(F.relu(self.comb2(x))))


class Residual(nn.Module):
    def __init__(self, in_features: int, out_dim: int):
        super().__init__()
        self.res1, self.res2 = Conv(in_features, out_dim, 3), Conv(out_dim, out_dim, 3)

    def forward(self, a, b):
        return self.res2(F.relu(self.res1(torch.cat([a, b], dim=1))))


class DecCnn(nn.Module):
    def __init__(self, c_dim: int, g: int):
        super().__init__()
        self.d3a, self.d3b, self.d3c = Conv(g * 4, g * 4, 3), Conv(g * 4, g * 4, 3), Conv(g * 4, g * 2, 3)
        self.d2a, self.d2b = Conv(g * 2, g * 2, 3), Conv(g * 2, g, 3)
        self.d1a, self.d1b = Conv(g, g, 3), Conv(g, c_dim, 3)

    def forward(self, comb, res1, res2, res3):
        x = fixed_unpooling(comb) + res3
        x = F.relu(self.d3c(F.relu(self.d3b(F.relu(self.d3a(x))))))
        x = fixed_unpooling(x) + res2
        x = F.relu(self.d2b(F.relu(self.d2a(x))))
        x = fixed_unpooling(x) + res1
        return torch.tanh(self.d1b(F.relu(self.d1a(x))))


def _gray_nchw(frames):
    return to_gray_frames(frames.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


class MCNet(nn.Module):
    """K-1 warm-up steps over difference frames, then T autoregressive steps;
    returns each step's (pred, dyn, cont, res1, res2, res3), NCHW, stacked over T."""

    def __init__(self, g: int, c_dim: int):
        super().__init__()
        self.g = g
        self.motion_enc = MotionEnc(g)
        self.content_enc = ContentEnc(g, c_dim)
        self.conv_lstm = ConvLSTMCell(4 * g, 4 * g, 3, 1.0)
        self.comb_layers = CombLayers(g)
        self.residual1 = Residual(g * 2, g)
        self.residual2 = Residual(g * 4, g * 2)
        self.residual3 = Residual(g * 8, g * 4)
        self.dec_cnn = DecCnn(c_dim, g)

    def _predict(self, xt, h_dyn, res_m):
        h_cont, res_c = self.content_enc(xt)
        h_tpl = self.comb_layers(h_dyn, h_cont)
        r1 = self.residual1(res_m[0], res_c[0])
        r2 = self.residual2(res_m[1], res_c[1])
        r3 = self.residual3(res_m[2], res_c[2])
        return (self.dec_cnn(h_tpl, r1, r2, r3), h_dyn, h_cont, r1, r2, r3)

    def forward(self, T, diff_in, xt):
        B, Km1, H, W, _ = diff_in.shape
        xt = xt.permute(0, 3, 1, 2)
        state = torch.zeros((B, 8 * self.g, H // 8, W // 8), dtype=xt.dtype, device=xt.device)
        h_dyn, res_m = None, None
        for t in range(Km1):
            enc, res_m = self.motion_enc(diff_in[:, t].permute(0, 3, 1, 2))
            h_dyn, state = self.conv_lstm(enc, state)
        steps = [self._predict(xt, h_dyn, res_m)]
        for _ in range(1, T):
            x_hat = steps[-1][0]
            enc, res_m = self.motion_enc(_gray_nchw(x_hat) - _gray_nchw(xt))
            h_dyn, state = self.conv_lstm(enc, state)
            xt = x_hat
            steps.append(self._predict(xt, h_dyn, res_m))
        return [torch.stack(f) for f in zip(*steps)]


class KernelHead(nn.Module):
    def __init__(self, in_features: int, kf_dim: int, ks: int, layers: int):
        super().__init__()
        self.layers = layers
        c = in_features
        for i in range(layers - 1):
            self.add_module(f"conv{i}", Conv(c, kf_dim * 2, 3))
            c = kf_dim * 2
        self.to_ks = Conv(c, ks, 3)
        self.post_up = Conv(ks, ks, 3)

    def forward(self, x):
        for i in range(self.layers - 1):
            x = F.relu(getattr(self, f"conv{i}")(x))
        return self.post_up(upsample2x_bilinear(F.relu(self.to_ks(x))))


class ConvBlock(nn.Module):
    def __init__(self, in_features: int, features: int, num_layers: int):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"conv{i}", Conv(in_features if i == 0 else features, features, 3))

    def forward(self, x):
        for i in range(self.num_layers):
            x = F.relu(getattr(self, f"conv{i}")(x))
        return x


class KernelNet(nn.Module):
    """U-Net over [dyn1, dyn2, cont1, cont2] with the time plane injected at
    decoder ``rc_loc - 1``; four kernel heads; two sepconv applications."""

    def __init__(self, g: int, ks: int, num_block: int, layers: int = 3, kf: int = 32, rc_loc: int = 4):
        super().__init__()
        self.ks, self.num_block, self.rc_loc = ks, num_block, rc_loc
        c = 16 * g
        for i in range(3, num_block):
            self.add_module(f"enc{i}", ConvBlock(c, kf * 2**i, layers))
            c = kf * 2**i
        for i in range(num_block - 1):
            c_out = kf * 2 ** (num_block - 1 - i)
            self.add_module(f"dec{i}", ConvBlock(c, c_out, layers))
            self.add_module(f"up{i}", Conv(c_out + int(i == rc_loc - 1), c_out, 3))
            c = c_out
        for name in ("vertical1", "vertical2", "horizontal1", "horizontal2"):
            self.add_module(name, KernelHead(c, kf, ks, layers))

    def forward(self, frame1, frame2, dyn1, dyn2, cont1, cont2, m2, m3, ratio, sepconv_fn):
        nb = self.num_block
        x = torch.cat([dyn1, dyn2, cont1, cont2], dim=1)
        enc = []
        for i in range(3, nb):
            x = getattr(self, f"enc{i}")(x)
            enc.append(x)
            x = F.avg_pool2d(x, 2)
        for i in range(nb - 1):
            x = getattr(self, f"dec{i}")(x)
            if i == self.rc_loc - 1:
                B, _, h, w = x.shape
                x = torch.cat([x, ratio.to(x.dtype)[:, None, None, None].expand(B, 1, h, w)], dim=1)
            x = F.relu(getattr(self, f"up{i}")(upsample2x_bilinear(x)))
            x = x + (enc[nb - 4 - i] if i < nb - 3 else m3 if i == nb - 3 else m2)
        v1, v2, h1, h2 = (getattr(self, n)(x).permute(0, 2, 3, 1)
                          for n in ("vertical1", "vertical2", "horizontal1", "horizontal2"))
        ks = self.ks
        dot1 = sepconv_fn(sepconv_ref.pad_for_sepconv(frame1.permute(0, 2, 3, 1), ks), v1, h1)
        dot2 = sepconv_fn(sepconv_ref.pad_for_sepconv(frame2.permute(0, 2, 3, 1), ks), v2, h2)
        return dot1, dot2


def _fold(x):
    return x.reshape(x.shape[0] * x.shape[1], *x.shape[2:])


class TAI(nn.Module):
    """bi-TAI: ``forward(T, preceding, following)`` -> ``{"pred", "pred_forward", "pred_backward"}``."""

    def __init__(self, gf_dim: int, c_dim: int, ks: int, num_block: int, kf_dim: int = 32, layers: int = 3,
                 feature_size: int = 3):
        super().__init__()
        if feature_size != 3:
            raise ValueError("the reference's ConvLSTM kernel is 3")
        self.c_dim = c_dim
        self.mcnet = MCNet(gf_dim, c_dim)
        self.merge_residual2 = Residual(gf_dim * 4, kf_dim * 2)
        self.merge_residual3 = Residual(gf_dim * 8, kf_dim * 4)
        self.kernelnet = KernelNet(gf_dim, ks, num_block, layers, kf_dim)
        self.sepconv_fn = sepconv_ref.sepconv

    def forward(self, T: int, preceding, following):
        B = preceding.shape[0]
        diff = lambda v: to_gray_frames(v)[:, 1:] - to_gray_frames(v)[:, :-1]  # noqa: E731
        fwd = self.mcnet(T, diff(preceding), preceding[:, -1])
        bwd = self.mcnet(T, diff(following.flip(1)), following[:, 0])
        bwd = [a.flip(0) for a in bwd]
        m2 = self.merge_residual2(_fold(fwd[4]), _fold(bwd[4]))
        m3 = self.merge_residual3(_fold(fwd[5]), _fold(bwd[5]))
        w = torch.linspace(0.0, 1.0, T + 2, dtype=preceding.dtype, device=preceding.device)[1:-1]
        ratio = torch.repeat_interleave(1.0 - w, B)
        dot1, dot2 = self.kernelnet(_fold(fwd[0]), _fold(bwd[0]), _fold(fwd[1]), _fold(bwd[1]),
                                    _fold(fwd[2]), _fold(bwd[2]), m2, m3, ratio, self.sepconv_fn)
        comb = 0.5 * dot1.reshape(T, B, *dot1.shape[1:]) + 0.5 * dot2.reshape(T, B, *dot2.shape[1:])
        return {"pred": comb.transpose(0, 1),
                "pred_forward": fwd[0].permute(1, 0, 3, 4, 2),
                "pred_backward": bwd[0].permute(1, 0, 3, 4, 2)}

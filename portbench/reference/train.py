"""The training step, plain PyTorch: the benchmark's reference of bi-TAI's GAN step.

One step is a generator update then a discriminator update, as the upstream
code and the port take it: the G loss is
``alpha * (L2 + GDL of the blend and of both streams) + beta * BCE(D(fake), 1)``
with the discriminator not updating its power-iteration vectors; the D
update scores the generator's prediction from before its update (detached)
against sliding-window labels, then the real video, each call advancing the
spectral norm's ``u``.  Both networks step with Adam (bias-corrected, as
``torch.optim.Adam`` defines it), written out here.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import _Fp8, set_precision


def _l2normalize(v, eps=1e-12):
    return v / (torch.sqrt(torch.sum(v**2)) + eps)


class SpectralNorm(nn.Module):
    def __init__(self, out_features: int, n_power_iterations: int):
        super().__init__()
        self.n = n_power_iterations
        self.register_buffer("u", torch.empty(out_features))

    def forward(self, w, train: bool):
        with torch.no_grad():
            w_mat = w.reshape(w.shape[0], -1).float()
            u = self.u.float()
            for _ in range(self.n):
                v = _l2normalize(u @ w_mat)
                u = _l2normalize(w_mat @ v)
            sigma = u @ w_mat @ v
            if train:
                self.u.copy_(u)
        return w / sigma.to(w.dtype)


class SNConv(nn.Module):
    def __init__(self, cin: int, cout: int, Ip: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, 4, 4))
        self.bias = nn.Parameter(torch.empty(cout))
        self.sn = SpectralNorm(cout, Ip)
        self.fp8 = False

    def forward(self, x, train):
        w = self.sn(self.weight, train)
        if self.fp8:
            x, w = _Fp8.apply(x), _Fp8.apply(w)
        return F.conv2d(x, w, self.bias, stride=2, padding=1)


class SNDense(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin))
        self.bias = nn.Parameter(torch.empty(cout))
        self.sn = SpectralNorm(cout, 1)

    def forward(self, x, train):
        return F.linear(x, self.sn(self.weight, train), self.bias)


class Discriminator(nn.Module):
    """Scores every ``window``-frame window of ``[B, N, H, W, C]``: logits ``[B, N-window+1]``."""

    def __init__(self, window: int, c_dim: int, image_size, df_dim: int, Ip: int):
        super().__init__()
        self.window = window
        h, w = image_size
        c = window * c_dim
        for i, mult in enumerate((1, 2, 4, 8)):
            self.add_module(f"conv{i}", SNConv(c, df_dim * mult, Ip))
            c = df_dim * mult
            h, w = (h - 2) // 2 + 1, (w - 2) // 2 + 1
        self.head = SNDense(c * h * w, 1)

    def forward(self, video, train):
        B, N, H, W, C = video.shape
        nw = N - self.window + 1
        windows = torch.stack([video[:, s : s + self.window] for s in range(nw)], dim=1)
        x = windows.permute(0, 1, 2, 5, 3, 4).reshape(B * nw, self.window * C, H, W)
        for i in range(4):
            x = F.leaky_relu(getattr(self, f"conv{i}")(x, train), 0.2)
        return self.head(x.permute(0, 2, 3, 1).reshape(B * nw, -1), train).reshape(B, nw)


@dataclass(frozen=True)
class Hyper:
    lr: float
    beta1: float
    alpha: float
    beta: float
    beta2: float = 0.999
    eps: float = 1e-8


def gdl(pred, target):
    pw, ph = pred[..., :, :-1, :] - pred[..., :, 1:, :], pred[..., 1:, :, :] - pred[..., :-1, :, :]
    tw, th = target[..., :, :-1, :] - target[..., :, 1:, :], target[..., 1:, :, :] - target[..., :-1, :, :]
    return ((pw - tw).abs()[..., 1:, :, :] + (ph - th).abs()[..., :, 1:, :]).mean()


def l2(pred, target):
    return ((pred - target) ** 2).mean()


def bce(logits, labels):
    return F.binary_cross_entropy_with_logits(logits, labels)


def window_labels(K, T, F_, window, device):
    idx = torch.arange(K + T + F_ - window + 1, device=device)
    return ((idx + window <= K) | (idx >= K + T)).float()


class Adam:
    """Adam over a list of parameters; ``exp_avg`` after the first step is (1 - beta1) * grad."""

    def __init__(self, params, hp: Hyper):
        self.params, self.hp, self.t = list(params), hp, 0
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def step(self, grads):
        hp = self.hp
        self.t += 1
        c1, c2 = 1 - hp.beta1**self.t, 1 - hp.beta2**self.t
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            m.mul_(hp.beta1).add_(g, alpha=1 - hp.beta1)
            v.mul_(hp.beta2).addcmul_(g, g, value=1 - hp.beta2)
            p.addcdiv_(m, (v.sqrt() / c2**0.5).add_(hp.eps), value=-hp.lr / c1)


def _grads(loss, params):
    return [torch.zeros_like(p) if g is None else g
            for p, g in zip(params, torch.autograd.grad(loss, params, allow_unused=True))]


def g_update(G, D, opt_g, K, T, F_, targets, hp: Hyper):
    """One generator update; returns (prediction detached, terms, gradients)."""
    p, m, f = targets[:, :K], targets[:, K : K + T], targets[:, K + T : K + T + F_]
    out = G(T, p, f)
    to01 = lambda a: (a + 1.0) / 2.0  # noqa: E731
    gt = to01(m)
    terms = {"G_Lp": l2(to01(out["pred"]), gt), "G_gdl": gdl(to01(out["pred"]), gt)}
    extra = {"G_Lp_forward": l2(to01(out["pred_forward"]), gt), "G_Lp_backward": l2(to01(out["pred_backward"]), gt),
             "G_gdl_forward": gdl(to01(out["pred_forward"]), gt),
             "G_gdl_backward": gdl(to01(out["pred_backward"]), gt)}
    logits = D(torch.cat([p, out["pred"], f], dim=1), train=False)
    terms["G_GAN"] = bce(logits, torch.ones_like(logits))
    loss = hp.alpha * (terms["G_Lp"] + terms["G_gdl"] + sum(extra.values())) + hp.beta * terms["G_GAN"]
    terms.update(extra)
    terms["G_loss"] = loss
    grads = _grads(loss, opt_g.params)
    opt_g.step(grads)
    return out["pred"].detach(), {k: v.detach() for k, v in terms.items()}, grads


def d_update(D, opt_d, pred, K, T, F_, targets, window: int):
    """One discriminator update on ``pred``; returns (terms, gradients)."""
    p, m, f = targets[:, :K], targets[:, K : K + T], targets[:, K + T : K + T + F_]
    logits_fake = D(torch.cat([p, pred, f], dim=1), train=True)
    labels = window_labels(K, T, F_, window, logits_fake.device)
    loss_fake = bce(logits_fake, labels.expand_as(logits_fake))
    logits_real = D(torch.cat([p, m, f], dim=1), train=True)
    loss_real = bce(logits_real, torch.ones_like(logits_real))
    grads = _grads(loss_fake + loss_real, opt_d.params)
    opt_d.step(grads)
    return {"D_fake": loss_fake.detach(), "D_real": loss_real.detach()}, grads


def train_step(G, D, opt_g, opt_d, K, T, F_, targets, hp: Hyper, window: int):
    """G update then D update; returns (terms, G gradients, D gradients)."""
    pred, terms, g_grads = g_update(G, D, opt_g, K, T, F_, targets, hp)
    d_terms, d_grads = d_update(D, opt_d, pred, K, T, F_, targets, window)
    terms.update(d_terms)
    return terms, g_grads, d_grads


def set_fp8(G: nn.Module, D: nn.Module) -> None:
    """fp8 operands in every conv of both networks (the training control)."""
    set_precision(G, "fp8")
    for m in D.modules():
        if isinstance(m, SNConv):
            m.fp8 = True

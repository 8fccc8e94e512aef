"""The work of one request or one training step, counted on the plain
reference at the cell's shapes on the meta device: the FLOPs of the
reference's operations by ``torch.utils.flop_counter``'s formulas (the
table ``FlopCounterMode`` reads; its module tracker refuses
``torch.autograd.grad``, which the training step calls), the separable convolution's
2*ks*(ks+1) per output value forward (4*ks*(ks+1) and ks*(2*ks+1) for its
two adjoints) from the shapes of its calls, and the shapes of the convs
that int8 serving quantizes.  Nothing of the port is called."""

from __future__ import annotations

from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from ..reference import train as ref_train
from ..reference.layers import Conv, convs
from ..reference.tai import TAI


@dataclass
class Work:
    flops: float = 0.0  # the reference's counted operations, sepconv left out
    conv_flops: float = 0.0  # 2 * MAC of the shared convs (the int8 convs when quantized)
    sepconv: list = field(default_factory=list)  # (B, H, W, C, ks) of each call
    sepconv_flops: float = 0.0  # forward, and both adjoints where trained
    conv_calls: list = field(default_factory=list)  # (images, cin, cout, k, h, w)


class _FlopCount(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.flops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        count = flop_registry.get(func._overloadpacket)
        if count is not None:
            self.flops += count(*args, **kwargs, out_val=out)
        return out


class _Stub(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, v, h):
        ctx.shapes = (x, v, h)
        return x.new_empty(v.shape[:3] + x.shape[-1:])

    @staticmethod
    def backward(ctx, g):
        return tuple(torch.empty_like(t) for t in ctx.shapes)


def _counted(model: TAI, work: Work, trained: bool):
    def stub(x, v, h):
        B, H, W, ks = v.shape
        C = x.shape[-1]
        work.sepconv.append((B, H, W, C, ks))
        per = 2 * ks * (ks + 1) + (4 * ks * (ks + 1) + ks * (2 * ks + 1) if trained else 0)
        work.sepconv_flops += per * B * H * W * C
        return _Stub.apply(x, v, h)

    def hook(m: Conv, args):
        x = args[0]
        cout, cin, k, _ = m.weight.shape
        work.conv_calls.append((x.shape[0], cin, cout, k, x.shape[2], x.shape[3]))
        work.conv_flops += 2 * x.shape[0] * x.shape[2] * x.shape[3] * cout * cin * k * k

    model.sepconv_fn = stub
    return [m.register_forward_pre_hook(hook) for m in convs(model)]


def generator(cfg: dict) -> TAI:
    kw = cfg["model_kwargs"]
    return TAI(kw["gf_dim"], kw["c_dim"], kw["ks"], kw["num_block"], feature_size=kw["feature_size"])


def discriminator(cfg: dict) -> ref_train.Discriminator:
    t = cfg["train"]
    return ref_train.Discriminator(t["disc_window_size"], cfg["model_kwargs"]["c_dim"], cfg["image_size"],
                                   t["df_dim"], t["Ip"])


def serve(cfg: dict, B: int, K: int, T: int, F: int) -> Work:
    """One forward of ``B`` clips."""
    H, W = cfg["image_size"]
    C = cfg["model_kwargs"]["c_dim"]
    work = Work()
    with torch.device("meta"):
        model = generator(cfg)
        p, f = torch.empty(B, K, H, W, C), torch.empty(B, F, H, W, C)
    hooks = _counted(model, work, trained=False)
    with _FlopCount() as counter, torch.no_grad():
        model(T, p, f)
    for h in hooks:
        h.remove()
    work.flops = float(counter.flops)
    return work


def train(cfg: dict, B: int, K: int, T: int, F: int) -> Work:
    """One training step (G forward and backward, Adam; D forward and backward, Adam) of ``B`` videos."""
    H, W = cfg["image_size"]
    C = cfg["model_kwargs"]["c_dim"]
    t = cfg["train"]
    hp = ref_train.Hyper(t["lr"], t["beta1"], t["alpha"], t["beta"])
    work = Work()
    with torch.device("meta"):
        G, D = generator(cfg), discriminator(cfg)
        targets = torch.empty(B, K + T + F, H, W, C)
        opt_g, opt_d = ref_train.Adam(G.parameters(), hp), ref_train.Adam(D.parameters(), hp)
    hooks = _counted(G, work, trained=True)
    with _FlopCount() as counter:
        ref_train.train_step(G, D, opt_g, opt_d, K, T, F, targets, hp, t["disc_window_size"])
    for h in hooks:
        h.remove()
    work.flops = float(counter.flops)
    return work

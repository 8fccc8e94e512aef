"""The operation counts of the plain reference, at a tiny size."""

import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.counts import flops

CFG = {"model_kwargs": {"gf_dim": 8, "c_dim": 1, "feature_size": 3, "ks": 5, "num_block": 5}, "image_size": [32, 32],
       "train": {"lr": 1e-4, "beta1": 0.5, "alpha": 1.0, "beta": 0.02, "df_dim": 8, "Ip": 3, "disc_window_size": 3}}


def test_serve_count_is_flop_counter_modes():
    w = flops.serve(CFG, 2, 3, 2, 3)
    with torch.device("meta"):
        model = flops.generator(CFG)
        p = torch.empty(2, 3, 32, 32, 1)
    model.sepconv_fn = lambda x, v, h: x.new_empty(v.shape[:3] + x.shape[-1:])
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        model(2, p, p)
    assert w.flops == counter.get_total_flops() > 0
    ks, calls = 5, 2  # two sepconv calls over B*T images of 32x32, one channel
    assert w.sepconv == [(4, 32, 32, 1, ks)] * calls
    assert w.sepconv_flops == calls * 2 * ks * (ks + 1) * 4 * 32 * 32


def test_conv_count_by_hand():
    """The first conv of MC-Net's motion encoder: 5x5, 1 -> 8 channels, over B*(K-1) difference frames."""
    w = flops.serve(CFG, 2, 3, 2, 3)
    assert w.conv_calls[0] == (2, 1, 8, 5, 32, 32)
    assert w.conv_flops == sum(2 * n * h * wd * co * ci * k * k for n, ci, co, k, h, wd in w.conv_calls)
    assert w.conv_flops <= w.flops


def test_train_counts_forward_and_backward():
    fwd = flops.serve(CFG, 2, 3, 2, 3)
    step = flops.train(CFG, 2, 3, 2, 3)
    assert 2.5 < step.flops / fwd.flops < 4.5  # forward, backward at about twice, and the discriminator
    ks = 5
    assert step.sepconv_flops == 2 * (2 * ks * (ks + 1) + 4 * ks * (ks + 1) + ks * (2 * ks + 1)) * 4 * 32 * 32

"""Conv-transformer blocks of the SCT family (counterpart of ``vfi_tpu/nn/transformer.py``).

Queries and keys are spatially pooled vectors of the value maps; values are
whole conv maps, so attention mixes frames.  Sequences are ``[B, T, C, H, W]``
(NCHW per frame).  As in vfi_tpu:

  * LayerNorm over the channel axis (eps 1e-6, flax's default; torch's is
    1e-5), in place of the reference's BatchNorm3d;
  * all heads in one contraction;
  * the feed-forward convs are ``d_v`` wide whatever ``d_ff`` says;
  * a masked logit is ``-1e10``, not ``-inf``, so a fully masked row
    softmaxes to uniform rather than NaN.

Submodules carry vfi_tpu's flax names (``q``, ``k``, ``v``, ``proj``,
``mha``, ``self_mha``, ``cross_mha``, ``ff1``, ``ff2``, ``norm1``-``norm3``,
``block{n}``).  Time steps and positional encodings are computed in float32
and added in the activations' dtype.
"""

from __future__ import annotations

import math
from typing import List, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import Conv

NEG_INF = 1e10
LN_EPS = 1e-6


def lecun_normal_(w: torch.Tensor) -> torch.Tensor:
    """flax's default kernel init: a normal of variance 1/fan_in truncated at two std."""
    std = math.sqrt(1.0 / w[0].numel()) / 0.87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std)


class Dense(nn.Linear):
    """flax ``nn.Dense``: lecun-normal weights, zero bias."""

    def reset_parameters(self) -> None:
        lecun_normal_(self.weight)
        nn.init.zeros_(self.bias)


class Conv1x1(nn.Conv2d):
    """flax ``nn.Conv`` with a 1x1 kernel and flax's default init."""

    def __init__(self, in_features: int, features: int):
        super().__init__(in_features, features, 1)

    def reset_parameters(self) -> None:
        lecun_normal_(self.weight)
        nn.init.zeros_(self.bias)


def channel_norm(norm: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """A norm over the trailing axis applied to the channel axis of ``[B, T, C, H, W]``."""
    return norm(x.movedim(2, -1)).movedim(-1, 2)


def positional_encoding(t: torch.Tensor, d_v: int) -> torch.Tensor:
    """Sinusoidal encoding of (possibly fractional) time steps ``[B, T]`` ->
    ``[B, T, d_v]`` in float32: sin and cos interleaved, denominators
    10000^(2i/d_v)."""
    i = torch.arange(d_v // 2, dtype=torch.float32, device=t.device)
    wave = t.float()[..., None] / torch.pow(10000.0, 2.0 * i / d_v)
    return torch.stack([torch.sin(wave), torch.cos(wave)], dim=-1).reshape(*t.shape, d_v)


def add_spatial_pe(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Each frame of ``x`` ``[B, T, C, H, W]`` plus its time step's encoding, over H and W."""
    return x + positional_encoding(t, x.shape[2]).to(x.dtype)[..., None, None]


class ConvMultiHeadAttention(nn.Module):
    """Multi-head attention over conv-map values with vector queries and keys."""

    def __init__(self, num_heads: int, d_qk: int, d_v: int):
        super().__init__()
        self.num_heads, self.d_qk, self.d_v = num_heads, d_qk, d_v
        self.q = Dense(d_qk, num_heads * d_qk)
        self.k = Dense(d_qk, num_heads * d_qk)
        self.v = Conv(d_v, num_heads * d_v, 3)
        self.proj = Conv1x1(num_heads * d_v, d_v)

    def forward(self, v, k, q, prod_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """
        :param v: value maps ``[B, T_i, d_v, H, W]``
        :param k: key vectors ``[B, T_i, d_qk]``
        :param q: query vectors ``[B, T_o, d_qk]``
        :param prod_mask: ``[B, T_o, T_i]``; 0 forbids attention
        :return: ``[B, T_o, d_v, H, W]``
        """
        B, T_i, _, H, W = v.shape
        nh, dq, dv = self.num_heads, self.d_qk, self.d_v
        proj_q = self.q(q).reshape(B, -1, nh, dq)
        proj_k = self.k(k).reshape(B, T_i, nh, dq)
        proj_v = self.v(v.flatten(0, 1)).reshape(B, T_i, nh, dv, H, W)

        logits = torch.einsum("bond,bind->bnoi", proj_q, proj_k) / math.sqrt(dq)
        if prod_mask is not None:
            logits = logits.masked_fill(prod_mask[:, None] == 0, -NEG_INF)
        weights = torch.softmax(logits, dim=-1)  # [B, nh, T_o, T_i]
        attended = torch.einsum("bnoi,bindxy->bondxy", weights, proj_v)
        T_o = attended.shape[1]
        out = self.proj(attended.reshape(B * T_o, nh * dv, H, W))
        return out.reshape(B, T_o, dv, H, W)


def _feed_forward(ff1: nn.Module, ff2: nn.Module, x: torch.Tensor) -> torch.Tensor:
    return ff2(F.relu(ff1(x.flatten(0, 1)))).reshape(x.shape)


class EncoderBlock(nn.Module):
    """Self-attention and a conv feed-forward, each with a residual and a norm."""

    def __init__(self, num_heads: int, d_v: int):
        super().__init__()
        self.mha = ConvMultiHeadAttention(num_heads, d_v, d_v)
        self.norm1 = nn.LayerNorm(d_v, eps=LN_EPS)
        self.ff1 = Conv(d_v, d_v, 3)
        self.ff2 = Conv(d_v, d_v, 3)
        self.norm2 = nn.LayerNorm(d_v, eps=LN_EPS)

    def forward(self, v: torch.Tensor, seq_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        B, T_i = v.shape[:2]
        if seq_mask is None:
            seq_mask = v.new_ones((B, T_i))
        masked_v = v * seq_mask[:, :, None, None, None]
        q = masked_v.mean(dim=(3, 4))  # [B, T_i, d_v]
        prod_mask = seq_mask[:, None, :].expand(B, T_i, T_i)
        x = channel_norm(self.norm1, masked_v + self.mha(v, q, q, prod_mask))
        return channel_norm(self.norm2, x + _feed_forward(self.ff1, self.ff2, x))


class DecoderBlock(nn.Module):
    """Masked self-attention, cross-attention to the encoder, feed-forward."""

    def __init__(self, num_heads: int, d_v: int):
        super().__init__()
        self.self_mha = ConvMultiHeadAttention(num_heads, d_v, d_v)
        self.norm1 = nn.LayerNorm(d_v, eps=LN_EPS)
        self.cross_mha = ConvMultiHeadAttention(num_heads, d_v, d_v)
        self.norm2 = nn.LayerNorm(d_v, eps=LN_EPS)
        self.ff1 = Conv(d_v, d_v, 3)
        self.ff2 = Conv(d_v, d_v, 3)
        self.norm3 = nn.LayerNorm(d_v, eps=LN_EPS)

    def forward(self, q_dec, kv_dec, kv_enc, enc_seq_mask=None, prod_mask=None) -> torch.Tensor:
        B, T_o = q_dec.shape[:2]
        T_i = kv_enc.shape[1]
        if enc_seq_mask is None:
            enc_seq_mask = q_dec.new_ones((B, T_i))
        enc_prod_mask = enc_seq_mask[:, None, :].expand(B, T_o, T_i)

        self_out = self.self_mha(kv_dec, kv_dec.mean(dim=(3, 4)), q_dec.mean(dim=(3, 4)), prod_mask)
        x = channel_norm(self.norm1, self_out + q_dec)
        cross = self.cross_mha(kv_enc, kv_enc.mean(dim=(3, 4)), x.mean(dim=(3, 4)), enc_prod_mask)
        x = channel_norm(self.norm2, cross + x)
        return channel_norm(self.norm3, x + _feed_forward(self.ff1, self.ff2, x))


class ConvTransformerEncoder(nn.Module):
    """A stack of encoder blocks over PE-added inputs; the top rep, or every
    block's rep when ``return_all`` (the skip-connected variants)."""

    def __init__(self, num_blocks: int, num_heads: int, d_v: int, return_all: bool = False):
        super().__init__()
        self.num_blocks, self.return_all = num_blocks, return_all
        for n in range(num_blocks):
            self.add_module(f"block{n}", EncoderBlock(num_heads, d_v))

    def forward(self, x, input_mask, time_steps):
        x = add_spatial_pe(x, time_steps)
        reps = []
        for n in range(self.num_blocks):
            x = getattr(self, f"block{n}")(x, input_mask)
            reps.append(x)
        return reps if self.return_all else reps[-1]


class ConvTransformerDecoder(nn.Module):
    """Autoregressive decoder whose per-level key/value caches grow by one
    frame per step.

    ``enc_attend``: which encoder rep each level cross-attends to — ``"top"``
    (``enc_output`` is one rep), ``"skip"`` (level i attends encoder level
    n-1-i) or ``"same"`` (level i attends encoder level i).
    """

    def __init__(self, num_blocks: int, num_heads: int, d_v: int, enc_attend: str = "top"):
        super().__init__()
        if enc_attend not in ("top", "skip", "same"):
            raise ValueError(f"unknown enc_attend {enc_attend!r}")
        self.num_blocks, self.enc_attend = num_blocks, enc_attend
        for n in range(num_blocks):
            self.add_module(f"block{n}", DecoderBlock(num_heads, d_v))

    def _enc_for(self, enc_output, n_block: int):
        if self.enc_attend == "top":
            return enc_output
        if self.enc_attend == "skip":
            return enc_output[-n_block - 1]
        return enc_output[n_block]

    def forward(self, enc_output, enc_seq_mask, init_dec_input, time_steps_full, prod_mask_full) -> torch.Tensor:
        """Decode ``time_steps_full.shape[1]`` frames: the given decoder inputs
        (``init_dec_input``, ``[B, T_o_old, C, H, W]``) in one pass, then one
        step per remaining frame, each feeding the top level's newest rep back
        in as the next level-0 input."""
        T_o_old = init_dec_input.shape[1]
        T_o = time_steps_full.shape[1]
        blocks = [getattr(self, f"block{n}") for n in range(self.num_blocks)]

        reps: List[torch.Tensor] = [add_spatial_pe(init_dec_input, time_steps_full[:, :T_o_old])]
        init_mask = prod_mask_full[:, :T_o_old, :T_o_old]
        for n, blk in enumerate(blocks):
            reps.append(blk(reps[n], reps[n], self._enc_for(enc_output, n), enc_seq_mask, init_mask))

        for t in range(T_o_old, T_o):
            x = add_spatial_pe(reps[-1][:, -1:], time_steps_full[:, t : t + 1])
            step_mask = prod_mask_full[:, t : t + 1, : t + 1]
            reps[0] = torch.cat([reps[0], x], dim=1)
            for n, blk in enumerate(blocks):
                x = blk(x, reps[n], self._enc_for(enc_output, n), enc_seq_mask, step_mask)
                reps[n + 1] = torch.cat([reps[n + 1], x], dim=1)
        return reps[-1]

"""SCT, the sequential conv-transformer fill-in family (counterpart of
``vfi_tpu/models/sct.py``): 8 registered variants.

Shared machinery: a 4-stage conv frame encoder and decoder applied per
frame, a conv-transformer encoder over the context frames (time steps scaled
into [0, 1) for the preceding and [2, 3) for the following frames), and an
autoregressive conv-transformer decoder over the middle time steps, scaled
into [1, 2).  Videos in and ``pred`` out are channels-last
``[B, T, H, W, C]``; inside, sequences are ``[B, T, C, H, W]``.

Variants:
  * Forward — earliest-to-latest generation under a causal mask, and the
    teacher-forced pass (``forward_train``, or ``gt_middle=`` to forward)
  * Inward — ends-inward order (first, last, second, ...), re-sorted
  * Random — a random order, re-sorted
  * RandomB — a random order; each generated frame is re-encoded and
    appended to the transformer encoder's input for the later steps
  * RandomC — RandomB with encoder/decoder skip connections
  * RandomD — RandomC with same-level attention
  * Bypass — Forward whose frame-decoder skips pass through extra convs
  * FrameEncDecBN — Forward with a GroupNorm-ed frame codec (eps 1e-6,
    ``min(8, C)`` groups, flax's defaults)

The random-order variants take an explicit CPU ``torch.Generator``
(``generator=``); without one they draw from a generator seeded 0 at each
call, so serving is deterministic per call, as vfi_tpu's fixed
``PRNGKey(0)`` makes it; the permutations are not vfi_tpu's.  All draws go
through :func:`_draw_uniforms`.

The 8 variants take vfi_tpu's dynamic ``lengths`` (K, T, F) on pad-to-max
buffers (``ops/dynamic.py``; ``T`` is then max_T): the padded context is
masked out of the encoder with its times zeroed, the generation times use
the sampled T, and steps at or after it (padding) generate after every
valid step and sort last; a random order is a uniform order of the valid
steps, uniforms over them ranked by a double argsort.  The outputs at
t < T equal the static forward's at those lengths (Random and RandomB given
the same order).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..nn.layers import Conv
from ..nn.transformer import ConvTransformerDecoder, ConvTransformerEncoder
from ..ops.dynamic import as_lengths

GN_EPS = 1e-6


def _draw_uniforms(B: int, T: int, generator: Optional[torch.Generator]) -> torch.Tensor:
    """Uniforms ``[B, T]`` (float32, CPU) from ``generator``, or from one seeded 0."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    return torch.rand(B, T, generator=generator)


def _draw_orders(B: int, T: int, generator: Optional[torch.Generator]) -> torch.Tensor:
    """``B`` uniform permutations of ``range(T)`` ``[B, T]`` (int64, CPU): row
    b's step s generates the frame at time ``perm[b, s]``."""
    return _draw_uniforms(B, T, generator).argsort(dim=1)


def _ranked_times(u: torch.Tensor, T_len: torch.Tensor):
    """A uniform order of the ``T_len`` valid steps of ``T`` from uniforms
    ``u`` ``[B, T]``: each valid step's rank among the valid steps' uniforms
    (a double argsort; the padded steps rank last).  Returns (the steps'
    generation times ``[B, T]``, 1 + rank / T_len, and 1e6 + s at a padded
    step s, which sorts after every valid one; the times before that
    replacement; the steps' validity ``[T]``)."""
    s = torch.arange(u.shape[1], device=u.device)
    valid = s < T_len
    ranks = torch.where(valid, u, torch.inf).argsort(dim=1).argsort(dim=1)
    base = ranks.float() / T_len.float() + 1.0
    return torch.where(valid, base, 1e6 + s.float()), base, valid


def _seq(frames: torch.Tensor) -> torch.Tensor:
    """Channels-last video ``[B, N, H, W, C]`` -> sequence ``[B, N, C, H, W]``."""
    return frames.permute(0, 1, 4, 2, 3)


def _video(seq: torch.Tensor) -> torch.Tensor:
    return seq.permute(0, 1, 3, 4, 2)


def _nearest_up2(x: torch.Tensor) -> torch.Tensor:
    return F.interpolate(x, scale_factor=2, mode="nearest")


class _Codec(nn.Module):
    """Convs named ``{name}``, each followed by a GroupNorm ``{norm}`` when ``use_norm``."""

    def __init__(self, use_norm: bool):
        super().__init__()
        self.use_norm = use_norm

    def _add(self, conv: str, norm: Optional[str], cin: int, cout: int) -> None:
        self.add_module(conv, Conv(cin, cout, 3))
        if self.use_norm and norm is not None:
            self.add_module(norm, nn.GroupNorm(min(8, cout), cout, eps=GN_EPS))

    def _run(self, conv: str, norm: str, x: torch.Tensor) -> torch.Tensor:
        x = getattr(self, conv)(x)
        return getattr(self, norm)(x) if self.use_norm else x


class FrameEncoder(_Codec):
    """4-stage per-frame conv pyramid; the reps at H, H/2, H/4 and H/8 are
    ``d_v/8``, ``d_v/4``, ``d_v/2`` and ``d_v`` wide."""

    def __init__(self, c_dim: int, d_v: int, use_norm: bool = False):
        super().__init__(use_norm)
        self._add("e0a", "n0a", c_dim, d_v // 8)
        self._add("e0b", "n0b", d_v // 8, d_v // 8)
        cin = d_v // 8
        for s, width in enumerate((d_v // 4, d_v // 2, d_v)):
            self._add(f"e{s + 1}a", f"n{s + 1}a", cin, width)
            self._add(f"e{s + 1}b", f"n{s + 1}b", width, width)
            cin = width

    def forward(self, frames: torch.Tensor) -> List[torch.Tensor]:
        """``[B, N, C, H, W]`` -> the 4 reps ``[B, N, d, H/2^s, W/2^s]``."""
        B, N = frames.shape[:2]
        x = self._run("e0a", "n0a", frames.flatten(0, 1))
        x = self._run("e0b", "n0b", F.relu(x))
        reps = [x]
        for s in range(1, 4):
            x = F.max_pool2d(x, 2)
            x = self._run(f"e{s}a", f"n{s}a", F.relu(x))
            x = self._run(f"e{s}b", f"n{s}b", F.relu(x))
            reps.append(x)
        return [r.reshape(B, N, *r.shape[1:]) for r in reps]


class FrameDecoder(_Codec):
    """4-stage conv decoder with nearest-neighbour 2x upsampling; the caller
    adds the frame encoder's rep of each stage to its input."""

    def __init__(self, d_v: int, c_dim: int, use_norm: bool = False):
        super().__init__(use_norm)
        self._add("d0a", "n0a", d_v, d_v)
        self._add("d0b", "n0b", d_v, d_v // 2)
        for stage in (1, 2):
            width = d_v // 2**stage
            self._add(f"d{stage}a", f"n{stage}a", width, width)
            self._add(f"d{stage}b", f"n{stage}b", width, width // 2)
        self._add("d3a", "n3a", d_v // 8, d_v // 8)
        self._add("d3b", None, d_v // 8, c_dim)

    def forward(self, x: torch.Tensor, stage: int) -> torch.Tensor:
        """One stage on flat frames ``[N, C, H, W]``."""
        if stage < 3:
            x = self._run(f"d{stage}a", f"n{stage}a", x if stage == 0 else F.relu(x))
            x = self._run(f"d{stage}b", f"n{stage}b", F.relu(x))
            return _nearest_up2(x)
        x = self._run("d3a", "n3a", F.relu(x))
        return torch.tanh(self.d3b(F.relu(x)))


class BaseSCTFillInModel(nn.Module):
    """The shared frame codec and transformer encoder/decoder wiring.

    ``d_ff`` is accepted as vfi_tpu accepts it; the blocks are ``d_v`` wide.
    ``frame_norm``, ``enc_return_all`` and ``dec_enc_attend`` default to the
    variant's own."""

    frame_norm = False
    enc_return_all = False
    dec_enc_attend = "top"
    random_order = False  # True where forward draws generation orders

    def __init__(self, c_dim: int, num_blocks: int = 2, num_heads: int = 3, d_v: int = 256, d_ff: int = 2048,
                 frame_norm: Optional[bool] = None, enc_return_all: Optional[bool] = None,
                 dec_enc_attend: Optional[str] = None):
        super().__init__()
        self.c_dim, self.num_blocks, self.num_heads, self.d_v, self.d_ff = c_dim, num_blocks, num_heads, d_v, d_ff
        for name, value in (("frame_norm", frame_norm), ("enc_return_all", enc_return_all),
                            ("dec_enc_attend", dec_enc_attend)):
            if value is not None:
                setattr(self, name, value)
        self.frame_encoder = FrameEncoder(c_dim, d_v, self.frame_norm)
        self.frame_decoder = FrameDecoder(d_v, c_dim, self.frame_norm)
        self.encoder = ConvTransformerEncoder(num_blocks, num_heads, d_v, return_all=self.enc_return_all)
        self.decoder = ConvTransformerDecoder(num_blocks, num_heads, d_v, enc_attend=self.dec_enc_attend)

    # -- frame codec ---------------------------------------------------------
    def encode_frames(self, frames: torch.Tensor) -> List[torch.Tensor]:
        return self.frame_encoder(frames)

    def _skip(self, skip: torch.Tensor, stage: int) -> torch.Tensor:
        """The frame-encoder rep added to the decoder's input at ``stage``."""
        return skip

    def decode_frames(self, dec_out: torch.Tensor, frame_reps: List[torch.Tensor]) -> torch.Tensor:
        """Transformer outputs ``[B, T, d_v, h, w]`` -> frames ``[B, T, C, H, W]``,
        adding each stage's rep of the frame pyramid (a one-frame pyramid,
        the seed's, broadcast over T)."""
        B, T = dec_out.shape[:2]
        x = dec_out
        for stage in range(4):
            skip = self._skip(frame_reps[-stage - 1], stage)
            out = self.frame_decoder((x + skip).flatten(0, 1), stage)
            x = out.reshape(B, T, *out.shape[1:])
        return x

    # -- context encoding ------------------------------------------------------
    @staticmethod
    def _lengths(lengths, T: int, preceding: torch.Tensor, following: torch.Tensor):
        """``lengths`` as device tensors (None stays None), checked against the
        buffers' sizes where on the host."""
        if lengths is None:
            return None
        return as_lengths(lengths, preceding.device, (preceding.shape[1], T, following.shape[1]))

    @staticmethod
    def _context_times(B: int, K: int, F: int, device, lengths=None):
        """Scaled time steps of the preceding and following buffers, ``[B, K]``
        and ``[B, F]``, and their validity, ``[K]`` and ``[F]`` (float32).
        With ``lengths``, the right-aligned preceding and left-aligned
        following frames are scaled by the sampled K and F, and the padding's
        times are 0."""
        iK = torch.arange(K, dtype=torch.float32, device=device)
        iF = torch.arange(F, dtype=torch.float32, device=device)
        if lengths is None:
            mask_pre, mask_fol = torch.ones_like(iK), torch.ones_like(iF)
            t_pre, t_fol = iK / K, iF / F + 2.0
        else:
            Kf, Ff = lengths[0].float(), lengths[2].float()
            mask_pre, mask_fol = (iK >= K - Kf).float(), (iF < Ff).float()
            t_pre, t_fol = (iK - (K - Kf)) / Kf * mask_pre, (iF / Ff + 2.0) * mask_fol
        return t_pre.expand(B, K), t_fol.expand(B, F), mask_pre, mask_fol

    def _context(self, preceding: torch.Tensor, following: torch.Tensor, lengths=None):
        """Encode the K+F context frames (sequences): (encoder output, its mask)."""
        B, K = preceding.shape[:2]
        F_ = following.shape[1]
        t_pre, t_fol, mask_pre, mask_fol = self._context_times(B, K, F_, preceding.device, lengths)
        enc_mask = torch.cat([mask_pre, mask_fol]).to(preceding.dtype).expand(B, K + F_)
        reps = self.encode_frames(torch.cat([preceding, following], dim=1))
        return self.encoder(reps[-1], enc_mask, torch.cat([t_pre, t_fol], dim=1)), enc_mask

    @staticmethod
    def _causal_mask(B: int, T: int, like: torch.Tensor) -> torch.Tensor:
        return torch.tril(like.new_ones((T, T))).expand(B, T, T)

    def _decode_with_times(self, T: int, preceding, enc_out, enc_mask, dec_times, dec_in=None):
        """The transformer decoder seeded by the last preceding frame (or, with
        ``dec_in``, fed those frames), then the frame decoder with the seed's
        (or ``dec_in``'s) pyramid."""
        B = preceding.shape[0]
        reps = self.encode_frames(preceding[:, -1:] if dec_in is None else dec_in)
        dec_out = self.decoder(enc_out, enc_mask, reps[-1], dec_times, self._causal_mask(B, T, preceding))
        return self.decode_frames(dec_out, reps)

    @staticmethod
    def _resort(pred_permuted: torch.Tensor, dec_times: torch.Tensor) -> torch.Tensor:
        """Generated frames back in time order, by the argsort of their times."""
        order = torch.argsort(dec_times, dim=1)
        return torch.take_along_dim(pred_permuted, order[:, :, None, None, None], dim=1)


class SCTSkipConScaledTForwardFillInModel(BaseSCTFillInModel):
    """Earliest-to-latest autoregressive generation; with ``gt_middle`` the
    teacher-forced pass, whose decoder inputs are the seed frame and the first
    T-1 true middle frames (with ``lengths``, a left-aligned max_T buffer).
    Under the causal mask a valid step never attends a padded one."""

    def _dec_times(self, T: int, B: int, device, lengths=None) -> torch.Tensor:
        T_len = T if lengths is None else lengths[1].float()
        return (torch.arange(T, dtype=torch.float32, device=device) / T_len + 1.0).expand(B, T)

    def forward(self, T: int, preceding, following, gt_middle=None, lengths=None) -> Dict[str, torch.Tensor]:
        p, f = _seq(preceding), _seq(following)
        B = p.shape[0]
        lengths = self._lengths(lengths, T, p, f)
        enc_out, enc_mask = self._context(p, f, lengths)
        dec_in = None
        if gt_middle is not None:
            dec_in = torch.cat([p[:, -1:], _seq(gt_middle)[:, : T - 1]], dim=1)
        dec_times = self._dec_times(T, B, p.device, lengths)
        pred = self._decode_with_times(T, p, enc_out, enc_mask, dec_times, dec_in)
        return {"pred": _video(pred)}

    def forward_train(self, T: int, preceding, following, gt_middle, lengths=None) -> Dict[str, torch.Tensor]:
        return self(T, preceding, following, gt_middle=gt_middle, lengths=lengths)


class SCTSkipConScaledTInwardFillInModel(BaseSCTFillInModel):
    """Ends-inward generation order: first, last, second, second-to-last, ..."""

    def forward(self, T: int, preceding, following, lengths=None) -> Dict[str, torch.Tensor]:
        """With ``lengths``, the order is the closed form at the sampled T
        (even s -> s/2, odd s -> T-(s+1)/2), and padded steps come last."""
        p, f = _seq(preceding), _seq(following)
        B = p.shape[0]
        lengths = self._lengths(lengths, T, p, f)
        enc_out, enc_mask = self._context(p, f, lengths)
        s = torch.arange(T, device=p.device)
        T_len = T if lengths is None else lengths[1]
        order = torch.where(s % 2 == 0, s // 2, T_len - (s + 1) // 2).float()
        dec_times = order / (T if lengths is None else T_len.float()) + 1.0
        if lengths is not None:
            dec_times = torch.where(s < T_len, dec_times, 1e6 + s.float())
        dec_times = dec_times.expand(B, T)
        pred = self._decode_with_times(T, p, enc_out, enc_mask, dec_times)
        return {"pred": _video(self._resort(pred, dec_times))}


class SCTSkipConScaledTRandomFillInModel(BaseSCTFillInModel):
    """A random generation order, re-sorted afterwards."""

    random_order = True

    def forward(self, T: int, preceding, following, generator=None, lengths=None) -> Dict[str, torch.Tensor]:
        p, f = _seq(preceding), _seq(following)
        B = p.shape[0]
        lengths = self._lengths(lengths, T, p, f)
        enc_out, enc_mask = self._context(p, f, lengths)
        if lengths is None:
            dec_times = _draw_orders(B, T, generator).to(p.device, non_blocking=True).float() / T + 1.0
        else:
            dec_times = _ranked_times(_draw_uniforms(B, T, generator).to(p.device, non_blocking=True), lengths[1])[0]
        pred = self._decode_with_times(T, p, enc_out, enc_mask, dec_times)
        return {"pred": _video(self._resort(pred, dec_times))}


class SCTSkipConScaledTRandomBFillInModel(BaseSCTFillInModel):
    """A random order; each generated frame is re-encoded and appended to the
    transformer encoder's input for the later steps."""

    random_order = True

    def _step_decode(self, enc_out, enc_mask, dec_reps, dec_time):
        prod_mask = enc_mask.new_ones((dec_time.shape[0], 1, 1))
        return self.decode_frames(self.decoder(enc_out, enc_mask, dec_reps[-1], dec_time, prod_mask), dec_reps)

    def forward(self, T: int, preceding, following, generator=None, lengths=None) -> Dict[str, torch.Tensor]:
        """With ``lengths``, a generated frame joins the encoder's input as
        valid only if its step was valid (a padded one with time 0)."""
        p, f = _seq(preceding), _seq(following)
        B, K = p.shape[:2]
        lengths = self._lengths(lengths, T, p, f)
        t_pre, t_fol, mask_pre, mask_fol = self._context_times(B, K, f.shape[1], p.device, lengths)
        ctx_mask = torch.cat([mask_pre, mask_fol]).to(p.dtype).expand(B, -1)
        reps_p, reps_f = self.encode_frames(p), self.encode_frames(f)
        if lengths is None:
            step_times = _draw_orders(B, T, generator).to(p.device, non_blocking=True).float() / T + 1.0  # [B, T]
            mid_times, step_valid = step_times, p.new_ones(T)
        else:
            u = _draw_uniforms(B, T, generator).to(p.device, non_blocking=True)
            step_times, base, valid = _ranked_times(u, lengths[1])
            mid_times, step_valid = torch.where(valid, base, 0.0), valid.to(p.dtype)

        preds: List[torch.Tensor] = []
        mid_reps: List[torch.Tensor] = []
        dec_reps = self.encode_frames(p[:, -1:])
        for t in range(T):
            if t > 0:
                dec_reps = self.encode_frames(preds[-1])
                mid_reps.append(dec_reps[-1])
            enc_in = torch.cat([reps_p[-1], reps_f[-1], *mid_reps], dim=1)
            enc_time = torch.cat([t_pre, t_fol, mid_times[:, :t]], dim=1)
            enc_mask = torch.cat([ctx_mask, step_valid[:t].expand(B, t)], dim=1)
            enc_out = self.encoder(enc_in, enc_mask, enc_time)
            preds.append(self._step_decode(enc_out, enc_mask, dec_reps, step_times[:, t : t + 1]))
        return {"pred": _video(self._resort(torch.cat(preds, dim=1), step_times))}


class SCTSkipConScaledTRandomCFillInModel(SCTSkipConScaledTRandomBFillInModel):
    """RandomB with encoder/decoder skip connections."""

    enc_return_all = True
    dec_enc_attend = "skip"


class SCTSkipConScaledTRandomDFillInModel(SCTSkipConScaledTRandomBFillInModel):
    """RandomC with same-level encoder attention."""

    enc_return_all = True
    dec_enc_attend = "same"


class _Bypass(nn.Module):
    def __init__(self, features: int):
        super().__init__()
        self.c1 = Conv(features, features, 3)
        self.c2 = Conv(features, features, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.c2(F.relu(self.c1(x))))


class SCTBypassScaledTForwardFillInModel(SCTSkipConScaledTForwardFillInModel):
    """Forward whose frame-decoder skips pass through two convs each (``bypass{i}``)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        for i in range(4):
            self.add_module(f"bypass{i}", _Bypass(self.d_v // 2 ** (3 - i)))

    def _skip(self, skip: torch.Tensor, stage: int) -> torch.Tensor:
        flat = getattr(self, f"bypass{3 - stage}")(skip.flatten(0, 1))
        return flat.reshape(*skip.shape[:2], *flat.shape[1:])


class SCTFrameEncDecBNSkipConScaledTForwardFillInModel(SCTSkipConScaledTForwardFillInModel):
    """Forward with a normalised frame codec."""

    frame_norm = True


SCT_CLASSES = {
    "SCTSkipConScaledTForward": SCTSkipConScaledTForwardFillInModel,
    "SCTSkipConScaledTInward": SCTSkipConScaledTInwardFillInModel,
    "SCTSkipConScaledTRandom": SCTSkipConScaledTRandomFillInModel,
    "SCTSkipConScaledTRandomB": SCTSkipConScaledTRandomBFillInModel,
    "SCTSkipConScaledTRandomC": SCTSkipConScaledTRandomCFillInModel,
    "SCTSkipConScaledTRandomD": SCTSkipConScaledTRandomDFillInModel,
    "SCTBypassScaledTForward": SCTBypassScaledTForwardFillInModel,
    "SCTFrameEncDecBNSkipConScaledTForward": SCTFrameEncDecBNSkipConScaledTForwardFillInModel,
}

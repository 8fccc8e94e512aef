"""Legacy SCT fill-in variants (counterpart of ``vfi_tpu/models/legacy_sct.py``).

Two early conv-transformer models that the reference keeps on disk but never
registers; as in vfi_tpu they are reached only through a JSON model key,
e.g. ``{"class": "SCTSkipConFillInModel", "args": [], "kwargs": {"c_dim": 1,
"num_blocks": 2, "num_heads": 3, "d_v": 256, "d_ff": 2048}}``.  Against the
registered family (``models/sct.py``):

  * unscaled integer time steps: context frames at ``0..K-1`` and
    ``K+T..K+T+F-1``, middle frames at ``K..K+T-1``;
  * one generation order, earliest to latest under a causal mask;
  * ``SCTSkipConFillInModel`` seeds the decoder with the last preceding
    frame; ``SCTSuperSkipConFillInModel`` with a zero frame, and its level i
    cross-attends encoder level n-1-i.

Both have the teacher-forced pass (``gt_middle=`` / ``forward_train``).
"""

from __future__ import annotations

from typing import Dict

import torch

from .sct import BaseSCTFillInModel, _seq, _video


class SCTSkipConFillInModel(BaseSCTFillInModel):
    """Legacy forward-order SCT with unscaled times."""

    def _seed_frames(self, preceding: torch.Tensor) -> torch.Tensor:
        return preceding[:, -1:]

    def forward(self, T: int, preceding, following, gt_middle=None) -> Dict[str, torch.Tensor]:
        p, f = _seq(preceding), _seq(following)
        B, K = p.shape[:2]
        F_ = f.shape[1]
        ar = torch.arange(K + T + F_, dtype=torch.float32, device=p.device)
        enc_time = torch.cat([ar[:K], ar[K + T:]]).expand(B, K + F_)
        dec_time = ar[K:K + T].expand(B, T)
        enc_mask = p.new_ones((B, K + F_))
        enc_out = self.encoder(self.encode_frames(torch.cat([p, f], dim=1))[-1], enc_mask, enc_time)
        dec_in = self._seed_frames(p)
        if gt_middle is not None:
            dec_in = torch.cat([dec_in, _seq(gt_middle)[:, : T - 1]], dim=1)
        return {"pred": _video(self._decode_with_times(T, p, enc_out, enc_mask, dec_time, dec_in))}

    def forward_train(self, T: int, preceding, following, gt_middle) -> Dict[str, torch.Tensor]:
        return self(T, preceding, following, gt_middle=gt_middle)


class SCTSuperSkipConFillInModel(SCTSkipConFillInModel):
    """Legacy variant: a zero start frame and skip-connected transformer levels."""

    enc_return_all = True
    dec_enc_attend = "skip"

    def _seed_frames(self, preceding: torch.Tensor) -> torch.Tensor:
        return torch.zeros_like(preceding[:, :1])

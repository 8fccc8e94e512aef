"""Training hyper-parameters (counterpart of ``vfi_tpu/utils/config.py``'s
``TrainConfig``; the argument parser is not ported)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class TrainConfig:
    """The static training hyper-parameters consumed by environments."""

    K: int
    T: int
    F: int
    lr: float = 1e-4
    beta1: float = 0.5
    alpha: float = 1.0
    beta: float = 0.02
    df_dim: int = 64
    Ip: int = 3
    disc_window_size: int = 3
    tf_p_min: float = 0.0
    tf_p_max: float = 0.0
    tf_offset: float = 100000.0
    tf_decay: float = 20000.0
    lambda_r: float = 0.8
    lambda_p: float = 0.005
    lambda_w: float = 0.4
    lambda_s: float = 1.0
    lr_decay_count: int = 40000
    lr_decay_rate: float = 0.1
    vgg16_weights: Optional[str] = None
    train_dtype: str = "float32"  # "bfloat16" -> mixed precision (f32 params/opt, bf16 compute)

    @classmethod
    def from_opt(cls, opt) -> "TrainConfig":
        names = {f for f in cls.__dataclass_fields__}
        return cls(**{k: v for k, v in vars(opt).items() if k in names})

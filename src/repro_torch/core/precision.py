"""Precision strategies (Paper Table 2) as a selectable policy, the port of
``repro.core.precision``: every training entry point takes ``--precision
{A,B,C,D,D-MW,KAHAN,SR}``."""

from __future__ import annotations

import dataclasses
import enum

import torch


class Strategy(str, enum.Enum):
    """Precision strategy options, Paper §5 (+ App. B baselines)."""

    A_BF16 = "A"              # plain bf16 AdamW (option A)
    B_COLLAGE_LIGHT = "B"     # + MCF expansion on params
    C_COLLAGE_PLUS = "C"      # + MCF expansion on v and beta2
    D_MINUS_MW = "D-MW"       # fp32 optim states, no master weights
    D_MIXED_MW = "D"          # fp32 optim states + fp32 master weights
    KAHAN = "KAHAN"           # Kahan-compensated bf16
    SR = "SR"                 # stochastic-rounding bf16

    @property
    def uses_expansion_params(self) -> bool:
        return self in (Strategy.B_COLLAGE_LIGHT, Strategy.C_COLLAGE_PLUS)

    @property
    def uses_expansion_second_moment(self) -> bool:
        return self is Strategy.C_COLLAGE_PLUS

    @property
    def optim_dtype(self):
        if self in (Strategy.D_MINUS_MW, Strategy.D_MIXED_MW):
            return torch.float32  # f32-ok: D⁻ and D keep f32 moments (Paper Table 2)
        return None  # component dtype of the policy

    @property
    def uses_master_weights(self) -> bool:
        return self is Strategy.D_MIXED_MW


# Paper Table 2: state bytes per parameter (param+grad, optim states, MCF/MW).
BYTES_PER_PARAM = {
    Strategy.A_BF16: 8,            # 2θ+2g + 2m+2v
    Strategy.B_COLLAGE_LIGHT: 10,  # + 2δθ
    Strategy.C_COLLAGE_PLUS: 12,   # + 2δθ + 2δv
    Strategy.D_MINUS_MW: 12,       # 2θ+2g + 4m+4v
    Strategy.D_MIXED_MW: 16,       # + 4 master
    Strategy.KAHAN: 10,            # + 2c
    Strategy.SR: 8,
}


@dataclasses.dataclass(frozen=True)
class BucketPolicy:
    """Knobs of the bucketed multi-tensor engine: ``enabled`` keeps params
    and all optimizer state as persistent flat buckets; ``max_bucket_elems``
    splits buckets above that element count (None: one bucket per dtype);
    ``pad_multiple`` is the flat-axis padding, a multiple of 128."""

    enabled: bool = False
    max_bucket_elems: int | None = None
    pad_multiple: int = 1024     # 8 × 128, the JAX package's default


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    """End-to-end numeric policy for a training run."""

    strategy: Strategy = Strategy.C_COLLAGE_PLUS
    param_dtype: torch.dtype = torch.bfloat16    # stored params / grads / acts
    accum_dtype: torch.dtype = torch.float32     # GEMM accumulation  # f32-ok
    softmax_dtype: torch.dtype = torch.float32   # attention softmax / norms  # f32-ok
    # "fused": weight decay inside the summed update (Alg. 2 l.12);
    # "pytorch": separate (1-αλ)θ step (App. D Eq. 4, kept for ablation)
    wd_mode: str = "fused"
    bucketing: BucketPolicy = BucketPolicy()

    @property
    def bytes_per_param(self) -> int:
        return BYTES_PER_PARAM[self.strategy]


def parse_strategy(name: str) -> Strategy:
    name = name.upper().replace("_", "-")
    aliases = {"D-MW": Strategy.D_MINUS_MW, "DMW": Strategy.D_MINUS_MW,
               "LIGHT": Strategy.B_COLLAGE_LIGHT, "PLUS": Strategy.C_COLLAGE_PLUS}
    if name in aliases:
        return aliases[name]
    return Strategy(name)

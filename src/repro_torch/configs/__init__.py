"""Architecture registry: ``--arch <id>`` resolution for the port's entry
points: the paper's own GPT family and all ten architecture families of
the JAX package — the six attention-only ones (dense GQA, gemma3's
local:global windows, MoE), the two recurrent ones (rwkv6's time/channel
mix, jamba's Mamba + attention + MoE hybrid) and the two with a frontend
stub (seamless-m4t's encoder + cross-attention, internvl2's patch
prefix). An unknown arch raises ``KeyError``."""

from repro_torch.configs import (codeqwen1_5_7b, gemma3_27b, gpt, granite_3_2b, internlm2_1_8b,
                                 internvl2_1b, jamba_1_5_large_398b, moonshot_v1_16b_a3b,
                                 qwen3_moe_30b_a3b, rwkv6_1_6b, seamless_m4t_medium)
from repro_torch.configs.base import SHAPES, Group, ModelConfig, ShapeConfig, Sub

GPT = {"gpt-tiny": gpt.GPT_TINY, "gpt-125m": gpt.GPT_125M, "gpt-1.3b": gpt.GPT_1_3B,
       "gpt-2.7b": gpt.GPT_2_7B, "gpt-6.7b": gpt.GPT_6_7B, "gpt-30b": gpt.GPT_30B}

ARCHS = {
    "seamless-m4t-medium": seamless_m4t_medium,
    "granite-3-2b": granite_3_2b,
    "internlm2-1.8b": internlm2_1_8b,
    "codeqwen1.5-7b": codeqwen1_5_7b,
    "gemma3-27b": gemma3_27b,
    "qwen3-moe-30b-a3b": qwen3_moe_30b_a3b,
    "moonshot-v1-16b-a3b": moonshot_v1_16b_a3b,
    "rwkv6-1.6b": rwkv6_1_6b,
    "jamba-1.5-large-398b": jamba_1_5_large_398b,
    "internvl2-1b": internvl2_1b,
}

# the JAX package's assigned architectures, in its registry's order
ASSIGNED = ["seamless-m4t-medium", "granite-3-2b", "internlm2-1.8b", "codeqwen1.5-7b",
            "gemma3-27b", "qwen3-moe-30b-a3b", "moonshot-v1-16b-a3b", "jamba-1.5-large-398b",
            "internvl2-1b", "rwkv6-1.6b"]

# families of the JAX package that the port does not cover yet: none
NOT_YET_PORTED = ()


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    arch = arch.replace("_", "-")
    if arch.startswith("gpt"):
        return gpt.SMOKE if smoke else GPT[arch]
    if arch in ARCHS:
        mod = ARCHS[arch]
        return mod.SMOKE if smoke else mod.CONFIG
    raise KeyError(f"unknown arch {arch!r}")


__all__ = ["ARCHS", "ASSIGNED", "GPT", "NOT_YET_PORTED", "SHAPES", "get_config", "ModelConfig",
           "Group", "ShapeConfig", "Sub"]

"""The paper's own GPT family (Paper Table 11): dense MHA, tanh-GELU MLP,
(1 + scale) RMSNorm, split-half RoPE. A copy of ``repro.configs.gpt``."""

import dataclasses

from repro_torch.configs.base import ModelConfig


def _gpt(name, n_layers, d_model, n_heads):
    return ModelConfig(
        name=name, family="dense", n_layers=n_layers, d_model=d_model,
        n_heads=n_heads, n_kv_heads=n_heads, d_ff=4 * d_model,
        vocab_size=50257, act="gelu", rope_theta=1e4)


GPT_125M = _gpt("gpt-125m", 12, 768, 12)
GPT_1_3B = _gpt("gpt-1.3b", 24, 2048, 16)
GPT_2_7B = _gpt("gpt-2.7b", 32, 2560, 32)
GPT_6_7B = _gpt("gpt-6.7b", 32, 4096, 32)
GPT_30B = _gpt("gpt-30b", 56, 7168, 56)

# tiny model for the pretraining-quality benchmarks on CPU
GPT_TINY = dataclasses.replace(_gpt("gpt-tiny", 4, 256, 8), vocab_size=512)

CONFIG = GPT_125M
SMOKE = dataclasses.replace(_gpt("gpt-smoke", 2, 64, 4), vocab_size=256)

"""moonshot-v1-16b-a3b [moe]: kimi/moonlight, 64e top-6
[hf:moonshotai/Moonlight-16B-A3B; hf]. 48L d_model=2048 16H (GQA kv=16)
d_ff=1408 (expert width) vocab=163840. A copy of
``repro.configs.moonshot_v1_16b_a3b``."""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=1408,
    vocab_size=163840, n_experts=64, experts_per_token=6,
    act="swiglu", rope_theta=5e4)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=32,
    vocab_size=256, n_experts=8, experts_per_token=2, capacity_factor=4.0)

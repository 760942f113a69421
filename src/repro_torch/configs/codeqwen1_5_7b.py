"""codeqwen1.5-7b [dense]: qwen1.5-arch [hf:Qwen/CodeQwen1.5-7B; hf].
32L d_model=4096 32H (GQA kv=32 → MHA) d_ff=13440 vocab=92416. A copy of
``repro.configs.codeqwen1_5_7b``."""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="codeqwen1.5-7b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=32, d_ff=13440,
    vocab_size=92416, act="swiglu", rope_theta=1e6)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
    vocab_size=256)

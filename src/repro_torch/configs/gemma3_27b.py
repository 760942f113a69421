"""gemma3-27b [dense]: 5:1 local:global sliding-window, 128k context
[hf:google/gemma-3-1b-pt; unverified]. 62L d_model=5376 32H (GQA kv=16)
d_ff=21504 vocab=262144. head_dim=128, qk-norm. Stack program: 10×(5 local +
1 global) + 2 trailing local layers. attention_impl="banded" is the
optimized O(L·W) local path (§Perf hillclimb); "masked" is the baseline. A copy of
``repro.configs.gemma3_27b``."""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-27b", family="dense",
    n_layers=62, d_model=5376, n_heads=32, n_kv_heads=16, head_dim=128,
    d_ff=21504, vocab_size=262144, act="swiglu", rope_theta=1e6,
    local_global_period=6, window_size=1024, qk_norm=True,
    tie_embeddings=True)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=8, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256, local_global_period=4, window_size=8)

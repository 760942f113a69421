"""granite-3-2b [dense]: GQA [hf:ibm-granite/granite-3.0-2b-base; hf].
40L d_model=2048 32H (GQA kv=8) d_ff=8192 vocab=49155. A copy of
``repro.configs.granite_3_2b``."""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-2b", family="dense",
    n_layers=40, d_model=2048, n_heads=32, n_kv_heads=8, d_ff=8192,
    vocab_size=49155, act="swiglu", rope_theta=1e4, tie_embeddings=True)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab_size=256)

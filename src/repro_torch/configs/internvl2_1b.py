"""internvl2-1b [vlm]: InternViT + LM backbone [arXiv:2404.16821; hf].
24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151655. Vision frontend is a
STUB: the batch carries precomputed patch embeddings; text length is
seq_len − frontend_len so each cell's total positions match the shape. A
copy of ``repro.configs.internvl2_1b``."""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b", family="vlm",
    n_layers=24, d_model=896, n_heads=14, n_kv_heads=2, d_ff=4864,
    vocab_size=151655, act="swiglu", rope_theta=1e6, tie_embeddings=True,
    frontend="vit_patches", frontend_len=256)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=56, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab_size=256, frontend_len=8)

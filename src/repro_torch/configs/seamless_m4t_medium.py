"""seamless-m4t-medium [audio]: enc-dec multimodal backbone
[arXiv:2308.11596; hf]. 12L d_model=1024 16H (GQA kv=16) d_ff=4096
vocab=256206. Audio frontend is a STUB: the batch carries precomputed
frame embeddings (B, frontend_len, d_model). A copy of
``repro.configs.seamless_m4t_medium``."""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium", family="audio",
    n_layers=12, n_enc_layers=12, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab_size=256206, act="gelu", rope_theta=1e4,
    frontend="audio_frames", frontend_len=1024)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, n_enc_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab_size=256, frontend_len=8)

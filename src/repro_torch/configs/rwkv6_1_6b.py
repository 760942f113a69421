"""rwkv6-1.6b [ssm]: Finch — data-dependent decay [arXiv:2404.05892;
unverified]. 24L d_model=2048 (attention-free) d_ff=7168 vocab=65536.
O(1)/token decode via (dk×dv) head states. A copy of
``repro.configs.rwkv6_1_6b``."""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b", family="ssm",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32, d_ff=7168,
    vocab_size=65536, attention_free=True, rwkv_head_dim=64, rwkv_chunk=64,
    rope_theta=0.0)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=2, n_kv_heads=2, d_ff=128,
    vocab_size=256, rwkv_head_dim=16, rwkv_chunk=8)

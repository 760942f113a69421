"""jamba-1.5-large-398b [hybrid]: Mamba+attn 1:7 interleave, MoE 16e top-2
[arXiv:2403.19887; hf]. 72L d_model=8192 64H (GQA kv=8) d_ff=24576
vocab=65536. Stack program: 9 periods of 8 layers (7 Mamba + 1 attention;
MoE FFN every 2nd layer). A copy of ``repro.configs.jamba_1_5_large_398b``."""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=24576, vocab_size=65536, n_experts=16, experts_per_token=2,
    attn_every=8, moe_every=2, ssm_d_state=16, ssm_expand=2, ssm_chunk=16,
    act="swiglu", rope_theta=0.0)  # jamba uses no positional encoding

SMOKE = dataclasses.replace(
    CONFIG, n_layers=4, attn_every=4, d_model=64, n_heads=4, n_kv_heads=2,
    head_dim=16, d_ff=64, vocab_size=256, n_experts=4, experts_per_token=2, capacity_factor=4.0,
    ssm_chunk=8)

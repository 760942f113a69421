"""Config system: model configs + layer-stack programs.

The port's own copy of ``repro.configs.base`` (the port imports nothing of
the JAX package). A model is described by a ``ModelConfig`` plus a derived
*stack program*: an ordered list of ``Group(repeats, period)`` where
``period`` is a tuple of sublayer specs. Each group's parameters are stacked
over ``repeats`` (leading axis), exactly as in the JAX package; the port
walks that axis with a Python loop where the JAX package scans it.
Heterogeneous interleaves (jamba 1:7 Mamba:attn with MoE-every-2, gemma3
5:1 local:global) are expressed as longer periods, not per-layer
conditionals.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class Sub:
    """One sublayer (pre-norm residual block) inside a period."""

    kind: str                 # attn | cross_attn | mamba | rwkv_tmix |
    #                           rwkv_cmix | mlp | moe
    window: int = 0           # attn only: 0 = global causal, >0 = local band
    causal: bool = True       # attn only: False for encoder self-attention


@dataclasses.dataclass(frozen=True)
class Group:
    repeats: int
    period: tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str               # dense | moe | hybrid | ssm | encdec | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    # --- MoE ---
    n_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    moe_group_size: int = 0    # tokens per dispatch group (0 = ungrouped)
    # --- attention pattern (gemma3-style local:global) ---
    local_global_period: int = 0   # e.g. 6 → 5 local + 1 global
    window_size: int = 1024
    attention_impl: str = "masked"  # "masked" (baseline) | "banded" (optimized)
    # --- flash-attention prefill path ---
    # causal self-attention sublayers (global AND banded-local) dispatch to
    # the flash kernel when L >= flash_min_len (0 = off); the masked path
    # stays as the short-sequence + oracle path
    flash_min_len: int = 0
    flash_block: int = 128         # q/k block size of the JAX package's kernels
    # --- hybrid (jamba) ---
    attn_every: int = 0       # e.g. 8 → attention at period position 7 (1:7)
    moe_every: int = 0        # e.g. 2 → MoE FFN on odd positions
    ssm_d_state: int = 16
    ssm_conv_width: int = 4
    ssm_expand: int = 2
    ssm_chunk: int = 64       # chunked selective-scan block size
    # --- rwkv6 ---
    attention_free: bool = False
    rwkv_head_dim: int = 64
    rwkv_chunk: int = 64
    # --- encoder-decoder ---
    n_enc_layers: int = 0
    # --- modality frontend stubs ([audio]/[vlm]) ---
    frontend: Optional[str] = None    # "audio_frames" | "vit_patches"
    frontend_len: int = 256           # frames/patches per sample
    # --- misc ---
    norm_eps: float = 1e-5
    act: str = "swiglu"       # swiglu | gelu
    rope_theta: float = 1e4
    qk_norm: bool = False
    tie_embeddings: bool = False
    max_seq_len: int = 131072
    dtype: str = "bfloat16"

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    # ------------------------------------------------------------ programs
    def decoder_program(self) -> list[Group]:
        """Stack program for the decoder (or the only) stack."""
        if self.family == "ssm":  # rwkv6: 24 × (time-mix, channel-mix)
            return [Group(self.n_layers, (Sub("rwkv_tmix"), Sub("rwkv_cmix")))]
        if self.family == "hybrid":  # jamba period of attn_every layers
            period = []
            for i in range(self.attn_every):
                mixer = Sub("attn") if i == self.attn_every - 1 else Sub("mamba")
                ffn = Sub("moe") if (self.moe_every and i % self.moe_every == 1) else Sub("mlp")
                period += [mixer, ffn]
            reps, rem = divmod(self.n_layers, self.attn_every)
            assert rem == 0, "hybrid n_layers must divide attn_every"
            return [Group(reps, tuple(period))]
        ffn = Sub("moe") if self.family == "moe" else Sub("mlp")
        if self.local_global_period:  # gemma3 5:1 local:global
            p = self.local_global_period
            period = []
            for i in range(p):
                w = 0 if i == p - 1 else self.window_size
                period += [Sub("attn", window=w), ffn]
            reps, tail = divmod(self.n_layers, p)
            groups = [Group(reps, tuple(period))]
            if tail:
                groups.append(Group(1, tuple([Sub("attn", window=self.window_size), ffn] * tail)))
            return groups
        if self.family in ("encdec", "audio"):
            return [Group(self.n_layers, (Sub("attn"), Sub("cross_attn"), ffn))]
        return [Group(self.n_layers, (Sub("attn"), ffn))]

    def encoder_program(self) -> list[Group]:
        if self.n_enc_layers == 0:
            return []
        return [Group(self.n_enc_layers, (Sub("attn", causal=False), Sub("mlp")))]

    @property
    def is_encdec(self) -> bool:
        return self.n_enc_layers > 0

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic (or mostly-local) archs that run long_500k."""
        return (self.family in ("ssm", "hybrid")
                or self.local_global_period > 0)

    def param_count(self) -> int:
        """Analytic parameter count (embedding + stacks), for roofline."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        h, hk, dh = self.n_heads, self.n_kv_heads, self.head_dim_
        attn = d * (h * dh) * 2 + d * (hk * dh) * 2      # q,o + k,v
        mlp = 3 * d * f if self.act == "swiglu" else 2 * d * f
        moe = self.n_experts * 3 * d * f + d * self.n_experts
        d_in = self.ssm_expand * d
        mamba = (d * 2 * d_in + d_in * self.ssm_conv_width
                 + d_in * self.ssm_d_state  # A
                 + d_in * (d // 16) + d_in  # dt_proj(+bias? no), D
                 + d_in * (d // 16 + 2 * self.ssm_d_state)
                 + d_in * d)
        rwkv_t = 6 * d * d + 2 * d * 64  # r,k,v,g,o,w-lora-ish
        rwkv_c = 3 * d * f // 2 if False else 2 * d * f  # cmix uses d_ff
        total = 0
        for g in self.decoder_program() + self.encoder_program():
            per = 0
            for sub in g.period:
                per += {"attn": attn, "cross_attn": attn, "mlp": mlp,
                        "moe": moe, "mamba": mamba, "rwkv_tmix": rwkv_t,
                        "rwkv_cmix": rwkv_c}[sub.kind]
                per += d  # norm scale
            total += g.repeats * per
        total += v * d * (1 if self.tie_embeddings else 2)  # embed + head
        total += d  # final norm
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE: only routed experts) — for 6·N·D."""
        if not self.n_experts:
            return self.param_count()
        full = self.param_count()
        d, f = self.d_model, self.d_ff
        moe_layers = 0
        for g in self.decoder_program():
            moe_layers += g.repeats * sum(1 for s in g.period if s.kind == "moe")
        inactive = moe_layers * (self.n_experts - self.experts_per_token) * 3 * d * f
        return full - inactive


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell: sequence length, global batch and mode."""

    name: str                 # e.g. train_4k | prefill_32k | decode_32k | custom
    seq_len: int
    global_batch: int
    mode: str                 # "train" | "prefill" | "decode"


# the JAX package's assigned input-shape cells (``repro.configs.base.SHAPES``)
SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

"""Shared neural-net layers, the port of ``repro.models.layers``.

Numeric discipline (paper §2.1 "mixed-precision GEMM"): params/activations
are stored in the policy dtype (bf16); every matmul accumulates in fp32 and
is rounded back to the storage dtype; norms/softmax run in fp32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

ACC = torch.float32


def dense_init(gen, shape, dtype, scale=None):
    """N(0, 1) · scale, drawn in f32 on ``gen``'s device; ``shape`` ends in
    (d_in, d_out) and may lead with a stack axis. Default scale d_in^-1/2."""
    scale = scale if scale is not None else shape[-2] ** -0.5
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=gen.device)
    return (w * scale).to(dtype)


def rms_norm_init(shape, dtype, device):
    return torch.zeros(shape, dtype=dtype, device=device)  # (1 + scale) parameterization


def matmul(x, w):
    """Storage-dtype matmul with fp32 accumulation. A bf16 GEMM reduces in
    fp32 and rounds once to bf16 (``device.resolve_device`` turns off the
    reduced-precision split-K reduction on the card)."""
    return torch.matmul(x, w)


def rms_norm(x, scale, eps):
    xf = x.to(ACC)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.to(ACC))).to(x.dtype)


def embed_lookup(table, ids):
    return table[ids]


# ----------------------------------------------------------------- RoPE ----
def rope_freqs(positions, head_dim, theta):
    """positions: (..., L) int → cos/sin (..., L, head_dim/2), f32."""
    exponent = torch.arange(0, head_dim, 2, dtype=ACC, device=positions.device) / head_dim
    inv = 1.0 / (theta**exponent)
    ang = positions.to(ACC)[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def rope_apply(x, cos, sin):
    """x: (B, L, H, dh); cos/sin: (B, L, dh/2) — rotate split halves."""
    xf = x.to(ACC)
    x1, x2 = torch.chunk(xf, 2, dim=-1)
    c = cos[:, :, None, :]
    s = sin[:, :, None, :]
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(x.dtype)


# ------------------------------------------------------------------ MLP ----
def mlp_apply(p, x, act):
    if act == "swiglu":
        g = matmul(x, p["w_gate"])
        u = matmul(x, p["w_up"])
        h = (F.silu(g.to(ACC)) * u.to(ACC)).to(x.dtype)
        return matmul(h, p["w_down"])
    # jax.nn.gelu defaults to the tanh approximation
    h = F.gelu(matmul(x, p["w_in"]).to(ACC), approximate="tanh").to(x.dtype)
    return matmul(h, p["w_out"])

"""Mamba selective-SSM block (jamba's sequence mixer), the port of
``repro.models.ssm``.

The training/prefill path is the reference's chunked form: a sequential
loop over chunks of ``ssm_chunk`` tokens carrying the (B, d_inner,
d_state) f32 state, with a parallel scan inside each chunk. The reference
scans chunks with ``lax.scan`` and the inside of a chunk with
``lax.associative_scan``; the port loops over chunks in Python and scans
inside a chunk with ``chunk_scan``, a log-step (Hillis–Steele) scan with
the reference's combine: log2(chunk) steps of whole-chunk tensor ops (four
at jamba's chunk of 16), not one step a token. Its bracketing differs from
XLA's, so it agrees with the reference to f32 rounding, not to the bit.
``mamba_reference`` runs the decode step token by token as the oracle.

On a grid (the channel dims over "model") a rank runs its d_in/tp
channels: ``conv_w``, ``dt_proj``, ``dt_bias``, ``A_log``, ``D`` and the
states ``h``/``conv`` are blocks of them. ``in_proj`` (D, 2·d_in) arrives
all-gathered over "model" (``distributed.sharding.materialize``), since its
column block does not fall on the x/z split (over model 2, rank 0 would hold
all of x and rank 1 all of z); the rank takes its channels of both halves.
``x_proj`` is a row block: its (dt_rank + 2n) product is an f32 partial,
summed over "model" and rounded once, with its gradient summed over "model"
too (every rank's channels read the whole dt/B/C). ``out_proj`` is a row
block: the mixer's output is an f32 partial (``layers.out_proj``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed import collectives as coll
from repro_torch.models.layers import (ACC, chunk_pad, dense_init, matmul, matmul_f32, out_proj,
                                      sharder)


def mamba_init(gen, cfg, dtype, repeats):
    """Parameters of ``repeats`` stacked Mamba sublayers. Same shapes and
    scales as the reference's init, not the same numbers."""
    d, R = cfg.d_model, repeats
    d_in = cfg.ssm_expand * d
    n = cfg.ssm_d_state
    dt_rank = max(d // 16, 1)
    dev = gen.device
    # f32-ok: Mamba's A_log init, cast to the parameter dtype below
    a_log = torch.log(torch.arange(1, n + 1, dtype=torch.float32, device=dev))
    return {
        "in_proj": dense_init(gen, (R, d, 2 * d_in), dtype),
        "conv_w": dense_init(gen, (R, cfg.ssm_conv_width, d_in), dtype, scale=0.2),
        "x_proj": dense_init(gen, (R, d_in, dt_rank + 2 * n), dtype),
        "dt_proj": dense_init(gen, (R, dt_rank, d_in), dtype),
        "dt_bias": torch.full((R, d_in), -4.6, dtype=dtype, device=dev),   # softplus⁻¹(0.01)
        "A_log": a_log.expand(R, d_in, n).to(dtype).contiguous(),
        "D": torch.ones((R, d_in), dtype=dtype, device=dev),
        "out_proj": dense_init(gen, (R, d_in, d), dtype),
    }


def softplus(x):
    """``jax.nn.softplus``: log(1 + eˣ) as logaddexp(x, 0) at every x
    (``F.softplus`` returns x itself above its threshold)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _causal_conv(x, w, state=None):
    """Depthwise causal conv1d. x: (B, L, d_in); w: (K, d_in).
    state: (B, K-1, d_in) tail from the previous segment (decode). The K
    products are summed in order in x's dtype, each partial sum rounded to
    it, as the reference's ``sum`` from a Python 0."""
    K, L = w.shape[0], x.shape[1]
    pad = torch.zeros((x.shape[0], K - 1, x.shape[2]), dtype=x.dtype, device=x.device) \
        if state is None else state
    xp = torch.cat([pad, x], dim=1)
    out = xp[:, 0:L] * w[0]
    for i in range(1, K):
        out = out + xp[:, i:i + L] * w[i]
    new_state = xp[:, -(K - 1):] if K > 1 else None
    return out, new_state


def _channels(p, cfg) -> tuple:
    """(first channel, channels) of this rank's block of d_in, and d_in."""
    d_in = cfg.ssm_expand * cfg.d_model
    dl = p["dt_bias"].shape[-1]
    return (0 if dl == d_in else sharder().block_start(dl, d_in)), dl, d_in


def in_proj_halves(p, cfg) -> tuple:
    """The columns of ``in_proj`` that give this rank's channels of x and
    of z."""
    lo, dl, d_in = _channels(p, cfg)
    w = p["in_proj"]
    return w[..., lo:lo + dl], w[..., d_in + lo:d_in + lo + dl]


def _ssm_inputs(p, x, cfg, conv_state=None):
    n = cfg.ssm_d_state
    dt_rank = max(cfg.d_model // 16, 1)
    _, dl, d_in = _channels(p, cfg)
    if dl == d_in:
        xz = matmul(x, p["in_proj"])
        xs, z = torch.chunk(xz, 2, dim=-1)
    else:
        wx, wz = in_proj_halves(p, cfg)
        xs, z = matmul(x, wx), matmul(x, wz)
    xs, new_conv = _causal_conv(xs, p["conv_w"], conv_state)
    xs = F.silu(xs.to(ACC)).to(x.dtype)
    if dl == d_in:
        xdb = matmul(xs, p["x_proj"])
    else:                                  # Σ over "model" both ways, in f32
        model = sharder().model
        part = matmul_f32(xs.reshape(-1, dl), p["x_proj"]).reshape(*xs.shape[:-1], -1)
        xdb = coll.copy_to(coll.reduce_to(part, model), model).to(x.dtype)
    dt_r = xdb[..., :dt_rank]
    b_ssm = xdb[..., dt_rank:dt_rank + n].to(ACC)
    c_ssm = xdb[..., dt_rank + n:].to(ACC)
    dt = softplus(matmul(dt_r, p["dt_proj"]).to(ACC) + p["dt_bias"].to(ACC))
    a = -torch.exp(p["A_log"].to(ACC))               # (d_in, n)
    return xs, z, dt, a, b_ssm, c_ssm, new_conv


def chunk_scan(a, b):
    """Inclusive scan along dim 1 of the linear recurrence h_t = a_t·h_{t-1}
    + b_t, as pairs: the reference's ``lax.associative_scan`` with combine
    (l, r) → (r₀·l₀, r₀·l₁ + r₁), in ⌈log2 len⌉ doubling steps."""
    n, s = a.shape[1], 1
    while s < n:
        a, b = (torch.cat([a[:, :s], a[:, s:] * a[:, :-s]], dim=1),
                torch.cat([b[:, :s], a[:, s:] * b[:, :-s] + b[:, s:]], dim=1))
        s *= 2
    return a, b


def _discretize(a, dt_k, b_k, xs_k):
    """(ā, b̄) of one chunk: exp(dt·A) and dt·x·B, (B, ck, d_in, n) f32."""
    a_bar = torch.exp(dt_k[..., None] * a)
    b_bar = (dt_k * xs_k)[..., None] * b_k[:, :, None, :]
    return a_bar, b_bar


def mamba_apply(p, x, cfg):
    """Parallel (train/prefill) path. x: (B, L, D) → (B, L, D)."""
    xs, z, dt, a, b_ssm, c_ssm, _ = _ssm_inputs(p, x, cfg)
    y = ssm_chunked(xs.to(ACC), dt, a, b_ssm, c_ssm, cfg.ssm_chunk)
    y = y + p["D"].to(ACC) * xs.to(ACC)
    y = y * F.silu(z.to(ACC))
    return out_proj(y.to(x.dtype), p["out_proj"], cfg.ssm_expand * cfg.d_model)


def ssm_chunked(xs, dt, a, b_ssm, c_ssm, chunk):
    """The selective scan of a whole sequence in chunks of ``chunk`` tokens
    (the reference's ``lax.scan`` over chunks, a Python loop here), the
    (B, d_in, n) f32 state carried across chunks. xs, dt: (B, L, d_in)
    f32; a: (d_in, n); b_ssm, c_ssm: (B, L, n) f32 → y (B, L, d_in) f32."""
    B, L, d_in = xs.shape
    ck, pad = chunk_pad(L, chunk)
    nc = (L + pad) // ck

    def padded(t):
        return F.pad(t, (0, 0, 0, pad)) if pad else t

    xs, dt, b_ssm, c_ssm = map(padded, (xs, dt, b_ssm, c_ssm))
    h = torch.zeros((B, d_in, a.shape[-1]), dtype=ACC, device=xs.device)
    ys = []
    for c in range(nc):
        sl = slice(c * ck, (c + 1) * ck)
        acc_a, acc_b = chunk_scan(*_discretize(a, dt[:, sl], b_ssm[:, sl], xs[:, sl]))
        hs = acc_a * h[:, None] + acc_b              # (B, ck, d_in, n)
        ys.append(torch.einsum("bldn,bln->bld", hs, c_ssm[:, sl]))
        h = hs[:, -1]
    return torch.cat(ys, dim=1)[:, :L]


def mamba_decode(p, x, cfg, state):
    """O(1) decode. x: (B, 1, D); state {"h": (B,d_in,n) f32, "conv":
    (B,K-1,d_in)}. Returns (out, new state); the state passed in is not
    changed."""
    xs, z, dt, a, b_ssm, c_ssm, new_conv = _ssm_inputs(p, x, cfg, conv_state=state["conv"])
    a_bar = torch.exp(dt[:, 0, :, None] * a)         # (B, d_in, n)
    b_bar = (dt[:, 0] * xs.to(ACC)[:, 0])[..., None] * b_ssm[:, 0, None, :]
    h = a_bar * state["h"] + b_bar
    y = torch.einsum("bdn,bn->bd", h, c_ssm[:, 0])
    y = y + p["D"].to(ACC) * xs.to(ACC)[:, 0]
    y = y * F.silu(z.to(ACC)[:, 0])
    out = out_proj(y[:, None].to(x.dtype), p["out_proj"], cfg.ssm_expand * cfg.d_model)
    return out, {"h": h, "conv": new_conv}


def mamba_init_state(cfg, batch, dtype, device, repeats=None):
    """Zero decode state; ``repeats`` adds a leading layer axis. On a grid
    this rank's channels."""
    d_in = cfg.ssm_expand * cfg.d_model
    if sharder() is not None:
        d_in = sharder().local_size(d_in)
    lead = () if repeats is None else (repeats,)
    return {"h": torch.zeros(lead + (batch, d_in, cfg.ssm_d_state), dtype=ACC, device=device),
            "conv": torch.zeros(lead + (batch, cfg.ssm_conv_width - 1, d_in), dtype=dtype,
                                device=device)}


def mamba_reference(p, x, cfg):
    """Token-by-token sequential oracle (tests only)."""
    state = mamba_init_state(cfg, x.shape[0], x.dtype, x.device)
    outs = []
    for t in range(x.shape[1]):
        o, state = mamba_decode(p, x[:, t:t + 1], cfg, state)
        outs.append(o)
    return torch.cat(outs, dim=1)

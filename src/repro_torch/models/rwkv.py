"""RWKV-6 "Finch" block: time-mix with data-dependent decay + channel-mix,
the port of ``repro.models.rwkv``.

The training/prefill path is the reference's *chunked linear-attention
form* (GLA-style): within a chunk of C tokens the pairwise decay matrix
P[i,j] = exp(cum[i] − cum[j+1]) (always ≤ 1: no division by decays) gives
an O(C²) intra term, while a (dk × dv) f32 state per head carries history
across chunks. The reference scans the chunks with ``lax.scan``; the port
runs a Python loop over them. Decode is O(1) a token through the state
recurrence; ``rwkv_tmix_reference`` runs it token by token as the oracle.

Simplifications of the reference kept as they are: static token-shift mix
coefficients for r/k/v/g; the *decay* keeps its data-dependent LoRA.
Parameters carry a leading stack axis of ``repeats`` at init, as every
sublayer of the port does; the apply functions take one layer's slice.

On a grid (the head and channel dims over "model"):

* time-mix runs this rank's heads: ``wr``/``wk``/``wv``/``wg`` are column
  blocks on head boundaries, ``w_b`` a column block, ``wo`` a row block
  (the output an f32 partial, ``layers.out_proj``). ``w0``, ``u`` and
  ``ln_scale`` are stored whole and sliced here to the rank's heads; they,
  ``mu`` and ``w_a`` (applied ahead of split products) take their
  gradient summed over "model" (``distributed.sharding.materialize``). The
  state ``S`` holds the rank's heads; ``last_x`` is whole.
* channel-mix: the rules go by name, so its ``wv`` (d_ff, d) and ``wr``
  (d, d) take attention's column rule, while ``wk`` (d, d_ff) splits d_ff.
  ``wk``'s block gives this rank's d_ff block of k; ``wv`` arrives
  all-gathered over "model" and the rank multiplies its d_ff rows: an f32
  partial of k·wv, summed over "model" both ways (forward and gradient)
  and rounded once. ``wr`` stays a column block: the rank's d/tp columns
  of the output, gate times k·wv, sit in an otherwise zero f32 partial, so
  the sublayer's boundary sum assembles the output exactly. Gathering
  ``wv`` (d_ff·d weights) rather than k (B·L·d_ff activations) keeps one
  product a rank over its own d_ff block.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed import collectives as coll
from repro_torch.models.layers import (ACC, chunk_pad, dense_init, matmul, matmul_f32, out_proj,
                                      sharder)

W_LORA = 64


def _uniform(gen, shape, dtype):
    """U[0, 1) drawn in f32 on ``gen``'s device, cast to ``dtype``."""
    if gen.device.type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    # f32-ok: init draws in f32, then casts to the parameter dtype
    return torch.rand(shape, generator=gen, dtype=torch.float32, device=gen.device).to(dtype)


def rwkv_tmix_init(gen, cfg, dtype, repeats):
    """Parameters of ``repeats`` stacked time-mix sublayers. Same shapes
    and scales as the reference's init, not the same numbers."""
    d, R = cfg.d_model, repeats
    h = d // cfg.rwkv_head_dim
    dev = gen.device
    return {
        "mu": _uniform(gen, (R, 5, d), dtype),
        "w0": torch.full((R, d), -2.0, dtype=dtype, device=dev),   # base decay
        "w_a": dense_init(gen, (R, d, W_LORA), dtype, scale=0.01),
        "w_b": dense_init(gen, (R, W_LORA, d), dtype, scale=0.01),
        "wr": dense_init(gen, (R, d, d), dtype),
        "wk": dense_init(gen, (R, d, d), dtype),
        "wv": dense_init(gen, (R, d, d), dtype),
        "wg": dense_init(gen, (R, d, d), dtype),
        "wo": dense_init(gen, (R, d, d), dtype),
        "u": dense_init(gen, (R, h, cfg.rwkv_head_dim), dtype, scale=0.1),
        "ln_scale": torch.ones((R, d), dtype=dtype, device=dev),   # per-head group norm
    }


def _token_shift(x, last=None):
    """x_{t-1} with zero (or carried) left pad. x: (B, L, D)."""
    pad = torch.zeros_like(x[:, :1]) if last is None else last[:, None]
    return torch.cat([pad, x[:, :-1]], dim=1)


def _block(w, lo: int, n: int):
    """Entries lo..lo+n of the last dim (the rank's heads or channels)."""
    return w if n == w.shape[-1] else w[..., lo:lo + n]


def _heads(p, x) -> tuple:
    """(first channel, channels) of this rank's heads of the time-mix."""
    dl = p["wr"].shape[-1]
    return (0 if dl == x.shape[-1] else sharder().block_start(dl, x.shape[-1])), dl


def _tmix_inputs(p, x, cfg, last_x=None):
    B, L, d = x.shape
    hd = cfg.rwkv_head_dim
    lo, dl = _heads(p, x)
    H = dl // hd
    xf = x.to(ACC)
    xprev = _token_shift(x, last_x).to(ACC)
    mu = p["mu"].to(ACC)

    def mix(i):          # rounded to the model dtype before its product
        m = mu[i]
        return (xf * (1 - m) + xprev * m).to(x.dtype)

    r = matmul(mix(0), p["wr"]).reshape(B, L, H, hd)
    k = matmul(mix(1), p["wk"]).reshape(B, L, H, hd)
    v = matmul(mix(2), p["wv"]).reshape(B, L, H, hd)
    g = matmul(mix(3), p["wg"])
    # data-dependent decay (the Finch signature): w ∈ (0,1)
    lora = matmul(torch.tanh(matmul(mix(4), p["w_a"]).to(ACC)).to(x.dtype), p["w_b"]).to(ACC)
    ww = _block(p["w0"], lo, dl).to(ACC) + lora
    logw = -torch.exp(torch.clamp(ww, -10.0, 4.0))            # log-decay ≤ 0
    logw = torch.clamp(logw, -20.0, -1e-4).reshape(B, L, H, hd)
    return r.to(ACC), k.to(ACC), v.to(ACC), g, logw, x[:, -1]


def _out_proj(p, wkv, g, cfg, x_dtype):
    B, L, H, hd = wkv.shape
    d = cfg.d_model
    # per-head group norm; the population variance, as jnp.var
    mean = torch.mean(wkv, -1, keepdim=True)
    var = torch.var(wkv, -1, keepdim=True, correction=0)
    wkv = (wkv - mean) * torch.rsqrt(var + 64e-5)
    lo = 0 if H * hd == d else sharder().block_start(H * hd, d)
    out = wkv.reshape(B, L, H * hd) * _block(p["ln_scale"], lo, H * hd).to(ACC)
    out = out * F.silu(g.to(ACC))
    return out_proj(out.to(x_dtype), p["wo"], d)


def rwkv_tmix_apply(p, x, cfg, chunk=None):
    """Chunked-parallel WKV6. x: (B, L, D) → (B, L, D)."""
    r, k, v, g, logw, _ = _tmix_inputs(p, x, cfg)
    o = wkv_chunked(r, k, v, logw, _u(p, x, cfg), chunk or cfg.rwkv_chunk)
    return _out_proj(p, o, g, cfg, x.dtype)


def _u(p, x, cfg):
    """The bonus ``u`` of this rank's heads, f32."""
    lo, dl = _heads(p, x)
    hd = cfg.rwkv_head_dim
    u = p["u"]
    return (u if dl == x.shape[-1] else u[lo // hd:(lo + dl) // hd]).to(ACC)


def wkv_chunked(r, k, v, logw, u, chunk):
    """The WKV recurrence of a whole sequence in chunks of ``chunk``
    tokens (the reference's ``lax.scan`` over chunks, a Python loop here).
    r, k, v, logw: (B, L, H, hd) f32; u: (H, hd) f32 → o (B, L, H, hd)."""
    B, L, H, hd = r.shape
    C, pad = chunk_pad(L, chunk)
    nc = (L + pad) // C

    def to_chunks(t):  # (B, L, H, hd) -> (B, nc, C, H, hd)
        if pad:
            t = F.pad(t, (0, 0, 0, 0, 0, pad))
        return t.reshape(B, nc, C, H, hd)

    rc, kc, vc, wc = map(to_chunks, (r, k, v, logw))
    mask = (torch.arange(C, device=r.device)[:, None]
            > torch.arange(C, device=r.device)[None, :]).to(ACC)[None, :, :, None]
    S = torch.zeros((B, H, hd, hd), dtype=ACC, device=r.device)
    outs = []
    for c in range(nc):
        rk, kk, vk, lw = rc[:, c], kc[:, c], vc[:, c], wc[:, c]      # (B, C, H, hd)
        cum = torch.cumsum(lw, dim=1)                 # Σ_{s≤i} logw_s
        cum_in = cum - lw                             # Σ_{s<i}  (exclusive)
        # inter-chunk: o_i += (r_i ⊙ exp(cum_in_i))ᵀ S_prev
        inter = torch.einsum("bchd,bhde->bche", rk * torch.exp(cum_in), S)
        # intra-chunk: A[i,j] = Σ_d r_i k_j exp(cum_in_i − cum_j)   (j < i)
        pair = cum_in[:, :, None] - cum[:, None, :]   # (B,C,C,H,hd) ≤ 0 for j<i
        pair = torch.exp(torch.clamp(pair, max=0.0))
        scores = torch.einsum("bihd,bjhd,bijhd->bijh", rk, kk, pair) * mask
        # diagonal bonus term: (r_i ⊙ u) · k_i
        diag = torch.einsum("bihd,hd,bihd->bih", rk, u, kk)
        intra = torch.einsum("bijh,bjhe->bihe", scores, vk) + diag[..., None] * vk
        # state update: S' = exp(cum_C)⊙S + Σ_j exp(cum_C − cum_j) k_j v_jᵀ
        decay_all = torch.exp(cum[:, -1])             # (B, H, hd)
        k_hat = kk * torch.exp(cum[:, -1][:, None] - cum)
        S = decay_all[..., None] * S + torch.einsum("bjhd,bjhe->bhde", k_hat, vk)
        outs.append(inter + intra)
    return torch.stack(outs, dim=1).reshape(B, L + pad, H, hd)[:, :L]


def rwkv_tmix_decode(p, x, cfg, state):
    """O(1) decode. state: {"S": (B,H,hd,hd) f32, "last_x": (B,D)}.
    Returns (out, new state); the state passed in is not changed."""
    r, k, v, g, logw, _ = _tmix_inputs(p, x, cfg, last_x=state["last_x"])
    u = _u(p, x, cfg)
    S = state["S"]
    rk, kk, vk = r[:, 0], k[:, 0], v[:, 0]            # (B, H, hd)
    o = torch.einsum("bhd,bhde->bhe", rk, S) + \
        torch.einsum("bhd,hd,bhd->bh", rk, u, kk)[..., None] * vk
    w = torch.exp(logw[:, 0])                         # (B, H, hd)
    S_new = w[..., None] * S + kk[..., None] * vk[:, :, None, :]
    out = _out_proj(p, o[:, None], g, cfg, x.dtype)
    return out, {"S": S_new, "last_x": x[:, -1]}


def rwkv_tmix_init_state(cfg, batch, dtype, device, repeats=None):
    """Zero decode state; ``repeats`` adds a leading layer axis. On a grid
    this rank's heads."""
    hd = cfg.rwkv_head_dim
    H = cfg.d_model // hd
    if sharder() is not None:
        H = sharder().local_size(H)
    lead = () if repeats is None else (repeats,)
    return {"S": torch.zeros(lead + (batch, H, hd, hd), dtype=ACC, device=device),
            "last_x": torch.zeros(lead + (batch, cfg.d_model), dtype=dtype, device=device)}


# ------------------------------------------------------------ channel mix --
def rwkv_cmix_init(gen, cfg, dtype, repeats):
    d, f, R = cfg.d_model, cfg.d_ff, repeats
    return {"mu": _uniform(gen, (R, 2, d), dtype),
            "wk": dense_init(gen, (R, d, f), dtype),
            "wv": dense_init(gen, (R, f, d), dtype),
            "wr": dense_init(gen, (R, d, d), dtype)}


def rwkv_cmix_apply(p, x, cfg, last_x=None):
    xf = x.to(ACC)
    xprev = _token_shift(x, last_x).to(ACC)
    mu = p["mu"].to(ACC)
    xk = (xf * (1 - mu[0]) + xprev * mu[0]).to(x.dtype)
    xr = (xf * (1 - mu[1]) + xprev * mu[1]).to(x.dtype)
    k = torch.square(torch.relu(matmul(xk, p["wk"]).to(ACC))).to(x.dtype)
    fl = p["wk"].shape[-1]
    if fl == cfg.d_ff:
        return (torch.sigmoid(matmul(xr, p["wr"]).to(ACC))
                * matmul(k, p["wv"]).to(ACC)).to(x.dtype)
    # this rank's d_ff block of k against the rows of the gathered wv
    sh = sharder()
    B, L, d = x.shape
    part = matmul_f32(k.reshape(-1, fl), p["wv"][sh.block_start(fl, cfg.d_ff):][:fl])
    kv = coll.copy_to(coll.reduce_to(part, sh.model).to(x.dtype), sh.model).to(ACC)
    dl = p["wr"].shape[-1]
    c0 = sh.block_start(dl, d)
    gate = torch.sigmoid(matmul(xr, p["wr"]).to(ACC))
    cols = gate * kv.reshape(B, L, d)[..., c0:c0 + dl]
    return F.pad(cols, (c0, d - c0 - dl))      # the f32 partial: zeros off its columns


def rwkv_cmix_decode(p, x, cfg, state):
    out = rwkv_cmix_apply(p, x, cfg, last_x=state["last_x"])
    return out, {"last_x": x[:, -1]}


def rwkv_tmix_reference(p, x, cfg):
    """Sequential oracle (tests only)."""
    B = x.shape[0]
    state = rwkv_tmix_init_state(cfg, B, x.dtype, x.device)
    outs = []
    for t in range(x.shape[1]):
        o, state = rwkv_tmix_decode(p, x[:, t:t + 1], cfg, state)
        outs.append(o)
    return torch.cat(outs, dim=1)

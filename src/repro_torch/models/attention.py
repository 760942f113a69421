"""GQA attention for prefill and single-token KV-cache decode, the port of
``repro.models.attention``.

GQA is computed with grouped einsums — KV heads are never materialized
repeated. Softmax in fp32. Above ``cfg.flash_min_len`` every causal
self-attention sublayer dispatches to the flash kernel
(``kernel_flash_attention``); the masked path stays as the short-sequence
implementation and the test oracle. Below it, windowed layers (gemma3's
local ones) take ``banded_attention`` (O(L·W): each block of W queries
scores its own and the previous key block) under ``attention_impl``
"banded" or "flash", and causal layers ``flash_attention`` (the JAX
package's blocked online softmax, in torch) under "flash".
``verify_attention`` is the speculative verify step. Cross-attention
(enc-dec decoders) runs ``full_attention`` with ``x_kv`` (the encoder's
memory) and no rotary embedding at prefill, and ``cross_decode`` against
the memory's K/V, computed once at prefill by ``cross_kv``, at decode and
verify.

Head counts come from the weights, so on a grid of ranks the functions run
on this rank's heads: ``wq``/``wk``/``wv`` are column blocks (whole heads),
``wo`` a row block whose partial output the sublayer sums over "model".
Where the KV heads do not divide "model", every rank holds them all (a
projection gathered over "model", ``distributed.sharding.materialize``,
and a cache replicated on heads) and picks the KV head of each of its
query heads (``_local_kv``: query head h reads KV head h // (H/Hkv)).
With context parallelism the decode cache's length is split over "data":
each rank scores its span and the spans are combined by the log-sum-exp
rule (``_cp_attend``); only the rank owning ``pos`` writes the new K/V.
"""

from __future__ import annotations

import torch

from repro_torch.distributed import collectives as coll
from repro_torch.kernels.flash_attention import flash_attention as kflash
from repro_torch.models.layers import (check_write, dense_init, matmul, matmul_f32, out_proj,
                                      rms_norm, rope_apply, rope_freqs, sharder)

NEG_INF = -1e30


def attn_init(gen, cfg, dtype, repeats):
    """Parameters of ``repeats`` stacked attention sublayers."""
    d, h, hk, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    p = {"wq": dense_init(gen, (repeats, d, h * dh), dtype),
         "wk": dense_init(gen, (repeats, d, hk * dh), dtype),
         "wv": dense_init(gen, (repeats, d, hk * dh), dtype),
         "wo": dense_init(gen, (repeats, h * dh, d), dtype)}
    if cfg.qk_norm:
        p["q_norm"] = torch.zeros((repeats, dh), dtype=dtype, device=gen.device)
        p["k_norm"] = torch.zeros((repeats, dh), dtype=dtype, device=gen.device)
    return p


def _positions(B, L, device):
    return torch.arange(L, device=device)[None, :].expand(B, L)


def _qkv(p, x, x_kv, cfg, positions, kv_positions):
    B, L, _ = x.shape
    dh = cfg.head_dim_
    h, hk = p["wq"].shape[-1] // dh, p["wk"].shape[-1] // dh
    q = matmul(x, p["wq"]).reshape(B, L, h, dh)
    k = matmul(x_kv, p["wk"]).reshape(B, x_kv.shape[1], hk, dh)
    v = matmul(x_kv, p["wv"]).reshape(B, x_kv.shape[1], hk, dh)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if positions is not None and cfg.rope_theta > 0:  # NoPE archs skip rotary
        cos, sin = rope_freqs(positions, dh, cfg.rope_theta)
        q = rope_apply(q, cos, sin)
        cos_k, sin_k = rope_freqs(kv_positions, dh, cfg.rope_theta)
        k = rope_apply(k, cos_k, sin_k)
    return q, k, v


def _local_kv(q, k, v, cfg):
    """K/V heads grouped for this rank's query heads: as they are where
    they group evenly (one rank, or whole KV heads a rank), else the KV
    head of each query head, picked from all of them."""
    h, hk = q.shape[2], k.shape[2]
    G = cfg.n_heads // cfg.n_kv_heads
    if hk * G == h:
        return k, v
    r = sharder().model_rank
    idx = torch.tensor([(r * h + j) // G for j in range(h)], device=k.device)
    return k.index_select(2, idx), v.index_select(2, idx)


def _gqa_scores(q, k, cfg):
    """(B,L,H,dh)×(B,S,Hk,dh) → (B,Hk,G,L,S) grouped scores, fp32: one
    batched product over (B, Hk) of the group's (G·L, dh) queries."""
    B, L, h, dh = q.shape
    hk, S = k.shape[2], k.shape[1]
    g = h // hk
    qg = q.reshape(B, L, hk, g, dh).permute(0, 2, 3, 1, 4).reshape(B * hk, g * L, dh)
    kt = k.permute(0, 2, 3, 1).reshape(B * hk, dh, S)
    return matmul_f32(qg, kt).reshape(B, hk, g, L, S) * (dh**-0.5)


def _gqa_out(probs, v, cfg, dtype):
    B, hk, g, L, S = probs.shape
    dh = v.shape[-1]
    pv = probs.to(dtype).reshape(B * hk, g * L, S)
    vv = v.permute(0, 2, 1, 3).reshape(B * hk, S, dh)
    out = matmul_f32(pv, vv, out_dtype=dtype).reshape(B, hk, g, L, dh)
    return out.permute(0, 3, 1, 2, 4).reshape(B, L, hk * g * dh)


def full_attention(p, x, cfg, *, causal=True, window=0, x_kv=None, positions=None,
                   kv_positions=None, rope=True):
    """Prefill attention with a full masked softmax; window>0 adds a band
    mask. ``x_kv`` (B, S, D): keys and values from another sequence
    (cross-attention), else from ``x``. ``rope``: rotate queries and keys
    by their positions (``positions``, default 0..L-1; ``kv_positions``,
    default ``positions``); cross-attention passes False, as the JAX
    package rotates only when ``x_kv is x``."""
    x_kv = x if x_kv is None else x_kv
    B, L, _ = x.shape
    S = x_kv.shape[1]
    if not rope:
        positions = kv_positions = None
    elif positions is None and cfg.rope_theta > 0:
        positions = _positions(B, L, x.device)
    q, k, v = _qkv(p, x, x_kv, cfg, positions,
                   positions if kv_positions is None else kv_positions)
    k, v = _local_kv(q, k, v, cfg)
    scores = _gqa_scores(q, k, cfg)
    qi = torch.arange(L, device=x.device)[:, None]
    kj = torch.arange(S, device=x.device)[None, :]
    mask = torch.zeros((L, S), dtype=torch.bool, device=x.device)
    if causal:
        mask |= kj > qi
    if window:
        mask |= kj <= qi - window
    scores = scores.masked_fill(mask, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = _gqa_out(probs, v, cfg, x.dtype)
    return out_proj(out, p["wo"], cfg.n_heads * cfg.head_dim_)


def banded_attention(p, x, cfg, *, window, positions=None):
    """O(L·W) local causal attention: queries in blocks of W attend to their
    own and the previous key block. Needs L % W == 0 (the JAX package
    asserts it; the launcher pads)."""
    B, L, _ = x.shape
    W = window
    if L % W:
        raise ValueError(f"banded_attention needs L % window == 0: L {L}, window {W}")
    nb = L // W
    if positions is None:
        positions = _positions(B, L, x.device)
    q, k, v = _qkv(p, x, x, cfg, positions, positions)
    k, v = _local_kv(q, k, v, cfg)
    h, hk, dh = q.shape[2], k.shape[2], cfg.head_dim_
    g = h // hk
    kb = k.reshape(B, nb, W, hk, dh)
    vb = v.reshape(B, nb, W, hk, dh)
    k2 = torch.cat([torch.cat([torch.zeros_like(kb[:, :1]), kb[:, :-1]], dim=1), kb], dim=2)
    v2 = torch.cat([torch.cat([torch.zeros_like(vb[:, :1]), vb[:, :-1]], dim=1), vb], dim=2)
    # one batched product over (B, block, kv head) of the group's (g·W, dh) queries
    qg = q.reshape(B, nb, W, hk, g, dh).permute(0, 1, 3, 4, 2, 5).reshape(B * nb * hk, g * W, dh)
    kt = k2.permute(0, 1, 3, 4, 2).reshape(B * nb * hk, dh, 2 * W)
    scores = (matmul_f32(qg, kt) * (dh**-0.5)).reshape(B, nb, hk, g, W, 2 * W)
    qi = torch.arange(W, device=x.device)[:, None] + W          # position in the 2W window
    kj = torch.arange(2 * W, device=x.device)[None, :]
    mask = (kj > qi) | (kj <= qi - W)                            # causal and band
    first = (torch.arange(nb, device=x.device) == 0)[:, None, None]   # block 0: no previous
    m = torch.where(first, (mask | (kj < W))[None], mask[None])  # (nb, W, 2W)
    scores = scores.masked_fill(m[None, :, None, None], NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    pv = probs.to(x.dtype).reshape(B * nb * hk, g * W, 2 * W)
    vv = v2.permute(0, 1, 3, 2, 4).reshape(B * nb * hk, 2 * W, dh)
    out = matmul_f32(pv, vv, out_dtype=x.dtype).reshape(B, nb, hk, g, W, dh)
    out = out.permute(0, 1, 4, 2, 3, 5).reshape(B, L, h * dh)
    return out_proj(out, p["wo"], cfg.n_heads * cfg.head_dim_)


def flash_attention(p, x, cfg, *, causal=True, window=0, positions=None, q_chunk=1024,
                    kv_chunk=1024):
    """Memory-bounded attention in torch: an online softmax over key chunks
    for each query chunk, every key chunk visited as in the JAX package's
    scan (a fully masked one is cancelled by the next correction), so
    O(q_chunk·kv_chunk) score memory instead of O(L²)."""
    B, L, _ = x.shape
    q_chunk, kv_chunk = min(q_chunk, L), min(kv_chunk, L)
    if L % q_chunk or L % kv_chunk:
        raise ValueError(f"flash_attention needs L % chunk == 0: L {L}, chunks "
                         f"{q_chunk}, {kv_chunk}")
    if positions is None:
        positions = _positions(B, L, x.device)
    q, k, v = _qkv(p, x, x, cfg, positions, positions)
    k, v = _local_kv(q, k, v, cfg)
    h, hk, dh = q.shape[2], k.shape[2], cfg.head_dim_
    g = h // hk
    dev = x.device
    outs = []
    for qi in range(L // q_chunk):
        qb = q[:, qi * q_chunk:(qi + 1) * q_chunk].reshape(B, q_chunk, hk, g, dh)
        qb = qb.permute(0, 2, 3, 1, 4).reshape(B * hk, g * q_chunk, dh)
        # f32-ok: the blocked path's online-softmax row max, sum and output
        m = torch.full((B, hk, g, q_chunk), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((B, hk, g, q_chunk), dtype=torch.float32, device=dev)  # f32-ok
        acc = torch.zeros((B, hk, g, q_chunk, dh), dtype=torch.float32, device=dev)  # f32-ok
        qpos = qi * q_chunk + torch.arange(q_chunk, device=dev)[:, None]
        for kj in range(L // kv_chunk):
            sl = slice(kj * kv_chunk, (kj + 1) * kv_chunk)
            kt = k[:, sl].permute(0, 2, 3, 1).reshape(B * hk, dh, kv_chunk)
            s = (matmul_f32(qb, kt) * (dh**-0.5)).reshape(B, hk, g, q_chunk, kv_chunk)
            kpos = kj * kv_chunk + torch.arange(kv_chunk, device=dev)[None, :]
            bad = torch.zeros((q_chunk, kv_chunk), dtype=torch.bool, device=dev)
            if causal:
                bad |= kpos > qpos
            if window:
                bad |= kpos <= qpos - window
            s = s.masked_fill(bad, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p_ = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p_.sum(dim=-1)
            vv = v[:, sl].permute(0, 2, 1, 3).reshape(B * hk, kv_chunk, dh)
            pv = matmul_f32(p_.to(x.dtype).reshape(B * hk, g * q_chunk, kv_chunk), vv)
            acc = acc * corr[..., None] + pv.reshape(B, hk, g, q_chunk, dh)
            m = m_new
        out = acc / torch.clamp_min(l, 1e-30)[..., None]
        outs.append(out.permute(0, 3, 1, 2, 4).reshape(B, q_chunk, h * dh))
    out = torch.cat(outs, dim=1).to(x.dtype)
    return out_proj(out, p["wo"], cfg.n_heads * cfg.head_dim_)


def use_flash(cfg, L: int) -> bool:
    """Dispatch predicate for the flash path: opt-in via
    ``cfg.flash_min_len`` and only worth the kernel launch above it."""
    return cfg.flash_min_len > 0 and L >= cfg.flash_min_len


def kernel_flash_attention(p, x, cfg, *, causal=True, window=0, positions=None):
    """Causal self-attention through the flash kernels (``flash_mha``, the
    autograd Function over ``flash_fwd`` and the backward pair): the train
    and prefill hot path above ``cfg.flash_min_len``. Sliding windows and
    GQA are handled in the kernels, any L without padding. Under
    ``torch.no_grad`` (serving) only the forward kernel runs."""
    B, L, _ = x.shape
    if positions is None and cfg.rope_theta > 0:
        positions = _positions(B, L, x.device)
    q, k, v = _qkv(p, x, x, cfg, positions, positions)
    k, v = _local_kv(q, k, v, cfg)
    h, dh = q.shape[2], cfg.head_dim_
    o = kflash.flash_mha(
        q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
        v.transpose(1, 2).contiguous(), causal=causal, window=window)
    out = o.transpose(1, 2).reshape(B, L, h * dh)
    return out_proj(out.to(x.dtype), p["wo"], cfg.n_heads * cfg.head_dim_)


# ------------------------------------------------------------- decoding ----
def decode_attention(p, x, cfg, cache, pos, *, window=0, active=None):
    """One-token decode: x (B,1,D); cache {"k","v"}: (B, S, Hk, dh).

    ``pos (B,)`` is the per-row cache write position. Writes the new K/V at
    ``pos[b]`` then attends over the first pos[b]+1 entries (masked). For
    local layers only the last ``window`` positions score.

    The cache is updated IN PLACE (the JAX package returns a new one): a
    functional copy would move the whole cache every token. The returned
    dict holds the same tensors. ``active (B,) bool``: rows with False keep
    their cache bit-identical — where the JAX package drops an
    out-of-bounds scatter, the port writes each row's old entry back, a
    masked index write (torch has no ``mode="drop"``)."""
    B = x.shape[0]
    S = cache["k"].shape[1]
    sh = sharder()
    cp = sh is not None and sh.context_parallel
    start = sh.cache_span(S * sh.data.size)[0] if cp else 0   # this rank's span of the cache
    positions = pos[:, None]                         # (B, 1)
    q, k_new, v_new = _qkv(p, x, x, cfg, positions, positions)
    for name, new in (("k", k_new), ("v", v_new)):
        c = cache[name]
        check_write(f"decode {name}", new[:, 0], (c.shape[0],) + tuple(c.shape[2:]))
    rows = torch.arange(B, device=x.device)
    if active is None and not cp:
        cache["k"][rows, pos] = k_new[:, 0].to(cache["k"].dtype)
        cache["v"][rows, pos] = v_new[:, 0].to(cache["v"].dtype)
    else:                        # inactive rows, and positions off this rank's span, keep theirs
        lp = pos - start
        live = ((lp >= 0) & (lp < S))[:, None, None]
        if active is not None:
            live = live & active[:, None, None]
        wpos = lp.clamp(0, S - 1)
        for name, new in (("k", k_new), ("v", v_new)):
            c = cache[name]
            c[rows, wpos] = torch.where(live, new[:, 0].to(c.dtype), c[rows, wpos])
    k, v = _local_kv(q, cache["k"], cache["v"], cfg)
    scores = _gqa_scores(q, k, cfg)                  # (B,hk,g,1,S)
    kj = start + torch.arange(S, device=x.device)[None, :]
    invalid = kj > positions                         # (B, S)
    if window:
        invalid |= kj <= positions - window
    scores = scores.masked_fill(invalid[:, None, None, None, :], NEG_INF)
    if cp:
        out = _cp_attend(scores, v, x.dtype, sh.data)
    else:
        out = _gqa_out(torch.softmax(scores, dim=-1), v, cfg, x.dtype)
    return out_proj(out, p["wo"], cfg.n_heads * cfg.head_dim_), cache


def _cp_attend(scores, v, dtype, data):
    """Softmax · V over a cache split by length over ``data``: the row max
    by pmax, Σexp by psum, then each span's probabilities (rounded to
    ``dtype`` as the one-rank path rounds them) times its V, summed in f32
    over the spans and rounded once."""
    m = coll.pmax(scores.amax(dim=-1), data, role="cp_combine")
    e = torch.exp(scores - m[..., None])
    den = coll.psum(e.sum(dim=-1), data, role="cp_combine")
    probs = e / den[..., None]
    B, hk, g, L, S = probs.shape
    dh = v.shape[-1]
    pv = matmul_f32(probs.to(dtype).reshape(B * hk, g * L, S),
                    v.permute(0, 2, 1, 3).reshape(B * hk, S, dh))
    out = coll.psum(pv, data, role="cp_combine").to(dtype).reshape(B, hk, g, L, dh)
    return out.permute(0, 3, 1, 2, 4).reshape(B, L, hk * g * dh)


def verify_attention(p, x, cfg, cache, pos, *, window=0, active=None):
    """Multi-token verify step (speculative decoding): x (B, W, D) is the
    current token + the draft's proposals, W = k+1.

    Writes the W new K/V rows at ``pos[b] .. pos[b]+W-1``, then every query
    position i attends over the first ``pos[b]+i+1`` cache entries (window
    mask as in decode), so logits[:, i] are those of sequential decode after
    consuming tokens 0..i. Rejected suffixes need no erasure: the caller
    rolls ``pos`` back and the stale rows beyond it are never attended.

    The cache is updated in place. A write is dropped (the JAX package's
    ``mode="drop"``) where its row is inactive or its position is past the
    cache end S. Dropped pairs are not clamped (several would land on S-1,
    and ``index_put_`` with repeated indices has no defined order on the
    card), nor filtered out (a data-dependent count would sync the host):
    position ``pos+i`` goes to ``(pos+i) mod S``, distinct within a row
    for W <= S, and a dropped pair's slot gets its own value back. Past the
    end that slot is ``pos+i-S < pos``, below every live write of the row."""
    B, W, _ = x.shape
    S = cache["k"].shape[1]
    if W > S:
        raise ValueError(f"verify width {W} exceeds the cache length {S}")
    positions = pos[:, None] + torch.arange(W, device=x.device)[None, :]   # (B, W)
    q, k_new, v_new = _qkv(p, x, x, cfg, positions, positions)
    live = positions < S
    if active is not None:
        live &= active[:, None]
    rows = torch.arange(B, device=x.device)[:, None].expand(B, W)
    wpos = positions % S
    for name, new in (("k", k_new), ("v", v_new)):
        c = cache[name]
        check_write(f"verify {name}", new, (c.shape[0], W) + tuple(c.shape[2:]))
        c[rows, wpos] = torch.where(live[..., None, None], new.to(c.dtype), c[rows, wpos])
    scores = _gqa_scores(q, cache["k"], cfg)         # (B,hk,g,W,S)
    kj = torch.arange(S, device=x.device)[None, None, :]
    invalid = kj > positions[:, :, None]             # (B, W, S) per query
    if window:
        invalid |= kj <= positions[:, :, None] - window
    scores = scores.masked_fill(invalid[:, None, None], NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = _gqa_out(probs, cache["v"], cfg, x.dtype)
    return out_proj(out, p["wo"], cfg.n_heads * cfg.head_dim_), cache


def cross_kv(p, memory, cfg):
    """Cross-attention K/V of the encoder's memory (B, F, D), computed once
    at prefill: {"k", "v"} (B, F, Hk, dh), no rotary embedding."""
    B, F, _ = memory.shape
    dh = cfg.head_dim_
    hk = p["wk"].shape[-1] // dh                     # this rank's heads on a grid
    k = matmul(memory, p["wk"]).reshape(B, F, hk, dh)
    v = matmul(memory, p["wv"]).reshape(B, F, hk, dh)
    if cfg.qk_norm:
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    return {"k": k, "v": v}


def cross_decode(p, x, cfg, cache):
    """Cross-attention of x (B, L, D) against the cached memory K/V, no
    rotary embedding and no mask (every query sees the whole memory), so
    it takes any L: one decode token or a verify step's k+1."""
    B, L, _ = x.shape
    dh = cfg.head_dim_
    q = matmul(x, p["wq"]).reshape(B, L, p["wq"].shape[-1] // dh, dh)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
    k, v = _local_kv(q, cache["k"], cache["v"], cfg)
    probs = torch.softmax(_gqa_scores(q, k, cfg), dim=-1)
    out = _gqa_out(probs, v, cfg, x.dtype)
    return out_proj(out, p["wo"], cfg.n_heads * cfg.head_dim_)


def init_kv_cache(cfg, batch, seq_len, dtype, device, repeats):
    """Zero K/V caches for ``repeats`` stacked layers: (R, B, S, Hk, dh); on
    a grid this rank's KV heads and, with context parallelism, its span."""
    hk, sh = cfg.n_kv_heads, sharder()
    if sh is not None:
        seq_len, hk = sh.cache_span(seq_len)[1], sh.local_size(hk)
    shape = (repeats, batch, seq_len, hk, cfg.head_dim_)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}

"""Plain PyTorch version of the fused Collage-AdamW bucket update: the port
of ``repro.kernels.collage_update.ref.collage_bucket_update_ref``, with its
signature and returns.

It is the CPU path of ``collage_update.collage_bucket_update`` and the
version the CUDA kernel is held against on the card, bit for bit. Every
f32 operation is a separate eager PyTorch op, rounded on its own (no FMA
contraction), and every bf16 rounding is ``x.to(bfloat16).float()``, so on
the CPU it is bit-identical to the JAX package's EAGER ref (the jitted ref
may contract a multiply-add on XLA's CPU backend and drift by one ulp).

Scalars arrive as host floats (f32 values); the constants derived from
``b1``/``b2``/``wd`` are rounded exactly as the JAX code rounds them
(``update_constants``), and the kernel wrapper passes the same ones.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import bucketing, mcf
from repro_torch.core.mcf import Expansion
from repro_torch.kernels.collage_update.collage_update import (BLOCK_ROWS, LANES,
                                                               choose_block_rows, state_fields)

F32 = torch.float32


def _rn(x):
    return x.to(torch.bfloat16).to(F32)


def _rn_host(x) -> float:
    """bf16 round-to-nearest-even of a host f32 value."""
    return float(torch.tensor(np.float32(x), dtype=F32).to(torch.bfloat16).to(F32))


def update_constants(b1, b2, eps, wd, pt_decay, lr) -> dict:
    """Host f32 constants of one update, rounded as the JAX code rounds them:
    ``f32(b1)``, ``f32(1 - b1)`` (the difference taken in double), their bf16
    roundings, ``b2``'s bf16 expansion, eps, the fused decay term, and the
    pt-decay factor ``rn(1 - lr·f32(wd))``."""
    f32 = np.float32
    b2_32 = f32(b2)
    b2hi = _rn_host(b2_32)
    return {
        "b1": float(f32(b1)), "c1": float(f32(1.0 - b1)),
        "b2": float(b2_32), "c2": float(f32(1.0 - b2)),
        "cb1": _rn_host(b1), "c1m": _rn_host(1.0 - b1),
        "cb2": _rn_host(b2), "c2m": _rn_host(1.0 - b2),
        "b2hi": b2hi, "b2lo": _rn_host(b2_32 - f32(b2hi)),
        "eps": float(f32(eps)), "wd_upd": 0.0 if pt_decay else float(f32(wd)),
        "factor": _rn_host(f32(1.0) - f32(lr) * f32(wd)),
    }


def _f(x, like):
    """A host f32 scalar as a 0-dim f32 tensor (exact) on ``like``'s device."""
    return torch.tensor(x, dtype=F32, device=like.device)


def collage_bucket_update_plain(state: dict, g, lr, bc1, bc2, seed=None, elem_offset=None, *,
                                b1=0.9, b2=0.999, eps=1e-8, wd=0.0, strategy="C",
                                pt_decay=False, compute_metrics=False,
                                block_rows=BLOCK_ROWS, tiled_metrics=True, return_tiles=False):
    """Update of ONE flat bucket. ``state`` maps the strategy's fields
    (``state_fields``) to 1-D tensors of length N (N % 128 == 0). Returns
    ``(new_state, partials)``: partials is the 5-tuple of f32 0-dim tensors
    (⟨Δθ,Δθ̂⟩, ‖Δθ‖², ‖Δθ̂‖², #lost, ‖g‖²) or None. ``tiled_metrics`` mirrors
    the kernel's per-tile ``det_sum`` partials bit for bit; False uses plain
    ``torch.sum`` (equal up to summation order). ``return_tiles``: partials
    is the kernel's per-tile (tiles, 5) f32 partials instead, before the sum
    over the tiles (a bucket updated in chunks of whole tiles gives the
    whole bucket's tiles, concatenated)."""
    fields = state_fields(strategy)
    if set(state) != set(fields):
        raise ValueError(f"state fields {sorted(state)} vs {fields}")
    n = g.shape[0]
    if n % LANES:
        raise ValueError(f"bucket length {n} is not a multiple of {LANES}")
    c = update_constants(b1, b2, eps, wd, pt_decay, lr)
    lr_t, bc1_t, bc2_t = _f(float(np.float32(lr)), g), _f(float(np.float32(bc1)), g), \
        _f(float(np.float32(bc2)), g)
    k = {name: _f(v, g) for name, v in c.items()}

    theta32 = state["theta"].to(F32)
    m = state["m"].to(F32)
    vhi = state["vhi"].to(F32)
    g32 = g.to(F32)
    new = {}

    if strategy in ("D-", "D"):
        m_new = k["b1"] * m + k["c1"] * g32
        v_new = k["b2"] * vhi + k["c2"] * g32 * g32
        mhat = m_new / bc1_t
        vhat = v_new / bc2_t
        if strategy == "D":
            w = state["master"]
            upd32 = -lr_t * (mhat / (mcf.sqrt_rn(vhat) + k["eps"]) + k["wd_upd"] * w)
            w_new = w + upd32
            new["theta"] = w_new.to(torch.bfloat16)
            new["master"] = w_new
        else:
            upd32 = -lr_t * (mhat / (mcf.sqrt_rn(vhat) + k["eps"]) + k["wd_upd"] * theta32)
            new["theta"] = (theta32 + _rn(upd32)).to(torch.bfloat16)
        eff = new["theta"].to(F32) - theta32
        new["m"], new["vhi"] = m_new, v_new
    else:
        # each stored value rounded once to bf16, widened where it is read
        new["m"] = (_rn(k["cb1"] * m) + _rn(k["c1m"] * g32)).to(torch.bfloat16)
        m32 = new["m"].to(F32)
        g2 = _rn(g32 * g32)
        if strategy == "C":
            b2e = mcf.from_float(c["b2"], torch.bfloat16, device=g.device)
            v = mcf.grow(mcf.mul(b2e, Expansion(state["vhi"], state["vlo"])),
                         (k["c2m"] * g2).to(torch.bfloat16))
            new["vhi"], new["vlo"] = v.hi, v.lo
            vhat = v.value(F32) / bc2_t
        else:
            new["vhi"] = (_rn(k["cb2"] * vhi) + _rn(k["c2m"] * g2)).to(torch.bfloat16)
            vhat = new["vhi"].to(F32) / bc2_t
        mhat = m32 / bc1_t
        upd32 = -lr_t * (mhat / (mcf.sqrt_rn(vhat) + k["eps"]) + k["wd_upd"] * theta32)
        upd_b = upd32.to(torch.bfloat16)
        upd16 = upd_b.to(F32)

        if strategy == "A":
            base = _rn(theta32 * k["factor"]) if pt_decay else theta32
            new["theta"] = (base + upd16).to(torch.bfloat16)
            eff = new["theta"].to(F32) - theta32
        elif strategy == "SR":
            if seed is None:
                raise ValueError("SR needs a seed")
            idx = torch.arange(n, dtype=torch.int64, device=g.device)
            if elem_offset is not None:
                idx = (idx + int(elem_offset)) & bucketing.MASK32
            noise = bucketing.sr_noise_bits(idx, int(seed))
            new_p32 = bucketing.stochastic_round_bits(theta32 + upd32, noise)
            eff = new_p32 - theta32
            new["theta"] = new_p32.to(torch.bfloat16)
        elif strategy == "KAHAN":
            cc = state["delta"].to(F32)
            upd_c = _rn(upd16 + cc)
            new["theta"] = (theta32 + upd_c).to(torch.bfloat16)
            new_p32 = new["theta"].to(F32)
            new["delta"] = (upd_c - _rn(new_p32 - theta32)).to(torch.bfloat16)
            eff = new_p32 - theta32
        else:  # B / C: Grow Δθ into the (θ, δθ) expansion
            e = mcf.grow(Expansion(state["theta"], state["delta"]), upd_b)
            eff = (e.hi.to(F32) - theta32) + (e.lo.to(F32) - state["delta"].to(F32))
            new["theta"], new["delta"] = e.hi, e.lo

    partials = None
    if compute_metrics and return_tiles:
        partials = metric_tiles(upd32, eff, g32, block_rows)
    elif compute_metrics:
        partials = metric_partials(upd32, eff, g32, block_rows) if tiled_metrics \
            else metric_partials_fast(upd32, eff, g32)
    return new, partials


def _metric_values(u, e, g32):
    lost = ((u.abs() > 0) & (e == 0)).to(F32)
    return (u * e, u * u, e * e, lost, g32 * g32)


def metric_partials_fast(u, e, g32):
    return tuple(torch.sum(x) for x in _metric_values(u, e, g32))


def metric_tiles(u, e, g32, block_rows=BLOCK_ROWS):
    """Per-tile ``det_sum`` over the kernel's (br, 128) tiles → (tiles, 5)."""
    rows = u.shape[0] // LANES
    br = choose_block_rows(rows, block_rows)
    grid = rows // br
    return torch.stack([bucketing.det_sum(x.reshape(grid, br * LANES), dim=1)
                        for x in _metric_values(u, e, g32)], dim=1)


def metric_partials(u, e, g32, block_rows=BLOCK_ROWS):
    """Per-tile ``det_sum`` over the kernel's (br, 128) tiles, then
    ``det_sum`` over the tiles in order: the kernel's partials bit for bit."""
    sums = bucketing.det_sum(metric_tiles(u, e, g32, block_rows), dim=0)
    return tuple(sums[i] for i in range(5))

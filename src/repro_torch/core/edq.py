"""Effective Descent Quality (Paper Def. 3.3) and imprecision diagnostics,
the port of ``repro.core.edq``.

Trees are nested dicts/lists of tensors (leaves in ``jax.tree_util``'s
order). ``edq`` and ``imprecision_pct`` sum the raw partials leaf by leaf
through ``kernels.edq.edq_partials``: the CUDA kernel on the card, its
plain version on the CPU.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.core import bucketing
from repro_torch.core.mcf import Expansion, ulp
from repro_torch.kernels.edq import edq as kedq

F32 = torch.float32  # f32-ok: EDQ metrics are f32 sums


def effective_update(theta_old: Any, theta_new: Any) -> Any:
    """Δθ̂ (Eq. 2): the change of the stored representation, in f32. For
    Expansion leaves the stored value is hi + lo, taken componentwise (each
    difference is f32-exact; evaluating hi + lo first would round tiny
    residuals away)."""

    def leaf(o, n):
        if isinstance(o, Expansion):
            return (n.hi.to(F32) - o.hi.to(F32)) + (n.lo.to(F32) - o.lo.to(F32))
        return n.to(F32) - o.to(F32)

    return bucketing.tree_map(leaf, theta_old, theta_new)


def _partials(update: Any, effective: Any, atol: float = 0.0):
    """Σ over leaves of the raw (⟨u,e⟩, ‖u‖², ‖e‖², #lost), and the count of
    elements."""
    leaves_u, leaves_e = bucketing.tree_leaves(update), bucketing.tree_leaves(effective)
    total = None
    for u, e in zip(leaves_u, leaves_e):
        p = kedq.edq_partials(u.to(F32).reshape(-1), e.to(F32).reshape(-1), atol)
        total = p if total is None else total + p
    return total, sum(u.numel() for u in leaves_u)


def edq(update: Any, effective: Any) -> torch.Tensor:
    """EDQ = ⟨Δθ/‖Δθ‖, Δθ̂⟩ over the full parameter vector (Eq. 3): ‖Δθ‖
    exactly when nothing is lost, smaller when rounding bites."""
    p, _ = _partials(update, effective)
    return p[0] / torch.clamp_min(torch.sqrt(p[1]), 1e-30)


def imprecision_pct(update: Any, effective: Any, atol: float = 0.0) -> torch.Tensor:
    """Percentage of parameters whose intended update was entirely lost
    (Fig. 3 left): |Δθ| > atol but Δθ̂ == 0."""
    p, n = _partials(update, effective, atol)
    return 100.0 * p[3] / n


def lost_arithmetic_mask(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Def. 3.2 detector for a ⊕ b in a's dtype: |b| ≤ ulp(a)/2 ⇒ a ⊕ b = a."""
    return b.to(F32).abs() <= ulp(a) / 2

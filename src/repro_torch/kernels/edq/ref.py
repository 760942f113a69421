"""Plain PyTorch version of the EDQ metric partials: the CPU path of
``edq.edq_partials`` and the version the CUDA kernel is held against on the
card (up to f32 summation order)."""

from __future__ import annotations

import torch

F32 = torch.float32


def edq_partials_plain(u: torch.Tensor, e: torch.Tensor, atol: float = 0.0) -> torch.Tensor:
    """(⟨u,e⟩, ‖u‖², ‖e‖², #(|u| > atol ∧ e == 0)) of two f32 vectors, as a
    (4,) f32 tensor: the JAX kernel's per-block sums over the whole input.
    The lost count is counted in int64 and rounded once to f32, as the
    kernel rounds it."""
    u32, e32 = u.to(F32), e.to(F32)
    lost = ((u32.abs() > atol) & (e32 == 0)).sum().to(F32)
    return torch.stack([torch.sum(u32 * e32), torch.sum(u32 * u32), torch.sum(e32 * e32),
                        lost])

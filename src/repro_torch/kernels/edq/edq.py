"""EDQ metric partials (Paper Def. 3.3 diagnostics): the wrapper of the
Hopper CUDA kernel, the port of ``repro.kernels.edq.edq``.

``edq_partials(u, e)`` reads Δθ and Δθ̂ (1-D f32, any length ≥ 1) once and
returns the raw sums (⟨u,e⟩, ‖u‖², ‖e‖², #lost) as a (4,) f32 tensor; the
kernel writes one row of partials per block and a second one-block launch
sums the columns, as the JAX wrapper sums ``partials[:, i]`` (here in f64,
rounded once, so that the lost count stays exact past 2^24 elements). ``edq_metrics``
finalizes them as the JAX ``edq_metrics`` does. On a CUDA tensor the
wrapper launches ``csrc/edq/edq.cu`` (built on first use) or raises; on a
CPU tensor it runs the plain version ``ref.edq_partials_plain``; on a
meta tensor (a dry run) it returns the kernel's empty output and runs
nothing. Nothing else selects the path. ``edq_partials.launches`` counts
kernel launches, ``edq_partials.meta_calls`` meta calls.
"""

from __future__ import annotations

import ctypes

import torch

TILE = 16384          # elements per block of the kernel
KERNEL_SOURCE = "edq/edq.cu"


def _library():
    from repro_torch.kernels import build

    lib = build.load(KERNEL_SOURCE)
    fn = lib.edq_partials
    # u, e, partials, out; n, grid; atol; stream
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 2 + [ctypes.c_float,
                                                                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.edq_error_string.argtypes = [ctypes.c_int]
    lib.edq_error_string.restype = ctypes.c_char_p
    return lib


def _check(u, e):
    if u.dtype != torch.float32 or e.dtype != torch.float32:
        raise TypeError(f"edq_partials takes f32 inputs, got {u.dtype} and {e.dtype}")
    if u.dim() != 1 or u.shape != e.shape or u.numel() < 1:
        raise ValueError(f"edq_partials takes two 1-D inputs of one length >= 1: "
                         f"{tuple(u.shape)} and {tuple(e.shape)}")
    if u.device != e.device:
        raise ValueError(f"inputs on {u.device} and {e.device}")
    if not (u.is_contiguous() and e.is_contiguous()):
        raise ValueError("edq_partials takes contiguous inputs")


def edq_partials(u: torch.Tensor, e: torch.Tensor, atol: float = 0.0) -> torch.Tensor:
    """(⟨u,e⟩, ‖u‖², ‖e‖², #(|u| > atol ∧ e == 0)) as a (4,) f32 tensor on
    the inputs' device. The kernel takes the length as a 64-bit integer."""
    from repro_torch.kernels.edq import ref

    _check(u, e)
    if u.device.type == "cpu":
        return ref.edq_partials_plain(u, e, atol)
    if u.device.type not in ("cuda", "meta"):
        raise ValueError(f"edq_partials: unsupported device {u.device}")
    n = u.numel()
    grid = -(-n // TILE)
    partials = torch.empty((grid, 4), dtype=torch.float32, device=u.device)
    out = torch.empty((4,), dtype=torch.float32, device=u.device)
    if u.device.type == "meta":         # a dry run: the kernel's output, nothing run
        edq_partials.meta_calls += 1
        return out
    lib = _library()
    stream = torch.cuda.current_stream(u.device).cuda_stream
    err = lib.edq_partials(u.data_ptr(), e.data_ptr(), partials.data_ptr(), out.data_ptr(),
                           n, grid, float(atol), stream)
    if err != 0:
        msg = lib.edq_error_string(err).decode()
        raise build.KernelLaunchError(f"edq kernel launch failed: {msg} (cudaError {err})")
    edq_partials.launches += 1
    return out


edq_partials.launches = 0
edq_partials.meta_calls = 0


def finalize(partials: torch.Tensor, n: int) -> dict:
    """Raw sums → {edq, update_norm, effective_norm, imprecision_pct}, as
    the JAX ``edq_metrics`` finalizes them."""
    dot, un2, en2, lost = partials.unbind()
    un = torch.sqrt(un2)
    return {"edq": dot / torch.clamp_min(un, 1e-30), "update_norm": un,
            "effective_norm": torch.sqrt(en2), "imprecision_pct": 100.0 * lost / n}


def edq_metrics(u: torch.Tensor, e: torch.Tensor) -> dict:
    """EDQ, ‖Δθ‖, ‖Δθ̂‖ and imprecision % of one flat update pair."""
    return finalize(edq_partials(u, e), u.numel())

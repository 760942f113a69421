"""Buffer liveness: the step's peak device memory, the port of
``repro.analysis.liveness.peak_hbm``.

``peak_bytes_modeled`` sweeps the trace's storage intervals (``analysis.
trace``): a storage holds its bytes from the op that allocated it (the
step's inputs from the start) to the op at which it was found freed (the
outputs, and inputs the caller still holds, to the end). The sweep counts
only storages on the trace's device. It is a model: it does not see the
allocator's rounding, cuBLAS workspaces or memory held outside the step.

On the card ``peak_bytes_measured`` is what the allocator saw:
``torch.cuda.max_memory_allocated()`` over one step, its counter reset
before the step (``measured_peak``), beside ``held_before_bytes``, what
was allocated when the step began: the step's inputs and whatever else the
process holds (cuBLAS workspaces, earlier tensors), which the model
counts only as far as they are the step's inputs.
"""

from __future__ import annotations

import gc
from typing import Callable

import torch

from repro_torch.analysis.trace import Trace


def peak_hbm(trace: Trace) -> dict:
    """The modelled peak and the inputs' bytes; the measured keys are None
    until a caller on the card fills them in (``measured_peak``). A lean
    trace (``trace.Tally``) carries its peak already."""
    if trace.tally is not None:
        t = trace.tally
        return {"peak_bytes_modeled": int(t.peak), "param_bytes": int(t.param_bytes),
                "end_bytes_modeled": None, "peak_bytes_measured": None,
                "held_before_bytes": None}
    n = len(trace.ops)
    delta = [0] * (n + 1)
    start = param_bytes = 0
    for s in trace.storages:
        if s.device != trace.device:
            continue
        if s.birth < 0:
            start += s.nbytes
            param_bytes += s.nbytes
        else:
            delta[s.birth] += s.nbytes
        if s.death is not None:
            delta[s.death] -= s.nbytes
    live = peak = start
    for i in range(n + 1):
        live += delta[i]
        peak = max(peak, live)
    return {"peak_bytes_modeled": int(peak), "param_bytes": int(param_bytes),
            "end_bytes_modeled": int(live), "peak_bytes_measured": None,
            "held_before_bytes": None}


def measured_peak(fn: Callable[[], object]) -> tuple:
    """Run ``fn()`` on the card with the peak counter reset before it →
    (its result, the peak bytes ``torch.cuda.max_memory_allocated`` saw,
    the bytes allocated when it began). Unreachable objects of earlier
    work are collected first, so their tensors are not in the peak."""
    if not torch.cuda.is_available():
        raise RuntimeError("measured_peak needs a CUDA card")
    gc.collect()
    torch.cuda.synchronize()
    held = int(torch.cuda.memory_allocated())
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, int(torch.cuda.max_memory_allocated()), held

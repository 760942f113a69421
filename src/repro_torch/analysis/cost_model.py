"""Modelled cost of one step on the card, the port of
``repro.analysis.cost_model``.

``overlap_comm`` and ``schedule_cost`` are the JAX package's pure
arithmetic (a single in-order collective channel overlapped with compute;
a pipeline schedule's stats priced under the masked-tick model), copied.

``model_step`` prices one traced eager step (``analysis.trace``) on the
hardware ``HW`` describes. Each aten op costs its roofline time

    t(op) = max(flops / peak rate of its dtype, bytes / memory rate)

with FLOPs from ``torch.utils.flop_counter``'s formulas and bytes its
operands plus its results (each op reads and writes device memory: an
unfused upper bound). Each launch of a hand-written kernel costs its bound
(``kernel_bound``: the formulas ``chip_smoke.py``'s kernel table uses),
and the gradient collectives their wire bytes over NVLink, from
``distributed.collectives``'s census: ``(n − 1)/n`` of the bytes a rank
sends, 0 at one rank. Eager PyTorch runs one op after another on one
stream, so the modelled step is the sum, with no overlap; it leaves out
the host's launch cost, which the measured step time includes.

``HW`` is the H100 SXM data sheet's (dense rates, at the 700 W limit); a
card set below it runs slower, so a report states the card's name and
power limit beside it.
"""

from __future__ import annotations

import subprocess
from typing import Optional

import numpy as np

from repro_torch.analysis.trace import Trace
from repro_torch.kernels.collage_update import collage_update as kcu

HW = {"name": "NVIDIA H100 SXM (data sheet, dense, 700 W)",
      "peak_flops_bf16": 989e12,       # tensor cores; fp16 the same
      "peak_flops_f32": 67e12,         # f32 outside the tensor cores
      "hbm_bw": 3.35e12,
      "nvlink_bw": 450e9,              # per direction
      "hbm_per_card": 80e9}

HBM_BYTES_PER_S = HW["hbm_bw"]
BF16_FLOP_PER_S = HW["peak_flops_bf16"]
F32_FLOP_PER_S = HW["peak_flops_f32"]

# f32 operations per element of the Collage update, strategy C with metrics:
# an upper estimate counted from collage_update.cu (EMAs, Mul/Grow of v,
# the update, Grow of θ, the five metric products and their tree adds).
UPDATE_OPS_PER_ELEM_C = 80


# --------------------------------------------------------------------------
# the kernels' bounds (chip_smoke.py's kernel table reads these too)
# --------------------------------------------------------------------------

def _valid_pairs(L, causal, window):
    q = np.arange(L)[:, None]
    k = np.arange(L)[None, :]
    valid = np.ones((L, L), bool)
    if causal:
        valid &= k <= q
    if window:
        valid &= k > q - window
    return int(valid.sum())


def _bound(nbytes, flops, peak):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def attention_bound_ms(B, H, Hkv, L, dh, causal, window):
    """Least time for the forward: each input read once and each output
    written once over HBM, or the products on the valid (q, k) pairs over
    the bf16 tensor-core peak, whichever is larger."""
    nbytes = 2 * (2 * B * H * L * dh + 2 * B * Hkv * L * dh) + 4 * B * H * L
    flops = 4 * dh * _valid_pairs(L, causal, window) * B * H   # Q·Kᵀ, P·V: 2 flops a MAC
    return _bound(nbytes, flops, BF16_FLOP_PER_S)


def bwd_bound_ms(kernel, B, H, Hkv, L, dh, causal, window):
    """Least time of one backward kernel: reads q, k, v, dO (bf16) and LSE
    (f32) once, and D (f32) once for dK/dV; writes dQ and D, or dK and dV,
    once; 3 products (S, dP, dQ) for dQ (the kernel's second S and dP are
    its own choice, not the function's work), 4 (S, dP, dV, dK) for dK/dV,
    on the valid (q, k) pairs."""
    reads = 2 * (2 * B * H * L * dh + 2 * B * Hkv * L * dh) + 2 * 4 * B * H * L
    writes = 2 * B * H * L * dh if kernel == "dq" else 2 * 2 * B * Hkv * L * dh
    gemms = 3 if kernel == "dq" else 4
    flops = 2 * gemms * dh * _valid_pairs(L, causal, window) * B * H
    return _bound(reads + writes, flops, BF16_FLOP_PER_S)


def bwd_pair_bound_ms(B, H, Hkv, L, dh, causal, window):
    """Least time of the whole backward: q, k, v, dO and LSE read once, dQ,
    dK, dV written once (bf16), the five products once."""
    nbytes = 2 * (2 * B * H * L * dh + 2 * B * Hkv * L * dh) + 4 * B * H * L \
        + 2 * (B * H * L * dh + 2 * B * Hkv * L * dh)
    flops = 2 * 5 * dh * _valid_pairs(L, causal, window) * B * H
    return _bound(nbytes, flops, BF16_FLOP_PER_S)


def update_bound_ms(n, code="C"):
    """Least time of the Collage update of an n-element bucket: the gradient
    and every state field read once and written once (22 B/param for C, the
    count of kernels/collage_update/ops.py), or its f32 operations."""
    nbytes = 2 * n + sum(2 * n * kcu.field_dtype(f, code).itemsize
                         for f in kcu.state_fields(code))
    return _bound(nbytes, UPDATE_OPS_PER_ELEM_C * n, F32_FLOP_PER_S)


def edq_bound_ms(n):
    """Least time of the EDQ partials of n elements: u and e (f32) read once
    (the (grid, 4) output is negligible), or 7 f32 operations a pair."""
    return _bound(2 * 4 * n, 7 * n, F32_FLOP_PER_S)


def kernel_bound(call) -> tuple:
    """(ms, "bytes" | "operations") of one logged kernel launch."""
    a = call.args
    if call.name == "flash_fwd":
        return attention_bound_ms(a["B"], a["H"], a["Hkv"], a["L"], a["dh"], a["causal"],
                                  a["window"])
    if call.name in ("flash_bwd_dq", "flash_bwd_dkv"):
        return bwd_bound_ms("dq" if call.name == "flash_bwd_dq" else "dkv", a["B"], a["H"],
                            a["Hkv"], a["L"], a["dh"], a["causal"], a["window"])
    if call.name == "collage_bucket_update":
        return update_bound_ms(a["n"], a["code"])
    if call.name == "edq_partials":
        return edq_bound_ms(a["n"])
    raise ValueError(f"no bound for kernel {call.name!r}")


# --------------------------------------------------------------------------
# the JAX package's pure arithmetic
# --------------------------------------------------------------------------

def overlap_comm(events, compute_end_s: float) -> dict:
    """Single in-order collective channel overlapped with compute.

    ``events``: [(ready_s, cost_s, key)] in LAUNCH order (the engine
    launches buckets in readiness order, so callers pass them sorted by
    ready time). Each transfer starts when its data is ready AND the
    channel is free: ``start_k = max(ready_k, finish_{k-1})``. The step
    ends when both compute and the last transfer have drained.

    Returns per-key (ready/start/finish) plus the two totals the gate
    compares: ``overlapped_total_s`` (this model) and ``serialized_total_s``
    (the no-overlap baseline — every transfer after compute_end)."""
    per_key = {}
    finish = 0.0
    total_cost = 0.0
    for ready, cost, key in events:
        start = max(float(ready), finish)
        finish = start + float(cost)
        total_cost += float(cost)
        per_key[key] = {"ready_s": float(ready), "start_s": start,
                        "finish_s": finish}
    return {
        "per_key": per_key,
        "overlapped_total_s": max(float(compute_end_s), finish),
        "serialized_total_s": float(compute_end_s) + total_cost,
    }


def schedule_cost(stats: dict, *, fwd_unit_s: float = 1.0,
                  bwd_unit_s: float = 2.0,
                  comm_cost_s: dict | None = None) -> dict:
    """Price a pipeline schedule's stats() dict under the masked-tick model.

    ``fwd_unit_s``/``bwd_unit_s``: one microbatch through one STAGE's layer
    chunk (L/S layers); a tick executes one masked fwd and one masked bwd
    unit of 1/V that size, so ``tick_s = (fwd+bwd)/V`` and bubble ticks
    cost the same as real ones (SPMD lax.scan cannot skip per-device work).
    ``comm_cost_s``: seconds per gradient bucket class (stage/embed/head);
    each class launches at ``comm_ready[class] · tick_s`` in readiness
    order on one channel (:func:`overlap_comm`)."""
    T, M, V = stats["n_ticks"], stats["n_micro"], stats["n_virtual"]
    tick_s = (fwd_unit_s + bwd_unit_s) / V
    compute_s = T * tick_s
    ideal_s = M * (fwd_unit_s + bwd_unit_s)
    out = {
        "name": stats["name"],
        "n_ticks": T,
        "tick_s": tick_s,
        "compute_s": compute_s,
        "ideal_compute_s": ideal_s,
        "bubble_fraction": 1.0 - ideal_s / compute_s,
    }
    if comm_cost_s:
        events = sorted(
            (stats["comm_ready"][k] * tick_s, comm_cost_s[k], k)
            for k in comm_cost_s)
        out["comm"] = overlap_comm(events, compute_s)
    return out


# --------------------------------------------------------------------------
# one traced step
# --------------------------------------------------------------------------

def _peak_flops(dtype: str, hw: dict) -> float:
    return hw["peak_flops_bf16"] if dtype in ("bfloat16", "float16") else hw["peak_flops_f32"]


def model_step(trace: Trace, census: Optional[list] = None, n_dp: int = 1) -> dict:
    """The modelled time of the traced step (seconds) on ``HW`` and what
    bounds it. ``census``: the ``distributed.collectives.CENSUS`` records
    of the step; ``n_dp``: the ranks they went to."""
    hw = HW
    compute = memory = ops_s = 0.0
    by = {"operations": 0.0, "bytes": 0.0}
    flops_bf16 = flops_f32 = 0.0
    n_bytes = 0
    for op in trace.ops:
        if op.device != trace.device:
            continue
        dt = op.ins[0][0] if op.ins else (op.outs[0][0] if op.outs else "float32")
        t_c = op.flops / _peak_flops(dt, hw)
        t_m = op.nbytes / hw["hbm_bw"]
        compute += t_c
        memory += t_m
        n_bytes += op.nbytes
        if dt in ("bfloat16", "float16"):
            flops_bf16 += op.flops
        else:
            flops_f32 += op.flops
        ops_s += max(t_c, t_m)
        by["operations" if t_c > t_m else "bytes"] += max(t_c, t_m)
    kernels_s = 0.0
    kernel_ms: dict = {}
    for call in trace.kernels:
        ms, _ = kernel_bound(call)
        kernels_s += ms * 1e-3
        kernel_ms[call.name] = kernel_ms.get(call.name, 0.0) + ms
    wire = sum(r["bytes"] for r in (census or ())) * (n_dp - 1) / n_dp
    collective = wire / hw["nvlink_bw"]
    modeled = ops_s + kernels_s + collective
    terms = {"aten ops, operations": by["operations"], "aten ops, bytes": by["bytes"],
             "kernels": kernels_s, "collectives": collective}
    return {
        "hw": hw["name"],
        "flops": flops_bf16 + flops_f32,
        "flops_bf16": flops_bf16,
        "flops_f32": flops_f32,
        "bytes": n_bytes,
        "wire_bytes": wire,
        "serial_compute_s": compute,
        "serial_memory_s": memory,
        "serial_collective_s": collective,
        "kernels_s": kernels_s,
        "kernel_bound_ms": kernel_ms,
        "modeled_step_s": modeled,
        "bound": max(terms, key=terms.get),
    }


def card() -> Optional[str]:
    """The card's name and power limit as ``nvidia-smi`` gives them (None
    without nvidia-smi)."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True, timeout=60).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return out.strip().splitlines()[0] if out.strip() else None

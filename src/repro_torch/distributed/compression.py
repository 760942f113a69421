"""Gradient compression for the data-parallel reduce, with error feedback:
the port of ``repro.distributed.compression``.

A gradient is rounded onto a low-precision grid before the collective
(bf16, or fp8 with one f32 scale per ``BLOCK`` elements), and the rounding
residual is kept in a local buffer and added back into the next step's
gradient (a Kahan/Collage-light residual), so the accumulated error stays
O(ulp) instead of O(steps·ulp).

Residual dtype: a bf16 target fed bf16 values keeps a bf16 residual (the
error of RN(a+b) for two bf16 numbers is a bf16 number: TwoSum); fp8
targets and f32 inputs keep an f32 residual.

fp8 block scaling: each block is scaled so its amax maps onto the top of
the fp8 grid (``mcf``'s ``rn``, the JAX package's ``reduce_precision``
grid: 240 for e4m3, 57344 for e5m2), quantized and shipped with its scale
vector. Under a collective the block amax is shared first (``pmax``) so
every rank quantizes onto one grid, with ``1/n_dev`` headroom (or the
given ``headroom``) so the sum stays in range.

Granularities, as in the JAX package: leaf-wise (``compress_tree``,
``pmean_compressed_tree``: one collective per leaf; ``reduce_tree``) and
bucket-wise (one per flat bucket, the residual rows in
``BucketedOptState.grad_err``): ``bucket_reducer`` is the hook both the
single-program step and the sharded engine hand ``step_bucketed``, where
the JAX package reduces the whole bucket tuple first
(``pmean_compressed_buckets``, ``psum_scatter_compressed_buckets``); a
bucket's mean and residual are the same either way. The collectives are
``distributed.collectives``: the reference's sums.
"""

from __future__ import annotations

import math
from typing import Any, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import bucketing, mcf
from repro_torch.distributed import collectives as coll

F32 = torch.float32
BLOCK = 512  # per-block scaling granularity for fp8

# largest finite value of the reduce_precision (eb, mb) grid mcf rounds onto
_FP8_GRID_MAX = {torch.float8_e4m3fn: 240.0, torch.float8_e5m2: 57344.0}

_SPECS = {
    "none": (None, False),
    "bf16": (torch.bfloat16, False),
    "bf16_ef": (torch.bfloat16, True),
    "fp8": (torch.float8_e4m3fn, False),
    "fp8_ef": (torch.float8_e4m3fn, True),
    "fp8e5_ef": (torch.float8_e5m2, True),
}


def parse_spec(name: str):
    """'bf16' | 'bf16_ef' | 'fp8' | 'fp8_ef' | … → (dtype | None, use_ef)."""
    if name not in _SPECS:
        raise ValueError(f"unknown grad_compression {name!r}; one of {sorted(_SPECS)}")
    return _SPECS[name]


def is_fp8(dtype) -> bool:
    return dtype in _FP8_GRID_MAX


def residual_dtype(dtype, value_dtype) -> torch.dtype:
    """The dtype that holds the quantization residual exactly."""
    if not is_fp8(dtype) and value_dtype == dtype:
        return dtype
    return F32


# --------------------------------------------------------------------------
# quantization primitives
# --------------------------------------------------------------------------

def _blocked(x32: torch.Tensor):
    """Flatten + zero-pad to a BLOCK multiple → ((nb, BLOCK), orig size)."""
    flat = x32.reshape(-1)
    n = flat.shape[0]
    pad = (-n) % BLOCK
    if pad:
        flat = torch.cat([flat, torch.zeros(pad, dtype=flat.dtype, device=flat.device)])
    return flat.reshape(-1, BLOCK), n


def block_amax(g32: torch.Tensor) -> torch.Tensor:
    """Per-BLOCK amax of |g32| (flattened), shape (nb,) f32."""
    blocks, _ = _blocked(g32.to(F32))
    return torch.amax(torch.abs(blocks), dim=1)


def fp8_scale(amax: torch.Tensor, dtype, headroom: float = 1.0) -> torch.Tensor:
    """Per-block scale mapping amax → grid_max / headroom (≥ tiny)."""
    gmax = _FP8_GRID_MAX[dtype]
    return torch.clamp_min(amax, float(np.float32(1e-30))) * float(np.float32(headroom / gmax))


def quantize(g32: torch.Tensor, dtype, scale: Optional[torch.Tensor] = None):
    """RN ``g32`` onto the ``dtype`` grid → (payload in ``dtype``, the f32
    value it represents). fp8 needs the per-block ``scale`` (nb,)."""
    f = mcf.fpu(dtype)
    if not is_fp8(dtype):
        payload = f.round(g32.to(F32))
        return payload, f.load(payload)
    gmax = _FP8_GRID_MAX[dtype]
    blocks, n = _blocked(g32.to(F32))
    q32 = torch.clamp(f.rn(blocks / scale[:, None]), -gmax, gmax)
    deq32 = (q32 * scale[:, None]).reshape(-1)[:n].reshape(g32.shape)
    payload = f.store(q32).reshape(-1)[:n].reshape(g32.shape)
    return payload, deq32


def dequantize(payload: torch.Tensor, dtype, scale: Optional[torch.Tensor] = None):
    """payload (``dtype``) → f32 values (per-block scales for fp8)."""
    if not is_fp8(dtype):
        return payload.to(F32)
    blocks, n = _blocked(payload.to(F32))
    return (blocks * scale[:, None]).reshape(-1)[:n].reshape(payload.shape)


# --------------------------------------------------------------------------
# local round trip (single program: models the wire loss)
# --------------------------------------------------------------------------

def _residual(g32: torch.Tensor, payload: torch.Tensor, dtype, scale) -> torch.Tensor:
    """The quantization residual g32 − deq32, as the JAX package's compiled
    step takes it. bf16: the difference is exact. fp8: XLA contracts
    g32 − q·s into one fused multiply-add (one rounding); here the product
    is taken in f64, where it is exact, and the difference rounds to f64
    and then to f32, which is one correct rounding (53 ≥ 2·24 + 2)."""
    if not is_fp8(dtype):
        return g32 - payload.to(F32)
    blocks, n = _blocked(payload.to(torch.float64))
    prod = (blocks * scale.to(torch.float64)[:, None]).reshape(-1)[:n].reshape(g32.shape)
    return (g32.to(torch.float64) - prod).to(F32)


def _div(x32: torch.Tensor, n: int) -> torch.Tensor:
    """x32 / n correctly rounded: CUDA divides by a host scalar as a product
    with its reciprocal, which is not; a divisor on the device is."""
    return x32 / torch.tensor(float(n), dtype=F32, device=x32.device)


def _with_err(g, err):
    g32 = g.to(F32)
    return g32 if err is None else g32 + err.to(F32)


def compress_decompress(g: torch.Tensor, err: Optional[torch.Tensor], dtype=torch.bfloat16):
    """Round-trip a gradient through ``dtype`` with error feedback →
    (dequantized f32 value, new residual). No collective."""
    g32 = _with_err(g, err)
    scale = fp8_scale(block_amax(g32), dtype) if is_fp8(dtype) else None
    payload, deq32 = quantize(g32, dtype, scale)
    return deq32, _residual(g32, payload, dtype, scale).to(residual_dtype(dtype, g.dtype))


def init_error_state(grads_template: Any, dtype=torch.bfloat16) -> Any:
    """Zero EF residuals from the gradient structure: per-bucket (1, padded)
    rows for a BucketedParams, else a tree shaped like the template."""
    if isinstance(grads_template, bucketing.BucketedParams):
        dev = grads_template.data[0].device
        return tuple(torch.zeros((1, b.padded), dtype=residual_dtype(
            dtype, bucketing.named_dtype(b.dtype)), device=dev)
            for b in grads_template.layout.buckets)
    return bucketing.tree_map(
        lambda g: torch.zeros(g.shape, dtype=residual_dtype(dtype, g.dtype), device=g.device),
        grads_template)


def compress_tree(grads: Any, err_state: Optional[Any], dtype=torch.bfloat16):
    """Leaf-wise local round trip → (grads in each leaf's dtype, residuals)."""
    flat, skel = bucketing.tree_flatten_with_path(grads)
    errs = bucketing.tree_leaves(err_state) if err_state is not None else [None] * len(flat)
    qs, es = [], []
    for (_, g), e in zip(flat, errs):
        deq, r = compress_decompress(g, e, dtype)
        qs.append(deq.to(g.dtype))
        es.append(r)
    return bucketing.tree_unflatten(skel, qs), bucketing.tree_unflatten(skel, es)


# --------------------------------------------------------------------------
# the local round trip on a grid rank's blocks of the global gradient
# --------------------------------------------------------------------------

_CHUNK_ELEMS = 1 << 22           # elements a pass over a block takes at once


def _block_chunks(g: torch.Tensor, block):
    """(rows slice, the BLOCK index in the whole leaf's flat order of every
    element of those rows of ``g``), over chunks of ``g``'s dim 0.
    ``block``: None (``g`` is the whole leaf) or (whole shape, start per
    dim) of the block ``g`` is."""
    whole, starts = (tuple(g.shape), (0,) * g.dim()) if block is None else block
    if g.dim() == 0:
        yield ..., torch.zeros((), dtype=torch.int64, device=g.device)
        return
    strides = [math.prod(whole[d + 1:]) for d in range(len(whole))]
    inner = torch.zeros((), dtype=torch.int64, device=g.device)
    for d in range(1, g.dim()):
        idx = (torch.arange(g.shape[d], device=g.device) + starts[d]) * strides[d]
        inner = inner[..., None] + idx
    rows = max(1, _CHUNK_ELEMS // max(1, inner.numel()))
    for r0 in range(0, g.shape[0], rows):
        r1 = min(g.shape[0], r0 + rows)
        head = (torch.arange(r0, r1, device=g.device) + starts[0]) * strides[0]
        yield slice(r0, r1), torch.div(head.reshape((-1,) + (1,) * (g.dim() - 1)) + inner,
                                       BLOCK, rounding_mode="floor")


def compress_blocks(grads: Any, err_tree: Optional[Any], dtype, blocks: Sequence,
                    axis: Optional[coll.Axis]):
    """``compress_tree``'s local round trip of the global gradient, on a
    rank's blocks of its leaves (``blocks``: per leaf in leaf order, None
    for a leaf the rank holds whole, else (whole shape, start per dim))
    → (the blocks in each leaf's dtype, their residuals): the one-rank
    round trip of each whole leaf restricted to the block, bit for bit.

    bf16 rounds element by element. fp8 scales each BLOCK of a whole
    leaf's flat order by that block's amax, and a rank's block cuts
    through those blocks, so each rank takes the amax of its part of every
    block, the parts meet in one MAX all-reduce over ``axis`` (every leaf at
    once; ranks holding no part give 0), and each element is quantized by
    its block's scale as the one-rank round trip quantizes it."""
    if not is_fp8(dtype):
        return compress_tree(grads, err_tree, dtype)
    flat, skel = bucketing.tree_flatten_with_path(grads)
    gs = [g for _, g in flat]
    errs = bucketing.tree_leaves(err_tree) if err_tree is not None else [None] * len(gs)
    blocks = list(blocks)
    dev = gs[0].device
    g32s = [_with_err(g, e) for g, e in zip(gs, errs)]
    nbs = [-(-math.prod(b[0] if b is not None else g.shape) // BLOCK) for g, b in zip(gs, blocks)]
    amax = torch.zeros(sum(nbs), dtype=F32, device=dev)
    starts = np.cumsum([0] + nbs[:-1]).tolist()
    for g32, b, n0, nb in zip(g32s, blocks, starts, nbs):
        part = amax[n0:n0 + nb]
        for rows, ids in _block_chunks(g32, b):
            part.scatter_reduce_(0, ids.reshape(-1), g32[rows].abs().reshape(-1), "amax")
    amax = coll.pmax(amax, axis, role="amax")
    gmax = _FP8_GRID_MAX[dtype]
    f = mcf.fpu(dtype)
    qs, es = [], []
    for g, g32, b, n0, nb in zip(gs, g32s, blocks, starts, nbs):
        scale = fp8_scale(amax[n0:n0 + nb], dtype)
        deq = torch.empty_like(g32)
        res = torch.empty_like(g32)
        for rows, ids in _block_chunks(g32, b):
            s_e = scale[ids]
            x = g32[rows]
            q32 = torch.clamp(f.rn(x / s_e), -gmax, gmax)
            payload = f.store(q32)
            deq[rows] = q32 * s_e
            res[rows] = (x.to(torch.float64) - payload.to(torch.float64)
                         * s_e.to(torch.float64)).to(F32)
        qs.append(deq.to(g.dtype))
        es.append(res.to(residual_dtype(dtype, g.dtype)))
    return bucketing.tree_unflatten(skel, qs), bucketing.tree_unflatten(skel, es)


# --------------------------------------------------------------------------
# collective paths: the payload on the wire IS ``dtype``
# --------------------------------------------------------------------------

def pmean_compressed_rows(gs: Sequence[torch.Tensor], errs: Sequence[Optional[torch.Tensor]],
                          dtype, axis: Optional[coll.Axis], n_dev: int, *,
                          headroom: Optional[float] = None, joint: bool = False):
    """``pmean_compressed`` for the R virtual devices this rank carries
    (rows; one gradient and residual each, of one shape). Without ``joint``
    each row is reduced over the ranks on its own (R means); with ``joint``
    over all (row, rank) pairs (the pipeline's (pipe × dp) reduce: one mean,
    the fp8 amax shared over every row and rank). Returns (means, residuals)."""
    g32s = [_with_err(g, e) for g, e in zip(gs, errs)]
    if is_fp8(dtype):
        amax = torch.stack([block_amax(g) for g in g32s])
        if joint:
            amax = torch.amax(amax, dim=0, keepdim=True)
        amax = coll.pmax(amax, axis)
        hr = float(n_dev if headroom is None else headroom)
        scales = [fp8_scale(a, dtype, headroom=hr) for a in amax]
        if joint:
            scales = scales * len(g32s)
    else:
        scales = [None] * len(g32s)
    quant = [quantize(g, dtype, s) for g, s in zip(g32s, scales)]
    summed = coll.psum(torch.stack([p for p, _ in quant]), axis, rows=True, joint=joint)
    sums = [summed] if joint else list(summed)
    means = [_div(dequantize(s, dtype, sc), n_dev) for s, sc in zip(sums, scales)]
    resids = [_residual(g, p, dtype, sc).to(residual_dtype(dtype, g0.dtype))
              for g, (p, _), sc, g0 in zip(g32s, quant, scales, gs)]
    return means, resids


def pmean_compressed(g: torch.Tensor, err: Optional[torch.Tensor], dtype,
                     axis: Optional[coll.Axis], n_dev: int, headroom: Optional[float] = None):
    """EF-compressed mean over ``axis``: quantize(g + err) → psum of the
    ``dtype`` payload → dequantize / n_dev. ``axis=None``: the local round
    trip (n_dev 1). Returns (mean32, new residual)."""
    (mean,), (resid,) = pmean_compressed_rows([g], [err], dtype, axis, n_dev,
                                              headroom=headroom)
    return mean, resid


def psum_scatter_compressed(g: torch.Tensor, err: Optional[torch.Tensor], dtype,
                            axis: Optional[coll.Axis], n_dev: int):
    """ZeRO variant: quantize the full local gradient, reduce-scatter the
    payload, dequantize the owned shard. The residual stays full-length.
    Returns (mean32 shard (len/n_dev,), new full-length residual)."""
    assert g.dim() == 1 and g.shape[0] % n_dev == 0, (tuple(g.shape), n_dev)
    g32 = _with_err(g, err)
    if is_fp8(dtype):
        # each shard must be whole scaling blocks, or the shard's scales misalign
        assert (g.shape[0] // n_dev) % BLOCK == 0, (tuple(g.shape), n_dev, BLOCK)
        scale = fp8_scale(coll.pmax(block_amax(g32), axis), dtype, headroom=float(n_dev))
        payload, _ = quantize(g32, dtype, scale)
        shard = coll.psum_scatter(payload, axis)
        nb = scale.shape[0] // n_dev
        idx = 0 if axis is None else axis.rank
        mean32 = _div(dequantize(shard, dtype, scale[idx * nb:(idx + 1) * nb]), n_dev)
    else:
        scale = None
        payload, _ = quantize(g32, dtype)
        mean32 = _div(coll.psum_scatter(payload, axis).to(F32), n_dev)
    return mean32, _residual(g32, payload, dtype, scale).to(residual_dtype(dtype, g.dtype))


def pmean_compressed_tree(grads: Any, err_tree: Optional[Any], dtype, axis, n_dev: int):
    """Leaf-wise EF-compressed mean (O(leaves) collectives) → (grads in
    each leaf's dtype, residual tree)."""
    flat, skel = bucketing.tree_flatten_with_path(grads)
    errs = bucketing.tree_leaves(err_tree) if err_tree is not None else [None] * len(flat)
    qs, es = [], []
    for (_, g), e in zip(flat, errs):
        m, r = pmean_compressed(g, e, dtype, axis, n_dev)
        qs.append(m.to(g.dtype))
        es.append(r)
    return bucketing.tree_unflatten(skel, qs), bucketing.tree_unflatten(skel, es)


def reduce_tree(grads: Any, err_tree: Optional[Any], dtype, axis: Optional[coll.Axis],
                n_dev: int):
    """The data-parallel gradient mean of a tree, leaf by leaf → (grads in
    each leaf's dtype, residual tree or None). ``dtype`` None: the f32 sum
    of the uncompressed leaves; else ``pmean_compressed_tree``, which with
    ``axis`` None is the local round trip (``compress_tree``)."""
    if dtype is None:
        return bucketing.tree_map(
            lambda g: _div(coll.psum(g.to(F32), axis), n_dev).to(g.dtype), grads), None
    if axis is None:
        return compress_tree(grads, err_tree, dtype)
    return pmean_compressed_tree(grads, err_tree, dtype, axis, n_dev)


def bucket_reducer(err_rows: Optional[Sequence[torch.Tensor]], dtype,
                   axis: Optional[coll.Axis], n_dev: int, n_buckets: int, *,
                   zero_shard: bool = False):
    """The data-parallel gradient mean of flat buckets, one collective per
    bucket, as ``step_bucketed``'s ``reduce_fn`` hook (each bucket reduced
    just before its own update) → (hook, the new residual rows: a list the
    hook fills in). ``zero_shard``: the hook returns this rank's shard of
    the mean (``psum_scatter_compressed``); ``dtype`` None: the f32 sum of
    the uncompressed bucket; ``axis`` None: the local round trip."""
    new_rows: list = [None] * n_buckets

    def reduce_fn(i: int, g: torch.Tensor) -> torch.Tensor:
        if dtype is None:
            red = coll.psum_scatter if zero_shard else coll.psum
            return _div(red(g.to(F32), axis), n_dev).to(g.dtype)
        e = None if err_rows is None else err_rows[i]
        if axis is None:
            m, new_rows[i] = compress_decompress(g, e, dtype)
        else:
            red = psum_scatter_compressed if zero_shard else pmean_compressed
            m, new_rows[i] = red(g, e, dtype, axis, n_dev)
        return m.to(g.dtype)

    return reduce_fn, new_rows


def store_error_rows(rows: Sequence[torch.Tensor], new_rows: Sequence[torch.Tensor],
                     donate: bool) -> tuple:
    """A bucketed state's residual rows after a step: the (1, padded) rows
    of ``bucket_reducer``'s new residuals, written over ``rows`` when the
    step is donated (as the update writes the buckets), else new tensors."""
    if not donate:
        return tuple(r[None] for r in new_rows)
    for row, new in zip(rows, new_rows):
        row[0].copy_(new)
    return tuple(rows)

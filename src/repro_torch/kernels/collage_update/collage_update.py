"""Fused Collage-AdamW bucket update: the wrapper of the Hopper CUDA kernel,
the port of ``repro.kernels.collage_update.collage_update``.

``collage_bucket_update`` updates ONE flat bucket in one pass: m/v EMAs,
the bias-corrected AdamW update, the strategy's rule (A, B, C, KAHAN, SR,
D⁻, D), round-to-nearest onto bf16 after every operation, and optionally
the per-tile metric partials (``det_sum`` over each (br, 128) tile, then
over the tiles, both on the card). On a CUDA tensor it launches
``csrc/collage_update/collage_update.cu`` (built on first use) or raises;
on a CPU tensor it runs the plain version ``ref.collage_bucket_update_plain``.
Nothing else selects the path. ``collage_bucket_update.launches`` counts
kernel launches.

The update is functional by default, as the JAX one: new state tensors
are allocated and the inputs are left as they were. With ``in_place`` the
kernel writes the new state over the old (the trainer's donated step: one
copy of the optimizer state instead of two, what lets gemma3-27b's 3.89 B
element bucket fit on an 80 GB card). ``launch`` is the kernel's launch
with ``finish=False`` leaving out the sum over the tiles: ``chip_smoke.py``
times the two apart. Buckets of 2^31 elements or more take one launch:
the kernel indexes in 64 bits; the SR index stays the JAX package's
uint32 ``elem_offset + i``, wrapping mod 2^32.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

LANES = 128       # last dim of every tile
SUBLANES = 8
BLOCK_ROWS = 256  # rows per tile at most
N_METRICS = 5     # metric partials: dot, un2, en2, lost, gn2
FINISH_ROWS = 2048  # the kernel's sum over the tiles ends in one block of this many rows
MAX_TILES = 2**31 - 1   # the kernel's tile count is a C int

KERNEL_SOURCE = "collage_update/collage_update.cu"

# bucket-state fields each strategy reads and writes, in tile order
_FIELDS = {
    "A": ("theta", "m", "vhi"),
    "B": ("theta", "m", "vhi", "delta"),
    "C": ("theta", "m", "vhi", "vlo", "delta"),
    "KAHAN": ("theta", "m", "vhi", "delta"),
    "SR": ("theta", "m", "vhi"),
    "D-": ("theta", "m", "vhi"),
    "D": ("theta", "m", "vhi", "master"),
}
# strategy → the kernel's code (the template argument of the CUDA kernel)
KERNEL_CODE = {"A": 0, "B": 1, "C": 2, "KAHAN": 3, "SR": 4, "D-": 5, "D": 6}
# the kernel's pointer slots, in argument order
_SLOTS = ("theta", "m", "vhi", "vlo", "delta", "master")
# host constants, in the order of the kernel's constant block
_CONSTS = ("lr", "bc1", "bc2", "b1", "c1", "b2", "c2", "cb1", "c1m", "cb2", "c2m", "b2hi",
           "b2lo", "eps", "wd_upd", "factor")


def state_fields(strategy: str) -> tuple:
    return _FIELDS[strategy]


def field_dtype(field: str, strategy: str):
    """Storage dtype of a bucket-state field: bf16, but f32 for option D's
    optimizer states and the master copy."""
    if field == "master" or (strategy in ("D-", "D") and field in ("m", "vhi")):
        return torch.float32
    return torch.bfloat16


def choose_block_rows(rows: int, block_rows: int = BLOCK_ROWS) -> int:
    """Largest power-of-two-ish divisor of ``rows`` ≤ block_rows: the tile
    height, shared by the kernel and the plain version so that the metric
    partials are summed in the same order."""
    br = min(block_rows, rows)
    while rows % br:
        br //= 2
    return br


def kernel_grid(n: int, block_rows: int = BLOCK_ROWS) -> tuple:
    """(tile rows, tiles) of the kernel's launch over an n-element bucket
    (Python ints: no 32-bit product). The kernel takes n as a 64-bit int
    and at most ``MAX_TILES`` tiles."""
    br = choose_block_rows(n // LANES, block_rows)
    tiles = n // LANES // br
    if tiles > MAX_TILES:
        raise ValueError(f"bucket of {n} elements: {tiles} tiles of {br} rows, the kernel "
                         f"takes at most {MAX_TILES}")
    return br, tiles


def _library():
    from repro_torch.kernels import build

    lib = build.load(KERNEL_SOURCE)
    fn = lib.collage_update
    # code, n (64-bit), br, pt_decay; g, 6 inputs, 6 outputs, partials,
    # sums, constants; seed, elem_offset; stream
    fn.argtypes = ([ctypes.c_int, ctypes.c_int64, ctypes.c_int, ctypes.c_int]
                   + [ctypes.c_void_p] * 16
                   + [ctypes.c_uint32] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.collage_update_error_string.argtypes = [ctypes.c_int]
    lib.collage_update_error_string.restype = ctypes.c_char_p
    return lib


def _check(state, g, strategy):
    fields = state_fields(strategy)
    if set(state) != set(fields):
        raise ValueError(f"state fields {sorted(state)} vs {fields}")
    if g.dim() != 1 or g.shape[0] % LANES:
        raise ValueError(f"g must be 1-D with a length that is a multiple of {LANES}: "
                         f"{tuple(g.shape)}")
    for f in fields:
        t = state[f]
        if t.shape != g.shape or t.device != g.device:
            raise ValueError(f"{f}: {tuple(t.shape)} on {t.device} vs g {tuple(g.shape)}")


def collage_bucket_update(state: dict, g, lr, bc1, bc2, seed=None, elem_offset=None, *,
                          b1=0.9, b2=0.999, eps=1e-8, wd=0.0, strategy="C", pt_decay=False,
                          compute_metrics=False, block_rows=BLOCK_ROWS, in_place=False):
    """Fused update of ONE flat bucket → ``(new_state, partials)``; partials
    is a 5-tuple of f32 0-dim tensors or None. ``lr``/``bc1``/``bc2`` are
    host scalars (f32 values). ``seed`` and ``elem_offset`` (SR) index the
    counter-based noise stream bucket-globally. ``in_place``: the new state
    is written over ``state``'s tensors, which are returned."""
    from repro_torch.kernels.collage_update import ref

    _check(state, g, strategy)
    if g.device.type == "cpu":
        out, parts = ref.collage_bucket_update_plain(
            state, g, lr, bc1, bc2, seed, elem_offset, b1=b1, b2=b2, eps=eps, wd=wd,
            strategy=strategy, pt_decay=pt_decay, compute_metrics=compute_metrics,
            block_rows=block_rows, tiled_metrics=True)
        return (copy_into(state, out) if in_place else out), parts
    if g.device.type != "cuda":
        raise ValueError(f"collage_bucket_update: unsupported device {g.device}")
    out, sums = launch(state, g, lr, bc1, bc2, seed, elem_offset, b1=b1, b2=b2, eps=eps, wd=wd,
                       strategy=strategy, pt_decay=pt_decay, compute_metrics=compute_metrics,
                       block_rows=block_rows, in_place=in_place)
    collage_bucket_update.launches += 1
    return out, None if sums is None else tuple(sums[i] for i in range(N_METRICS))


def copy_into(state: dict, new: dict) -> dict:
    """Write ``new``'s tensors over ``state``'s (the plain version's in-place
    update) and return ``state``."""
    for f, t in new.items():
        state[f].copy_(t)
    return state


def launch(state: dict, g, lr, bc1, bc2, seed=None, elem_offset=None, *, b1=0.9, b2=0.999,
           eps=1e-8, wd=0.0, strategy="C", pt_decay=False, compute_metrics=False,
           block_rows=BLOCK_ROWS, finish=True, in_place=False):
    """The kernel's launch on CUDA tensors → ``(new_state, sums)``: sums the
    (5,) metric sums, ``det_sum`` over the tiles of the per-tile sums (None
    without metrics, or with ``finish=False``, which leaves out the launches
    that sum over the tiles). ``in_place``: the outputs are ``state``'s own
    tensors. Counts nothing: ``collage_bucket_update`` counts its own
    launches."""
    from repro_torch.core import bucketing
    from repro_torch.kernels import build
    from repro_torch.kernels.collage_update import ref

    _check(state, g, strategy)
    if g.device.type != "cuda":
        raise ValueError(f"the collage_update kernel takes CUDA tensors, got {g.device}")
    if g.dtype != torch.bfloat16:
        raise TypeError(f"collage_update kernel takes bf16 gradients, got {g.dtype}")
    for f in state_fields(strategy):
        t = state[f]
        if t.dtype != field_dtype(f, strategy):
            raise TypeError(f"{f}: {t.dtype}, the kernel takes {field_dtype(f, strategy)}")
        if not t.is_contiguous():
            raise ValueError(f"{f}: not contiguous")
    if not g.is_contiguous():
        raise ValueError("g: not contiguous")
    if strategy == "SR" and seed is None:
        raise ValueError("SR needs a seed")

    n = g.shape[0]
    br, grid = kernel_grid(n, block_rows)
    lib = _library()
    out = {f: state[f] if in_place else torch.empty_like(state[f])
           for f in state_fields(strategy)}
    consts = ref.update_constants(b1, b2, eps, wd, pt_decay, lr)
    consts.update(lr=float(np.float32(lr)), bc1=float(np.float32(bc1)),
                  bc2=float(np.float32(bc2)))
    host = (ctypes.c_float * len(_CONSTS))(*(consts[k] for k in _CONSTS))
    partials = sums = None
    if compute_metrics:
        partials = torch.empty((N_METRICS, grid), dtype=torch.float32, device=g.device)
        if finish:          # the 5 sums, then from 8 the scratch of the sum over the tiles
            sums = torch.empty((8 + N_METRICS * (FINISH_ROWS + 48),), dtype=torch.float32,
                               device=g.device)
    ptr = lambda d, f: d[f].data_ptr() if f in d else None
    stream = torch.cuda.current_stream(g.device).cuda_stream
    err = lib.collage_update(
        KERNEL_CODE[strategy], n, br, int(bool(pt_decay)), g.data_ptr(),
        *(ptr(state, f) for f in _SLOTS), *(ptr(out, f) for f in _SLOTS),
        partials.data_ptr() if partials is not None else None,
        sums.data_ptr() if sums is not None else None,
        ctypes.addressof(host),
        int(seed or 0) & bucketing.MASK32, int(elem_offset or 0) & bucketing.MASK32,
        stream)
    if err != 0:
        msg = lib.collage_update_error_string(err).decode()
        raise build.KernelLaunchError(
            f"collage_update kernel launch failed: {msg} (cudaError {err})")
    return out, None if sums is None else sums[:N_METRICS]


collage_bucket_update.launches = 0

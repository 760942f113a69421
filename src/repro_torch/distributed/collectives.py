"""The port's stand-in for ``lax.psum`` / ``lax.psum_scatter`` / ``lax.pmax``
/ ``lax.all_gather`` over a data-parallel axis of ``torch.distributed``
ranks (``nccl`` on the card, ``gloo`` on the CPU).

The sums reproduce the JAX package's, not the backend's: a payload crosses
the wire in its own dtype (an fp8 payload as its uint8 view: no backend
reduces fp8) and is summed on the receiving rank, in rank order, in the
reference's accumulator (XLA's all-reduce of an fp8 operand sums in f16,
of a bf16 operand in f32, then rounds once to the operand's dtype). So a
reduce is an all-gather and a local sum, and the ZeRO reduce-scatter is an
all-to-all of shards and the same local sum. A backend's ring reduce would
round bf16 at every hop, in an order of its own.

``Axis`` names the ranks of the dp axis; ``Axis()`` is one rank with no
process group, where every collective is the identity. Rows: a rank may
carry several virtual devices of the reference's mesh (the pipeline stages
it holds, ``distributed.pipeline``): their payloads go as rows of one
tensor, and ``joint=True`` sums over the (row, rank) pairs in the order of
the reference's (pipe, data) mesh, row-major.

Every collective is recorded in ``CENSUS`` (op, role, wire dtype, numel,
the bytes this rank sends): the tests and ``chip_smoke.py`` read it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.distributed as dist

F32 = torch.float32
_FP8 = (torch.float8_e4m3fn, torch.float8_e5m2)

CENSUS: list = []


def reset_census():
    CENSUS.clear()


def _record(op: str, role: str, wire: torch.Tensor, numel: Optional[int] = None):
    n = wire.numel() if numel is None else numel
    CENSUS.append({"op": op, "role": role, "dtype": str(wire.dtype).replace("torch.", ""),
                   "numel": int(n), "bytes": int(n * wire.element_size())})


@dataclasses.dataclass(frozen=True)
class Axis:
    """The data-parallel axis: ``size`` ranks of the process group
    ``group`` (None: the default group), this process being ``rank``.
    ``Axis()``: a single rank and no group."""

    size: int = 1
    rank: int = 0
    group: Any = None
    distributed: bool = False

    @classmethod
    def of(cls, group=None) -> "Axis":
        """The axis over an initialised ``torch.distributed`` group."""
        if not dist.is_initialized():
            raise RuntimeError("Axis.of: torch.distributed is not initialised")
        return cls(dist.get_world_size(group), dist.get_rank(group), group, True)


def accumulator(dtype: torch.dtype) -> torch.dtype:
    """The dtype XLA's all-reduce sums an operand of ``dtype`` in."""
    if dtype in _FP8:
        return torch.float16
    if dtype in (torch.bfloat16, torch.float16):
        return F32
    return dtype


def _wire(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.uint8) if x.dtype in _FP8 else x


def _unwire(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return x.view(dtype) if dtype in _FP8 else x


def _ordered_sum(parts, dtype: torch.dtype) -> torch.Tensor:
    """Σ parts in list order, each addition rounded to the accumulator of
    ``dtype`` (f16 adds are taken in f32 and rounded: correctly rounded, as
    2·11 + 2 ≤ 24), then rounded once to ``dtype``."""
    if len(parts) == 1:      # one rank: the sum is the part, in its own dtype
        return parts[0].clone()
    acc = accumulator(dtype)
    tot = parts[0].to(acc)
    for p in parts[1:]:
        tot = (tot.to(F32) + p.to(F32)).to(acc) if acc == torch.float16 else tot + p.to(acc)
    return tot.to(dtype)


def _gather(x: torch.Tensor, axis: Axis, role: str) -> list:
    """[x of rank 0, x of rank 1, …] (all-gather)."""
    w = _wire(x.contiguous())
    _record("all_gather", role, w)
    out = [torch.empty_like(w) for _ in range(axis.size)]
    dist.all_gather(out, w, group=axis.group)
    return [_unwire(o, x.dtype) for o in out]


def psum(x: torch.Tensor, axis: Optional[Axis], *, rows: bool = False, joint: bool = False,
         role: str = "grad") -> torch.Tensor:
    """Σ of ``x`` over the ranks of ``axis``, in rank order, in the
    reference's accumulator, rounded once to ``x``'s dtype.

    ``rows``: dim 0 of ``x`` holds this rank's virtual devices; without
    ``joint`` each row is summed over the ranks on its own (result of
    ``x``'s shape), with ``joint`` over all (row, rank) pairs, row-major
    (result ``x.shape[1:]``)."""
    local = axis is None or not axis.distributed
    parts = [x] if local else _gather(x, axis, role)
    if not rows:
        return parts[0].clone() if local else _ordered_sum(parts, x.dtype)
    if joint:
        return _ordered_sum([p[r] for r in range(x.shape[0]) for p in parts], x.dtype)
    return torch.stack([_ordered_sum([p[r] for p in parts], x.dtype)
                        for r in range(x.shape[0])])


def psum_scatter(x: torch.Tensor, axis: Optional[Axis], role: str = "grad") -> torch.Tensor:
    """``lax.psum_scatter(x, tiled=True)`` over dim 0 of a 1-D ``x``: this
    rank's contiguous shard of the sum (all-to-all of shards, then the
    ordered sum)."""
    if axis is None or not axis.distributed:
        return x.clone()
    n = axis.size
    if x.dim() != 1 or x.shape[0] % n:
        raise ValueError(f"psum_scatter: 1-D length divisible by {n}, got {tuple(x.shape)}")
    w = _wire(x.contiguous())
    _record("all_to_all", role, w)
    out = torch.empty_like(w)
    dist.all_to_all_single(out, w, group=axis.group)
    parts = list(_unwire(out, x.dtype).reshape(n, -1))
    return _ordered_sum(parts, x.dtype)


def pmax(x: torch.Tensor, axis: Optional[Axis], role: str = "amax") -> torch.Tensor:
    """Elementwise max over the ranks (an f32 MAX all-reduce: exact)."""
    if axis is None or not axis.distributed:
        return x.clone()
    out = x.contiguous().clone()
    _record("all_reduce_max", role, out)
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=axis.group)
    return out


def all_gather(x: torch.Tensor, axis: Optional[Axis], role: str = "param") -> torch.Tensor:
    """``lax.all_gather(x, tiled=True)`` of a 1-D shard: the full array."""
    if axis is None or not axis.distributed:
        return x.clone()
    return torch.cat(_gather(x, axis, role))


def pmean_scalar(x: torch.Tensor, axis: Optional[Axis], role: str = "metric") -> torch.Tensor:
    """``lax.pmean`` of an f32 scalar (or small vector)."""
    if axis is None or not axis.distributed:
        return x
    return psum(x.to(F32), axis, role=role) / axis.size

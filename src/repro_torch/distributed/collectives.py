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
Roles of the grid (``distributed.sharding``): ``fsdp_gather`` and
``fsdp_scatter`` (a weight's just-in-time gather over dp and its
gradient's reduce-scatter), ``tp_reduce`` (a row-parallel output's sum over "model",
and the sum of a column-parallel input's gradient), ``vocab_reduce`` (the
vocab-parallel embedding, loss and argmax), ``cp_combine`` (the
context-parallel decode's log-sum-exp combine over "data"), ``sp_scatter``
and ``sp_gather`` (sequence parallelism's reduce-scatter and all-gather
over the sequence), ``grad`` (a dp-replicated leaf's gradient sum),
``moe_dp`` (the MoE's sums over the dp ranks of a global batch: the
per-expert assignment counts, for positions and capacity, and the aux
loss's router probabilities).

Along a tensor dim (``all_gather_dim``, ``psum_scatter_dim``, ``reduce_to``,
``copy_to``, ``gather_rep_dim``, ``split_dim``) each collective is an
autograd Function whose backward is its conjugate: gather ↔ reduce-scatter,
psum ↔ identity, slice ↔ gather.

Several ranks may share one card, where NCCL refuses them: then they meet
in a ``gloo`` group over CUDA tensors, which takes every collective here.
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
    out = _all_to_all(_wire(x.contiguous()), axis, role)
    parts = list(_unwire(out, x.dtype).reshape(n, -1))
    return _ordered_sum(parts, x.dtype)


def _all_to_all(w: torch.Tensor, axis: Axis, role: str) -> torch.Tensor:
    """Equal blocks of dim 0 to the ranks in order; block j of the result
    came from rank j."""
    _record("all_to_all", role, w)
    out = torch.empty_like(w)
    dist.all_to_all_single(out, w, group=axis.group)
    return out


def sum_disjoint(x: torch.Tensor, axis: Optional[Axis], role: str = "tp_reduce") -> torch.Tensor:
    """Σ of ``x`` over the ranks where at each element at most one rank's
    part is nonzero (blocks of a whole, zeros elsewhere): exact in ``x``'s
    own dtype, so it is summed there, with no accumulator copies (``psum``
    of such parts gives the same numbers). An all-gather and a local sum."""
    if axis is None or not axis.distributed:
        return x.clone()
    parts = _gather(x, axis, role)
    out = parts[0]
    for p in parts[1:]:
        out.add_(p)
    return out


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


# ------------------------------------------- along a tensor dim, with autograd
def _local(axis: Optional[Axis]) -> bool:
    return axis is None or not axis.distributed


def _gather_dim(x: torch.Tensor, axis: Axis, dim: int, role: str) -> torch.Tensor:
    return torch.cat(_gather(x, axis, role), dim=dim)


def _scatter_sum_dim(x: torch.Tensor, axis: Axis, dim: int, role: str) -> torch.Tensor:
    """This rank's block along ``dim`` of Σ_ranks x: an all-to-all of the
    blocks, then the ordered sum in the reference's accumulator."""
    n = axis.size
    if x.shape[dim] % n:
        raise ValueError(f"psum_scatter_dim: dim {dim} of {tuple(x.shape)} over {n} ranks")
    blocks = torch.stack(torch.chunk(x, n, dim=dim))              # (n, ..., k, ...)
    out = _unwire(_all_to_all(_wire(blocks.contiguous()), axis, role), x.dtype)
    return _ordered_sum(list(out), x.dtype)


def _block_of(x: torch.Tensor, axis: Axis, dim: int) -> torch.Tensor:
    k = x.shape[dim] // axis.size
    return x.narrow(dim, axis.rank * k, k).contiguous()


class _AllGatherDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim, role, back_role):
        ctx.axis, ctx.dim, ctx.role = axis, dim, back_role
        return _gather_dim(x, axis, dim, role)

    @staticmethod
    def backward(ctx, g):
        return _scatter_sum_dim(g.contiguous(), ctx.axis, ctx.dim, ctx.role), None, None, None, None


class _PsumScatterDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim, role, back_role):
        ctx.axis, ctx.dim, ctx.role = axis, dim, back_role
        return _scatter_sum_dim(x.contiguous(), axis, dim, role)

    @staticmethod
    def backward(ctx, g):
        return _gather_dim(g, ctx.axis, ctx.dim, ctx.role), None, None, None, None


class _ReduceTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, role):
        return psum(x, axis, role=role)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, role):
        ctx.axis, ctx.role = axis, role
        return x

    @staticmethod
    def backward(ctx, g):
        return psum(g.contiguous(), ctx.axis, role=ctx.role), None, None


class _GatherRepDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim, role):
        ctx.axis, ctx.dim = axis, dim
        return _gather_dim(x, axis, dim, role)

    @staticmethod
    def backward(ctx, g):
        return _block_of(g, ctx.axis, ctx.dim), None, None, None


class _SplitDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim, role):
        ctx.axis, ctx.dim, ctx.role = axis, dim, role
        return _block_of(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather_dim(g.contiguous(), ctx.axis, ctx.dim, ctx.role), None, None, None


def all_gather_dim(x: torch.Tensor, axis: Optional[Axis], dim: int, role: str = "fsdp_gather",
                   back_role: str = "fsdp_scatter") -> torch.Tensor:
    """The ranks' blocks of ``x`` concatenated along ``dim`` (FSDP's
    just-in-time gather); backward: the reduce-scatter of the gradient."""
    return x if _local(axis) else _AllGatherDim.apply(x, axis, dim, role, back_role)


def psum_scatter_dim(x: torch.Tensor, axis: Optional[Axis], dim: int, role: str = "sp_scatter",
                     back_role: str = "sp_gather") -> torch.Tensor:
    """This rank's block along ``dim`` of Σ_ranks x (bf16 parts summed in
    f32 in rank order, rounded once); backward: the all-gather."""
    return x if _local(axis) else _PsumScatterDim.apply(x, axis, dim, role, back_role)


def reduce_to(x: torch.Tensor, axis: Optional[Axis], role: str = "tp_reduce") -> torch.Tensor:
    """Σ over the ranks (a row-parallel output); backward: the identity."""
    return x if _local(axis) else _ReduceTo.apply(x, axis, role)


def copy_to(x: torch.Tensor, axis: Optional[Axis], role: str = "tp_reduce") -> torch.Tensor:
    """The identity (a column-parallel input, a weight every rank applies to
    its own part); backward: Σ of the gradient over the ranks."""
    return x if _local(axis) else _CopyTo.apply(x, axis, role)


def gather_rep_dim(x: torch.Tensor, axis: Optional[Axis], dim: int,
                   role: str = "sp_gather") -> torch.Tensor:
    """The all-gather along ``dim`` ahead of a computation every rank
    repeats whole; backward: this rank's block of its own gradient (every
    rank holds the same one)."""
    return x if _local(axis) else _GatherRepDim.apply(x, axis, dim, role)


def split_dim(x: torch.Tensor, axis: Optional[Axis], dim: int,
              role: str = "sp_gather") -> torch.Tensor:
    """This rank's block along ``dim`` of a tensor every rank holds whole;
    backward: the all-gather of the blocks' gradients."""
    return x if _local(axis) else _SplitDim.apply(x, axis, dim, role)


def gather_dim(x: torch.Tensor, axis: Optional[Axis], dim: int, role: str = "gather") -> torch.Tensor:
    """All-gather along ``dim`` without autograd (assembling results)."""
    return x if _local(axis) else _gather_dim(x, axis, dim, role)


class _CountOnce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.first = axis.rank == 0
        return x

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.first else torch.zeros_like(g)), None


def count_once(x: torch.Tensor, axis: Optional[Axis]) -> torch.Tensor:
    """The identity, whose gradient passes on the axis' rank 0 only (zeros
    elsewhere): for a computation every rank repeats whole on an input
    whose gradient is later summed over the axis, so that its part counts
    once."""
    return x if _local(axis) else _CountOnce.apply(x, axis)


def exclusive_prefix(x: torch.Tensor, axis: Optional[Axis], role: str = "moe_dp") -> tuple:
    """(Σ of ``x`` over the ranks before this one, Σ over all ranks) of a
    small integer tensor: one all-gather, then sums in rank order, on the
    device (nothing is read back to the host)."""
    if _local(axis):
        return torch.zeros_like(x), x
    parts = _gather(x, axis, role)
    before = torch.zeros_like(x)
    for p in parts[:axis.rank]:
        before = before + p
    total = before
    for p in parts[axis.rank:]:
        total = total + p
    return before, total

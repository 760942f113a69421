"""The data-parallel / ZeRO part of ``repro.distributed.sharding``.

Bucketed states shard every flat bucket (params and every optimizer role)
along its single axis over the dp ranks: rank r holds the contiguous
``[r·padded/n, (r+1)·padded/n)`` of each bucket. The update is elementwise
and every role bucket has one layout, so all roles co-shard with no extra
collective. ``bucket_pad_multiple`` sizes the layout so that every bucket
divides the dp axis (and, for fp8, every shard is whole scaling blocks).

Not ported yet: the GSPMD name rules of tensor, FSDP and context
parallelism (``param_spec``, ``state_shardings``, ``batch_shardings``,
``cache_shardings``, ``make_activation_sharder``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core import bucketing
from repro_torch.distributed.collectives import Axis


def dp_size(axis: Optional[Axis]) -> int:
    """The number of dp ranks (``_dp_axes``' product; 1 without an axis)."""
    return 1 if axis is None else axis.size


def bucket_pad_multiple(axis: Optional[Axis], block: int = 1) -> int:
    """Layout pad_multiple that keeps every bucket dividing both the tile
    (8×128) and the dp ranks; ``block``: the compressed collective's
    quantization block (``compression.BLOCK`` for fp8), so each rank's
    ZeRO shard is whole blocks."""
    return math.lcm(bucketing.PAD_DEFAULT, dp_size(axis) * block)


def shard_of(x: torch.Tensor, axis: Optional[Axis]) -> torch.Tensor:
    """This rank's contiguous shard of a flat bucket."""
    n = dp_size(axis)
    if x.shape[0] % n:
        raise ValueError(f"bucket of {x.shape[0]} elements does not divide {n} ranks")
    k = x.shape[0] // n
    r = 0 if axis is None else axis.rank
    return x[r * k:(r + 1) * k].clone()

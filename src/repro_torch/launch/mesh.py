"""Grids of ranks, the port of ``repro.launch.mesh.make_mesh``.

A ``Grid`` lays ``torch.distributed`` ranks out as ``jax.make_mesh`` lays
devices out: row-major over named axes ("data", "model"), or ("pod",
"data", "model") with ``pods > 1``, so global rank ((pod·dp) + data)·tp +
model. It holds this rank's coordinates and one process group per axis
line through it, plus the dp line (pod × data) that the FSDP rules shard
over (``distributed.sharding._dp_axes``). Every rank creates every line's
group, in one order, as ``dist.new_group`` requires.

``make_mesh(1, 1)`` is the one-rank grid: no group, every collective the
identity. The sharded engine's ``train.sharded.Mesh`` (dp ranks × the
pipeline stage devices of a rank) is another type: the GSPMD rules
(``distributed.sharding``) and the grid train step
(``train.train_loop.make_train_step(grid=)``) take a ``Grid``.

Not carried over: the JAX module's production meshes (256 and 512 TPU
chips) and its TPU hardware constants.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Any

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device
from repro_torch.distributed.collectives import Axis


@dataclasses.dataclass(frozen=True)
class Grid:
    """A row-major grid of ranks with named axes. ``coords``: this rank's
    coordinate on each axis; ``lines``: the ``Axis`` through this rank
    along each axis name, along "dp" (pod × data) and over the whole grid
    ("world")."""

    axis_names: tuple
    shape: tuple
    coords: tuple
    lines: Any = None
    device: torch.device = torch.device("cpu")

    @property
    def sizes(self) -> dict:
        return dict(zip(self.axis_names, self.shape))

    @property
    def tp(self) -> int:
        return self.sizes.get("model", 1)

    @property
    def n_dp(self) -> int:
        return math.prod(self.sizes.get(a, 1) for a in ("pod", "data"))

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    def axis(self, name: str) -> Axis:
        """The line through this rank along ``name`` ("dp": pod × data)."""
        if self.lines is not None and name in self.lines:
            return self.lines[name]
        return Axis()


def grid_shape(dp: int, tp: int, pods: int = 1) -> Grid:
    """A grid's layout without process groups, at rank 0 (the spec rules
    need only names and sizes)."""
    names, shape = _layout(dp, tp, pods)
    return Grid(names, shape, (0,) * len(shape))


def _layout(dp: int, tp: int, pods: int):
    if pods > 1:
        return ("pod", "data", "model"), (pods, dp, tp)
    return ("data", "model"), (dp, tp)


def _unravel(rank: int, shape: tuple) -> tuple:
    out = []
    for n in reversed(shape):
        out.append(rank % n)
        rank //= n
    return tuple(reversed(out))


def make_mesh(dp: int, tp: int, pods: int = 1, *, device="cuda") -> Grid:
    """This rank's place in a (pods ×) dp × tp grid over the initialised
    default process group (world size = the grid's size), with one group
    per axis line. ``make_mesh(1, 1)`` needs no process group."""
    dev = resolve_device(device)
    names, shape = _layout(dp, tp, pods)
    n = math.prod(shape)
    if n == 1:
        return Grid(names, shape, (0,) * len(shape), None, dev)
    if not dist.is_initialized():
        raise RuntimeError(f"make_mesh({dp}, {tp}, {pods}): torch.distributed is not initialised")
    if dist.get_world_size() != n:
        raise ValueError(f"grid of {n} ranks over a world of {dist.get_world_size()}")
    me = dist.get_rank()
    coords = _unravel(me, shape)
    lines: dict = {}
    # each axis, then the dp line (pod × data): every line's group, in one order on every rank
    axes = [(a,) for a in names] + ([("pod", "data")] if pods > 1 else [])
    for ax in axes:
        idx = [names.index(a) for a in ax]
        size = math.prod(shape[i] for i in idx)
        rest = [i for i in range(len(shape)) if i not in idx]
        for fixed in itertools.product(*(range(shape[i]) for i in rest)):
            ranks = []
            for moving in itertools.product(*(range(shape[i]) for i in idx)):
                c = [0] * len(shape)
                for i, v in zip(rest, fixed):
                    c[i] = v
                for i, v in zip(idx, moving):
                    c[i] = v
                r = 0
                for ci, si in zip(c, shape):
                    r = r * si + ci
                ranks.append(r)
            group = dist.new_group(ranks) if size > 1 else None
            if me in ranks:
                key = ax[0] if len(ax) == 1 else "dp"
                lines[key] = Axis(size, ranks.index(me), group, size > 1)
    if pods == 1:
        lines["dp"] = lines["data"]
    lines["world"] = Axis(n, me, None, True)
    return Grid(names, shape, coords, lines, dev)

"""Sharding rules: parameter, optimizer, batch, cache and activation specs,
the port of ``repro.distributed.sharding``.

Strategy: FSDP × TP over a ``launch.mesh.Grid`` of ranks.
  * TP ("model" axis): attention Q/KV/O head dims, the MLP hidden dim, the
    MoE expert dim, the Mamba/RWKV channel dims, the vocab of the
    embedding and head.
  * FSDP ("data", with "pod" when the pod axis plays dp): the other large
    dim of every weight. Optimizer state (δθ, m, v, master) shards as its
    parameter: the update is elementwise, so it needs no collective.
  * Sequence: the context-parallel decode splits the KV cache length over
    "data"; activations split the batch over the dp axes.

The rules go by name (the last named component of a leaf's path) and by
rank (a leading layer-stack dim gets a None): one table for every family.
A spec is a ``P``, a tuple with the reference's ``PartitionSpec`` entries:
None, an axis name, or a tuple of names. Paths are the JAX package's
``keystr`` strings (``.params['decoder']['groups'][0]['sub0']['wq']``), as
``named_leaves`` gives them for the port's containers.

``local_block`` cuts this rank's block of a leaf (the reference's
``device_put`` with a ``NamedSharding``; a tuple of axes nests in tuple
order), ``gather_block`` is its inverse over the grid's process groups.
``make_activation_sharder`` gives the object the model's TP boundaries
call (``models.transformer.shard_act``); ``materialize`` turns a rank's
parameter blocks into the tensors its forward reads, with each sublayer
kind's gathers and gradient sums over "model" (attention, MoE, Mamba, RWKV
time-mix and channel-mix).

The data-parallel / ZeRO part (``dp_size``, ``bucket_pad_multiple``,
``shard_of``) serves the sharded engine (``train.sharded``): every flat
bucket shards along its single axis over the dp ranks.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import re
import weakref
from typing import Optional

import torch

from repro_torch.core import bucketing
from repro_torch.core.mcf import Expansion
from repro_torch.distributed import collectives as coll
from repro_torch.distributed.collectives import Axis


# ==========================================================================
# dp / ZeRO (the sharded engine)
# ==========================================================================

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


# ==========================================================================
# the name rules
# ==========================================================================

class P(tuple):
    """A PartitionSpec: one entry a dim (None, an axis name, or a tuple of
    names); ``P()`` replicates."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


# name → base spec (without the layer-stack dim). "F" marks the FSDP slot.
_F = "__fsdp__"
_RULES: dict = {
    # embeddings / head
    "embed": ("model", _F),            # (V, D) vocab-parallel
    "lm_head": (_F, "model"),          # (D, V)
    # attention
    "wq": (_F, "model"), "wk": (_F, "model"), "wv": (_F, "model"),
    "wo": ("model", _F),
    "q_norm": (None,), "k_norm": (None,),
    # dense MLP
    "w_gate": (_F, "model"), "w_up": (_F, "model"), "w_down": ("model", _F),
    "w_in": (_F, "model"), "w_out": ("model", _F),
    # MoE (expert-parallel over "model")
    "router": (None, None),
    "we_gate": ("model", _F, None), "we_up": ("model", _F, None),
    "we_down": ("model", None, _F),
    # Mamba
    "in_proj": (_F, "model"), "out_proj": ("model", _F),
    "conv_w": (None, "model"), "x_proj": ("model", None),
    "dt_proj": (None, "model"), "dt_bias": ("model",),
    "A_log": ("model", None), "D": ("model",),
    # RWKV6
    "wr": (_F, "model"), "wg": (_F, "model"),
    "w_a": (_F, None), "w_b": (None, "model"),
    "u": (None, None), "mu": (None, None), "ln_scale": (None,),
    "w0": (None,),
    # norms
    "norm": (None,), "final_norm": (None,),
}

_ATTN_NAMES = {"wq", "wk", "wv", "wo", "q_norm", "k_norm"}
TP_MODES = ("full", "mlponly", "none")


def _sizes(grid) -> dict:
    return dict(zip(grid.axis_names, grid.shape))


def _dp_axes(grid):
    axes = tuple(a for a in grid.axis_names if a in ("pod", "data"))
    return axes if len(axes) > 1 else (axes[0] if axes else None)


def _names(entry) -> tuple:
    return entry if isinstance(entry, tuple) else ((entry,) if entry else ())


def _n(entry, sizes) -> int:
    return math.prod(sizes[a] for a in _names(entry))


_COMPONENT = re.compile(r"\['((?:[^'\\]|\\.)*)'\]|\[<flat index \d+>\]|\[\d+\]|\.([A-Za-z_]\w*)")


@functools.lru_cache(maxsize=4096)
def _last_name(path: str) -> str:
    """The last dict key of a keystr path, or its last attribute other than
    an Expansion's ``hi``/``lo`` (those follow their parameter)."""
    for m in reversed(list(_COMPONENT.finditer(path))):
        if m.group(1) is not None:
            return m.group(1)
        if m.group(2) is not None and m.group(2) not in ("hi", "lo"):
            return m.group(2)
    return ""


def param_spec(path: str, shape, grid, fsdp: bool = True, tp_mode: str = "full") -> P:
    """The spec of a parameter-shaped leaf. ``tp_mode``: "full", "mlponly"
    (attention replicated over "model": for archs whose head counts do not
    divide it) or "none" (pure FSDP; the model axis idle). An axis whose
    size does not divide its dim is dropped (granite's vocab 49155 stays
    whole on "model")."""
    if tp_mode not in TP_MODES:
        raise ValueError(f"tp_mode {tp_mode!r}: one of {TP_MODES}")
    shape = tuple(getattr(shape, "shape", shape))
    name = _last_name(path)
    base = _RULES.get(name)
    if base is None:
        return P()                         # replicate unknown/small leaves
    if tp_mode == "none" or (tp_mode == "mlponly" and name in _ATTN_NAMES):
        base = tuple(None if s == "model" else s for s in base)
    fs = _dp_axes(grid) if fsdp else None
    base = tuple(fs if s == _F else s for s in base)
    extra = len(shape) - len(base)
    assert extra in (0, 1), (name, shape, base)
    spec = (None,) * extra + base          # leading layer-stack dim
    sizes = _sizes(grid)
    return P(*(s if (n := _n(s, sizes)) > 1 and dim % n == 0 else None
               for dim, s in zip(shape, spec)))


_BUCKET_LEAF = re.compile(r"\.(" + "|".join(("data", "m", "vhi", "vlo", "delta", "master",
                                                "grad_err")) + r")\[\d+\]")


def _is_bucket_leaf(path: str, shape) -> bool:
    """A 1-D leaf reached through a BucketedParams/BucketedOptState role
    attribute then a tuple index (the per-bucket flat arrays)."""
    return len(tuple(shape)) == 1 and _BUCKET_LEAF.search(path) is not None


def bucket_spec(shape, grid, fsdp: bool = True) -> P:
    """A flat bucket along its single axis over the dp axes (ZeRO-3 style);
    replicated when its length does not divide them."""
    if not fsdp:
        return P()
    dp = _dp_axes(grid)
    if dp is None:
        return P()
    n = _n(dp, _sizes(grid))
    return P(dp) if n > 1 and tuple(shape)[0] % n == 0 else P()


# ==========================================================================
# the port's containers, named as jax.tree_util names the reference's
# ==========================================================================

# keyed nodes (GetAttrKey children, in the reference's flatten order)
_KEYED = {"TrainState": ("params", "opt_state", "grad_err"),
          "BucketedParams": ("data",),
          "BucketedOptState": ("step", "m", "vhi", "vlo", "delta", "master", "rng", "grad_err"),
          "DecodeState": ("layers", "pos"),
          "SlotState": ("state", "tok", "active", "done", "n_gen", "budget"),
          "SpecState": ("slots", "draft")}
# unkeyed nodes (FlattenedIndexKey children)
_UNKEYED = {"CollageOptState": ("step", "m", "v", "delta", "master", "rng")}


def _node(tree):
    name = type(tree).__name__
    if name in ("ParamTree", "ParamView"):
        from repro_torch.models.model import param_dict
        return "dict", param_dict(tree)
    return name, tree


def map_leaves(fn, tree, path: str = ""):
    """``fn(path, leaf)`` over the tensor (and ``P``) leaves of a tree of the
    port's containers (nested dicts, lists, tuples, Expansions, train and
    serving states), rebuilt in the same containers, dict keys sorted; host
    ints and None stay."""
    kind, tree = _node(tree)
    if isinstance(tree, (torch.Tensor, P)):
        return fn(path, tree)
    if tree is None or isinstance(tree, (int, float)):
        return tree
    if isinstance(tree, dict):
        return {k: map_leaves(fn, tree[k], f"{path}[{k!r}]") for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_leaves(fn, v, f"{path}[{i}]") for i, v in enumerate(tree))
    if isinstance(tree, Expansion):
        return Expansion(map_leaves(fn, tree.hi, f"{path}[<flat index 0>]"),
                         map_leaves(fn, tree.lo, f"{path}[<flat index 1>]"))
    if kind in _KEYED:
        return dataclasses.replace(tree, **{f: map_leaves(fn, getattr(tree, f), f"{path}.{f}")
                                            for f in _KEYED[kind]})
    if kind in _UNKEYED:
        return dataclasses.replace(tree, **{f: map_leaves(fn, getattr(tree, f),
                                                          f"{path}[<flat index {i}>]")
                                            for i, f in enumerate(_UNKEYED[kind])})
    raise TypeError(f"map_leaves: {type(tree).__name__} at {path!r}")


def named_leaves(tree) -> list:
    """[(keystr path, leaf)] of a tree's tensor and ``P`` leaves, in the
    reference's order."""
    out = []
    map_leaves(lambda path, leaf: out.append((path, leaf)), tree)
    return out


# ==========================================================================
# specs of whole trees
# ==========================================================================

def state_shardings(tree, grid, fsdp: bool = True, tp_mode: str = "full"):
    """Specs for a TrainState / params tree (the path rules); bucketed
    leaves get the flat-axis FSDP spec. Same containers, ``P`` leaves."""
    return map_leaves(lambda path, x: bucket_spec(x.shape, grid, fsdp)
                      if _is_bucket_leaf(path, x.shape)
                      else param_spec(path, x.shape, grid, fsdp, tp_mode), tree)


def _batch_rows(n_rows: int, grid):
    """The dp entry of a leading batch dim, or None (replicated) when the
    rows do not divide the dp ranks (e.g. a batch of one)."""
    dp = _dp_axes(grid)
    n = _n(dp, _sizes(grid)) if dp else 1
    return dp if n_rows % max(n, 1) == 0 else None


def batch_shardings(batch, grid):
    """Batch over the dp axes, replicated when B % n_dp ≠ 0."""
    def one(path, x):
        if x.dim() == 0:
            return P()
        rows = _batch_rows(x.shape[0], grid)
        return P() if rows is None else P(rows, *([None] * (x.dim() - 1)))
    return map_leaves(one, batch)


def cache_shardings(tree, grid, context_parallel: bool = False):
    """DecodeState / SlotState / SpecState specs: batch over dp, heads and
    channels over "model", per-row vectors with the batch rows; routed by
    leaf name, so SpecState's draft pool co-shards slot for slot with the
    target's. ``context_parallel``: the cache LENGTH over "data"."""
    sizes = _sizes(grid)
    dp = _dp_axes(grid)
    n_dp = _n(dp, sizes) if dp else 1
    tp = sizes.get("model", 1)

    def one(path, x):
        name, shape, nd = _last_name(path), tuple(x.shape), x.dim()
        rows = dp if nd and shape[0] % n_dp == 0 else None
        if name == "pos" and nd == 1:
            return P(rows)
        if name in ("active", "done", "n_gen", "budget") and nd == 1:
            return P(rows)
        if name == "tok" and nd == 2:
            return P(rows, None)
        bshard = dp if (nd > 1 and shape[1] % n_dp == 0) else None
        if name in ("k", "v") and nd == 5:           # (layers, B, S, hk, dh)
            hshard = "model" if shape[3] % tp == 0 else None
            if context_parallel:
                sshard = "data" if shape[2] % sizes.get("data", 1) == 0 else None
                return P(None, None, sshard, hshard, None)
            return P(None, bshard, None, hshard, None)
        if name == "h" and nd == 4:                  # mamba (layers, B, d_in, n)
            return P(None, bshard, "model", None)
        if name == "S" and nd == 5:                  # rwkv (layers, B, H, dk, dv)
            hshard = "model" if shape[2] % tp == 0 else None
            return P(None, bshard, hshard, None, None)
        if name == "conv" and nd == 4:               # (layers, B, K-1, d_in)
            return P(None, bshard, None, "model")
        if name == "last_x" and nd == 3:             # (layers, B, D)
            return P(None, bshard, None)
        return P()
    return map_leaves(one, tree)


# ==========================================================================
# blocks
# ==========================================================================

def _block_range(dim: int, entry, grid, coords=None) -> tuple:
    """(start, size) of this rank's block of a dim of length ``dim``: the
    axes of ``entry`` row-major, in tuple order."""
    names = _names(entry)
    if not names:
        return 0, dim
    sizes = _sizes(grid)
    coords = dict(zip(grid.axis_names, coords if coords is not None else grid.coords))
    idx = 0
    for a in names:
        idx = idx * sizes[a] + coords[a]
    k = dim // _n(entry, sizes)
    return idx * k, k


def block_slices(shape, spec, grid, coords=None) -> tuple:
    return tuple(slice(s, s + k) for s, k in
                 (_block_range(d, e, grid, coords) for d, e in zip(shape, _pad(spec, len(shape)))))


def _pad(spec, nd: int) -> tuple:
    return tuple(spec) + (None,) * (nd - len(spec))


def local_block(x: torch.Tensor, spec, grid, coords=None) -> torch.Tensor:
    """This rank's block of ``x`` under ``spec`` (a copy)."""
    return x[block_slices(x.shape, spec, grid, coords)].clone()


def _line(entry, grid) -> Axis:
    names = _names(entry)
    return grid.axis(names[0] if len(names) == 1 else "dp")


def gather_block(x: torch.Tensor, spec, grid) -> torch.Tensor:
    """The whole leaf from every rank's block (all-gathers over the lines
    of the spec's axes)."""
    for d, entry in enumerate(_pad(spec, x.dim())):
        if _names(entry):
            x = coll.gather_dim(x, _line(entry, grid), d, role="gather_block")
    return x


def _spec_of(specs: dict, path: str) -> P:
    return specs.get(path, P())


def local_tree(tree, specs, grid):
    """``local_block`` of every leaf, its spec found by path in ``specs``
    (a spec tree of the same containers)."""
    by_path = dict(named_leaves(specs))
    return map_leaves(lambda path, x: local_block(x, _spec_of(by_path, path), grid), tree)


def gather_tree(tree, specs, grid):
    """``gather_block`` of every leaf (the inverse of ``local_tree``)."""
    by_path = dict(named_leaves(specs))
    return map_leaves(lambda path, x: gather_block(x, _spec_of(by_path, path), grid), tree)


def owned(spec, grid) -> bool:
    """Whether this rank counts a leaf of ``spec`` in a sum over the grid:
    a leaf replicated over an axis counts once, on that axis' rank 0."""
    used = {a for e in spec for a in _names(e)}
    return all(c == 0 for a, c in zip(grid.axis_names, grid.coords) if a not in used)


# ==========================================================================
# the rank's forward: parameters and TP boundaries
# ==========================================================================

@dataclasses.dataclass(frozen=True)
class Split:
    """How a sublayer kind runs split over "model", the one table the
    grid's modules read (``materialize``, ``models.transformer``,
    ``train.grid.check_grid``).

    ``key``: the leaf that names the kind (``sublayer_kind``); ``mark``:
    the leaf whose block says whether the sublayer is split, split at dim
    ``dim`` of ``whole(cfg)`` entries; ``together``: the leaves that must be
    split when ``mark`` is (a rank's blocks of one split); ``summed``:
    leaves stored replicated over "model" that every rank applies to its
    own heads or channels, or ahead of a split product, so their gradient
    is partial per rank and summed over "model"; ``gathered``: leaves whose
    stored "model" block does not fall on the split the sublayer computes
    with, all-gathered over "model" (their gradient reduce-scattered)."""
    key: str
    mark: str
    dim: int
    whole: object
    together: tuple = ()
    summed: tuple = ()
    gathered: tuple = ()


# in the order ``sublayer_kind`` tries them (RWKV's time-mix also has a wr)
SPLITS = {
    "attn": Split("wq", "wq", -1, lambda c: c.n_heads * c.head_dim_,
                  summed=("q_norm", "k_norm")),
    "moe": Split("router", "we_gate", -3, lambda c: c.n_experts, ("we_up", "we_down")),
    "mamba": Split("in_proj", "dt_bias", -1, lambda c: c.ssm_expand * c.d_model,
                   ("in_proj", "conv_w", "x_proj", "dt_proj", "A_log", "D", "out_proj"),
                   gathered=("in_proj",)),
    "rwkv_tmix": Split("w0", "wr", -1, lambda c: c.d_model, ("wk", "wv", "wg", "w_b", "wo"),
                       summed=("mu", "w_a", "w0", "u", "ln_scale")),
    "rwkv_cmix": Split("wr", "wk", -1, lambda c: c.d_ff, ("wr", "wv"), summed=("mu",),
                       gathered=("wv",)),
}


def sublayer_kind(names) -> Optional[str]:
    """The sublayer kind of a dict of leaves named ``names``."""
    for kind, rule in SPLITS.items():
        if rule.key in names:
            return kind
    return None


def materialize(params, specs, grid, head_dim: int, over_dp: bool = True,
                per_layer: bool = False):
    """The tensors a rank's forward reads, from its parameter blocks, with
    autograd to the blocks: each dp-sharded dim all-gathered over dp (its
    gradient reduce-scattered) and each dp-replicated leaf's gradient
    summed over dp (``over_dp`` False: neither, for the bucketed layout,
    whose buckets are gathered and reduce-scattered whole); and, inside a
    sublayer split over "model":

    * attention: a KV projection whose block does not fall on head
      boundaries all-gathered over "model" (its stored spec stays), a
      replicated one and q/k norms with their gradient summed over "model";
    * Mamba: ``in_proj`` all-gathered over "model" (its column block does
      not fall on the x/z split: each rank takes its channels of both
      halves, ``models.ssm``);
    * RWKV time-mix: ``mu`` and ``w_a`` (applied ahead of split products)
      and ``w0``, ``u``, ``ln_scale`` (sliced to this rank's heads by
      ``models.rwkv``) with their gradient summed over "model";
    * RWKV channel-mix: ``mu`` summed likewise, ``wv`` all-gathered over
      "model" (the name rule splits its d columns; the product needs the
      rows of this rank's d_ff block, ``models.rwkv``).

    MoE needs nothing here: its experts are a block of the expert dim, and
    the router's sums happen in ``models.moe``.

    ``per_layer`` (FSDP's just-in-time gathers): a leaf whose chain gathers
    is not gathered here. A layer stack becomes a ``DeferredStack``, whose
    layer i is gathered from the rank's block when the forward takes it
    (``models.transformer.layer_params``), inside a rematerialised layer's
    body, so that the recompute gathers again; the embedding and the head
    become a ``Deferred``, gathered where the model uses them
    (``resolve``). Leaves whose chain gathers nothing (norms, replicated
    leaves) are taken whole as without it. The gathers, sums and their
    numbers are the same either way. The train step takes it (a layer's
    gathered weights live for its forward and its backward only); serving
    does not (a prefill and its decode steps read the same gathered
    weights, gathered once)."""
    by_path = dict(named_leaves(specs))
    siblings: dict = {}
    for path in by_path:
        siblings.setdefault(path[:path.rfind("[")], set()).add(_last_name(path))
    dp, model = grid.axis("dp"), grid.axis("model")

    def split(parent: str, kind: str) -> bool:
        return "model" in by_path.get(f"{parent}[{SPLITS[kind].mark!r}]", P())

    def plan(path, spec, shape) -> list:
        """The collectives of a leaf (or a layer of it) of ``shape`` under
        ``spec``: ("gather", axis, dim, role, back_role) or ("copy", axis,
        role)."""
        ops = []
        if over_dp:
            dp_dims = [d for d, e in enumerate(spec)
                       if _names(e) and set(_names(e)) <= {"pod", "data"}]
            ops += [("gather", dp, d, "fsdp_gather", "fsdp_scatter") for d in dp_dims]
            if not dp_dims:
                ops.append(("copy", dp, "grad"))
        name = _last_name(path)
        parent = path[:path.rfind("[")]
        kind = sublayer_kind(siblings.get(parent, ()))
        if kind is None or not split(parent, kind):
            return ops
        last = len(shape) - 1
        tp_gather = [("gather", model, last, "tp_gather", "tp_scatter")]
        if kind == "attn":
            if name == "wq" and shape[-1] % head_dim:
                raise ValueError(f"{path}: a block of {shape[-1]} query columns splits a head "
                                 f"of {head_dim}; tp_mode='mlponly' keeps attention whole")
            if name in ("wk", "wv") and "model" in spec and shape[-1] % head_dim:
                return ops + tp_gather
            if name in ("wk", "wv") and "model" not in spec:
                return ops + [("copy", model, "tp_reduce")]
        if name in SPLITS[kind].summed:
            return ops + [("copy", model, "tp_reduce")]
        if name in SPLITS[kind].gathered and "model" in spec:
            return ops + tp_gather
        return ops

    def run(ops, x):
        for op in ops:
            if op[0] == "gather":
                x = coll.all_gather_dim(x, *op[1:])
            else:
                x = coll.copy_to(x, op[1], role=op[2])
        return x

    def one(path, x):
        spec = _pad(_spec_of(by_path, path), x.dim())
        ops = plan(path, spec, tuple(x.shape))
        gathers = any(op[0] == "gather" for op in ops)
        if per_layer and gathers and "['groups']" in path:      # a layer stack: dim 0 whole
            lops = plan(path, spec[1:], tuple(x.shape[1:]))
            return DeferredStack(x, functools.partial(run, lops))
        if per_layer and gathers and _last_name(path) in ("embed", "lm_head"):
            return Deferred(x, functools.partial(run, ops))
        return run(ops, x)
    return map_leaves(one, params)


# ------------------------------------------------- FSDP's deferred gathers
class Deferred:
    """A parameter a rank gathers where its forward uses it (``get()``:
    ``materialize``'s collectives on the rank's block, with autograd to
    it): the embedding and the head under ``materialize(per_layer=True)``.
    Each ``get()`` gathers anew; the model drops the result after use."""

    def __init__(self, block: torch.Tensor, fn):
        self.block, self._fn = block, fn

    @property
    def device(self) -> torch.device:
        return self.block.device

    @property
    def dtype(self) -> torch.dtype:
        return self.block.dtype

    def get(self) -> torch.Tensor:
        return self._fn(self.block)


def resolve(x):
    """A parameter as a tensor: a ``Deferred`` is gathered here."""
    return x.get() if isinstance(x, Deferred) else x


# id(root of a gathered layer tensor) → (weakref to it, the zero-argument
# function that gathers it again)
_GATHERED: dict = {}


def _forget(key, ref):
    if _GATHERED.get(key, (None,))[0] is ref:
        del _GATHERED[key]


def _root(t: torch.Tensor) -> torch.Tensor:
    return t if t._base is None else t._base


def _regather(fn, x):
    with torch.no_grad():
        return fn(x.detach())


class DeferredStack:
    """A stacked layer leaf whose layers are gathered one at a time:
    ``stack[i]`` runs ``materialize``'s collectives on layer i of the rank's
    block (a view: ``unbind``, whose backward stacks the layers' gradients
    once, each already reduce-scattered when its layer's backward ended)
    and registers the result, so that ``regather_saved`` can save it as a
    key and gather it again in the backward."""

    def __init__(self, block: torch.Tensor, fn):
        self.block, self._fn = block, fn
        self._layers = block.unbind(0)

    def __len__(self) -> int:
        return len(self._layers)

    def __getitem__(self, layer: int) -> torch.Tensor:
        x = self._layers[layer]
        out = self._fn(x)
        root = _root(out)
        key = id(root)
        ref = weakref.ref(root, lambda r, k=key: _forget(k, r))
        _GATHERED[key] = (ref, functools.partial(_regather, self._fn, x))
        return out


@dataclasses.dataclass(frozen=True)
class _Regathered:
    """A saved gathered tensor, kept as the way to gather it again."""
    fn: object
    size: tuple
    stride: tuple
    offset: int


def _pack(t: torch.Tensor):
    root = _root(t)
    entry = _GATHERED.get(id(root))
    if entry is None or entry[0]() is not root:
        return t
    return _Regathered(entry[1], tuple(t.size()), t.stride(), t.storage_offset())


def _unpack(p):
    if not isinstance(p, _Regathered):
        return p
    return _root(p.fn()).as_strided(p.size, p.stride, p.offset)


def regather_saved():
    """Saved-tensor hooks for a layer run without rematerialisation: a
    tensor autograd saves that is (a view of) a ``DeferredStack`` layer's
    gathered result is saved as the way to gather it, and gathered again
    when the backward unpacks it, so the gathered layer is freed after its
    forward. Every rank unpacks in the same order (the same graph), so the
    collectives of the backward match."""
    return torch.autograd.graph.saved_tensors_hooks(_pack, _unpack)


class GridSharder:
    """The TP boundaries of a rank's forward on a grid (the port's
    ``make_activation_sharder``; installed with
    ``models.transformer.activation_sharding`` and called through
    ``shard_act(x, kind)``).

    A sublayer split over "model" (``tp``) reads a replicated input and
    leaves a partial output: without sequence parallelism the input is the
    identity whose gradient is summed over "model", the output is summed
    over "model". With it (``seq``, when the train step's L divides tp)
    the residual stream holds this rank's L/tp tokens: the input is
    all-gathered over the sequence (its gradient reduce-scattered), the
    output reduce-scattered, the norms run on local tokens and their
    weights' gradients are summed over "model". A sublayer every rank
    computes whole (``tp`` False) gathers its input and takes its own block
    of the output, with no sum either way.

    ``context_parallel``: decode attention over a cache whose length is
    split over "data" (``models.attention.decode_attention``).

    ``rows_split``: whether the batch rows of the running forward are split
    over dp (``batch_shardings``), so that a computation over the global
    batch (the MoE's capacity, positions and aux loss) sums over dp. It is
    set from the batch: ``local_batch`` cuts this rank's rows and records
    it; until then it is unknown, and ``dp_rows`` raises on a distributed
    dp (a batch of 3 on dp 2 is replicated, one of 4 split: which one the
    forward runs decides the routes)."""

    def __init__(self, grid, sp: bool = False, context_parallel: bool = False):
        self.grid = grid
        self.sp = bool(sp)
        self.context_parallel = bool(context_parallel)
        self.model = grid.axis("model")
        self.dp = grid.axis("dp")
        self.data = grid.axis("data")
        self.tp = grid.tp
        self.seq = False
        self.mem_seq = False
        self.rows_split = None

    @property
    def model_rank(self) -> int:
        return self.model.rank

    def local_batch(self, batch):
        """This rank's rows of a global batch (``batch_shardings``: over dp
        when they divide the dp ranks, else replicated), recording which."""
        spec = batch_shardings(batch, self.grid)
        first = named_leaves(spec)[0][1]
        self.rows_split = bool(first and first[0])
        return local_tree(batch, spec, self.grid)

    @property
    def dp_rows(self):
        """The dp line the batch rows are split over, or None."""
        if not self.dp.distributed:
            return None
        if self.rows_split is None:
            raise ValueError("the batch rows' split over dp is unknown: take the rank's rows "
                             "with GridSharder.local_batch")
        return self.dp if self.rows_split else None

    def block_start(self, local: int, whole: int) -> int:
        """The first index of this rank's block of ``local`` out of ``whole``
        along a dim split over "model" (0 when the rank holds it whole)."""
        return 0 if local == whole else self.model.rank * local

    def local_size(self, n: int) -> int:
        """A dim of ``n`` a rank holds under ``cache_shardings``' rule: its
        block over "model" when "model" divides it."""
        return n // self.tp if n % self.tp == 0 else n

    def begin_seq(self, length: int):
        """Sequence parallelism for a train forward of ``length`` tokens."""
        self.seq = self.sp and self.tp > 1 and length % self.tp == 0

    @contextlib.contextmanager
    def encoder(self, length: int):
        """The encoder's forward over ``length`` frames: sequence
        parallelism by its own length, which its output (the memory the
        cross-attention reads, ``kind="memory"``) keeps."""
        seq = self.seq
        self.begin_seq(length)
        self.mem_seq = self.seq
        try:
            yield
        finally:
            self.seq = seq

    def __call__(self, x, kind="seq", tp: bool = False):
        m = self.model
        if kind == "seq":                  # the residual stream after the embedding
            return coll.split_dim(x, m, 1) if self.seq else x
        if kind == "block_in":
            if self.seq:
                return coll.all_gather_dim(x, m, 1, "sp_gather", "sp_scatter") if tp \
                    else coll.gather_rep_dim(x, m, 1)
            return coll.copy_to(x, m) if tp else x
        if kind == "block_out":
            if self.seq:
                return coll.psum_scatter_dim(x, m, 1) if tp else coll.split_dim(x, m, 1)
            return coll.reduce_to(x, m) if tp else x
        if kind == "norm":                 # a norm weight applied to this rank's tokens
            return coll.copy_to(x, m) if self.seq else x
        if kind == "memory":               # the encoder's output into a cross-attention
            if self.mem_seq:
                return coll.all_gather_dim(x, m, 1, "sp_gather", "sp_scatter") if tp \
                    else coll.gather_rep_dim(x, m, 1)
            return coll.copy_to(x, m) if tp else x
        raise ValueError(f"shard_act kind {kind!r}")

    # ------------------------------------------------ vocab-parallel parts
    def vocab_start(self, local_vocab: int) -> int:
        return self.model.rank * local_vocab

    def embed(self, table, ids):
        """Rows of a vocab block: ids outside it read zeros, then Σ over
        "model"."""
        vl = table.shape[0]
        local = ids - self.vocab_start(vl)
        hit = (local >= 0) & (local < vl)
        rows = table[local.clamp(0, vl - 1)]
        rows = torch.where(hit[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                             device=rows.device))
        return coll.reduce_to(rows, self.model, role="vocab_reduce")

    def ce(self, logits, targets):
        """Per-token −log p(target) from vocab-block logits (f32)."""
        return _VocabCE.apply(logits, targets, self.model, self.vocab_start(logits.shape[-1]))

    def argmax(self, logits):
        """Greedy tokens from vocab-block logits: the argmax of the logits
        rounded to bf16, ties to the lowest global index (torch.argmax's)."""
        v = logits.to(torch.bfloat16)
        val, idx = v.max(dim=-1)
        idx = idx + self.vocab_start(logits.shape[-1])
        if not self.model.distributed:
            return idx
        vals = coll.gather_dim(val.float()[None], self.model, 0, role="vocab_reduce")
        idxs = coll.gather_dim(idx[None], self.model, 0, role="vocab_reduce")
        best = vals.max(dim=0).values
        big = torch.iinfo(idxs.dtype).max
        return torch.where(vals == best, idxs, big).min(dim=0).values

    # ------------------------------------------------- context parallelism
    def cache_span(self, length: int) -> tuple:
        """(start, local length) of this rank's span of a cache of
        ``length`` positions (the whole cache without context parallelism)."""
        if not self.context_parallel or not self.data.distributed:
            return 0, length
        k = length // self.data.size
        return self.data.rank * k, k


class _VocabCE(torch.autograd.Function):
    """−log softmax(logits)[target] over a vocab split on "model": the row
    max by pmax, Σexp and the target logit by psum; never the whole (…, V)
    logits. Backward: softmax − onehot on this rank's block."""

    @staticmethod
    def forward(ctx, logits, targets, axis, start):
        x = logits.float()
        m = coll.pmax(x.amax(dim=-1), axis, role="vocab_reduce")
        e = torch.exp(x - m[..., None])
        s = coll.psum(e.sum(dim=-1), axis, role="vocab_reduce")
        local = targets - start
        hit = (local >= 0) & (local < x.shape[-1])
        lc = local.clamp(0, x.shape[-1] - 1)
        t = torch.where(hit, torch.gather(x, -1, lc[..., None])[..., 0], torch.zeros((), device=x.device))
        t = coll.psum(t, axis, role="vocab_reduce")
        ctx.save_for_backward(e, s, lc, hit)
        return torch.log(s) + m - t

    @staticmethod
    def backward(ctx, g):
        e, s, lc, hit = ctx.saved_tensors
        grad = e / s[..., None] * g[..., None]
        grad.scatter_add_(-1, lc[..., None], -(g * hit)[..., None])
        return grad, None, None, None


def make_activation_sharder(grid, sp: bool = False, context_parallel: bool = False) -> GridSharder:
    """The object installed into ``models.transformer.activation_sharding``.

    ``sp``: Korthikanti-style sequence parallelism in the train forward:
    the residual stream between blocks split over "model" on the sequence
    dim, so a TP boundary's sum becomes a reduce-scatter (and an all-gather
    before the next product): half the bytes, and the norms run on 1/tp of
    the tokens."""
    return GridSharder(grid, sp, context_parallel)

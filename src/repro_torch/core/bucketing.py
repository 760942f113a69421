"""Bucketed multi-tensor layout, the port of ``repro.core.bucketing``: the
persistent flat representation behind the fused optimizer engine.

Parameter leaves are grouped by storage dtype (× an optional size cap) into
a few contiguous 1-D *buckets*, padded to ``pad_multiple``; a
``BucketLayout`` records where each leaf lives. All optimizer state is
bucket-resident, so one optimizer step is one fused launch per bucket.

Leaf order is that of ``jax.tree_util`` over the JAX parameter dict (sorted
dict keys, list order) and leaf names are its ``keystr`` paths, so the
port's ``to_json()`` of a model equals the JAX package's: the SR noise
index and the metric-partial tiling both depend on that order.

``BucketedParams.tree()`` gives the model-shaped view: every leaf is a view
of its bucket (one ``torch.split`` per bucket), so a backward pass through
the model leaves each bucket's gradient as ONE flat tensor — the port of
"differentiate w.r.t. buckets".

Also here: ``det_sum`` (the pinned-order reduction shared by the kernel
epilogue and the plain version) and the counter-based SR noise stream
(``lowbias32``, ``fold_seed``, ``sr_bits32``, ``sr_noise_bits``,
``stochastic_round_bits``).
torch has no uint32 ``>>`` or ``+``, so the 32-bit hash runs in int64
masked to 32 bits; products are split so that no int64 product overflows.

``rebucket``, ``migrate`` and ``state_template_for_layout`` move every
role array bit-exactly between two layouts (a checkpoint written under
another size cap or pad multiple).

``bucket_close_ranks``/``readiness_order``: at which point of the backward
pass each bucket's gradient is complete, and the order the buckets'
collectives may launch in.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

import torch

LANES = 128
SUBLANES = 8
PAD_DEFAULT = SUBLANES * LANES
MASK32 = 0xFFFFFFFF

_DTYPE_NAMES = {torch.bfloat16: "bfloat16", torch.float16: "float16",
                torch.float32: "float32"}  # f32-ok: dtype names of the layout's JSON
_NAMED_DTYPES = {v: k for k, v in _DTYPE_NAMES.items()}


def dtype_name(dt: torch.dtype) -> str:
    return _DTYPE_NAMES[dt]


def named_dtype(name: str) -> torch.dtype:
    return _NAMED_DTYPES[name]


# --------------------------------------------------------------------------
# pytree flattening of nested dicts/lists, in jax.tree_util's order
# --------------------------------------------------------------------------

def tree_flatten_with_path(tree: Any, path: str = ""):
    """[(keystr path, leaf)] in jax.tree_util's order (sorted dict keys,
    list order) and a skeleton for ``tree_unflatten``."""
    if isinstance(tree, dict):
        out, skel = [], {}
        for k in sorted(tree):
            sub, skel[k] = tree_flatten_with_path(tree[k], f"{path}[{k!r}]")
            out += sub
        return out, skel
    if isinstance(tree, (list, tuple)):
        out, skel = [], []
        for i, v in enumerate(tree):
            sub, s = tree_flatten_with_path(v, f"{path}[{i}]")
            out += sub
            skel.append(s)
        return out, skel
    return [(path, tree)], None


def tree_unflatten(skel: Any, leaves: Sequence) -> Any:
    it = iter(leaves)

    def build(s):
        if isinstance(s, dict):
            return {k: build(v) for k, v in s.items()}
        if isinstance(s, list):
            return [build(v) for v in s]
        return next(it)

    out = build(skel)
    if next(it, None) is not None:
        raise ValueError("more leaves than the skeleton holds")
    return out


def tree_leaves(tree: Any) -> list:
    return [leaf for _, leaf in tree_flatten_with_path(tree)[0]]


def tree_map(fn, tree: Any, *rest: Any) -> Any:
    """``fn`` leaf by leaf over trees of one structure (nested dicts and
    lists; anything else, an Expansion included, is a leaf)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)


# --------------------------------------------------------------------------
# layout metadata
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LeafSlot:
    """Placement of one parameter leaf inside its bucket."""

    name: str                 # keystr path
    bucket: int
    offset: int               # element offset inside the bucket
    size: int
    shape: tuple


@dataclasses.dataclass(frozen=True)
class BucketSpec:
    dtype: str                # storage dtype of the parameter bucket
    size: int                 # sum of leaf sizes (unpadded)
    padded: int               # size rounded up to pad_multiple


@dataclasses.dataclass(frozen=True)
class BucketLayout:
    """Persistent flat-param layout. ``slots`` are in tree leaf order;
    ``treedef`` is the nested dict/list skeleton the leaves unflatten into
    (not compared: two layouts are equal when their placement is)."""

    treedef: Any = dataclasses.field(compare=False, hash=False, repr=False)
    slots: tuple = ()
    buckets: tuple = ()
    pad_multiple: int = PAD_DEFAULT

    @property
    def n_buckets(self) -> int:
        return len(self.buckets)

    @property
    def total_size(self) -> int:
        return sum(b.size for b in self.buckets)

    def to_json(self) -> dict:
        return {
            "pad_multiple": self.pad_multiple,
            "buckets": [[b.dtype, b.size, b.padded] for b in self.buckets],
            "slots": [[s.name, s.bucket, s.offset, s.size, list(s.shape)] for s in self.slots],
        }

    @classmethod
    def from_json(cls, d: dict, treedef) -> "BucketLayout":
        buckets = tuple(BucketSpec(dt, int(sz), int(pad)) for dt, sz, pad in d["buckets"])
        slots = tuple(LeafSlot(n, int(b), int(o), int(s), tuple(sh))
                      for n, b, o, s, sh in d["slots"])
        return cls(treedef, slots, buckets, int(d["pad_multiple"]))


def build_layout(params: Any, *, max_bucket_elems: Optional[int] = None,
                 pad_multiple: int = PAD_DEFAULT) -> BucketLayout:
    """Group parameter leaves by dtype (× size cap) into contiguous buckets;
    leaves keep tree order within a bucket."""
    if pad_multiple % LANES:
        raise ValueError(f"pad_multiple {pad_multiple} is not a multiple of {LANES}")
    flat, skel = tree_flatten_with_path(params)
    open_buckets: dict = {}
    buckets: list = []
    slots = []
    for path, leaf in flat:
        dt = dtype_name(leaf.dtype)
        b = open_buckets.get(dt)
        if b is None or (max_bucket_elems is not None
                         and buckets[b][1] + leaf.numel() > max_bucket_elems
                         and buckets[b][1] > 0):
            b = len(buckets)
            buckets.append([dt, 0])
            open_buckets[dt] = b
        slots.append(LeafSlot(path, b, buckets[b][1], int(leaf.numel()), tuple(leaf.shape)))
        buckets[b][1] += int(leaf.numel())
    specs = tuple(BucketSpec(dt, sz, sz + (-sz) % pad_multiple) for dt, sz in buckets)
    return BucketLayout(skel, tuple(slots), specs, pad_multiple)


# --------------------------------------------------------------------------
# bucket / unbucket
# --------------------------------------------------------------------------

def bucket_close_ranks(layout: BucketLayout, leaf_ranks: Sequence[int]) -> tuple:
    """Per-bucket readiness rank: the rank at which the bucket closes, the
    max over its leaves of ``leaf_ranks[i]`` (the point, in any monotone
    unit, at which leaf i's gradient is ready; leaves in ``layout.slots``
    order)."""
    if len(leaf_ranks) != len(layout.slots):
        raise ValueError(f"{len(leaf_ranks)} ranks for {len(layout.slots)} leaves")
    close = [None] * layout.n_buckets
    for slot, r in zip(layout.slots, leaf_ranks):
        if close[slot.bucket] is None or r > close[slot.bucket]:
            close[slot.bucket] = r
    return tuple(close)


def readiness_order(layout: BucketLayout, leaf_ranks: Sequence[int]) -> tuple:
    """Bucket indices sorted by close rank (ties: layout order): the order
    in which the buckets' gradient collectives become launchable."""
    close = bucket_close_ranks(layout, leaf_ranks)
    return tuple(sorted(range(layout.n_buckets), key=lambda b: (close[b], b)))


def bucket_leaves(leaves: Sequence[torch.Tensor], layout: BucketLayout, dtype=None) -> tuple:
    """Concatenate per-leaf tensors into the layout's flat buckets (``dtype``
    None: each bucket keeps its spec dtype; else all cast to it)."""
    per_bucket: list = [[] for _ in layout.buckets]
    for slot, leaf in zip(layout.slots, leaves):
        if leaf.numel() != slot.size:
            raise ValueError(f"{slot.name}: {tuple(leaf.shape)} vs {slot.shape}")
        per_bucket[slot.bucket].append(leaf.reshape(-1))
    out = []
    for spec, parts in zip(layout.buckets, per_bucket):
        dt = dtype if dtype is not None else named_dtype(spec.dtype)
        parts = [p.to(dt) for p in parts]
        pad = spec.padded - spec.size
        if pad:
            parts.append(torch.zeros((pad,), dtype=dt, device=parts[0].device))
        out.append(torch.cat(parts) if len(parts) > 1 else parts[0].clone())
    return tuple(out)


def bucket_tree(tree: Any, layout: BucketLayout, dtype=None) -> tuple:
    return bucket_leaves(tree_leaves(tree), layout, dtype)


def unbucket_leaves(data: Sequence[torch.Tensor], layout: BucketLayout) -> list:
    """Per-leaf views of the buckets: one ``torch.split`` per bucket, so the
    backward of all of a bucket's views is one concatenation into a flat
    gradient."""
    per_bucket: list = [[] for _ in layout.buckets]
    for i, slot in enumerate(layout.slots):
        per_bucket[slot.bucket].append(i)
    out: list = [None] * len(layout.slots)
    for b, (spec, idx) in enumerate(zip(layout.buckets, per_bucket)):
        sizes = [layout.slots[i].size for i in idx]
        if spec.padded > spec.size:
            sizes.append(spec.padded - spec.size)
        parts = torch.split(data[b], sizes)
        for i, part in zip(idx, parts):
            out[i] = part.view(layout.slots[i].shape)
    return out


def unbucket(data: Sequence[torch.Tensor], layout: BucketLayout) -> Any:
    return tree_unflatten(layout.treedef, unbucket_leaves(data, layout))


@dataclasses.dataclass
class BucketedParams:
    """Parameters as persistent flat buckets; ``tree()`` is the model view."""

    data: tuple
    layout: BucketLayout

    def tree(self) -> Any:
        return unbucket(self.data, self.layout)


@dataclasses.dataclass
class BucketedOptState:
    """All optimizer state bucket-resident, one flat tensor per bucket per
    role (None where the strategy has no such role): ``m``, ``vhi``/``vlo``
    (vlo for Collage-plus), ``delta`` (δθ or Kahan c), ``master`` (fp32, D).
    ``step`` is a host int; ``rng`` the uint32 SR seed as a host int."""

    step: int
    m: tuple
    vhi: tuple
    vlo: Optional[tuple]
    delta: Optional[tuple]
    master: Optional[tuple]
    rng: Optional[int]
    layout: BucketLayout
    grad_err: Optional[tuple] = None


def rebucket(data: Sequence[torch.Tensor], old: BucketLayout, new: BucketLayout) -> tuple:
    """One role's buckets moved from layout ``old`` to ``new``, bit-exactly;
    each bucket keeps the dtype of the old buckets (f32 moments stay f32)."""
    if len(old.slots) != len(new.slots):
        raise ValueError(f"{len(old.slots)} leaves vs {len(new.slots)}")
    leaves = unbucket_leaves(data, old)
    per_bucket: list = [[] for _ in new.buckets]
    for slot, leaf in zip(new.slots, leaves):
        per_bucket[slot.bucket].append(leaf.reshape(-1))
    out = []
    for spec, parts in zip(new.buckets, per_bucket):
        pad = spec.padded - spec.size
        if pad:
            parts.append(torch.zeros((pad,), dtype=parts[0].dtype, device=parts[0].device))
        out.append(torch.cat(parts))
    return tuple(out)


def _no_grad_err(state: BucketedOptState):
    if state.grad_err is not None:
        raise NotImplementedError("moving grad_err (gradient compression) between bucket "
                                  "layouts: not yet ported to repro_torch")


def _map_bucketed(obj: Any, fix) -> Any:
    """``fix`` applied to every BucketedParams / BucketedOptState inside
    ``obj`` (dataclasses, such as a TrainState, tuples, lists and dicts)."""
    if isinstance(obj, (BucketedParams, BucketedOptState)):
        return fix(obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, (type, BucketLayout)):
        return dataclasses.replace(obj, **{f.name: _map_bucketed(getattr(obj, f.name), fix)
                                           for f in dataclasses.fields(obj) if f.init})
    if isinstance(obj, (list, tuple)):
        return type(obj)(_map_bucketed(x, fix) for x in obj)
    if isinstance(obj, dict):
        return {k: _map_bucketed(v, fix) for k, v in obj.items()}
    return obj


def migrate(obj: Any, new_layout: BucketLayout) -> Any:
    """``obj`` with every bucketed node re-expressed under ``new_layout``
    (values preserved bit-exactly)."""

    def fix(x):
        if isinstance(x, BucketedParams):
            return BucketedParams(rebucket(x.data, x.layout, new_layout), new_layout)
        _no_grad_err(x)
        rb = lambda t: None if t is None else rebucket(t, x.layout, new_layout)
        return BucketedOptState(x.step, rb(x.m), rb(x.vhi), rb(x.vlo), rb(x.delta),
                                rb(x.master), x.rng, new_layout)

    return _map_bucketed(obj, fix)


def state_template_for_layout(obj: Any, layout: BucketLayout) -> Any:
    """A zero-valued copy of ``obj`` with its bucketed nodes shaped for
    ``layout`` (each role keeps its dtype): the restore template of a
    checkpoint written under another bucket partitioning."""

    def zeros_for(t):
        if t is None:
            return None
        return tuple(torch.zeros((b.padded,), dtype=t[0].dtype, device=t[0].device)
                     for b in layout.buckets)

    def fix(x):
        if isinstance(x, BucketedParams):
            dev = x.data[0].device
            return BucketedParams(tuple(torch.zeros((b.padded,), dtype=named_dtype(b.dtype),
                                                    device=dev) for b in layout.buckets), layout)
        _no_grad_err(x)
        return BucketedOptState(x.step, zeros_for(x.m), zeros_for(x.vhi), zeros_for(x.vlo),
                                zeros_for(x.delta), zeros_for(x.master), x.rng, layout)

    return _map_bucketed(obj, fix)


# --------------------------------------------------------------------------
# deterministic reduction
# --------------------------------------------------------------------------

def det_sum(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Bit-deterministic sum along ``dim`` (a 1-D tensor is flattened):
    binary-tree halving ``y[i] = x[i] + x[i + half]``, and for odd n
    ``y[0] += x[n-1]`` — the JAX package's order, element for element. A
    2-D tensor reduces each column (dim 0) or row (dim 1) independently."""
    if x.dim() == 1 or dim is None:
        x, dim = x.reshape(-1), 0
    n = x.shape[dim]
    while n > 1:
        half = n // 2
        y = x.narrow(dim, 0, half) + x.narrow(dim, half, half)
        if n - 2 * half:
            first = y.narrow(dim, 0, 1) + x.narrow(dim, n - 1, 1)
            y = torch.cat([first, y.narrow(dim, 1, half - 1)], dim=dim)
        x, n = y, half
    return x.select(dim, 0)


# --------------------------------------------------------------------------
# counter-based SR noise stream (uint32 arithmetic in int64 masked)
# --------------------------------------------------------------------------

_GOLDEN = 0x9E3779B9


def _u32(x) -> torch.Tensor:
    return torch.as_tensor(x).to(torch.int64) & MASK32


def mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x · c) mod 2^32 for x in [0, 2^32) held in int64: the product is
    split at 16 bits of c so that no int64 product overflows."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def lowbias32(x) -> torch.Tensor:
    """32-bit integer hash (bias-optimized murmur3 finalizer), as int64."""
    x = _u32(x)
    x = x ^ (x >> 16)
    x = mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = mul32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    return x


def fold_seed(seed, *vals) -> torch.Tensor:
    """Per-(step, bucket) seed from the run seed (counter-based RNG)."""
    s = _u32(seed)
    for v in vals:
        s = lowbias32(s ^ mul32(_u32(v), _GOLDEN))
    return s


def sr_bits32(idx, seed) -> torch.Tensor:
    """32 uniform random bits per element, keyed by the element's index and
    the folded seed (int64 in [0, 2^32))."""
    return lowbias32((mul32(_u32(idx), _GOLDEN) + int(_u32(seed))) & MASK32)


def sr_noise_bits(idx, seed) -> torch.Tensor:
    """16 uniform noise bits per element, keyed by the element's global
    index within its bucket and the folded seed (int64 in [0, 2^16))."""
    return sr_bits32(idx, seed) & 0xFFFF


def stochastic_round_bits(x32: torch.Tensor, noise16: torch.Tensor) -> torch.Tensor:
    """SR f32 → bf16 grid: add 16 noise bits below the kept mantissa, then
    truncate (E[SR(x)] = x). Returns on-grid f32."""
    # f32-ok: SR reads the f32 bit pattern (x32 is f32 already)
    bits = x32.to(torch.float32).view(torch.int32).to(torch.int64) & MASK32
    rounded = (bits + noise16) & 0xFFFF0000
    # f32-ok: the result lies on the bf16 grid, held in f32
    return torch.where(rounded >= 2**31, rounded - 2**32, rounded).to(torch.int32).view(
        torch.float32)

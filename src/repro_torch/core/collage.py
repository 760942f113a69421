"""Collage: precision-aware AdamW (Paper Algorithm 2), the port of
``repro.core.collage`` for the bucketed layout.

``init`` builds the tree-layout state (zeros of the right roles and
dtypes); ``init_bucketed``/``step_bucketed`` keep params and all optimizer
state as persistent flat buckets (``core.bucketing``) and run one fused
update per bucket (``kernels.collage_update.ops.bucketed_step``).

Scalars (lr, bias corrections) are computed on the host in numpy float32
and passed to the update by value, so a step never synchronises with the
card to read them. numpy's float32 ``pow``/``cos`` may differ from XLA's in
the last bit at some steps; parity tests feed the JAX package's scalars.

Not ported yet: the tree-layout ``step`` (and its per-leaf threefry SR) and
``convert_state``; both raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import bucketing, mcf
from repro_torch.core.mcf import Expansion
from repro_torch.core.precision import PrecisionPolicy, Strategy

Schedule = Callable[[int], np.float32]
F32 = torch.float32


@dataclasses.dataclass
class CollageOptState:
    """Tree-layout optimizer state (nested dicts shaped like the params)."""

    step: int
    m: Any
    v: Any                          # Expansion leaves for Collage-plus
    delta: Optional[Any]
    master: Optional[Any]
    rng: Optional[int]              # SR seed


class StepMetrics(NamedTuple):
    """Per-step precision diagnostics (Paper Def. 3.3 & Fig. 3)."""

    edq: torch.Tensor
    update_norm: torch.Tensor
    effective_norm: torch.Tensor
    imprecision_pct: torch.Tensor
    grad_norm: torch.Tensor


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(fn, v) for v in tree]
    return fn(tree)


class CollageAdamW:
    """AdamW with a selectable precision strategy (Paper Table 2)."""

    def __init__(self, learning_rate: float | Schedule, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 0.0,
                 policy: PrecisionPolicy | None = None, compute_metrics: bool = False,
                 use_fused_kernel: bool = False, sr_seed: int = 0):
        self.lr = learning_rate if callable(learning_rate) \
            else (lambda t: np.float32(learning_rate))
        self.b1 = float(b1)
        self.b2 = float(b2)
        self.eps = float(eps)
        self.wd = float(weight_decay)
        self.policy = policy or PrecisionPolicy()
        self.compute_metrics = compute_metrics
        self.use_fused_kernel = use_fused_kernel
        self.sr_seed = int(sr_seed)

    def init(self, params: Any) -> CollageOptState:
        s = self.policy.strategy
        cdt = self.policy.param_dtype
        zeros = lambda dt: _map(lambda p: torch.zeros(p.shape, dtype=dt, device=p.device),
                                params)
        if s in (Strategy.D_MINUS_MW, Strategy.D_MIXED_MW):
            m, v = zeros(F32), zeros(F32)
        else:
            m, v = zeros(cdt), zeros(cdt)
        if s.uses_expansion_second_moment:
            v = _map(mcf.zeros_like_expansion, v)
        delta = zeros(cdt) if (s.uses_expansion_params or s is Strategy.KAHAN) else None
        master = _map(lambda p: p.to(F32), params) if s.uses_master_weights else None
        rng = self.sr_seed if s is Strategy.SR else None
        return CollageOptState(step=0, m=m, v=v, delta=delta, master=master, rng=rng)

    def init_bucketed(self, params: Any):
        """Params + optimizer state as persistent flat buckets (layout knobs
        from ``policy.bucketing``)."""
        bp = self.policy.bucketing
        layout = bucketing.build_layout(params, max_bucket_elems=bp.max_bucket_elems,
                                        pad_multiple=bp.pad_multiple)
        return bucket_state(self.init(params), params, layout, self.policy,
                            sr_seed=self.sr_seed)

    def step_bucketed(self, grads, bparams, bstate, *, elem_offsets=None, reduce_fn=None):
        """One step over buckets: one fused update per bucket."""
        from repro_torch.kernels.collage_update import ops as kops
        return kops.bucketed_step(self, grads, bparams, bstate, elem_offsets=elem_offsets,
                                  reduce_fn=reduce_fn)

    def step(self, grads, params, state, **kw):
        raise NotImplementedError(
            "CollageAdamW.step (tree layout): not yet ported to repro_torch; "
            "use the bucketed layout (policy.bucketing.enabled)")


def bucket_state(state: CollageOptState, params: Any, layout: bucketing.BucketLayout,
                 policy: PrecisionPolicy, *, sr_seed: int = 0):
    """Lift a tree-layout (params, CollageOptState) into the bucket layout."""
    s = policy.strategy
    opt_dt = F32 if s in (Strategy.D_MINUS_MW, Strategy.D_MIXED_MW) else None
    for b in layout.buckets:
        if bucketing.named_dtype(b.dtype) != policy.param_dtype:
            raise TypeError(f"bucket dtype {b.dtype} vs policy {policy.param_dtype}")
    bparams = bucketing.BucketedParams(bucketing.bucket_tree(params, layout), layout)
    m = bucketing.bucket_tree(state.m, layout, dtype=opt_dt)
    if s.uses_expansion_second_moment:
        leaves_v = _expansion_leaves(state.v)
        vhi = bucketing.bucket_leaves([e.hi for e in leaves_v], layout)
        vlo = bucketing.bucket_leaves([e.lo for e in leaves_v], layout)
    else:
        vhi = bucketing.bucket_tree(state.v, layout, dtype=opt_dt)
        vlo = None
    delta = bucketing.bucket_tree(state.delta, layout) if state.delta is not None else None
    master = bucketing.bucket_tree(state.master, layout, dtype=F32) \
        if state.master is not None else None
    rng = int(sr_seed) & bucketing.MASK32 if s is Strategy.SR else None
    return bparams, bucketing.BucketedOptState(
        step=int(state.step), m=m, vhi=vhi, vlo=vlo, delta=delta, master=master, rng=rng,
        layout=layout)


def _expansion_leaves(tree) -> list:
    if isinstance(tree, Expansion):
        return [tree]
    if isinstance(tree, dict):
        return [e for k in sorted(tree) for e in _expansion_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [e for v in tree for e in _expansion_leaves(v)]
    raise TypeError(f"not an Expansion tree: {type(tree)}")


def unbucket_state(bparams: bucketing.BucketedParams, bstate: bucketing.BucketedOptState,
                   policy: PrecisionPolicy):
    """Inverse of ``bucket_state`` (values preserved bit-exactly)."""
    s = policy.strategy
    layout = bparams.layout
    params = bparams.tree()
    m = bucketing.unbucket(bstate.m, layout)
    if s.uses_expansion_second_moment:
        his = bucketing.unbucket_leaves(bstate.vhi, layout)
        los = bucketing.unbucket_leaves(bstate.vlo, layout)
        v = bucketing.tree_unflatten(layout.treedef,
                                     [Expansion(h, lo) for h, lo in zip(his, los)])
    else:
        v = bucketing.unbucket(bstate.vhi, layout)
    delta = bucketing.unbucket(bstate.delta, layout) if bstate.delta is not None else None
    master = bucketing.unbucket(bstate.master, layout) if bstate.master is not None else None
    return params, CollageOptState(step=bstate.step, m=m, v=v, delta=delta, master=master,
                                   rng=bstate.rng)


def convert_state(*args, **kw):
    raise NotImplementedError("convert_state: not yet ported to repro_torch")


def cosine_schedule(base_lr: float, warmup: int, total: int, min_ratio: float = 0.1) -> Schedule:
    """CosineAnnealing with linear warmup, evaluated in numpy float32 with
    the JAX package's operation order."""
    f32 = np.float32

    def f(t):
        tf = f32(t)
        warm = tf / f32(max(warmup, 1))
        prog = np.clip((tf - f32(warmup)) / f32(max(total - warmup, 1)), f32(0.0), f32(1.0))
        cos = f32(min_ratio) + f32((1 - min_ratio) * 0.5) * (f32(1) + np.cos(f32(np.pi) * prog))
        return f32(f32(base_lr) * (warm if tf < f32(warmup) else cos))

    return f

"""Collage: precision-aware AdamW (Paper Algorithm 2), the port of
``repro.core.collage``.

Two layouts, as in the JAX package:

* tree layout (``init``/``step``): per-leaf state in nested dicts shaped
  like the params, one eager update per leaf. With ``use_fused_kernel``
  the step goes through the bucket engine's shim
  (``kernels.collage_update.ops.fused_step``), which re-buckets every call.
* bucket layout (``init_bucketed``/``step_bucketed``): params and all
  optimizer state as persistent flat buckets (``core.bucketing``), one
  fused update per bucket (``kernels.collage_update.ops.bucketed_step``).

The tree step's arithmetic is the JAX package's ``_leaf_step``: every f32
operation a separate eager op, rounded on its own (no FMA: no ``addcmul``
or ``lerp`` on f32 state), every bf16 rounding ``x.to(bfloat16).float()``,
and the square root taken in f64 and rounded once (torch's vectorised CPU
``sqrt`` is not correctly rounded). Its metric partials ⟨Δθ,Δθ̂⟩, ‖Δθ‖²,
‖Δθ̂‖² and the lost count come from ``kernels.edq.edq_partials`` (one
launch per leaf on the card), ‖g‖² from a torch sum. Stochastic rounding
draws its noise from the counter-based hash of ``core.bucketing``, keyed by
(seed, step, leaf index, element index): the JAX package splits a threefry
key per leaf, a stream the port cannot reproduce.

Scalars (lr, bias corrections) are computed on the host in numpy float32
and passed to the update by value, so a step never synchronises with the
card to read them. numpy's float32 ``pow``/``cos`` may differ from XLA's in
the last bit at some steps; parity tests feed the JAX package's scalars.

``step(..., metrics_partials=True)`` returns the raw per-leaf metric
partials in place of the StepMetrics (the pipeline engine sums the stage
leaves' and the shared leaves' apart and finalizes once);
``step_bucketed(..., metrics_partials=True)`` their sum over the buckets
(the ZeRO engine sums them over the dp ranks and finalizes once).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import bucketing, mcf
from repro_torch.core.mcf import Expansion
from repro_torch.core.precision import PrecisionPolicy, Strategy
from repro_torch.kernels.edq import edq as kedq

# Leaves past this many elements are updated in flat chunks of it. The
# strict-FPU update holds ~20 f32 copies of what it updates at once, which
# on a large leaf (gpt-125m's 38.6 M-element embedding: ~3 GB) outgrows the
# bytes Collage saves over D; every op is elementwise, so the chunks give
# the same bits (``tests/test_torch_audit.py``). Each chunk costs its ~150
# eager launches again: 2^22 chunks slowed gpt-125m's tree C step on the
# card; at 2^24 its optimizer still peaks below its backward.
LEAF_CHUNK = 1 << 24

SR_FUSED_BLOCKS = ("SR through the fused shim on blocks of leaves: the kernel indexes its noise "
                   "by a bucket offset, not by a block's place in its leaf (ROADMAP.md Queue 1 "
                   "item 7b)")

Schedule = Callable[[int], np.float32]  # f32-ok: host schedule values in numpy f32
F32 = torch.float32  # f32-ok: the strict-FPU update's working dtype


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


class CollageAdamW:
    """AdamW with a selectable precision strategy (Paper Table 2)."""

    def __init__(self, learning_rate: float | Schedule, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 0.0,
                 policy: PrecisionPolicy | None = None, compute_metrics: bool = False,
                 use_fused_kernel: bool = False, sr_seed: int = 0):
        # f32-ok: the host lr in numpy f32, the JAX package's scalar
        self.lr = learning_rate if callable(learning_rate) \
            else (lambda t: np.float32(learning_rate))  # f32-ok
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
        zeros = lambda dt: bucketing.tree_map(
            lambda p: torch.zeros(p.shape, dtype=dt, device=p.device), params)
        if s in (Strategy.D_MINUS_MW, Strategy.D_MIXED_MW):
            m, v = zeros(F32), zeros(F32)
        else:
            m, v = zeros(cdt), zeros(cdt)
        if s.uses_expansion_second_moment:
            v = bucketing.tree_map(mcf.zeros_like_expansion, v)
        delta = zeros(cdt) if (s.uses_expansion_params or s is Strategy.KAHAN) else None
        master = bucketing.tree_map(lambda p: p.to(F32), params) \
            if s.uses_master_weights else None
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

    def step_bucketed(self, grads, bparams, bstate, *, metrics_partials: bool = False,
                      elem_offsets=None, reduce_fn=None, donate=False):
        """One step over buckets: one fused update per bucket (``donate``:
        written over the old buckets). ``metrics_partials``: the raw summed
        metric partials in place of the StepMetrics."""
        from repro_torch.kernels.collage_update import ops as kops
        return kops.bucketed_step(self, grads, bparams, bstate,
                                  metrics_partials=metrics_partials, elem_offsets=elem_offsets,
                                  reduce_fn=reduce_fn, donate=donate)

    def step(self, grads, params, state: CollageOptState, *, metrics_partials: bool = False,
             scalars=None, blocks=None):
        """One tree-layout step → ``(new_params, new_state, StepMetrics)``.
        ``scalars``: (lr, bc1, bc2) to use in place of the host-computed ones
        (parity tests feed the JAX package's). ``metrics_partials``: in
        place of the StepMetrics, the per-leaf raw partials (⟨Δθ,Δθ̂⟩,
        ‖Δθ‖², ‖Δθ̂‖², #lost, ‖g‖²), a list in leaf order (zeros without
        ``compute_metrics``): plain sums, so a caller may add those of
        several leaves or shards and finalize once. ``blocks``: per leaf
        (leaf order), None or the (whole leaf's shape, block start per dim)
        of a block the leaf is (a grid rank's): SR then draws each
        element's noise at its index in the whole leaf, so the block's
        update is the one-rank update's, bit for bit."""
        from repro_torch.kernels.collage_update import ops as kops

        t = state.step + 1
        lr, bc1, bc2 = scalars if scalars is not None else kops._scalars(self, t)
        if self.use_fused_kernel:
            if metrics_partials:
                raise ValueError("metrics_partials is a tree-layout feature (per-leaf "
                                 "partials); the fused shim reduces per bucket")
            if blocks is not None and self.policy.strategy is Strategy.SR and any(blocks):
                raise ValueError(SR_FUSED_BLOCKS)
            return kops.fused_step(self, grads, params, state, scalars=(lr, bc1, bc2))

        s = self.policy.strategy
        flat, skel = bucketing.tree_flatten_with_path(grads)
        leaves_g = [g for _, g in flat]
        n = len(leaves_g)
        leaves_p = bucketing.tree_leaves(params)
        leaves_m = bucketing.tree_leaves(state.m)
        leaves_v = bucketing.tree_leaves(state.v)
        leaves_d = bucketing.tree_leaves(state.delta) if state.delta is not None else [None] * n
        leaves_w = bucketing.tree_leaves(state.master) if state.master is not None else [None] * n
        seeds = [bucketing.fold_seed(state.rng, t, i) if s is Strategy.SR else None
                 for i in range(n)]
        blocks = [None] * n if blocks is None else list(blocks)
        dev = leaves_g[0].device
        sc = {"lr": _host(lr), "bc1": _host(bc1), "bc2": _host(bc2)}

        outs, parts = [], []
        for *args, block in zip(leaves_g, leaves_p, leaves_m, leaves_v, leaves_d, leaves_w, seeds,
                                blocks):
            *out, upd, eff = self._leaf_update(*args, sc, block=block)
            outs.append(out)
            if self.compute_metrics:     # taken leaf by leaf: Δθ, Δθ̂ are freed at once
                parts.append(self._leaf_partials(args[0], upd, eff))
        new_p, new_m, new_v, new_d, new_w = map(list, zip(*outs))

        if metrics_partials:
            metrics = parts if self.compute_metrics else [kops._zeros5(dev) for _ in range(n)]
        elif self.compute_metrics:
            metrics = kops.finalize_metrics(kops.sum_partials(parts, dev),
                                            sum(g.numel() for g in leaves_g))
        else:
            metrics = StepMetrics(*kops._zeros5(dev))
        unflat = lambda leaves: bucketing.tree_unflatten(skel, leaves)
        new_state = CollageOptState(
            step=t, m=unflat(new_m), v=unflat(new_v),
            delta=unflat(new_d) if state.delta is not None else None,
            master=unflat(new_w) if state.master is not None else None, rng=state.rng)
        return unflat(new_p), new_state, metrics

    # ------------------------------------------------- per-leaf update rules
    def _leaf_update(self, g, p, m, v, d, w, seed, sc, block=None):
        """``_leaf_step`` over one leaf, in flat chunks of ``LEAF_CHUNK``
        elements past that size, written into the leaf's outputs.
        ``block``: (whole shape, starts) when ``p`` is a block of a leaf."""
        n = p.numel()
        if block is not None:
            block = (tuple(block[0]), tuple(block[1]), tuple(p.shape))
        if n <= LEAF_CHUNK:
            return self._leaf_step(g, p, m, v, d, w, seed, sc, block=block)
        ins = [_map_parts(lambda t: t.reshape(-1), x) for x in (g, p, m, v, d, w)]
        outs = None
        for a in range(0, n, LEAF_CHUNK):
            part = [_map_parts(lambda t: t[a:a + LEAF_CHUNK], x) for x in ins]
            res = self._leaf_step(*part, seed, sc, offset=a, block=block)
            if outs is None:
                outs = [_map_parts(lambda t: t.new_empty(n), r) for r in res]
            for o, r in zip(outs, res):
                _map_parts(lambda t, u: t[a:a + LEAF_CHUNK].copy_(u), o, r)
        return [_map_parts(lambda t: t.reshape(p.shape), o) for o in outs]

    def _leaf_step(self, g, p, m, v, d, w, seed, sc, offset=0, block=None):
        """One leaf of ``step``: the JAX package's ``_leaf_step``, op for op.
        Returns (θ, m, v, δθ, master, Δθ in f32, Δθ̂ in f32). ``offset``: the
        flat index of ``p``'s first element in its leaf (SR's noise index);
        with ``block`` (whole shape, starts, block shape) in the block, and
        the noise index is the element's in the whole leaf."""
        s = self.policy.strategy
        cdt = self.policy.param_dtype
        lr, bc1, bc2 = sc["lr"], sc["bc1"], sc["bc2"]
        eps = _host(self.eps)

        if s in (Strategy.D_MINUS_MW, Strategy.D_MIXED_MW):
            # f32 optimizer states; grads arrive in bf16 (Table 2) → upcast
            g32 = g.to(F32)
            m = _host(self.b1) * m + _host(1.0 - self.b1) * g32
            v = _host(self.b2) * v + _host(1.0 - self.b2) * g32 * g32
            mhat = m / bc1
            vhat = v / bc2
            f = mcf.fpu(cdt)
            theta_ref = w if s is Strategy.D_MIXED_MW else p.to(F32)
            upd32 = -lr * (mhat / (mcf.sqrt_rn(vhat) + eps) + self._wd_term(theta_ref))
            if s is Strategy.D_MIXED_MW:
                w = w + upd32                       # f32 master update
                new_p = f.round(w)                  # RN onto the bf16 grid
                eff = f.load(new_p) - f.load(p)
            else:
                theta32 = f.load(p)
                new_p = f.round(theta32 + f.rn(upd32))  # bf16 ⊕ → lost arithmetic
                eff = f.load(new_p) - theta32
            return new_p, m, v, d, w, upd32, eff

        # bf16-storage families (A / B / C / KAHAN / SR): EMAs in the
        # component dtype through the strict FPU
        f = mcf.fpu(cdt)
        g32 = f.load(g)
        theta32 = f.load(p)
        cb1, c1m = f.rn(_host(self.b1)), f.rn(_host(1 - self.b1))
        cb2, c2m = f.rn(_host(self.b2)), f.rn(_host(1 - self.b2))
        # each stored value rounded once (``round``), widened where it is read
        m = f.round(f.mul(cb1, f.load(m)) + f.mul(c1m, g32))
        m32 = f.load(m)
        g2 = f.mul(g32, g32)
        if s.uses_expansion_second_moment:
            beta2_e = mcf.from_float(self.b2, dtype=cdt)     # host scalars
            v = mcf.grow(mcf.mul(beta2_e, v), f.round(c2m * g2))   # Alg. 2 line 9
            vhat32 = v.value(F32) / bc2
        else:
            v = f.round(f.mul(cb2, f.load(v)) + f.mul(c2m, g2))  # β₂ cast to bf16 (→ 1.0!)
            vhat32 = f.load(v) / bc2
        mhat32 = m32 / bc1
        # Δθ formed in f32, rounded once
        upd32 = -lr * (mhat32 / (mcf.sqrt_rn(vhat32) + eps) + self._wd_term(theta32))
        upd16 = f.round(upd32)
        upd16_32 = f.load(upd16)

        if s is Strategy.A_BF16:
            base32 = self._maybe_pt_decay(theta32, lr, f)
            new_p = f.round(base32 + upd16_32)       # bf16 ⊕: lost arithmetic
            return new_p, m, v, d, w, upd32, f.load(new_p) - theta32
        if s is Strategy.SR:
            idx = torch.arange(offset, offset + p.numel(), dtype=torch.int64, device=p.device)
            if block is not None:
                idx = block_index(idx, *block)
            idx = idx.reshape(p.shape)
            new_p = mcf.stochastic_round(theta32 + upd32, cdt, bucketing.sr_bits32(idx, seed))
            return new_p, m, v, d, w, upd32, f.load(new_p) - theta32
        if s is Strategy.KAHAN:
            upd_c = f.add(upd16_32, f.load(d))
            new_p = f.round(theta32 + upd_c)
            new_p32 = f.load(new_p)
            new_d = f.round(upd_c - f.sub(new_p32, theta32))
            return new_p, m, v, new_d, w, upd32, new_p32 - theta32
        # Collage light/plus: Grow Δθ into the (θ, δθ) expansion; Δθ̂ taken
        # componentwise (each difference f32-exact)
        e = mcf.grow(Expansion(p, d), upd16)
        eff = (f.load(e.hi) - theta32) + (f.load(e.lo) - f.load(d))
        return e.hi, m, v, e.lo, w, upd32, eff

    def _wd_term(self, theta32):
        if self.policy.wd_mode == "fused":
            return _host(self.wd) * theta32
        return torch.zeros_like(theta32)

    def _maybe_pt_decay(self, theta32, lr, f):
        # App. D Eq. 4: separate PyTorch-style decay θ·(1−αλ); in bf16 the
        # factor rounds to 1.0 whenever αλ < 2⁻⁹, a silent no-op
        if self.policy.wd_mode == "pytorch" and self.wd:
            factor = f.rn(_host(1.0) - lr * _host(self.wd))
            return f.mul(theta32, factor)
        return theta32

    @staticmethod
    def _leaf_partials(g, u, e) -> tuple:
        """Raw metric partials of one leaf (⟨Δθ,Δθ̂⟩, ‖Δθ‖², ‖Δθ̂‖², #lost,
        ‖g‖²): the first four from the EDQ kernel (its plain version on the
        CPU), ‖g‖² from a torch sum."""
        p = kedq.edq_partials(u.reshape(-1), e.reshape(-1))
        g32 = g.to(F32)
        return (p[0], p[1], p[2], p[3], torch.sum(g32 * g32))


def block_index(flat, whole_shape, starts, block_shape) -> torch.Tensor:
    """Indices in the whole leaf (row-major) of a block's elements, given
    their flat indices ``flat`` in the block."""
    out = torch.zeros_like(flat)
    stride = 1
    for d in reversed(range(len(block_shape))):
        out += (flat % block_shape[d] + starts[d]) * stride
        flat = flat // block_shape[d]
        stride *= whole_shape[d]
    return out


def _map_parts(fn, x, *rest):
    """``fn`` over a tensor, over each component of an Expansion (with the
    matching components of ``rest``); None stays None."""
    if x is None:
        return None
    if isinstance(x, Expansion):
        return Expansion(fn(x.hi, *(r.hi for r in rest)), fn(x.lo, *(r.lo for r in rest)))
    return fn(x, *rest)


def _host(x) -> torch.Tensor:
    """A host value rounded to f32, as a 0-dim CPU tensor: exact, and an
    operand of CUDA ops by value (a device copy would synchronise the host
    with the card at every call)."""
    return torch.tensor(float(np.float32(x)), dtype=F32)  # f32-ok: a host scalar


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


def convert_state(state: CollageOptState, params: Any, new_policy: PrecisionPolicy, *,
                  sr_seed: int = 0) -> CollageOptState:
    """Checkpoint-time precision migration: re-express an optimizer state
    under another strategy (e.g. resume an f32-master run as Collage-plus,
    or back). Moments are rounded or expanded; master weights and residuals
    are rebuilt as needed; ``sr_seed`` seeds the SR stream of the migrated
    run when the old state has none."""
    s = new_policy.strategy
    cdt = new_policy.param_dtype
    tmap = bucketing.tree_map
    val32 = lambda x: x.value(F32) if isinstance(x, Expansion) else x.to(F32)
    m32, v32 = tmap(val32, state.m), tmap(val32, state.v)
    if s in (Strategy.D_MINUS_MW, Strategy.D_MIXED_MW):
        m, v = m32, v32
    else:
        m, v = tmap(lambda x: x.to(cdt), m32), tmap(lambda x: x.to(cdt), v32)
    if s.uses_expansion_second_moment:
        def expand(x32):
            hi = x32.to(cdt)
            return Expansion(hi, (x32 - hi.to(F32)).to(cdt))
        v = tmap(expand, v32)
    delta = None
    if s.uses_expansion_params or s is Strategy.KAHAN:
        if state.delta is not None:
            delta = state.delta
        elif state.master is not None:      # keep the master weights' residual in δθ
            delta = tmap(lambda w, p: (w - p.to(F32)).to(cdt), state.master, params)
        else:
            delta = tmap(lambda p: torch.zeros(p.shape, dtype=cdt, device=p.device), params)
    master = None
    if s.uses_master_weights:
        if state.master is not None:
            master = state.master
        elif state.delta is not None:
            master = tmap(lambda p, d: p.to(F32) + d.to(F32), params, state.delta)
        else:
            master = tmap(lambda p: p.to(F32), params)
    rng = None
    if s is Strategy.SR:
        rng = state.rng if state.rng is not None else int(sr_seed)
    return CollageOptState(step=state.step, m=m, v=v, delta=delta, master=master, rng=rng)


def cosine_schedule(base_lr: float, warmup: int, total: int, min_ratio: float = 0.1) -> Schedule:
    """CosineAnnealing with linear warmup, evaluated in numpy float32 with
    the JAX package's operation order."""
    f32 = np.float32  # f32-ok: host schedule in numpy f32

    def f(t):
        tf = f32(t)
        warm = tf / f32(max(warmup, 1))
        prog = np.clip((tf - f32(warmup)) / f32(max(total - warmup, 1)), f32(0.0), f32(1.0))
        cos = f32(min_ratio) + f32((1 - min_ratio) * 0.5) * (f32(1) + np.cos(f32(np.pi) * prog))
        return f32(f32(base_lr) * (warm if tf < f32(warmup) else cos))

    return f

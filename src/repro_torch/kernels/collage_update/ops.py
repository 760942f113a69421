"""Bucketed execution engine: one fused update per persistent flat bucket,
the port of ``repro.kernels.collage_update.ops`` (``bucketed_step``).

HBM traffic per parameter (bf16): Collage-plus = 6 reads + 5 writes = 22 B.
Params and optimizer state live as ``BucketedParams``/``BucketedOptState``
and gradients arrive as flat buckets (autograd w.r.t. the bucket views), so
a step does no per-step flatten or concatenation.

With ``use_fused_kernel`` each bucket goes through
``collage_update.collage_bucket_update`` (the CUDA kernel on the card, its
plain version on the CPU); without it, through the plain version with
fast metric sums (``torch.sum``, equal to the tiled partials up to f32
summation order).

``fused_step`` is the tree-layout shim: ``CollageAdamW.step`` with
``use_fused_kernel`` runs it.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import bucketing
from repro_torch.core.collage import StepMetrics
from repro_torch.core.precision import Strategy
from repro_torch.kernels.collage_update import collage_update as cu
from repro_torch.kernels.collage_update import ref as cu_ref

STRATEGY_CODE = {
    Strategy.A_BF16: "A",
    Strategy.B_COLLAGE_LIGHT: "B",
    Strategy.C_COLLAGE_PLUS: "C",
    Strategy.KAHAN: "KAHAN",
    Strategy.SR: "SR",
    Strategy.D_MINUS_MW: "D-",
    Strategy.D_MIXED_MW: "D",
}

# bucket-state field name → BucketedOptState role (theta lives in params)
_FIELD_ROLE = {"m": "m", "vhi": "vhi", "vlo": "vlo", "delta": "delta", "master": "master"}


def _update_one_bucket(opt, state_dict, g, lr, bc1, bc2, seed, elem_offset=None,
                       donate=False):
    """Update of one flat bucket: the kernel wrapper, or the plain version
    with fast metric sums; ``donate`` writes the new state over the old."""
    code = STRATEGY_CODE[opt.policy.strategy]
    kw = dict(b1=opt.b1, b2=opt.b2, eps=opt.eps, wd=opt.wd, strategy=code,
              pt_decay=(opt.policy.wd_mode == "pytorch"), compute_metrics=opt.compute_metrics)
    if opt.use_fused_kernel:
        return cu.collage_bucket_update(state_dict, g, lr, bc1, bc2, seed, elem_offset,
                                        in_place=donate, **kw)
    out, parts = cu_ref.collage_bucket_update_plain(state_dict, g, lr, bc1, bc2, seed,
                                                    elem_offset, tiled_metrics=False, **kw)
    return (cu.copy_into(state_dict, out) if donate else out), parts


def _zeros5(device):
    return tuple(torch.zeros((), dtype=torch.float32, device=device) for _ in range(5))


def sum_partials(partials_list, device=None) -> tuple:
    """Σ of per-bucket metric partials: the raw (⟨Δθ,Δθ̂⟩, ‖Δθ‖², ‖Δθ̂‖²,
    #lost, ‖g‖²) as a 5-tuple of f32 0-dim tensors."""
    partials_list = list(partials_list)
    if device is None:
        device = partials_list[0][0].device if partials_list else "cpu"
    tot = _zeros5(device)
    for p in partials_list:
        tot = tuple(t + q for t, q in zip(tot, p))
    return tot


def finalize_metrics(partials, total: int) -> StepMetrics:
    """Raw partials → StepMetrics (Paper Def. 3.3). ``total`` is the
    unpadded parameter count (padding contributes exact zeros)."""
    dot, un2, en2, lost, gn2 = partials
    un = torch.sqrt(un2)
    return StepMetrics(edq=dot / torch.clamp_min(un, 1e-30), update_norm=un,
                       effective_norm=torch.sqrt(en2), imprecision_pct=100.0 * lost / total,
                       grad_norm=torch.sqrt(gn2))


def _scalars(opt, t: int):
    """lr, bc1 = 1 − b1^t, bc2 = 1 − b2^t as numpy float32 host scalars."""
    tf = np.float32(t)
    lr = np.float32(opt.lr(t))
    bc1 = np.float32(1.0) - np.float32(opt.b1) ** tf
    bc2 = np.float32(1.0) - np.float32(opt.b2) ** tf
    return lr, bc1, bc2


def bucketed_step(opt, grads, bparams: bucketing.BucketedParams,
                  bstate: bucketing.BucketedOptState, *, metrics_partials=False,
                  elem_offsets=None, reduce_fn=None, scalars=None, donate=False):
    """One optimizer step over persistent buckets → (new BucketedParams, new
    BucketedOptState, StepMetrics).

    ``grads``: a BucketedParams or a tuple of flat bucket tensors.
    ``metrics_partials``: return the raw summed metric partials (a 5-tuple
    of f32 0-dim tensors) in place of the StepMetrics: a ZeRO caller sums
    them over the ranks and calls ``finalize_metrics`` once.
    ``elem_offsets`` (SR): per-bucket element offsets of this caller's shard
    in the full bucket. ``reduce_fn``: ``(bucket index, grad) → grad`` hook
    run just before each bucket's update. ``scalars``: (lr, bc1, bc2) to use
    in place of ``_scalars`` (parity tests feed the JAX package's).
    ``donate``: the new params and state are written over ``bparams``' and
    ``bstate``'s buckets (the JAX package's donated step), which then hold
    the new values; the old ones are gone."""
    s = opt.policy.strategy
    layout = bparams.layout
    gdata = grads.data if isinstance(grads, bucketing.BucketedParams) else tuple(grads)
    if len(gdata) != layout.n_buckets:
        raise ValueError(f"{len(gdata)} gradient buckets for {layout.n_buckets} buckets")
    if elem_offsets is not None and len(elem_offsets) != layout.n_buckets:
        raise ValueError("one elem_offset per bucket")
    t = bstate.step + 1
    lr, bc1, bc2 = scalars if scalars is not None else _scalars(opt, t)
    fields = cu.state_fields(STRATEGY_CODE[s])

    new: dict = {f: [] for f in fields}
    partials = []
    for i in range(layout.n_buckets):
        sd = {"theta": bparams.data[i].detach()}
        for f in fields:
            if f != "theta":
                sd[f] = getattr(bstate, _FIELD_ROLE[f])[i]
        seed = int(bucketing.fold_seed(bstate.rng, t, i)) if s is Strategy.SR else None
        off = elem_offsets[i] if elem_offsets is not None else None
        g_i = gdata[i] if reduce_fn is None else reduce_fn(i, gdata[i])
        out, part = _update_one_bucket(opt, sd, g_i, lr, bc1, bc2, seed, elem_offset=off,
                                       donate=donate)
        for f in fields:
            new[f].append(out[f])
        if part is not None:
            partials.append(part)

    device = bparams.data[0].device
    if metrics_partials:
        metrics = sum_partials(partials, device) if opt.compute_metrics else _zeros5(device)
    elif opt.compute_metrics:
        metrics = finalize_metrics(sum_partials(partials, device), layout.total_size)
    else:
        metrics = StepMetrics(*_zeros5(device))
    new_state = bucketing.BucketedOptState(
        step=t, m=tuple(new["m"]), vhi=tuple(new["vhi"]),
        vlo=tuple(new["vlo"]) if "vlo" in fields else bstate.vlo,
        delta=tuple(new["delta"]) if "delta" in fields else bstate.delta,
        master=tuple(new["master"]) if "master" in fields else bstate.master,
        rng=bstate.rng, layout=layout, grad_err=bstate.grad_err)
    return bucketing.BucketedParams(tuple(new["theta"]), layout), new_state, metrics


def fused_step(opt, grads, params, state, *, scalars=None, metrics_partials=False):
    """``CollageAdamW.step`` through the bucket engine, for tree-shaped state
    (``use_fused_kernel``): ``bucket_state`` → ``bucketed_step`` (one
    ``collage_bucket_update`` per bucket) → ``unbucket_state``. Re-buckets
    every call, the cost ``bucketed_step`` on persistent buckets removes. The
    SR seed of bucket i at step t is ``fold_seed(state.rng, t, i)``, as in
    ``bucketed_step``, so both give the same bits from the same state.
    ``metrics_partials``: the summed raw partials in place of the
    StepMetrics."""
    from repro_torch.core.collage import bucket_state, unbucket_state

    bp = opt.policy.bucketing
    layout = bucketing.build_layout(params, max_bucket_elems=bp.max_bucket_elems,
                                    pad_multiple=bp.pad_multiple)
    bparams, bstate = bucket_state(state, params, layout, opt.policy,
                                   sr_seed=state.rng if state.rng is not None else 0)
    gbuckets = bucketing.bucket_tree(grads, layout)
    bparams, bstate, metrics = bucketed_step(opt, gbuckets, bparams, bstate, scalars=scalars,
                                             metrics_partials=metrics_partials)
    new_params, new_state = unbucket_state(bparams, bstate, opt.policy)
    return new_params, new_state, metrics

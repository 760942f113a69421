"""Training loop: the Collage-precision train step with microbatched
gradient accumulation, the port of ``repro.train.train_loop``.

Bucket layout (``opt.policy.bucketing.enabled``): params and all optimizer
state persist as flat buckets (``core.bucketing``). Each step detaches the
bucket tensors, marks them ``requires_grad``, and computes the loss against
``params.tree()`` — views of the buckets, made by one ``torch.split`` per
bucket — so ``torch.autograd.grad`` returns ONE flat gradient per bucket and
the optimizer step runs with no flatten or concatenation
("differentiate w.r.t. buckets"). The tree layout computes gradients as a
nested dict and steps with ``CollageAdamW.step`` (per leaf, or through the
fused shim with ``use_fused_kernel``).

The step function mutates nothing: it returns a new ``TrainState`` (the
optimizer's update is functional, as the JAX package's).

Not ported yet: gradient compression (``grad_compression`` other than
"none"), the sharded collective (``psum_axis``) and remat.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from repro_torch.core import bucketing
from repro_torch.core.collage import CollageAdamW
from repro_torch.launch.api import CapabilityError
from repro_torch.models.model import Model, param_dict


@dataclasses.dataclass
class TrainState:
    params: Any                      # BucketedParams, or the model's nested dict
    opt_state: Any                   # BucketedOptState, or CollageOptState
    grad_err: Optional[Any] = None   # EF residual of gradient compression (not ported)


def _check_compression(grad_compression: str):
    if grad_compression != "none":
        raise CapabilityError(f"grad_compression {grad_compression!r}: not yet ported to "
                              "repro_torch (only 'none')")


def init_state(model: Model, opt: CollageAdamW, seed: int = 0, grad_compression: str = "none",
               n_dp: Optional[int] = None, *, device="cuda") -> TrainState:
    """A fresh TrainState: parameters from ``model.init(seed)`` (bucketed
    when the policy says so) and zeroed optimizer state."""
    _check_compression(grad_compression)
    if n_dp is not None:
        raise NotImplementedError("n_dp (sharded engine): not yet ported to repro_torch")
    tree = bucketing.tree_unflatten(*_detached(param_dict(model.init(seed, device=device))))
    if opt.policy.bucketing.enabled:
        params, opt_state = opt.init_bucketed(tree)
    else:
        params, opt_state = tree, opt.init(tree)
    return TrainState(params, opt_state, None)


def _detached(tree):
    flat, skel = bucketing.tree_flatten_with_path(tree)
    return skel, [t.detach() for _, t in flat]


def with_flash(model: Model, flash_min_len: Optional[int]) -> Model:
    """The model with ``cfg.flash_min_len`` replaced (None = keep cfg)."""
    if flash_min_len is None:
        return model
    cfg = dataclasses.replace(model.cfg, flash_min_len=int(flash_min_len))
    return dataclasses.replace(model, cfg=cfg)


def make_accum_grads(model: Model, *, microbatch: int = 0, remat: str = "none",
                     flash_min_len: Optional[int] = None) -> Callable:
    """Build ``accum(params, batch) → (loss, metrics, grads)``. With
    ``microbatch`` > 0 the batch is split into chunks of that many rows and
    the gradients are accumulated in f32, then averaged and cast back to the
    parameter dtype; pre-chunked (n, mb, L) batches are taken as they are."""
    if remat != "none":
        raise NotImplementedError(f"remat {remat!r}: not yet ported to repro_torch")
    model = with_flash(model, flash_min_len)

    def grads_of(params, batch):
        if isinstance(params, bucketing.BucketedParams):
            leaves = tuple(d.detach().requires_grad_(True) for d in params.data)
            p = bucketing.BucketedParams(leaves, params.layout)
        else:
            skel, flat = _detached(param_dict(params))
            leaves = tuple(t.requires_grad_(True) for t in flat)
            p = bucketing.tree_unflatten(skel, leaves)
        with torch.enable_grad():
            loss, metrics = model.loss(p, batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = tuple(torch.zeros_like(x) if gr is None else gr for x, gr in zip(leaves, grads))
        if isinstance(params, bucketing.BucketedParams):
            grads = bucketing.BucketedParams(grads, params.layout)
        else:
            grads = bucketing.tree_unflatten(skel, grads)
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads

    def accum_grads(params, batch):
        pre_chunked = batch["tokens"].dim() == 3
        if not microbatch and not pre_chunked:
            return grads_of(params, batch)
        if pre_chunked:
            n = batch["tokens"].shape[0]
            chunks = batch
        else:
            B = batch["tokens"].shape[0]
            if B % microbatch:
                raise ValueError(f"batch {B} is not a multiple of microbatch {microbatch}")
            n = B // microbatch
            chunks = {k: v.reshape((n, microbatch) + tuple(v.shape[1:])) for k, v in batch.items()}
        acc = None
        loss_sum = ce_sum = aux_sum = 0.0
        for i in range(n):
            loss, m, grads = grads_of(params, {k: v[i] for k, v in chunks.items()})
            leaves = _grad_leaves(grads)
            acc = [g.to(torch.float32) for g in leaves] if acc is None \
                else [a + g.to(torch.float32) for a, g in zip(acc, leaves)]
            loss_sum, ce_sum, aux_sum = loss_sum + loss, ce_sum + m["ce"], aux_sum + m["aux"]
        grads = _with_grad_leaves(grads, [(a / n).to(g.dtype)
                                          for a, g in zip(acc, _grad_leaves(grads))])
        ce = ce_sum / n
        return loss_sum / n, {"ce": ce, "aux": aux_sum / n, "ppl": torch.exp(ce)}, grads

    return accum_grads


def _grad_leaves(grads) -> list:
    if isinstance(grads, bucketing.BucketedParams):
        return list(grads.data)
    return bucketing.tree_leaves(grads)


def _with_grad_leaves(grads, leaves):
    if isinstance(grads, bucketing.BucketedParams):
        return bucketing.BucketedParams(tuple(leaves), grads.layout)
    return bucketing.tree_unflatten(bucketing.tree_flatten_with_path(grads)[1], leaves)


def _apply_opt(opt: CollageAdamW, grads, params, opt_state):
    if isinstance(params, bucketing.BucketedParams):
        return opt.step_bucketed(grads, params, opt_state)
    return opt.step(grads, params, opt_state)


def make_train_step(model: Model, opt: CollageAdamW, *, microbatch: int = 0,
                    remat: str = "none", grad_compression: str = "none",
                    psum_axis: Optional[str] = None,
                    flash_min_len: Optional[int] = None) -> Callable:
    """Build ``train_step(state, batch) → (state, metrics)``; metrics are
    0-dim tensors on the device (reading one synchronises)."""
    _check_compression(grad_compression)
    if psum_axis is not None:
        raise NotImplementedError("psum_axis (sharded step): not yet ported to repro_torch")
    accum_grads = make_accum_grads(model, microbatch=microbatch, remat=remat,
                                   flash_min_len=flash_min_len)

    def train_step(state: TrainState, batch):
        loss, lmetrics, grads = accum_grads(state.params, batch)
        params, opt_state, om = _apply_opt(opt, grads, state.params, state.opt_state)
        metrics = {"loss": loss, **lmetrics, "edq": om.edq, "update_norm": om.update_norm,
                   "imprecision_pct": om.imprecision_pct, "grad_norm": om.grad_norm}
        return TrainState(params, opt_state, state.grad_err), metrics

    return train_step


def make_eval_step(model: Model) -> Callable:
    def eval_step(params, batch):
        with torch.no_grad():
            _, metrics = model.loss(params, batch)
        return metrics
    return eval_step

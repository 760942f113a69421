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

The step function returns a new ``TrainState`` and, by default, mutates
nothing (the optimizer's update is functional, as the JAX package's). With
``donate`` (bucketed layout; the launcher's choice) the optimizer writes
the new parameters and state over the old buckets, as a jit with donated
arguments does: one copy of the optimizer state on the card, not two.

Gradient compression (``grad_compression``: "bf16", "fp8", with "_ef" the
error-feedback residual): on the bucket layout one round trip per bucket,
the residual rows in ``BucketedOptState.grad_err``; on the tree layout one
per leaf, the residual in ``TrainState.grad_err``. Without ``psum_axis``
the round trip is local (it models the wire loss of a single program);
with ``psum_axis`` (a ``distributed.collectives.Axis``) the payload is
reduced over the ranks (``distributed.compression``). The sharded engine
(``train.sharded``) reuses ``make_accum_grads`` and ``TrainState``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.convert import key_from_seed, seed_from_key
from repro_torch.core import bucketing
from repro_torch.core.collage import CollageAdamW, CollageOptState
from repro_torch.core.mcf import Expansion
from repro_torch.distributed import collectives as coll
from repro_torch.distributed import compression
from repro_torch.models.model import Model, param_dict
from repro_torch.models.transformer import check_remat


@dataclasses.dataclass
class TrainState:
    params: Any                      # BucketedParams, or the model's nested dict
    opt_state: Any                   # BucketedOptState, or CollageOptState
    grad_err: Optional[Any] = None   # per-leaf EF residual (tree layout)

    def map_named(self, fn: Callable[[str, Any], Any]) -> "TrainState":
        """A TrainState of the same structure with every stored array ``a``
        replaced by ``fn(name, a)``: the checkpoint format's naming hook.

        ``fn`` is called in the JAX package's leaf order, with the name
        ``jax.tree_util.keystr`` gives that leaf of its ``TrainState``
        (keyed fields; ``CollageOptState`` and ``Expansion`` unkeyed, so
        their children are ``[<flat index i>]``). The host ints go to ``fn``
        as the arrays the JAX package stores and come back as ints:
        ``step`` as an int32 scalar, the SR seed as a threefry key
        ``[0, seed]`` on the tree layout (read back as ``k0 ^ k1``) and as
        a uint32 scalar on the bucketed layout."""
        p, o = self.params, self.opt_state
        as_int = lambda name, v, dt: int(np.asarray(fn(name, np.asarray(v, dt))))
        if isinstance(p, bucketing.BucketedParams):
            params = bucketing.BucketedParams(_named(fn, ".params.data", p.data), p.layout)
            step = as_int(".opt_state.step", o.step, np.int32)
            m, vhi, vlo, delta, master = (_named(fn, f".opt_state.{r}", getattr(o, r))
                                          for r in ("m", "vhi", "vlo", "delta", "master"))
            rng = None if o.rng is None else as_int(".opt_state.rng", o.rng, np.uint32)
            ge = _named(fn, ".opt_state.grad_err", o.grad_err)
            opt_state = bucketing.BucketedOptState(step, m, vhi, vlo, delta, master, rng,
                                                   o.layout, ge)
        else:
            params = _named(fn, ".params", p)
            idx = ".opt_state[<flat index {}>]".format
            step = as_int(idx(0), o.step, np.int32)
            m, v, delta, master = (_named(fn, idx(i), getattr(o, r))
                                   for i, r in enumerate(("m", "v", "delta", "master"), 1))
            rng = None if o.rng is None else seed_from_key(fn(idx(5), key_from_seed(o.rng)))
            opt_state = CollageOptState(step, m, v, delta, master, rng)
        return TrainState(params, opt_state, _named(fn, ".grad_err", self.grad_err))


def _named(fn, prefix: str, tree):
    """``fn(name, leaf)`` over nested dicts (sorted keys), lists, tuples and
    Expansions, named and ordered as ``jax.tree_util`` names them."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _named(fn, f"{prefix}[{k!r}]", tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_named(fn, f"{prefix}[{i}]", v) for i, v in enumerate(tree))
    if isinstance(tree, Expansion):
        return Expansion(fn(f"{prefix}[<flat index 0>]", tree.hi),
                         fn(f"{prefix}[<flat index 1>]", tree.lo))
    return fn(prefix, tree)


def init_state(model: Model, opt: CollageAdamW, seed: int = 0, grad_compression: str = "none",
               n_dp: Optional[int] = None, *, device="cuda") -> TrainState:
    """A fresh TrainState: parameters from ``model.init(seed)`` (bucketed
    when the policy says so), zeroed optimizer state and, with an "_ef"
    compression, zeroed residuals built from the gradient structure.

    ``n_dp``: None for the single-program step; the dp rank count (1
    included) for the sharded engine, whose residuals always carry a
    leading per-rank dim (the global state: ``sharded.shard_state``
    hands each rank its row). Bucket residual rows are (1, padded) here and
    (n_dp, padded) for n_dp > 1, as in the JAX package."""
    tree = bucketing.tree_unflatten(*_detached(param_dict(model.init(seed, device=device))))
    if opt.policy.bucketing.enabled:
        params, opt_state = opt.init_bucketed(tree)
    else:
        params, opt_state = tree, opt.init(tree)
    dtype, use_ef = compression.parse_spec(grad_compression)
    err = None
    if use_ef:
        if isinstance(params, bucketing.BucketedParams):
            rows = compression.init_error_state(params, dtype)
            if n_dp is not None and n_dp > 1:
                rows = tuple(r.repeat(n_dp, 1) for r in rows)
            opt_state = dataclasses.replace(opt_state, grad_err=rows)
        else:
            err = compression.init_error_state(params, dtype)
            if n_dp is not None:
                err = bucketing.tree_map(
                    lambda e: e[None].repeat((n_dp,) + (1,) * e.dim()), err)
    return TrainState(params, opt_state, err)


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
                     flash_min_len: Optional[int] = None,
                     grads_of: Optional[Callable] = None) -> Callable:
    """Build ``accum(params, batch) → (loss, metrics, grads)``. With
    ``microbatch`` > 0 the batch is split into chunks of that many rows and
    the gradients are accumulated in f32, then averaged and cast back to the
    parameter dtype; pre-chunked (n, mb, L) batches are taken as they are.
    ``remat`` ("none", "full", "dots") rematerialises each decoder layer in
    the backward pass (``models.transformer.group_apply``).

    ``grads_of(params, batch) → (loss, {"ce", "aux", "ppl"}, grads)``: the
    gradient of one chunk, in place of the model's own on this process
    (the grid step's: a rank's reduced blocks of a chunk of the global
    batch, ``train.grid``); the accumulation is the same."""
    check_remat(remat)
    model = with_flash(model, flash_min_len)

    def own_grads(params, batch):
        if isinstance(params, bucketing.BucketedParams):
            leaves = tuple(d.detach().requires_grad_(True) for d in params.data)
            p = bucketing.BucketedParams(leaves, params.layout)
        else:
            skel, flat = _detached(param_dict(params))
            leaves = tuple(t.requires_grad_(True) for t in flat)
            p = bucketing.tree_unflatten(skel, leaves)
        with torch.enable_grad():
            loss, metrics = model.loss(p, batch, remat=remat)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = tuple(torch.zeros_like(x) if gr is None else gr for x, gr in zip(leaves, grads))
        if isinstance(params, bucketing.BucketedParams):
            grads = bucketing.BucketedParams(grads, params.layout)
        else:
            grads = bucketing.tree_unflatten(skel, grads)
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads

    grads_of = grads_of or own_grads

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
            # f32-ok: microbatch gradients accumulate in f32 (this and the next line)
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


def _apply_opt(opt: CollageAdamW, grads, params, opt_state, donate=False, reduce_fn=None, **kw):
    """The optimizer step of either layout; ``kw``: ``step_bucketed``'s or
    ``step``'s own (a grid rank's ``metrics_partials``, ``elem_offsets``,
    ``blocks``)."""
    if isinstance(params, bucketing.BucketedParams):
        return opt.step_bucketed(grads, params, opt_state, donate=donate, reduce_fn=reduce_fn,
                                 **kw)
    if donate:
        raise ValueError("donate: the bucketed layout only (the tree step is per leaf)")
    return opt.step(grads, params, opt_state, **kw)


def _apply_bucket_reduced(opt: CollageAdamW, grads, params, opt_state, dtype, use_ef: bool,
                          psum_axis, n_dev: int, donate=False, **kw):
    """``_apply_opt`` on buckets with each bucket's round trip (``dtype``)
    or mean over ``psum_axis`` just before its update
    (``compression.bucket_reducer``); the residual rows (row 0 of
    ``BucketedOptState.grad_err``: this program's) written back as the
    buckets are, in place when ``donate``."""
    reduce_fn = None
    if dtype is not None or psum_axis is not None:
        rows = tuple(e[0] for e in opt_state.grad_err) if use_ef else None
        reduce_fn, new_rows = compression.bucket_reducer(rows, dtype, psum_axis, n_dev,
                                                         params.layout.n_buckets)
    new_params, new_state, om = _apply_opt(opt, grads, params, opt_state, donate, reduce_fn, **kw)
    if reduce_fn is not None and use_ef:
        new_state = dataclasses.replace(new_state, grad_err=compression.store_error_rows(
            opt_state.grad_err, new_rows, donate))
    return new_params, new_state, om


def make_train_step(model: Model, opt: CollageAdamW, *, microbatch: int = 0,
                    remat: str = "none", grad_compression: str = "none",
                    psum_axis: Optional["coll.Axis"] = None,
                    flash_min_len: Optional[int] = None, donate: bool = False,
                    grid=None) -> Callable:
    """Build ``train_step(state, batch) → (state, metrics)``; metrics are
    0-dim tensors on the device (reading one synchronises). ``donate``
    (bucketed layout): the step writes the new state over the one it is
    given, which must not be used again.

    ``psum_axis``: a ``collectives.Axis`` whose ranks each run this step on
    their own batch; the gradients are averaged over them (compressed: the
    payload on the wire is the compressed dtype). Without it compression
    is a local round trip that models the wire loss.

    ``grid`` (a ``launch.mesh.Grid``): the step of one rank of an FSDP × TP
    grid (``train.grid.make_grid_train_step`` under the default rules), on
    its blocks of the state and the global batch, with the same
    ``microbatch``, ``remat``, ``grad_compression`` (the local round trip
    of the global gradient) and ``donate``; ``psum_axis`` is the shard_map
    engine's (``train.sharded``) and raises on a grid."""
    if grid is not None:
        from repro_torch.train.grid import make_grid_train_step
        if psum_axis is not None:
            raise ValueError("psum_axis belongs to the shard_map engine (train/sharded.py), whose "
                             "ranks each average their own batch's gradients; the grid step's "
                             "reductions are its gathers' backward over (data, model), and the "
                             "JAX package's GSPMD step takes no psum_axis either")
        return make_grid_train_step(with_flash(model, flash_min_len), opt, grid, remat=remat,
                                    microbatch=microbatch, grad_compression=grad_compression,
                                    donate=donate)
    if psum_axis is not None and not isinstance(psum_axis, coll.Axis):
        raise TypeError(f"psum_axis: a collectives.Axis, not {type(psum_axis).__name__}")
    accum_grads = make_accum_grads(model, microbatch=microbatch, remat=remat,
                                   flash_min_len=flash_min_len)
    dtype, use_ef = compression.parse_spec(grad_compression)
    n_dev = 1 if psum_axis is None else psum_axis.size

    def train_step(state: TrainState, batch):
        loss, lmetrics, grads = accum_grads(state.params, batch)
        grad_err = state.grad_err
        if isinstance(grads, bucketing.BucketedParams):
            # one round trip per bucket, just before its update; the
            # residual rows are per dp rank (this single program is row 0)
            params, opt_state, om = _apply_bucket_reduced(
                opt, grads, state.params, state.opt_state, dtype, use_ef, psum_axis, n_dev,
                donate)
        else:
            if dtype is not None or psum_axis is not None:
                grads, new_err = compression.reduce_tree(grads, grad_err if use_ef else None,
                                                         dtype, psum_axis, n_dev)
                if use_ef:
                    grad_err = new_err
            params, opt_state, om = _apply_opt(opt, grads, state.params, state.opt_state, donate)
        metrics = {"loss": loss, **lmetrics, "edq": om.edq, "update_norm": om.update_norm,
                   "imprecision_pct": om.imprecision_pct, "grad_norm": om.grad_norm}
        return TrainState(params, opt_state, grad_err), metrics

    return train_step


def make_eval_step(model: Model) -> Callable:
    def eval_step(params, batch):
        with torch.no_grad():
            _, metrics = model.loss(params, batch)
        return metrics
    return eval_step

"""The train step on a grid of ranks: the counterpart of the JAX package's
``train_loop.make_train_step`` jitted with ``in_shardings=(state_shardings,
batch_shardings)`` (FSDP × TP, ``distributed.sharding``'s rules).

Each rank runs ``step(state, batch)`` on its blocks of the state (its
``state_shardings`` blocks: ``shard_state``) and the GLOBAL batch, of which
it keeps its dp rows (``batch_shardings``). The forward reads
``sharding.materialize``'s tensors, so the gradient reductions are the
backward of its gathers: a dp-sharded leaf's gradient is reduce-scattered
over dp, a dp-replicated leaf's summed over dp; leaves that every rank of
"model" applies to its own heads or channels, and the norms under sequence
parallelism, have theirs summed over "model". Each rank's loss is its rows'
token sum over the global token count, so the sums over dp give the mean
over the global batch; the MoE aux loss is global on every rank (its sums
over dp run inside ``models.moe``, whose backward is the identity) and
enters each rank's objective whole.

The update is elementwise and each optimizer leaf co-shards with its
parameter, so every rank updates its blocks alone. SR draws each element's
noise at its index in the whole leaf (``CollageAdamW.step(blocks=)``): the
grid's update is the one-rank update, bit for bit, given the same gradient.
The metrics' raw partials (⟨Δθ,Δθ̂⟩, ‖Δθ‖², ‖Δθ̂‖², #lost, ‖g‖², the EDQ
kernel on the blocks) are summed over the grid with each leaf counted once:
a leaf replicated over an axis only on that axis' rank 0.

The bucketed layout (``opt.policy.bucketing.enabled``) follows the
reference's ``bucket_spec``: every flat bucket, parameters and each
optimizer role, is sharded over dp and replicated over "model" (ZeRO-3
style). A step all-gathers each bucket over dp, takes each leaf's "model"
block as the tree step holds it, and runs the same forward; after the
backward each model rank reduce-scatters its partial bucket gradient over
dp (a split leaf's block at its place with zeros elsewhere; a leaf
replicated over "model" counted from model rank 0 only, its gradient being
whole on every rank), sums the shard over "model" (disjoint parts: exact in
the bucket's dtype, and the same numbers as summing first over "model",
for 1/n_dp of the bytes) and updates its shard with one fused
``collage_update`` a bucket, ``elem_offsets`` the shard's start in the
bucket: the ZeRO update of ``train.sharded``, so SR is the one-rank
bucketed update bit for bit. The
metric partials count once a grid: each dp shard on model rank 0.

With ``fsdp=False`` the buckets are replicated over dp (``bucket_spec``
→ ``P()``): no gather, the bucket gradient summed over dp, every dp rank
updating the whole bucket, the metric partials counted on one rank.

FSDP's parameter memory: the forward reads ``materialize(per_layer=True)``,
so each layer's dp-sharded leaves are gathered from the rank's block just
before the layer (``models.transformer.group_apply``) and dropped after
it, the embedding and the head where the model uses them. In the backward
they are gathered again: by the recompute under ``remat`` "full" and
"dots", on unpacking a saved tensor under "none"
(``sharding.regather_saved``); each layer's gradient is reduce-scattered
when its backward ends. The bucketed layout keeps its whole-bucket gather
(a bucket shard's bounds do not fall on layers).

The JAX package's production train cell (``launch/dryrun.py``'s GSPMD
branch) on the grid: ``remat``; gradient accumulation over ``microbatch``
rows of the global batch, or over a pre-chunked (n, mb, L) batch whose
rows split over dp on dim 1 (``train_loop.make_accum_grads`` over this
step's per-chunk gradient: each chunk's reduced gradient added in f32,
divided by n and cast once; the MoE's capacity, positions and aux loss
per chunk over its global rows); ``grad_compression``, the GSPMD step's
local round trip of the GLOBAL gradient with error feedback (tree: on the
rank's blocks, fp8's block amax the max over the ranks holding a part of
the block, ``compression.compress_blocks``, the residual sharded as its
parameter; bucketed: shard-local, the shard a whole number of fp8 blocks,
the residual row 0 of ``grad_err`` sharded as its bucket); ``donate``
(bucketed: the new shards and residual rows written over the ones given).

Families on the grid: all of them. The dense ones, the MoE ones (expert
parallelism: ``models.moe``), the recurrent ones (RWKV6 and jamba's Mamba +
attention + MoE stack, their channel dims over "model": ``models.rwkv``,
``models.ssm``), and the frontends: seamless-m4t's encoder (its non-causal
self-attention on the rank's heads) and the cross-attention of every
decoder layer (the memory entering through the TP boundary,
``GridSharder``'s "memory"), internvl2's patch prefix (the loss on the
text segment); with sequence parallelism the encoder's frames and the
prefix plus text split over "model" when they divide it. On the tree and
the bucketed layouts.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import bucketing
from repro_torch.core.collage import SR_FUSED_BLOCKS, CollageAdamW, CollageOptState
from repro_torch.core.precision import Strategy
from repro_torch.distributed import collectives as coll
from repro_torch.distributed import compression
from repro_torch.distributed import sharding as sh
from repro_torch.kernels.collage_update import ops as kops
from repro_torch.models import moe as moe_lib
from repro_torch.models import transformer as tf
from repro_torch.models.model import AUX_LOSS_COEF, Model, param_dict

F32 = torch.float32


def check_grid(cfg: ModelConfig, grid, tp_mode: str = "full"):
    """Raise for what the grid does not run; the message names the leaf
    whose block cannot be used."""
    name = cfg.name
    tp, dh = grid.tp, cfg.head_dim_
    if tp_mode == "full" and tp > 1 and (cfg.n_heads * dh) % tp == 0 and cfg.n_heads % tp:
        raise ValueError(f"{name}: {cfg.n_heads} query heads over model {tp} would split a head; "
                         f"tp_mode='mlponly' keeps attention whole")
    meta = param_dict(Model(cfg).init(device="meta"))
    specs = dict(sh.named_leaves(sh.state_shardings(meta, grid, True, tp_mode)))
    shapes = {p: tuple(x.shape) for p, x in sh.named_leaves(meta)}
    subs: dict = {}
    for path in specs:
        subs.setdefault(path[:path.rfind("[")], []).append(path)
    for parent, paths in subs.items():
        names = {sh._last_name(q): q for q in paths}
        kind = sh.sublayer_kind(names)
        if kind is None:
            continue
        mark = names[sh.SPLITS[kind].mark]
        split = "model" in specs[mark]
        for leaf in sh.SPLITS[kind].together:
            if ("model" in specs[names[leaf]]) != split:
                raise ValueError(f"{name}: {names[leaf]} is {'whole' if split else 'split'} over "
                                 f"model {tp} while {mark} is {'split' if split else 'whole'}: "
                                 f"this rank's block cannot be used")
        if kind == "rwkv_tmix" and split and (shapes[mark][-1] // tp) % cfg.rwkv_head_dim:
            raise ValueError(f"{name}: {mark}: a block of {shapes[mark][-1] // tp} columns over "
                             f"model {tp} splits a head of {cfg.rwkv_head_dim}")


def state_specs(state, grid, fsdp: bool = True, tp_mode: str = "full"):
    """``sharding.state_shardings`` of a TrainState, but a bucketed state's
    residual rows ``grad_err`` (1, padded) split on their flat dim as their
    buckets are (the JAX package's GSPMD spec keeps them whole: the grid
    takes the shard-local round trip, so a rank needs its shard's rows)."""
    specs = sh.state_shardings(state, grid, fsdp, tp_mode)
    ost = getattr(state, "opt_state", None)
    if isinstance(ost, bucketing.BucketedOptState) and ost.grad_err is not None:
        rows = tuple(sh.P(None, *sh.bucket_spec(e.shape[1:], grid, fsdp)) for e in ost.grad_err)
        specs = dataclasses.replace(specs, opt_state=dataclasses.replace(specs.opt_state,
                                                                         grad_err=rows))
    return specs


def shard_state(state, grid, fsdp: bool = True, tp_mode: str = "full"):
    """This rank's blocks of a global TrainState (its ``state_specs``)."""
    return sh.local_tree(state, state_specs(state, grid, fsdp, tp_mode), grid)


def gather_state(local, template, grid, fsdp: bool = True, tp_mode: str = "full"):
    """The global TrainState from every rank's blocks (all-gathers);
    ``template``: a global state (the meta device will do) for the specs."""
    return sh.gather_tree(local, state_specs(template, grid, fsdp, tp_mode), grid)


def _rebuild(tree, leaves):
    it = iter(leaves)
    return sh.map_leaves(lambda path, x: next(it), tree)


def make_grid_train_step(model: Model, opt: CollageAdamW, grid, *, fsdp: bool = True,
                         tp_mode: str = "full", sp: bool = False, remat: str = "none",
                         microbatch: int = 0, grad_compression: str = "none",
                         donate: bool = False) -> Callable:
    """``step(state, batch) → (state, metrics)`` on ``grid``: ``state`` this
    rank's blocks (of a tree or a bucketed TrainState: ``shard_state``),
    ``batch`` the global batch (or a pre-chunked (n, mb, L) one); the
    metrics are the global ones (0-dim tensors). ``sp``: sequence
    parallelism (when L divides "model"); ``remat``, ``microbatch``,
    ``grad_compression`` and ``donate`` (bucketed only) as in
    ``train_loop.make_train_step``.

    Its parts, for callers that look between them: ``step.grads(params,
    batch) → (losses, grads)`` (losses: the global loss, ce and aux as one
    f32 tensor of 3; grads this rank's reduced blocks, accumulated),
    ``step.compress(state, grads) → (grads, grad_err)`` (the tree layout's
    round trip; the bucketed one runs inside ``update``), ``step.update(
    state, grads) → (params, opt_state, counted metric partials)`` and
    ``step.finish(losses, parts)``."""
    from repro_torch.train.train_loop import (TrainState, _apply_bucket_reduced, _apply_opt,
                                              make_accum_grads)

    cfg = model.cfg
    bucketed = opt.policy.bucketing.enabled
    check_grid(cfg, grid, tp_mode)
    tf.check_remat(remat)
    cdtype, use_ef = compression.parse_spec(grad_compression)
    if donate and not bucketed:
        raise ValueError("donate: the bucketed layout only (the tree step is per leaf)")
    if opt.use_fused_kernel and opt.policy.strategy is Strategy.SR and grid.size > 1 \
            and not bucketed:
        raise ValueError(SR_FUSED_BLOCKS)
    sharder = sh.make_activation_sharder(grid, sp)
    shapes = param_dict(model.init(device="meta"))
    pspecs = sh.state_shardings(shapes, grid, fsdp, tp_mode)
    specs = [s for _, s in sh.named_leaves(pspecs)]
    whole = [x for _, x in sh.named_leaves(shapes)]
    blocks = [(tuple(x.shape), tuple(b.start for b in sh.block_slices(x.shape, s, grid)))
              if any(s) else None for x, s in zip(whole, specs)]
    owned = [sh.owned(s, grid) for s in specs]
    total = sum(x.numel() for x in whole)
    dp, model_ax, world = grid.axis("dp"), grid.axis("model"), grid.axis("world")
    has_moe = any(s.kind == "moe" for g in cfg.decoder_program() for s in g.period)
    # the bucketed layout: each leaf's "model" block (the dp entries dropped)
    tspecs = sh.map_leaves(lambda path, s: sh.P(*("model" if "model" in sh._names(e) else None
                                                   for e in s)), pspecs)
    tflat = dict(sh.named_leaves(tspecs))
    shard_buckets = bucketed and fsdp and grid.n_dp > 1
    if shard_buckets and opt.policy.bucketing.pad_multiple % grid.n_dp:
        raise ValueError(f"bucket pad_multiple {opt.policy.bucketing.pad_multiple} must be a "
                         f"multiple of the {grid.n_dp} dp ranks: build the BucketPolicy with "
                         f"sharding.bucket_pad_multiple")
    if shard_buckets and cdtype is not None and compression.is_fp8(cdtype) \
            and opt.policy.bucketing.pad_multiple % (grid.n_dp * compression.BLOCK):
        raise ValueError(f"bucket pad_multiple {opt.policy.bucketing.pad_multiple}: fp8's "
                         f"round trip on a bucket shard needs whole blocks of "
                         f"{compression.BLOCK}: build the BucketPolicy with "
                         f"sharding.bucket_pad_multiple(block=compression.BLOCK)")

    def loss_grads(params, leaves, batch, over_dp: bool):
        """(ce summed over dp, aux, autograd gradients of ``leaves``) of this
        rank's objective over the materialised ``params``."""
        local = sharder.local_batch(batch)
        rows_split = bool(sharder.rows_split)
        if has_moe:
            moe_lib.check_groups(cfg, local["tokens"].numel(), grid.n_dp if rows_split else 1)
        with torch.enable_grad(), tf.activation_sharding(sharder):
            sharder.begin_seq(*model.seq_lengths(local))
            compute = sh.materialize(params, pspecs if over_dp else tspecs, grid, cfg.head_dim_,
                                     over_dp=over_dp, per_layer=True)
            loss, lm = model.loss(compute, local, remat=remat)
            if rows_split:           # this rank's token sum over the global token count
                n = (local["labels"][..., 1:] >= 0).sum().to(F32)
                scale = n / torch.clamp_min(coll.psum(n, dp, role="metric"), 1.0)
                # the aux loss is the global one on every rank (its backward
                # leaves each rank its rows' part, summed over dp below)
                objective = lm["ce"] * scale + AUX_LOSS_COEF * lm["aux"]
            else:                    # every dp rank holds the whole batch
                scale = torch.tensor(1.0 / grid.n_dp, dtype=F32, device=loss.device)
                objective = loss * scale
            grads = torch.autograd.grad(objective, leaves, allow_unused=True)
            del compute
        grads = [torch.zeros_like(x) if g is None else g for x, g in zip(leaves, grads)]
        ce = coll.psum((lm["ce"] * scale).detach(), dp, role="metric")
        return ce, lm["aux"].detach(), grads

    def chunk_grads(params, batch):
        """``make_accum_grads``' per-chunk contract: (loss, {"ce", "aux",
        "ppl"}, this rank's reduced gradient) of one chunk of the global
        batch."""
        if bucketed:
            ce, aux, grads = _bucket_grads(params, batch)
        else:
            leaves = [x.detach().requires_grad_(True) for _, x in sh.named_leaves(params)]
            ce, aux, g = loss_grads(_rebuild(params, leaves), leaves, batch, True)
            grads = _rebuild(params, g)
        return ce + AUX_LOSS_COEF * aux, {"ce": ce, "aux": aux, "ppl": torch.exp(ce)}, grads

    accum = make_accum_grads(model, microbatch=microbatch, grads_of=chunk_grads)

    def grads_of(params, batch):
        """(the global (loss, ce, aux) as one f32 tensor of 3, the
        (accumulated) gradient of this rank's blocks)."""
        loss, m, grads = accum(params, batch)
        return torch.stack([loss, m["ce"], m["aux"]]), grads

    def _bucket_grads(params: bucketing.BucketedParams, batch):
        """The bucket shards' gradient: buckets gathered over dp, each leaf's
        "model" block; each model rank's partial bucket gradient (its blocks
        at their places, zeros elsewhere; replicated leaves from model rank
        0 only) reduce-scattered over dp (summed, buckets replicated over
        dp), then its shard summed over "model". The sums commute exactly
        (at each element at most one model rank's part is nonzero), so the
        order moves 1/n_dp of the bucket over "model" for the same
        numbers."""
        layout = params.layout
        if shard_buckets:
            leaves = [coll.all_gather(d, dp, role="fsdp_gather").detach().requires_grad_(True)
                      for d in params.data]
        else:
            leaves = [d.detach().requires_grad_(True) for d in params.data]
        with torch.enable_grad():
            tree = sh.local_tree(bucketing.unbucket(leaves, layout), tspecs, grid)
        ce, aux, grads = loss_grads(tree, leaves, batch, False)
        del tree, leaves
        replicated = [[] for _ in layout.buckets]          # leaves whole on every model rank
        for slot in layout.slots:
            if "model" not in tflat[slot.name]:
                replicated[slot.bucket].append((slot.offset, slot.size))
        out = []
        for b in range(len(grads)):
            g, grads[b] = grads[b], None
            if model_ax.rank:                 # replicated leaves count from model rank 0
                for off, size in replicated[b]:
                    g[off:off + size] = 0
            g = coll.psum_scatter(g, dp, role="fsdp_scatter") if shard_buckets \
                else coll.psum(g, dp, role="grad")
            out.append(coll.sum_disjoint(g, model_ax, role="tp_reduce"))
            del g
        return ce, aux, bucketing.BucketedParams(tuple(out), layout)

    def compress(state, grads):
        """The tree layout's round trip of the global gradient on this
        rank's blocks → (grads, the new residuals or the old ones)."""
        if bucketed or cdtype is None:
            return grads, state.grad_err
        grads, err = compression.compress_blocks(grads, state.grad_err if use_ef else None,
                                                 cdtype, blocks, world)
        return grads, (err if use_ef else state.grad_err)

    def update(state, grads):
        """The optimizer on this rank's blocks → (params, opt_state, the
        summed raw metric partials of the leaves this rank counts)."""
        if bucketed:
            n = grid.n_dp if shard_buckets else 1
            r = dp.rank if shard_buckets else 0
            offs = tuple(r * (b.padded // n) for b in state.params.layout.buckets)
            params, ost, parts = _apply_bucket_reduced(
                opt, grads, state.params, state.opt_state, cdtype, use_ef, None, 1, donate,
                metrics_partials=True, elem_offsets=offs)
            if model_ax.rank or (dp.rank and not shard_buckets):   # each shard counts once
                parts = kops._zeros5(parts[0].device)
            return params, ost, parts
        if not opt.use_fused_kernel:
            params, ost, parts = _apply_opt(opt, grads, state.params, state.opt_state,
                                            metrics_partials=True, blocks=blocks)
            return params, ost, kops.sum_partials([p for p, o in zip(parts, owned) if o],
                                                  parts[0][0].device)
        return _fused_update(opt, grads, state.params, state.opt_state, owned)

    def finish(losses, parts, n_params: int = total) -> dict:
        """The global metrics from ``grads``' (loss, ce, aux) and this rank's
        counted partials."""
        tot = coll.psum(torch.stack([p.to(F32) for p in parts]), world, role="metric")
        om = kops.finalize_metrics(tuple(tot), n_params)
        loss, ce, aux = losses[0], losses[1], losses[2]
        return {"loss": loss, "ce": ce, "aux": aux, "ppl": torch.exp(ce), "edq": om.edq,
                "update_norm": om.update_norm, "imprecision_pct": om.imprecision_pct,
                "grad_norm": om.grad_norm}

    def step(state, batch):
        losses, grads = grads_of(state.params, batch)
        grads, grad_err = compress(state, grads)
        params, opt_state, parts = update(state, grads)
        n = state.params.layout.total_size if bucketed else total
        return TrainState(params, opt_state, grad_err), finish(losses, parts, n)

    step.grads, step.compress, step.update, step.finish = grads_of, compress, update, finish
    step.specs = pspecs
    return step


def _fused_update(opt: CollageAdamW, grads, params, ost: CollageOptState, owned):
    """The fused shim over the leaves this rank counts and, apart, the rest
    (so the counted partials are summed alone); one group off a grid."""
    if all(owned):
        p, s, parts = kops.fused_step(opt, grads, params, ost, metrics_partials=True)
        return p, s, parts
    flat = lambda t: [x for _, x in bucketing.tree_flatten_with_path(t)[0]] if t is not None \
        else None
    gl, skel = bucketing.tree_flatten_with_path(grads)
    gl = [x for _, x in gl]
    cols = {"p": flat(params), "m": flat(ost.m), "v": flat(ost.v), "d": flat(ost.delta),
            "w": flat(ost.master)}
    out = {k: list(v) if v is not None else None for k, v in cols.items()}
    parts = kops._zeros5(gl[0].device)
    for want in (True, False):
        idx = [i for i, o in enumerate(owned) if o == want]
        if not idx:
            continue
        pick = lambda xs: None if xs is None else {str(i): xs[i] for i in idx}
        sub = CollageOptState(ost.step, pick(cols["m"]), pick(cols["v"]), pick(cols["d"]),
                              pick(cols["w"]), ost.rng)
        p, s, part = kops.fused_step(opt, pick(gl), pick(cols["p"]), sub, metrics_partials=True)
        for i in idx:
            out["p"][i], out["m"][i], out["v"][i] = p[str(i)], s.m[str(i)], s.v[str(i)]
            if s.delta is not None:
                out["d"][i] = s.delta[str(i)]
            if s.master is not None:
                out["w"][i] = s.master[str(i)]
        if want:
            parts = part
    un = lambda xs: None if xs is None else bucketing.tree_unflatten(skel, xs)
    return un(out["p"]), CollageOptState(ost.step + 1, un(out["m"]), un(out["v"]), un(out["d"]),
                                         un(out["w"]), ost.rng), parts

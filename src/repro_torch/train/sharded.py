"""Sharded train-step engine, the port of ``repro.train.sharded``: data
parallelism over ``torch.distributed`` ranks with ZeRO bucket sharding,
bucket-granular compressed gradient collectives, and the schedule-as-data
pipeline.

One process per dp rank (``nccl`` on the card, ``gloo`` on the CPU; the
``Mesh``'s ``dp`` axis). Where the JAX engine runs one shard_map body per
device, the port runs the same body once per rank, and its collectives are
``distributed.collectives``: the reference's sums, payloads on the wire in
their own dtype. A step takes the GLOBAL batch and keeps this rank's rows
(``split_batch``, the reference's ``batch_pspecs``); the state it takes and
returns is this rank's part of the global state (``shard_state``, the
reference's ``state_pspecs`` + ``device_put``; ``gather_state`` the inverse,
for checkpoints).

  * ZeRO (bucketed): every flat bucket, params and every optimizer role,
    is cut into ``n_dp`` contiguous shards. The step all-gathers the param
    buckets, computes full local gradients, and reduce-scatters them
    through ``step_bucketed``'s ``reduce_fn`` hook, so the update runs on
    1/n_dp of every bucket. SR passes each shard's element offset
    ``rank · padded/n_dp``: the noise stream stays bucket-global and SR +
    ZeRO is bit-identical to the unsharded step. Metrics: the raw partials
    are summed over the ranks and finalized once.
  * compression: one quantize → collective → dequantize per bucket (or per
    leaf on the tree layout), the EF residual rows per rank.
  * pipeline (``pipeline_axis``, tree layout, uniform single-group decoder
    stacks): the stages are ``mesh.pipe``, a list of devices of this rank
    (single controller: all on one card when there is one card, S devices
    of a multi-card host otherwise). ``distributed.pipeline.run_schedule``
    walks the tick program. Each gradient class has one collective: stage
    chunks over dp; embed and head over the joint (pipe × dp) pairs, as
    the sum of one partial per (stage row, rank) — the embedding's lookup
    pullback on stage 0 (plus, tied, the head's part on stage S−1), the
    head's on stage S−1, zeros elsewhere — with the fp8 headroom widened to
    S·n_dp and one EF residual row per (stage, rank) cell.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Sequence

import torch

from repro_torch.core import bucketing
from repro_torch.core.collage import CollageAdamW, CollageOptState, StepMetrics
from repro_torch.core.mcf import Expansion
from repro_torch.core.precision import Strategy
from repro_torch.distributed import collectives as coll
from repro_torch.distributed import compression
from repro_torch.distributed import pipeline as pp
from repro_torch.distributed.compression import _div
from repro_torch.distributed.sharding import shard_of
from repro_torch.kernels.collage_update import ops as kops
from repro_torch.models import transformer as tf
from repro_torch.models.layers import embed_lookup
from repro_torch.models.model import AUX_LOSS_COEF, Model, ParamView
from repro_torch.train import train_loop

F32 = torch.float32
PIPE = "pipe"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The engine's mesh: ``dp``, the data-parallel ranks (this process is
    one of them), and ``pipe``, the pipeline stage devices inside this rank
    (empty without a pipeline axis)."""

    dp: coll.Axis = coll.Axis()
    pipe: tuple = ()

    @property
    def n_dp(self) -> int:
        return self.dp.size


def _in_groups(path: str) -> bool:
    """Leaf of the stacked decoder groups (dim 0 = layer stack)."""
    return "['groups']" in path


def _map_named(fn, tree):
    """``fn(path, leaf)`` over a params-like tree; an Expansion's two
    components get its path."""
    flat, skel = bucketing.tree_flatten_with_path(tree)

    def one(path, leaf):
        if isinstance(leaf, Expansion):
            return Expansion(fn(path, leaf.hi), fn(path, leaf.lo))
        return fn(path, leaf)
    return bucketing.tree_unflatten(skel, [one(p, x) for p, x in flat])


# --------------------------------------------------------------------------
# per-rank shards of the global state and batch
# --------------------------------------------------------------------------

def _zero_fields(o: bucketing.BucketedOptState) -> tuple:
    return tuple(f for f in ("m", "vhi", "vlo", "delta", "master") if getattr(o, f) is not None)


def shard_state(state: train_loop.TrainState, mesh: Mesh, *, zero_shard: bool = False,
                pipeline_axis: Optional[str] = None) -> train_loop.TrainState:
    """This rank's part of a global TrainState (the JAX engine's
    ``device_put_state``): its residual row(s) (its (stage, rank) rows in
    pipeline mode, rows s·n_dp + rank) and, with ``zero_shard``, its shard
    of every flat bucket; the rest is replicated."""
    axis, n = mesh.dp, mesh.n_dp
    params, opt_state, grad_err = state.params, state.opt_state, state.grad_err
    row = lambda e: e[axis.rank:axis.rank + 1].clone() if e.shape[0] == n else e
    if pipeline_axis is not None and grad_err is not None:
        S = len(mesh.pipe)
        grad_err = {k: v[[s * n + axis.rank for s in range(S)]].clone()
                    for k, v in grad_err.items()}
    elif grad_err is not None:
        grad_err = bucketing.tree_map(row, grad_err)
    if isinstance(opt_state, bucketing.BucketedOptState):
        if opt_state.grad_err is not None:
            opt_state = dataclasses.replace(opt_state,
                                            grad_err=tuple(row(e) for e in opt_state.grad_err))
        if zero_shard:
            sh = lambda bs: tuple(shard_of(b, axis) for b in bs)
            params = bucketing.BucketedParams(sh(params.data), params.layout)
            opt_state = dataclasses.replace(
                opt_state, **{f: sh(getattr(opt_state, f)) for f in _zero_fields(opt_state)})
    return train_loop.TrainState(params, opt_state, grad_err)


def gather_state(state: train_loop.TrainState, mesh: Mesh, *, zero_shard: bool = False,
                 pipeline_axis: Optional[str] = None) -> train_loop.TrainState:
    """The inverse of ``shard_state`` (a collective: every rank calls it and
    gets the global state)."""
    axis, n = mesh.dp, mesh.n_dp

    def rows(e):
        if n == 1:
            return e
        return coll.all_gather(e.reshape(-1), axis, "checkpoint").reshape(n, *e.shape[1:])
    params, opt_state, grad_err = state.params, state.opt_state, state.grad_err
    if pipeline_axis is not None and grad_err is not None:
        S = len(mesh.pipe)
        full = {}
        for k, v in grad_err.items():
            g = v if n == 1 else coll.all_gather(v.reshape(-1), axis, "checkpoint") \
                .reshape(n, S, v.shape[1])
            full[k] = v if n == 1 else torch.stack([g[d, s] for s in range(S) for d in range(n)])
        grad_err = full
    elif grad_err is not None:
        grad_err = bucketing.tree_map(rows, grad_err)
    if isinstance(opt_state, bucketing.BucketedOptState):
        if opt_state.grad_err is not None:
            opt_state = dataclasses.replace(opt_state,
                                            grad_err=tuple(rows(e) for e in opt_state.grad_err))
        if zero_shard:
            ga = lambda bs: tuple(coll.all_gather(b, axis, "checkpoint") for b in bs)
            params = bucketing.BucketedParams(ga(params.data), params.layout)
            opt_state = dataclasses.replace(
                opt_state, **{f: ga(getattr(opt_state, f)) for f in _zero_fields(opt_state)})
    return train_loop.TrainState(params, opt_state, grad_err)


def split_batch(batch: dict, mesh: Mesh) -> dict:
    """This rank's rows of the global batch: dim 0 of (B, ...) leaves, dim 1
    of pre-chunked (n_micro, mb, ...) batches."""
    n, r = mesh.n_dp, mesh.dp.rank
    if n == 1:
        return batch
    dim = 1 if batch["tokens"].dim() == 3 else 0

    def one(x):
        if x.dim() == 0:
            return x
        if x.shape[dim] % n:
            raise ValueError(f"batch dim {x.shape[dim]} does not divide {n} dp ranks")
        k = x.shape[dim] // n
        return x.narrow(dim, r * k, k)
    return {key: one(v) for key, v in batch.items()}


def _virtualize(tree: Any, n_stages: int, n_virtual: int) -> Any:
    """Every decoder-group leaf of a params-like tree in the (V, S, L/(S·V),
    …) round-robin chunk layout (``pipeline.split_virtual``): chunk
    c = v·S + s at [v, s], the canonical layer order when flattened."""
    C = n_stages * n_virtual

    def fix(path, leaf):
        if _in_groups(path) and leaf.dim() >= 1:
            L = leaf.shape[0]
            assert L % C == 0, (path, L, C)
            return leaf.reshape(n_virtual, n_stages, L // C, *leaf.shape[1:])
        return leaf
    return _map_named(fix, tree)


def _virtualize_opt(o: CollageOptState, n_stages: int, n_virtual: int) -> CollageOptState:
    v = lambda t: None if t is None else _virtualize(t, n_stages, n_virtual)
    return dataclasses.replace(o, m=v(o.m), v=v(o.v), delta=v(o.delta), master=v(o.master))


def init_state(model: Model, opt: CollageAdamW, seed: int, mesh: Mesh, *,
               grad_compression: str = "none", pipeline_axis: Optional[str] = None,
               virtual_stages: int = 1, device="cuda") -> train_loop.TrainState:
    """The GLOBAL TrainState (``shard_state`` gives a rank its part): one
    EF-residual row per dp rank; in pipeline mode the per-(leaf class ×
    dtype) bucket rows of ``pipeline_error_state``, and with
    ``virtual_stages > 1`` the group leaves in the (V, S, L/(S·V), …)
    chunk layout."""
    dtype, use_ef = compression.parse_spec(grad_compression)
    if pipeline_axis is None:
        if virtual_stages != 1:
            raise ValueError("virtual_stages requires pipeline_axis")
        return train_loop.init_state(model, opt, seed, grad_compression, n_dp=mesh.n_dp,
                                     device=device)
    state = train_loop.init_state(model, opt, seed, "none", device=device)
    S = len(mesh.pipe)
    if virtual_stages > 1:
        state = train_loop.TrainState(_virtualize(state.params, S, virtual_stages),
                                      _virtualize_opt(state.opt_state, S, virtual_stages), None)
    if use_ef:
        state = dataclasses.replace(state, grad_err=pipeline_error_state(
            state.params, S, mesh.n_dp, dtype))
    return state


# --------------------------------------------------------------------------
# pipeline-mode gradient compression: (leaf class × dtype) flat buckets
# --------------------------------------------------------------------------

def _pipeline_leaf_class(path: str) -> str:
    """``stage`` (stacked decoder chunks, stage-local), ``embed`` or
    ``head`` (final norm + lm head)."""
    if _in_groups(path):
        return "stage"
    if "['embed']" in path:
        return "embed"
    return "head"


def _pipeline_bucket_order(flat) -> dict:
    """{bucket key: [leaf index]} over ``tree_flatten_with_path`` output,
    ordered by first leaf; keys "<class>:<dtype>" as the JAX package's."""
    order: dict = {}
    for i, (path, leaf) in enumerate(flat):
        key = f"{_pipeline_leaf_class(path)}:{bucketing.dtype_name(leaf.dtype)}"
        order.setdefault(key, []).append(i)
    return order


def pipeline_error_state(params: Any, n_stages: int, n_dp: int, dtype) -> dict:
    """Zero EF residuals for the pipeline engine: one (n_stages · n_dp,
    bucket_len) block per (leaf class × dtype) bucket, ``bucket_len`` the
    per-stage length (a stage leaf contributes size / n_stages); row
    s · n_dp + d belongs to stage s of dp rank d."""
    flat, _ = bucketing.tree_flatten_with_path(params)
    rows = {}
    for key, idxs in _pipeline_bucket_order(flat).items():
        length = 0
        for i in idxs:
            path, leaf = flat[i]
            size = leaf.numel()
            if _pipeline_leaf_class(path) == "stage":
                assert size % n_stages == 0, (tuple(leaf.shape), n_stages)
                size //= n_stages
            length += size
        leaf0 = flat[idxs[0]][1]
        rows[key] = torch.zeros((n_stages * n_dp, length),
                                dtype=compression.residual_dtype(dtype, leaf0.dtype),
                                device=leaf0.device)
    return rows


def _stage_part(leaf: torch.Tensor, s: int, S: int, V: int) -> torch.Tensor:
    """Stage s's part of a stored stage leaf: its L/S layers, or (V > 1)
    its chunks [:, s]."""
    if V == 1:
        k = leaf.shape[0] // S
        return leaf[s * k:(s + 1) * k]
    return leaf[:, s]


def _compress_pipeline_grads(grads: Any, row_parts: dict, err_rows: Optional[dict], dtype,
                             axis: coll.Axis, n_dp: int, *, n_pipe: int, n_virtual: int,
                             class_order: Optional[Sequence[str]] = None):
    """Bucket-granular EF-compressed mean of the pipeline gradients: per
    (leaf class × dtype) bucket ONE compressed collective. Stage buckets:
    one row per stage (its chunk leaves, flat), each reduced over dp.
    Embed/head buckets: one row of partials per stage row, reduced over
    the joint (pipe × dp) pairs with headroom S·n_dp. ``row_parts``: for
    every embed/head leaf path, its S stage-row partials.

    Returns (grads in leaf dtypes, new residual rows or None)."""
    S, V = n_pipe, n_virtual
    flat, skel = bucketing.tree_flatten_with_path(grads)
    order = _pipeline_bucket_order(flat)
    keys = list(order)
    if class_order is not None:
        rank = {c: r for r, c in enumerate(class_order)}
        keys.sort(key=lambda k: (rank.get(k.split(":")[0], len(rank)), k))
    new_leaves: list = [None] * len(flat)
    new_rows: Optional[dict] = {} if err_rows is not None else None
    for key in keys:
        idxs = order[key]
        stage = key.split(":")[0] == "stage"
        if stage:
            parts = [[_stage_part(flat[i][1], s, S, V).reshape(-1) for i in idxs]
                     for s in range(S)]
        else:
            parts = [[row_parts[flat[i][0]][s].reshape(-1) for i in idxs] for s in range(S)]
        buckets = [p[0] if len(p) == 1 else torch.cat(p) for p in parts]
        errs = list(err_rows[key]) if err_rows is not None else [None] * S
        means, resids = compression.pmean_compressed_rows(
            buckets, errs, dtype, axis, n_dp, joint=not stage,
            headroom=None if stage else float(S * n_dp))
        if new_rows is not None:
            new_rows[key] = torch.stack(resids)
        for i in idxs:
            leaf = flat[i][1]
            new_leaves[i] = torch.empty_like(leaf)
        off = 0
        for i in idxs:
            path, leaf = flat[i]
            if stage:
                for s in range(S):
                    part = _stage_part(new_leaves[i], s, S, V)
                    part.copy_(means[s][off:off + part.numel()].reshape(part.shape))
                off += leaf.numel() // S
            else:
                new_leaves[i].copy_(means[0][off:off + leaf.numel()].reshape(leaf.shape))
                off += leaf.numel()
    return bucketing.tree_unflatten(skel, new_leaves), new_rows


# --------------------------------------------------------------------------
# metrics plumbing
# --------------------------------------------------------------------------

METRIC_KEYS = ("loss", "ce", "aux", "ppl", "edq", "update_norm", "imprecision_pct",
               "grad_norm")


def _metric_dict(loss, lmetrics, om: StepMetrics) -> dict:
    return {"loss": loss, "ce": lmetrics["ce"], "aux": lmetrics["aux"],
            "ppl": torch.exp(lmetrics["ce"]), "edq": om.edq, "update_norm": om.update_norm,
            "imprecision_pct": om.imprecision_pct, "grad_norm": om.grad_norm}


def _psum_parts(parts, axis) -> tuple:
    """Σ over the ranks of a 5-tuple of raw metric partials."""
    return tuple(coll.psum(torch.stack([p.to(F32) for p in parts]), axis, role="metric"))


# --------------------------------------------------------------------------
# the engine
# --------------------------------------------------------------------------

def make_sharded_train_step(model: Model, opt: CollageAdamW, mesh: Mesh, *,
                            microbatch: int = 0, remat: str = "none",
                            grad_compression: str = "none",
                            zero_shard: Optional[bool] = None,
                            pipeline_axis: Optional[str] = None,
                            schedule: str = "gpipe", virtual_stages: int = 1,
                            flash_min_len: Optional[int] = None,
                            donate: bool = False) -> Callable:
    """Build ``step(local_state, global_batch) → (local_state, metrics)``.

    zero_shard (default: on iff the optimizer is bucketed and there is more
    than one dp rank): ZeRO-shard every flat bucket; the layout's
    pad_multiple must divide (``sharding.bucket_pad_multiple``); the
    resolved value is ``step.zero_shard`` (the layout ``shard_state`` and
    the checkpoint functions take).
    grad_compression: "none" | "bf16[_ef]" | "fp8[_ef]" | "fp8e5_ef".
    pipeline_axis ("pipe"): the pipeline over ``mesh.pipe`` for a uniform
    single-group decoder stack (tree layout, pre-chunked batches);
    schedule "gpipe" | "1f1b" | "interleaved", virtual_stages V
    (interleaved; the state built with the same V by ``init_state``).
    donate (bucketed): the update writes over the state's buckets. Every
    combination the JAX engine refuses is refused here, at build time."""
    model = train_loop.with_flash(model, flash_min_len)
    bucketed = opt.policy.bucketing.enabled
    axis, n_dp = mesh.dp, mesh.n_dp
    if zero_shard is None:
        zero_shard = bucketed and n_dp > 1
    dtype, use_ef = compression.parse_spec(grad_compression)

    if zero_shard:
        if not bucketed:
            raise ValueError("zero_shard requires the bucketed layout "
                             "(opt.policy.bucketing.enabled)")
        need = n_dp * (compression.BLOCK if dtype is not None and compression.is_fp8(dtype)
                       else 1)
        pad = opt.policy.bucketing.pad_multiple
        if pad % need:
            raise ValueError(
                f"bucket pad_multiple {pad} must be a multiple of {need} for ZeRO over "
                f"{n_dp} ranks" + (" with fp8 block scaling" if need > n_dp else "")
                + " — build the BucketPolicy with "
                "sharding.bucket_pad_multiple(axis, block=compression.BLOCK)")
    if pipeline_axis is None:
        if schedule != "gpipe" or virtual_stages != 1:
            raise ValueError("schedule/virtual_stages require pipeline_axis")
    else:
        if pipeline_axis != PIPE or not mesh.pipe:
            raise ValueError(f"pipeline_axis {pipeline_axis!r}: the mesh's stage devices "
                             f"(Mesh.pipe) under the name {PIPE!r}")
        if bucketed or zero_shard:
            raise ValueError("pipeline mode requires the tree layout")
        if opt.use_fused_kernel:
            raise ValueError("pipeline mode requires the tree-layout optimizer step "
                             "(use_fused_kernel=False)")
        if schedule not in pp.SCHEDULES:
            raise ValueError(f"unknown schedule {schedule!r}; one of {pp.SCHEDULES}")
        if schedule != "interleaved" and virtual_stages != 1:
            raise ValueError(f"virtual_stages={virtual_stages} requires "
                             f"schedule='interleaved' (got {schedule!r})")
        if schedule == "interleaved" and virtual_stages < 2:
            raise ValueError("interleaved schedule needs virtual_stages>=2")
        _check_pipelinable(model, len(mesh.pipe) * virtual_stages)
    if donate and not bucketed:
        raise ValueError("donate: the bucketed layout only (the tree step is per leaf)")

    accum = train_loop.make_accum_grads(model, microbatch=microbatch, remat=remat)

    def pmean(x):
        return coll.pmean_scalar(x.to(F32), axis, role="loss")

    # ---------------------------------------------------- per-rank body --
    def body(state: train_loop.TrainState, batch):
        params, opt_state, grad_err = state.params, state.opt_state, state.grad_err
        if bucketed and zero_shard:
            full = bucketing.BucketedParams(tuple(coll.all_gather(d, axis) for d in params.data),
                                            params.layout)
        else:
            full = params
        loss, lmetrics, grads = accum(full, batch)
        loss = pmean(loss)
        lmetrics = {k: pmean(lmetrics[k]) for k in ("ce", "aux")}

        if bucketed:
            layout = params.layout
            err_rows = tuple(e[0] for e in opt_state.grad_err) if use_ef else None

            # each bucket's collective runs just before its own update
            reduce_fn, new_rows = compression.bucket_reducer(
                err_rows, dtype, axis, n_dp, layout.n_buckets, zero_shard=zero_shard)

            offs = None
            if zero_shard and opt.policy.strategy is Strategy.SR:
                # this shard's elements start at rank · padded/n_dp of each bucket
                offs = tuple(axis.rank * (b.padded // n_dp) for b in layout.buckets)
            if zero_shard and opt.compute_metrics:
                new_params, new_opt, parts = opt.step_bucketed(
                    grads.data, params, opt_state, metrics_partials=True, elem_offsets=offs,
                    reduce_fn=reduce_fn, donate=donate)
                om = kops.finalize_metrics(_psum_parts(parts, axis), layout.total_size)
            else:
                new_params, new_opt, om = opt.step_bucketed(
                    grads.data, params, opt_state, elem_offsets=offs, reduce_fn=reduce_fn,
                    donate=donate)
            if use_ef:
                new_opt = dataclasses.replace(new_opt, grad_err=compression.store_error_rows(
                    opt_state.grad_err, new_rows, donate))
        else:
            err_plain = bucketing.tree_map(lambda e: e[0], grad_err) if use_ef else None
            grads, new_err = compression.reduce_tree(grads, err_plain, dtype, axis, n_dp)
            if use_ef:
                grad_err = bucketing.tree_map(lambda r: r[None], new_err)
            new_params, new_opt, om = opt.step(grads, params, opt_state)
        return train_loop.TrainState(new_params, new_opt, grad_err), \
            _metric_dict(loss, lmetrics, om)

    # ------------------------------------------------ pipeline variant --
    stages = tuple(mesh.pipe)
    S, V = max(len(stages), 1), virtual_stages

    def _pipeline_grads(state, batch):
        """The schedule's gradients, reduced as the optimizer takes them →
        (grads, new residual rows, ce, aux)."""
        params = state.params
        cfg = model.cfg
        group = cfg.decoder_program()[0]
        n_micro = batch["tokens"].shape[0]
        sched = pp.make_schedule(schedule, n_stages=S, n_micro=n_micro, n_virtual=V)
        C = S * V
        cgroup = dataclasses.replace(group, repeats=group.repeats // C)

        def chunk_body(chunk_p, h):
            return tf.group_apply(chunk_p, h, cgroup, cfg, remat=remat)

        g0 = params["decoder"]["groups"][0]

        def chunk(c):
            dev = stages[c % S]
            if V == 1:
                k = group.repeats // S
                return bucketing.tree_map(lambda p: p[c * k:(c + 1) * k].to(dev), g0)
            v, s = divmod(c, S)
            return bucketing.tree_map(lambda p: p[v, s].to(dev), g0)

        tied = cfg.tie_embeddings
        last = stages[(C - 1) % S]
        head_params = {"norm": params["decoder"]["final_norm"].to(last),
                       "w": (params["embed"] if tied else params["lm_head"]).to(last)}

        def head_loss_fn(hp, y, lab):
            pseudo = ParamView({"embed": hp["w"] if tied else None,
                                "decoder": {"groups": [], "final_norm": hp["norm"]},
                                "lm_head": None if tied else hp["w"]})
            return model.token_ce(model._head(pseudo, y), lab)

        tokens = batch["tokens"].to(stages[0])
        emb = params["embed"].detach().to(stages[0])
        xs = embed_lookup(emb, tokens)
        out = pp.run_schedule(sched, chunk_body, head_loss_fn, [chunk(c) for c in range(C)],
                              head_params, xs, batch["labels"], devices=stages)

        # the embedding lookup's pullback of the dxs cotangents (stage 0's row)
        emb_req = emb.requires_grad_(True)
        with torch.enable_grad():
            (g_lookup,) = torch.autograd.grad(embed_lookup(emb_req, tokens), emb_req,
                                              out["dxs"].to(xs.dtype))
        home = params["embed"].device
        zeros = lambda p: torch.zeros_like(p)
        g_hw = out["g_head"]["w"].to(home)
        g_lookup = g_lookup.to(home)
        # per-stage-row partials of the embed/head leaves, in stored dtypes
        emb_rows = [zeros(params["embed"]) for _ in range(S)]
        emb_rows[0] = g_lookup.to(params["embed"].dtype)
        if tied:
            last_s = (C - 1) % S
            base = emb_rows[last_s].to(F32) if last_s != 0 else g_lookup.to(F32)
            emb_rows[last_s] = (base + g_hw).to(params["embed"].dtype)
        fn = params["decoder"]["final_norm"]
        row_parts = {"['embed']": emb_rows,
                     "['decoder']['final_norm']": [zeros(fn) for _ in range(S)]}
        row_parts["['decoder']['final_norm']"][(C - 1) % S] = \
            out["g_head"]["norm"].to(home).to(fn.dtype)
        if not tied:
            lh = params["lm_head"]
            row_parts["['lm_head']"] = [zeros(lh) for _ in range(S)]
            row_parts["['lm_head']"][(C - 1) % S] = g_hw.to(lh.dtype)

        # stage grads in the stored layout (each chunk cast to the leaf dtype)
        gc = [bucketing.tree_leaves(g) for g in out["g_chunks"]]
        skel = bucketing.tree_flatten_with_path(g0)[1]
        stored = []
        for j, p in enumerate(bucketing.tree_leaves(g0)):
            parts = [gc[c][j].to(device=p.device, dtype=p.dtype) for c in range(C)]
            stored.append(torch.cat(parts) if V == 1 else
                          torch.stack(parts).reshape(V, S, *parts[0].shape))
        grads = {"embed": None,
                 "decoder": {"groups": [bucketing.tree_unflatten(skel, stored)],
                             "final_norm": None}}
        if not tied:
            grads["lm_head"] = None

        class_order = sorted(sched.comm_ready, key=lambda c: sched.comm_ready[c])
        grad_err = state.grad_err
        if dtype is not None:
            # the embed/head placeholders only give the bucket order its leaves
            for path, rows in row_parts.items():
                _set_path(grads, path, rows[0])
            grads, new_rows = _compress_pipeline_grads(
                grads, row_parts, grad_err if use_ef else None, dtype, axis, n_dp,
                n_pipe=S, n_virtual=V, class_order=class_order)
            if use_ef:
                grad_err = new_rows
        else:
            grads["decoder"]["groups"] = [compression.reduce_tree(
                grads["decoder"]["groups"][0], None, None, axis, n_dp)[0]]
            for path, rows in row_parts.items():
                summed = coll.psum(torch.stack([r.to(F32) for r in rows]), axis, rows=True,
                                   joint=True)
                _set_path(grads, path, _div(summed, n_dp).to(rows[0].dtype))
        return grads, grad_err, _div(out["ce"].to(home), n_micro), \
            _div(out["aux"].to(home), n_micro)

    def _pipeline_body(state, batch):
        params = state.params
        home = params["embed"].device
        grads, grad_err, ce, aux = _pipeline_grads(state, batch)
        loss = pmean(ce + AUX_LOSS_COEF * aux)
        lmetrics = {"ce": pmean(ce), "aux": pmean(aux)}
        if opt.compute_metrics:
            # raw per-leaf partials: stage leaves and shared leaves summed
            # apart and finalized once, as the JAX engine does after its
            # psum over the pipe axis
            new_params, new_opt, parts = opt.step(grads, params, state.opt_state,
                                                  metrics_partials=True)
            flat, _ = bucketing.tree_flatten_with_path(grads)
            stage_tot = shared_tot = kops._zeros5(home)
            count = 0
            for (path, leaf), part in zip(flat, parts):
                if _pipeline_leaf_class(path) == "stage":
                    stage_tot = tuple(a + q for a, q in zip(stage_tot, part))
                else:
                    shared_tot = tuple(a + q for a, q in zip(shared_tot, part))
                count += leaf.numel()
            om = kops.finalize_metrics(tuple(a + b for a, b in zip(stage_tot, shared_tot)),
                                       count)
        else:
            new_params, new_opt, _ = opt.step(grads, params, state.opt_state)
            om = StepMetrics(*kops._zeros5(home))
        return train_loop.TrainState(new_params, new_opt, grad_err), \
            _metric_dict(loss, lmetrics, om)

    def step(state, batch):
        local = split_batch(batch, mesh)
        if pipeline_axis is not None:
            return _pipeline_body(state, local)
        return body(state, local)

    step.zero_shard = zero_shard
    if pipeline_axis is not None:
        # the gradients the pipeline step hands its optimizer (checks)
        step.grads = lambda state, batch: _pipeline_grads(state, split_batch(batch, mesh))[0]
    return step


def _set_path(tree: dict, path: str, value):
    """Set the leaf of a nested dict at a keystr path "['a']['b']"."""
    keys = [k.strip("'") for k in path[1:-1].split("][")]
    for k in keys[:-1]:
        tree = tree[k]
    tree[keys[-1]] = value


def _check_pipelinable(model: Model, n_stages: int):
    cfg = model.cfg
    prog = cfg.decoder_program()
    if cfg.is_encdec or cfg.family == "vlm":
        raise ValueError("pipeline mode: decoder-only models only")
    if len(prog) != 1:
        raise ValueError(f"pipeline mode needs a uniform single-group decoder stack, "
                         f"got {len(prog)} groups")
    group = prog[0]
    if any(s.kind == "cross_attn" for s in group.period):
        raise ValueError("pipeline mode: cross-attn groups unsupported")
    if group.repeats % n_stages:
        raise ValueError(f"decoder depth {group.repeats} not divisible by "
                         f"{n_stages} pipeline stages")

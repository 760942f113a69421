"""The train step on a grid of ranks: the counterpart of the JAX package's
``train_loop.make_train_step`` jitted with ``in_shardings=(state_shardings,
batch_shardings)`` (FSDP × TP, ``distributed.sharding``'s rules).

Each rank runs ``step(state, batch)`` on its blocks of the state (its
``state_shardings`` blocks: ``shard_state``) and the GLOBAL batch, of which
it keeps its dp rows (``batch_shardings``). The forward reads
``sharding.materialize``'s tensors, so the gradient reductions are the
backward of its gathers: a dp-sharded leaf's gradient is reduce-scattered
over dp, a dp-replicated leaf's summed over dp; leaves that every rank of
"model" applies to its own heads, and the norms under sequence
parallelism, have theirs summed over "model". Each rank's loss is its rows'
token sum over the global token count, so the sums over dp give the mean
over the global batch.

The update is elementwise and each optimizer leaf co-shards with its
parameter, so every rank updates its blocks alone. SR draws each element's
noise at its index in the whole leaf (``CollageAdamW.step(blocks=)``): the
grid's update is the one-rank update, bit for bit, given the same gradient.
The metrics' raw partials (⟨Δθ,Δθ̂⟩, ‖Δθ‖², ‖Δθ̂‖², #lost, ‖g‖², the EDQ
kernel on the blocks) are summed over the grid with each leaf counted once:
a leaf replicated over an axis only on that axis' rank 0.

Families on the grid: the dense ones (gpt-*, granite, internlm2,
codeqwen, gemma3 with its tied head and local:global windows), on the
tree layout. MoE, the recurrent mixers, the frontends and the bucketed
layout raise at build (``check_grid``); their specs are ported whole.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import bucketing
from repro_torch.core.collage import SR_FUSED_BLOCKS, CollageAdamW, CollageOptState
from repro_torch.core.precision import Strategy
from repro_torch.distributed import collectives as coll
from repro_torch.distributed import sharding as sh
from repro_torch.kernels.collage_update import ops as kops
from repro_torch.models import transformer as tf
from repro_torch.models.model import Model, param_dict

F32 = torch.float32
ITEM = "ROADMAP.md Queue 1 item 7b"


def check_grid(cfg: ModelConfig, grid, tp_mode: str = "full", bucketed: bool = False):
    """Raise for what the grid does not run yet; the message names the
    family and the roadmap item that ports it."""
    kinds = {s.kind for g in cfg.decoder_program() for s in g.period}
    name = cfg.name
    if "moe" in kinds:
        raise ValueError(f"{name}: MoE on a grid (the we_* expert dim over 'model', expert "
                         f"parallelism) is not ported yet ({ITEM})")
    if kinds & set(tf.RECURRENT):
        raise ValueError(f"{name}: the Mamba/RWKV channel dims over 'model' on a grid are not "
                         f"ported yet ({ITEM})")
    if cfg.is_encdec or cfg.family == "vlm":
        raise ValueError(f"{name}: the frontends' encoder and cross-attention on a grid are not "
                         f"ported yet ({ITEM})")
    if bucketed:
        raise ValueError(f"{name}: the bucketed layout on a grid is not ported yet ({ITEM}); "
                         f"over dp ranks alone, train.sharded's ZeRO engine shards the buckets")
    tp, dh = grid.tp, cfg.head_dim_
    if tp_mode == "full" and tp > 1 and (cfg.n_heads * dh) % tp == 0 and cfg.n_heads % tp:
        raise ValueError(f"{name}: {cfg.n_heads} query heads over model {tp} would split a head; "
                         f"tp_mode='mlponly' keeps attention whole")


def shard_state(state, grid, fsdp: bool = True, tp_mode: str = "full"):
    """This rank's blocks of a global TrainState (its ``state_shardings``)."""
    return sh.local_tree(state, sh.state_shardings(state, grid, fsdp, tp_mode), grid)


def gather_state(local, template, grid, fsdp: bool = True, tp_mode: str = "full"):
    """The global TrainState from every rank's blocks (all-gathers);
    ``template``: a global state (the meta device will do) for the specs."""
    return sh.gather_tree(local, sh.state_shardings(template, grid, fsdp, tp_mode), grid)


def _rebuild(tree, leaves):
    it = iter(leaves)
    return sh.map_leaves(lambda path, x: next(it), tree)


def make_grid_train_step(model: Model, opt: CollageAdamW, grid, *, fsdp: bool = True,
                         tp_mode: str = "full", sp: bool = False) -> Callable:
    """``step(state, batch) → (state, metrics)`` on ``grid``: ``state`` this
    rank's blocks, ``batch`` the global batch; the metrics are the global
    ones (0-dim tensors). ``sp``: sequence parallelism (when L divides
    "model")."""
    cfg = model.cfg
    check_grid(cfg, grid, tp_mode, opt.policy.bucketing.enabled)
    if opt.use_fused_kernel and opt.policy.strategy is Strategy.SR and grid.size > 1:
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
    dp, world = grid.axis("dp"), grid.axis("world")

    def grads_of(params, batch):
        bspec = sh.batch_shardings(batch, grid)
        local = sh.local_tree(batch, bspec, grid)
        rows_split = bool(bspec["tokens"] and bspec["tokens"][0])
        leaves = [x.detach().requires_grad_(True) for _, x in sh.named_leaves(params)]
        with torch.enable_grad(), tf.activation_sharding(sharder):
            sharder.begin_seq(local["tokens"].shape[1])
            compute = sh.materialize(_rebuild(params, leaves), pspecs, grid, cfg.head_dim_)
            loss, lm = model.loss(compute, local)
            if rows_split:           # this rank's token sum over the global token count
                n = (local["labels"][..., 1:] >= 0).sum().to(F32)
                scale = n / torch.clamp_min(coll.psum(n, dp, role="metric"), 1.0)
            else:                    # every dp rank holds the whole batch
                scale = torch.tensor(1.0 / grid.n_dp, dtype=F32, device=loss.device)
            grads = torch.autograd.grad(loss * scale, leaves, allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g for x, g in zip(leaves, grads)]
        ce = coll.psum((lm["ce"] * scale).detach(), dp, role="metric")
        return ce, _rebuild(params, grads)

    def update(state, grads):
        """The optimizer on this rank's blocks → (params, opt_state, the
        summed raw metric partials of the leaves this rank counts)."""
        if not opt.use_fused_kernel:
            params, ost, parts = opt.step(grads, state.params, state.opt_state,
                                          metrics_partials=True, blocks=blocks)
            return params, ost, kops.sum_partials([p for p, o in zip(parts, owned) if o],
                                                  parts[0][0].device)
        return _fused_update(opt, grads, state.params, state.opt_state, owned)

    def finish(ce, parts) -> dict:
        """The global metrics from the loss and this rank's counted partials."""
        tot = coll.psum(torch.stack([p.to(F32) for p in parts]), world, role="metric")
        om = kops.finalize_metrics(tuple(tot), total)
        zero = torch.zeros((), dtype=F32, device=ce.device)
        return {"loss": ce, "ce": ce, "aux": zero, "ppl": torch.exp(ce), "edq": om.edq,
                "update_norm": om.update_norm, "imprecision_pct": om.imprecision_pct,
                "grad_norm": om.grad_norm}

    def step(state, batch):
        from repro_torch.train.train_loop import TrainState
        ce, grads = grads_of(state.params, batch)
        params, opt_state, parts = update(state, grads)
        return TrainState(params, opt_state, None), finish(ce, parts)

    step.grads, step.update, step.finish = grads_of, update, finish
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

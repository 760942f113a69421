"""50 training steps of the port against 50 of the JAX package, for each
of the seven strategies, on gpt-smoke: loss, EDQ, update norm and
imprecision % agree at every step.

Both packages start from the JAX package's initial weights and take the
same batches (the JAX package's ``make_batch_fn``) and the same lr, bc1
and bc2 (the JAX package's cosine schedule with warmup): the tree layout
evaluates them as its jitted step does, the bucketed layout as its
``_scalars`` does. The tree layout runs all seven strategies; the bucketed
layout runs C (the main path) and SR, where both packages draw the same
counter-based noise (on the tree layout the port's SR noise is its own
hash stream, the JAX package's threefry: equally unbiased, not the same
bits).

Tolerances, and why they hold. The two packages compute the same
function, but not with the same roundings: their bf16 products are summed
in other orders, XLA's CPU backend flushes f32 subnormals where the port
keeps them, and XLA may contract a multiply and an add. Gradients then
differ in their last bits, a few elements of each step's bf16 update
round the other way, and the parameters drift apart by isolated ulps. The
loss, a mean over the batch, moves smoothly with them. EDQ and
imprecision % do not: they count which elements' updates land, and where
an update lands only when an accumulated value crosses a bf16 rounding
boundary (Kahan's compensation, D's master copy, stochastic rounding) a
drifted value crosses a step earlier or later. Measured over 50 steps on
this input, the largest differences were: loss 7.9e-4 (of ~5.4); EDQ
6.7e-4 absolute and 5 % relative late in the run, where EDQ falls to
~0.008 (tree SR, KAHAN, D; below 0.3 % for the others); update norm 0.13 %
relative; imprecision 0.33 percentage points. The tolerances are about
2.5–4 times those.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs.base import ShapeConfig as JShape
from repro.core.collage import CollageAdamW as JAdamW
from repro.core.collage import cosine_schedule as jcosine
from repro.core.precision import BucketPolicy as JBP
from repro.core.precision import PrecisionPolicy as JPP
from repro.core.precision import parse_strategy as jparse
from repro.data.synthetic import make_batch_fn as jax_batch_fn
from repro.kernels.collage_update import ops as jops
from repro.models.model import build_model as jax_build
from repro.train import train_loop as jtl
from repro_torch.configs import get_config
from repro_torch.convert import bucketed_from_numpy, params_from_numpy
from repro_torch.core.collage import CollageAdamW, cosine_schedule
from repro_torch.core.precision import BucketPolicy, PrecisionPolicy, parse_strategy
from repro_torch.kernels.collage_update import ops as tops
from repro_torch.models.model import build_model, param_dict
from repro_torch.train import train_loop as ttl

STEPS, LR, WARMUP = 50, 1e-3, 5
KW = dict(b2=0.95, weight_decay=0.1, compute_metrics=True, sr_seed=7)
CASES = [(s, False) for s in ["A", "B", "C", "KAHAN", "SR", "D-MW", "D"]] + \
    [("C", True), ("SR", True)]
LOSS_ATOL = 2e-3
EDQ_RTOL, EDQ_ATOL = 0.05, 5e-4          # |Δ| ≤ rtol·|edq| + atol
NORM_RTOL = 5e-3
IMPR_ATOL = 1.0                          # percentage points


@functools.lru_cache(maxsize=None)
def _jax_setup():
    cfg = jax_config("gpt-smoke", smoke=True)
    model = jax_build(cfg)
    make = jax_batch_fn(cfg, JShape("t", 32, 4, "train"))
    batches = [{k: np.asarray(v) for k, v in make(i).items()} for i in range(STEPS)]
    return model, model.init(jax.random.PRNGKey(0)), batches


@functools.lru_cache(maxsize=None)
def _tree_scalars():
    """(lr, bc1, bc2) of steps 1..STEPS as the JAX tree step evaluates them
    (``CollageAdamW.step``: f32 schedule and ``1 − b^t`` under jit)."""
    opt = JAdamW(jcosine(LR, WARMUP, STEPS), **KW)

    @jax.jit
    def scalars(t):
        tf = t.astype(jnp.float32)
        return (opt.lr(t).astype(jnp.float32), 1.0 - jnp.float32(opt.b1) ** tf,
                1.0 - jnp.float32(opt.b2) ** tf)

    return [tuple(float(x) for x in scalars(jnp.int32(t))) for t in range(1, STEPS + 1)]


def _close(got, want, rtol, atol):
    return abs(got - want) <= rtol * abs(want) + atol


@pytest.mark.parametrize("name,bucketed", CASES)
def test_trajectory_matches_jax(name, bucketed):
    jm, jp, batches = _jax_setup()
    tm = build_model(get_config("gpt-smoke", smoke=True))
    jopt = JAdamW(jcosine(LR, WARMUP, STEPS), policy=JPP(
        strategy=jparse(name), bucketing=JBP(enabled=bucketed)), **KW)
    topt = CollageAdamW(cosine_schedule(LR, WARMUP, STEPS), policy=PrecisionPolicy(
        strategy=parse_strategy(name), bucketing=BucketPolicy(enabled=bucketed)), **KW)
    if bucketed:
        jb, jst = jopt.init_bucketed(jp)
        js = jtl.TrainState(jb, jst, None)
        np_ = lambda t: None if t is None else [np.asarray(x) for x in t]
        tp, tst = bucketed_from_numpy(
            jb.layout.to_json(), np_(jb.data), np_(jst.m), np_(jst.vhi), np_(jst.vlo),
            np_(jst.delta), np_(jst.master), rng=None if jst.rng is None else int(jst.rng),
            device="cpu")
        ts = ttl.TrainState(tp, tst)
    else:
        js = jtl.TrainState(jp, jopt.init(jp), None)
        tparams = param_dict(params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tm.cfg,
                                               "cpu"))
        ts = ttl.TrainState(tparams, topt.init(tparams))
    jstep = jax.jit(jtl.make_train_step(jm, jopt))
    accum = ttl.make_accum_grads(tm)
    losses = []
    for i in range(STEPS):
        js, jmet = jstep(js, batches[i])
        loss, _, grads = accum(ts.params, {k: torch.from_numpy(v.astype(np.int64))
                                           for k, v in batches[i].items()})
        if bucketed:
            sc = tuple(float(x) for x in jops._scalars(jopt, jnp.int32(i + 1)))
            params, opt_state, m = tops.bucketed_step(topt, grads, ts.params, ts.opt_state,
                                                      scalars=sc)
        else:
            params, opt_state, m = topt.step(grads, ts.params, ts.opt_state,
                                             scalars=_tree_scalars()[i])
        ts = dataclasses.replace(ts, params=params, opt_state=opt_state)
        got = {"loss": float(loss), "edq": float(m.edq), "update_norm": float(m.update_norm),
               "imprecision_pct": float(m.imprecision_pct)}
        want = {k: float(jmet[k]) for k in got}
        where = f"{name} {'bucketed' if bucketed else 'tree'} step {i + 1}: {got} vs {want}"
        assert _close(got["loss"], want["loss"], 0.0, LOSS_ATOL), where
        assert _close(got["edq"], want["edq"], EDQ_RTOL, EDQ_ATOL), where
        assert _close(got["update_norm"], want["update_norm"], NORM_RTOL, 0.0), where
        assert _close(got["imprecision_pct"], want["imprecision_pct"], 0.0, IMPR_ATOL), where
        losses.append(got["loss"])
    assert ts.opt_state.step == int(js.opt_state.step) == STEPS
    assert losses[-1] < losses[0] - 0.1, losses

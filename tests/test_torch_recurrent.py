"""The recurrent families in the port (rwkv6-1.6b: RWKV6 time-mix and
channel-mix; jamba-1.5-large-398b: Mamba + NoPE attention + MoE) against
the JAX package at smoke size, with the JAX package's own initial weights
and numpy-seeded inputs:

* ``get_config``: CONFIG and SMOKE equal to the reference's field by field,
  ``param_count`` and ``active_param_count`` equal;
* the mixers ``rwkv_tmix_apply``, ``rwkv_cmix_apply``, ``mamba_apply`` and
  their decode steps at tests/test_torch_families.py's ``TOL``: f32
  against the jitted reference; bf16 against the eager one
  (``jax.disable_jit``), which rounds each operation on its own as the
  port does;
* the chunked mixers against the port's own sequential oracles
  (``rwkv_tmix_reference``, ``mamba_reference``) at L 8, 13 and 16 (bf16,
  tests/test_mixers.py's rtol 0.05 / atol 0.02);
* ``_mamba_state_after`` and ``_rwkv_state_after`` against the
  reference's at prompt lengths 2, 3, 13 and 16 (the partial-chunk tail and
  prompts shorter than the conv receptive field);
* the group norm of ``_out_proj`` takes the population variance (a case
  that fails with the unbiased one);
* ``chunk_scan`` against a sequential recurrence;
* forward, loss and every gradient of rwkv6-smoke and jamba-smoke in f32 at
  tests/test_torch_train.py's tolerance (rtol 1e-3, atol 1e-5);
* one train step, bucketed and on the tree layout, under C and SR: the
  loss against the JAX package's, the update's metrics against the JAX
  optimizer's on the same gradient (tree SR draws its own noise);
* remat ``full`` and ``dots`` give gradients bit-identical to ``none``."""

import contextlib
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs.base import ShapeConfig as JShape
from repro.core import bucketing as jbucketing
from repro.core.collage import CollageAdamW as JAdamW
from repro.core.precision import BucketPolicy as JBP
from repro.core.precision import PrecisionPolicy as JPP
from repro.core.precision import parse_strategy as jparse
from repro.data.synthetic import make_batch_fn as jax_batch_fn
from repro.models import rwkv as jrwkv
from repro.models import ssm as jssm
from repro.models import transformer as jtf
from repro.models.model import build_model as jax_build
from repro.train import train_loop as jtl
from repro_torch.configs import get_config
from repro_torch.convert import (bucketed_from_numpy, params_from_numpy, tensor_from_numpy,
                                 tensor_to_numpy)
from repro_torch.core import bucketing
from repro_torch.core.collage import CollageAdamW
from repro_torch.core.precision import BucketPolicy, PrecisionPolicy, parse_strategy
from repro_torch.models import rwkv as trwkv
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as ttf
from repro_torch.models.model import build_model, param_dict
from repro_torch.train import train_loop as ttl

ARCHS = ["rwkv6-1.6b", "jamba-1.5-large-398b"]
TOL = {"float32": dict(rtol=1e-4, atol=1e-4), "bfloat16": dict(rtol=3e-2, atol=3e-2)}
ORACLE_TOL = dict(rtol=0.05, atol=0.02)      # tests/test_mixers.py's
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _x(shape, dtype, seed=1, scale=0.5):
    """numpy-seeded activations, rounded to ``dtype``: (jax array, torch tensor)."""
    a = (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)
    ja = jnp.asarray(a).astype(JDT[dtype])
    return ja, tensor_from_numpy(np.asarray(ja), "cpu")


def _np32(t):
    return (t.float().numpy() if isinstance(t, torch.Tensor)
            else np.asarray(jnp.asarray(t).astype(jnp.float32)))


@functools.lru_cache(maxsize=None)
def _mixer(kind, dtype):
    """(cfg, JAX params of one sublayer, the port's copy of them)."""
    arch = "jamba-1.5-large-398b" if kind == "mamba" else "rwkv6-1.6b"
    cfg = jax_config(arch, smoke=True)
    init = {"mamba": jssm.mamba_init, "rwkv_tmix": jrwkv.rwkv_tmix_init,
            "rwkv_cmix": jrwkv.rwkv_cmix_init}[kind]
    jp = init(jax.random.PRNGKey(0), cfg, JDT[dtype])
    tp = {k: tensor_from_numpy(np.asarray(v), "cpu") for k, v in jp.items()}
    return get_config(arch, smoke=True), jp, tp


def _eager(dtype):
    """f32: the jitted reference; bf16: the eager one (see the module doc)."""
    return jax.disable_jit() if dtype == "bfloat16" else contextlib.nullcontext()


def _jit(fn, dtype):
    return fn if dtype == "bfloat16" else jax.jit(fn)


# ----------------------------------------------------------------- configs --
@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_the_reference(arch):
    for smoke in (False, True):
        assert dataclasses.asdict(get_config(arch, smoke)) == \
            dataclasses.asdict(jax_config(arch, smoke))
    cfg, jcfg = get_config(arch), jax_config(arch)
    assert [(g.repeats, [s.kind for s in g.period]) for g in cfg.decoder_program()] \
        == [(g.repeats, [s.kind for s in g.period]) for g in jcfg.decoder_program()]
    assert (cfg.param_count(), cfg.active_param_count()) == \
        (jcfg.param_count(), jcfg.active_param_count()) == \
        {"rwkv6-1.6b": (1_583_450_112, 1_583_450_112),
         "jamba-1.5-large-398b": (398_553_047_040, 94_147_239_936)}[arch]
    assert cfg.supports_long_context


@pytest.mark.parametrize("arch", ARCHS)
def test_full_config_shapes_on_meta_match_eval_shape(arch):
    """The full CONFIG's tree on the meta device: the reference's names,
    shapes and dtypes (jamba: 398 B parameters, no memory)."""
    want = {jax.tree_util.keystr(p): (tuple(a.shape), str(a.dtype)) for p, a in
            jax.tree_util.tree_leaves_with_path(
                jax.eval_shape(jax_build(jax_config(arch)).init, jax.random.PRNGKey(0)))}
    tp = build_model(get_config(arch)).init(device="meta")
    got = {"".join(f"[{int(k)}]" if k.isdigit() else f"['{k}']" for k in n.split(".")):
           (tuple(t.shape), str(t.dtype).replace("torch.", "")) for n, t in tp.named_parameters()}
    assert got == want and all(t.is_meta for t in tp.parameters())


# ------------------------------------------------------------------ mixers --
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["rwkv_tmix", "rwkv_cmix", "mamba"])
def test_mixer_apply_matches_reference(kind, dtype):
    cfg, jp, tp = _mixer(kind, dtype)
    jx, tx = _x((2, 21, cfg.d_model), dtype)            # 21: a partial last chunk
    japply = {"mamba": jssm.mamba_apply, "rwkv_tmix": jrwkv.rwkv_tmix_apply,
              "rwkv_cmix": jrwkv.rwkv_cmix_apply}[kind]
    tapply = {"mamba": tssm.mamba_apply, "rwkv_tmix": trwkv.rwkv_tmix_apply,
              "rwkv_cmix": trwkv.rwkv_cmix_apply}[kind]
    with _eager(dtype):
        want = _jit(lambda p, x: japply(p, x, cfg), dtype)(jp, jx)
    got = tapply(tp, tx, cfg)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    np.testing.assert_allclose(_np32(got), _np32(want), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["rwkv_tmix", "rwkv_cmix", "mamba"])
def test_mixer_decode_steps_match_reference(kind, dtype):
    """Six decode steps from a zero state: outputs and every state leaf
    (dtypes included: S and h f32, last_x and conv the model dtype)."""
    cfg, jp, tp = _mixer(kind, dtype)
    jx, tx = _x((3, 6, cfg.d_model), dtype, seed=2)
    if kind == "mamba":
        jstep, tstep = jssm.mamba_decode, tssm.mamba_decode
        jst = jssm.mamba_init_state(cfg, 3, JDT[dtype])
        tst = tssm.mamba_init_state(cfg, 3, tx.dtype, "cpu")
    elif kind == "rwkv_tmix":
        jstep, tstep = jrwkv.rwkv_tmix_decode, trwkv.rwkv_tmix_decode
        jst = jrwkv.rwkv_tmix_init_state(cfg, 3, JDT[dtype])
        tst = trwkv.rwkv_tmix_init_state(cfg, 3, tx.dtype, "cpu")
    else:
        jstep, tstep = jrwkv.rwkv_cmix_decode, trwkv.rwkv_cmix_decode
        jst = {"last_x": jnp.zeros((3, cfg.d_model), JDT[dtype])}
        tst = {"last_x": torch.zeros((3, cfg.d_model), dtype=tx.dtype)}
    step = _jit(lambda p, x, s: jstep(p, x, cfg, s), dtype)
    for t in range(6):
        with _eager(dtype):
            jo, jst = step(jp, jx[:, t:t + 1], jst)
        to, tst = tstep(tp, tx[:, t:t + 1], cfg, tst)
        np.testing.assert_allclose(_np32(to), _np32(jo), **TOL[dtype], err_msg=f"step {t}")
        assert sorted(tst) == sorted(jst)
        for name in jst:
            assert str(tst[name].dtype).replace("torch.", "") == str(jst[name].dtype), name
            np.testing.assert_allclose(_np32(tst[name]), _np32(jst[name]), **TOL[dtype],
                                       err_msg=f"step {t} {name}")


@pytest.mark.parametrize("L", [8, 13, 16])
@pytest.mark.parametrize("kind", ["rwkv_tmix", "mamba"])
def test_chunked_mixer_matches_own_sequential_oracle(kind, L):
    cfg, _, tp = _mixer(kind, "bfloat16")
    _, tx = _x((2, L, cfg.d_model), "bfloat16", seed=3)
    if kind == "mamba":
        par, seq = tssm.mamba_apply(tp, tx, cfg), tssm.mamba_reference(tp, tx, cfg)
    else:
        par, seq = trwkv.rwkv_tmix_apply(tp, tx, cfg), trwkv.rwkv_tmix_reference(tp, tx, cfg)
    np.testing.assert_allclose(_np32(par), _np32(seq), **ORACLE_TOL)


def test_chunk_scan_equals_sequential_recurrence():
    """The log-step scan at chunk lengths 1–17 (powers of two and not)
    against h_t = a_t·h_{t-1} + b_t from h_{-1} = 0, in f64."""
    g = torch.Generator().manual_seed(0)
    for n in range(1, 18):
        a = torch.rand((2, n, 3, 4), generator=g, dtype=torch.float64)
        b = torch.randn((2, n, 3, 4), generator=g, dtype=torch.float64)
        acc_a, acc_b = tssm.chunk_scan(a, b)
        h, pa = torch.zeros_like(b[:, 0]), torch.ones_like(a[:, 0])
        for t in range(n):
            h, pa = a[:, t] * h + b[:, t], a[:, t] * pa
            torch.testing.assert_close(acc_b[:, t], h, rtol=1e-12, atol=1e-12)
            torch.testing.assert_close(acc_a[:, t], pa, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("L", [2, 3, 13, 16])
@pytest.mark.parametrize("kind", ["rwkv_tmix", "mamba"])
def test_state_after_prefill_matches_reference(kind, L):
    """The decode state after a prompt of L tokens (chunk 8: L 13 has a
    partial tail, L 2 and 3 are shorter than the conv's K-1 = 3)."""
    cfg, jp, tp = _mixer(kind, "float32")
    jx, tx = _x((2, L, cfg.d_model), "float32", seed=4)
    jfn = jtf._mamba_state_after if kind == "mamba" else jtf._rwkv_state_after
    tfn = ttf._mamba_state_after if kind == "mamba" else ttf._rwkv_state_after
    want = jax.jit(lambda p, x: jfn(p, x, cfg))(jp, jx)
    got = tfn(tp, tx, cfg)
    assert sorted(got) == sorted(want)
    for name in want:
        assert tuple(got[name].shape) == want[name].shape, name
        np.testing.assert_allclose(_np32(got[name]), _np32(want[name]), **TOL["float32"],
                                   err_msg=name)


def test_out_proj_group_norm_takes_the_population_variance():
    """hd 16 makes the unbiased variance 16/15 of the population one: the
    normalised output moves by ~3 %, far outside f32 1e-4."""
    cfg, jp, tp = _mixer("rwkv_tmix", "float32")
    B, L, d = 2, 5, cfg.d_model
    rng = np.random.default_rng(5)
    wkv = rng.standard_normal((B, L, d // cfg.rwkv_head_dim, cfg.rwkv_head_dim)) \
        .astype(np.float32)
    g = rng.standard_normal((B, L, d)).astype(np.float32)
    want = jrwkv._out_proj(jp, jnp.asarray(wkv), jnp.asarray(g), cfg, jnp.float32)
    got = trwkv._out_proj(tp, torch.from_numpy(wkv), torch.from_numpy(g), cfg, torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL["float32"])


def test_softplus_is_logaddexp_above_the_torch_threshold():
    """dt = softplus(...) at 30 and -30 as jax.nn.softplus gives it."""
    x = np.array([-30.0, -1.0, 0.0, 1.0, 19.9, 20.1, 30.0], np.float32)
    np.testing.assert_array_equal(tssm.softplus(torch.from_numpy(x)).numpy(),
                                  np.asarray(jax.nn.softplus(jnp.asarray(x))))


# ------------------------------------------------------------ whole model --
@functools.lru_cache(maxsize=None)
def _pair(arch, dtype="float32"):
    jcfg = dataclasses.replace(jax_config(arch, smoke=True), dtype=dtype)
    tcfg = dataclasses.replace(get_config(arch, smoke=True), dtype=dtype)
    jm = jax_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tcfg, "cpu")
    return jm, jp, build_model(tcfg), tp


def _tokens(B, T, V, seed=0):
    return np.random.default_rng(seed).integers(0, V, size=(B, T))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_and_aux(arch, dtype):
    jm, jp, tm, tp = _pair(arch, dtype)
    toks = _tokens(2, 21, tm.cfg.vocab_size)
    with _eager(dtype):
        jl, ja = _jit(jm.forward, dtype)(jp, {"tokens": jnp.asarray(toks, jnp.int32)})
    tl, ta = tm.forward(tp, {"tokens": torch.from_numpy(toks)})
    assert tl.dtype == torch.float32 and tl.shape == (2, 21, tm.cfg.vocab_size)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl, np.float32), **TOL[dtype])
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-5, atol=1e-7)
    assert (float(ta) > 0) == (tm.cfg.family == "hybrid")


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference_f32(arch):
    jm, jp, tm, tp = _pair(arch)
    toks = _tokens(2, 20, tm.cfg.vocab_size, seed=2)
    batch = {"tokens": toks, "labels": toks}
    (jl, jmet), jg = jax.value_and_grad(lambda p: jm.loss(p, batch), has_aux=True)(jp)
    loss, met, grads = ttl.make_accum_grads(tm)(
        tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert abs(float(loss) - float(jl)) < 1e-5, (float(loss), float(jl))
    np.testing.assert_allclose(float(met["aux"]), float(jmet["aux"]), rtol=1e-5, atol=1e-7)
    jleaves = jax.tree_util.tree_leaves_with_path(jg)
    tleaves = bucketing.tree_flatten_with_path(grads)[0]
    assert [jax.tree_util.keystr(p) for p, _ in jleaves] == [p for p, _ in tleaves]
    for (path, a), (_, b) in zip(jleaves, tleaves):
        assert b.abs().sum() > 0, f"no gradient reached {path}"
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-3, atol=1e-5,
                                   err_msg=jax.tree_util.keystr(path))


# tests/test_torch_train.py's tolerances of its bf16 step comparisons
# (bucketed: loss 5e-4 absolute, norms 4e-3 relative, imprecision 0.04
# points; tree layout: 2e-3, 6e-3, 0.4)
STEP_TOL = {True: dict(loss=5e-4, rel=4e-3, impr=0.04),
            False: dict(loss=2e-3, rel=6e-3, impr=0.4)}
OPT_KW = dict(b2=0.95, weight_decay=0.1, compute_metrics=True, sr_seed=7)


def _step_batch(cfg, i):
    b = jax_batch_fn(cfg, JShape("t", 16, 2, "train"))(i)
    return {k: np.asarray(v) for k, v in b.items()}


@pytest.mark.parametrize("name", ["C", "SR"])
@pytest.mark.parametrize("bucketed", [True, False], ids=["bucketed", "tree"])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference_bf16(arch, bucketed, name):
    """One bf16 train step of the port from the JAX package's initial
    state against the JAX package's: its loss against the jitted
    reference's, and its update metrics against the reference optimizer
    (``train_loop._apply_opt``, jitted) applied to the port's own gradient,
    within tests/test_torch_train.py's tolerances. (The bf16 gradients
    themselves: a jitted reference fuses the chunked mixers' bf16 chains
    and lands ~3 % from the per-op rounding that the port and the eager
    reference share, and an eager reference takes minutes to compile; the
    gradient's parity is held in f32 above.) Bucketed SR draws the
    reference's counter-based noise from the same seed; tree SR its own
    stream, so there finite metrics only."""
    jcfg = jax_config(arch, smoke=True)
    jm, tm = jax_build(jcfg), build_model(get_config(arch, smoke=True))
    jopt = JAdamW(1e-3, policy=JPP(strategy=jparse(name), bucketing=JBP(enabled=bucketed)),
                  **OPT_KW)
    topt = CollageAdamW(1e-3, use_fused_kernel=bucketed, policy=PrecisionPolicy(
        strategy=parse_strategy(name), bucketing=BucketPolicy(enabled=bucketed)), **OPT_KW)
    js = jtl.init_state(jm, jopt, jax.random.PRNGKey(0))
    jtree = js.params.tree() if bucketed else js.params
    tree = param_dict(params_from_numpy(jax.tree_util.tree_map(np.asarray, jtree), tm.cfg,
                                        "cpu"))
    if bucketed:
        np_ = lambda t: None if t is None else [np.asarray(x) for x in t]
        bo = js.opt_state
        tparams, tstate = bucketed_from_numpy(
            js.params.layout.to_json(), np_(js.params.data), np_(bo.m), np_(bo.vhi),
            np_(bo.vlo), np_(bo.delta), np_(bo.master), step=int(bo.step),
            rng=None if bo.rng is None else int(bo.rng), device="cpu")
        ts = ttl.TrainState(tparams, tstate)
    else:
        ts = ttl.TrainState(tree, topt.init(tree))
    batch = _step_batch(jcfg, 0)
    tbatch = {k: torch.from_numpy(v.astype(np.int64)) for k, v in batch.items()}
    _, _, tgrads = ttl.make_accum_grads(tm)(tree, tbatch)
    jgrads = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(jtree),
        [jnp.asarray(tensor_to_numpy(g, jnp.bfloat16)) for g in bucketing.tree_leaves(tgrads)])
    if bucketed:
        jgrads = jbucketing.BucketedParams(jbucketing.bucket_tree(jgrads, js.params.layout),
                                           js.params.layout)
    jloss = jax.jit(lambda p: jm.loss(p, batch)[0])(jtree)
    _, _, om = jax.jit(lambda g, p, s: jtl._apply_opt(jopt, g, p, s))(
        jgrads, js.params, js.opt_state)
    ts, tmet = ttl.make_train_step(tm, topt)(ts, tbatch)
    tol = STEP_TOL[bucketed]
    assert abs(float(tmet["loss"]) - float(jloss)) < tol["loss"]
    assert isinstance(ts.params, dict) != bucketed and ts.opt_state.step == 1
    if name == "SR" and not bucketed:
        assert all(np.isfinite(float(v)) for v in tmet.values()) and float(tmet["edq"]) > 0
        return
    for k in ("edq", "grad_norm", "update_norm"):
        np.testing.assert_allclose(float(tmet[k]), float(getattr(om, k)), rtol=tol["rel"],
                                   err_msg=k)
    assert abs(float(tmet["imprecision_pct"]) - float(om.imprecision_pct)) < tol["impr"]


@pytest.mark.parametrize("remat", ["full", "dots"])
@pytest.mark.parametrize("arch", ARCHS)
def test_remat_gradients_are_bit_identical(arch, remat):
    _, _, tm, tp = _pair(arch)
    toks = torch.from_numpy(_tokens(2, 16, tm.cfg.vocab_size, seed=7))
    batch = {"tokens": toks, "labels": toks}
    (l0, m0, g0), (l1, m1, g1) = [ttl.make_accum_grads(tm, remat=r)(tp, batch)
                                  for r in ("none", remat)]
    assert float(l0) == float(l1) and float(m0["aux"]) == float(m1["aux"])
    for (path, a), (_, b) in zip(bucketing.tree_flatten_with_path(g0)[0],
                                 bucketing.tree_flatten_with_path(g1)[0]):
        assert torch.equal(a, b), path

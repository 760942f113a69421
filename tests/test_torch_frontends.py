"""The two frontend families in the port (seamless-m4t-medium: an encoder
over audio frames and cross-attention in every decoder layer;
internvl2-1b: a prefix of vision patches in the decoder sequence) against
the JAX package at smoke size, with the JAX package's own initial weights
moved over by ``params_from_numpy``. The frontends are stubs in both
packages: precomputed (B, F, D) embeddings, here drawn from a numpy seed.

* ``get_config``: CONFIG and SMOKE equal to the reference's field by field,
  the decoder and encoder programs, ``param_count``;
* the parameter tree's names and shapes (the ``encoder`` subtree), and the
  full CONFIGs' on the meta device against ``jax.eval_shape``;
* ``full_attention`` with ``x_kv`` (no rotary embedding), ``cross_kv``,
  ``cross_decode`` and ``_encode`` at f32 1e-4 and bf16 3e-2;
* forward logits, the loss (a VLM's on its text segment) and every leaf's
  f32 gradient, the encoder's included; remat none, full and dots give
  bit-identical gradients, the encoder's included;
* one bucketed and one tree-layout step under C and SR (the reference
  optimizer fed the port's gradient, tests/test_torch_recurrent.py's
  tolerances);
* ragged prefill then decode against the reference's decode (f32), the
  positions after the VLM prefix, and the ``cache_len < F + T`` error;
* the synthetic corpus's frontend batches: shapes, dtype, scale, the VLM's
  text length."""

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
from repro.models import attention as jattn
from repro.models.model import build_model as jax_build
from repro.train import train_loop as jtl
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.convert import (bucketed_from_numpy, params_from_numpy, tensor_from_numpy,
                                 tensor_to_numpy)
from repro_torch.core import bucketing
from repro_torch.core.collage import CollageAdamW
from repro_torch.core.precision import BucketPolicy, PrecisionPolicy, parse_strategy
from repro_torch.data.synthetic import make_batch_fn
from repro_torch.models import attention as tattn
from repro_torch.models.model import as_view, build_model, param_dict
from repro_torch.train import train_loop as ttl

ARCHS = ["seamless-m4t-medium", "internvl2-1b"]
TOL = {"float32": dict(rtol=1e-4, atol=1e-4), "bfloat16": dict(rtol=3e-2, atol=3e-2)}
# tests/test_torch_recurrent.py's train-step tolerances (bucketed, tree)
STEP_TOL = {True: dict(loss=5e-4, rel=4e-3, impr=0.04),
            False: dict(loss=2e-3, rel=6e-3, impr=0.4)}
OPT_KW = dict(b2=0.95, weight_decay=0.1, compute_metrics=True, sr_seed=7)


@functools.lru_cache(maxsize=None)
def _pair(arch, dtype):
    jcfg = dataclasses.replace(jax_config(arch, smoke=True), dtype=dtype)
    tcfg = dataclasses.replace(get_config(arch, smoke=True), dtype=dtype)
    jm = jax_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tcfg, "cpu")
    return jm, jp, build_model(tcfg), tp


def _batch(cfg, B, T, seed=0):
    """Tokens (B, T) and frontends (B, F, D) f32 N(0, 0.1²) from a numpy seed."""
    g = np.random.default_rng(seed)
    toks = g.integers(0, cfg.vocab_size, size=(B, T))
    fe = g.standard_normal((B, cfg.frontend_len, cfg.d_model), dtype=np.float32) * 0.1
    return {"tokens": toks, "labels": toks, "frontend": fe}


def _jax(batch):
    return {k: jnp.asarray(v, jnp.int32 if v.dtype.kind == "i" else v.dtype)
            for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _dotted(path) -> str:
    return ".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_the_reference(arch):
    for smoke in (False, True):
        assert dataclasses.asdict(get_config(arch, smoke)) == \
            dataclasses.asdict(jax_config(arch, smoke))
    cfg, jcfg = get_config(arch), jax_config(arch)
    prog = lambda gs: [(g.repeats, [(s.kind, s.window, s.causal) for s in g.period]) for g in gs]
    assert prog(cfg.decoder_program()) == prog(jcfg.decoder_program())
    assert prog(cfg.encoder_program()) == prog(jcfg.encoder_program())
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.is_encdec == jcfg.is_encdec == (arch == "seamless-m4t-medium")


@pytest.mark.parametrize("arch", ARCHS)
def test_param_tree_names_and_shapes(arch):
    _, jp, tm, tp = _pair(arch, "float32")
    want = {_dotted(p): tuple(a.shape) for p, a in jax.tree_util.tree_leaves_with_path(jp)}
    got = {n: tuple(t.shape) for n, t in tp.named_parameters()}
    assert got == want
    assert any(n.startswith("encoder.") for n in got) == tm.cfg.is_encdec
    assert ("lm_head" in got) == (not tm.cfg.tie_embeddings)


@pytest.mark.parametrize("arch", ARCHS)
def test_full_config_shapes_on_meta_match_eval_shape(arch):
    cfg = get_config(arch)
    want = {_dotted(p): (tuple(a.shape), str(a.dtype)) for p, a in
            jax.tree_util.tree_leaves_with_path(
                jax.eval_shape(jax_build(jax_config(arch)).init, jax.random.PRNGKey(0)))}
    got = {n: (tuple(t.shape), str(t.dtype).replace("torch.", "")) for n, t in
           build_model(cfg).init(device="meta").named_parameters()}
    assert got == want


def _attn_params(cfg, dtype, seed=0):
    """One attention sublayer's weights as (JAX dict, port dict)."""
    g = np.random.default_rng(seed)
    d, h, hk, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    shapes = {"wq": (d, h * dh), "wk": (d, hk * dh), "wv": (d, hk * dh), "wo": (h * dh, d)}
    np_ = {k: (g.standard_normal(s, dtype=np.float32) * d**-0.5) for k, s in shapes.items()}
    jp = {k: jnp.asarray(v, dtype) for k, v in np_.items()}
    tp = {k: torch.from_numpy(v).to(getattr(torch, dtype)) for k, v in np_.items()}
    return jp, tp


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_attention_paths_match_reference(dtype):
    """``full_attention`` with ``x_kv`` (cross-attention: no mask, no rotary
    embedding) and without (non-causal self-attention: rotary), then
    ``cross_kv`` and ``cross_decode`` at one query and at a verify step's
    four, on seamless smoke's widths."""
    cfg = dataclasses.replace(get_config("seamless-m4t-medium", smoke=True), dtype=dtype)
    jp, tp = _attn_params(cfg, dtype)
    g = np.random.default_rng(1)
    x = g.standard_normal((2, 5, cfg.d_model), dtype=np.float32)
    mem = g.standard_normal((2, 8, cfg.d_model), dtype=np.float32)
    jx, jmem = jnp.asarray(x, dtype), jnp.asarray(mem, dtype)
    tx, tmem = (torch.from_numpy(a).to(getattr(torch, dtype)) for a in (x, mem))
    close = lambda t, j: np.testing.assert_allclose(t.float().numpy(),
                                                    np.asarray(j, np.float32), **TOL[dtype])
    close(tattn.full_attention(tp, tx, cfg, causal=False, x_kv=tmem, rope=False),
          jattn.full_attention(jp, jx, cfg, causal=False, x_kv=jmem))
    close(tattn.full_attention(tp, tx, cfg, causal=False),
          jattn.full_attention(jp, jx, cfg, causal=False))
    tkv, jkv = tattn.cross_kv(tp, tmem, cfg), jattn.cross_kv(jp, jmem, cfg)
    for name in ("k", "v"):
        close(tkv[name], jkv[name])
    for L in (1, 4):
        close(tattn.cross_decode(tp, tx[:, :L], cfg, tkv),
              jattn.cross_decode(jp, jx[:, :L], cfg, jkv))
    # rotary embedding is self-attention's only: x_kv = x itself with
    # rope=False is the JAX package's cross-attention over the same rows
    assert not torch.equal(tattn.full_attention(tp, tx, cfg, causal=False, x_kv=tx, rope=False),
                           tattn.full_attention(tp, tx, cfg, causal=False))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encode_matches_reference(dtype):
    jm, jp, tm, tp = _pair("seamless-m4t-medium", dtype)
    fe = _batch(tm.cfg, 2, 4)["frontend"]
    want = jax.jit(jm._encode)(jp, jnp.asarray(fe, dtype))
    got = tm._encode(as_view(tp), torch.from_numpy(fe))
    assert got.dtype == getattr(torch, dtype) and got.shape == (2, tm.cfg.frontend_len,
                                                                tm.cfg.d_model)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match_reference(arch, dtype):
    """Logits over the whole decoder sequence (the VLM's prefix included)
    against the jitted reference, at f32 1e-4 and bf16 3e-2."""
    jm, jp, tm, tp = _pair(arch, dtype)
    batch = _batch(tm.cfg, 2, 12, seed=2)
    jl, _ = jax.jit(jm.forward)(jp, _jax(batch))
    tl, _ = tm.forward(tp, _torch(batch))
    assert tl.dtype == torch.float32 and tl.shape == (2, tm._prefix_len + 12, 256)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL[dtype])


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference_f32(arch):
    """At tests/test_torch_train.py's gradient tolerance (rtol 1e-3, atol
    1e-5), every leaf nonzero: the encoder's through cross-attention, the
    VLM's loss on the text segment only."""
    jm, jp, tm, tp = _pair(arch, "float32")
    batch = _batch(tm.cfg, 2, 12, seed=3)
    (jl, _), jg = jax.value_and_grad(lambda p: jm.loss(p, _jax(batch)), has_aux=True)(jp)
    loss, met, grads = ttl.make_accum_grads(tm)(tp, _torch(batch))
    assert abs(float(loss) - float(jl)) < 1e-5, (float(loss), float(jl))
    logits, _ = tm.forward(tp, _torch(batch))
    text = torch.from_numpy(batch["labels"])
    assert float(met["ce"]) == float(tm.token_ce(logits[:, tm._prefix_len:], text))
    jleaves = jax.tree_util.tree_leaves_with_path(jg)
    tleaves = bucketing.tree_flatten_with_path(grads)[0]
    assert [jax.tree_util.keystr(p) for p, _ in jleaves] == [p for p, _ in tleaves]
    assert any("encoder" in p for p, _ in tleaves) == tm.cfg.is_encdec
    for (path, a), (_, b) in zip(jleaves, tleaves):
        assert b.abs().sum() > 0, f"no gradient reached {path}"
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-3, atol=1e-5,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_keeps_the_encoder_gradient_bit_identical(remat):
    """``memory`` enters each checkpointed decoder layer as an input: under
    remat full and dots the loss and every gradient, the encoder's
    included, are remat none's bit for bit (seamless smoke, f32)."""
    _, _, tm, tp = _pair("seamless-m4t-medium", "float32")
    batch = _torch(_batch(tm.cfg, 2, 12, seed=4))
    (l0, _, g0), (l1, _, g1) = (ttl.make_accum_grads(tm, remat=r)(tp, batch)
                                for r in ("none", remat))
    assert float(l0) == float(l1)
    flat0, flat1 = (bucketing.tree_flatten_with_path(g)[0] for g in (g0, g1))
    assert sum("encoder" in p for p, _ in flat0) > 0
    for (path, a), (_, b) in zip(flat0, flat1):
        assert torch.equal(a, b), path


def _step_batch(cfg, i):
    b = jax_batch_fn(cfg, JShape("t", 16, 2, "train"))(i)
    return {k: np.asarray(v) for k, v in b.items()}


@pytest.mark.parametrize("name", ["C", "SR"])
@pytest.mark.parametrize("bucketed", [True, False], ids=["bucketed", "tree"])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference_bf16(arch, bucketed, name):
    """One bf16 train step of the port from the JAX package's initial state
    and on its batch (frontends included): the loss against the jitted
    reference's, the update metrics against the reference optimizer
    (``train_loop._apply_opt``, jitted) on the port's own gradient
    (tests/test_torch_recurrent.py's protocol and tolerances). Tree SR
    draws its own noise stream: finite metrics there."""
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
    assert batch["frontend"].shape == (2, jcfg.frontend_len, jcfg.d_model)
    tbatch = {k: tensor_from_numpy(v.astype(np.int64) if v.dtype.kind == "i" else v, "cpu")
              for k, v in batch.items()}
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


@pytest.mark.parametrize("arch", ARCHS)
def test_ragged_prefill_then_decode_matches_reference(arch):
    """Ragged prefill (prompt_lens) then three decode steps against the
    reference's own decode (f32; not against decode ≡ forward, which the
    reference misses by an f32 ulp), positions F + length + steps."""
    jm, jp, tm, tp = _pair(arch, "float32")
    batch = _batch(tm.cfg, 3, 14, seed=5)
    del batch["labels"]
    lens = np.array([14, 6, 11])
    jlog, jst = jax.jit(jm.prefill, static_argnums=2)(jp, _jax(batch), 32,
                                                      jnp.asarray(lens, jnp.int32))
    tlog, tst = tm.prefill(tp, _torch(batch), 32, prompt_lens=torch.from_numpy(lens))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL["float32"])
    assert tst.pos.tolist() == np.asarray(jst.pos).tolist() == (tm._prefix_len + lens).tolist()
    step = jax.jit(jm.decode_step)
    for i, nxt in enumerate(([[3], [7], [11]], [[5], [2], [9]], [[1], [4], [8]])):
        nxt = np.array(nxt)
        jlog, jst = step(jp, jst, jnp.asarray(nxt, jnp.int32))
        tlog, tst = tm.decode_step(tp, tst, torch.from_numpy(nxt))
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL["float32"],
                                   err_msg=f"decode step {i}")
    assert tst.pos.tolist() == (tm._prefix_len + lens + 3).tolist()


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_refuses_a_cache_shorter_than_prefix_and_prompt(arch):
    """The VLM's patches take F positions of the cache: cache_len < F + T
    raises (the reference asserts); generate's default cache fits F + T +
    max_new_tokens."""
    _, _, tm, tp = _pair(arch, "float32")
    batch = _torch(_batch(tm.cfg, 1, 10, seed=6))
    F = tm._prefix_len
    assert F == (tm.cfg.frontend_len if tm.cfg.family == "vlm" else 0)
    with pytest.raises(ValueError, match="cache_len"):
        tm.prefill(tp, batch, F + 9)
    _, st = tm.prefill(tp, batch, F + 10)
    assert st.pos.tolist() == [F + 10]
    toks, st = tm.generate(tp, batch, 4)
    assert toks.shape == (1, 4) and st.pos.tolist() == [F + 10 + 3]
    assert st.layers[0]["sub0"]["k"].shape[2] == F + 10 + 4
    with pytest.raises(ValueError, match="cache_len"):
        tm.generate(tp, batch, 4, cache_len=F + 13)


@pytest.mark.parametrize("arch", ARCHS)
def test_make_batch_fn_frontends(arch):
    """The synthetic frontends: (B, F, D) in the model dtype on the device
    asked for, N(0, 0.1²) (a numpy stream, where the JAX corpus draws from
    jax.random: the same shape and scale), a pure function of (seed, step);
    a VLM's text takes seq_len − F tokens, so prefix and text fill seq_len."""
    cfg = get_config(arch, smoke=True)
    B, L = 4, 32
    fn = make_batch_fn(cfg, ShapeConfig("t", L, B, "train"), seed=3, device="cpu")
    jfn = jax_batch_fn(jax_config(arch, smoke=True), JShape("t", L, B, "train"), seed=3)
    b, jb = fn(0), jfn(0)
    text = L - cfg.frontend_len if cfg.family == "vlm" else L
    assert b["tokens"].shape == tuple(jb["tokens"].shape) == (B, text)
    assert b["frontend"].shape == tuple(jb["frontend"].shape) == (B, cfg.frontend_len,
                                                                  cfg.d_model)
    assert b["frontend"].dtype == torch.bfloat16 and b["frontend"].device.type == "cpu"
    big = make_batch_fn(cfg, ShapeConfig("t", L, 64, "train"), device="cpu")(5)["frontend"]
    assert abs(big.float().std().item() - 0.1) < 5e-3 and abs(big.float().mean().item()) < 5e-3
    assert torch.equal(fn(0)["frontend"], b["frontend"])
    assert not torch.equal(fn(1)["frontend"], b["frontend"])

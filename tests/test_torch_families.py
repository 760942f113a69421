"""The six attention-only families in the port (qwen3-moe-30b-a3b,
moonshot-v1-16b-a3b, gemma3-27b, granite-3-2b, internlm2-1.8b,
codeqwen1.5-7b) against the JAX package at smoke size, with the JAX
package's own initial weights moved over by ``params_from_numpy``:

* ``get_config``: CONFIG and SMOKE equal to the reference's field by field;
  every family resolves (none is left to port);
* the parameter tree's names and shapes, and the full CONFIGs' shapes on
  the meta device against ``jax.eval_shape`` of the reference's init;
* forward logits and the MoE aux loss at tests/test_torch_model.py's
  tolerances: f32 against the jitted reference; bf16 against the eager
  one (``jax.disable_jit``), which rounds each operation on its own as the
  port does: a jitted program may fuse the router's product and round a
  logit one bf16 ulp apart, and on qwen3 smoke that flips a route (a
  different function, not a rounding). Routes are compared first, layer by
  layer, against the eager reference's; a flip fails the test;
* gemma3 smoke with 10 layers: a stack of two groups (2 × (3 local + 1
  global), then a tail of 2 local layers);
* ragged prefill, then decode, held to the reference's decode (f32);
* the loss and every parameter gradient in f32 (tied heads: the embedding
  gradient sums the lookup's and the head's)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import transformer as jtf
from repro.models.layers import matmul as jmatmul
from repro.models.layers import rms_norm as jrms
from repro.models.model import build_model as jax_build
from repro_torch import configs as tconfigs
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import bucketing
from repro_torch.models import moe as tmoe
from repro_torch.models.model import build_model
from repro_torch.train import train_loop as ttl

ARCHS = ["qwen3-moe-30b-a3b", "moonshot-v1-16b-a3b", "gemma3-27b", "granite-3-2b",
         "internlm2-1.8b", "codeqwen1.5-7b"]
TOL = {"float32": dict(rtol=1e-4, atol=1e-4), "bfloat16": dict(rtol=3e-2, atol=3e-2)}


@functools.lru_cache(maxsize=None)
def _pair(arch, dtype, **over):
    kw = dict(dtype=dtype, **over)
    jcfg = dataclasses.replace(jax_config(arch, smoke=True), **kw)
    tcfg = dataclasses.replace(get_config(arch, smoke=True), **kw)
    jm = jax_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tcfg, "cpu")
    return jm, jp, build_model(tcfg), tp


def _tokens(B, T, V, seed=0):
    return np.random.default_rng(seed).integers(0, V, size=(B, T))


def _dotted(path) -> str:
    return ".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_the_reference(arch):
    for smoke in (False, True):
        assert dataclasses.asdict(get_config(arch, smoke)) == \
            dataclasses.asdict(jax_config(arch, smoke))
    cfg, jcfg = get_config(arch), jax_config(arch)
    assert [(g.repeats, [(s.kind, s.window) for s in g.period]) for g in cfg.decoder_program()] \
        == [(g.repeats, [(s.kind, s.window) for s in g.period]) for g in jcfg.decoder_program()]
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.active_param_count() == jcfg.active_param_count()
    assert cfg.supports_long_context == jcfg.supports_long_context


def test_other_families_still_raise():
    """No family is left to port (seamless-m4t and internvl2 were the last):
    ``NOT_YET_PORTED`` is empty, the port's registry holds every arch of the
    JAX package's and each resolves; an unknown arch raises KeyError."""
    from repro.configs import ARCHS as JAX_ARCHS

    assert tconfigs.NOT_YET_PORTED == ()
    assert sorted(tconfigs.ARCHS) == sorted(k for k in JAX_ARCHS if not k.startswith("gpt"))
    for arch in tconfigs.ARCHS:
        assert get_config(arch).name == get_config(arch, smoke=True).name == arch
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("no-such-arch")


@pytest.mark.parametrize("arch", ARCHS)
def test_param_tree_names_and_shapes(arch):
    _, jp, tm, tp = _pair(arch, "float32")
    want = {_dotted(p): tuple(a.shape) for p, a in jax.tree_util.tree_leaves_with_path(jp)}
    got = {n: tuple(t.shape) for n, t in tp.named_parameters()}
    assert got == want
    assert ("lm_head" in got) == (not tm.cfg.tie_embeddings)


@pytest.mark.parametrize("arch", ARCHS)
def test_full_config_shapes_on_meta_match_eval_shape(arch):
    """The full CONFIG's tree (billions of parameters) on the meta device:
    no memory, the reference's shapes and dtypes."""
    cfg = get_config(arch)
    want = {_dotted(p): (tuple(a.shape), str(a.dtype)) for p, a in
            jax.tree_util.tree_leaves_with_path(
                jax.eval_shape(jax_build(jax_config(arch)).init, jax.random.PRNGKey(0)))}
    tp = build_model(cfg).init(device="meta")
    got = {n: (tuple(t.shape), str(t.dtype).replace("torch.", "")) for n, t in
           tp.named_parameters()}
    assert got == want
    assert all(t.is_meta for t in tp.parameters())


def _reference_routes(jm, jp, toks):
    """The eager reference's experts at every MoE sublayer, in order: its
    forward stepped layer by layer with its own sub_apply and routing
    lines (repro.models.moe._moe_dispatch: bf16 router product, f32
    softmax, top_k)."""
    cfg = jm.cfg
    routes = []
    with jax.disable_jit():
        x = jp["embed"][jnp.asarray(toks)]
        for g, gp in zip(cfg.decoder_program(), jp["decoder"]["groups"]):
            for layer in range(g.repeats):
                lp = jax.tree_util.tree_map(lambda a: a[layer], gp)
                for i, s in enumerate(g.period):
                    p = lp[f"sub{i}"]
                    if s.kind == "moe":
                        h = jrms(x, p["norm"], cfg.norm_eps).reshape(-1, cfg.d_model)
                        probs = jax.nn.softmax(jmatmul(h, p["router"]).astype(jnp.float32), -1)
                        routes.append(np.asarray(jax.lax.top_k(probs, cfg.experts_per_token)[1]))
                    x, _ = jtf.sub_apply(p, x, s, cfg)
    return routes


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_and_aux(arch, dtype):
    jm, jp, tm, tp = _pair(arch, dtype)
    toks = _tokens(2, 24, tm.cfg.vocab_size)
    batch = {"tokens": jnp.asarray(toks, jnp.int32)}
    if dtype == "float32":
        jl, ja = jax.jit(jm.forward)(jp, batch)
    else:
        with jax.disable_jit():
            jl, ja = jm.forward(jp, batch)
    with tmoe.record() as rec:
        tl, ta = tm.forward(tp, {"tokens": torch.from_numpy(toks)})
    if tm.cfg.family == "moe":
        ref = _reference_routes(jm, jp, toks)
        assert len(rec) == len(ref) == tm.cfg.n_layers
        for layer, (r, want) in enumerate(zip(rec, ref)):
            np.testing.assert_array_equal(r["idx"][0].numpy(), want, err_msg=f"layer {layer}")
        assert float(ta) > 0
    assert tl.dtype == torch.float32 and tl.shape == (2, 24, tm.cfg.vocab_size)
    np.testing.assert_allclose(tl.float().numpy(), np.asarray(jl, np.float32), **TOL[dtype])
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-5, atol=1e-7)


def test_gemma3_two_group_stack_forward_and_decode():
    """gemma3 smoke at 10 layers: 2 × (3 local + 1 global), then a tail
    group of 2 local layers; forward, ragged prefill and two decode steps."""
    jm, jp, tm, tp = _pair("gemma3-27b", "float32", n_layers=10)
    groups = tm.cfg.decoder_program()
    assert [(g.repeats, len(g.period)) for g in groups] == [(2, 8), (1, 4)]
    assert len(tp.decoder.groups) == 2
    toks = _tokens(2, 24, tm.cfg.vocab_size, seed=4)
    jl, _ = jax.jit(jm.forward)(jp, {"tokens": jnp.asarray(toks, jnp.int32)})
    tl, _ = tm.forward(tp, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL["float32"])
    _prefill_decode(jm, jp, tm, tp, seed=5)


def _prefill_decode(jm, jp, tm, tp, seed):
    toks = _tokens(3, 20, tm.cfg.vocab_size, seed=seed)
    lens = np.array([20, 11, 16])
    jlog, jst = jax.jit(jm.prefill, static_argnums=2)(
        jp, {"tokens": jnp.asarray(toks, jnp.int32)}, 32, jnp.asarray(lens, jnp.int32))
    tlog, tst = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, 32,
                           prompt_lens=torch.from_numpy(lens))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL["float32"])
    np.testing.assert_array_equal(tst.pos.numpy(), np.asarray(jst.pos))
    step = jax.jit(jm.decode_step)
    for i, nxt in enumerate(([[3], [7], [11]], [[5], [2], [9]])):
        nxt = np.array(nxt)
        jlog, jst = step(jp, jst, jnp.asarray(nxt, jnp.int32))
        tlog, tst = tm.decode_step(tp, tst, torch.from_numpy(nxt))
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL["float32"],
                                   err_msg=f"decode step {i}")
        np.testing.assert_array_equal(tst.pos.numpy(), np.asarray(jst.pos))


@pytest.mark.parametrize("arch", ARCHS)
def test_ragged_prefill_then_decode(arch):
    jm, jp, tm, tp = _pair(arch, "float32")
    _prefill_decode(jm, jp, tm, tp, seed=1)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference_f32(arch):
    """At tests/test_torch_train.py's gradient tolerance (rtol 1e-3, atol
    1e-5); the MoE aux term is in the loss and in every router gradient."""
    jm, jp, tm, tp = _pair(arch, "float32")
    toks = _tokens(2, 24, tm.cfg.vocab_size, seed=2)
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


def test_make_batch_fn_defaults_to_the_card():
    """The port's synthetic batches default to the card, as every entry
    point does: without one they raise the port's no-card error; the CPU
    is asked for."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.synthetic import make_batch_fn

    cfg, shape = get_config("granite-3-2b", smoke=True), ShapeConfig("t", 16, 2, "train")
    if torch.cuda.is_available():
        assert make_batch_fn(cfg, shape)(0)["tokens"].is_cuda
    else:
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            make_batch_fn(cfg, shape)
    batch = make_batch_fn(cfg, shape, device="cpu")(0)
    assert batch["tokens"].device.type == "cpu" and batch["tokens"].shape == (2, 16)


def test_donated_train_step_equals_functional_and_tree_refuses():
    """The launcher's bucketed step donates its state (the new values are
    written over the old buckets): the same losses and bits as the
    functional step; the tree layout has no donated step."""
    from repro_torch.core.collage import CollageAdamW
    from repro_torch.core.precision import BucketPolicy, PrecisionPolicy

    tm = build_model(get_config("qwen3-moe-30b-a3b", smoke=True))
    toks = _tokens(2, 16, tm.cfg.vocab_size, seed=6)
    batch = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(toks)}
    runs = []
    for donate in (False, True):
        opt = CollageAdamW(1e-3, policy=PrecisionPolicy(bucketing=BucketPolicy(enabled=True)))
        state = ttl.init_state(tm, opt, 0, device="cpu")
        first = state.params.data[0]
        step = ttl.make_train_step(tm, opt, donate=donate)
        losses = []
        for _ in range(2):
            state, met = step(state, batch)
            losses.append(float(met["loss"]))
        assert (state.params.data[0].data_ptr() == first.data_ptr()) == donate
        runs.append((losses, state.params.data[0].view(torch.int16).clone()))
    assert runs[0][0] == runs[1][0] and torch.equal(runs[0][1], runs[1][1])
    opt = CollageAdamW(1e-3)
    state = ttl.init_state(tm, opt, 0, device="cpu")
    with pytest.raises(ValueError, match="bucketed layout only"):
        ttl.make_train_step(tm, opt, donate=True)(state, batch)


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_moe_aux_and_gradients_through_remat(remat):
    """``remat`` recomputes the MoE layers (routing included) in the
    backward pass: the loss, the aux term and every gradient bit-identical
    to remat none (qwen3 smoke, f32)."""
    _, _, tm, tp = _pair("qwen3-moe-30b-a3b", "float32")
    toks = torch.from_numpy(_tokens(2, 16, tm.cfg.vocab_size, seed=7))
    batch = {"tokens": toks, "labels": toks}
    runs = [ttl.make_accum_grads(tm, remat=r)(tp, batch) for r in ("none", remat)]
    (l0, m0, g0), (l1, m1, g1) = runs
    assert float(l0) == float(l1) and float(m0["aux"]) == float(m1["aux"]) > 0
    for (path, a), (_, b) in zip(bucketing.tree_flatten_with_path(g0)[0],
                                 bucketing.tree_flatten_with_path(g1)[0]):
        assert torch.equal(a, b), path

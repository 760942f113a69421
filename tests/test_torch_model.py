"""The port's Model (repro_torch.models.model) against repro.models.model
on gpt-smoke, with the JAX package's own initial weights moved over by
``params_from_numpy``: forward, ragged prefill and decode logits, and greedy
``generate`` tokens, with the flash path off and on (flash_min_len 16,
flash_block 16 — the JAX kernel in interpret mode, the port's wrapper on
its plain version)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models.model import build_model as jax_build
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.models.layers import rms_norm
from repro_torch.models.model import as_view, build_model

# f32: the tolerance of tests/test_flash_vjp.py's model-level prefill check.
# bf16: every matmul output is rounded to bf16 (2^-8 relative) and the two
# frameworks round at the same places but reduce in different orders, so a
# last-bit flip in the residual stream can reach the f32 logits (std ~0.2
# at gpt-smoke) at the 1e-2 level.
TOL = {"float32": dict(rtol=1e-4, atol=1e-4), "bfloat16": dict(rtol=3e-2, atol=3e-2)}


def _cfgs(dtype, flash):
    kw = dict(dtype=dtype, flash_min_len=flash, flash_block=16)
    return (dataclasses.replace(jax_config("gpt-smoke", smoke=True), **kw),
            dataclasses.replace(get_config("gpt-smoke", smoke=True), **kw))


@functools.lru_cache(maxsize=None)
def _pair(dtype, flash):
    jcfg, tcfg = _cfgs(dtype, flash)
    jm = jax_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tcfg, "cpu")
    return dtype, jm, jp, build_model(tcfg), tp


@pytest.fixture(scope="module", params=[("float32", 0), ("float32", 16), ("bfloat16", 0),
                                        ("bfloat16", 16)], ids=lambda p: f"{p[0]}-flash{p[1]}")
def pair(request):
    return _pair(*request.param)


@pytest.fixture(scope="module", params=[0, 16], ids=lambda f: f"float32-flash{f}")
def pair_f32(request):
    return _pair("float32", request.param)


def _tokens(B, T, V, seed=0):
    return np.random.default_rng(seed).integers(0, V, size=(B, T))


def _close(t, j, dtype):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32), **TOL[dtype])


def test_param_tree_names_and_shapes(pair):
    _, _, jp, _, tp = pair
    named = dict(tp.named_parameters())
    assert named["decoder.groups.0.sub0.wq"].shape == jp["decoder"]["groups"][0]["sub0"]["wq"].shape
    assert named["lm_head"].shape == jp["lm_head"].shape
    n_jax = len(jax.tree_util.tree_leaves(jp))
    assert len(named) == n_jax


def test_forward_logits(pair):
    dtype, jm, jp, tm, tp = pair
    toks = _tokens(2, 24, tm.cfg.vocab_size)
    jl, _ = jax.jit(jm.forward)(jp, {"tokens": jnp.asarray(toks, jnp.int32)})
    tl, _ = tm.forward(tp, {"tokens": torch.from_numpy(toks)})
    assert tl.dtype == torch.float32 and tl.shape == (2, 24, tm.cfg.vocab_size)
    _close(tl, jl, dtype)


def test_ragged_prefill_then_decode(pair):
    dtype, jm, jp, tm, tp = pair
    toks = _tokens(2, 24, tm.cfg.vocab_size, seed=1)
    lens = np.array([24, 17])
    jlog, jst = jax.jit(jm.prefill, static_argnums=2)(
        jp, {"tokens": jnp.asarray(toks, jnp.int32)}, 32, jnp.asarray(lens, jnp.int32))
    tlog, tst = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, 32,
                           prompt_lens=torch.from_numpy(lens))
    _close(tlog, jlog, dtype)
    np.testing.assert_array_equal(tst.pos.numpy(), np.asarray(jst.pos))
    empty = tm.init_decode_state(2, 32, device="cpu")
    for name in ("k", "v"):
        _close(tst.layers[0]["sub0"][name], jst.layers[0]["sub0"][name], dtype)
        assert empty.layers[0]["sub0"][name].shape == jst.layers[0]["sub0"][name].shape
        assert not empty.layers[0]["sub0"][name].any()
    nxt = np.array([[3], [7]])
    jlog2, jst2 = jax.jit(jm.decode_step)(jp, jst, jnp.asarray(nxt, jnp.int32))
    tlog2, tst2 = tm.decode_step(tp, tst, torch.from_numpy(nxt))
    _close(tlog2, jlog2, dtype)
    np.testing.assert_array_equal(tst2.pos.numpy(), np.asarray(jst2.pos))


@pytest.mark.parametrize("masked", [False, True], ids=["closed", "eos-budgets"])
def test_generate_greedy_tokens_identical_fp32(pair_f32, masked):
    """Token identity is held in f32; bf16 is held by its logits above."""
    _, jm, jp, tm, tp = pair_f32
    toks = _tokens(3, 20, tm.cfg.vocab_size, seed=2)
    lens = np.array([20, 13, 17])
    kw = {}
    if masked:
        # EOS = the 4th greedy token of row 0 of the unmasked run, so that an
        # EOS really fires; row 2 has a budget of 5
        first, _ = tm.generate(tp, {"tokens": torch.from_numpy(toks)}, 8,
                               prompt_lens=torch.from_numpy(lens))
        kw = dict(eos_id=int(first[0, 3]), pad_id=int(first[0, 3]) + 1,
                  gen_lens=np.array([8, 8, 5]))
    jgen = jax.jit(lambda p, b, pl, gl: jm.generate(
        p, b, 8, prompt_lens=pl, gen_lens=gl, eos_id=kw.get("eos_id"),
        pad_id=kw.get("pad_id", 0)))
    jt, _ = jgen(jp, {"tokens": jnp.asarray(toks, jnp.int32)}, jnp.asarray(lens, jnp.int32),
                 None if not masked else jnp.asarray(kw["gen_lens"], jnp.int32))
    tt, _ = tm.generate(tp, {"tokens": torch.from_numpy(toks)}, 8,
                        prompt_lens=torch.from_numpy(lens),
                        gen_lens=None if not masked else torch.from_numpy(kw["gen_lens"]),
                        eos_id=kw.get("eos_id"), pad_id=kw.get("pad_id", 0))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    if masked:
        assert (tt[0, 4:] == kw["pad_id"]).all()      # row 0 stopped at its EOS


def test_sampling_is_seeded_and_top_k_bounded():
    """Sampling streams are not the JAX package's (jax.random vs a
    torch.Generator), so they are held by their own contract: the same
    generator seed repeats, and top-k never leaves the k best logits."""
    from repro_torch.models.model import greedy_tokens, sample_logits

    logits = torch.from_numpy(np.random.default_rng(0).standard_normal((4, 50)).astype(np.float32))
    draws = [sample_logits(logits, torch.Generator().manual_seed(1), 0.7, 5) for _ in range(2)]
    assert torch.equal(draws[0], draws[1])
    top5 = torch.topk(logits, 5).indices
    for _ in range(20):
        tok = sample_logits(logits, torch.Generator().manual_seed(_), 1.3, 5)
        assert all(int(t) in top5[i].tolist() for i, t in enumerate(tok))
    one = sample_logits(logits, torch.Generator().manual_seed(3), 2.0, 1)
    assert torch.equal(one, greedy_tokens(logits))


def test_head_cpu_path_and_its_gradient():
    """``Model._head`` on the CPU is the f32 product of the upcast operands
    (the card's bf16 product with f32 output has no CPU kernel), and its
    bf16 gradients match the JAX package's ``preferred_element_type=f32``
    product's: both take the f32 cotangent times the other operand and
    round once to bf16, so they may differ by one bf16 ulp."""
    _, jm, jp, tm, tp = _pair("bfloat16", 0)
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((2, 5, tm.cfg.d_model)) * 0.5).astype(np.float32)
    r = rng.standard_normal((2, 5, tm.cfg.vocab_size)).astype(np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    w = tp.lm_head.detach()
    norm = tp.decoder.final_norm.detach()
    want = torch.matmul(rms_norm(xb, norm, tm.cfg.norm_eps).float(), w.float())
    xg, wg = xb.clone().requires_grad_(True), w.clone().requires_grad_(True)
    params = {"embed": tp.embed.detach(), "lm_head": wg,
              "decoder": {"groups": [], "final_norm": norm}}
    logits = tm._head(as_view(params), xg)
    assert logits.dtype == torch.float32 and torch.equal(logits, want)
    dx, dw = torch.autograd.grad((logits * torch.from_numpy(r)).sum(), (xg, wg))

    def jhead(xj, wj):
        p = dict(jp, lm_head=wj)
        return jnp.sum(jm._head(p, xj) * r)

    jdx, jdw = jax.grad(jhead, argnums=(0, 1))(jnp.asarray(x, jnp.bfloat16),
                                               jnp.asarray(jp["lm_head"]))
    for got, ref in ((dx, jdx), (dw, jdw)):
        ref = np.asarray(ref, np.float32)
        np.testing.assert_allclose(got.float().numpy(), ref, rtol=2.0**-7,
                                   atol=2.0**-7 * np.abs(ref).max())

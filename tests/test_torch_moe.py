"""The port's MoE FFN (repro_torch.models.moe) and its banded and blocked
attention (models.attention.banded_attention, flash_attention) against
repro.models.moe and repro.models.attention, on the same numpy-made
inputs and the JAX package's own initial weights.

MoE is held routes first: the experts, the renormalised gates and the
capacity positions of every (token, slot) must equal the reference's,
since a different route is a different function, not a rounding. The
reference runs eagerly here (``jax.disable_jit``): like the port it rounds
each operation on its own, where a jitted program may fuse the router's
product and round a logit one bf16 ulp apart, which can flip a route at
a one-ulp margin. A flip is a failure of these tests. Then the dispatch
must be bit-exact, the output within one bf16 ulp (the combine sums the
same k terms in another f32 order), the aux loss within rtol 1e-5 (a mean
over the tokens in another order)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import attention as jattn
from repro.models import moe as jmoe
from repro.models.layers import matmul as jmatmul
from repro_torch.configs import get_config
from repro_torch.convert import tensor_from_numpy
from repro_torch.models import attention as tattn
from repro_torch.models import moe as tmoe

ARCH = "qwen3-moe-30b-a3b"
B, L = 2, 24                    # T = 48 tokens: 3 groups of 16


def _cfgs(arch=ARCH, **kw):
    return (dataclasses.replace(jax_config(arch, smoke=True), **kw),
            dataclasses.replace(get_config(arch, smoke=True), **kw))


def _moe_params(jcfg, seed=0, tie=None):
    jp = jmoe.moe_init(jax.random.PRNGKey(seed), jcfg, jnp.bfloat16)
    if tie is not None:         # router column b := column a: exact ties between a and b
        a, b = tie
        jp["router"] = jp["router"].at[:, b].set(jp["router"][:, a])
    tp = {k: tensor_from_numpy(np.asarray(v), "cpu") for k, v in jp.items()}
    return jp, tp


def _x(seed=1, scale=1.0):
    x = np.random.default_rng(seed).standard_normal((B, L, 64)).astype(np.float32) * scale
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    return jx, tensor_from_numpy(np.asarray(jx), "cpu")


def _ref_routing(p, xt, cfg):
    """repro.models.moe._moe_dispatch's lines up to the expert batch, on one
    group xt (T, D): experts, gates (renormalised, before the drop), capacity
    positions, kept mask and xe."""
    T, E, K = xt.shape[0], cfg.n_experts, cfg.experts_per_token
    logits = jmatmul(xt, p["router"]).astype(jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    gate_vals, idx = jax.lax.top_k(probs, K)
    gate_vals = gate_vals / jnp.sum(gate_vals, -1, keepdims=True)
    C = max(int(T * K / E * cfg.capacity_factor), 1)
    onehot = jax.nn.one_hot(idx, E, dtype=jnp.float32)
    pos = jnp.cumsum(onehot.reshape(T * K, E), axis=0).reshape(T, K, E) - 1.0
    pos = jnp.sum(pos * onehot, axis=-1)
    keep = pos < C
    pos_oh = jax.nn.one_hot(pos.astype(jnp.int32), C, dtype=jnp.float32) * keep[..., None]
    dispatch = jnp.einsum("tke,tkc->tec", onehot, pos_oh)
    xe = jnp.einsum("tec,td->ecd", dispatch.astype(xt.dtype), xt,
                    preferred_element_type=jnp.float32).astype(xt.dtype)
    return idx, gate_vals, pos.astype(jnp.int32), keep, xe


def _bf16_ulp(x):
    """One bf16 ulp of each f32 value (2^-7 relative to its binade)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), np.finfo(np.float32).tiny)))
    return np.exp2(e - 7)


CASES = [(0, 4.0), (16, 4.0), (0, 1.0), (16, 1.0)]


@pytest.mark.parametrize("group,cf", CASES, ids=[f"group{g}-cf{c}" for g, c in CASES])
def test_moe_routes_dispatch_output_aux_match_reference(group, cf):
    jcfg, tcfg = _cfgs(moe_group_size=group, capacity_factor=cf)
    jp, tp = _moe_params(jcfg)
    jx, tx = _x()
    T = B * L
    g_sz = group or T
    with jax.disable_jit():
        jout, jaux = jmoe.moe_apply(jp, jx, jcfg)
        ref = [_ref_routing(jp, xg, jcfg) for xg in jx.reshape(T // g_sz, g_sz, 64)]
    xt = tx.reshape(T // g_sz, g_sz, 64)
    _, idx, gates, pos, keep, C, _ = tmoe.route(tp, xt, tcfg)
    xe, _ = tmoe.dispatch(xt, idx, pos, keep, C, tcfg.n_experts)
    for gi, (ridx, rgate, rpos, rkeep, rxe) in enumerate(ref):
        np.testing.assert_array_equal(idx[gi].numpy(), np.asarray(ridx), err_msg="routes")
        np.testing.assert_array_equal(pos[gi].numpy(), np.asarray(rpos), err_msg="positions")
        np.testing.assert_array_equal(keep[gi].numpy(), np.asarray(rkeep), err_msg="kept")
        # the gates: f32 softmax and renormalisation, ~1 f32 ulp apart
        np.testing.assert_allclose(gates[gi].numpy(), np.asarray(rgate), rtol=1e-6, atol=0)
        np.testing.assert_array_equal(xe[gi].view(torch.int16).numpy(),
                                      np.asarray(rxe).view(np.int16), err_msg="dispatch")
    dropped = 1.0 - float(keep.float().mean())
    assert (dropped > 0.05) == (cf == 1.0), dropped      # cf 1.0 really drops tokens

    out, aux = tmoe.moe_apply(tp, tx, tcfg)
    o, r = out.float().numpy(), np.asarray(jout, np.float32)
    assert np.all(np.abs(o - r) <= _bf16_ulp(r)), float(np.abs(o - r).max())
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)


def test_moe_ties_take_the_lower_expert_first():
    """Router columns 3 and 5 equal: every token's logits tie between the
    two. jax.lax.top_k takes the lower index first; so must the port (when
    both are among the k and when only one of them fits)."""
    jcfg, tcfg = _cfgs(capacity_factor=1.0)
    jp, tp = _moe_params(jcfg, seed=2, tie=(3, 5))
    jx, tx = _x(seed=3)
    with jax.disable_jit():
        ridx = _ref_routing(jp, jx.reshape(B * L, 64), jcfg)[0]
    _, idx, _, _, _, _, _ = tmoe.route(tp, tx.reshape(1, B * L, 64), tcfg)
    ridx = np.asarray(ridx)
    np.testing.assert_array_equal(idx[0].numpy(), ridx)
    has3 = (ridx == 3).any(-1)
    assert has3.any() and not ((ridx == 5).any(-1) & ~has3).any()


def test_moe_gradient_matches_reference():
    """d(Σ out·w + aux)/d(x, router, experts) at f32: the index dispatch's
    transpose (a gather's scatter of k rows a token) is the one-hot
    product's."""
    jcfg, tcfg = _cfgs(capacity_factor=1.0, dtype="float32")
    jp = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32),
                                jmoe.moe_init(jax.random.PRNGKey(0), jcfg, jnp.float32))
    x = np.random.default_rng(4).standard_normal((B, L, 64)).astype(np.float32)
    w = np.random.default_rng(5).standard_normal((B, L, 64)).astype(np.float32)

    def jloss(p, x):
        out, aux = jmoe.moe_apply(p, x, jcfg)
        return jnp.sum(out * w) + aux

    with jax.disable_jit():
        jg = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    tp = {k: torch.from_numpy(np.array(v)).requires_grad_(True) for k, v in jp.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    out, aux = tmoe.moe_apply(tp, tx, tcfg)
    (out * torch.from_numpy(w)).sum().add(aux).backward()
    for k in tp:
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(jg[0][k]), rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jg[1]), rtol=1e-4, atol=1e-5)


# ------------------------------------------------------------ attention --
def _attn(jcfg, seed=0, dtype=jnp.float32):
    jp = jattn.attn_init(jax.random.PRNGKey(seed), jcfg, dtype)
    return jp, {k: tensor_from_numpy(np.asarray(v), "cpu") for k, v in jp.items()}


def _ax(Lx, dtype, seed=1):
    x = np.random.default_rng(seed).standard_normal((2, Lx, 64)).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    return jx, tensor_from_numpy(np.asarray(jx), "cpu")


ATTN_TOL = {"float32": dict(rtol=1e-4, atol=1e-5), "bfloat16": dict(rtol=3e-2, atol=3e-2)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Lx,W", [(32, 8), (48, 16)])
def test_banded_attention_matches_reference_and_masked(dtype, Lx, W):
    """gemma3 smoke's local layer (GQA 4/2, qk-norm, dh 16): the port's
    banded attention against the reference's, and against the port's own
    masked path with the same band (tests/test_mixers.py's comparison)."""
    jcfg, tcfg = _cfgs("gemma3-27b", window_size=W, dtype=dtype)
    jdt = jnp.dtype(dtype)
    jp, tp = _attn(jcfg, dtype=jdt)
    jx, tx = _ax(Lx, jdt)
    with jax.disable_jit():
        jb = jattn.banded_attention(jp, jx, jcfg, window=W)
    tb = tattn.banded_attention(tp, tx, tcfg, window=W)
    np.testing.assert_allclose(tb.float().numpy(), np.asarray(jb, np.float32), **ATTN_TOL[dtype])
    tf = tattn.full_attention(tp, tx, tcfg, causal=True, window=W)
    np.testing.assert_allclose(tb.float().numpy(), tf.float().numpy(),
                               **(ATTN_TOL[dtype] if dtype == "float32"
                                  else dict(rtol=0.05, atol=0.02)))


def test_banded_attention_needs_whole_windows():
    _, tcfg = _cfgs("gemma3-27b", window_size=8)
    _, tp = _attn(_cfgs("gemma3-27b", window_size=8)[0])
    _, tx = _ax(20, jnp.float32)
    with pytest.raises(ValueError, match="L % window"):
        tattn.banded_attention(tp, tx, tcfg, window=8)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window,chunk", [(0, 8), (10, 8), (0, 1024)],
                         ids=["causal-chunk8", "window10-chunk8", "causal-one-chunk"])
def test_blocked_flash_attention_matches_reference_and_masked(dtype, window, chunk):
    """The JAX package's jnp blocked online softmax (attention_impl "flash")
    against the port's, with chunks smaller than L (fully masked key chunks
    included, for the window) and with one chunk; then against the port's
    masked path."""
    jcfg, tcfg = _cfgs("granite-3-2b", dtype=dtype)
    jdt = jnp.dtype(dtype)
    jp, tp = _attn(jcfg, dtype=jdt)
    jx, tx = _ax(32, jdt, seed=2)
    kw = dict(causal=True, window=window, q_chunk=chunk, kv_chunk=chunk)
    with jax.disable_jit():
        jf = jattn.flash_attention(jp, jx, jcfg, **kw)
    tf = tattn.flash_attention(tp, tx, tcfg, **kw)
    np.testing.assert_allclose(tf.float().numpy(), np.asarray(jf, np.float32), **ATTN_TOL[dtype])
    tm = tattn.full_attention(tp, tx, tcfg, causal=True, window=window)
    np.testing.assert_allclose(tf.float().numpy(), tm.float().numpy(), **ATTN_TOL[dtype])

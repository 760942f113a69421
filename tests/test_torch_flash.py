"""The port's flash-attention forward (repro_torch.kernels.flash_attention)
against the JAX package's Pallas kernel (interpret mode, as
tests/test_flash_vjp.py runs it) and its full-softmax oracle.

On the CPU the wrapper runs the plain version, so this file holds
``flash_fwd_plain`` to the reference; the CUDA kernel is held against the
plain version by tests/test_torch_cuda.py and ``chip_smoke.py`` on a card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.flash_attention import _mha_fwd
from repro.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.flash_attention import flash_attention as tflash

_mha_fwd_jit = jax.jit(_mha_fwd, static_argnums=(3, 4, 5, 6, 7))
_ref_jit = jax.jit(attention_ref, static_argnames=("causal", "window"))


def _inputs(seed, B, H, Hkv, L, dh):
    rng = np.random.default_rng(seed)
    mk = lambda h: (rng.standard_normal((B, h, L, dh)) * 0.5).astype(np.float32)
    return mk(H), mk(Hkv), mk(Hkv)


def _jax_fwd(q, k, v, causal, window, blk):
    """JAX kernel forward (interpret): (O, LSE) with LSE cut back to L."""
    o, (*_, lse) = _mha_fwd_jit(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal,
                                window, blk, blk, True)
    return np.asarray(o, np.float32), np.asarray(lse)[:, :, :q.shape[2]]


SWEEP = [(causal, window, group, L)
         for causal in (True, False) for window in (0, 16) for group in (1, 2)
         for L in (5, 33, 64)]


@pytest.mark.parametrize("causal,window,group,L", SWEEP)
def test_plain_matches_jax_kernel_fp32(causal, window, group, L):
    H, dh = 4, 16
    q, k, v = _inputs(L * 10 + window + group, 1, H, H // group, L, dh)
    o, lse = tflash.flash_fwd_plain(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v), causal=causal, window=window)
    jo, jlse = _jax_fwd(q, k, v, causal, window, 16)
    # fp32 tolerance of tests/test_flash_vjp.py
    np.testing.assert_allclose(o.numpy(), jo, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(lse.numpy(), jlse, rtol=2e-4, atol=2e-5)
    ref = _ref_jit(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal, window=window)
    np.testing.assert_allclose(o.numpy(), np.asarray(ref), rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("window", [0, 16])
def test_plain_bf16_matches_jax_kernel(window):
    q, k, v = _inputs(3, 2, 4, 2, 33, 16)
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    o, lse = tflash.flash_fwd_plain(tq, tk, tv, causal=True, window=window)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    jq, jk, jv = (jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v))
    jo, (*_, jlse) = _mha_fwd_jit(jq, jk, jv, True, window, 16, 16, True)
    # bf16 tolerance of tests/test_flash_vjp.py (O), f32 statistics (LSE)
    np.testing.assert_allclose(o.float().numpy(), np.asarray(jo, np.float32), rtol=0.05,
                               atol=0.05)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[:, :, :33], rtol=1e-3, atol=1e-3)


def test_band_of_one_keeps_the_diagonal():
    """window=1 leaves each row exactly its own key: O = V and
    LSE = q·k / sqrt(dh), exactly what the full softmax gives."""
    q, k, v = (torch.from_numpy(x) for x in _inputs(0, 1, 2, 2, 8, 16))
    o, lse = tflash.flash_fwd_plain(q, k, v, causal=True, window=1)
    torch.testing.assert_close(o, v, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(lse, (q * k).sum(-1) * 16**-0.5, rtol=1e-5, atol=1e-5)


def test_cpu_wrapper_takes_plain_path_without_launching():
    q, k, v = (torch.from_numpy(x) for x in _inputs(1, 1, 4, 2, 33, 16))
    before = tflash.flash_fwd.launches
    o, lse = tflash.flash_fwd(q, k, v, causal=True, window=16)
    po, plse = tflash.flash_fwd_plain(q, k, v, causal=True, window=16)
    assert tflash.flash_fwd.launches == before
    torch.testing.assert_close(o, po, rtol=0, atol=0)
    torch.testing.assert_close(lse, plse, rtol=0, atol=0)
    torch.testing.assert_close(tflash.flash_attention(q, k, v, causal=True, window=16), po,
                               rtol=0, atol=0)


def test_wrapper_rejects_bad_shapes():
    q, k, v = (torch.from_numpy(x) for x in _inputs(1, 1, 4, 2, 8, 16))
    with pytest.raises(ValueError):
        tflash.flash_fwd(q, k[:, :, :4], v, causal=True)
    with pytest.raises(ValueError):
        tflash.flash_fwd(q, q[:, :3], q[:, :3], causal=True)      # 4 heads vs 3 kv heads


# ------------------------------------------------------------- backward --
# Shapes of tests/test_flash_vjp.py's sweep (GQA, window, odd L, non-causal)
# plus L below one 64-row tile; the JAX kernels run in interpret mode with
# 32-blocks. Tolerances are that file's: fp32 rtol 2e-4 / atol 2e-5, bf16 0.05.
BWD_SWEEP = [
    # L, H, Hkv, dh, causal, window
    (96, 4, 2, 16, True, 0),          # GQA + odd L
    (200, 4, 1, 32, True, 0),         # group 4, odd L
    (200, 4, 2, 32, True, 48),        # window + GQA + odd L
    (100, 2, 2, 16, False, 0),        # non-causal + odd L
    (192, 2, 1, 32, False, 48),       # non-causal + window
    (40, 4, 2, 16, True, 0),          # L < 64
]


def _jax_grads(q, k, v, do, causal, window, dtype=jnp.float32):
    from repro.kernels.flash_attention.flash_attention import flash_mha as jflash_mha

    def f(q, k, v):
        o = jflash_mha(q, k, v, causal=causal, window=window, blk_q=32, blk_k=32,
                       interpret=True)
        return jnp.sum(o.astype(jnp.float32) * do)

    args = [jnp.asarray(x).astype(dtype) for x in (q, k, v)]
    return [np.asarray(g, np.float32) for g in jax.grad(f, argnums=(0, 1, 2))(*args)]


def _torch_grads(q, k, v, do, causal, window, dtype=torch.float32):
    tq, tk, tv = (torch.from_numpy(x).to(dtype).requires_grad_(True) for x in (q, k, v))
    o = tflash.flash_mha(tq, tk, tv, causal=causal, window=window)
    (o.float() * torch.from_numpy(do)).sum().backward()
    return [t.grad.float().numpy() for t in (tq, tk, tv)]


@pytest.mark.parametrize("L,H,Hkv,dh,causal,window", BWD_SWEEP)
def test_flash_mha_grads_match_jax_fp32(L, H, Hkv, dh, causal, window):
    q, k, v = _inputs(L + H + window, 1, H, Hkv, L, dh)
    do = np.random.default_rng(L).standard_normal(q.shape).astype(np.float32)
    for jg, tg, name in zip(_jax_grads(q, k, v, do, causal, window),
                            _torch_grads(q, k, v, do, causal, window), "qkv"):
        np.testing.assert_allclose(tg, jg, rtol=2e-4, atol=2e-5, err_msg=f"d{name}")


def test_flash_mha_grads_match_jax_bf16():
    q, k, v = _inputs(5, 2, 4, 2, 96, 16)
    do = np.random.default_rng(5).standard_normal(q.shape).astype(np.float32)
    for jg, tg in zip(_jax_grads(q, k, v, do, True, 48, jnp.bfloat16),
                      _torch_grads(q, k, v, do, True, 48, torch.bfloat16)):
        np.testing.assert_allclose(tg, jg, rtol=0.05, atol=0.05)


def test_bwd_plain_parts_and_wrapper_on_cpu():
    """flash_bwd on CPU tensors runs the plain pair without launching; rows
    that no key reaches (LSE +1e30) contribute exactly 0."""
    q, k, v = (torch.from_numpy(x) for x in _inputs(2, 1, 4, 2, 33, 16))
    do = torch.from_numpy(np.random.default_rng(2).standard_normal(q.shape).astype(np.float32))
    o, lse = tflash.flash_fwd_plain(q, k, v, causal=True, window=16)
    before = (tflash.flash_bwd_dq.launches, tflash.flash_bwd_dkv.launches)
    got = tflash.flash_bwd(q, k, v, lse, do, causal=True, window=16)
    want = tflash.flash_bwd_plain(q, k, v, lse, do, causal=True, window=16)
    assert (tflash.flash_bwd_dq.launches, tflash.flash_bwd_dkv.launches) == before
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    lse_dead = torch.full_like(lse, 1e30)
    dq, delta = tflash.flash_bwd_dq_plain(q, k, v, lse_dead, do, window=16)
    assert not dq.any() and not delta.any()
    dk, dv = tflash.flash_bwd_dkv_plain(q, k, v, lse_dead, do, (do * o).sum(-1), window=16)
    assert not dk.any() and not dv.any()


def test_delta_is_rowsum_of_do_o_in_fp32():
    """The dQ pass's D = Σ_k p·dp equals the JAX package's rowsum(dO ∘ O)
    in exact arithmetic: in f32 they agree to f32 rounding (rtol 1e-5)."""
    q, k, v = (torch.from_numpy(x) for x in _inputs(4, 2, 4, 2, 96, 16))
    do = torch.from_numpy(np.random.default_rng(4).standard_normal(q.shape).astype(np.float32))
    o, lse = tflash.flash_fwd_plain(q, k, v, causal=True, window=48)
    _, delta = tflash.flash_bwd_dq_plain(q, k, v, lse, do, causal=True, window=48)
    torch.testing.assert_close(delta, (do * o).sum(-1), rtol=1e-5, atol=1e-5)


def test_bf16_dq_keeps_rows_of_ds_summing_to_zero():
    """Keys sharing a large common part and nearly equal values make the
    true ds small: D from the bf16-rounded O (the JAX definition) then gives
    a dQ far from the f32 one, while D = Σ_k p·dp keeps it within bf16
    rounding (measured 0.0016 vs 2.3 relative; limits 0.01 and 0.5)."""
    rng = np.random.default_rng(0)
    B, H, L, dh = 1, 2, 128, 32
    q = rng.standard_normal((B, H, L, dh)) * 0.5
    k = rng.standard_normal(dh) * 3 + rng.standard_normal((B, H, L, dh)) * 0.5
    v = 1.0 + rng.standard_normal((B, H, L, dh)) * 0.02
    do = rng.standard_normal((B, H, L, dh))
    tq, tk, tv, tdo = (torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
                       for x in (q, k, v, do))
    _, lse32 = tflash.flash_fwd_plain(tq.float(), tk.float(), tv.float())
    dq32, _ = tflash.flash_bwd_dq_plain(tq.float(), tk.float(), tv.float(), lse32, tdo.float())
    o, lse = tflash.flash_fwd_plain(tq, tk, tv)
    dq, _ = tflash.flash_bwd_dq_plain(tq, tk, tv, lse, tdo)
    _, ds, kk, _ = tflash._bwd_plain_parts(tq, tk, tv, lse, tdo, (tdo.float() * o.float()).sum(-1),
                                           True, 0)
    dq_rowsum = torch.einsum("bhls,bhsd->bhld", ds, kk) * dh**-0.5
    rel = lambda a: ((a.float() - dq32).norm() / dq32.norm()).item()
    assert rel(dq) < 0.01 and rel(dq_rowsum) > 0.5


def test_no_grad_forward_launches_nothing_extra_and_keeps_grad_fn():
    """Under no_grad flash_mha is the forward alone; with grad it carries a
    grad_fn (the ctypes forward alone would not)."""
    q, k, v = (torch.from_numpy(x) for x in _inputs(3, 1, 4, 4, 20, 16))
    with torch.no_grad():
        o = tflash.flash_mha(q, k, v)
    assert o.grad_fn is None
    o = tflash.flash_mha(q.requires_grad_(True), k, v)
    assert o.grad_fn is not None

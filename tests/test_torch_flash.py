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

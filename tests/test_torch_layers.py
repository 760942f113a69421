"""The port's shared layers (repro_torch.models.layers) against
repro.models.layers on the same seeded inputs, in f32 and bf16."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jl
from repro_torch.convert import tensor_from_numpy
from repro_torch.models import layers as tl

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# f32: both sides compute the same f32 ops (1e-5 covers sum order and
# transcendental ulps); bf16: outputs are rounded to bf16 (2^-8 relative),
# and one rounding flip of an input to a later op moves the result by ~1 ulp
TOL = {"float32": dict(rtol=1e-5, atol=1e-5), "bfloat16": dict(rtol=2e-2, atol=2e-2)}


def _pair(x, dtype):
    """The same seeded numpy array as a JAX array and a torch tensor."""
    jd, _ = DTYPES[dtype]
    j = jnp.asarray(x).astype(jd)
    return j, tensor_from_numpy(np.asarray(j), "cpu")


def _close(t, j, dtype):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32), **TOL[dtype])


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_matmul(dtype):
    rng = np.random.default_rng(0)
    jx, tx = _pair(rng.standard_normal((3, 5, 64)), dtype)
    jw, tw = _pair(rng.standard_normal((64, 48)) * 0.125, dtype)
    out = tl.matmul(tx, tw)
    assert out.dtype == DTYPES[dtype][1]
    _close(out, jl.matmul(jx, jw), dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_rms_norm(dtype):
    rng = np.random.default_rng(1)
    jx, tx = _pair(rng.standard_normal((2, 7, 64)) * 3, dtype)
    js, ts = _pair(rng.standard_normal(64) * 0.1, dtype)
    _close(tl.rms_norm(tx, ts, 1e-5), jl.rms_norm(jx, js, 1e-5), dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_rope(dtype):
    rng = np.random.default_rng(2)
    jx, tx = _pair(rng.standard_normal((2, 9, 4, 16)), dtype)
    pos = rng.integers(0, 4096, size=(2, 9))
    jc, js = jl.rope_freqs(jnp.asarray(pos, jnp.int32), 16, 1e4)
    tc, ts = tl.rope_freqs(torch.from_numpy(pos), 16, 1e4)
    # large angles: cos/sin of ~4096 rad agree to a few f32 ulps of the angle
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=2e-3)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=2e-3)
    # the rotation itself, on the same cos/sin
    out = tl.rope_apply(tx, torch.from_numpy(np.array(jc)), torch.from_numpy(np.array(js)))
    _close(out, jl.rope_apply(jx, jc, js), dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("act", ["gelu", "swiglu"])
def test_mlp_apply(act, dtype):
    rng = np.random.default_rng(3)
    jp = jl.mlp_init(jax.random.PRNGKey(0), 32, 64, act, DTYPES[dtype][0])
    tp = {k: tensor_from_numpy(np.asarray(v), "cpu") for k, v in jp.items()}
    jx, tx = _pair(rng.standard_normal((2, 5, 32)), dtype)
    _close(tl.mlp_apply(tp, tx, act), jl.mlp_apply(jp, jx, act), dtype)


def test_embed_lookup():
    rng = np.random.default_rng(4)
    table = rng.standard_normal((50, 8)).astype(np.float32)
    ids = rng.integers(0, 50, size=(3, 6))
    np.testing.assert_array_equal(
        tl.embed_lookup(torch.from_numpy(table), torch.from_numpy(ids)).numpy(),
        np.asarray(jl.embed_lookup(jnp.asarray(table), jnp.asarray(ids))))

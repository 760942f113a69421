"""The port's EDQ metrics (repro_torch.kernels.edq, repro_torch.core.edq)
against the JAX package's (repro.kernels.edq, repro.core.edq).

Tolerance: rtol 1e-5 on the finalized metrics (1e-6 on imprecision %), the
tolerance of tests/test_kernels.py for the Pallas kernel against its
oracle: the two sum the same f32 products in another order. The lost count
and Δθ̂ itself are exact. On the CPU the wrapper runs the plain version;
the CUDA kernel is held against the plain version on the card by
``chip_smoke.py`` and tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import edq as jedq
from repro.core.mcf import Expansion as JExpansion
from repro.kernels.edq.edq import edq_metrics as jedq_metrics
from repro_torch.convert import tensor_from_numpy
from repro_torch.core import bucketing
from repro_torch.core import edq as tedq
from repro_torch.core.mcf import Expansion
from repro_torch.kernels.edq import edq as kedq
from repro_torch.kernels.edq import ref as kref


def _pair(n, seed):
    """Δθ, Δθ̂ (f32) with lost elements (Δθ̂ == 0 where Δθ != 0), exact
    zeros in both, and mixed signs."""
    rng = np.random.default_rng(seed)
    u = (rng.standard_normal(n) * 1e-3).astype(np.float32)
    e = (u * (1 + 0.01 * rng.standard_normal(n))).astype(np.float32)
    pick = rng.random(n)
    e[pick < 0.1] = 0.0
    u[(pick > 0.95) & (pick < 0.97)] = 0.0
    e[pick > 0.99] *= -1
    return u, e


@pytest.mark.parametrize("n", [256, 4096, 128 * 77])
def test_plain_edq_metrics_match_jax(n):
    u, e = _pair(n, n)
    want = jedq_metrics(jnp.asarray(u), jnp.asarray(e), interpret=True)
    got = kedq.edq_metrics(torch.from_numpy(u), torch.from_numpy(e))
    for k in ("edq", "update_norm", "effective_norm"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(float(got["imprecision_pct"]), float(want["imprecision_pct"]),
                               rtol=1e-6)
    assert 5 < float(got["imprecision_pct"]) < 15          # the injected lost elements


@pytest.mark.parametrize("n", [1, 7, 1000, 16384 + 5])
def test_plain_partials_on_ragged_lengths(n):
    """Lengths that are no multiple of 128 (the JAX kernel refuses them; the
    port's kernel takes them): the partials against f64 sums."""
    u, e = _pair(n, 3 * n)
    p = kedq.edq_partials(torch.from_numpy(u), torch.from_numpy(e)).numpy()
    u64, e64 = u.astype(np.float64), e.astype(np.float64)
    want = [np.sum(u64 * e64), np.sum(u64 * u64), np.sum(e64 * e64)]
    np.testing.assert_allclose(p[:3], want, rtol=1e-5, atol=1e-30)
    assert p[3] == np.sum((np.abs(u) > 0) & (e == 0))


def test_lost_count_is_exact_past_2_24():
    """The count is taken exactly and rounded once to f32 (an f32 running
    sum of ones stops at 2^24)."""
    n = 2**24 + 6
    p = kedq.edq_partials(torch.ones(n), torch.zeros(n))
    assert float(p[3]) == float(np.float32(n))


def test_cpu_wrapper_runs_plain_and_does_not_launch():
    u, e = (torch.from_numpy(x) for x in _pair(4096, 1))
    before = kedq.edq_partials.launches
    assert torch.equal(kedq.edq_partials(u, e), kref.edq_partials_plain(u, e))
    assert torch.equal(kedq.edq_partials(u, e, 1e-3), kref.edq_partials_plain(u, e, 1e-3))
    assert kedq.edq_partials.launches == before


def test_wrapper_refuses_what_the_kernel_does_not_take():
    u = torch.ones(256)
    before = kedq.edq_partials.launches
    with pytest.raises(TypeError):
        kedq.edq_partials(u.to(torch.bfloat16), u.to(torch.bfloat16))
    with pytest.raises(TypeError):
        kedq.edq_partials(u.double(), u.double())
    with pytest.raises(ValueError):
        kedq.edq_partials(u, u[:128])                      # lengths differ
    with pytest.raises(ValueError):
        kedq.edq_partials(u.reshape(16, 16), u.reshape(16, 16))   # not 1-D
    with pytest.raises(ValueError):
        kedq.edq_partials(u[::2], u[::2])                  # not contiguous
    with pytest.raises(ValueError):
        kedq.edq_partials(u[:0], u[:0])                    # empty
    with pytest.raises(ValueError):
        kedq.edq_partials(u, u.to("meta"))                 # devices differ
    assert kedq.edq_partials.launches == before


def _trees(seed):
    """Old and new parameter trees (bf16, one Expansion leaf), and an update
    tree, as numpy, in the JAX package's nesting."""
    rng = np.random.default_rng(seed)
    bf = lambda x: np.asarray(jnp.asarray(x, jnp.float32).astype(jnp.bfloat16))
    shapes = {"a": (64, 128), "b": [(300,), (7, 5)]}
    old = {"a": bf(rng.standard_normal(shapes["a"]) * 0.05),
           "b": [bf(rng.standard_normal(s)) for s in shapes["b"]]}
    upd = {"a": (rng.standard_normal(shapes["a"]) * 1e-3).astype(np.float32),
           "b": [(rng.standard_normal(s) * 1e-3).astype(np.float32) for s in shapes["b"]]}
    new = jax.tree_util.tree_map(
        lambda o, u: bf(np.asarray(o, np.float32) + u), old, upd)
    lo_old = bf(rng.standard_normal(shapes["a"]) * 1e-5)
    lo_new = bf(np.asarray(lo_old, np.float32) + rng.standard_normal(shapes["a"]) * 1e-6)
    return old, new, upd, (lo_old, lo_new)


def _to_port(tree):
    if isinstance(tree, dict):
        return {k: _to_port(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_port(v) for v in tree]
    return tensor_from_numpy(tree, "cpu")


@pytest.mark.parametrize("expansion", [False, True])
def test_core_edq_matches_jax(expansion):
    old, new, upd, (lo_old, lo_new) = _trees(4)
    j_old = jax.tree_util.tree_map(jnp.asarray, old)
    j_new = jax.tree_util.tree_map(jnp.asarray, new)
    t_old, t_new = _to_port(old), _to_port(new)
    if expansion:
        j_old["a"] = JExpansion(jnp.asarray(old["a"]), jnp.asarray(lo_old))
        j_new["a"] = JExpansion(jnp.asarray(new["a"]), jnp.asarray(lo_new))
        t_old["a"] = Expansion(t_old["a"], tensor_from_numpy(lo_old, "cpu"))
        t_new["a"] = Expansion(t_new["a"], tensor_from_numpy(lo_new, "cpu"))
    j_eff = jedq.effective_update(j_old, j_new)
    t_eff = tedq.effective_update(t_old, t_new)
    for a, b in zip(jax.tree_util.tree_leaves(j_eff), bucketing.tree_leaves(t_eff)):
        np.testing.assert_array_equal(np.asarray(a).view(np.uint32), b.numpy().view(np.uint32))
    j_upd = jax.tree_util.tree_map(jnp.asarray, upd)
    t_upd = _to_port(upd)
    np.testing.assert_allclose(float(tedq.edq(t_upd, t_eff)), float(jedq.edq(j_upd, j_eff)),
                               rtol=1e-5)
    for atol in (0.0, 5e-4):
        np.testing.assert_allclose(float(tedq.imprecision_pct(t_upd, t_eff, atol)),
                                   float(jedq.imprecision_pct(j_upd, j_eff, atol)), rtol=1e-6)
    assert float(tedq.imprecision_pct(t_upd, t_eff)) > 0     # bf16 ⊕ loses some


def test_lost_arithmetic_mask_matches_jax():
    old, _, upd, _ = _trees(5)
    a, b = old["a"], upd["a"] * np.float32(0.1)
    want = np.asarray(jedq.lost_arithmetic_mask(jnp.asarray(a), jnp.asarray(b)))
    got = tedq.lost_arithmetic_mask(tensor_from_numpy(a, "cpu"), torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < want.mean() < 1

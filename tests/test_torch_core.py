"""The port's numerical core (repro_torch.core: mcf, bucketing) against the
JAX package's (repro.core). Tolerance: none — every function here must be
bit-identical to its JAX counterpart on the same numpy inputs, uint32 edge
values included. Also: the bucket layout of the port's model equals the
JAX one (``to_json``), and bucket/unbucket round trips.

Subnormals: XLA's CPU backend flushes subnormal results to zero and reads
subnormal inputs as zero; the port keeps them (eager PyTorch, and the CUDA
kernel, which must not flush). So the mcf ops are held to JAX on inputs
whose results stay normal, and on subnormals to an exact f64 oracle."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core import bucketing as jb
from repro.core import mcf as jmcf
from repro.models.model import build_model as jax_build
from repro_torch.configs import get_config
from repro_torch.convert import bucketed_from_numpy, bucketed_to_numpy, tensor_from_numpy
from repro_torch.core import bucketing as tb
from repro_torch.core import mcf as tmcf
from repro_torch.core.collage import CollageAdamW
from repro_torch.core.precision import BucketPolicy, PrecisionPolicy, Strategy
from repro_torch.models.model import build_model, param_dict

U32_EDGES = np.array([0, 1, 2, 0x7FFF, 0x8000, 0xFFFF, 0x10000, 0x7FFFFFFF, 0x80000000,
                      0x80000001, 0x9E3779B9, 0xFFFFFFFE, 0xFFFFFFFF], np.uint32)


def _bf16_values(n, seed):
    """bf16 values as numpy over normal magnitudes (1e-15..1e4) and signed 0."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n).astype(np.float32) * np.float32(10.0) ** rng.integers(
        -15, 5, n).astype(np.float32)
    x[:6] = [0.0, -0.0, 3.0, -2.5, 1e15, 65504.0]
    return np.asarray(jnp.asarray(x).astype(jnp.bfloat16))


def _t(x):
    return tensor_from_numpy(np.asarray(x), "cpu")


def _same_bits(a_jax, b_torch):
    a = np.asarray(a_jax)
    b = b_torch.detach()
    if b.dtype == torch.bfloat16:
        np.testing.assert_array_equal(a.view(np.uint16), b.view(torch.int16).numpy().view(np.uint16))
    else:
        np.testing.assert_array_equal(a.view(np.uint32), b.numpy().view(np.uint32))


@pytest.mark.parametrize("op", ["fast2sum", "two_sum", "two_prod", "split"])
def test_mcf_pair_ops_bit_identical(op):
    a, b = _bf16_values(4096, 0), _bf16_values(4096, 1)
    if op == "fast2sum":                         # its precondition: |a| ≥ |b|
        a, b = np.where(np.abs(a.astype(np.float32)) >= np.abs(b.astype(np.float32)), a, b), \
            np.where(np.abs(a.astype(np.float32)) >= np.abs(b.astype(np.float32)), b, a)
    args_j = (jnp.asarray(a),) if op == "split" else (jnp.asarray(a), jnp.asarray(b))
    args_t = (_t(a),) if op == "split" else (_t(a), _t(b))
    for x, y in zip(getattr(jmcf, op)(*args_j), getattr(tmcf, op)(*args_t)):
        _same_bits(x, y)


def test_mcf_expansion_ops_bit_identical():
    hi, lo, a = _bf16_values(4096, 2), _bf16_values(4096, 3), _bf16_values(4096, 4)
    b_hi, b_lo = _bf16_values(4096, 5), _bf16_values(4096, 6)
    je, te = jmcf.Expansion(jnp.asarray(hi), jnp.asarray(lo)), tmcf.Expansion(_t(hi), _t(lo))
    jf, tf = jmcf.Expansion(jnp.asarray(b_hi), jnp.asarray(b_lo)), \
        tmcf.Expansion(_t(b_hi), _t(b_lo))
    for jr, tr in [(jmcf.grow(je, jnp.asarray(a)), tmcf.grow(te, _t(a))),
                   (jmcf.mul(je, jf), tmcf.mul(te, tf)),
                   (jmcf.scaling(je, jnp.asarray(a)), tmcf.scaling(te, _t(a))),
                   (jmcf.add_expansion(je, jf), tmcf.add_expansion(te, tf))]:
        _same_bits(jr.hi, tr.hi)
        _same_bits(jr.lo, tr.lo)
    _same_bits(je.value(), te.value())


def test_from_float_zeros_and_ulp():
    for x in (0.999, 0.95, 0.9, 1e-8, 3.0):
        je, te = jmcf.from_float(x, jnp.bfloat16, (3,)), tmcf.from_float(x, torch.bfloat16, (3,))
        _same_bits(je.hi, te.hi)
        _same_bits(je.lo, te.lo)
    v = _bf16_values(2048, 7)
    _same_bits(jmcf.ulp(jnp.asarray(v)), tmcf.ulp(_t(v)))
    z = tmcf.zeros_like_expansion(_t(v))
    assert torch.equal(z.hi, _t(v)) and not z.lo.any()


def test_eft_exact_on_subnormals():
    """two_sum and two_prod stay error-free where results are subnormal:
    x + y equals the exact f64 sum/product (the port does not flush)."""
    tiny = np.float32(2.0**-130)                 # an f32 subnormal, on the bf16 grid
    rng = np.random.default_rng(13)
    a = _t(np.asarray(jnp.asarray(rng.integers(-64, 64, 512).astype(np.float32) * tiny)
                      .astype(jnp.bfloat16)))
    b = _t(np.asarray(jnp.asarray(rng.integers(-64, 64, 512).astype(np.float32) * tiny)
                      .astype(jnp.bfloat16)))
    x, y = tmcf.two_sum(a, b)
    exact = a.double() + b.double()
    assert bool((x.double() + y.double() == exact).all())
    assert bool((x != 0).any())
    big = _t(np.asarray(jnp.asarray(rng.integers(1, 256, 512).astype(np.float32) * 2.0**-120)
                        .astype(jnp.bfloat16)))
    small = _t(np.asarray(jnp.asarray(rng.integers(1, 256, 512).astype(np.float32) * 2.0**-10)
                          .astype(jnp.bfloat16)))
    x, e = tmcf.two_prod(big, small)
    assert bool((x.double() + e.double() == big.double() * small.double()).all())


def test_strict_fpu_rn_matches_reduce_precision():
    rng = np.random.default_rng(8)
    bits = rng.integers(0, 2**32, 1 << 16, dtype=np.uint64).astype(np.uint32)
    bits[:6] = [0x00000001, 0x807FFFFF, 0x7F7FFFFF, 0x7F800000, 0x00008000, 0x3F808000]
    x = bits.view(np.float32)
    finite = np.isfinite(x)
    j = np.asarray(jmcf.fpu(jnp.bfloat16).rn(jnp.asarray(x)))
    t = tmcf.fpu(torch.bfloat16).rn(torch.from_numpy(x.copy())).numpy()
    np.testing.assert_array_equal(j.view(np.uint32)[finite], t.view(np.uint32)[finite])


@pytest.mark.parametrize("n", [1, 2, 3, 5, 7, 128, 1000, 1023, 1024, 3 * 1024 + 1, 158349])
def test_det_sum_bit_identical(n):
    x = np.random.default_rng(n).standard_normal(n).astype(np.float32) * np.float32(1e3)
    _same_bits(jb.det_sum(jnp.asarray(x)), tb.det_sum(torch.from_numpy(x)))


def test_det_sum_columns_and_rows():
    x = np.random.default_rng(9).standard_normal((13, 5)).astype(np.float32)
    cols = tb.det_sum(torch.from_numpy(x), dim=0)
    rows = tb.det_sum(torch.from_numpy(x), dim=1)
    for k in range(5):
        _same_bits(jb.det_sum(jnp.asarray(x[:, k])), cols[k])
    for r in range(13):
        _same_bits(jb.det_sum(jnp.asarray(x[r])), rows[r])


def test_hash_functions_bit_identical():
    rng = np.random.default_rng(10)
    x = np.concatenate([U32_EDGES, rng.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)])
    tx = torch.from_numpy(x.astype(np.int64))
    np.testing.assert_array_equal(np.asarray(jb.lowbias32(jnp.asarray(x))),
                                  tb.lowbias32(tx).numpy().astype(np.uint32))
    for seed in (0, 1, 0xFFFFFFFF, 0x12345678):
        np.testing.assert_array_equal(
            np.asarray(jb.sr_noise_bits(jnp.asarray(x), jnp.uint32(seed))),
            tb.sr_noise_bits(tx, seed).numpy().astype(np.uint32))
        for vals in ((), (1,), (7, 0), (0xFFFFFFFF, 3)):
            assert int(jb.fold_seed(jnp.uint32(seed), *(np.uint32(v) for v in vals))) == \
                int(tb.fold_seed(seed, *vals))


def test_int64_wrap_keeps_the_low_32_bits():
    """torch has no uint32 ``*``: the port splits its 32-bit products so no
    int64 product overflows. A direct int64 product does wrap for
    x·0x846CA68B (up to 2^64) and still keeps the right low 32 bits;
    both agree with numpy's uint32 product."""
    x = np.concatenate([U32_EDGES, np.random.default_rng(11).integers(
        0, 2**32, 1024, dtype=np.uint64).astype(np.uint32)])
    want = (x * np.uint32(0x846CA68B)).astype(np.uint32)
    tx = torch.from_numpy(x.astype(np.int64))
    np.testing.assert_array_equal(tb.mul32(tx, 0x846CA68B).numpy().astype(np.uint32), want)
    wrapped = (tx * 0x846CA68B) & tb.MASK32
    np.testing.assert_array_equal(wrapped.numpy().astype(np.uint32), want)


def test_stochastic_round_bits_bit_identical():
    rng = np.random.default_rng(12)
    x = rng.standard_normal(4096).astype(np.float32)
    x[:4] = [1e-40, -3.4e38, 0.0, -0.0]
    noise = rng.integers(0, 1 << 16, 4096).astype(np.uint32)
    noise[:2] = [0, 0xFFFF]
    j = jb.stochastic_round_bits(jnp.asarray(x), jnp.asarray(noise))
    t = tb.stochastic_round_bits(torch.from_numpy(x), torch.from_numpy(noise.astype(np.int64)))
    _same_bits(j, t)


def _smoke_params():
    jcfg = jax_config("gpt-smoke", smoke=True)
    jparams = jax_build(jcfg).init(jax.random.PRNGKey(0))
    tparams = param_dict(build_model(get_config("gpt-smoke", smoke=True)).init(0, device="cpu"))
    return jparams, tparams


@pytest.mark.parametrize("cap,pad", [(None, 1024), (20000, 128)])
def test_layout_json_equals_jax(cap, pad):
    jparams, tparams = _smoke_params()
    jl = jb.build_layout(jparams, max_bucket_elems=cap, pad_multiple=pad)
    tl = tb.build_layout(tparams, max_bucket_elems=cap, pad_multiple=pad)
    assert tl.to_json() == jl.to_json()
    names = [s.name for s in tl.slots]
    assert names[0] == "['decoder']['final_norm']" and names[-1] == "['lm_head']"
    assert tb.BucketLayout.from_json(tl.to_json(), tl.treedef) == tl


def test_bucket_unbucket_round_trip():
    _, tparams = _smoke_params()
    layout = tb.build_layout(tparams, max_bucket_elems=20000, pad_multiple=128)
    data = tb.bucket_tree(tparams, layout)
    assert all(d.shape == (b.padded,) for d, b in zip(data, layout.buckets))
    back = tb.unbucket(data, layout)
    for (pa, a), (pb, b) in zip(tb.tree_flatten_with_path(tparams)[0],
                                tb.tree_flatten_with_path(back)[0]):
        assert pa == pb and torch.equal(a, b)
    # views: a write through the tree lands in the bucket
    leaf = tb.unbucket_leaves(data, layout)[0]
    leaf.fill_(1.5)
    assert bool((data[layout.slots[0].bucket][:leaf.numel()] == 1.5).all())


def test_bucketed_state_conversion_round_trip():
    """A JAX bucketed state (gpt-smoke, Collage-plus) → the port → numpy:
    every bucket bit-identical, layout equal."""
    from repro.core.collage import CollageAdamW as JAdamW
    from repro.core.precision import BucketPolicy as JBP, PrecisionPolicy as JPP, Strategy as JS
    jparams, _ = _smoke_params()
    jopt = JAdamW(1e-3, policy=JPP(strategy=JS.C_COLLAGE_PLUS, bucketing=JBP(enabled=True)))
    jbp, jbs = jopt.init_bucketed(jparams)
    np_ = lambda t: [np.asarray(x) for x in t] if t is not None else None
    tbp, tbs = bucketed_from_numpy(jbp.layout.to_json(), np_(jbp.data), np_(jbs.m),
                                   np_(jbs.vhi), np_(jbs.vlo), np_(jbs.delta), np_(jbs.master),
                                   step=int(jbs.step), device="cpu")
    back = bucketed_to_numpy(tbp, tbs, bf16_dtype=jnp.bfloat16)
    assert back["layout"] == jbp.layout.to_json()
    for role, jt in (("data", jbp.data), ("m", jbs.m), ("vhi", jbs.vhi), ("vlo", jbs.vlo),
                     ("delta", jbs.delta)):
        for a, b in zip(jt, back[role]):
            np.testing.assert_array_equal(np.asarray(a).view(np.uint16), b.view(np.uint16))
    # the port's own init_bucketed gives the same roles and dtypes
    _, tparams = _smoke_params()
    topt = CollageAdamW(1e-3, policy=PrecisionPolicy(strategy=Strategy.C_COLLAGE_PLUS,
                                                     bucketing=BucketPolicy(enabled=True)))
    pbp, pbs = topt.init_bucketed(tparams)
    assert pbp.layout == tbp.layout
    for role in ("m", "vhi", "vlo", "delta"):
        assert [x.dtype for x in getattr(pbs, role)] == [x.dtype for x in getattr(tbs, role)]
        assert not any(x.any() for x in getattr(pbs, role))
    assert pbs.master is None and tbs.master is None


def test_init_roles_per_strategy():
    _, tparams = _smoke_params()
    for s in Strategy:
        opt = CollageAdamW(1e-3, policy=dataclasses.replace(
            PrecisionPolicy(strategy=s), bucketing=BucketPolicy(enabled=True)))
        _, st = opt.init_bucketed(tparams)
        assert (st.vlo is not None) == (s is Strategy.C_COLLAGE_PLUS)
        assert (st.delta is not None) == (s in (Strategy.B_COLLAGE_LIGHT,
                                                Strategy.C_COLLAGE_PLUS, Strategy.KAHAN))
        assert (st.master is not None) == (s is Strategy.D_MIXED_MW)
        want = torch.float32 if s in (Strategy.D_MINUS_MW, Strategy.D_MIXED_MW) \
            else torch.bfloat16
        assert st.m[0].dtype == want and st.vhi[0].dtype == want

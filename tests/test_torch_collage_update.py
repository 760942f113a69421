"""The port's Collage-AdamW bucket update (repro_torch.kernels.collage_update)
against the JAX package's ``collage_bucket_update_ref``.

Tolerance: none for the bf16 strategies. The new bf16 state and the tiled
metric partials must be bit-identical. The reference is called EAGERLY
(not ``jitted_ref``): XLA's CPU backend may contract a multiply and an add
of the jitted ref into an FMA and drift by one ulp (ref.py:160-162), while
the port (eager PyTorch here, ``__fadd_rn``/``__fmul_rn`` in the CUDA
kernel) rounds every operation on its own, as the eager ref does. The
D⁻/D f32 states take the same separately rounded operations and are held
bit for bit too.

On the CPU the wrapper runs the plain version; the CUDA kernel is held
against the plain version, bit for bit, by ``chip_smoke.py`` and
tests/test_torch_cuda.py on a card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.collage_update import collage_update as jcu
from repro.kernels.collage_update.ref import collage_bucket_update_ref
from repro_torch.convert import tensor_from_numpy
from repro_torch.kernels.collage_update import collage_update as tcu
from repro_torch.kernels.collage_update import ops as tops
from repro_torch.kernels.collage_update import ref as tref

CODES = ["A", "B", "C", "KAHAN", "SR", "D-", "D"]


def _np_dtype(field, code):
    return np.float32 if jcu.field_dtype(field, code) == jnp.float32 else jnp.bfloat16


def _state(code, n, seed):
    """Random state of plausible magnitudes, made with numpy."""
    rng = np.random.default_rng(seed)
    mk = {
        "theta": lambda: rng.standard_normal(n) * 0.05,
        "m": lambda: rng.standard_normal(n) * 1e-3,
        "vhi": lambda: rng.random(n) * 1e-5,
        "vlo": lambda: rng.standard_normal(n) * 1e-9,
        "delta": lambda: rng.standard_normal(n) * 1e-5,
        "master": lambda: rng.standard_normal(n) * 0.05,
    }
    st = {f: np.asarray(jnp.asarray(mk[f](), jnp.float32).astype(_np_dtype(f, code)))
          for f in jcu.state_fields(code)}
    if code == "D":         # master on the theta it rounds to, plus a residual
        st["master"] = (np.asarray(st["theta"], np.float32)
                        + np.float32(1e-5) * rng.standard_normal(n).astype(np.float32))
    g = np.asarray(jnp.asarray(rng.standard_normal(n) * 1e-2, jnp.float32).astype(jnp.bfloat16))
    return st, g


def _bits(x):
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype.itemsize == 2 else x.view(np.uint32)


def _run_both(code, n, *, seed=0, lr=1e-3, bc1=0.19, bc2=0.0199, wd=0.1, pt_decay=False,
              tiled=True, sr_seed=None, elem_offset=None, b2=0.999):
    st, g = _state(code, n, seed)
    kw = dict(b1=0.9, b2=b2, eps=1e-8, wd=wd, strategy=code, pt_decay=pt_decay,
              compute_metrics=True)
    lr32, bc132, bc232 = np.float32(lr), np.float32(bc1), np.float32(bc2)
    jseed = None if sr_seed is None else jnp.uint32(sr_seed)
    jnew, jpart = collage_bucket_update_ref(
        {f: jnp.asarray(v) for f, v in st.items()}, jnp.asarray(g), jnp.float32(lr32),
        jnp.float32(bc132), jnp.float32(bc232), jseed,
        None if elem_offset is None else jnp.uint32(elem_offset), tiled_metrics=tiled, **kw)
    tst = {f: tensor_from_numpy(v, "cpu") for f, v in st.items()}
    tnew, tpart = tref.collage_bucket_update_plain(
        tst, tensor_from_numpy(g, "cpu"), lr32, bc132, bc232, sr_seed, elem_offset,
        tiled_metrics=tiled, **kw)
    return jnew, jpart, tnew, tpart


def _torch_np(t):
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


@pytest.mark.parametrize("code", CODES)
@pytest.mark.parametrize("n", [2048, 3 * 1024])      # br 16, and br 24 (not a power of two)
def test_plain_update_bit_identical_to_eager_ref(code, n):
    sr = 1234 if code == "SR" else None
    jnew, jpart, tnew, tpart = _run_both(code, n, seed=n + len(code), sr_seed=sr)
    for f in jnew:
        np.testing.assert_array_equal(_bits(jnew[f]), _bits(_torch_np(tnew[f])), err_msg=f)
    for k in range(5):
        assert _bits(np.float32(jpart[k])) == _bits(np.float32(tpart[k].item())), (k, jpart[k],
                                                                                   tpart[k])


def test_block_rows_match_the_jax_choice():
    for rows in (1, 8, 24, 100, 256, 300, 512, 1266792):
        assert tcu.choose_block_rows(rows) == jcu.choose_block_rows(rows)
    assert tcu.choose_block_rows(1266792) == 8          # gpt-125m's bucket


def test_kernel_grid_refuses_buckets_past_int32():
    """The kernel takes the bucket length in 64 bits and its tile count as a
    C int: buckets of 2^31 elements or more take one launch (gemma3-27b's
    3.89 B-element bucket; chip_smoke.py's 2^31 + 3072 case), and only a
    tile count past int32 is refused before launch, not wrapped."""
    assert tcu.kernel_grid(162_149_376) == (8, 158_349)
    assert tcu.kernel_grid(2**31 - 128) == (1, 2**24 - 1)
    assert tcu.kernel_grid(2**31) == (256, 2**16)
    assert tcu.kernel_grid(2**31 + 3 * 1024) == (8, 2**21 + 3)
    assert tcu.kernel_grid(2**32 + 1024) == (8, 2**22 + 1)
    n_max = tcu.MAX_TILES * 128                   # odd rows: one-row tiles
    assert tcu.kernel_grid(n_max) == (1, tcu.MAX_TILES)
    for n in (n_max + 128 * 2, (2**31 + 3) * 128):
        with pytest.raises(ValueError, match="at most"):
            tcu.kernel_grid(n)


def test_pt_decay_strategy_a():
    jnew, jpart, tnew, tpart = _run_both("A", 1024, seed=3, lr=0.02, wd=0.5, pt_decay=True)
    np.testing.assert_array_equal(_bits(jnew["theta"]), _bits(_torch_np(tnew["theta"])))
    for k in range(5):
        assert np.float32(jpart[k]) == np.float32(tpart[k].item())


@pytest.mark.parametrize("elem_offset", [0, 5 * 1024, 2**32 - 512])   # the last wraps
def test_sr_elem_offset(elem_offset):
    jnew, jpart, tnew, tpart = _run_both("SR", 1024, seed=4, sr_seed=0xDEADBEEF,
                                         elem_offset=elem_offset)
    np.testing.assert_array_equal(_bits(jnew["theta"]), _bits(_torch_np(tnew["theta"])))
    for k in range(5):
        assert np.float32(jpart[k]) == np.float32(tpart[k].item())


@pytest.mark.parametrize("code", ["C", "D"])
def test_fast_metrics_match(code):
    """tiled_metrics=False: plain sums, equal to the reference's up to f32
    summation order (rtol 1e-5, the tolerance of tests/test_kernels.py)."""
    jnew, jpart, tnew, tpart = _run_both(code, 4096, seed=5, tiled=False)
    for f in jnew:
        np.testing.assert_array_equal(_bits(jnew[f]), _bits(_torch_np(tnew[f])), err_msg=f)
    for k in range(5):
        np.testing.assert_allclose(float(tpart[k]), float(jpart[k]), rtol=1e-5, atol=0)


def test_cpu_wrapper_runs_plain_and_does_not_launch():
    st, g = _state("C", 1024, 7)
    tst = {f: tensor_from_numpy(v, "cpu") for f, v in st.items()}
    tg = tensor_from_numpy(g, "cpu")
    before = tcu.collage_bucket_update.launches
    a, pa = tcu.collage_bucket_update(tst, tg, 1e-3, 0.1, 0.001, compute_metrics=True)
    b, pb = tref.collage_bucket_update_plain(tst, tg, 1e-3, 0.1, 0.001, compute_metrics=True)
    assert tcu.collage_bucket_update.launches == before
    for f in a:
        assert torch.equal(a[f], b[f])
    assert all(torch.equal(x, y) for x, y in zip(pa, pb))
    with pytest.raises(ValueError):
        tcu.collage_bucket_update({"theta": tst["theta"]}, tg, 1e-3, 0.1, 0.001)
    with pytest.raises(ValueError):
        tcu.collage_bucket_update({f: t[:100] for f, t in tst.items()}, tg[:100], 1e-3, .1, .1)


@pytest.mark.parametrize("code", ["C", "SR", "D"])
def test_bucketed_step_three_steps_from_converted_state(code):
    """3 steps of ``bucketed_step`` from a JAX bucketed state carried across
    by ``convert.bucketed_from_numpy``, fed the JAX package's lr/bc1/bc2
    (torch's and XLA's f32 ``pow`` differ at rare steps): the state stays
    bit-identical to the JAX package's EAGER step (use_fused_kernel False on
    both sides); the finalized metrics use plain sums (rtol 1e-5)."""
    import jax
    from repro.configs import get_config as jax_config
    from repro.core.collage import CollageAdamW as JAdamW
    from repro.core.precision import BucketPolicy as JBP, PrecisionPolicy as JPP
    from repro.core.precision import parse_strategy as jparse
    from repro.kernels.collage_update.ops import _scalars as jscalars
    from repro.models.model import build_model as jax_build
    from repro_torch.convert import bucketed_from_numpy, bucketed_to_numpy
    from repro_torch.core.collage import CollageAdamW
    from repro_torch.core.precision import BucketPolicy, PrecisionPolicy, parse_strategy

    name = code
    kw = dict(b2=0.95, weight_decay=0.1, compute_metrics=True, sr_seed=7)
    jopt = JAdamW(1e-3, policy=JPP(strategy=jparse(name), bucketing=JBP(enabled=True)), **kw)
    topt = CollageAdamW(1e-3, policy=PrecisionPolicy(strategy=parse_strategy(name),
                                                     bucketing=BucketPolicy(enabled=True)), **kw)
    jparams = jax_build(jax_config("gpt-smoke", smoke=True)).init(jax.random.PRNGKey(1))
    jbp, jbs = jopt.init_bucketed(jparams)
    np_ = lambda t: None if t is None else [np.asarray(x) for x in t]
    tbp, tbs = bucketed_from_numpy(jbp.layout.to_json(), np_(jbp.data), np_(jbs.m),
                                   np_(jbs.vhi), np_(jbs.vlo), np_(jbs.delta), np_(jbs.master),
                                   step=int(jbs.step), rng=None if jbs.rng is None
                                   else int(jbs.rng), device="cpu")
    rng = np.random.default_rng(8)
    for t in range(1, 4):
        g = [np.asarray(jnp.asarray(rng.standard_normal(d.shape[0]) * 1e-2, jnp.float32)
                        .astype(jnp.bfloat16)) for d in jbp.data]
        jbp, jbs, jm = jopt.step_bucketed(tuple(jnp.asarray(x) for x in g), jbp, jbs)
        sc = tuple(np.float32(x) for x in jscalars(jopt, jnp.int32(t)))
        tbp, tbs, tm = tops.bucketed_step(topt, tuple(tensor_from_numpy(x, "cpu") for x in g),
                                          tbp, tbs, scalars=sc)
        for k in range(5):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, atol=0)
    back = bucketed_to_numpy(tbp, tbs)
    assert back["step"] == int(jbs.step) == 3
    for role, jt in (("data", jbp.data), ("m", jbs.m), ("vhi", jbs.vhi), ("vlo", jbs.vlo),
                     ("delta", jbs.delta), ("master", jbs.master)):
        if jt is None:
            assert back[role] is None
            continue
        for a, b in zip(jt, back[role]):
            np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=role)


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused-wrapper"])
def test_donated_bucketed_step_writes_the_same_bits_in_place(fused):
    """``bucketed_step(donate=True)`` (the launcher's bucketed train step):
    the new parameters and state are the old buckets' tensors, holding the
    bits of the functional step from the same state and gradient."""
    from repro_torch.core import bucketing
    from repro_torch.core.collage import CollageAdamW
    from repro_torch.core.precision import BucketPolicy, PrecisionPolicy, Strategy
    from repro_torch.kernels.collage_update import ops as tops

    g = torch.Generator().manual_seed(0)
    tree = {"a": (torch.randn((64, 40), generator=g) * 0.05).to(torch.bfloat16),
            "b": (torch.randn((300,), generator=g) * 0.05).to(torch.bfloat16)}
    opt = CollageAdamW(1e-3, policy=PrecisionPolicy(strategy=Strategy.C_COLLAGE_PLUS,
                                                    bucketing=BucketPolicy(enabled=True)),
                       use_fused_kernel=fused)
    bp, bs = opt.init_bucketed(tree)
    grads = tuple((torch.randn(d.shape, generator=g) * 1e-2).to(d.dtype) for d in bp.data)
    bp, bs, _ = tops.bucketed_step(opt, grads, bp, bs)          # nonzero state
    keep = (tuple(d.clone() for d in bp.data), bucketing.BucketedOptState(
        bs.step, *(tuple(x.clone() for x in r) if r is not None else None
                   for r in (bs.m, bs.vhi, bs.vlo, bs.delta, bs.master)),
        bs.rng, bs.layout, bs.grad_err))
    want_p, want_s, want_m = tops.bucketed_step(
        opt, grads, bucketing.BucketedParams(keep[0], bp.layout), keep[1])
    got_p, got_s, got_m = tops.bucketed_step(opt, grads, bp, bs, donate=True)
    assert all(x.data_ptr() == y.data_ptr() for x, y in zip(got_p.data, bp.data))
    assert all(x.data_ptr() == y.data_ptr() for x, y in zip(got_s.vlo, bs.vlo))
    for role in ("data", "m", "vhi", "vlo", "delta"):
        src_w = want_p.data if role == "data" else getattr(want_s, role)
        src_g = got_p.data if role == "data" else getattr(got_s, role)
        for x, y in zip(src_g, src_w):
            assert torch.equal(x.view(torch.int16), y.view(torch.int16)), role
    assert float(got_m.edq) == float(want_m.edq)


@pytest.mark.parametrize("code", ["C", "SR"])
def test_update_in_chunks_of_whole_tiles_equals_one_bucket(code):
    """chip_smoke.py's check of the update past 2^31 elements runs the plain
    version over chunks of whole tiles, each with its element offset: the
    chunks' bits and concatenated per-tile partials (``return_tiles``),
    summed over the tiles by ``det_sum``, equal the whole bucket's."""
    from repro_torch.core import bucketing
    from repro_torch.kernels.collage_update import ref as tref

    n, chunk, br = 40 * 1024, 16 * 1024, 8
    g = torch.Generator().manual_seed(1)
    scales = {"theta": 0.05, "m": 1e-3, "vhi": 1e-5, "vlo": 1e-9, "delta": 1e-5}
    state = {f: (torch.randn((n,), generator=g) * scales[f]).abs().to(torch.bfloat16)
             if f == "vhi" else (torch.randn((n,), generator=g) * scales[f]).to(torch.bfloat16)
             for f in tcu.state_fields(code)}
    grad = (torch.randn((n,), generator=g) * 1e-2).to(torch.bfloat16)
    seed, off = (77, 2**32 - 20 * 1024) if code == "SR" else (None, None)
    kw = dict(strategy=code, compute_metrics=True, block_rows=br)
    whole, parts = tref.collage_bucket_update_plain(state, grad, 1e-3, 0.19, 0.0975, seed, off,
                                                    **kw)
    tiles = []
    for s in range(0, n, chunk):
        sub = {f: t[s:s + chunk] for f, t in state.items()}
        o = None if off is None else (off + s) % 2**32
        out, t = tref.collage_bucket_update_plain(sub, grad[s:s + chunk], 1e-3, 0.19, 0.0975,
                                                  seed, o, return_tiles=True, **kw)
        for f in out:
            assert torch.equal(out[f].view(torch.int16), whole[f][s:s + chunk].view(torch.int16))
        tiles.append(t)
    sums = bucketing.det_sum(torch.cat(tiles), dim=0)
    assert all(torch.equal(sums[i], parts[i]) for i in range(5))

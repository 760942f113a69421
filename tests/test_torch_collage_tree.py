"""The port's tree-layout Collage step (repro_torch.core.collage
``CollageAdamW.step``, ``convert_state``, ``mcf.stochastic_round`` and the
fused shim ``kernels.collage_update.ops.fused_step``) against the JAX
package's.

Tolerance: none for the state. Params, m, v (both components), δθ and the
master copy must be bit-identical to the JAX package's step run EAGERLY
(not under ``jax.jit``: XLA's CPU backend may contract a multiply and an
add into an FMA and drift by one ulp, while the port rounds every
operation on its own). Inputs keep every result normal (XLA's CPU backend
flushes subnormals; the port keeps them). The finalized metrics sum the
same f32 products in another order: rtol 1e-5, the tolerance of
tests/test_kernels.py. Stochastic rounding draws other noise than the JAX
package's threefry stream (by design): it is held bit for bit given the
same noise, and by its statistics.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import collage as jcollage
from repro.core import mcf as jmcf
from repro.core.precision import PrecisionPolicy as JPP
from repro.core.precision import parse_strategy as jparse
from repro.kernels.collage_update.ref import collage_bucket_update_ref
from repro_torch.convert import opt_state_from_numpy, opt_state_to_numpy, tensor_from_numpy
from repro_torch.core import bucketing, mcf
from repro_torch.core.collage import CollageAdamW, bucket_state, convert_state
from repro_torch.core.precision import PrecisionPolicy, parse_strategy
from repro_torch.kernels.collage_update import ops as tops

DETERMINISTIC = ["A", "B", "C", "KAHAN", "D-MW", "D"]
SHAPES = {"a": (64, 128), "b": [(300,), (7, 5)]}     # two leaves of no multiple of 128
KW = dict(b2=0.95, weight_decay=0.1, compute_metrics=True, sr_seed=7)


def _bf(x):
    return np.asarray(jnp.asarray(x, jnp.float32).astype(jnp.bfloat16))


def _tree(fn):
    return {"a": fn(SHAPES["a"]), "b": [fn(s) for s in SHAPES["b"]]}


def _np_state(name, seed):
    """Params and a random optimizer state of plausible magnitudes (results
    stay normal), as numpy trees in the JAX package's roles and dtypes."""
    rng = np.random.default_rng(seed)
    s = jparse(name)
    params = _tree(lambda sh: _bf(rng.standard_normal(sh) * 0.05))
    f32 = s.name in ("D_MINUS_MW", "D_MIXED_MW")
    cast = (lambda x: x.astype(np.float32)) if f32 else _bf
    m = _tree(lambda sh: cast(rng.standard_normal(sh) * 1e-3))
    v = _tree(lambda sh: cast(np.abs(rng.standard_normal(sh)) * 1e-5))
    if s.uses_expansion_second_moment:
        v = jax.tree_util.tree_map(lambda hi: (hi, _bf(rng.standard_normal(hi.shape) * 1e-9)), v)
    delta = _tree(lambda sh: _bf(rng.standard_normal(sh) * 1e-5)) \
        if (s.uses_expansion_params or s.name == "KAHAN") else None
    master = jax.tree_util.tree_map(
        lambda p: (p.astype(np.float32) + np.float32(1e-5) * rng.standard_normal(p.shape)
                   ).astype(np.float32), params) if s.uses_master_weights else None
    return params, {"step": 0, "m": m, "v": v, "delta": delta, "master": master,
                    "rng": np.array([0, 7], np.uint32) if s.name == "SR" else None}


def _is_pair(x):
    return isinstance(x, tuple) and len(x) == 2


def _jax_state(st):
    v = jax.tree_util.tree_map(lambda p: jmcf.Expansion(jnp.asarray(p[0]), jnp.asarray(p[1])),
                               st["v"], is_leaf=_is_pair) if _has_pairs(st["v"]) \
        else jax.tree_util.tree_map(jnp.asarray, st["v"])
    j = lambda t: None if t is None else jax.tree_util.tree_map(jnp.asarray, t)
    return jcollage.CollageOptState(step=jnp.int32(st["step"]), m=j(st["m"]), v=v,
                                    delta=j(st["delta"]), master=j(st["master"]),
                                    rng=j(st["rng"]))


def _has_pairs(tree):
    return any(_is_pair(x) for x in jax.tree_util.tree_leaves(tree, is_leaf=_is_pair))


def _jax_to_numpy(state):
    """A JAX CollageOptState as the numpy trees ``opt_state_to_numpy`` gives."""
    conv = lambda t: None if t is None else jax.tree_util.tree_map(
        lambda x: (np.asarray(x.hi), np.asarray(x.lo)) if isinstance(x, jmcf.Expansion)
        else np.asarray(x), t, is_leaf=lambda x: isinstance(x, jmcf.Expansion))
    return {"m": conv(state.m), "v": conv(state.v), "delta": conv(state.delta),
            "master": conv(state.master)}


def _port_params(params):
    return jax.tree_util.tree_map(lambda x: tensor_from_numpy(x, "cpu"), params)


def _bits(x):
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype.itemsize == 2 else x.view(np.uint32)


def _assert_same_tree(jax_tree, port_np_tree, what):
    ja = jax.tree_util.tree_leaves(jax_tree)
    tb = jax.tree_util.tree_leaves(port_np_tree)
    assert len(ja) == len(tb), what
    for i, (a, b) in enumerate(zip(ja, tb)):
        np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=f"{what} leaf {i}")


def _grads(seed):
    rng = np.random.default_rng(seed)
    return _tree(lambda sh: _bf(rng.standard_normal(sh) * 1e-2))


def _jax_scalars(t, b2=0.95):
    tf = jnp.float32(t)
    return (np.float32(1e-3), np.float32(1.0 - jnp.float32(0.9) ** tf),
            np.float32(1.0 - jnp.float32(b2) ** tf))


def _opts(name, wd_mode="fused", fused=False):
    jopt = jcollage.CollageAdamW(1e-3, policy=JPP(strategy=jparse(name), wd_mode=wd_mode), **KW)
    topt = CollageAdamW(1e-3, policy=PrecisionPolicy(strategy=parse_strategy(name),
                                                     wd_mode=wd_mode),
                        use_fused_kernel=fused, **KW)
    return jopt, topt


@pytest.mark.parametrize("name,wd_mode", [*[(n, "fused") for n in DETERMINISTIC],
                                          ("A", "pytorch")])
def test_tree_steps_bit_identical_to_eager_jax(name, wd_mode):
    """3 steps from the same converted state; the JAX step eager."""
    jopt, topt = _opts(name, wd_mode)
    params, st = _np_state(name, 1)
    jp, js = jax.tree_util.tree_map(jnp.asarray, params), _jax_state(st)
    tp, ts = _port_params(params), opt_state_from_numpy(**st, device="cpu")
    for t in range(1, 4):
        g = _grads(10 + t)
        jp, js, jm = jopt.step(jax.tree_util.tree_map(jnp.asarray, g), jp, js)
        tp, ts, tm = topt.step(_port_params(g), tp, ts, scalars=_jax_scalars(t))
        for k in range(5):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                       err_msg=f"step {t} metric {tm._fields[k]}")
        back = opt_state_to_numpy(ts)
        _assert_same_tree(jp, jax.tree_util.tree_map(
            lambda x: x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 else x.numpy(),
            tp), f"step {t} params")
        for role, jt in _jax_to_numpy(js).items():
            if jt is None:
                assert back[role] is None, role
            else:
                _assert_same_tree(jt, back[role], f"step {t} {role}")
    assert ts.step == int(js.step) == 3
    if name in ("A", "D-MW"):                  # bf16 ⊕ loses some updates
        assert float(tm.imprecision_pct) > 0


@pytest.mark.parametrize("src,dst", [("D", "C"), ("C", "D"), ("D", "KAHAN"), ("C", "SR")])
def test_convert_state_matches_jax(src, dst):
    params, st = _np_state(src, 2)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jnew = jcollage.convert_state(_jax_state(st), jp, JPP(strategy=jparse(dst)), sr_seed=3)
    tnew = convert_state(opt_state_from_numpy(**st, device="cpu"), _port_params(params),
                         PrecisionPolicy(strategy=parse_strategy(dst)), sr_seed=3)
    back = opt_state_to_numpy(tnew)
    for role, jt in _jax_to_numpy(jnew).items():
        if jt is None:
            assert back[role] is None, role
        else:
            _assert_same_tree(jt, back[role], role)
    if dst == "SR":      # the JAX key PRNGKey(3) and the port's seed 3
        np.testing.assert_array_equal(back["rng"], np.asarray(jnew.rng))


def test_opt_state_numpy_round_trip():
    params, st = _np_state("C", 3)
    back = opt_state_to_numpy(opt_state_from_numpy(**st, device="cpu"))
    for role in ("m", "v", "delta"):
        _assert_same_tree(st[role], back[role], role)
    assert back["master"] is None and back["rng"] is None
    _, sr = _np_state("SR", 3)
    assert opt_state_from_numpy(**sr, device="cpu").rng == 7      # PRNGKey(7) → seed 7


def test_stochastic_round_bit_trick_equals_jax_given_the_same_noise():
    rng = np.random.default_rng(4)
    x = (rng.standard_normal(4096) * 10.0 ** rng.integers(-6, 4, 4096)).astype(np.float32)
    key = jax.random.PRNGKey(11)
    want = jmcf.stochastic_round(jnp.asarray(x), jnp.bfloat16, key)
    noise = np.asarray(jax.random.randint(key, x.shape, 0, 1 << 16, dtype=jnp.uint32))
    got = mcf.stochastic_round(torch.from_numpy(x), torch.bfloat16,
                               torch.from_numpy(noise.astype(np.int64)))
    np.testing.assert_array_equal(np.asarray(want).view(np.uint16),
                                  got.view(torch.int16).numpy().view(np.uint16))


def test_stochastic_round_ulp_branch_equals_jax_given_the_same_bits():
    """float16 (the generic branch): the uniform of ``jax.random.uniform``
    made from the same 32 random bits. Magnitudes stay above float16's
    smallest normal (XLA's CPU backend flushes float16 subnormals)."""
    rng = np.random.default_rng(5)
    x = (rng.choice([-1.0, 1.0], 4096) * 10.0 ** rng.uniform(-3, 4, 4096)).astype(np.float32)
    key = jax.random.PRNGKey(12)
    want = jmcf.stochastic_round(jnp.asarray(x), jnp.float16, key)
    bits = np.asarray(jax.random.bits(key, x.shape, jnp.uint32))
    got = mcf.stochastic_round(torch.from_numpy(x), torch.float16,
                               torch.from_numpy(bits.astype(np.int64)))
    np.testing.assert_array_equal(np.asarray(want).view(np.uint16),
                                  got.view(torch.int16).numpy().view(np.uint16))


def test_stochastic_round_is_unbiased():
    """E[SR(x)] = x: the mean over 64 draws of the hash stream, per element,
    within 4 standard errors of x (one bf16 ulp gap each)."""
    rng = np.random.default_rng(6)
    x = torch.from_numpy((rng.standard_normal(2048) * 3).astype(np.float32))
    idx = torch.arange(x.numel(), dtype=torch.int64)
    draws = torch.stack([mcf.stochastic_round(x, torch.bfloat16,
                                              bucketing.sr_bits32(idx, int(
                                                  bucketing.fold_seed(9, k)))).float()
                         for k in range(64)])
    gap = mcf.ulp(x.to(torch.bfloat16))
    err = (draws.mean(0) - x) / gap
    assert float(err.abs().max()) < 4 * 0.5 / 8          # σ ≤ gap/2, 64 draws
    assert abs(float(err.mean())) < 0.02                  # no bias across elements


def test_sr_tree_steps_move_parameters_and_follow_the_seed():
    """As test_collage_optimizer.py's SR test: θ = 200 with tiny updates is
    frozen under round-to-nearest (option A) but moves under SR; the same
    seed repeats, another differs."""
    theta0 = {"w": torch.full((4096,), 200.0, dtype=torch.bfloat16)}
    rng = np.random.default_rng(4)
    grads = [{"w": torch.from_numpy(rng.standard_normal(4096).astype(np.float32) * 1e-2
                                    ).to(torch.bfloat16)} for _ in range(30)]

    def run(name, seed):
        opt = CollageAdamW(1.2e-4, policy=PrecisionPolicy(strategy=parse_strategy(name)),
                           sr_seed=seed)
        p, st = theta0, opt.init(theta0)
        for g in grads:
            p, st, _ = opt.step(g, p, st)
        return p["w"]

    assert torch.equal(run("A", 0), theta0["w"])
    sr0 = run("SR", 0)
    assert not torch.equal(sr0, theta0["w"])
    assert torch.equal(run("SR", 0), sr0)
    assert not torch.equal(run("SR", 1), sr0)


@pytest.mark.parametrize("name", [*DETERMINISTIC, "SR"])
def test_fused_step_equals_bucketed_step(name):
    """The tree shim (use_fused_kernel) and the bucket engine on the same
    state give the same bits and the same metrics."""
    _, topt = _opts(name, fused=True)
    params, st = _np_state(name, 5)
    tp, ts = _port_params(params), opt_state_from_numpy(**st, device="cpu")
    g = _port_params(_grads(6))
    sc = _jax_scalars(1)
    fp, fs, fm = topt.step(g, tp, ts, scalars=sc)
    layout = bucketing.build_layout(tp)
    bp, bs = bucket_state(ts, tp, layout, topt.policy, sr_seed=ts.rng or 0)
    gb = bucketing.bucket_tree(g, layout)
    bp, bs, bm = tops.bucketed_step(topt, gb, bp, bs, scalars=sc)
    for a, b in zip(bucketing.tree_leaves(fp), bucketing.unbucket_leaves(bp.data, layout)):
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))
    fb = bucket_state(fs, fp, layout, topt.policy)[1]
    for role in ("m", "vhi", "vlo", "delta", "master"):
        if getattr(bs, role) is None:
            continue
        for a, b in zip(getattr(fb, role), getattr(bs, role)):
            assert torch.equal(a.view(torch.uint8), b.view(torch.uint8)), role
    assert all(torch.equal(a, b) for a, b in zip(fm, bm))
    assert fs.step == 1 and fs.rng == ts.rng


@pytest.mark.parametrize("name", ["C", "D"])
def test_fused_step_bit_identical_to_jax_eager_bucket_oracle(name):
    """The shim's buckets against the JAX package's ``collage_bucket_update_ref``
    run eagerly on the JAX package's own bucketing of the same state."""
    from repro.core import bucketing as jb
    from repro.kernels.collage_update.ops import STRATEGY_CODE as JCODE

    jopt, topt = _opts(name, fused=True)
    params, st = _np_state(name, 7)
    g = _grads(8)
    sc = _jax_scalars(1)
    tp, ts, _ = topt.step(_port_params(g), _port_params(params),
                          opt_state_from_numpy(**st, device="cpu"), scalars=sc)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    layout = jb.build_layout(jp)
    jbp, jbs = jcollage.bucket_state(_jax_state(st), jp, layout, jopt.policy)
    code = JCODE[jopt.policy.strategy]
    roles = {"theta": jbp.data, "m": jbs.m, "vhi": jbs.vhi, "vlo": jbs.vlo,
             "delta": jbs.delta, "master": jbs.master}
    gb = jb.bucket_tree(jax.tree_util.tree_map(jnp.asarray, g), layout)
    fields = [f for f in ("theta", "m", "vhi", "vlo", "delta", "master") if roles[f] is not None]
    new = {f: [] for f in fields}
    for i in range(layout.n_buckets):
        out, _ = collage_bucket_update_ref(
            {f: roles[f][i] for f in fields}, gb[i], jnp.float32(sc[0]), jnp.float32(sc[1]),
            jnp.float32(sc[2]), None, None, b1=0.9, b2=0.95, eps=1e-8, wd=0.1, strategy=code,
            pt_decay=False, compute_metrics=False)
        for f in fields:
            new[f].append(out[f])
    _assert_same_tree(jb.unbucket(new["theta"], layout), jax.tree_util.tree_map(
        lambda x: x.view(torch.int16).numpy(), tp), "params")
    back = opt_state_to_numpy(ts)
    _assert_same_tree(jb.unbucket(new["m"], layout), back["m"], "m")
    if name == "C":
        _assert_same_tree(jb.unbucket(new["delta"], layout), back["delta"], "delta")
        his = jax.tree_util.tree_leaves(jb.unbucket(new["vhi"], layout))
        los = jax.tree_util.tree_leaves(jb.unbucket(new["vlo"], layout))
        pairs = jax.tree_util.tree_leaves(back["v"], is_leaf=_is_pair)
        for h, lo, (bh, bl) in zip(his, los, pairs):
            np.testing.assert_array_equal(_bits(h), _bits(bh))
            np.testing.assert_array_equal(_bits(lo), _bits(bl))
    else:
        _assert_same_tree(jb.unbucket(new["vhi"], layout), back["v"], "v")
        _assert_same_tree(jb.unbucket(new["master"], layout), back["master"], "master")


def test_step_metrics_partials_is_not_ported():
    """Ported now (the name stays): ``step(metrics_partials=True)`` returns
    the JAX package's per-leaf raw partials (⟨Δθ,Δθ̂⟩, ‖Δθ‖², ‖Δθ̂‖², #lost,
    ‖g‖²) in leaf order, with the same state; their sum finalizes to the
    plain step's metrics; the fused shim refuses them as the JAX one does."""
    jopt, topt = _opts("C")
    params, st = _np_state("C", 1)
    jp, js = jax.tree_util.tree_map(jnp.asarray, params), _jax_state(st)
    tp, ts = _port_params(params), opt_state_from_numpy(**st, device="cpu")
    g = _grads(11)
    jp2, js2, jparts = jopt.step(jax.tree_util.tree_map(jnp.asarray, g), jp, js,
                                 metrics_partials=True)
    tp2, ts2, tparts = topt.step(_port_params(g), tp, ts, scalars=_jax_scalars(1),
                                 metrics_partials=True)
    assert len(tparts) == len(jparts) == 3
    for tpart, jpart in zip(tparts, jparts):
        for k in range(5):
            np.testing.assert_allclose(float(tpart[k]), float(jpart[k]), rtol=1e-5)
    _assert_same_tree(jp2, jax.tree_util.tree_map(
        lambda x: x.view(torch.int16).numpy(), tp2), "params")
    _, _, plain = topt.step(_port_params(g), tp, ts, scalars=_jax_scalars(1))
    fin = tops.finalize_metrics(tops.sum_partials(tparts), sum(
        int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(params)))
    for k in range(5):
        np.testing.assert_allclose(float(fin[k]), float(plain[k]), rtol=1e-6)
    _, fused = _opts("C", fused=True)
    with pytest.raises(ValueError, match="metrics_partials"):
        fused.step(_port_params(g), tp, ts, metrics_partials=True)
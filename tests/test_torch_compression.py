"""The port's gradient compression (repro_torch.distributed.compression),
its fp8 rounding (core.mcf) and its collectives (distributed.collectives)
against the JAX package's.

* fp8 ``rn`` over every bf16 bit pattern, the grid's edges and random f32
  bit patterns: bit for bit ``lax.reduce_precision`` with (4, 3) and
  (5, 2) (max 240 / 57344, ±inf past the rounding edge, the grid's
  subnormals flushed to zero).
* ``block_amax``/``fp8_scale``/``quantize``/``dequantize``/
  ``compress_decompress``/``compress_tree``/``init_error_state``/
  ``residual_dtype`` for bf16, fp8 and fp8e5, at ragged lengths (not
  multiples of 512), bit for bit against the JAX functions under
  ``jax.jit``, as the JAX package's steps run them: XLA contracts the fp8
  residual g − q·s into one fused multiply-add, which the port takes
  exactly (the eager JAX function rounds q·s first).
* ``pmean_compressed`` and ``psum_scatter_compressed`` on gloo at 2 and 4
  ranks against the JAX functions under shard_map on forced host devices
  (a subprocess): bit for bit. These pin the reference's sums: fp8
  payloads summed in rank order in f16, bf16 in f32, rounded once.
* The numerics the JAX package's TestCompressionNumerics holds: per-block
  fp8 scaling, the exact bf16 residual, the 100-step EF bound.
"""

import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bucketing as jb
from repro.distributed import compression as jc
from repro_torch.core import bucketing
from repro_torch.core import mcf
from repro_torch.distributed import collectives as coll
from repro_torch.distributed import compression as tc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DTYPES = {"bf16": (torch.bfloat16, jnp.bfloat16), "fp8": (torch.float8_e4m3fn, jnp.float8_e4m3fn),
          "fp8e5": (torch.float8_e5m2, jnp.float8_e5m2)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file's cases: they run many small ops,
    which a thread pool shared with the suite's other workers slows many
    times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# XLA's CPU backend on one thread: the suite's other workers share the cores
ONE_THREAD_XLA = "--xla_cpu_multi_thread_eigen=false"


def _env(**extra):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1",
               JAX_PLATFORMS="cpu")
    env.update(extra)
    return env


def run_ranks(code: str, n: int, tmp_path, timeout: float = 240.0) -> list:
    """Run ``code`` in n processes, the ranks of a gloo group that meets
    through a FileStore under ``tmp_path`` (``RANK``, ``N`` and ``TMP`` are
    defined for it); the workers are killed if they outlast ``timeout``.
    Returns their standard outputs."""
    store = tmp_path / f"store_{n}_{os.urandom(4).hex()}"
    prelude = textwrap.dedent(f"""
        import datetime, sys, torch, torch.distributed as dist
        torch.set_num_threads(1)
        RANK, N, TMP = int(sys.argv[1]), {n}, {str(tmp_path)!r}
        dist.init_process_group("gloo", store=dist.FileStore({str(store)!r}, N), rank=RANK,
                                world_size=N, timeout=datetime.timedelta(seconds=60))
    """)
    body = prelude + textwrap.dedent(code) + "\ndist.destroy_process_group()\n"
    procs = [subprocess.Popen([sys.executable, "-c", body, str(r)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=_env()) for r in range(n)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            assert p.returncode == 0, f"rank failed:\nSTDOUT:\n{out}\nSTDERR:\n{err[-4000:]}"
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def run_jax_devices(code: str, n: int, timeout: float = 300.0) -> str:
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(code)], capture_output=True,
                         text=True, timeout=timeout,
                         env=_env(XLA_FLAGS=f"--xla_force_host_platform_device_count={n} "
                                            + ONE_THREAD_XLA))
    assert out.returncode == 0, f"STDOUT:\n{out.stdout}\nSTDERR:\n{out.stderr[-4000:]}"
    return out.stdout


def _bits(x) -> np.ndarray:
    """The raw bits of a JAX array or a torch tensor, as an unsigned view."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype in (torch.bfloat16, torch.float8_e4m3fn, torch.float8_e5m2):
            w = {1: torch.uint8, 2: torch.int16}[x.element_size()]
            return x.view(w).numpy().view({1: np.uint8, 2: np.uint16}[x.element_size()])
        return x.numpy().view(np.uint32)
    a = np.asarray(x)
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32}[a.dtype.itemsize])


def _assert_bits(port, ref, what):
    a, b = _bits(port), _bits(ref)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    bad = int((a != b).sum())
    assert bad == 0, f"{what}: {bad} of {a.size} differ"


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.require(a, requirements=["C", "W"]))


# --------------------------------------------------------------------------
# fp8 rn
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name,fmt", [("fp8", (4, 3)), ("fp8e5", (5, 2))])
def test_fp8_rn_equals_reduce_precision(name, fmt):
    tdt = DTYPES[name][0]
    every_bf16 = (np.arange(2**16, dtype=np.uint32) << 16).view(np.float32)
    edges = np.array([240, 244, 247.99, 248, 256, 448, 57344, 61440, 2.0**-6, 2.0**-7,
                      2.0**-9, 2.0**-14, 2.0**-15, 2.0**-16, 1.5 * 2.0**-7, 1e-30, 0.0,
                      np.inf, np.nan], np.float32)
    edges = np.concatenate([edges, -edges])
    rand = np.random.RandomState(0).randint(0, 2**32, 2**18, dtype=np.uint64) \
        .astype(np.uint32).view(np.float32)
    for x in (every_bf16, edges, rand):
        ref = np.asarray(jax.lax.reduce_precision(jnp.asarray(x), *fmt))
        got = mcf.fpu(tdt).rn(_t(x)).numpy()
        assert np.array_equal(np.isnan(ref), np.isnan(got))
        keep = ~np.isnan(ref)
        assert np.array_equal(ref.view(np.uint32)[keep], got.view(np.uint32)[keep])
    assert float(mcf.fpu(tdt).rn(torch.tensor([244.0]))[0]) == (240.0 if name == "fp8" else 256.0)


# --------------------------------------------------------------------------
# primitives, bit for bit against the eager JAX functions
# --------------------------------------------------------------------------

def _grad(n, dt, seed):
    g = (np.random.RandomState(seed).standard_normal(n) * 1e-3).astype(np.float32)
    g[:7] *= 300.0                                  # an outlier block
    g[n // 2] = 0.0
    return g.astype(np.float32) if dt == "f32" else np.asarray(jnp.asarray(g, jnp.bfloat16))


def _port(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return _t(a.view(np.uint16)).view(torch.bfloat16)
    return _t(a)


@pytest.mark.parametrize("n", [1000, 1536, 4099])
@pytest.mark.parametrize("name", list(DTYPES))
def test_primitives_match_reference(name, n):
    tdt, jdt = DTYPES[name]
    for src in ("f32", "bf16"):
        g = _grad(n, src, n)
        e = (np.random.RandomState(1).standard_normal(n) * 1e-6).astype(np.float32)
        jg, tg = jnp.asarray(g), _port(g)
        assert tc.residual_dtype(tdt, tg.dtype) == {
            jnp.dtype(jnp.float32): torch.float32,
            jnp.dtype(jnp.bfloat16): torch.bfloat16}[jc.residual_dtype(jdt, jg.dtype)]
        amax = tc.block_amax(tg)
        _assert_bits(amax, jc.block_amax(jg), "block_amax")
        if tc.is_fp8(tdt):
            for hr in (1.0, 2.0, 4.0, 8.0):
                _assert_bits(tc.fp8_scale(amax, tdt, hr), jc.fp8_scale(jc.block_amax(jg), jdt, hr),
                             f"fp8_scale {hr}")
            scale, jscale = tc.fp8_scale(amax, tdt, 4.0), jc.fp8_scale(jc.block_amax(jg), jdt, 4.0)
        else:
            scale = jscale = None
        pay, deq = tc.quantize(tg.float(), tdt, scale)
        jpay, jdeq = jc.quantize(jg.astype(jnp.float32), jdt, jscale)
        _assert_bits(pay, jpay, "payload")
        _assert_bits(deq, jdeq, "deq32")
        _assert_bits(tc.dequantize(pay, tdt, scale), jc.dequantize(jpay, jdt, jscale),
                     "dequantize")
        jit_cd = jax.jit(jc.compress_decompress, static_argnums=2)
        for err in (None, e):
            d, r = tc.compress_decompress(tg, None if err is None else _t(err), tdt)
            jd, jr = jit_cd(jg, None if err is None else jnp.asarray(err), jdt)
            _assert_bits(d, jd, "compress_decompress value")
            _assert_bits(r, jr, "compress_decompress residual")


@pytest.mark.parametrize("name", list(DTYPES))
def test_tree_and_error_state_match_reference(name):
    tdt, jdt = DTYPES[name]
    tree_np = {"a": _grad(300, "bf16", 1).reshape(20, 15), "b": [_grad(700, "bf16", 2)],
               "c": _grad(64, "f32", 3)}
    jtree = jax.tree_util.tree_map(jnp.asarray, tree_np)
    ttree = {"a": _port(tree_np["a"]), "b": [_port(tree_np["b"][0])], "c": _port(tree_np["c"])}
    jerr = jc.init_error_state(jtree, jdt)
    terr = tc.init_error_state(ttree, tdt)
    for (_, t), j in zip(bucketing.tree_flatten_with_path(terr)[0], jax.tree_util.tree_leaves(jerr)):
        _assert_bits(t, j, "init_error_state tree")
    for err_in in (None, 1):
        je = None if err_in is None else jax.tree_util.tree_map(lambda x: x + 1e-5, jerr)
        te = None if err_in is None else bucketing.tree_map(lambda x: x + 1e-5, terr)
        jq, jr = jax.jit(jc.compress_tree, static_argnums=2)(jtree, je, jdt)
        tq, tr = tc.compress_tree(ttree, te, tdt)
        for t, j in zip(bucketing.tree_leaves(tq) + bucketing.tree_leaves(tr),
                        jax.tree_util.tree_leaves(jq) + jax.tree_util.tree_leaves(jr)):
            _assert_bits(t, j, "compress_tree")
    # bucketed template: (1, padded) rows in the residual dtype
    params = {"a": jnp.zeros((300,), jnp.bfloat16), "b": jnp.zeros((200,), jnp.bfloat16)}
    jlayout = jb.build_layout(params, pad_multiple=512)
    jrows = jc.init_error_state(jb.BucketedParams(jb.bucket_tree(params, jlayout), jlayout), jdt)
    tparams = {"a": torch.zeros(300, dtype=torch.bfloat16),
               "b": torch.zeros(200, dtype=torch.bfloat16)}
    tlayout = bucketing.build_layout(tparams, pad_multiple=512)
    trows = tc.init_error_state(
        bucketing.BucketedParams(bucketing.bucket_tree(tparams, tlayout), tlayout), tdt)
    assert [tuple(r.shape) for r in trows] == [tuple(r.shape) for r in jrows] == [(1, 512)]
    for t, j in zip(trows, jrows):
        _assert_bits(t, j, "init_error_state rows")


def test_parse_spec_and_residual_rules():
    for name, (dt, ef) in tc._SPECS.items():
        jdt, jef = jc.parse_spec(name)
        assert ef == jef and (dt is None) == (jdt is None)
        assert tc.is_fp8(dt) == (jdt is not None and jc.is_fp8(jdt))
    with pytest.raises(ValueError, match="unknown grad_compression"):
        tc.parse_spec("int4")
    assert tc.residual_dtype(torch.bfloat16, torch.bfloat16) == torch.bfloat16
    assert tc.residual_dtype(torch.bfloat16, torch.float32) == torch.float32
    assert tc.residual_dtype(torch.float8_e4m3fn, torch.bfloat16) == torch.float32


# --------------------------------------------------------------------------
# the numerics of TestCompressionNumerics, on the port
# --------------------------------------------------------------------------

def test_fp8_block_scaling_is_per_block():
    g = torch.from_numpy(np.random.RandomState(0).standard_normal(4 * tc.BLOCK)
                         .astype(np.float32))
    g[:tc.BLOCK] *= 100.0
    deq, resid = tc.compress_decompress(g, None, torch.float8_e4m3fn)
    err = (deq - g).abs().reshape(-1, tc.BLOCK)
    amax = g.abs().reshape(-1, tc.BLOCK).amax(1)
    assert bool((err.amax(1) / amax < 2.0 ** -4).all())
    assert resid.dtype == torch.float32


def test_bf16_residual_is_exact_for_bf16_grads():
    g = (torch.from_numpy(np.random.RandomState(1).standard_normal(1024).astype(np.float32))
         * 1e-2).to(torch.bfloat16)
    deq, r = tc.compress_decompress(g, torch.zeros(1024, dtype=torch.bfloat16), torch.bfloat16)
    assert torch.equal(g.float() - deq, r.float())


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float8_e4m3fn])
def test_ef_accumulated_error_bound_100_steps(dt):
    err = None
    comp = torch.zeros(4096)
    true = torch.zeros(4096)
    rng = np.random.RandomState(2)
    for _ in range(100):
        g = torch.from_numpy(rng.standard_normal(4096).astype(np.float32)) * 1e-3
        deq, err = tc.compress_decompress(g, err, dt)
        comp, true = comp + deq, true + g
    assert float((comp + err.float() - true).abs().max()) < 5e-7


# --------------------------------------------------------------------------
# the collectives: gloo ranks against shard_map on forced host devices
# --------------------------------------------------------------------------

_N = 4096


def _inputs(n):
    rng = np.random.RandomState(10 + n)
    g = (rng.standard_normal((n, _N)) * 1e-3).astype(np.float32)
    g[:, 5] *= 500.0
    e = (rng.standard_normal((n, _N)) * 1e-7).astype(np.float32)
    return g, e


@pytest.mark.parametrize("n", [2, 4])
def test_collectives_match_shard_map(n, tmp_path):
    g, e = _inputs(n)
    np.save(tmp_path / "g.npy", g)
    np.save(tmp_path / "e.npy", e)
    run_jax_devices(f"""
        import numpy as np, jax, jax.numpy as jnp
        from functools import partial
        from jax.experimental.shard_map import shard_map
        from jax.sharding import PartitionSpec as P
        from repro.distributed import compression as c
        n, T = {n}, {str(tmp_path)!r}
        g, e = np.load(T + "/g.npy"), np.load(T + "/e.npy")
        mesh = jax.make_mesh((n,), ("data",))
        for name, dt in (("bf16", jnp.bfloat16), ("fp8", jnp.float8_e4m3fn),
                         ("fp8e5", jnp.float8_e5m2)):
            for op in ("pmean", "scatter"):
                @jax.jit
                @partial(shard_map, mesh=mesh, in_specs=(P("data"), P("data")),
                         out_specs=(P("data"), P("data")), check_rep=False)
                def f(gg, ee):
                    if op == "pmean":
                        m, r = c.pmean_compressed(gg[0], ee[0], dt, "data", n)
                    else:
                        m, r = c.psum_scatter_compressed(gg[0], ee[0], dt, "data", n)
                    return m[None], r[None]
                m, r = f(jnp.asarray(g), jnp.asarray(e))
                np.save(f"{{T}}/ref_{{name}}_{{op}}_m.npy", np.asarray(m, np.float32))
                np.save(f"{{T}}/ref_{{name}}_{{op}}_r.npy", np.asarray(r, np.float32))
    """, n)
    run_ranks("""
        import numpy as np
        from repro_torch.distributed import collectives as coll, compression as c
        axis = coll.Axis.of()
        g = torch.from_numpy(np.load(TMP + "/g.npy")[RANK])
        e = torch.from_numpy(np.load(TMP + "/e.npy")[RANK])
        for name, dt in (("bf16", torch.bfloat16), ("fp8", torch.float8_e4m3fn),
                         ("fp8e5", torch.float8_e5m2)):
            for op in ("pmean", "scatter"):
                coll.reset_census()
                f = c.pmean_compressed if op == "pmean" else c.psum_scatter_compressed
                m, r = f(g, e, dt, axis, N)
                np.save(f"{TMP}/port_{name}_{op}_{RANK}_m.npy", m.float().numpy())
                np.save(f"{TMP}/port_{name}_{op}_{RANK}_r.npy", r.float().numpy())
                if RANK == 0:
                    print(name, op, [(x["op"], x["role"], x["dtype"], x["numel"])
                                     for x in coll.CENSUS])
    """, n, tmp_path)
    for name in DTYPES:
        for op in ("pmean", "scatter"):
            ref_m = np.load(tmp_path / f"ref_{name}_{op}_m.npy")
            ref_r = np.load(tmp_path / f"ref_{name}_{op}_r.npy")
            for r in range(n):
                m = np.load(tmp_path / f"port_{name}_{op}_{r}_m.npy")
                res = np.load(tmp_path / f"port_{name}_{op}_{r}_r.npy")
                want = ref_m[r]
                assert m.shape == want.shape, (name, op, m.shape, want.shape)
                assert np.array_equal(m.view(np.uint32), want.view(np.uint32)), \
                    (name, op, r, int((m != want).sum()))
                assert np.array_equal(res.view(np.uint32), ref_r[r].view(np.uint32)), \
                    (name, op, r)


def test_census_records_wire_dtypes(tmp_path):
    out = run_ranks("""
        from repro_torch.distributed import collectives as coll, compression as c
        axis = coll.Axis.of()
        g = torch.full((2048,), 1e-3 * (RANK + 1))
        for dt in (torch.bfloat16, torch.float8_e4m3fn):
            coll.reset_census()
            c.pmean_compressed(g, None, dt, axis, N)
            c.psum_scatter_compressed(g, None, dt, axis, N)
            if RANK == 0:
                print("CENSUS", [(x["op"], x["role"], x["dtype"], x["numel"], x["bytes"])
                                 for x in coll.CENSUS])
    """, 2, tmp_path)
    lines = [eval(l.split("CENSUS ", 1)[1]) for l in out[0].splitlines() if l.startswith("CENSUS")]
    assert lines[0] == [("all_gather", "grad", "bfloat16", 2048, 4096),
                        ("all_to_all", "grad", "bfloat16", 2048, 4096)]
    assert lines[1] == [("all_reduce_max", "amax", "float32", 4, 16),
                        ("all_gather", "grad", "uint8", 2048, 2048),
                        ("all_reduce_max", "amax", "float32", 4, 16),
                        ("all_to_all", "grad", "uint8", 2048, 2048)]


def test_single_rank_axis_is_the_local_round_trip():
    """``Axis()`` (one rank, no group): the compressed mean is the local
    round trip, and nothing is recorded."""
    coll.reset_census()
    g = torch.from_numpy(_inputs(2)[0][0])
    for dt in (torch.bfloat16, torch.float8_e4m3fn):
        m, r = tc.pmean_compressed(g, None, dt, coll.Axis(), 1)
        d, rr = tc.compress_decompress(g, None, dt)
        assert torch.equal(m, d) and torch.equal(r, rr)
    assert coll.CENSUS == []
    with pytest.raises(RuntimeError, match="not initialised"):
        coll.Axis.of()

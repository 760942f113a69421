"""The port's sharded engine (repro_torch.train.sharded) on gloo ranks,
against the single-device step and against the JAX package's sharded
engine, mirroring tests/test_sharded_engine.py.

Ranks are subprocesses that meet through a FileStore under ``tmp_path``
(no TCP port), with a 60 s group timeout; the parent kills them past its
own timeout. Each battery of cases runs once per rank count and the tests
read its results.

* At 2 and 4 ranks (gpt-tiny smoke, C): the tree layout and ZeRO bucketed
  ≡ the single-device step under none/bf16_ef/fp8_ef (loss within 2e-3,
  edq within 3e-2 relative on ZeRO, 99 % of parameters within
  2e-2·max(|θ|, 1e-2): TestDistributedParity's bounds), with per-rank
  residual rows that differ under fp8; the census: compressed wire dtypes
  (bf16, fp8 as uint8), one collective per bucket on the bucketed layout
  and one per leaf on the tree layout, f32 uncompressed; SR + ZeRO
  bit-identical across 1/2/4 ranks and to the unsharded oracle over 10
  steps when fed the same gradients, and the SR + ZeRO engine tracking
  the single-device SR step; the pipeline (1f1b, 2 stages per rank) with
  fp8_ef ≡ the single-device compressed step, one residual row per
  (stage, rank) and one compressed gather per gradient class; a ZeRO
  checkpoint that restores into the ranks and into a single-rank state.
* Against the JAX package's engine (its sharded step in a subprocess on
  forced host devices, the same initial state through the checkpoint
  format and the same batches): dp tree (bf16_ef), ZeRO bucketed SR with
  fp8_ef and pipeline 1f1b (2 stages × 2 ranks), 2 steps each, to the
  bounds above (the pipeline's: every parameter within 2e-2·|θ| + 3·lr per
  step); the launcher under 2 ranks prints the JAX launcher's losses to
  4 decimals (the pipeline's later steps within three times the
  reference's own pipeline-vs-unpipelined gap) and its grad_norm, edq and
  update_norm within 2e-3 relative, with ``--dp 2 --zero --bucketed
  --grad-compression fp8_ef`` and with ``--pipeline-stages 2 --schedule
  1f1b``; ZeRO checkpoints cross
  between the packages bit for bit, either way, into sharded and
  single-rank states.
* Build-time validation: the JAX engine's refusals (TestEngineValidation).
"""

import hashlib
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import bucketing
from repro_torch.core.collage import CollageAdamW
from repro_torch.core.precision import BucketPolicy, PrecisionPolicy, Strategy
from repro_torch.data.synthetic import make_batch_fn
from repro_torch.distributed import collectives as coll
from repro_torch.models.model import build_model
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train import sharded, train_loop

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMPS = ("none", "bf16_ef", "fp8_ef")


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


def _spawn_ranks(code: str, n: int, tmp, timeout: float):
    store = os.path.join(tmp, f"store_{n}_{os.urandom(4).hex()}")
    prelude = textwrap.dedent(f"""
        import datetime, sys, torch, torch.distributed as dist
        torch.set_num_threads(1)
        RANK, N, TMP = int(sys.argv[1]), {n}, {str(tmp)!r}
        dist.init_process_group("gloo", store=dist.FileStore({store!r}, N), rank=RANK,
                                world_size=N, timeout=datetime.timedelta(seconds=60))
    """)
    body = prelude + textwrap.dedent(code) + "\ndist.destroy_process_group()\n"
    return [subprocess.Popen([sys.executable, "-c", body, str(r)], stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True, env=_env()) for r in range(n)]


def _spawn_jax(code: str, n: int):
    return [subprocess.Popen([sys.executable, "-c", textwrap.dedent(code)],
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                             env=_env(XLA_FLAGS=f"--xla_force_host_platform_device_count={n} "
                                                + ONE_THREAD_XLA))]


def _join(procs, timeout: float) -> list:
    """Wait for every process; kill them all past ``timeout``; fail on a
    nonzero exit. Returns their standard outputs."""
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            assert p.returncode == 0, f"process failed:\nSTDOUT:\n{out}\nSTDERR:\n{err[-6000:]}"
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


_COMMON = """
import hashlib, json, os, numpy as np, torch
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import bucketing
from repro_torch.core.collage import CollageAdamW
from repro_torch.core.precision import BucketPolicy, PrecisionPolicy, Strategy
from repro_torch.data.synthetic import make_batch_fn
from repro_torch.distributed import collectives as coll, sharding as shard_lib
from repro_torch.models.model import build_model
from repro_torch.train import checkpoint as ckpt_lib, sharded, train_loop

axis = coll.Axis.of()
mesh = sharded.Mesh(dp=axis)

def mkopt(bucketed, strategy=Strategy.C_COLLAGE_PLUS, **kw):
    bp = BucketPolicy(enabled=True, pad_multiple=shard_lib.bucket_pad_multiple(axis, block=512)) \\
        if bucketed else BucketPolicy()
    return CollageAdamW(1e-3, b2=0.95, policy=PrecisionPolicy(strategy=strategy, bucketing=bp),
                        **kw)

def vec(state):
    p = state.params
    leaves = p.data if isinstance(p, bucketing.BucketedParams) else bucketing.tree_leaves(p)
    return np.concatenate([t.detach().float().reshape(-1).numpy() for t in leaves])

def err_rows(state):
    ge = state.opt_state.grad_err if isinstance(state.params, bucketing.BucketedParams) \\
        else state.grad_err
    if ge is None:
        return None
    leaves = bucketing.tree_leaves(ge)
    big = max(leaves, key=lambda t: t.numel())
    return big.float().reshape(big.shape[0], -1).numpy()

OUT = os.path.join(TMP, f"n{N}")
os.makedirs(OUT, exist_ok=True)
def dump(name, obj):
    if RANK == 0:
        if isinstance(obj, np.ndarray):
            np.save(os.path.join(OUT, name + ".npy"), obj)
        else:
            with open(os.path.join(OUT, name + ".json"), "w") as f:
                json.dump(obj, f)
"""

_BATTERY = _COMMON + """
cfg = get_config("gpt-tiny", smoke=True)
model = build_model(cfg)
bf = make_batch_fn(cfg, ShapeConfig("t", 32, 16, "train"), device="cpu")

for mode in ("tree", "zero"):
    for comp in ("none", "bf16_ef", "fp8_ef"):
        zero = mode == "zero"
        opt = mkopt(zero, compute_metrics=zero)
        step = sharded.make_sharded_train_step(model, opt, mesh, grad_compression=comp)
        sd = sharded.shard_state(sharded.init_state(model, opt, 0, mesh,
                                                         grad_compression=comp, device="cpu"),
                                      mesh, zero_shard=zero)
        ms = []
        for i in range(3):
            coll.reset_census()
            sd, m = step(sd, bf(i))
            ms.append({k: float(v) for k, v in m.items()})
        census = [(c["op"], c["role"], c["dtype"], c["numel"]) for c in coll.CENSUS]
        full = sharded.gather_state(sd, mesh, zero_shard=zero)
        dump(f"{mode}_{comp}_metrics", {"metrics": ms, "census": census})
        dump(f"{mode}_{comp}_params", vec(full))
        rows = err_rows(full)
        if rows is not None:
            dump(f"{mode}_{comp}_rows", rows)
        if mode == "zero" and comp == "fp8_ef":
            d = os.path.join(OUT, "ckpt_zero")
            ckpt_lib.save_sharded(d, 3, sd, mesh, zero_shard=True, extra={"step": 3})
            tmpl = sharded.shard_state(sharded.init_state(
                model, opt, 1, mesh, grad_compression=comp, device="cpu"), mesh, zero_shard=True)
            back, extra = ckpt_lib.restore_sharded(d, 3, tmpl, mesh, zero_shard=True)
            same = all(torch.equal(a, b) for a, b in zip(back.params.data, sd.params.data)) \\
                and all(torch.equal(a, b) for a, b in zip(back.opt_state.m, sd.opt_state.m)) \\
                and all(torch.equal(a, b) for a, b in zip(back.opt_state.grad_err,
                                                          sd.opt_state.grad_err))
            dump("ckpt_roundtrip", {"same": bool(same), "step": extra["step"]})

# make_train_step(psum_axis=) on this rank's rows ≡ the engine (no ZeRO)
# on the global batch: the same per-bucket / per-leaf reduce
def flat(tree):
    return np.concatenate([t.float().reshape(-1).numpy() for t in bucketing.tree_leaves(tree)])
for bucketed, comp in ((True, "fp8_ef"), (True, "none"), (False, "bf16_ef")):
    opt = mkopt(bucketed)
    eng = sharded.make_sharded_train_step(model, opt, mesh, grad_compression=comp,
                                          zero_shard=False)
    sd = sharded.shard_state(sharded.init_state(model, opt, 0, mesh, grad_compression=comp,
                                                device="cpu"), mesh, zero_shard=False)
    tstep = train_loop.make_train_step(model, opt, grad_compression=comp, psum_axis=axis)
    st = train_loop.init_state(model, opt, 0, comp, device="cpu")
    for i in range(3):
        sd, _ = eng(sd, bf(i))
        st, _ = tstep(st, sharded.split_batch(bf(i), mesh))
    same = np.array_equal(vec(st), vec(sd))
    if comp != "none":
        ge = (lambda s: s.opt_state.grad_err) if bucketed else (lambda s: s.grad_err)
        same = same and np.array_equal(flat(ge(st)), flat(ge(sd)))
    ok = torch.tensor([int(same)])
    dist.all_reduce(ok, op=dist.ReduceOp.MIN)
    dump(f"psum_axis_{'bucketed' if bucketed else 'tree'}_{comp}", {"same": bool(ok.item())})

# SR + ZeRO engine
opt = mkopt(True, Strategy.SR, sr_seed=3, compute_metrics=True)
step = sharded.make_sharded_train_step(model, opt, mesh, zero_shard=True)
sd = sharded.shard_state(sharded.init_state(model, opt, 0, mesh, device="cpu"), mesh,
                              zero_shard=True)
ms = []
for i in range(3):
    sd, m = step(sd, bf(i))
    ms.append({k: float(v) for k, v in m.items()})
dump("sr_zero_metrics", {"metrics": ms, "census": []})
dump("sr_zero_params", vec(sharded.gather_state(sd, mesh, zero_shard=True)))

# SR + ZeRO determinism: synthetic per-bucket gradients, each rank its shard
opt = CollageAdamW(1e-3, b2=0.95, policy=PrecisionPolicy(
    strategy=Strategy.SR, bucketing=BucketPolicy(enabled=True, pad_multiple=8192)), sr_seed=7)
st = train_loop.init_state(model, opt, 0, device="cpu")
layout = st.params.layout
loc = sharded.shard_state(st, mesh, zero_shard=True)
bp, bs = loc.params, loc.opt_state
def grad_bucket(t, i, n):
    idx = torch.arange(n, dtype=torch.int64)
    h = bucketing.lowbias32((idx * 7919 + (t * 131 + i)) & 0xFFFFFFFF)
    return ((h.double() / 4294967296.0 - 0.5).float().to(torch.bfloat16)
            * torch.tensor(1e-2, dtype=torch.bfloat16))
for t in range(10):
    k = [b.padded // N for b in layout.buckets]
    g = tuple(grad_bucket(t, i, b.padded)[RANK * k[i]:(RANK + 1) * k[i]]
              for i, b in enumerate(layout.buckets))
    bp, bs, _ = opt.step_bucketed(g, bp, bs, elem_offsets=tuple(RANK * x for x in k))
full = [coll.all_gather(d, axis) for d in bp.data]
dump("sr_sha", {"sha": hashlib.sha256(b"".join(
    d.view(torch.int16).numpy().tobytes() for d in full)).hexdigest()})

# pipeline: 2 stages per rank, 1f1b, fp8_ef
cfg4 = get_config("gpt-tiny", smoke=False)
model4 = build_model(cfg4)
bf4 = make_batch_fn(cfg4, ShapeConfig("t", 32, 16, "train"), device="cpu")
pmesh = sharded.Mesh(dp=axis, pipe=(torch.device("cpu"),) * 2)
opt = mkopt(False)
step = sharded.make_sharded_train_step(model4, opt, pmesh, pipeline_axis="pipe",
                                       schedule="1f1b", grad_compression="fp8_ef")
sd = sharded.shard_state(sharded.init_state(model4, opt, 0, pmesh, pipeline_axis="pipe",
                                                 grad_compression="fp8_ef", device="cpu"),
                              pmesh, pipeline_axis="pipe")
ms = []
for i in range(2):
    coll.reset_census()
    b = {k: v.reshape((4, 4) + tuple(v.shape[1:])) for k, v in bf4(i).items()}
    sd, m = step(sd, b)
    ms.append({k: float(v) for k, v in m.items()})
census = [(c["op"], c["role"], c["dtype"], c["numel"]) for c in coll.CENSUS]
full = sharded.gather_state(sd, pmesh, zero_shard=False, pipeline_axis="pipe")
dump("pipe_metrics", {"metrics": ms, "census": census,
                      "rows": {k: list(v.shape) for k, v in full.grad_err.items()}})
dump("pipe_params", vec(full))
dump("pipe_rows", full.grad_err["stage:bfloat16"].float().numpy())
"""


@pytest.fixture(scope="module")
def battery(tmp_path_factory):
    """{n: results dir} of the battery at 2 and 4 ranks (run together)."""
    tmp = str(tmp_path_factory.mktemp("battery"))
    procs = {n: _spawn_ranks(_BATTERY, n, tmp, 300) for n in (2, 4)}
    for n, ps in procs.items():
        _join(ps, 300)
    return {n: os.path.join(tmp, f"n{n}") for n in (2, 4)}


def _load(d, name):
    if os.path.exists(os.path.join(d, name + ".npy")):
        return np.load(os.path.join(d, name + ".npy"))
    with open(os.path.join(d, name + ".json")) as f:
        return json.load(f)


def _mkopt(bucketed, strategy=Strategy.C_COLLAGE_PLUS, pad=1024, **kw):
    bp = BucketPolicy(enabled=True, pad_multiple=pad) if bucketed else BucketPolicy()
    return CollageAdamW(1e-3, b2=0.95, policy=PrecisionPolicy(strategy=strategy, bucketing=bp),
                        **kw)


def _vec(state):
    p = state.params
    leaves = p.data if isinstance(p, bucketing.BucketedParams) else bucketing.tree_leaves(p)
    return np.concatenate([t.detach().float().reshape(-1).numpy() for t in leaves])


def _frac_close(a, b):
    return float((np.abs(a - b) <= 2e-2 * np.maximum(np.abs(a), 1e-2)).mean())


_REF: dict = {}


def _reference(key, n):
    """The single-device run each battery case is held to (cached); the
    bucket layout pads as the n-rank run's does."""
    mode, comp = key
    pad = {2: 1024, 4: 2048}[n] if mode in ("zero", "sr") else 1024
    if (key, pad) in _REF:
        return _REF[(key, pad)]
    cfg = get_config("gpt-tiny", smoke=key[0] != "pipe")
    model = build_model(cfg)
    bf = make_batch_fn(cfg, ShapeConfig("t", 32, 16, "train"), device="cpu")
    if mode == "sr":
        opt = _mkopt(True, Strategy.SR, pad=pad, sr_seed=3, compute_metrics=True)
    else:
        opt = _mkopt(mode == "zero", pad=pad, compute_metrics=mode == "zero")
    step = train_loop.make_train_step(model, opt, grad_compression=comp)
    s = train_loop.init_state(model, opt, 0, comp, device="cpu")
    ms = []
    for i in range(2 if mode == "pipe" else 3):
        b = bf(i)
        if mode == "pipe":
            b = {k: v.reshape((4, 4) + tuple(v.shape[1:])) for k, v in b.items()}
        s, m = step(s, b)
        ms.append({k: float(v) for k, v in m.items()})
    _REF[(key, pad)] = (ms, _vec(s))
    return _REF[(key, pad)]


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("comp", COMPS)
@pytest.mark.parametrize("mode", ["tree", "zero"])
def test_dp_matches_single_device(battery, mode, comp, n):
    got = _load(battery[n], f"{mode}_{comp}_metrics")["metrics"]
    ref, ref_params = _reference((mode, comp), n)
    for i, (mr, m) in enumerate(zip(ref, got)):
        assert abs(mr["loss"] - m["loss"]) < 2e-3, (i, mr["loss"], m["loss"])
        if mode == "zero":
            assert abs(mr["edq"] - m["edq"]) < 3e-2 * max(abs(mr["edq"]), 1e-2), i
    assert _frac_close(ref_params, _load(battery[n], f"{mode}_{comp}_params")) > 0.99
    if comp.endswith("_ef"):
        rows = _load(battery[n], f"{mode}_{comp}_rows")
        assert rows.shape[0] == n
        if comp == "fp8_ef":
            assert np.abs(rows).max() > 0 and not np.array_equal(rows[0], rows[1])


@pytest.mark.parametrize("n", [2, 4])
def test_census_compressed_wire_and_bucket_granularity(battery, n):
    cen = {(mode, comp): _load(battery[n], f"{mode}_{comp}_metrics")["census"]
           for mode in ("tree", "zero") for comp in COMPS}
    n_leaves = len(bucketing.tree_leaves(train_loop.init_state(
        build_model(get_config("gpt-tiny", smoke=True)), _mkopt(False), 0,
        device="cpu").params))
    grads = lambda c: [x for x in c if x[1] == "grad"]
    # tree: one gradient collective per leaf; bucketed: one per bucket
    for comp, dt in (("none", "float32"), ("bf16_ef", "bfloat16"), ("fp8_ef", "uint8")):
        g = grads(cen[("tree", comp)])
        assert len(g) == n_leaves and {x[2] for x in g} == {dt}, g
        assert {x[0] for x in g} == {"all_gather"}
        z = grads(cen[("zero", comp)])
        params = [x for x in cen[("zero", comp)] if x[1] == "param"]
        assert len(z) == len(params) >= 1
        assert {x[0] for x in z} == {"all_to_all"} and {x[2] for x in z} == {dt}, z
        assert {x[2] for x in params} == {"bfloat16"}
    amax = [x for x in cen[("zero", "fp8_ef")] if x[1] == "amax"]
    assert len(amax) == len(grads(cen[("zero", "fp8_ef")]))
    assert all(x[0] == "all_reduce_max" and x[2] == "float32" for x in amax)


@pytest.mark.parametrize("n", [2, 4])
def test_psum_axis_step_matches_sharded_engine(battery, n):
    """``make_train_step(psum_axis=)`` on each rank's rows gives the sharded
    engine's parameters and residuals bit for bit (bucketed fp8_ef and
    uncompressed, tree bf16_ef), on every rank."""
    for case in ("bucketed_fp8_ef", "bucketed_none", "tree_bf16_ef"):
        assert _load(battery[n], f"psum_axis_{case}")["same"], case


def _sr_oracle_sha():
    if "sr_sha" in _REF:
        return _REF["sr_sha"]
    model = build_model(get_config("gpt-tiny", smoke=True))
    opt = CollageAdamW(1e-3, b2=0.95, policy=PrecisionPolicy(
        strategy=Strategy.SR, bucketing=BucketPolicy(enabled=True, pad_multiple=8192)),
        sr_seed=7)
    st = train_loop.init_state(model, opt, 0, device="cpu")
    bp, bs = st.params, st.opt_state

    def grad_bucket(t, i, n):
        idx = torch.arange(n, dtype=torch.int64)
        h = bucketing.lowbias32((idx * 7919 + (t * 131 + i)) & 0xFFFFFFFF)
        return ((h.double() / 4294967296.0 - 0.5).float().to(torch.bfloat16)
                * torch.tensor(1e-2, dtype=torch.bfloat16))
    for t in range(10):
        g = tuple(grad_bucket(t, i, b.padded) for i, b in enumerate(bp.layout.buckets))
        bp, bs, _ = opt.step_bucketed(g, bp, bs)
    _REF["sr_sha"] = hashlib.sha256(b"".join(d.view(torch.int16).numpy().tobytes()
                                             for d in bp.data)).hexdigest()
    return _REF["sr_sha"]


def test_sr_zero_bit_identical_across_dp_counts(battery):
    """dp 1 (the unsharded oracle), 2 and 4 ZeRO ranks: 10 SR steps on the
    same gradients give the same bytes (the shard offset keeps the noise
    stream bucket-global)."""
    want = _sr_oracle_sha()
    assert _load(battery[2], "sr_sha")["sha"] == want
    assert _load(battery[4], "sr_sha")["sha"] == want


@pytest.mark.parametrize("n", [2, 4])
def test_sr_zero_engine_tracks_single_device(battery, n):
    got = _load(battery[n], "sr_zero_metrics")["metrics"]
    ref, ref_params = _reference(("sr", "none"), n)
    for mr, m in zip(ref, got):
        assert abs(mr["loss"] - m["loss"]) < 2e-3
    assert _frac_close(ref_params, _load(battery[n], "sr_zero_params")) > 0.99


@pytest.mark.parametrize("n", [2, 4])
def test_pipeline_dp_matches_single_device(battery, n):
    res = _load(battery[n], "pipe_metrics")
    ref, ref_params = _reference(("pipe", "fp8_ef"), n)
    for mr, m in zip(ref, res["metrics"]):
        assert abs(mr["loss"] - m["loss"]) < 2e-3
    a, b = ref_params, _load(battery[n], "pipe_params")
    assert int((np.abs(a - b) > 2e-2 * np.abs(a) + 2 * 3 * 1e-3).sum()) == 0
    # one residual row per (stage, rank) cell; one compressed gather per class
    assert res["rows"]["stage:bfloat16"][0] == 2 * n
    rows = _load(battery[n], "pipe_rows")
    assert np.abs(rows).max() > 0 and not np.array_equal(rows[0], rows[1])
    fp8 = [c for c in res["census"] if c[1] == "grad" and c[2] == "uint8"]
    assert len(fp8) == 3 and all(c[0] == "all_gather" for c in fp8), res["census"]


def test_zero_checkpoint_round_trips_through_the_ranks(battery, tmp_path):
    """save_sharded gathers, rank 0 writes; restore_sharded hands each rank
    its part back bit for bit; the same checkpoint restores into a
    single-rank state (its 2-row residuals zero-filled)."""
    assert _load(battery[2], "ckpt_roundtrip") == {"same": True, "step": 3}
    d = os.path.join(battery[2], "ckpt_zero")
    model = build_model(get_config("gpt-tiny", smoke=True))
    opt = _mkopt(True, pad=1024, compute_metrics=True)
    tmpl = train_loop.init_state(model, opt, 5, "fp8_ef", device="cpu")
    state, extra = ckpt_lib.restore_bucketed(d, 3, tmpl)
    assert extra["step"] == 3
    assert np.array_equal(_vec(state), _load(battery[2], "zero_fp8_ef_params"))
    assert all(float(r.abs().max()) == 0.0 for r in state.opt_state.grad_err)


# --------------------------------------------------------------------------
# against the JAX package's sharded engine and launcher
# --------------------------------------------------------------------------

_JAX_COMMON = """
import json, os, numpy as np, jax, jax.numpy as jnp
from repro.configs import get_config
from repro.configs.base import ShapeConfig
from repro.core.collage import CollageAdamW
from repro.core.precision import BucketPolicy, PrecisionPolicy, Strategy
from repro.data.synthetic import make_batch_fn
from repro.distributed import compression, sharding as shard_lib
from repro.models.model import build_model
from repro.train import checkpoint as ckpt_lib, sharded, train_loop
from repro.launch import train as jlaunch
T = @TMP@

def save_batches(tag, cfg, B, steps, chunk=None):
    bf = make_batch_fn(cfg, ShapeConfig("t", 32, B, "train"))
    for i in range(steps):
        for k, v in bf(i).items():
            np.save(f"{T}/{tag}_b{i}_{k}.npy", np.asarray(v))
    return bf

def vec(state):
    leaves = state.params.data if hasattr(state.params, "data") \\
        else jax.tree_util.tree_leaves(state.params)
    return np.concatenate([np.asarray(x, np.float32).ravel() for x in leaves])

def engine(tag, model, opt, mesh, bf, steps=2, chunk=None, **kw):
    zero = kw.pop("zero_shard", None)
    init_kw = {k: v for k, v in kw.items() if k in ("grad_compression", "pipeline_axis")}
    s = sharded.init_state(model, opt, jax.random.PRNGKey(0), mesh, axis="data", **init_kw)
    put_kw = {k: v for k, v in kw.items() if k == "pipeline_axis"}
    s = sharded.device_put_state(s, mesh, axis="data", zero_shard=bool(zero), **put_kw)
    ckpt_lib.save(f"{T}/{tag}_init", 0, s, extra={"step": 0})
    step = sharded.make_sharded_train_step(model, opt, mesh, axis="data", zero_shard=zero, **kw)
    ms = []
    for i in range(steps):
        b = bf(i)
        if chunk:
            b = jax.tree_util.tree_map(lambda x: x.reshape((chunk, -1) + x.shape[1:]), b)
        s, m = step(s, b)
        ms.append({k: float(v) for k, v in m.items()})
    ckpt_lib.save(f"{T}/{tag}_final", steps, s, extra={"step": steps})
    json.dump(ms, open(f"{T}/{tag}_metrics.json", "w"))
    np.save(f"{T}/{tag}_params.npy", vec(s))

def cli(tag, flags):
    hist = jlaunch.main(flags + ["--ckpt-dir", f"{T}/{tag}_run", "--log-every", "1"])
    json.dump(hist, open(f"{T}/{tag}_hist.json", "w"))
"""

_JAX_DP = _JAX_COMMON + """
mesh = jax.make_mesh((2,), ("data",))
cfg = get_config("gpt-tiny", smoke=True)
model = build_model(cfg)
bf = save_batches("dp", cfg, 16, 2)
pad = shard_lib.bucket_pad_multiple(mesh, block=compression.BLOCK)
opt = CollageAdamW(1e-3, b2=0.95, policy=PrecisionPolicy(strategy=Strategy.C_COLLAGE_PLUS))
engine("tree", model, opt, mesh, bf, grad_compression="bf16_ef")
opt = CollageAdamW(1e-3, b2=0.95, sr_seed=3, compute_metrics=True, policy=PrecisionPolicy(
    strategy=Strategy.SR, bucketing=BucketPolicy(enabled=True, pad_multiple=pad)))
engine("zero", model, opt, mesh, bf, grad_compression="fp8_ef", zero_shard=True)

# the launcher: its initial state as a step-0 checkpoint, its batches, its losses
flags = ["--arch", "gpt-tiny", "--smoke", "--steps", "3", "--seq-len", "32", "--batch", "4",
         "--bucketed", "--dp", "2", "--zero", "--grad-compression", "fp8_ef"]
cfg_c = get_config("gpt-tiny", smoke=True)
save_batches("cli_dp", cfg_c, 4, 3)
bp = BucketPolicy(enabled=True, pad_multiple=pad)
opt = CollageAdamW(jlaunch.cosine_schedule(6e-4, 20, 3), b1=0.9, b2=0.95, weight_decay=0.1,
                   policy=PrecisionPolicy(strategy=Strategy.C_COLLAGE_PLUS, bucketing=bp),
                   compute_metrics=True)
s = sharded.init_state(build_model(cfg_c), opt, jax.random.PRNGKey(0), mesh, axis="data",
                       grad_compression="fp8_ef")
ckpt_lib.save(f"{T}/cli_dp_init", 0, sharded.device_put_state(s, mesh, zero_shard=True),
              extra={"step": 0})
cli("cli_dp", flags)
# the pipeline launcher's flags without the pipeline (its gap to the
# pipelined run is the reference's own)
cli("cli_flat", ["--arch", "gpt-tiny", "--smoke", "--steps", "3", "--seq-len", "32",
                 "--batch", "8", "--dp", "2", "--microbatch", "2"])
"""

_JAX_PIPE = _JAX_COMMON + """
mesh = jax.make_mesh((2, 2), ("pipe", "data"))
cfg = get_config("gpt-tiny", smoke=True)
model = build_model(cfg)
bf = save_batches("pipe", cfg, 16, 2)
opt = CollageAdamW(1e-3, b2=0.95, compute_metrics=True,
                   policy=PrecisionPolicy(strategy=Strategy.C_COLLAGE_PLUS))
engine("pipe", model, opt, mesh, bf, chunk=4, pipeline_axis="pipe", schedule="1f1b")

flags = ["--arch", "gpt-tiny", "--smoke", "--steps", "3", "--seq-len", "32", "--batch", "8",
         "--dp", "2", "--pipeline-stages", "2", "--schedule", "1f1b", "--microbatch", "2"]
save_batches("cli_pipe", cfg, 8, 3)
opt = CollageAdamW(jlaunch.cosine_schedule(6e-4, 20, 3), b1=0.9, b2=0.95, weight_decay=0.1,
                   policy=PrecisionPolicy(strategy=Strategy.C_COLLAGE_PLUS),
                   compute_metrics=True)
s = sharded.init_state(model, opt, jax.random.PRNGKey(0), mesh, axis="data",
                       pipeline_axis="pipe")
ckpt_lib.save(f"{T}/cli_pipe_init", 0, s, extra={"step": 0})
cli("cli_pipe", flags)
"""

_PORT_E2E = _COMMON + """
from repro_torch.launch import train as tlaunch

def batches(tag, steps, chunk=None):
    out = []
    for i in range(steps):
        b = {k: torch.from_numpy(np.load(f"{TMP}/{tag}_b{i}_{k}.npy").astype(np.int64))
             for k in ("tokens", "labels")}
        if chunk:
            b = {k: v.reshape((chunk, -1) + tuple(v.shape[1:])) for k, v in b.items()}
        out.append(b)
    return out

def engine(tag, model, opt, m, steps=2, chunk=None, zero=False, **kw):
    pa = kw.get("pipeline_axis")
    init_kw = {k: v for k, v in kw.items() if k in ("grad_compression", "pipeline_axis")}
    tmpl = sharded.init_state(model, opt, 1, m, device="cpu", **init_kw)
    state, _ = ckpt_lib.restore_bucketed(f"{TMP}/{tag}_init", 0, tmpl)
    sd = sharded.shard_state(state, m, zero_shard=zero, pipeline_axis=pa)
    step = sharded.make_sharded_train_step(model, opt, m, zero_shard=zero, **kw)
    ms = []
    for b in batches("dp" if tag in ("tree", "zero") else tag, steps, chunk):
        sd, met = step(sd, b)
        ms.append({k: float(v) for k, v in met.items()})
    full = sharded.gather_state(sd, m, zero_shard=zero, pipeline_axis=pa)
    dump(f"e2e_{tag}_metrics", ms)
    dump(f"e2e_{tag}_params", vec(full))

cfg = get_config("gpt-tiny", smoke=True)
model = build_model(cfg)
opt = mkopt(False)
engine("tree", model, opt, mesh, grad_compression="bf16_ef")
opt = mkopt(True, Strategy.SR, sr_seed=3, compute_metrics=True)
engine("zero", model, opt, mesh, grad_compression="fp8_ef", zero=True)
pmesh = sharded.Mesh(dp=axis, pipe=(torch.device("cpu"),) * 2)
opt = mkopt(False, compute_metrics=True)
engine("pipe", model, opt, pmesh, chunk=4, pipeline_axis="pipe", schedule="1f1b")

# the launcher under these ranks, from the JAX launcher's initial state
os.environ["WORLD_SIZE"] = str(N)
for tag, src, flags in (
        ("cli_dp", "cli_dp", ["--bucketed", "--dp", "2", "--zero", "--grad-compression",
                              "fp8_ef", "--batch", "4"]),
        ("cli_pipe", "cli_pipe", ["--dp", "2", "--pipeline-stages", "2", "--schedule", "1f1b",
                                  "--microbatch", "2", "--batch", "8"]),
        ("cli_flat", "cli_pipe", ["--dp", "2", "--microbatch", "2", "--batch", "8"])):
    run = f"{TMP}/{tag}_port_run"
    if RANK == 0:
        import shutil
        shutil.copytree(f"{TMP}/{src}_init", run, dirs_exist_ok=True)
    dist.barrier()
    data = batches(src, 3)
    tlaunch.make_batch_fn = lambda cfg, shape, seed=0, device="cpu": (lambda i: data[i])
    hist = tlaunch.main(["--arch", "gpt-tiny", "--smoke", "--device", "cpu", "--steps", "3",
                         "--seq-len", "32", "--log-every", "1", "--resume", "--ckpt-dir", run]
                        + flags)
    dump(f"{tag}_port_hist", hist)
"""


@pytest.fixture(scope="module")
def e2e(tmp_path_factory):
    """The JAX package's engine and launcher (two subprocesses, 2 and 4
    forced host devices), then the port's on 2 gloo ranks."""
    tmp = str(tmp_path_factory.mktemp("e2e"))
    code = {n: c.replace("@TMP@", repr(tmp)) for n, c in ((2, _JAX_DP), (4, _JAX_PIPE))}
    jobs = _spawn_jax(code[2], 2) + _spawn_jax(code[4], 4)
    _join(jobs, 400)
    _join(_spawn_ranks(_PORT_E2E, 2, tmp, 300), 300)
    return tmp


def _e2e(tmp, name):
    with open(os.path.join(tmp, name)) as f:
        return json.load(f)


@pytest.mark.parametrize("tag", ["tree", "zero", "pipe"])
def test_engine_matches_jax_sharded_engine(e2e, tag):
    ref = _e2e(e2e, f"{tag}_metrics.json")
    got = _load(os.path.join(e2e, "n2"), f"e2e_{tag}_metrics")
    for i, (mr, m) in enumerate(zip(ref, got)):
        assert abs(mr["loss"] - m["loss"]) < 2e-3, (tag, i, mr["loss"], m["loss"])
        if tag in ("zero", "pipe"):
            for k in ("edq", "update_norm", "grad_norm"):
                rtol = 3e-2 if tag == "zero" else 2e-3
                assert abs(mr[k] - m[k]) <= rtol * max(abs(mr[k]), 1e-6), (tag, k, mr[k], m[k])
    a = np.load(os.path.join(e2e, f"{tag}_params.npy"))
    b = _load(os.path.join(e2e, "n2"), f"e2e_{tag}_params")
    if tag == "pipe":
        assert int((np.abs(a - b) > 2e-2 * np.abs(a) + 2 * 3 * 1e-3).sum()) == 0
    else:
        assert _frac_close(a, b) > 0.99


# The launcher against the JAX launcher (3 steps inside a 20-step warmup).
# Runs that differ only in the order bf16 gradient products are rounded
# part by up to 8.7e-5 in the loss by step 3: the reference's own pipeline
# against its unpipelined run on the same flags (Adam's first steps move an
# element by ±lr whatever its gradient's size, so the sign of a gradient
# near zero decides its update). The port's pipeline against the
# reference's adds three such gaps (its own to its unpipelined run, that
# run to the reference's, the reference's to its pipeline): the bound is
# three times the largest. The losses of these steps cannot see a wrong
# reduction (Adam is scale-invariant: a sum for a mean moves nothing); the
# metrics can, and are held to the JAX engine's pipeline bound.
LAUNCHER_PIPE_LOSS_ATOL = 3 * 8.7e-5
LAUNCHER_METRIC_RTOL = 2e-3


@pytest.mark.parametrize("tag", ["cli_dp", "cli_pipe"])
def test_launcher_losses_match_jax_launcher(e2e, tag):
    """The printed losses to 4 decimals (within 5e-5; the pipeline's after
    its first step within LAUNCHER_PIPE_LOSS_ATOL, beside the reference's
    own pipeline gap, printed), and every step's grad_norm, edq and
    update_norm within 2e-3 relative: a gradient from one rank's rows or a
    sum in place of the mean moves grad_norm by a third or more."""
    ref = _e2e(e2e, f"{tag}_hist.json")
    got = _load(os.path.join(e2e, "n2"), f"{tag}_port_hist")
    assert len(ref) == len(got) == 3
    gaps = [abs(a["loss"] - b["loss"]) for a, b in zip(got, ref)]
    if tag == "cli_pipe":
        flat = _e2e(e2e, "cli_flat_hist.json")
        flat_port = _load(os.path.join(e2e, "n2"), "cli_flat_port_hist")
        own = lambda x, y: [f"{abs(a['loss'] - b['loss']):.2e}" for a, b in zip(x, y)]
        print(f"loss gaps by step: port vs reference pipeline {[f'{g:.2e}' for g in gaps]}; "
              f"reference pipeline vs unpipelined {own(ref, flat)}; port pipeline vs "
              f"unpipelined {own(got, flat_port)}; port vs reference unpipelined "
              f"{own(flat_port, flat)}")
    assert gaps[0] < 5e-5, (got, ref)
    bound = LAUNCHER_PIPE_LOSS_ATOL if tag == "cli_pipe" else 5e-5
    assert max(gaps[1:]) < bound, (gaps, got, ref)
    for i, (m, r) in enumerate(zip(got, ref)):
        for k in ("grad_norm", "edq", "update_norm"):
            assert abs(m[k] - r[k]) <= LAUNCHER_METRIC_RTOL * abs(r[k]), (tag, i, k, m[k], r[k])


def test_zero_checkpoints_cross_between_packages(e2e, battery, tmp_path):
    """The JAX engine's ZeRO checkpoint restores into a single-rank port
    state bit for bit; the port's ZeRO checkpoint restores into the JAX
    package's dp-2 and single-device templates bit for bit."""
    import jax
    from repro.configs import get_config as jcfg
    from repro.core.collage import CollageAdamW as JAdamW
    from repro.core.precision import BucketPolicy as JBP
    from repro.core.precision import PrecisionPolicy as JPP
    from repro.core.precision import Strategy as JS
    from repro.models.model import build_model as jbuild
    from repro.train import checkpoint as jckpt
    from repro.train import train_loop as jtl

    # JAX → port (single rank)
    d = os.path.join(e2e, "zero_final")
    data = np.load(os.path.join(d, "step_00000002", "arrays.npz"))
    with open(os.path.join(d, "step_00000002", "manifest.json")) as f:
        manifest = json.load(f)
    model = build_model(get_config("gpt-tiny", smoke=True))
    opt = _mkopt(True, Strategy.SR, pad=1024, sr_seed=3)
    tmpl = train_loop.init_state(model, opt, 9, "fp8_ef", n_dp=2, device="cpu")
    state, _ = ckpt_lib.restore_bucketed(d, 2, tmpl)
    names = {}

    def grab(name, leaf):
        names[name] = leaf
        return leaf
    state.map_named(grab)
    for key, meta in manifest["arrays"].items():
        leaf = names[meta["name"]]
        arr = leaf.view(torch.int16).numpy().view(np.uint16) if isinstance(leaf, torch.Tensor) \
            and leaf.dtype == torch.bfloat16 else np.asarray(
                leaf.numpy() if isinstance(leaf, torch.Tensor) else leaf)
        assert np.array_equal(arr.reshape(data[key].shape), data[key]), meta["name"]

    # port → JAX (dp-2 rows and a single-device template)
    src = os.path.join(battery[2], "ckpt_zero")
    jmodel = jbuild(jcfg("gpt-tiny", smoke=True))
    jopt = JAdamW(1e-3, b2=0.95, policy=JPP(strategy=JS.C_COLLAGE_PLUS,
                                            bucketing=JBP(enabled=True, pad_multiple=1024)))
    port_params = _load(battery[2], "zero_fp8_ef_params")
    for n_dp in (2, None):
        jt = jtl.init_state(jmodel, jopt, jax.random.PRNGKey(1), "fp8_ef", n_dp=n_dp)
        js, extra = jckpt.restore_bucketed(src, 3, jt)
        assert extra["step"] == 3
        vec = np.concatenate([np.asarray(x, np.float32).ravel() for x in js.params.data])
        assert np.array_equal(vec, port_params)
        rows = np.asarray(js.opt_state.grad_err[0], np.float32)
        if n_dp == 2:
            assert np.array_equal(rows, _load(battery[2], "zero_fp8_ef_rows"))
        else:
            assert rows.shape[0] == 1 and not rows.any()


# --------------------------------------------------------------------------
# build-time validation (TestEngineValidation)
# --------------------------------------------------------------------------

def _model_opt(bucketed=True):
    model = build_model(get_config("gpt-tiny", smoke=True))
    opt = CollageAdamW(1e-3, policy=PrecisionPolicy(
        strategy=Strategy.SR if bucketed == "sr" else Strategy.C_COLLAGE_PLUS,
        bucketing=BucketPolicy(enabled=bool(bucketed))))
    return model, opt


def test_zero_requires_bucketed():
    model, opt = _model_opt(bucketed=False)
    with pytest.raises(ValueError, match="bucketed"):
        sharded.make_sharded_train_step(model, opt, sharded.Mesh(), zero_shard=True)


def test_sr_zero_builds():
    model, opt = _model_opt(bucketed="sr")
    assert callable(sharded.make_sharded_train_step(model, opt, sharded.Mesh(),
                                                    zero_shard=True))


def test_pipeline_rejects_buckets_and_accepts_compression():
    mesh = sharded.Mesh(pipe=(torch.device("cpu"),))
    model, opt = _model_opt(bucketed=True)
    with pytest.raises(ValueError, match="tree layout"):
        sharded.make_sharded_train_step(model, opt, mesh, pipeline_axis="pipe")
    model, opt = _model_opt(bucketed=False)
    assert callable(sharded.make_sharded_train_step(model, opt, mesh, pipeline_axis="pipe",
                                                    grad_compression="bf16_ef"))
    opt.use_fused_kernel = True
    with pytest.raises(ValueError, match="use_fused_kernel"):
        sharded.make_sharded_train_step(model, opt, mesh, pipeline_axis="pipe")
    with pytest.raises(ValueError, match="Mesh.pipe"):
        sharded.make_sharded_train_step(model, opt, sharded.Mesh(), pipeline_axis="pipe")


def test_schedule_build_time_validation():
    mesh = sharded.Mesh(pipe=(torch.device("cpu"),))
    model, opt = _model_opt(bucketed=False)
    with pytest.raises(ValueError, match="unknown schedule"):
        sharded.make_sharded_train_step(model, opt, mesh, pipeline_axis="pipe",
                                        schedule="zb-h1")
    with pytest.raises(ValueError, match="interleaved"):
        sharded.make_sharded_train_step(model, opt, mesh, pipeline_axis="pipe",
                                        schedule="1f1b", virtual_stages=2)
    with pytest.raises(ValueError, match="virtual_stages>=2"):
        sharded.make_sharded_train_step(model, opt, mesh, pipeline_axis="pipe",
                                        schedule="interleaved")
    with pytest.raises(ValueError, match="pipeline_axis"):
        sharded.make_sharded_train_step(model, opt, sharded.Mesh(), schedule="1f1b")
    with pytest.raises(ValueError, match="not divisible"):
        sharded.make_sharded_train_step(model, opt, sharded.Mesh(pipe=(torch.device("cpu"),) * 4),
                                        pipeline_axis="pipe")
    enc = build_model(get_config("seamless-m4t-medium", smoke=True))
    with pytest.raises(ValueError, match="decoder-only"):
        sharded.make_sharded_train_step(enc, opt, mesh, pipeline_axis="pipe")


def test_fp8_zero_requires_block_aligned_pad():
    model = build_model(get_config("gpt-tiny", smoke=True))
    opt = CollageAdamW(1e-3, policy=PrecisionPolicy(
        strategy=Strategy.C_COLLAGE_PLUS, bucketing=BucketPolicy(enabled=True, pad_multiple=128)))
    with pytest.raises(ValueError, match="pad_multiple"):
        sharded.make_sharded_train_step(model, opt, sharded.Mesh(), grad_compression="fp8_ef",
                                        zero_shard=True)


def test_tree_ef_engine_on_one_rank():
    """One rank: the tree-layout residuals keep their leading rank dim and
    the step runs."""
    cfg = get_config("gpt-tiny", smoke=True)
    model = build_model(cfg)
    opt = CollageAdamW(1e-3, policy=PrecisionPolicy(strategy=Strategy.C_COLLAGE_PLUS))
    mesh = sharded.Mesh()
    state = sharded.init_state(model, opt, 0, mesh, grad_compression="bf16_ef", device="cpu")
    assert bucketing.tree_leaves(state.grad_err)[0].shape[0] == 1
    step = sharded.make_sharded_train_step(model, opt, mesh, grad_compression="bf16_ef")
    state, m = step(sharded.shard_state(state, mesh),
                    make_batch_fn(cfg, ShapeConfig("t", 32, 4, "train"), device="cpu")(0))
    assert np.isfinite(float(m["loss"]))


def test_step_bucketed_threads_grad_err():
    model, opt = _model_opt(bucketed=True)
    state = train_loop.init_state(model, opt, 0, "bf16_ef", device="cpu")
    assert state.grad_err is None and state.opt_state.grad_err is not None
    _, new_s, _ = opt.step_bucketed(tuple(torch.zeros_like(d) for d in state.params.data),
                                    state.params, state.opt_state)
    assert all(a is b for a, b in zip(new_s.grad_err, state.opt_state.grad_err))


def test_single_rank_zero_is_bit_identical_to_the_unsharded_step():
    """One rank, ZeRO forced on (the default is off at one rank, as in the
    JAX engine): the sharded step equals the single-program step bit for
    bit, bf16_ef and fp8_ef (one payload summed, headroom 1)."""
    cfg = get_config("gpt-tiny", smoke=True)
    model = build_model(cfg)
    bf = make_batch_fn(cfg, ShapeConfig("t", 32, 4, "train"), device="cpu")
    for comp in ("bf16_ef", "fp8_ef"):
        opt = _mkopt(True, compute_metrics=True)
        ref = train_loop.make_train_step(model, opt, grad_compression=comp)
        s = train_loop.init_state(model, opt, 0, comp, device="cpu")
        mesh = sharded.Mesh()
        step = sharded.make_sharded_train_step(model, opt, mesh, grad_compression=comp,
                                               zero_shard=True)
        sd = sharded.shard_state(sharded.init_state(model, opt, 0, mesh,
                                                         grad_compression=comp, device="cpu"),
                                      mesh, zero_shard=True)
        for i in range(2):
            s, mr = ref(s, bf(i))
            sd, m = step(sd, bf(i))
            assert all(float(mr[k]) == float(m[k]) for k in ("loss", "edq", "grad_norm"))
        assert all(torch.equal(a, b) for a, b in zip(s.params.data, sd.params.data))
        assert all(torch.equal(a, b) for a, b in zip(s.opt_state.grad_err,
                                                     sd.opt_state.grad_err))


def test_bucket_close_ranks_and_readiness_order_match_reference():
    """Per-bucket readiness over a layout of several buckets (a size cap),
    from leaf ranks in backward order and in random orders."""
    import jax
    from repro.configs import get_config as jcfg
    from repro.core import bucketing as jb
    from repro.models.model import build_model as jbuild
    jparams = jbuild(jcfg("gpt-tiny", smoke=False)).init(jax.random.PRNGKey(0))
    jlayout = jb.build_layout(jparams, max_bucket_elems=200_000)
    tparams = bucketing.tree_unflatten(*train_loop._detached(
        train_loop.param_dict(build_model(get_config("gpt-tiny", smoke=False))
                              .init(0, device="cpu"))))
    tlayout = bucketing.build_layout(tparams, max_bucket_elems=200_000)
    assert tlayout.to_json() == jlayout.to_json() and tlayout.n_buckets >= 3
    n = len(tlayout.slots)
    rng = np.random.RandomState(0)
    for ranks in [list(range(n))[::-1], *[list(rng.randint(0, 50, n)) for _ in range(5)]]:
        assert bucketing.bucket_close_ranks(tlayout, ranks) == \
            jb.bucket_close_ranks(jlayout, ranks)
        assert bucketing.readiness_order(tlayout, ranks) == jb.readiness_order(jlayout, ranks)
    with pytest.raises(ValueError, match="leaves"):
        bucketing.bucket_close_ranks(tlayout, [0])

"""The JAX package's production train cell on the port's FSDP × TP grid
(``train.grid``: per-layer FSDP gathers, remat, gradient accumulation,
the compressed round trip and the frontend families) on a (2, 2) grid of
gloo ranks, against the JAX package's single-device step and the port's
one-rank step. tests/test_torch_gspmd_cells_more.py holds the rest of the
cell (the bucketed layout with donation and without FSDP, the gathered
bytes a rank keeps, serving the frontends, F6) with this file's cases and
helpers.

As in tests/test_torch_gspmd_families.py (whose process helpers these
files share), the ranks are spawned once for the module and meet through a
FileStore under ``tmp_path``; rank 0 writes what the grid computed
(gathered with ``gather_block``) and the port's one-rank results; the JAX
references run meanwhile in processes of their own, jitted with
``--xla_allow_excess_precision=false``:

* training, tree C, with the dryrun cell's flags (``remat`` "full" and
  "dots", ``microbatch`` rows of the global batch or a pre-chunked (n, mb,
  L) batch, ``grad_compression`` bf16_ef / fp8_ef, sequence parallelism)
  on granite (dense), qwen3-moe (capacity per microbatch over its global
  rows), jamba (Mamba's gathered ``in_proj`` in the recompute), rwkv6 and
  the frontends (seamless-m4t's encoder and cross-attention; internvl2's
  patch prefix, at an odd vocab of 255 so that the embedding stays whole
  over "model" and the tied head is not vocab-parallel, as the full
  config's 151,655): against the jitted JAX step with the same flags, in
  f32 the loss and metrics within 1e-4 and the parameters as
  tests/test_torch_gspmd_families.py holds them (99.9 % within 1e-4, all
  within 2·lr: Adam's first step on gradients near eps, a divergence by
  design shown by tests/test_torch_gspmd_cells_more.py's F6 test), and the
  metrics within 1e-5 of the port's one-rank step with the same flags; in
  bf16 at the reference test's rule (loss within 2e-2, ≥ 99 % of the
  parameters within 2e-2·max(|θ|, 1)) with the metrics within 2e-3, to
  the JAX step and to the port's one-rank step;
* the fp8 (e4m3, e5m2) and bf16 round trips on a rank's blocks
  (``compression.compress_blocks``) bit-identical, values and residuals,
  to the one-rank round trip of the whole leaves.
"""

import dataclasses
import os
import pickle

import numpy as np
import pytest
import torch

import test_torch_gspmd as G
from test_torch_gspmd_families import BF16_METRIC_RTOL, F32_JAX_METRIC_RTOL, _hold
from repro_torch.configs import get_config

B, L = 8, 32                  # train batch
SB, PROMPT, CACHE, GEN = 4, 16, 48, 8   # serving
GRANITE, QWEN, RWKV, JAMBA = ("granite-3-2b", "qwen3-moe-30b-a3b", "rwkv6-1.6b",
                              "jamba-1.5-large-398b")
SEAMLESS, VLM = "seamless-m4t-medium", "internvl2-1b"
VLM_ODD = {"vocab_size": 255}     # the embedding whole over "model" (151,655 at full size)

# name: (arch, dtype, config overrides, step flags); "chunks": a pre-chunked batch
TRAIN = {
    "granite_f32_full": (GRANITE, "float32", {}, {"remat": "full"}),
    "granite_f32_dots": (GRANITE, "float32", {}, {"remat": "dots"}),
    "granite_bf16_cell": (GRANITE, "bfloat16", {},
                          {"remat": "full", "microbatch": 2, "grad_compression": "bf16_ef"}),
    "granite_f32_fp8_chunked": (GRANITE, "float32", {}, {"grad_compression": "fp8_ef",
                                                         "chunks": 2}),
    "qwen3_f32_accum": (QWEN, "float32", {}, {"remat": "full", "microbatch": 4}),
    "jamba_f32_cell": (JAMBA, "float32", {},
                       {"remat": "full", "microbatch": 4, "grad_compression": "fp8_ef"}),
    "rwkv6_f32_dots": (RWKV, "float32", {}, {"remat": "dots", "grad_compression": "bf16_ef"}),
    "seamless_f32": (SEAMLESS, "float32", {}, {}),
    "seamless_f32_cell": (SEAMLESS, "float32", {}, {"remat": "full", "microbatch": 2,
                                                    "grad_compression": "fp8_ef", "sp": True}),
    "seamless_bf16": (SEAMLESS, "bfloat16", {}, {"remat": "full"}),
    "internvl2_f32": (VLM, "float32", VLM_ODD, {}),
    "internvl2_f32_cell": (VLM, "float32", VLM_ODD, {"remat": "dots", "chunks": 2,
                                                     "grad_compression": "bf16_ef", "sp": True}),
    "internvl2_bf16": (VLM, "bfloat16", VLM_ODD, {"remat": "full"}),
}
# name: (strategy, step flags), granite bf16 bucketed with the fused update
BUCKETED = {
    "bucketed_fp8_donate": ("C", {"grad_compression": "fp8_ef", "microbatch": 2,
                                  "donate": True}),
    "bucketed_nofsdp": ("C", {"fsdp": False, "grad_compression": "bf16_ef", "remat": "full"}),
    "bucketed_nofsdp_sr": ("SR", {"fsdp": False}),
}
ROUND_TRIPS = [("float32", "fp8_ef"), ("bfloat16", "fp8_ef"), ("float32", "fp8e5_ef"),
               ("bfloat16", "bf16_ef")]
# the per-layer gathers' live bytes: (arch, config overrides), f32
LIVE = {"granite": (GRANITE, {"n_layers": 6}), "qwen3": (QWEN, {"n_layers": 6}),
        "rwkv6": (RWKV, {"n_layers": 6}), "seamless": (SEAMLESS, {"n_layers": 4,
                                                                  "n_enc_layers": 4})}
REMATS = ("none", "full", "dots")
SERVE = {"seamless": (SEAMLESS, {}), "internvl2": (VLM, VLM_ODD)}
F6_ARCHS = (RWKV, JAMBA)
# F6: the port's own f32 step parts from the JAX one by more than 1e-4 only
# at elements whose gradient is below this (Adam's eps is 1e-8)
F6_GRAD_NEAR_EPS = 1e-6


def _cfg(arch, dtype, overrides=None):
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype=dtype)
    return dataclasses.replace(cfg, **(overrides or {}))


def _step_kw(flags) -> dict:
    """make_train_step's keywords of a case's flags."""
    return {k: v for k, v in flags.items() if k in ("remat", "microbatch", "grad_compression")}


_PRELUDE = """
import dataclasses, datetime, pickle, sys, weakref, torch, torch.distributed as dist
torch.set_num_threads(1)
RANK, TESTS, STORE = int(sys.argv[1]), sys.argv[2], sys.argv[3]
sys.path.insert(0, TESTS)
from repro_torch.core import bucketing
from repro_torch.core.collage import CollageAdamW
from repro_torch.core.precision import BucketPolicy, PrecisionPolicy, parse_strategy
from repro_torch.distributed import collectives as coll, compression, sharding as sh
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import transformer as tf
from repro_torch.models.model import build_model
from repro_torch.train import grid as grid_lib, train_loop
import test_torch_gspmd_cells as T

inp = pickle.load(open("inputs.pkl", "rb"))
dist.init_process_group("gloo", store=dist.FileStore(STORE, 4), rank=RANK, world_size=4,
                        timeout=datetime.timedelta(seconds=240))
g = mesh_lib.make_mesh(2, 2, device="cpu")
out = {}

def np_(x):
    return x.detach().float().numpy()

def leaves(tree):
    return [np_(x) for _, x in sh.named_leaves(tree)]

def bucket_leaves(p):
    return [np_(x) for x in bucketing.unbucket_leaves(p.data, p.layout)]

def opt_of(dtype, strategy="C", bucketed=False, pad=None):
    pdt = torch.float32 if dtype == "float32" else torch.bfloat16
    bp = BucketPolicy(enabled=bucketed) if pad is None else BucketPolicy(enabled=True,
                                                                        pad_multiple=pad)
    return CollageAdamW(1e-3, b2=0.95, compute_metrics=True, sr_seed=3, use_fused_kernel=bucketed,
                        policy=PrecisionPolicy(strategy=parse_strategy(strategy), param_dtype=pdt,
                                               bucketing=bp))

def batch_of(name, dtype, flags):
    b = dict(inp["batch"][name])
    if "chunks" in flags:
        n = flags["chunks"]
        b = {k: v.reshape((n, v.shape[0] // n) + tuple(v.shape[1:])) for k, v in b.items()}
    return b

def tree_state(params, opt, comp):
    _, use_ef = compression.parse_spec(comp)
    err = compression.init_error_state(params, compression.parse_spec(comp)[0]) if use_ef else None
    return train_loop.TrainState(params, opt.init(params), err)
"""

_RANKS = _PRELUDE + """
# training, tree C, with the cell's flags
for name, (arch, dtype, over, flags) in T.TRAIN.items():
    model = build_model(T._cfg(arch, dtype, over))
    opt = opt_of(dtype)
    kw = T._step_kw(flags)
    state = tree_state(inp["params"][name], opt, kw.get("grad_compression", "none"))
    step = grid_lib.make_grid_train_step(model, opt, g, sp=flags.get("sp", False), **kw)
    batch = batch_of(name, dtype, flags)
    coll.reset_census()
    new, m = step(grid_lib.shard_state(state, g), batch)
    full = grid_lib.gather_state(new, state, g)
    out[name] = {"metrics": {k: float(v) for k, v in m.items()}, "params": leaves(full.params),
                 "roles": sorted({c["role"] for c in coll.CENSUS})}
    if RANK == 0:
        s1, m1 = train_loop.make_train_step(model, opt, **kw)(state, batch)
        out[name]["one_rank"] = {"metrics": {k: float(v) for k, v in m1.items()},
                                 "params": leaves(s1.params)}

# the round trip on blocks against the one-rank round trip of the whole leaves
for dtype, comp in T.ROUND_TRIPS:
    cdt, _ = compression.parse_spec(comp)
    grads, errs = inp["round_trip"][dtype]
    specs = sh.state_shardings(grads, g)
    blocks = [(tuple(x.shape), tuple(b.start for b in sh.block_slices(x.shape, s, g)))
              if any(s) else None for (_, x), (_, s) in zip(sh.named_leaves(grads),
                                                            sh.named_leaves(specs))]
    q1, e1 = compression.compress_tree(grads, errs, cdt)
    coll.reset_census()
    qb, eb = compression.compress_blocks(sh.local_tree(grads, specs, g),
                                         sh.local_tree(errs, specs, g), cdt, blocks,
                                         g.axis("world"))
    ops = sorted({c["op"] for c in coll.CENSUS})
    qg, eg = sh.gather_tree(qb, specs, g), sh.gather_tree(eb, specs, g)
    bits = lambda x: x.view(torch.int16 if x.element_size() == 2 else torch.int32)
    same = [a.dtype == b.dtype and torch.equal(bits(a), bits(b))
            for (_, a), (_, b) in zip(sh.named_leaves((q1, e1)), sh.named_leaves((qg, eg)))]
    split = sum(1 for b in blocks if b is not None)
    out[f"round_trip_{dtype}_{comp}"] = {"same": same, "split_leaves": split, "ops": ops,
                                         "residual_nonzero": any(bool((e != 0).any())
                                                                 for _, e in sh.named_leaves(e1))}

if RANK == 0:
    pickle.dump(out, open("out.pkl", "wb"))
dist.destroy_process_group()
"""


# The JAX references, each in a process of its own that imports JAX and the
# JAX package only (not torch): inputs_np.pkl holds the inputs as numpy.
_JAX = """
import dataclasses, os, pickle, sys
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_allow_excess_precision=false").strip()
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_config
from repro.core.collage import CollageAdamW
from repro.core.precision import PrecisionPolicy, Strategy
from repro.distributed import compression
from repro.models.model import build_model
from repro.train import train_loop

inp = pickle.load(open("inputs_np.pkl", "rb"))
what, args = sys.argv[1], sys.argv[2:]

def model_of(arch, dtype, over=None):
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype=dtype, **(over or {}))
    return build_model(cfg)

def as_jax(tree, dtype):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.dtype(dtype)), tree)

def opt_of(dtype):
    return CollageAdamW(1e-3, b2=0.95, compute_metrics=True,
                        policy=PrecisionPolicy(strategy=Strategy.C_COLLAGE_PLUS,
                                               param_dtype=jnp.dtype(dtype)))

out = {}
if what == "train":                 # one step of the single-device train step a case
    for name in args:
        arch, dtype, over, flags = inp["train"][name]
        opt, params = opt_of(dtype), as_jax(inp["params"][name], dtype)
        comp = flags.get("grad_compression", "none")
        cdt, use_ef = compression.parse_spec(comp)
        err = compression.init_error_state(params, cdt) if use_ef else None
        state = train_loop.TrainState(params, opt.init(params), err)
        batch = {k: (jnp.asarray(v, jnp.dtype(dtype)) if k == "frontend" else
                     jnp.asarray(v, jnp.int32)) for k, v in inp["batch"][name].items()}
        if "chunks" in flags:
            n = flags["chunks"]
            batch = {k: v.reshape((n, v.shape[0] // n) + v.shape[1:]) for k, v in batch.items()}
        step = train_loop.make_train_step(
            model_of(arch, dtype, over), opt, remat=flags.get("remat", "none"),
            microbatch=flags.get("microbatch", 0), grad_compression=comp)
        s2, m = jax.jit(step)(state, batch)
        out[name] = {"metrics": {k: float(v) for k, v in m.items()},
                     "params": [np.asarray(x, np.float32)
                                for x in jax.tree_util.tree_leaves(s2.params)]}
else:                               # F6: the f32 gradient, and the update run op by op on it
    for arch in args:
        model, opt = model_of(arch, "float32"), opt_of("float32")
        params = as_jax(inp["params"]["f6_" + arch], "float32")
        toks = jnp.asarray(inp["batch"]["f6_" + arch]["tokens"], jnp.int32)
        _, _, grads = jax.jit(train_loop.make_accum_grads(model))(
            params, {"tokens": toks, "labels": toks})
        new, _, _ = opt.step(grads, params, opt.init(params))
        out["f6_" + arch] = {"grads": [np.asarray(x) for x in jax.tree_util.tree_leaves(grads)],
                             "params": [np.asarray(x) for x in jax.tree_util.tree_leaves(new)]}
pickle.dump(out, open(f"jax_{what}_{args[0]}.pkl", "wb"))
"""
# the train references in four processes
JAX_REFS = [("train", "granite_f32_full", "granite_f32_dots", "granite_bf16_cell",
             "granite_f32_fp8_chunked"),
            ("train", "qwen3_f32_accum", "rwkv6_f32_dots", "internvl2_f32", "internvl2_bf16"),
            ("train", "jamba_f32_cell", "internvl2_f32_cell"),
            ("train", "seamless_f32", "seamless_f32_cell", "seamless_bf16")]


def _numpy_batch(cfg, rng, rows, length) -> dict:
    """Tokens (and, for a frontend arch, frames or patches N(0, 0.1²) in the
    model dtype) from numpy."""
    import ml_dtypes

    toks = rng.integers(0, cfg.vocab_size, (rows, length))
    b = {"tokens": toks, "labels": toks}
    if cfg.is_encdec or cfg.family == "vlm":
        fe = (rng.standard_normal((rows, cfg.frontend_len, cfg.d_model)) * 0.1).astype(np.float32)
        b["frontend"] = fe.astype(ml_dtypes.bfloat16) if cfg.dtype == "bfloat16" else fe
    return b


def _inputs(cfgs: dict, serve: dict = None, round_trip: bool = False):
    """(the inputs as numpy, for the JAX processes; the same as torch
    tensors, for the ranks), from numpy (seed 0): weights and a (B, L)
    batch for each config of ``cfgs``; weights and a (SB, PROMPT) prompt
    batch for each serving case of ``serve`` ({name: (arch, overrides)}, in
    bf16 and f32); with ``round_trip``, gradients whose rows span 1e-6 to
    1e2 and residuals of granite's leaves in f32 and bf16."""
    from repro_torch.convert import params_from_numpy
    from repro_torch.distributed.sharding import map_leaves
    from repro_torch.models.model import build_model, param_dict

    rng = np.random.default_rng(0)
    cfgs = dict(cfgs)
    np_params, np_batch, np_serve = {}, {}, {}
    for name, cfg in list(cfgs.items()):
        np_params[name] = G._numpy_params_of(cfg, rng)
        np_batch[name] = _numpy_batch(cfg, rng, B, L)
    for sname, (arch, over) in (serve or {}).items():
        for dtype in ("bfloat16", "float32"):
            key = f"serve_{sname}_{dtype}"
            cfgs[key] = _cfg(arch, dtype, over)
            np_params[key] = G._numpy_params_of(cfgs[key], rng)
            np_serve[key] = {k: v for k, v in _numpy_batch(cfgs[key], rng, SB, PROMPT).items()
                             if k != "labels"}
    trips = {}
    for dtype in ("float32", "bfloat16") if round_trip else ():
        shapes = param_dict(build_model(_cfg(GRANITE, dtype)).init(device="meta"))

        def draw(path, x):
            shape = tuple(x.shape)
            a = rng.standard_normal(shape) * 10.0 ** rng.uniform(-6, 2, shape[:1] + (1,) *
                                                                 (len(shape) - 1))
            return torch.tensor(a.astype(np.float32)).to(getattr(torch, dtype))
        grads = map_leaves(draw, shapes)
        errs = map_leaves(lambda path, x: torch.tensor(
            (rng.standard_normal(tuple(x.shape)) * 1e-3).astype(np.float32)), shapes)
        trips[dtype] = (grads, errs)
    next_tok = rng.integers(0, 255, (SB, 1))

    def batch_torch(b, dtype):
        return {k: (torch.tensor(np.asarray(v, np.float32)).to(getattr(torch, dtype))
                    if k == "frontend" else torch.tensor(v)) for k, v in b.items()}
    params = {name: map_leaves(lambda path, x: x.detach().clone(), param_dict(
        params_from_numpy(np_params[name], cfg, device="cpu"))) for name, cfg in cfgs.items()}
    return ({"params": np_params, "batch": np_batch, "train": TRAIN},
            {"params": params, "round_trip": trips, "next_tok": torch.tensor(next_tok),
             "batch": {name: batch_torch(b, cfgs[name].dtype) for name, b in np_batch.items()},
             "serve": {name: batch_torch(b, cfgs[name].dtype) for name, b in np_serve.items()}})


def _run(tmp_path_factory, label, ranks, jax_refs, inputs):
    """(rank 0's results, the JAX references): the four ranks running
    ``ranks`` and each JAX reference of ``jax_refs`` run as processes of
    their own, all at once, on ``inputs`` (``_inputs``' pair)."""
    tmp = str(tmp_path_factory.mktemp(label))
    tests = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(tmp, "inputs.pkl"), "wb") as f:
        pickle.dump(inputs[1], f)
    with open(os.path.join(tmp, "inputs_np.pkl"), "wb") as f:
        pickle.dump(inputs[0], f)
    procs = [G._spawn(_JAX, args, tmp) for args in jax_refs]
    procs += [G._spawn(ranks, [r, tests, os.path.join(tmp, "store")], tmp) for r in range(4)]
    try:
        for p in procs:
            out, err = p.communicate(timeout=400)
            assert p.returncode == 0, f"process failed:\n{out}\n{err[-6000:]}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    refs = {}
    for args in jax_refs:
        with open(os.path.join(tmp, f"jax_{args[0]}_{args[1]}.pkl"), "rb") as f:
            refs.update(pickle.load(f))
    with open(os.path.join(tmp, "out.pkl"), "rb") as f:
        return pickle.load(f), refs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(what the grid computed, the JAX references)."""
    inputs = _inputs({name: _cfg(a, d, o) for name, (a, d, o, _) in TRAIN.items()},
                     round_trip=True)
    return _run(tmp_path_factory, "gspmd_cells", _RANKS, JAX_REFS, inputs)


@pytest.mark.parametrize("name", list(TRAIN))
def test_cell_step_matches_single_device(runs, name):
    """The grid step with the cell's flags against the jitted JAX step with
    the same flags, and in f32 against the port's one-rank step (metrics
    within 1e-5; the f32 residuals ``grad_err`` bit-identical to its)."""
    got, refs = runs
    arch, dtype, _, flags = TRAIN[name]
    _hold(got[name], refs[name], dtype, F32_JAX_METRIC_RTOL)
    if dtype == "float32":
        gm, wm = got[name]["metrics"], got[name]["one_rank"]["metrics"]
        for k in ("loss", "aux", "edq", "update_norm", "grad_norm", "imprecision_pct"):
            np.testing.assert_allclose(gm[k], wm[k], rtol=1e-5, atol=1e-7, err_msg=k)
    else:
        _hold(got[name], got[name]["one_rank"], dtype, BF16_METRIC_RTOL)
    roles = set(got[name]["roles"])
    assert {"fsdp_gather", "fsdp_scatter", "tp_reduce"} <= roles
    if flags.get("sp"):
        assert {"sp_gather", "sp_scatter"} <= roles
    if flags.get("grad_compression", "").startswith("fp8"):
        assert "amax" in roles                    # the blocks' amax over the ranks

@pytest.mark.parametrize("dtype,comp", ROUND_TRIPS)
def test_round_trip_on_blocks_bit_identical(runs, dtype, comp):
    """``compress_blocks`` on the ranks' blocks ≡ ``compress_tree`` on the
    whole leaves: values in the leaf dtype and f32/bf16 residuals, bit for
    bit; fp8 takes one MAX all-reduce of the blocks' amax, bf16 none."""
    r = runs[0][f"round_trip_{dtype}_{comp}"]
    assert r["split_leaves"] > 5 and r["residual_nonzero"]
    assert all(r["same"]), [i for i, s in enumerate(r["same"]) if not s]
    assert r["ops"] == (["all_reduce_max"] if comp.startswith("fp8") else [])

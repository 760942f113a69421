"""The port's FSDP × TP grid for the MoE and recurrent families and the
bucketed layout (distributed.sharding, train.grid, models.moe / ssm /
rwkv) on a (2, 2) grid of gloo ranks, against the JAX package's
single-device functions.

As in tests/test_torch_gspmd.py (whose numpy weights and process helpers
this file shares), the ranks are spawned once for the module and meet
through a FileStore under ``tmp_path``; rank 0 writes what the grid
computed (gathered with ``gather_block``), and the tests hold it to the JAX
functions, computed meanwhile in processes of their own:

* training, tree C: qwen3-moe and moonshot (expert parallelism, capacity
  over the global batch), qwen3-moe with ``moe_group_size`` 64 (rank-local
  dispatch groups, the aux loss the mean over every rank's groups), rwkv6
  (heads over "model", channel-mix's gathered ``wv``) and jamba (Mamba
  channels over "model" with the gathered ``in_proj``, NoPE attention, MoE):
  in f32 against the jitted JAX train step: the loss and metrics within
  1e-4, 99.9 % of the parameters within 1e-4 and all within 2·lr (see
  ``F32_JAX_METRIC_RTOL``), and the metrics against the port's one-rank
  step within 1e-5 relative (a leaf or an aux term counted twice would
  show there); in bf16 against the JAX step jitted with every operation
  rounding on its own, as the port's do (XLA's
  ``--xla_allow_excess_precision=false``: by default the jitted step
  keeps f32 inside its fusions and reads rwkv6's grad_norm 16 % lower;
  so it reads what the step run op by op reads) at
  the reference test's rule (loss within 2e-2 relative, ≥ 99 % of the
  parameters within 2e-2·max(|θ|, 1)) with the metrics within 2e-3;
* MoE routing (qwen3-moe, f32, capacity factor 1 so that slots drop): the
  routes, positions, kept mask and capacity of every rank's rows equal the
  one-rank ``moe.record()`` over the global batch, the aux loss and logits
  within 1e-6; the same forward with its capacity taken per rank differs
  (the test has teeth);
* serving, qwen3-moe (also at capacity factor 1, where a decode step
  drops slots), rwkv6 and jamba: prefill and ``decode_step`` logits
  against the JAX functions (3e-2 in bf16, jitted as the train step is,
  where excess precision flips bf16 routes; 1e-5 in f32), greedy
  ``generate`` tokens equal to the JAX ones in f32; and qwen3-moe served a
  batch of 3 on dp 2 (rows replicated over dp) against the port's one-rank
  model; a MoE forward whose rows' split over dp is unknown raises;
* the bucketed layout, granite bf16, fused C and SR (the update's plain
  version here): the buckets sharded over dp and replicated over "model",
  the update bit-identical to the one-rank bucketed update of the same
  gradients, the loss and parameters against the one-rank bucketed step at
  the bf16 rule with the metrics within 2e-3;
* a ``moe_group_size`` whose groups straddle the dp ranks raises before the
  step computes anything, naming the roadmap item.
"""

import dataclasses
import os
import pickle

import numpy as np
import pytest
import torch

import test_torch_gspmd as G
from repro_torch.configs import get_config
from repro_torch.core.collage import CollageAdamW
from repro_torch.core.precision import BucketPolicy, PrecisionPolicy, Strategy
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models.model import build_model
from repro_torch.train import grid as grid_lib
from repro_torch.train import train_loop

B, L = 8, 32                  # train batch
SB, PROMPT, CACHE, GEN = 4, 16, 32, 8   # serving
QWEN, MOON, RWKV, JAMBA = ("qwen3-moe-30b-a3b", "moonshot-v1-16b-a3b", "rwkv6-1.6b",
                           "jamba-1.5-large-398b")

# name: (arch, dtype, config overrides), one tree-C train step each
TRAIN = {
    "qwen3_f32": (QWEN, "float32", {}),
    "qwen3_bf16": (QWEN, "bfloat16", {}),
    "qwen3_f32_groups": (QWEN, "float32", {"moe_group_size": 64}),
    "moonshot_f32": (MOON, "float32", {}),
    "moonshot_bf16": (MOON, "bfloat16", {}),
    "rwkv6_f32": (RWKV, "float32", {}),
    "rwkv6_bf16": (RWKV, "bfloat16", {}),
    "jamba_f32": (JAMBA, "float32", {}),
    "jamba_bf16": (JAMBA, "bfloat16", {}),
}
# name: (arch, config overrides). qwen3-moe at capacity factor 1: a decode
# step's 8 assignments over 8 experts get a capacity of 1, so slots drop and
# their positions count the other dp rank's rows
SERVE = {"qwen3": (QWEN, {}), "qwen3_cf1": (QWEN, {"capacity_factor": 1.0}), "rwkv6": (RWKV, {}),
         "jamba": (JAMBA, {})}
BUCKETED = {"bucketed_C": Strategy.C_COLLAGE_PLUS, "bucketed_SR": Strategy.SR}
BUCKET_ARCH = ("granite-3-2b", "bfloat16")
BF16_METRIC_RTOL = 2e-3


def _cfg(arch, dtype, overrides=None):
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype=dtype)
    return dataclasses.replace(cfg, **(overrides or {}))


def _opt(dtype, strategy=Strategy.C_COLLAGE_PLUS, bucketed=False):
    pdt = torch.float32 if dtype == "float32" else torch.bfloat16
    return CollageAdamW(1e-3, b2=0.95, compute_metrics=True, sr_seed=3, use_fused_kernel=bucketed,
                        policy=PrecisionPolicy(strategy=strategy, param_dtype=pdt,
                                               bucketing=BucketPolicy(enabled=bucketed)))


_RANKS = """
import datetime, pickle, sys, torch, torch.distributed as dist
torch.set_num_threads(1)
RANK, TESTS, STORE = int(sys.argv[1]), sys.argv[2], sys.argv[3]
sys.path.insert(0, TESTS)
import dataclasses
from repro_torch.core import bucketing
from repro_torch.distributed import collectives as coll, sharding as sh
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import moe as moe_lib, transformer as tf
from repro_torch.models.model import build_model
from repro_torch.train import grid as grid_lib, train_loop
import test_torch_gspmd_families as T

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

# training, tree C
for name, (arch, dtype, over) in T.TRAIN.items():
    model = build_model(T._cfg(arch, dtype, over))
    opt = T._opt(dtype)
    params = inp["params"][arch + dtype]
    state = train_loop.TrainState(params, opt.init(params))
    step = train_loop.make_train_step(model, opt, grid=g)
    coll.reset_census()
    new, m = step(grid_lib.shard_state(state, g), inp["batch"])
    full = grid_lib.gather_state(new, state, g)
    out[name] = {"metrics": {k: float(v) for k, v in m.items()}, "params": leaves(full.params),
                 "roles": sorted({c["role"] for c in coll.CENSUS})}
    if RANK == 0:
        _, m1 = train_loop.make_train_step(model, opt)(state, inp["batch"])
        out[name]["one_rank_metrics"] = {k: float(v) for k, v in m1.items()}

# MoE routing: the grid's records against the one-rank record of the global batch
cfg = T._cfg(T.QWEN, "float32", {"capacity_factor": 1.0})
model = build_model(cfg)
params = inp["params"][T.QWEN + "float32"]
pspecs = sh.state_shardings(params, g)
shd = sh.make_activation_sharder(g)
batch = {"tokens": inp["batch"]["tokens"]}
lb = shd.local_batch(batch)
res = {}
with torch.no_grad(), tf.activation_sharding(shd):
    mp = sh.materialize(sh.local_tree(params, pspecs, g), pspecs, g, cfg.head_dim_)
    for label, split in (("global", True), ("per_rank", False)):
        shd.rows_split = split           # per_rank: the counterfactual, capacity per rank
        with moe_lib.record() as rec:
            logits, aux = model.forward(mp, lb)
        res[label] = {"aux": float(aux), "capacity": [r["capacity"] for r in rec],
                      **{k: [sh.gather_block(r[k], sh.P(None, "data", None), g).tolist()
                             for r in rec] for k in ("idx", "pos", "keep")}}
        if split:
            res["logits"] = np_(sh.gather_block(logits, sh.P("data", None, "model"), g))
if RANK == 0:
    with torch.no_grad(), moe_lib.record() as rec:
        logits, aux = model.forward(params, batch)
    res["one_rank"] = {"aux": float(aux), "capacity": [r["capacity"] for r in rec],
                       "logits": np_(logits),
                       **{k: [r[k].tolist() for r in rec] for k in ("idx", "pos", "keep")}}
out["routing"] = res

# serving
for sname, (arch, over) in T.SERVE.items():
    for dtype in ("bfloat16", "float32"):
        model = build_model(T._cfg(arch, dtype, over))
        params = inp["params"][arch + dtype]
        pspecs = sh.state_shardings(params, g)
        shd = sh.make_activation_sharder(g)
        with torch.no_grad(), tf.activation_sharding(shd):
            mp = sh.materialize(sh.local_tree(params, pspecs, g), pspecs, g, model.cfg.head_dim_)
            lb = shd.local_batch({"tokens": inp["serve_tokens"]})
            r = {}
            logits, st = model.prefill(mp, lb, cache_len=T.CACHE)
            r["prefill"] = np_(sh.gather_block(logits, sh.P("data", None, "model"), g))
            tok = sh.local_block(inp["next_tok"], sh.P("data", None), g)
            logits, st = model.decode_step(mp, st, tok)
            r["decode"] = np_(sh.gather_block(logits, sh.P("data", None, "model"), g))
            if dtype == "float32":
                gen, _ = model.generate(mp, lb, T.GEN)
                r["generate"] = sh.gather_block(gen, sh.P("data", None), g).tolist()
        out[f"serve_{sname}_{dtype}"] = r

# qwen3-moe (capacity factor 1) served a batch of 3: the rows do not divide
# dp 2, so they are replicated and each dp rank routes them as one rank does
cfg = T._cfg(T.QWEN, "float32", {"capacity_factor": 1.0})
model = build_model(cfg)
params = inp["params"][T.QWEN + "float32"]
pspecs = sh.state_shardings(params, g)
shd = sh.make_activation_sharder(g)
b3, nxt3 = {"tokens": inp["serve_tokens"][:3]}, inp["next_tok"][:3]
logits_of = lambda x: np_(sh.gather_block(x, sh.P(None, None, "model"), g))
with torch.no_grad(), tf.activation_sharding(shd):
    mp = sh.materialize(sh.local_tree(params, pspecs, g), pspecs, g, cfg.head_dim_)
    lb = shd.local_batch(b3)
    r = {"rows_split": shd.rows_split}
    logits, st = model.prefill(mp, lb, cache_len=T.CACHE)
    r["prefill"] = logits_of(logits)
    r["decode"] = logits_of(model.decode_step(mp, st, nxt3)[0])
    r["generate"] = model.generate(mp, lb, T.GEN)[0].tolist()
if RANK == 0:
    with torch.no_grad(), moe_lib.record() as rec:
        logits, st = model.prefill(params, b3, cache_len=T.CACHE)
        r["one_rank"] = {"prefill": np_(logits), "decode": np_(model.decode_step(params, st, nxt3)[0]),
                         "dropped": sum(int((~x["keep"]).sum()) for x in rec)}
        r["one_rank"]["generate"] = model.generate(params, b3, T.GEN)[0].tolist()
out["serve_qwen3_b3"] = r

# the bucketed layout: the step against the one-rank bucketed step, and the
# update bit for bit against the one-rank bucketed update of the same gradients
arch, dtype = T.BUCKET_ARCH
model = build_model(T._cfg(arch, dtype))
params = inp["params"][arch + dtype]
for name, strat in T.BUCKETED.items():
    opt = T._opt(dtype, strat, bucketed=True)
    bp, bo = opt.init_bucketed(params)
    state = train_loop.TrainState(bp, bo)
    specs = sh.state_shardings(state, g)
    step = train_loop.make_train_step(model, opt, grid=g)
    loc = grid_lib.shard_state(state, g)
    coll.reset_census()
    new, m = step(loc, inp["batch"])
    roles = sorted({c["role"] for c in coll.CENSUS})
    full = grid_lib.gather_state(new, state, g)
    _, grads = step.grads(loc.params, inp["batch"])
    p2, o2, _ = step.update(loc, grads)
    got = grid_lib.gather_state(train_loop.TrainState(p2, o2), state, g)
    full_g = tuple(coll.all_gather(x, g.axis("dp")) for x in grads.data)
    want_p, want_o, _ = opt.step_bucketed(full_g, bp, bo)
    same = all(torch.equal(a, b) for (_, a), (_, b) in
               zip(sh.named_leaves(train_loop.TrainState(want_p, want_o)), sh.named_leaves(got)))
    r = {"metrics": {k: float(v) for k, v in m.items()}, "params": bucket_leaves(full.params),
         "roles": roles, "bit_identical": same, "n": len(sh.named_leaves(got)),
         "shards": [tuple(s) for _, s in sh.named_leaves(specs.params)],
         "local_len": [int(x.numel()) for x in loc.params.data],
         "whole_len": [int(x.numel()) for x in bp.data]}
    if RANK == 0:
        s1, m1 = train_loop.make_train_step(model, opt)(state, inp["batch"])
        r["one_rank"] = {"metrics": {k: float(v) for k, v in m1.items()},
                         "params": bucket_leaves(s1.params)}
    out[name] = r

if RANK == 0:
    pickle.dump(out, open("out.pkl", "wb"))
dist.destroy_process_group()
"""


# The JAX references, each in a process of its own that imports JAX and the
# JAX package only (not torch): inputs_np.pkl holds the inputs as numpy.
_JAX = """
import dataclasses, os, pickle, sys
# each bf16 operation rounds to bf16 as the port's do (XLA otherwise keeps
# f32 inside its fusions): the jitted step then reads what the step run
# op by op under jax.disable_jit reads, in a tenth of the time
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_allow_excess_precision=false").strip()
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_config
from repro.core.collage import CollageAdamW
from repro.core.precision import PrecisionPolicy, Strategy
from repro.models.model import build_model
from repro.train import train_loop

inp = pickle.load(open("inputs_np.pkl", "rb"))
what, args = sys.argv[1], sys.argv[2:]

def model_of(arch, dtype, over=None):
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype=dtype, **(over or {}))
    return build_model(cfg)

def params_of(arch, dtype):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.dtype(dtype)),
                                  inp["params"][arch + dtype])

out = {}
if what == "train":                 # one step of the single-device train step a case
    toks = inp["tokens"].astype(np.int32)
    for name in args:
        arch, dtype, over = inp["train"][name]
        opt = CollageAdamW(1e-3, b2=0.95, compute_metrics=True,
                           policy=PrecisionPolicy(strategy=Strategy.C_COLLAGE_PLUS,
                                                  param_dtype=jnp.dtype(dtype)))
        params = params_of(arch, dtype)
        state = train_loop.TrainState(params, opt.init(params), None)
        step = train_loop.make_train_step(model_of(arch, dtype, over), opt)
        s2, m = jax.jit(step)(state, {"tokens": toks, "labels": toks})
        out[name] = {"metrics": {k: float(v) for k, v in m.items()},
                     "params": [np.asarray(x, np.float32)
                                for x in jax.tree_util.tree_leaves(s2.params)]}
else:                               # prefill, decode_step, greedy generate of one case
    serve, nxt = inp["serve_tokens"].astype(np.int32), inp["next_tok"].astype(np.int32)
    sname = args[0]
    arch, over = inp["serve"][sname]
    for dtype in ("bfloat16", "float32"):
        model, params = model_of(arch, dtype, over), params_of(arch, dtype)
        logits, st = jax.jit(model.prefill, static_argnames="cache_len")(
            params, {"tokens": serve}, cache_len=int(inp["cache"]))
        dlogits, _ = jax.jit(model.decode_step)(params, st, nxt)
        r = {"prefill": np.asarray(logits, np.float32), "decode": np.asarray(dlogits, np.float32)}
        if dtype == "float32":
            gen, _ = model.generate(params, {"tokens": serve}, max_new_tokens=int(inp["gen"]))
            r["generate"] = np.asarray(gen).tolist()
        out[f"serve_{sname}_{dtype}"] = r
pickle.dump(out, open(f"jax_{what}_{args[0]}.pkl", "wb"))
"""
# the train references in five processes (each a JAX start and its
# compiles), a serving one a case
JAX_REFS = [("train", "qwen3_f32", "qwen3_f32_groups", "moonshot_f32"),
            ("train", "qwen3_bf16", "moonshot_bf16"), ("train", "rwkv6_f32", "rwkv6_bf16"),
            ("train", "jamba_f32"), ("train", "jamba_bf16")] + [("serve", a) for a in SERVE]


def _inputs():
    """(the inputs as numpy, for the JAX processes; the same as torch
    tensors, for the ranks), from numpy (seed 0)."""
    from repro_torch.convert import params_from_numpy
    from repro_torch.distributed.sharding import map_leaves
    from repro_torch.models.model import param_dict

    rng = np.random.default_rng(0)
    pairs = sorted({(a, d) for a, d, _ in TRAIN.values()} | {BUCKET_ARCH})
    np_params = {a + d: G._numpy_params(a, d, rng) for a, d in pairs}
    numpy_in = {"params": np_params, "tokens": rng.integers(0, 256, (B, L)),
                "serve_tokens": rng.integers(0, 256, (SB, PROMPT)),
                "next_tok": rng.integers(0, 256, (SB, 1)), "train": TRAIN, "serve": SERVE,
                "cache": CACHE, "gen": GEN}
    toks = torch.tensor(numpy_in["tokens"])
    params = {a + d: map_leaves(lambda path, x: x.detach().clone(), param_dict(
        params_from_numpy(np_params[a + d], _cfg(a, d), device="cpu"))) for a, d in pairs}
    return numpy_in, {"params": params, "batch": {"tokens": toks, "labels": toks},
                      **{k: torch.tensor(numpy_in[k]) for k in ("serve_tokens", "next_tok")}}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(what the grid computed, the JAX references): the four ranks and
    each JAX reference run as processes of their own, all at once."""
    tmp = str(tmp_path_factory.mktemp("gspmd_families"))
    tests = os.path.dirname(os.path.abspath(__file__))
    numpy_in, inputs = _inputs()
    with open(os.path.join(tmp, "inputs.pkl"), "wb") as f:
        pickle.dump(inputs, f)
    with open(os.path.join(tmp, "inputs_np.pkl"), "wb") as f:
        pickle.dump(numpy_in, f)
    procs = [G._spawn(_JAX, args, tmp) for args in JAX_REFS]
    procs += [G._spawn(_RANKS, [r, tests, os.path.join(tmp, "store")], tmp) for r in range(4)]
    try:
        for p in procs:
            out, err = p.communicate(timeout=300)
            assert p.returncode == 0, f"process failed:\n{out}\n{err[-6000:]}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    refs = {}
    for args in JAX_REFS:
        with open(os.path.join(tmp, f"jax_{args[0]}_{args[1]}.pkl"), "rb") as f:
            refs.update(pickle.load(f))
    with open(os.path.join(tmp, "out.pkl"), "rb") as f:
        return pickle.load(f), refs


# f32 against the JAX step. The port's one-rank step itself reads edq and
# update_norm 2.1e-5 relative from the JAX step's on qwen3-moe, and a
# parameter 1.5e-4 (rwkv6) and 1.1e-3 (jamba) from it: the gradients agree
# within 1e-8, but Adam's first step moves an element by lr·g/(|g| + eps),
# so a gradient near eps moves by up to 2·lr on a difference of 1e-8. So
# the metrics are held at 1e-4 to the JAX step and at 1e-5 to the port's
# one-rank step, and the parameters within 1e-4 (relative and absolute)
# for 99.9 % of them, every one within 2·lr
F32_JAX_METRIC_RTOL = 1e-4
LR = 1e-3


def _hold(got, want, dtype, metric_rtol=1e-5):
    """The reference test's rules: f32 loss within 1e-4, the parameters as
    above, the metrics within ``metric_rtol`` relative; bf16 loss within
    2e-2, ≥ 99 % of the parameters within 2e-2·max(|θ|, 1), the metrics
    within 2e-3."""
    gm, wm = got["metrics"], want["metrics"]
    assert len(got["params"]) == len(want["params"])
    if dtype == "bfloat16":
        np.testing.assert_allclose(gm["loss"], wm["loss"], rtol=2e-2)
        for a, b in zip(want["params"], got["params"]):
            assert (np.abs(a - b) <= 2e-2 * np.maximum(np.abs(a), 1)).mean() > 0.99
        for k in ("edq", "update_norm", "grad_norm"):
            np.testing.assert_allclose(gm[k], wm[k], rtol=BF16_METRIC_RTOL, err_msg=k)
    else:
        np.testing.assert_allclose(gm["loss"], wm["loss"], rtol=1e-4)
        for a, b in zip(want["params"], got["params"]):
            assert (np.abs(a - b) <= 1e-4 + 1e-4 * np.abs(a)).mean() >= 0.999
            assert np.abs(a - b).max() <= 2 * LR
        for k in ("edq", "update_norm", "grad_norm", "imprecision_pct", "aux"):
            np.testing.assert_allclose(gm[k], wm[k], rtol=metric_rtol, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("name", list(TRAIN))
def test_train_step_matches_single_device(runs, name):
    got, refs = runs
    arch, dtype, _ = TRAIN[name]
    _hold(got[name], refs[name], dtype, F32_JAX_METRIC_RTOL)
    if dtype == "float32":
        gm, wm = got[name]["metrics"], got[name]["one_rank_metrics"]
        for k in ("loss", "aux", "edq", "update_norm", "grad_norm", "imprecision_pct"):
            np.testing.assert_allclose(gm[k], wm[k], rtol=1e-5, atol=1e-7, err_msg=k)
    roles = set(got[name]["roles"])
    assert {"fsdp_gather", "fsdp_scatter", "tp_reduce", "vocab_reduce"} <= roles
    if arch in (QWEN, MOON, JAMBA) and "groups" not in name:
        assert "moe_dp" in roles                  # counts and router sums over dp
    if arch in (RWKV, JAMBA):                     # cmix's wv, Mamba's in_proj over "model"
        assert {"tp_gather", "tp_scatter"} <= roles


def test_moe_routes_and_capacity_are_global(runs):
    """Each rank's routes, positions, kept mask and capacity equal the
    one-rank record over the global batch (capacity factor 1: slots drop),
    aux and logits within 1e-6; taken per rank, they do not."""
    res = runs[0]["routing"]
    got, want, per_rank = res["global"], res["one_rank"], res["per_rank"]
    assert not all(k for r in want["keep"] for k in np.ravel(r))      # some slots dropped
    for k in ("idx", "pos", "keep", "capacity"):
        assert got[k] == want[k], k
    np.testing.assert_allclose(got["aux"], want["aux"], rtol=1e-6)
    np.testing.assert_allclose(res["logits"], want["logits"], rtol=1e-6, atol=1e-6)
    assert per_rank["pos"] != want["pos"] and per_rank["capacity"] != want["capacity"]


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("name", list(SERVE))
def test_serving_logits_match(runs, name, kind, dtype):
    got, refs = runs
    key = f"serve_{name}_{dtype}"
    tol = 3e-2 if dtype == "bfloat16" else 1e-5
    np.testing.assert_allclose(got[key][kind], refs[key][kind], rtol=tol, atol=tol)


@pytest.mark.parametrize("name", list(SERVE))
def test_greedy_generate_matches(runs, name):
    got, refs = runs
    key = f"serve_{name}_float32"
    assert got[key]["generate"] == refs[key]["generate"]


def test_moe_serving_with_replicated_rows(runs):
    """qwen3-moe served a batch of 3 on dp 2 (the rows replicated over dp),
    at capacity factor 1 so that slots drop: prefill and decode logits
    within 1e-5 of the port's one-rank model, greedy tokens equal. Routes
    whose capacity or positions were summed over dp would differ."""
    r = runs[0]["serve_qwen3_b3"]
    assert r["rows_split"] is False and r["one_rank"]["dropped"] > 0
    for k in ("prefill", "decode"):
        np.testing.assert_allclose(r[k], r["one_rank"][k], rtol=1e-5, atol=1e-5, err_msg=k)
    assert r["generate"] == r["one_rank"]["generate"]


def test_moe_forward_needs_the_rows_split():
    """The MoE's capacity over the global batch needs to know whether the
    rows are split over dp: before ``local_batch`` a forward on a
    distributed dp raises (nothing is sent); ``local_batch`` records it
    from the batch (3 rows on dp 2 replicated, 4 split)."""
    from repro_torch.distributed import collectives as coll
    from repro_torch.distributed import sharding as sh
    from repro_torch.models import transformer as tf
    from repro_torch.models.model import param_dict

    model = build_model(_cfg(QWEN, "float32"))
    params = param_dict(model.init(0, device="cpu"))
    shd = sh.make_activation_sharder(mesh_lib.grid_shape(2, 1))
    shd.dp = coll.Axis(2, 0, None, True)             # a dp line of two ranks
    toks = torch.zeros((3, 8), dtype=torch.int64)
    with torch.no_grad(), tf.activation_sharding(shd), \
            pytest.raises(ValueError, match="local_batch"):
        model.forward(params, {"tokens": toks})
    assert shd.local_batch({"tokens": toks})["tokens"].shape == (3, 8)
    assert shd.rows_split is False and shd.dp_rows is None
    assert shd.local_batch({"tokens": torch.zeros((4, 8), dtype=torch.int64)})["tokens"].shape \
        == (2, 8)
    assert shd.rows_split is True and shd.dp_rows is shd.dp


@pytest.mark.parametrize("name", list(BUCKETED))
def test_bucketed_layout_on_the_grid(runs, name):
    """Buckets over dp and replicated over "model"; the update equal to the
    one-rank bucketed update of the same gradients bit for bit; the step
    held to the one-rank bucketed step at the bf16 rule."""
    got = runs[0][name]
    assert got["shards"] and all(s == ("data",) for s in got["shards"])
    assert [2 * n for n in got["local_len"]] == got["whole_len"]
    assert got["bit_identical"] and got["n"] >= 3          # θ, m, v at least
    _hold(got, got["one_rank"], BUCKET_ARCH[1])
    assert {"fsdp_gather", "fsdp_scatter", "tp_reduce"} <= set(got["roles"])


def test_moe_groups_straddling_dp_ranks_refuse():
    """moe_group_size 64 over 96 tokens a dp rank (6 rows of 32 over dp 2):
    a group would straddle two ranks."""
    model = build_model(_cfg(QWEN, "float32", {"moe_group_size": 64}))
    opt = _opt("float32")
    grid = mesh_lib.grid_shape(2, 2)
    state = train_loop.init_state(model, opt, 0, device="cpu")
    toks = torch.zeros((6, 32), dtype=torch.int64)
    step = train_loop.make_train_step(model, opt, grid=grid)
    with pytest.raises(ValueError, match=r"ROADMAP\.md Queue 1 item 7b"):
        step(grid_lib.shard_state(state, grid), {"tokens": toks, "labels": toks})

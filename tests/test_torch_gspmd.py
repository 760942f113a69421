"""The port's FSDP × TP grid (launch.mesh, distributed.sharding, the grid
train step of train.grid, the grid's serving) on gloo ranks, against the
JAX package's single-device functions.

Weights and batches come from numpy with a seed, the weights carried into
the port by ``convert.params_from_numpy``; the ranks are spawned once for
this module (eight: the (2,4) grid, then ranks 0-3 as the (2,2) grid) and
meet through a FileStore under ``tmp_path``; rank 0 writes what the grid
computed (gathered with ``gather_block``) and the tests hold it to the JAX
function on one device, computed meanwhile in two processes (the train
steps, the serving):

* training, granite-3-2b smoke tree C on (2,2) and (2,4) (on (2,4) the
  KV projection's block splits a head: it is gathered over "model"), in
  bf16 at the reference test's rule (loss within 2e-2 relative, ≥ 99 % of
  the parameters within 2e-2·max(|θ|, 1)) with grad_norm, edq and
  update_norm within 2e-3, and in f32 within 1e-4 with the metrics within
  1e-5 relative (a replicated leaf counted tp times would show there);
  internlm2 and gemma3 (tied head, local:global windows, q/k norms; one
  period of 4 layers) on (2,2), in f32 against the JAX step at the same
  rule, and in bf16 against the port's one-rank step (itself held to the
  JAX package's loss and gradients by tests/test_torch_families.py);
  ``fsdp=False`` and ``tp_mode`` mlponly and none in f32 within 1e-4;
  ``sp=True`` equal to ``sp=False`` within 1e-5 with its census roles;
* SR on the grid bit-identical to the port's one-rank update given the
  same gradient, and the fused update (its plain version here) too;
* serving, granite on (2,2): prefill and ``decode_step`` logits against
  the JAX functions (3e-2 in bf16, 1e-5 in f32), the context-parallel
  decode (a batch of one, the cache length over "data"), greedy
  ``generate`` tokens equal to the JAX ones in f32;
* the one build refusal left: ``psum_axis`` (the shard_map engine's).
  MoE, rwkv6, jamba and the bucketed layout run on the grid:
  tests/test_torch_gspmd_families.py; the frontends, remat, microbatches,
  compression, donation and the bucketed layout without FSDP:
  tests/test_torch_gspmd_cells.py and test_torch_gspmd_cells_more.py.
"""

import dataclasses
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.collage import CollageAdamW
from repro_torch.core.precision import PrecisionPolicy, Strategy
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models.model import build_model
from repro_torch.train import train_loop

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, L = 8, 32                  # train batch
SB, PROMPT, CACHE, GEN = 4, 16, 32, 8   # serving

# (name, arch, dtype, fsdp, tp_mode, sp) trained on every grid in GRIDS[name]
TRAIN = {
    "granite_bf16": ("granite-3-2b", "bfloat16", True, "full", False),
    "granite_f32": ("granite-3-2b", "float32", True, "full", False),
    "granite_f32_sp": ("granite-3-2b", "float32", True, "full", True),
    # sp beside attention every rank runs whole (its input gathered, its
    # output split, with no sum)
    "granite_f32_sp_mlponly": ("granite-3-2b", "float32", True, "mlponly", True),
    "granite_f32_nofsdp": ("granite-3-2b", "float32", False, "full", False),
    "granite_f32_mlponly": ("granite-3-2b", "float32", True, "mlponly", False),
    "granite_f32_none": ("granite-3-2b", "float32", True, "none", False),
    "internlm2_bf16": ("internlm2-1.8b", "bfloat16", True, "full", False),
    "gemma3_bf16": ("gemma3-27b", "bfloat16", True, "full", False),
    "internlm2_f32": ("internlm2-1.8b", "float32", True, "full", False),
    # the q/k norms (their gradient summed over "model") and local:global
    # windows on local heads
    "gemma3_f32": ("gemma3-27b", "float32", True, "full", False),
}
# each grid's cases; the ranks run the larger grid first, on all eight,
# then ranks 0-3 form the (2, 2) grid (one process start a rank)
GRIDS = {(2, 2): list(TRAIN), (2, 4): ["granite_bf16", "granite_f32"]}
# bf16 cases held to the port's one-rank step (itself held to the JAX
# package's loss and gradients by tests/test_torch_families.py), computed by
# the ranks; the same families in f32 are held to the JAX step
ONE_RANK_REF = ("internlm2-1.8bbfloat16", "gemma3-27bbfloat16")


# the bf16 cases' grad_norm, edq and update_norm against the reference's:
# bf16 gradients summed in another order read up to 5.1e-4 relative
# (gemma3's grad_norm); a leaf counted twice, a missing sum over a grid axis
# or a gradient in the wrong place moves them by far more
BF16_METRIC_RTOL = 2e-3


def _cfg(arch, dtype):
    """The smoke config in ``dtype``; gemma3 cut to one local:global period
    (4 layers: 3 windowed, 1 global)."""
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype=dtype)
    return dataclasses.replace(cfg, n_layers=4) if arch == "gemma3-27b" else cfg


def _policy(dtype, strategy=Strategy.C_COLLAGE_PLUS, fused=False):
    pdt = torch.float32 if dtype == "float32" else torch.bfloat16
    return CollageAdamW(1e-3, b2=0.95, compute_metrics=True, sr_seed=3, use_fused_kernel=fused,
                        policy=PrecisionPolicy(strategy=strategy, param_dtype=pdt))


_RANKS = """
import datetime, json, pickle, sys, torch, torch.distributed as dist
torch.set_num_threads(1)
RANK, TESTS, STORE = int(sys.argv[1]), sys.argv[2], sys.argv[3]
sys.path.insert(0, TESTS)
import numpy as np
from repro_torch.core.precision import Strategy
from repro_torch.distributed import collectives as coll, sharding as sh
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import transformer as tf
from repro_torch.models.model import build_model
from repro_torch.train import grid as grid_lib, train_loop
import test_torch_gspmd as T

inp = pickle.load(open("inputs.pkl", "rb"))

def np_(x):
    return x.detach().float().numpy()

def leaves(tree):
    return [np_(x) for _, x in sh.named_leaves(tree)]

def train_cases(DP, TP, g, out):
    for name in T.GRIDS[(DP, TP)]:
        arch, dtype, fsdp, mode, sp = T.TRAIN[name]
        model = build_model(T._cfg(arch, dtype))
        opt = T._policy(dtype)
        params = inp["params"][arch + dtype]
        state = train_loop.TrainState(params, opt.init(params))
        step = grid_lib.make_grid_train_step(model, opt, g, fsdp=fsdp, tp_mode=mode, sp=sp)
        coll.reset_census()
        new, m = step(grid_lib.shard_state(state, g, fsdp, mode), inp["batch"])
        full = grid_lib.gather_state(new, state, g, fsdp, mode)
        out[name] = {"metrics": {k: float(v) for k, v in m.items()}, "params": leaves(full.params),
                     "roles": sorted({c["role"] for c in coll.CENSUS})}
        if arch + dtype in T.ONE_RANK_REF and RANK == 0:
            s1, m1 = train_loop.make_train_step(model, opt)(state, inp["batch"])
            out[arch + dtype] = {"metrics": {k: float(v) for k, v in m1.items()},
                                 "params": leaves(s1.params)}

def grid_22_cases(g, out):
    arch, dtype = "granite-3-2b", "float32"
    model = build_model(T._cfg(arch, dtype))
    params = inp["params"][arch + dtype]
    # SR, and the fused update: the grid's update ≡ the one-rank update given the same gradient
    for name, strat, fused in (("sr", Strategy.SR, False), ("fused", Strategy.C_COLLAGE_PLUS, True)):
        opt = T._policy(dtype, strat, fused)
        state = train_loop.TrainState(params, opt.init(params))
        step = train_loop.make_train_step(model, opt, grid=g)
        loc = grid_lib.shard_state(state, g)
        _, grads = step.grads(loc.params, inp["batch"])
        p2, o2, _ = step.update(loc, grads)
        full_g = sh.gather_tree(grads, step.specs, g)
        want_p, want_o, _ = opt.step(full_g, state.params, state.opt_state)
        got = grid_lib.gather_state(train_loop.TrainState(p2, o2), state, g)
        same = all(torch.equal(a, b) for (_, a), (_, b) in
                   zip(sh.named_leaves(train_loop.TrainState(want_p, want_o)),
                       sh.named_leaves(got)))
        out[name] = {"bit_identical": same, "n": len(sh.named_leaves(got))}
    # serving
    for dtype in ("bfloat16", "float32"):
        model = build_model(T._cfg(arch, dtype))
        params = inp["params"][arch + dtype]
        pspecs = sh.state_shardings(params, g)
        toks = inp["serve_tokens"]
        res = {}
        for cp in (False, True):
            shd = sh.make_activation_sharder(g, context_parallel=cp)
            with torch.no_grad(), tf.activation_sharding(shd):
                mp = sh.materialize(sh.local_tree(params, pspecs, g), pspecs, g, model.cfg.head_dim_)
                batch = {"tokens": toks[:1] if cp else toks}
                bspec = sh.batch_shardings(batch, g)
                rows = bspec["tokens"][0] if bspec["tokens"] else None
                lb = sh.local_tree(batch, bspec, g)
                logits, st = model.prefill(mp, lb, cache_len=T.CACHE)
                res[f"prefill{int(cp)}"] = np_(sh.gather_block(logits, sh.P(rows, None, "model"), g))
                tok = sh.local_block(inp["next_tok"][:1] if cp else inp["next_tok"],
                                     sh.P(rows, None), g)
                logits, st = model.decode_step(mp, st, tok)
                res[f"decode{int(cp)}"] = np_(sh.gather_block(logits, sh.P(rows, None, "model"), g))
                if not cp:
                    gen, _ = model.generate(mp, lb, T.GEN)
                    res["generate"] = sh.gather_block(gen, sh.P(rows, None), g).tolist()
        out["serve_" + dtype] = res

for DP, TP in sorted(T.GRIDS, key=lambda g: -g[0] * g[1]):
    if RANK >= DP * TP:
        break
    dist.init_process_group("gloo", store=dist.FileStore(f"{STORE}_{DP}_{TP}", DP * TP),
                            rank=RANK, world_size=DP * TP,
                            timeout=datetime.timedelta(seconds=240))
    g = mesh_lib.make_mesh(DP, TP, device="cpu")
    out = {}
    train_cases(DP, TP, g, out)
    if (DP, TP) == (2, 2):
        grid_22_cases(g, out)
    if RANK == 0:
        pickle.dump(out, open(f"out_{DP}_{TP}.pkl", "wb"))
    dist.destroy_process_group()
"""


def _env():
    return dict(os.environ, PYTHONPATH=os.path.join(REPO, "src") + os.pathsep
                + os.path.dirname(os.path.abspath(__file__)), OMP_NUM_THREADS="1",
                JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_cpu_multi_thread_eigen=false")


def _numpy_params(arch, dtype, rng) -> dict:
    """Weights from numpy of ``_cfg(arch, dtype)`` (``_numpy_params_of``)."""
    return _numpy_params_of(_cfg(arch, dtype), rng)


def _numpy_params_of(cfg, rng) -> dict:
    """Weights from numpy (the port's tree, its init's scales): matrices
    N(0, 1)·d_in^-1/2, the embedding and head N(0, 0.02²), norms
    N(0, 0.1²); bf16 through ml_dtypes, as the JAX package holds them."""
    import ml_dtypes

    from repro_torch.distributed.sharding import _last_name, map_leaves
    from repro_torch.models.model import param_dict

    def draw(path, x):
        name, shape = _last_name(path), tuple(x.shape)
        scale = 0.1 if name.endswith("norm") else 0.02 if name in ("embed", "lm_head") \
            else shape[-2] ** -0.5
        a = (rng.standard_normal(shape) * scale).astype(np.float32)
        return a.astype(ml_dtypes.bfloat16) if cfg.dtype == "bfloat16" else a
    return map_leaves(draw, param_dict(build_model(cfg).init(device="meta")))


def _inputs():
    """(the inputs as numpy, for the JAX processes; the same as torch
    tensors, for the ranks): params per (arch, dtype), carried into the port
    by ``convert.params_from_numpy``, and the batches, from numpy (seed 0)."""
    from repro_torch.convert import params_from_numpy
    from repro_torch.distributed.sharding import map_leaves
    from repro_torch.models.model import param_dict

    rng = np.random.default_rng(0)
    pairs = sorted({(a, d) for a, d, *_ in TRAIN.values()})
    np_params = {a + d: _numpy_params(a, d, rng) for a, d in pairs}
    numpy_in = {"params": np_params, "tokens": rng.integers(0, 256, (B, L)),
                "serve_tokens": rng.integers(0, 256, (SB, PROMPT)),
                "next_tok": rng.integers(0, 256, (SB, 1)),
                "layers": {a: _cfg(a, d).n_layers for a, d in pairs}, "cache": CACHE, "gen": GEN}
    toks = torch.tensor(numpy_in["tokens"])
    params = {a + d: map_leaves(lambda path, x: x.detach().clone(), param_dict(
        params_from_numpy(np_params[a + d], _cfg(a, d), device="cpu"))) for a, d in pairs}
    return numpy_in, {"params": params, "batch": {"tokens": toks, "labels": toks},
                      **{k: torch.tensor(numpy_in[k]) for k in ("serve_tokens", "next_tok")}}


# The JAX references, each in a process of its own that imports JAX and the
# JAX package only (not torch): inputs_np.pkl holds the inputs as numpy.
_JAX = """
import dataclasses, pickle, sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_config
from repro.core.collage import CollageAdamW
from repro.core.precision import PrecisionPolicy, Strategy
from repro.models.model import build_model
from repro.train import train_loop

inp = pickle.load(open("inputs_np.pkl", "rb"))
what, args = sys.argv[1], sys.argv[2:]

def model_of(arch, dtype):
    cfg = get_config(arch, smoke=True)
    return build_model(dataclasses.replace(cfg, dtype=dtype, n_layers=inp["layers"][arch]))

def params_of(arch, dtype):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.dtype(dtype)),
                                  inp["params"][arch + dtype])

out = {}
if what == "train":                 # one step of the single-device train step, per (arch, dtype)
    toks = inp["tokens"].astype(np.int32)
    for arch, dtype in zip(args[::2], args[1::2]):
        opt = CollageAdamW(1e-3, b2=0.95, compute_metrics=True,
                           policy=PrecisionPolicy(strategy=Strategy.C_COLLAGE_PLUS,
                                                  param_dtype=jnp.dtype(dtype)))
        params = params_of(arch, dtype)
        state = train_loop.TrainState(params, opt.init(params), None)
        s2, m = jax.jit(train_loop.make_train_step(model_of(arch, dtype), opt))(
            state, {"tokens": toks, "labels": toks})
        out[arch + dtype] = {"metrics": {k: float(v) for k, v in m.items()},
                             "params": [np.asarray(x, np.float32)
                                        for x in jax.tree_util.tree_leaves(s2.params)]}
else:                               # granite's prefill, decode_step, greedy generate
    serve, nxt = inp["serve_tokens"].astype(np.int32), inp["next_tok"].astype(np.int32)
    for dtype in ("bfloat16", "float32"):
        model, params = model_of("granite-3-2b", dtype), params_of("granite-3-2b", dtype)
        logits, st = model.prefill(params, {"tokens": serve}, cache_len=int(inp["cache"]))
        dlogits, _ = model.decode_step(params, st, nxt)
        # the context-parallel case's reference is row 0: the same function
        # on the same row (the JAX model computes each row on its own)
        res = {"prefill0": np.asarray(logits, np.float32), "decode0": np.asarray(dlogits, np.float32)}
        res["prefill1"], res["decode1"] = res["prefill0"][:1], res["decode0"][:1]
        if dtype == "float32":
            gen, _ = model.generate(params, {"tokens": serve}, max_new_tokens=int(inp["gen"]))
            res["generate"] = np.asarray(gen).tolist()
        out["serve_" + dtype] = res
pickle.dump(out, open(f"jax_{what}.pkl", "wb"))
"""
# two processes: every train reference in one (one JAX start), the serving one
JAX_REFS = [("train", *[x for a, d in sorted({(a, d) for a, d, *_ in TRAIN.values()})
                        if a + d not in ONE_RANK_REF for x in (a, d)]), ("serve",)]


def _spawn(code, args, tmp):
    return subprocess.Popen([sys.executable, "-c", textwrap.dedent(code), *map(str, args)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            env=_env(), cwd=tmp)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(grid results {(dp, tp): {case: ...}}, JAX references): the ranks of
    every grid and each JAX reference run as processes of their own, all at
    once."""
    tmp = str(tmp_path_factory.mktemp("gspmd"))
    tests = os.path.dirname(os.path.abspath(__file__))
    numpy_in, inputs = _inputs()
    with open(os.path.join(tmp, "inputs.pkl"), "wb") as f:
        pickle.dump(inputs, f)
    with open(os.path.join(tmp, "inputs_np.pkl"), "wb") as f:
        pickle.dump(numpy_in, f)
    procs = [_spawn(_JAX, args, tmp) for args in JAX_REFS]
    procs += [_spawn(_RANKS, [r, tests, os.path.join(tmp, "store")], tmp)
              for r in range(max(dp * tp for dp, tp in GRIDS))]
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
        with open(os.path.join(tmp, f"jax_{args[0]}.pkl"), "rb") as f:
            refs.update(pickle.load(f))
    grids = {}
    for dp, tp in GRIDS:
        with open(os.path.join(tmp, f"out_{dp}_{tp}.pkl"), "rb") as f:
            grids[(dp, tp)] = pickle.load(f)
    return grids, refs


def _cases():
    """Every grid's cases; the f32 internlm2 and gemma3 cases last, after the
    (2, 4) grid's, so that each case keeps its test id."""
    late = ("internlm2_f32", "gemma3_f32")
    cases = [(g, name) for g, names in GRIDS.items() for name in names]
    return [c for c in cases if c[1] not in late] + [c for c in cases if c[1] in late]


@pytest.mark.parametrize("grid,name", _cases())
def test_train_step_matches_single_device(runs, grid, name):
    grids, refs = runs
    arch, dtype, fsdp, mode, sp = TRAIN[name]
    got = grids[grid][name]
    want = grids[(2, 2)][arch + dtype] if arch + dtype in ONE_RANK_REF else refs[arch + dtype]
    gm, wm = got["metrics"], want["metrics"]
    assert len(got["params"]) == len(want["params"])
    if dtype == "bfloat16":      # the reference test's rule, and the metrics
        np.testing.assert_allclose(gm["loss"], wm["loss"], rtol=2e-2)
        for a, b in zip(want["params"], got["params"]):
            assert (np.abs(a - b) <= 2e-2 * np.maximum(np.abs(a), 1)).mean() > 0.99
        for k in ("edq", "update_norm", "grad_norm"):
            np.testing.assert_allclose(gm[k], wm[k], rtol=BF16_METRIC_RTOL, err_msg=k)
    else:
        np.testing.assert_allclose(gm["loss"], wm["loss"], rtol=1e-4)
        for a, b in zip(want["params"], got["params"]):
            np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-4)
        for k in ("edq", "update_norm", "grad_norm", "imprecision_pct"):
            np.testing.assert_allclose(gm[k], wm[k], rtol=1e-5, atol=1e-7, err_msg=k)
    roles = set(got["roles"])
    assert {"fsdp_gather", "fsdp_scatter"} <= roles if fsdp else "grad" in roles
    if mode == "full":
        assert {"tp_reduce", "vocab_reduce"} <= roles
    if grid == (2, 4) and mode == "full":   # granite's wk/wv (64, 32): a head split over 4
        assert {"tp_gather", "tp_scatter"} <= roles
    if sp:
        assert {"sp_gather", "sp_scatter"} <= roles


def test_sequence_parallel_equals_tensor_parallel(runs):
    """sp=True ≡ sp=False within 1e-5 in f32 (the norms on local tokens,
    reduce-scatter/all-gather in place of the boundary sums)."""
    g = runs[0][(2, 2)]
    a, b = g["granite_f32"], g["granite_f32_sp"]
    np.testing.assert_allclose(b["metrics"]["loss"], a["metrics"]["loss"], rtol=1e-5)
    for x, y in zip(a["params"], b["params"]):
        np.testing.assert_allclose(y, x, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["sr", "fused"])
def test_update_bit_identical_to_one_rank(runs, name):
    got = runs[0][(2, 2)][name]
    assert got["bit_identical"] and got["n"] > 10


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("kind", ["prefill0", "decode0", "prefill1", "decode1"])
def test_serving_logits_match(runs, dtype, kind):
    """Prefill and TP decode (cp 0); the context-parallel prefill and
    decode of one row, the cache length over "data" (cp 1)."""
    grids, refs = runs
    got, want = grids[(2, 2)]["serve_" + dtype][kind], refs["serve_" + dtype][kind]
    tol = 3e-2 if dtype == "bfloat16" else 1e-5
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def test_greedy_generate_matches(runs):
    grids, refs = runs
    assert grids[(2, 2)]["serve_float32"]["generate"] == refs["serve_float32"]["generate"]


def test_serving_with_attention_whole_refuses():
    """Serving under tp_mode mlponly/none (attention whole on every rank
    beside a cache whose heads ``cache_shardings`` splits over "model")
    raises, naming the roadmap item."""
    from repro_torch.distributed import sharding as sh
    from repro_torch.models import transformer as tf

    model = build_model(get_config("granite-3-2b", smoke=True))
    params = model.init(0, device="cpu")
    with torch.no_grad(), tf.activation_sharding(
            sh.make_activation_sharder(mesh_lib.grid_shape(2, 2))):
        with pytest.raises(ValueError, match=r"ROADMAP\.md Queue 1 item 7b"):
            model.prefill(params, {"tokens": torch.zeros((2, 8), dtype=torch.int64)}, cache_len=16)


def test_context_parallel_cross_caches_refuse():
    """The context-parallel decode splits a cache's length over "data"; an
    encoder-decoder arch's cross-attention caches are not ported to it, so
    its prefill raises before any collective, naming the roadmap item."""
    from repro_torch.distributed import sharding as sh
    from repro_torch.models import transformer as tf

    cfg = get_config("seamless-m4t-medium", smoke=True)
    model = build_model(cfg)
    batch = {"tokens": torch.zeros((1, 8), dtype=torch.int64),
             "frontend": torch.zeros((1, cfg.frontend_len, cfg.d_model))}
    with torch.no_grad(), tf.activation_sharding(
            sh.make_activation_sharder(mesh_lib.grid_shape(2, 2), context_parallel=True)):
        with pytest.raises(ValueError, match=r"ROADMAP\.md Queue 1 item 7b"):
            model.prefill(model.init(0, device="cpu"), batch, cache_len=16)


def test_grid_step_refuses_psum_axis():
    """``psum_axis`` is the shard_map engine's (train/sharded.py): the grid
    step's gradient reductions are its gathers' backward, and the JAX
    package's GSPMD step takes none either."""
    from repro_torch.distributed.collectives import Axis

    model = build_model(get_config("granite-3-2b", smoke=True))
    with pytest.raises(ValueError, match=r"shard_map engine \(train/sharded\.py\)") as e:
        train_loop.make_train_step(model, CollageAdamW(1e-3), grid=mesh_lib.grid_shape(2, 2),
                                   psum_axis=Axis())
    assert "7b" not in str(e.value)

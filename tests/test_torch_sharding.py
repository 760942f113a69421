"""The port's sharding rules (repro_torch.distributed.sharding) against the
JAX package's, spec for spec.

One subprocess with 8 forced host devices computes every JAX spec once
(``state_shardings``, ``batch_shardings``, ``cache_shardings``; meshes
need real devices) and writes them as JSON: every family's smoke
TrainState (tree C, SR and D; bucketed C) on grids (1,1), (2,4), (4,2) and
(2,2,2 with "pod"), with ``fsdp`` on and off and ``tp_mode`` full, mlponly
and none; every family's DecodeState, SlotState and SpecState, with and
without context parallelism; the batch at 8 rows and at 1. The port's specs
of the same trees (built on the meta device) must be equal. Leaves the
port holds as host ints (the step, the SR seed) must be replicated in the
reference. ``local_block`` of every rank, put back together, is the
identity.
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.core.collage import CollageAdamW
from repro_torch.core.precision import BucketPolicy, PrecisionPolicy, Strategy
from repro_torch.distributed import sharding as sh
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models.model import build_model
from repro_torch.train import train_loop

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAMILIES = ["gpt-tiny"] + sorted(ARCHS)
GRIDS = [(1, 1, 1), (2, 4, 1), (4, 2, 1), (2, 2, 2)]       # (dp, tp, pods)
STATES = ["C", "SR", "D", "C_bucketed"]
TP_MODES = ["full", "mlponly", "none"]
B, CACHE = 4, 32

_JAX = """
import json, sys, jax, jax.numpy as jnp
from repro.configs import get_config
from repro.core.collage import CollageAdamW
from repro.core.precision import BucketPolicy, PrecisionPolicy, Strategy
from repro.distributed import sharding as shard_lib
from repro.models.model import build_model
from repro.train import train_loop

FAMILIES, GRIDS, STATES, TP_MODES, B, CACHE = json.loads(sys.argv[1])
STRAT = {"C": Strategy.C_COLLAGE_PLUS, "SR": Strategy.SR, "D": Strategy.D_MIXED_MW}

def enc(spec):
    return [list(e) if isinstance(e, tuple) else e for e in spec]

def specs(tree):
    return {jax.tree_util.keystr(p): enc(s.spec)
            for p, s in jax.tree_util.tree_flatten_with_path(tree)[0]}

meshes = {}
for dp, tp, pods in GRIDS:
    meshes[f"{dp},{tp},{pods}"] = (jax.make_mesh((pods, dp, tp), ("pod", "data", "model"))
                                   if pods > 1 else jax.make_mesh((dp, tp), ("data", "model")))
out = {}
for fam in FAMILIES:
    cfg = get_config(fam, smoke=True)
    model = build_model(cfg)
    abs_params = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    for st in STATES:
        strat = STRAT[st.split("_")[0]]
        bucketed = st.endswith("bucketed")
        bp = BucketPolicy(enabled=True) if bucketed else BucketPolicy()
        opt = CollageAdamW(1e-3, policy=PrecisionPolicy(strategy=strat, bucketing=bp))
        # init_state's own assembly, on the abstract params (one trace of init a family)
        abs_state = jax.eval_shape(lambda p: train_loop.TrainState(
            *(opt.init_bucketed(p) if bucketed else (p, opt.init(p))), None), abs_params)
        for g, m in meshes.items():
            for fsdp in (True, False):
                for mode in TP_MODES:
                    out[f"{fam}|{st}|{g}|{int(fsdp)}|{mode}"] = specs(
                        shard_lib.state_shardings(abs_state, m, fsdp=fsdp, tp_mode=mode))
    draft = build_model(get_config(fam, smoke=True))
    serving = {"decode": lambda: model.init_decode_state(B, CACHE),
               "decode1": lambda: model.init_decode_state(1, CACHE),
               "slot": lambda: model.init_slot_state(B, CACHE)}
    if cfg.family not in ("ssm", "hybrid"):
        serving["spec"] = lambda: model.init_spec_state(draft, B, CACHE)
    for kind, fn in serving.items():
        try:
            abs_cache = jax.eval_shape(fn)
        except ValueError:
            continue
        for g, m in meshes.items():
            for cp in (False, True):
                out[f"{fam}|{kind}|{g}|{int(cp)}"] = specs(
                    shard_lib.cache_shardings(abs_cache, m, context_parallel=cp))
for g, m in meshes.items():
    for rows in (8, 1):
        b = {"tokens": jax.ShapeDtypeStruct((rows, 16), jnp.int32),
             "labels": jax.ShapeDtypeStruct((rows, 16), jnp.int32),
             "frontend": jax.ShapeDtypeStruct((rows, 4, 8), jnp.bfloat16)}
        out[f"batch|{rows}|{g}"] = specs(shard_lib.batch_shardings(b, m))
json.dump(out, open(sys.argv[2], "w"))
"""


@pytest.fixture(scope="module")
def jax_specs(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("specs") / "specs.json")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8 "
                         "--xla_cpu_multi_thread_eigen=false")
    args = json.dumps([FAMILIES, GRIDS, STATES, TP_MODES, B, CACHE])
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(_JAX), args, path],
                         capture_output=True, text=True, env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-6000:]
    with open(path) as f:
        return json.load(f)


def _enc(spec):
    return [list(e) if isinstance(e, tuple) else e for e in spec]


def _port(tree) -> dict:
    return {p: _enc(s) for p, s in sh.named_leaves(tree)}


# leaves the port holds as host ints: the reference's are replicated arrays
_HOST_INTS = (".opt_state[<flat index 0>]", ".opt_state[<flat index 5>]", ".opt_state.step",
              ".opt_state.rng")


def _assert_equal(want: dict, got: dict, case):
    for name, spec in want.items():
        if name in _HOST_INTS:
            assert name not in got and not any(spec), (case, name, spec)
            continue
        assert name in got, (case, name)
        assert got[name] == spec, (case, name, got[name], spec)
    assert set(got) <= set(want), (case, sorted(set(got) - set(want)))


def _assemble(blocks: dict, spec, grid) -> torch.Tensor:
    """The whole leaf from ``{coords: block}`` of every rank: what
    ``gather_block`` gives a rank, without process groups."""
    first = next(iter(blocks.values()))
    spec = sh._pad(spec, first.dim())
    shape = tuple(d * int(np.prod([grid.sizes[a] for a in sh._names(e)]))
                  for d, e in zip(first.shape, spec))
    out = first.new_empty(shape)
    for coords, b in blocks.items():
        out[sh.block_slices(shape, spec, grid, coords)] = b
    return out


def _grid(g):
    dp, tp, pods = g
    return mesh_lib.grid_shape(dp, tp, pods)


_STRAT = {"C": Strategy.C_COLLAGE_PLUS, "SR": Strategy.SR, "D": Strategy.D_MIXED_MW}


@pytest.mark.parametrize("fam", FAMILIES)
def test_state_specs_equal(jax_specs, fam):
    """Every TrainState layout × grid × fsdp × tp_mode of one family."""
    model = build_model(get_config(fam, smoke=True))
    n = 0
    for st in STATES:
        bp = BucketPolicy(enabled=True) if st.endswith("bucketed") else BucketPolicy()
        opt = CollageAdamW(1e-3, policy=PrecisionPolicy(strategy=_STRAT[st.split("_")[0]],
                                                        bucketing=bp))
        state = train_loop.init_state(model, opt, 0, device="meta")
        for g in GRIDS:
            grid = _grid(g)
            for fsdp in (True, False):
                for mode in TP_MODES:
                    key = f"{fam}|{st}|{','.join(map(str, g))}|{int(fsdp)}|{mode}"
                    _assert_equal(jax_specs[key],
                                  _port(sh.state_shardings(state, grid, fsdp, mode)), key)
                    n += 1
    assert n == len(STATES) * len(GRIDS) * 2 * len(TP_MODES)


@pytest.mark.parametrize("fam", FAMILIES)
def test_cache_specs_equal(jax_specs, fam):
    """DecodeState (B rows and one row), SlotState and SpecState of one
    family, with and without context parallelism."""
    cfg = get_config(fam, smoke=True)
    model, draft = build_model(cfg), build_model(cfg)
    states = {"decode": lambda: model.init_decode_state(B, CACHE, device="meta"),
              "decode1": lambda: model.init_decode_state(1, CACHE, device="meta"),
              "slot": lambda: model.init_slot_state(B, CACHE, device="meta"),
              "spec": lambda: model.init_spec_state(draft, B, CACHE, device="meta")}
    seen = 0
    for kind, fn in states.items():
        for g in GRIDS:
            for cp in (False, True):
                key = f"{fam}|{kind}|{','.join(map(str, g))}|{int(cp)}"
                if key not in jax_specs:
                    continue
                _assert_equal(jax_specs[key], _port(sh.cache_shardings(fn(), _grid(g), cp)), key)
                seen += 1
    assert seen >= 3 * len(GRIDS) * 2


@pytest.mark.parametrize("g", GRIDS)
def test_batch_specs_equal(jax_specs, g):
    for rows in (8, 1):
        b = {"tokens": torch.zeros((rows, 16), dtype=torch.int64, device="meta"),
             "labels": torch.zeros((rows, 16), dtype=torch.int64, device="meta"),
             "frontend": torch.zeros((rows, 4, 8), dtype=torch.bfloat16, device="meta")}
        key = f"batch|{rows}|{','.join(map(str, g))}"
        _assert_equal(jax_specs[key], _port(sh.batch_shardings(b, _grid(g))), key)


def test_granite_vocab_stays_whole():
    """An axis that does not divide its dim is dropped: granite's vocab
    49155 on a model axis of 4."""
    grid = mesh_lib.grid_shape(2, 4)
    assert sh.param_spec("['embed']", (49155, 2048), grid) == sh.P(None, "data")
    assert sh.param_spec("['embed']", (49152, 2048), grid) == sh.P("model", "data")
    assert sh.param_spec("['decoder']['groups'][0]['sub0']['wq']", (40, 2048, 4096), grid,
                         tp_mode="mlponly") == sh.P(None, "data", None)
    assert sh._last_name(".opt_state[<flat index 2>]['decoder']['final_norm'][<flat index 1>]") \
        == "final_norm"
    assert sh._last_name(".x['wq'].hi") == "wq"


@pytest.mark.parametrize("g", GRIDS)
def test_local_block_assemble_identity(g):
    """``local_block`` of every rank, then ``assemble``: the leaf back, for
    every leaf of granite's params and serving state."""
    grid = _grid(g)
    cfg = get_config("granite-3-2b", smoke=True)
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    gen = torch.Generator().manual_seed(1)
    state = model.init_decode_state(B, CACHE, device="cpu")
    state = sh.map_leaves(lambda p, x: torch.randn(x.shape, generator=gen).to(x.dtype)
                          if x.is_floating_point() else x, state)
    coords = list(np.ndindex(*grid.shape))
    for tree, specs in ((params, sh.state_shardings(params, grid)),
                        (state, sh.cache_shardings(state, grid)),
                        (state, sh.cache_shardings(state, grid, context_parallel=True))):
        by_path = dict(sh.named_leaves(specs))
        for path, x in sh.named_leaves(tree):
            spec = by_path[path]
            blocks = {c: sh.local_block(x, spec, grid, c) for c in coords}
            back = _assemble(blocks, spec, grid)
            assert torch.equal(back, x), (g, path, spec)
            split = np.prod([grid.sizes[a] for e in spec for a in sh._names(e)])
            assert blocks[coords[-1]].numel() * split == x.numel(), (g, path, spec)

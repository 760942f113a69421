"""The port's dry run (``repro_torch.launch.dryrun``) and its virtual rank,
against the JAX package's dry run and against real ranks, and the bucketed
state's residual rows across bucket layouts.

* ``grad_err`` across bucket layouts: a bucketed C run with bf16_ef,
  checkpointed under one ``max_bucket_elems`` and restored under another,
  equals the JAX package's ``checkpoint.restore`` → ``migrate`` bit for
  bit, every residual row included (two rows, each moved on its own).
* The cell rules: ``SKIP``, ``cell_config``, ``accum_plan``,
  ``parse_variant`` and the model FLOPs equal the JAX dry run's for every
  assigned arch × shape × a few variants. The JAX module sets
  ``XLA_FLAGS`` to 512 host devices when it is imported, so its side runs
  in a subprocess.
* The virtual rank: ``launch.mesh.virtual_grid`` gives a rank of a grid
  with no processes, whose collectives record their census entry and
  return tensors of the real collective's shape on the meta device. Its
  census, entry by entry (op, role, dtype, bytes), equals that of each
  rank of a real (2, 2) gloo grid (four processes) for the tree C train
  step, the bucketed step, prefill and decode (under tp_mode mlponly and
  none too, rwkv6's decode among them; with sequence parallelism too,
  seamless's prefill among them), and its state blocks are
  ``shard_state``'s.
* Sequence parallelism in the serving cells: seamless's cross-attention
  caches hold all the memory's frames under ``sp=1`` (F8); a prefill
  cell's boundary sums move from ``tp_reduce`` to ``sp_scatter`` (F9),
  for granite, seamless, qwen3-moe and internvl2 under ``tpmode=none``;
  a decode cell's census under ``sp=1`` equals ``sp=0``'s.
* On a one-rank grid the meta trace of a step equals the CPU trace of the
  same step: FLOPs, modelled peak and the kernel calls (the CPU's plain
  versions' own ops set apart); each kernel wrapper's meta outputs have
  its plain version's shapes and dtypes, and a meta call runs no plain
  version.
* ``dryrun.run_cell`` writes a report, a ``skipped`` or a ``refused``
  record, at smoke size on the (2, 2) grid.
"""

import dataclasses
import functools
import json
import os
import pathlib
import pickle
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.core import bucketing as jbucketing
from repro.train import checkpoint as jckpt
from repro.train import train_loop as jtl
from repro_torch.analysis import liveness
from repro_torch.analysis import trace as trace_lib
from repro_torch.configs import get_config
from repro_torch.core import bucketing
from repro_torch.distributed import collectives as coll
from repro_torch.distributed import sharding as sh
from repro_torch.kernels.collage_update import collage_update as kcu
from repro_torch.kernels.edq import edq as kedq
from repro_torch.kernels.flash_attention import flash_attention as kflash
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_lib
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import train_loop as ttl

import test_torch_checkpoint as C

ROOT = pathlib.Path(__file__).resolve().parents[1]
TESTS = pathlib.Path(__file__).resolve().parent
ENV = {**os.environ, "PYTHONPATH": str(ROOT / "src")}


# ------------------------------------------------- grad_err across layouts --
@functools.lru_cache(maxsize=None)
def _jax_ef_state(comp, steps=2):
    jm = C._jax_model()
    jopt = C._jax_opt("C", True)
    js = jtl.init_state(jm, jopt, jax.random.PRNGKey(0), grad_compression=comp)
    step = jax.jit(jtl.make_train_step(jm, jopt, grad_compression=comp))
    for i in range(steps):
        js, _ = step(js, C._batch_np(i))
    return js


def _second_row(js):
    """``js`` with a second residual row a bucket (a seeded row of values
    that the residual's dtype holds exactly, zero on the padding), as a
    two-rank state holds."""
    g = np.random.default_rng(3)
    rows = []
    for e, b in zip(js.opt_state.grad_err, js.params.layout.buckets):
        e = np.asarray(e)
        other = g.standard_normal(e.shape[1:]).astype(np.float32).astype(e.dtype)
        other[b.size:] = 0
        rows.append(jax.numpy.asarray(np.concatenate([e, other[None]], 0)))
    return dataclasses.replace(js, opt_state=dataclasses.replace(js.opt_state,
                                                                 grad_err=tuple(rows)))


@pytest.mark.parametrize("comp", ["bf16_ef", "fp8_ef"])
@pytest.mark.parametrize("writer", ["reference", "port"])
def test_grad_err_restores_across_bucket_layouts_as_the_reference_migrates(writer, comp,
                                                                            tmp_path):
    """A bucketed C state with error-feedback residuals (two rows), written
    under one bucket layout and restored under another: the port's
    ``restore_bucketed`` equals the JAX package's restore → ``migrate``,
    every array bit for bit, the residual rows included. (bf16_ef leaves
    bf16 buckets a zero residual row: fp8_ef's rows are the step's own.)"""
    js = _second_row(_jax_ef_state(comp))
    assert all(np.asarray(e).any() for e in js.opt_state.grad_err)
    if comp == "fp8_ef":
        assert all(np.asarray(e)[0].any() for e in js.opt_state.grad_err)
    jtemplate = jtl.init_state(C._jax_model(), C._jax_opt("C", True, **C.OTHER),
                               jax.random.PRNGKey(1), grad_compression=comp)
    jtemplate = _second_row(jtemplate)
    assert jtemplate.params.layout.n_buckets > js.params.layout.n_buckets
    jckpt.save(str(tmp_path / "j"), 2, js, extra={"step": 2})
    want, _ = jckpt.restore_bucketed(str(tmp_path / "j"), 2, jtemplate)
    want_direct = jbucketing.migrate(js, jtemplate.params.layout)
    C._assert_same(C._jax_named(want), C._jax_named(want_direct))

    src = str(tmp_path / "j")
    if writer == "port":          # the same state through the port's own save
        ts, _ = ckpt.restore(src, 2, _port_template(comp))
        C._assert_same(C._port_named(ts), C._jax_named(js))
        ckpt.save(str(tmp_path / "t"), 2, ts, extra={"step": 2})
        src = str(tmp_path / "t")
    got, _ = ckpt.restore_bucketed(src, 2, _port_template(comp, **C.OTHER))
    assert got.params.layout.to_json() == jtemplate.params.layout.to_json()
    assert [tuple(e.shape) for e in got.opt_state.grad_err] == \
        [tuple(np.shape(e)) for e in want.opt_state.grad_err]
    C._assert_same(C._port_named(got), C._jax_named(want))


def _port_template(comp, **bucket_kw):
    tm, topt = C._port_model(), C._port_opt("C", True, **bucket_kw)
    ts = ttl.init_state(tm, topt, 0, grad_compression=comp, device="cpu")
    ost = ts.opt_state
    rows = tuple(torch.cat([e, e]) for e in ost.grad_err)
    return dataclasses.replace(ts, opt_state=dataclasses.replace(ost, grad_err=rows))


def test_port_migrate_moves_each_residual_row_alone():
    """``bucketing.migrate`` of a port state with two residual rows: each
    row equals the migration of that row alone, and the round trip back to
    the first layout is the identity."""
    tm = C._port_model()
    ts = ttl.init_state(tm, C._port_opt("C", True), 0, grad_compression="fp8_ef", device="cpu")
    step = ttl.make_train_step(tm, C._port_opt("C", True), grad_compression="fp8_ef")
    for i in range(2):
        ts, _ = step(ts, C._to_torch(C._batch_np(i)))
    g = torch.Generator().manual_seed(5)
    rows = []
    for e, b in zip(ts.opt_state.grad_err, ts.params.layout.buckets):
        assert e.any()
        other = torch.randn(e.shape, generator=g).to(e.dtype)
        other[:, b.size:] = 0
        rows.append(torch.cat([e, other]))
    rows = tuple(rows)
    ts = dataclasses.replace(ts, opt_state=dataclasses.replace(ts.opt_state, grad_err=rows))
    other = _port_template("fp8_ef", **C.OTHER).params.layout
    moved = bucketing.migrate(ts, other)
    for r in range(2):
        alone = bucketing.rebucket([e[r] for e in rows], ts.params.layout, other)
        for a, b in zip(alone, moved.opt_state.grad_err):
            assert torch.equal(a, b[r])
    back = bucketing.migrate(moved, ts.params.layout)
    C._assert_same(C._port_named(back), C._port_named(ts))


# ------------------------------------------------------------ cell rules --
VARIANTS = ["", "smoke=1", "attn=banded,flashmin=512,ssmchunk=32,rwkvchunk=32,window=256",
            "moegroup=64,accum=8"]
_JAX_RULES = """
import dataclasses, json, sys
from repro.configs import ASSIGNED, SHAPES
from repro.launch import dryrun
out = {"skip": sorted(map(list, dryrun.SKIP)), "assigned": list(ASSIGNED),
       "shapes": {k: dataclasses.astuple(v) for k, v in SHAPES.items()}, "cells": []}
for v in json.loads(sys.argv[1]):
    ov = dryrun.parse_variant(v)
    for arch in ASSIGNED:
        for shape in list(SHAPES) + list(dryrun.AUDIT_SHAPES):
            cfg, sh = dryrun.cell_config(arch, shape, ov)
            n_acc = {n: dryrun.accum_plan(cfg, sh, n) for n in (1, 32, 64)}
            tokens = sh.global_batch if sh.mode == "decode" else sh.global_batch * sh.seq_len
            flops = (6 if sh.mode == "train" else 2) * cfg.active_param_count() * tokens
            out["cells"].append([v, arch, shape, ov, dataclasses.asdict(cfg),
                                 dataclasses.astuple(sh), {str(k): list(x) for k, x in
                                                           n_acc.items()}, tokens, flops])
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_rules(procs):
    """The JAX dry run's cell rules, from a process of its own (its module
    sets XLA_FLAGS to 512 host devices when imported)."""
    out, err = procs["jax"].communicate(timeout=300)
    assert procs["jax"].returncode == 0, err[-4000:]
    return json.loads(out.strip().splitlines()[-1])


def test_cell_rules_equal_the_reference(jax_rules):
    """SKIP, the shapes, ``parse_variant``, ``cell_config`` (every field of
    the reference's config), ``accum_plan`` at 1, 32 and 64 dp ranks and
    the model FLOPs equal the JAX dry run's for every assigned arch × shape
    × variant."""
    assert jax_rules["assigned"] == list(dryrun.ASSIGNED)
    assert sorted(map(list, dryrun.SKIP)) == jax_rules["skip"]
    assert {k: list(dataclasses.astuple(v)) for k, v in dryrun.SHAPES.items()} == \
        jax_rules["shapes"]
    assert len(jax_rules["cells"]) == len(VARIANTS) * 10 * 6
    for v, arch, shape, ov, jcfg, jshape, jacc, jtokens, jflops in jax_rules["cells"]:
        assert dryrun.parse_variant(v) == ov
        cfg, sh_ = dryrun.cell_config(arch, shape, ov)
        got = dataclasses.asdict(cfg)
        assert {k: got[k] for k in jcfg} == jcfg, (v, arch, shape)
        assert list(dataclasses.astuple(sh_)) == jshape
        assert {str(n): list(dryrun.accum_plan(cfg, sh_, n)) for n in (1, 32, 64)} == jacc
        assert list(dryrun.model_flops(cfg, sh_)) == [jtokens, jflops], (v, arch, shape)


# ------------------------------------------------ the virtual rank's census --
CENSUS_CASES = {
    # name: (arch, shape (L, B, mode), overrides, chunks)
    "tree": ("granite-3-2b", (32, 8, "train"), {"remat": "full", "compress": "fp8_ef"}, 2),
    "bucketed": ("granite-3-2b", (32, 8, "train"), {"bucketed": "1", "compress": "bf16_ef"}, 1),
    "moe_tree": ("qwen3-moe-30b-a3b", (32, 8, "train"), {"sp": "1"}, 1),
    "prefill": ("granite-3-2b", (16, 4, "prefill"), {}, 1),
    "decode": ("granite-3-2b", (32, 4, "decode"), {}, 1),
    "decode_cp": ("granite-3-2b", (32, 1, "decode"), {}, 1),
    # serving under the other tp_modes: the attention (and rwkv6's time-mix)
    # on the rank's block, cut from the whole weights the rules store
    "prefill_mlponly": ("granite-3-2b", (16, 4, "prefill"), {"tpmode": "mlponly"}, 1),
    "decode_mlponly": ("granite-3-2b", (32, 4, "decode"), {"tpmode": "mlponly"}, 1),
    "decode_none": ("granite-3-2b", (32, 4, "decode"), {"tpmode": "none"}, 1),
    "decode_none_rwkv6": ("rwkv6-1.6b", (32, 4, "decode"), {"tpmode": "none"}, 1),
    # sequence parallelism in serving: the prefill's positions over "model"
    # (seamless's frames by their own count), the decode step unsplit
    "prefill_sp": ("granite-3-2b", (16, 4, "prefill"), {"sp": "1"}, 1),
    "prefill_sp_seamless": ("seamless-m4t-medium", (16, 4, "prefill"), {"sp": "1"}, 1),
    "decode_sp": ("granite-3-2b", (32, 4, "decode"), {"sp": "1"}, 1),
}


def _cell(name, grid, device):
    from repro_torch.configs.base import ShapeConfig
    arch, (L, B, mode), ov, chunks = CENSUS_CASES[name]
    cfg = get_config(arch, smoke=True)
    shape = ShapeConfig(name, L, B, mode)
    return dryrun.cell_step(cfg, shape, grid, "C", True, ov, chunks, B // chunks, device=device)


def census_of(name, grid, device) -> tuple:
    """(the census entries of one step of the case, the rank's state blocks)."""
    cell = _cell(name, grid, device)
    coll.reset_census()
    cell["fn"](*cell["inputs"])
    entries = [(c["op"], c["role"], c["dtype"], c["numel"], c["bytes"]) for c in coll.CENSUS]
    blocks = [(p, tuple(x.shape), str(x.dtype)) for p, x in sh.named_leaves(cell["inputs"][0])]
    return entries, blocks


_RANKS = """
import datetime, pickle, sys, torch, torch.distributed as dist
torch.set_num_threads(1)
RANK, TESTS, STORE = int(sys.argv[1]), sys.argv[2], sys.argv[3]
sys.path.insert(0, TESTS)
from repro_torch.launch import mesh as mesh_lib
import test_torch_dryrun as T
dist.init_process_group("gloo", store=dist.FileStore(STORE, 4), rank=RANK, world_size=4,
                        timeout=datetime.timedelta(seconds=240))
g = mesh_lib.make_mesh(2, 2, device="cpu")
out = {"coords": g.coords}
for name in T.CENSUS_CASES:
    out[name] = T.census_of(name, g, "cpu")
pickle.dump(out, open(f"rank{RANK}.pkl", "wb"))
dist.destroy_process_group()
"""


@pytest.fixture(scope="module", autouse=True)
def procs(tmp_path_factory):
    """The processes of this module, all started with its first test: the
    JAX dry run's rules, and the four ranks of a real (2, 2) gloo grid."""
    tmp = str(tmp_path_factory.mktemp("dryrun_grid"))
    out = {"tmp": tmp, "jax": subprocess.Popen(
        [sys.executable, "-c", _JAX_RULES, json.dumps(VARIANTS)], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env={**ENV, "JAX_PLATFORMS": "cpu"})}
    out["ranks"] = [subprocess.Popen([sys.executable, "-c", _RANKS, str(r), str(TESTS),
                                      os.path.join(tmp, "store")], stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True, env=ENV, cwd=tmp)
                    for r in range(4)]
    try:
        yield out
    finally:
        for p in [out["jax"], *out["ranks"]]:
            if p.poll() is None:
                p.kill()
                p.wait()


@pytest.fixture(scope="module")
def real_ranks(procs):
    """Each rank's census and blocks of every case on the real grid."""
    for p in procs["ranks"]:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, f"rank failed:\n{out}\n{err[-6000:]}"
    ranks = []
    for r in range(4):
        with open(os.path.join(procs["tmp"], f"rank{r}.pkl"), "rb") as f:
            ranks.append(pickle.load(f))
    return ranks


@pytest.mark.parametrize("name", list(CENSUS_CASES))
def test_virtual_rank_census_equals_a_real_grid(real_ranks, name):
    """On each rank of a real (2, 2) gloo grid and on the virtual rank at the
    same coordinates (the meta device, no processes), one step of the case
    makes the same collectives in the same order (op, role, wire dtype,
    numel, bytes), from the same state blocks."""
    for rank in real_ranks:
        g = mesh_lib.virtual_grid(2, 2, coords=rank["coords"])
        assert g.axis("world").rank == real_ranks.index(rank)
        got, blocks = census_of(name, g, "meta")
        want, want_blocks = rank[name]
        assert got, name
        assert got == want, (name, rank["coords"])
        assert blocks == want_blocks, (name, rank["coords"])


def test_virtual_axis_collectives_move_nothing_and_keep_shapes():
    """Each collective on a virtual axis returns the real collective's shape
    and dtype on the meta device and records its census entry; a virtual
    axis is never the one-rank identity."""
    g = mesh_lib.virtual_grid(4, 2, pods=2, coords=(1, 2, 1))
    dp, model = g.axis("dp"), g.axis("model")
    assert (dp.size, dp.rank, model.size, model.rank, g.axis("world").rank) == (8, 6, 2, 1, 13)
    assert dp.virtual and dp.distributed and g.device.type == "meta"
    x = torch.empty((16, 3), dtype=torch.bfloat16, device="meta")
    coll.reset_census()
    assert tuple(coll.all_gather_dim(x, dp, 0).shape) == (128, 3)
    assert tuple(coll.psum_scatter_dim(x, dp, 0).shape) == (2, 3)
    assert coll.psum(x, model).dtype == torch.bfloat16
    assert tuple(coll.psum_scatter(x.reshape(-1), dp).shape) == (6,)
    assert tuple(coll.pmax(x.float(), model).shape) == (16, 3)
    assert [(c["op"], c["bytes"]) for c in coll.CENSUS] == [
        ("all_gather", 96), ("all_to_all", 96), ("all_gather", 96), ("all_to_all", 96),
        ("all_reduce_max", 192)]


# ------------------------------------------- sequence parallelism in serving --
def _virtual_cell(arch, L, B, mode, overrides):
    """One rank's serving cell on the virtual (2, 2) grid, at smoke size →
    (what it returns, its census by role)."""
    from repro_torch.configs.base import ShapeConfig
    cell = dryrun.cell_step(get_config(arch, smoke=True), ShapeConfig("t", L, B, mode),
                            mesh_lib.virtual_grid(2, 2, coords=(0, 1)), "C", True, overrides,
                            device="meta")
    coll.reset_census()
    out = cell["fn"](*cell["inputs"])
    return out, dryrun.census_by(coll.CENSUS)


def test_sequence_parallel_prefill_keeps_the_whole_memory_in_the_cross_caches():
    """F8's gate: seamless's prefill cell under ``sp=1`` splits its 8 frames
    over "model" for the encoder, yet every cross-attention cache holds all
    8 (a rank's block of the memory, 4, before the repair), as under
    ``sp=0``."""
    cfg = get_config("seamless-m4t-medium", smoke=True)
    for sp in ("0", "1"):
        (_, state), census = _virtual_cell("seamless-m4t-medium", 16, 4, "prefill", {"sp": sp})
        cross = [c for layers in state.layers for key, c in layers.items()
                 if tuple(c["k"].shape[2:3]) == (cfg.frontend_len,)]
        n_cross = sum(s.kind == "cross_attn" for g in cfg.decoder_program() for s in g.period)
        assert len(cross) == n_cross > 0, (sp, [tuple(c["k"].shape) for layers in state.layers
                                                for c in layers.values()])
        assert ("sp_scatter" in census) == (sp == "1")


@pytest.mark.parametrize("arch,tpmode", [("granite-3-2b", "full"), ("seamless-m4t-medium", "full"),
                                         ("qwen3-moe-30b-a3b", "full"),
                                         ("internvl2-1b", "none")])
def test_sequence_parallel_prefill_cell_reduce_scatters_its_boundaries(arch, tpmode):
    """F9's gate: a prefill cell under ``sp=1`` reduce-scatters the
    decoder's boundary sums over the sequence (``sp_scatter``) and gathers
    its inputs (``sp_gather``) where ``sp=0`` sums them (``tp_reduce``); the
    parent planned both alike."""
    _, plain = _virtual_cell(arch, 16, 4, "prefill", {"tpmode": tpmode})
    _, sp = _virtual_cell(arch, 16, 4, "prefill", {"tpmode": tpmode, "sp": "1"})
    assert plain.get("tp_reduce", 0) > 0 and not {"sp_scatter", "sp_gather"} & set(plain)
    assert sp.get("sp_scatter", 0) > 0 and sp.get("sp_gather", 0) > 0
    assert sp.get("tp_reduce", 0) == 0, sp


@pytest.mark.parametrize("arch", ["granite-3-2b", "rwkv6-1.6b", "seamless-m4t-medium"])
def test_sequence_parallel_decode_cell_equals_tensor_parallel(arch):
    """A decode cell's (B, 1, D) token has nothing to split: under ``sp=1``
    its census equals ``sp=0``'s byte for byte, as in the reference."""
    assert _virtual_cell(arch, 32, 4, "decode", {"sp": "1"})[1] == \
        _virtual_cell(arch, 32, 4, "decode", {})[1]


# -------------------------------------------------- meta trace, CPU trace --
def _one_rank_traces(overrides, metrics=True):
    from repro_torch.configs.base import ShapeConfig
    cfg = dataclasses.replace(get_config("granite-3-2b", smoke=True), dtype="float32")
    opt = dryrun._opt

    def no_metrics(*a):
        o = opt(*a)
        o.compute_metrics = False
        return o
    if not metrics:
        dryrun._opt = no_metrics
    shape = ShapeConfig("t", 32, 4, "train")
    g1 = mesh_lib.virtual_grid(1, 1)
    out = {}
    try:
        for dev in ("meta", "cpu"):
            cell = dryrun.cell_step(cfg, shape, g1, "C", True, overrides, 2, 2, device=dev)
            res, tr = trace_lib.record_step(cell["fn"], *cell["inputs"], device=dev)
            out[dev] = tr
    finally:
        dryrun._opt = opt
    return out


@pytest.mark.parametrize("remat", ["full", "none"])
def test_meta_trace_equals_the_cpu_trace_on_one_rank(remat):
    """A one-rank grid's step traced on the meta device and on the CPU: the
    same FLOPs and the same kernel calls (the meta calls stand for launches;
    the CPU ran the plain versions, whose own ops are set apart); without
    the metric partials (no kernel call, whose plain version allocates
    otherwise than the kernel) the same modelled peak; and the lean trace
    gives the full trace's numbers."""
    trs = _one_rank_traces({"remat": remat})
    meta, cpu = trs["meta"], trs["cpu"]
    assert meta.flops() == sum(op.flops for op in cpu.ops if not op.in_wrapper) > 0
    assert [(k.name, k.args) for k in meta.kernels] == [(k.name, k.args) for k in cpu.kernels]
    assert all(k.kernel for k in meta.kernels) and not any(k.kernel for k in cpu.kernels)
    assert len(meta.kernels) > 0
    bare = _one_rank_traces({"remat": remat}, metrics=False)
    assert not bare["meta"].kernels and not bare["cpu"].kernels
    assert bare["meta"].flops() == bare["cpu"].flops() == meta.flops()
    # the host scalars the step makes without a device (0-dim f32 and bf16
    # constants of the update) are host memory on the card and in the meta
    # trace, device memory only in the CPU's: the peaks differ by no more
    host = sum(st.nbytes for st in bare["meta"].storages if st.device == "cpu")
    assert 0 < host <= 1024
    peak_meta = liveness.peak_hbm(bare["meta"])["peak_bytes_modeled"]
    peak_cpu = liveness.peak_hbm(bare["cpu"])["peak_bytes_modeled"]
    assert 0 <= peak_cpu - peak_meta <= host, (peak_cpu, peak_meta, host)
    from repro_torch.configs.base import ShapeConfig
    cfg = dataclasses.replace(get_config("granite-3-2b", smoke=True), dtype="float32")
    lean = dryrun.trace_rank(cfg, ShapeConfig("t", 32, 4, "train"), mesh_lib.virtual_grid(1, 1),
                             "C", True, {"remat": remat}, 2, 2)["trace"]
    assert lean.tally is not None and lean.n_ops == len(meta.ops)
    assert lean.flops() == meta.flops()
    assert liveness.peak_hbm(lean)["peak_bytes_modeled"] == \
        liveness.peak_hbm(meta)["peak_bytes_modeled"]
    from repro_torch.analysis import cost_model
    a, b = cost_model.model_step(lean), cost_model.model_step(meta)
    for k in ("flops", "bytes", "kernels_s"):
        assert a[k] == b[k], k
    assert a["modeled_step_s"] == pytest.approx(b["modeled_step_s"], rel=1e-12)


def _wrapper_cases():
    g = torch.Generator().manual_seed(0)
    rn = lambda *s, dt=torch.bfloat16: torch.randn(*s, generator=g).to(dt)
    q, k, v = rn(1, 4, 8, 64), rn(1, 2, 8, 64), rn(1, 2, 8, 64)
    o, lse = kflash.flash_fwd(q, k, v)
    dq, delta = kflash.flash_bwd_dq(q, k, v, lse, o)
    state = {f: torch.zeros(256, dtype=kcu.field_dtype(f, "C")) for f in kcu.state_fields("C")}
    return [
        ("flash_fwd", kflash, lambda *a: kflash.flash_fwd(*a, causal=True), (q, k, v)),
        ("flash_bwd_dq", kflash, lambda *a: kflash.flash_bwd_dq(*a), (q, k, v, lse, o)),
        ("flash_bwd_dkv", kflash, lambda *a: kflash.flash_bwd_dkv(*a), (q, k, v, lse, o, delta)),
        ("collage_bucket_update", kcu,
         lambda st, gr: kcu.collage_bucket_update(st, gr, 1e-3, 0.1, 0.01, compute_metrics=True),
         (state, rn(256))),
        ("edq_partials", kedq, lambda u, e: kedq.edq_partials(u, e),
         (rn(300, dt=torch.float32), rn(300, dt=torch.float32))),
    ]


def _to_meta(x):
    if isinstance(x, dict):
        return {k: _to_meta(v) for k, v in x.items()}
    return x.to("meta") if isinstance(x, torch.Tensor) else x


def _shapes(x):
    if isinstance(x, dict):
        return {k: _shapes(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return [_shapes(v) for v in x]
    return (tuple(x.shape), x.dtype) if isinstance(x, torch.Tensor) else x


@pytest.mark.parametrize("case", range(5), ids=["flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                                                 "collage_bucket_update", "edq_partials"])
def test_wrapper_meta_outputs_have_the_plain_shapes_and_run_nothing(case, monkeypatch):
    """Each kernel wrapper on meta tensors returns outputs of its plain
    version's shapes and dtypes, counts a meta call and no launch, and runs
    no plain version (each plain function raises if called)."""
    from repro_torch.kernels.collage_update import ref as cref
    from repro_torch.kernels.edq import ref as eref
    name, mod, call, args = _wrapper_cases()[case]
    plain = call(*args)
    for m, fn in ((kflash, "flash_fwd_plain"), (kflash, "flash_bwd_dq_plain"),
                  (kflash, "flash_bwd_dkv_plain"), (cref, "collage_bucket_update_plain"),
                  (eref, "edq_partials_plain")):
        monkeypatch.setattr(m, fn, lambda *a, **k: pytest.fail("a plain version ran on meta"))
    wrapper = getattr(mod, name)
    launches, calls = wrapper.launches, wrapper.meta_calls
    got = call(*[_to_meta(a) for a in args])
    assert _shapes(got) == _shapes(plain)
    assert all(t.device.type == "meta" for t in trace_lib.tensors_of(got))
    assert (wrapper.launches, wrapper.meta_calls) == (launches, calls + 1)


# ------------------------------------------------------------- run_cell --
def test_run_cell_writes_a_report_a_skip_and_a_refusal(tmp_path):
    """At smoke size on virtual grids: a report with the reference's keys,
    a skipped cell (the reference's SKIP) and a refused one (internvl2's 4
    query heads over model 8 would split a head)."""
    g = mesh_lib.virtual_grid(2, 2)
    rec = dryrun.run_cell("granite-3-2b", "train_smoke", "grid_2x2", str(tmp_path),
                          variant="smoke=1", grid=g)
    for k in ("chips", "params", "active_params", "tokens_per_step", "model_flops_total",
              "per_device", "roofline_terms_s", "dominant", "useful_flops_ratio", "fits_80gb",
              "grad_accum", "microbatch_global", "device", "hardware", "depth"):
        assert k in rec, k
    pd = rec["per_device"]
    assert rec["chips"] == 4 and pd["peak_bytes_modeled"] > pd["state_bytes_by_role"]["params"]
    assert pd["collective_bytes_by_role"]["fsdp_gather"] > 0
    assert pd["kernel_calls"]["edq_partials"] > 0
    assert json.loads((tmp_path / "grid_2x2" / "granite-3-2b__train_smoke__smoke=1.json")
                      .read_text()) == rec
    assert "skipped" in dryrun.run_cell("granite-3-2b", "long_500k",
                                        "grid_2x2", str(tmp_path), grid=g)
    rec = dryrun.run_cell("internvl2-1b", "train_smoke", "grid_1x8", str(tmp_path),
                          variant="smoke=1", grid=mesh_lib.virtual_grid(1, 8))
    assert "split a head" in rec["refused"]


# ------------------------------------------------------------ extrapolation --
@pytest.mark.parametrize("arch,shape", [("granite-3-2b", "train_smoke"),
                                        ("qwen3-moe-30b-a3b", "decode_smoke")])
def test_depth_extrapolation_matches_the_whole_stack(arch, shape, monkeypatch):
    """A cell of 4 repeats and 4 chunks traced at 1 and 2 of each and
    extrapolated, against the whole stack traced: FLOPs, the census by role
    and op, the kernel calls and the compute seconds exactly (they are
    bilinear in repeats and chunks); the bytes moved within 1e-4 and the
    modelled peak within 10 % (held as a model: the peak's place moves
    between repeats)."""
    orig = dryrun.cell_config

    def four(a, s, o=None):
        cfg, sh_ = orig(a, s, o)
        return dataclasses.replace(cfg, n_layers=4 * dryrun.period_of(cfg)), sh_
    monkeypatch.setattr(dryrun, "cell_config", four)
    g = mesh_lib.virtual_grid(2, 2)
    ov = {"smoke": "1", "accum": "4"}
    _, _, got, meta = dryrun.lower_cell(arch, shape, g, overrides=ov)
    _, _, want, _ = dryrun.lower_cell(arch, shape, g, overrides=ov, full_depth=True)
    assert meta["depth"]["repeats"] == 4
    assert meta["depth"]["chunks"] == (4 if shape.startswith("train") else 1)
    for k in ("flops", "census", "kernel_calls", "state_bytes", "n_ops"):
        assert got[k] == want[k], k
    assert got["compute_s"] == pytest.approx(want["compute_s"], rel=1e-12)
    assert got["bytes"] == pytest.approx(want["bytes"], rel=1e-4)
    assert got["peak"] == pytest.approx(want["peak"], rel=0.10)

"""Dry run of the production cells on H100 grids, the port of
``repro.launch.dryrun``: every (arch × shape × mesh × variant) cell traced
for one rank of the grid, with its memory, cost and collective bytes a card.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-3-2b \\
      --shape train_4k [--multi-pod] [--precision C] [--variant k=v,...] [--force]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes

The reference lowers and compiles each cell's jitted step for 256 or 512
host devices and reads XLA's HLO. Eager PyTorch has no program to lower, so
here each cell runs one rank's step on the meta device (shapes, no data)
under a virtual grid (``launch.mesh.virtual_grid``): the rank's blocks of
the state (``train.grid.shard_state``, ``sharding.cache_shardings``), the
global batch and the step the card would run, its collectives recording
the census and moving nothing, its kernel wrappers standing for their
launches (``analysis.trace``, lean). What the reference's ideas become:

* Meshes: the reference's chip counts laid out for H100 nodes of 8 cards:
  ``single_pod`` 256 cards as ("data" 32, "model" 8), ``multi_pod`` 512 as
  ("pod" 2, "data" 32, "model" 8); "model" stays inside a node's NVLink.
* Collective bytes: the census a rank (op, role, dtype, bytes), each op's
  wire bytes a rank (an all-gather of |w| over n ranks receives (n−1)·|w|,
  an all-to-all of |w| sends (n−1)/n·|w|, an all-reduce 2(n−1)/n·|w|),
  priced on NVLink for the roles over "model" and on the DGX H100's
  inter-node rate (``cost_model.HW["internode_bw"]``) for the rest.
* Memory and cost: bytes a rank by role of the state, the modelled peak
  (``liveness.peak_hbm``), the modelled compute, memory and collective
  seconds (``cost_model``'s per-op roofline and kernel bounds), the model
  FLOPs (6 or 2 × active parameters × tokens, the reference's) against the
  traced FLOPs (``useful_flops_ratio``), whether the peak fits 80 GB.
* Depth: a production rank's eager step runs to millions of ops, and each
  meta op costs the host ~0.2 ms, so each cell is traced at 1 and 2 repeats
  of its layer period (the tail of gemma3's stack and seamless's encoder
  kept in proportion) and, for gradient accumulation, 1 and 2 chunks; the
  additive quantities (FLOPs, bytes, seconds, census, kernel calls) are
  bilinear in (repeats, chunks) and are extrapolated exactly so; the peak
  is taken linear in the repeats and flat past the second chunk (chunks
  after the first hold the same live set). ``lower_cell(full_depth=True)``
  traces the whole stack and every chunk (``depth`` in a report says
  which).
* Attention: where the reference's cell picks its blocked "flash"
  implementation (train and prefill at L ≥ 8192), the H100 cell takes the
  hand-written flash kernels (``flash_min_len`` = L), as the card would.
* Serving: prefill and decode cells read ``sharding.materialize_serving``
  under every ``tpmode``, as a real rank does (the sublayers whose cache
  is split over "model" on the rank's blocks); a cache write of the wrong
  shape raises on the meta device as on the CPU. Under ``sp=1`` a prefill
  cell splits its positions over "model" through ``Model.prefill``, as the
  reference's activation constraint does; a decode cell's token has
  nothing to split, so there ``sp=1`` changes nothing (its report equals
  ``sp=0``'s), as in the reference, whose decode constrains nothing.
* Refusals: a cell that the grid refuses (a head split by
  ``train.grid.check_grid``, a ROADMAP item 7b part still to port) is
  written as ``{"refused": <the message>}`` beside the reference's
  ``skipped``.
* Device: traced on the meta device by design, as the reference lowers on
  host devices; where ``cost_model.card()`` finds a card the report names
  it and its power limit, elsewhere it says "modelled, H100 SXM data sheet".

Not carried over: the TPU constants, the HLO text and its analysis,
``reanalyze_cell`` and the stored ``.hlo.zst`` (there is no HLO); the
pipeline variants (``pipeline=``: the stages are devices of one rank, and
a dry run has one meta device). Reports go to
``experiments/dryrun_torch/<mesh>/<arch>__<shape>[__variant].json``; a
re-run skips cached cells unless ``--force``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import re
import time
import traceback
from typing import Optional

import torch

from repro_torch.analysis import cost_model, liveness
from repro_torch.analysis import trace as trace_lib
from repro_torch.configs import ASSIGNED, SHAPES, get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import bucketing
from repro_torch.core.collage import CollageAdamW
from repro_torch.core.precision import BucketPolicy, PrecisionPolicy, parse_strategy
from repro_torch.device import torch_dtype
from repro_torch.distributed import collectives as coll
from repro_torch.distributed import compression
from repro_torch.distributed import sharding as sh
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import transformer as tf
from repro_torch.models.model import build_model, param_dict
from repro_torch.train import grid as grid_lib
from repro_torch.train import train_loop

SKIP = {}
for _a in ASSIGNED:
    if not get_config(_a).supports_long_context:
        SKIP[(_a, "long_500k")] = "full-attention arch: long_500k skipped per spec"

# smoke-scale shapes of the static-analysis audit (``launch.precision_audit``):
# not in SHAPES, so ``--all`` never picks them up
AUDIT_SHAPES = {
    "train_smoke": ShapeConfig("train_smoke", 128, 32, "train"),
    "decode_smoke": ShapeConfig("decode_smoke", 256, 8, "decode"),
}

# mesh: (data, model, pods); "model" inside a node of 8 cards
MESHES = {"single_pod": (32, 8, 1), "multi_pod": (32, 8, 2)}
OUTDIR = "experiments/dryrun_torch"
HBM_LIMIT = 80e9
DEVICE_NOTE = ("traced on the meta device (one virtual rank of the grid, no data), as the "
               "reference lowers on host devices")

# the census roles whose collectives run over "model" (one node's NVLink);
# the rest span nodes
MODEL_ROLES = {"tp_reduce", "tp_gather", "tp_scatter", "vocab_reduce", "sp_scatter",
               "sp_gather"}
# the grid's refusals (what it does not run), by their messages
REFUSALS = re.compile(r"would split a head|splits a head|cannot be used|item 7b|"
                      r"SR through the fused|must be a multiple of the \d+ dp ranks")


def cell_config(arch: str, shape_name: str, overrides: Optional[dict] = None):
    """Per-cell model-config adjustments (the reference's ``cell_config``).
    ``overrides`` come from variants (``parse_variant``)."""
    cfg = get_config(arch, smoke=(overrides or {}).get("smoke", "0") == "1")
    shape = SHAPES.get(shape_name) or AUDIT_SHAPES[shape_name]
    if shape.seq_len >= 8192 and shape.mode != "decode":
        cfg = dataclasses.replace(cfg, attention_impl="flash")
    if cfg.family == "hybrid":
        cfg = dataclasses.replace(cfg, ssm_chunk=16)
    for k, v in (overrides or {}).items():
        if k in ("attn",):
            cfg = dataclasses.replace(cfg, attention_impl=v)
        elif k == "flashmin":   # the flash kernels' train/prefill dispatch
            cfg = dataclasses.replace(cfg, flash_min_len=int(v))
        elif k == "ssmchunk":
            cfg = dataclasses.replace(cfg, ssm_chunk=int(v))
        elif k == "rwkvchunk":
            cfg = dataclasses.replace(cfg, rwkv_chunk=int(v))
        elif k == "window":
            cfg = dataclasses.replace(cfg, window_size=int(v))
        elif k == "moegroup":
            cfg = dataclasses.replace(cfg, moe_group_size=int(v))
    return cfg, shape


def parse_variant(variant: str) -> dict:
    """'attn=flash,accum=8,remat=dots,fsdp=0' → override dict."""
    out = {}
    for part in (variant or "").split(","):
        if "=" in part:
            k, v = part.split("=", 1)
            out[k.strip()] = v.strip()
    return out


def accum_plan(cfg, shape, n_dp: int) -> tuple:
    """(grad_accum_steps, microbatch_global_rows): ≤ ~2 rows a device for
    wide models under remat (the reference's plan)."""
    rows_per_dev = 4 if cfg.d_model <= 2048 else (2 if cfg.d_model <= 5376 else 1)
    if shape.seq_len > 4096:
        rows_per_dev = 1
    mb_global = max(rows_per_dev * n_dp, 1)
    n_acc = max(shape.global_batch // mb_global, 1)
    mb_global = shape.global_batch // n_acc
    return n_acc, mb_global


def model_flops(cfg, shape) -> tuple:
    """(tokens a step, model FLOPs a step): 6 (train) or 2 × active
    parameters × tokens, one new token a row at decode."""
    tokens = shape.global_batch if shape.mode == "decode" else shape.global_batch * shape.seq_len
    return tokens, (6 if shape.mode == "train" else 2) * cfg.active_param_count() * tokens


def mesh_grid(mesh_name: str, coords=None):
    """The virtual rank at ``coords`` (default 0) of a production mesh."""
    dp, tp, pods = MESHES[mesh_name]
    return mesh_lib.virtual_grid(dp, tp, pods, coords)


# --------------------------------------------------------------------------
# depth
# --------------------------------------------------------------------------

def period_of(cfg) -> int:
    """Decoder layers a repeat of the main group holds."""
    if cfg.family == "hybrid":
        return cfg.attn_every
    return cfg.local_global_period or 1


def repeats_of(cfg) -> int:
    return cfg.n_layers // period_of(cfg)


def at_repeats(cfg, r: int):
    """``cfg`` with its main group cut to ``r`` repeats (gemma3's tail kept,
    an encoder cut in proportion)."""
    p, R = period_of(cfg), repeats_of(cfg)
    over = {"n_layers": r * p + cfg.n_layers % p}
    if cfg.n_enc_layers:
        if cfg.n_enc_layers % R:
            raise ValueError(f"{cfg.name}: {cfg.n_enc_layers} encoder layers over {R} repeats")
        over["n_enc_layers"] = r * cfg.n_enc_layers // R
    return dataclasses.replace(cfg, **over)


def _bilinear(q: dict, R: int, C: int):
    """Extrapolate q[(r, c)] for r, c ∈ {1, 2} (c = 1 only when absent) to
    (R, C), a number or a dict of numbers."""
    def one(get):
        q11, q21 = get((1, 1)), get((2, 1))
        out = q11 + (R - 1) * (q21 - q11)
        if (1, 2) in q:
            q12, q22 = get((1, 2)), get((2, 2))
            out += (C - 1) * (q12 - q11) + (R - 1) * (C - 1) * (q22 - q21 - q12 + q11)
        return out
    sample = q[(1, 1)]
    if isinstance(sample, dict):
        keys = set().union(*(v.keys() for v in q.values()))
        return {k: one(lambda rc: q[rc].get(k, 0)) for k in sorted(keys)}
    return one(lambda rc: q[rc])


# --------------------------------------------------------------------------
# one rank's step on the meta device
# --------------------------------------------------------------------------

def cell_batch(cfg, rows: tuple, seq_len: int, device="meta") -> dict:
    """The global batch's shapes: ``rows`` leading dims ((B,) or (n, mb)).
    Off the meta device (the tests' real ranks) its values are zeros."""
    make = torch.empty if torch.device(device).type == "meta" else torch.zeros
    text = seq_len - cfg.frontend_len if cfg.family == "vlm" else seq_len
    b = {"tokens": make(rows + (text,), dtype=torch.int64, device=device),
         "labels": make(rows + (text,), dtype=torch.int64, device=device)}
    if cfg.family == "vlm" or cfg.is_encdec:
        b["frontend"] = make(rows + (cfg.frontend_len, cfg.d_model),
                             dtype=torch_dtype(cfg.dtype), device=device)
    return b


def _opt(precision: str, bucketed: bool, grid) -> CollageAdamW:
    bp = BucketPolicy(enabled=True, pad_multiple=sh.bucket_pad_multiple(
        grid.axis("dp"), block=compression.BLOCK)) if bucketed else BucketPolicy()
    return CollageAdamW(1e-4, b2=0.95, weight_decay=0.1, compute_metrics=True,
                        policy=PrecisionPolicy(strategy=parse_strategy(precision), bucketing=bp))


def state_bytes(state) -> dict:
    """Bytes of a rank's state blocks by role."""
    out: dict = {}

    def add(role, tree):
        if tree is not None:
            out[role] = out.get(role, 0) + sum(t.numel() * t.element_size()
                                               for t in trace_lib.tensors_of(tree))
    if isinstance(state.params, bucketing.BucketedParams):
        add("params", state.params.data)
        o = state.opt_state
        add("m", o.m)
        add("v", o.vhi)
        add("v", o.vlo)
        add("delta", o.delta)
        add("master", o.master)
        add("grad_err", o.grad_err)
        out["gradients"] = out["params"]
    else:
        add("params", state.params)
        o = state.opt_state
        add("m", o.m)
        add("v", o.v)
        add("delta", o.delta)
        add("master", o.master)
        add("gradients", state.params)
    add("grad_err", state.grad_err)
    return out


def cell_step(cfg, shape, grid, precision: str = "C", fsdp: bool = True,
              overrides: Optional[dict] = None, n_acc: int = 1, mb_global: int = 0,
              device="meta") -> dict:
    """One rank's step of the cell → {"fn", "inputs", "state_bytes",
    "meta"}: ``fn(*inputs)`` runs it (on ``device``: the meta device for a
    dry run, the CPU on the tests' real ranks). Raises what the grid
    raises. Variant keys: the reference's (``remat``, ``fsdp``, ``tpmode``,
    ``sp``, ``compress``, ``bucketed``, ``engine``, ``zero``, ``accum``)."""
    overrides = overrides or {}
    fsdp = fsdp and overrides.get("fsdp", "1") != "0"
    remat = overrides.get("remat", "full")
    tp_mode = overrides.get("tpmode", "full")
    sp = overrides.get("sp", "0") == "1"
    comp = overrides.get("compress", "none")
    bucketed = overrides.get("bucketed", "0") == "1"
    engine = overrides.get("engine", "gspmd")
    if overrides.get("pipeline"):
        raise ValueError("pipeline variants are not carried over: the stages are devices of "
                         "one rank, and a dry run has one meta device")
    model = build_model(cfg)
    meta: dict = {}
    if shape.mode == "train":
        opt = _opt(precision, bucketed, grid)
        rows = (n_acc, mb_global or shape.global_batch // n_acc)
        batch = cell_batch(cfg, rows, shape.seq_len, device)
        if engine == "sharded":
            from repro_torch.train import sharded
            zero = overrides.get("zero", "1" if bucketed else "0") == "1" and bucketed
            m = sharded.Mesh(grid.axis("dp"))
            state = sharded.init_state(model, opt, 0, m, grad_compression=comp, device=device)
            loc = sharded.shard_state(state, m, zero_shard=zero)
            step = sharded.make_sharded_train_step(model, opt, m, remat=remat,
                                                   grad_compression=comp, zero_shard=zero,
                                                   donate=bucketed)
            meta.update(engine="sharded", zero_shard=zero)
        else:
            state = train_loop.init_state(model, opt, 0, grad_compression=comp, device=device)
            loc = grid_lib.shard_state(state, grid, fsdp, tp_mode)
            step = grid_lib.make_grid_train_step(model, opt, grid, fsdp=fsdp, tp_mode=tp_mode,
                                                 sp=sp, remat=remat, grad_compression=comp,
                                                 donate=bucketed)
            meta.update(engine="gspmd")
        del state
        return {"fn": step, "inputs": (loc, batch), "state_bytes": state_bytes(loc),
                "meta": meta}
    params = param_dict(model.init(0, device=device))
    grid_lib.check_grid(cfg, grid, tp_mode)
    pspecs = sh.state_shardings(params, grid, fsdp, tp_mode)
    local = sh.local_tree(params, pspecs, grid)
    del params
    sb = {"params": sum(t.numel() * t.element_size() for t in trace_lib.tensors_of(local))}
    cp = shape.mode == "decode" and shape.global_batch < grid.n_dp
    sharder = sh.make_activation_sharder(grid, sp=sp, context_parallel=cp)
    if shape.mode == "prefill":
        batch = cell_batch(cfg, (shape.global_batch,), shape.seq_len, device)
        batch.pop("labels")
        lb = sharder.local_batch(batch)

        def prefill(local, lb):
            with torch.no_grad(), tf.activation_sharding(sharder):
                mp = sh.materialize_serving(local, pspecs, grid, cfg)
                return model.prefill(mp, lb, cache_len=shape.seq_len)
        return {"fn": prefill, "inputs": (local, lb), "state_bytes": sb, "meta": meta}
    state = model.init_decode_state(shape.global_batch, shape.seq_len, device=device)
    lstate = sh.local_tree(state, sh.cache_shardings(state, grid, cp), grid)
    del state
    sb["cache"] = sum(t.numel() * t.element_size() for t in trace_lib.tensors_of(lstate))
    tok = {"token": torch.zeros((shape.global_batch, 1), dtype=torch.int64, device=device)}
    ltok = sharder.local_batch(tok)["token"]
    meta["context_parallel"] = bool(cp)

    def decode(local, inputs):
        with torch.no_grad(), tf.activation_sharding(sharder):
            mp = sh.materialize_serving(local, pspecs, grid, cfg)
            return model.decode_step(mp, inputs[0], inputs[1])
    return {"fn": decode, "inputs": (local, (lstate, ltok)), "state_bytes": sb, "meta": meta}


def trace_rank(cfg, shape, grid, precision: str = "C", fsdp: bool = True,
               overrides: Optional[dict] = None, n_acc: int = 1, mb_global: int = 0,
               lean: bool = True) -> dict:
    """One rank's step of the cell traced on the meta device → {"trace",
    "census", "state_bytes", "meta"}."""
    cell = cell_step(cfg, shape, grid, precision, fsdp, overrides, n_acc, mb_global)
    coll.reset_census()
    out, tr = trace_lib.record_step(cell["fn"], *cell["inputs"], device="meta", lean=lean)
    del out, cell["inputs"]
    return {"trace": tr, "census": list(coll.CENSUS), "state_bytes": cell["state_bytes"],
            "meta": cell["meta"]}


def census_by(census: list) -> dict:
    """Bytes a rank sent, by role and by "op:role"."""
    out: dict = {}
    for c in census:
        for k in (c["role"], f"{c['op']}:{c['role']}"):
            out[k] = out.get(k, 0) + c["bytes"]
    return out


def _axis_size(role: str, grid) -> int:
    if role in MODEL_ROLES:
        return grid.tp
    if role in ("metric", "amax"):
        return grid.size
    if role == "cp_combine":
        return grid.sizes.get("data", 1)
    return grid.n_dp


def wire_seconds(census: list, grid) -> dict:
    """Each collective's wire bytes a rank over its link: NVLink inside a
    node ("model"), the inter-node rate across nodes."""
    nv = cost_model.HW["nvlink_bw"]
    ib = cost_model.HW["internode_bw"]
    out = {"nvlink_bytes": 0.0, "internode_bytes": 0.0}
    for c in census:
        n = _axis_size(c["role"], grid)
        if n <= 1:
            continue
        b = c["bytes"]
        wire = {"all_gather": (n - 1) * b, "all_to_all": (n - 1) / n * b,
                "all_reduce_max": 2 * (n - 1) / n * b}.get(c["op"], (n - 1) * b)
        out["nvlink_bytes" if c["role"] in MODEL_ROLES else "internode_bytes"] += wire
    out["seconds"] = out["nvlink_bytes"] / nv + out["internode_bytes"] / ib
    return out


def _measure(res: dict, grid) -> dict:
    tr = res["trace"]
    cost = cost_model.model_step(tr)
    wire = wire_seconds(res["census"], grid)
    kcalls: dict = {}
    for k in tr.kernels:
        if k.kernel:
            kcalls[k.name] = kcalls.get(k.name, 0) + 1
    return {"flops": tr.flops(), "bytes": cost["bytes"], "compute_s": cost["serial_compute_s"],
            "memory_s": cost["serial_memory_s"], "aten_s": cost["modeled_step_s"]
            - cost["kernels_s"], "kernels_s": cost["kernels_s"], "collective_s": wire["seconds"],
            "nvlink_bytes": wire["nvlink_bytes"], "internode_bytes": wire["internode_bytes"],
            "peak": liveness.peak_hbm(tr)["peak_bytes_modeled"], "n_ops": tr.n_ops,
            "census": census_by(res["census"]), "kernel_calls": kcalls,
            "state_bytes": res["state_bytes"], "census_entries": len(res["census"])}


def lower_cell(arch: str, shape_name: str, grid, precision: str = "C", fsdp: bool = True,
               overrides: Optional[dict] = None, full_depth: bool = False) -> tuple:
    """Trace one rank of the cell (the reference's ``lower_cell``, read as
    "trace one rank") → (cfg, shape, measured terms, meta). Unless
    ``full_depth``, at 1 and 2 repeats (and chunks), extrapolated."""
    overrides = overrides or {}
    cfg, shape = cell_config(arch, shape_name, overrides)
    if cfg.attention_impl == "flash" and shape.mode != "decode" and "flashmin" not in overrides:
        cfg = dataclasses.replace(cfg, flash_min_len=shape.seq_len)
    n_acc, mb_global = (1, shape.global_batch)
    if shape.mode == "train":
        n_acc, mb_global = accum_plan(cfg, shape, grid.n_dp)
        if "accum" in overrides:
            n_acc = int(overrides["accum"])
            mb_global = shape.global_batch // n_acc
    R = repeats_of(cfg)
    t0 = time.time()
    if full_depth or R <= 2:
        res = trace_rank(cfg, shape, grid, precision, fsdp, overrides, n_acc, mb_global)
        got = _measure(res, grid)
        meta = dict(res["meta"], depth={"traced": "full", "repeats": R, "chunks": n_acc})
    else:
        runs, meta = {}, {}
        chunks = (1, 2) if n_acc > 1 else (1,)
        for r in (1, 2):
            for c in chunks:
                res = trace_rank(at_repeats(cfg, r), shape, grid, precision, fsdp, overrides,
                                 c, mb_global)
                runs[(r, c)] = _measure(res, grid)
                meta = res["meta"]
        got = {k: _bilinear({rc: v[k] for rc, v in runs.items()}, R, n_acc)
               for k in runs[(1, 1)] if k != "peak"}
        c = chunks[-1]              # chunks past the first hold the same live set
        got["peak"] = runs[(1, c)]["peak"] + (R - 1) * (runs[(2, c)]["peak"] - runs[(1, c)]["peak"])
        meta = dict(meta, depth={"traced": "repeats 1 and 2" + (", chunks 1 and 2"
                                                                  if n_acc > 1 else ""),
                                 "repeats": R, "chunks": n_acc,
                                 "traced_ops": sum(v["n_ops"] for v in runs.values())})
    meta.update(cards=grid.size, grad_accum=n_acc, microbatch_global=mb_global,
                trace_seconds=round(time.time() - t0, 1), flash_min_len=cfg.flash_min_len)
    return cfg, shape, got, meta


def analyze_cell(arch, shape_name, mesh_name, cfg, shape, got, meta) -> dict:
    """The report of one cell (the reference's ``analyze_cell``'s keys where
    they carry over)."""
    n_cards = meta.pop("cards")
    tokens, mflops = model_flops(cfg, shape)
    terms = {"compute_s": got["compute_s"], "memory_s": got["memory_s"],
             "kernels_s": got["kernels_s"], "collective_s": got["collective_s"]}
    dominant = max(terms, key=terms.get)
    card = cost_model.card()
    census = {k: int(round(v)) for k, v in got["census"].items()}
    return {
        "arch": arch, "shape": shape_name, "mesh": mesh_name, "chips": n_cards,
        "grid": dict(zip(*_axes(mesh_name))) if mesh_name in MESHES else mesh_name,
        "params": cfg.param_count(), "active_params": cfg.active_param_count(),
        "tokens_per_step": tokens, "model_flops_total": mflops,
        "per_device": {
            "traced_flops": got["flops"],
            "bytes_moved": got["bytes"],
            "state_bytes_by_role": {k: int(round(v)) for k, v in got["state_bytes"].items()},
            "peak_bytes_modeled": int(round(got["peak"])),
            "collective_bytes_by_role": {k: v for k, v in census.items() if ":" not in k},
            "collective_bytes_by_op": {k: v for k, v in census.items() if ":" in k},
            "wire_bytes_nvlink": got["nvlink_bytes"],
            "wire_bytes_internode": got["internode_bytes"],
            "kernel_calls": {k: int(round(v)) for k, v in got["kernel_calls"].items()},
            "traced_ops": int(round(got["n_ops"])),
        },
        "roofline_terms_s": terms,
        "aten_ops_s": got["aten_s"],
        "dominant": dominant,
        "useful_flops_ratio": (mflops / n_cards) / got["flops"] if got["flops"] else 0.0,
        "fits_80gb": got["peak"] <= HBM_LIMIT,
        "device": DEVICE_NOTE,
        "hardware": card or "modelled, H100 SXM data sheet",
        "hw_rates": {k: v for k, v in cost_model.HW.items() if k != "name"},
        **meta,
    }


def _axes(mesh_name: str) -> tuple:
    dp, tp, pods = MESHES[mesh_name]
    if pods > 1:
        return ("pod", "data", "model"), (pods, dp, tp)
    return ("data", "model"), (dp, tp)


def _out_path(outdir, mesh_name, arch, shape_name, variant) -> pathlib.Path:
    suffix = "__" + re.sub(r"[^\w=.-]", "_", variant) if variant else ""
    return pathlib.Path(outdir) / mesh_name / f"{arch}__{shape_name}{suffix}.json"


def run_cell(arch, shape_name, mesh_name, outdir=OUTDIR, precision="C", force=False, fsdp=True,
             variant="", full_depth=False, grid=None) -> dict:
    """Trace, analyse and write one cell → its record (a report, or
    ``skipped`` / ``refused``). ``grid``: another virtual grid than the
    mesh's (the tests' (2, 2))."""
    out = _out_path(outdir, mesh_name, arch, shape_name, variant)
    if out.exists() and not force:
        print(f"[cached] {mesh_name}/{arch}/{shape_name}")
        return json.loads(out.read_text())
    base = {"arch": arch, "shape": shape_name, "mesh": mesh_name, "variant": variant}
    if (arch, shape_name) in SKIP:
        rec = dict(base, skipped=SKIP[(arch, shape_name)])
    else:
        grid = grid or mesh_grid(mesh_name)
        t0 = time.time()
        try:
            cfg, shape, got, meta = lower_cell(arch, shape_name, grid, precision, fsdp,
                                               parse_variant(variant), full_depth)
        except (ValueError, NotImplementedError) as e:
            if not REFUSALS.search(str(e)):
                raise
            rec = dict(base, refused=str(e))
            print(f"[refused] {mesh_name}/{arch}/{shape_name}: {e}")
        else:
            meta["variant"] = variant
            rec = analyze_cell(arch, shape_name, mesh_name, cfg, shape, got, meta)
            rec["wall_seconds"] = round(time.time() - t0, 1)
            print(f"[ok] {mesh_name}/{arch}/{shape_name}: dominant={rec['dominant']} "
                  f"peak={rec['per_device']['peak_bytes_modeled'] / 2**30:.2f} GiB "
                  f"terms={ {k: f'{v:.3e}' for k, v in rec['roofline_terms_s'].items()} } "
                  f"({rec['wall_seconds']} s)")
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(rec, indent=1))
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--precision", default="C")
    ap.add_argument("--outdir", default=OUTDIR)
    ap.add_argument("--variant", default="")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    archs = ASSIGNED if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = ["single_pod", "multi_pod"] if (args.both_meshes or args.all) \
        else (["multi_pod"] if args.multi_pod else ["single_pod"])
    failures, counts = [], {"ok": 0, "skipped": 0, "refused": 0}
    t0 = time.time()
    for mesh_name in meshes:
        for arch in archs:
            for shape_name in shapes:
                try:
                    rec = run_cell(arch, shape_name, mesh_name, args.outdir, args.precision,
                                   args.force, variant=args.variant)
                    counts["skipped" if "skipped" in rec else
                           "refused" if "refused" in rec else "ok"] += 1
                except Exception:
                    failures.append((mesh_name, arch, shape_name))
                    print(f"[FAIL] {mesh_name}/{arch}/{shape_name}")
                    traceback.print_exc()
    print(f"dry-run: {counts['ok']} reports, {counts['skipped']} skipped, {counts['refused']} "
          f"refused, {len(failures)} failed in {time.time() - t0:.1f} s")
    if failures:
        raise SystemExit(f"dry-run failures: {failures}")


if __name__ == "__main__":
    main()

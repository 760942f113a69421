"""Precision-flow & memory audit script, the port of
``scripts/precision_audit.py`` (DESIGN.md §8).

Runs a matrix of (config × strategy × parallelism-mode) train cells through
the sharded engine (``train/sharded.py``) at one rank, traces one step of
each (``analysis.trace``) and runs the audit passes over it: the
no-master-copy census of the state it returns, its wide transients and
double-round chains, donation, liveness and the modelled cost. Writes one
JSON report.

  PYTHONPATH=src python -m repro_torch.launch.precision_audit [--quick] \\
      [--device cuda|cpu] [--out PATH]

The matrix is the JAX script's: gpt-tiny, granite-3-2b and
qwen3-moe-30b-a3b at smoke size × {C, SR} × {flat, zero, pipeline}, plus D
flat per arch and one gpt-tiny C ``pipeline_1f1b`` cell (22 cells;
``--quick``: gpt-tiny's 8). Every (16,16) cell must certify no
parameter-shaped f32 leaf in the state it returns, while the D cells report
their master copy (the detector's teeth); the C-vs-D memory gap comes from
the flat cells, the peak measured on the card (``--device cuda``) and
modelled on the CPU.

At one rank the ``zero`` cells hold each bucket whole (a shard of one); the
JAX script runs them on eight host devices, where a rank holds 1/8 of every
bucket: compare the totals, not the per-rank bytes. The ``pipeline`` cells
put their two stages on devices of this one rank, as the engine does on one
card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import time
from typing import Optional

import torch

from repro_torch.analysis import audit_cell, donated_storages, measured_peak, record_step
from repro_torch.analysis.cost_model import card
from repro_torch.analysis.source_lint import lint_paths
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.collage import CollageAdamW
from repro_torch.core.precision import BucketPolicy, PrecisionPolicy, parse_strategy
from repro_torch.data.synthetic import make_batch_fn
from repro_torch.device import resolve_device
from repro_torch.distributed import collectives as coll
from repro_torch.distributed import compression
from repro_torch.distributed import sharding as shard_lib
from repro_torch.models.model import build_model
from repro_torch.train import sharded

REPO = pathlib.Path(__file__).resolve().parents[3]

# one small dense, one mid dense (GQA), one MoE — the shapes that exercise
# every param-layout branch (flat buckets, tree/pipeline, expert tensors)
ARCHS = ("gpt-tiny", "granite-3-2b", "qwen3-moe-30b-a3b")
STRATEGIES_16BIT = ("C", "SR")

# parallelism modes for the 16-bit strategies; the D baseline runs flat
# tree-layout only (one master-copy witness per arch is enough)
MODES = {
    # flat dp in the tree layout, uncompressed wire: the SAME layout the D
    # baseline runs, so the memory gap below is strategy-only
    "flat": dict(bucketed="0", compress="none", smoke="1"),
    "zero": dict(bucketed="1", zero="1", compress="bf16_ef", smoke="1"),
    "pipeline": dict(bucketed="0", pipeline="pipe", accum="4", compress="none", smoke="1"),
}
D_OVERRIDES = dict(bucketed="0", smoke="1")
PIPE_STAGES = 2          # the JAX script's (2, 4) pipe × data mesh

# smoke-scale shapes of the audit (``launch/dryrun.py``'s AUDIT_SHAPES)
AUDIT_SHAPES = {"train_smoke": ShapeConfig("train_smoke", 128, 32, "train")}

RANKS_NOTE = ("one rank: a zero cell holds every bucket whole; the JAX script's eight "
              "host devices hold 1/8 each, so per-rank bytes differ by that factor and "
              "the totals compare")


def cell_config(arch: str, shape_name: str, overrides: Optional[dict] = None):
    """Per-cell model-config adjustments (``launch/dryrun.py``'s rules)."""
    overrides = overrides or {}
    cfg = get_config(arch, smoke=overrides.get("smoke", "0") == "1")
    shape = AUDIT_SHAPES[shape_name]
    if shape.seq_len >= 8192 and shape.mode != "decode":
        cfg = dataclasses.replace(cfg, attention_impl="flash")
    if cfg.family == "hybrid":
        cfg = dataclasses.replace(cfg, ssm_chunk=16)
    return cfg, shape


def accum_plan(cfg, shape, n_dp: int) -> tuple:
    """(grad_accum_steps, microbatch_global_rows): ≤ ~2 rows a device for
    wide models under remat (``launch/dryrun.py``'s plan)."""
    rows_per_dev = 4 if cfg.d_model <= 2048 else (2 if cfg.d_model <= 5376 else 1)
    if shape.seq_len > 4096:
        rows_per_dev = 1
    mb_global = max(rows_per_dev * n_dp, 1)
    n_acc = max(shape.global_batch // mb_global, 1)
    mb_global = shape.global_batch // n_acc
    return n_acc, mb_global


def _chunked(batch: dict, n_acc: int) -> dict:
    return {k: v.reshape((n_acc, v.shape[0] // n_acc) + tuple(v.shape[1:]))
            for k, v in batch.items()}


def audit_step(step, init, batches, *, strategy: str, device, donate: bool,
               n_dp: int = 1, timed: int = 1) -> tuple:
    """Trace one step (``batches[0]``) from the state ``init()`` makes and
    audit it; on the card then time ``timed`` more steps with the first
    one's peak measured → (the audit of the cell, the state, the last
    step's metrics). The traced step is the warm-up of the measured one.
    The initial state is made here so that no caller holds it: a step that
    is not donated then holds the state it was given and the one it
    builds, as in training, and no third."""
    dev = torch.device(device)
    state = init()
    donated = donated_storages(state, donate)
    coll.reset_census()
    (state, metrics), trace = record_step(step, state, batches[0], device=dev)
    census = list(coll.CENSUS)
    trace.require_backward()
    cell = audit_cell(trace, state, strategy=strategy, donated=donated, census=census,
                      n_dp=n_dp)
    cell["n_ops"], cell["n_backward_ops"] = len(trace.ops), trace.n_backward_ops
    cell["kernel_launches"] = {}
    for call in trace.kernels:
        cell["kernel_launches"][call.name] = cell["kernel_launches"].get(call.name, 0) + 1
    cell["measured_step_ms"] = None
    if dev.type == "cuda":
        ms = []
        for i in range(timed):
            b = batches[1 + i]
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

            def one():
                e0.record()
                out = step(state, b)
                e1.record()
                return out
            (state, metrics), peak, held = measured_peak(one)
            ms.append(e0.elapsed_time(e1))
            if i == 0:
                cell["liveness"].update(peak_bytes_measured=peak, held_before_bytes=held)
        cell["measured_step_ms"] = ms
    return cell, state, metrics


def build_cell(arch: str, strategy: str, overrides: dict, device):
    """(model, step, a function making the rank's initial state, the
    cell's batches, donate, meta) for one cell, as ``launch/dryrun.py``'s
    ``engine == "sharded"`` branch builds it, at one rank."""
    dev = resolve_device(device)
    axis = coll.Axis()
    cfg, shape = cell_config(arch, "train_smoke", overrides)
    model = build_model(cfg)
    bucketed = overrides.get("bucketed", "0") == "1"
    pipeline_axis = sharded.PIPE if overrides.get("pipeline") else None
    schedule = overrides.get("schedule", "gpipe")
    mesh = sharded.Mesh(dp=axis, pipe=(dev,) * PIPE_STAGES if pipeline_axis else ())
    bp = BucketPolicy(enabled=True, pad_multiple=shard_lib.bucket_pad_multiple(
        axis, block=compression.BLOCK)) if bucketed else BucketPolicy()
    opt = CollageAdamW(1e-4, b2=0.95, weight_decay=0.1,
                       policy=PrecisionPolicy(strategy=parse_strategy(strategy), bucketing=bp))
    comp = overrides.get("compress", "none")
    zero = overrides.get("zero", "1" if bucketed else "0") == "1" and bucketed
    n_acc, mb = accum_plan(cfg, shape, axis.size)
    if "accum" in overrides:
        n_acc = int(overrides["accum"])
        mb = shape.global_batch // n_acc
    step = sharded.make_sharded_train_step(
        model, opt, mesh, remat=overrides.get("remat", "full"), grad_compression=comp,
        zero_shard=zero, pipeline_axis=pipeline_axis, schedule=schedule, donate=bucketed)
    def init():
        return sharded.shard_state(
            sharded.init_state(model, opt, 0, mesh, grad_compression=comp,
                               pipeline_axis=pipeline_axis, device=dev),
            mesh, zero_shard=zero, pipeline_axis=pipeline_axis)
    batch_fn = make_batch_fn(cfg, shape, device=dev)
    batches = [_chunked(batch_fn(i), n_acc) for i in range(2)]
    meta = {"grad_accum": n_acc, "microbatch_global": mb, "zero_shard": zero,
            "pipeline_axis": pipeline_axis, "schedule": schedule if pipeline_axis else None,
            "compress": comp, "n_dp": axis.size}
    return model, step, init, batches, bucketed, meta


def run_one(arch: str, strategy: str, mode: str, overrides: dict, device) -> dict:
    t0 = time.time()
    _, step, init, batches, donate, meta = build_cell(arch, strategy, overrides, device)
    cell, _, _ = audit_step(step, init, batches, strategy=strategy, device=device,
                            donate=donate)
    pf, don, live, cost = (cell[k] for k in ("precision_flow", "donation", "liveness", "cost"))
    return {
        "strategy": strategy,
        "mode": mode,
        "sixteen_bit": pf["sixteen_bit"],
        **meta,
        # precision flow — hard invariant + advisory structural counts
        "n_param_f32_persistent": len(pf["param_f32_persistent"]),
        "param_f32_persistent": [x["name"] for x in pf["param_f32_persistent"]],
        "state_bytes": pf["state_bytes"],
        "f32_state_bytes": pf["f32_state_bytes"],
        "bytes_per_param": pf["bytes_per_param"],
        "f32_bytes_per_param": pf["f32_bytes_per_param"],
        "state_by_role": pf["by_role"],
        "transient_param_shaped_f32": pf["transient_param_shaped_f32"],
        "f32_arith_param_shaped": pf["f32_arith_param_shaped"],
        "double_round_chains": pf["double_round_chains"],
        "double_round_samples": pf["double_round_samples"],
        # donation
        "n_donated": don["n_donated"],
        "n_aliased": don["n_aliased"],
        "n_unrealized": len(don["unrealized"]),
        "unrealized": don["unrealized"],
        # liveness + modelled cost
        "peak_bytes_modeled": live["peak_bytes_modeled"],
        "peak_bytes_measured": live["peak_bytes_measured"],
        "held_before_bytes": live["held_before_bytes"],
        "param_bytes": live["param_bytes"],
        "modeled_step_s": cost["modeled_step_s"],
        "bound": cost["bound"],
        "measured_step_ms": cell["measured_step_ms"],
        "n_ops": cell["n_ops"],
        "n_backward_ops": cell["n_backward_ops"],
        "kernel_launches": cell["kernel_launches"],
        "ok": cell["ok"],
        "wall_seconds": round(time.time() - t0, 1),
    }


def matrix(archs=ARCHS) -> list:
    """[(key, arch, strategy, mode, overrides)] of the audit, in run order."""
    cells = []
    for arch in archs:
        for strategy in STRATEGIES_16BIT:
            for mode, ov in MODES.items():
                cells.append((f"{arch}/{strategy}/{mode}", arch, strategy, mode, ov))
        cells.append((f"{arch}/D/flat", arch, "D", "flat", D_OVERRIDES))
    # ONE 1F1B cell: the schedule interpreter's explicit backward is a
    # precision path of its own; the smallest arch under C keeps it short
    cells.append((f"{archs[0]}/C/pipeline_1f1b", archs[0], "C", "pipeline_1f1b",
                  dict(MODES["pipeline"], schedule="1f1b")))
    return cells


def run_audit(archs=ARCHS, quick: bool = False, device="cuda") -> dict:
    dev = resolve_device(device)
    cells = {}
    for key, arch, strategy, mode, ov in matrix(archs):
        print(f"[audit] {key} ...", flush=True)
        cells[key] = c = run_one(arch, strategy, mode, ov, dev)
        measured = c["peak_bytes_measured"]
        print(f"[audit] {key}: ok={c['ok']} state {c['state_bytes']} B "
              f"({c['bytes_per_param']:.3f} B/param), f32 leaves "
              f"{c['n_param_f32_persistent']}, peak modelled {c['peak_bytes_modeled']} B"
              f"{'' if measured is None else f', measured {measured} B'}"
              f", double rounds {c['double_round_chains']} ({c['wall_seconds']}s)", flush=True)

    # collage-vs-mixed memory gap, per arch, from the flat cells
    peak_key = "peak_bytes_measured" if dev.type == "cuda" else "peak_bytes_modeled"
    memory_gap = {}
    for arch in archs:
        c, d = cells.get(f"{arch}/C/flat"), cells.get(f"{arch}/D/flat")
        if not (c and d):
            continue
        memory_gap[arch] = {
            "state_bytes_collage": c["state_bytes"],
            "state_bytes_mixed": d["state_bytes"],
            "state_ratio": round(c["state_bytes"] / d["state_bytes"], 4),
            "peak_source": peak_key,
            "peak_collage": c[peak_key],
            "peak_mixed": d[peak_key],
            "peak_ratio": round(c[peak_key] / d[peak_key], 4),
            "peak_modeled_ratio": round(c["peak_bytes_modeled"] / d["peak_bytes_modeled"], 4),
        }

    lint = lint_paths(repo_root=str(REPO))
    sixteen = {k: c for k, c in cells.items() if c["sixteen_bit"]}
    mixed = {k: c for k, c in cells.items() if not c["sixteen_bit"]}
    ok = {
        "no_master_copy_all_16bit_cells":
            bool(sixteen) and all(c["ok"]["no_master_copy"] for c in sixteen.values()),
        "mixed_baseline_has_master_copy":
            bool(mixed) and all(c["n_param_f32_persistent"] > 0 for c in mixed.values()),
        "all_donations_realized":
            all(c["ok"]["all_donations_realized"] for c in cells.values()),
        "no_double_rounding":
            all(c["double_round_chains"] == 0 for c in cells.values()),
        "collage_state_smaller_than_mixed":
            bool(memory_gap) and all(g["state_ratio"] < 1.0 for g in memory_gap.values()),
        "collage_peak_hbm_below_mixed":
            bool(memory_gap) and all(g["peak_ratio"] < 1.0 for g in memory_gap.values()),
        "source_lint_clean": not lint,
    }
    return {
        "bench": "precision_audit",
        "quick": quick,
        "device": {"type": dev.type,
                   "name": torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu",
                   "card": card() if dev.type == "cuda" else None},
        "ranks": RANKS_NOTE,
        "n_cells": len(cells),
        "cells": cells,
        "memory_gap": memory_gap,
        "source_lint": {"n_findings": len(lint), "findings": lint},
        "ok": ok,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true", help="gpt-tiny only (8 cells)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="precision_audit.json")
    args = ap.parse_args(argv)
    archs = ARCHS[:1] if args.quick else ARCHS
    t0 = time.time()
    report = run_audit(archs, quick=args.quick, device=args.device)
    pathlib.Path(args.out).write_text(json.dumps(report, indent=1))
    failed = [k for k, v in report["ok"].items() if not v]
    print(f"[audit] wrote {args.out}: {report['n_cells']} cells in "
          f"{time.time() - t0:.0f}s; ok={report['ok']}")
    if failed:
        print(f"[audit] FAILED invariants: {failed}")
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

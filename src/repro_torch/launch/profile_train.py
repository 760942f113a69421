"""Where the time of a train step goes, on the card.

Runs the training workload of ``chip_smoke.py`` (by default gpt-125m,
Collage-plus C, bucketed, fused update, flash_min_len 256, B 8 × L 512;
``--arch``/``--layers``/``--batch``/``--seq-len``/``--remat`` give phases 8
and 9's families at their cut depth, with the donated step the launcher
uses) for 3 warm-up
steps, then ``--steps`` steps under ``torch.profiler``, and prints the wall
time, the device's busy share of it, and device time by kernel, grouped
(the port's kernels, bf16 and f32 GEMMs, softmax, the rest) and by name.
The profiler's own host cost stretches the wall (and so the idle share);
the device time per step is what it measures well.

  PYTHONPATH=src python -m repro_torch.launch.profile_train
  PYTHONPATH=src python -m repro_torch.launch.profile_train --arch qwen3-moe-30b-a3b --layers 2
  PYTHONPATH=src python -m repro_torch.launch.profile_train --arch rwkv6-1.6b --remat full
  PYTHONPATH=src python -m repro_torch.launch.profile_train --arch seamless-m4t-medium

The frontend families take ``make_batch_fn``'s seeded frontend stubs:
internvl2-1b's 256 patches fill part of ``--seq-len``, seamless-m4t's
1024 frames go through its encoder beside ``--seq-len`` tokens.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.launch import train as tlaunch
from repro_torch.launch.profile_serve import device_summary, is_gemm
from repro_torch.models.model import build_model
from repro_torch.models.transformer import REMAT_MODES
from repro_torch.train import train_loop


def _group(name: str) -> str:
    n = name.lower()
    for kernel in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "collage_update"):
        if kernel in n:
            return f"{kernel} kernel"
    if "collage_finish" in n:              # the update's sum over the tiles
        return "collage_update kernel"
    if is_gemm(n):
        if "sgemm" in n or "f32f32" in n:
            return "f32 GEMM (cuBLAS, CUDA cores)"
        # the lm_head products of an odd vocab (gpt-125m's 50257,
        # granite's 49155): rows not 16-byte aligned, so cuBLAS runs its
        # alignment-1 kernels
        return "bf16 GEMM, unaligned (lm_head)" if "align1" in n else "bf16 GEMM (cuBLAS)"
    if "softmax" in n:
        return "softmax / log_softmax"
    return "other (elementwise, reductions, copies, indexing)"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--arch", default="gpt-125m")
    ap.add_argument("--layers", type=int, default=None, help="depth cut (default: the config's)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=512)
    ap.add_argument("--remat", default="none", choices=REMAT_MODES)
    args = ap.parse_args(argv)
    targs = tlaunch.parser().parse_args([
        "--arch", args.arch, "--precision", "C", "--bucketed", "--fused-kernel",
        "--flash-min-len", "256", "--seq-len", str(args.seq_len), "--batch", str(args.batch),
        "--steps", str(3 + args.steps), "--warmup", "2", "--remat", args.remat])
    cfg, model, opt, step_fn, batch_fn, dev, _ = tlaunch.build(targs)
    if args.layers is not None:
        model = build_model(dataclasses.replace(cfg, n_layers=args.layers, flash_min_len=256))
        step_fn = train_loop.make_train_step(model, opt, flash_min_len=256, remat=args.remat,
                                             donate=True)
    state = train_loop.init_state(model, opt, targs.seed, device=dev)
    batches = [batch_fn(i) for i in range(3 + args.steps)]
    for b in batches[:3]:
        state, _ = step_fn(state, b)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in batches[3:]:
            state, metrics = step_fn(state, b)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    summary = device_summary(prof, wall_us, _group)
    summary["steps"] = args.steps
    summary["arch"], summary["layers"], summary["remat"] = args.arch, model.cfg.n_layers, args.remat
    summary["peak_bytes"] = torch.cuda.max_memory_allocated()
    summary["loss"] = float(metrics["loss"])
    print(json.dumps(summary, indent=1))
    return summary


if __name__ == "__main__":
    main()

"""Where the time of one closed-batch serve run goes, on the card.

Runs the serving workload of ``chip_smoke.py`` (gpt-125m, 8 ragged
requests with prompts 257–512, 32 greedy tokens, max_batch 8,
flash_min_len 256) once to warm up, then once under ``torch.profiler``,
and prints: the wall time, the device's busy share of it (union of kernel
intervals), and device time by kernel, grouped (flash kernel, GEMMs, the
rest) and by name. ``--trace`` writes the Chrome trace (over 64 MB for this run).

  PYTHONPATH=src python -m repro_torch.launch.profile_serve
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import os
import time

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_config
from repro_torch.launch.api import SamplingParams, make_engine
from repro_torch.launch.serve import synthetic_requests
from repro_torch.models.model import build_model


def is_gemm(lower_name: str) -> bool:
    """cuBLAS's matrix-product kernels, by name (``nvjet`` is its Hopper
    kernel family)."""
    return any(k in lower_name for k in ("gemm", "cutlass", "sm90_xmma", "cublas", "nvjet"))


def _group(name: str) -> str:
    n = name.lower()
    if "flash_fwd" in n:
        return "flash_fwd kernel"
    if is_gemm(n):
        return "GEMM (cuBLAS)"
    return "other (elementwise, reductions, copies, indexing)"


def device_summary(prof, wall_us: float, group) -> dict:
    """Wall time, device busy share (union of kernel intervals), launches,
    and device time by ``group(kernel name)`` and by kernel name."""
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        raise RuntimeError("torch.profiler recorded no device activity")
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    by_name = collections.Counter()
    counts = collections.Counter()
    for e in kernels:
        by_name[e.name] += e.time_range.end - e.time_range.start
        counts[e.name] += 1
    by_group = collections.Counter()
    for name, us in by_name.items():
        by_group[group(name)] += us
    return {
        "device": torch.cuda.get_device_name(0),
        "wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
        "device_idle_share": 1.0 - busy / wall_us, "kernel_launches": len(kernels),
        "by_group_ms": {g: us / 1e3 for g, us in by_group.most_common()},
        "top_kernels": [{"name": n[:90], "ms": us / 1e3, "calls": counts[n]}
                        for n, us in by_name.most_common(20)],
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--trace", default=None, help="write the Chrome trace here")
    ap.add_argument("--gen", type=int, default=32)
    args = ap.parse_args(argv)

    cfg = dataclasses.replace(get_config("gpt-125m"), flash_min_len=256)
    model = build_model(cfg)
    params = model.init(0, device="cuda")
    reqs = synthetic_requests(cfg.vocab_size, 8, 257, 512, seed=0)

    def run():
        eng = make_engine(model, params, mode="closed", sampling=SamplingParams(), max_batch=8)
        return eng.run(reqs, args.gen)

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()                                   # ends in a host copy: synchronised
        wall_us = (time.perf_counter() - t0) * 1e6
    summary = device_summary(prof, wall_us, _group)
    print(json.dumps(summary, indent=1))
    if args.trace:
        os.makedirs(os.path.dirname(os.path.abspath(args.trace)), exist_ok=True)
        prof.export_chrome_trace(args.trace)
    return summary


if __name__ == "__main__":
    main()

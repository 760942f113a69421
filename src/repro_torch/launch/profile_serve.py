"""Where the time of serving goes, on the card.

Closed engine (default): runs the serving workload of ``chip_smoke.py``
(gpt-125m, 8 ragged requests with prompts 257–512, 32 greedy tokens,
max_batch 8, flash_min_len 256) once to warm up, then once under
``torch.profiler``, and prints: the wall time, the device's busy share of
it (union of kernel intervals), and device time by kernel, grouped (flash
kernel, GEMMs, the rest) and by name. ``--trace`` writes the Chrome trace
(over 64 MB for this run).

``--continuous``: the slot arena of ``chip_smoke.py``'s serve_continuous
phase (gpt-125m, its trace's first 8 requests prefilled into 8 slots of
576 positions, 4 a prefill launch) and one decode segment of 16 steps
traced the same way, with the launches per decode step; with
``--speculative-draft {self,layers:N}`` also one speculative round (the
draft's proposal of 4 tokens, then the target's verify), each half traced
on its own.

``--arch A [--layers N] [--experts E]`` serves another arch (depth and
expert count cut as given) instead of gpt-125m; recurrent archs (rwkv6,
jamba) batch by exact prompt length, so their arena is prefilled one
request a launch, each at its own length; VLM and enc-dec archs
(internvl2, seamless-m4t) get the synthetic corpus's frontend stubs on
every request, and a VLM's cache rows its F prefix positions more.

  PYTHONPATH=src python -m repro_torch.launch.profile_serve
  PYTHONPATH=src python -m repro_torch.launch.profile_serve --continuous \
      --speculative-draft layers:6
  PYTHONPATH=src python -m repro_torch.launch.profile_serve --continuous --arch rwkv6-1.6b
  PYTHONPATH=src python -m repro_torch.launch.profile_serve --continuous \
      --arch jamba-1.5-large-398b --layers 8 --experts 4
  PYTHONPATH=src python -m repro_torch.launch.profile_serve --arch internvl2-1b
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
from repro_torch.launch.serve import (_bucket_len, attach_frontends, draft_from_target,
                                      poisson_requests, synthetic_requests)
from repro_torch.models.model import build_model

# the serve_continuous trace of chip_smoke.py: benchmarks/decode.py's
# serving trace at gpt-125m's prompt lengths (one 512 bucket)
TRACE = dict(n=24, lo=257, hi=512, gen_lo=4, gen_hi=64, rate=2.0, seed=0)
ENGINE = dict(max_slots=8, seg_len=16, prefill_batch=4)
SPEC_K = 4


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


def trace_requests(vocab_size: int):
    t = TRACE
    return poisson_requests(vocab_size, t["n"], t["lo"], t["hi"], t["gen_lo"], t["gen_hi"],
                            t["rate"], seed=t["seed"])


def model_requests(model, reqs):
    """``reqs`` with the synthetic frontend stubs where ``model`` needs them."""
    return attach_frontends(reqs, model.cfg) if model.needs_frontend else reqs


def cache_len(prefix: int = 0) -> int:
    """The trace's cache length, after a VLM's ``prefix`` of patch positions."""
    return prefix + _bucket_len(TRACE["hi"]) + TRACE["gen_hi"]


def fixed_slot_state(model, params, draft_model, draft_params, reqs):
    """The first ``max_slots`` requests of ``reqs`` written into a fresh
    arena (and the draft's pool) in prefill launches of ``prefill_batch``,
    each with budget ``gen_hi``: a full pool, every slot live. Returns
    (slots, draft, batch, prompt_lens) with the padded (max_slots, bucket)
    batch. A recurrent model (no draft) is prefilled one request a launch
    at its exact length; its draft and batch are None. Requests of a VLM
    or enc-dec arch carry frontends, which the batch stacks."""
    n, pb, S = ENGINE["max_slots"], ENGINE["prefill_batch"], cache_len(model._prefix_len)
    dev = params.device
    if model._has_recurrent_state():
        slots = model.init_slot_state(n, S, device=dev)
        for i, r in enumerate(reqs[:n]):
            toks = torch.as_tensor(r.tokens, dtype=torch.int64, device=dev)[None]
            model.prefill_into(params, slots, {"tokens": toks}, [i], [TRACE["gen_hi"]],
                               cache_len=S)
        return slots, None, None, None
    toks = torch.zeros((n, _bucket_len(TRACE["hi"])), dtype=torch.int64)
    for i, r in enumerate(reqs[:n]):
        toks[i, :len(r.tokens)] = torch.as_tensor(r.tokens)
    toks = toks.to(dev)
    lens = torch.tensor([len(r.tokens) for r in reqs[:n]], device=dev)
    full = {"tokens": toks}
    if model.needs_frontend:
        full["frontend"] = torch.stack([torch.as_tensor(r.frontend) for r in reqs[:n]]).to(dev)
    slots = model.init_slot_state(n, S, device=dev)
    draft = draft_model.init_decode_state(n, S, device=dev)
    for g0 in range(0, n, pb):
        rows = slice(g0, g0 + pb)
        batch = {k: v[rows] for k, v in full.items()}
        sidx = list(range(g0, g0 + pb))
        model.prefill_into(params, slots, batch, sidx, [TRACE["gen_hi"]] * pb, cache_len=S,
                           prompt_lens=lens[rows])
        draft_model.prefill_state_into(draft_params, draft, batch, sidx, cache_len=S,
                                       prompt_lens=lens[rows])
    return slots, draft, full, lens


def _profiled(fn, make_args):
    """``fn(*make_args())`` once to warm up, then once under the profiler
    (the arguments made outside it) → device_summary."""
    fn(*make_args())
    args = make_args()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn(*args)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    return device_summary(prof, wall_us, _group)


def profile_continuous(cfg, draft_spec=None) -> dict:
    model = build_model(cfg)
    if draft_spec and model._has_recurrent_state():
        raise ValueError(f"{cfg.name}: no speculative round for a recurrent arch")
    params = model.init(0, device="cuda")
    dm, dp = (None, None) if model._has_recurrent_state() else \
        draft_from_target(model, params, draft_spec or "self")
    slots, draft, _, _ = fixed_slot_state(model, params, dm, dp,
                                          model_requests(model, trace_requests(cfg.vocab_size)))
    seg_len = ENGINE["seg_len"]
    out = {"segment": _profiled(
        lambda s: model.decode_segment(params, s, seg_len=seg_len, eos_id=1),
        lambda: (slots.clone(),))}
    out["segment"]["launches_per_decode_step"] = out["segment"]["kernel_launches"] / seg_len
    if draft_spec:
        out["draft"] = draft_spec
        out["propose"] = _profiled(
            lambda d, s: dm.draft_propose(dp, d, s.tok, s.state.pos, s.run, spec_k=SPEC_K),
            lambda: (draft.clone(), slots))
        out["verify"] = _profiled(
            lambda s, props: model.spec_verify(params, s, props, eos_id=1),
            lambda: (slots.clone(), slots.tok.repeat(1, SPEC_K)))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--trace", default=None, help="write the Chrome trace here (closed engine)")
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--continuous", action="store_true",
                    help="profile one decode segment of the continuous engine's slot arena")
    ap.add_argument("--speculative-draft", default=None,
                    help="with --continuous: also one speculative round with this draft "
                         "(self | layers:N)")
    ap.add_argument("--arch", default="gpt-125m")
    ap.add_argument("--layers", type=int, default=None, help="depth cut (default: the config's)")
    ap.add_argument("--experts", type=int, default=None,
                    help="n_experts cut (default: the config's)")
    args = ap.parse_args(argv)
    cfg = dataclasses.replace(get_config(args.arch), flash_min_len=256)
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    if args.experts is not None:
        cfg = dataclasses.replace(cfg, n_experts=args.experts)
    if args.continuous:
        summary = profile_continuous(cfg, args.speculative_draft)
        summary["arch"], summary["layers"] = args.arch, cfg.n_layers
        print(json.dumps(summary, indent=1))
        return summary

    model = build_model(cfg)
    params = model.init(0, device="cuda")
    reqs = model_requests(model, synthetic_requests(cfg.vocab_size, 8, 257, 512, seed=0))

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

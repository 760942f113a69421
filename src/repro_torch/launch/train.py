"""Training launcher, the port of ``repro.launch.train``'s single-program
path: builds the model, the Collage optimizer and the train step, and runs
``--steps`` steps on the synthetic corpus through ``RunSupervisor``
(checkpointing, crash recovery, straggler records).

  PYTHONPATH=src python -m repro_torch.launch.train --arch gpt-125m \\
      --precision C --bucketed --fused-kernel --flash-min-len 256 \\
      --seq-len 512 --batch 8 --steps 8 [--ckpt-dir D [--ckpt-every N] [--resume]] \\
      [--remat {none,full,dots}]
  PYTHONPATH=src python -m repro_torch.launch.train --arch gpt-tiny --smoke \\
      --device cpu --steps 3 --bucketed --seq-len 32 --batch 4
  PYTHONPATH=src python -m repro_torch.launch.train --arch gpt-125m \\
      --precision D --flash-min-len 256 --seq-len 512 --batch 8 --steps 8
  PYTHONPATH=src python -m repro_torch.launch.train --arch internvl2-1b \\
      --bucketed --fused-kernel --flash-min-len 256 --seq-len 512 --batch 8 --steps 6

Every ``--arch`` of the registry runs here; the frontend families' batches
carry seeded frontend stubs (a VLM's patches take ``frontend_len`` of the
``--seq-len`` positions). ``--device`` defaults to ``cuda`` and raises
without a card. Without
``--bucketed`` the tree layout steps each leaf on its own, under any
``--precision`` (A, B, C, KAHAN, SR, D-MW, D), with each leaf's EDQ
partials from the CUDA EDQ kernel; ``--fused-kernel`` runs the CUDA Collage
update instead (one launch per bucket per step; on the tree layout the
buckets are rebuilt every step). The bucketed step writes the new state
over the old buckets (a donated step: one copy of the optimizer state on
the card). ``--flash-min-len N`` runs the flash
forward and backward kernels for sequences of at least N. ``--remat``
rematerialises each decoder layer in the backward pass. On the CPU the
same flags run the kernels' plain versions.

Checkpoints (the JAX package's format, ``train.checkpoint``) are written
only with ``--ckpt-dir``: every ``--ckpt-every`` steps (default 100) and at
the last step; ``--resume`` continues from the latest one there. (The JAX
launcher defaults to a fixed directory under /tmp; the port writes nothing
unless asked, so that runs in parallel never share a directory.)
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.collage import CollageAdamW, cosine_schedule
from repro_torch.core.precision import BucketPolicy, PrecisionPolicy, parse_strategy
from repro_torch.data.synthetic import make_batch_fn
from repro_torch.device import resolve_device
from repro_torch.models.model import build_model
from repro_torch.models.transformer import REMAT_MODES
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train import train_loop
from repro_torch.train.elastic import RunSupervisor, SupervisorConfig


def _refuse_unported(args):
    unported = [
        (args.dp > 1, "--dp > 1"),
        (args.zero, "--zero"),
        (args.pipeline_stages > 1, "--pipeline-stages > 1"),
        (args.grad_compression != "none", f"--grad-compression {args.grad_compression}"),
        (args.xla_latency_hiding, "--xla-latency-hiding"),
    ]
    for given, flag in unported:
        if given:
            raise NotImplementedError(f"{flag}: not yet ported to repro_torch")


def build(args):
    dev = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    shape = ShapeConfig("custom", args.seq_len, args.batch, "train")
    model = build_model(cfg)
    policy = PrecisionPolicy(strategy=parse_strategy(args.precision),
                             bucketing=BucketPolicy(enabled=args.bucketed))
    opt = CollageAdamW(cosine_schedule(args.lr, args.warmup, args.steps), b1=0.9, b2=args.b2,
                       weight_decay=args.weight_decay, policy=policy,
                       compute_metrics=not args.no_metrics, use_fused_kernel=args.fused_kernel,
                       sr_seed=args.sr_seed)
    step_fn = train_loop.make_train_step(model, opt, microbatch=args.microbatch,
                                         remat=args.remat,
                                         grad_compression=args.grad_compression,
                                         flash_min_len=args.flash_min_len,
                                         donate=args.bucketed)
    batch_fn = make_batch_fn(cfg, shape, seed=args.seed, device=dev)
    return cfg, model, opt, step_fn, batch_fn, dev


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gpt-tiny")
    ap.add_argument("--precision", default="C")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--lr", type=float, default=6e-4)
    ap.add_argument("--b2", type=float, default=0.95)
    ap.add_argument("--weight-decay", type=float, default=0.1)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--remat", default="none", choices=REMAT_MODES,
                    help="rematerialise each decoder layer in the backward pass")
    ap.add_argument("--grad-compression", default="none")
    ap.add_argument("--fused-kernel", action="store_true",
                    help="the fused Collage update (CUDA kernel on the card)")
    ap.add_argument("--bucketed", action="store_true",
                    help="persistent flat-bucket params/opt-state")
    ap.add_argument("--dp", type=int, default=1)
    ap.add_argument("--zero", action="store_true")
    ap.add_argument("--pipeline-stages", type=int, default=1)
    ap.add_argument("--schedule", default="gpipe", choices=("gpipe", "1f1b", "interleaved"))
    ap.add_argument("--virtual-stages", type=int, default=1)
    ap.add_argument("--xla-latency-hiding", action="store_true")
    ap.add_argument("--sr-seed", type=int, default=0,
                    help="stochastic-rounding noise seed (--precision SR)")
    ap.add_argument("--flash-min-len", type=int, default=None,
                    help="causal self-attention through the flash kernels when "
                         "seq_len >= this (0 = masked path, unset = config default)")
    ap.add_argument("--no-metrics", action="store_true")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None,
                    help="write checkpoints here (none without it)")
    ap.add_argument("--ckpt-every", type=int, default=None,
                    help="steps between checkpoints (default 100; needs --ckpt-dir)")
    ap.add_argument("--resume", action="store_true",
                    help="continue from the latest checkpoint in --ckpt-dir")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--metrics-out", default=None)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def main(argv=None):
    ap = parser()
    args = ap.parse_args(argv)
    _refuse_unported(args)
    if args.ckpt_dir is None and (args.resume or args.ckpt_every is not None):
        ap.error("--resume and --ckpt-every need --ckpt-dir")
    cfg, model, opt, step_fn, batch_fn, dev = build(args)
    state = train_loop.init_state(model, opt, args.seed, args.grad_compression, device=dev)
    start = 0
    if args.resume:
        latest = ckpt_lib.latest_step(args.ckpt_dir)
        if latest is not None:
            state, extra = ckpt_lib.restore_bucketed(args.ckpt_dir, latest, state)
            start = extra["step"]
            print(f"resumed from step {start}")
    every = 100 if args.ckpt_every is None else args.ckpt_every
    sup = RunSupervisor(SupervisorConfig(args.ckpt_dir, every))
    history = []
    t0 = time.time()

    def logged_step(state, batch):
        state, metrics = step_fn(state, batch)
        step = int(state.opt_state.step)
        if step % args.log_every == 0 or step == 1:
            m = {k: float(v) for k, v in metrics.items()}
            m["step"] = step
            history.append(m)
            print(f"step {step:5d} loss {m['loss']:.4f} ppl {m['ppl']:.2f} "
                  f"edq {m.get('edq', 0):.3e} impr% {m.get('imprecision_pct', 0):.2f}")
        return state, metrics

    state, step, _ = sup.run(state, logged_step, batch_fn, args.steps, start_step=start)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.time() - t0
    tok = args.batch * args.seq_len * (step - start)
    print(f"done: {step} steps, {dt:.1f}s, {tok / max(dt, 1e-9):.0f} tok/s")
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            json.dump(history, f)
    return history


if __name__ == "__main__":
    main()

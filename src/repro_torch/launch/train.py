"""Training launcher, the port of ``repro.launch.train``: builds the
model, the Collage optimizer and the train step, and runs ``--steps`` steps
on the synthetic corpus through ``RunSupervisor`` (checkpointing, crash
recovery, straggler records).

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

Distributed (``train.sharded``): ``--dp N`` runs one process per rank
under ``torchrun --nproc-per-node N`` (``--dp`` must equal ``WORLD_SIZE``;
``nccl`` for ``--device cuda``, one card per rank, ``gloo`` for ``cpu``),
``--zero`` ZeRO-shards the flat buckets (with ``--bucketed``; on by
default for bucketed ``--dp`` > 1), ``--grad-compression
bf16|bf16_ef|fp8|fp8_ef|fp8e5_ef`` compresses the gradient collective (a
local round trip without ``--dp``), and ``--pipeline-stages S --schedule
gpipe|1f1b|interleaved [--virtual-stages V] --microbatch MB`` runs the
pipeline with its S stages on this rank's device:

  torchrun --nproc-per-node 2 -m repro_torch.launch.train --device cpu \
      --arch gpt-tiny --smoke --dp 2 --zero --bucketed --grad-compression fp8_ef
  PYTHONPATH=src python -m repro_torch.launch.train --arch gpt-tiny --device cpu \
      --pipeline-stages 2 --schedule 1f1b --microbatch 2

``--xla-latency-hiding`` (an XLA scheduler flag) raises.

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
import datetime
import json
import os
import time

import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.collage import CollageAdamW, cosine_schedule
from repro_torch.core.precision import BucketPolicy, PrecisionPolicy, parse_strategy
from repro_torch.data.synthetic import make_batch_fn
from repro_torch.device import resolve_device
from repro_torch.distributed import collectives as coll
from repro_torch.distributed import compression
from repro_torch.distributed import sharding as shard_lib
from repro_torch.models.model import build_model
from repro_torch.models.transformer import REMAT_MODES
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train import sharded
from repro_torch.train import train_loop
from repro_torch.train.elastic import RunSupervisor, SupervisorConfig

# rendezvous and collective timeout of a torchrun group
DIST_TIMEOUT = datetime.timedelta(seconds=60)


def _refuse_unported(args):
    if args.xla_latency_hiding:
        raise NotImplementedError("--xla-latency-hiding: an XLA scheduler flag; "
                                  "repro_torch has no XLA (not ported, by design)")


def _mesh(args, dev):
    """The sharded engine's mesh, or None for the single-program step; joins
    the torchrun group when ``--dp`` > 1."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if args.dp != world:
        raise ValueError(f"--dp {args.dp} must equal WORLD_SIZE {world} "
                         f"(run it under torchrun --nproc-per-node {args.dp})")
    pipeline = args.pipeline_stages > 1
    if args.dp == 1 and not pipeline:
        return None
    axis = coll.Axis()
    if args.dp > 1:
        if not dist.is_initialized():
            dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                    timeout=DIST_TIMEOUT)
        axis = coll.Axis.of()
    return sharded.Mesh(dp=axis, pipe=(dev,) * args.pipeline_stages if pipeline else ())


def build(args):
    """(cfg, model, opt, step_fn, batch_fn, device, mesh) for ``args``;
    ``mesh`` is the sharded engine's (None for the single-program step),
    whose step carries its resolved ``zero_shard``."""
    dev = resolve_device(args.device)
    if dev.type == "cuda" and "LOCAL_RANK" in os.environ:
        dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(dev)
    cfg = get_config(args.arch, smoke=args.smoke)
    shape = ShapeConfig("custom", args.seq_len, args.batch, "train")
    model = build_model(cfg)
    mesh = _mesh(args, dev)
    pipeline_axis = sharded.PIPE if args.pipeline_stages > 1 else None
    bucket_policy = BucketPolicy(enabled=args.bucketed) if mesh is None else BucketPolicy(
        enabled=args.bucketed,
        pad_multiple=shard_lib.bucket_pad_multiple(mesh.dp, block=compression.BLOCK))
    policy = PrecisionPolicy(strategy=parse_strategy(args.precision), bucketing=bucket_policy)
    opt = CollageAdamW(cosine_schedule(args.lr, args.warmup, args.steps), b1=0.9, b2=args.b2,
                       weight_decay=args.weight_decay, policy=policy,
                       compute_metrics=not args.no_metrics, use_fused_kernel=args.fused_kernel,
                       sr_seed=args.sr_seed)
    if mesh is not None:
        # an explicit --zero passes True so the engine refuses what it cannot
        # shard; absent, it is on for bucketed dp > 1
        step_fn = sharded.make_sharded_train_step(
            model, opt, mesh, microbatch=args.microbatch, remat=args.remat,
            grad_compression=args.grad_compression, zero_shard=True if args.zero else None,
            pipeline_axis=pipeline_axis,
            schedule=args.schedule if pipeline_axis else "gpipe",
            virtual_stages=args.virtual_stages if pipeline_axis else 1,
            flash_min_len=args.flash_min_len, donate=args.bucketed)
    else:
        step_fn = train_loop.make_train_step(model, opt, microbatch=args.microbatch,
                                             remat=args.remat,
                                             grad_compression=args.grad_compression,
                                             flash_min_len=args.flash_min_len,
                                             donate=args.bucketed)
    batch_fn = make_batch_fn(cfg, shape, seed=args.seed, device=dev)
    if pipeline_axis is not None:
        if not args.microbatch:
            raise SystemExit("--pipeline-stages needs --microbatch (the schedule consumes "
                             "(n_micro, mb, L) chunked batches)")
        raw_batch_fn, mb = batch_fn, args.microbatch

        def batch_fn(i):
            return {k: v.reshape((v.shape[0] // mb, mb) + tuple(v.shape[1:]))
                    for k, v in raw_batch_fn(i).items()}
    return cfg, model, opt, step_fn, batch_fn, dev, mesh


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
    ap.add_argument("--dp", type=int, default=1,
                    help="data-parallel ranks (the sharded engine); must equal torchrun's "
                         "WORLD_SIZE; 1 = single-program step")
    ap.add_argument("--zero", action="store_true",
                    help="ZeRO-shard the flat buckets over the dp ranks (needs --bucketed)")
    ap.add_argument("--pipeline-stages", type=int, default=1,
                    help="pipeline stages on this rank's device (uniform decoder stacks; "
                         "needs --microbatch)")
    ap.add_argument("--schedule", default="gpipe", choices=("gpipe", "1f1b", "interleaved"))
    ap.add_argument("--virtual-stages", type=int, default=1,
                    help="virtual chunks per stage (interleaved schedule)")
    ap.add_argument("--xla-latency-hiding", action="store_true",
                    help="refused: an XLA scheduler flag")
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
    cfg, model, opt, step_fn, batch_fn, dev, mesh = build(args)
    pipeline_axis = sharded.PIPE if args.pipeline_stages > 1 else None
    save_fn = restore_fn = None
    if mesh is not None:
        vstages = args.virtual_stages if pipeline_axis else 1
        state = sharded.init_state(model, opt, args.seed, mesh,
                                   grad_compression=args.grad_compression,
                                   pipeline_axis=pipeline_axis, virtual_stages=vstages,
                                   device=dev)
        layout = dict(zero_shard=step_fn.zero_shard, pipeline_axis=pipeline_axis)
        state = sharded.shard_state(state, mesh, **layout)

        def save_fn(ckpt_dir, step, state, **kw):
            return ckpt_lib.save_sharded(ckpt_dir, step, state, mesh, **layout, **kw)

        def restore_fn(ckpt_dir, step, template):
            return ckpt_lib.restore_sharded(ckpt_dir, step, template, mesh, **layout)
    else:
        state = train_loop.init_state(model, opt, args.seed, args.grad_compression, device=dev)
    restore = restore_fn or ckpt_lib.restore_bucketed
    lead = mesh is None or mesh.dp.rank == 0
    start = 0
    if args.resume:
        latest = ckpt_lib.latest_step(args.ckpt_dir)
        if latest is not None:
            state, extra = restore(args.ckpt_dir, latest, state)
            start = extra["step"]
            if lead:
                print(f"resumed from step {start}")
    every = 100 if args.ckpt_every is None else args.ckpt_every
    sup = RunSupervisor(SupervisorConfig(args.ckpt_dir, every), save_fn=save_fn,
                        restore_fn=restore_fn)
    history = []
    t0 = time.time()

    def logged_step(state, batch):
        state, metrics = step_fn(state, batch)
        step = int(state.opt_state.step)
        if step % args.log_every == 0 or step == 1:
            m = {k: float(v) for k, v in metrics.items()}
            m["step"] = step
            history.append(m)
            if lead:
                print(f"step {step:5d} loss {m['loss']:.4f} ppl {m['ppl']:.2f} "
                      f"edq {m.get('edq', 0):.3e} impr% {m.get('imprecision_pct', 0):.2f}")
        return state, metrics

    state, step, _ = sup.run(state, logged_step, batch_fn, args.steps, start_step=start)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.time() - t0
    tok = args.batch * args.seq_len * (step - start)
    if lead:
        print(f"done: {step} steps, {dt:.1f}s, {tok / max(dt, 1e-9):.0f} tok/s")
    if args.metrics_out and lead:
        with open(args.metrics_out, "w") as f:
            json.dump(history, f)
    return history


if __name__ == "__main__":
    main()

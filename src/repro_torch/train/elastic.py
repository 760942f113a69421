"""Run supervisor: checkpointing, crash recovery and straggler records, the
port of ``repro.train.elastic``.

Policy (as the JAX package's):

1. per-step deadline = p99 of the recent step times × ``deadline_slack``
   (no deadline before 5 steps);
2. a step that misses its deadline but completes keeps its state; the
   faulting step is recorded in ``recoveries`` and ``stragglers``, and its
   time enters the window clamped to the deadline;
3. only a crash (a ``RuntimeError`` or ``TimeoutError`` out of the step)
   restores the latest checkpoint and continues from its step.

What the port adds: the card is never hidden. An error of the CUDA
runtime (``torch.AcceleratorError``, an out-of-memory error) or of a
kernel wrapper (a failed build or launch) is a ``RuntimeError`` too, but
restoring cannot cure it, and a retry on a faulted context can only repeat
or mask it: the supervisor re-raises those.

Without a checkpoint directory (``SupervisorConfig.ckpt_dir`` None) the
supervisor saves nothing, and a crash raises.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import torch

from repro_torch.kernels.build import KernelBuildError, KernelLaunchError
from repro_torch.train import checkpoint as ckpt_lib

# errors that a restore cannot cure
DEVICE_ERRORS = tuple(e for e in (getattr(torch, "AcceleratorError", None),
                                  torch.cuda.OutOfMemoryError, KernelBuildError,
                                  KernelLaunchError) if e is not None)


@dataclasses.dataclass
class SupervisorConfig:
    ckpt_dir: Optional[str]
    ckpt_every: int = 100
    keep_last: int = 3
    deadline_slack: float = 3.0
    min_step_time: float = 1e-3


class RunSupervisor:
    """Drives train steps with checkpointing and failure recovery.

    ``fault_hook(step)`` (tests) may raise to simulate a host crash.
    ``recoveries`` records the faulting step of every incident (crash or
    straggler), ``stragglers`` the deadline misses among them."""

    def __init__(self, cfg: SupervisorConfig, *,
                 fault_hook: Optional[Callable[[int], None]] = None,
                 save_fn: Optional[Callable] = None, restore_fn: Optional[Callable] = None):
        if cfg.ckpt_every < 1:
            raise ValueError(f"ckpt_every {cfg.ckpt_every} < 1")
        self.cfg = cfg
        self.fault_hook = fault_hook
        # the sharded engine's gather-then-write and read-then-shard
        self.save_fn = save_fn or ckpt_lib.save
        self.restore_fn = restore_fn or ckpt_lib.restore_bucketed
        self.recoveries: list[int] = []
        self.stragglers: list[int] = []
        self.step_times: list[float] = []

    def deadline(self) -> float:
        if len(self.step_times) < 5:
            return float("inf")
        recent = sorted(self.step_times[-50:])
        p99 = recent[min(len(recent) - 1, int(len(recent) * 0.99))]
        return max(p99, self.cfg.min_step_time) * self.cfg.deadline_slack

    def run(self, state, train_step, batch_fn, n_steps: int, start_step: int = 0,
            template=None):
        """Run to ``n_steps``, checkpointing and recovering on faults.
        ``template``: the restore template (default: the current state).
        Returns ``(state, step, last metrics)``."""
        step = start_step
        last_metrics = None
        ckpt_dir = self.cfg.ckpt_dir
        while step < n_steps:
            t0 = time.monotonic()
            try:
                if self.fault_hook is not None:
                    self.fault_hook(step)
                state, last_metrics = train_step(state, batch_fn(step))
            except DEVICE_ERRORS:
                raise
            except (RuntimeError, TimeoutError) as e:
                restore_step = None if ckpt_dir is None else ckpt_lib.latest_step(ckpt_dir)
                if restore_step is None:
                    raise RuntimeError("fault before first checkpoint") from e
                self.recoveries.append(step)
                tmpl = state if template is None else template
                state, extra = self.restore_fn(ckpt_dir, restore_step, tmpl)
                step = extra["step"]
                continue
            dt = time.monotonic() - t0
            deadline = self.deadline()
            if dt > deadline:
                self.recoveries.append(step)
                self.stragglers.append(step)
                self.step_times.append(deadline)
            else:
                self.step_times.append(dt)
            step += 1
            if ckpt_dir is not None and (step % self.cfg.ckpt_every == 0 or step == n_steps):
                self.save_fn(ckpt_dir, step, state, keep_last=self.cfg.keep_last,
                             extra={"step": step})
        return state, step, last_metrics

"""Fault-tolerance demo on the PyTorch/CUDA port: train with periodic
checkpoints, inject a simulated host crash mid-run, and watch the
supervisor restore and continue to a result bitwise-identical to an
uninterrupted run. The program of ``examples/fault_tolerant_training.py``
through ``repro_torch`` (``train_loop``, ``RunSupervisor``); it runs on the
card unless ``--device cpu`` is given.
  PYTHONPATH=src python examples/torch_fault_tolerant_training.py [--device cpu]
"""
import argparse
import shutil
import tempfile

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.collage import CollageAdamW
from repro_torch.core.precision import PrecisionPolicy, Strategy
from repro_torch.data.synthetic import make_batch_fn
from repro_torch.distributed import sharding as sh
from repro_torch.models.model import build_model
from repro_torch.train import train_loop
from repro_torch.train.elastic import RunSupervisor, SupervisorConfig


def main(argv=None) -> bool:
    ap = argparse.ArgumentParser(description="fault-tolerant training demo")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    cfg = get_config("gpt-tiny", smoke=True)
    model = build_model(cfg)
    opt = CollageAdamW(1e-3, b2=0.95, policy=PrecisionPolicy(strategy=Strategy.C_COLLAGE_PLUS))
    batch_fn = make_batch_fn(cfg, ShapeConfig("t", 64, 4, "train"), device=args.device)
    step = train_loop.make_train_step(model, opt)
    state0 = train_loop.init_state(model, opt, 0, device=args.device)
    ckpt_dir = tempfile.mkdtemp(prefix="repro_torch_ft_")
    armed = {"crash": True}

    def fault(i):
        if i == 12 and armed["crash"]:
            armed["crash"] = False
            print(f"!! simulated host failure at step {i}")
            raise RuntimeError("host down")

    try:
        sup = RunSupervisor(SupervisorConfig(ckpt_dir, ckpt_every=5), fault_hook=fault)
        final, _, _ = sup.run(state0, step, batch_fn, n_steps=20)
        print(f"recovered incidents (faulting steps): {sup.recoveries}")
        ref = state0
        for i in range(20):
            ref, _ = step(ref, batch_fn(i))
        same = all(torch.equal(a, b) for (_, a), (_, b) in
                   zip(sh.named_leaves(ref.params), sh.named_leaves(final.params)))
        print(f"bitwise-identical to uninterrupted run: {same}")
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    assert same
    return same


if __name__ == "__main__":
    main()

"""Card-only test of the grid: four ranks share one card as data 2 × model
2 (a gloo group over CUDA tensors; NCCL refuses two ranks on one device)
and train granite-3-2b smoke, widened to d 256 (head dim 64, one the
kernels take), through the flash kernels on their local heads; the step is held to the one-rank step of the same weights and batch
(the reference test's rule: loss within 2e-2 relative, ≥ 99 % of the
parameters within 2e-2·max(|θ|, 1)). It carries the ``cuda`` marker and
skips without a card; this file imports no JAX:

  PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_gspmd_cuda.py
"""

import os
import pathlib
import subprocess
import sys
import textwrap

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]

_RANK = """
import datetime, sys, torch, torch.distributed as dist
RANK, STORE = int(sys.argv[1]), sys.argv[2]
dist.init_process_group("gloo", store=dist.FileStore(STORE, 4), rank=RANK, world_size=4,
                        timeout=datetime.timedelta(seconds=120))
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.collage import CollageAdamW
from repro_torch.data.synthetic import make_batch_fn
from repro_torch.distributed import sharding as sh
from repro_torch.kernels.flash_attention import flash_attention as kflash
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models.model import build_model
from repro_torch.train import grid as grid_lib, train_loop
import dataclasses
cfg = dataclasses.replace(get_config("granite-3-2b", smoke=True), d_model=256)   # dh 64
model = build_model(cfg)
opt = CollageAdamW(1e-3, b2=0.95, compute_metrics=True)
g = mesh_lib.make_mesh(2, 2, device="cuda")
batch = make_batch_fn(cfg, ShapeConfig("t", 64, 8, "train"), device="cuda")(0)
s0 = train_loop.init_state(model, opt, 0, device="cuda")
s1, m1 = train_loop.make_train_step(model, opt, flash_min_len=16)(s0, batch)
kernels = (kflash.flash_fwd, kflash.flash_bwd_dq, kflash.flash_bwd_dkv)
for k in kernels:
    k.launches = 0
step = train_loop.make_train_step(model, opt, grid=g, flash_min_len=16)
s2, m2 = step(grid_lib.shard_state(s0, g), batch)
launches = {k.__name__: k.launches for k in kernels}
full = grid_lib.gather_state(s2, s0, g)
assert abs(float(m1["loss"]) - float(m2["loss"])) <= 2e-2 * abs(float(m1["loss"])), (m1, m2)
for (_, a), (_, b) in zip(sh.named_leaves(s1.params), sh.named_leaves(full.params)):
    a, b = a.float(), b.float()
    assert ((a - b).abs() <= 2e-2 * a.abs().clamp_min(1)).float().mean() > 0.99
assert all(v == cfg.n_layers for v in launches.values()), launches
dist.destroy_process_group()
print("GRID_CUDA_OK")
"""


@pytest.mark.cuda
def test_grid_train_step_on_one_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: four ranks share it as a data 2 × model 2 grid")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    store = str(tmp_path / "store")
    procs = [subprocess.Popen([sys.executable, "-c", textwrap.dedent(_RANK), str(r), store],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
             for r in range(4)]
    try:
        for p in procs:
            out, err = p.communicate(timeout=600)
            assert p.returncode == 0 and "GRID_CUDA_OK" in out, err[-6000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()

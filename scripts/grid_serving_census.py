"""Census bytes a rank of greedy serving on a (2, 2) grid, modelled on a
virtual rank (the meta device, no card, no processes).

  PYTHONPATH=src python scripts/grid_serving_census.py

Runs ``Model.generate`` (prefill + the decode steps) at full width on rank
(0, 0) of ``launch.mesh.virtual_grid(2, 2)`` for the serving runs of
``chip_smoke.py`` phases 15 and 17 (4 prompts of 512, 16 greedy tokens;
granite-3-2b 4 layers under tp_mode full, mlponly and none, rwkv6-1.6b 2
layers under none, seamless-m4t-medium 6 + 6 layers under full), each in
bf16 and f32, without and with sequence parallelism, and prints the bytes
each collective role records after ``materialize_serving``: what the card
run's census should read, counted from the leaves' shapes.
"""

import dataclasses

import torch

from repro_torch.configs import get_config
from repro_torch.distributed import collectives as coll
from repro_torch.distributed import sharding as sh
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import transformer as tf
from repro_torch.models.model import build_model, param_dict

N, PROMPT, GEN = 4, 512, 16
RUNS = [("granite-3-2b", 4, mode, 512) for mode in ("full", "mlponly", "none")] + \
    [("rwkv6-1.6b", 2, "none", 512), ("seamless-m4t-medium", 6, "full", 256)]


def census(arch, layers, dtype, mode, sp, flash) -> dict:
    """Bytes by role of one greedy ``generate`` on the virtual rank."""
    cfg = get_config(arch)
    over = dict(n_layers=layers, dtype=dtype, flash_min_len=flash if dtype == "bfloat16" else 0)
    if cfg.is_encdec:
        over["n_enc_layers"] = layers
    model = build_model(dataclasses.replace(cfg, **over))
    cfg = model.cfg
    g = mesh_lib.virtual_grid(2, 2, coords=(0, 0))
    params = param_dict(model.init(0, device="meta"))
    specs = sh.state_shardings(params, g, tp_mode=mode)
    local = sh.local_tree(params, specs, g)
    batch = {"tokens": torch.zeros((N, PROMPT), dtype=torch.int64, device="meta")}
    if model.needs_frontend:
        batch["frontend"] = torch.zeros((N, cfg.frontend_len, cfg.d_model),
                                        dtype=getattr(torch, dtype), device="meta")
    sharder = sh.make_activation_sharder(g, sp=sp)
    with torch.no_grad(), tf.activation_sharding(sharder):
        mp = sh.materialize_serving(local, specs, g, cfg)
        lb = sharder.local_batch(batch)
        coll.reset_census()
        model.generate(mp, lb, GEN, generator=torch.Generator())
    by_role: dict = {}
    for c in coll.CENSUS:
        by_role[c["role"]] = by_role.get(c["role"], 0) + c["bytes"]
    return dict(sorted(by_role.items()))


def main():
    for arch, layers, mode, flash in RUNS:
        for dtype in ("bfloat16", "float32"):
            for sp in (False, True):
                print(f"{arch} {layers} layers {dtype} tp_mode {mode} sp {sp}: census bytes by "
                      f"role {census(arch, layers, dtype, mode, sp, flash)}", flush=True)


if __name__ == "__main__":
    main()

"""Checkpoints in the JAX package's format, the port of
``repro.train.checkpoint``: a checkpoint either package writes, the other
restores bit for bit.

Format (one directory per step):

* ``step_%08d/arrays.npz``: array ``i`` of the state under the key
  ``a{i}``, bf16 stored as its uint16 bit view;
* ``step_%08d/manifest.json``: ``{"step", "arrays": {"a{i}": {"name",
  "shape", "dtype", "sha256"}}, "extra"}``, where ``name`` is the leaf's
  ``jax.tree_util.keystr`` path in the JAX package's ``TrainState``
  (``train_loop.TrainState.map_named`` gives the same names), ``dtype``
  the logical dtype (``"bfloat16"`` for a uint16 view) and ``sha256`` the
  hash of the logical bytes; a bucketed state adds ``extra.bucket_layout``.

A save writes ``step_N.tmp/`` and publishes it with one ``os.rename``, then
points ``latest`` at it with ``os.replace``, and keeps the last
``keep_last`` steps. Restore takes a template state, matches leaves by
name and verifies every checksum. The error-feedback residual
``grad_err`` may change shape or vanish across a restore: a template leaf
the checkpoint lacks, or one whose shape changed, is zero-filled and a
stored one the template lacks is dropped; any other mismatch raises.
``restore_bucketed`` migrates a checkpoint written under another bucket
partitioning onto the template's layout, bit-exactly.

``save_sharded``/``restore_sharded`` serve the sharded engine
(``train.sharded``): the ranks gather the global state (ZeRO shards
whole, one residual row per rank) and rank 0 writes it in this format;
a restore reads the global state and hands each rank its part. So a ZeRO
checkpoint restores into a single-rank run and the other way round
(residual rows of another rank count are zero-filled), in either package.

bf16 crosses numpy as uint16: this module needs no ml_dtypes.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
from typing import Optional

import numpy as np
import torch

from repro_torch.convert import tensor_to_numpy
from repro_torch.core import bucketing


class CheckpointError(ValueError):
    """A checkpoint that does not match its manifest or its template."""


def _is_grad_err(name: str) -> bool:
    return ".grad_err" in name


def _layout(state) -> Optional[bucketing.BucketLayout]:
    params = state.params
    return params.layout if isinstance(params, bucketing.BucketedParams) else None


def _step_dir(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step:08d}")


def _logical(leaf) -> tuple[np.ndarray, str]:
    """(the array as stored, its logical dtype name)."""
    if isinstance(leaf, torch.Tensor):
        arr = tensor_to_numpy(leaf)
        return arr, "bfloat16" if leaf.dtype == torch.bfloat16 else str(arr.dtype)
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def save(ckpt_dir: str, step: int, state, *, keep_last: int = 3,
         extra: Optional[dict] = None) -> str:
    """Persist ``state`` (a ``TrainState``) and the JSON-able ``extra`` for
    ``step``, atomically. Returns the step's directory."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = _step_dir(ckpt_dir, step)
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step, "arrays": {}, "extra": dict(extra or {})}
    layout = _layout(state)
    if layout is not None:
        manifest["extra"]["bucket_layout"] = layout.to_json()
    arrays = {}

    def put(name, leaf):
        arr, dtype = _logical(leaf)
        key = f"a{len(arrays)}"
        arrays[key] = arr
        manifest["arrays"][key] = {"name": name, "shape": list(arr.shape), "dtype": dtype,
                                   "sha256": hashlib.sha256(arr.tobytes()).hexdigest()}
        return leaf

    state.map_named(put)
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)                         # atomic publish
    with open(os.path.join(ckpt_dir, "latest.tmp"), "w") as f:
        f.write(str(step))
    os.replace(os.path.join(ckpt_dir, "latest.tmp"), os.path.join(ckpt_dir, "latest"))
    _gc(ckpt_dir, keep_last)
    return final


def _steps(ckpt_dir: str) -> list[int]:
    return sorted(int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
                  if d.startswith("step_") and not d.endswith(".tmp"))


def latest_step(ckpt_dir: str) -> Optional[int]:
    """The step ``latest`` points at; if that directory is gone, the newest
    one on disk; None when there is none."""
    p = os.path.join(ckpt_dir, "latest")
    if not os.path.exists(p):
        return None
    with open(p) as f:
        step = int(f.read().strip())
    if not os.path.isdir(_step_dir(ckpt_dir, step)):
        steps = _steps(ckpt_dir)
        return steps[-1] if steps else None
    return step


def _manifest(ckpt_dir: str, step: int) -> dict:
    with open(os.path.join(_step_dir(ckpt_dir, step), "manifest.json")) as f:
        return json.load(f)


def restore(ckpt_dir: str, step: int, template, *, verify: bool = True):
    """Load ``step`` into the structure, dtypes and devices of ``template``
    (a ``TrainState``). Returns ``(state, extra)``."""
    manifest = _manifest(ckpt_dir, step)
    by_name = {meta["name"]: key for key, meta in manifest["arrays"].items()}
    names = []
    template.map_named(lambda name, leaf: names.append(name) or leaf)
    extra_stored = [n for n in by_name if n not in set(names)]
    missing = [n for n in names if n not in by_name]
    bad = sorted(n for n in extra_stored + missing if not _is_grad_err(n))
    if bad:
        hint = ""
        if "bucket_layout" in manifest["extra"] and _layout(template) is None:
            hint = (" — the checkpoint holds a bucketed state; resume with --bucketed or "
                    "restore_bucketed()")
        raise CheckpointError(f"checkpoint/template structure mismatch on {bad}{hint}")

    with np.load(os.path.join(_step_dir(ckpt_dir, step), "arrays.npz")) as data:
        def load(name, t_leaf):
            key = by_name.get(name)
            shape = tuple(t_leaf.shape)
            if key is None:               # a grad_err leaf new to this layout
                arr = None
            else:
                meta = manifest["arrays"][key]
                arr = data[key]
                if verify and hashlib.sha256(arr.tobytes()).hexdigest() != meta["sha256"]:
                    raise CheckpointError(f"checksum mismatch for {name}")
                if meta["dtype"] == "bfloat16" and arr.dtype != np.uint16:
                    raise CheckpointError(f"{name}: bfloat16 stored as {arr.dtype}")
                if tuple(arr.shape) != shape:
                    if not _is_grad_err(name):
                        raise CheckpointError(f"{name}: stored shape {tuple(arr.shape)}, "
                                              f"template {shape}")
                    arr = None            # per-device residual rows of another layout
            if arr is None:
                return torch.zeros_like(t_leaf) if isinstance(t_leaf, torch.Tensor) \
                    else np.zeros_like(t_leaf)
            if not isinstance(t_leaf, torch.Tensor):          # a host int's array
                return arr.astype(t_leaf.dtype)
            t = torch.from_numpy(np.require(arr, requirements=["C", "W"]))
            if meta["dtype"] == "bfloat16":
                t = t.view(torch.bfloat16)
            return t.to(device=t_leaf.device, dtype=t_leaf.dtype)

        state = template.map_named(load)
    return state, manifest["extra"]


def restore_bucketed(ckpt_dir: str, step: int, template, *, verify: bool = True):
    """``restore``, and where the checkpoint was written under another
    bucket partitioning than ``template``'s, load it under the stored layout
    and migrate every role array onto the template's (bit-exact). A
    tree-layout checkpoint or template restores as ``restore`` does."""
    stored = _manifest(ckpt_dir, step)["extra"].get("bucket_layout")
    layout = _layout(template)
    if stored is None or layout is None or stored == layout.to_json():
        return restore(ckpt_dir, step, template, verify=verify)
    old_layout = bucketing.BucketLayout.from_json(stored, layout.treedef)
    old_template = bucketing.state_template_for_layout(template, old_layout)
    state, extra = restore(ckpt_dir, step, old_template, verify=verify)
    return bucketing.migrate(state, layout), extra


def save_sharded(ckpt_dir: str, step: int, state, mesh, *, zero_shard: bool,
                 pipeline_axis: Optional[str] = None, keep_last: int = 3,
                 extra: Optional[dict] = None) -> Optional[str]:
    """``save`` of a sharded engine's state: every rank calls it; the
    global state is gathered and rank 0 writes it. Returns rank 0's step
    directory (None on the other ranks)."""
    from repro_torch.train import sharded
    full = sharded.gather_state(state, mesh, zero_shard=zero_shard,
                                pipeline_axis=pipeline_axis)
    path = None
    if mesh.dp.rank == 0:
        path = save(ckpt_dir, step, full, keep_last=keep_last, extra=extra)
    if mesh.dp.distributed:
        torch.distributed.barrier(group=mesh.dp.group)
    return path


def restore_sharded(ckpt_dir: str, step: int, template, mesh, *, zero_shard: bool,
                    pipeline_axis: Optional[str] = None, verify: bool = True):
    """``restore_bucketed`` into a sharded engine's state: the global state
    is read (its template gathered from ``template``, this rank's part) and
    this rank keeps its part. Returns ``(state, extra)``."""
    from repro_torch.train import sharded
    kw = dict(zero_shard=zero_shard, pipeline_axis=pipeline_axis)
    full, extra = restore_bucketed(ckpt_dir, step, sharded.gather_state(template, mesh, **kw),
                                   verify=verify)
    return sharded.shard_state(full, mesh, **kw), extra


def _gc(ckpt_dir: str, keep_last: int):
    for s in _steps(ckpt_dir)[:-keep_last]:
        shutil.rmtree(_step_dir(ckpt_dir, s), ignore_errors=True)

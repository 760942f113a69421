"""Parameters of the JAX package → the port's ``ParamTree``.

``params_from_numpy`` takes the JAX parameter tree as nested dicts and
lists of numpy arrays (``jax.tree_util.tree_map(np.asarray, params)``) and
returns the port's parameters on ``device``. bf16 arrays arrive as
ml_dtypes ``bfloat16``; they are recognised by their dtype's name and moved
bit-exactly through a uint16 view, without importing ml_dtypes (the card's
machine has none).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device, torch_dtype
from repro_torch.models.model import ParamTree


def tensor_from_numpy(arr, device) -> torch.Tensor:
    arr = np.require(arr, requirements=["C", "W"])   # copies read-only JAX views
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def _tree(node, device):
    if isinstance(node, dict):
        return {k: _tree(v, device) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_tree(v, device) for v in node]
    return tensor_from_numpy(node, device)


def params_from_numpy(tree: dict, cfg: ModelConfig, device="cuda") -> ParamTree:
    dev = resolve_device(device)
    params = ParamTree(_tree(tree, dev))
    want = torch_dtype(cfg.dtype)
    for name, t in params.named_parameters():
        if t.dtype != want:
            raise TypeError(f"{name}: dtype {t.dtype}, config {cfg.name} stores {want}")
    return params

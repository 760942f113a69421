"""Parameters and bucketed optimizer state of the JAX package → the port's.

``params_from_numpy`` takes the JAX parameter tree as nested dicts and
lists of numpy arrays (``jax.tree_util.tree_map(np.asarray, params)``) and
returns the port's parameters on ``device``. bf16 arrays arrive as
ml_dtypes ``bfloat16``; they are recognised by their dtype's name and moved
bit-exactly through a uint16 view, without importing ml_dtypes (the card's
machine has none).

``bucketed_from_numpy`` takes a JAX ``BucketedParams`` + ``BucketedOptState``
as numpy buckets and the layout's ``to_json()``, and returns the port's,
bit-exactly; ``bucketed_to_numpy`` is its inverse (for the tests). Whole
train states cross between the packages through the checkpoint format
(``train.checkpoint``).

``opt_state_from_numpy`` takes a JAX tree-layout ``CollageOptState`` as
numpy trees (Expansion leaves of ``v`` as ``(hi, lo)`` tuples) and returns
the port's; ``opt_state_to_numpy`` is its inverse. The SR state is an int
seed in the port: a JAX threefry key ``[k0, k1]`` becomes ``k0 ^ k1`` (the
seed the JAX ``fused_step`` folds from it; ``PRNGKey(s)`` gives ``s``), and
goes back as ``[0, seed]`` (``seed_from_key``, ``key_from_seed``; the
checkpoint format stores the tree layout's seed so too).
"""

from __future__ import annotations

import numpy as np
import torch

import ast

from repro_torch.configs.base import ModelConfig
from repro_torch.core import bucketing
from repro_torch.core.collage import CollageOptState
from repro_torch.core.mcf import Expansion
from repro_torch.device import resolve_device, torch_dtype
from repro_torch.models.model import ParamTree


def key_from_seed(seed: int) -> np.ndarray:
    """The port's SR seed as the JAX package's threefry key: ``[0, seed]``,
    which is ``jax.random.PRNGKey(seed)``."""
    return np.array([0, int(seed) & bucketing.MASK32], np.uint32)


def seed_from_key(key) -> int:
    """A JAX threefry key ``[k0, k1]`` as the port's SR seed ``k0 ^ k1`` (the
    seed the JAX ``fused_step`` folds from it); the inverse of
    ``key_from_seed``."""
    k0, k1 = (int(k) for k in np.asarray(key, np.uint32).reshape(2))
    return k0 ^ k1


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


def skeleton_from_names(names) -> dict:
    """The nested dict/list skeleton of a tree from its leaves' ``keystr``
    paths (``['decoder']['groups'][0]['sub0']['wq']``), in leaf order."""
    root: dict = {}
    for name in names:
        keys = [ast.literal_eval(part) for part in name[1:-1].split("][")]
        node = root
        for key, nxt in zip(keys, keys[1:] + [None]):
            if nxt is None:
                node[key] = None
                break
            child = [] if isinstance(nxt, int) else {}
            if isinstance(node, list):
                while len(node) <= key:
                    node.append(child)
                node = node[key]
            else:
                node = node.setdefault(key, child)
    return root


def bucketed_from_numpy(layout_json: dict, data, m, vhi, vlo=None, delta=None, master=None, *,
                        step: int = 0, rng=None, device="cuda"):
    """JAX ``BucketedParams``/``BucketedOptState`` buckets (numpy arrays, one
    per bucket per role; None for a role the strategy lacks) and the layout's
    ``to_json()`` → the port's ``(BucketedParams, BucketedOptState)``."""
    dev = resolve_device(device)
    skel = skeleton_from_names([slot[0] for slot in layout_json["slots"]])
    layout = bucketing.BucketLayout.from_json(layout_json, skel)
    conv = lambda role: None if role is None else tuple(tensor_from_numpy(x, dev) for x in role)
    params = bucketing.BucketedParams(conv(data), layout)
    for b, spec in zip(params.data, layout.buckets):
        if b.shape != (spec.padded,) or bucketing.dtype_name(b.dtype) != spec.dtype:
            raise ValueError(f"bucket {tuple(b.shape)} {b.dtype} vs layout {spec}")
    state = bucketing.BucketedOptState(
        step=int(step), m=conv(m), vhi=conv(vhi), vlo=conv(vlo), delta=conv(delta),
        master=conv(master), rng=None if rng is None else int(rng) & bucketing.MASK32,
        layout=layout)
    return params, state


def tensor_to_numpy(t: torch.Tensor, bf16_dtype=np.uint16) -> np.ndarray:
    """A tensor as numpy; bf16 leaves as a uint16 bit view, viewed as
    ``bf16_dtype`` (e.g. ml_dtypes' bfloat16, which the caller brings)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16).view(bf16_dtype)
    return t.numpy()


def bucketed_to_numpy(bparams, bstate, bf16_dtype=np.uint16) -> dict:
    """Inverse of ``bucketed_from_numpy``: {"layout", "data", "m", "vhi",
    "vlo", "delta", "master", "step", "rng"}."""
    conv = lambda role: None if role is None else [tensor_to_numpy(x, bf16_dtype) for x in role]
    return {"layout": bparams.layout.to_json(), "data": conv(bparams.data), "m": conv(bstate.m),
            "vhi": conv(bstate.vhi), "vlo": conv(bstate.vlo), "delta": conv(bstate.delta),
            "master": conv(bstate.master), "step": bstate.step, "rng": bstate.rng}


def _opt_tree(node, device):
    """A numpy tree → tensors; a ``(hi, lo)`` tuple of arrays → Expansion."""
    if node is None:
        return None
    if isinstance(node, tuple) and len(node) == 2 and all(isinstance(x, np.ndarray)
                                                          for x in node):
        return Expansion(tensor_from_numpy(node[0], device), tensor_from_numpy(node[1], device))
    if isinstance(node, dict):
        return {k: _opt_tree(v, device) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_opt_tree(v, device) for v in node]
    return tensor_from_numpy(node, device)


def opt_state_from_numpy(step, m, v, delta=None, master=None, rng=None, *,
                         device="cuda") -> CollageOptState:
    """A JAX tree-layout ``CollageOptState`` (numpy trees; None for a role the
    strategy lacks) → the port's, bit-exactly. ``rng``: a JAX key (2 uint32),
    an int seed, or None."""
    dev = resolve_device(device)
    if rng is not None:
        key = np.asarray(rng, dtype=np.uint32).reshape(-1)
        rng = seed_from_key(key) if key.size == 2 else int(key[0])
    return CollageOptState(step=int(step), m=_opt_tree(m, dev), v=_opt_tree(v, dev),
                           delta=_opt_tree(delta, dev), master=_opt_tree(master, dev), rng=rng)


def _opt_tree_to_numpy(node, bf16_dtype):
    if node is None:
        return None
    if isinstance(node, Expansion):
        return (tensor_to_numpy(node.hi, bf16_dtype), tensor_to_numpy(node.lo, bf16_dtype))
    if isinstance(node, dict):
        return {k: _opt_tree_to_numpy(v, bf16_dtype) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_opt_tree_to_numpy(v, bf16_dtype) for v in node]
    return tensor_to_numpy(node, bf16_dtype)


def opt_state_to_numpy(state: CollageOptState, bf16_dtype=np.uint16) -> dict:
    """Inverse of ``opt_state_from_numpy``: {"step", "m", "v", "delta",
    "master", "rng"}; the SR seed as a JAX-style key ``[0, seed]``."""
    conv = lambda t: _opt_tree_to_numpy(t, bf16_dtype)
    rng = None if state.rng is None else key_from_seed(state.rng)
    return {"step": int(state.step), "m": conv(state.m), "v": conv(state.v),
            "delta": conv(state.delta), "master": conv(state.master), "rng": rng}

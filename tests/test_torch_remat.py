"""``remat`` in the port (models.transformer.group_apply, Model.loss,
train_loop.make_accum_grads) against itself and against the JAX package's
``loss(..., remat=)``, on gpt-smoke.

* The gradients of ``"none"``, ``"full"`` and ``"dots"`` are bit-identical
  to one another on the CPU, flash off and on (the flash autograd Function
  runs its forward again in the recompute), bucketed and tree layout:
  rematerialising recomputes the same operations on the same inputs.
* Each mode's f32 gradients match the JAX package's gradients of
  ``loss(..., remat=mode)`` at tests/test_torch_train.py's model-level
  tolerance (rtol 1e-3, atol 1e-5): ``jax.checkpoint`` changes no value
  either, so the two packages differ only in summation order.
* ``"full"`` recomputes a layer's products in the backward pass; ``"dots"``
  only its batched ones: the 2-D products' outputs are saved, as JAX's
  ``dots_with_no_batch_dims_saveable`` saves them.
"""

import collections
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_config as jax_config
from repro.configs.base import ShapeConfig as JShape
from repro.data.synthetic import make_batch_fn as jax_batch_fn
from repro.models.model import build_model as jax_build
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import bucketing
from repro_torch.core.collage import CollageAdamW
from repro_torch.core.precision import BucketPolicy, PrecisionPolicy, Strategy
from repro_torch.models.model import build_model
from repro_torch.train import train_loop as ttl

MODES = ["none", "full", "dots"]


def _batch(L=40, B=2):
    b = jax_batch_fn(jax_config("gpt-smoke", smoke=True), JShape("t", L, B, "train"))(0)
    return {k: np.asarray(v) for k, v in b.items()}


def _to_torch(batch):
    return {k: torch.from_numpy(v.astype(np.int64)) for k, v in batch.items()}


def _bf16_state(flash, bucketed):
    cfg = dataclasses.replace(get_config("gpt-smoke", smoke=True), flash_min_len=flash)
    model = build_model(cfg)
    opt = CollageAdamW(1e-3, policy=PrecisionPolicy(strategy=Strategy.C_COLLAGE_PLUS,
                                                    bucketing=BucketPolicy(enabled=bucketed)))
    return model, ttl.init_state(model, opt, 0, device="cpu")


def _grad_bits(grads):
    leaves = grads.data if isinstance(grads, bucketing.BucketedParams) \
        else bucketing.tree_leaves(grads)
    return [g.view(torch.int16) if g.dtype == torch.bfloat16 else g.view(torch.int32)
            for g in leaves]


@pytest.mark.parametrize("bucketed", [True, False])
@pytest.mark.parametrize("flash", [0, 16])
def test_remat_modes_give_bit_identical_gradients(flash, bucketed):
    model, state = _bf16_state(flash, bucketed)
    batch = _to_torch(_batch())
    out = {m: ttl.make_accum_grads(model, remat=m)(state.params, batch) for m in MODES}
    loss0, _, g0 = out["none"]
    for mode in ("full", "dots"):
        loss, _, g = out[mode]
        assert torch.equal(loss, loss0), mode
        assert all(torch.equal(a, b) for a, b in zip(_grad_bits(g), _grad_bits(g0))), mode


@functools.lru_cache(maxsize=None)
def _f32_pair(flash):
    kw = dict(dtype="float32", flash_min_len=flash, flash_block=16)
    jcfg = dataclasses.replace(jax_config("gpt-smoke", smoke=True), **kw)
    tcfg = dataclasses.replace(get_config("gpt-smoke", smoke=True), **kw)
    jm = jax_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tcfg, "cpu")
    return jm, jp, build_model(tcfg), tp


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("flash", [0, 16])
def test_remat_gradients_match_jax(flash, mode):
    jm, jp, tm, tp = _f32_pair(flash)
    batch = _batch()
    (jl, _), jg = jax.value_and_grad(lambda p: jm.loss(p, batch, remat=mode), has_aux=True)(jp)
    loss, _, grads = ttl.make_accum_grads(tm, remat=mode)(tp, _to_torch(batch))
    assert abs(float(loss) - float(jl)) < 1e-5
    jleaves = jax.tree_util.tree_leaves_with_path(jg)
    tleaves = bucketing.tree_flatten_with_path(grads)[0]
    assert [jax.tree_util.keystr(p) for p, _ in jleaves] == [p for p, _ in tleaves]
    for (path, a), (_, b) in zip(jleaves, tleaves):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-3, atol=1e-5,
                                   err_msg=f"{mode} {jax.tree_util.keystr(path)}")


class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.counts = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.counts[func] += 1
        return func(*args, **(kwargs or {}))


def test_what_each_mode_recomputes():
    """A layer's forward makes six 2-D products (q, k, v, wo, w_in, w_out)
    and two batched ones (the attention scores and P·V). ``full`` runs all
    of them again in the backward pass but the last: the output of w_out
    feeds only a residual add, which saves nothing, and the recompute stops
    once every saved tensor is back. ``dots`` saves the 2-D products'
    outputs and recomputes only the batched ones."""
    model, state = _bf16_state(0, True)
    batch = _to_torch(_batch())
    counts = {}
    for mode in MODES:
        with _CountOps() as c:
            ttl.make_accum_grads(model, remat=mode)(state.params, batch)
        counts[mode] = (c.counts[torch.ops.aten.mm.default], c.counts[torch.ops.aten.bmm.default])
    layers = model.cfg.n_layers
    mm, bmm = counts["none"]
    assert counts["full"] == (mm + 5 * layers, bmm + 2 * layers)
    assert counts["dots"] == (mm, bmm + 2 * layers)


def test_unknown_remat_mode_raises():
    model, state = _bf16_state(0, True)
    with pytest.raises(ValueError, match="remat"):
        ttl.make_accum_grads(model, remat="offload")
    with pytest.raises(ValueError, match="remat"):
        model.loss(state.params, _to_torch(_batch()), remat="everything")

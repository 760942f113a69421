"""Stack assembly for prefill / decode, the port of
``repro.models.transformer``.

Each ``Group(repeats, period)`` of the config's stack program holds its
parameters stacked over ``repeats`` (leading axis), as the JAX package
does; where the JAX package runs one ``lax.scan`` over that axis, the port
runs a Python loop over the layer index. The attn, mlp and moe sublayers
are ported; mamba, rwkv and cross-attention raise (the verify step raises
the JAX package's ``ValueError`` for the recurrent kinds). ``sub_apply``
and ``group_apply`` return the MoE aux loss beside the activations, summed
over the group's layers as the JAX package's scan carries it.
"""

from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import Group, ModelConfig, Sub
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_lib
from repro_torch.models.layers import ACC, dense_init, mlp_apply, rms_norm, rms_norm_init


def _not_ported(kind):
    return NotImplementedError(f"sublayer kind {kind!r}: not yet ported to repro_torch")


# ------------------------------------------------------------------- init --
def sub_init(gen, sub: Sub, cfg: ModelConfig, dtype, repeats: int):
    """Parameters of ``repeats`` stacked copies of one sublayer."""
    p = {"norm": rms_norm_init((repeats, cfg.d_model), dtype, gen.device)}
    if sub.kind == "attn":
        p.update(attn.attn_init(gen, cfg, dtype, repeats))
    elif sub.kind == "mlp":
        d, f = cfg.d_model, cfg.d_ff
        if cfg.act == "swiglu":
            p.update(w_gate=dense_init(gen, (repeats, d, f), dtype),
                     w_up=dense_init(gen, (repeats, d, f), dtype),
                     w_down=dense_init(gen, (repeats, f, d), dtype))
        else:
            p.update(w_in=dense_init(gen, (repeats, d, f), dtype),
                     w_out=dense_init(gen, (repeats, f, d), dtype))
    elif sub.kind == "moe":
        p.update(moe_lib.moe_init(gen, cfg, dtype, repeats))
    else:
        raise _not_ported(sub.kind)
    return p


def group_init(gen, group: Group, cfg: ModelConfig, dtype):
    return {f"sub{i}": sub_init(gen, s, cfg, dtype, group.repeats)
            for i, s in enumerate(group.period)}


def layer_params(group_params, layer: int) -> dict:
    """One layer's slice of a group's stacked parameters (views)."""
    return {key: {name: t[layer] for name, t in sub.items()}
            for key, sub in group_params.items()}


# ---------------------------------------------------------------- forward --
def sub_apply(p, x, sub: Sub, cfg: ModelConfig, positions=None):
    """Pre-norm residual sublayer: (x + f(rms_norm(x)), aux) where aux is
    the MoE aux loss (f32 scalar), None for the other kinds.
    Attention takes the flash kernels above ``cfg.flash_min_len``, else the
    config's ``attention_impl``: "banded" for windowed layers, "flash" (the
    blocked online softmax in torch) for causal ones, "masked" otherwise."""
    aux = None
    h = rms_norm(x, p["norm"], cfg.norm_eps)
    impl = cfg.attention_impl
    if sub.kind == "attn":
        if sub.causal and attn.use_flash(cfg, x.shape[1]):
            out = attn.kernel_flash_attention(p, h, cfg, causal=True, window=sub.window,
                                              positions=positions)
        elif sub.window and impl in ("banded", "flash") and sub.causal:
            out = attn.banded_attention(p, h, cfg, window=sub.window, positions=positions)
        elif impl == "flash" and sub.causal:
            out = attn.flash_attention(p, h, cfg, causal=True, window=sub.window,
                                       positions=positions)
        else:
            out = attn.full_attention(p, h, cfg, causal=sub.causal, window=sub.window,
                                      positions=positions)
    elif sub.kind == "mlp":
        out = mlp_apply(p, h, cfg.act)
    elif sub.kind == "moe":
        out, aux = moe_lib.moe_apply(p, h, cfg)
    else:
        raise _not_ported(sub.kind)
    return x + out, aux


REMAT_MODES = ("none", "full", "dots")

# "dots" keeps the outputs of the 2-D products (a (B, L, D) activation
# times a weight matrix reaches aten as mm): JAX's
# ``dots_with_no_batch_dims_saveable``. Batched products (the attention
# einsums), the flash kernels and everything elementwise are recomputed.
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def check_remat(remat: str):
    if remat not in REMAT_MODES:
        raise ValueError(f"remat {remat!r}: one of {REMAT_MODES}")


def group_apply(params, x, group: Group, cfg: ModelConfig, positions=None, remat: str = "none"):
    """Full-sequence forward through one group (loop over its layers) →
    (x, aux summed over the layers).

    ``remat`` rematerialises each layer's body in the backward pass, as the
    JAX package's ``jax.checkpoint`` of its scan body: "full" saves only
    the layer's input, "dots" also the outputs of its 2-D products."""
    check_remat(remat)

    def body(h, lp):
        aux = None
        for i, s in enumerate(group.period):
            h, a = sub_apply(lp[f"sub{i}"], h, s, cfg, positions=positions)
            if a is not None:
                aux = a if aux is None else aux + a
        return h, aux

    aux = None
    for layer in range(group.repeats):
        lp = layer_params(params, layer)
        if remat == "none":
            x, a = body(x, lp)
        elif remat == "full":
            x, a = checkpoint(body, x, lp, use_reentrant=False)
        else:
            x, a = checkpoint(body, x, lp, use_reentrant=False, context_fn=functools.partial(
                create_selective_checkpoint_contexts, _dots_policy))
        if a is not None:
            aux = a if aux is None else aux + a
    return x, (torch.zeros((), dtype=ACC, device=x.device) if aux is None else aux)


# ----------------------------------------------------------------- decode --
def sub_decode(p, x, sub: Sub, cfg: ModelConfig, cache, pos, active=None):
    """One-token step. Returns (x_out, cache or None); attention caches are
    updated in place (``attention.decode_attention``)."""
    h = rms_norm(x, p["norm"], cfg.norm_eps)
    if sub.kind == "attn":
        out, nc = attn.decode_attention(p, h, cfg, cache, pos, window=sub.window, active=active)
    elif sub.kind == "mlp":
        out, nc = mlp_apply(p, h, cfg.act), None
    elif sub.kind == "moe":
        out, nc = moe_lib.moe_decode_apply(p, h, cfg)[0], None
    else:
        raise _not_ported(sub.kind)
    return x + out, nc


def _group_step(sub_step, params, x, group: Group, cfg: ModelConfig, caches, pos, active):
    for layer in range(group.repeats):
        lp = layer_params(params, layer)
        for i, s in enumerate(group.period):
            key = f"sub{i}"
            cache = None
            if key in caches:
                cache = {name: t[layer] for name, t in caches[key].items()}
            x, _ = sub_step(lp[key], x, s, cfg, cache, pos, active=active)
    return x, caches


def group_decode(params, x, group: Group, cfg: ModelConfig, caches, pos, active=None):
    """Loop over layers carrying x; each layer's cache slice is written in
    place, so the returned caches are the ones passed in."""
    return _group_step(sub_decode, params, x, group, cfg, caches, pos, active)


def sub_verify(p, x, sub: Sub, cfg: ModelConfig, cache, pos, active=None):
    """Width-W verify step (speculative decoding): x (B, W, D) is the
    current token + draft proposals. Same contract as ``sub_decode``, every
    sublayer over all W positions in one pass. Recurrent mixers cannot roll
    a rejected suffix back, so they are an error here."""
    h = rms_norm(x, p["norm"], cfg.norm_eps)
    if sub.kind == "attn":
        out, nc = attn.verify_attention(p, h, cfg, cache, pos, window=sub.window, active=active)
    elif sub.kind == "mlp":
        out, nc = mlp_apply(p, h, cfg.act), None
    elif sub.kind == "moe":
        out, nc = moe_lib.moe_apply(p, h, cfg)[0], None
    elif sub.kind == "cross_attn":
        raise _not_ported(sub.kind)
    else:
        raise ValueError(f"verify step unsupported for recurrent sublayer {sub.kind!r}: "
                         f"SSM/RWKV state has no structural rollback")
    return x + out, nc


def group_verify(params, x, group: Group, cfg: ModelConfig, caches, pos, active=None):
    """``group_decode`` at width W: each layer's cache slice is written in
    place."""
    return _group_step(sub_verify, params, x, group, cfg, caches, pos, active)


def group_init_cache(group: Group, cfg: ModelConfig, batch, cache_len, dtype, device):
    """Zero caches stacked over repeats. Only caching subs get entries."""
    caches = {}
    for i, s in enumerate(group.period):
        if s.kind == "attn":
            caches[f"sub{i}"] = attn.init_kv_cache(cfg, batch, cache_len, dtype, device,
                                                   group.repeats)
        elif s.kind not in ("mlp", "moe"):
            raise _not_ported(s.kind)
    return caches


# ---------------------------------------------------------------- prefill --
def group_prefill(params, x, group: Group, cfg: ModelConfig, cache_len):
    """Forward + cache construction: each attention layer's K/V are written
    into a zeroed cache, then the sublayer runs through ``sub_apply``."""
    B, L, _ = x.shape
    caches = group_init_cache(group, cfg, B, cache_len, x.dtype, x.device)
    positions = attn._positions(B, L, x.device)
    for layer in range(group.repeats):
        lp = layer_params(params, layer)
        for i, s in enumerate(group.period):
            key = f"sub{i}"
            p = lp[key]
            if s.kind == "attn":
                hn = rms_norm(x, p["norm"], cfg.norm_eps)
                _, k, v = attn._qkv(p, hn, hn, cfg, positions, positions)
                caches[key]["k"][layer, :, :L] = k
                caches[key]["v"][layer, :, :L] = v
            x, _ = sub_apply(p, x, s, cfg)
    return x, caches

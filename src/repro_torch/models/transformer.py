"""Stack assembly for prefill / decode, the port of
``repro.models.transformer``.

Each ``Group(repeats, period)`` of the config's stack program holds its
parameters stacked over ``repeats`` (leading axis), as the JAX package
does; where the JAX package runs one ``lax.scan`` over that axis, the port
runs a Python loop over the layer index. Every sublayer kind of the JAX
package is ported: attn, cross_attn (against the encoder's ``memory``),
mlp, moe, mamba, rwkv_tmix and rwkv_cmix (the verify step raises the JAX
package's ``ValueError`` for the recurrent kinds). ``sub_apply`` and
``group_apply`` return the MoE aux loss beside the activations, summed
over the group's layers as the JAX package's scan carries it.

Caches are updated in place: attention K/V rows at the scatter site
(``attention.decode_attention``), the recurrent states (mamba ``h``/
``conv``, rwkv ``S``/``last_x``) by ``_freeze_rows``, which writes the
advanced state into the cache and keeps inactive rows bit-identical.

Activation sharding: the model code is grid-agnostic; ``activation_sharding``
installs a grid's sharder (``distributed.sharding.make_activation_sharder``)
and ``shard_act`` applies it at each sublayer's TP boundary, where the JAX
package applies ``with_sharding_constraint`` to the residual: the normed
input of a sublayer split over "model" (the identity, whose gradient is
summed over "model"; with sequence parallelism an all-gather over the
sequence) and its partial output (f32, ``layers.out_proj``: summed over
"model" in f32, with sequence parallelism reduce-scattered over the
sequence, then rounded once to the residual's dtype). Off a grid both are
the identity. A sublayer is split over "model" when this rank holds a block
of its heads, hidden units, experts (MoE) or channels (Mamba, RWKV:
``_split_over_model``); its recurrent caches then hold this rank's channels
or heads (``cache_shardings``), prefill included.
"""

from __future__ import annotations

import contextlib
import functools

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import Group, ModelConfig, Sub
from repro_torch.distributed.sharding import SPLITS, DeferredStack, regather_saved
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_lib
from repro_torch.models import rwkv as rwkv_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import (ACC, SHARDER, dense_init, matmul_f32, mlp_apply,
                                      rms_norm, rms_norm_init, sharder)

RECURRENT = ("mamba", "rwkv_tmix", "rwkv_cmix")


# ---------------------------------------------------- activation sharding --
@contextlib.contextmanager
def activation_sharding(fn):
    """Install a grid's activation sharder for the forwards (and backwards)
    run inside."""
    tok = SHARDER.set(fn)
    try:
        yield
    finally:
        SHARDER.reset(tok)


def shard_act(x, kind="seq", **kw):
    fn = SHARDER.get()
    return fn(x, kind, **kw) if fn is not None else x


def _split_over_model(p, sub: Sub, cfg: ModelConfig) -> bool:
    """Whether this rank holds a block of the sublayer's heads, hidden
    units, experts or channels (its output is then a partial sum over
    "model"): the mark leaf of ``distributed.sharding.SPLITS``."""
    if sub.kind == "mlp":
        return p["w_gate" if cfg.act == "swiglu" else "w_in"].shape[-1] < cfg.d_ff
    rule = SPLITS.get("attn" if sub.kind == "cross_attn" else sub.kind)
    return rule is not None and p[rule.mark].shape[rule.dim] < rule.whole(cfg)


def _normed(p, x, sub: Sub, cfg: ModelConfig):
    """(the sublayer's input: its norm of x at the TP boundary, whether the
    sublayer is split over "model")."""
    if sharder() is None:
        return rms_norm(x, p["norm"], cfg.norm_eps), False
    tp = _split_over_model(p, sub, cfg)
    h = rms_norm(x, shard_act(p["norm"], "norm"), cfg.norm_eps)
    return shard_act(h, "block_in", tp=tp), tp


# ------------------------------------------------------------------- init --
def sub_init(gen, sub: Sub, cfg: ModelConfig, dtype, repeats: int):
    """Parameters of ``repeats`` stacked copies of one sublayer."""
    p = {"norm": rms_norm_init((repeats, cfg.d_model), dtype, gen.device)}
    if sub.kind in ("attn", "cross_attn"):
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
    elif sub.kind == "mamba":
        p.update(ssm_lib.mamba_init(gen, cfg, dtype, repeats))
    elif sub.kind == "rwkv_tmix":
        p.update(rwkv_lib.rwkv_tmix_init(gen, cfg, dtype, repeats))
    elif sub.kind == "rwkv_cmix":
        p.update(rwkv_lib.rwkv_cmix_init(gen, cfg, dtype, repeats))
    else:
        raise ValueError(sub.kind)
    return p


def group_init(gen, group: Group, cfg: ModelConfig, dtype):
    return {f"sub{i}": sub_init(gen, s, cfg, dtype, group.repeats)
            for i, s in enumerate(group.period)}


def layer_params(group_params, layer: int) -> dict:
    """One layer's slice of a group's stacked parameters (views)."""
    return {key: {name: t[layer] for name, t in sub.items()}
            for key, sub in group_params.items()}


# ---------------------------------------------------------------- forward --
def sub_apply(p, x, sub: Sub, cfg: ModelConfig, memory=None, positions=None):
    """Pre-norm residual sublayer: (x + f(rms_norm(x)), aux) where aux is
    the MoE aux loss (f32 scalar), None for the other kinds.
    Causal self-attention takes the flash kernels above
    ``cfg.flash_min_len``, else the config's ``attention_impl``: "banded"
    for windowed layers, "flash" (the blocked online softmax in torch) for
    causal ones, "masked" otherwise; non-causal self-attention (the
    encoder's) takes the masked path, as in the JAX package. Cross-attention
    attends to ``memory`` (B, F, D) on the masked path, without a mask or
    rotary embedding."""
    aux = None
    h, tp = _normed(p, x, sub, cfg)
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
    elif sub.kind == "cross_attn":
        out = attn.full_attention(p, h, cfg, causal=False, rope=False,
                                  x_kv=shard_act(memory, "memory", tp=tp))
    elif sub.kind == "mlp":
        out = mlp_apply(p, h, cfg.act, cfg.d_ff)
    elif sub.kind == "moe":
        out, aux = moe_lib.moe_apply(p, h, cfg)
    elif sub.kind == "mamba":
        out = ssm_lib.mamba_apply(p, h, cfg)
    elif sub.kind == "rwkv_tmix":
        out = rwkv_lib.rwkv_tmix_apply(p, h, cfg)
    elif sub.kind == "rwkv_cmix":
        out = rwkv_lib.rwkv_cmix_apply(p, h, cfg)
    else:
        raise ValueError(sub.kind)
    return x + shard_act(out, "block_out", tp=tp).to(x.dtype), aux


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


def group_apply(params, x, group: Group, cfg: ModelConfig, memory=None, positions=None,
                remat: str = "none"):
    """Full-sequence forward through one group (loop over its layers) →
    (x, aux summed over the layers). ``memory``: the encoder's output, for
    the cross-attention sublayers.

    ``remat`` rematerialises each layer's body in the backward pass, as the
    JAX package's ``jax.checkpoint`` of its scan body: "full" saves only
    the layer's inputs, "dots" also the outputs of its 2-D products.
    ``memory`` is one of those inputs, so the encoder's gradient flows
    through the checkpointed layers.

    The body takes its layer's parameters itself (``layer_params``), so on
    a grid a ``sharding.DeferredStack``'s gathers run inside it: freed after
    the layer's forward and, under "full" and "dots", run again by the
    recompute. Under "none" the gathered tensors the backward needs are
    saved as the way to gather them (``sharding.regather_saved``). The body
    installs the grid's sharder itself: the backward may recompute it on
    the autograd engine's device thread, which does not see this thread's
    ``activation_sharding``."""
    check_remat(remat)
    grid_sharder = SHARDER.get()

    def body(h, layer, memory):
        with activation_sharding(grid_sharder):
            lp = layer_params(params, layer)
            aux = None
            for i, s in enumerate(group.period):
                h, a = sub_apply(lp[f"sub{i}"], h, s, cfg, memory=memory, positions=positions)
                if a is not None:
                    aux = a if aux is None else aux + a
            return h, aux

    deferred = any(isinstance(t, DeferredStack) for sub in params.values() for t in sub.values())
    aux = None
    for layer in range(group.repeats):
        if remat == "none":
            with regather_saved() if deferred else contextlib.nullcontext():
                x, a = body(x, layer, memory)
        elif remat == "full":
            x, a = checkpoint(body, x, layer, memory, use_reentrant=False)
        else:
            x, a = checkpoint(body, x, layer, memory, use_reentrant=False,
                              context_fn=functools.partial(create_selective_checkpoint_contexts,
                                                           _dots_policy))
        if a is not None:
            aux = a if aux is None else aux + a
    return x, (torch.zeros((), dtype=ACC, device=x.device) if aux is None else aux)


# ----------------------------------------------------------------- decode --
def _freeze_rows(new, cache, active):
    """Write the advanced recurrent state ``new`` into ``cache`` in place;
    with ``active (B,) bool``, rows with False keep their carried state
    bit-identical (retired slots of continuous batching). Only for the
    small recurrent states (mamba h/conv, rwkv S/last_x: O(B·d) leaves);
    the attention KV write is masked at its scatter site instead."""
    for name, t in cache.items():
        n = new[name]
        if active is not None:
            n = torch.where(active.reshape(active.shape + (1,) * (n.dim() - 1)), n, t)
        t.copy_(n)
    return cache


def sub_decode(p, x, sub: Sub, cfg: ModelConfig, cache, pos, active=None):
    """One-token step. Returns (x_out, cache or None); caches are updated
    in place (attention: ``attention.decode_attention``; recurrent states:
    ``_freeze_rows``)."""
    h, tp = _normed(p, x, sub, cfg)
    if sub.kind == "attn":
        out, nc = attn.decode_attention(p, h, cfg, cache, pos, window=sub.window, active=active)
    elif sub.kind == "cross_attn":
        out, nc = attn.cross_decode(p, h, cfg, cache), cache
    elif sub.kind == "mlp":
        out, nc = mlp_apply(p, h, cfg.act, cfg.d_ff), None
    elif sub.kind == "moe":
        out, nc = moe_lib.moe_decode_apply(p, h, cfg)[0], None
    elif sub.kind in RECURRENT:
        step = {"mamba": ssm_lib.mamba_decode, "rwkv_tmix": rwkv_lib.rwkv_tmix_decode,
                "rwkv_cmix": rwkv_lib.rwkv_cmix_decode}[sub.kind]
        out, new = step(p, h, cfg, cache)
        nc = _freeze_rows(new, cache, active)
    else:
        raise ValueError(sub.kind)
    return x + shard_act(out, "block_out", tp=tp).to(x.dtype), nc


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
        out, nc = attn.cross_decode(p, h, cfg, cache), cache
    else:
        raise ValueError(f"verify step unsupported for recurrent sublayer {sub.kind!r}: "
                         f"SSM/RWKV state has no structural rollback")
    return x + out, nc


def group_verify(params, x, group: Group, cfg: ModelConfig, caches, pos, active=None):
    """``group_decode`` at width W: each layer's cache slice is written in
    place."""
    return _group_step(sub_verify, params, x, group, cfg, caches, pos, active)


def group_init_cache(group: Group, cfg: ModelConfig, batch, cache_len, dtype, device,
                     memory_len: int = 0):
    """Zero caches stacked over repeats. Only caching subs get entries:
    self-attention K/V of ``cache_len`` positions, cross-attention K/V of
    the memory's ``memory_len``, the recurrent states."""
    sh = sharder()
    if memory_len and sh is not None and sh.context_parallel:
        raise ValueError("the context-parallel decode splits a cache's length over \"data\"; "
                         "an encoder-decoder arch's cross-attention caches are not ported to it "
                         "(ROADMAP.md Queue 1 item 7b)")
    caches = {}
    for i, s in enumerate(group.period):
        key, R = f"sub{i}", group.repeats
        if s.kind == "attn":
            caches[key] = attn.init_kv_cache(cfg, batch, cache_len, dtype, device, R)
        elif s.kind == "cross_attn":
            caches[key] = attn.init_kv_cache(cfg, batch, memory_len, dtype, device, R)
        elif s.kind == "mamba":
            caches[key] = ssm_lib.mamba_init_state(cfg, batch, dtype, device, R)
        elif s.kind == "rwkv_tmix":
            caches[key] = rwkv_lib.rwkv_tmix_init_state(cfg, batch, dtype, device, R)
        elif s.kind == "rwkv_cmix":
            caches[key] = {"last_x": torch.zeros((R, batch, cfg.d_model), dtype=dtype,
                                                 device=device)}
        elif s.kind not in ("mlp", "moe"):
            raise ValueError(s.kind)
    return caches


# ---------------------------------------------------------------- prefill --
def group_prefill(params, x, group: Group, cfg: ModelConfig, cache_len, memory=None):
    """Forward + cache construction: each attention layer's K/V are written
    into a zeroed cache, then the sublayer runs through ``sub_apply``; each
    cross-attention layer's cache holds the K/V of ``memory``
    (``attention.cross_kv``); each recurrent sublayer runs its parallel
    path and writes its decode state after the last token
    (``_mixer_prefill``)."""
    B, L, _ = x.shape
    caches = group_init_cache(group, cfg, B, cache_len, x.dtype, x.device,
                              memory_len=0 if memory is None else memory.shape[1])
    positions = attn._positions(B, L, x.device)
    for layer in range(group.repeats):
        lp = layer_params(params, layer)
        for i, s in enumerate(group.period):
            key = f"sub{i}"
            p = lp[key]
            if s.kind == "attn":
                hn = rms_norm(x, p["norm"], cfg.norm_eps)
                _, k, v = attn._qkv(p, hn, hn, cfg, positions, positions)
                if k.shape[2] != caches[key]["k"].shape[3]:
                    raise ValueError(f"a cache of {caches[key]['k'].shape[3]} KV heads a rank for "
                                     f"attention over {k.shape[2]}: serving on a grid needs "
                                     f"tp_mode 'full' (ROADMAP.md Queue 1 item 7b)")
                lo = 0 if sharder() is None else sharder().cache_span(cache_len)[0]
                n = max(0, min(caches[key]["k"].shape[2], L - lo))   # this rank's span
                caches[key]["k"][layer, :, :n] = k[:, lo:lo + n]
                caches[key]["v"][layer, :, :n] = v[:, lo:lo + n]
            elif s.kind == "cross_attn":
                for name, t in attn.cross_kv(p, memory, cfg).items():
                    caches[key][name][layer] = t
            if s.kind in RECURRENT:
                x, state = _mixer_prefill(p, x, s, cfg)
                for name, t in state.items():
                    if t.shape != caches[key][name].shape[1:]:
                        raise ValueError(f"a {s.kind} state {name} of {tuple(t.shape)} for a cache "
                                         f"of {tuple(caches[key][name].shape[1:])}: serving on "
                                         f"a grid needs tp_mode 'full' (ROADMAP.md Queue 1 item "
                                         f"7b)")
                    caches[key][name][layer] = t
            else:
                x, _ = sub_apply(p, x, s, cfg, memory=memory)
    return x, caches


def _mixer_prefill(p, x, sub: Sub, cfg):
    """Run the parallel path AND return the decode state at position L-1
    (on a grid, of this rank's channels or heads)."""
    h, tp = _normed(p, x, sub, cfg)
    if sub.kind == "mamba":
        out = ssm_lib.mamba_apply(p, h, cfg)
        state = _mamba_state_after(p, h, cfg)
    elif sub.kind == "rwkv_tmix":
        out = rwkv_lib.rwkv_tmix_apply(p, h, cfg)
        state = _rwkv_state_after(p, h, cfg)
    else:  # rwkv_cmix
        out = rwkv_lib.rwkv_cmix_apply(p, h, cfg)
        state = {"last_x": h[:, -1]}
    return x + shard_act(out, "block_out", tp=tp).to(x.dtype), state


def _mamba_state_after(p, x, cfg):
    """Final SSM state after consuming x (recomputed chunked — cheap).

    The state must reflect EXACTLY the L real tokens, so (unlike the
    pad-and-slice output path) an off-chunk tail is advanced with one exact
    partial-chunk step — pad tokens must never enter the carried state."""
    B, L, D = x.shape
    xs, _, dt, a, b_ssm, _, _ = ssm_lib._ssm_inputs(p, x, cfg)
    ck = min(cfg.ssm_chunk, L)
    nc = L // ck                                 # full chunks
    d_in = xs.shape[-1]
    xs_f = xs.to(ACC)

    def advance(h0, sl):
        acc_a, acc_b = ssm_lib.chunk_scan(*ssm_lib._discretize(a, dt[:, sl], b_ssm[:, sl],
                                                               xs_f[:, sl]))
        return acc_a[:, -1] * h0 + acc_b[:, -1]

    h = torch.zeros((B, d_in, cfg.ssm_d_state), dtype=ACC, device=x.device)
    for c in range(nc):
        h = advance(h, slice(c * ck, (c + 1) * ck))
    if L % ck:                                   # exact partial-chunk tail
        h = advance(h, slice(nc * ck, L))
    K = cfg.ssm_conv_width
    # conv tail: last K-1 pre-activation inputs (zero-extended left for
    # prompts shorter than the conv receptive field); the reference takes
    # this product with preferred_element_type=f32, then rounds
    if d_in == cfg.ssm_expand * D:
        xz = matmul_f32(x.reshape(B * L, D), p["in_proj"], out_dtype=x.dtype).reshape(B, L, -1)
        conv = xz[..., :d_in][:, -(K - 1):]
    else:                                        # this rank's channels
        w = ssm_lib.in_proj_halves(p, cfg)[0]
        conv = matmul_f32(x.reshape(B * L, D), w, out_dtype=x.dtype).reshape(B, L, -1)
        conv = conv[:, -(K - 1):]
    if L < K - 1:
        conv = torch.cat([torch.zeros((B, K - 1 - L, d_in), dtype=conv.dtype,
                                      device=x.device), conv], dim=1)
    return {"h": h, "conv": conv}


def _rwkv_state_after(p, x, cfg):
    """Final WKV state after consuming x; exact partial-chunk tail as in
    ``_mamba_state_after``."""
    B, L, d = x.shape
    hd = cfg.rwkv_head_dim
    _, k, v, _, logw, _ = rwkv_lib._tmix_inputs(p, x, cfg)
    H = k.shape[2]                               # this rank's heads on a grid
    C = min(cfg.rwkv_chunk, L)
    nc = L // C                                  # full chunks

    def advance(S, sl):
        kk, vk, lw = k[:, sl], v[:, sl], logw[:, sl]
        cum = torch.cumsum(lw, dim=1)
        decay_all = torch.exp(cum[:, -1])
        k_hat = kk * torch.exp(cum[:, -1][:, None] - cum)
        return decay_all[..., None] * S + torch.einsum("bjhd,bjhe->bhde", k_hat, vk)

    S = torch.zeros((B, H, hd, hd), dtype=ACC, device=x.device)
    for c in range(nc):
        S = advance(S, slice(c * C, (c + 1) * C))
    if L % C:                                    # exact partial-chunk tail
        S = advance(S, slice(nc * C, L))
    return {"S": S, "last_x": x[:, -1]}

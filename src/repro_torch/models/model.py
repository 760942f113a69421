"""Top-level Model API: init / forward / token_ce / loss / prefill /
decode_step / generate, the port of ``repro.models.model`` for the dense
families.

Parameters hold the JAX package's stacked tree under the same names:
``embed`` (V, D), ``decoder.groups.<g>.sub<i>.<name>`` with a leading layer
axis (e.g. ``decoder.groups.0.sub0.wq`` is (12, 768, 768) for gpt-125m),
``decoder.final_norm`` and ``lm_head`` (D, V). Two containers carry them:

* ``ParamTree`` (an ``nn.Module`` of frozen ``nn.Parameter``s), what
  ``init`` returns, for serving;
* ``ParamView``, a plain nested view whose leaves are the tensors given,
  not re-wrapped: what the training path builds from
  ``BucketedParams.tree()``, so every leaf stays a view of its flat bucket
  and a backward pass leaves the gradient in the bucket. (Wrapping a view
  in ``nn.Parameter`` would make a new leaf and cut it from the bucket.)

Every method takes either, a nested dict of tensors, or a
``BucketedParams``.

Serving: the KV caches travel inside a ``DecodeState`` that also carries
the per-row cache position ``pos (B,)``. ``prefill`` sets ``pos`` to the
true cache position (per-row ragged prompt lengths included) and
``decode_step`` advances it, so callers never compute positions.
``generate`` is prefill plus a Python loop of decode steps (the JAX
package's ``lax.scan``), with EOS / per-request budgets (finished rows
freeze ``pos``, leave their cache untouched and emit ``pad_id``).
Randomness comes from an explicit ``torch.Generator``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.bucketing import BucketedParams
from repro_torch.device import resolve_device, torch_dtype
from repro_torch.models import transformer as tf
from repro_torch.models.layers import (ACC, dense_init, embed_lookup, matmul_f32, rms_norm,
                                      rms_norm_init)

# MoE load-balance penalty weight in the training objective (the JAX
# package's ``AUX_LOSS_COEF``)
AUX_LOSS_COEF = 0.01


def _frozen(t):
    return nn.Parameter(t, requires_grad=False)


class _Stack(nn.Module):
    def __init__(self, groups: list, final_norm):
        super().__init__()
        self.groups = nn.ModuleList(
            nn.ModuleDict({key: nn.ParameterDict({n: _frozen(t) for n, t in sub.items()})
                           for key, sub in g.items()})
            for g in groups)
        self.final_norm = _frozen(final_norm)


class ParamTree(nn.Module):
    """The model's stacked parameter tree (serving: no gradients)."""

    def __init__(self, tree: dict):
        super().__init__()
        self.embed = _frozen(tree["embed"])
        self.decoder = _Stack(tree["decoder"]["groups"], tree["decoder"]["final_norm"])
        self.lm_head = _frozen(tree["lm_head"]) if "lm_head" in tree else None

    @property
    def device(self) -> torch.device:
        return self.embed.device


class _Decoder:
    def __init__(self, groups, final_norm):
        self.groups = groups
        self.final_norm = final_norm


class ParamView:
    """The parameter tree as plain attributes over the given tensors (no
    ``nn.Parameter`` wrapping): ``embed``, ``decoder.groups`` (a list of
    {sub: {name: tensor}}), ``decoder.final_norm``, ``lm_head``."""

    def __init__(self, tree: dict):
        self.embed = tree["embed"]
        self.decoder = _Decoder(tree["decoder"]["groups"], tree["decoder"]["final_norm"])
        self.lm_head = tree.get("lm_head")

    @property
    def device(self) -> torch.device:
        return self.embed.device


def param_dict(params) -> dict:
    """The parameters as the JAX package's nested dict of tensors."""
    if isinstance(params, dict):
        return params
    if isinstance(params, BucketedParams):
        return params.tree()
    tree = {"embed": params.embed,
            "decoder": {"groups": [{key: {n: t for n, t in sub.items()} for key, sub in g.items()}
                                   for g in params.decoder.groups],
                        "final_norm": params.decoder.final_norm}}
    if params.lm_head is not None:
        tree["lm_head"] = params.lm_head
    return tree


def as_view(params):
    """ParamTree / ParamView pass through; a dict or BucketedParams becomes
    a ParamView over the same tensors."""
    if isinstance(params, (ParamTree, ParamView)):
        return params
    return ParamView(param_dict(params))


@dataclasses.dataclass
class DecodeState:
    """Generation-loop carry: per-group caches + per-row cache position.

    ``pos[b]`` is the next cache write position of row b == the number of
    valid entries (prompt + generated so far), int64. It is the single
    source of truth for RoPE positions and attention masking. The caches
    are updated in place by ``decode_step``."""

    layers: tuple                 # one cache dict per decoder group
    pos: torch.Tensor             # (B,) int64


def greedy_tokens(logits):
    """Tie-robust greedy selection: argmax over logits rounded to bf16,
    first index on ties (``torch.argmax``'s rule, as ``jnp.argmax``'s)."""
    return torch.argmax(logits.to(torch.bfloat16), dim=-1)


def sample_logits(logits, generator: Optional[torch.Generator], temperature: float = 0.0,
                  top_k: int = 0):
    """Greedy / temperature / top-k sampling on logits (B, V) fp32.
    Sampling draws one categorical sample per row from ``generator``."""
    if temperature <= 0.0:
        return greedy_tokens(logits)
    logits = logits.to(ACC) / temperature
    if 0 < top_k < logits.shape[-1]:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    # ------------------------------------------------------------- params --
    def init(self, seed: int = 0, *, device="cuda") -> ParamTree:
        """Random parameters from ``seed`` (a ``torch.Generator`` on the
        device). Same shapes and scales as the JAX package's init, not the
        same numbers: ``jax.random`` streams are not reproducible here."""
        cfg = self.cfg
        if cfg.family in ("vlm", "audio", "encdec"):   # frontends are not ported
            raise NotImplementedError(f"{cfg.name}: family {cfg.family!r} not yet ported")
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        dtype = torch_dtype(cfg.dtype)
        tree = {
            "embed": dense_init(gen, (cfg.vocab_size, cfg.d_model), dtype, scale=0.02),
            "decoder": {
                "groups": [tf.group_init(gen, g, cfg, dtype) for g in cfg.decoder_program()],
                "final_norm": rms_norm_init((cfg.d_model,), dtype, dev),
            },
        }
        if not cfg.tie_embeddings:
            tree["lm_head"] = dense_init(gen, (cfg.d_model, cfg.vocab_size), dtype, scale=0.02)
        return ParamTree(tree)

    # ------------------------------------------------------------ helpers --
    def _head(self, params, x):
        cfg = self.cfg
        x = rms_norm(x, params.decoder.final_norm, cfg.norm_eps)
        w = params.embed.T if cfg.tie_embeddings else params.lm_head
        logits = matmul_f32(x.reshape(-1, x.shape[-1]), w)     # fp32
        return logits.reshape(*x.shape[:-1], w.shape[-1])

    def _has_recurrent_state(self) -> bool:
        return any(s.kind in ("mamba", "rwkv_tmix", "rwkv_cmix")
                   for g in self.cfg.decoder_program() for s in g.period)

    # ------------------------------------------------------------ forward --
    def forward(self, params, batch, remat: str = "none"):
        """Full-sequence logits. Returns (logits fp32, aux_loss); aux_loss is
        the MoE balance loss of the JAX package, 0 until MoE is ported.
        ``remat`` ("none", "full", "dots") rematerialises each decoder
        layer in the backward pass (``transformer.group_apply``)."""
        cfg = self.cfg
        params = as_view(params)
        x = embed_lookup(params.embed, batch["tokens"])
        for g, gp in zip(cfg.decoder_program(), params.decoder.groups):
            x = tf.group_apply(gp, x, g, cfg, remat=remat)
        return self._head(params, x), torch.zeros((), dtype=ACC, device=x.device)

    @staticmethod
    def token_ce(logits, labels):
        """Next-token cross entropy (fp32) from full-sequence logits
        (..., L, V) and labels (..., L); labels < 0 are masked."""
        logits = logits[..., :-1, :]
        targets = labels[..., 1:]
        mask = (targets >= 0).to(ACC)
        logp = torch.log_softmax(logits.to(ACC), dim=-1)
        ll = torch.gather(logp, -1, targets.clamp_min(0)[..., None])[..., 0]
        ntok = torch.clamp_min(mask.sum(), 1.0)
        return -(ll * mask).sum() / ntok

    def loss(self, params, batch, remat: str = "none"):
        """Next-token cross entropy (fp32) plus the MoE aux term; returns
        (loss, {"ce", "aux", "ppl"})."""
        logits, aux = self.forward(params, batch, remat=remat)
        ce = self.token_ce(logits, batch["labels"])
        total = ce + AUX_LOSS_COEF * aux
        return total, {"ce": ce, "aux": aux, "ppl": torch.exp(ce)}

    # ------------------------------------------------------------ serving --
    def init_decode_state(self, batch_size: int, cache_len: int, *, device="cuda") -> DecodeState:
        dev = resolve_device(device)
        dtype = torch_dtype(self.cfg.dtype)
        layers = tuple(tf.group_init_cache(g, self.cfg, batch_size, cache_len, dtype, dev)
                       for g in self.cfg.decoder_program())
        return DecodeState(layers, torch.zeros((batch_size,), dtype=torch.int64, device=dev))

    def prefill(self, params, batch, cache_len: int, prompt_lens=None):
        """Process the prompt; returns (per-row last-valid-position logits
        (B,1,V) fp32, DecodeState).

        ``prompt_lens (B,)``: valid prompt length per row for ragged batches
        (tokens right-padded to the common length)."""
        cfg = self.cfg
        B, T = batch["tokens"].shape
        if cache_len < T:
            raise ValueError(f"cache_len {cache_len} < prompt {T}: the KV write would clip")
        if prompt_lens is not None and self._has_recurrent_state():
            raise ValueError("ragged prefill (prompt_lens) unsupported for recurrent-state archs")
        params = as_view(params)
        x = embed_lookup(params.embed, batch["tokens"])
        layers = []
        for g, gp in zip(cfg.decoder_program(), params.decoder.groups):
            x, c = tf.group_prefill(gp, x, g, cfg, cache_len)
            layers.append(c)
        if prompt_lens is None:
            pos = torch.full((B,), T, dtype=torch.int64, device=x.device)
        else:
            pos = prompt_lens.to(device=x.device, dtype=torch.int64)
        # last valid position per row
        x_last = x[torch.arange(B, device=x.device), pos - 1][:, None]
        return self._head(params, x_last), DecodeState(tuple(layers), pos)

    def decode_step(self, params, state: DecodeState, token, active=None):
        """One-token serve step: token (B,1); positions come from
        ``state.pos``. Returns (logits (B,1,V) fp32, new DecodeState); the
        caches are updated in place.

        ``active (B,) bool``: rows with False freeze ``pos`` and keep their
        caches bit-identical; their logits are garbage the caller discards."""
        cfg = self.cfg
        params = as_view(params)
        x = embed_lookup(params.embed, token)
        for g, gp, c in zip(cfg.decoder_program(), params.decoder.groups, state.layers):
            x, _ = tf.group_decode(gp, x, g, cfg, c, state.pos, active=active)
        adv = 1 if active is None else active.to(torch.int64)
        return self._head(params, x), DecodeState(state.layers, state.pos + adv)

    @torch.no_grad()
    def generate(self, params, batch, max_new_tokens: int, *,
                 generator: Optional[torch.Generator] = None, temperature: float = 0.0,
                 top_k: int = 0, prompt_lens=None, cache_len: Optional[int] = None,
                 eos_id: Optional[int] = None, gen_lens=None, pad_id: int = 0, sampling=None):
        """Prefill + a loop of decode steps. Returns (tokens (B,
        max_new_tokens) int64, final DecodeState).

        ``sampling`` takes a ``launch.api.SamplingParams`` and overrides the
        ``temperature``/``top_k``/``eos_id``/``pad_id`` kwargs.

        Early exit: ``eos_id`` and/or per-request budgets ``gen_lens (B,)``
        (clamped to ``max_new_tokens``) carry a ``done`` mask through the
        loop — finished rows freeze ``pos``, stop writing KV, and emit
        ``pad_id``. The EOS token itself is emitted. With both None every
        row runs every step (the closed-batch path)."""
        if sampling is not None:
            temperature, top_k = sampling.temperature, sampling.top_k
            eos_id, pad_id = sampling.eos_id, sampling.pad_id
        B, T = batch["tokens"].shape
        if cache_len is None:
            cache_len = T + max_new_tokens
        if cache_len < T + max_new_tokens:
            raise ValueError(f"cache_len {cache_len} < {T}+{max_new_tokens}")
        logits, state = self.prefill(params, batch, cache_len, prompt_lens=prompt_lens)
        if generator is None:           # the JAX package's default key is PRNGKey(0)
            generator = torch.Generator(device=logits.device).manual_seed(0)
        tok = sample_logits(logits[:, -1], generator, temperature, top_k)[:, None]

        if eos_id is None and gen_lens is None:       # closed-batch path
            out = [tok[:, 0]]
            for _ in range(max_new_tokens - 1):
                logits, state = self.decode_step(params, state, tok)
                tok = sample_logits(logits[:, -1], generator, temperature, top_k)[:, None]
                out.append(tok[:, 0])
            return torch.stack(out, dim=1), state

        dev = tok.device
        if gen_lens is None:
            budget = torch.full((B,), max_new_tokens, dtype=torch.int64, device=dev)
        else:
            budget = gen_lens.to(device=dev, dtype=torch.int64).clamp(max=max_new_tokens)
        done = budget <= 1
        if eos_id is not None:
            done = done | (tok[:, 0] == eos_id)
        n = torch.ones((B,), dtype=torch.int64, device=dev)
        out = [tok[:, 0]]
        for _ in range(max_new_tokens - 1):
            run = ~done
            logits, state = self.decode_step(params, state, tok, active=run)
            nxt = sample_logits(logits[:, -1], generator, temperature, top_k)
            n = n + run.to(torch.int64)
            done = done | (run & (n >= budget))
            if eos_id is not None:
                done = done | (run & (nxt == eos_id))
            out.append(torch.where(run, nxt, torch.full_like(nxt, pad_id)))
            tok = torch.where(run, nxt, tok[:, 0])[:, None]
        return torch.stack(out, dim=1), state


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)

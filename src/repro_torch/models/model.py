"""Top-level Model API: init / forward / token_ce / loss / prefill /
decode_step / generate, the port of ``repro.models.model`` for every
architecture family of the JAX package.

Parameters hold the JAX package's stacked tree under the same names:
``embed`` (V, D), ``decoder.groups.<g>.sub<i>.<name>`` with a leading layer
axis (e.g. ``decoder.groups.0.sub0.wq`` is (12, 768, 768) for gpt-125m),
``decoder.final_norm``, ``lm_head`` (D, V), and for enc-dec archs the
``encoder`` stack (``encoder.groups``, ``encoder.final_norm``). Two
containers carry them:

* ``ParamTree`` (an ``nn.Module`` of frozen ``nn.Parameter``s), what
  ``init`` returns, for serving;
* ``ParamView``, a plain nested view whose leaves are the tensors given,
  not re-wrapped: what the training path builds from
  ``BucketedParams.tree()``, so every leaf stays a view of its flat bucket
  and a backward pass leaves the gradient in the bucket. (Wrapping a view
  in ``nn.Parameter`` would make a new leaf and cut it from the bucket.)

Every method takes either, a nested dict of tensors, or a
``BucketedParams``.

Frontends are stubs, as in the JAX package: the batch carries precomputed
frame or patch embeddings ``frontend`` (B, F, D). An enc-dec arch
(seamless-m4t) encodes them into the ``memory`` its decoder's
cross-attention reads; a VLM (internvl2) puts them in front of the token
embeddings, as a prefix of F positions of the decoder sequence and its
cache, and takes the loss on the text segment only.

Serving: the KV caches and recurrent states travel inside a
``DecodeState`` that also carries the per-row cache position ``pos (B,)``.
``prefill`` sets ``pos`` to the true cache position (the VLM prefix and
per-row ragged prompt lengths included) and
``decode_step`` advances it, so callers never compute positions. The
cross-attention caches hold the memory's K/V, written once at prefill.
``generate`` is prefill plus a Python loop of decode steps (the JAX
package's ``lax.scan``), with EOS / per-request budgets (finished rows
freeze ``pos``, leave their cache untouched and emit ``pad_id``).
Randomness comes from an explicit ``torch.Generator``.

On a grid of ranks (``models.transformer.activation_sharding`` with a
``distributed.sharding`` sharder) every method is this rank's program over
its blocks (``distributed.sharding.materialize``) and its batch rows: the
embedding and the head are vocab-parallel when the vocab divides "model"
(``_head`` gives this rank's block of the logits; the tied head is the
embedding's block transposed), the loss is the vocab-parallel cross
entropy (a pmax of the row max, psums of Σexp and of the target logit: the
(B, L, V) logits are never gathered), and greedy sampling takes the local
argmax, then the best over "model", ties to the lowest global index. The
serving state is the rank's block of ``cache_shardings``' specs.

Slot-pool serving (continuous batching) keeps a ``SlotState`` arena on the
device: ``prefill_into`` writes new requests' rows into free slots and
``decode_segment`` advances every slot ``seg_len`` steps. Speculative
decoding pairs it with a draft pool (``SpecState``): ``draft_propose``
proposes k tokens a slot and ``spec_verify`` checks them in one width-(k+1)
``decode_verify`` forward. All of them update the arena in place and read
nothing back to the host; the engine reads once a segment or round.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.bucketing import BucketedParams
from repro_torch.device import resolve_device, torch_dtype
from repro_torch.distributed.sharding import resolve
from repro_torch.models import transformer as tf
from repro_torch.models.layers import (ACC, dense_init, embed_lookup, matmul_f32, rms_norm,
                                      rms_norm_init, sharder)

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
        self.encoder = _Stack(tree["encoder"]["groups"], tree["encoder"]["final_norm"]) \
            if "encoder" in tree else None
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
    {sub: {name: tensor}}), ``decoder.final_norm``, ``encoder`` (the same,
    or None), ``lm_head``."""

    def __init__(self, tree: dict):
        self.embed = tree["embed"]
        self.decoder = _Decoder(tree["decoder"]["groups"], tree["decoder"]["final_norm"])
        enc = tree.get("encoder")
        self.encoder = None if enc is None else _Decoder(enc["groups"], enc["final_norm"])
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
    stack = lambda st: {"groups": [{key: {n: t for n, t in sub.items()} for key, sub in g.items()}
                                   for g in st.groups], "final_norm": st.final_norm}
    tree = {"embed": params.embed, "decoder": stack(params.decoder)}
    if params.encoder is not None:
        tree["encoder"] = stack(params.encoder)
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
    valid entries (frontend prefix + prompt + generated so far), int64. It
    is the single source of truth for RoPE positions and attention
    masking. The caches are updated in place by ``decode_step``."""

    layers: tuple                 # one cache dict per decoder group
    pos: torch.Tensor             # (B,) int64

    def clone(self) -> "DecodeState":
        """A copy with its own caches (the methods update them in place)."""
        return DecodeState(tuple({k: {n: t.clone() for n, t in sub.items()} for k, sub in g.items()}
                                 for g in self.layers), self.pos.clone())


@dataclasses.dataclass
class SlotState:
    """Slot-pool serving carry (continuous batching): the KV arena is a
    ``DecodeState`` over a fixed ``max_slots`` batch, with per-slot vectors
    the host scheduler only reads:

      tok    (B, 1) int64 — last sampled token, not yet consumed
      active (B,)  bool   — slot holds an admitted request
      done   (B,)  bool   — request finished (EOS / budget); stays True
                            until ``prefill_into`` refills the slot
      n_gen  (B,)  int64  — tokens emitted so far (the prefill one included)
      budget (B,)  int64  — per-request max_new_tokens

    A slot advances iff ``active & ~done``; retired rows freeze ``pos``,
    keep their KV rows and emit ``pad_id``. Every tensor is updated in
    place."""

    state: DecodeState
    tok: torch.Tensor
    active: torch.Tensor
    done: torch.Tensor
    n_gen: torch.Tensor
    budget: torch.Tensor

    @property
    def run(self):
        """(B,) bool — slots that advance this step."""
        return self.active & ~self.done

    def clone(self) -> "SlotState":
        return SlotState(self.state.clone(), self.tok.clone(), self.active.clone(),
                         self.done.clone(), self.n_gen.clone(), self.budget.clone())


@dataclasses.dataclass
class SpecState:
    """Speculative-decoding carry: the target's slot pool and the draft
    model's cache pool over the same slot grid. ``slots`` is authoritative
    for all bookkeeping; the draft's ``pos`` is overwritten from the
    target's at every proposal, so a rejection rolls both pools back by
    position alone (rows beyond ``pos`` are never attended)."""

    slots: SlotState
    draft: DecodeState


def _scatter_rows(pool_layers, new_layers, dst, src):
    """pool[:, dst] = new[:, src] for every layer-stacked cache tensor."""
    for pool, new in zip(pool_layers, new_layers):
        for key, sub in pool.items():
            for name, t in sub.items():
                t[:, dst] = new[key][name][:, src].to(t.dtype)


def _from_host(arr, device):
    """A host array on ``device`` with no host sync: on the card through
    pinned memory and a copy that does not block."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _live_rows(slot_idx, max_slots: int, device):
    """Prefill rows that land in the arena: (arena slots, batch rows).
    ``slot_idx`` is host data; rows with ``slot_idx >= max_slots`` are the
    padding of a fixed prefill batch, filtered out here (the JAX package
    drops their scatter out of bounds)."""
    idx = np.asarray(slot_idx, np.int64)
    src = np.flatnonzero(idx < max_slots)
    return _from_host(idx[src], device), _from_host(src, device)


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


class _MetaGenerator:
    """Stands in for a ``torch.Generator`` on the meta device (which has
    none): ``init`` then makes the tree's shapes and no numbers."""

    device = torch.device("meta")


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    # ------------------------------------------------------------- params --
    def init(self, seed: int = 0, *, device="cuda") -> ParamTree:
        """Random parameters from ``seed`` (a ``torch.Generator`` on the
        device). Same shapes and scales as the JAX package's init, not the
        same numbers: ``jax.random`` streams are not reproducible here.
        ``device="meta"``: the shapes only."""
        cfg = self.cfg
        dev = resolve_device(device)
        gen = _MetaGenerator() if dev.type == "meta" else \
            torch.Generator(device=dev).manual_seed(seed)
        dtype = torch_dtype(cfg.dtype)
        tree = {
            "embed": dense_init(gen, (cfg.vocab_size, cfg.d_model), dtype, scale=0.02),
            "decoder": {
                "groups": [tf.group_init(gen, g, cfg, dtype) for g in cfg.decoder_program()],
                "final_norm": rms_norm_init((cfg.d_model,), dtype, dev),
            },
        }
        if cfg.is_encdec:
            tree["encoder"] = {
                "groups": [tf.group_init(gen, g, cfg, dtype) for g in cfg.encoder_program()],
                "final_norm": rms_norm_init((cfg.d_model,), dtype, dev),
            }
        if not cfg.tie_embeddings:
            tree["lm_head"] = dense_init(gen, (cfg.d_model, cfg.vocab_size), dtype, scale=0.02)
        return ParamTree(tree)

    # ------------------------------------------------------------ helpers --
    def _head(self, params, x):
        cfg = self.cfg
        x = rms_norm(x, tf.shard_act(params.decoder.final_norm, "norm"), cfg.norm_eps)
        w = resolve(params.embed).T if cfg.tie_embeddings else resolve(params.lm_head)
        x = tf.shard_act(x, "block_in", tp=w.shape[-1] < cfg.vocab_size)
        logits = matmul_f32(x.reshape(-1, x.shape[-1]), w)     # fp32
        return logits.reshape(*x.shape[:-1], w.shape[-1])

    def _sampler(self):
        """``sample_logits``; on a grid with vocab-block logits, greedy
        through the sharder's cross-rank argmax."""
        sh, V = sharder(), self.cfg.vocab_size

        def sample(logits, generator, temperature=0.0, top_k=0):
            if sh is None or logits.shape[-1] == V:
                return sample_logits(logits, generator, temperature, top_k)
            if temperature > 0.0:
                raise ValueError("sampling from vocab-parallel logits: greedy only "
                                 "(temperature 0)")
            return sh.argmax(logits)
        return sample

    def _has_recurrent_state(self) -> bool:
        return any(s.kind in tf.RECURRENT for g in self.cfg.decoder_program() for s in g.period)

    @property
    def needs_frontend(self) -> bool:
        """Batches carry ``frontend`` (B, F, D) embeddings: VLM and enc-dec."""
        return self.cfg.family == "vlm" or self.cfg.is_encdec

    @property
    def _prefix_len(self) -> int:
        """Decoder-sequence prefix occupied by the frontend: VLM patches sit
        in the decoder cache; enc-dec frontends go through the encoder."""
        return self.cfg.frontend_len if self.cfg.family == "vlm" else 0

    def _encode(self, params, frontend):
        """The encoder stack over the frontend embeddings (in the model
        dtype): the memory (B, F, D) the cross-attention reads, or None for
        an arch without an encoder. On a grid with sequence parallelism the
        frames split over "model" when F divides it (``GridSharder.encoder``),
        and so does the memory."""
        cfg = self.cfg
        if not cfg.is_encdec:
            return None
        x = frontend.to(device=params.embed.device, dtype=torch_dtype(cfg.dtype))
        sh = sharder()
        with sh.encoder(x.shape[1]) if sh is not None else contextlib.nullcontext():
            x = tf.shard_act(x, "seq")
            for g, gp in zip(cfg.encoder_program(), params.encoder.groups):
                x, _ = tf.group_apply(gp, x, g, cfg)
            return rms_norm(x, tf.shard_act(params.encoder.final_norm, "norm"), cfg.norm_eps)

    def _decoder_input(self, params, batch):
        """Token embeddings, with the VLM patch prefix put in front of them
        in the model dtype."""
        x = embed_lookup(resolve(params.embed), batch["tokens"], self.cfg.vocab_size)
        if self.cfg.family == "vlm":
            x = torch.cat([batch["frontend"].to(device=x.device, dtype=x.dtype), x], dim=1)
        return x

    # ------------------------------------------------------------ forward --
    def forward(self, params, batch, remat: str = "none"):
        """Full-sequence logits (over the VLM prefix too). Returns (logits
        fp32, aux_loss); aux_loss is the MoE balance loss summed over the
        groups (0 without MoE). ``remat`` ("none", "full", "dots")
        rematerialises each decoder layer in the backward pass
        (``transformer.group_apply``); the encoder runs without."""
        cfg = self.cfg
        params = as_view(params)
        memory = self._encode(params, batch.get("frontend"))
        x = tf.shard_act(self._decoder_input(params, batch), "seq")
        aux = torch.zeros((), dtype=ACC, device=x.device)
        for g, gp in zip(cfg.decoder_program(), params.decoder.groups):
            x, a = tf.group_apply(gp, x, g, cfg, memory=memory, remat=remat)
            aux = aux + a
        return self._head(params, x), aux

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
        (loss, {"ce", "aux", "ppl"}). A VLM's loss is on the text segment
        only."""
        logits, aux = self.forward(params, batch, remat=remat)
        if self.cfg.family == "vlm":
            logits = logits[:, batch["frontend"].shape[1]:]
        sh = sharder()
        if sh is not None and logits.shape[-1] < self.cfg.vocab_size:   # vocab-parallel
            targets = batch["labels"][..., 1:]
            mask = (targets >= 0).to(ACC)
            nll = sh.ce(logits[..., :-1, :], targets.clamp_min(0))
            ce = (nll * mask).sum() / torch.clamp_min(mask.sum(), 1.0)
        else:
            ce = self.token_ce(logits, batch["labels"])
        total = ce + AUX_LOSS_COEF * aux
        return total, {"ce": ce, "aux": aux, "ppl": torch.exp(ce)}

    # ------------------------------------------------------------ serving --
    def init_decode_state(self, batch_size: int, cache_len: int, *, device="cuda") -> DecodeState:
        """Zero caches: ``cache_len`` self-attention positions, and for an
        enc-dec arch cross-attention K/V of ``frontend_len`` frames."""
        cfg = self.cfg
        dev = resolve_device(device)
        dtype = torch_dtype(cfg.dtype)
        mem_len = cfg.frontend_len if cfg.is_encdec else 0
        layers = tuple(tf.group_init_cache(g, cfg, batch_size, cache_len, dtype, dev,
                                           memory_len=mem_len)
                       for g in cfg.decoder_program())
        return DecodeState(layers, torch.zeros((batch_size,), dtype=torch.int64, device=dev))

    def prefill(self, params, batch, cache_len: int, prompt_lens=None):
        """Process the prompt; returns (per-row last-valid-position logits
        (B,1,V) fp32, DecodeState).

        ``prompt_lens (B,)``: valid prompt length per row for ragged batches
        (tokens right-padded to the common length). A VLM's patch prefix
        takes the first F positions of the cache, so ``pos`` is F + the
        prompt length."""
        cfg = self.cfg
        B, T = batch["tokens"].shape
        F = self._prefix_len
        if cache_len < F + T:
            raise ValueError(f"cache_len {cache_len} < frontend {F} + prompt {T}: the KV write "
                             f"would clip")
        if prompt_lens is not None and self._has_recurrent_state():
            raise ValueError("ragged prefill (prompt_lens) unsupported for recurrent-state archs")
        params = as_view(params)
        memory = self._encode(params, batch.get("frontend"))
        x = self._decoder_input(params, batch)
        layers = []
        for g, gp in zip(cfg.decoder_program(), params.decoder.groups):
            x, c = tf.group_prefill(gp, x, g, cfg, cache_len, memory=memory)
            layers.append(c)
        if prompt_lens is None:
            pos = torch.full((B,), F + T, dtype=torch.int64, device=x.device)
        else:
            pos = F + prompt_lens.to(device=x.device, dtype=torch.int64)
        # last valid position per row, in decoder-sequence coordinates
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
        x = embed_lookup(resolve(params.embed), token, cfg.vocab_size)
        for g, gp, c in zip(cfg.decoder_program(), params.decoder.groups, state.layers):
            x, _ = tf.group_decode(gp, x, g, cfg, c, state.pos, active=active)
        adv = 1 if active is None else active.to(torch.int64)
        return self._head(params, x), DecodeState(state.layers, state.pos + adv)

    def decode_verify(self, params, state: DecodeState, tokens, active=None):
        """Verify-mode forward (speculative decoding): tokens (B, W) are the
        current token + the draft's W-1 proposals. One batched forward
        gives per-position logits (B, W, V): logits[:, i] are what
        ``decode_step`` gives after consuming tokens[:, :i+1] one by one
        (up to the rounding of products over B·W rows instead of B). The
        W new KV rows are written at pos..pos+W-1 in place; inactive rows'
        writes are dropped. Returns (logits, DecodeState with pos advanced
        by W on active rows); a caller that rejects a suffix rolls ``pos``
        back (``spec_verify``)."""
        cfg = self.cfg
        params = as_view(params)
        x = embed_lookup(resolve(params.embed), tokens, cfg.vocab_size)
        for g, gp, c in zip(cfg.decoder_program(), params.decoder.groups, state.layers):
            x, _ = tf.group_verify(gp, x, g, cfg, c, state.pos, active=active)
        W = tokens.shape[1]
        adv = W if active is None else W * active.to(torch.int64)
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
        F = self._prefix_len
        if cache_len is None:
            cache_len = F + T + max_new_tokens
        if cache_len < F + T + max_new_tokens:
            raise ValueError(f"cache_len {cache_len} < {F}+{T}+{max_new_tokens}")
        logits, state = self.prefill(params, batch, cache_len, prompt_lens=prompt_lens)
        if generator is None:           # the JAX package's default key is PRNGKey(0)
            generator = torch.Generator(device=logits.device).manual_seed(0)
        sample = self._sampler()
        tok = sample(logits[:, -1], generator, temperature, top_k)[:, None]

        if eos_id is None and gen_lens is None:       # closed-batch path
            out = [tok[:, 0]]
            for _ in range(max_new_tokens - 1):
                logits, state = self.decode_step(params, state, tok)
                tok = sample(logits[:, -1], generator, temperature, top_k)[:, None]
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
            nxt = sample(logits[:, -1], generator, temperature, top_k)
            n = n + run.to(torch.int64)
            done = done | (run & (n >= budget))
            if eos_id is not None:
                done = done | (run & (nxt == eos_id))
            out.append(torch.where(run, nxt, torch.full_like(nxt, pad_id)))
            tok = torch.where(run, nxt, tok[:, 0])[:, None]
        return torch.stack(out, dim=1), state


    # -------------------------------------------------- slot-pool serving --
    def init_slot_state(self, max_slots: int, cache_len: int, *, device="cuda") -> SlotState:
        """Empty slot-pool arena: every slot free (active False)."""
        state = self.init_decode_state(max_slots, cache_len, device=device)
        dev = state.pos.device
        z = lambda dtype: torch.zeros((max_slots,), dtype=dtype, device=dev)
        return SlotState(state=state, tok=torch.zeros((max_slots, 1), dtype=torch.int64, device=dev),
                         active=z(torch.bool), done=z(torch.bool), n_gen=z(torch.int64),
                         budget=z(torch.int64))

    @torch.no_grad()
    def prefill_into(self, params, slots: SlotState, batch, slot_idx, budget,
                     generator: Optional[torch.Generator] = None, *, cache_len: int,
                     prompt_lens=None, temperature: float = 0.0, top_k: int = 0,
                     eos_id: Optional[int] = None):
        """Prefill a fixed-shape batch of new requests and write its rows
        into the arena at ``slot_idx (Bp,)`` (host ints; rows with
        ``slot_idx >= max_slots`` are padding and touch nothing). Samples
        each new request's first token from the prefill logits, the whole
        group from one ``generator``. ``cache_len`` must be the pool's.
        Returns (tok0 (Bp,), slots), the arena updated in place. Reads
        nothing back from the card: the host data goes over without a sync.
        Recurrent archs take no ``prompt_lens`` (rows of one exact length)."""
        logits, new = self.prefill(params, batch, cache_len, prompt_lens=prompt_lens)
        tok0 = sample_logits(logits[:, -1], generator, temperature, top_k)
        budget = budget.to(device=tok0.device, dtype=torch.int64) if torch.is_tensor(budget) \
            else _from_host(np.asarray(budget, np.int64), tok0.device)
        done0 = budget <= 1
        if eos_id is not None:
            done0 = done0 | (tok0 == eos_id)
        dst, src = _live_rows(slot_idx, slots.active.shape[0], tok0.device)
        _scatter_rows(slots.state.layers, new.layers, dst, src)
        slots.state.pos[dst] = new.pos[src]
        slots.tok[dst, 0] = tok0[src]
        # index_fill_: a scalar set by index would copy it to the card and sync
        slots.active.index_fill_(0, dst, True)
        slots.done[dst] = done0[src]
        slots.n_gen.index_fill_(0, dst, 1)
        slots.budget[dst] = budget[src]
        return tok0, slots

    @torch.no_grad()
    def decode_segment(self, params, slots: SlotState, generator: Optional[torch.Generator] = None,
                       *, seg_len: int, temperature: float = 0.0, top_k: int = 0,
                       eos_id: Optional[int] = None, pad_id: int = 0):
        """Advance the whole pool ``seg_len`` decode steps, with nothing
        read back to the host. Per step only ``run = active & ~done`` slots
        consume their token, write KV and advance ``pos``; rows that hit
        EOS or their budget flip ``done`` and coast (emitting ``pad_id``).
        Returns (emitted (max_slots, seg_len), slots): slot b's real tokens
        are the first ``n_gen_after[b] - n_gen_before[b]`` of ``emitted[b]``
        (``done`` is monotone, so real tokens are a prefix)."""
        params = as_view(params)
        emits = []
        for _ in range(seg_len):
            run = slots.run
            logits, st = self.decode_step(params, slots.state, slots.tok, active=run)
            nxt = sample_logits(logits[:, -1], generator, temperature, top_k)
            slots.n_gen += run
            fin = run & (slots.n_gen >= slots.budget)
            if eos_id is not None:
                fin |= run & (nxt == eos_id)
            slots.done |= fin
            emits.append(torch.where(run, nxt, pad_id))
            slots.tok[:, 0] = torch.where(run, nxt, slots.tok[:, 0])
            slots.state.pos.copy_(st.pos)
        return torch.stack(emits, dim=1), slots

    # ----------------------------------------------- speculative decoding --
    def init_spec_state(self, draft_model: "Model", max_slots: int, cache_len: int, *,
                        device="cuda") -> SpecState:
        """Paired empty pools: the target's slot arena and the draft's
        cache arena over the same (max_slots, cache_len) grid."""
        return SpecState(slots=self.init_slot_state(max_slots, cache_len, device=device),
                         draft=draft_model.init_decode_state(max_slots, cache_len, device=device))

    @torch.no_grad()
    def prefill_state_into(self, params, pool: DecodeState, batch, slot_idx, *, cache_len: int,
                           prompt_lens=None) -> DecodeState:
        """``prefill_into`` for a bare cache pool (the draft half of
        speculative decoding): no sampling, no liveness bookkeeping."""
        _, new = self.prefill(params, batch, cache_len, prompt_lens=prompt_lens)
        dst, src = _live_rows(slot_idx, pool.pos.shape[0], pool.pos.device)
        _scatter_rows(pool.layers, new.layers, dst, src)
        pool.pos[dst] = new.pos[src]
        return pool

    @torch.no_grad()
    def draft_propose(self, params, draft: DecodeState, tok, pos, run, *, spec_k: int):
        """Greedy k-token proposal over the draft pool. ``tok``/``pos``/
        ``run`` come from the target's SlotState: the draft's own ``pos`` is
        overwritten, which is how rejected speculation rolls the draft back.
        Runs ``spec_k + 1`` steps, so the draft also consumes its last
        proposal and its KV covers every position the target can commit.
        Returns (proposals (B, spec_k), draft)."""
        params = as_view(params)
        draft.pos.copy_(pos)
        st, tk, props = draft, tok, []
        for _ in range(spec_k + 1):
            logits, st = self.decode_step(params, st, tk, active=run)
            nxt = greedy_tokens(logits[:, -1])
            tk = torch.where(run, nxt, tk[:, 0])[:, None]
            props.append(nxt)
        draft.pos.copy_(st.pos)
        return torch.stack(props[:spec_k], dim=1), draft

    @torch.no_grad()
    def spec_verify(self, params, slots: SlotState, proposals, *, eos_id: Optional[int] = None,
                    pad_id: int = 0):
        """One batched target forward verifies every live slot's proposals,
        commits the accepted prefix and rolls back the rest; greedy only.

        With current token w0 = ``tok`` and proposals w1..wk, the width-
        (k+1) verify gives target greedy tokens t0..tk (t_i conditions on
        w0..w_i); w_{i+1} is accepted iff w_{j+1} == t_j for all j <= i. With
        ``a`` accepted the commit stream is w1..wa, t_a (the bonus token),
        cut at the first EOS and at the remaining budget. Rollback is
        structural: ``pos`` is set to the committed length, ``tok`` to the
        last committed token. Returns (emitted (max_slots, k+1), slots)
        under ``decode_segment``'s n_gen-delta protocol."""
        B, k = proposals.shape
        W = k + 1
        run = slots.run
        p0 = slots.state.pos
        tokens = torch.cat([slots.tok, proposals], dim=1)             # (B, W)
        logits, _ = self.decode_verify(params, slots.state, tokens, active=run)
        t = greedy_tokens(logits)                                     # (B, W)
        acc = torch.cumprod((proposals == t[:, :k]).to(torch.int64), dim=1).sum(dim=1)
        idx = torch.arange(W, device=t.device)[None, :]
        props_ext = torch.cat([proposals, torch.zeros_like(proposals[:, :1])], dim=1)
        cand_toks = torch.where(idx < acc[:, None], props_ext, t)     # (B, W)
        remaining = (slots.budget - slots.n_gen).clamp_min(1)
        cand = torch.minimum(acc + 1, remaining)                      # (B,) >= 1
        if eos_id is not None:
            is_eos = (cand_toks == eos_id) & (idx < cand[:, None])
            eos_hit = is_eos.any(dim=1)
            first_eos = torch.argmax(is_eos.to(torch.int64), dim=1)  # 0 if none
            m = torch.where(eos_hit, first_eos + 1, cand)
        else:
            eos_hit = torch.zeros_like(run)
            m = cand
        m = torch.where(run, m, 0)
        emitted = torch.where(run[:, None] & (idx < m[:, None]), cand_toks, pad_id)
        last = torch.gather(cand_toks, 1, (m - 1).clamp_min(0)[:, None])[:, 0]
        slots.n_gen += m
        slots.done |= run & (eos_hit | (slots.n_gen >= slots.budget))
        slots.state.pos.copy_(p0 + m)                                 # structural rollback
        slots.tok[:, 0] = torch.where(run, last, slots.tok[:, 0])
        return emitted, slots


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)

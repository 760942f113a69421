"""Serving launcher: the port of ``repro.launch.serve``'s engines and CLI.

* ``GenerationEngine`` — closed batch: a fixed request list is sorted by
  prompt length, grouped into batches of ``max_batch`` that share a
  power-of-two prompt bucket, right-padded, filled with dummy rows up to
  ``max_batch``, and each batch runs ``Model.generate`` to its full gen
  length with per-row ``prompt_lens``. EOS / per-request budgets freeze
  finished rows; the engine reports ``tokens_generated`` vs
  ``tokens_padded``.
* ``ContinuousEngine`` — open stream: a fixed ``(max_slots, cache_len)``
  slot-pool KV arena (``Model.SlotState``) driven by a host scheduler that
  interleaves bucketed prefill launches (``prefill_into`` writes new rows
  into free slots) with fixed-shape ``decode_segment`` launches, retiring
  finished rows and refilling their slots between segments; admission is
  capped by a token budget; outputs stream per request as rows finish.
  With a draft model it runs greedy speculative decoding on the same
  arena (``draft_propose`` + one ``spec_verify`` forward a round), whose
  output equals non-speculative greedy decoding.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gpt-125m \
      --requests 8 --batch 8 --prompt-len 512 --gen 32 --flash-min-len 256
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gpt-tiny --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gpt-tiny --smoke --device cpu \
      --continuous --requests 32 --slots 8 --seg-len 8 --arrival-rate 0.5 \
      [--speculative-draft layers:1 --spec-k 4]
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-1.6b --smoke --device cpu \
      [--continuous]
  PYTHONPATH=src python -m repro_torch.launch.serve --arch internvl2-1b --smoke --device cpu \
      [--continuous [--speculative-draft layers:1]]

VLM and enc-dec archs (internvl2, seamless-m4t) need a frontend (F, D) on
every request (frame or patch embeddings, stubs as in the JAX package);
the engines stack a launch's frontends, with zeros for its dummy rows. A
VLM's patch prefix takes F positions of each cache row, so the continuous
engine reserves F + bucket + budget positions a request.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import time
from collections import deque
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.data.synthetic import SyntheticCorpus
from repro_torch.launch.api import (AdmissionError, CapabilityError, PoolError, Request,
                                    RequestResult, SamplingParams, make_engine)
from repro_torch.models.model import Model, ParamView, as_view, build_model, param_dict

__all__ = ["SlotPool", "GenerationEngine", "ContinuousEngine", "draft_from_target",
           "synthetic_requests", "poisson_requests", "attach_frontends", "main"]


def _bucket_len(n: int, lo: int = 8) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


def synthetic_requests(vocab_size: int, n: int, lo: int, hi: int, seed: int = 0) -> list[Request]:
    """``n`` requests whose prompts are synthetic-corpus rows cut to seeded
    lengths in [lo, hi]."""
    toks = SyntheticCorpus(vocab_size, hi, max(n, 1), seed=seed).batch_at(0)["tokens"]
    rng = np.random.default_rng(seed)
    return [Request(tokens=toks[i, :int(rng.integers(lo, hi + 1))]) for i in range(n)]


def poisson_requests(vocab_size: int, n: int, lo: int, hi: int, gen_lo: int, gen_hi: int,
                     rate: float, seed: int = 0) -> list[Request]:
    """An open-stream trace, drawn as the JAX package's serving benchmark
    draws it (``benchmarks/decode.py``): per request a prompt length in
    [lo, hi], a budget in [gen_lo, gen_hi], an exponential gap of mean
    1/rate virtual ticks, then uniform prompt tokens in [2, vocab)."""
    rng = np.random.default_rng(seed)
    reqs, arrival = [], 0.0
    for _ in range(n):
        L = int(rng.integers(lo, hi + 1))
        g = int(rng.integers(gen_lo, gen_hi + 1))
        arrival += float(rng.exponential(1.0 / rate))
        reqs.append(Request(tokens=rng.integers(2, vocab_size, size=L).astype(np.int32),
                            max_new_tokens=g, arrival=arrival))
    return reqs


def attach_frontends(requests: Sequence[Request], cfg, seed: int = 0) -> list[Request]:
    """The requests with frontend stubs (frontend_len, d_model) f32: the
    rows of the synthetic corpus's ``frontend_at(0)`` for ``seed``, as the
    JAX package's serve CLI draws them."""
    fe = SyntheticCorpus(cfg.vocab_size, 1, max(len(requests), 1), seed=seed).frontend_at(
        0, cfg.d_model, cfg.frontend_len)
    return [dataclasses.replace(r, frontend=fe[i]) for i, r in enumerate(requests)]


def _frontends(requests: Sequence[Request], idxs, Bp: int, device) -> torch.Tensor:
    """A launch's frontends stacked (Bp, F, D) on ``device``, zeros for the
    dummy rows."""
    fes = [torch.as_tensor(requests[i].frontend) for i in idxs]
    fes += [torch.zeros_like(fes[0])] * (Bp - len(fes))
    return torch.stack(fes).to(device)


class SlotPool:
    """Host-side free/alloc bookkeeping for the slot arena: which slot a new
    request lands in (lowest free first), with the scheduler's invariants
    guarded (no double alloc, no double free, no lost slot)."""

    def __init__(self, n_slots: int):
        if n_slots <= 0:
            raise AdmissionError(f"n_slots must be positive, got {n_slots}")
        self.n_slots = n_slots
        self._free = list(range(n_slots - 1, -1, -1))   # lowest slot first
        self._live: set = set()
        self._used: set = set()
        self.allocs = 0                                  # lifetime counter
        self.reuses = 0                # allocs that recycled a retired slot

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def live(self) -> frozenset:
        return frozenset(self._live)

    def alloc(self) -> int:
        if not self._free:
            raise PoolError("SlotPool.alloc on a full pool")
        s = self._free.pop()
        self._live.add(s)
        if s in self._used:
            self.reuses += 1
        self._used.add(s)
        self.allocs += 1
        return s

    def release(self, slot: int):
        if slot not in self._live:
            raise PoolError(f"SlotPool.release of non-live slot {slot}")
        self._live.remove(slot)
        self._free.append(slot)


class GenerationEngine:
    """Batched serving engine over ``Model.generate``.

    Requests are sorted by prompt length and grouped into batches of
    ``max_batch``; each batch is right-padded to a power-of-two prompt
    bucket (dummy rows fill it to ``max_batch``) and generated with per-row
    ``prompt_lens``. Runs on the device that holds ``params``."""

    def __init__(self, model: Model, params, *, max_batch: int = 8,
                 sampling: Optional[SamplingParams] = None):
        sp = sampling if sampling is not None else SamplingParams()
        self.sampling = sp
        self.model = model
        self.params = params
        self.device = params.device
        self.seed = sp.seed
        self._calls = 0            # advances the default sampling stream
        self.max_batch = max_batch
        self.pad_id = sp.pad_id
        self.eos_id = sp.eos_id
        self._exact_lens = model._has_recurrent_state()
        # tokens_generated = real (pre-EOS / in-budget) tokens on real rows;
        # tokens_padded = decode slots burned on finished/dummy rows
        self.stats = {"batches": 0, "tokens_generated": 0, "tokens_padded": 0}

    def _group(self, order: Sequence[int], reqs: Sequence[Request]):
        """Batches of ≤ max_batch indices sharing a prompt bucket."""
        groups, cur, cur_bucket = [], [], None
        for i in order:
            n = len(reqs[i].tokens)
            b = n if self._exact_lens else _bucket_len(n)
            if cur and (b != cur_bucket or len(cur) == self.max_batch):
                groups.append((cur_bucket, cur))
                cur = []
            if not cur:
                cur_bucket = b
            cur.append(i)
        if cur:
            groups.append((cur_bucket, cur))
        return groups

    def generate(self, requests: Sequence[Request], max_new_tokens: int,
                 generator: Optional[torch.Generator] = None) -> list[np.ndarray]:
        """Serve a list of ragged requests; returns per-request generated
        token arrays (max_new_tokens,), in the input order.

        Without an explicit ``generator`` the sampling stream advances per
        call (the call counter is folded into the engine seed)."""
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(
                self.seed + 1_000_003 * self._calls)
        self._calls += 1
        for i, r in enumerate(requests):
            err = self._request_error(i, r)
            if err is not None:
                raise ValueError(err)
        order = sorted(range(len(requests)), key=lambda i: len(requests[i].tokens))
        budgets = [min(r.max_new_tokens or max_new_tokens, max_new_tokens) for r in requests]
        # per-request budgets / EOS engage the masked loop
        masked = self.eos_id is not None or any(b != max_new_tokens for b in budgets)
        out: list = [None] * len(requests)
        pending = []
        for bucket, idxs in self._group(order, requests):
            Bp = self.max_batch
            toks = np.full((Bp, bucket), self.pad_id, np.int64)
            lens = np.full((Bp,), bucket, np.int64)   # dummy rows full-length
            buds = np.ones((Bp,), np.int64)           # dummy rows: 1 token
            for r, i in enumerate(idxs):
                t = np.asarray(requests[i].tokens, np.int64)
                toks[r, :len(t)] = t
                lens[r] = len(t)
                buds[r] = budgets[i]
            dev = self.device
            batch = {"tokens": torch.from_numpy(toks).to(dev)}
            if self.model.needs_frontend:
                batch["frontend"] = _frontends(requests, idxs, Bp, dev)
            ragged = None if (lens == bucket).all() else torch.from_numpy(lens).to(dev)
            gen, _ = self.model.generate(
                self.params, batch, max_new_tokens, generator=generator,
                prompt_lens=ragged, gen_lens=torch.from_numpy(buds).to(dev) if masked else None,
                sampling=self.sampling)
            pending.append((idxs, Bp, gen))   # host-sync AFTER every group is enqueued
            self.stats["batches"] += 1
        for idxs, Bp, gen in pending:
            gen = gen.cpu().numpy().astype(np.int32)
            real = 0
            for r, i in enumerate(idxs):
                out[i] = gen[r]
                real += self._real_len(gen[r], budgets[i])
            self.stats["tokens_generated"] += real
            self.stats["tokens_padded"] += Bp * max_new_tokens - real
        return out

    def _real_len(self, row: np.ndarray, budget: int) -> int:
        """User-visible token count of an output row: up to and including
        the first EOS, capped by the request's budget."""
        if self.eos_id is not None:
            hits = np.flatnonzero(row[:budget] == self.eos_id)
            if hits.size:
                return int(hits[0]) + 1
        return int(budget)

    @property
    def goodput(self) -> float:
        """Real generated tokens / generation slots computed."""
        total = self.stats["tokens_generated"] + self.stats["tokens_padded"]
        return self.stats["tokens_generated"] / max(total, 1)

    def run(self, requests: Sequence[Request], max_new_tokens: int,
            generator: Optional[torch.Generator] = None) -> tuple[list[RequestResult], dict]:
        """(results, report): malformed requests surface as
        ``finish_reason='error'`` rather than raising."""
        results: list[Optional[RequestResult]] = [None] * len(requests)
        good, idxmap = [], []
        for i, r in enumerate(requests):
            err = self._request_error(i, r)
            if err is not None:
                results[i] = RequestResult(np.zeros(0, np.int32), 0, "error", error=err)
            else:
                good.append(r)
                idxmap.append(i)
        outs = self.generate(good, max_new_tokens, generator=generator) if good else []
        for j, i in enumerate(idxmap):
            b = min(good[j].max_new_tokens or max_new_tokens, max_new_tokens)
            nreal = self._real_len(outs[j], b)
            toks = np.asarray(outs[j][:nreal], np.int32)
            eos = self.eos_id is not None and nreal > 0 and int(toks[-1]) == self.eos_id
            results[i] = RequestResult(toks, nreal, "eos" if eos else "budget")
        report = {"mode": "closed", "goodput": self.goodput, **self.stats}
        return results, report

    def _request_error(self, i: int, r: Request) -> Optional[str]:
        if self.model.needs_frontend and r.frontend is None:
            return (f"request {i}: {self.model.cfg.name} requires frontend embeddings on every "
                    f"request")
        if not self.model.needs_frontend and r.frontend is not None:
            return f"request {i}: frontend given for a text-only arch"
        return None


class ContinuousEngine:
    """In-flight continuous batching over a slot-pool KV arena.

    The device side is ``prefill_into`` (new rows written into free slots,
    one fixed prefill batch a launch) and ``decode_segment`` (every slot
    ``seg_len`` steps); the host side is this scheduler:

      1. arrivals (virtual clock, ``Request.arrival`` ticks) join a FIFO
      2. admission: the queue head is admitted while a slot is free and
         ``reserved + (F + bucket + budget) <= token_budget`` (F: a VLM's
         patch prefix, else 0) — strict FIFO, so admission control never
         starves a long request
      3. admitted requests are grouped per prompt bucket into prefill
         launches of a fixed batch, padded with dummy rows
         (``slot_idx = max_slots``) that touch nothing
      4. one decode segment advances the pool; finished rows (EOS / budget)
         are retired between segments and their slots refilled by step 2

    The virtual clock charges ``seg_len`` ticks a decode segment (one tick
    = one decode step), ``ceil(bucket / seg_len)`` a prefill launch and
    one a speculative round; the queueing-delay percentiles of the report
    use this clock, so they do not depend on the hardware. The device is
    read back once a prefill launch (its first tokens) and once a segment
    or round (emitted tokens, ``n_gen``, ``done``), never per token.

    With ``spec_k > 0`` and a draft model every round is one
    ``draft_propose`` over the paired draft pool and one ``spec_verify``
    target forward over ``(max_slots, spec_k + 1)``; greedy only.

    Sampling (temperature > 0) draws from a ``torch.Generator`` seeded
    from (seed, call, event), one per prefill launch and segment. VLM and
    enc-dec archs need a frontend on every request (its launch stacks them,
    zeros for the dummy rows); a text-only arch ignores one.
    Outputs stream: ``on_token(req_idx, token)`` fires per real decoded
    token, ``on_complete(req_idx, tokens)`` when a row retires.
    """

    def __init__(self, model: Model, params, *, cache_len: int, max_slots: int = 8,
                 seg_len: int = 8, prefill_batch: int = 2, token_budget: Optional[int] = None,
                 sampling: Optional[SamplingParams] = None, draft_model: Optional[Model] = None,
                 draft_params=None, spec_k: int = 0):
        if max_slots <= 0 or seg_len <= 0 or prefill_batch <= 0:
            raise AdmissionError("max_slots, seg_len, prefill_batch must be > 0")
        sp = sampling if sampling is not None else SamplingParams()
        self.sampling = sp
        self.model = model
        self.params = params
        self.device = as_view(params).device
        self.cache_len = int(cache_len)
        self.max_slots = int(max_slots)
        self.seg_len = int(seg_len)
        self.prefill_batch = int(prefill_batch)
        # admission reservation cap: Σ_live (frontend prefix + bucket + budget)
        self.token_budget = (int(token_budget) if token_budget is not None
                             else self.max_slots * self.cache_len)
        self.pad_id = sp.pad_id
        self.eos_id = sp.eos_id
        self.seed = sp.seed
        self._calls = 0
        # recurrent states would take pad tokens in: bucket by exact length
        self._exact_lens = model._has_recurrent_state()
        self.spec_k = int(spec_k)
        self.draft_model = draft_model
        self.draft_params = draft_params
        if self.spec_k < 0:
            raise AdmissionError(f"spec_k must be >= 0, got {spec_k}")
        if self.spec_k:
            if draft_model is None or draft_params is None:
                raise AdmissionError(f"spec_k={spec_k} requires draft_model= and draft_params=")
            if sp.temperature > 0 or sp.top_k > 0:
                raise CapabilityError(
                    "speculative decoding is greedy-only: under argmax the k-token rejection "
                    "guarantee degenerates to exact prefix match (bit-parity); sampling "
                    "acceptance is not implemented — use spec_k=0 with temperature > 0")
            if model._has_recurrent_state():
                raise CapabilityError(
                    f"{model.cfg.name}: speculative decoding needs structural KV rollback by "
                    f"position; recurrent state (SSM/RWKV) cannot roll back a rejected suffix "
                    f"— use spec_k=0")
            if draft_model._has_recurrent_state():
                raise CapabilityError(
                    f"draft {draft_model.cfg.name}: recurrent draft state cannot roll back "
                    f"rejected proposals — use an attention draft")
            if draft_model.cfg.vocab_size != model.cfg.vocab_size:
                raise AdmissionError(f"draft vocab {draft_model.cfg.vocab_size} != target "
                                     f"vocab {model.cfg.vocab_size}")
        self.stats = {"prefill_launches": 0, "segments": 0, "prefill_slot_rows": 0,
                      "decode_slot_steps": 0, "tokens_real": 0, "slot_allocs": 0,
                      "max_reserved": 0, "verify_launches": 0, "target_slot_forwards": 0,
                      "spec_tokens_committed": 0}

    def _bucket(self, n: int) -> int:
        return n if self._exact_lens else _bucket_len(n)

    def _reservation(self, i: int, r: Request, max_new_tokens: int) -> tuple:
        """Admission-time validation for one request; raises
        ``AdmissionError`` if it could never be scheduled. Returns
        (budget, reservation)."""
        if self.model.needs_frontend and r.frontend is None:
            raise AdmissionError(f"request {i}: frontend embeddings required")
        b = min(r.max_new_tokens or max_new_tokens, max_new_tokens)
        bucket = self._bucket(len(r.tokens))
        F = self.model._prefix_len
        res = F + bucket + b
        if res > self.cache_len:
            raise AdmissionError(f"request {i}: frontend {F} + prompt bucket {bucket} + budget "
                                 f"{b} = {res} exceeds cache_len {self.cache_len}")
        if res > self.token_budget:
            raise AdmissionError(f"request {i}: reservation {res} exceeds token_budget "
                                 f"{self.token_budget} — it could never be admitted")
        return b, res

    def _generator(self, stream: tuple, event: int) -> Optional[torch.Generator]:
        """The sampling stream of one prefill launch or segment (None when
        greedy, which draws nothing)."""
        if self.sampling.temperature <= 0:
            return None
        seed = int(np.random.SeedSequence([*stream, event]).generate_state(1)[0])
        return torch.Generator(device=self.device).manual_seed(seed)

    # ------------------------------------------------------------ server --
    def serve(self, requests: Sequence[Request], max_new_tokens: int, *,
              seed: Optional[int] = None, on_token: Optional[Callable[[int, int], None]] = None,
              on_complete: Optional[Callable[[int, np.ndarray], None]] = None):
        """Run an open-stream trace to completion.

        Returns ``(outputs, report)``: per-request arrays of the real
        generated tokens (up to and including EOS, capped by the request
        budget), in input order, and a report of goodput, virtual-clock
        queueing-delay percentiles and the scheduler's counters.
        ``seed`` sets the sampling stream; by default the engine's seed
        with this call's index."""
        stream = (self.seed, self._calls) if seed is None else (seed,)
        self._calls += 1
        n = len(requests)
        budgets, resv = [], []
        for i, r in enumerate(requests):
            b, res = self._reservation(i, r, max_new_tokens)
            budgets.append(b)
            resv.append(res)

        pool = SlotPool(self.max_slots)
        model, dev = self.model, self.device
        draft = None
        if self.spec_k:
            spec = model.init_spec_state(self.draft_model, self.max_slots, self.cache_len,
                                         device=dev)
            slots, draft = spec.slots, spec.draft
        else:
            slots = model.init_slot_state(self.max_slots, self.cache_len, device=dev)
        arr_order = sorted(range(n), key=lambda i: (requests[i].arrival, i))
        arrived: deque = deque()
        p = 0                       # next not-yet-arrived index in arr_order
        clock = 0.0
        reserved = 0
        ev = 0                      # sampling event counter
        slot_req: dict[int, int] = {}
        slot_ngen = np.zeros(self.max_slots, np.int64)  # host n_gen mirror
        outputs: list[list[int]] = [[] for _ in range(n)]
        delays = np.zeros(n)
        done_tick = np.zeros(n)
        completed = 0
        sp = self.sampling

        def retire(s: int, i: int):
            nonlocal reserved, completed
            pool.release(s)
            del slot_req[s]
            reserved -= resv[i]
            done_tick[i] = clock
            completed += 1
            if on_complete is not None:
                on_complete(i, np.asarray(outputs[i], np.int32))

        def emit(i: int, t: int):
            outputs[i].append(t)
            self.stats["tokens_real"] += 1
            if on_token is not None:
                on_token(i, t)

        while completed < n:
            while p < n and requests[arr_order[p]].arrival <= clock + 1e-9:
                arrived.append(arr_order[p])
                p += 1
            # strict-FIFO admission under the slot + token-budget caps
            admits: list[int] = []
            while (arrived and pool.n_free > len(admits)
                   and reserved + sum(resv[j] for j in admits) + resv[arrived[0]]
                   <= self.token_budget):
                admits.append(arrived.popleft())
            # group same-bucket admits into fixed-shape prefill launches
            g = 0
            while g < len(admits):
                bucket = self._bucket(len(requests[admits[g]].tokens))
                group = [admits[g]]
                g += 1
                while (g < len(admits) and len(group) < self.prefill_batch
                       and self._bucket(len(requests[admits[g]].tokens)) == bucket):
                    group.append(admits[g])
                    g += 1
                Bp = self.prefill_batch
                toks = np.full((Bp, bucket), self.pad_id, np.int64)
                lens = np.full((Bp,), bucket, np.int64)
                sidx = np.full((Bp,), self.max_slots, np.int64)  # dummy rows touch nothing
                buds = np.ones((Bp,), np.int64)
                for r, i in enumerate(group):
                    t = np.asarray(requests[i].tokens, np.int64)
                    toks[r, :len(t)] = t
                    lens[r] = len(t)
                    s = pool.alloc()
                    slot_req[s] = i
                    sidx[r] = s
                    buds[r] = budgets[i]
                    reserved += resv[i]
                    delays[i] = clock - requests[i].arrival
                self.stats["max_reserved"] = max(self.stats["max_reserved"], reserved)
                batch = {"tokens": torch.from_numpy(toks).to(dev)}
                if model.needs_frontend:
                    batch["frontend"] = _frontends(requests, group, Bp, dev)
                # attention archs always pass prompt_lens; recurrent archs
                # bucket by exact length, so rows are never ragged
                pl = None if self._exact_lens else torch.from_numpy(lens).to(dev)
                tok0, slots = model.prefill_into(
                    self.params, slots, batch, sidx, buds, self._generator(stream, ev),
                    cache_len=self.cache_len, prompt_lens=pl, temperature=sp.temperature,
                    top_k=sp.top_k, eos_id=self.eos_id)
                if self.spec_k:
                    # the same rows into the draft's pool; the virtual clock
                    # charges nothing extra (the reference overlaps it)
                    draft = self.draft_model.prefill_state_into(
                        self.draft_params, draft, batch, sidx, cache_len=self.cache_len,
                        prompt_lens=pl)
                ev += 1
                clock += max(1, math.ceil(bucket / self.seg_len))
                self.stats["prefill_launches"] += 1
                self.stats["prefill_slot_rows"] += Bp
                tok0 = tok0.cpu().numpy()
                for r, i in enumerate(group):
                    t0 = int(tok0[r])
                    emit(i, t0)
                    slot_ngen[sidx[r]] = 1
                    # instantly-done rows (budget 1, or first token is EOS)
                    # retire before ever occupying a decode segment
                    if budgets[i] <= 1 or (self.eos_id is not None and t0 == self.eos_id):
                        retire(int(sidx[r]), i)
            if slot_req:
                if self.spec_k:
                    props, draft = self.draft_model.draft_propose(
                        self.draft_params, draft, slots.tok, slots.state.pos, slots.run,
                        spec_k=self.spec_k)
                    emitted, slots = model.spec_verify(self.params, slots, props,
                                                       eos_id=self.eos_id, pad_id=self.pad_id)
                    clock += 1
                    self.stats["verify_launches"] += 1
                    # every slot still in slot_req is running (done rows
                    # retire the moment they are read back)
                    self.stats["target_slot_forwards"] += len(slot_req)
                    self.stats["decode_slot_steps"] += self.max_slots * (self.spec_k + 1)
                else:
                    emitted, slots = model.decode_segment(
                        self.params, slots, self._generator(stream, ev), seg_len=self.seg_len,
                        temperature=sp.temperature, top_k=sp.top_k, eos_id=self.eos_id,
                        pad_id=self.pad_id)
                    ev += 1
                    clock += self.seg_len
                    self.stats["segments"] += 1
                    self.stats["decode_slot_steps"] += self.max_slots * self.seg_len
                # the one read-back of the segment or round
                host = torch.cat([emitted, slots.n_gen[:, None], slots.done[:, None].long()],
                                 dim=1).cpu().numpy()
                em, ngen, done = host[:, :-2], host[:, -2], host[:, -1]
                for s, i in list(slot_req.items()):
                    k = int(ngen[s] - slot_ngen[s])   # done is monotone: real
                    for t in em[s, :k]:               # tokens are a prefix
                        emit(i, int(t))
                    if self.spec_k:
                        self.stats["spec_tokens_committed"] += k
                    slot_ngen[s] = ngen[s]
                    if done[s]:
                        retire(s, i)
            elif not arrived:
                if p >= n:          # nothing live, queued or future: a bug
                    raise PoolError("scheduler stalled with requests outstanding")
                clock = max(clock, requests[arr_order[p]].arrival)  # idle jump
            else:
                # arrived but unadmitted with an empty pool is impossible:
                # reserved == 0 and every reservation was validated above
                raise PoolError("admission stalled with free slots")

        self.stats["slot_allocs"] = pool.allocs
        token_slots = self.stats["prefill_slot_rows"] + self.stats["decode_slot_steps"]
        report = {
            "requests": n,
            "max_slots": self.max_slots,
            "seg_len": self.seg_len,
            "prefill_batch": self.prefill_batch,
            "token_budget": self.token_budget,
            "clock_ticks": float(clock),
            "tokens_real": self.stats["tokens_real"],
            "token_slots": token_slots,
            "goodput": self.stats["tokens_real"] / max(token_slots, 1),
            "delay_p50": float(np.percentile(delays, 50)),
            "delay_p99": float(np.percentile(delays, 99)),
            "completion_p99": float(np.percentile(
                done_tick - np.array([r.arrival for r in requests]), 99)),
            "prefill_launches": self.stats["prefill_launches"],
            "segments": self.stats["segments"],
            "slot_allocs": pool.allocs,
            "slot_reuse": pool.reuses,
            "max_reserved": self.stats["max_reserved"],
            "delays": [float(d) for d in delays],
        }
        if self.spec_k:
            fw = self.stats["target_slot_forwards"]
            committed = self.stats["spec_tokens_committed"]
            report.update({
                "spec_k": self.spec_k,
                "verify_launches": self.stats["verify_launches"],
                "target_slot_forwards": fw,
                "spec_tokens_committed": committed,
                # each verify forward commits 1 token for free (the bonus
                # token) plus 0..k accepted proposals: the share of
                # proposal slots that landed
                "acceptance_rate": (committed - fw) / max(fw * self.spec_k, 1),
            })
        return [np.asarray(o, np.int32) for o in outputs], report

    def run(self, requests: Sequence[Request], max_new_tokens: int, *,
            seed: Optional[int] = None) -> tuple[list[RequestResult], dict]:
        """``serve`` with the unified results: an inadmissible request comes
        back as ``finish_reason='error'`` (with the admission message)
        instead of failing the trace; admitted ones carry their
        virtual-clock queueing delay."""
        results: list[Optional[RequestResult]] = [None] * len(requests)
        good, idxmap = [], []
        for i, r in enumerate(requests):
            try:
                self._reservation(i, r, max_new_tokens)
            except AdmissionError as e:
                results[i] = RequestResult(np.zeros(0, np.int32), 0, "error", error=str(e))
            else:
                good.append(r)
                idxmap.append(i)
        outs, report = self.serve(good, max_new_tokens, seed=seed) if good else ([], {"requests": 0})
        for j, i in enumerate(idxmap):
            toks = outs[j]
            eos = self.eos_id is not None and len(toks) > 0 and int(toks[-1]) == self.eos_id
            results[i] = RequestResult(toks, int(len(toks)), "eos" if eos else "budget",
                                       delay_ticks=float(report["delays"][j]))
        return results, report


def draft_from_target(model: Model, params, spec: str):
    """A (draft_model, draft_params) pair from the target itself.

    ``"self"``: the target is its own draft (every proposal accepted: for
    parity and boundary tests, not for speed). ``"layers:N"``: the depth-N
    truncation, the first N decoder layers of the stacked group as views
    (no copy), sharing the target's ``embed``, ``lm_head``, ``final_norm``
    and whole ``encoder``. Truncation needs a single-group decoder (the
    dense families)."""
    if spec == "self":
        return model, params
    if not spec.startswith("layers:"):
        raise AdmissionError(f"unknown draft spec {spec!r} (self | layers:N)")
    n = int(spec.split(":", 1)[1])
    cfg = model.cfg
    if n <= 0 or n >= cfg.n_layers:
        raise AdmissionError(f"layers:{n} draft needs 0 < N < n_layers={cfg.n_layers}")
    if len(cfg.decoder_program()) != 1:
        raise CapabilityError(f"{cfg.name}: layers:N draft slicing needs a single-group "
                              f"decoder program; pass an explicit draft model")
    tree = dict(param_dict(params))
    group = tree["decoder"]["groups"][0]
    tree["decoder"] = {"groups": [{key: {name: t[:n] for name, t in sub.items()}
                                   for key, sub in group.items()}],
                       "final_norm": tree["decoder"]["final_norm"]}
    return build_model(dataclasses.replace(cfg, n_layers=n)), ParamView(tree)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gpt-tiny")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--requests", type=int, default=8, help="number of ragged requests")
    ap.add_argument("--batch", type=int, default=4, help="engine max batch size")
    ap.add_argument("--prompt-len", type=int, default=32, help="max simulated prompt length")
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--eos-id", type=int, default=None,
                    help="treat this token id as EOS (early exit)")
    ap.add_argument("--continuous", action="store_true",
                    help="serve an open Poisson stream through the slot-pool ContinuousEngine "
                         "instead of the closed-batch GenerationEngine")
    ap.add_argument("--slots", type=int, default=8, help="continuous: slot-pool arena size")
    ap.add_argument("--seg-len", type=int, default=8,
                    help="continuous: decode steps per segment")
    ap.add_argument("--prefill-batch", type=int, default=2,
                    help="continuous: fixed prefill launch batch")
    ap.add_argument("--arrival-rate", type=float, default=0.5,
                    help="continuous: Poisson arrivals per virtual tick")
    ap.add_argument("--token-budget", type=int, default=None,
                    help="continuous: admission cap on reserved tokens")
    ap.add_argument("--speculative-draft", default=None,
                    help="continuous: speculative decoding with a draft built from the target — "
                         "'self' (target as its own draft; parity testing) or 'layers:N' "
                         "(depth-N truncation sharing embed/head); greedy only, output equals "
                         "non-speculative greedy decoding")
    ap.add_argument("--spec-k", type=int, default=4,
                    help="speculative: draft proposals per slot per verify round (the verify "
                         "forward is (slots, k+1) wide)")
    ap.add_argument("--flash-min-len", type=int, default=None,
                    help="prefill dispatches causal self-attention to the flash kernel when "
                         "prompt_len >= this (0 = off, unset = config default)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    if args.flash_min_len is not None:
        cfg = dataclasses.replace(cfg, flash_min_len=args.flash_min_len)
    model = build_model(cfg)
    params = model.init(args.seed, device=args.device)
    # ragged prompts; recurrent archs batch by exact length, so every
    # request of theirs takes the full prompt_len (the reference's demo)
    lo = args.prompt_len if model._has_recurrent_state() else max(args.prompt_len // 2, 1)
    sampling = SamplingParams(temperature=args.temperature, top_k=args.top_k,
                              eos_id=args.eos_id, seed=args.seed)
    if args.continuous:
        return _serve_continuous(args, model, params, sampling, lo)
    requests = synthetic_requests(cfg.vocab_size, args.requests, lo, args.prompt_len,
                                  seed=args.seed)
    if model.needs_frontend:
        requests = attach_frontends(requests, cfg, seed=args.seed)
    engine = make_engine(model, params, mode="closed", sampling=sampling, max_batch=args.batch)
    t0 = time.perf_counter()
    outs = engine.generate(requests, args.gen,
                           generator=torch.Generator(params.device).manual_seed(args.seed + 1))
    t_warm = time.perf_counter() - t0
    t0 = time.perf_counter()
    outs = engine.generate(requests, args.gen,
                           generator=torch.Generator(params.device).manual_seed(args.seed + 1))
    t_serve = time.perf_counter() - t0          # generate ends in a host copy: synchronised
    n_tok = args.requests * args.gen
    print(f"engine on {params.device}: {args.requests} requests (ragged prompts ≤ "
          f"{args.prompt_len}) × {args.gen} new tokens")
    print(f"  warmup: {t_warm * 1e3:.1f} ms")
    print(f"  steady-state: {t_serve * 1e3:.1f} ms ({n_tok / max(t_serve, 1e-9):.1f} tok/s)")
    print(f"  tokens: {engine.stats['tokens_generated']} generated, "
          f"{engine.stats['tokens_padded']} padded (goodput {engine.goodput:.3f})")
    print("sample generations (token ids):")
    for o in outs[:2]:
        print("  ", [int(t) for t in o[:16]])
    return outs


def _serve_continuous(args, model, params, sampling, lo):
    """The ``--continuous`` path of ``main``: per-request budgets in
    [1, gen] and Poisson arrivals (what makes the slots churn)."""
    cfg = model.cfg
    requests = poisson_requests(cfg.vocab_size, args.requests, lo, args.prompt_len, 1,
                                args.gen, args.arrival_rate, seed=args.seed)
    cache_len = _bucket_len(args.prompt_len) + args.gen
    if model.needs_frontend:
        requests = attach_frontends(requests, cfg, seed=args.seed)
        cache_len += cfg.frontend_len          # the JAX CLI's, enc-dec archs included
    spec_kw: dict = {}
    mode = "continuous"
    if args.speculative_draft:
        dm, dp = draft_from_target(model, params, args.speculative_draft)
        spec_kw = dict(draft_model=dm, draft_params=dp, spec_k=args.spec_k)
        mode = "speculative"
    engine = make_engine(model, params, mode=mode, sampling=sampling, cache_len=cache_len,
                         max_slots=args.slots, seg_len=args.seg_len,
                         prefill_batch=args.prefill_batch, token_budget=args.token_budget,
                         **spec_kw)
    t0 = time.perf_counter()
    outs, report = engine.serve(requests, args.gen, seed=args.seed + 1)
    wall = time.perf_counter() - t0            # serve reads every round back: synchronised
    print(f"{mode} on {engine.device}: {args.requests} requests, {args.slots} slots, "
          f"seg_len {args.seg_len}, token_budget {engine.token_budget}")
    print(f"  wall {wall * 1e3:.1f} ms ({report['tokens_real'] / max(wall, 1e-9):.1f} tok/s, "
          f"first call: warm-up included)")
    print(f"  goodput {report['goodput']:.3f} ({report['tokens_real']} real / "
          f"{report['token_slots']} token-slots), slot reuse {report['slot_reuse']}")
    print(f"  queueing delay (virtual ticks): p50 {report['delay_p50']:.1f}  "
          f"p99 {report['delay_p99']:.1f}")
    if engine.spec_k:
        print(f"  speculative: k={report['spec_k']}, acceptance {report['acceptance_rate']:.3f}, "
              f"{report['target_slot_forwards']} target forwards for "
              f"{report['spec_tokens_committed']} committed tokens")
    print("sample generations (token ids):")
    for o in outs[:2]:
        print("  ", [int(t) for t in o[:16]])
    return outs


if __name__ == "__main__":
    main()

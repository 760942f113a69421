"""Serving launcher: the closed-batch generation engine, the port of
``repro.launch.serve``'s ``GenerationEngine`` and the closed path of its
``main``.

A fixed request list is sorted by prompt length, grouped into batches of
``max_batch`` that share a power-of-two prompt bucket, right-padded, filled
with dummy rows up to ``max_batch``, and each batch runs ``Model.generate``
to its full gen length with per-row ``prompt_lens``. EOS / per-request
budgets freeze finished rows; the engine reports ``tokens_generated`` vs
``tokens_padded``. The continuous-batching and speculative engines are not
ported yet (``--continuous`` raises ``CapabilityError``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gpt-125m \
      --requests 8 --batch 8 --prompt-len 512 --gen 32 --flash-min-len 256
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gpt-tiny --smoke --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.data.synthetic import SyntheticCorpus
from repro_torch.launch.api import (CapabilityError, Request, RequestResult, SamplingParams,
                                    make_engine)
from repro_torch.models.model import Model, build_model

__all__ = ["GenerationEngine", "synthetic_requests", "main"]


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
        if r.frontend is not None:
            return f"request {i}: frontend given for a text-only arch"
        return None


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
                    help="continuous batching: not yet ported (raises)")
    ap.add_argument("--flash-min-len", type=int, default=None,
                    help="prefill dispatches causal self-attention to the flash kernel when "
                         "prompt_len >= this (0 = off, unset = config default)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.continuous:
        raise CapabilityError("--continuous: continuous batching is not yet ported to repro_torch")

    cfg = get_config(args.arch, smoke=args.smoke)
    if args.flash_min_len is not None:
        cfg = dataclasses.replace(cfg, flash_min_len=args.flash_min_len)
    model = build_model(cfg)
    params = model.init(args.seed, device=args.device)
    requests = synthetic_requests(cfg.vocab_size, args.requests, max(args.prompt_len // 2, 1),
                                  args.prompt_len, seed=args.seed)

    sampling = SamplingParams(temperature=args.temperature, top_k=args.top_k,
                              eos_id=args.eos_id, seed=args.seed)
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


if __name__ == "__main__":
    main()

"""Deterministic synthetic LM corpus, the port of ``repro.data.synthetic``.

Zipf-distributed order-2 Markov chains over the vocabulary, with the same
transition tables as the JAX corpus (both build them with numpy from
``seed``). The token stream is NOT the JAX corpus's: that one samples with
``jax.random``; this one samples with a numpy ``Generator`` seeded from
(seed, step, host_id). ``batch_at(step)`` is a pure function of its
arguments; ``make_batch_fn`` hands its batches to the trainer as tensors.

Frontend stubs (VLM patches, audio frames): ``frontend_at`` draws
N(0, 0.1²) embeddings (B, F, D) from a numpy ``Generator`` seeded from
(seed + 7, step), where the JAX corpus draws them from ``jax.random`` with
the key ``fold_in(PRNGKey(seed + 7), step)``: the same shape and scale,
not the same numbers.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device, torch_dtype


@dataclasses.dataclass(frozen=True)
class SyntheticCorpus:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_states: int = 64          # Markov state count (hashed from last 2 tokens)
    zipf_a: float = 1.2

    def _tables(self):
        rng = np.random.default_rng(self.seed)
        # per-state Zipf-permuted next-token distributions, top-64 truncated
        ranks = np.arange(1, 65, dtype=np.float64) ** (-self.zipf_a)
        probs = (ranks / ranks.sum()).astype(np.float32)
        cand = np.stack([rng.permutation(self.vocab_size)[:64] for _ in range(self.n_states)])
        return cand.astype(np.int64), probs

    def batch_at(self, step: int, host_id: int = 0, n_hosts: int = 1) -> dict:
        """Pure function (step → batch) of int64 numpy arrays; rows sliced
        per host."""
        rows = self.global_batch // n_hosts
        cand, probs = self._tables()
        cum = np.cumsum(probs)
        rng = np.random.default_rng((self.seed, step, host_id))
        s1 = rng.integers(0, self.n_states, size=rows)
        s2 = rng.integers(0, self.n_states, size=rows)
        u = rng.random((rows, self.seq_len), dtype=np.float32)
        toks = np.empty((rows, self.seq_len), np.int64)
        for t in range(self.seq_len):
            state = (s1 * 31 + s2) % self.n_states
            idx = np.minimum(np.searchsorted(cum, u[:, t]), 63)   # inverse-CDF Zipf
            toks[:, t] = cand[state, idx]
            s1, s2 = s2, toks[:, t] % self.n_states
        return {"tokens": toks, "labels": toks}

    def frontend_at(self, step: int, d_model: int, frontend_len: int, host_id: int = 0,
                    n_hosts: int = 1) -> np.ndarray:
        """Frontend embeddings (rows, frontend_len, d_model) f32, N(0, 0.1²),
        a pure function of (seed, step); every host draws the same rows, as
        the JAX corpus does."""
        rows = self.global_batch // n_hosts
        rng = np.random.default_rng((self.seed + 7, step))
        return rng.standard_normal((rows, frontend_len, d_model), dtype=np.float32) * \
            np.float32(0.1)


def make_batch_fn(cfg, shape, seed=0, device="cuda"):
    """step → batch ({"tokens", "labels"} int64 tensors on ``device``, and
    for VLM and enc-dec archs ``frontend`` (B, F, D) in the model dtype)
    for a (ModelConfig, ShapeConfig) pair. A VLM's text is
    ``seq_len − frontend_len`` tokens, so prefix and text fill ``seq_len``
    positions. ``device`` defaults to the card, as every entry point of the
    port (``device.resolve_device``: no card, no batches); the CPU is asked
    for."""
    device = resolve_device(device)
    vlm = cfg.family == "vlm"
    text_len = shape.seq_len - cfg.frontend_len if vlm else shape.seq_len
    corpus = SyntheticCorpus(cfg.vocab_size, text_len, shape.global_batch, seed=seed)

    def fn(step: int, host_id: int = 0, n_hosts: int = 1):
        b = {k: torch.from_numpy(v).to(device)
             for k, v in corpus.batch_at(step, host_id, n_hosts).items()}
        if vlm or cfg.is_encdec:
            fe = corpus.frontend_at(step, cfg.d_model, cfg.frontend_len, host_id, n_hosts)
            b["frontend"] = torch.from_numpy(fe).to(device=device, dtype=torch_dtype(cfg.dtype))
        return b

    return fn

"""Serving API surface, the port of ``repro.launch.api``.

* ``SamplingParams`` — temperature, top_k, pad_id, eos_id, seed, validated
  once in ``__post_init__``.
* ``Request`` / ``RequestResult`` — what ``engine.run`` takes and returns:
  the generated tokens, ``n_generated``, a ``finish_reason``
  (``eos | budget | error``) and the queueing delay.
* typed exceptions — ``AdmissionError`` (a ``ValueError``),
  ``CapabilityError`` (a ``RuntimeError``) and ``PoolError``, all under
  ``ServeError``.
* ``make_engine(model, params, mode=...)``: ``closed``, ``continuous`` and
  ``speculative``.

The JAX package's loose per-engine sampling kwargs (its deprecation shim
``SamplingParams.resolve``) are not carried over: the port's engines take
``sampling=`` only.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


class ServeError(Exception):
    """Base of the serving failure taxonomy."""


class AdmissionError(ServeError, ValueError):
    """Request rejected at validation/admission time: it could never be
    scheduled, or the engine configuration is malformed."""


class CapabilityError(ServeError, RuntimeError):
    """The engine/model cannot perform the requested operation at all."""


class PoolError(ServeError, RuntimeError):
    """Slot-pool invariant violation: a scheduler bug, not a user error."""


FINISH_REASONS = ("eos", "budget", "error")


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Sampling/stream configuration shared by the engine and by
    ``Model.generate``."""

    temperature: float = 0.0
    top_k: int = 0
    pad_id: int = 0
    eos_id: Optional[int] = None
    seed: int = 0

    def __post_init__(self):
        if self.temperature < 0:
            raise AdmissionError(f"temperature must be >= 0, got {self.temperature}")
        if self.top_k < 0:
            raise AdmissionError(f"top_k must be >= 0, got {self.top_k}")
        if self.eos_id is not None and self.eos_id == self.pad_id:
            raise AdmissionError(
                f"eos_id == pad_id ({self.eos_id}): finished rows emit pad_id, so the host "
                f"could not find the EOS position in outputs")


@dataclasses.dataclass
class Request:
    """One generation request: a token prompt. ``max_new_tokens`` caps THIS
    request's generation (None = the engine call's gen length);
    ``arrival`` is the virtual tick the continuous engine admits it at;
    ``frontend`` (F, D): the frame or patch embeddings a VLM or enc-dec
    arch needs on every request (a numpy array or a tensor; the closed
    engine rejects one on a text-only arch)."""

    tokens: np.ndarray                       # (L,) int
    frontend: Optional[np.ndarray] = None    # (F, D) float
    max_new_tokens: Optional[int] = None
    arrival: float = 0.0


@dataclasses.dataclass
class RequestResult:
    """Uniform per-request outcome from ``engine.run``: the REAL generated
    tokens (up to and including EOS, capped by the request budget),
    ``finish_reason`` and the queueing delay (0.0 for the closed engine)."""

    tokens: np.ndarray                       # (n_generated,) int32
    n_generated: int
    finish_reason: str                       # "eos" | "budget" | "error"
    delay_ticks: float = 0.0
    error: Optional[str] = None              # set iff finish_reason=="error"

    def __post_init__(self):
        if self.finish_reason not in FINISH_REASONS:
            raise ValueError(f"finish_reason {self.finish_reason!r} not in {FINISH_REASONS}")


def make_engine(model, params, *, mode: str = "closed",
                sampling: Optional[SamplingParams] = None, **kwargs):
    """Engine factory: ``closed`` → GenerationEngine, ``continuous`` →
    ContinuousEngine, ``speculative`` → ContinuousEngine with a draft model
    attached (requires ``draft_model=``, ``draft_params=`` and a positive
    ``spec_k``, 4 by default). Extra kwargs pass through to the engine
    constructor (``cache_len`` etc. for the open-stream modes)."""
    from repro_torch.launch import serve                # circular-free: lazy

    if mode == "closed":
        return serve.GenerationEngine(model, params, sampling=sampling, **kwargs)
    if mode == "continuous":
        return serve.ContinuousEngine(model, params, sampling=sampling, **kwargs)
    if mode == "speculative":
        if kwargs.get("draft_model") is None or kwargs.get("draft_params") is None:
            raise AdmissionError("mode='speculative' requires draft_model= and draft_params=")
        kwargs.setdefault("spec_k", 4)
        if kwargs["spec_k"] <= 0:
            raise AdmissionError(f"mode='speculative' requires spec_k > 0, got {kwargs['spec_k']}")
        return serve.ContinuousEngine(model, params, sampling=sampling, **kwargs)
    raise AdmissionError(f"unknown engine mode {mode!r} (closed | continuous | speculative)")

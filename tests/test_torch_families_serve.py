"""qwen3-moe-30b-a3b and gemma3-27b at smoke size through the port's three
serving engines (closed ``GenerationEngine``, ``ContinuousEngine``, and
speculative decoding with the ``self`` draft) against the JAX package's
engines on the same trace, in f32 with the JAX package's own weights:
tokens, finish reasons and every scheduler key the port keeps must be the
reference's. qwen3 smoke routes 2 of 8 experts with capacity factor 4
(no token is ever dropped), gemma3 smoke has 8-token windows that bind in
the 16-token prompt bucket. qwen3 also serves through the CLI. A width-4
``decode_verify`` over gemma3's two-group stack (10 layers) with its tied
head, and over qwen3's MoE layers, gives the reference's logits."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.launch import api as japi
from repro.launch.serve import ContinuousEngine as JaxContinuous
from repro.launch.serve import GenerationEngine as JaxEngine
from repro.launch.serve import draft_from_target as jax_draft_from_target
from repro.models.model import build_model as jax_build
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.launch import api as tapi
from repro_torch.launch.serve import ContinuousEngine, GenerationEngine, draft_from_target, main
from repro_torch.models.model import build_model

ARCHS = ["qwen3-moe-30b-a3b", "gemma3-27b"]
# tests/test_torch_continuous.py's scheduler keys
SCHED_KEYS = ("requests", "max_slots", "seg_len", "prefill_batch", "token_budget",
              "clock_ticks", "tokens_real", "token_slots", "goodput", "delay_p50", "delay_p99",
              "completion_p99", "prefill_launches", "segments", "slot_allocs", "slot_reuse",
              "max_reserved", "delays")
SPEC_KEYS = ("target_slot_forwards", "spec_tokens_committed", "acceptance_rate",
             "verify_launches", "clock_ticks", "token_slots", "goodput", "delays")
G = 8


@functools.lru_cache(maxsize=None)
def _pair(arch):
    jcfg = dataclasses.replace(jax_config(arch, smoke=True), dtype="float32")
    tcfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
    jm = jax_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(3))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tcfg, "cpu")
    return jm, jp, build_model(tcfg), tp


def _trace(api, vocab, n=7, seed=3):
    """Prompts 4–14 (buckets 8 and 16), budgets 1–G, arrivals over 10 ticks."""
    rng = np.random.default_rng(seed)
    return [api.Request(tokens=rng.integers(2, vocab, size=int(rng.integers(4, 15)))
                        .astype(np.int32), max_new_tokens=int(rng.integers(1, G + 1)),
                        arrival=float(rng.uniform(0, 10))) for _ in range(n)]


@pytest.mark.parametrize("arch", ARCHS)
def test_closed_engine_matches_reference(arch):
    jm, jp, tm, tp = _pair(arch)
    V = tm.cfg.vocab_size
    probe = GenerationEngine(tm, tp, max_batch=3).generate(_trace(tapi, V), G)
    eos = next(int(t) for row in probe for t in row[1:] if int(t) != 0)
    sp = dict(eos_id=eos, pad_id=0)
    tres, trep = GenerationEngine(tm, tp, max_batch=3, sampling=tapi.SamplingParams(**sp)).run(
        _trace(tapi, V), G)
    jres, jrep = JaxEngine(jm, jp, max_batch=3, sampling=japi.SamplingParams(**sp)).run(
        _trace(japi, V), G)
    for i, (t, j) in enumerate(zip(tres, jres)):
        np.testing.assert_array_equal(t.tokens, np.asarray(j.tokens), err_msg=f"request {i}")
        assert (t.finish_reason, t.n_generated) == (j.finish_reason, j.n_generated)
    assert any(t.finish_reason == "eos" for t in tres)
    for key in ("batches", "tokens_generated", "tokens_padded", "goodput"):
        assert trep[key] == jrep[key], key


@pytest.mark.parametrize("arch", ARCHS)
def test_continuous_and_speculative_match_reference(arch):
    """7 requests through 3 slots: the continuous streams equal the closed
    engine's and the JAX ContinuousEngine's (scheduler keys included); the
    speculative streams (self draft, spec_k 3) equal them too, and the
    speculation counters equal the JAX speculative engine's."""
    jm, jp, tm, tp = _pair(arch)
    V = tm.cfg.vocab_size
    kw = dict(cache_len=16 + G, max_slots=3, seg_len=4, prefill_batch=2)
    closed = GenerationEngine(tm, tp, max_batch=3)
    outs_c = closed.generate(_trace(tapi, V), G)
    outs, rep = ContinuousEngine(tm, tp, **kw).serve(_trace(tapi, V), G)
    jouts, jrep = JaxContinuous(jm, jp, **kw).serve(_trace(japi, V), G,
                                                     key=jax.random.PRNGKey(5))
    for i, r in enumerate(_trace(tapi, V)):
        want = outs_c[i][:closed._real_len(outs_c[i], min(r.max_new_tokens, G))]
        np.testing.assert_array_equal(outs[i], want, err_msg=f"request {i}: closed")
        np.testing.assert_array_equal(outs[i], np.asarray(jouts[i]), err_msg=f"request {i}: JAX")
    for key in SCHED_KEYS:
        assert rep[key] == jrep[key], key
    assert rep["slot_reuse"] > 0

    dm, dp = draft_from_target(tm, tp, "self")
    outs_s, rep_s = tapi.make_engine(tm, tp, mode="speculative", draft_model=dm,
                                     draft_params=dp, spec_k=3, **kw).serve(_trace(tapi, V), G)
    jdm, jdp = jax_draft_from_target(jm, jp, "self")
    jouts_s, jrep_s = japi.make_engine(jm, jp, mode="speculative", draft_model=jdm,
                                       draft_params=jdp, spec_k=3, **kw).serve(
        _trace(japi, V), G, key=jax.random.PRNGKey(5))
    for i in range(len(outs)):
        np.testing.assert_array_equal(outs_s[i], outs[i], err_msg=f"request {i}: continuous")
        np.testing.assert_array_equal(outs_s[i], np.asarray(jouts_s[i]), err_msg=f"request {i}")
    for key in SPEC_KEYS:
        assert rep_s[key] == jrep_s[key], key
    assert rep_s["acceptance_rate"] > 0.5


def test_cli_serves_the_family_on_cpu(capsys):
    """``launch.serve --arch qwen3-moe-30b-a3b --smoke --device cpu``:
    continuous, then with the self draft (greedy: the same streams)."""
    args = ["--arch", "qwen3-moe-30b-a3b", "--smoke", "--device", "cpu", "--continuous",
            "--requests", "5", "--gen", "6", "--slots", "3"]
    outs = main(args)
    spec = main(args + ["--speculative-draft", "self", "--spec-k", "2"])
    assert len(outs) == 5 and all(1 <= len(o) <= 6 for o in outs)
    assert all(np.array_equal(a, b) for a, b in zip(outs, spec))
    assert "continuous on cpu" in capsys.readouterr().out


@pytest.mark.parametrize("arch,over", [("gemma3-27b", {"n_layers": 10}),
                                       ("qwen3-moe-30b-a3b", {})], ids=["gemma3-two-groups",
                                                                        "qwen3-moe"])
def test_decode_verify_matches_reference_and_sequential_decode(arch, over):
    """After a ragged prefill, one width-4 ``decode_verify`` over gemma3's
    two-group stack with its tied head (and over qwen3's MoE layers) gives
    the JAX package's logits and positions, and the port's own 4 sequential
    decode steps' logits within 1e-5 (f32)."""
    kw = dict(dtype="float32", **over)
    jcfg = dataclasses.replace(jax_config(arch, smoke=True), **kw)
    tcfg = dataclasses.replace(get_config(arch, smoke=True), **kw)
    jm = jax_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(3))
    tm, tp = build_model(tcfg), params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                                                  "cpu")
    toks = np.random.default_rng(0).integers(2, 256, size=(3, 16))
    lens = np.array([16, 5, 11])
    _, jst = jax.jit(jm.prefill, static_argnums=2)(jp, {"tokens": jnp.asarray(toks, jnp.int32)},
                                                   32, jnp.asarray(lens, jnp.int32))
    _, tst = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, 32,
                        prompt_lens=torch.from_numpy(lens))
    tk = np.random.default_rng(1).integers(2, 256, size=(3, 4))
    jl, jsv = jax.jit(jm.decode_verify)(jp, jst, jnp.asarray(tk, jnp.int32))
    tl, tsv = tm.decode_verify(tp, tst.clone(), torch.from_numpy(tk))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(tsv.pos.numpy(), np.asarray(jsv.pos))
    sd, steps = tst.clone(), []
    for i in range(4):
        logits, sd = tm.decode_step(tp, sd, torch.from_numpy(tk[:, i:i + 1]))
        steps.append(logits[:, 0])
    assert (tl - torch.stack(steps, 1)).abs().max().item() <= 1e-5

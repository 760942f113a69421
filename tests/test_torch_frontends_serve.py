"""seamless-m4t-medium (encoder + cross-attention caches) and internvl2-1b
(a patch prefix in every cache row) at smoke size through the port's
three serving engines against the JAX package's engines on the same trace
and frontends, in f32 with the JAX package's own weights: greedy tokens,
finish reasons and every scheduler key the port keeps. Also the admission
errors (a missing frontend, a frontend on a text-only arch, a reservation
of F + bucket + budget past the cache), dummy prefill rows with zero
frontends leaving the arena, cross caches included, bit-identical, the
``layers:N`` draft keeping the target's encoder, and the CLIs."""

import dataclasses
import functools

import jax
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
from repro_torch.launch import train as ttrain
from repro_torch.launch.serve import (ContinuousEngine, GenerationEngine, _bucket_len,
                                      draft_from_target, main)
from repro_torch.models.model import build_model, param_dict

ARCHS = ["seamless-m4t-medium", "internvl2-1b"]
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


def _trace(api, cfg, n=7, seed=3):
    """Prompts 4–14 (buckets 8 and 16), budgets 1–G, arrivals over 10 ticks,
    each with a frontend (F, D) f32 N(0, 0.1²)."""
    rng = np.random.default_rng(seed)
    reqs = []
    for _ in range(n):
        toks = rng.integers(2, cfg.vocab_size, size=int(rng.integers(4, 15))).astype(np.int32)
        fe = rng.standard_normal((cfg.frontend_len, cfg.d_model), dtype=np.float32) * 0.1
        reqs.append(api.Request(tokens=toks, frontend=fe,
                                max_new_tokens=int(rng.integers(1, G + 1)),
                                arrival=float(rng.uniform(0, 10))))
    return reqs


def _cache_len(model):
    return model._prefix_len + 16 + G


@pytest.mark.parametrize("arch", ARCHS)
def test_closed_engine_matches_reference(arch):
    jm, jp, tm, tp = _pair(arch)
    probe = GenerationEngine(tm, tp, max_batch=3).generate(_trace(tapi, tm.cfg), G)
    eos = next(int(t) for row in probe for t in row[1:] if int(t) != 0)
    sp = dict(eos_id=eos, pad_id=0)
    tres, trep = GenerationEngine(tm, tp, max_batch=3, sampling=tapi.SamplingParams(**sp)).run(
        _trace(tapi, tm.cfg), G)
    jres, jrep = JaxEngine(jm, jp, max_batch=3, sampling=japi.SamplingParams(**sp)).run(
        _trace(japi, tm.cfg), G)
    for i, (t, j) in enumerate(zip(tres, jres)):
        np.testing.assert_array_equal(t.tokens, np.asarray(j.tokens), err_msg=f"request {i}")
        assert (t.finish_reason, t.n_generated) == (j.finish_reason, j.n_generated)
    assert any(t.finish_reason == "eos" for t in tres)
    for key in ("batches", "tokens_generated", "tokens_padded", "goodput"):
        assert trep[key] == jrep[key], key


@pytest.mark.parametrize("arch", ARCHS)
def test_continuous_and_speculative_match_reference(arch):
    """7 requests through 3 slots (cache F + 16 + G): the continuous streams
    equal the closed engine's and the JAX ContinuousEngine's (scheduler keys
    included); the speculative streams (self and layers:1 drafts, spec_k
    3) equal them too, with the JAX speculative engine's counters."""
    jm, jp, tm, tp = _pair(arch)
    kw = dict(cache_len=_cache_len(tm), max_slots=3, seg_len=4, prefill_batch=2)
    closed = GenerationEngine(tm, tp, max_batch=3)
    outs_c = closed.generate(_trace(tapi, tm.cfg), G)
    outs, rep = ContinuousEngine(tm, tp, **kw).serve(_trace(tapi, tm.cfg), G)
    jouts, jrep = JaxContinuous(jm, jp, **kw).serve(_trace(japi, tm.cfg), G,
                                                     key=jax.random.PRNGKey(5))
    for i, r in enumerate(_trace(tapi, tm.cfg)):
        want = outs_c[i][:closed._real_len(outs_c[i], min(r.max_new_tokens, G))]
        np.testing.assert_array_equal(outs[i], want, err_msg=f"request {i}: closed")
        np.testing.assert_array_equal(outs[i], np.asarray(jouts[i]), err_msg=f"request {i}: JAX")
    for key in SCHED_KEYS:
        assert rep[key] == jrep[key], key
    assert rep["slot_reuse"] > 0

    for spec in ("self", "layers:1"):
        dm, dp = draft_from_target(tm, tp, spec)
        outs_s, rep_s = tapi.make_engine(tm, tp, mode="speculative", draft_model=dm,
                                         draft_params=dp, spec_k=3, **kw).serve(
            _trace(tapi, tm.cfg), G)
        jdm, jdp = jax_draft_from_target(jm, jp, spec)
        jouts_s, jrep_s = japi.make_engine(jm, jp, mode="speculative", draft_model=jdm,
                                           draft_params=jdp, spec_k=3, **kw).serve(
            _trace(japi, tm.cfg), G, key=jax.random.PRNGKey(5))
        for i in range(len(outs)):
            np.testing.assert_array_equal(outs_s[i], outs[i], err_msg=f"{spec} request {i}")
            np.testing.assert_array_equal(outs_s[i], np.asarray(jouts_s[i]),
                                          err_msg=f"{spec} request {i}: JAX")
        for key in SPEC_KEYS:
            assert rep_s[key] == jrep_s[key], (spec, key)


def test_layers_draft_keeps_the_target_encoder():
    """``layers:1`` of seamless: the first decoder layer as views, the
    target's whole encoder, embedding and head (the same tensors); the
    draft config keeps n_enc_layers."""
    _, _, tm, tp = _pair("seamless-m4t-medium")
    dm, dp = draft_from_target(tm, tp, "layers:1")
    assert dm.cfg.n_layers == 1 and dm.cfg.n_enc_layers == tm.cfg.n_enc_layers
    tree, dtree = param_dict(tp), param_dict(dp)
    for name in ("embed", "lm_head"):
        assert dtree[name] is tree[name]
    enc, denc = tree["encoder"], dtree["encoder"]
    assert denc["final_norm"] is enc["final_norm"]
    for key, sub in enc["groups"][0].items():
        for n, t in sub.items():
            assert denc["groups"][0][key][n] is t
    for key, sub in tree["decoder"]["groups"][0].items():
        for n, t in sub.items():
            d = dtree["decoder"]["groups"][0][key][n]
            assert d.shape[0] == 1 and d.data_ptr() == t.data_ptr()


@pytest.mark.parametrize("arch", ARCHS)
def test_admission_errors(arch):
    """A request without a frontend: an error result of the closed engine
    and an AdmissionError of the continuous one; a frontend on a text-only
    arch: an error of the closed engine (the continuous one ignores it, as
    the JAX package's does); the continuous reservation is F + bucket +
    budget, F the VLM's prefix."""
    _, _, tm, tp = _pair(arch)
    reqs = _trace(tapi, tm.cfg, n=2)
    bare = dataclasses.replace(reqs[0], frontend=None)
    res, _ = GenerationEngine(tm, tp, max_batch=2).run([bare, reqs[1]], G)
    assert res[0].finish_reason == "error" and "requires frontend" in res[0].error
    assert res[1].finish_reason in ("budget", "eos")
    with pytest.raises(ValueError, match="requires frontend"):
        GenerationEngine(tm, tp).generate([bare], G)
    eng = ContinuousEngine(tm, tp, cache_len=_cache_len(tm), max_slots=2)
    with pytest.raises(tapi.AdmissionError, match="frontend embeddings required"):
        eng.serve([bare], G)
    F = tm._prefix_len
    assert eng._reservation(0, dataclasses.replace(reqs[0], max_new_tokens=G), G)[1] == \
        F + _bucket_len(len(reqs[0].tokens)) + G
    tight = ContinuousEngine(tm, tp, cache_len=F + 16 + G - 1, max_slots=2)
    long_req = dataclasses.replace(reqs[0], tokens=np.arange(2, 14), max_new_tokens=G)
    with pytest.raises(tapi.AdmissionError, match=f"frontend {F} \\+ prompt bucket 16"):
        tight.serve([long_req], G)
    tres, _ = tight.run([long_req, bare], G)
    assert [r.finish_reason for r in tres] == ["error", "error"]
    text_m = build_model(get_config("gpt-tiny", smoke=True))
    text_p = text_m.init(0, device="cpu")
    res, _ = GenerationEngine(text_m, text_p).run(
        [tapi.Request(tokens=np.arange(2, 8), frontend=reqs[0].frontend)], 4)
    assert res[0].finish_reason == "error" and "text-only" in res[0].error
    outs, _ = ContinuousEngine(text_m, text_p, cache_len=32).serve(
        [tapi.Request(tokens=np.arange(2, 8), frontend=reqs[0].frontend)], 4)
    assert len(outs[0]) == 4


@pytest.mark.parametrize("arch", ARCHS)
def test_dummy_prefill_rows_leave_the_arena_bit_identical(arch):
    """A prefill launch of 3 rows into a live arena, one row a dummy
    (zero frontend, slot index past the arena): the two live rows land in
    their slots, every other slot (cross-attention caches, the patch
    prefix and the bookkeeping included) keeps its bits."""
    _, _, tm, tp = _pair(arch)
    S, F = _cache_len(tm), tm._prefix_len
    reqs = _trace(tapi, tm.cfg, n=5, seed=7)
    slots = tm.init_slot_state(4, S, device="cpu")

    def batch(rs, dummy=0):
        toks = np.zeros((len(rs) + dummy, 16), np.int64)
        for i, r in enumerate(rs):
            toks[i, :len(r.tokens)] = r.tokens
        fe = np.stack([r.frontend for r in rs] + [np.zeros_like(rs[0].frontend)] * dummy)
        lens = [len(r.tokens) for r in rs] + [16] * dummy
        return {"tokens": torch.from_numpy(toks), "frontend": torch.from_numpy(fe)}, \
            torch.tensor(lens)

    b, lens = batch(reqs[:2])
    tm.prefill_into(tp, slots, b, [0, 2], [G, G], cache_len=S, prompt_lens=lens)
    tm.decode_segment(tp, slots, seg_len=2)
    before = slots.clone()
    b, lens = batch(reqs[2:4], dummy=1)
    tm.prefill_into(tp, slots, b, [3, 1, 4], [G, G, 1], cache_len=S, prompt_lens=lens)
    _, closed = tm.prefill(tp, b, S, prompt_lens=lens)
    for arena, old, ref in zip(slots.state.layers, before.state.layers, closed.layers):
        for key, sub in arena.items():
            for name, t in sub.items():
                assert torch.equal(t[:, [0, 2]], old[key][name][:, [0, 2]]), (key, name)
                assert torch.equal(t[:, [3, 1]], ref[key][name][:, :2]), (key, name)
    # the loop above covered the cross-attention caches (memory length F)
    assert any(sub["k"].shape[2] == tm.cfg.frontend_len
               for sub in slots.state.layers[0].values()) == tm.cfg.is_encdec
    for f in ("tok", "active", "done", "n_gen", "budget"):
        assert torch.equal(getattr(slots, f)[[0, 2]], getattr(before, f)[[0, 2]]), f
    assert slots.state.pos[[3, 1]].tolist() == (F + lens[:2]).tolist()
    assert slots.state.pos[[0, 2]].tolist() == before.state.pos[[0, 2]].tolist()


@pytest.mark.parametrize("arch", ARCHS)
def test_cli_serves_and_trains_the_family_on_cpu(arch, capsys):
    """``launch.serve --arch A --smoke --device cpu``: closed, continuous and
    speculative layers:1 (greedy: the continuous streams); ``launch.train
    --arch A --smoke --device cpu`` bucketed with the fused update under
    remat full, then on the tree layout."""
    base = ["--arch", arch, "--smoke", "--device", "cpu"]
    outs = main(base + ["--requests", "3", "--gen", "4", "--prompt-len", "12"])
    assert len(outs) == 3 and all(len(o) == 4 for o in outs)
    args = base + ["--continuous", "--requests", "4", "--gen", "5", "--slots", "2"]
    cont = main(args)
    spec = main(args + ["--speculative-draft", "layers:1", "--spec-k", "2"])
    assert all(np.array_equal(a, b) for a, b in zip(cont, spec))
    train = base + ["--steps", "2", "--seq-len", "16", "--batch", "2", "--log-every", "1"]
    hist = ttrain.main(train + ["--bucketed", "--fused-kernel", "--remat", "full",
                                "--flash-min-len", "8"])
    assert [h["step"] for h in hist] == [1, 2] and all(np.isfinite(h["loss"]) for h in hist)
    hist = ttrain.main(train + ["--precision", "SR"])
    assert all(h["edq"] > 0 for h in hist)
    out = capsys.readouterr().out
    assert "continuous on cpu" in out and "speculative on cpu" in out

"""rwkv6-1.6b and jamba-1.5-large-398b at smoke size through the port's
serving paths, against the JAX package's, in f32 with the JAX package's
own weights:

* prefill at prompt lengths 2, 3, 13 and 16 (chunk 8: a partial tail,
  prompts shorter than the conv's receptive field), then decode step by
  step to 16 tokens: logits and every recurrent state leaf held to the
  reference's prefill and *decode* (whose own decode misses its forward by
  ~1 f32 ulp on these archs: tests/test_decode_parity.py), and ragged
  prefill refused;
* the closed ``GenerationEngine`` and the ``ContinuousEngine`` on one
  trace of prompts at three exact lengths: both bucket recurrent archs by
  exact length (never ragged), and their tokens, finish reasons and every
  scheduler key of the reports equal the JAX engines';
* ``prefill_into``'s dummy rows and a segment's inactive rows leave every
  recurrent leaf of the slot arena (h, conv, S, last_x) bit-identical;
* speculative decoding with a recurrent target or draft is a
  ``CapabilityError``;
* the serve CLI on the CPU, closed and continuous."""

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
from repro.models.model import build_model as jax_build
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.launch import api as tapi
from repro_torch.launch.serve import ContinuousEngine, GenerationEngine, main
from repro_torch.models.model import build_model

ARCHS = ["rwkv6-1.6b", "jamba-1.5-large-398b"]
F32_TOL = dict(rtol=1e-4, atol=1e-4)
# tests/test_torch_continuous.py's scheduler keys
SCHED_KEYS = ("requests", "max_slots", "seg_len", "prefill_batch", "token_budget",
              "clock_ticks", "tokens_real", "token_slots", "goodput", "delay_p50", "delay_p99",
              "completion_p99", "prefill_launches", "segments", "slot_allocs", "slot_reuse",
              "max_reserved", "delays")
G = 8


@functools.lru_cache(maxsize=None)
def _pair(arch):
    jcfg = dataclasses.replace(jax_config(arch, smoke=True), dtype="float32")
    tcfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
    jm = jax_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(3))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tcfg, "cpu")
    return jm, jp, build_model(tcfg), tp


def _trace(api, vocab, n=8, seed=3):
    """Prompts of exact lengths 5, 9 and 13 (recurrent archs batch by
    exact length), budgets 1–G, arrivals over 10 ticks."""
    rng = np.random.default_rng(seed)
    return [api.Request(tokens=rng.integers(2, vocab, size=int(rng.choice([5, 9, 13])))
                        .astype(np.int32), max_new_tokens=int(rng.integers(1, G + 1)),
                        arrival=float(rng.uniform(0, 10))) for _ in range(n)]


def _assert_states_close(tlayers, jlayers, msg):
    for g, (tl, jl) in enumerate(zip(tlayers, jlayers)):
        assert sorted(tl) == sorted(jl)
        for key in jl:
            assert sorted(tl[key]) == sorted(jl[key]), key
            for name, ref in jl[key].items():
                got = tl[key][name]
                assert tuple(got.shape) == ref.shape and \
                    str(got.dtype).replace("torch.", "") == str(ref.dtype), (key, name)
                np.testing.assert_allclose(got.numpy(), np.asarray(ref), **F32_TOL,
                                           err_msg=f"{msg}: group {g} {key} {name}")


@pytest.mark.parametrize("plen", [2, 3, 13, 16])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_matches_reference(arch, plen):
    jm, jp, tm, tp = _pair(arch)
    toks = np.random.default_rng(plen).integers(0, tm.cfg.vocab_size, size=(2, 16))
    pre = toks[:, :plen]
    jlog, jst = jax.jit(jm.prefill, static_argnums=2)(
        jp, {"tokens": jnp.asarray(pre, jnp.int32)}, 16)
    tlog, tst = tm.prefill(tp, {"tokens": torch.from_numpy(pre)}, 16)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **F32_TOL)
    np.testing.assert_array_equal(tst.pos.numpy(), np.asarray(jst.pos))
    _assert_states_close(tst.layers, jst.layers, "prefill")
    step = jax.jit(jm.decode_step)
    for t in range(plen, 16):
        nxt = toks[:, t:t + 1]
        jlog, jst = step(jp, jst, jnp.asarray(nxt, jnp.int32))
        tlog, tst = tm.decode_step(tp, tst, torch.from_numpy(nxt))
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **F32_TOL,
                                   err_msg=f"decode position {t}")
        np.testing.assert_array_equal(tst.pos.numpy(), np.asarray(jst.pos))
    _assert_states_close(tst.layers, jst.layers, "after decode")


@pytest.mark.parametrize("arch", ARCHS)
def test_ragged_prefill_is_refused(arch):
    _, _, tm, tp = _pair(arch)
    with pytest.raises(ValueError, match="recurrent"):
        tm.prefill(tp, {"tokens": torch.zeros((2, 8), dtype=torch.int64)}, 16,
                   prompt_lens=torch.tensor([8, 5]))


@pytest.mark.parametrize("arch", ARCHS)
def test_closed_engine_matches_reference(arch):
    """EOS engaged: a token greedy decoding really emits mid-row."""
    jm, jp, tm, tp = _pair(arch)
    V = tm.cfg.vocab_size
    probe = GenerationEngine(tm, tp, max_batch=3).generate(_trace(tapi, V), G)
    eos = next(int(t) for row in probe for t in row[1:] if int(t) != 0)
    sp = dict(eos_id=eos, pad_id=0)
    eng = GenerationEngine(tm, tp, max_batch=3, sampling=tapi.SamplingParams(**sp))
    tres, trep = eng.run(_trace(tapi, V), G)
    jres, jrep = JaxEngine(jm, jp, max_batch=3, sampling=japi.SamplingParams(**sp)).run(
        _trace(japi, V), G)
    for i, (t, j) in enumerate(zip(tres, jres)):
        np.testing.assert_array_equal(t.tokens, np.asarray(j.tokens), err_msg=f"request {i}")
        assert (t.finish_reason, t.n_generated) == (j.finish_reason, j.n_generated)
    assert any(t.finish_reason == "eos" for t in tres)
    for key in ("batches", "tokens_generated", "tokens_padded", "goodput"):
        assert trep[key] == jrep[key], key
    assert trep["batches"] >= 3            # one batch or more per exact length


@pytest.mark.parametrize("arch", ARCHS)
def test_continuous_buckets_by_exact_length_and_matches_reference(arch):
    """8 requests at three exact lengths through 3 slots: no prefill is
    ever ragged (``prompt_lens`` stays None), the streams equal the closed
    engine's and the JAX ContinuousEngine's, and so does every scheduler
    key of the report."""
    jm, jp, tm, tp = _pair(arch)
    V = tm.cfg.vocab_size
    kw = dict(cache_len=16 + G, max_slots=3, seg_len=4, prefill_batch=2)
    closed = GenerationEngine(tm, tp, max_batch=3)
    outs_c = closed.generate(_trace(tapi, V), G)
    eng = ContinuousEngine(tm, tp, **kw)
    seen = []
    prefill_into = tm.prefill_into

    def spy(*args, **kwargs):
        seen.append((kwargs["prompt_lens"], args[2]["tokens"].shape[1]))
        return prefill_into(*args, **kwargs)

    object.__setattr__(tm, "prefill_into", spy)
    try:
        outs, rep = eng.serve(_trace(tapi, V), G)
    finally:
        object.__delattr__(tm, "prefill_into")
    jouts, jrep = JaxContinuous(jm, jp, **kw).serve(_trace(japi, V), G,
                                                     key=jax.random.PRNGKey(5))
    assert seen and all(pl is None for pl, _ in seen)
    assert sorted({T for _, T in seen}) == [5, 9, 13]
    for i, r in enumerate(_trace(tapi, V)):
        want = outs_c[i][:closed._real_len(outs_c[i], min(r.max_new_tokens, G))]
        np.testing.assert_array_equal(outs[i], want, err_msg=f"request {i}: closed")
        np.testing.assert_array_equal(outs[i], np.asarray(jouts[i]), err_msg=f"request {i}: JAX")
    for key in SCHED_KEYS:
        assert rep[key] == jrep[key], key
    assert rep["slot_reuse"] > 0


def _random_arena(model, max_slots, cache_len, seed=0):
    """A slot arena whose every tensor holds seeded random values, so an
    untouched row is told apart from a rewritten one."""
    slots = model.init_slot_state(max_slots, cache_len, device="cpu")
    g = torch.Generator().manual_seed(seed)
    for layer in slots.state.layers:
        for sub in layer.values():
            for t in sub.values():
                t.copy_(torch.randn(t.shape, generator=g))
    slots.state.pos.copy_(torch.randint(4, cache_len // 2, (max_slots,), generator=g))
    slots.tok.copy_(torch.randint(2, model.cfg.vocab_size, (max_slots, 1), generator=g))
    slots.n_gen.fill_(1)
    slots.budget.fill_(cache_len // 2)
    return slots


def _leaves(slots, rows):
    return {(g, k, n): t[:, rows].clone() for g, layer in enumerate(slots.state.layers)
            for k, sub in layer.items() for n, t in sub.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_dummy_and_inactive_rows_leave_the_recurrent_arena_bit_identical(arch):
    """``prefill_into`` with one real row (slot 2) and dummy rows: slots 0,
    1, 3 keep every bit, slot 2 holds the prefill's own state. Then a
    segment where only slot 2 runs (0 free, 1 done, 3 free and done):
    slots 0, 1, 3 keep every bit of h/conv, S and last_x."""
    _, _, tm, tp = _pair(arch)
    names = {n for layer in tm.init_decode_state(1, 4, device="cpu").layers
             for sub in layer.values() for n in sub}
    assert names >= ({"h", "conv"} if arch.startswith("jamba") else {"S", "last_x"})
    S = 32
    slots = _random_arena(tm, 4, S)
    before = _leaves(slots, [0, 1, 3])
    toks = torch.from_numpy(np.random.default_rng(4).integers(2, 256, size=(4, 11)))
    tok0, _ = tm.prefill_into(tp, slots, {"tokens": toks}, [2, 4, 4, 9], [5, 1, 1, 1],
                              cache_len=S)
    after = _leaves(slots, [0, 1, 3])
    assert all(torch.equal(before[k], after[k]) for k in before)
    _, ref = tm.prefill(tp, {"tokens": toks}, S)
    for layer, new in zip(slots.state.layers, ref.layers):
        for k, sub in layer.items():
            for n, t in sub.items():
                assert torch.equal(t[:, 2], new[k][n][:, 0]), (k, n)
    assert (slots.state.pos[2].item(), slots.tok[2, 0].item()) == (11, tok0[0].item())

    slots.active.copy_(torch.tensor([False, True, True, False]))
    slots.done.copy_(torch.tensor([False, True, False, True]))
    frozen = _leaves(slots, [0, 1, 3])
    live = _leaves(slots, [2])
    emitted, _ = tm.decode_segment(tp, slots, seg_len=3, pad_id=7)
    after = _leaves(slots, [0, 1, 3])
    assert all(torch.equal(frozen[k], after[k]) for k in frozen)
    moved = _leaves(slots, [2])
    assert any(not torch.equal(live[k], moved[k]) for k in live)
    assert (emitted[[0, 1, 3]] == 7).all() and slots.state.pos[2].item() == 14


@pytest.mark.parametrize("arch", ARCHS)
def test_speculative_refuses_a_recurrent_target_or_draft(arch):
    _, _, tm, tp = _pair(arch)
    attn = build_model(dataclasses.replace(get_config("gpt-smoke", smoke=True), dtype="float32"))
    ap = attn.init(0, device="cpu")
    for target, params, draft, dparams in ((tm, tp, attn, ap), (attn, ap, tm, tp)):
        with pytest.raises(tapi.CapabilityError, match="recurrent"):
            tapi.make_engine(target, params, mode="speculative", cache_len=32,
                             draft_model=draft, draft_params=dparams, spec_k=2)


@pytest.mark.parametrize("arch", ARCHS)
def test_cli_serves_the_family_on_cpu(arch, capsys):
    """``launch.serve --arch A --smoke --device cpu``, closed and
    continuous, every request at the full prompt length (exact-length
    batches): well-formed streams of each request's length."""
    args = ["--arch", arch, "--smoke", "--device", "cpu", "--requests", "5", "--gen", "6",
            "--prompt-len", "12"]
    closed = main(args + ["--batch", "3"])
    cont = main(args + ["--continuous", "--slots", "3"])
    assert len(closed) == len(cont) == 5
    assert all(len(o) == 6 for o in closed) and all(1 <= len(o) <= 6 for o in cont)
    assert all(0 <= int(t) < 256 for o in closed + cont for t in o)
    out = capsys.readouterr().out
    assert "engine on cpu" in out and "continuous on cpu" in out

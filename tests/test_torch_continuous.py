"""The port's continuous-batching engine (repro_torch.launch.serve's
ContinuousEngine and SlotPool, Model.prefill_into / decode_segment) against
repro.launch.serve on gpt-smoke in f32 with the flash path on: the slot
pool's choices and errors, greedy tokens and every scheduler key of the
report, admission, and the arena rows that dummy and inactive rows leave
alone."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.launch import api as japi
from repro.launch.serve import ContinuousEngine as JaxContinuous
from repro.launch.serve import SlotPool as JaxSlotPool
from repro.models.model import build_model as jax_build
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.launch import api as tapi
from repro_torch.launch.serve import ContinuousEngine, GenerationEngine, SlotPool
from repro_torch.models.model import build_model

# every key of the reference's report that the port keeps, with the same
# meaning and value (the reference's trace counters have no eager analogue)
SCHED_KEYS = ("requests", "max_slots", "seg_len", "prefill_batch", "token_budget",
              "clock_ticks", "tokens_real", "token_slots", "goodput", "delay_p50", "delay_p99",
              "completion_p99", "prefill_launches", "segments", "slot_allocs", "slot_reuse",
              "max_reserved", "delays")
TRACE_KEYS = {"prefill_traces", "decode_traces"}
F32_TOL = dict(rtol=1e-4, atol=1e-4)      # tests/test_torch_model.py's f32 tolerance


@pytest.fixture(scope="module")
def pair():
    kw = dict(dtype="float32", flash_min_len=16, flash_block=16)
    jcfg = dataclasses.replace(jax_config("gpt-smoke", smoke=True), **kw)
    tcfg = dataclasses.replace(get_config("gpt-smoke", smoke=True), **kw)
    jm = jax_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(3))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tcfg, "cpu")
    return jm, jp, build_model(tcfg), tp


def _trace(api, vocab, n, seed=3, lo=4, hi=12, gen_hi=10):
    """tests/test_slot_pool.py's trace (prompts 4–12: buckets 8 and 16, the
    16 through the flash path), in either package's Request."""
    rng = np.random.default_rng(seed)
    reqs = []
    for _ in range(n):
        L = int(rng.integers(lo, hi + 1))
        reqs.append(api.Request(tokens=rng.integers(2, vocab, size=L).astype(np.int32),
                                max_new_tokens=int(rng.integers(1, gen_hi + 1)),
                                arrival=float(rng.uniform(0, 12))))
    return reqs


# ------------------------------------------------------------ slot pool --
def _pool_op(pool, op, arg):
    try:
        return "ok", (pool.alloc() if op == "alloc" else pool.release(arg))
    except Exception as e:                               # noqa: BLE001 — compared below
        return "err", type(e).__name__


@pytest.mark.parametrize("seed,n_slots", [(0, 1), (1, 3), (2, 5), (3, 9)])
def test_pool_choices_and_errors_match_reference(seed, n_slots):
    """The same seeded alloc/release sequence, invalid operations included
    (alloc on a full pool, release of a free or unknown slot): the same
    slots, the same errors, the same counters."""
    rng = np.random.default_rng(seed)
    tpool, jpool = SlotPool(n_slots), JaxSlotPool(n_slots)
    for _ in range(80):
        op = "alloc" if rng.random() < 0.5 else "release"
        arg = int(rng.integers(-1, n_slots + 2))
        if op == "release" and jpool.live and rng.random() < 0.7:
            arg = int(rng.choice(sorted(jpool.live)))
        t, j = _pool_op(tpool, op, arg), _pool_op(jpool, op, arg)
        assert t == j, (op, arg)
        assert tpool.live == jpool.live and tpool.n_free == jpool.n_free
    assert (tpool.allocs, tpool.reuses) == (jpool.allocs, jpool.reuses)


def test_pool_error_types():
    for api, pool_cls in ((tapi, SlotPool), (japi, JaxSlotPool)):
        with pytest.raises(api.AdmissionError):
            pool_cls(0)
        pool = pool_cls(1)
        pool.alloc()
        with pytest.raises(api.PoolError) as e:
            pool.alloc()
        assert isinstance(e.value, RuntimeError)


# ------------------------------------------------- engine vs reference --
@pytest.mark.parametrize("with_eos", [False, True])
def test_continuous_matches_closed_and_reference(pair, with_eos):
    """9 requests through 3 slots (slot reuse, dummy prefill rows, both
    prompt buckets): the port's continuous streams equal its closed
    engine's and the JAX ContinuousEngine's, and so does every scheduler
    key of the report; the report drops only the trace counters."""
    jm, jp, tm, tp = pair
    G, V = 10, tm.cfg.vocab_size
    treqs, jreqs = _trace(tapi, V, 9), _trace(japi, V, 9)
    eos = None
    if with_eos:       # a token greedy decoding really emits mid-row (not pad 0)
        rows = GenerationEngine(tm, tp, max_batch=3).generate(treqs, G)
        eos = next(int(t) for row in rows for t in row[1:] if int(t) != 0)
    closed = GenerationEngine(tm, tp, max_batch=3, sampling=tapi.SamplingParams(eos_id=eos))
    outs_c = closed.generate(treqs, G)
    kw = dict(cache_len=16 + G, max_slots=3, seg_len=4, prefill_batch=2)
    cont = ContinuousEngine(tm, tp, sampling=tapi.SamplingParams(eos_id=eos), **kw)
    outs, rep = cont.serve(treqs, G)
    jouts, jrep = JaxContinuous(jm, jp, sampling=japi.SamplingParams(eos_id=eos), **kw).serve(
        jreqs, G, key=jax.random.PRNGKey(5))
    for i, r in enumerate(treqs):
        b = min(r.max_new_tokens, G)
        want = outs_c[i][:closed._real_len(outs_c[i], b)]
        np.testing.assert_array_equal(outs[i], want, err_msg=f"request {i}: closed")
        np.testing.assert_array_equal(outs[i], np.asarray(jouts[i]), err_msg=f"request {i}: JAX")
    for key in SCHED_KEYS:
        assert rep[key] == jrep[key], key
    assert set(jrep) - set(rep) == TRACE_KEYS and set(rep) <= set(jrep)
    assert rep["slot_reuse"] > 0 and rep["slot_allocs"] == 9
    assert rep["tokens_real"] == closed.stats["tokens_generated"]
    if with_eos:
        assert any(eos in o for o in map(list, outs)), "EOS never fired"


def test_admission_token_budget_matches_reference(pair):
    """A token budget with room for ~2 live rows: reservations never
    exceed it, every request still gets its whole budget, and the
    schedule (delays, reuse, clock) is the reference's; a budget no
    request fits is rejected up front in both packages."""
    jm, jp, tm, tp = pair
    G, V = 8, tm.cfg.vocab_size
    tight = 2 * (16 + G)
    kw = dict(cache_len=16 + G, max_slots=4, seg_len=4, prefill_batch=2, token_budget=tight)
    outs, rep = ContinuousEngine(tm, tp, **kw).serve(_trace(tapi, V, 6, seed=11, gen_hi=G), G)
    _, jrep = JaxContinuous(jm, jp, **kw).serve(_trace(japi, V, 6, seed=11, gen_hi=G), G,
                                                key=jax.random.PRNGKey(0))
    assert rep["max_reserved"] <= tight
    reqs = _trace(tapi, V, 6, seed=11, gen_hi=G)
    assert [len(o) for o in outs] == [min(r.max_new_tokens, G) for r in reqs]
    for key in SCHED_KEYS:
        assert rep[key] == jrep[key], key
    for api, eng, m, p in ((tapi, ContinuousEngine, tm, tp), (japi, JaxContinuous, jm, jp)):
        with pytest.raises(api.AdmissionError):
            eng(m, p, cache_len=16 + G, max_slots=4, token_budget=8).serve(
                _trace(api, V, 6, seed=11, gen_hi=G), G)


@pytest.mark.parametrize("case", ["zero_slots", "zero_seg_len", "zero_prefill_batch",
                                  "eos_is_pad", "request_exceeds_cache"])
def test_config_validation_matches_reference(pair, case):
    jm, jp, tm, tp = pair
    for api, eng, m, p in ((tapi, ContinuousEngine, tm, tp), (japi, JaxContinuous, jm, jp)):
        with pytest.raises(api.AdmissionError) as e:
            if case == "eos_is_pad":
                eng(m, p, cache_len=32, sampling=api.SamplingParams(eos_id=0, pad_id=0))
            elif case == "request_exceeds_cache":
                eng(m, p, cache_len=8).serve([api.Request(tokens=np.arange(1, 7, dtype=np.int32))],
                                             8)
            else:
                arg = {"zero_slots": "max_slots", "zero_seg_len": "seg_len",
                       "zero_prefill_batch": "prefill_batch"}[case]
                eng(m, p, cache_len=32, **{arg: 0})
        assert isinstance(e.value, ValueError)
        if case == "request_exceeds_cache":
            assert "cache_len" in str(e.value)


def test_run_reports_inadmissible_request_as_error(pair):
    _, _, tm, tp = pair
    G = 8
    reqs = _trace(tapi, tm.cfg.vocab_size, 5, gen_hi=G)
    bad = tapi.Request(tokens=np.arange(2, 200, dtype=np.int32))
    res, rep = tapi.make_engine(tm, tp, mode="continuous", cache_len=16 + G, max_slots=2,
                                seg_len=4).run(reqs + [bad], G)
    for r, q in zip(res, reqs):
        assert r.finish_reason == "budget" and r.n_generated == min(q.max_new_tokens, G)
        assert r.delay_ticks >= 0.0
    assert res[-1].finish_reason == "error" and "cache_len" in res[-1].error
    assert rep["requests"] == len(reqs)


def test_streaming_callbacks(pair):
    _, _, tm, tp = pair
    G = 6
    reqs = _trace(tapi, tm.cfg.vocab_size, 5, gen_hi=G)
    got, completed = {}, {}
    eng = ContinuousEngine(tm, tp, cache_len=16 + G, max_slots=2, seg_len=3)
    outs, _ = eng.serve(reqs, G, on_token=lambda i, t: got.setdefault(i, []).append(t),
                        on_complete=lambda i, toks: completed.__setitem__(i, toks))
    assert sorted(completed) == list(range(len(reqs)))
    for i, o in enumerate(outs):
        np.testing.assert_array_equal(o, got[i])
        np.testing.assert_array_equal(o, completed[i])


def test_sampled_streams_are_valid_and_seed_deterministic(pair):
    """temperature > 0 (the port's torch.Generator streams, not the JAX
    package's keys): tokens in the vocabulary, every budget met, the same
    seed gives the same streams, another seed others."""
    _, _, tm, tp = pair
    G, V = 8, tm.cfg.vocab_size
    reqs = _trace(tapi, V, 6, gen_hi=G)
    sp = tapi.SamplingParams(temperature=0.9, top_k=20, seed=7)
    eng = ContinuousEngine(tm, tp, cache_len=16 + G, max_slots=3, seg_len=4, sampling=sp)
    a, _ = eng.serve(reqs, G, seed=1)
    b, _ = eng.serve(reqs, G, seed=1)
    c, _ = eng.serve(reqs, G, seed=2)
    for x, r in zip(a, reqs):
        assert len(x) == min(r.max_new_tokens, G) and x.min() >= 0 and x.max() < V
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not all(np.array_equal(x, y) for x, y in zip(a, c))


# ------------------------------------------------------------ the arena --
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


def _rows_equal(slots, snap, rows):
    """Slots ``rows`` of the arena hold the same bits as in ``snap``."""
    rows = torch.as_tensor(rows, dtype=torch.int64)
    for layer, old in zip(slots.state.layers, snap.state.layers):
        for k, sub in layer.items():
            for n, t in sub.items():
                if not torch.equal(t[:, rows], old[k][n][:, rows]):
                    return False
    return all(torch.equal(getattr(slots, f)[rows], getattr(snap, f)[rows])
               for f in ("tok", "active", "done", "n_gen", "budget")) \
        and torch.equal(slots.state.pos[rows], snap.state.pos[rows])


def test_dummy_prefill_rows_leave_the_arena_bit_identical(pair):
    """A prefill batch of 4 with one real row (slot 2) and dummy rows
    (slot_idx = max_slots and beyond): every other slot keeps its bits;
    slot 2 holds the prefill's own row."""
    _, _, tm, tp = pair
    S = 32
    slots = _random_arena(tm, 4, S)
    snap = slots.clone()
    toks = torch.from_numpy(np.random.default_rng(4).integers(2, 256, size=(4, 16)))
    lens = torch.tensor([11, 16, 16, 16])
    tok0, _ = tm.prefill_into(tp, slots, {"tokens": toks}, [2, 4, 4, 9], [5, 1, 1, 1],
                              cache_len=S, prompt_lens=lens)
    assert _rows_equal(slots, snap, [0, 1, 3])
    _, ref = tm.prefill(tp, {"tokens": toks}, S, prompt_lens=lens)
    for layer, new in zip(slots.state.layers, ref.layers):
        for k, sub in layer.items():
            for n, t in sub.items():
                assert torch.equal(t[:, 2], new[k][n][:, 0])
    assert (slots.state.pos[2].item(), slots.tok[2, 0].item(), slots.n_gen[2].item(),
            slots.budget[2].item()) == (11, tok0[0].item(), 1, 5)
    assert bool(slots.active[2]) and not bool(slots.done[2])


def test_inactive_decode_rows_leave_the_arena_bit_identical(pair):
    """A segment over 4 slots where only slot 0 runs (1 is free, 2 is done,
    3 is free and done): slots 1–3 keep every bit and emit pad; slot 0
    advances once a step."""
    _, _, tm, tp = pair
    slots = _random_arena(tm, 4, 32)
    slots.active.copy_(torch.tensor([True, False, True, False]))
    slots.done.copy_(torch.tensor([False, False, True, True]))
    snap = slots.clone()
    emitted, _ = tm.decode_segment(tp, slots, seg_len=3, pad_id=7)
    assert _rows_equal(slots, snap, [1, 2, 3])
    assert (emitted[1:] == 7).all()
    assert slots.state.pos[0] == snap.state.pos[0] + 3 and slots.n_gen[0] == 4


def _jax_slots(jm, jp, toks, lens, sidx, buds, S, max_slots, eos):
    js = jm.init_slot_state(max_slots, S)
    _, js = jm.prefill_into(jp, js, {"tokens": jnp.asarray(toks, jnp.int32)},
                            jnp.asarray(sidx, jnp.int32), jnp.asarray(buds, jnp.int32),
                            jax.random.PRNGKey(0), cache_len=S,
                            prompt_lens=jnp.asarray(lens, jnp.int32), eos_id=eos)
    return js


def test_prefill_into_and_decode_segment_match_reference(pair):
    """The model layer alone, on one seeded admission (3 real rows of 4,
    slots 3, 0, 4 of 5): the JAX prefill_into + decode_segment and the
    port's give the same tokens, n_gen, done and pos, and arena rows
    within the f32 tolerance."""
    jm, jp, tm, tp = pair
    S, eos = 28, None
    rng = np.random.default_rng(8)
    toks = rng.integers(2, 256, size=(4, 16))
    lens, sidx, buds = [16, 9, 13, 16], [3, 0, 4, 5], [12, 3, 7, 1]
    js = _jax_slots(jm, jp, toks, lens, sidx, buds, S, 5, eos)
    jem, js = jm.decode_segment(jp, js, jax.random.PRNGKey(1), seg_len=6)
    ts = tm.init_slot_state(5, S, device="cpu")
    tm.prefill_into(tp, ts, {"tokens": torch.from_numpy(toks)}, sidx, buds, cache_len=S,
                    prompt_lens=torch.tensor(lens))
    tem, ts = tm.decode_segment(tp, ts, seg_len=6)
    np.testing.assert_array_equal(tem.numpy(), np.asarray(jem))
    for f in ("n_gen", "done", "active", "budget"):
        np.testing.assert_array_equal(getattr(ts, f).numpy(), np.asarray(getattr(js, f)), f)
    np.testing.assert_array_equal(ts.tok.numpy(), np.asarray(js.tok))
    np.testing.assert_array_equal(ts.state.pos.numpy(), np.asarray(js.state.pos))
    for name in ("k", "v"):
        ref = np.asarray(js.state.layers[0]["sub0"][name])
        np.testing.assert_allclose(ts.state.layers[0]["sub0"][name].numpy(), ref, **F32_TOL)

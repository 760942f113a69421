"""The port's speculative decoding (Model.decode_verify / draft_propose /
spec_verify, attention.verify_attention, ContinuousEngine with a draft,
draft_from_target, make_engine's modes) against repro on gpt-smoke in f32
with the flash path on: verify against sequential decode, the k-boundary
cases of spec_verify against the JAX spec_verify on the same seeded slot
state, dropped writes past the cache end, speculative ≡ continuous streams
and the speculation counters, and the error taxonomy."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.launch import api as japi
from repro.launch.serve import draft_from_target as jax_draft_from_target
from repro.models.model import DecodeState as JaxDecodeState
from repro.models.model import build_model as jax_build
from repro_torch.configs import get_config
from repro_torch.configs.base import Sub
from repro_torch.convert import params_from_numpy
from repro_torch.launch import api as tapi
from repro_torch.launch.serve import ContinuousEngine, GenerationEngine, draft_from_target
from repro_torch.models import transformer as tf
from repro_torch.models.model import build_model, param_dict

KW = dict(dtype="float32", flash_min_len=16, flash_block=16)
# decode_verify against W sequential decode_steps on the CPU in f32: not
# bit-identical. Decode's per-head score product has one query row, which
# the CPU runs as a matrix-vector product that sums in another order than
# verify's W-row product (measured gap 3.6e-7 on these logits); GQA with 2
# query heads a group takes one kernel for both and is bit-identical.
VERIFY_ATOL = 1e-5


def _pair(**over):
    kw = {**KW, **over}
    jcfg = dataclasses.replace(jax_config("gpt-smoke", smoke=True), **kw)
    tcfg = dataclasses.replace(get_config("gpt-smoke", smoke=True), **kw)
    jm = jax_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(3))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tcfg, "cpu")
    return jm, jp, build_model(tcfg), tp


@pytest.fixture(scope="module")
def pair():
    return _pair()


def _trace(api, vocab, n, seed=3, lo=4, hi=12, gen_hi=10):
    rng = np.random.default_rng(seed)
    return [api.Request(tokens=rng.integers(2, vocab, size=int(rng.integers(lo, hi + 1)))
                        .astype(np.int32), max_new_tokens=int(rng.integers(1, gen_hi + 1)),
                        arrival=float(rng.uniform(0, 12))) for _ in range(n)]


# ------------------------------------------------ verify vs sequential --
@pytest.mark.parametrize("over", [{}, dict(n_kv_heads=2, local_global_period=2, window_size=5)],
                         ids=["mha", "gqa_window"])
def test_decode_verify_matches_sequential_decode(over):
    """logits[:, i] of one width-5 verify equal those of 5 sequential
    decode steps (within VERIFY_ATOL), over ragged slots and, for the
    second config, GQA 4/2 with a 5-wide window on the local layer; the
    caches and positions come out the same."""
    _, _, tm, tp = _pair(**over)
    B, S, W = 3, 32, 5
    slots = tm.init_slot_state(B, S, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(2, 256, size=(B, 16)))
    tm.prefill_into(tp, slots, {"tokens": toks}, [0, 1, 2], [20] * 3, cache_len=S,
                    prompt_lens=torch.tensor([16, 5, 11]))
    tk = torch.from_numpy(np.random.default_rng(1).integers(2, 256, size=(B, W)))
    lv, sv = tm.decode_verify(tp, slots.state.clone(), tk)
    sd, ls = slots.state.clone(), []
    for i in range(W):
        logits, sd = tm.decode_step(tp, sd, tk[:, i:i + 1])
        ls.append(logits[:, 0])
    gap = (lv - torch.stack(ls, 1)).abs().max().item()
    assert gap <= VERIFY_ATOL, gap
    assert torch.equal(sv.pos, sd.pos)
    for a, b in zip(sv.layers, sd.layers):
        for k in a:
            for n in a[k]:
                torch.testing.assert_close(a[k][n], b[k][n], rtol=0, atol=VERIFY_ATOL)


def test_verify_writes_past_the_cache_end_are_dropped(pair):
    """Slot 0 at pos S-2 verifies W=5 tokens (3 writes past the end), slot
    1 is inactive: slot 0's positions below pos keep their bits (the
    dropped writes' wrapped destinations among them), its last two take
    the new K/V, slot 1 keeps every bit; the reference's ``mode="drop"``
    gives the same cache."""
    jm, jp, tm, tp = pair
    S, W = 12, 5
    g = torch.Generator().manual_seed(0)
    st = tm.init_decode_state(2, S, device="cpu")
    for t in st.layers[0]["sub0"].values():
        t.copy_(torch.randn(t.shape, generator=g))
    st.pos.copy_(torch.tensor([S - 2, 4]))
    before = st.clone()
    tk = torch.from_numpy(np.random.default_rng(2).integers(2, 256, size=(2, W)))
    active = torch.tensor([True, False])
    _, new = tm.decode_verify(tp, st, tk, active=active)
    assert torch.equal(new.pos, torch.tensor([S - 2 + W, 4]))
    jst = JaxDecodeState(tuple({k: {n: jnp.asarray(t.numpy()) for n, t in sub.items()}
                                for k, sub in layer.items()} for layer in before.layers),
                         jnp.asarray(before.pos.numpy(), jnp.int32))
    _, jnew = jm.decode_verify(jp, jst, jnp.asarray(tk.numpy(), jnp.int32),
                               active=jnp.asarray(active.numpy()))
    for n in ("k", "v"):
        got, old = st.layers[0]["sub0"][n], before.layers[0]["sub0"][n]
        assert torch.equal(got[:, 0, :S - 2], old[:, 0, :S - 2])
        assert not torch.equal(got[:, 0, S - 2:], old[:, 0, S - 2:])
        assert torch.equal(got[:, 1], old[:, 1])
        np.testing.assert_allclose(got.numpy(), np.asarray(jnew.layers[0]["sub0"][n]), rtol=1e-4,
                                   atol=1e-4)


# ------------------------------------------------ spec_verify boundaries --
def _seeded_slots(pair, budget, B=2, S=32):
    """Two live slots prefilled from one seeded batch in both packages;
    greedy[b] is the closed greedy continuation (greedy[:, 0] is the token
    already in slots.tok)."""
    jm, jp, tm, tp = pair
    toks = np.random.default_rng(0).integers(2, 256, size=(B, 8))
    greedy, _ = tm.generate(tp, {"tokens": torch.from_numpy(toks)}, budget, cache_len=S)
    ts = tm.init_slot_state(B, S, device="cpu")
    tm.prefill_into(tp, ts, {"tokens": torch.from_numpy(toks)}, list(range(B)), [budget] * B,
                    cache_len=S)
    js = jm.init_slot_state(B, S)
    _, js = jm.prefill_into(jp, js, {"tokens": jnp.asarray(toks, jnp.int32)},
                            jnp.arange(B, dtype=jnp.int32), jnp.full((B,), budget, jnp.int32),
                            jax.random.PRNGKey(0), cache_len=S)
    greedy = greedy.numpy()
    assert (ts.tok[:, 0].numpy() == greedy[:, 0]).all()
    assert (np.asarray(js.tok[:, 0]) == greedy[:, 0]).all()
    return ts, js, greedy


def _both_verify(pair, ts, js, props, eos=None):
    """One spec_verify in each package; asserts they agree on everything
    the scheduler reads and returns the port's (emitted, n_gen delta,
    slots)."""
    jm, jp, tm, tp = pair
    n0 = ts.n_gen.clone()
    em, ts = tm.spec_verify(tp, ts, torch.as_tensor(props), eos_id=eos)
    jem, js = jm.spec_verify(jp, js, jnp.asarray(props, jnp.int32), eos_id=eos)
    np.testing.assert_array_equal(em.numpy(), np.asarray(jem))
    for f in ("n_gen", "done", "active", "budget"):
        np.testing.assert_array_equal(getattr(ts, f).numpy(), np.asarray(getattr(js, f)), f)
    np.testing.assert_array_equal(ts.tok.numpy(), np.asarray(js.tok))
    np.testing.assert_array_equal(ts.state.pos.numpy(), np.asarray(js.state.pos))
    return em.numpy(), (ts.n_gen - n0).numpy(), ts, js


@pytest.mark.parametrize("case", ["accept_all", "reject_all", "rollback_then_readvance",
                                  "eos_in_accepted_prefix", "budget_truncation"])
def test_spec_verify_matches_reference(pair, case):
    """tests/test_speculative.py's k-boundary cases, each through both
    packages' spec_verify on the same seeded slot state."""
    k, budget = {"eos_in_accepted_prefix": (4, 10), "budget_truncation": (4, 3),
                 "rollback_then_readvance": (3, 12)}.get(case, (3, 10))
    ts, js, greedy = _seeded_slots(pair, budget)
    p0 = ts.state.pos.clone()
    right = greedy[:, 1:k + 1]
    wrong = (right + 1) % 256
    if case == "accept_all":
        em, m, ts, _ = _both_verify(pair, ts, js, right)
        assert (m == k + 1).all() and (em[:, :k + 1] == greedy[:, 1:k + 2]).all()
        assert torch.equal(ts.state.pos, p0 + k + 1) and not ts.done.any()
        assert (ts.tok[:, 0].numpy() == greedy[:, k + 1]).all()
    elif case == "reject_all":
        em, m, ts, _ = _both_verify(pair, ts, js, wrong)
        assert (m == 1).all() and (em[:, 0] == greedy[:, 1]).all() and (em[:, 1:] == 0).all()
        assert torch.equal(ts.state.pos, p0 + 1)
    elif case == "rollback_then_readvance":
        _, _, ts, js = _both_verify(pair, ts, js, wrong)
        em, m, _, _ = _both_verify(pair, ts, js, greedy[:, 2:k + 2])
        assert (m == k + 1).all() and (em[:, :k + 1] == greedy[:, 2:k + 3]).all()
    elif case == "eos_in_accepted_prefix":
        # the first slot b and commit j >= 2 whose token has not come before in its stream
        b, j = next((b, j) for b in range(2) for j in range(2, k + 1)
                    if greedy[b, j] not in greedy[b, 1:j] and greedy[b, j] != 0)
        eos = int(greedy[b, j])
        em, m, ts, _ = _both_verify(pair, ts, js, right, eos=eos)
        assert m[b] == j and em[b, j - 1] == eos and (em[b, j:] == 0).all() and bool(ts.done[b])
        assert bool(ts.done[1 - b]) == (eos in em[1 - b, :m[1 - b]])
    else:
        em, m, ts, _ = _both_verify(pair, ts, js, right)
        assert (m == 2).all() and (em[:, :2] == greedy[:, 1:3]).all() and ts.done.all()
        assert (ts.n_gen == budget).all()


# ------------------------------------------------ engine-level parity --
@pytest.mark.parametrize("draft,eos,n,gen,spec_k", [
    ("self", False, 9, 10, 4), ("layers:1", False, 9, 10, 4), ("self", True, 9, 10, 4),
    ("self", False, 5, 6, 1)], ids=["self", "layers1", "eos", "spec_k1"])
def test_speculative_matches_continuous_and_reference(pair, draft, eos, n, gen, spec_k):
    """Speculative streams equal continuous streams; the speculation
    counters (target_slot_forwards, spec_tokens_committed,
    acceptance_rate) and the streams equal the JAX speculative engine's
    on the same trace. (The reference's layers:1 draft is never accepted
    on gpt-smoke, so acceptance > 0 is not asked of it here.)"""
    jm, jp, tm, tp = pair
    V = tm.cfg.vocab_size
    treqs, jreqs = _trace(tapi, V, n, gen_hi=gen), _trace(japi, V, n, gen_hi=gen)
    eos_id = None
    if eos:
        rows = GenerationEngine(tm, tp, max_batch=3).generate(treqs, gen)
        eos_id = next(int(t) for row in rows for t in row[1:] if int(t) != 0)
    kw = dict(cache_len=16 + gen, max_slots=3, seg_len=4, prefill_batch=2)
    outs_c, rep_c = tapi.make_engine(tm, tp, mode="continuous",
                                     sampling=tapi.SamplingParams(eos_id=eos_id), **kw).serve(
        treqs, gen)
    dm, dp = draft_from_target(tm, tp, draft)
    outs_s, rep_s = tapi.make_engine(tm, tp, mode="speculative", draft_model=dm, draft_params=dp,
                                     spec_k=spec_k, sampling=tapi.SamplingParams(eos_id=eos_id),
                                     **kw).serve(treqs, gen)
    jdm, jdp = jax_draft_from_target(jm, jp, draft)
    jouts, jrep = japi.make_engine(jm, jp, mode="speculative", draft_model=jdm, draft_params=jdp,
                                   spec_k=spec_k, sampling=japi.SamplingParams(eos_id=eos_id),
                                   **kw).serve(jreqs, gen, key=jax.random.PRNGKey(5))
    for i in range(n):
        np.testing.assert_array_equal(outs_s[i], outs_c[i], err_msg=f"request {i}")
        np.testing.assert_array_equal(outs_s[i], np.asarray(jouts[i]), err_msg=f"request {i}")
    assert rep_s["tokens_real"] == rep_c["tokens_real"]
    for key in ("target_slot_forwards", "spec_tokens_committed", "acceptance_rate",
                "verify_launches", "clock_ticks", "token_slots", "goodput", "delays"):
        assert rep_s[key] == jrep[key], key
    assert set(jrep) - set(rep_s) == {"prefill_traces", "decode_traces", "draft_traces",
                                      "verify_traces", "draft_prefill_traces"}
    if draft == "self":
        assert rep_s["target_slot_forwards"] < rep_s["spec_tokens_committed"]
        assert eos or rep_s["acceptance_rate"] > 0.5     # EOS cuts commits short
    if eos:
        assert any(eos_id in o for o in map(list, outs_s)), "EOS never fired"


# ------------------------------------------------------------ the draft --
def test_layers_draft_shares_the_target_storage(pair):
    """layers:N slices the stacked group tensors to [:N] as views and shares
    embed, lm_head and final_norm: no byte is copied."""
    _, _, tm, tp = pair
    dm, dp = draft_from_target(tm, tp, "layers:1")
    assert dm.cfg.n_layers == 1 and dm.cfg.d_model == tm.cfg.d_model
    t, d = param_dict(tp), param_dict(dp)
    assert d["embed"] is t["embed"] and d["lm_head"] is t["lm_head"]
    assert d["decoder"]["final_norm"] is t["decoder"]["final_norm"]
    for key, sub in d["decoder"]["groups"][0].items():
        for name, view in sub.items():
            full = t["decoder"]["groups"][0][key][name]
            assert view.shape[0] == 1 and view.data_ptr() == full.data_ptr()
            assert view.untyped_storage().data_ptr() == full.untyped_storage().data_ptr()
    assert draft_from_target(tm, tp, "self") == (tm, tp)


@pytest.mark.parametrize("spec,err", [("layers:2", "AdmissionError"), ("layers:0", "AdmissionError"),
                                      ("bogus", "AdmissionError"),
                                      ("layers:1/two_groups", "CapabilityError")])
def test_draft_from_target_errors_match_reference(spec, err):
    over = {}
    if spec.endswith("two_groups"):      # local:global period 2 over 3 layers: two groups
        spec, over = "layers:1", dict(local_global_period=2, window_size=4, n_layers=3)
    jm, jp, tm, tp = _pair(**over)
    for api, fn, m, p in ((tapi, draft_from_target, tm, tp),
                          (japi, jax_draft_from_target, jm, jp)):
        with pytest.raises(getattr(api, err)):
            fn(m, p, spec)


# ---------------------------------------------------------------- errors --
def test_speculation_is_greedy_only(pair):
    _, _, tm, tp = pair
    for sp in (tapi.SamplingParams(temperature=0.7), tapi.SamplingParams(top_k=3)):
        with pytest.raises(tapi.CapabilityError):
            tapi.make_engine(tm, tp, mode="speculative", sampling=sp, cache_len=32,
                             draft_model=tm, draft_params=tp, spec_k=4)


def test_recurrent_target_or_draft_is_a_capability_error(pair):
    """A recurrent model (SSM/RWKV) cannot roll back a rejected suffix: as
    target or draft the engine refuses it before touching a parameter,
    and the verify step refuses its sublayers as the reference does."""
    _, _, tm, tp = pair
    rec = build_model(dataclasses.replace(tm.cfg, family="ssm"))
    assert rec._has_recurrent_state()
    for target, draft in ((rec, tm), (tm, rec)):
        with pytest.raises(tapi.CapabilityError) as e:
            ContinuousEngine(target, tp, cache_len=32, draft_model=draft, draft_params=tp,
                             spec_k=4)
        assert isinstance(e.value, RuntimeError)
    h = torch.zeros((1, 2, tm.cfg.d_model))
    with pytest.raises(ValueError, match="rollback"):
        tf.sub_verify({"norm": torch.zeros(tm.cfg.d_model)}, h, Sub("rwkv_tmix"), tm.cfg, None,
                      torch.zeros(1, dtype=torch.int64))


@pytest.mark.parametrize("case", ["no_draft", "zero_spec_k", "negative_spec_k", "vocab_mismatch",
                                  "bogus_mode"])
def test_admission_errors_match_reference(pair, case):
    jm, jp, tm, tp = pair
    for api, m, p in ((tapi, tm, tp), (japi, jm, jp)):
        kw = dict(cache_len=32, draft_model=m, draft_params=p)
        mode = "speculative"
        if case == "no_draft":
            kw = dict(cache_len=32)
        elif case == "zero_spec_k":
            kw["spec_k"] = 0
        elif case == "negative_spec_k":
            mode, kw["spec_k"] = "continuous", -1
        elif case == "vocab_mismatch":
            other = dataclasses.replace(m.cfg, vocab_size=m.cfg.vocab_size + 1)
            kw["draft_model"] = (build_model if api is tapi else jax_build)(other)
        else:
            mode = "warp-drive"
        with pytest.raises(api.AdmissionError):
            api.make_engine(m, p, mode=mode, **kw)


def test_make_engine_builds_each_mode(pair):
    _, _, tm, tp = pair
    assert isinstance(tapi.make_engine(tm, tp), GenerationEngine)
    cont = tapi.make_engine(tm, tp, mode="continuous", cache_len=32)
    assert isinstance(cont, ContinuousEngine) and cont.spec_k == 0
    spec = tapi.make_engine(tm, tp, mode="speculative", cache_len=32, draft_model=tm,
                            draft_params=tp)
    assert isinstance(spec, ContinuousEngine) and spec.spec_k == 4

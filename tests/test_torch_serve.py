"""The port's closed-batch engine and serving API (repro_torch.launch)
against repro.launch on gpt-smoke in f32 with the flash path on; the
continuous and speculative engines are in test_torch_continuous.py and
test_torch_speculative.py."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.launch import api as japi
from repro.launch.serve import GenerationEngine as JaxEngine
from repro.models.model import build_model as jax_build
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.data.synthetic import SyntheticCorpus
from repro_torch.launch import api as tapi
from repro_torch.launch.serve import ContinuousEngine, GenerationEngine, _bucket_len, main
from repro_torch.models.model import build_model


def _setup():
    kw = dict(dtype="float32", flash_min_len=16, flash_block=16)
    jcfg = dataclasses.replace(jax_config("gpt-smoke", smoke=True), **kw)
    tcfg = dataclasses.replace(get_config("gpt-smoke", smoke=True), **kw)
    jm = jax_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(3))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tcfg, "cpu")
    return jm, jp, build_model(tcfg), tp


def _requests(api, lens, budgets, vocab, seed=5):
    rng = np.random.default_rng(seed)
    return [api.Request(tokens=rng.integers(0, vocab, size=n).astype(np.int32),
                        max_new_tokens=b) for n, b in zip(lens, budgets)]


def test_engine_run_matches_jax_engine():
    """6 ragged greedy requests over three prompt buckets (8, 16, 32; the
    last two through the flash path), two batches with dummy rows, per-
    request budgets and an EOS that fires: identical tokens, finish
    reasons, generated and padded token counts."""
    jm, jp, tm, tp = _setup()
    lens, budgets, G = [5, 12, 17, 20, 9, 30], [None, 4, None, 6, None, None], 8
    treqs = _requests(tapi, lens, budgets, tm.cfg.vocab_size)
    # EOS = a token that the port's unmasked run emits mid-stream
    probe = GenerationEngine(tm, tp, max_batch=4).generate(treqs, G)
    eos = int(probe[2][2])
    sp = dict(eos_id=eos, pad_id=(eos + 1) % tm.cfg.vocab_size)
    teng = GenerationEngine(tm, tp, max_batch=4, sampling=tapi.SamplingParams(**sp))
    jeng = JaxEngine(jm, jp, max_batch=4, sampling=japi.SamplingParams(**sp))
    tres, trep = teng.run(treqs, G)
    jres, jrep = jeng.run(_requests(japi, lens, budgets, tm.cfg.vocab_size), G)
    for t, j in zip(tres, jres):
        np.testing.assert_array_equal(t.tokens, np.asarray(j.tokens))
        assert (t.finish_reason, t.n_generated) == (j.finish_reason, j.n_generated)
    assert any(t.finish_reason == "eos" for t in tres)
    assert any(t.finish_reason == "budget" for t in tres)
    for key in ("batches", "tokens_generated", "tokens_padded", "goodput"):
        assert trep[key] == jrep[key], key


def test_run_reports_malformed_request_as_error():
    _, _, tm, tp = _setup()
    reqs = [tapi.Request(tokens=np.arange(5)), tapi.Request(tokens=np.arange(5),
                                                            frontend=np.zeros((2, 64)))]
    res, _ = GenerationEngine(tm, tp).run(reqs, 3)
    assert res[0].finish_reason == "budget" and res[0].n_generated == 3
    assert res[1].finish_reason == "error" and "frontend" in res[1].error


@pytest.mark.parametrize("kw", [dict(temperature=-1.0), dict(top_k=-2),
                                dict(eos_id=0, pad_id=0)])
def test_sampling_params_validation_matches(kw):
    for api in (japi, tapi):
        with pytest.raises(api.AdmissionError) as e:
            api.SamplingParams(**kw)
        assert isinstance(e.value, ValueError) and isinstance(e.value, api.ServeError)


def test_make_engine_modes(capsys):
    """Each mode builds its engine (speculative only with a draft), and the
    CLI serves gpt-smoke continuously, with and without a layers:1 draft."""
    _, _, tm, tp = _setup()
    assert isinstance(tapi.make_engine(tm, tp, mode="closed", max_batch=2), GenerationEngine)
    cont = tapi.make_engine(tm, tp, mode="continuous", cache_len=32)
    spec = tapi.make_engine(tm, tp, mode="speculative", cache_len=32, draft_model=tm,
                            draft_params=tp)
    assert isinstance(cont, ContinuousEngine) and cont.spec_k == 0
    assert isinstance(spec, ContinuousEngine) and spec.spec_k == 4
    with pytest.raises(tapi.AdmissionError):
        tapi.make_engine(tm, tp, mode="speculative", cache_len=32)
    with pytest.raises(tapi.AdmissionError):
        tapi.make_engine(tm, tp, mode="bogus")
    args = ["--arch", "gpt-tiny", "--smoke", "--device", "cpu", "--continuous", "--requests", "6",
            "--gen", "8", "--flash-min-len", "16"]
    outs = main(args)
    spec_outs = main(args + ["--speculative-draft", "layers:1", "--spec-k", "2"])
    assert len(outs) == 6 and all(1 <= len(o) <= 8 for o in outs)
    assert all(np.array_equal(a, b) for a, b in zip(outs, spec_outs))   # greedy: same streams
    out = capsys.readouterr().out
    assert "continuous on cpu" in out and "speculative: k=2" in out


def test_bucket_len_and_corpus():
    assert [_bucket_len(n) for n in (1, 8, 9, 33)] == [8, 8, 16, 64]
    c = SyntheticCorpus(256, 12, 3, seed=1)
    a, b = c.batch_at(4)["tokens"], c.batch_at(4)["tokens"]
    np.testing.assert_array_equal(a, b)                    # pure function of (seed, step)
    assert a.shape == (3, 12) and a.min() >= 0 and a.max() < 256
    assert not np.array_equal(a, c.batch_at(5)["tokens"])


def test_cuda_default_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        build_model(get_config("gpt-smoke", smoke=True)).init(0)

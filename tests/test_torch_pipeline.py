"""The port's pipeline (repro_torch.distributed.pipeline and the pipeline
mode of train.sharded) against the JAX package's.

* The schedule IR: ``make_schedule``'s instruction arrays, stash slots,
  ``comm_ready`` and ``stats()`` equal the JAX package's for every schedule
  over a grid of (S, M, V), with the same validation errors; the
  structural properties tests/test_distributed.py holds (every op once,
  dataflow through the ring, no live slot overwritten, 1F1B's stash).
* ``run_schedule`` (single controller, S stages in one process) ≡ the
  gradient of the sequential microbatch-mean loss, for every schedule, on
  a toy f32 tanh-residual body with an aux term: ≤ 8e-7 relative, the
  bound of tests/test_sharded_engine.py (pure f32 summation order: a
  misrouted cotangent or a clobbered slot is a gross error).
* The engine's pipeline mode ≡ the unpipelined step (the bounds of
  tests/test_sharded_engine.py: loss within 2e-3, edq/update_norm/
  grad_norm within 2e-3 relative, every parameter within 2e-2·|θ| + 3·lr
  per step), on gpt-tiny for gpipe, 1f1b and interleaved (V 2), with tied
  embeddings (granite) and MoE aux (qwen3-moe, the same microbatch
  decomposition on both sides) on 1f1b, and with fp8_ef; the three
  schedules' losses agree to 4 decimals.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.distributed import pipeline as jp
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.collage import CollageAdamW
from repro_torch.core.precision import BucketPolicy, PrecisionPolicy, Strategy
from repro_torch.data.synthetic import make_batch_fn
from repro_torch.distributed import pipeline as pp
from repro_torch.models.model import AUX_LOSS_COEF, build_model
from repro_torch.train import sharded, train_loop

ARRAYS = ("f_chunk", "f_micro", "f_slot", "f_wslot", "b_chunk", "b_micro", "b_xslot",
          "b_dyslot", "b_wslot")
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file's cases: they run many small ops,
    which a thread pool shared with the suite's other workers slows many
    times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _grid(name):
    for S in (1, 2, 3, 4):
        for M in (1, 2, 3, 4, 6, 8):
            for V in ((1,) if name != "interleaved" else (2, 3)):
                yield S, M, V


@pytest.mark.parametrize("name", pp.SCHEDULES)
def test_schedule_ir_matches_reference(name):
    n = 0
    for S, M, V in _grid(name):
        try:
            ref = jp.make_schedule(name, n_stages=S, n_micro=M, n_virtual=V)
        except ValueError as e:
            with pytest.raises(ValueError, match=str(e).split(",")[0]):
                pp.make_schedule(name, n_stages=S, n_micro=M, n_virtual=V)
            continue
        got = pp.make_schedule(name, n_stages=S, n_micro=M, n_virtual=V)
        for k in ARRAYS:
            assert np.array_equal(getattr(got, k), getattr(ref, k)), (name, S, M, V, k)
            assert getattr(got, k).dtype == np.int32
        assert (got.n_fwd_slots, got.n_bwd_slots) == (ref.n_fwd_slots, ref.n_bwd_slots)
        assert got.comm_ready == ref.comm_ready and got.stats() == ref.stats()
        n += 1
    assert n >= 12


def test_schedule_validation_errors():
    with pytest.raises(ValueError, match="unknown schedule"):
        pp.make_schedule("zb-h1", n_stages=2, n_micro=4)
    with pytest.raises(ValueError, match="interleaved"):
        pp.make_schedule("gpipe", n_stages=2, n_micro=4, n_virtual=2)
    with pytest.raises(ValueError, match="n_virtual >= 2"):
        pp.make_schedule("interleaved", n_stages=2, n_micro=4, n_virtual=1)
    with pytest.raises(ValueError, match="n_micro % n_stages"):
        pp.make_schedule("interleaved", n_stages=4, n_micro=6, n_virtual=2)


def _scheds():
    for name in pp.SCHEDULES:
        for S, M, V in _grid(name):
            if name == "interleaved" and M % S:
                continue
            yield pp.make_schedule(name, n_stages=S, n_micro=M, n_virtual=V)


def test_schedule_ops_dataflow_and_slots():
    """Every (chunk, micro) runs forward and backward once, forward first;
    each input arrived on an earlier tick; no slot is written while live."""
    for sched in _scheds():
        S, M, C = sched.n_stages, sched.n_micro, sched.n_chunks
        fwd, bwd = {}, {}
        for t in range(sched.n_ticks):
            for s in range(S):
                if sched.f_chunk[t, s] >= 0:
                    fwd[(int(sched.f_chunk[t, s]), int(sched.f_micro[t, s]))] = t
                if sched.b_chunk[t, s] >= 0:
                    bwd[(int(sched.b_chunk[t, s]), int(sched.b_micro[t, s]))] = t
        want = {(c, m) for c in range(C) for m in range(M)}
        assert set(fwd) == want == set(bwd), sched.name
        for c, m in want:
            assert fwd[(c, m)] < bwd[(c, m)]
            assert c == 0 or fwd[(c - 1, m)] < fwd[(c, m)]
            assert c == C - 1 or bwd[(c + 1, m)] < bwd[(c, m)]
        for s in range(S):
            live = {}
            for t in range(sched.n_ticks):
                if sched.b_chunk[t, s] > 0:
                    slot = int(sched.b_xslot[t, s])
                    assert live.pop(slot)[0] == (int(sched.b_chunk[t, s]),
                                                 int(sched.b_micro[t, s]))
                w = int(sched.f_wslot[t, s])
                if w >= 0:
                    assert w not in live
                    up = (s - 1) % S
                    live[w] = ((int(sched.f_chunk[t, up]) + 1, int(sched.f_micro[t, up])), t)
            assert not live
        r = sched.comm_ready
        assert r["head"] <= r["embed"] <= r["stage"] <= sched.n_ticks


def test_schedule_bubble_and_stash_economy():
    for S, M in ((2, 4), (4, 8)):
        g = pp.make_schedule("gpipe", n_stages=S, n_micro=M).stats()
        o = pp.make_schedule("1f1b", n_stages=S, n_micro=M).stats()
        v = pp.make_schedule("interleaved", n_stages=S, n_micro=M, n_virtual=2).stats()
        assert o["bubble_fraction"] < g["bubble_fraction"]
        assert v["bubble_fraction"] < g["bubble_fraction"]
        assert o["n_fwd_slots"] == min(M, S) < g["n_fwd_slots"] == M


def test_split_stages_and_virtual_match_reference():
    import jax.numpy as jnp
    x = np.arange(12 * 3 * 2, dtype=np.float32).reshape(12, 3, 2)
    tree = {"a": torch.from_numpy(x), "b": [torch.from_numpy(x[:, 0])]}
    jtree = {"a": jnp.asarray(x), "b": [jnp.asarray(x[:, 0])]}
    for S, V in ((2, 1), (3, 1), (2, 2), (3, 2)):
        got = pp.split_virtual(tree, S, V) if V > 1 else pp.split_stages(tree, S)
        ref = jp.split_virtual(jtree, S, V) if V > 1 else jp.split_stages(jtree, S)
        assert np.array_equal(got["a"].numpy(), np.asarray(ref["a"]))
        assert np.array_equal(got["b"][0].numpy(), np.asarray(ref["b"][0]))


# --------------------------------------------------------------------------
# run_schedule ≡ sequential autodiff (f32)
# --------------------------------------------------------------------------

S_TOY, D, MB, L, VOC, LC = 4, 8, 2, 6, 12, 2


def _toy_body(p, x):
    aux = torch.zeros((), dtype=torch.float32)
    for k in range(p["w"].shape[0]):
        x = torch.tanh(x @ p["w"][k]) + x
        aux = aux + torch.sum(x * x) * 1e-3
    return x, aux


def _toy_head(hp, y, lab):
    logp = torch.log_softmax(y @ hp["wo"], dim=-1)
    return -torch.gather(logp, -1, lab[..., None])[..., 0].mean()


@pytest.mark.parametrize("name,M,V", [("gpipe", 8, 1), ("1f1b", 8, 1), ("1f1b", 6, 1),
                                      ("interleaved", 8, 2)])
def test_run_schedule_matches_sequential_autodiff(name, M, V):
    C = S_TOY * V
    rng = np.random.RandomState(42)
    Ws = torch.from_numpy(rng.randn(C * LC, D, D).astype(np.float32) * 0.3)
    wo = torch.from_numpy(rng.randn(D, VOC).astype(np.float32) * 0.3)
    xs = torch.from_numpy(rng.randn(M, MB, L, D).astype(np.float32))
    labels = torch.from_numpy(rng.randint(0, VOC, (M, MB, L)))

    Wr, wor, xr = (t.clone().requires_grad_(True) for t in (Ws, wo, xs))
    with torch.enable_grad():
        tot, ce_ref, aux_ref = 0.0, 0.0, 0.0
        for m in range(M):
            y, aux = _toy_body({"w": Wr}, xr[m])
            ce = _toy_head({"wo": wor}, y, labels[m])
            tot = tot + (ce + AUX_LOSS_COEF * aux) / M
            ce_ref, aux_ref = ce_ref + ce.detach(), aux_ref + aux.detach()
        gW, gwo, gxs = torch.autograd.grad(tot, (Wr, wor, xr))

    sched = pp.make_schedule(name, n_stages=S_TOY, n_micro=M, n_virtual=V)
    chunks = [{"w": Ws[c * LC:(c + 1) * LC]} for c in range(C)]
    out = pp.run_schedule(sched, _toy_body, _toy_head, chunks, {"wo": wo}, xs, labels,
                          devices=[CPU] * S_TOY)
    gc = torch.cat([g["w"] for g in out["g_chunks"]])

    def rel(a, b):
        return float((a - b).abs().max() / max(float(b.abs().max()), 1e-12))
    errs = (rel(gc, gW), rel(out["g_head"]["wo"], gwo), rel(out["dxs"], gxs),
            abs(float(out["ce"] - ce_ref)) / abs(float(ce_ref)),
            abs(float(out["aux"] - aux_ref)) / abs(float(aux_ref)))
    assert max(errs) < 8e-7, (name, M, V, errs)


def test_run_schedule_checks_its_inputs():
    sched = pp.make_schedule("1f1b", n_stages=2, n_micro=2)
    with pytest.raises(ValueError, match="devices"):
        pp.run_schedule(sched, _toy_body, _toy_head, [{}, {}], {}, torch.zeros(2, 1, 1, 1),
                        torch.zeros(2, 1, 1, dtype=torch.long), devices=[CPU])
    with pytest.raises(ValueError, match="chunk parameter trees"):
        pp.run_schedule(sched, _toy_body, _toy_head, [{}], {}, torch.zeros(2, 1, 1, 1),
                        torch.zeros(2, 1, 1, dtype=torch.long), devices=[CPU, CPU])


# --------------------------------------------------------------------------
# the engine's pipeline mode ≡ the unpipelined step
# --------------------------------------------------------------------------

def _opt(**kw):
    return CollageAdamW(1e-3, b2=0.95, policy=PrecisionPolicy(
        strategy=Strategy.C_COLLAGE_PLUS, bucketing=BucketPolicy()), **kw)


def _params_vec(state):
    from repro_torch.core import bucketing
    return np.concatenate([t.detach().float().reshape(-1).numpy()
                           for t in bucketing.tree_leaves(state.params)])


def _run_pair(arch, smoke, schedule, S, V, n_ref, n_pipe, comp="none", steps=2, metrics=False,
              B=16):
    cfg = get_config(arch, smoke=smoke)
    model = build_model(cfg)
    bf = make_batch_fn(cfg, ShapeConfig("t", 32, B, "train"), device="cpu")
    chunk = lambda i, n: {k: v.reshape((n, B // n) + tuple(v.shape[1:]))
                          for k, v in bf(i).items()}
    opt = _opt(compute_metrics=metrics)
    ref_step = train_loop.make_train_step(model, opt)
    s = train_loop.init_state(model, opt, 0, device="cpu")
    mesh = sharded.Mesh(pipe=(CPU,) * S)
    step = sharded.make_sharded_train_step(model, opt, mesh, pipeline_axis="pipe",
                                           schedule=schedule, virtual_stages=V,
                                           grad_compression=comp)
    sd = sharded.shard_state(
        sharded.init_state(model, opt, 0, mesh, pipeline_axis="pipe", virtual_stages=V,
                           grad_compression=comp, device="cpu"), mesh, pipeline_axis="pipe")
    hist = []
    for i in range(steps):
        s, mref = ref_step(s, chunk(i, n_ref))
        sd, m = step(sd, chunk(i, n_pipe))
        hist.append(({k: float(v) for k, v in mref.items()}, {k: float(v) for k, v in m.items()}))
    return s, sd, hist


def _assert_envelope(s, sd, steps=2, lr=1e-3):
    a, b = _params_vec(s), _params_vec(sd)
    tol = 2e-2 * np.abs(a) + steps * 3 * lr
    assert int((np.abs(a - b) > tol).sum()) == 0, np.abs(a - b).max()


LOSSES = {}


@pytest.mark.parametrize("schedule,S,V", [("gpipe", 4, 1), ("1f1b", 4, 1),
                                          ("interleaved", 2, 2)])
def test_pipeline_engine_matches_unpipelined(schedule, S, V):
    s, sd, hist = _run_pair("gpt-tiny", False, schedule, S, V, 4, 4, metrics=True)
    for mref, m in hist:
        assert abs(mref["loss"] - m["loss"]) < 2e-3
        for k in ("edq", "update_norm", "grad_norm"):
            assert m[k] != 0.0 and abs(mref[k] - m[k]) <= 2e-3 * max(abs(mref[k]), 1e-6), \
                (k, mref[k], m[k])
        assert abs(mref["imprecision_pct"] - m["imprecision_pct"]) < 1e-2
    _assert_envelope(s, sd)
    # the virtual (V, S, L/(S·V), …) layout ravels to the canonical layer order
    if V > 1:
        g = sd.params["decoder"]["groups"][0]["sub0"]["wq"]
        assert tuple(g.shape[:3]) == (V, S, 4 // (S * V))
    LOSSES[schedule] = [m["loss"] for _, m in hist]
    if len(LOSSES) == 3:
        r = [round(x, 4) for x in LOSSES["gpipe"]]
        assert [round(x, 4) for x in LOSSES["1f1b"]] == r
        assert [round(x, 4) for x in LOSSES["interleaved"]] == r


def test_pipeline_1f1b_tied_embeddings():
    cfg = get_config("granite-3-2b", smoke=True)
    assert cfg.tie_embeddings
    s, sd, hist = _run_pair("granite-3-2b", True, "1f1b", 2, 1, 4, 4)
    for mref, m in hist:
        assert abs(mref["loss"] - m["loss"]) < 2e-3
    _assert_envelope(s, sd)


def test_pipeline_1f1b_moe_aux_rides_the_schedule():
    s, sd, hist = _run_pair("qwen3-moe-30b-a3b", True, "1f1b", 2, 1, 8, 8, comp="bf16_ef", B=8)
    for mref, m in hist:
        assert m["aux"] > 0
        assert abs(mref["loss"] - m["loss"]) < 3e-3
        assert abs(mref["aux"] - m["aux"]) < 1e-2 * abs(mref["aux"])


def test_pipeline_fp8_ef_residual_rows_per_stage():
    s, sd, hist = _run_pair("gpt-tiny", False, "1f1b", 4, 1, 4, 4, comp="fp8_ef")
    for mref, m in hist:
        assert abs(mref["loss"] - m["loss"]) < 2e-3
    assert set(sd.grad_err) == {"stage:bfloat16", "embed:bfloat16", "head:bfloat16"}
    rows = sd.grad_err["stage:bfloat16"]
    assert rows.shape[0] == 4 and rows.dtype == torch.float32
    assert float(rows.abs().max()) > 0 and not torch.equal(rows[0], rows[1])
    # rows of a stage that holds no embedding gradient flush through the
    # same reduce, and stay zero when there is nothing to flush
    assert float(sd.grad_err["embed:bfloat16"][1:].abs().max()) == 0.0


# --------------------------------------------------------------------------
# the legacy standalone GPipe (pipeline_apply) ≡ the sequential stack
# --------------------------------------------------------------------------

def test_pipeline_apply_matches_sequential():
    """The reference's test_pipeline_matches_sequential (which fails on this
    tree under its shard_map): L 8, D 16, 8 microbatches of 4, 4 stages;
    the output equals the JAX sequential stack's within 1e-5 and the
    gradient of Σ out² the sequential one within 1e-4, not S-fold."""
    import jax
    import jax.numpy as jnp

    L, D, n_micro, mb, S = 8, 16, 8, 4, 4
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((L, D, D)) * 0.1).astype(np.float32)
    x = rng.standard_normal((n_micro, mb, D)).astype(np.float32)

    def sequential(params, x):
        def body(h, w):
            return jnp.tanh(h @ w), None
        h, _ = jax.lax.scan(body, x.reshape(n_micro * mb, D), params["w"])
        return h.reshape(n_micro, mb, D)

    want = np.asarray(sequential({"w": jnp.asarray(w)}, jnp.asarray(x)))
    g_want = np.asarray(jax.grad(lambda p: jnp.sum(sequential(p, jnp.asarray(x)) ** 2))(
        {"w": jnp.asarray(w)})["w"])

    def stage_body(stage_params, h):
        for k in range(stage_params["w"].shape[0]):
            h = torch.tanh(h @ stage_params["w"][k])
        return h

    tw = torch.tensor(w, requires_grad=True)
    staged = pp.split_stages({"w": tw}, S)
    got = pp.pipeline_apply(stage_body, staged, torch.tensor(x))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5, atol=1e-5)
    (g,) = torch.autograd.grad(torch.sum(got ** 2), tw)
    np.testing.assert_allclose(g.numpy(), g_want, rtol=1e-4, atol=1e-4)
    # the stages on devices of their own (here all the CPU): the same values
    again = pp.pipeline_apply(stage_body, staged, torch.tensor(x), devices=["cpu"] * S)
    assert torch.equal(again, got)
    sched = pp.make_schedule("gpipe", n_stages=S, n_micro=n_micro)
    assert sched.stats()["bubble_fraction"] > 0

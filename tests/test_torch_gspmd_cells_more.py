"""The rest of the JAX package's production train cell on the port's
FSDP × TP grid, with tests/test_torch_gspmd_cells.py's cases and helpers,
on a (2, 2) grid of gloo ranks:

* the bucketed layout, granite bf16: fused C with fp8_ef, microbatches and
  ``donate`` (the new shards and residual rows written into the storage
  given), and with ``fsdp=False`` (buckets replicated over dp) under C
  with bf16_ef and remat "full", and SR: the update, residual rows
  included, bit-identical to the one-rank bucketed update of the same
  gradient, the step held to the port's one-rank bucketed step with the
  same flags at the bf16 rule (tests/test_torch_train.py and
  test_torch_compression.py hold that step to the JAX package's; the JAX
  bucketed step runs its Pallas kernel, in interpret mode here: minutes a
  step);
* the per-layer gathers: every ``all_gather_dim`` output of a parameter
  ("fsdp_gather", "tp_gather") recorded through a weakref, the gathered
  bytes alive at once never past two layers' worth plus the embedding and
  head, under remat "none", "full" and "dots", beside the up-front figure
  (every leaf gathered at the step's start, as before this slice);
* serving the frontends on the grid (``tp_mode`` "full", and seamless
  under "mlponly": its self- and cross-attention caches on the rank's
  heads), without and with sequence parallelism (``sp=True``): prefill
  and decode logits against the port's one-rank model (1e-5 in f32, 3e-2
  in bf16) and f32 greedy tokens equal; under sp the caches (seamless's
  cross-attention ones over all the memory's frames) within 1e-6 of
  sp=False's and 1e-5 of the one-rank port's;
* F6 (a divergence by design): the port's tree update fed the JAX step's
  f32 gradient of rwkv6 and jamba is bit-identical to the JAX update run
  op by op; the port's own gradient is within 1e-4 of each leaf's largest,
  and where its step parts from that update the gradient is near Adam's
  eps.
"""

import numpy as np
import pytest
import torch

import test_torch_gspmd_cells as C
from test_torch_gspmd_cells import (BF16_METRIC_RTOL, BUCKETED, F6_ARCHS, F6_GRAD_NEAR_EPS,
                                    GRANITE, LIVE, REMATS, SERVE, _cfg, _hold)


_RANKS = C._PRELUDE + """
import test_torch_gspmd_cells_more as M
SERVE_MODES = M.SERVE_MODES
# the bucketed layout (granite bf16, fused update)
model = build_model(T._cfg(T.GRANITE, "bfloat16"))
params = inp["params"]["bucketed"]
pad = sh.bucket_pad_multiple(g.axis("dp"), block=compression.BLOCK)
for name, (strat, flags) in T.BUCKETED.items():
    fsdp = flags.get("fsdp", True)
    comp = flags.get("grad_compression", "none")
    cdt, use_ef = compression.parse_spec(comp)
    opt = opt_of("bfloat16", strat, True, pad)
    rows = train_loop.init_state(model, opt, 0, grad_compression=comp,
                                 device="meta").opt_state.grad_err
    bp, bo = opt.init_bucketed(params)
    rows = None if rows is None else tuple(torch.zeros(r.shape, dtype=r.dtype) for r in rows)
    state = train_loop.TrainState(bp, dataclasses.replace(bo, grad_err=rows))
    kw = T._step_kw(flags)
    step = grid_lib.make_grid_train_step(model, opt, g, fsdp=fsdp, donate=flags.get("donate", False),
                                         **kw)
    loc = grid_lib.shard_state(state, g, fsdp)
    # the update of the grid's own gradient, against the one-rank update of it
    losses, grads = step.grads(loc.params, inp["batch"]["bucketed"])
    snap = grid_lib.shard_state(state, g, fsdp)
    p2, o2, _ = step.update(snap, grads)
    got = grid_lib.gather_state(train_loop.TrainState(p2, o2), state, g, fsdp)
    full_g = tuple(coll.all_gather(x, g.axis("dp")) for x in grads.data) if fsdp else grads.data
    want_p, want_o, _ = train_loop._apply_bucket_reduced(opt, full_g, bp, state.opt_state, cdt,
                                                         use_ef, None, 1)
    same = all(torch.equal(a, b) for (_, a), (_, b) in
               zip(sh.named_leaves(train_loop.TrainState(want_p, want_o)), sh.named_leaves(got)))
    # the whole step; donated: every shard written into the storage it was given
    ptrs = [x.data_ptr() for _, x in sh.named_leaves(loc)]
    new, m = step(loc, inp["batch"]["bucketed"])
    in_place = [x.data_ptr() for _, x in sh.named_leaves(new)] == ptrs
    full = grid_lib.gather_state(new, state, g, fsdp)
    r = {"metrics": {k: float(v) for k, v in m.items()}, "params": bucket_leaves(full.params),
         "bit_identical": same, "n": len(sh.named_leaves(got)), "in_place": in_place,
         "local_len": [int(x.numel()) for x in loc.params.data],
         "whole_len": [int(x.numel()) for x in bp.data],
         "err_rows": [tuple(x.shape) for x in (loc.opt_state.grad_err or ())]}
    if RANK == 0:
        s1, m1 = train_loop.make_train_step(model, opt, **kw)(state, inp["batch"]["bucketed"])
        r["one_rank"] = {"metrics": {k: float(v) for k, v in m1.items()},
                         "params": bucket_leaves(s1.params)}
    out[name] = r

# the per-layer gathers: the live bytes of parameter gathers
live, peak = [], [0]
_gather = coll.all_gather_dim

def recorded(x, axis, dim, role="fsdp_gather", back_role="fsdp_scatter"):
    y = _gather(x, axis, dim, role, back_role)
    if role in ("fsdp_gather", "tp_gather"):
        live.append(weakref.ref(y))
        live[:] = [w for w in live if w() is not None]
        peak[0] = max(peak[0], sum(w().numel() * w().element_size() for w in live))
    return y

coll.all_gather_dim = recorded
for name, (arch, over) in T.LIVE.items():
    cfg = T._cfg(arch, "float32", over)
    model = build_model(cfg)
    opt = opt_of("float32")
    params = inp["params"]["live_" + name]
    specs = sh.state_shardings(params, g)
    loc = grid_lib.shard_state(train_loop.TrainState(params, opt.init(params)), g)
    with torch.no_grad():              # the up-front figure: every leaf gathered at once
        upfront = sh.materialize(loc.params, specs, g, cfg.head_dim_)
    layer, head, total = {}, 0, 0
    for (p, a), (_, b) in zip(sh.named_leaves(upfront), sh.named_leaves(loc.params)):
        if a.numel() > b.numel():
            n = a.numel() * a.element_size()
            total += n
            if "['groups']" in p:
                grp = p[:p.index("['sub")]
                layer[grp] = layer.get(grp, 0) + n // a.shape[0]
            else:
                head += n
    del upfront
    r = {"layer": max(layer.values()), "head": head, "upfront": total}
    for remat in T.REMATS:
        live.clear()
        peak[0] = 0
        step = grid_lib.make_grid_train_step(model, opt, g, remat=remat)
        step(loc, inp["batch"]["live_" + name])
        r[remat] = peak[0]
    out["live_" + name] = r
coll.all_gather_dim = _gather

# serving the frontends (seamless also under mlponly: SERVE_MODES), without
# and with sequence parallelism (the prefill's positions over "model", the
# encoder's frames by their own count); in f32 the prefill's caches
for sname, mode in [(n, "full") for n in T.SERVE] + list(SERVE_MODES):
    arch, over = T.SERVE[sname]
    for dtype in ("bfloat16", "float32"):
        model = build_model(T._cfg(arch, dtype, over))
        params = inp["params"][f"serve_{sname}_{dtype}"]
        batch = inp["serve"][f"serve_{sname}_{dtype}"]
        pspecs = sh.state_shardings(params, g, tp_mode=mode)
        cspecs = sh.cache_shardings(model.init_decode_state(len(batch["tokens"]), T.CACHE,
                                                            device="meta").layers, g)
        for sp in (False, True):
            shd = sh.make_activation_sharder(g, sp=sp)
            with torch.no_grad(), tf.activation_sharding(shd):
                mp = sh.materialize_serving(sh.local_tree(params, pspecs, g), pspecs, g,
                                            model.cfg)
                lb = shd.local_batch(batch)
                coll.reset_census()
                logits, st = model.prefill(mp, lb, cache_len=T.CACHE)
                roles = sorted({c["role"] for c in coll.CENSUS})
                vocab = sh.P("data", None, "model") if logits.shape[-1] < model.cfg.vocab_size \\
                    else sh.P("data", None, None)
                r = {"prefill": np_(sh.gather_block(logits, vocab, g)), "roles": roles,
                     "split_after": [shd.seq, shd.mem_seq]}
                if dtype == "float32":
                    r["cache"] = leaves(sh.gather_tree(st.layers, cspecs, g))
                tok = sh.local_block(inp["next_tok"], sh.P("data", None), g)
                logits, st = model.decode_step(mp, st, tok)
                r["decode"] = np_(sh.gather_block(logits, vocab, g))
                if dtype == "float32":
                    gen, _ = model.generate(mp, lb, T.GEN)
                    r["generate"] = sh.gather_block(gen, sh.P("data", None), g).tolist()
            sfx = "_sp" if sp else ""
            if mode != "full":
                out[f"serve_{sname}_{mode}_{dtype}{sfx}"] = r
            elif sp:
                out[f"serve_{sname}_{dtype}{sfx}"] = r
            else:
                plain = r
        if mode != "full":
            continue
        if RANK == 0:
            with torch.no_grad():
                logits, st = model.prefill(params, batch, cache_len=T.CACHE)
                cache = [x.copy() for x in leaves(st.layers)]    # the decode writes in place
                plain["one_rank"] = {"prefill": np_(logits), "cache": cache,
                                     "decode": np_(model.decode_step(params, st,
                                                                     inp["next_tok"])[0])}
                if dtype == "float32":
                    plain["one_rank"]["generate"] = model.generate(params, batch,
                                                                   T.GEN)[0].tolist()
        out[f"serve_{sname}_{dtype}"] = plain

if RANK == 0:
    pickle.dump(out, open("out.pkl", "wb"))
dist.destroy_process_group()
"""


# F6 in a process an arch
JAX_REFS = [("f6", arch) for arch in F6_ARCHS]
# (SERVE case, tp_mode) served besides under "full": seamless's self- and
# cross-attention on the rank's heads (its KV 4 over model 2), the encoder
# whole (it has no cache), held to the same one-rank references
SERVE_MODES = [("seamless", "mlponly")]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(what the grid computed, the JAX references, the ranks' inputs)."""
    cfgs = {"bucketed": _cfg(GRANITE, "bfloat16")}
    cfgs.update({"live_" + n: _cfg(a, "float32", o) for n, (a, o) in LIVE.items()})
    cfgs.update({"f6_" + a: _cfg(a, "float32") for a in F6_ARCHS})
    inputs = C._inputs(cfgs, serve=SERVE)
    return (*C._run(tmp_path_factory, "gspmd_cells_more", _RANKS, JAX_REFS, inputs), inputs[1])


@pytest.mark.parametrize("name", list(BUCKETED))
def test_bucketed_cell(runs, name):
    """The bucketed update (residual rows included) bit-identical to the
    one-rank bucketed update of the same gradient; the step held to the
    one-rank bucketed step with the same flags; the donated step writes
    every shard into the storage it was given; without FSDP every rank
    holds the whole buckets."""
    got = runs[0][name]
    _, flags = BUCKETED[name]
    assert got["bit_identical"] and got["n"] >= 3
    _hold(got, got["one_rank"], "bfloat16", BF16_METRIC_RTOL)
    if flags.get("fsdp", True):
        assert [2 * n for n in got["local_len"]] == got["whole_len"]
        if flags.get("grad_compression"):
            assert all(2 * s[1] in got["whole_len"] for s in got["err_rows"])
    else:
        assert got["local_len"] == got["whole_len"]
    assert got["in_place"] == bool(flags.get("donate"))

@pytest.mark.parametrize("remat", REMATS)
@pytest.mark.parametrize("name", list(LIVE))
def test_per_layer_gathers_bound_live_bytes(runs, name, remat):
    """The gathered parameter bytes alive at once on a rank never pass two
    layers' worth plus the embedding and head, whatever the remat mode; the
    up-front gathers held them all."""
    r = runs[0]["live_" + name]
    bound = 2 * r["layer"] + r["head"]
    print(f"{name} remat {remat}: live gathered peak {r[remat]} B, bound {bound} B (layer "
          f"{r['layer']}, embedding and head {r['head']}), up-front {r['upfront']} B")
    assert 0 < r[remat] <= bound < r["upfront"]

@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("name", list(SERVE))
def test_frontend_serving_matches_one_rank(runs, name, kind, dtype):
    r = runs[0][f"serve_{name}_{dtype}"]
    tol = 3e-2 if dtype == "bfloat16" else 1e-5
    np.testing.assert_allclose(r[kind], r["one_rank"][kind], rtol=tol, atol=tol)


@pytest.mark.parametrize("name", list(SERVE))
def test_frontend_greedy_generate_matches_one_rank(runs, name):
    r = runs[0][f"serve_{name}_float32"]
    assert r["generate"] == r["one_rank"]["generate"]


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("name,mode", SERVE_MODES)
def test_frontend_serving_under_tp_mode_matches_one_rank(runs, name, mode, kind, dtype):
    """The cross-attention caches on the rank's heads: prefill and decode
    logits against the port's one-rank model (1e-5 in f32, 3e-2 in
    bf16)."""
    r = runs[0][f"serve_{name}_{mode}_{dtype}"]
    tol = 3e-2 if dtype == "bfloat16" else 1e-5
    np.testing.assert_allclose(r[kind], runs[0][f"serve_{name}_{dtype}"]["one_rank"][kind],
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("name,mode", SERVE_MODES)
def test_frontend_greedy_generate_under_tp_mode_matches_one_rank(runs, name, mode):
    r = runs[0][f"serve_{name}_{mode}_float32"]
    assert r["generate"] == runs[0][f"serve_{name}_float32"]["one_rank"]["generate"]

# The grid's f32 prefill caches against the one-rank port's: the encoder's
# and the projections' partial sums over "model" in another order read up
# to 2.0e-6 from one rank's without sequence parallelism too; a cache of a
# rank's block of the memory, or of the wrong positions, reads O(1)
CACHE_ONE_RANK_TOL = 1e-5
# (SERVE case, tp_mode) served with sequence parallelism
SP_SERVE = [(n, "full") for n in SERVE] + SERVE_MODES


def _sp_key(name, mode, dtype):
    return f"serve_{name}_" + ("" if mode == "full" else mode + "_") + f"{dtype}_sp"


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("name,mode", SP_SERVE)
def test_frontend_sequence_parallel_serving_matches_one_rank(runs, name, mode, kind, dtype):
    """With ``sp=True`` (seamless's 8 frames and 16 positions, internvl2's
    8 patches + 16 positions over "model"): prefill and the decode step
    after it against the port's one-rank model (1e-5 in f32, 3e-2 in
    bf16), and in f32 within 1e-5 of sp=False's; greedy tokens equal."""
    r = runs[0][_sp_key(name, mode, dtype)]
    want = runs[0][f"serve_{name}_{dtype}"]["one_rank"][kind]
    tol = 3e-2 if dtype == "bfloat16" else 1e-5
    np.testing.assert_allclose(r[kind], want, rtol=tol, atol=tol)
    if dtype == "float32":
        tp = runs[0][f"serve_{name}_float32" if mode == "full" else
                     f"serve_{name}_{mode}_float32"]
        np.testing.assert_allclose(r[kind], tp[kind], rtol=1e-5, atol=1e-5)
        assert r["generate"] == tp["generate"] == \
            runs[0][f"serve_{name}_float32"]["one_rank"]["generate"]


@pytest.mark.parametrize("name,mode", SP_SERVE)
def test_frontend_sequence_parallel_caches_hold_the_whole_memory(runs, name, mode):
    """F8's gate: after a prefill with sp=True each rank's caches (seamless's
    cross-attention K/V: all F frames of the memory, not a rank's block),
    gathered over their heads, hold the one-rank port's shapes, within
    1e-6 of sp=False's and ``CACHE_ONE_RANK_TOL`` of the one-rank port's in
    f32; the prefill's boundary sums are reduce-scattered over the
    sequence, and no split outlives it."""
    r = runs[0][_sp_key(name, mode, "float32")]
    tp = runs[0][f"serve_{name}_" + ("" if mode == "full" else mode + "_") + "float32"]
    want = runs[0][f"serve_{name}_float32"]["one_rank"]["cache"]
    assert len(r["cache"]) == len(tp["cache"]) == len(want) > 0
    for a, b, c in zip(r["cache"], tp["cache"], want):
        assert a.shape == b.shape == c.shape
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(a, c, rtol=CACHE_ONE_RANK_TOL, atol=CACHE_ONE_RANK_TOL)
    assert {"sp_gather", "sp_scatter"} <= set(r["roles"]) and "tp_reduce" not in r["roles"]
    assert r["split_after"] == [False, False]


@pytest.mark.parametrize("arch", F6_ARCHS)
def test_f6_update_bit_identical_on_the_jax_gradient(runs, arch):
    """F6 (a divergence by design): fed the JAX step's f32 gradient, the
    port's tree C update equals the JAX update run op by op, every leaf
    bit for bit. The port's own step parts from it only where the two
    gradients (each within 1e-4 of its leaf's largest element) are near
    Adam's eps, so that lr·g/(|g| + eps) moves by up to lr on a difference
    in the last bits."""
    from repro_torch.core import bucketing
    from repro_torch.core.collage import CollageAdamW
    from repro_torch.core.precision import PrecisionPolicy, Strategy
    from repro_torch.models.model import build_model
    from repro_torch.train import train_loop

    _, refs, inputs = runs
    ref = refs["f6_" + arch]
    params = inputs["params"]["f6_" + arch]
    opt = CollageAdamW(1e-3, b2=0.95, compute_metrics=True,
                       policy=PrecisionPolicy(strategy=Strategy.C_COLLAGE_PLUS,
                                              param_dtype=torch.float32))
    skel = bucketing.tree_flatten_with_path(params)[1]
    grads = bucketing.tree_unflatten(skel, [torch.from_numpy(x) for x in ref["grads"]])
    new, _, _ = opt.step(grads, params, opt.init(params))
    got = [x.numpy() for x in bucketing.tree_leaves(new)]
    assert len(got) == len(ref["params"]) > 10
    for a, b in zip(got, ref["params"]):
        np.testing.assert_array_equal(a, b)
    batch = inputs["batch"]["f6_" + arch]
    model = build_model(_cfg(arch, "float32"))
    _, _, own_g = train_loop.make_accum_grads(model)(params, batch)
    own, _, _ = opt.step(own_g, params, opt.init(params))
    for a, b, ga, gb in zip(bucketing.tree_leaves(own), ref["params"],
                            bucketing.tree_leaves(own_g), ref["grads"]):
        ga = ga.numpy()
        assert np.abs(ga - gb).max() <= 1e-4 * np.abs(gb).max()
        parted = np.abs(a.numpy() - b) > 1e-4
        assert (np.abs(gb[parted]) < F6_GRAD_NEAR_EPS).all()


def test_remat_recompute_sees_the_grid_sharder_on_another_thread():
    """The backward may recompute a rematerialised layer on the autograd
    engine's device thread, which does not see the calling thread's
    ``activation_sharding`` (on the card the row-parallel products then took
    the one-rank path in the recompute): the layer body installs the grid's
    sharder itself. Here the backward runs on a thread of its own, and the
    recompute must pass through the sharder as the forward did."""
    import threading

    from repro_torch.distributed import sharding as sh
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import transformer as tf
    from repro_torch.models.model import build_model, param_dict

    class Counting(sh.GridSharder):
        calls = 0

        def __call__(self, x, kind="seq", tp=False):
            Counting.calls += 1
            return super().__call__(x, kind, tp=tp)

    model = build_model(_cfg(GRANITE, "float32"))
    leaves = {k: v for k, v in sh.named_leaves(param_dict(model.init(0, device="cpu")))}
    params = sh.map_leaves(lambda path, x: leaves[path].detach().requires_grad_(True),
                           param_dict(model.init(device="meta")))
    toks = torch.zeros((2, 8), dtype=torch.int64)
    with tf.activation_sharding(Counting(mesh_lib.grid_shape(1, 1))):
        loss, _ = model.loss(params, {"tokens": toks, "labels": toks}, remat="full")
    forward = Counting.calls
    out = {}
    thread = threading.Thread(target=lambda: out.update(
        g=torch.autograd.grad(loss, [x for _, x in sh.named_leaves(params)])))
    thread.start()
    thread.join()
    assert "g" in out and forward > 0
    assert Counting.calls > forward                 # the recompute called it too

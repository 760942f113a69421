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
* serving the frontends on the grid (``tp_mode`` "full"): prefill and
  decode logits against the port's one-rank model (1e-5 in f32, 3e-2 in
  bf16) and f32 greedy tokens equal;
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

# serving the frontends
for sname, (arch, over) in T.SERVE.items():
    for dtype in ("bfloat16", "float32"):
        model = build_model(T._cfg(arch, dtype, over))
        params = inp["params"][f"serve_{sname}_{dtype}"]
        batch = inp["serve"][f"serve_{sname}_{dtype}"]
        pspecs = sh.state_shardings(params, g)
        shd = sh.make_activation_sharder(g)
        with torch.no_grad(), tf.activation_sharding(shd):
            mp = sh.materialize(sh.local_tree(params, pspecs, g), pspecs, g, model.cfg.head_dim_)
            lb = shd.local_batch(batch)
            logits, st = model.prefill(mp, lb, cache_len=T.CACHE)
            vocab = sh.P("data", None, "model") if logits.shape[-1] < model.cfg.vocab_size \\
                else sh.P("data", None, None)
            r = {"prefill": np_(sh.gather_block(logits, vocab, g))}
            tok = sh.local_block(inp["next_tok"], sh.P("data", None), g)
            logits, st = model.decode_step(mp, st, tok)
            r["decode"] = np_(sh.gather_block(logits, vocab, g))
            if dtype == "float32":
                gen, _ = model.generate(mp, lb, T.GEN)
                r["generate"] = sh.gather_block(gen, sh.P("data", None), g).tolist()
        if RANK == 0:
            with torch.no_grad():
                logits, st = model.prefill(params, batch, cache_len=T.CACHE)
                r["one_rank"] = {"prefill": np_(logits),
                                 "decode": np_(model.decode_step(params, st, inp["next_tok"])[0])}
                if dtype == "float32":
                    r["one_rank"]["generate"] = model.generate(params, batch, T.GEN)[0].tolist()
        out[f"serve_{sname}_{dtype}"] = r

if RANK == 0:
    pickle.dump(out, open("out.pkl", "wb"))
dist.destroy_process_group()
"""


# F6 in a process an arch
JAX_REFS = [("f6", arch) for arch in F6_ARCHS]


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

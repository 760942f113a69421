"""The port's audit (repro_torch.analysis, launch.precision_audit) against
the JAX train step's output state, and the passes' teeth.

* Census: the TrainState one port step returns, leaf for leaf (keystr
  name, dtype, shape, bytes), equals the leaves of the JAX step's output
  state from ``jax.eval_shape`` (gpt-tiny smoke, all seven strategies on
  the tree layout, bucketed C and SR), and holds Paper Table 2's bytes a
  parameter less the 2-byte gradient; D and D⁻ hold 12 and 8 B/param of
  f32 state. The JAX package's own audit is not the reference: its
  precision-flow pass finds no result names on this jax (ROADMAP R1).
* The one-rank sharded cells: ``flat`` and ``zero`` equal the JAX sharded
  engine's output state on a one-device mesh; the ``pipeline`` cells hold
  the ``flat`` cell's bytes by dtype.
* Teeth: C certifies, D is caught by name, an injected f32 leaf is caught,
  scalars and ``allow_names`` are exempt, a donated bucket written to a
  fresh tensor is caught, a bf16→f32→reshape→bf16 chain is one double
  rounding (none with arithmetic between), a known sequence's modelled
  peak is exact, the trace's FLOPs equal ``FlopCounterMode``'s.
* The cost model's pure arithmetic equals the JAX functions; the lint's
  fixtures; the audit script's ``--quick --device cpu`` report.
"""

import json
import textwrap

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jcfg
from repro.configs.base import ShapeConfig as JShape
from repro.core.collage import CollageAdamW as JAdamW
from repro.core.precision import BucketPolicy as JBucket
from repro.core.precision import BYTES_PER_PARAM as J_BYTES
from repro.core.precision import PrecisionPolicy as JPolicy
from repro.core.precision import parse_strategy as jparse
from repro.models.model import build_model as jbuild
from repro.train import train_loop as jtl
from repro_torch.analysis import (MASTER_COPY_STRATEGIES, analyze_precision_flow,
                                  assert_donation_realized, assert_no_master_copy, audit_cell,
                                  census, check_donation, donated_storages, is_sixteen_bit,
                                  lint_file, lint_paths, peak_hbm, record_step, recording)
from repro_torch.analysis import cost_model
from repro_torch.analysis.trace import KernelCall, _flops
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.collage import CollageAdamW, CollageOptState
from repro_torch.core.precision import BucketPolicy, PrecisionPolicy, parse_strategy
from repro_torch.data.synthetic import make_batch_fn
from repro_torch.launch import precision_audit
from repro_torch.models.model import build_model
from repro_torch.train import train_loop

STRATEGIES = ("A", "B", "C", "KAHAN", "SR", "D-MW", "D")
CELLS = [(s, False) for s in STRATEGIES] + [("C", True), ("SR", True)]
SHAPE = ("t", 16, 2, "train")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_step(strategy, bucketed, donate=False, trace=True):
    """(state after one port step, its trace (None without ``trace``), the
    input's donated storages)."""
    cfg = get_config("gpt-tiny", smoke=True)
    model = build_model(cfg)
    opt = CollageAdamW(1e-4, policy=PrecisionPolicy(strategy=parse_strategy(strategy),
                                                    bucketing=BucketPolicy(enabled=bucketed)))
    state = train_loop.init_state(model, opt, 0, device="cpu")
    step = train_loop.make_train_step(model, opt, donate=donate)
    donated = donated_storages(state, donate)
    batch = make_batch_fn(cfg, ShapeConfig(*SHAPE), device="cpu")(0)
    if not trace:
        return step(state, batch)[0], None, donated
    (state, _), tr = record_step(step, state, batch, device="cpu")
    return state, tr, donated


def _jax_leaves(out) -> list:
    return [(jax.tree_util.keystr(p), str(x.dtype), tuple(x.shape),
             int(np.prod(x.shape, dtype=np.int64)) * x.dtype.itemsize)
            for p, x in jax.tree_util.tree_flatten_with_path(out)[0]]


def _port_leaves(rep) -> list:
    return [(x["name"], x["dtype"], x["shape"], x["bytes"]) for x in rep["leaves"]]


@pytest.mark.parametrize("strategy,bucketed", CELLS)
def test_census_equals_the_jax_steps_output_state(strategy, bucketed):
    model = jbuild(jcfg("gpt-tiny", smoke=True))
    opt = JAdamW(1e-4, policy=JPolicy(strategy=jparse(strategy),
                                      bucketing=JBucket(enabled=bucketed)))
    st = jax.eval_shape(lambda: jtl.init_state(model, opt, jax.random.PRNGKey(0)))
    out, _ = jax.eval_shape(jtl.make_train_step(model, opt), st,
                            model.input_specs(JShape(*SHAPE)))
    state, _, _ = _port_step(strategy, bucketed, trace=False)
    rep = census(state)
    assert _port_leaves(rep) == _jax_leaves(out)
    want = J_BYTES[jparse(strategy)] - 2
    if bucketed:
        padded = state.params.layout.buckets[0].padded
        assert rep["bytes_per_param"] * rep["n_params"] == pytest.approx(want * padded, rel=1e-12)
    else:
        assert rep["bytes_per_param"] == want
    assert rep["f32_bytes_per_param"] == {"D-MW": 8, "D": 12}.get(strategy, 0)
    assert rep["no_master_copy"] == (strategy not in ("D-MW", "D"))


def _jax_sharded_out(bucketed, comp):
    from repro.distributed import compression as jcomp
    from repro.distributed import sharding as jshard
    from repro.train import sharded as jsh
    model = jbuild(jcfg("gpt-tiny", smoke=True))
    mesh = jax.make_mesh((1,), ("data",))
    bp = JBucket(enabled=True, pad_multiple=jshard.bucket_pad_multiple(
        mesh, block=jcomp.BLOCK)) if bucketed else JBucket()
    opt = JAdamW(1e-4, b2=0.95, weight_decay=0.1,
                 policy=JPolicy(strategy=jparse("C"), bucketing=bp))
    st = jax.eval_shape(lambda: jsh.init_state(model, opt, jax.random.PRNGKey(0), mesh,
                                               axis="data", grad_compression=comp))
    ssh = jsh.named_shardings(st, jsh.state_pspecs(st, axis="data", zero_shard=bucketed), mesh)
    batch = jax.tree_util.tree_map(
        lambda x: jax.ShapeDtypeStruct((8,) + (x.shape[0] // 8,) + x.shape[1:], x.dtype),
        model.input_specs(JShape("train_smoke", 128, 32, "train")))
    bsh = jsh.named_shardings(batch, jsh.batch_pspecs(batch, axis="data"), mesh)
    step = jsh.make_sharded_train_step(model, opt, mesh, axis="data", remat="full",
                                       grad_compression=comp, zero_shard=bucketed, jit=False)
    jitted = jax.jit(step, in_shardings=(ssh, bsh), out_shardings=(ssh, None),
                     donate_argnums=(0,))
    return jax.eval_shape(jitted, st, batch)[0]


def _cell_state(mode, strategy="C"):
    _, step, init, batches, donate, meta = precision_audit.build_cell(
        "gpt-tiny", strategy, precision_audit.MODES[mode], "cpu")
    state = init()
    donated = donated_storages(state, donate)
    return step(state, batches[0])[0], donated, meta


@pytest.mark.parametrize("mode", ["flat", "zero"])
def test_one_rank_sharded_cells_equal_the_jax_sharded_engine(mode):
    """The engine at one rank (``sharded.Mesh()``, ZeRO forced on in the
    zero cell) returns the JAX sharded engine's state on a one-device mesh,
    residual rows included; the zero cell is donated, every bucket in place."""
    state, donated, meta = _cell_state(mode)
    assert meta["grad_accum"] == 8 and meta["zero_shard"] == (mode == "zero")
    out = _jax_sharded_out(mode == "zero", precision_audit.MODES[mode]["compress"])
    rep = census(state)
    assert _port_leaves(rep) == _jax_leaves(out)
    assert rep["no_master_copy"]
    don = check_donation(donated, state)
    if mode == "zero":
        assert [x["name"] for x in rep["leaves"] if x["role"] == "grad_err"] == \
            [".opt_state.grad_err[0]"]
        assert don["n_donated"] == 6 and don["all_donations_realized"], don
    else:
        assert don["n_donated"] == 0 and don["all_donations_realized"]


@pytest.fixture(scope="module")
def quick_report(tmp_path_factory):
    """The audit script's ``--quick --device cpu`` report (gpt-tiny's 8 cells)."""
    out = tmp_path_factory.mktemp("audit") / "audit.json"
    assert precision_audit.main(["--quick", "--device", "cpu", "--out", str(out)]) == 0
    return json.loads(out.read_text())


@pytest.mark.parametrize("mode", ["pipeline", "pipeline_1f1b"])
def test_pipeline_cells_hold_the_flat_cells_bytes(mode, quick_report):
    """Two stages on devices of the one rank, 4 microbatches: the state the
    schedule's step returns holds the flat cell's bytes, dtype by dtype."""
    cells = quick_report["cells"]
    pipe, flat = cells[f"gpt-tiny/C/{mode}"], cells["gpt-tiny/C/flat"]
    assert pipe["grad_accum"] == 4 and pipe["pipeline_axis"] == "pipe"
    assert pipe["schedule"] == ("1f1b" if mode == "pipeline_1f1b" else "gpipe")
    assert pipe["n_backward_ops"] > 0 and pipe["ok"]["no_master_copy"]

    def by_dtype(cell):
        out: dict = {}
        for d in cell["state_by_role"].values():
            for dt, b in d.items():
                out[dt] = out.get(dt, 0) + b
        return out
    assert by_dtype(pipe) == by_dtype(flat) == {"bfloat16": 1313920, "int32": 4}


# ----------------------------------------------------------------- teeth

def test_collage_certifies_and_d_is_caught_by_name():
    state, trace, _ = _port_step("C", False)
    rep = analyze_precision_flow(trace, state, sixteen_bit=True)
    assert rep["no_master_copy"] and rep["double_round_chains"] == 0
    assert rep["transient_param_shaped_f32"] > 0          # the strict-FPU f32 update
    assert_no_master_copy(rep, "C")
    state, trace, _ = _port_step("D", False)
    rep = analyze_precision_flow(trace, state, sixteen_bit=False)
    names = [x["name"] for x in rep["param_f32_persistent"]]
    assert ".opt_state[<flat index 4>]['embed']" in names and len(names) == 30
    assert {x["role"] for x in rep["param_f32_persistent"]} == {"m", "v", "master"}
    assert rep["by_role"]["master"] == {"float32": 131392 * 4}
    assert_no_master_copy(rep, "D (declared mixed)")               # D is allowed its copy
    with pytest.raises(AssertionError, match="master copy"):
        assert_no_master_copy(analyze_precision_flow(trace, state, sixteen_bit=True), "D")
    # D⁻ keeps f32 moments (no master role) and is not a (16,16) strategy
    assert [is_sixteen_bit(s) for s in STRATEGIES] == [True] * 5 + [False] * 2
    assert MASTER_COPY_STRATEGIES == ("D",)


def test_injected_f32_leaf_is_caught_and_scalars_and_allow_names_are_exempt():
    state, _, _ = _port_step("C", False)

    def step_with_f32_m(s):
        m = dict(s.opt_state.m)
        m["embed"] = m["embed"].to(torch.float32)
        return train_loop.TrainState(s.params, type(s.opt_state)(
            s.opt_state.step, m, s.opt_state.v, s.opt_state.delta, s.opt_state.master,
            s.opt_state.rng), s.grad_err)
    bad = census(step_with_f32_m(state))
    assert [x["name"] for x in bad["param_f32_persistent"]] == \
        [".opt_state[<flat index 1>]['embed']"]
    assert not bad["no_master_copy"]
    assert census(step_with_f32_m(state), allow_names=("['embed']",))["no_master_copy"]
    # an f32 leaf below min_numel (the final norm's 64 elements) is a scalar-sized exemption
    state, _, _ = _port_step("D-MW", False)
    rep = census(state)
    assert not any("final_norm" in x["name"] for x in rep["param_f32_persistent"])
    assert all(x["role"] != "scalar" for x in rep["param_f32_persistent"])
    scal = [x for x in rep["leaves"] if x["role"] == "scalar"]
    assert [x["name"] for x in scal] == [".opt_state[<flat index 0>]"]


def test_donation_catches_a_bucket_written_to_a_fresh_tensor():
    state, _, donated = _port_step("C", True, donate=True)
    rep = check_donation(donated, state)
    assert rep["n_donated"] == 5 and rep["all_donations_realized"], rep
    assert_donation_realized(rep)
    cfg = get_config("gpt-tiny", smoke=True)
    model = build_model(cfg)
    opt = CollageAdamW(1e-4, policy=PrecisionPolicy(bucketing=BucketPolicy(enabled=True)))
    step = train_loop.make_train_step(model, opt, donate=True)

    def leaky(s, b):
        s, m = step(s, b)
        o = s.opt_state
        return train_loop.TrainState(s.params, type(o)(
            o.step, (o.m[0].clone(),), o.vhi, o.vlo, o.delta, o.master, o.rng, o.layout,
            o.grad_err), s.grad_err), m
    s0 = train_loop.init_state(model, opt, 0, device="cpu")
    donated = donated_storages(s0, True)
    s1, _ = leaky(s0, make_batch_fn(cfg, ShapeConfig(*SHAPE), device="cpu")(0))
    rep = check_donation(donated, s1)
    nbytes = s1.opt_state.m[0].numel() * 2
    assert rep["unrealized"] == [{"name": ".opt_state.m[0]", "bytes": nbytes}]
    with pytest.raises(AssertionError, match="NOT written in place"):
        assert_donation_realized(rep)
    assert check_donation(donated_storages(s0, False), s1)["n_donated"] == 0


def test_double_round_chains():
    x = torch.randn(4, 32).to(torch.bfloat16)
    with recording("cpu", x) as t1:
        x.to(torch.float32).reshape(128).to(torch.bfloat16)
    with recording("cpu", x) as t2:
        (x.to(torch.float32) * 2.0).reshape(128).to(torch.bfloat16)
    with recording("cpu", x) as t3:
        x.to(torch.float32).permute(1, 0).contiguous().to(torch.bfloat16)
    count = lambda t: analyze_precision_flow(t, _tiny_state(), sixteen_bit=True)
    assert count(t1)["double_round_chains"] == 1
    assert count(t2)["double_round_chains"] == 0
    r3 = count(t3)
    assert r3["double_round_chains"] == 1 and r3["widening_converts"] == 1
    assert "test_torch_audit" not in r3["double_round_samples"][0]     # port frames only


def _tiny_state():
    w = {"w": torch.zeros(2, dtype=torch.bfloat16)}
    return train_loop.TrainState(w, CollageOptState(0, w, w, None, None, None))


def test_modelled_peak_of_a_known_sequence_is_exact():
    x = torch.zeros(100, dtype=torch.float32)                # an input: 400 B from the start
    with recording("cpu", x) as t:
        a = torch.empty(1000, dtype=torch.float32)            # 4000
        b = a.view(10, 100)                                   # a view: no bytes
        c = torch.empty(500, dtype=torch.bfloat16)            # 1000 → 5400 live
        del a, b
        d = torch.empty(200, dtype=torch.float64)             # 1600 → 400 + 1000 + 1600
        e = x + 1.0                                           # 400
        del c, d, e
    live = peak_hbm(t)
    assert live["param_bytes"] == 400 and live["peak_bytes_modeled"] == 5400
    assert live["end_bytes_modeled"] == 400
    assert [s.input for s in t.storages].count(True) == 1


def test_trace_flops_equal_flop_counter_and_hold_the_backward():
    from torch.utils.flop_counter import FlopCounterMode
    state, trace, _ = _port_step("C", True)
    trace.require_backward()
    assert trace.n_backward_ops > 100
    cfg = get_config("gpt-tiny", smoke=True)
    model = build_model(cfg)
    opt = CollageAdamW(1e-4, policy=PrecisionPolicy(bucketing=BucketPolicy(enabled=True)))
    with FlopCounterMode(display=False) as fc:
        train_loop.make_train_step(model, opt)(state, make_batch_fn(
            cfg, ShapeConfig(*SHAPE), device="cpu")(1))
    assert trace.flops() == fc.get_total_flops() > 0
    a, b, out = torch.ones(2, 3, 4), torch.ones(2, 4, 5), torch.empty(2, 3, 5)
    assert _flops(torch.ops.aten.bmm.dtype, (a, b, torch.float32), {}, out) \
        == _flops(torch.ops.aten.bmm.default, (a, b), {}, out) == 2 * 2 * 3 * 4 * 5
    with recording("cpu") as t:
        torch.ones(3) * 2
    with pytest.raises(RuntimeError, match="backward"):
        t.require_backward()


def test_audit_cell_and_cost_model_on_a_traced_step():
    state, trace, donated = _port_step("SR", True, donate=True)
    cell = audit_cell(trace, state, strategy="SR", donated=donated)
    assert cell["ok"] == {"no_master_copy": True, "all_donations_realized": True}
    cost = cell["cost"]
    assert cost["flops"] == trace.flops() and cost["serial_collective_s"] == 0.0
    assert cost["modeled_step_s"] >= max(cost["serial_compute_s"], cost["serial_memory_s"])
    assert cost["hw"].startswith("NVIDIA H100")
    assert cell["liveness"]["peak_bytes_measured"] is None
    trace.kernels = [KernelCall("collage_bucket_update", {"n": 132096, "code": "C"}),
                     KernelCall("flash_fwd", dict(B=8, H=12, Hkv=12, L=512, dh=64,
                                                  causal=True, window=0))]
    k = cost_model.model_step(trace)
    assert k["kernels_s"] * 1e3 == pytest.approx(
        cost_model.update_bound_ms(132096, "C")[0]
        + cost_model.attention_bound_ms(8, 12, 12, 512, 64, True, 0)[0])
    wire = cost_model.model_step(trace, census=[{"bytes": 1000}], n_dp=4)
    assert wire["wire_bytes"] == 750 and wire["serial_collective_s"] == 750 / 450e9


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_chunked_leaf_update_is_bit_identical(strategy, monkeypatch):
    """The repair of the tree step's peak: leaves past ``collage.LEAF_CHUNK``
    elements are updated in flat chunks (a ragged last one here: 8192 =
    2·3000 + 2192); params, state and metrics equal the whole-leaf step's
    bits over 3 steps, SR's noise indexed by the element's place in its
    leaf."""
    from repro_torch.core import bucketing
    from repro_torch.core import collage as tcollage

    gen = torch.Generator().manual_seed(5)
    shapes = {"a": (64, 128), "b": [(300,), (7, 5)]}
    draw = lambda sh, s: (torch.randn(sh, generator=gen) * s).to(torch.bfloat16)
    params = {"a": draw(shapes["a"], 0.05), "b": [draw(sh, 0.05) for sh in shapes["b"]]}
    grads = [{"a": draw(shapes["a"], 1e-2), "b": [draw(sh, 1e-2) for sh in shapes["b"]]}
             for _ in range(3)]

    def run(chunk):
        monkeypatch.setattr(tcollage, "LEAF_CHUNK", chunk)
        opt = CollageAdamW(1e-3, b2=0.95, weight_decay=0.1, compute_metrics=True, sr_seed=7,
                           policy=PrecisionPolicy(strategy=parse_strategy(strategy)))
        p, st, ms = params, opt.init(params), []
        for g in grads:
            p, st, m = opt.step(g, p, st)
            ms.append([float(x) for x in m])
        leaves = bucketing.tree_leaves(p)
        for role in (st.m, st.v, st.delta, st.master):
            if role is not None:
                for x in bucketing.tree_leaves(role):
                    leaves += [x.hi, x.lo] if hasattr(x, "hi") else [x]
        return leaves, ms

    whole, whole_m = run(1 << 40)
    chunked, chunked_m = run(3000)
    assert chunked_m == whole_m
    assert len(whole) == len(chunked)
    for a, b in zip(whole, chunked):
        assert a.dtype == b.dtype and torch.equal(a.view(torch.uint8), b.view(torch.uint8))


# ---------------------------------------------------------- arithmetic

def test_overlap_comm_and_schedule_cost_equal_the_jax_functions():
    from repro.analysis import cost_model as jcm
    from repro.distributed import pipeline as jpp
    events = [(0.5, 1.0, "stage"), (0.7, 0.25, "embed"), (3.0, 0.5, "head")]
    assert cost_model.overlap_comm(events, 2.5) == jcm.overlap_comm(events, 2.5)
    for name, S, M, V in (("gpipe", 4, 8, 1), ("1f1b", 4, 8, 1), ("interleaved", 2, 8, 2)):
        stats = jpp.make_schedule(name, n_stages=S, n_micro=M, n_virtual=V).stats()
        comm = {k: 0.1 * (i + 1) for i, k in enumerate(sorted(stats["comm_ready"]))}
        for kw in ({}, {"fwd_unit_s": 0.3, "bwd_unit_s": 0.7, "comm_cost_s": comm}):
            assert cost_model.schedule_cost(stats, **kw) == jcm.schedule_cost(stats, **kw)
    assert "197e12" not in open(cost_model.__file__).read()


# ----------------------------------------------------------------- lint

def test_lint_fixtures(tmp_path):
    src = textwrap.dedent("""\
        import numpy as np
        import torch
        a = x.float()
        b = x.double()
        c = x.to(torch.float32)
        d = x.to(dtype=torch.float64)
        e = x.type(torch.float32)
        f = torch.zeros(3, dtype=np.float32)
        g = torch.ones(3, dtype="float32")
        h = x.to(torch.float)
        i = x.float()  # f32-ok: a reason
        # f32-ok: the line below
        j = x.to(torch.float32)
        k = x.to(torch.bfloat16)
        l = x.half()
        m = torch.zeros(3, dtype=torch.bfloat16)
        n = x.to(torch.float32)
    """)
    p = tmp_path / "fixture.py"
    p.write_text(src)
    found = [(f["line"], f["code"]) for f in lint_file(str(p))]
    assert found == [(3, "f32-method"), (4, "f32-method"), (5, "to-f32"), (6, "f32-dtype-arg"),
                     (7, "type-f32"), (8, "f32-dtype-arg"), (9, "f32-dtype-arg"),
                     (10, "to-f32"), (17, "to-f32")]
    (tmp_path / "bad.py").write_text("def (:\n")
    assert lint_file(str(tmp_path / "bad.py"))[0]["code"] == "syntax-error"


def test_lint_is_clean_on_the_port():
    import pathlib
    repo = pathlib.Path(__file__).resolve().parents[1]
    assert lint_paths(repo_root=str(repo)) == []


# --------------------------------------------------------- audit script

def test_audit_script_quick_on_the_cpu_passes_every_flag(quick_report):
    rep = quick_report
    assert rep["n_cells"] == 8 and all(rep["ok"].values()), rep["ok"]
    assert set(rep["ok"]) == {"no_master_copy_all_16bit_cells", "mixed_baseline_has_master_copy",
                              "all_donations_realized", "no_double_rounding",
                              "collage_state_smaller_than_mixed",
                              "collage_peak_hbm_below_mixed", "source_lint_clean"}
    gap = rep["memory_gap"]["gpt-tiny"]
    assert gap["peak_source"] == "peak_bytes_modeled" and gap["state_ratio"] < 1.0
    assert rep["cells"]["gpt-tiny/D/flat"]["n_param_f32_persistent"] == 30
    assert rep["cells"]["gpt-tiny/C/zero"]["n_donated"] == 6
    assert rep["device"]["type"] == "cpu" and "one rank" in rep["ranks"]
    assert [k for k, *_ in precision_audit.matrix()][-1] == "gpt-tiny/C/pipeline_1f1b"
    assert len(precision_audit.matrix()) == 22

"""The port's checkpoints (repro_torch.train.checkpoint, the bucketing
migration and train.elastic's supervisor) against the JAX package's
format, on gpt-smoke (and, across packages, on qwen3-moe, gemma3, rwkv6 and
jamba smoke: MoE leaves, a tied head, a stack of two groups, the recurrent
mixers' leaves).

* Reference → port and port → reference, bit for bit: a state written by
  one package's ``save`` is restored by the other's, and every array of
  the restored state has the writer's bits under the same
  ``jax.tree_util.keystr`` name. The tree layout under each of the seven
  strategies (m, v with its Expansion, δθ, the master copy and the SR key
  all appear) and the bucketed layout (C, SR, D: every role array).
* Across bucket layouts: ``restore_bucketed`` onto another size cap and
  pad multiple, in both directions, equals the JAX package's own
  ``migrate``.
* The SR seed: the tree layout stores it as the threefry key [0, seed] and
  reads a key back as k0 ^ k1, so a seed survives port → reference → port.
* Faults: a corrupted checkpoint, ``keep_last``, ``latest`` and its
  fallback scan, the grad_err zero-fill rules, a structure mismatch.
* Resume: a run resumed at step k is bit-identical to an uninterrupted
  one (bucketed C; tree SR, whose noise stream follows the restored seed).
* The supervisor: crash recovery and the straggler rule as the JAX
  package's tests/test_fault_tolerance.py holds them, and errors of the
  card or of a kernel wrapper re-raised rather than restored over.

No tolerance anywhere: checkpoints move bits.
"""

import dataclasses
import functools
import os
import shutil
import time

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs.base import ShapeConfig as JShape
from repro.core import bucketing as jbucketing
from repro.core.collage import CollageAdamW as JAdamW
from repro.core.precision import BucketPolicy as JBP
from repro.core.precision import PrecisionPolicy as JPP
from repro.core.precision import parse_strategy as jparse
from repro.data.synthetic import make_batch_fn as jax_batch_fn
from repro.models.model import build_model as jax_build
from repro.train import checkpoint as jckpt
from repro.train import train_loop as jtl
from repro_torch.configs import get_config
from repro_torch.convert import key_from_seed, tensor_from_numpy, tensor_to_numpy
from repro_torch.core import bucketing
from repro_torch.core.collage import CollageAdamW
from repro_torch.core.precision import BucketPolicy, PrecisionPolicy, parse_strategy
from repro_torch.kernels.build import KernelLaunchError
from repro_torch.models.model import build_model
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import train_loop as ttl
from repro_torch.train.elastic import RunSupervisor, SupervisorConfig

STRATEGIES = ["A", "B", "C", "KAHAN", "SR", "D-MW", "D"]
BUCKETED = ["C", "SR", "D"]
KW = dict(b2=0.95, weight_decay=0.1, sr_seed=7)
# a second bucket layout: gpt-smoke's leaves split over several buckets
# (embed and lm_head hold 16,384 elements each), padded to 128
OTHER = dict(max_bucket_elems=20_000, pad_multiple=128)
SR_KEY = ".opt_state[<flat index 5>]"       # the tree layout's SR key


def _batch_np(step, L=32, B=4):
    b = jax_batch_fn(jax_config("gpt-smoke", smoke=True), JShape("t", L, B, "train"))(step)
    return {k: np.asarray(v) for k, v in b.items()}


def _to_torch(batch):
    """Tokens as int64; the frontend families' embeddings (bf16 from the
    JAX corpus) bit for bit."""
    return {k: torch.from_numpy(v.astype(np.int64)) if v.dtype.kind in "iu"
            else tensor_from_numpy(v, "cpu") for k, v in batch.items()}


def _jax_opt(name, bucketed, **bucket_kw):
    return JAdamW(1e-3, policy=JPP(strategy=jparse(name),
                                   bucketing=JBP(enabled=bucketed, **bucket_kw)), **KW)


def _port_opt(name, bucketed, sr_seed=KW["sr_seed"], **bucket_kw):
    return CollageAdamW(1e-3, policy=PrecisionPolicy(
        strategy=parse_strategy(name), bucketing=BucketPolicy(enabled=bucketed, **bucket_kw)),
        **{**KW, "sr_seed": sr_seed})


@functools.lru_cache(maxsize=None)
def _jax_model():
    return jax_build(jax_config("gpt-smoke", smoke=True))


@functools.lru_cache(maxsize=None)
def _jax_state(name, bucketed, steps=2):
    """A JAX TrainState after ``steps`` jitted steps: every role nonzero,
    the SR key split ``steps`` times."""
    jm = _jax_model()
    jopt = _jax_opt(name, bucketed)
    js = jtl.init_state(jm, jopt, jax.random.PRNGKey(0))
    step = jax.jit(jtl.make_train_step(jm, jopt))
    for i in range(steps):
        js, _ = step(js, _batch_np(i))
    return js


def _port_model():
    return build_model(get_config("gpt-smoke", smoke=True))


def _port_state(name, bucketed, steps=2, seed=0, **bucket_kw):
    tm, topt = _port_model(), _port_opt(name, bucketed, **bucket_kw)
    ts = ttl.init_state(tm, topt, seed, device="cpu")
    step = ttl.make_train_step(tm, topt)
    for i in range(steps):
        ts, _ = step(ts, _to_torch(_batch_np(i)))
    return ts


def _bits(a) -> np.ndarray:
    a = np.ascontiguousarray(a)
    return a.view(f"u{a.dtype.itemsize}")


def _jax_named(state) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(state)
    return {jax.tree_util.keystr(p): np.asarray(x) for p, x in flat}


def _port_named(state) -> dict:
    out = {}

    def put(name, leaf):
        out[name] = tensor_to_numpy(leaf) if isinstance(leaf, torch.Tensor) else np.asarray(leaf)
        return leaf

    state.map_named(put)
    return out


def _assert_same(got: dict, want: dict):
    assert list(got) == list(want), (list(got), list(want))
    for name in want:
        a, b = got[name], want[name]
        assert a.shape == b.shape and a.dtype.itemsize == b.dtype.itemsize, (name, a, b)
        assert np.array_equal(_bits(a), _bits(b)), name


# ------------------------------------------------------ across packages --
@pytest.mark.parametrize("name", STRATEGIES)
def test_reference_tree_checkpoint_restores_bit_for_bit(name, tmp_path):
    js = _jax_state(name, False)
    jckpt.save(str(tmp_path), 2, js, extra={"step": 2})
    got, extra = ckpt.restore(str(tmp_path), 2, ttl.init_state(_port_model(), _port_opt(
        name, False), 1, device="cpu"))
    assert extra == {"step": 2} and got.opt_state.step == 2
    want = _jax_named(js)
    if name == "SR":
        # the port holds the seed k0 ^ k1 of the reference's key [k0, k1]
        # and writes it back as [0, k0 ^ k1]: not the key's bits
        key = np.asarray(js.opt_state.rng)
        assert got.opt_state.rng == int(key[0]) ^ int(key[1])
        want[SR_KEY] = key_from_seed(int(key[0]) ^ int(key[1]))
    _assert_same(_port_named(got), want)


@pytest.mark.parametrize("name", STRATEGIES)
def test_port_tree_checkpoint_restores_into_reference(name, tmp_path):
    ts = _port_state(name, False)
    ckpt.save(str(tmp_path), 2, ts, extra={"step": 2})
    template = jtl.init_state(_jax_model(), _jax_opt(name, False), jax.random.PRNGKey(1))
    got, extra = jckpt.restore(str(tmp_path), 2, template)
    assert extra == {"step": 2}
    _assert_same(_jax_named(got), _port_named(ts))
    if name == "SR":
        assert np.asarray(got.opt_state.rng).tolist() == [0, 7]


@pytest.mark.parametrize("name", BUCKETED)
def test_reference_bucketed_checkpoint_restores_bit_for_bit(name, tmp_path):
    js = _jax_state(name, True)
    jckpt.save(str(tmp_path), 2, js, extra={"step": 2})
    got, _ = ckpt.restore(str(tmp_path), 2, _port_state(name, True, steps=0, seed=1))
    assert got.params.layout.to_json() == js.params.layout.to_json()
    _assert_same(_port_named(got), _jax_named(js))


@pytest.mark.parametrize("name", BUCKETED)
def test_port_bucketed_checkpoint_restores_into_reference(name, tmp_path):
    ts = _port_state(name, True)
    ckpt.save(str(tmp_path), 2, ts, extra={"step": 2})
    template = jtl.init_state(_jax_model(), _jax_opt(name, True), jax.random.PRNGKey(1))
    got, _ = jckpt.restore(str(tmp_path), 2, template)
    _assert_same(_jax_named(got), _port_named(ts))


# qwen3 smoke: MoE leaves (router, we_gate, we_up, we_down, stacked over the
# repeats); gemma3 smoke at 10 layers: a tied head (no lm_head) and a stack
# of two groups; rwkv6 smoke: the time-mix and channel-mix leaves (mu, w0,
# w_a, w_b, wr/wk/wv/wg/wo, u, ln_scale); jamba smoke: Mamba (in_proj,
# conv_w, x_proj, dt_proj, dt_bias, A_log, D, out_proj) beside NoPE
# attention and MoE
FAMILIES = {"qwen3-moe-30b-a3b": {}, "gemma3-27b": {"n_layers": 10}, "rwkv6-1.6b": {},
            "jamba-1.5-large-398b": {}, "seamless-m4t-medium": {}, "internvl2-1b": {}}


def _family_cfgs(arch):
    return (dataclasses.replace(jax_config(arch, smoke=True), **FAMILIES[arch]),
            dataclasses.replace(get_config(arch, smoke=True), **FAMILIES[arch]))


@functools.lru_cache(maxsize=None)
def _jax_family_state(arch, bucketed):
    jcfg, _ = _family_cfgs(arch)
    jm, jopt = jax_build(jcfg), _jax_opt("C", bucketed)
    js = jtl.init_state(jm, jopt, jax.random.PRNGKey(0))
    step = jax.jit(jtl.make_train_step(jm, jopt))
    batches = jax_batch_fn(jcfg, JShape("t", 16, 2, "train"))
    for i in range(2):
        js, _ = step(js, {k: np.asarray(v) for k, v in batches(i).items()})
    return jm, jopt, js


@pytest.mark.parametrize("bucketed", [True, False], ids=["bucketed", "tree"])
@pytest.mark.parametrize("arch", list(FAMILIES))
def test_family_checkpoints_cross_both_ways(arch, bucketed, tmp_path):
    """C after 2 steps, reference → port and port → reference, bit for bit,
    under the reference's names; the bucket layout over the MoE leaves or
    the tied tree is the reference's."""
    jcfg, tcfg = _family_cfgs(arch)
    jm, jopt, js = _jax_family_state(arch, bucketed)
    jckpt.save(str(tmp_path / "ref"), 2, js, extra={"step": 2})
    tm, topt = build_model(tcfg), _port_opt("C", bucketed)
    got, _ = ckpt.restore(str(tmp_path / "ref"), 2, ttl.init_state(tm, topt, 1, device="cpu"))
    want = _jax_named(js)
    _assert_same(_port_named(got), want)
    if bucketed:
        assert got.params.layout.to_json() == js.params.layout.to_json()
    names = str(js.params.layout.to_json()["slots"]) if bucketed else " ".join(want)
    assert ("we_gate" in names) == (arch in ("qwen3-moe-30b-a3b", "jamba-1.5-large-398b"))
    assert ("A_log" in names) == (arch == "jamba-1.5-large-398b")
    assert ("w_a" in names) == (arch == "rwkv6-1.6b")
    assert ("lm_head" in names) == (not tcfg.tie_embeddings)
    assert ("['groups'][1]" in names) == (arch == "gemma3-27b")
    assert ("'encoder'" in names) == (arch == "seamless-m4t-medium")

    ts = ttl.init_state(tm, topt, 2, device="cpu")
    step = ttl.make_train_step(tm, topt)
    batches = jax_batch_fn(jcfg, JShape("t", 16, 2, "train"))
    for i in range(2):
        ts, _ = step(ts, _to_torch({k: np.asarray(v) for k, v in batches(i).items()}))
    ckpt.save(str(tmp_path / "port"), 2, ts, extra={"step": 2})
    back, _ = jckpt.restore(str(tmp_path / "port"), 2,
                            jtl.init_state(jm, jopt, jax.random.PRNGKey(1)))
    _assert_same(_jax_named(back), _port_named(ts))


def test_manifests_of_both_packages_agree(tmp_path):
    """The same state written by each package: the same keys, names,
    shapes, dtypes and checksums in the same order."""
    js = _jax_state("C", True)
    jckpt.save(str(tmp_path / "j"), 2, js, extra={"step": 2})
    ts, _ = ckpt.restore(str(tmp_path / "j"), 2, _port_state("C", True, steps=0))
    ckpt.save(str(tmp_path / "t"), 2, ts, extra={"step": 2})
    read = lambda d: open(os.path.join(d, "step_00000002", "manifest.json")).read()
    assert read(tmp_path / "t") == read(tmp_path / "j")


@pytest.mark.parametrize("direction", ["reference_to_port", "port_to_reference"])
def test_restore_bucketed_across_layouts_matches_reference_migrate(direction, tmp_path):
    """A checkpoint of one bucket layout restored onto another, in either
    direction, equals the JAX package's own ``migrate`` of that state."""
    js = _jax_state("C", True)
    jtemplate = jtl.init_state(_jax_model(), _jax_opt("C", True, **OTHER),
                               jax.random.PRNGKey(1))
    assert jtemplate.params.layout.n_buckets > 1
    want = jbucketing.migrate(js, jtemplate.params.layout)
    if direction == "reference_to_port":
        jckpt.save(str(tmp_path), 2, js, extra={"step": 2})
        got, _ = ckpt.restore_bucketed(str(tmp_path), 2,
                                       _port_state("C", True, steps=0, **OTHER))
        assert got.params.layout.to_json() == jtemplate.params.layout.to_json()
        _assert_same(_port_named(got), _jax_named(want))
    else:
        jckpt.save(str(tmp_path / "j"), 2, js, extra={"step": 2})
        ts, _ = ckpt.restore(str(tmp_path / "j"), 2, _port_state("C", True, steps=0))
        ckpt.save(str(tmp_path / "t"), 2, ts, extra={"step": 2})
        got, _ = jckpt.restore_bucketed(str(tmp_path / "t"), 2, jtemplate)
        _assert_same(_jax_named(got), _jax_named(want))
        # and the port's own migrate agrees
        layout = _port_state("C", True, steps=0, **OTHER).params.layout
        _assert_same(_port_named(bucketing.migrate(ts, layout)), _jax_named(want))


def test_rebucket_round_trip_is_bit_exact():
    ts = _port_state("C", True, steps=1)
    a = ts.params.layout
    b = _port_state("C", True, steps=0, **OTHER).params.layout
    moved = bucketing.rebucket(ts.opt_state.vlo, a, b)
    assert [t.numel() for t in moved] == [s.padded for s in b.buckets]
    back = bucketing.rebucket(moved, b, a)
    assert all(torch.equal(x.view(torch.int16), y.view(torch.int16))
               for x, y in zip(back, ts.opt_state.vlo))
    tmpl = bucketing.state_template_for_layout(ts, b)
    assert tmpl.params.layout == b and tmpl.opt_state.layout == b
    assert all(not t.any() and t.dtype == torch.bfloat16 for t in tmpl.opt_state.m)


def test_sr_seed_survives_port_reference_port(tmp_path):
    """Port → reference → port: the seed 12345 goes out as the key
    [0, 12345], the reference stores the key as it is, and it comes back
    as 0 ^ 12345."""
    ts = ttl.init_state(_port_model(), _port_opt("SR", False, sr_seed=12345), 0, device="cpu")
    assert ts.opt_state.rng == 12345
    ckpt.save(str(tmp_path / "t"), 0, ts, extra={"step": 0})
    js, _ = jckpt.restore(str(tmp_path / "t"), 0, _jax_state("SR", False))
    assert np.asarray(js.opt_state.rng).tolist() == [0, 12345]
    jckpt.save(str(tmp_path / "j"), 0, js, extra={"step": 0})
    back, _ = ckpt.restore(str(tmp_path / "j"), 0, _port_state("SR", False, steps=0))
    assert back.opt_state.rng == 12345


# ------------------------------------------------------------- faults --
def test_checksum_detects_corruption(tmp_path):
    ts = _port_state("C", True, steps=0)
    path = ckpt.save(str(tmp_path), 1, ts, extra={"step": 1})
    f = os.path.join(path, "arrays.npz")
    with np.load(f) as d:
        arrays = dict(d)
    arrays["a0"] = arrays["a0"].copy()
    arrays["a0"][5] ^= 1                        # one bit of one parameter
    np.savez(f, **arrays)
    with pytest.raises(ckpt.CheckpointError, match="checksum"):
        ckpt.restore(str(tmp_path), 1, ts)
    raw = bytearray(open(f, "rb").read())       # and a flipped byte of the file
    raw[len(raw) // 2] ^= 0xFF
    open(f, "wb").write(bytes(raw))
    with pytest.raises(Exception):
        ckpt.restore(str(tmp_path), 1, ts)


def test_keep_last_gc_and_latest(tmp_path):
    ts = _port_state("C", True, steps=0)
    d = str(tmp_path)
    for s in (1, 2, 3, 4, 5):
        ckpt.save(d, s, ts, keep_last=2, extra={"step": s})
    assert sorted(x for x in os.listdir(d) if x.startswith("step_")) == \
        ["step_00000004", "step_00000005"]
    assert ckpt.latest_step(d) == 5
    assert not any(x.endswith(".tmp") for x in os.listdir(d))


def test_latest_step_scans_when_latest_points_at_nothing(tmp_path):
    ts = _port_state("C", True, steps=0)
    d = str(tmp_path)
    assert ckpt.latest_step(d) is None
    for s in (2, 4):
        ckpt.save(d, s, ts, extra={"step": s})
    shutil.rmtree(os.path.join(d, "step_00000004"))
    assert ckpt.latest_step(d) == 2
    shutil.rmtree(os.path.join(d, "step_00000002"))
    assert ckpt.latest_step(d) is None


def test_structure_mismatch_raises_with_hint(tmp_path):
    ckpt.save(str(tmp_path), 1, _port_state("C", True, steps=0), extra={"step": 1})
    with pytest.raises(ckpt.CheckpointError, match="bucketed"):
        ckpt.restore(str(tmp_path), 1, _port_state("C", False, steps=0))


def test_grad_err_leaves_zero_fill_and_drop(tmp_path):
    """grad_err may change across a restore: a template leaf the checkpoint
    lacks or whose shape changed is zero-filled, a stored one the template
    lacks is dropped; the other leaves restore bit for bit."""
    ts = _port_state("C", False, steps=1)
    err = lambda n: {"embed": torch.full((n, 3), 0.5)}
    ckpt.save(str(tmp_path / "a"), 1, ts, extra={"step": 1})
    got, _ = ckpt.restore(str(tmp_path / "a"), 1, dataclasses.replace(ts, grad_err=err(2)))
    assert not got.grad_err["embed"].any() and got.grad_err["embed"].shape == (2, 3)
    ckpt.save(str(tmp_path / "b"), 1, dataclasses.replace(ts, grad_err=err(4)),
              extra={"step": 1})
    got, _ = ckpt.restore(str(tmp_path / "b"), 1, dataclasses.replace(ts, grad_err=err(2)))
    assert not got.grad_err["embed"].any()
    got, _ = ckpt.restore(str(tmp_path / "b"), 1, dataclasses.replace(ts, grad_err=err(4)))
    assert torch.equal(got.grad_err["embed"], err(4)["embed"])
    got, _ = ckpt.restore(str(tmp_path / "b"), 1, ts)
    assert got.grad_err is None
    _assert_same(_port_named(got), _port_named(ts))


# ------------------------------------------------------------- resume --
@pytest.mark.parametrize("name,bucketed", [("C", True), ("SR", False)])
def test_resumed_run_is_bit_identical(name, bucketed, tmp_path):
    """4 steps straight, against 2 steps, save, restore into a fresh state
    from another seed, 2 steps: params, optimizer state and losses."""
    tm, topt = _port_model(), _port_opt(name, bucketed)
    step = ttl.make_train_step(tm, topt)
    batches = [_to_torch(_batch_np(i)) for i in range(4)]
    ts, losses = ttl.init_state(tm, topt, 0, device="cpu"), []
    for i in range(4):
        if i == 2:
            ckpt.save(str(tmp_path), 2, ts, extra={"step": 2})
        ts, m = step(ts, batches[i])
        losses.append(float(m["loss"]))
    rs, extra = ckpt.restore_bucketed(str(tmp_path), 2, ttl.init_state(tm, topt, 1,
                                                                        device="cpu"))
    resumed = losses[:2]
    for i in range(extra["step"], 4):
        rs, m = step(rs, batches[i])
        resumed.append(float(m["loss"]))
    assert resumed == losses
    _assert_same(_port_named(rs), _port_named(ts))


# --------------------------------------------------------- supervisor --
def _sup_setup():
    tm, topt = _port_model(), _port_opt("C", True)
    step = ttl.make_train_step(tm, topt)
    batches = {}
    batch_fn = lambda i: batches.setdefault(i, _to_torch(_batch_np(i)))
    return ttl.init_state(tm, topt, 0, device="cpu"), step, batch_fn


def test_supervisor_crash_recovery(tmp_path):
    state, step, batch_fn = _sup_setup()
    armed = [True]

    def fault(i):
        if i == 7 and armed[0]:
            armed[0] = False
            raise RuntimeError("simulated host failure")

    sup = RunSupervisor(SupervisorConfig(str(tmp_path), ckpt_every=5), fault_hook=fault)
    final, n, _ = sup.run(state, step, batch_fn, n_steps=10)
    assert n == 10 and sup.recoveries == [7] and sup.stragglers == []
    assert ckpt.latest_step(str(tmp_path)) == 10
    s = state
    for i in range(10):
        s, _ = step(s, batch_fn(i))
    _assert_same(_port_named(final), _port_named(s))


def test_supervisor_straggler_keeps_completed_state(tmp_path):
    def train_step(s, batch):
        time.sleep(1.0 if int(batch) == 7 else 0.002)
        return s + batch, {"loss": 0.0}

    sup = RunSupervisor(SupervisorConfig(None, ckpt_every=5, min_step_time=1e-4,
                                         deadline_slack=5.0))
    final, n, _ = sup.run(torch.zeros(4), train_step, lambda i: torch.tensor(float(i)),
                          n_steps=10)
    assert n == 10 and sup.recoveries == [7] and sup.stragglers == [7]
    assert all(t < 0.5 for t in sup.step_times)
    assert torch.equal(final, torch.full((4,), float(sum(range(10)))))


@pytest.mark.parametrize("error", [KernelLaunchError("flash_fwd kernel launch failed"),
                                   torch.cuda.OutOfMemoryError("CUDA out of memory")])
def test_supervisor_reraises_errors_of_the_card(error, tmp_path):
    """A kernel wrapper's or the CUDA runtime's error is not restored over,
    even with a checkpoint to go back to."""
    state, step, batch_fn = _sup_setup()

    def fault(i):
        if i == 3:
            raise error

    sup = RunSupervisor(SupervisorConfig(str(tmp_path), ckpt_every=2), fault_hook=fault)
    with pytest.raises(type(error)):
        sup.run(state, step, batch_fn, n_steps=5)
    assert sup.recoveries == [] and ckpt.latest_step(str(tmp_path)) == 2


def test_supervisor_without_checkpoints_raises_on_a_crash():
    state, step, batch_fn = _sup_setup()

    def fault(i):
        if i == 1:
            raise TimeoutError("simulated hang")

    sup = RunSupervisor(SupervisorConfig(None), fault_hook=fault)
    with pytest.raises(RuntimeError, match="before first checkpoint"):
        sup.run(state, step, batch_fn, n_steps=3)

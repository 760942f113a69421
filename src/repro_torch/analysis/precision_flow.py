"""Precision-flow pass: the no-master-copy invariant over one eager step,
the port of ``repro.analysis.precision_flow``.

The invariant: for every (16,16) strategy (all but D⁻, whose moments are
f32, and D, the fp32 master-weights baseline), no parameter-shaped f32
tensor lives across steps. What lives across steps is exactly the ``TrainState`` the step
returns, so the **state census** walks it through ``TrainState.map_named``,
which names every leaf as the JAX package's ``jax.tree_util.keystr`` names
the leaves of its output state (``.params.data[0]``,
``.opt_state[<flat index 1>]['embed']``, …): a wide-float leaf of at least
``min_numel`` elements, not matched by ``allow_names``, is a master copy.
Each leaf also gets a role (params, m, v, vhi, vlo, delta, master,
grad_err, scalar), so D⁻'s f32 moments read apart from D's master copy.

Two advisory counts follow the wide values inside the step, from the
trace (``analysis.trace``):

* ``transient_param_shaped_f32``: results in f32/f64 with the shape of a
  persistent leaf (``f32_arith_param_shaped``: of those, arithmetic). The
  tree layout's optimizer computes in f32 by design (strict-FPU rounding
  of each op); growth means a new promotion site.
* ``double_round_chains``: narrowings (f32 → bf16) of a value whose
  producers, through data movement only (``trace.PASSTHROUGH``), start at
  a widening (bf16 → f32): a round trip that touched no arithmetic.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.analysis.trace import ARITH, PASSTHROUGH, WIDE_FLOATS, Trace
from repro_torch.core import bucketing

_TREE_ROLES = {0: "scalar", 1: "m", 2: "v", 3: "delta", 4: "master", 5: "scalar"}


def role_of(name: str) -> str:
    """The role of a state leaf, from its keystr name."""
    if name.startswith(".params"):
        return "params"
    if name.startswith(".grad_err") or name.startswith(".opt_state.grad_err"):
        return "grad_err"
    if name.startswith(".opt_state."):
        field = name[len(".opt_state."):].split("[")[0]
        return "scalar" if field in ("step", "rng") else field
    if name.startswith(".opt_state[<flat index "):
        i = int(name[len(".opt_state[<flat index "):].split(">")[0])
        role = _TREE_ROLES[i]
        if role == "v" and name.endswith("[<flat index 0>]"):
            return "vhi"
        if role == "v" and name.endswith("[<flat index 1>]"):
            return "vlo"
        return role
    return "scalar"


def _leaf(name: str, a) -> dict:
    if isinstance(a, torch.Tensor):
        dtype, shape, nbytes = str(a.dtype).replace("torch.", ""), tuple(a.shape), \
            a.numel() * a.element_size()
    else:
        a = np.asarray(a)
        dtype, shape, nbytes = str(a.dtype), tuple(a.shape), a.nbytes
    return {"name": name, "dtype": dtype, "shape": shape, "bytes": int(nbytes),
            "role": role_of(name)}


def state_leaves(state) -> list:
    """Every leaf of a ``TrainState`` in the JAX package's order: name,
    dtype, shape, bytes, role."""
    out = []

    def fn(name, a):
        out.append(_leaf(name, a))
        return a
    state.map_named(fn)
    return out


def n_params(state) -> int:
    """The parameter count (a bucketed layout's real elements, no padding)."""
    p = state.params
    if isinstance(p, bucketing.BucketedParams):
        return int(p.layout.total_size)
    return int(sum(t.numel() for t in bucketing.tree_leaves(p)))


def _numel(shape) -> int:
    return int(np.prod(shape, dtype=np.int64)) if shape else 1


def census(state, *, min_numel: int = 65, allow_names: tuple = ()) -> dict:
    """The state half of the pass: leaves, bytes, the persistent f32 leaves."""
    leaves = state_leaves(state)
    persistent = [x for x in leaves if x["dtype"] in WIDE_FLOATS
                  and _numel(x["shape"]) >= min_numel
                  and not any(a in x["name"] for a in allow_names)]
    by_role: dict = {}
    for x in leaves:
        d = by_role.setdefault(x["role"], {})
        d[x["dtype"]] = d.get(x["dtype"], 0) + x["bytes"]
    n = n_params(state)
    tensor_bytes = sum(x["bytes"] for x in leaves if x["role"] != "scalar")
    f32_bytes = sum(x["bytes"] for x in leaves if x["dtype"] in WIDE_FLOATS
                    and x["role"] != "scalar")
    return {
        "leaves": leaves,
        "n_state_results": len(leaves),
        "state_bytes": sum(x["bytes"] for x in leaves),
        "param_f32_persistent": persistent,
        "f32_state_bytes": sum(x["bytes"] for x in persistent),
        "by_role": by_role,
        "n_params": n,
        "bytes_per_param": tensor_bytes / n,
        "f32_bytes_per_param": f32_bytes / n,
        "no_master_copy": not persistent,
    }


def _double_round_source(trace: Trace, op) -> Optional[int]:
    """The widening a narrowing's value came from through data movement
    only, or None."""
    cur = op.producers[op.value_operand()] if op.producers else -1
    for _ in range(64):
        if cur < 0:
            return None
        prod = trace.ops[cur]
        if prod.widening():
            return cur
        if prod.name not in PASSTHROUGH or not prod.producers:
            return None
        cur = prod.producers[prod.value_operand()]
    return None


def transients(trace: Trace, param_shapes: set) -> dict:
    """The trace half of the pass: wide param-shaped results, converts and
    double-round chains, each with samples (the op and its source line)."""
    transient = arith = widening = narrowing = double = 0
    t_samples, d_samples = [], []
    for op in trace.ops:
        if op.widening():
            widening += 1
        elif op.narrowing():
            narrowing += 1
            src = _double_round_source(trace, op)
            if src is not None:
                double += 1
                if len(d_samples) < 8:
                    d_samples.append(f"{trace.ops[src].op} at {trace.ops[src].location} → "
                                     f"{op.op} at {op.location}")
        for (dt, shape), a in zip(op.outs, op.alias):
            if a < 0 and dt in WIDE_FLOATS and shape in param_shapes:
                transient += 1
                if len(t_samples) < 8:
                    t_samples.append(f"{op.op} {dt}{list(shape)}")
                if op.name in ARITH:
                    arith += 1
    return {
        "transient_param_shaped_f32": transient,
        "transient_samples": t_samples,
        "f32_arith_param_shaped": arith,
        "double_round_chains": double,
        "double_round_samples": d_samples,
        "widening_converts": widening,
        "narrowing_converts": narrowing,
    }


def analyze_precision_flow(trace: Trace, state, *, sixteen_bit: bool,
                           min_numel: int = 65) -> dict:
    """The pass over one step: ``state`` is the TrainState it returned,
    ``trace`` its record. ``sixteen_bit`` declares whether the strategy
    claims the (16,16) property (D⁻ and D do not: the same walk then
    reports their f32 leaves instead of failing)."""
    rep = {"sixteen_bit": sixteen_bit, **census(state, min_numel=min_numel)}
    shapes = {x["shape"] for x in rep["leaves"] if _numel(x["shape"]) >= min_numel}
    rep.update(transients(trace, shapes))
    return rep


def assert_no_master_copy(report: dict, ctx: str = "") -> None:
    """Hard gate for (16,16) strategies: raises with the offending leaves."""
    if report["sixteen_bit"] and report["param_f32_persistent"]:
        leaves = [v["name"] for v in report["param_f32_persistent"]]
        raise AssertionError(
            f"{ctx}: fp32 master copy detected — parameter-shaped f32 "
            f"buffers live across steps: {leaves}")

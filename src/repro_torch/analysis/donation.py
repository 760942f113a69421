"""Donation: is a donated step really written in place? The port of
``repro.analysis.donation``.

In the JAX package ``donate_argnums`` is a request that XLA may drop; its
pass reads the compiled executable's input-output aliases. In the port a
donated step (``make_train_step(donate=True)``,
``make_sharded_train_step(donate=True)``: the bucketed layout) promises to
write every new bucket over the one it replaces: parameters, every
optimizer role and the error-feedback residual rows. The pass holds the
returned state to that promise by storage: each output bucket must lie in
the storage of the input bucket of the same name. ``unrealized`` lists
those that do not, with their bytes. The tree layout's step is per leaf and
never donated: its cells report ``n_donated`` 0.

The input storages are held as weak references (``donated_storages``), so
a freed input's address cannot be taken for a new bucket's while the check
runs.
"""

from __future__ import annotations

import torch
from torch.multiprocessing.reductions import StorageWeakRef

from repro_torch.core import bucketing


def _buckets(state) -> dict:
    """name → tensor for every bucket of a bucketed TrainState."""
    out: dict = {}
    if not isinstance(state.params, bucketing.BucketedParams):
        return out

    def fn(name, a):
        if isinstance(a, torch.Tensor):
            out[name] = a
        return a
    state.map_named(fn)
    return out


def donated_storages(state, donate: bool) -> dict:
    """Before a step: name → (weak ref to the storage, bytes) of every bucket
    the step was asked to write in place (none without ``donate``)."""
    if not donate:
        return {}
    return {k: (StorageWeakRef(t.untyped_storage()), t.numel() * t.element_size())
            for k, t in _buckets(state).items()}


def check_donation(before: dict, state_after) -> dict:
    after = _buckets(state_after)
    unrealized = []
    for name, (ref, nbytes) in before.items():
        t = after.get(name)
        if t is None or StorageWeakRef(t.untyped_storage()).cdata != ref.cdata:
            unrealized.append({"name": name, "bytes": nbytes})
    return {
        "n_args": len(after),
        "n_donated": len(before),
        "n_aliased": len(before) - len(unrealized),
        "donated_bytes": sum(b for _, b in before.values()),
        "unrealized": unrealized,
        "unrealized_bytes": sum(u["bytes"] for u in unrealized),
        "all_donations_realized": not unrealized,
    }


def assert_donation_realized(report: dict, ctx: str = "") -> None:
    if not report["all_donations_realized"]:
        raise AssertionError(
            f"{ctx}: {len(report['unrealized'])} donated bucket(s) "
            f"({report['unrealized_bytes']} B) were NOT written in place: "
            f"{report['unrealized'][:4]}")

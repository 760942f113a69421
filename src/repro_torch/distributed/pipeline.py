"""Pipeline parallelism as a schedule-as-data IR, the port of
``repro.distributed.pipeline``.

A schedule is data: ``make_schedule`` compiles a named policy (``gpipe`` |
``1f1b`` | ``interleaved``) into per-tick instruction arrays (numpy, shape
(T, S), int32, −1 = no-op): for every (tick, stage) cell which microbatch
runs its forward, which its backward, and which activation-stash slots
are read and written, plus the tick after which each gradient class
(head, stage, embed) is complete. The IR is a copy of the JAX package's,
array for array.

``run_schedule`` executes a Schedule in ONE process (single controller):
the S stages are a list of devices (all S on one card when there is one
card), and at each tick it runs every stage's forward unit and backward
unit in turn, then moves the arrivals between the stage stashes (the
reference's ``ppermute``). The backward is explicit: each chunk is
recomputed at its stashed input and differentiated there with
``torch.autograd.grad`` (activation-checkpointing semantics), and the head
loss and its output cotangent are taken inline at final-chunk backward
ticks. Nothing is differentiated through the schedule. Bubble cells (−1)
are skipped: in the reference they are masked units whose results are
discarded, so skipping them changes no value.

Schedules:

  * ``gpipe``   — all forwards, then all backwards. Stash: M slots.
  * ``1f1b``    — stage s runs min(M, S−s) warmup forwards, then alternates
    Bwd/Fwd; stash min(M, S−s) slots.
  * ``interleaved`` — V virtual chunks per stage, chunk c on stage c mod S
    (round-robin), Megatron ordering; requires M % S == 0.

The legacy standalone GPipe forward, ``stage_schedule`` and
``pipeline_apply``, runs its stages on devices of one rank too: tick t runs
stage s on microbatch t − s, its input the output stage s−1 made at tick
t−1. Autograd runs through it whole, so its gradient is the sequential
stack's; the reference's shard_map version transposes its closing psums to
psums and delivers the S-fold gradient its docstring warns of.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.core import bucketing

SCHEDULES = ("gpipe", "1f1b", "interleaved")
F32 = torch.float32


# ==========================================================================
# Schedule IR (numpy; the JAX package's generators)
# ==========================================================================

@dataclasses.dataclass(frozen=True)
class Schedule:
    """Per-tick instruction program for ``run_schedule``.

    All arrays are host-side numpy, shape (T, S), int32, −1 = no-op.
    ``f_*`` drive the forward unit of a tick, ``b_*`` the backward unit;
    ``*_wslot`` name the stash slot into which THIS tick's ppermute
    arrival is written (−1 = discard — the wire carries garbage).

    For the forward of (chunk c, micro m): ``f_slot`` is the stash slot
    holding its input activation (−1 ⇒ c == 0, read xs[micro]); the same
    slot is read again at the Bwd tick (``b_xslot``) for the VJP
    recompute, then freed. ``b_dyslot`` holds the arrived output
    cotangent (−1 ⇒ c == C−1: the head loss/cotangent is computed
    inline). Slot indices are generator-allocated with liveness checking
    (:func:`_allocate_slots`); ``n_fwd_slots``/``n_bwd_slots`` size the
    stashes — the per-schedule activation-memory claim, asserted by
    tests."""
    name: str
    n_stages: int
    n_micro: int
    n_virtual: int
    f_chunk: np.ndarray
    f_micro: np.ndarray
    f_slot: np.ndarray
    f_wslot: np.ndarray
    b_chunk: np.ndarray
    b_micro: np.ndarray
    b_xslot: np.ndarray
    b_dyslot: np.ndarray
    b_wslot: np.ndarray
    n_fwd_slots: int
    n_bwd_slots: int
    # tick AFTER which each gradient bucket class is complete (all
    # contributing Bwd ticks executed) — drives the comm-launch order and
    # the overlap cost model
    comm_ready: dict

    @property
    def n_chunks(self) -> int:
        return self.n_stages * self.n_virtual

    @property
    def n_ticks(self) -> int:
        return int(self.f_chunk.shape[0])

    def stats(self) -> dict:
        """Structural summary: ticks, stash sizes, bubble fraction."""
        T, M, V = self.n_ticks, self.n_micro, self.n_virtual
        return {
            "name": self.name, "n_stages": self.n_stages, "n_micro": M,
            "n_virtual": V, "n_ticks": T,
            "n_fwd_slots": self.n_fwd_slots,
            "n_bwd_slots": self.n_bwd_slots,
            # masked-tick bubble: every tick costs (fwd+bwd)/V on every
            # device; ideal is M·V ticks (both units busy throughout)
            "bubble_fraction": 1.0 - (M * V) / T,
            "comm_ready": dict(self.comm_ready),
        }


def _orders(name: str, S: int, M: int, V: int):
    """Per-device forward/backward op orderings + warmup depths.

    Returns (fwd_orders, bwd_orders, warmup): op = (chunk, micro);
    ``warmup[s]`` bounds the device's forwards-in-flight (fwd issued −
    bwd issued) — the 1F1B memory cap; M·V disables the cap (GPipe)."""
    fwd, bwd, warm = [], [], []
    for s in range(S):
        if V == 1:
            f = [(s, m) for m in range(M)]
            b = list(f)
        else:
            if M % S:
                raise ValueError(
                    f"interleaved schedule needs n_micro % n_stages == 0, "
                    f"got M={M}, S={S}")
            f = [(v * S + s, g * S + i)
                 for g in range(M // S)
                 for v in range(V)
                 for i in range(S)]
            b = [(v * S + s, g * S + i)
                 for g in range(M // S)
                 for v in reversed(range(V))
                 for i in range(S)]
        fwd.append(f)
        bwd.append(b)
        if name == "gpipe":
            warm.append(M * V)
        elif name == "1f1b":
            warm.append(min(M, S - s))
        else:  # interleaved
            warm.append(min(M * V, 2 * (S - 1 - s) + (V - 1) * S + 1))
    return fwd, bwd, warm


def _simulate(name: str, S: int, M: int, V: int):
    """Dependency-driven tick simulation → (rows, fwd_tick, bwd_tick).

    Each tick a device may issue one forward AND one backward (its two
    units), strictly in its policy order, gated by dataflow: Fwd(c, m)
    needs the arrival of Fwd(c−1, m) by the end of an earlier tick;
    Bwd(c, m) needs its own Fwd done earlier plus (c < C−1) the arrival
    of Bwd(c+1, m)'s input cotangent. The backward unit is considered
    first so a completed Bwd frees its in-flight slot for the same-tick
    forward (the 1F1B steady state). GPipe additionally holds every
    backward until the device's forward list is exhausted."""
    C = S * V
    fwd_orders, bwd_orders, warm = _orders(name, S, M, V)
    fwd_tick: dict = {}
    bwd_tick: dict = {}
    fp, bp = [0] * S, [0] * S
    rows = []
    t = 0
    while any(fp[s] < len(fwd_orders[s]) or bp[s] < len(bwd_orders[s])
              for s in range(S)):
        progress = False
        row = []
        for s in range(S):
            bop = None
            if bp[s] < len(bwd_orders[s]) and \
                    (name != "gpipe" or fp[s] == len(fwd_orders[s])):
                c, m = bwd_orders[s][bp[s]]
                ok = (c, m) in fwd_tick and fwd_tick[(c, m)] < t
                if c < C - 1:
                    ok = ok and (c + 1, m) in bwd_tick \
                        and bwd_tick[(c + 1, m)] < t
                if ok:
                    bop = (c, m)
                    bwd_tick[(c, m)] = t
                    bp[s] += 1
                    progress = True
            fop = None
            if fp[s] < len(fwd_orders[s]) and fp[s] - bp[s] < warm[s]:
                c, m = fwd_orders[s][fp[s]]
                if c == 0 or ((c - 1, m) in fwd_tick
                              and fwd_tick[(c - 1, m)] < t):
                    fop = (c, m)
                    fwd_tick[(c, m)] = t
                    fp[s] += 1
                    progress = True
            row.append((fop, bop))
        if not progress:
            raise AssertionError(
                f"schedule {name!r} deadlocked at tick {t} "
                f"(S={S}, M={M}, V={V}, fp={fp}, bp={bp})")
        rows.append(row)
        t += 1
    return rows, fwd_tick, bwd_tick


def _allocate_slots(events):
    """Greedy first-fit slot allocation with liveness checking.

    ``events``: [(arrival_tick, free_tick, key)] for one device — the
    value is written at the END of arrival_tick and last read at the
    START of free_tick, so a slot is reusable by an arrival at
    tick ≥ its previous free_tick. Returns ({key: slot}, n_slots)."""
    slots: list = []  # free_tick per slot
    assign = {}
    for arrival, free, key in sorted(events):
        for i, slot_free in enumerate(slots):
            if arrival >= slot_free:
                slots[i] = free
                assign[key] = i
                break
        else:
            assign[key] = len(slots)
            slots.append(free)
    return assign, len(slots)


def make_schedule(name: str, *, n_stages: int, n_micro: int,
                  n_virtual: int = 1) -> Schedule:
    """Compile a named schedule into its instruction-array IR."""
    if name not in SCHEDULES:
        raise ValueError(f"unknown schedule {name!r}; one of {SCHEDULES}")
    if name != "interleaved" and n_virtual != 1:
        raise ValueError(f"n_virtual={n_virtual} requires the interleaved "
                         f"schedule (got {name!r})")
    if name == "interleaved" and n_virtual < 2:
        raise ValueError("interleaved schedule needs n_virtual >= 2")
    S, M, V = n_stages, n_micro, n_virtual
    C = S * V
    rows, fwd_tick, bwd_tick = _simulate(name, S, M, V)
    T = len(rows)

    # -- validate: every op exactly once, forward strictly before backward
    want = {(c, m) for c in range(C) for m in range(M)}
    assert set(fwd_tick) == want and set(bwd_tick) == want, \
        (name, S, M, V, len(fwd_tick), len(bwd_tick))
    for key in want:
        assert fwd_tick[key] < bwd_tick[key], (name, key)

    # -- slot allocation (per stage; the stash size is the max over stages)
    f_assign: dict = {}
    b_assign: dict = {}
    n_f = n_b = 1
    for s in range(S):
        fev = [(fwd_tick[(c - 1, m)], bwd_tick[(c, m)], (c, m))
               for (c, m) in fwd_tick
               if c % S == s and c > 0]
        a, n = _allocate_slots(fev)
        f_assign.update(a)
        n_f = max(n_f, n)
        bev = [(bwd_tick[(c + 1, m)], bwd_tick[(c, m)], (c, m))
               for (c, m) in bwd_tick
               if c % S == s and c < C - 1]
        a, n = _allocate_slots(bev)
        b_assign.update(a)
        n_b = max(n_b, n)

    # -- instruction arrays
    arrs = {k: np.full((T, S), -1, np.int32)
            for k in ("f_chunk", "f_micro", "f_slot", "f_wslot", "b_chunk",
                      "b_micro", "b_xslot", "b_dyslot", "b_wslot")}
    for t, row in enumerate(rows):
        for s, (fop, bop) in enumerate(row):
            if fop is not None:
                c, m = fop
                arrs["f_chunk"][t, s] = c
                arrs["f_micro"][t, s] = m
                if c > 0:
                    arrs["f_slot"][t, s] = f_assign[(c, m)]
                # the arrival this send produces: device s+1 stashes it
                if c < C - 1:
                    arrs["f_wslot"][t, (s + 1) % S] = f_assign[(c + 1, m)]
            if bop is not None:
                c, m = bop
                arrs["b_chunk"][t, s] = c
                arrs["b_micro"][t, s] = m
                if c > 0:
                    arrs["b_xslot"][t, s] = f_assign[(c, m)]
                if c < C - 1:
                    arrs["b_dyslot"][t, s] = b_assign[(c, m)]
                if c > 0:
                    arrs["b_wslot"][t, (s - 1) % S] = b_assign[(c - 1, m)]

    # -- bucket-class readiness: last contributing Bwd tick + 1
    comm_ready = {
        "head": max(bwd_tick[(C - 1, m)] for m in range(M)) + 1,
        "stage": max(bwd_tick.values()) + 1,
        "embed": max(bwd_tick[(0, m)] for m in range(M)) + 1,
    }
    return Schedule(name=name, n_stages=S, n_micro=M, n_virtual=V,
                    n_fwd_slots=n_f, n_bwd_slots=n_b, comm_ready=comm_ready,
                    **arrs)




# ==========================================================================
# the interpreter (single controller)
# ==========================================================================

def _leaves(tree):
    flat, skel = bucketing.tree_flatten_with_path(tree)
    return [t for _, t in flat], skel


def _unflatten(skel, leaves):
    return bucketing.tree_unflatten(skel, leaves)


def _f32(x, device):
    return torch.tensor(float(np.float32(x)), dtype=F32, device=device)


def run_schedule(sched: Schedule, body_fn: Callable, head_loss_fn: Callable,
                 chunk_params: Sequence, head_params, xs: torch.Tensor, labels: torch.Tensor, *,
                 devices: Sequence[torch.device]) -> dict:
    """Execute ``sched`` over the S stage ``devices`` of this process.

    ``body_fn(p_chunk, x) → (y, aux)`` applies one chunk's layers to one
    microbatch activation x (mb, L, D); ``chunk_params[c]`` is chunk c's
    parameter tree (chunk c runs on ``devices[c % S]``).
    ``head_loss_fn(head_params, y, labels_m) → ce_m`` is the per-microbatch
    head loss, taken at final-chunk backward ticks. ``xs`` (M, mb, L, D) are
    the embedded microbatches, ``labels`` (M, mb, L).

    Returns, as the JAX package's ``run_schedule`` (every gradient
    explicit, in f32):

      * ``g_chunks``: per chunk, its parameter gradient tree;
      * ``g_head``: the head parameters' gradient (stage S−1's);
      * ``dxs``: (M, mb, L, D) cotangents of xs (stage 0's);
      * ``ce``/``aux``: f32 sums of the per-microbatch CE and of the
        per-(chunk, micro) MoE aux.

    The loss decomposition is ``train_loop.make_accum_grads``'s: each ce_m
    is normalized by its own token count, cotangents are scaled 1/M, the
    aux cotangent is AUX_LOSS_COEF/M per (chunk, micro)."""
    from repro_torch.models.model import AUX_LOSS_COEF

    S, M, V = sched.n_stages, sched.n_micro, sched.n_virtual
    C = sched.n_chunks
    if len(devices) != S:
        raise ValueError(f"{len(devices)} devices for {S} stages")
    if len(chunk_params) != C:
        raise ValueError(f"{len(chunk_params)} chunk parameter trees for {C} chunks")
    act = xs.dtype
    first, last = devices[0], devices[(C - 1) % S]
    inv_m = {d: _f32(1.0 / M, d) for d in set(devices)}
    aux_ct = {d: _f32(np.float32(AUX_LOSS_COEF) * np.float32(1.0 / M), d) for d in set(devices)}
    hp_leaves, hp_skel = _leaves(head_params)

    fstash = [dict() for _ in range(S)]
    bstash = [dict() for _ in range(S)]
    gacc: list = [None] * C
    hacc = [torch.zeros(p.shape, dtype=F32, device=p.device) for p in hp_leaves]
    dxs = torch.zeros(xs.shape, dtype=F32, device=first)
    ce = torch.zeros((), dtype=F32, device=last)
    aux = torch.zeros((), dtype=F32, device=first)

    for t in range(sched.n_ticks):
        arrive_f, arrive_b = {}, {}
        for s in range(S):
            dev = devices[s]
            # ---- forward unit
            fc = int(sched.f_chunk[t, s])
            if fc >= 0:
                fm = int(sched.f_micro[t, s])
                x = xs[fm].to(dev) if fc == 0 else fstash[s][int(sched.f_slot[t, s])]
                with torch.no_grad():
                    y, _ = body_fn(chunk_params[fc], x)
                if fc < C - 1:
                    r = (s + 1) % S
                    arrive_f[r] = (int(sched.f_wslot[t, r]), y)
            # ---- backward unit: recompute at the stashed input, then its VJP
            bc = int(sched.b_chunk[t, s])
            if bc < 0:
                continue
            bm = int(sched.b_micro[t, s])
            x_b = xs[bm].to(dev) if bc == 0 else fstash[s].pop(int(sched.b_xslot[t, s]))
            x_b = x_b.detach().requires_grad_(True)
            p_leaves, p_skel = _leaves(chunk_params[bc])
            p_leaves = [p.detach().requires_grad_(True) for p in p_leaves]
            with torch.enable_grad():
                y_b, aux_b = body_fn(_unflatten(p_skel, p_leaves), x_b)
            if bc == C - 1:
                hp = [p.detach().requires_grad_(True) for p in hp_leaves]
                yh = y_b.detach().requires_grad_(True)
                with torch.enable_grad():
                    ce_m = head_loss_fn(_unflatten(hp_skel, hp), yh, labels[bm].to(dev))
                *g_hp, dy_head = torch.autograd.grad(ce_m, hp + [yh])
                dy = (dy_head.to(F32) * inv_m[dev]).to(act)
                hacc = [h + g.to(F32) * inv_m[dev] for h, g in zip(hacc, g_hp)]
                ce = ce + ce_m.detach().to(F32)
            else:
                dy = bstash[s].pop(int(sched.b_dyslot[t, s]))
            outs, cts = [y_b], [dy]
            if aux_b.requires_grad:
                outs.append(aux_b)
                cts.append(aux_ct[dev])
            *dp, dx = torch.autograd.grad(outs, p_leaves + [x_b], cts, allow_unused=True)
            dp = [torch.zeros(p.shape, dtype=F32, device=p.device) if g is None else g.to(F32)
                  for p, g in zip(p_leaves, dp)]
            gacc[bc] = dp if gacc[bc] is None else [a + g for a, g in zip(gacc[bc], dp)]
            if bc == 0:
                dxs[bm] += dx.to(device=first, dtype=F32)
            else:
                r = (s - 1) % S
                arrive_b[r] = (int(sched.b_wslot[t, r]), dx.to(act))
            aux = aux + aux_b.detach().to(device=first, dtype=F32)
        # ---- ring shifts; an arrival with no slot is discarded
        for r, (slot, y) in arrive_f.items():
            if slot >= 0:
                fstash[r][slot] = y.to(devices[r])
        for r, (slot, dx) in arrive_b.items():
            if slot >= 0:
                bstash[r][slot] = dx.to(devices[r])

    g_chunks = [_unflatten(_leaves(chunk_params[c])[1], gacc[c]) for c in range(C)]
    return {"g_chunks": g_chunks, "g_head": _unflatten(hp_skel, hacc), "dxs": dxs,
            "ce": ce, "aux": aux}


# ==========================================================================
# layer-stack layouts
# ==========================================================================

def split_stages(stacked_params, n_stages: int):
    """(L, ...) layer-stacked leaves → (S, L/S, ...) for stage sharding."""
    def f(x):
        L = x.shape[0]
        assert L % n_stages == 0, (L, n_stages)
        return x.reshape(n_stages, L // n_stages, *x.shape[1:])
    return bucketing.tree_map(f, stacked_params)


def split_virtual(stacked_params, n_stages: int, n_virtual: int):
    """(L, ...) leaves → (V, S, L/(S·V), ...) round-robin chunk layout:
    chunk c = v·S + s lives at [v, s], and flattening (v, s, k) gives the
    canonical layer order back."""
    C = n_stages * n_virtual

    def f(x):
        L = x.shape[0]
        assert L % C == 0, (L, n_stages, n_virtual)
        return x.reshape(n_virtual, n_stages, L // C, *x.shape[1:])
    return bucketing.tree_map(f, stacked_params)


# ==========================================================================
# legacy standalone GPipe (forward scan; differentiable end to end)
# ==========================================================================

def stage_schedule(body_fn: Callable, stage_params: Sequence, xs: torch.Tensor, *,
                   n_stages: int, with_aux: bool = False, devices: Sequence = ()):
    """GPipe forward over ``n_stages`` stages of this rank: ``stage_params[s]``
    is stage s's params (on ``devices[s]``, default ``xs``' device), ``xs``
    (n_micro, ...) the microbatches. Bubble ticks run nothing (the
    reference computes them masked and discards them). Returns the last
    stage's outputs (n_micro, ...) and, ``with_aux``, Σ of the stages' aux."""
    S, M = n_stages, xs.shape[0]
    devs = list(devices) or [xs.device] * S
    prev: list = [None] * S
    outs: list = [None] * M
    aux = torch.zeros((), dtype=F32, device=xs.device)
    for t in range(M + S - 1):
        cur: list = [None] * S
        for s in range(S):
            m = t - s
            if not 0 <= m < M:
                continue
            inp = (xs[m] if s == 0 else prev[s - 1]).to(devs[s])
            res = body_fn(stage_params[s], inp)
            out, a = res if with_aux else (res, None)
            cur[s] = out
            if a is not None:
                aux = aux + a.to(device=xs.device, dtype=F32)
            if s == S - 1:
                outs[m] = out.to(xs.device)
        prev = cur
    out = torch.stack(outs)
    return (out, aux) if with_aux else out


def pipeline_apply(body_fn: Callable, staged_params, x_micro: torch.Tensor, *,
                   devices: Sequence = ()):
    """Run ``x_micro`` (n_micro, mb, ...) through the S-stage pipeline:
    ``staged_params`` leaves carry a leading stage dim (``split_stages``),
    ``body_fn(stage_params, x)`` applies one stage's layer chunk. Returns
    (n_micro, mb, ...)."""
    S = bucketing.tree_leaves(staged_params)[0].shape[0]
    devs = list(devices) or [x_micro.device] * S
    per_stage = [bucketing.tree_map(lambda p, s=s: p[s].to(devs[s]), staged_params)
                 for s in range(S)]
    return stage_schedule(body_fn, per_stage, x_micro, n_stages=S, devices=devs)


"""Mixture-of-Experts FFN with top-k routing (qwen3-moe, moonshot), the port
of ``repro.models.moe``.

Same function as the JAX package's GShard-style capacity dispatch: router
logits rounded to the storage dtype, then f32 softmax, top-k, gates
renormalised over the k, a capacity of C = max(⌊T·K/E·cf⌋, 1) rows per
expert, positions from a running count over the (token, slot)-flattened
assignments, overflow dropped; the aux load-balancing loss
E · Σ_e fe·me. Where the JAX package builds (T, E, C) one-hot dispatch and
combine tensors and multiplies them out (T·E·C·D multiply-adds, 671 MB a
tensor at qwen3's width and B 8 × L 512), the port moves rows by index:

* **routes** come from a stable descending sort of the probabilities, so a
  tie puts the lower expert first, as ``jax.lax.top_k`` does (``torch.topk``
  promises no order on ties; 128 experts over bf16 logits tie often);
* **dispatch** writes each kept (token, slot) row into its (expert, position)
  row of an (E·C, D) buffer: every row receives at most one token, so the
  result equals the one-hot product bit for bit. Dropped rows go to one
  spare row that is cut off;
* **combine** gathers ye[e, c] for each (token, slot) and sums over the k
  slots in f32 with the gate rounded to the storage dtype (the JAX
  package's ``combine.astype(x.dtype)``), then rounds once: the same terms
  as the one-hot product, summed in slot order (a dropped slot's gate is
  0). No ``index_add_`` (on the card its atomics leave the order of a sum
  to chance).

Capacity positions come from a stable sort of the (group, expert) keys
rather than a running sum over (T·K, E) one-hots: the same numbers.

The expert products are batched products with f32 output
(``layers.matmul_f32``), as the JAX package's ``preferred_element_type=f32``
einsums. ``moe_group_size`` splits the tokens into independent dispatch
groups (a leading group axis where the JAX package vmaps); the aux loss is
then the mean over the groups.

``record()`` collects each call's routes and kept mask (for the parity tests
and ``chip_smoke.py``'s dropped share); outside it nothing is recorded.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from repro_torch.distributed import collectives as coll
from repro_torch.models.layers import ACC, dense_init, matmul, matmul_f32, sharder

_RECORD: list | None = None


@contextlib.contextmanager
def record():
    """Collect every ``moe_apply`` call's routing as a dict of tensors:
    ``idx`` (G, T, K) experts, ``pos`` (G, T, K) capacity positions,
    ``keep`` (G, T, K) bool, ``capacity`` C."""
    global _RECORD
    prev, _RECORD = _RECORD, []
    try:
        yield _RECORD
    finally:
        _RECORD = prev


def moe_init(gen, cfg, dtype, repeats):
    """Parameters of ``repeats`` stacked MoE sublayers: router (R, D, E),
    we_gate / we_up (R, E, D, F), we_down (R, E, F, D)."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {"router": dense_init(gen, (repeats, d, e), dtype, scale=0.02),
            "we_gate": dense_init(gen, (repeats, e, d, f), dtype),
            "we_up": dense_init(gen, (repeats, e, d, f), dtype),
            "we_down": dense_init(gen, (repeats, e, f, d), dtype)}


def capacity(tokens: int, cfg) -> int:
    """Rows per expert of one dispatch group of ``tokens`` tokens."""
    return max(int(tokens * cfg.experts_per_token / cfg.n_experts * cfg.capacity_factor), 1)


def route(p, xt, cfg, dp=None):
    """Routing of token groups xt (G, T, D) → (probs (G,T,E) f32, idx
    (G,T,K), gates (G,T,K) f32 renormalised, pos (G,T,K) int64, keep
    (G,T,K) bool, C, assignments per expert (G, E) int64). Gates of dropped
    slots are not zeroed here.

    ``dp`` (a ``collectives.Axis``; one group, the rows of the global batch
    split over its ranks in rank order): the capacity comes from the global
    token count, each position counts the earlier assignments of every
    rank (the exclusive prefix of the per-expert counts over dp), and the
    counts are the global ones."""
    G, T, _ = xt.shape
    E, K = cfg.n_experts, cfg.experts_per_token
    logits = matmul(xt, p["router"]).to(ACC)                    # rounded to bf16 first
    probs = torch.softmax(logits, dim=-1)
    idx = torch.sort(probs, dim=-1, descending=True, stable=True).indices[..., :K]
    gates = torch.gather(probs, -1, idx)
    gates = gates / gates.sum(dim=-1, keepdim=True)
    C = capacity(T * (1 if dp is None else dp.size), cfg)
    # position of each (token, slot) in its expert's buffer: the count of
    # earlier assignments to that expert in (t, k) order (the JAX package's
    # cumsum over one-hots), as the rank in a stable sort by (group, expert)
    # (searchsorted, not bincount: nothing here reads the device back)
    key = (idx.reshape(G, T * K) + E * torch.arange(G, device=xt.device)[:, None]).reshape(-1)
    order = torch.argsort(key, stable=True)
    skey = key[order]
    bounds = torch.searchsorted(skey, torch.arange(G * E + 1, device=xt.device))
    rank = torch.arange(G * T * K, device=xt.device) - bounds[skey]
    pos = torch.empty_like(rank).scatter_(0, order, rank).reshape(G, T, K)
    counts = (bounds[1:] - bounds[:-1]).reshape(G, E)
    if dp is not None:
        before, counts = coll.exclusive_prefix(counts, dp)
        pos = pos + torch.gather(before, 1, idx.reshape(G, T * K)).reshape(G, T, K)
    return probs, idx, gates, pos, pos < C, C, counts


def check_groups(cfg, tokens: int, n_dp: int):
    """Raise when ``moe_group_size`` makes dispatch groups that straddle the
    dp ranks' rows (``tokens`` a rank, rows split over ``n_dp`` ranks)."""
    g_sz = _group_size(cfg, tokens * n_dp)
    if g_sz != tokens * n_dp and tokens % g_sz:
        raise ValueError(f"{cfg.name}: moe_group_size {g_sz} over {tokens} tokens a dp rank: "
                         f"dispatch groups that straddle dp ranks are not ported yet "
                         f"(ROADMAP.md Queue 1 item 7b)")


def _group_size(cfg, tokens: int) -> int:
    g_sz = cfg.moe_group_size or tokens
    return tokens if tokens % g_sz else g_sz


def moe_apply(p, x, cfg):
    """x (B, L, D) → (out (B, L, D), aux-loss scalar f32).

    On a grid whose batch rows are split over dp (``GridSharder.dp_rows``)
    one dispatch group is the GLOBAL batch, as the JAX function routes it:
    capacity, positions and the aux loss's sums are taken over dp. Groups of
    ``moe_group_size`` that fall inside a rank's rows stay rank-local; the
    aux loss is then the mean over every rank's groups. Where the experts
    are split over "model" the output is this rank's f32 partial (its
    experts' rows), summed over "model" at the sublayer's boundary."""
    B, L, D = x.shape
    T = B * L
    sh = sharder()
    dp = None if sh is None else sh.dp_rows
    n_dp = 1 if dp is None else dp.size
    check_groups(cfg, T, n_dp)
    g_sz = _group_size(cfg, T * n_dp)
    if g_sz == T * n_dp:                 # one group: the global batch
        out, aux = _moe_dispatch(p, x.reshape(1, T, D), cfg, dp)
        return out.reshape(B, L, D), aux[0]
    out, aux = _moe_dispatch(p, x.reshape(T // g_sz, g_sz, D), cfg)
    aux = aux.mean() if dp is None else coll.reduce_to(aux.sum(), dp, role="moe_dp") \
        / (T * n_dp // g_sz)
    return out.reshape(B, L, D), aux


def dispatch(xt, idx, pos, keep, C: int, E: int):
    """The expert batch xe (G, E, C, D): each kept (t, k) row of xt goes to
    row (e, pos) of its group's buffer, every other row is zero (the JAX
    package's one-hot dispatch product, bit for bit). Also returns each
    (t, k)'s flat row (G·E·C for a dropped one), which ``combine`` reads."""
    G, T, D = xt.shape
    K = idx.shape[-1]
    grp = torch.arange(G, device=xt.device)[:, None, None]
    slot = torch.where(keep, (grp * E + idx) * C + pos, G * E * C).reshape(-1)
    # in f32: the values are exact, and the gradient of a token sums its k
    # rows in f32, as the one-hot product's transpose does. Dropped rows all
    # land on the spare last row, which is cut off
    src = xt.to(ACC)[:, :, None, :].expand(G, T, K, D).reshape(-1, D)
    buf = torch.zeros((G * E * C + 1, D), dtype=ACC, device=xt.device)
    buf = buf.index_put((slot,), src)
    return buf[:-1].reshape(G, E, C, D).to(xt.dtype), slot


def _moe_dispatch(p, xt, cfg, dp=None):
    """Capacity-bounded top-k dispatch over G token groups xt (G, T, D) →
    (out (G, T, D), aux (G,) f32); ``dp``: ``route``'s.

    Expert parallelism: a rank holding E/tp experts (``we_*`` a block of
    the expert dim over "model", from ``model_rank · E/tp``) routes every
    token (the input is replicated over "model"), dispatches the (token,
    slot)s of its experts only and returns the f32 partial combine (gates
    times its rows, zero for the other slots). Two sums keep the router's
    gradient whole: the gates where they enter the combine take their
    gradient summed over "model" (each rank's part covers its experts), and
    the router's input takes its gradient on model rank 0 only, since the
    boundary sums the input's gradient over "model" and every rank computes
    the router's part whole. The aux loss's part is whole on every rank and
    is never summed."""
    G, T, D = xt.shape
    E, K = cfg.n_experts, cfg.experts_per_token
    sh = sharder()
    E_loc = p["we_gate"].shape[-3]
    split = sh is not None and E_loc < E
    e0 = sh.block_start(E_loc, E) if split else 0
    xr = coll.count_once(xt, sh.model) if split else xt
    probs, idx, gates, pos, keep, C, counts = route(p, xr, cfg, dp)
    if _RECORD is not None:
        _RECORD.append({"idx": idx, "pos": pos, "keep": keep, "capacity": C})
    gates = gates * keep
    if split:
        local = (idx >= e0) & (idx < e0 + E_loc)
        gates = coll.copy_to(gates, sh.model) * local
        keep = keep & local
    xe, slot = dispatch(xt, idx - e0, pos, keep, C, E_loc)

    # expert products, one batched product per weight over (E, G·C) rows
    xe = xe.transpose(0, 1).reshape(E_loc, G * C, D)
    g = matmul_f32(xe, p["we_gate"])
    u = matmul_f32(xe, p["we_up"])
    h = (F.silu(g) * u).to(xt.dtype)
    ye = matmul_f32(h, p["we_down"], out_dtype=xt.dtype)       # (E, G·C, D)
    ye = ye.reshape(E_loc, G, C, D).transpose(0, 1).reshape(G * E_loc * C, D)

    # a dropped (t, k) reads some real row times its zero gate: spread over
    # the rows, so that no row is read by thousands of (t, k) (the gather's
    # backward sums a row's readers one after another)
    n_rows = G * E_loc * C
    spread = torch.arange(G * T * K, device=xt.device) % n_rows
    rows = ye[torch.where(slot < n_rows, slot, spread)].reshape(G, T, K, D)
    w = gates.to(xt.dtype).to(ACC)
    out = (w[..., None] * rows.to(ACC)).sum(dim=2)
    if not split:
        out = out.to(xt.dtype)

    # GShard aux loss: E · Σ_e (fraction of assignments to e) · (mean prob of e)
    if dp is None:
        me = probs.mean(dim=1)                                   # (G, E)
    else:
        me = coll.reduce_to(probs.sum(dim=1), dp, role="moe_dp") / (T * dp.size)
    fe = counts.to(ACC) / (T * K * (1 if dp is None else dp.size))
    aux = E * (fe * me).sum(dim=-1)
    return out, aux


def moe_decode_apply(p, x, cfg):
    """The decode path's MoE: the same capacity dispatch over the step's
    tokens."""
    return moe_apply(p, x, cfg)

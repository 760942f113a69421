"""The orders the CUDA kernels rely on, checked on the CPU: no card needed.

* The Collage update's warp path (``csrc/collage_update/collage_update.cu``,
  tiles of br ≤ 8 rows of 128) sums each tile's metric values in registers
  and by warp shuffles, not level by level in shared memory. A torch model
  of its lane mapping and its level order (quarters inside a lane, then
  shuffles between lanes, then the br values of lane 0) must give
  ``bucketing.det_sum``'s bits on tiles whose values span 1e-30 to 1e30
  with mixed signs, where any other order of the additions shows.
* Its sum over the tiles runs det_sum's first levels for every output
  entry at once (a tree a warp, then one block for the rest); a torch model
  of those trees must give ``bucketing.det_sum``'s bits.
* The flash dK/dV kernel (``csrc/flash_attention/flash_bwd.cu`` with
  ``tile_ring.cuh``) runs one key tile a block over a band of query tiles,
  heaviest key tile first, and masks elements only on edge tiles. A Python
  mirror of ``key_band``, ``key_tile`` and ``edge_tile_kv`` is held against
  the element mask at every ``chip_smoke.KERNEL_SHAPES`` entry.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from repro_torch.core import bucketing

# ---------------------------------------------------------------------------
# the Collage update's tile sum, one warp a tile
# ---------------------------------------------------------------------------

LANES = 128
WARP = 32


def warp_tile_sum(x: torch.Tensor, br: int) -> torch.Tensor:
    """The warp path's sum of one (br × 128) tile, in the kernel's order.
    Lane l holds elements 32·br·c + br·l + j of quarter c (j < br); the
    quarters come in the order 0, 2, 1, 3, summed as (x0 + x2) + (x1 + x3);
    then ``acc += __shfl_down_sync(acc, off)`` for off 16, 8, 4, 2, 1 (a
    lane past 32 − off reads its own value, as the hardware gives); then
    lane 0 sums its br values in det_sum order in registers."""
    q = x.reshape(4, WARP, br)                   # [quarter, lane, j]
    acc = (q[0] + q[2]) + (q[1] + q[3])
    for off in (16, 8, 4, 2, 1):
        down = torch.cat([acc[off:], acc[WARP - off:]])   # shfl_down: out of range → own
        acc = acc + down
    regs = list(acc[0])
    n = br
    while n > 1:                                 # det_sum_regs<BR>
        half = n // 2
        for i in range(half):
            regs[i] = regs[i] + regs[i + half]
        if n & 1:
            regs[0] = regs[0] + regs[n - 1]
        n = half
    return regs[0]


def _mixed_tile(n, seed):
    """Signs mixed; magnitudes 1e-30 to 1e30 (even seeds), where the large
    terms decide the sum, or 1e-2 to 1e2 (odd seeds), where nearly every
    addition rounds."""
    rng = np.random.default_rng(seed)
    mag = 10.0 ** (rng.uniform(-30, 30, n) if seed % 2 == 0 else rng.uniform(-2, 2, n))
    return torch.from_numpy((rng.choice([-1.0, 1.0], n) * mag).astype(np.float32))


@pytest.mark.parametrize("br", range(1, 9))
def test_warp_tile_sum_is_det_sum_bit_for_bit(br):
    n = br * LANES
    sequential_differs = False
    for seed in range(40):
        x = _mixed_tile(n, 100 * br + seed)
        want = bucketing.det_sum(x)
        got = warp_tile_sum(x, br)
        assert got.view(torch.int32) == want.view(torch.int32), (br, seed)
        seq = torch.tensor(0.0, dtype=torch.float32)
        for v in x:
            seq = seq + v
        sequential_differs |= bool(seq.view(torch.int32) != want.view(torch.int32))
    # the inputs are hard enough that an order other than det_sum's shows
    assert sequential_differs


def warp_tree(x: torch.Tensor, idx: torch.Tensor, i: int, n: list) -> torch.Tensor:
    """collage_update.cu warp_tree for many idx at once: y_i[idx] (idx ≥ 1)
    as the tree of its 2^i leaves idx + Σ b_l·n_l, c = (b_i … b_1) in
    binary. Lane l of the warp takes the run of 2^(i−5) consecutive c from
    l·2^(i−5) (one c a lane when i < 5) and merges it as a binary counter;
    then ``t += __shfl_down_sync(t, off)`` for off 1, 2, 4, … below the
    lanes in use, and lane 0 holds the sum."""
    lanes, per = (32, 1 << (i - 5)) if i >= 5 else (1 << i, 1)
    t = []
    for lane in range(lanes):
        stk = {}
        for u in range(per):
            c = lane * per + u
            off = idx + sum(((c >> (l - 1)) & 1) * n[l] for l in range(1, i + 1))
            a, lvl, cc = x[off], 0, u
            while cc & 1:
                a = stk[lvl] + a
                lvl, cc = lvl + 1, cc >> 1
            stk[lvl] = a
        t.append(stk[max(i - 5, 0)])
    off = 1
    while off < lanes:
        t = [t[k] + t[k + off] if k + off < lanes else t[k] for k in range(lanes)]
        off *= 2
    return t[0]


def finish_sum(x: torch.Tensor, rows: int = 2048) -> torch.Tensor:
    """collage_update.cu's sum over the tiles: the trees of det_sum's first K
    levels, one warp each (collage_finish_levels), then y_K[0] from x[0] and
    its extra terms and det_sum's remaining levels (collage_finish)."""
    n = [x.shape[0]]
    while n[-1] > rows:
        n.append(n[-1] >> 1)
    K = len(n) - 1
    if K == 0:
        return bucketing.det_sum(x)
    y = torch.empty(n[K], dtype=x.dtype)
    y[1:] = warp_tree(x, torch.arange(1, n[K]), K, n)
    y0 = x[0]
    for l in range(K):
        y0 = y0 + warp_tree(x, torch.tensor([n[l + 1]]), l, n)[0]
        if n[l] & 1:
            y0 = y0 + warp_tree(x, torch.tensor([n[l] - 1]), l, n)[0]
    y[0] = y0
    return bucketing.det_sum(y)


@pytest.mark.parametrize("tiles", [1, 7, 2048, 2049, 4099, 8191, 158_349])
def test_update_sum_over_tiles_is_det_sum_bit_for_bit(tiles):
    """158,349 is gpt-125m's bucket at br 8; the others put odd lengths at
    the first levels, at the last one done at once and past it."""
    for seed in range(4):
        x = _mixed_tile(tiles, 7 * tiles + seed)
        got, want = finish_sum(x), bucketing.det_sum(x)
        assert got.view(torch.int32) == want.view(torch.int32), (tiles, seed)


# ---------------------------------------------------------------------------
# the flash dK/dV kernel's band, order and edge tiles
# ---------------------------------------------------------------------------

TILE = 64


def key_band(k0, L, causal, window):
    """tile_ring.cuh key_band: the query tiles [lo, hi) of key tile k0."""
    nq = -(-L // TILE)
    lo = k0 // TILE if causal else 0
    hi = min(nq, (k0 + TILE + window - 2) // TILE + 1) if window else nq
    return lo, hi


def key_tile(rank, nk, causal):
    """tile_ring.cuh key_tile: the key tile of grid rank ``rank``."""
    return rank if causal else nk - 1 - rank


def edge_tile_kv(k0, q0, L, causal, window):
    """tile_ring.cuh edge_tile_kv: True where the kernel masks elements."""
    return (q0 + TILE > L or (causal and k0 + TILE - 1 > q0)
            or bool(window and k0 <= q0 + TILE - 1 - window))


def _valid(L, causal, window):
    """The element mask's complement on the padded (query, key) grid:
    valid[q, k] where the pair contributes (both inside L, causal, window)."""
    n = -(-L // TILE) * TILE
    q = np.arange(n)[:, None]
    k = np.arange(n)[None, :]
    valid = (q < L) & (k < L)
    if causal:
        valid &= k <= q
    if window:
        valid &= k > q - window
    return valid


@pytest.mark.parametrize("shape", chip_smoke.KERNEL_SHAPES, ids=lambda s: s[0])
def test_dkv_band_order_and_edge_tiles_match_the_element_mask(shape):
    _, _, _, _, L, _, causal, window = shape
    nk = -(-L // TILE)
    valid = _valid(L, causal, window)
    tiles = [key_tile(r, nk, causal) for r in range(nk)]
    assert sorted(tiles) == list(range(nk))                  # every key tile once
    sizes = [np.subtract(*key_band(t * TILE, L, causal, window)[::-1]) for t in tiles]
    assert all(a >= b for a, b in zip(sizes, sizes[1:]))     # heaviest band first
    for kt in range(nk):
        k0 = kt * TILE
        lo, hi = key_band(k0, L, causal, window)
        assert 0 <= lo < hi <= nk
        for qt in range(nk):
            q0 = qt * TILE
            block = valid[q0:q0 + TILE, k0:k0 + TILE]
            if not lo <= qt < hi:
                assert not block.any(), (kt, qt)             # outside the band: no valid pair
            elif not edge_tile_kv(k0, q0, L, causal, window):
                # interior: every pair counts, for the keys that are stored
                # (key rows at or past L are computed unmasked, never stored)
                assert block[:, :max(0, min(TILE, L - k0))].all(), (kt, qt)

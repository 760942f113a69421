// Shared pieces of the flash-attention kernels for Hopper (sm_90a): the
// swizzled shared-memory tile layout, the cp.async K/V ring, the wgmma
// products on those tiles, the causal/window band of a query tile (and of
// a key tile), their heavy-first order and the tests for tiles that need
// an element mask.
//
// Tile layout. Every tile is 64 rows of a row-major (L, dh) bf16 matrix,
// stored as dh / 64 column halves of 64 rows x 128 bytes; within a half the
// 16-byte chunk j of row r sits at chunk j ^ (r % 8): the 128-byte swizzle
// that a wgmma shared-memory descriptor names. So one stored copy of a tile
// serves as a K-major operand (Q and dO as A, K and V as B of Q K^T and
// dO V^T: the reduction runs along the rows) and as an MN-major one (V of
// P V, K of dS K: the reduction runs down the rows, wgmma's "transposed B");
// no tile is ever stored twice or transposed by a thread.
//
// The ring. NSTAGE stages of one K and one V tile each (for dK/dV: one Q
// and one dO tile and the tile's LSE and D rows); every thread of the
// block starts its share of 16-byte cp.async copies of a stage and commits
// them as one group, and waits with cp.async.wait_group NSTAGE - 2, so tiles
// k + 1 and k + 2 are in flight while tile k is multiplied. One
// __syncthreads a tile both publishes the arrived tile and frees the stage
// the previous tile used. Rows at or past L are zero-filled by the copy
// itself (a source size of 0), so the ragged edge needs no branch. cp.async
// rather than TMA: a TMA tensor map is encoded on the host for every shape
// and pointer; the 16-byte copies need nothing but the pointers.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

typedef __nv_bfloat16 bf16;

constexpr int TILE = 64;          // rows of a query tile and of a key tile
constexpr int NWARPS = 4;         // 16 query rows each: one warpgroup of 64 rows
constexpr int NTHREADS = NWARPS * 32;
constexpr int NSTAGE = 3;         // K/V ring depth
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <int DH>
__host__ __device__ constexpr uint32_t tile_bytes() { return TILE * DH * 2; }

// Byte offset of element (r, c) (c a multiple of 8 for a chunk address).
template <int DH>
__device__ __forceinline__ uint32_t swz(int r, int c) {
    return (uint32_t)((c >> 6) * (TILE * 128) + r * 128 + ((((c >> 3) & 7) ^ (r & 7)) << 4) +
                      (c & 7) * 2);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The block's dynamic shared memory as a shared-window address. The
// 128-byte swizzle (ours and wgmma's) is a function of address bits 4-9, so
// every tile must start on 1024 bytes: the window's base does (no static
// shared memory precedes it), and a kernel that ever finds otherwise stops
// rather than compute on a misread layout. No slack is allocated for
// re-aligning: at dh 64 that slack would cost the forward its fourth block
// on an SM.
__device__ __forceinline__ uint32_t smem_base(const void* dyn) {
    const uint32_t base = smem_u32(dyn);
    if (base & 1023u) __trap();
    return base;
}

// 2^x by the SFU (flush-to-zero; 2^-inf = 0): the one transcendental of the
// softmax and of the backward's probabilities
__device__ __forceinline__ float ex2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
                 "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// 4-byte copy (cp.async.cg takes only 16): a row's LSE or D, whose
// addresses are 4-byte aligned only when L is ragged
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
                 "r"(valid ? 4 : 0));
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Start (not wait for) the copy of rows [r0, r0 + TILE) of the (L, DH)
// row-major matrix `src` into the swizzled tile at shared address `dst`,
// shared among the NT threads tid = 0 .. NT - 1.
template <int DH, int NT = NTHREADS>
__device__ __forceinline__ void load_tile_async(uint32_t dst, const bf16* __restrict__ src, int r0,
                                                int L, int tid) {
    constexpr int CH = DH / 8;
    static_assert(TILE * CH % NT == 0, "threads must divide the tile's chunks");
#pragma unroll
    for (int it = 0; it < TILE * CH / NT; ++it) {
        const int i = tid + it * NT;
        const int r = i / CH, c = (i % CH) * 8;
        const bool in = r0 + r < L;
        cp_async16(dst + swz<DH>(r, c), src + (size_t)(in ? r0 + r : 0) * DH + c, in);
    }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x (low half) = lo
    return *reinterpret_cast<uint32_t*>(&v);
}

// The C fragments of key columns [16 kk, 16 kk + 16), rounded to bf16, are
// exactly the register A fragment of that k-step of wgmma's P . B.
__device__ __forceinline__ void a_frag(uint32_t a[4], const float p[TILE / 8][4], int kk) {
    a[0] = pack_bf16(p[2 * kk][0], p[2 * kk][1]);
    a[1] = pack_bf16(p[2 * kk][2], p[2 * kk][3]);
    a[2] = pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]);
    a[3] = pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3]);
}

// Write a warp's 16 rows x DH of f32 accumulators (C fragments, times
// mul[0] for row g and mul[1] for row g + 8) as bf16 rows [q0 + 16 warp,
// + 16) of `out` (row stride DH), skipping rows at or past L. The rows go
// through the warp's own rows of the swizzled tile `stage` (which no other
// warp reads) so that the device-memory stores are 16 bytes wide.
template <int DH>
__device__ __forceinline__ void store_rows(const float acc[DH / 8][4], const float mul[2],
                                           uint32_t stage, bf16* __restrict__ out, int q0, int L,
                                           int warp, int lane) {
    const int r0 = warp * 16 + (lane >> 2), t4 = lane & 3;
#pragma unroll
    for (int nd = 0; nd < DH / 8; ++nd) {
#pragma unroll
        for (int row = 0; row < 2; ++row) {
            const uint32_t val = pack_bf16(acc[nd][2 * row] * mul[row],
                                           acc[nd][2 * row + 1] * mul[row]);
            asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(stage + swz<DH>(r0 + 8 * row, nd * 8) +
                                                             t4 * 4),
                         "r"(val));
        }
    }
    __syncwarp();
    constexpr int CH = DH / 8;
#pragma unroll
    for (int it = 0; it < 16 * CH / 32; ++it) {
        const int i = lane + it * 32;
        const int r = warp * 16 + i / CH, c = (i % CH) * 8;
        if (q0 + r < L) {
            uint4 val;
            asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
                         : "=r"(val.x), "=r"(val.y), "=r"(val.z), "=r"(val.w)
                         : "r"(stage + swz<DH>(r, c)));
            *reinterpret_cast<uint4*>(out + (size_t)(q0 + r) * DH + c) = val;
        }
    }
}

// ---- wgmma (one warpgroup; every product here is m64n64k16, bf16 in, f32
// accumulators; d[4 j + e] is the C-fragment entry e of columns 8 j .. 8 j + 7,
// the mma.sync m16n8 layout of the warp's 16 rows)

// Shared-memory matrix descriptor of a swizzled tile (128-byte swizzle).
// Both byte offsets are 1024 (one 8-row group of 128-byte rows): for the
// K-major operands (the reduction runs along the 128-byte row) only the
// stride between 8-row groups is read; for the MN-major ones (V and the K
// of dS K: the reduction runs down the rows, and 64 columns fill one
// swizzle atom) it is the step from one 8-row group to the next as well.
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr) {
    return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)(1024 >> 4) << 16) |
           ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wg_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Make the compiler treat the registers as written here (after a wait):
// it must not read an accumulator before the asynchronous product is done.
template <int N>
__device__ __forceinline__ void wg_touch(float* d) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Generic shared-to-async proxy fence: cp.async writes are generic-proxy
// stores, wgmma reads its shared operands through the async proxy.
__device__ __forceinline__ void fence_async_smem() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d (64 x 64) (+)= A . B^T, A (64 x 16) and B (64 x 16) K-major in shared
// memory; scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 64) += A . B, A (64 x 16) from registers (a: the m16n8k16 A
// fragment of the warp's 16 rows), B (16 x 64) MN-major in shared memory
// (a row-major tile read down its rows).
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t a[4], uint64_t db) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// Byte offset of the k-step ks (16 columns) of a K-major tile: the column
// half, then 32 bytes a step inside the swizzled 128-byte rows (the
// hardware applies the swizzle to the full address, so the step is plain).
__device__ __forceinline__ uint32_t kstep(int ks) {
    return (ks >> 2) * (TILE * 128) + (ks & 3) * 32;
}

// s (64 x 64) = A . B^T over DH, A and B swizzled K-major tiles (launch
// only: the caller fences, commits and waits).
template <int DH>
__device__ __forceinline__ void wg_abt(float s[TILE / 8][4], uint32_t a, uint32_t b) {
#pragma unroll
    for (int ks = 0; ks < DH / 16; ++ks)
        wgmma_ss(&s[0][0], wg_desc(a + kstep(ks)), wg_desc(b + kstep(ks)), ks > 0);
}

// acc (64 x DH) += P . B, P given as its four bf16 A fragments (one per
// k-step of 16 keys) in registers, B a row-major 64 x DH tile read down its
// rows (MN-major: V, or the K of dS K), one 64-column half per product
// (launch only: the caller fences, commits and waits). The fragments are
// packed before the fence: a register written between two products of
// one batch makes ptxas serialise them.
template <int DH>
__device__ __forceinline__ void wg_pv(float acc[DH / 8][4], const uint32_t pa[TILE / 16][4],
                                      uint32_t b) {
#pragma unroll
    for (int kk = 0; kk < TILE / 16; ++kk) {
#pragma unroll
        for (int half = 0; half < DH / 64; ++half)
            wgmma_rs(&acc[8 * half][0], pa[kk], wg_desc(b + half * (TILE * 128) + kk * 16 * 128));
    }
}

// The key tiles [lo, hi) that query tile [q0, q0 + TILE) reaches: up to the
// diagonal when causal, from the window's lower edge (the floor-divide of
// max(q0 - window + 1, 0), as the TPU kernel's _band_lo_block) when
// window > 0.
__device__ __forceinline__ void band(int q0, int L, int causal, int window, int& lo, int& hi) {
    const int nk = (L + TILE - 1) / TILE;
    hi = causal ? min(nk, q0 / TILE + 1) : nk;
    lo = window ? max(q0 - window + 1, 0) / TILE : 0;
}

// Heavy first: blocks start in rank order, so rank 0 takes the query tile
// with the longest band. Causal: the last tile (bands grow with the tile; a
// window caps them, and its light tiles are the first ones). Not causal:
// bands only shrink with the tile (a window cuts their start), so tile 0.
__device__ __forceinline__ int query_tile(int rank, int nq, int causal) {
    return causal ? nq - 1 - rank : rank;
}

// True when some (query, key) pair of the tiles is masked: the key tile
// crosses the diagonal, the window's lower edge or L. Interior tiles skip
// the element mask. (Query rows at or past L are never stored.)
__device__ __forceinline__ bool edge_tile(int q0, int k0, int L, int causal, int window) {
    return k0 + TILE > L || (causal && k0 + TILE - 1 > q0) ||
           (window && k0 <= q0 + TILE - 1 - window);
}

__device__ __forceinline__ bool masked(int qpos, int kpos, int L, int causal, int window) {
    return kpos >= L || (causal && kpos > qpos) || (window && kpos <= qpos - window);
}

// ---- the transpose, for dK/dV: a fixed key tile, streamed query tiles ----

// The query tiles [lo, hi) that key tile [k0, k0 + TILE) reaches: from the
// diagonal when causal, up to the tile of the last query inside the window
// (qpos <= kpos + window - 1) when window > 0, as the TPU kernel's
// _dkv_kernel bounds its query loop.
__device__ __forceinline__ void key_band(int k0, int L, int causal, int window, int& lo,
                                         int& hi) {
    const int nq = (L + TILE - 1) / TILE;
    lo = causal ? k0 / TILE : 0;
    hi = window ? min(nq, (k0 + TILE + window - 2) / TILE + 1) : nq;
}

// Heavy first: causal bands only shrink as the key tile grows (the
// diagonal starts them later; a window caps them and L cuts the last
// ones), so rank 0 takes key tile 0; not causal, bands only grow with the
// tile (a window ends them earlier for the first tiles), so the last.
__device__ __forceinline__ int key_tile(int rank, int nk, int causal) {
    return causal ? rank : nk - 1 - rank;
}

// True when some (query, key) pair of the tiles is masked or lies past L
// on the query side: the query tile crosses L, or the pair of tiles
// crosses the diagonal or the window's lower edge. dK and dV sum over the
// queries, and the ring zero-fills query rows at or past L (their LSE and
// D too), so those rows must be masked; key rows at or past L are never
// stored. Interior tiles skip the element mask.
__device__ __forceinline__ bool edge_tile_kv(int k0, int q0, int L, int causal, int window) {
    return q0 + TILE > L || (causal && k0 + TILE - 1 > q0) ||
           (window && k0 <= q0 + TILE - 1 - window);
}

__device__ __forceinline__ bool masked_kv(int qpos, int kpos, int L, int causal, int window) {
    return qpos >= L || masked(qpos, kpos, L, causal, window);
}

}  // namespace flash

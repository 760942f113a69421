// Flash-attention backward for Hopper (sm_90a): dQ, and dK/dV summed over
// each GQA group, recomputing the probabilities from the row log-sum-exp.
//
// Replaces: src/repro/kernels/flash_attention/flash_attention.py::_dq_kernel
// and ::_dkv_kernel (the Pallas TPU kernels launched by _bwd_call). Same
// function and conventions: p = exp(s - lse) with s = scale * q.k, masked
// pairs (causal kpos > qpos, window kpos <= qpos - window, the ragged edge
// kpos >= L or qpos >= L) contribute exactly p = 0, and a row whose LSE is
// +1e30 (no key reaches it) gives exp(s - 1e30) = 0; ds = p * (dO.v - D);
// dQ = scale * sum_k ds k, dV = sum_q p dO, dK = scale * sum_q ds q. kv
// head = h / (H / Hkv). One departure: the TPU code takes D = rowsum(dO * O)
// from the stored O; here the dQ kernel computes D = sum_k p (dO.v) itself,
// in a first pass over the same tiles, and hands it to the dK/dV kernel
// (equal in exact arithmetic; see the dQ kernel for why).
// Outputs are bf16 (the dtype of q, k, v: the autograd wrapper casts to
// that anyway), accumulated in f32 registers.
//
// What bounds it on the H100: at the training shape (B 8, H 12, L 512,
// dh 64, causal) the pair reads q, k, v, dO and LSE, passes D from one
// kernel to the other and writes dQ, dK, dV: ~45 MB, ~14 us at 3.35 TB/s,
// while its seven products over the 12.6 M valid (q, k) pairs (S and dP
// twice in the dQ kernel) are ~11 GFLOP, ~11 us at 989 TFLOP/s. So bytes
// bound it, as the forward; the designs' job is to stream tiles through
// shared memory and never write scores or probabilities to device memory.
//
// dQ kernel (the forward's structure; tile_ring.cuh):
//  * one block of one warpgroup per (64-query tile, head, batch), grid
//    (B * H, query tiles) heaviest tile first; Q and dO stay in shared
//    memory;
//  * both sweeps over the K/V band (pass 1: D = sum_k p dp; pass 2: dS =
//    p (dp - D), dQ += dS K) run through one 3-stage cp.async ring, pass
//    2's first tiles loading while pass 1 ends (one (b, h)'s K and V are
//    128 KB: pass 2 reads them from L2);
//  * S = Q K^T and dP = dO V^T are wgmma with both operands in shared
//    memory; dQ += dS K is wgmma with dS from registers and K read down its
//    rows through a transposed descriptor (no transposed copy of K);
//  * p = 2^(s * log2(e) / sqrt(dh) - lse * log2(e)) is one FFMA and one
//    ex2.approx; only edge tiles take the element mask.
//
// dK/dV kernel (mma.sync tiles with padded rows):
//  * 64 x 64 tiles, 4 warps per block, each warp owns 16 rows of the
//    block's own tile; products are mma.sync.m16n8k16 bf16 with f32
//    accumulators; P and dS are rounded to bf16 only as A operands;
//  * one block per (64-key tile, kv head, batch); loops over the GQA
//    group's query heads and, for each, over the query tiles the band
//    reaches (from _dkv_kernel: lo = first tile at or after the key tile
//    when causal, hi = the tile of the last query inside the window),
//    accumulating in registers: no atomics, so results are deterministic;
//    works on transposed scores (keys as rows), with Q and dO also stored
//    transposed for the P^T.dO and dS^T.Q products;
//  * the ragged edge is masked in the kernel (rows and keys >= L read as
//    zeros, are masked, and are never stored), so any L runs unpadded;
//  * rows of shared-memory tiles are padded by 8 elements so fragment
//    loads hit 32 distinct banks.
//
// C entries: flash_bwd_dq_bf16(...), flash_bwd_dkv_bf16(...) return
// cudaGetLastError() after the launch.

#include "tile_ring.cuh"

namespace {

constexpr int BM = 64;         // rows of the block's own tile
constexpr int BN = 64;         // rows of each streamed tile
constexpr int NWARPS = BM / 16;
constexpr int NTHREADS = NWARPS * 32;
constexpr int PAD = 8;
constexpr int TS = BN + PAD;   // row stride of a transposed tile
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ void mma_bf16_16816(float c[4], const uint32_t a[4], uint32_t b0,
                                               uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld_pair(const bf16* p) {
    return *reinterpret_cast<const uint32_t*>(p);
}

// A fragment (16 rows from r0 - g, 16 columns from ks * 16) of a row-major tile
__device__ __forceinline__ void ld_a(uint32_t a[4], const bf16* t, int stride, int r0, int ks,
                                     int t4) {
    const int c = ks * 16 + t4 * 2;
    a[0] = ld_pair(t + r0 * stride + c);
    a[1] = ld_pair(t + (r0 + 8) * stride + c);
    a[2] = ld_pair(t + r0 * stride + c + 8);
    a[3] = ld_pair(t + (r0 + 8) * stride + c + 8);
}

// acc (16 x 64 per warp) += A (16 x DH, row-major tile `a`) . B^T where B
// is the row-major tile `b` (64 x DH): the S = Q K^T pattern.
template <int DH>
__device__ __forceinline__ void mma_abt(float acc[BN / 8][4], const bf16* a, const bf16* b,
                                        int r0, int g, int t4) {
    constexpr int RS = DH + PAD;
#pragma unroll
    for (int ks = 0; ks < DH / 16; ++ks) {
        uint32_t af[4];
        ld_a(af, a, RS, r0, ks, t4);
#pragma unroll
        for (int nt = 0; nt < BN / 8; ++nt) {
            const bf16* br = b + (nt * 8 + g) * RS + ks * 16 + t4 * 2;
            mma_bf16_16816(acc[nt], af, ld_pair(br), ld_pair(br + 8));
        }
    }
}

// acc (16 x DH per warp) += P (16 x 64, the C fragments `p`, rounded to
// bf16) . B where B (64 x DH) is given transposed in `bt` (DH x 64).
template <int DH>
__device__ __forceinline__ void mma_pb(float acc[DH / 8][4], float p[BN / 8][4],
                                       const bf16* bt, int g, int t4) {
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
        uint32_t pa[4];
        pa[0] = pack_bf16(p[2 * kk][0], p[2 * kk][1]);
        pa[1] = pack_bf16(p[2 * kk][2], p[2 * kk][3]);
        pa[2] = pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]);
        pa[3] = pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3]);
#pragma unroll
        for (int nd = 0; nd < DH / 8; ++nd) {
            const bf16* br = bt + (nd * 8 + g) * TS + kk * 16 + t4 * 2;
            mma_bf16_16816(acc[nd], pa, ld_pair(br), ld_pair(br + 8));
        }
    }
}

// Copy rows [r0, r0 + 64) of a (L, DH) matrix into a row-major tile (and,
// when `tt` is not null, its transpose); rows >= L read as zeros.
template <int DH>
__device__ __forceinline__ void load_tile(bf16* t, bf16* tt, const bf16* __restrict__ src,
                                          int r0, int L, int tid) {
    constexpr int RS = DH + PAD;
    constexpr int CH = DH / 8;
    for (int i = tid; i < BN * CH; i += NTHREADS) {
        const int r = i / CH, c = (i % CH) * 8;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (r0 + r < L) val = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * DH + c);
        *reinterpret_cast<uint4*>(t + r * RS + c) = val;
        if (tt) {
            const bf16* e = reinterpret_cast<const bf16*>(&val);
#pragma unroll
            for (int j = 0; j < 8; ++j) tt[(c + j) * TS + r] = e[j];
        }
    }
}

__device__ __forceinline__ bool masked(int qpos, int kpos, int L, int causal, int window) {
    return qpos >= L || kpos >= L || (causal && kpos > qpos) || (window && kpos <= qpos - window);
}

// ------------------------------------------------------------------ dQ --
namespace dqk {

// using-declarations, not a using-directive: the dK/dV helpers above share
// some of these names, and a directive's names would lose to theirs
using flash::band;
using flash::bf16;
using flash::cp_async_commit;
using flash::cp_async_wait;
using flash::edge_tile;
using flash::ex2;
using flash::LOG2E;
using flash::load_tile_async;
using flash::fence_async_smem;
using flash::masked;
using flash::NEG_INF;
using flash::NSTAGE;
using flash::NTHREADS;
using flash::query_tile;
using flash::smem_base;
using flash::store_rows;
using flash::TILE;
using flash::tile_bytes;
using flash::wg_abt;
using flash::wg_commit;
using flash::wg_fence;
using flash::wg_pv;
using flash::wg_touch;
using flash::wg_wait;

// p = exp2(s * scale_log2 - lse2) in place; on an edge tile masked pairs
// give exactly 0 (a row with LSE = +1e30 gives 0 everywhere by itself).
template <bool EDGE>
__device__ __forceinline__ void probs(float s[TILE / 8][4], float scale_log2, const float lse2[2],
                                      int k0, int t4, const int qpos[2], int L, int causal,
                                      int window) {
#pragma unroll
    for (int nt = 0; nt < TILE / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int kpos = k0 + nt * 8 + t4 * 2 + (e & 1);
            s[nt][e] = EDGE && masked(qpos[e >> 1], kpos, L, causal, window)
                           ? 0.f
                           : ex2(fmaf(s[nt][e], scale_log2, -lse2[e >> 1]));
        }
    }
}

template <int DH>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse, float* __restrict__ delta,
                    bf16* __restrict__ dq, int H, int Hkv, int L, int causal, int window,
                    float scale) {
    constexpr uint32_t TB = tile_bytes<DH>();
    extern __shared__ __align__(1024) unsigned char smem_raw[];
    const uint32_t Qs = smem_base(smem_raw);         // [Q][dO][K0 V0][K1 V1][K2 V2]
    const uint32_t dOs = Qs + TB;

    const int nq = (L + TILE - 1) / TILE;
    const int q0 = query_tile(blockIdx.y, nq, causal) * TILE;
    const int h = blockIdx.x % H, b = blockIdx.x / H;
    const int hk = h / (H / Hkv);
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const size_t q_base = (size_t)(b * H + h) * L * DH;
    const size_t row_base = (size_t)(b * H + h) * L;
    const bf16* kb = k + (size_t)(b * Hkv + hk) * L * DH;
    const bf16* vb = v + (size_t)(b * Hkv + hk) * L * DH;
    const float scale_log2 = scale * LOG2E;

    // Two sweeps over the band, one ring: step j < n is pass 1's tile
    // lo + j, step j >= n pass 2's tile lo + j - n (its first tiles load
    // while pass 1 ends; one (b, h)'s K and V are in L2 by then).
    int lo, hi;
    band(q0, L, causal, window, lo, hi);
    const int n = hi - lo;
    auto fetch = [&](int j) {
        const uint32_t st = Qs + TB * (2 + 2 * (j % NSTAGE));
        const int k0 = (lo + (j < n ? j : j - n)) * TILE;
        load_tile_async<DH>(st, kb, k0, L, tid);
        load_tile_async<DH>(st + TB, vb, k0, L, tid);
    };

    // Q and dO join the first key tile's group
    load_tile_async<DH>(Qs, q + q_base, q0, L, tid);
    load_tile_async<DH>(dOs, dout + q_base, q0, L, tid);
#pragma unroll
    for (int j = 0; j < NSTAGE - 1; ++j) {
        if (j < 2 * n) fetch(j);
        cp_async_commit();
    }

    const int r0 = warp * 16 + g;
    const int qpos[2] = {q0 + r0, q0 + r0 + 8};
    float lse2[2], dl[2] = {0.f, 0.f};
#pragma unroll
    for (int row = 0; row < 2; ++row)
        lse2[row] = qpos[row] < L ? lse[row_base + qpos[row]] * LOG2E : -NEG_INF;
    float acc[DH / 8][4];
#pragma unroll
    for (int nd = 0; nd < DH / 8; ++nd) acc[nd][0] = acc[nd][1] = acc[nd][2] = acc[nd][3] = 0.f;

    for (int j = 0; j < 2 * n; ++j) {
        cp_async_wait<NSTAGE - 2>();
        fence_async_smem();
        __syncthreads();
        if (j + NSTAGE - 1 < 2 * n) fetch(j + NSTAGE - 1);
        cp_async_commit();
        if (j == n) {
            // Pass 1 is done: D = sum_k p dp over the band, from the same f32
            // p and dp that pass 2 forms dS with, so each row of dS sums to
            // zero up to f32 rounding. (rowsum(dO * O) over the bf16-rounded
            // O shifts a whole row of dS by p times O's rounding error; where
            // the true dS is small, in trained layers, that shift dominates
            // dQ and dK.) The four lanes of a quad hold the same rows.
#pragma unroll
            for (int row = 0; row < 2; ++row) {
                dl[row] += __shfl_xor_sync(0xffffffffu, dl[row], 1);
                dl[row] += __shfl_xor_sync(0xffffffffu, dl[row], 2);
                if (t4 == 0 && qpos[row] < L) delta[row_base + qpos[row]] = dl[row];
            }
        }
        const uint32_t Ks = Qs + TB * (2 + 2 * (j % NSTAGE));
        const int k0 = (lo + (j < n ? j : j - n)) * TILE;

        float s[TILE / 8][4], dp[TILE / 8][4];
#pragma unroll
        for (int nt = 0; nt < TILE / 8; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
        wg_fence();
        wg_abt<DH>(s, Qs, Ks);                           // S = Q K^T
        wg_abt<DH>(dp, dOs, Ks + TB);                    // dP = dO V^T
        wg_commit();
        wg_wait<0>();
        wg_touch<TILE / 2>(&s[0][0]);
        wg_touch<TILE / 2>(&dp[0][0]);
        if (edge_tile(q0, k0, L, causal, window))
            probs<true>(s, scale_log2, lse2, k0, t4, qpos, L, causal, window);
        else
            probs<false>(s, scale_log2, lse2, k0, t4, qpos, L, causal, window);

        if (j < n) {
#pragma unroll
            for (int nt = 0; nt < TILE / 8; ++nt)
#pragma unroll
                for (int e = 0; e < 4; ++e) dl[e >> 1] += s[nt][e] * dp[nt][e];
        } else {
            // dS = p (dp - D); dQ += dS K, K read transposed from its tile
#pragma unroll
            for (int nt = 0; nt < TILE / 8; ++nt)
#pragma unroll
                for (int e = 0; e < 4; ++e) s[nt][e] *= dp[nt][e] - dl[e >> 1];
            uint32_t pa[TILE / 16][4];
#pragma unroll
            for (int kk = 0; kk < TILE / 16; ++kk) flash::a_frag(pa[kk], s, kk);
            wg_fence();
            wg_pv<DH>(acc, pa, Ks);
            wg_commit();
            wg_wait<0>();
            wg_touch<DH / 2>(&acc[0][0]);
        }
    }

    const float mul[2] = {scale, scale};
    store_rows<DH>(acc, mul, Qs, dq + q_base, q0, L, warp, lane);
}

}  // namespace dqk

// --------------------------------------------------------------- dK/dV --
template <int DH>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int Hkv, int L,
                     int causal, int window, float scale) {
    constexpr int RS = DH + PAD;
    extern __shared__ __align__(16) unsigned char smem[];
    bf16* Ks = reinterpret_cast<bf16*>(smem);     // [BM][RS]
    bf16* Vs = Ks + BM * RS;                       // [BM][RS]
    bf16* Qs = Vs + BM * RS;                       // [BN][RS]
    bf16* dOs = Qs + BN * RS;                      // [BN][RS]
    bf16* Qt = dOs + BN * RS;                      // [DH][TS]
    bf16* dOt = Qt + DH * TS;                      // [DH][TS]
    float* lse_s = reinterpret_cast<float*>(dOt + DH * TS);   // [BN], log2 domain
    float* d_s = lse_s + BN;                                   // [BN]

    const int k0 = blockIdx.x * BM, hk = blockIdx.y, b = blockIdx.z;
    const int group = H / Hkv;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const size_t kv_base = (size_t)(b * Hkv + hk) * L * DH;
    const float scale_log2 = scale * LOG2E;

    load_tile<DH>(Ks, nullptr, k + kv_base, k0, L, tid);
    load_tile<DH>(Vs, nullptr, v + kv_base, k0, L, tid);
    const int r0 = warp * 16 + g;
    const int kpos[2] = {k0 + r0, k0 + r0 + 8};

    float ak[DH / 8][4], av[DH / 8][4];
#pragma unroll
    for (int nd = 0; nd < DH / 8; ++nd)
#pragma unroll
        for (int e = 0; e < 4; ++e) ak[nd][e] = av[nd][e] = 0.f;

    const int nq = (L + BM - 1) / BN;
    const int lo = causal ? k0 / BN : 0;
    const int hi = window ? min(nq, (k0 + BM + window - 2) / BN + 1) : nq;

    for (int gi = 0; gi < group; ++gi) {
        const int h = hk * group + gi;
        const size_t q_base = (size_t)(b * H + h) * L * DH;
        const size_t row_base = (size_t)(b * H + h) * L;
        for (int qt = lo; qt < hi; ++qt) {
            const int q0 = qt * BN;
            __syncthreads();
            load_tile<DH>(Qs, Qt, q + q_base, q0, L, tid);
            load_tile<DH>(dOs, dOt, dout + q_base, q0, L, tid);
            for (int i = tid; i < BN; i += NTHREADS) {
                const bool in = q0 + i < L;
                lse_s[i] = in ? lse[row_base + q0 + i] * LOG2E : -NEG_INF;
                d_s[i] = in ? delta[row_base + q0 + i] : 0.f;
            }
            __syncthreads();

            float st[BN / 8][4], dpt[BN / 8][4];
#pragma unroll
            for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
                for (int e = 0; e < 4; ++e) st[nt][e] = dpt[nt][e] = 0.f;
            mma_abt<DH>(st, Ks, Qs, r0, g, t4);     // S^T = K Q^T
            mma_abt<DH>(dpt, Vs, dOs, r0, g, t4);   // dP^T = V dO^T

#pragma unroll
            for (int nt = 0; nt < BN / 8; ++nt) {
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int row = e >> 1;
                    const int qc = nt * 8 + t4 * 2 + (e & 1);
                    const float p = masked(q0 + qc, kpos[row], L, causal, window)
                                        ? 0.f
                                        : exp2f(st[nt][e] * scale_log2 - lse_s[qc]);
                    st[nt][e] = p;
                    dpt[nt][e] = p * (dpt[nt][e] - d_s[qc]);
                }
            }
            mma_pb<DH>(av, st, dOt, g, t4);         // dV += P^T dO
            mma_pb<DH>(ak, dpt, Qt, g, t4);         // dK += dS^T Q
        }
    }

#pragma unroll
    for (int row = 0; row < 2; ++row) {
        if (kpos[row] >= L) continue;
        bf16* ok = dk + kv_base + (size_t)kpos[row] * DH;
        bf16* ov = dv + kv_base + (size_t)kpos[row] * DH;
#pragma unroll
        for (int nd = 0; nd < DH / 8; ++nd) {
            *reinterpret_cast<uint32_t*>(ok + nd * 8 + t4 * 2) =
                pack_bf16(ak[nd][2 * row] * scale, ak[nd][2 * row + 1] * scale);
            *reinterpret_cast<uint32_t*>(ov + nd * 8 + t4 * 2) =
                pack_bf16(av[nd][2 * row], av[nd][2 * row + 1]);
        }
    }
}

template <int DH>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, void* delta, void* dq, int B, int H, int Hkv, int L,
                      int causal, int window, cudaStream_t stream) {
    // Q, dO and the ring's K and V tiles
    constexpr size_t smem = (size_t)flash::tile_bytes<DH>() * (2 + 2 * flash::NSTAGE);
    cudaError_t err = cudaFuncSetAttribute(dqk::flash_bwd_dq_kernel<DH>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid(B * H, (L + flash::TILE - 1) / flash::TILE);
    dqk::flash_bwd_dq_kernel<DH><<<grid, flash::NTHREADS, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const bf16*>(dout), static_cast<const float*>(lse),
        static_cast<float*>(delta), static_cast<bf16*>(dq), H, Hkv, L, causal, window,
        1.f / sqrtf((float)DH));
    return cudaGetLastError();
}

template <int DH>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* delta, void* dk, void* dv, int B, int H,
                       int Hkv, int L, int causal, int window, cudaStream_t stream) {
    constexpr size_t smem = sizeof(bf16) * (size_t)(4 * BM * (DH + PAD) + 2 * DH * TS) +
                            sizeof(float) * 2 * BN;
    cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<DH>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((L + BM - 1) / BM, Hkv, B);
    flash_bwd_dkv_kernel<DH><<<grid, NTHREADS, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const bf16*>(dout), static_cast<const float*>(lse),
        static_cast<const float*>(delta), static_cast<bf16*>(dk), static_cast<bf16*>(dv), H, Hkv,
        L, causal, window, 1.f / sqrtf((float)DH));
    return cudaGetLastError();
}

bool bad_args(int B, int H, int Hkv, int L, int window) {
    return B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 || L <= 0 || window < 0 || H > 65535 ||
           B > 65535;
}

}  // namespace

// q, dout (B, H, L, dh), k, v (B, Hkv, L, dh): contiguous bf16; lse
// (B, H, L): contiguous f32. Writes dq (B, H, L, dh) bf16 and delta
// (B, H, L) f32, the D that flash_bwd_dkv_bf16 then reads. dh is 64 or 128.
extern "C" int flash_bwd_dq_bf16(const void* q, const void* k, const void* v, const void* dout,
                                 const void* lse, void* delta, void* dq, int B, int H,
                                 int Hkv, int L, int dh, int causal, int window, void* stream) {
    if (bad_args(B, H, Hkv, L, window) || (long long)B * H > 0x7fffffffLL ||
        (L + flash::TILE - 1) / flash::TILE > 65535)    // grid (B * H, query tiles)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (dh) {
        case 64: return (int)launch_dq<64>(q, k, v, dout, lse, delta, dq, B, H, Hkv, L, causal,
                                           window, s);
        case 128: return (int)launch_dq<128>(q, k, v, dout, lse, delta, dq, B, H, Hkv, L, causal,
                                             window, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

// As above; dk, dv (B, Hkv, L, dh) bf16, each the sum over its GQA group.
extern "C" int flash_bwd_dkv_bf16(const void* q, const void* k, const void* v, const void* dout,
                                  const void* lse, const void* delta, void* dk, void* dv, int B,
                                  int H, int Hkv, int L, int dh, int causal, int window,
                                  void* stream) {
    if (bad_args(B, H, Hkv, L, window)) return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (dh) {
        case 64: return (int)launch_dkv<64>(q, k, v, dout, lse, delta, dk, dv, B, H, Hkv, L,
                                            causal, window, s);
        case 128: return (int)launch_dkv<128>(q, k, v, dout, lse, delta, dk, dv, B, H, Hkv, L,
                                              causal, window, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

extern "C" const char* flash_bwd_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

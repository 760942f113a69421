// Flash-attention forward for Hopper (sm_90a): causal / sliding-window GQA
// attention with an online softmax, writing O and the row log-sum-exp.
//
// Replaces: src/repro/kernels/flash_attention/flash_attention.py::_fwd_kernel
// (the Pallas TPU kernel launched by _fwd_call). Same function, same
// conventions: kpos in (qpos - window, qpos] when causal with a window,
// kv head = h / (H / Hkv), O in the input dtype (bf16), LSE = m + log(l)
// in f32, and a row that no key reaches publishes LSE = +1e30 so that a
// backward recomputation exp(s - lse) of that row is exactly 0.
//
// What bounds it on the H100: at the serving shape (B 8, H 12, L 512,
// dh 64) q, k, v and o are ~25 MB of bf16, ~7.6 us at 3.35 TB/s, while the
// causal products are ~3.2 GFLOP, ~3 us at 989 TFLOP/s of bf16 tensor
// cores. So bytes bound the function; but a block sees at most 8 key tiles
// at L 512, and what a naive design waits on is each tile's load latency
// and, once the products run on wgmma, the softmax's per-element ALU work
// (64 x 64 exponentials a tile against 1 MFLOP of tensor-core products).
//
// Design (tile_ring.cuh holds the shared pieces):
//  * one block of one warpgroup (4 warps, 128 threads) per (64-query tile,
//    head, batch); grid (B * H, query tiles) with the query tile taken
//    heaviest first (causal: the last tile, whose band is longest, is in
//    the first wave of blocks), so the short blocks fill the tail;
//  * K and V stream through a 3-stage cp.async ring of 64-key tiles:
//    tiles k + 1 and k + 2 are in flight while tile k is multiplied, one
//    __syncthreads per tile; the ragged edge is zero-filled by the copy;
//  * tiles are stored once, row-major with the 128-byte swizzle; S = Q K^T
//    is wgmma m64n64k16 with both operands in shared memory (K-major);
//    O += P V is wgmma with P from registers (the S accumulators rounded
//    to bf16 are its A fragments) and V read down its rows through a
//    transposed (MN-major) descriptor: no transposed copy of V exists;
//  * the running max, sum and O stay in f32 registers; the max is taken on
//    the raw scores and each p is one FFMA and one ex2.approx
//    (2^(s * log2(e) / sqrt(dh) - m)); only tiles that cross the
//    diagonal, the window's lower edge or L take the element mask;
//  * 116 registers and 56 KB of shared memory at dh 64: four blocks an SM;
//  * the epilogue stages each warp's O rows in its own (spent) rows of the
//    Q tile and writes them with 16-byte stores; rows past L are not
//    stored, so any L runs without padding.
//
// C entry: flash_fwd_bf16(...) returns cudaGetLastError() after the launch.

#include <math.h>

#include "tile_ring.cuh"

namespace {

using namespace flash;

// Blocks an SM holds: Q plus the ring's three K/V stages are 57,344 bytes
// at dh 64 (four fit in 228 KB), 114,688 at dh 128 (two fit)
template <int DH>
constexpr int min_blocks() { return DH == 64 ? 4 : 2; }

// One online-softmax step on the raw scores s = q.k of key tile k0: s
// becomes p = 2^(s * scale_log2 - m_new) (masked entries exactly 0), the
// running max m (log2 domain) and sum l move on, and corr = 2^(m_old -
// m_new) is what the accumulator must be scaled by before P V of this tile
// is added. Only an edge tile masks; on an interior tile every entry is
// valid, so the row max is finite and no entry needs the select.
template <bool EDGE>
__device__ __forceinline__ void softmax_step(float s[TILE / 8][4], float m[2], float l[2],
                                             float corr[2], float scale_log2, int k0, int t4,
                                             const int qpos[2], int L, int causal, int window) {
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int nt = 0; nt < TILE / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            if (EDGE && masked(qpos[e >> 1], k0 + nt * 8 + t4 * 2 + (e & 1), L, causal, window))
                s[nt][e] = -INFINITY;
            mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
        }
    }
    float mb[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int row = 0; row < 2; ++row) {
        mx[row] = fmaxf(mx[row], __shfl_xor_sync(0xffffffffu, mx[row], 1));
        mx[row] = fmaxf(mx[row], __shfl_xor_sync(0xffffffffu, mx[row], 2));
        const float mn = fmaxf(m[row], mx[row] * scale_log2);   // scale > 0: max commutes
        corr[row] = ex2(m[row] - mn);
        m[row] = mn;
        // a row with no valid key yet keeps m = NEG_INF: 2^(-inf - m) is 0
        mb[row] = mn;
    }
#pragma unroll
    for (int nt = 0; nt < TILE / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const float p = ex2(fmaf(s[nt][e], scale_log2, -mb[e >> 1]));
            s[nt][e] = p;
            rs[e >> 1] += p;
        }
    }
#pragma unroll
    for (int row = 0; row < 2; ++row) {
        rs[row] += __shfl_xor_sync(0xffffffffu, rs[row], 1);
        rs[row] += __shfl_xor_sync(0xffffffffu, rs[row], 2);
        l[row] = l[row] * corr[row] + rs[row];
    }
}

template <int DH>
__global__ void __launch_bounds__(NTHREADS, min_blocks<DH>())
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
                 int H, int Hkv, int L, int causal, int window, float scale_log2) {
    static_assert(DH % 64 == 0, "head dim must be a multiple of 64");
    constexpr uint32_t TB = tile_bytes<DH>();
    extern __shared__ __align__(1024) unsigned char smem_raw[];
    const uint32_t Qs = smem_base(smem_raw);         // [Q][K0 V0][K1 V1][K2 V2]

    const int nq = (L + TILE - 1) / TILE;
    const int q0 = query_tile(blockIdx.y, nq, causal) * TILE;
    const int h = blockIdx.x % H, b = blockIdx.x / H;
    const int hk = h / (H / Hkv);
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const size_t q_base = (size_t)(b * H + h) * L * DH;
    const bf16* kb = k + (size_t)(b * Hkv + hk) * L * DH;
    const bf16* vb = v + (size_t)(b * Hkv + hk) * L * DH;

    int lo, hi;
    band(q0, L, causal, window, lo, hi);
    const int n = hi - lo;
    auto stage = [&](int j) { return Qs + TB * (1 + 2 * (j % NSTAGE)); };   // K; V at + TB
    auto fetch = [&](int j) {       // key tile lo + j into its stage
        load_tile_async<DH>(stage(j), kb, (lo + j) * TILE, L, tid);
        load_tile_async<DH>(stage(j) + TB, vb, (lo + j) * TILE, L, tid);
    };

    // Q joins the first key tile's group
    load_tile_async<DH>(Qs, q + q_base, q0, L, tid);
#pragma unroll
    for (int j = 0; j < NSTAGE - 1; ++j) {
        if (j < n) fetch(j);
        cp_async_commit();
    }

    const int r0 = warp * 16 + g;    // this thread's rows: r0 and r0 + 8
    const int qpos[2] = {q0 + r0, q0 + r0 + 8};
    float m[2] = {NEG_INF, NEG_INF};   // running max (log2 domain)
    float l[2] = {0.f, 0.f};           // running sum
    float acc[DH / 8][4];
#pragma unroll
    for (int nd = 0; nd < DH / 8; ++nd) acc[nd][0] = acc[nd][1] = acc[nd][2] = acc[nd][3] = 0.f;

    for (int j = 0; j < n; ++j) {
        cp_async_wait<NSTAGE - 2>();   // tile j has landed (this thread's part)
        fence_async_smem();            // ... visible to wgmma's reads
        __syncthreads();               // ... every thread's; stage j - 1 is free
        if (j + NSTAGE - 1 < n) fetch(j + NSTAGE - 1);
        cp_async_commit();
        const int k0 = (lo + j) * TILE;

        float s[TILE / 8][4];
#pragma unroll
        for (int nt = 0; nt < TILE / 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
        wg_fence();
        wg_abt<DH>(s, Qs, stage(j));                     // S = Q K^T
        wg_commit();
        wg_wait<0>();
        wg_touch<TILE / 2>(&s[0][0]);

        float corr[2];
        if (edge_tile(q0, k0, L, causal, window))
            softmax_step<true>(s, m, l, corr, scale_log2, k0, t4, qpos, L, causal, window);
        else
            softmax_step<false>(s, m, l, corr, scale_log2, k0, t4, qpos, L, causal, window);
#pragma unroll
        for (int nd = 0; nd < DH / 8; ++nd) {
            acc[nd][0] *= corr[0];
            acc[nd][1] *= corr[0];
            acc[nd][2] *= corr[1];
            acc[nd][3] *= corr[1];
        }
        uint32_t pa[TILE / 16][4];
#pragma unroll
        for (int kk = 0; kk < TILE / 16; ++kk) a_frag(pa[kk], s, kk);
        wg_fence();
        wg_pv<DH>(acc, pa, stage(j) + TB);               // O += P V
        wg_commit();
        wg_wait<0>();
        wg_touch<DH / 2>(&acc[0][0]);
    }

    // ---- epilogue: LSE in f32; O = acc / l in bf16 through the warp's own Q rows
    float inv[2];
#pragma unroll
    for (int row = 0; row < 2; ++row) {
        inv[row] = 1.f / fmaxf(l[row], 1e-30f);
        if (t4 == 0 && qpos[row] < L)
            lse[(size_t)(b * H + h) * L + qpos[row]] =
                m[row] > 0.5f * NEG_INF ? (m[row] + __log2f(fmaxf(l[row], 1e-30f))) * LN2
                                        : -NEG_INF;
    }
    store_rows<DH>(acc, inv, Qs, o + q_base, q0, L, warp, lane);
}

template <int DH>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, void* lse, int B, int H,
                   int Hkv, int L, int causal, int window, cudaStream_t stream) {
    // Q and the ring's K and V tiles
    constexpr size_t smem = (size_t)tile_bytes<DH>() * (1 + 2 * NSTAGE);
    cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<DH>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid(B * H, (L + TILE - 1) / TILE);
    const float scale_log2 = LOG2E / sqrtf((float)DH);
    flash_fwd_kernel<DH><<<grid, NTHREADS, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<bf16*>(o), static_cast<float*>(lse), H, Hkv, L, causal, window, scale_log2);
    return cudaGetLastError();
}

}  // namespace

// q (B, H, L, dh), k/v (B, Hkv, L, dh), o (B, H, L, dh): contiguous bf16;
// lse (B, H, L): contiguous f32. dh is 64 or 128. Returns a cudaError_t.
extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v, void* o, void* lse,
                              int B, int H, int Hkv, int L, int dh, int causal, int window,
                              void* stream) {
    if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 || L <= 0 || window < 0 ||
        (long long)B * H > 0x7fffffffLL || (L + TILE - 1) / TILE > 65535)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (dh) {
        case 64:
            return (int)launch<64>(q, k, v, o, lse, B, H, Hkv, L, causal, window, s);
        case 128:
            return (int)launch<128>(q, k, v, o, lse, B, H, Hkv, L, causal, window, s);
        default:
            return (int)cudaErrorInvalidValue;
    }
}

extern "C" const char* flash_fwd_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

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
// dK/dV kernel (the dQ kernel's pieces, transposed: keys are the rows):
//  * one block of one warpgroup per (64-key tile, kv head, batch), grid
//    (B * Hkv, key tiles) with key tile 0, whose causal band is the
//    longest, first across the whole grid; K and V stay in shared memory;
//  * a 3-stage cp.async ring streams the band's (query head of the GQA
//    group, query tile) steps: a Q tile, a dO tile and the tile's 64 LSE
//    and 64 D values a stage (the query tiles: from the diagonal when
//    causal, up to the window's last query; as the TPU kernel's loop);
//  * S^T = K Q^T and dP^T = V dO^T are wgmma with both operands in shared
//    memory (K, V as A; Q, dO as the K-major B); dV += P^T dO and dK +=
//    dS^T Q are wgmma with P^T and dS^T from registers and dO, Q read
//    down their rows through the transposed descriptor: no transposed
//    copy of any tile;
//  * p = 2^(s * log2(e) / sqrt(dh) - lse * log2(e)) is one FFMA and one
//    ex2.approx with each thread's LSE and D read for its own query
//    columns; only edge tiles take the element mask (which also masks the
//    zero-filled query rows past L, summed over here);
//  * the GQA sum stays in the block's registers (no atomics: results are
//    deterministic); dK (x scale) and dV leave through the K and V tiles
//    as 16-byte stores.

// C entries: flash_bwd_dq_bf16(...), flash_bwd_dkv_bf16(...) return
// cudaGetLastError() after the launch.

#include "tile_ring.cuh"

namespace {

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
using flash::masked_kv;
using flash::cp_async4;
using flash::edge_tile_kv;
using flash::key_band;
using flash::key_tile;
using flash::a_frag;
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

// --------------------------------------------------------------- dK/dV --

// Transposed probabilities of one step in place: s (S^T: keys as rows,
// queries as columns) becomes p and dp (dP^T) becomes dS^T = p (dp - D),
// with LSE and D read for the thread's own query columns nt * 8 + t4 * 2 +
// (e & 1) from the stage's rows; on an edge tile masked pairs and query
// rows past L give exactly 0.
template <bool EDGE>
__device__ __forceinline__ void probs_t(float s[TILE / 8][4], float dp[TILE / 8][4],
                                        const float* lse_s, const float* d_s, float scale_log2,
                                        int q0, int t4, const int kpos[2], int L, int causal,
                                        int window) {
#pragma unroll
    for (int nt = 0; nt < TILE / 8; ++nt) {
        const float2 l2 = *reinterpret_cast<const float2*>(lse_s + nt * 8 + t4 * 2);
        const float2 d2 = *reinterpret_cast<const float2*>(d_s + nt * 8 + t4 * 2);
        const float nl[2] = {-l2.x * LOG2E, -l2.y * LOG2E}, dd[2] = {d2.x, d2.y};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int qpos = q0 + nt * 8 + t4 * 2 + (e & 1);
            const float p = EDGE && masked_kv(qpos, kpos[e >> 1], L, causal, window)
                                ? 0.f
                                : ex2(fmaf(s[nt][e], scale_log2, nl[e & 1]));
            s[nt][e] = p;
            dp[nt][e] = p * (dp[nt][e] - dd[e & 1]);
        }
    }
}

template <int DH>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int Hkv, int L,
                     int causal, int window, float scale) {
    static_assert(NTHREADS == 2 * TILE, "one 4-byte LSE or D copy a thread a stage");
    constexpr uint32_t TB = tile_bytes<DH>();
    extern __shared__ __align__(1024) unsigned char smem_raw[];
    // [K][V][Q0 dO0][Q1 dO1][Q2 dO2][LSE0 D0][LSE1 D1][LSE2 D2]
    const uint32_t Ks = smem_base(smem_raw);
    const uint32_t Vs = Ks + TB;
    const uint32_t rows_s = Ks + TB * (2 + 2 * NSTAGE);
    const float* rows = reinterpret_cast<const float*>(smem_raw + TB * (2 + 2 * NSTAGE));

    const int nk = (L + TILE - 1) / TILE;
    const int k0 = key_tile(blockIdx.y, nk, causal) * TILE;
    const int hk = blockIdx.x % Hkv, b = blockIdx.x / Hkv;
    const int group = H / Hkv;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const size_t kv_base = (size_t)(b * Hkv + hk) * L * DH;
    const float scale_log2 = scale * LOG2E;

    // the ring's steps: (query head gi of the group, query tile lo + j % nb)
    int lo, hi;
    key_band(k0, L, causal, window, lo, hi);
    const int nb = hi - lo, n = group * nb;
    auto fetch = [&](int j) {
        const int si = j % NSTAGE;
        const uint32_t st = Ks + TB * (2 + 2 * si);
        const int q0 = (lo + j % nb) * TILE;
        const size_t row_base = (size_t)(b * H + hk * group + j / nb) * L;
        load_tile_async<DH>(st, q + row_base * DH, q0, L, tid);
        load_tile_async<DH>(st + TB, dout + row_base * DH, q0, L, tid);
        const int r = tid & (TILE - 1);
        const bool in = q0 + r < L;
        cp_async4(rows_s + (si * 2 * TILE + tid) * 4,
                  (tid < TILE ? lse : delta) + row_base + (in ? q0 + r : 0), in);
    };

    // K and V join the first step's group
    load_tile_async<DH>(Ks, k + kv_base, k0, L, tid);
    load_tile_async<DH>(Vs, v + kv_base, k0, L, tid);
#pragma unroll
    for (int j = 0; j < NSTAGE - 1; ++j) {
        if (j < n) fetch(j);
        cp_async_commit();
    }

    const int r0 = warp * 16 + g;
    const int kpos[2] = {k0 + r0, k0 + r0 + 8};
    float ak[DH / 8][4], av[DH / 8][4];
#pragma unroll
    for (int nd = 0; nd < DH / 8; ++nd)
#pragma unroll
        for (int e = 0; e < 4; ++e) ak[nd][e] = av[nd][e] = 0.f;

    for (int j = 0; j < n; ++j) {
        cp_async_wait<NSTAGE - 2>();
        fence_async_smem();
        __syncthreads();
        if (j + NSTAGE - 1 < n) fetch(j + NSTAGE - 1);
        cp_async_commit();
        const int si = j % NSTAGE;
        const uint32_t Qs = Ks + TB * (2 + 2 * si), dOs = Qs + TB;
        const float* lse_s = rows + si * 2 * TILE;
        const int q0 = (lo + j % nb) * TILE;

        float s[TILE / 8][4], dp[TILE / 8][4];
#pragma unroll
        for (int nt = 0; nt < TILE / 8; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
        wg_fence();
        wg_abt<DH>(s, Ks, Qs);                           // S^T = K Q^T
        wg_abt<DH>(dp, Vs, dOs);                         // dP^T = V dO^T
        wg_commit();
        wg_wait<0>();
        wg_touch<TILE / 2>(&s[0][0]);
        wg_touch<TILE / 2>(&dp[0][0]);
        if (edge_tile_kv(k0, q0, L, causal, window))
            probs_t<true>(s, dp, lse_s, lse_s + TILE, scale_log2, q0, t4, kpos, L, causal, window);
        else
            probs_t<false>(s, dp, lse_s, lse_s + TILE, scale_log2, q0, t4, kpos, L, causal, window);

        // dV += P^T dO, dK += dS^T Q: the A fragments packed before the fence
        uint32_t pa[TILE / 16][4], da[TILE / 16][4];
#pragma unroll
        for (int kk = 0; kk < TILE / 16; ++kk) {
            a_frag(pa[kk], s, kk);
            a_frag(da[kk], dp, kk);
        }
        wg_fence();
        wg_pv<DH>(av, pa, dOs);
        wg_pv<DH>(ak, da, Qs);
        wg_commit();
        wg_wait<0>();
        wg_touch<DH / 2>(&av[0][0]);
        wg_touch<DH / 2>(&ak[0][0]);
    }

    // every product is done: the K and V tiles carry the results out
    __syncthreads();
    const float mk[2] = {scale, scale}, mv[2] = {1.f, 1.f};
    store_rows<DH>(ak, mk, Ks, dk + kv_base, k0, L, warp, lane);
    store_rows<DH>(av, mv, Vs, dv + kv_base, k0, L, warp, lane);
}

template <int DH>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, void* delta, void* dq, int B, int H, int Hkv, int L,
                      int causal, int window, cudaStream_t stream) {
    // Q, dO and the ring's K and V tiles
    constexpr size_t smem = (size_t)flash::tile_bytes<DH>() * (2 + 2 * flash::NSTAGE);
    cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<DH>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid(B * H, (L + flash::TILE - 1) / flash::TILE);
    flash_bwd_dq_kernel<DH><<<grid, flash::NTHREADS, smem, stream>>>(
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
    // K, V, the ring's Q and dO tiles, and its LSE and D rows
    constexpr size_t smem = (size_t)flash::tile_bytes<DH>() * (2 + 2 * flash::NSTAGE) +
                            sizeof(float) * 2 * flash::TILE * flash::NSTAGE;
    cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<DH>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid(B * Hkv, (L + flash::TILE - 1) / flash::TILE);
    flash_bwd_dkv_kernel<DH><<<grid, flash::NTHREADS, smem, stream>>>(
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
    if (bad_args(B, H, Hkv, L, window) || (long long)B * Hkv > 0x7fffffffLL ||
        (L + flash::TILE - 1) / flash::TILE > 65535)    // grid (B * Hkv, key tiles)
        return (int)cudaErrorInvalidValue;
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

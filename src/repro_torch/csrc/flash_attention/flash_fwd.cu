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
// dh 64) q, k, v and o are ~25 MB of bf16, ~7.5 us at 3.35 TB/s, while the
// causal products are ~3.2 GFLOP, ~3 us at 989 TFLOP/s of bf16 tensor
// cores. So the kernel is memory-bound, and the design's first job is to
// read Q, K and V once per query tile and never write scores to memory.
//
// Design (simple first; wgmma, TMA and warp specialisation come later):
//  * one thread block of 4 warps per (64-query tile, head, batch); each
//    warp owns 16 query rows;
//  * the Q tile is staged through shared memory once and kept in registers
//    as mma.sync A fragments; K and V tiles of 64 keys are staged through
//    shared memory (V transposed, so its B fragments are 32-bit loads),
//    rows padded by 8 elements so fragment loads hit 32 distinct banks;
//  * S = Q K^T and O += P V run on the tensor cores as
//    mma.sync.m16n8k16 with bf16 inputs and f32 accumulators; the running
//    max, the running sum and the accumulator stay in f32 registers; P is
//    rounded to bf16 only as the A operand of P V (the f32 P feeds the sum);
//  * the softmax runs in the log2 domain (scores pre-scaled by
//    log2(e) / sqrt(dh), exp2f);
//  * key tiles entirely above the causal diagonal or below the window band
//    are skipped (the band's first tile is the floor-divide of
//    max(q0 - window + 1, 0), as _band_lo_block does); the ragged edge
//    kpos >= L is masked in the kernel, and rows qpos >= L are not stored,
//    so any L runs without padding.
//
// C entry: flash_fwd_bf16(...) returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;         // query rows per block
constexpr int BN = 64;         // keys per tile
constexpr int NWARPS = BM / 16;
constexpr int NTHREADS = NWARPS * 32;
constexpr int PAD = 8;         // bf16 elements of row padding in shared memory
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ void mma_bf16_16816(float c[4], const uint32_t a[4], uint32_t b0,
                                               uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x (low half) = lo
    return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
    return *reinterpret_cast<const uint32_t*>(p);
}

template <int DH>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                 float* __restrict__ lse, int H, int Hkv, int L, int causal, int window,
                 float scale_log2) {
    static_assert(DH % 16 == 0, "head dim must be a multiple of 16");
    constexpr int RS = DH + PAD;     // row stride of the Q and K tiles
    constexpr int VS = BN + PAD;     // row stride of the transposed V tile
    constexpr int CH = DH / 8;       // 16-byte chunks per row
    extern __shared__ __align__(16) unsigned char smem[];
    __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);   // [BM][RS]
    __nv_bfloat16* Ks = Qs + BM * RS;                              // [BN][RS]
    __nv_bfloat16* Vt = Ks + BN * RS;                              // [DH][VS]

    const int q0 = blockIdx.x * BM;
    const int h = blockIdx.y;
    const int b = blockIdx.z;
    const int hk = h / (H / Hkv);
    const int tid = threadIdx.x;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int g = lane >> 2;         // fragment row group
    const int t4 = lane & 3;         // thread within the group
    const size_t q_base = (size_t)(b * H + h) * L * DH;
    const size_t kv_base = (size_t)(b * Hkv + hk) * L * DH;

    // ---- Q tile → shared memory (rows past L zero-filled) → A fragments
    for (int i = tid; i < BM * CH; i += NTHREADS) {
        const int r = i / CH, c = (i % CH) * 8;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (q0 + r < L) val = *reinterpret_cast<const uint4*>(q + q_base + (size_t)(q0 + r) * DH + c);
        *reinterpret_cast<uint4*>(Qs + r * RS + c) = val;
    }
    __syncthreads();
    const int r0 = warp * 16 + g;    // this thread's rows: r0 and r0 + 8
    uint32_t qf[DH / 16][4];
#pragma unroll
    for (int ks = 0; ks < DH / 16; ++ks) {
        const int c = ks * 16 + t4 * 2;
        qf[ks][0] = ld_pair(Qs + r0 * RS + c);
        qf[ks][1] = ld_pair(Qs + (r0 + 8) * RS + c);
        qf[ks][2] = ld_pair(Qs + r0 * RS + c + 8);
        qf[ks][3] = ld_pair(Qs + (r0 + 8) * RS + c + 8);
    }
    const int qpos[2] = {q0 + r0, q0 + r0 + 8};

    float m[2] = {NEG_INF, NEG_INF};   // running max (log2 domain)
    float l[2] = {0.f, 0.f};           // running sum
    float acc[DH / 8][4];
#pragma unroll
    for (int nd = 0; nd < DH / 8; ++nd)
        acc[nd][0] = acc[nd][1] = acc[nd][2] = acc[nd][3] = 0.f;

    // key tiles this query tile can reach
    const int nk = (L + BN - 1) / BN;
    const int hi = causal ? min(nk, (q0 + BM + BN - 1) / BN) : nk;
    const int lo = window ? max(q0 - window + 1, 0) / BN : 0;

    for (int kt = lo; kt < hi; ++kt) {
        const int k0 = kt * BN;
        __syncthreads();             // every warp is done with the previous tile
        for (int i = tid; i < BN * CH; i += NTHREADS) {
            const int r = i / CH, c = (i % CH) * 8;
            uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
            if (k0 + r < L) {
                const size_t off = kv_base + (size_t)(k0 + r) * DH + c;
                kv = *reinterpret_cast<const uint4*>(k + off);
                vv = *reinterpret_cast<const uint4*>(v + off);
            }
            *reinterpret_cast<uint4*>(Ks + r * RS + c) = kv;
            const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
            for (int e = 0; e < 8; ++e) Vt[(c + e) * VS + r] = ve[e];
        }
        __syncthreads();

        // S = Q K^T for this warp's 16 rows × 64 keys
        float s[BN / 8][4];
#pragma unroll
        for (int nt = 0; nt < BN / 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
        for (int ks = 0; ks < DH / 16; ++ks) {
#pragma unroll
            for (int nt = 0; nt < BN / 8; ++nt) {
                const __nv_bfloat16* kr = Ks + (nt * 8 + g) * RS + ks * 16 + t4 * 2;
                mma_bf16_16816(s[nt], qf[ks], ld_pair(kr), ld_pair(kr + 8));
            }
        }

        // scale, mask, new running max
        float mx[2] = {m[0], m[1]};
#pragma unroll
        for (int nt = 0; nt < BN / 8; ++nt) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int row = e >> 1;
                const int kpos = k0 + nt * 8 + t4 * 2 + (e & 1);
                const bool bad = kpos >= L || (causal && kpos > qpos[row]) ||
                                 (window && kpos <= qpos[row] - window);
                s[nt][e] = bad ? NEG_INF : s[nt][e] * scale_log2;
                mx[row] = fmaxf(mx[row], s[nt][e]);
            }
        }
        float corr[2], rs[2] = {0.f, 0.f};
#pragma unroll
        for (int row = 0; row < 2; ++row) {
            mx[row] = fmaxf(mx[row], __shfl_xor_sync(0xffffffffu, mx[row], 1));
            mx[row] = fmaxf(mx[row], __shfl_xor_sync(0xffffffffu, mx[row], 2));
            corr[row] = exp2f(m[row] - mx[row]);
            m[row] = mx[row];
        }
        // p = exp2(s - m); masked entries contribute exactly 0
#pragma unroll
        for (int nt = 0; nt < BN / 8; ++nt) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int row = e >> 1;
                const float p = s[nt][e] <= 0.5f * NEG_INF ? 0.f : exp2f(s[nt][e] - m[row]);
                s[nt][e] = p;
                rs[row] += p;
            }
        }
#pragma unroll
        for (int row = 0; row < 2; ++row) {
            rs[row] += __shfl_xor_sync(0xffffffffu, rs[row], 1);
            rs[row] += __shfl_xor_sync(0xffffffffu, rs[row], 2);
            l[row] = l[row] * corr[row] + rs[row];
        }
#pragma unroll
        for (int nd = 0; nd < DH / 8; ++nd) {
            acc[nd][0] *= corr[0];
            acc[nd][1] *= corr[0];
            acc[nd][2] *= corr[1];
            acc[nd][3] *= corr[1];
        }

        // O += P V: the S accumulators of key columns 16kk..16kk+15 are
        // exactly the A fragment of P for that k-step
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk) {
            uint32_t pa[4];
            pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
            pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
            pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
            pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
            for (int nd = 0; nd < DH / 8; ++nd) {
                const __nv_bfloat16* vr = Vt + (nd * 8 + g) * VS + kk * 16 + t4 * 2;
                mma_bf16_16816(acc[nd], pa, ld_pair(vr), ld_pair(vr + 8));
            }
        }
    }

    // ---- epilogue: O = acc / l in bf16, LSE in f32 (natural log)
#pragma unroll
    for (int row = 0; row < 2; ++row) {
        if (qpos[row] >= L) continue;
        const float inv = 1.f / fmaxf(l[row], 1e-30f);
        __nv_bfloat16* orow = o + q_base + (size_t)qpos[row] * DH;
#pragma unroll
        for (int nd = 0; nd < DH / 8; ++nd) {
            *reinterpret_cast<uint32_t*>(orow + nd * 8 + t4 * 2) =
                pack_bf16(acc[nd][2 * row] * inv, acc[nd][2 * row + 1] * inv);
        }
        if (t4 == 0) {
            lse[(size_t)(b * H + h) * L + qpos[row]] =
                m[row] > 0.5f * NEG_INF ? (m[row] + log2f(fmaxf(l[row], 1e-30f))) * LN2 : -NEG_INF;
        }
    }
}

template <int DH>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, void* lse, int B, int H,
                   int Hkv, int L, int causal, int window, cudaStream_t stream) {
    constexpr size_t smem = sizeof(__nv_bfloat16) * (size_t)(2 * BM * (DH + PAD) + DH * (BN + PAD));
    static_assert(BM == BN, "Q and K tiles share one row stride");
    cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<DH>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((L + BM - 1) / BM, H, B);
    const float scale_log2 = LOG2E / sqrtf((float)DH);
    flash_fwd_kernel<DH><<<grid, NTHREADS, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
        static_cast<float*>(lse), H, Hkv, L, causal, window, scale_log2);
    return cudaGetLastError();
}

}  // namespace

// q (B, H, L, dh), k/v (B, Hkv, L, dh), o (B, H, L, dh): contiguous bf16;
// lse (B, H, L): contiguous f32. dh is 64 or 128. Returns a cudaError_t.
extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v, void* o, void* lse,
                              int B, int H, int Hkv, int L, int dh, int causal, int window,
                              void* stream) {
    if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 || L <= 0 || window < 0 || H > 65535 ||
        B > 65535)
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

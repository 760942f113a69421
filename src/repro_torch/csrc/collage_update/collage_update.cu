// Fused Collage-AdamW update of one flat parameter bucket, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/collage_update/collage_update.py::collage_update_kernel
// (the Pallas TPU kernel launched by collage_bucket_update). Same function:
// one pass over the bucket computing the m/v EMAs, the bias-corrected AdamW
// update and the strategy's rule (A, B, C, KAHAN, SR, D-, D), rounding to
// nearest-even onto bf16 after every operation, plus the per-tile metric
// partials (<upd, eff>, |upd|^2, |eff|^2, #lost, |g|^2) summed in det_sum
// order over each (br x 128) tile, then over the tiles.
//
// What bounds it on the H100: at gpt-125m's bucket (162,149,376 elements,
// strategy C: 6 bf16 reads + 5 writes, 22 B an element) the bytes take
// 3.57 GB, ~1.06 ms at 3.35 TB/s. The C kernel issues ~180 SASS
// instructions an element (33 bf16 roundings of one cvt each, three
// correctly rounded divisions and a square root of ~10 each, the rest
// single f32 operations): ~0.88 ms at 132 SMs x 4 schedulers x 32 lanes an
// instruction and the top SM clock. So bytes bound it, with the issue rate
// close behind; the design keeps the loads wide, the instruction count
// low and the reductions free of shared memory and barriers.
//
// Numerics: every f32 operation is written as __fadd_rn / __fsub_rn /
// __fmul_rn / __fdiv_rn / __fsqrt_rn, which nvcc never contracts into an
// FMA (an FMA would erase the roundoff the error-free transformations
// keep) and which keep subnormals (no FTZ). rn(x) rounds to nearest-even
// onto bf16 as __float2bfloat16_rn does. The plain PyTorch version
// (kernels/collage_update/ref.py) does the same operations one by one, so
// the two agree bit for bit.
//
// Two paths, by tile height br (= choose_block_rows; the JAX kernel's tile,
// so the partials are summed over the same elements in the same order):
//
//  * br <= 8 (tiles of at most 1024 elements; gpt-125m's bucket has br 8):
//    one warp a tile, 4 warps a block. Lane l takes the br consecutive
//    elements 32 br c + br l + j (j < br) of each quarter c of the tile,
//    with 16-byte loads and stores at br 8 (one uint4 of 8 bf16 a field,
//    two for an f32 field). The tile's det_sum needs neither shared memory
//    nor a barrier: its halvings pair element i with i + half, which is
//      - quarter c with c + 2, then c with c + 1, inside the lane (the
//        quarters are taken in pairs, 0 with 2, then 1 with 3, each pair
//        summed and added to the first pair's sum);
//      - lane l with l + 16, 8, 4, 2, 1 (__shfl_down_sync), same j;
//      - then det_sum over the br values j in lane 0 (odd br: the odd
//        levels' y[0] += x[n - 1]).
//    Every level above the last br values halves an even length, and IEEE
//    addition commutes exactly, so the sums are det_sum's bit for bit.
//  * br >= 16 (and any bucket whose pointers are not all 16-byte aligned):
//    one block a tile, 256 threads striding over it with scalar loads; each
//    thread writes its elements' metric values into shared memory and the
//    block halves the tile level by level with a __syncthreads between
//    levels. As many of the 5 metrics as fit in 160 KB are reduced per
//    pass; a large tile (br 128 or 256) takes more than one pass and
//    recomputes the update from its inputs in each (outputs are written in
//    the last pass only).
//
// In place: the outputs may be the inputs (the trainer's donated step,
// which saves a second copy of the optimizer state). Every element is
// read, in every pass, and then written by one thread, which reads it no
// more after the write, so no thread ever reads a written value: the
// read-only-cache loads stay valid.
//
// Sizes: n is 64-bit, every element index is size_t, and the tile count
// (n / (br 128)) is at most 2^31 - 1, so buckets of 2^31 elements or more
// (gemma3-27b at six layers: 3.89 B) run in one launch.
//
// The partials are metric-major, (5, tiles) f32; one or two more launches
// (collage_finish_levels, collage_finish) sum each row in det_sum order
// and write the 5 sums: bucketing.det_sum(partials, dim=0) bit for bit.
//
// The SR noise index is elem_offset + tile * br * 128 + element in uint32
// (wrapping: the bucket-global index mod 2^32, as the JAX package's
// uint32 index), hashed by lowbias32 as bucketing.sr_noise_bits does.
//
// C entry: collage_update(...) returns cudaGetLastError() after the
// launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NMET = 5;
constexpr int LANES = 128;
constexpr int SMEM_LIMIT = 160 * 1024;   // bytes of metric scratch per block (br >= 16)
constexpr int WARP_BLOCK = 128;          // threads a block of the warp path: 4 tiles
constexpr int FINISH_THREADS = 1024;
constexpr int FINISH_ROWS = 2048;        // the sum over the tiles: rows of its last block
constexpr uint32_t GOLDEN = 0x9E3779B9u;
constexpr unsigned FULL = 0xffffffffu;

enum Code { A = 0, B = 1, C = 2, KAHAN = 3, SR = 4, DMINUS = 5, D = 6 };
// a strategy's state fields, in the order of the pointer slots
enum Slot { THETA = 0, M = 1, VHI = 2, VLO = 3, DELTA = 4, MASTER = 5, NSLOT = 6 };

struct Consts {
    float lr, bc1, bc2, b1, c1, b2, c2, cb1, c1m, cb2, c2m, b2hi, b2lo, eps, wd_upd, factor;
};

struct Ptrs {
    const void* in[NSLOT];
    void* out[NSLOT];
};

// Round to nearest-even onto bf16, as f32: one cvt.rn.bf16x2.f32 with x in
// the high half and 0 in the low half is already the f32 bit pattern of
// the rounded value (the same conversion as __float2bfloat16_rn: NaN to the
// canonical 0x7FFF, subnormals kept), where __bfloat162float(
// __float2bfloat16_rn(x)) takes a convert and a shift.
__device__ __forceinline__ float rn(float x) {
    uint32_t r;
    asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(x), "f"(0.f));
    return __uint_as_float(r);
}
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }

template <int CODE>
__host__ __device__ constexpr bool opt32() { return CODE == DMINUS || CODE == D; }

__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xFFFF0000u); }

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x (low half, lower address) = lo
    return *reinterpret_cast<uint32_t*>(&v);
}

// N consecutive values from element i of a bf16 or f32 field, by the
// widest loads the run's alignment allows (runs start at multiples of N):
// 16 bytes for 8 bf16 or 4 f32.
template <int N, bool F32>
__device__ __forceinline__ void load_run(const void* p, size_t i, float (&x)[N]) {
    if constexpr (F32) {
        constexpr int W = N % 4 == 0 ? 4 : N % 2 == 0 ? 2 : 1;
        const float* f = static_cast<const float*>(p) + i;
#pragma unroll
        for (int a = 0; a < N; a += W) {
            if constexpr (W == 4) {
                const float4 v = __ldg(reinterpret_cast<const float4*>(f + a));
                x[a] = v.x, x[a + 1] = v.y, x[a + 2] = v.z, x[a + 3] = v.w;
            } else if constexpr (W == 2) {
                const float2 v = __ldg(reinterpret_cast<const float2*>(f + a));
                x[a] = v.x, x[a + 1] = v.y;
            } else {
                x[a] = __ldg(f + a);
            }
        }
    } else {
        constexpr int W = N % 8 == 0 ? 8 : N % 4 == 0 ? 4 : N % 2 == 0 ? 2 : 1;
        const unsigned short* h = static_cast<const unsigned short*>(p) + i;
#pragma unroll
        for (int a = 0; a < N; a += W) {
            if constexpr (W == 1) {
                x[a] = __uint_as_float((uint32_t)__ldg(h + a) << 16);
            } else {
                uint32_t w[W / 2];
                if constexpr (W == 8) {
                    const uint4 v = __ldg(reinterpret_cast<const uint4*>(h + a));
                    w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
                } else if constexpr (W == 4) {
                    const uint2 v = __ldg(reinterpret_cast<const uint2*>(h + a));
                    w[0] = v.x, w[1] = v.y;
                } else {
                    w[0] = __ldg(reinterpret_cast<const unsigned int*>(h + a));
                }
#pragma unroll
                for (int b = 0; b < W / 2; ++b) x[a + 2 * b] = bf16_lo(w[b]), x[a + 2 * b + 1] = bf16_hi(w[b]);
            }
        }
    }
}

// The store of load_run (a bf16 value is on the bf16 grid already).
template <int N, bool F32>
__device__ __forceinline__ void store_run(void* p, size_t i, const float (&x)[N]) {
    if constexpr (F32) {
        constexpr int W = N % 4 == 0 ? 4 : N % 2 == 0 ? 2 : 1;
        float* f = static_cast<float*>(p) + i;
#pragma unroll
        for (int a = 0; a < N; a += W) {
            if constexpr (W == 4)
                *reinterpret_cast<float4*>(f + a) = make_float4(x[a], x[a + 1], x[a + 2], x[a + 3]);
            else if constexpr (W == 2)
                *reinterpret_cast<float2*>(f + a) = make_float2(x[a], x[a + 1]);
            else
                f[a] = x[a];
        }
    } else {
        constexpr int W = N % 8 == 0 ? 8 : N % 4 == 0 ? 4 : N % 2 == 0 ? 2 : 1;
        __nv_bfloat16* h = static_cast<__nv_bfloat16*>(p) + i;
#pragma unroll
        for (int a = 0; a < N; a += W) {
            if constexpr (W == 8)
                *reinterpret_cast<uint4*>(h + a) =
                    make_uint4(pack_bf16(x[a], x[a + 1]), pack_bf16(x[a + 2], x[a + 3]),
                               pack_bf16(x[a + 4], x[a + 5]), pack_bf16(x[a + 6], x[a + 7]));
            else if constexpr (W == 4)
                *reinterpret_cast<uint2*>(h + a) =
                    make_uint2(pack_bf16(x[a], x[a + 1]), pack_bf16(x[a + 2], x[a + 3]));
            else if constexpr (W == 2)
                *reinterpret_cast<uint32_t*>(h + a) = pack_bf16(x[a], x[a + 1]);
            else
                h[a] = __float2bfloat16_rn(x[a]);
        }
    }
}

// The strategy's state fields of N consecutive elements from element i
// (a field the strategy lacks reads as 0 and is never stored).
template <int CODE, int N>
__device__ __forceinline__ void load_fields(const Ptrs& p, size_t i, float (&x)[NSLOT][N]) {
#pragma unroll
    for (int j = 0; j < N; ++j) x[VLO][j] = x[DELTA][j] = x[MASTER][j] = 0.f;
    load_run<N, false>(p.in[THETA], i, x[THETA]);
    load_run<N, opt32<CODE>()>(p.in[M], i, x[M]);
    load_run<N, opt32<CODE>()>(p.in[VHI], i, x[VHI]);
    if constexpr (CODE == C) load_run<N, false>(p.in[VLO], i, x[VLO]);
    if constexpr (CODE == B || CODE == C || CODE == KAHAN) load_run<N, false>(p.in[DELTA], i, x[DELTA]);
    if constexpr (CODE == D) load_run<N, true>(p.in[MASTER], i, x[MASTER]);
}

template <int CODE, int N>
__device__ __forceinline__ void store_fields(const Ptrs& p, size_t i, const float (&x)[NSLOT][N]) {
    store_run<N, false>(p.out[THETA], i, x[THETA]);
    store_run<N, opt32<CODE>()>(p.out[M], i, x[M]);
    store_run<N, opt32<CODE>()>(p.out[VHI], i, x[VHI]);
    if constexpr (CODE == C) store_run<N, false>(p.out[VLO], i, x[VLO]);
    if constexpr (CODE == B || CODE == C || CODE == KAHAN) store_run<N, false>(p.out[DELTA], i, x[DELTA]);
    if constexpr (CODE == D) store_run<N, true>(p.out[MASTER], i, x[MASTER]);
}

__device__ __forceinline__ uint32_t lowbias32(uint32_t x) {
    x ^= x >> 16;
    x *= 0x7FEB352Du;
    x ^= x >> 15;
    x *= 0x846CA68Bu;
    x ^= x >> 16;
    return x;
}

// TwoSum(a, b) → (x, y), x = rn(a + b), x + y == a + b
__device__ __forceinline__ void two_sum(float a, float b, float& x, float& y) {
    x = rn(add(a, b));
    const float bv = rn(sub(x, a));
    const float av = rn(sub(x, bv));
    y = rn(add(rn(sub(b, bv)), rn(sub(a, av))));
}

__device__ __forceinline__ void fast2sum(float a, float b, float& x, float& y) {
    x = rn(add(a, b));
    y = rn(sub(b, rn(sub(x, a))));
}

// Grow (Paper Alg. 1): (hi, lo) + a
__device__ __forceinline__ void grow(float hi, float lo, float a, float& nhi, float& nlo) {
    float u, v;
    two_sum(hi, a, u, v);
    fast2sum(u, rn(add(lo, v)), nhi, nlo);
}

// (a_hi, a_lo) x (b_hi, b_lo), expansion Mul (App. C Alg. 7)
__device__ __forceinline__ void mul_expansion(float a_hi, float a_lo, float b_hi, float b_lo,
                                              float& hi, float& lo) {
    const float prod = mul(a_hi, b_hi);      // exact: bf16 inputs
    const float x = rn(prod);
    float e = rn(sub(prod, x));
    const float cross = rn(add(rn(mul(a_hi, b_lo)), rn(mul(a_lo, b_hi))));
    e = rn(add(e, cross));
    fast2sum(x, e, hi, lo);
}

// One element: s holds its state fields (slots) and is updated in place;
// returns upd and eff.
template <int CODE>
__device__ __forceinline__ void update_one(const Consts& k, float g, float (&s)[NSLOT],
                                           int pt_decay, uint32_t seed, uint32_t idx,
                                           float& upd, float& eff) {
    const float theta = s[THETA];
    const float m = s[M];
    const float vhi = s[VHI];
    float theta_n;

    if (opt32<CODE>()) {
        const float m_n = add(mul(k.b1, m), mul(k.c1, g));
        const float v_n = add(mul(k.b2, vhi), mul(mul(k.c2, g), g));
        const float mhat = __fdiv_rn(m_n, k.bc1);
        const float vhat = __fdiv_rn(v_n, k.bc2);
        const float step = __fdiv_rn(mhat, add(__fsqrt_rn(vhat), k.eps));
        if (CODE == D) {
            const float w = s[MASTER];
            upd = mul(-k.lr, add(step, mul(k.wd_upd, w)));
            const float w_n = add(w, upd);
            theta_n = rn(w_n);
            s[MASTER] = w_n;
        } else {
            upd = mul(-k.lr, add(step, mul(k.wd_upd, theta)));
            theta_n = rn(add(theta, rn(upd)));
        }
        eff = sub(theta_n, theta);
        s[M] = m_n;
        s[VHI] = v_n;
    } else {
        const float m_n = rn(add(rn(mul(k.cb1, m)), rn(mul(k.c1m, g))));
        const float g2 = rn(mul(g, g));
        float vhi_n, vhat;
        if (CODE == C) {
            const float vlo = s[VLO];
            float ph, plo, vlo_n;
            mul_expansion(k.b2hi, k.b2lo, vhi, vlo, ph, plo);
            grow(ph, plo, rn(mul(k.c2m, g2)), vhi_n, vlo_n);
            vhat = __fdiv_rn(add(vhi_n, vlo_n), k.bc2);
            s[VLO] = vlo_n;
        } else {
            vhi_n = rn(add(rn(mul(k.cb2, vhi)), rn(mul(k.c2m, g2))));
            vhat = __fdiv_rn(vhi_n, k.bc2);
        }
        const float mhat = __fdiv_rn(m_n, k.bc1);
        upd = mul(-k.lr,
                  add(__fdiv_rn(mhat, add(__fsqrt_rn(vhat), k.eps)), mul(k.wd_upd, theta)));
        const float upd16 = rn(upd);

        if (CODE == A) {
            const float base = pt_decay ? rn(mul(theta, k.factor)) : theta;
            theta_n = rn(add(base, upd16));
            eff = sub(theta_n, theta);
        } else if (CODE == SR) {
            const uint32_t noise = lowbias32(idx * GOLDEN + seed) & 0xFFFFu;
            const uint32_t bits = __float_as_uint(add(theta, upd));
            theta_n = __uint_as_float((bits + noise) & 0xFFFF0000u);
            eff = sub(theta_n, theta);
        } else if (CODE == KAHAN) {
            const float c = s[DELTA];
            const float upd_c = rn(add(upd16, c));
            theta_n = rn(add(theta, upd_c));
            const float c_n = rn(sub(upd_c, rn(sub(theta_n, theta))));
            eff = sub(theta_n, theta);
            s[DELTA] = c_n;
        } else {  // B / C: Grow the update into the (theta, delta) expansion
            const float delta = s[DELTA];
            float delta_n;
            grow(theta, delta, upd16, theta_n, delta_n);
            eff = add(sub(theta_n, theta), sub(delta_n, delta));
            s[DELTA] = delta_n;
        }
        s[M] = m_n;
        s[VHI] = vhi_n;
    }
    s[THETA] = theta_n;
}

__device__ __forceinline__ float metric(int which, float u, float e, float g) {
    switch (which) {
        case 0: return mul(u, e);
        case 1: return mul(u, u);
        case 2: return mul(e, e);
        case 3: return (fabsf(u) > 0.f && e == 0.f) ? 1.f : 0.f;
        default: return mul(g, g);
    }
}

// det_sum of N values in registers: y[i] = x[i] + x[i + half], and for odd
// n, y[0] += x[n - 1]
template <int N>
__device__ __forceinline__ float det_sum_regs(float (&x)[N]) {
#pragma unroll
    for (int n = N; n > 1; n >>= 1) {
        const int half = n >> 1;
#pragma unroll
        for (int i = 0; i < half; ++i) x[i] = add(x[i], x[i + half]);
        if (n & 1) x[0] = add(x[0], x[n - 1]);
    }
    return x[0];
}

// ---- br <= 8: one warp a tile of 128 * BR elements ----
template <int CODE, int BR>
__global__ void __launch_bounds__(WARP_BLOCK)
collage_update_warp(Consts k, Ptrs p, const __nv_bfloat16* __restrict__ g,
                    float* __restrict__ partials, int tiles, int pt_decay, uint32_t seed,
                    uint32_t elem_offset) {
    constexpr int Q = BR * LANES / 4;                // elements of a quarter
    const int lane = threadIdx.x & 31;
    const int tile = blockIdx.x * (WARP_BLOCK / 32) + (threadIdx.x >> 5);
    if (tile >= tiles) return;                       // the whole warp: one tile
    const size_t base = (size_t)tile * BR * LANES;
    // (x0 + x2) + (x1 + x3) of the quarters' metric values: -0 + v == v for
    // every v, so the first add copies
    float acc[NMET][BR];
#pragma unroll
    for (int w = 0; w < NMET; ++w)
#pragma unroll
        for (int j = 0; j < BR; ++j) acc[w][j] = -0.f;

#pragma unroll 1
    for (int h = 0; h < 2; ++h) {
        // quarters h and h + 2, which det_sum's first level pairs
        const int e0 = h * Q + lane * BR, e2 = e0 + 2 * Q;
        float xa[NSLOT][BR], xb[NSLOT][BR], ga[BR], gb[BR];
        load_run<BR, false>(g, base + e0, ga);
        load_fields<CODE, BR>(p, base + e0, xa);
        load_run<BR, false>(g, base + e2, gb);
        load_fields<CODE, BR>(p, base + e2, xb);
#pragma unroll
        for (int j = 0; j < BR; ++j) {
            float sa[NSLOT] = {xa[0][j], xa[1][j], xa[2][j], xa[3][j], xa[4][j], xa[5][j]};
            float sb[NSLOT] = {xb[0][j], xb[1][j], xb[2][j], xb[3][j], xb[4][j], xb[5][j]};
            float ua, ea, ub, eb;
            update_one<CODE>(k, ga[j], sa, pt_decay, seed,
                             elem_offset + (uint32_t)(base + e0 + j), ua, ea);
            update_one<CODE>(k, gb[j], sb, pt_decay, seed,
                             elem_offset + (uint32_t)(base + e2 + j), ub, eb);
#pragma unroll
            for (int f = 0; f < NSLOT; ++f) xa[f][j] = sa[f], xb[f][j] = sb[f];
            if (partials) {
#pragma unroll
                for (int w = 0; w < NMET; ++w)
                    acc[w][j] = add(acc[w][j], add(metric(w, ua, ea, ga[j]), metric(w, ub, eb, gb[j])));
            }
        }
        store_fields<CODE, BR>(p, base + e0, xa);
        store_fields<CODE, BR>(p, base + e2, xb);
    }
    if (!partials) return;
#pragma unroll
    for (int w = 0; w < NMET; ++w) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
#pragma unroll
            for (int j = 0; j < BR; ++j)
                acc[w][j] = add(acc[w][j], __shfl_down_sync(FULL, acc[w][j], off));
    }
    if (lane == 0) {
#pragma unroll
        for (int w = 0; w < NMET; ++w) partials[(size_t)w * tiles + tile] = det_sum_regs<BR>(acc[w]);
    }
}

// ---- br >= 16, or unaligned pointers: one block a tile ----
template <int CODE>
__global__ void collage_update_block(Consts k, Ptrs p, const __nv_bfloat16* __restrict__ g,
                                     float* __restrict__ partials, int n_tile, int per_pass,
                                     int pt_decay, uint32_t seed, uint32_t elem_offset) {
    extern __shared__ float buf[];                 // [per_pass][n_tile]
    const int tid = threadIdx.x;
    const size_t base = (size_t)blockIdx.x * n_tile;
    const uint32_t idx0 = elem_offset + (uint32_t)base;
    const int npass = partials ? (NMET + per_pass - 1) / per_pass : 1;

    for (int pass = 0; pass < npass; ++pass) {
        const int k0 = pass * per_pass;
        const int nk = min(NMET - k0, per_pass);
        for (int e = tid; e < n_tile; e += blockDim.x) {
            float x[NSLOT][1], gv[1], u, eff;
            load_run<1, false>(g, base + e, gv);
            load_fields<CODE, 1>(p, base + e, x);
            float s[NSLOT] = {x[0][0], x[1][0], x[2][0], x[3][0], x[4][0], x[5][0]};
            update_one<CODE>(k, gv[0], s, pt_decay, seed, idx0 + (uint32_t)e, u, eff);
            if (pass == npass - 1) {               // in place: after every read
#pragma unroll
                for (int f = 0; f < NSLOT; ++f) x[f][0] = s[f];
                store_fields<CODE, 1>(p, base + e, x);
            }
            if (partials)
                for (int j = 0; j < nk; ++j) buf[j * n_tile + e] = metric(k0 + j, u, eff, gv[0]);
        }
        if (!partials) return;
        __syncthreads();
        // det_sum over each of the nk rows of buf, all rows level by level
        for (int cur = n_tile; cur > 1; cur >>= 1) {
            const int half = cur >> 1;
            for (int j = tid; j < nk * half; j += blockDim.x) {
                float* b = buf + (j / half) * n_tile;
                const int i = j % half;
                b[i] = add(b[i], b[i + half]);
            }
            __syncthreads();
            if (cur & 1) {
                if (tid < nk) buf[tid * n_tile] = add(buf[tid * n_tile], buf[tid * n_tile + cur - 1]);
                __syncthreads();
            }
        }
        if (tid < nk) partials[(size_t)(k0 + tid) * gridDim.x + blockIdx.x] = buf[tid * n_tile];
        __syncthreads();                            // the next pass reuses buf
    }
}

// ---- the sum over the tiles: det_sum of each row of the (5, tiles)
// partials ----
//
// det_sum's level l is y_l[r] = y_{l-1}[r] + y_{l-1}[r + n_l] for r < n_l =
// n_{l-1} / 2 (n_0 = tiles), with y_l[0] += y_{l-1}[n_{l-1} - 1] when
// n_{l-1} is odd. So y_i[idx] for idx >= 1 is a fixed tree over the 2^i
// tiles idx + sum_l b_l n_l (b_l in {0, 1}), whose level l pairs the leaves
// that differ in b_l: in the order of c = (b_i ... b_1) in binary it pairs
// neighbours first, then neighbouring pairs, and so on. K levels are done
// at once: collage_finish_levels forms every such tree one warp each (a
// lane's run of consecutive c in registers, then shuffles with lane + 1,
// + 2, ...): y_K[r] for 1 <= r < n_K, and y_0[0]'s extra terms y_l[n_{l+1}]
// and y_l[n_l - 1]; collage_finish adds those into y_K[0] in det_sum's
// order and runs the remaining levels in one block's shared memory.

constexpr int MAXK = 20;                   // tiles < 2^31: K <= 20
constexpr int LEAVES_AT_ONCE = 8;          // a lane's independent loads

// y_i[idx] (idx >= 1) of row x, by one warp; the sum lands in lane 0
__device__ float warp_tree(const float* __restrict__ x, int idx, int i, const int* n, int lane) {
    const int lanes = i >= 5 ? 32 : 1 << i;
    const int per = i >= 5 ? 1 << (i - 5) : 1;          // consecutive c a lane
    float stk[MAXK + 1];
    float t = 0.f;
    if (lane < lanes) {
        for (int u0 = 0; u0 < per; u0 += LEAVES_AT_ONCE) {
            float v[LEAVES_AT_ONCE];
#pragma unroll
            for (int u = 0; u < LEAVES_AT_ONCE; ++u) {
                const int c = lane * per + u0 + u;
                int off = idx;
                for (int l = 1; l <= i; ++l) off += ((c >> (l - 1)) & 1) * n[l];
                v[u] = u0 + u < per ? __ldg(x + off) : 0.f;
            }
#pragma unroll
            for (int u = 0; u < LEAVES_AT_ONCE; ++u) {
                if (u0 + u >= per) break;
                float a = v[u];
                int lvl = 0;
                for (int cc = u0 + u; cc & 1; cc >>= 1) a = add(stk[lvl++], a);
                stk[lvl] = a;
            }
        }
        t = stk[i >= 5 ? i - 5 : 0];
    }
    for (int off = 1; off < lanes; off <<= 1) t = add(t, __shfl_down_sync(FULL, t, off));
    return t;
}

__device__ __forceinline__ int level_sizes(int tiles, int K, int* n) {
    n[0] = tiles;
    for (int l = 1; l <= K; ++l) n[l] = n[l - 1] >> 1;
    return n[K] - 1 + 2 * K;                              // trees a row
}

// terms (5, n_K - 1 + 2K): y_K[1 .. n_K), then y_l[n_{l+1}], y_l[n_l - 1]
// for l < K (the second only where n_l is odd)
__global__ void __launch_bounds__(128)
collage_finish_levels(const float* __restrict__ part, int tiles, int K, float* __restrict__ terms) {
    int n[MAXK + 1];
    const int per_row = level_sizes(tiles, K, n);
    const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5, lane = threadIdx.x & 31;
    if (warp >= NMET * per_row) return;
    const int w = warp / per_row, j = warp % per_row;
    int idx = j + 1, i = K;
    if (j >= n[K] - 1) {
        const int l = (j - (n[K] - 1)) >> 1, odd = (j - (n[K] - 1)) & 1;
        if (odd && !(n[l] & 1)) return;
        idx = odd ? n[l] - 1 : n[l + 1];
        i = l;
    }
    const float t = warp_tree(part + (size_t)w * tiles, idx, i, n, lane);
    if (lane == 0) terms[(size_t)w * per_row + j] = t;
}

// det_sum of each of the 5 rows, from y_K (K > 0: y_K[0] formed here from
// x[0] and its extra terms) or from the partials themselves (K == 0), in
// one block's shared memory
__global__ void __launch_bounds__(FINISH_THREADS)
collage_finish(const float* __restrict__ part, int tiles, int K, const float* __restrict__ terms,
               float* __restrict__ sums) {
    __shared__ float sm[NMET][FINISH_ROWS];
    int n[MAXK + 1];
    const int per_row = level_sizes(tiles, K, n);
    const int tid = threadIdx.x;
    int len = n[K];
    for (int w = 0; w < NMET; ++w)
        for (int i = tid; i < len; i += FINISH_THREADS)
            sm[w][i] = K == 0 ? part[(size_t)w * tiles + i]
                              : i ? terms[(size_t)w * per_row + i - 1] : 0.f;
    if (K > 0 && tid < NMET) {
        const float* t = terms + (size_t)tid * per_row + n[K] - 1;
        float y = part[(size_t)tid * tiles];
        for (int l = 0; l < K; ++l) {
            y = add(y, t[2 * l]);
            if (n[l] & 1) y = add(y, t[2 * l + 1]);
        }
        sm[tid][0] = y;
    }
    __syncthreads();
    for (; len > 1; len >>= 1) {
        const int half = len >> 1;
        for (int w = 0; w < NMET; ++w)
            for (int i = tid; i < half; i += FINISH_THREADS) sm[w][i] = add(sm[w][i], sm[w][i + half]);
        __syncthreads();
        if (len & 1) {
            if (tid < NMET) sm[tid][0] = add(sm[tid][0], sm[tid][len - 1]);
            __syncthreads();
        }
    }
    if (tid < NMET) sums[tid] = sm[tid][0];
}

// The sums over the tiles into `sums`; `scratch` holds the trees' terms
// (5 x (FINISH_ROWS + 2 MAXK) at most).
cudaError_t finish(const float* part, int tiles, float* scratch, float* sums, cudaStream_t s) {
    int K = 0, nk = tiles;
    while (nk > FINISH_ROWS) nk >>= 1, ++K;
    if (K > 0) {
        const int warps = NMET * (nk - 1 + 2 * K);
        collage_finish_levels<<<(warps + 3) / 4, 128, 0, s>>>(part, tiles, K, scratch);
        cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return err;
    }
    collage_finish<<<1, FINISH_THREADS, 0, s>>>(part, tiles, K, scratch, sums);
    return cudaGetLastError();
}

template <int CODE, int BR>
cudaError_t launch_warp(const Consts& k, const Ptrs& p, const __nv_bfloat16* g, float* partials,
                        int tiles, int pt_decay, uint32_t seed, uint32_t offset,
                        cudaStream_t stream) {
    const int grid = (int)(((int64_t)tiles + WARP_BLOCK / 32 - 1) / (WARP_BLOCK / 32));
    collage_update_warp<CODE, BR><<<grid, WARP_BLOCK, 0, stream>>>(k, p, g, partials, tiles,
                                                                   pt_decay, seed, offset);
    return cudaGetLastError();
}

bool aligned16(const Ptrs& p, const void* g) {
    uintptr_t bits = reinterpret_cast<uintptr_t>(g);
    for (int s = 0; s < NSLOT; ++s)
        bits |= reinterpret_cast<uintptr_t>(p.in[s]) | reinterpret_cast<uintptr_t>(p.out[s]);
    return bits % 16 == 0;
}

template <int CODE>
cudaError_t launch(const Consts& k, const Ptrs& p, const __nv_bfloat16* g, float* partials,
                   int tiles, int br, int pt_decay, uint32_t seed, uint32_t offset,
                   cudaStream_t stream) {
    const int n_tile = br * LANES;
    if (br <= 8 && aligned16(p, g)) {
        switch (br) {
            case 1: return launch_warp<CODE, 1>(k, p, g, partials, tiles, pt_decay, seed, offset, stream);
            case 2: return launch_warp<CODE, 2>(k, p, g, partials, tiles, pt_decay, seed, offset, stream);
            case 3: return launch_warp<CODE, 3>(k, p, g, partials, tiles, pt_decay, seed, offset, stream);
            case 4: return launch_warp<CODE, 4>(k, p, g, partials, tiles, pt_decay, seed, offset, stream);
            case 5: return launch_warp<CODE, 5>(k, p, g, partials, tiles, pt_decay, seed, offset, stream);
            case 6: return launch_warp<CODE, 6>(k, p, g, partials, tiles, pt_decay, seed, offset, stream);
            case 7: return launch_warp<CODE, 7>(k, p, g, partials, tiles, pt_decay, seed, offset, stream);
            default: return launch_warp<CODE, 8>(k, p, g, partials, tiles, pt_decay, seed, offset, stream);
        }
    }
    int per_pass = 0;
    size_t smem = 0;
    if (partials) {
        per_pass = SMEM_LIMIT / (n_tile * (int)sizeof(float));
        per_pass = per_pass > NMET ? NMET : per_pass;
        if (per_pass < 1) return cudaErrorInvalidValue;
        smem = (size_t)per_pass * n_tile * sizeof(float);
        cudaError_t err = cudaFuncSetAttribute(collage_update_block<CODE>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)smem);
        if (err != cudaSuccess) return err;
    }
    const int threads = n_tile >= 256 ? 256 : 128;
    collage_update_block<CODE><<<tiles, threads, smem, stream>>>(k, p, g, partials, n_tile,
                                                                  per_pass, pt_decay, seed, offset);
    return cudaGetLastError();
}

}  // namespace

// code: 0 A, 1 B, 2 C, 3 KAHAN, 4 SR, 5 D-, 6 D. n: bucket length, a multiple
// of br * 128, with at most 2^31 - 1 tiles; br: rows per tile (1..256). g:
// bf16 (n). in/out: theta, m, vhi, vlo, delta, master (null where the
// strategy has no such field; m and vhi are f32 for D-/D, master f32, the
// rest bf16; each output is either its input or disjoint from every input).
// partials: null, or f32 scratch (5, n / (br * 128)), metric-major.
// sums: null, or f32 (8 + 5 * (2048 + 48)): with partials, one or two more
// launches sum the partials over the tiles into sums[0..5), using the rest
// as scratch. consts: 16 host f32
// values (lr, bc1, bc2, b1, c1, b2, c2, cb1, c1m, cb2, c2m, b2hi, b2lo, eps,
// wd_upd, factor). Returns a cudaError_t.
extern "C" int collage_update(int code, int64_t n, int br, int pt_decay, const void* g,
                              const void* theta, const void* m, const void* vhi, const void* vlo,
                              const void* delta, const void* master, void* theta_o, void* m_o,
                              void* vhi_o, void* vlo_o, void* delta_o, void* master_o,
                              void* partials, void* sums, const void* consts, uint32_t seed,
                              uint32_t elem_offset, void* stream) {
    if (n <= 0 || br <= 0 || br > 256 || n % (br * LANES) != 0 || (sums && !partials)
        || n / (br * LANES) > INT32_MAX)
        return (int)cudaErrorInvalidValue;
    const int tiles = (int)(n / (br * LANES));
    Consts k = *static_cast<const Consts*>(consts);
    Ptrs p = {{theta, m, vhi, vlo, delta, master}, {theta_o, m_o, vhi_o, vlo_o, delta_o, master_o}};
    const __nv_bfloat16* gp = static_cast<const __nv_bfloat16*>(g);
    float* part = static_cast<float*>(partials);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err;
    switch (code) {
        case A: err = launch<A>(k, p, gp, part, tiles, br, pt_decay, seed, elem_offset, s); break;
        case B: err = launch<B>(k, p, gp, part, tiles, br, pt_decay, seed, elem_offset, s); break;
        case C: err = launch<C>(k, p, gp, part, tiles, br, pt_decay, seed, elem_offset, s); break;
        case KAHAN: err = launch<KAHAN>(k, p, gp, part, tiles, br, pt_decay, seed, elem_offset, s); break;
        case SR: err = launch<SR>(k, p, gp, part, tiles, br, pt_decay, seed, elem_offset, s); break;
        case DMINUS: err = launch<DMINUS>(k, p, gp, part, tiles, br, pt_decay, seed, elem_offset, s); break;
        case D: err = launch<D>(k, p, gp, part, tiles, br, pt_decay, seed, elem_offset, s); break;
        default: return (int)cudaErrorInvalidValue;
    }
    if (err != cudaSuccess || !sums) return (int)err;
    float* out = static_cast<float*>(sums);
    return (int)finish(part, tiles, out + 8, out, s);
}

extern "C" const char* collage_update_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

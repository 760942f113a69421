// Fused Collage-AdamW update of one flat parameter bucket, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/collage_update/collage_update.py::collage_update_kernel
// (the Pallas TPU kernel launched by collage_bucket_update). Same function:
// one pass over the bucket computing the m/v EMAs, the bias-corrected AdamW
// update and the strategy's rule (A, B, C, KAHAN, SR, D-, D), rounding to
// nearest-even onto bf16 after every operation, plus the per-tile metric
// partials (<upd, eff>, |upd|^2, |eff|^2, #lost, |g|^2) summed in det_sum
// order over each (br x 128) tile.
//
// What bounds it on the H100: it is elementwise, ~60 f32 operations per
// element against 22 bytes moved for strategy C (6 bf16 reads + 5 writes);
// at gpt-125m's bucket (162,149,376 elements) that is 3.57 GB, ~1.06 ms at
// 3.35 TB/s. So bytes bound it; the design reads and writes each element
// once and keeps the metric partials in shared memory.
//
// Numerics: every f32 operation is written as __fadd_rn / __fsub_rn /
// __fmul_rn / __fdiv_rn / __fsqrt_rn, which nvcc never contracts into an
// FMA (an FMA would erase the roundoff the error-free transformations
// keep) and which keep subnormals (no FTZ). rn(x) is __float2bfloat16_rn
// then __bfloat162float. The plain PyTorch version
// (kernels/collage_update/ref.py) does the same operations one by one, so
// the two agree bit for bit.
//
// Design (simple first):
//  * one block per tile of br x 128 elements (br = choose_block_rows), the
//    JAX kernel's tile, so the partials are summed over the same elements;
//    256 threads stride over the tile, neighbouring threads on neighbouring
//    elements;
//  * the strategy is a template argument: one specialised kernel per code;
//  * metrics: each thread writes its elements' metric values into shared
//    memory, then the block halves the tile in det_sum order
//    (y[i] = x[i] + x[i + half]; for odd n, y[0] += x[n - 1]) with a
//    __syncthreads between levels. As many of the 5 metrics as fit in
//    160 KB are reduced per pass; a large tile (br 128 or 256) takes more
//    than one pass and recomputes the update from its inputs in each
//    (outputs are written in the first pass only, so they must not alias
//    the inputs);
//  * the SR noise index is elem_offset + tile * br * 128 + element in uint32
//    (wrapping), hashed by lowbias32 as bucketing.sr_noise_bits does.
//
// C entry: collage_update(...) returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NMET = 5;
constexpr int NPART = 8;
constexpr int LANES = 128;
constexpr int SMEM_LIMIT = 160 * 1024;   // bytes of metric scratch per block
constexpr uint32_t GOLDEN = 0x9E3779B9u;

enum Code { A = 0, B = 1, C = 2, KAHAN = 3, SR = 4, DMINUS = 5, D = 6 };

struct Consts {
    float lr, bc1, bc2, b1, c1, b2, c2, cb1, c1m, cb2, c2m, b2hi, b2lo, eps, wd_upd, factor;
};

// field slots: theta, m, vhi, vlo, delta, master
struct Ptrs {
    const void* in[6];
    void* out[6];
};

__device__ __forceinline__ float rn(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }

template <bool F32>
__device__ __forceinline__ float load(const void* p, size_t i) {
    if (F32) return static_cast<const float*>(p)[i];
    return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
}

template <bool F32>
__device__ __forceinline__ void store(void* p, size_t i, float x) {
    if (F32)
        static_cast<float*>(p)[i] = x;
    else
        static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(x);   // x is on the grid
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

// One element: reads slot i, writes slot i when `write`, returns upd and eff.
template <int CODE>
__device__ __forceinline__ void update_one(const Consts& k, const Ptrs& p,
                                           const __nv_bfloat16* __restrict__ gp, size_t i,
                                           int pt_decay, uint32_t seed, uint32_t idx, bool write,
                                           float& upd, float& eff, float& g) {
    constexpr bool OPT32 = CODE == DMINUS || CODE == D;
    g = __bfloat162float(gp[i]);
    const float theta = load<false>(p.in[0], i);
    const float m = load<OPT32>(p.in[1], i);
    const float vhi = load<OPT32>(p.in[2], i);
    float theta_n;

    if (OPT32) {
        const float m_n = add(mul(k.b1, m), mul(k.c1, g));
        const float v_n = add(mul(k.b2, vhi), mul(mul(k.c2, g), g));
        const float mhat = __fdiv_rn(m_n, k.bc1);
        const float vhat = __fdiv_rn(v_n, k.bc2);
        const float step = __fdiv_rn(mhat, add(__fsqrt_rn(vhat), k.eps));
        if (CODE == D) {
            const float w = load<true>(p.in[5], i);
            upd = mul(-k.lr, add(step, mul(k.wd_upd, w)));
            const float w_n = add(w, upd);
            theta_n = rn(w_n);
            if (write) store<true>(p.out[5], i, w_n);
        } else {
            upd = mul(-k.lr, add(step, mul(k.wd_upd, theta)));
            theta_n = rn(add(theta, rn(upd)));
        }
        eff = sub(theta_n, theta);
        if (write) {
            store<true>(p.out[1], i, m_n);
            store<true>(p.out[2], i, v_n);
        }
    } else {
        const float m_n = rn(add(rn(mul(k.cb1, m)), rn(mul(k.c1m, g))));
        const float g2 = rn(mul(g, g));
        float vhi_n, vhat;
        if (CODE == C) {
            const float vlo = load<false>(p.in[3], i);
            float ph, plo, vlo_n;
            mul_expansion(k.b2hi, k.b2lo, vhi, vlo, ph, plo);
            grow(ph, plo, rn(mul(k.c2m, g2)), vhi_n, vlo_n);
            vhat = __fdiv_rn(add(vhi_n, vlo_n), k.bc2);
            if (write) store<false>(p.out[3], i, vlo_n);
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
            const float c = load<false>(p.in[4], i);
            const float upd_c = rn(add(upd16, c));
            theta_n = rn(add(theta, upd_c));
            const float c_n = rn(sub(upd_c, rn(sub(theta_n, theta))));
            eff = sub(theta_n, theta);
            if (write) store<false>(p.out[4], i, c_n);
        } else {  // B / C: Grow the update into the (theta, delta) expansion
            const float delta = load<false>(p.in[4], i);
            float delta_n;
            grow(theta, delta, upd16, theta_n, delta_n);
            eff = add(sub(theta_n, theta), sub(delta_n, delta));
            if (write) store<false>(p.out[4], i, delta_n);
        }
        if (write) {
            store<false>(p.out[1], i, m_n);
            store<false>(p.out[2], i, vhi_n);
        }
    }
    if (write) store<false>(p.out[0], i, theta_n);
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

template <int CODE>
__global__ void collage_update_kernel(Consts k, Ptrs p, const __nv_bfloat16* __restrict__ g,
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
            float u, eff, gv;
            update_one<CODE>(k, p, g, base + e, pt_decay, seed, idx0 + (uint32_t)e, pass == 0, u,
                             eff, gv);
            if (partials)
                for (int j = 0; j < nk; ++j) buf[j * n_tile + e] = metric(k0 + j, u, eff, gv);
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
        if (tid < nk) partials[(size_t)blockIdx.x * NPART + k0 + tid] = buf[tid * n_tile];
        __syncthreads();                            // the next pass reuses buf
    }
    if (tid >= NMET && tid < NPART) partials[(size_t)blockIdx.x * NPART + tid] = 0.f;
}

template <int CODE>
cudaError_t launch(const Consts& k, const Ptrs& p, const __nv_bfloat16* g, float* partials,
                   int n, int br, int pt_decay, uint32_t seed, uint32_t offset,
                   cudaStream_t stream) {
    const int n_tile = br * LANES;
    const int grid = n / n_tile;
    int per_pass = 0;
    size_t smem = 0;
    if (partials) {
        per_pass = SMEM_LIMIT / (n_tile * (int)sizeof(float));
        per_pass = per_pass > NMET ? NMET : per_pass;
        if (per_pass < 1) return cudaErrorInvalidValue;
        smem = (size_t)per_pass * n_tile * sizeof(float);
        cudaError_t err = cudaFuncSetAttribute(collage_update_kernel<CODE>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)smem);
        if (err != cudaSuccess) return err;
    }
    const int threads = n_tile >= 256 ? 256 : 128;
    collage_update_kernel<CODE><<<grid, threads, smem, stream>>>(k, p, g, partials, n_tile,
                                                                 per_pass, pt_decay, seed, offset);
    return cudaGetLastError();
}

}  // namespace

// code: 0 A, 1 B, 2 C, 3 KAHAN, 4 SR, 5 D-, 6 D. n: bucket length, a multiple
// of br * 128; br: rows per tile (1..256). g: bf16 (n). in/out: theta, m, vhi,
// vlo, delta, master (null where the strategy has no such field; m and vhi
// are f32 for D-/D, master f32, the rest bf16; outputs must not alias
// inputs). partials: null, or f32 (n / (br * 128), 8). consts: 16 host f32
// values (lr, bc1, bc2, b1, c1, b2, c2, cb1, c1m, cb2, c2m, b2hi, b2lo, eps,
// wd_upd, factor). Returns a cudaError_t.
extern "C" int collage_update(int code, int n, int br, int pt_decay, const void* g,
                              const void* theta, const void* m, const void* vhi, const void* vlo,
                              const void* delta, const void* master, void* theta_o, void* m_o,
                              void* vhi_o, void* vlo_o, void* delta_o, void* master_o,
                              void* partials, const void* consts, uint32_t seed,
                              uint32_t elem_offset, void* stream) {
    if (n <= 0 || br <= 0 || br > 256 || n % (br * LANES) != 0) return (int)cudaErrorInvalidValue;
    Consts k = *static_cast<const Consts*>(consts);
    Ptrs p = {{theta, m, vhi, vlo, delta, master}, {theta_o, m_o, vhi_o, vlo_o, delta_o, master_o}};
    const __nv_bfloat16* gp = static_cast<const __nv_bfloat16*>(g);
    float* part = static_cast<float*>(partials);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (code) {
        case A: return (int)launch<A>(k, p, gp, part, n, br, pt_decay, seed, elem_offset, s);
        case B: return (int)launch<B>(k, p, gp, part, n, br, pt_decay, seed, elem_offset, s);
        case C: return (int)launch<C>(k, p, gp, part, n, br, pt_decay, seed, elem_offset, s);
        case KAHAN:
            return (int)launch<KAHAN>(k, p, gp, part, n, br, pt_decay, seed, elem_offset, s);
        case SR: return (int)launch<SR>(k, p, gp, part, n, br, pt_decay, seed, elem_offset, s);
        case DMINUS:
            return (int)launch<DMINUS>(k, p, gp, part, n, br, pt_decay, seed, elem_offset, s);
        case D: return (int)launch<D>(k, p, gp, part, n, br, pt_decay, seed, elem_offset, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

extern "C" const char* collage_update_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

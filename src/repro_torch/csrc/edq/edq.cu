// EDQ metric partials of one (update, effective update) pair, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/edq/edq.py::edq_kernel (the Pallas TPU kernel
// launched by edq_metrics). Same function: one pass over u = dtheta and
// e = dtheta_hat (f32) producing, per block of the grid, the four partial
// sums <u, e>, |u|^2, |e|^2 and #(|u| > atol and e == 0) into a (grid, 4)
// f32 buffer, which a second one-block launch sums column by column (the
// JAX wrapper's partials[:, i].sum()); the wrapper (kernels/edq/edq.py)
// finalizes EDQ, the norms and the imprecision %.
//
// What bounds it on the H100: 8 bytes read per element and 7 f32
// operations; at gpt-125m's largest leaf (embed, 38,597,376 elements) that
// is 309 MB, ~0.092 ms at 3.35 TB/s, so bytes bound it. The design reads
// each element once, with 16-byte loads where both pointers allow them.
//
// Design (simple first):
//  * one block of 256 threads per tile of 16,384 elements; the last tile
//    is ragged and masked here, so any n >= 1 is taken (the TPU kernel
//    needs n % 128 == 0; the tree step's leaves are not all so);
//  * each thread accumulates its elements' four sums in registers
//    (products rounded to f32, then added: __fmul_rn / __fadd_rn, as the
//    JAX kernel's sum(u * e) rounds them), then a warp-shuffle reduction
//    and one over the block's 8 warps through shared memory;
//  * each thread takes 4 consecutive elements per step (one 16-byte load
//    of each input where both pointers are 16-byte aligned, four scalar
//    loads of the same elements where not);
//  * each block writes its own row of the (grid, 4) partials: no atomics,
//    so the result repeats bit for bit for a given n;
//  * edq_finish (one block) sums the rows in f64 in a fixed order and
//    rounds each column once to f32. The lost count is exact within a block
//    (at most 16,384), so the total stays exact past 2^24, where the JAX
//    kernel's f32 sum is not; one launch, where three torch ops (to f64,
//    sum, to f32) cost ~40 us a call.
//
// C entry: edq_partials(...) launches both and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr long long TILE = 16384;   // elements per block
constexpr int NPART = 4;

struct Acc {
    float dot, uu, ee, lost;
};

__device__ __forceinline__ void add(Acc& a, float u, float e, float atol) {
    a.dot = __fadd_rn(a.dot, __fmul_rn(u, e));
    a.uu = __fadd_rn(a.uu, __fmul_rn(u, u));
    a.ee = __fadd_rn(a.ee, __fmul_rn(e, e));
    a.lost = __fadd_rn(a.lost, (fabsf(u) > atol && e == 0.f) ? 1.f : 0.f);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x = __fadd_rn(x, __shfl_down_sync(0xffffffffu, x, off));
    return x;
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
edq_kernel(const float* __restrict__ u, const float* __restrict__ e, float* __restrict__ partials,
           long long n, float atol) {
    const long long start = (long long)blockIdx.x * TILE;
    const long long len = n - start < TILE ? n - start : TILE;
    const float* ut = u + start;
    const float* et = e + start;
    Acc a = {0.f, 0.f, 0.f, 0.f};
    // 4 consecutive elements per thread per step, 16-byte loads where both
    // pointers are 16-byte aligned (TILE is a multiple of 4); the scalar
    // path takes the same elements in the same order, so alignment does not
    // change the result
    const long long n4 = len / 4;
#pragma unroll 4
    for (long long i = threadIdx.x; i < n4; i += THREADS) {
        float4 x, y;
        if (VEC) {
            x = __ldg(reinterpret_cast<const float4*>(ut) + i);
            y = __ldg(reinterpret_cast<const float4*>(et) + i);
        } else {
            x = make_float4(__ldg(ut + 4 * i), __ldg(ut + 4 * i + 1), __ldg(ut + 4 * i + 2),
                            __ldg(ut + 4 * i + 3));
            y = make_float4(__ldg(et + 4 * i), __ldg(et + 4 * i + 1), __ldg(et + 4 * i + 2),
                            __ldg(et + 4 * i + 3));
        }
        add(a, x.x, y.x, atol);
        add(a, x.y, y.y, atol);
        add(a, x.z, y.z, atol);
        add(a, x.w, y.w, atol);
    }
    for (long long i = n4 * 4 + threadIdx.x; i < len; i += THREADS)
        add(a, __ldg(ut + i), __ldg(et + i), atol);

    __shared__ float red[THREADS / 32][NPART];
    float v[NPART] = {a.dot, a.uu, a.ee, a.lost};
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
#pragma unroll
    for (int k = 0; k < NPART; ++k) v[k] = warp_sum(v[k]);
    if (lane == 0) {
#pragma unroll
        for (int k = 0; k < NPART; ++k) red[warp][k] = v[k];
    }
    __syncthreads();
    if (warp == 0) {
#pragma unroll
        for (int k = 0; k < NPART; ++k) {
            const float x = warp_sum(lane < THREADS / 32 ? red[lane][k] : 0.f);
            if (lane == 0) partials[(long long)blockIdx.x * NPART + k] = x;
        }
    }
}

__global__ void __launch_bounds__(THREADS)
edq_finish(const float* __restrict__ partials, long long grid, float* __restrict__ out) {
    double acc[NPART] = {0.0, 0.0, 0.0, 0.0};
    for (long long r = threadIdx.x; r < grid; r += THREADS) {
#pragma unroll
        for (int k = 0; k < NPART; ++k) acc[k] += (double)partials[r * NPART + k];
    }
    __shared__ double red[THREADS][NPART];
#pragma unroll
    for (int k = 0; k < NPART; ++k) red[threadIdx.x][k] = acc[k];
    __syncthreads();
    for (int half = THREADS / 2; half > 0; half >>= 1) {
        if (threadIdx.x < half) {
#pragma unroll
            for (int k = 0; k < NPART; ++k) red[threadIdx.x][k] += red[threadIdx.x + half][k];
        }
        __syncthreads();
    }
    if (threadIdx.x < NPART) out[threadIdx.x] = (float)red[0][threadIdx.x];
}

}  // namespace

// u, e: f32 (n), n >= 1. partials: f32 scratch (grid, 4) with grid =
// ceil(n / 16384); the caller passes the grid it allocated, and a mismatch
// is refused. out: f32 (4), the column sums. atol: the lost count takes
// |u| > atol. Returns a cudaError_t.
extern "C" int edq_partials(const void* u, const void* e, void* partials, void* out,
                            long long n, long long grid, float atol, void* stream) {
    if (n <= 0 || grid != (n + TILE - 1) / TILE || grid > 0x7fffffffLL)
        return (int)cudaErrorInvalidValue;
    const float* up = static_cast<const float*>(u);
    const float* ep = static_cast<const float*>(e);
    float* part = static_cast<float*>(partials);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const bool vec = (reinterpret_cast<uintptr_t>(u) % 16 == 0) &&
                     (reinterpret_cast<uintptr_t>(e) % 16 == 0);
    if (vec)
        edq_kernel<true><<<(unsigned)grid, THREADS, 0, s>>>(up, ep, part, n, atol);
    else
        edq_kernel<false><<<(unsigned)grid, THREADS, 0, s>>>(up, ep, part, n, atol);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    edq_finish<<<1, THREADS, 0, s>>>(part, grid, static_cast<float*>(out));
    return (int)cudaGetLastError();
}

extern "C" const char* edq_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

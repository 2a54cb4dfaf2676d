// Heaviest-path max-plus DP alone, for a batch of consensus windows,
// hand-written for Hopper (sm_90a).
//
// Replaces daccord_tpu/kernels/pallas_dp.py:heaviest_path_batch (the Pallas
// TPU kernel, body _dp_kernel), the DP of the JAX package's scan route
// (window_kernel._dp_scan_one), and computes exactly what it computes, bit
// for bit: scores[t, v] = max_u (scores[t-1, u] + adjW[u, v]) + wt[t, v],
// NEG where the best predecessor is NEG, ptrs[t, v] the lowest u reaching
// the max; row 0 is s0 with pointer 0. The adjacency bits and the DP step
// are csrc/dp_bits.cuh, shared with csrc/dp_backtrack.cu.
//
// What bounds it on this card: the DP's (P-1) * M * M cells per window. A
// cell costs a bit test and a select, and every four cells three maxima and
// one compare-and-update: ~3.5 instructions, all on the SM's integer/logic
// pipe, which takes a warp instruction every other cycle. At M=256 and
// B=2048 that is ~1.3 ms of that pipe on 132 SMs (PERF.md has the times);
// the bytes bound, one read of the inputs (B * M * M * 4 for adjW) and one
// write of both [B, P, M] stacks (172 MB), is 0.24 ms. A simple kernel that
// re-read the f32 adjacency from L2 or HBM at every step ran 30x above that
// bound.
//
// What the design does about it: the adjacency is read once, as 16-byte
// loads, into bits (8 KB a window at M=256) and from there into registers,
// so the P-1 steps touch device memory only for wt and the two output rows;
// the two possible terms of each predecessor are added once per step, not
// once per cell; a cell's compare-and-update is shared by a group of four
// (csrc/dp_bits.cuh); a column's predecessors are split over S=2 threads and
// K compare chains, so that a batch of ~128 windows (the escalation tiers)
// still fills the card with short serial chains. One window a block: two a
// block at M=64 measured the same at B=2048 and 1.2-1.3x slower at B=128.
// The output rows are written once per step by the column's threads, in
// full 32-byte sectors.

#include "dp_bits.cuh"

using namespace dpbits;

template <int S, int U, int K>
struct HpConfig {
    static constexpr int MP = S * U;          // padded columns
    static constexpr int THREADS = S * MP;    // one window a block
    static constexpr int ZS = S * (U + 4);    // one term buffer
};

template <int S, int U, int K>
__global__ void __launch_bounds__(HpConfig<S, U, K>::THREADS,
                                  1024 / HpConfig<S, U, K>::THREADS)
heaviest_path_kernel(
    const float* __restrict__ adjW,     // [B, M, M]
    const float* __restrict__ wt,       // [B, P, M]
    const float* __restrict__ s0,       // [B, M]
    float* __restrict__ scores,         // [B, P, M]
    int32_t* __restrict__ ptrs,         // [B, P, M]
    int M, int P)
{
    using C = HpConfig<S, U, K>;
    extern __shared__ __align__(16) unsigned char smem[];
    float* Z = reinterpret_cast<float*>(smem);              // [2][ZS]
    float* N = Z + 2 * C::ZS;                                // [2][ZS]
    unsigned* bits = reinterpret_cast<unsigned*>(N + 2 * C::ZS);

    const int b = blockIdx.x;
    const int v = threadIdx.x / S;
    const int s = threadIdx.x % S;
    const bool col = v < M;

    load_bits(adjW + (size_t)b * M * M, M * M, bits);
    __syncthreads();
    unsigned cw[U / 32];
    column_bits<U>(bits, M, s * U, v, cw);

    const float* w = wt + (size_t)b * P * M;
    float* sc = scores + (size_t)b * P * M;
    int32_t* pt = ptrs + (size_t)b * P * M;
    const int zv = zpad<U>(v);
    const float start = col ? s0[(size_t)b * M + v] : 0.f;
    if (s == 0) {
        Z[zv] = col ? start + 0.0f : neg_inf();
        if (col) sc[v] = start;
    }
    if (s == S - 1) {
        N[zv] = col ? start + NEGF : neg_inf();
        if (col) pt[v] = 0;
    }
    __syncthreads();

    int cur = 0;
    for (int t = 1; t < P; ++t) {
        const float wv = col ? w[(size_t)t * M + v] : 0.f;
        float best;
        int bu;
        dp_step<S, U, K>(Z + cur * C::ZS, N + cur * C::ZS, cw, s, best, bu);
        const float sn = (best > NEGF * 0.5f) ? best + wv : NEGF;
        const int nx = cur ^ 1;
        if (s == 0) {
            Z[nx * C::ZS + zv] = col ? sn + 0.0f : neg_inf();
            if (col) sc[(size_t)t * M + v] = sn;
        }
        if (s == S - 1) {
            N[nx * C::ZS + zv] = col ? sn + NEGF : neg_inf();
            if (col) pt[(size_t)t * M + v] = bu;
        }
        __syncthreads();
        cur = nx;
    }
}

template <int S, int U, int K>
static int launch(const float* adjW, const float* wt, const float* s0,
                  float* scores, int32_t* ptrs, int B, int M, int P,
                  cudaStream_t stream)
{
    using C = HpConfig<S, U, K>;
    const size_t smem = 4 * (size_t)(4 * C::ZS) + 4 * (size_t)bits_words(M * M);
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            heaviest_path_kernel<S, U, K>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    heaviest_path_kernel<S, U, K><<<B, C::THREADS, smem, stream>>>(
        adjW, wt, s0, scores, ptrs, M, P);
    return (int)cudaGetLastError();
}

extern "C" int heaviest_path_launch(
    const void* adjW, const void* wt, const void* s0, void* scores, void* ptrs,
    int B, int M, int P, void* stream)
{
    if (B == 0) return 0;
    const float* a = (const float*)adjW;
    const float* w = (const float*)wt;
    const float* s = (const float*)s0;
    float* sc = (float*)scores;
    int32_t* pt = (int32_t*)ptrs;
    cudaStream_t st = (cudaStream_t)stream;
    // the split follows from M alone: two threads a column up to M=512, one
    // above (a block holds at most 1024 threads), one window a block
    if (M <= 64) return launch<2, 32, 2>(a, w, s, sc, pt, B, M, P, st);
    if (M <= 256) return launch<2, 128, 4>(a, w, s, sc, pt, B, M, P, st);
    if (M <= 512) return launch<2, 256, 4>(a, w, s, sc, pt, B, M, P, st);
    if (M <= 1024) return launch<1, 1024, 4>(a, w, s, sc, pt, B, M, P, st);
    return (int)cudaErrorInvalidValue;
}

extern "C" const char* heaviest_path_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}

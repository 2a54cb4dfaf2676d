// The OffsetLikely position weights of a batch of windows in one fixed
// summation order, hand-written for Hopper (sm_90a):
//
//     occ[b, m, o] = #{(d, i) : kid[b, d, i] == m and min(i, O-1) == o}
//     W[b, m, p]   = sum over o = 0 .. O-1, ascending, of occ[b, m, o] * ol[p, o]
//
// each product rounded to f32 and then added to the running f32 sum
// (__fmul_rn, __fadd_rn: no FMA contraction; the build has no
// --use_fast_math, so denormals are kept). kid is prep_batch's kept index of
// every k-mer position (-1: none). It computes what kernels/
// position_weights.py position_weights_plain computes on the CPU, bit for
// bit. It replaces the cuBLAS product torch.matmul(occ, ol.t()) of the
// design before it (the JAX package's W = occ @ OL.T, daccord_tpu/kernels/
// window_kernel.py _prep_one, is an XLA product and no Pallas kernel).
//
// Terms with occ == 0 are skipped, and the sum keeps the plain loop's bits:
// occ is a small integer count, every ol entry is finite (the ladder checks
// it at build), so a skipped term adds +0 or -0, which leaves a nonzero sum
// unchanged and keeps +0 as +0; the sum starts at +0 and so never becomes
// -0. The other terms are added in the same ascending order.
//
// What bounds it: one read of kid and one write of W (B * M * P f32, 21.5 MB
// at B=2048, M=64, P=41). kid comes as int32 (15 MB at D=32, NPOS=57: it is
// searchsorted's int32 output, so no pass narrows it); a kept index below
// M <= 1024 needs 16 bits, so the bound counts 2 bytes a position: ~29 MB,
// about 8.7 us at 3.35 TB/s. The products and adds are 2 * P a nonzero
// count, a few percent of the dense B * M * O * P.
//
// Design: a block loops over windows (as many blocks as fit the SMs, each
// transposing ol into shared memory once). For a window it counts occ in
// shared memory (16-bit counts, two a word, shared atomics), then each warp
// takes rows m: a __ballot_sync over 32 offsets' counts gives the nonzero
// ones in ascending order, each count is broadcast with a shuffle, and lane
// l adds the term for columns p = l + 32 j (j < TP), so W's row is written
// by consecutive lanes. The window's kid is read coalesced into registers
// (2048 positions a block) one window ahead: the next window's read is in
// flight while this one's rows are summed, and the first's while ol is
// transposed. A batch smaller than two windows an SM (the escalation tiers'
// ~140) takes blocks of 1024 threads, so a window's latency chain (read,
// count, rows) is split four times finer; larger batches take blocks of
// 256, several an SM. (Blocks of 512, two an SM, so that 133-151 windows
// run in one wave on 132 SMs, were no faster there.) (A warp a window with no block barrier, tried for
// tier 0's B=2048, ran 1.4x slower.) No occ tensor exists in global
// memory: prep_batch's f32 zero-fill and scatter of B * M * O counts
// (29 MB at B=2048) left the path with it.

#include <cuda_runtime.h>
#include <stdint.h>

constexpr int KREG_POS = 2048;   // kid positions a block holds in registers

template <int THREADS>
__device__ __forceinline__ void load_kid(int (&kv)[KREG_POS / THREADS],
                                         const int32_t* __restrict__ kb, int DN)
{
#pragma unroll
    for (int j = 0; j < KREG_POS / THREADS; ++j) {
        const int i = threadIdx.x + j * THREADS;
        kv[j] = i < DN ? kb[i] : -1;
    }
}

__device__ __forceinline__ void count_one(uint32_t* cnt, int m, int i, int NPOS,
                                          int M, int O)
{
    if (m >= 0 && m < M) {
        const int pos = i % NPOS;
        const int idx = m * O + (pos < O - 1 ? pos : O - 1);
        atomicAdd(&cnt[idx >> 1], 1u << ((idx & 1) << 4));
    }
}

template <int TP, int THREADS>   // TP columns a lane, 32 apart
__global__ void __launch_bounds__(THREADS)
position_weights_kernel(const int32_t* __restrict__ kid,  // [B, D, NPOS]
                        const float* __restrict__ ol,     // [P, O]
                        float* __restrict__ W,            // [B, M, P]
                        int B, int DN, int NPOS, int M, int P, int O, int PS)
{
    constexpr int WARPS = THREADS / 32;
    constexpr int KREG = KREG_POS / THREADS;
    extern __shared__ __align__(16) uint32_t sm[];
    float* olT = reinterpret_cast<float*>(sm);     // [O][PS]: PS covers every column
                                                   // slice a lane reads, plus one
    uint32_t* cnt = sm + (size_t)O * PS;           // [ceil(M * O / 2)]
    const int nwords = (M * O + 1) >> 1;
    const int tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31;
    int kv[KREG];
    if (blockIdx.x < B) load_kid<THREADS>(kv, kid + (size_t)blockIdx.x * DN, DN);
    // ol read in order (coalesced); the odd row stride keeps the transposed
    // writes in distinct banks. Unrolled, so a thread's loads are in flight
    // together rather than one L2 round trip each
#pragma unroll 4
    for (int i = tid; i < P * O; i += THREADS) {
        const int p = i / O, o = i - p * O;
        olT[o * PS + p] = ol[i];
    }
    for (int b = blockIdx.x; b < B; b += gridDim.x) {
        for (int i = tid; i < nwords; i += THREADS) cnt[i] = 0u;
        __syncthreads();
#pragma unroll
        for (int j = 0; j < KREG; ++j) count_one(cnt, kv[j], tid + j * THREADS, NPOS, M, O);
        const int32_t* kb = kid + (size_t)b * DN;
        for (int i = tid + KREG_POS; i < DN; i += THREADS) count_one(cnt, kb[i], i, NPOS, M, O);
        __syncthreads();
        if (b + gridDim.x < B) load_kid<THREADS>(kv, kid + (size_t)(b + gridDim.x) * DN, DN);
        float* Wb = W + (size_t)b * M * P;
        for (int m = warp; m < M; m += WARPS) {
            for (int p0 = 0; p0 < P; p0 += 32 * TP) {
                float acc[TP];
#pragma unroll
                for (int j = 0; j < TP; ++j) acc[j] = 0.0f;
                for (int o0 = 0; o0 < O; o0 += 32) {
                    const int o = o0 + lane;
                    uint32_t c = 0u;
                    if (o < O) {
                        const int idx = m * O + o;
                        c = (cnt[idx >> 1] >> ((idx & 1) << 4)) & 0xffffu;
                    }
                    uint32_t nz = __ballot_sync(0xffffffffu, c != 0u);
                    while (nz) {
                        const int src = __ffs(nz) - 1;
                        nz &= nz - 1u;
                        const float cf = __uint2float_rn(__shfl_sync(0xffffffffu, c, src));
                        const float* row = olT + (o0 + src) * PS + p0 + lane;
#pragma unroll
                        for (int j = 0; j < TP; ++j)
                            acc[j] = __fadd_rn(acc[j], __fmul_rn(cf, row[32 * j]));
                    }
                }
#pragma unroll
                for (int j = 0; j < TP; ++j) {
                    const int p = p0 + lane + 32 * j;
                    if (p < P) Wb[(size_t)m * P + p] = acc[j];
                }
            }
        }
        __syncthreads();   // the counts are the next window's
    }
}

// blocks of a kernel that fit the card at once
template <typename K>
static int card_fit(K kernel, int threads, size_t smem, int* fit)
{
    int dev = 0, n = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    *fit = n * per_sm;
    return 0;
}

template <int TP, int THREADS>
static int launch(const void* kid, const void* ol, void* W, int B, int D, int NPOS,
                  int M, int P, int O, void* stream)
{
    // a whole number of 32 * TP column slices, plus one word (see olT)
    const int PS = 32 * TP * ((P + 32 * TP - 1) / (32 * TP)) + 1;
    const size_t smem = 4 * ((size_t)O * PS + ((size_t)M * O + 1) / 2);
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            position_weights_kernel<TP, THREADS>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    // blocks that fit the card at once, cached for the last shared-memory
    // size (the ladder alternates between two or three)
    static size_t fit_smem = 0;
    static int fit = 0;
    if (fit == 0 || fit_smem != smem) {
        const int rc = card_fit(position_weights_kernel<TP, THREADS>, THREADS, smem, &fit);
        if (rc) return rc;
        fit_smem = smem;
    }
    const int grid = B < fit ? B : fit;
    position_weights_kernel<TP, THREADS><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
        (const int32_t*)kid, (const float*)ol, (float*)W, B, D * NPOS, NPOS, M, P, O, PS);
    return (int)cudaGetLastError();
}

template <int TP>
static int launch_tp(const void* kid, const void* ol, void* W, int B, int D, int NPOS,
                     int M, int P, int O, void* stream)
{
    static int sms = 0;
    if (sms == 0) {
        int dev = 0;
        cudaError_t e = cudaGetDevice(&dev);
        if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        if (e != cudaSuccess) return (int)e;
    }
    if (B < 2 * sms) return launch<TP, 1024>(kid, ol, W, B, D, NPOS, M, P, O, stream);
    return launch<TP, 256>(kid, ol, W, B, D, NPOS, M, P, O, stream);
}

extern "C" int position_weights_launch(const void* kid, const void* ol, void* W,
                                       int B, int D, int NPOS, int M, int P, int O,
                                       void* stream)
{
    if (B == 0 || M == 0 || P == 0) return 0;
    const int tp = P <= 32 ? 1 : P <= 64 ? 2 : P <= 96 ? 3 : 4;
    if (tp == 1) return launch_tp<1>(kid, ol, W, B, D, NPOS, M, P, O, stream);
    if (tp == 2) return launch_tp<2>(kid, ol, W, B, D, NPOS, M, P, O, stream);
    if (tp == 3) return launch_tp<3>(kid, ol, W, B, D, NPOS, M, P, O, stream);
    return launch_tp<4>(kid, ol, W, B, D, NPOS, M, P, O, stream);
}

extern "C" const char* position_weights_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}

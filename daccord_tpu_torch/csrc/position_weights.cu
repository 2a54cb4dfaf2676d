// The OffsetLikely position weights of a batch of windows in one fixed
// summation order, hand-written for Hopper (sm_90a):
//
//     W[r, p] = sum over o = 0 .. O-1, ascending, of occ[r, o] * ol[p, o]
//
// for r over the B * M (window, kept k-mer) rows, each product rounded to
// f32 and then added to the running f32 sum (__fmul_rn, __fadd_rn: no FMA
// contraction; the build has no --use_fast_math, so denormals are kept). It
// computes what kernels/position_weights.py position_weights_plain computes
// on the CPU, bit for bit. It replaces the cuBLAS product torch.matmul(occ,
// ol.t()) of kernels/window_kernel.py prep_batch, which sums in its own
// order (the JAX package's W = occ @ OL.T, daccord_tpu/kernels/
// window_kernel.py _prep_one, is an XLA product and no Pallas kernel). With
// one order on both sides, a ladder call on the card gives the CPU ladder's
// bytes, which the supervisor's shadow audit and its CPU failover need.
//
// What bounds it: one read of occ (B * M * O f32) and one write of W
// (B * M * P f32), ~50 MB at B=2048, M=64, about 15 us at 3.35 TB/s; the
// 2 * B * M * P * O f32 operations take about 9 us at 67 TFLOP/s.
//
// Design: a block takes RB = 64 rows; the table ol, transposed to [O][P],
// and the block's occ rows (each padded by one word, so the rows a warp
// reads lie in different banks) sit in shared memory. Thread (g, l), g in
// 0..15 and l in 0..15, holds a TR x TP (4 x TP) tile of the outputs in
// registers: rows 4g .. 4g+3 and columns p0 + l + 16 j, j < TP, for each
// slice p0 of 16 TP columns of P, with TP = ceil(P / 16) up to 4 (3 at the
// ladder's P of 37-41, so few columns idle). Each of its O steps loads four
// occ values and TP ol values and does 4 TP products and adds, each output
// still summed in ascending o (a thread an output loads two values for each
// product and add).

#include <cuda_runtime.h>
#include <stdint.h>

constexpr int TR = 4;            // rows a thread
constexpr int LANES = 16;        // threads across the columns
constexpr int THREADS = 256;
constexpr int RB = TR * THREADS / LANES;   // rows a block (64)

template <int TP>                // columns a thread, 16 apart
__global__ void __launch_bounds__(THREADS)
position_weights_kernel(const float* __restrict__ occ,   // [R, O]
                        const float* __restrict__ ol,    // [P, O]
                        float* __restrict__ W,           // [R, P]
                        int R, int P, int O)
{
    extern __shared__ __align__(16) float sm[];
    float* olT = sm;                       // [O][P]
    float* oc = sm + (size_t)O * P;        // [RB][O + 1]
    const int OS = O + 1;
    const int r0 = blockIdx.x * RB;
    const int rows = min(RB, R - r0);
    for (int i = threadIdx.x; i < P * O; i += THREADS) {
        const int p = i / O, o = i % O;
        olT[o * P + p] = ol[i];
    }
    for (int i = threadIdx.x; i < RB * O; i += THREADS) {
        const int r = i / O, o = i % O;
        oc[r * OS + o] = r < rows ? occ[(size_t)r0 * O + i] : 0.0f;
    }
    __syncthreads();
    const int g = threadIdx.x / LANES, l = threadIdx.x % LANES;
    const float* x = oc + g * TR * OS;
    for (int p0 = 0; p0 < P; p0 += TP * LANES) {
        float acc[TR][TP];
#pragma unroll
        for (int i = 0; i < TR; ++i)
#pragma unroll
            for (int j = 0; j < TP; ++j) acc[i][j] = 0.0f;
        for (int o = 0; o < O; ++o) {
            float xv[TR], yv[TP];
#pragma unroll
            for (int i = 0; i < TR; ++i) xv[i] = x[i * OS + o];
#pragma unroll
            for (int j = 0; j < TP; ++j) {
                const int p = p0 + l + LANES * j;
                yv[j] = p < P ? olT[o * P + p] : 0.0f;
            }
#pragma unroll
            for (int i = 0; i < TR; ++i)
#pragma unroll
                for (int j = 0; j < TP; ++j)
                    acc[i][j] = __fadd_rn(acc[i][j], __fmul_rn(xv[i], yv[j]));
        }
#pragma unroll
        for (int i = 0; i < TR; ++i) {
            const int r = g * TR + i;
#pragma unroll
            for (int j = 0; j < TP; ++j) {
                const int p = p0 + l + LANES * j;
                if (r < rows && p < P) W[(size_t)(r0 + r) * P + p] = acc[i][j];
            }
        }
    }
}

template <int TP>
static int launch(const void* occ, const void* ol, void* W, int R, int P, int O,
                  void* stream)
{
    const size_t smem = 4 * ((size_t)O * P + (size_t)RB * (O + 1));
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            position_weights_kernel<TP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    position_weights_kernel<TP><<<(R + RB - 1) / RB, THREADS, smem, (cudaStream_t)stream>>>(
        (const float*)occ, (const float*)ol, (float*)W, R, P, O);
    return (int)cudaGetLastError();
}

extern "C" int position_weights_launch(const void* occ, const void* ol, void* W,
                                       int R, int P, int O, void* stream)
{
    if (R == 0) return 0;
    const int tp = P <= 16 ? 1 : P <= 32 ? 2 : P <= 48 ? 3 : 4;
    if (tp == 1) return launch<1>(occ, ol, W, R, P, O, stream);
    if (tp == 2) return launch<2>(occ, ol, W, R, P, O, stream);
    if (tp == 3) return launch<3>(occ, ol, W, R, P, O, stream);
    return launch<4>(occ, ol, W, R, P, O, stream);
}

extern "C" const char* position_weights_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}

// Heaviest-path max-plus DP alone, for a batch of consensus windows,
// hand-written for Hopper (sm_90a).
//
// Replaces daccord_tpu/kernels/pallas_dp.py:heaviest_path_batch (the Pallas
// TPU kernel, body _dp_kernel), the DP of the JAX package's scan route
// (window_kernel._dp_scan_one), and computes exactly what it computes, bit
// for bit: scores[t, v] = max_u (scores[t-1, u] + adjW[u, v]) + wt[t, v],
// NEG where the best predecessor is NEG, ptrs[t, v] the lowest u reaching
// the max; row 0 is s0 with pointer 0. The step is written as the DP half of
// csrc/dp_backtrack.cu writes it (a copy: moving it into a shared header
// slowed dp_backtrack by 20-30% on the H100, see PERF.md).
//
// What bounds it on this card: unlike the fused kernel, it writes both
// [B, P, M] stacks to device memory (2048 x 41 x 256 x 8 B = 172 MB at
// M=256), and the inputs are ~B*M*M*4 bytes; counted once, that traffic
// bounds it (chip_smoke.py computes the bound). The DP itself is a serial
// chain of P-1 steps per window, each re-reading the window's adjacency
// from L1/L2, so a simple kernel runs latency-bound above that bound.
//
// What the design does about it: one block per window and one thread per
// column v; the score vector of the previous step stays in shared memory,
// and each step's score and pointer rows go out as coalesced stores across
// the block's threads. The stacks are written once and never read back here.

#include <cuda_runtime.h>
#include <stdint.h>

#define NEGF (-1e30f)

__global__ void heaviest_path_kernel(
    const float* __restrict__ adjW,     // [B, M, M]
    const float* __restrict__ wt,       // [B, P, M]
    const float* __restrict__ s0,       // [B, M]
    float* __restrict__ scores,         // [B, P, M]
    int32_t* __restrict__ ptrs,         // [B, P, M]
    int M, int P)
{
    extern __shared__ __align__(16) float sm[];        // [2, M]
    const int b = blockIdx.x;
    const int v = threadIdx.x;
    const float* A = adjW + (size_t)b * M * M;
    const float* w = wt + (size_t)b * P * M;
    float* sc = scores + (size_t)b * P * M;
    int32_t* pt = ptrs + (size_t)b * P * M;

    float* cur = sm;
    float* nxt = sm + M;
    const float start = s0[(size_t)b * M + v];
    cur[v] = start;
    sc[v] = start;
    pt[v] = 0;
    __syncthreads();
    for (int t = 1; t < P; ++t) {
        float best = cur[0] + A[v];
        int bu = 0;
        for (int u = 1; u < M; ++u) {
            const float c = cur[u] + A[(size_t)u * M + v];
            if (c > best) {          // strict: the first u reaching the max
                best = c;
                bu = u;
            }
        }
        const float sn = (best > NEGF * 0.5f) ? best + w[(size_t)t * M + v] : NEGF;
        nxt[v] = sn;
        sc[(size_t)t * M + v] = sn;
        pt[(size_t)t * M + v] = bu;
        __syncthreads();
        float* tmp = cur;
        cur = nxt;
        nxt = tmp;
    }
}

extern "C" int heaviest_path_launch(
    const void* adjW, const void* wt, const void* s0, void* scores, void* ptrs,
    int B, int M, int P, void* stream)
{
    if (B == 0) return 0;
    const size_t smem = 2 * (size_t)M * sizeof(float);
    heaviest_path_kernel<<<B, M, smem, (cudaStream_t)stream>>>(
        (const float*)adjW, (const float*)wt, (const float*)s0,
        (float*)scores, (int32_t*)ptrs, M, P);
    return (int)cudaGetLastError();
}

extern "C" const char* heaviest_path_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}
